"""Control-flow layers: While / Switch / IfElse / StaticRNN / DynamicRNN,
tensor arrays, beam search, and the comparison and logical layers.

The port of paddle_tpu/layers/control_flow.py (reference:
python/paddle/fluid/layers/control_flow.py — While:697, Switch:1126,
IfElse:1313, StaticRNN:307, DynamicRNN:1450, array_write:853,
array_read:960, less_than:893, increment:819).  The layers build the
reference's sub-blocks and ops, attr for attr (`Program.to_dict()` is
the reference's); the macro ops in ops/control_flow.py run them.

The reference's semantics, kept:
- tensor arrays need a static `capacity`;
- While bodies write loop-carried vars with stable shapes/dtypes;
- IfElse computes both branches and merges rows with `where` (the
  fluid reference split the batch by mask and ran each branch on its
  subset; identical results for pure branches).
"""

from __future__ import annotations

import contextlib

from typing import List, Optional, Sequence

from ..core import unique_name
from ..core.program import Variable, default_main_program
from ..layer_helper import LayerHelper
from . import tensor as tensor_layers


def _current_block():
    return default_main_program().current_block()


# ---------------------------------------------------------------------------
# small op wrappers (fluid keeps these in control_flow.py)
# ---------------------------------------------------------------------------

def less_than(x, y, cond=None, **ignored):
    """reference: layers/control_flow.py:893 — writes into `cond` when
    given so While conditions can be updated in-place."""
    helper = LayerHelper("less_than")
    if cond is None:
        cond = helper.create_variable_for_type_inference("bool")
    helper.append_op(type="less_than", inputs={"X": [x], "Y": [y]},
                     outputs={"Out": [cond]})
    return cond


def less_equal(x, y, cond=None):
    helper = LayerHelper("less_equal")
    if cond is None:
        cond = helper.create_variable_for_type_inference("bool")
    helper.append_op(type="less_equal", inputs={"X": [x], "Y": [y]},
                     outputs={"Out": [cond]})
    return cond


def greater_than(x, y, cond=None):
    helper = LayerHelper("greater_than")
    if cond is None:
        cond = helper.create_variable_for_type_inference("bool")
    helper.append_op(type="greater_than", inputs={"X": [x], "Y": [y]},
                     outputs={"Out": [cond]})
    return cond


def equal(x, y, cond=None):
    helper = LayerHelper("equal")
    if cond is None:
        cond = helper.create_variable_for_type_inference("bool")
    helper.append_op(type="equal", inputs={"X": [x], "Y": [y]},
                     outputs={"Out": [cond]})
    return cond


def not_equal(x, y, cond=None):
    helper = LayerHelper("not_equal")
    if cond is None:
        cond = helper.create_variable_for_type_inference("bool")
    helper.append_op(type="not_equal", inputs={"X": [x], "Y": [y]},
                     outputs={"Out": [cond]})
    return cond


def logical_and(x, y, out=None):
    helper = LayerHelper("logical_and")
    if out is None:
        out = helper.create_variable_for_type_inference("bool")
    helper.append_op(type="logical_and", inputs={"X": [x], "Y": [y]},
                     outputs={"Out": [out]})
    return out


def logical_or(x, y, out=None):
    helper = LayerHelper("logical_or")
    if out is None:
        out = helper.create_variable_for_type_inference("bool")
    helper.append_op(type="logical_or", inputs={"X": [x], "Y": [y]},
                     outputs={"Out": [out]})
    return out


def logical_xor(x, y, out=None):
    helper = LayerHelper("logical_xor")
    if out is None:
        out = helper.create_variable_for_type_inference("bool")
    helper.append_op(type="logical_xor", inputs={"X": [x], "Y": [y]},
                     outputs={"Out": [out]})
    return out


def logical_not(x, out=None):
    helper = LayerHelper("logical_not")
    if out is None:
        out = helper.create_variable_for_type_inference("bool")
    helper.append_op(type="logical_not", inputs={"X": [x]},
                     outputs={"Out": [out]})
    return out


def is_empty(x, cond=None, **ignored):
    """reference: layers/control_flow.py:1807 — scalar bool, true iff x
    has zero elements (a property of the shape)."""
    helper = LayerHelper("is_empty")
    if cond is None:
        cond = helper.create_variable_for_type_inference("bool")
    helper.append_op(type="is_empty", inputs={"X": [x]},
                     outputs={"Out": [cond]})
    cond.desc.shape = (1,)
    return cond


# ---------------------------------------------------------------------------
# Tensor arrays
# ---------------------------------------------------------------------------

def create_array(dtype, element_shape: Sequence[int], capacity: int,
                 name: Optional[str] = None) -> Variable:
    """Fixed-capacity tensor array (reference: layers/control_flow.py
    create_array:1013 — the capacity/element_shape args are additions: a
    LoDTensorArray grew on write; the reference's buffers are static,
    and so are the port's)."""
    helper = LayerHelper("create_array", name=name)
    arr = _current_block().create_var(
        name=name or unique_name.generate("array"),
        shape=(capacity,) + tuple(element_shape), dtype=dtype,
        stop_gradient=True)
    helper.append_op(type="create_array", inputs={}, outputs={"Out": [arr]},
                     attrs={"element_shape": list(element_shape),
                            "capacity": int(capacity),
                            "dtype": str(dtype)})
    return arr


def array_write(x, i, array):
    """reference: layers/control_flow.py:853.  Writes in place: the array
    var is both input and output so While loops carry it."""
    helper = LayerHelper("array_write")
    helper.append_op(type="array_write",
                     inputs={"X": [x], "I": [i], "Array": [array]},
                     outputs={"Out": [array]})
    return array


def array_read(array, i):
    """reference: layers/control_flow.py:960."""
    helper = LayerHelper("array_read")
    out = helper.create_variable_for_type_inference(array.dtype)
    helper.append_op(type="array_read",
                     inputs={"Array": [array], "I": [i]},
                     outputs={"Out": [out]})
    out.desc.shape = tuple(array.shape[1:])
    return out


def array_length(array):
    helper = LayerHelper("array_length")
    out = helper.create_variable_for_type_inference("int32")
    helper.append_op(type="array_length", inputs={"Array": [array]},
                     outputs={"Out": [out]})
    out.desc.shape = (1,)
    return out


def array_to_tensor(array, axis=0, use_stack=True):
    """Whole-buffer stack of a tensor array (entries past the high-water
    mark are zero)."""
    helper = LayerHelper("array_to_tensor")
    out = helper.create_variable_for_type_inference(array.dtype)
    idx = helper.create_variable_for_type_inference("int32")
    helper.append_op(type="array_to_tensor", inputs={"Array": [array]},
                     outputs={"Out": [out], "OutIndex": [idx]}, attrs={})
    out.desc.shape = tuple(array.shape)
    return out, idx


def tensor_array_to_tensor(input, axis=1, name=None, use_stack=False):
    """Concat (default) or stack a tensor array's entries along `axis`
    (reference: operators/tensor_array_to_tensor_op.cc:154 and the
    later fluid API of the same name).  Returns (out, out_index) —
    out_index holds each entry's size along the axis.  All capacity
    slots participate (unwritten tail entries are zero: the dense
    fixed-capacity array protocol)."""
    from ..ops.control_flow import _tat_axis

    t = input.shape[0]
    entry = tuple(input.shape[1:])
    # validate at BUILD time with the op's exact rule, so a bad axis
    # fails at the offending call, not at executor trace
    ax = _tat_axis(int(axis), len(entry), bool(use_stack))
    helper = LayerHelper("tensor_array_to_tensor", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    idx = helper.create_variable_for_type_inference("int32")
    helper.append_op(type="tensor_array_to_tensor",
                     inputs={"X": [input]},
                     outputs={"Out": [out], "OutIndex": [idx]},
                     attrs={"axis": int(axis),
                            "use_stack": bool(use_stack)})
    if use_stack:
        out.desc.shape = entry[:ax] + (t,) + entry[ax:]
    else:
        out.desc.shape = (entry[:ax] + (t * entry[ax],)
                          + entry[ax + 1:])
    idx.desc.shape = (t,)
    return out, idx


def lod_rank_table(x, level=0):
    """Rank table of a level-1 sequence batch: (B,) int32 indices
    sorted by length descending, stable (reference:
    layers/control_flow.py lod_rank_table / lod_rank_table_op.cc:19).
    Lengths come from x's .seq_len companion."""
    if level != 0:
        raise NotImplementedError(
            "lod_rank_table: only level-0 (outer) ranking is supported "
            "— the padded+seq_len design caps nesting at the outer "
            "level (see README LoD divergence note)")
    from .sequence import _seq_inputs, seq_len_var

    if seq_len_var(x) is None:
        raise ValueError(
            f"lod_rank_table: {x.name!r} has no .seq_len companion — "
            f"it is not a sequence batch")
    helper = LayerHelper("lod_rank_table")
    out = helper.create_variable_for_type_inference("int32")
    helper.append_op(type="lod_rank_table", inputs=_seq_inputs(x),
                     outputs={"Out": [out]})
    out.desc.shape = (x.shape[0],)
    return out


def reorder_lod_tensor_by_rank(x, rank_table):
    """Permute the batch dim of `x` by `rank_table`
    (reference: reorder_lod_tensor_by_rank_op.cc:34).  The .seq_len
    companion (when present) is reordered alongside."""
    from .sequence import _seq_inputs, seq_len_var

    helper = LayerHelper("reorder_lod_tensor_by_rank")
    out = helper.create_variable_for_type_inference(x.dtype)
    ins = _seq_inputs(x)
    ins["RankTable"] = [rank_table]
    outs = {"Out": [out]}
    sl = seq_len_var(x)
    new_sl = None
    if sl is not None:
        new_sl = _current_block().create_var(
            name=f"{out.name}.seq_len", shape=sl.shape, dtype=sl.dtype,
            stop_gradient=True)
        outs["OutSeqLen"] = [new_sl]
    helper.append_op(type="reorder_lod_tensor_by_rank", inputs=ins,
                     outputs=outs)
    out.desc.shape = tuple(x.shape)
    if new_sl is not None:
        new_sl.desc.shape = tuple(sl.shape)
    return out


def max_sequence_len(seq_len):
    helper = LayerHelper("max_sequence_len")
    out = helper.create_variable_for_type_inference("int32")
    helper.append_op(type="max_sequence_len", inputs={"SeqLen": [seq_len]},
                     outputs={"Out": [out]})
    out.desc.shape = (1,)
    return out


# ---------------------------------------------------------------------------
# While
# ---------------------------------------------------------------------------

class While:
    """reference: layers/control_flow.py:697.

        cond = layers.less_than(i, n)
        w = layers.While(cond)
        with w.block():
            ...  # body; update loop vars with assign/array_write and
            ...  # refresh `cond` via layers.less_than(i, n, cond=cond)

    Every outer var the body writes becomes part of the loop carry; its
    shape and dtype must be iteration-invariant.
    """

    def __init__(self, cond: Variable, name: Optional[str] = None):
        if str(cond.dtype) != "bool":
            raise TypeError("While condition must be a bool variable")
        self.cond = cond
        self.helper = LayerHelper("while", name=name)
        self._program = default_main_program()

    @contextlib.contextmanager
    def block(self):
        program = self._program
        parent_block = program.current_block()
        sub = program._create_block()
        try:
            yield
        finally:
            program._rollback()
        reads, writes = _analyze_block_io(sub)
        writes.discard(self.cond.name)
        # carried vars' *initial* values are read too — list them as inputs
        # so dead-op pruning keeps their producers
        parent_block.append_op(
            type="while",
            inputs={"Condition": [self.cond], "X": sorted(reads | writes)},
            outputs={"Out": sorted(writes)},
            attrs={"sub_block": sub.idx},
        )


def _analyze_block_io(block):
    """(reads, writes) of outer vars for a sub-block: names referenced by
    its ops that are not locally defined.  Mirrors the reference's
    collection of while-op inputs/outputs in layers/control_flow.py:758."""
    local = set(block.vars)
    reads, writes = set(), set()
    for op in block.ops:
        for n in op.desc.input_names():
            if n not in local:
                reads.add(n)
        for n in op.desc.output_names():
            if n not in local:
                writes.add(n)
    return reads, writes


# ---------------------------------------------------------------------------
# Switch (scalar conditional chain; used by lr schedulers)
# ---------------------------------------------------------------------------

class Switch:
    """reference: layers/control_flow.py:1126.

        with layers.Switch() as switch:
            with switch.case(cond1):  layers.assign(v1, lr)
            with switch.case(cond2):  layers.assign(v2, lr)
            with switch.default():    layers.assign(v3, lr)
    """

    def __init__(self, name: Optional[str] = None):
        self.helper = LayerHelper("switch", name=name)
        self._program = default_main_program()
        self._conds: List[Variable] = []
        self._case_blocks: List[int] = []
        self._default_block: int = -1
        self._inside = False

    def __enter__(self):
        self._inside = True
        self._parent_block = self._program.current_block()
        return self

    @contextlib.contextmanager
    def case(self, condition: Variable):
        if not self._inside:
            raise RuntimeError("Switch.case used outside 'with Switch()'")
        sub = self._program._create_block()
        try:
            yield
        finally:
            self._program._rollback()
        self._conds.append(condition)
        self._case_blocks.append(sub.idx)

    @contextlib.contextmanager
    def default(self):
        if not self._inside:
            raise RuntimeError("Switch.default used outside 'with Switch()'")
        sub = self._program._create_block()
        try:
            yield
        finally:
            self._program._rollback()
        self._default_block = sub.idx

    def __exit__(self, exc_type, exc, tb):
        self._inside = False
        if exc_type is not None:
            return False
        reads, writes = set(), set()
        for bidx in list(self._case_blocks) + (
                [self._default_block] if self._default_block >= 0 else []):
            r, w = _analyze_block_io(self._program.blocks[bidx])
            reads |= r
            writes |= w
        self._parent_block.append_op(
            type="switch",
            inputs={"Conditions": [c.name for c in self._conds],
                    "X": sorted(reads | writes)},
            outputs={"Out": sorted(writes)},
            attrs={"case_blocks": self._case_blocks,
                   "default_block": self._default_block},
        )
        return False


# ---------------------------------------------------------------------------
# IfElse (per-example branch; compute-both + where merge)
# ---------------------------------------------------------------------------

class IfElse:
    """reference: layers/control_flow.py:1313.

    The reference splits the batch by the bool mask and runs each branch on
    its row subset.  Here both branches run on the full batch and outputs
    merge per-row with `where` — identical results for pure branches, and
    static shapes.  Branch ops are emitted into the *current*
    block (they execute unconditionally).
    """

    def __init__(self, cond: Variable, name: Optional[str] = None):
        self.cond = cond
        self.helper = LayerHelper("ifelse", name=name)
        self._true_out: List[Variable] = []
        self._false_out: List[Variable] = []
        self._in_branch = None

    @contextlib.contextmanager
    def true_block(self):
        self._in_branch = True
        try:
            yield
        finally:
            self._in_branch = None

    @contextlib.contextmanager
    def false_block(self):
        self._in_branch = False
        try:
            yield
        finally:
            self._in_branch = None

    def input(self, x: Variable) -> Variable:
        if self._in_branch is None:
            raise RuntimeError("IfElse.input used outside a branch block")
        return x

    def output(self, *outs: Variable):
        if self._in_branch is None:
            raise RuntimeError("IfElse.output used outside a branch block")
        (self._true_out if self._in_branch else self._false_out).extend(outs)

    def __call__(self) -> List[Variable]:
        if len(self._true_out) != len(self._false_out):
            raise ValueError(
                f"IfElse branches declared different output counts: "
                f"{len(self._true_out)} vs {len(self._false_out)}")
        merged = []
        for t, f in zip(self._true_out, self._false_out):
            merged.append(tensor_layers.where(self.cond, t, f))
        return merged


# ---------------------------------------------------------------------------
# StaticRNN (a loop over time-major inputs)
# ---------------------------------------------------------------------------

class StaticRNN:
    """reference: layers/control_flow.py:307.

        rnn = layers.StaticRNN()
        with rnn.step():
            x_t = rnn.step_input(x)            # x: (T, B, D) time-major
            h_prev = rnn.memory(init=h0)       # or shape=&batch_ref=
            h = layers.fc(input=[x_t, h_prev], size=H, act='tanh')
            rnn.update_memory(h_prev, h)
            rnn.step_output(h)
        out = rnn()                            # (T, B, H)

    Differentiable end-to-end (torch autograd through the step loop),
    so append_backward trains through it — the replay machinery of
    recurrent_op.cc:311 is subsumed.  `unroll` is recorded in the op's
    attrs as in the reference (its scan-unroll lever) and changes no
    result.
    """

    def __init__(self, name: Optional[str] = None, unroll: int = 1):
        self.helper = LayerHelper("static_rnn", name=name)
        self._unroll = int(unroll)
        self._program = default_main_program()
        self._sub = None
        self._step_inputs = []   # [outer_name, inner_name]
        self._memories = []      # [pre_name, post_name, init_name]
        self._step_outputs = []  # [inner_name, outer_name]
        self._outputs: List[Variable] = []
        self._seq_len_static: Optional[int] = None

    @contextlib.contextmanager
    def step(self):
        parent_block = self._program.current_block()
        self._sub = self._program._create_block()
        try:
            yield
        finally:
            self._program._rollback()
        if not self._memories:
            raise RuntimeError("StaticRNN needs at least one memory")
        missing = [m for m in self._memories if m[1] is None]
        if missing:
            raise RuntimeError("StaticRNN memory never updated via "
                               "update_memory")
        reads, _writes = _analyze_block_io(self._sub)
        parent_block.append_op(
            type="static_rnn",
            inputs={"X": sorted(set(o for o, _i in self._step_inputs)
                    | set(init for _p, _q, init in self._memories)
                    | reads)},
            outputs={"Out": [o for _i, o in self._step_outputs]},
            attrs={"sub_block": self._sub.idx,
                   "step_inputs": self._step_inputs,
                   "memories": self._memories,
                   "step_outputs": self._step_outputs,
                   "final_states": [],
                   "unroll": self._unroll},
        )

    def step_input(self, x: Variable) -> Variable:
        if self._sub is None:
            raise RuntimeError("step_input outside rnn.step()")
        if self._seq_len_static is None:
            self._seq_len_static = x.shape[0]
        inner = self._sub.create_var(
            name=unique_name.generate(f"{x.name}@step"),
            shape=tuple(x.shape[1:]), dtype=x.dtype)
        self._step_inputs.append([x.name, inner.name])
        return inner

    def memory(self, init: Optional[Variable] = None,
               shape=None, batch_ref: Optional[Variable] = None,
               init_value: float = 0.0, dtype="float32") -> Variable:
        if self._sub is None:
            raise RuntimeError("memory outside rnn.step()")
        if init is None:
            if shape is None or batch_ref is None:
                raise ValueError("memory needs init= or shape=+batch_ref=")
            # init var built in the parent block, batch-sized like the ref.
            cur = self._program._block_stack.pop()  # temporarily step out
            try:
                init = tensor_layers.fill_constant_batch_size_like(
                    input=batch_ref, shape=[-1] + list(shape[1:]),
                    dtype=dtype, value=init_value)
            finally:
                self._program._block_stack.append(cur)
        pre = self._sub.create_var(
            name=unique_name.generate(f"{init.name}@pre"),
            shape=tuple(init.shape), dtype=init.dtype)
        self._memories.append([pre.name, None, init.name])
        return pre

    def update_memory(self, mem: Variable, var: Variable):
        for m in self._memories:
            if m[0] == mem.name:
                m[1] = var.name
                return
        raise KeyError(f"{mem.name!r} is not a StaticRNN memory")

    def step_output(self, o: Variable):
        if self._sub is None:
            raise RuntimeError("step_output outside rnn.step()")
        if self._seq_len_static is None:
            raise RuntimeError("step_output before any step_input")
        outer = self._program.current_block().parent.create_var(
            name=unique_name.generate(f"{o.name}@stacked"),
            shape=(self._seq_len_static,) + tuple(o.shape), dtype=o.dtype)
        self._step_outputs.append([o.name, outer.name])
        self._outputs.append(outer)

    def output(self, *outputs: Variable):
        for o in outputs:
            self.step_output(o)

    def __call__(self):
        if len(self._outputs) == 1:
            return self._outputs[0]
        return self._outputs


# ---------------------------------------------------------------------------
# DynamicRNN (seq_len masking over padded batch-major sequences)
# ---------------------------------------------------------------------------

class DynamicRNN:
    """reference: layers/control_flow.py:1450.

        drnn = layers.DynamicRNN()
        with drnn.block():
            x_t = drnn.step_input(x)     # x: (B, T, D) padded, has .seq_len
            h_prev = drnn.memory(shape=[H], value=0.0)
            h = layers.fc(input=[x_t, h_prev], size=H, act='tanh')
            drnn.update_memory(h_prev, h)
            drnn.output(h)
        out = drnn()                     # (B, T, H) padded, with .seq_len

    Per-example masking replaces the reference's lod_rank_table
    sort-by-length + shrink_rnn_memory machinery; outputs carry the input's
    `.seq_len` companion so sequence_* layers compose.  `unroll` is
    recorded as in StaticRNN and changes no result.
    """

    def __init__(self, name: Optional[str] = None, unroll: int = 1):
        self.helper = LayerHelper("dynamic_rnn", name=name)
        self._unroll = int(unroll)
        self._program = default_main_program()
        self._sub = None
        self._step_inputs = []
        self._memories = []
        self._step_outputs = []
        self._outputs: List[Variable] = []
        self._seq_len_name: Optional[str] = None
        self._first_input: Optional[Variable] = None

    @contextlib.contextmanager
    def block(self):
        parent_block = self._program.current_block()
        self._sub = self._program._create_block()
        try:
            yield
        finally:
            self._program._rollback()
        if self._seq_len_name is None:
            raise RuntimeError(
                "DynamicRNN.step_input never called (no sequence input)")
        if any(m[1] is None for m in self._memories):
            raise RuntimeError("DynamicRNN memory never updated")
        reads, _writes = _analyze_block_io(self._sub)
        parent_block.append_op(
            type="dynamic_rnn",
            inputs={"X": sorted(set(o for o, _i in self._step_inputs)
                    | set(init for _p, _q, init in self._memories)
                    | reads | {self._seq_len_name})},
            outputs={"Out": [o for _i, o in self._step_outputs]},
            attrs={"sub_block": self._sub.idx,
                   "step_inputs": self._step_inputs,
                   "memories": self._memories,
                   "step_outputs": self._step_outputs,
                   "final_states": [],
                   "seq_len": self._seq_len_name,
                   "unroll": self._unroll},
        )
        # propagate the seq_len companion to padded outputs
        from .sequence import _propagate_seq_len

        for (_inner, outer_name), outer_var in zip(self._step_outputs,
                                                   self._outputs):
            _propagate_seq_len(self._first_input, outer_var)

    def step_input(self, x: Variable) -> Variable:
        if self._sub is None:
            raise RuntimeError("step_input outside drnn.block()")
        from .sequence import seq_len_var

        sl = seq_len_var(x)
        if sl is None:
            raise ValueError(
                f"DynamicRNN input {x.name!r} has no .seq_len companion; "
                f"declare it with layers.data(..., lod_level=1)")
        if self._seq_len_name is None:
            self._seq_len_name = sl.name
            self._first_input = x
        inner = self._sub.create_var(
            name=unique_name.generate(f"{x.name}@step"),
            shape=(x.shape[0],) + tuple(x.shape[2:]), dtype=x.dtype)
        self._step_inputs.append([x.name, inner.name])
        return inner

    def memory(self, init: Optional[Variable] = None, shape=None,
               value: float = 0.0, need_reorder: bool = False,
               dtype="float32") -> Variable:
        if self._sub is None:
            raise RuntimeError("memory outside drnn.block()")
        if init is None:
            if shape is None:
                raise ValueError("memory needs init= or shape=")
            if self._first_input is None:
                raise RuntimeError("call step_input before shape-based "
                                   "memory (batch size comes from it)")
            cur = self._program._block_stack.pop()
            try:
                init = tensor_layers.fill_constant_batch_size_like(
                    input=self._first_input, shape=[-1] + list(shape),
                    dtype=dtype, value=value)
            finally:
                self._program._block_stack.append(cur)
        pre = self._sub.create_var(
            name=unique_name.generate(f"{init.name}@pre"),
            shape=tuple(init.shape), dtype=init.dtype)
        self._memories.append([pre.name, None, init.name])
        return pre

    def update_memory(self, mem: Variable, var: Variable):
        for m in self._memories:
            if m[0] == mem.name:
                m[1] = var.name
                return
        raise KeyError(f"{mem.name!r} is not a DynamicRNN memory")

    def output(self, *outs: Variable):
        if self._sub is None:
            raise RuntimeError("output outside drnn.block()")
        for o in outs:
            t = self._first_input.shape[1]
            outer = self._program.current_block().parent.create_var(
                name=unique_name.generate(f"{o.name}@padded"),
                shape=(o.shape[0], t) + tuple(o.shape[1:]), dtype=o.dtype)
            self._step_outputs.append([o.name, outer.name])
            self._outputs.append(outer)

    def __call__(self):
        if len(self._outputs) == 1:
            return self._outputs[0]
        return self._outputs


# ---------------------------------------------------------------------------
# Beam search
# ---------------------------------------------------------------------------

def beam_search(pre_ids, pre_scores, scores, beam_size: int, end_id: int,
                is_first_step: bool = False, name: Optional[str] = None):
    """One beam-search expansion step on dense (batch, beam) tensors.

    reference: layers/nn.py beam_search / operators/beam_search_op.cc:1.
    `scores` is (B, beam, V) next-token log-probs.  Returns
    (selected_ids (B, K), selected_scores (B, K), parent_idx (B, K)).
    """
    helper = LayerHelper("beam_search", name=name)
    ids = helper.create_variable_for_type_inference(pre_ids.dtype)
    sc = helper.create_variable_for_type_inference(pre_scores.dtype)
    parent = helper.create_variable_for_type_inference("int32")
    helper.append_op(
        type="beam_search",
        inputs={"PreIds": [pre_ids], "PreScores": [pre_scores],
                "Scores": [scores]},
        outputs={"SelectedIds": [ids], "SelectedScores": [sc],
                 "ParentIdx": [parent]},
        attrs={"beam_size": int(beam_size), "end_id": int(end_id),
               "is_first_step": bool(is_first_step)},
    )
    return ids, sc, parent


def beam_search_decode(ids, parents, num_steps=None, end_id: int = 1,
                       name: Optional[str] = None):
    """Backtrace beam parent pointers into sentences.

    `ids`/`parents` are (T, B, K) stacked per-step outputs (tensor-array
    buffers from array_to_tensor).  Returns (B, K, T) sequences padded
    with end_id.  reference: beam_search_decode_op.cc.
    """
    helper = LayerHelper("beam_search_decode", name=name)
    out = helper.create_variable_for_type_inference(ids.dtype)
    ins = {"Ids": [ids], "Parents": [parents]}
    if num_steps is not None:
        ins["NumSteps"] = [num_steps]
    helper.append_op(type="beam_search_decode", inputs=ins,
                     outputs={"SentenceIds": [out]},
                     attrs={"end_id": int(end_id)})
    return out
