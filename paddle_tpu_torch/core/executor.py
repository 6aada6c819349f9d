"""Executor: interpret a Program op by op on torch tensors.

The port of paddle_tpu/core/executor.py (reference:
paddle/fluid/framework/executor.cc — Run:299, the op-by-op hot loop at
:448-455).  Where the reference traces the whole program once into one
`jax.jit` computation, the port runs each op's torch implementation
eagerly on the executor's device — the reference C++ executor's own
model.

Training programs (`append_backward`'s `backward_marker` split) run the
reference's dense branch (paddle_tpu/core/executor.py:396-459,
547-549, 577-582): the ops before the marker that the loss, the
fetches, the update ops or persistable state need (XLA's dead-code
elimination in the reference) run with every trainable parameter as a
fresh autograd leaf, `torch.autograd.grad` of the
squeezed loss gives the gradients, `<param>@GRAD` and `<loss>@GRAD = 1`
are written into the env, and the ops after the marker (optimizer
updates) run under `torch.no_grad()`.  Nothing of the autograd graph
outlives the step.  An is_sparse lookup of a trainable table takes the
reference's SparseGrad path (paddle_tpu/core/executor.py:621-689): the
gradient is taken with respect to the gathered rows, so the table's is
a `SparseGrad` of the touched rows, which the optimizer ops with a
sparse branch update lazily and every other op sees densified.  What
the reference does beyond that — gradient accumulation, explicit
gradient sync, recompute and pipeline scopes — raises
NotImplementedError naming its ROADMAP item.

The in-step pieces run in the reference's order
(paddle_tpu/core/executor.py:431-617), each only when the program opted
in: the per-op finite bitmap (observe/numerics.py) is seeded before the
forward and ORed by every op; dynamic loss scaling multiplies the loss
by the device-resident scale before `torch.autograd.grad`, then the
loss and the gradients are unscaled; the update guard
(resilience/guard.py) takes `all_finite` and snapshots what the update
ops write, runs them, and selects every written value back where the
step was not finite; then the telemetry accumulator (observe/
metrics.py), the guard's counters and loss-scale schedule, and the
numerics latch advance.  All of it stays on the device: no host read
during the step.

A program marked by `amp.decorate(...).minimize` carries its bf16 op
lists in `_amp_lists`; every op of every run (forward-only, the training
forward and the update ops, as in the reference's executor.py:306-313)
gets its inputs cast by `amp.cast_ins_for_op` after the densify and
before the op's impl.  In the training forward the casts are autograd
ops on the parameter leaves, so each cotangent is cast back and the
parameter gradients reach the update ops in float32.

Places follow Paddle's idiom: `CUDAPlace(0)` runs on `cuda:0`,
`CPUPlace()` on the CPU.  `Executor()` without a place means
`CUDAPlace(0)` and raises when CUDA is not available — the CPU runs only
when the caller asks for it.
"""

from __future__ import annotations

import contextlib
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..observe import metrics as _obs_metrics
from ..observe import numerics as _obs_num
from ..observe.monitoring import dispatch_timer
from ..observe.numerics import NUMERICS_BITS_VAR
from ..resilience import guard as _guard
from .program import Program, Variable, grad_var_name
from .registry import OpContext, get_op_impl
from .selected_rows import SparseGrad, densify

# Scope key of the executor's RNG state (the reference's jax PRNG key;
# here the count of runs that drew from it).
RNG_STATE_VAR = "__rng_key__"

# Optimizer ops with a sparse (SelectedRows) branch; every other op sees
# densified gradients (the reference's SPARSE_AWARE_OPS less adagrad,
# which the port lacks).
SPARSE_AWARE_OPS = {"sgd", "momentum", "adam"}


class Scope:
    """Name → value store for persistable state (reference: scope.h:48).

    Parent-chain lookup is kept for API parity; values are torch tensors
    on the executor's device.
    """

    def __init__(self, parent: Optional["Scope"] = None):
        self.parent = parent
        self.vars: Dict[str, Any] = {}
        self.kids: List["Scope"] = []

    def new_scope(self) -> "Scope":
        kid = Scope(self)
        self.kids.append(kid)
        return kid

    def var(self, name: str):
        """Find-or-create (reference scope.h:56 Var)."""
        if name not in self.vars:
            self.vars[name] = None
        return self.vars[name]

    def find_var(self, name: str):
        s: Optional[Scope] = self
        while s is not None:
            if name in s.vars:
                return s.vars[name]
            s = s.parent
        return None

    def set_var(self, name: str, value):
        self.vars[name] = value

    def has_var(self, name: str) -> bool:
        return self.find_var(name) is not None

    def local_var_names(self) -> List[str]:
        return list(self.vars)

    def drop_kids(self):
        self.kids = []


_global_scope = Scope()


def global_scope() -> Scope:
    return _global_scope


@contextlib.contextmanager
def scope_guard(scope: Scope):
    global _global_scope
    old = _global_scope
    _global_scope = scope
    try:
        yield
    finally:
        _global_scope = old


def place_device(place) -> torch.device:
    """The torch device of a Paddle place.  None means CUDAPlace(0),
    which needs CUDA: without it this raises instead of falling back to
    the CPU."""
    from .. import CPUPlace, CUDAPlace

    if place is None:
        place = CUDAPlace(0)
    if isinstance(place, CPUPlace):
        return torch.device("cpu")
    if isinstance(place, CUDAPlace):
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"{place!r} requested (the default place) but CUDA is not "
                f"available; pass CPUPlace() to run on the CPU")
        return torch.device("cuda", place.device_id)
    raise TypeError(f"unknown place {place!r}; use CPUPlace() or "
                    f"CUDAPlace(id)")


# ---------------------------------------------------------------------------
# Program interpretation
# ---------------------------------------------------------------------------

def run_ops(ops, env: Dict[str, Any], seed, start_index: int = 0,
            program=None, device=None, row_block=None):
    """Run a straight-line op list over `env` (name → tensor), in order
    — the executor hot loop (executor.cc:448).  `seed` is the run's RNG
    seed material (see OpContext.rng), None when no op may draw.
    `device` None means CUDAPlace(0) (`place_device`).  The program's
    bf16 policy (`program._amp_lists`, amp.py), when it has one, casts
    each op's inputs at dispatch.  `row_block`: see OpContext."""
    device = _run_device(device)
    amp_lists = getattr(program, "_amp_lists", None)
    for i, op in enumerate(ops):
        _run_one_op(op, env, seed, start_index + i, program=program,
                    device=device, amp_lists=amp_lists,
                    row_block=row_block)
    return env


def _run_one_op(op, env, seed, op_index, program=None, device=None,
                sparse_rows=None, amp_lists=None, row_block=None):
    desc = op.desc
    try:
        impl = get_op_impl(desc.type)
        ins = {slot: [env[n] for n in names]
               for slot, names in desc.inputs.items()}
        if desc.type not in SPARSE_AWARE_OPS:
            ins = {slot: [densify(v) for v in vals]
                   for slot, vals in ins.items()}
        if amp_lists is not None:
            from ..amp import cast_ins_for_op

            ins = cast_ins_for_op(desc.type, ins, amp_lists)
        ctx = OpContext(seed, op_index=op_index, program=program,
                        device=device, amp_lists=amp_lists,
                        sparse_rows=sparse_rows, row_block=row_block)
        outs = impl(ctx, ins, desc.attrs)
    except Exception as exc:
        _reraise_with_op_context(exc, desc, op_index)
    for slot, names in desc.outputs.items():
        values = outs.get(slot, [])
        if len(values) != len(names):
            raise RuntimeError(
                f"op {desc.type}: output slot {slot!r} produced "
                f"{len(values)} values for {len(names)} names")
        for name, val in zip(names, values):
            env[name] = val
    if NUMERICS_BITS_VAR in env:
        # first-nonfinite op provenance (observe/numerics.py): OR this
        # op's finite flag into the step bitmap under its program
        # index; the bits var is absent unless the program opted in
        env[NUMERICS_BITS_VAR] = _obs_num.update_bits(
            env[NUMERICS_BITS_VAR], op_index,
            [env[n] for n in desc.output_names() if n in env])
    return env


def _reraise_with_op_context(exc: Exception, desc, op_index: int):
    """Attach op type/index/io context to a failure — the reference's
    PADDLE_ENFORCE discipline (platform/enforce.h) so a failing op inside
    a 500-op program is locatable.  The original traceback is preserved
    via exception chaining."""
    detail = (
        f"error while running op[{op_index}] {desc.type!r} "
        f"(inputs={desc.inputs}, outputs={desc.outputs}, "
        f"attrs={ {k: v for k, v in desc.attrs.items() if not str(k).startswith('_')} })"
    )
    try:
        new_exc = type(exc)(f"{detail}\n  caused by: {exc}")
    except Exception:  # noqa: BLE001 — exception types with odd ctors
        new_exc = RuntimeError(f"{detail}\n  caused by: {exc!r}")
    raise new_exc from exc


def _live_indices(block, ops, needed):
    """Indices of the ops in `ops` that contribute to the names in
    `needed` or write persistable state, in program order."""
    def is_persistable(name: str) -> bool:
        return block.has_var(name) and block.var(name).persistable

    needed = set(needed)
    keep = []
    for i in range(len(ops) - 1, -1, -1):
        desc = ops[i].desc
        outs = desc.output_names()
        if any(n in needed for n in outs) or any(
                is_persistable(n) for n in outs):
            keep.append(i)
            needed.update(desc.input_names())
    return keep[::-1]


def prune_ops(program: Program, fetch_names):
    """Dead-op elimination: keep ops contributing to fetches or writing
    persistable state (reference analog: framework/prune.cc)."""
    block = program.global_block()
    return [block.ops[i] for i in _live_indices(block, block.ops,
                                                fetch_names)]


def _pruned(program: Program, fetch_names):
    """prune_ops memoized per (program version, fetches): the decode
    engine interprets the same program for every step."""
    key = (program._version, tuple(fetch_names))
    cache = program.__dict__.setdefault("_pruned_ops", {})
    ops = cache.get(key)
    if ops is None:
        ops = cache[key] = prune_ops(program, fetch_names)
    return ops


def _run_device(device) -> torch.device:
    """The device ops run on: `device`, or CUDAPlace(0) when None."""
    return place_device(None) if device is None else torch.device(device)


def interpret_program(program: Program, env: Dict[str, Any], seed,
                      fetch_names=(), device=None, row_block=None):
    """Run the program over env: a forward program pruned to what the
    fetches and persistable state need; a training program whole
    (forward, gradients, update ops; training programs are never pruned,
    as in the reference).  `device` None means CUDAPlace(0).
    `row_block` (forward programs): each row computed as in a run of
    `row_block` rows (OpContext)."""
    device = _run_device(device)
    if len(program.blocks) > 1:
        raise NotImplementedError(
            "control-flow sub-blocks are not ported yet: ROADMAP queue A "
            "item 6 (ops/control_flow.py)")
    if program._backward_info is None:
        return run_ops(_pruned(program, fetch_names), env, seed,
                       program=program, device=device, row_block=row_block)
    return _train_step(program, env, seed, device, fetch_names)


def _check_trainable(program: Program, fwd_ops):
    """Raise for what the reference's training step does beyond the
    autodiff split (each names its ROADMAP item)."""
    if getattr(program, "_grad_sync", None):
        raise NotImplementedError(
            "training with explicit gradient sync is not ported yet: "
            "ROADMAP queue A item 2 (executor: explicit gradient sync)")
    for op in fwd_ops:
        attrs = op.desc.attrs
        if "__recompute__" in attrs or "__pp_group__" in attrs:
            raise NotImplementedError(
                "recompute and pipeline scopes in a training program are "
                "not ported yet: ROADMAP queue A item 2 (executor: "
                "recompute and pipeline scopes)")


def _live_forward(program: Program, fetch_names):
    """Indices of the forward ops (before the backward marker) that the
    loss, the fetches, the update ops or a persistable write need — the
    dead-code elimination the reference gets from XLA under `jit`;
    memoized per (program version, fetches)."""
    key = (program._version, tuple(fetch_names))
    cache = program.__dict__.setdefault("_live_forward", {})
    live = cache.get(key)
    if live is None:
        info = program._backward_info
        block = program.global_block()
        k = info["index"]
        needed = {info["loss"], *fetch_names}
        for op in block.ops[k:]:
            needed.update(op.desc.input_names())
        live = cache[key] = _live_indices(block, block.ops[:k], needed)
    return live


def _find_sparse_lookups(fwd_ops, live, trainable, env):
    """(op_index, table, ids_name, padding_idx) of every live lookup
    eligible for the SparseGrad path, by the reference's rules
    (paddle_tpu/core/executor.py:621-647): is_sparse, a trainable table,
    ids already in the env (a feed or state; ids computed by earlier ops
    fall back to dense), and a table that no other live forward op reads
    (another reader, e.g. a weight-tied projection, needs the dense
    gradient)."""
    candidates, lookups_of = [], {}
    for i in live:
        d = fwd_ops[i].desc
        if d.type == "lookup_table" and d.attrs.get("is_sparse"):
            tbl, ids_n = d.inputs["W"][0], d.inputs["Ids"][0]
            if tbl in trainable and ids_n in env:
                candidates.append((i, tbl, ids_n,
                                   d.attrs.get("padding_idx", -1)))
                lookups_of.setdefault(tbl, set()).add(i)
    shared = {tbl for i in live for tbl, own in lookups_of.items()
              if i not in own and tbl in fwd_ops[i].desc.input_names()}
    return [c for c in candidates if c[1] not in shared]


def _train_step(program: Program, env: Dict[str, Any], seed, device,
                fetch_names=()):
    """The training step (see the module docstring).  The forward runs
    only the ops `_live_forward` keeps, each under its program index, so
    pruning never shifts an op's random stream or its numerics bit.  The
    autograd leaves are the dense parameters and, for each lookup on the
    SparseGrad path, the rows it gathers; a table's gradient is then a
    SparseGrad of its lookups' ids and row gradients."""
    from ..ops.sparse import gather_rows

    info = program._backward_info
    ops = program.global_block().ops
    k = info["index"]
    fwd_ops, rest_ops = ops[:k], ops[k:]
    params = [p for p in info["params"] if p in env]
    _check_trainable(program, fwd_ops)
    live = _live_forward(program, fetch_names)
    lookups = _find_sparse_lookups(fwd_ops, live, set(params), env)
    sparse_tables = {tbl for _, tbl, _, _ in lookups}
    dense = [p for p in params if p not in sparse_tables]
    loss_name = info["loss"]
    trainable = {p: env[p] for p in params}   # the pre-update values
    tel = env.get(_obs_metrics.TELEMETRY_VAR)
    num_on = (tel is not None
              and getattr(program, "_telemetry_enabled", False)
              and getattr(program, "_numerics_enabled", False)
              and _obs_num.NONFINITE_WORDS in tel)
    if num_on:
        env[NUMERICS_BITS_VAR] = _obs_num.init_step_bits(len(ops), device)
    guard_cfg = getattr(program, "_update_guard", None)
    scale = None
    if (guard_cfg is not None and guard_cfg.loss_scaling is not None
            and tel is not None):
        scale = tel["loss_scale"].to(torch.float32)
    # fresh leaves: the scope's own tensors never join the graph
    leaves = [env[p].detach().requires_grad_() for p in dense]
    rows = {i: gather_rows(env[tbl], env[ids_n], pad).detach()
            .requires_grad_() for i, tbl, ids_n, pad in lookups}
    with torch.enable_grad():
        fenv = dict(env)
        fenv.update(zip(dense, leaves))
        amp_lists = getattr(program, "_amp_lists", None)
        for i in live:
            _run_one_op(fwd_ops[i], fenv, seed, i, program=program,
                        device=device, sparse_rows=rows,
                        amp_lists=amp_lists)
        loss = fenv[loss_name]
        if loss.dim() > 0:
            loss = loss.squeeze()
        if loss.dim() > 0:
            raise ValueError(f"loss {loss_name!r} must have one element, "
                             f"got shape {tuple(fenv[loss_name].shape)}")
        if scale is not None:
            # dynamic loss scaling wraps the loss BEFORE autodiff
            loss = loss * scale
        grad_list = torch.autograd.grad(loss, leaves + list(rows.values()),
                                        allow_unused=True)
    # nothing of the graph leaves the step: every value is detached
    env = {n: (v.detach() if isinstance(v, torch.Tensor) else v)
           for n, v in fenv.items()}
    loss = loss.detach()
    grads: Dict[str, Any] = {}
    for p, leaf, g in zip(dense, leaves, grad_list):
        grads[p] = torch.zeros_like(leaf) if g is None else g
    per_table: Dict[str, list] = {}
    for (i, tbl, ids_n, _), g in zip(lookups, grad_list[len(dense):]):
        if g is None:
            g = torch.zeros_like(rows[i])
        per_table.setdefault(tbl, []).append(
            (env[ids_n].reshape(-1), g.reshape(-1, env[tbl].shape[-1])))
    for tbl, pairs in per_table.items():
        grads[tbl] = SparseGrad(torch.cat([ids for ids, _ in pairs]),
                                torch.cat([g for _, g in pairs]),
                                env[tbl].shape)
    with torch.no_grad():
        return _update(program, env, seed, device, rest_ops, k, loss,
                       grads, trainable, guard_cfg, scale, num_on)


def _update(program, env, seed, device, rest_ops, k, loss, grads,
            trainable, guard_cfg, scale, num_on):
    """After the gradients, in the reference's order
    (paddle_tpu/core/executor.py:538-617): unscale, finite check and
    snapshot, the update ops, the guard's select, then telemetry, the
    guard's counters and the numerics latch."""
    finite = None
    pre_update: Dict[str, Any] = {}
    if scale is not None:
        # unscale before the finite check and the update ops: the
        # optimizer must see master-scale gradients
        inv = 1.0 / scale
        loss = loss * inv
        grads = _guard.scale_grads(grads, inv)
    if guard_cfg is not None:
        finite = _guard.all_finite(loss, grads)
        written = set()
        for op in rest_ops[1:]:
            written.update(op.desc.output_names())
        pre_update = _guard.snapshot_env(env, written)
    env[grad_var_name(program._backward_info["loss"])] = loss * 0 + 1.0
    for p, g in grads.items():
        env[grad_var_name(p)] = g
    # rest_ops[0] is the backward_marker itself
    run_ops(rest_ops[1:], env, seed, start_index=k + 1, program=program,
            device=device)
    if finite is not None:
        # a non-finite step becomes a full state no-op: every value the
        # update ops wrote selects back to its pre-update snapshot
        _guard.select_updates(finite, env, pre_update)
    tel_var = _obs_metrics.TELEMETRY_VAR
    if getattr(program, "_telemetry_enabled", False) and tel_var in env:
        env[tel_var] = _obs_metrics.device_update(env[tel_var], loss, grads,
                                                  trainable, env)
        if finite is not None:
            env[tel_var] = _guard.guard_telemetry_update(env[tel_var],
                                                         finite, guard_cfg)
        if num_on:
            bits = env.pop(NUMERICS_BITS_VAR)
            tel = _obs_num.device_group_update(
                env[tel_var], grads, trainable, env,
                _obs_num.param_groups(trainable))
            env[tel_var] = _obs_num.latch_step_bits(
                tel, bits,
                poisoned_extra=None if finite is None else ~finite)
    return env


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.to(torch.float32)
    return t.numpy()


class Executor:
    """Run programs on one device (reference: python/paddle/fluid/
    executor.py:445 Executor.run and paddle/fluid/framework/executor.cc).

    place: CUDAPlace(id) or CPUPlace(); None means CUDAPlace(0) and
    raises when CUDA is not available.
    """

    def __init__(self, place=None):
        self.place = place
        self.device = place_device(place)

    def run(self, program: Optional[Program] = None,
            feed: Optional[Dict[str, Any]] = None,
            fetch_list: Optional[Sequence[Any]] = None,
            scope: Optional[Scope] = None,
            return_numpy: bool = True,
            use_program_cache: bool = True,
            iterations: int = 1,
            accumulation_steps: int = 1):
        """Run `program` (reference: paddle_tpu/core/executor.py:1141).

        use_program_cache: accepted for the reference's signature; the
            port compiles nothing per program, so there is no cache to
            turn off (the pruned op lists it memoizes are keyed by the
            program's version and always valid).
        iterations: run the step K times on the same feeds and return
            the last run's fetches, as the reference's
            `chain_iterations` (:1089-1108).  Each iteration is one run
            of the RNG counter, so `iterations=3` draws the same dropout
            streams as three `run` calls (the reference also advances
            its key once per chained step, :1339).
        """
        from .program import default_main_program

        if accumulation_steps != 1:
            raise NotImplementedError(
                "gradient accumulation (accumulation_steps > 1) is not "
                "ported yet: ROADMAP queue A item 2 (executor: gradient "
                "accumulation)")
        if int(iterations) < 1:
            raise ValueError(f"iterations must be >= 1, got {iterations}")

        program = program or default_main_program()
        scope = scope or global_scope()
        fetch_names = [f.name if isinstance(f, Variable) else str(f)
                       for f in (fetch_list or [])]
        block = program.global_block()
        feeds = {name: self._to_tensor(value, block, name)
                 for name, value in (feed or {}).items()}
        # one dispatch in runtime_stats, with its host time: on a card
        # the time to enqueue the step's kernels, not the device time
        with dispatch_timer():
            for _ in range(int(iterations)):
                env = self._run_once(program, scope, feeds, fetch_names)
        missing = [n for n in fetch_names if n not in env]
        if missing:
            raise KeyError(f"fetch target(s) {missing} were not computed "
                           f"by the program")
        # a SparseGrad fetch is the dense gradient it stands for
        fetches = [densify(env[n]) for n in fetch_names]
        if return_numpy:
            # numpy has no bf16: a bf16 fetch (an AMP program's
            # intermediate) comes back widened, exactly, to float32
            fetches = [_to_numpy(f) for f in fetches]
        return fetches

    def _run_once(self, program: Program, scope: Scope, feeds,
                  fetch_names):
        """One step: the scope's persistable state and the telemetry
        accumulator (seeded as the reference's `_prepare` does,
        paddle_tpu/core/executor.py:1268-1280) in, the program
        interpreted, the new state written back."""
        block = program.global_block()
        run = scope.find_var(RNG_STATE_VAR) or 0
        scope.set_var(RNG_STATE_VAR, run + 1)
        env: Dict[str, Any] = {}
        for v in block.vars.values():
            if v.persistable and scope.find_var(v.name) is not None:
                env[v.name] = scope.find_var(v.name)
        tel_var = _obs_metrics.TELEMETRY_VAR
        if getattr(program, "_telemetry_enabled", False):
            tel = scope.find_var(tel_var)
            if tel is None:
                tel = _obs_metrics.init_telemetry_for(program, self.device)
            else:
                tel = _obs_metrics.ensure_numerics_fields(program, tel,
                                                          self.device)
            env[tel_var] = tel
        env.update(feeds)
        env = interpret_program(program, env, (program.random_seed, run),
                                fetch_names=fetch_names, device=self.device)
        for v in block.vars.values():
            if v.persistable and v.name in env:
                scope.set_var(v.name, env[v.name])
        if tel_var in env:
            scope.set_var(tel_var, env[tel_var])
        return env

    def close(self):
        """Nothing to release: the port keeps no compiled executables."""

    def _to_tensor(self, value, block, name):
        if isinstance(value, torch.Tensor):
            return value.to(self.device)
        arr = np.asarray(value)
        if block.has_var(name):
            from ..ops.common import to_torch_dtype

            return torch.as_tensor(arr).to(
                device=self.device,
                dtype=to_torch_dtype(block.var(name).dtype))
        return torch.as_tensor(arr, device=self.device)
