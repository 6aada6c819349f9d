"""Imperative (eager / proto-dygraph) mode: the port of
paddle_tpu/imperative.py.

reference: paddle/fluid/imperative/ — VarBase with var+grad slots
(layer.h:83), OpBase, Tracer::Trace recording ops and building grad ops
on the fly (tracer.h:51,57), autograd RunBackward (layer.h:103);
python/paddle/fluid/imperative/layers.py PyLayer.

Each traced op runs at once through the registry's impl (the same code
the Executor runs, so a `dynamic_lstm` reaches the LSTM kernels through
their `autograd.Function` and a `flash_attention` the flash kernels), on
the tracer's device, with `OpContext(seed=(0, op counter))` (ROADMAP C2).
Where the reference keeps a tape of op closures and replays it with
`jax.vjp` (paddle_tpu/imperative.py:149-174), the port lets torch
autograd record the graph as the ops run: a differentiable leaf (a
parameter, a user var without `stop_gradient`) enters each op as an
autograd leaf of its own (`VarBase._node`), and `backward()` takes
`torch.autograd.grad` of the root with the cotangent `ones_like(root)`
(for any root shape, as the reference) over the leaves the tape saw.
The graph is retained, so a second `backward()` through the same ops
works as the reference's replay does; leaf `.grad`s accumulate until
`clear_gradient()`, non-leaf grads are dropped, and a `stop_gradient`
input gets none.  `Tracer.reset()` (and `EagerOptimizer.minimize`)
drops the tape and with it the graph.

    with imperative.guard(place=fluid.CPUPlace()):
        x = imperative.to_variable(np_x)
        fc = imperative.FC(4, 64, act="relu")
        y = fc(x)
        loss = imperative.trace_op("reduce_mean", {"X": [y]})
        loss.backward()
        g = fc.w.grad

`guard(place=None)`, `to_variable` and the layers' parameters default to
CUDAPlace(0) and raise without CUDA, as the Executor does; inside a
guard they default to its place.
"""

from __future__ import annotations

import contextlib
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from .core.registry import OpContext, get_op_impl


def _device(place=None) -> torch.device:
    """The device of `place`; None: the active guard's, else
    CUDAPlace(0)."""
    from .core.executor import place_device

    if place is None:
        tracer = _active_tracer()
        if tracer is not None:
            return tracer.device
    return place_device(place)


# 64-bit values run 32 bits wide, as the reference's jnp.asarray makes
# them and as the Executor's feeds do (ops/common.py)
_NARROW = {torch.int64: torch.int32, torch.float64: torch.float32}


def _as_tensor(value, device: torch.device) -> torch.Tensor:
    t = (value.detach() if isinstance(value, torch.Tensor)
         else torch.as_tensor(np.asarray(value)))
    return t.to(device=device, dtype=_NARROW.get(t.dtype, t.dtype))


class VarBase:
    """Eager variable: value + grad slot (reference imperative/layer.h:83).
    `value` and `grad` are torch tensors on the variable's device."""

    def __init__(self, value, stop_gradient: bool = False,
                 name: Optional[str] = None, place=None):
        if isinstance(value, torch.Tensor) and place is None:
            self.value = value      # kept as it is (an op's output too)
        else:
            self.value = _as_tensor(value, _device(place))
        self.stop_gradient = stop_gradient
        self.grad = None
        self.name = name
        # autograd bookkeeping (set by the tracer for op outputs)
        self._producer: Optional["_TapeEntry"] = None
        self._out_index: int = 0
        self._leaf: Optional[torch.Tensor] = None
        self._leaf_of: Optional[torch.Tensor] = None

    # -- tensor-ish surface ---------------------------------------------
    @property
    def shape(self):
        return tuple(self.value.shape)

    @property
    def dtype(self):
        return str(self.value.dtype).replace("torch.", "")

    def numpy(self) -> np.ndarray:
        v = self.value.detach()
        if v.dtype == torch.bfloat16:
            v = v.float()
        return v.cpu().numpy()

    def clear_gradient(self):
        self.grad = None

    def __repr__(self):
        return (f"VarBase(shape={self.shape}, dtype={self.dtype}, "
                f"stop_gradient={self.stop_gradient})")

    # -- autograd -------------------------------------------------------
    def _node(self) -> torch.Tensor:
        """The tensor this variable enters an op as: an op output's own
        tensor, a leaf's autograd leaf (made anew when `value` was
        reassigned), a stop_gradient variable's value detached."""
        if self.stop_gradient:
            return self.value.detach()
        if self._producer is not None:
            return self.value
        if self._leaf is None or self._leaf_of is not self.value:
            self._leaf_of = self.value
            self._leaf = self.value.detach().requires_grad_(
                self.value.is_floating_point())
        return self._leaf

    def backward(self):
        """Differentiate this output over the tape (reference layer.h:103
        RunBackward)."""
        tracer = _active_tracer()
        if tracer is None:
            raise RuntimeError("backward() outside imperative.guard()")
        tracer.run_backward(self)


class _TapeEntry:
    __slots__ = ("op_type", "in_vars", "out_vars")

    def __init__(self, op_type, in_vars, out_vars):
        self.op_type = op_type
        self.in_vars = in_vars    # [VarBase] (differentiable inputs)
        self.out_vars = out_vars  # [VarBase]


class Tracer:
    """Eager op recorder (reference imperative/tracer.h:51 Tracer::Trace:
    execute the op now, remember how to differentiate it)."""

    def __init__(self, device: torch.device):
        self.device = device
        self.tape: List[_TapeEntry] = []
        self._op_counter = 0

    # -- forward --------------------------------------------------------
    def trace_op(self, op_type: str, ins: Dict[str, Sequence[VarBase]],
                 attrs: Optional[Dict[str, Any]] = None,
                 out_slots: Optional[Sequence[str]] = None) -> Any:
        impl = get_op_impl(op_type)
        attrs = dict(attrs or {})
        self._op_counter += 1
        ctx = OpContext((0, self._op_counter), op_index=self._op_counter,
                        device=self.device)
        diff_vars: List[VarBase] = []
        call_ins = {}
        for slot, vs in ins.items():
            call_ins[slot] = []
            for v in vs:
                if isinstance(v, VarBase):
                    node = v._node()
                    if node.requires_grad and v not in diff_vars:
                        diff_vars.append(v)
                    call_ins[slot].append(node)
                else:
                    call_ins[slot].append(_as_tensor(v, self.device))
        with torch.enable_grad():
            outs = impl(ctx, call_ins, attrs)
        keys = out_slots or sorted(outs)
        out_vars = []
        entry = _TapeEntry(op_type, diff_vars, out_vars)
        for k in keys:
            for a in outs[k]:
                ov = VarBase(a)
                if a.requires_grad:
                    ov._producer = entry
                ov._out_index = len(out_vars)
                out_vars.append(ov)
        if diff_vars:
            self.tape.append(entry)
        if len(out_vars) == 1:
            return out_vars[0]
        return out_vars

    # -- backward -------------------------------------------------------
    def run_backward(self, root: VarBase):
        """Cotangent ones_like(root) into the graph recorded since the
        last reset; every leaf on the tape that the root depends on
        accumulates its gradient into `.grad`."""
        if not root.value.requires_grad:
            return      # the root depends on no differentiable leaf
        leaves, nodes = [], []
        for entry in self.tape:
            for v in entry.in_vars:
                if v._producer is None and not any(v is u for u in leaves):
                    leaves.append(v)
                    nodes.append(v._node())
        grads = torch.autograd.grad(
            root.value, nodes, grad_outputs=torch.ones_like(root.value),
            retain_graph=True, allow_unused=True)
        for v, g in zip(leaves, grads):
            if g is not None:
                v.grad = g if v.grad is None else v.grad + g
        # non-leaf grads are discarded like the reference (only VarBases
        # the user holds references to matter)

    def reset(self):
        self.tape = []


_tracer_stack: List[Tracer] = []


def _active_tracer() -> Optional[Tracer]:
    return _tracer_stack[-1] if _tracer_stack else None


@contextlib.contextmanager
def guard(place=None):
    """Enable eager mode (reference python dygraph guard) on `place`
    (None: CUDAPlace(0))."""
    from .core.executor import place_device

    t = Tracer(place_device(place))
    _tracer_stack.append(t)
    try:
        yield t
    finally:
        _tracer_stack.pop()


def to_variable(value, stop_gradient: bool = False, place=None) -> VarBase:
    """A VarBase of `value` on `place` (None: the active guard's, else
    CUDAPlace(0))."""
    return VarBase(value, stop_gradient=stop_gradient, place=place)


def trace_op(op_type: str, ins, attrs=None, out_slots=None):
    tracer = _active_tracer()
    if tracer is None:
        raise RuntimeError("trace_op outside imperative.guard()")
    return tracer.trace_op(op_type, ins, attrs, out_slots)


class Layer:
    """Eager layer base (reference imperative/layers.py PyLayer / Layer):
    hold parameters, define forward().  Parameters live on `place`
    (None: the active guard's, else CUDAPlace(0))."""

    def __init__(self, name: Optional[str] = None, place=None):
        if name is None:
            # distinct default names per INSTANCE (the deterministic
            # init seeds derive from the name, so two unnamed layers of
            # one class must not share weights) — via core.unique_name
            # so unique_name.guard() resets them for in-process
            # rebuilds, same as static-graph layers
            from .core import unique_name

            name = unique_name.generate(self.__class__.__name__)
        self._name = name
        self._place = place
        self._params: Dict[str, VarBase] = {}
        self._sublayers: Dict[str, "Layer"] = {}

    def __setattr__(self, key, value):
        if isinstance(value, Layer):
            self.__dict__.setdefault("_sublayers", {})[key] = value
        super().__setattr__(key, value)

    def create_parameter(self, name: str, shape, dtype="float32",
                         initializer=None, fan_in=None) -> VarBase:
        """The reference's deterministic default init (a normal draw of
        numpy's RandomState seeded by the crc32 of the parameter's name,
        over sqrt(fan_in)), so a layer of the same name holds the same
        weights in both packages."""
        if initializer is None:
            import zlib

            # stable digest, NOT hash(): str hashing is salted per
            # process and would make default inits non-reproducible
            seed = zlib.crc32(f"{self._name}.{name}".encode())
            rng = np.random.RandomState(seed % (2 ** 31))
            # default fan heuristic fits (in, out)-style FC weights;
            # layers with other layouts (conv OIHW) pass fan_in
            if fan_in is None:
                fan_in = int(np.prod(shape[:-1])) or 1
            value = (rng.randn(*shape) / np.sqrt(fan_in)).astype(dtype)
        else:
            value = np.asarray(initializer, dtype=dtype)
        p = VarBase(value, name=f"{self._name}.{name}", place=self._place)
        self._params[name] = p
        return p

    def parameters(self) -> List[VarBase]:
        out = list(self._params.values())
        for sub in self._sublayers.values():
            out.extend(sub.parameters())
        return out

    def clear_gradients(self):
        for p in self.parameters():
            p.clear_gradient()

    def forward(self, *args, **kwargs):
        raise NotImplementedError

    def __call__(self, *args, **kwargs):
        return self.forward(*args, **kwargs)


class FC(Layer):
    """Eager fully-connected layer (the reference embryo's test layer)."""

    def __init__(self, input_dim: int, size: int, act: Optional[str] = None,
                 name: Optional[str] = None, place=None):
        super().__init__(name, place)
        self.w = self.create_parameter("w", [input_dim, size])
        self.b = self.create_parameter(
            "b", [size], initializer=np.zeros([size], np.float32))
        self._act = act

    def forward(self, x: VarBase) -> VarBase:
        y = trace_op("mul", {"X": [x], "Y": [self.w]},
                     {"x_num_col_dims": 1, "y_num_col_dims": 1})
        y = trace_op("elementwise_add", {"X": [y], "Y": [self.b]},
                     {"axis": 1})
        if self._act:
            y = trace_op(self._act, {"X": [y]})
        return y


class Conv2D(Layer):
    """Eager conv layer over the static-graph conv2d kernel (NCHW,
    filter (C_out, C_in/groups, kH, kW))."""

    def __init__(self, num_channels: int, num_filters: int,
                 filter_size: int, stride: int = 1, padding: int = 0,
                 groups: int = 1, act: Optional[str] = None,
                 name: Optional[str] = None, place=None):
        super().__init__(name, place)
        k = ([filter_size, filter_size]
             if isinstance(filter_size, int) else list(filter_size))
        # OIHW: fan_in is C_in/groups * kH * kW (the FC heuristic would
        # count num_filters and drop kW)
        self.w = self.create_parameter(
            "w", [num_filters, num_channels // groups] + k,
            fan_in=(num_channels // groups) * int(np.prod(k)))
        self.b = self.create_parameter(
            "b", [num_filters],
            initializer=np.zeros([num_filters], np.float32))
        self._attrs = {"strides": stride, "paddings": padding,
                       "groups": groups}
        self._act = act

    def forward(self, x: VarBase) -> VarBase:
        y = trace_op("conv2d", {"Input": [x], "Filter": [self.w]},
                     self._attrs, out_slots=["Output"])
        y = trace_op("elementwise_add", {"X": [y], "Y": [self.b]},
                     {"axis": 1})
        if self._act:
            y = trace_op(self._act, {"X": [y]})
        return y


class Embedding(Layer):
    """Eager embedding lookup (lookup_table kernel)."""

    def __init__(self, size, name: Optional[str] = None, place=None):
        super().__init__(name, place)
        self.w = self.create_parameter("w", list(size))

    def forward(self, ids: VarBase) -> VarBase:
        return trace_op("lookup_table",
                        {"Ids": [ids], "W": [self.w]},
                        {"padding_idx": -1})


# ---------------------------------------------------------------------------
# Eager optimizers (reference dygraph pattern: backward() then
# optimizer.minimize applies updates directly to parameter VarBases).
# Updates route through the SAME registered sgd/adam ops the static
# graph uses (ops/optim.py), under no_grad as the Executor runs its update
# ops, so eager and static trajectories match exactly — no second
# optimizer formula to maintain.
# ---------------------------------------------------------------------------

class EagerOptimizer:
    def step(self, parameters: Sequence[VarBase]):
        for p in parameters:
            if p.grad is not None:
                ctx = OpContext((0, 0), 0, device=p.value.device)
                with torch.no_grad():
                    self._apply(ctx, p)

    def _apply(self, ctx, p: VarBase):
        raise NotImplementedError

    def _lr(self, device) -> torch.Tensor:
        return torch.tensor([self.learning_rate], dtype=torch.float32,
                            device=device)

    def minimize(self, loss: VarBase, parameters: Sequence[VarBase]):
        """backward + apply + clear grads + reset the tape (the tape
        must not grow across steps)."""
        loss.backward()
        self.step(parameters)
        for p in parameters:
            p.clear_gradient()
        tracer = _active_tracer()
        if tracer is not None:
            tracer.reset()
        return loss


class SGDOptimizer(EagerOptimizer):
    def __init__(self, learning_rate: float = 0.01):
        self.learning_rate = float(learning_rate)

    def _apply(self, ctx, p: VarBase):
        outs = get_op_impl("sgd")(
            ctx, {"Param": [p.value], "Grad": [p.grad],
                  "LearningRate": [self._lr(p.value.device)]}, {})
        p.value = outs["ParamOut"][0]


class AdamOptimizer(EagerOptimizer):
    # per-parameter state keyed by WEAK reference: dead parameters drop
    # their moments (no device-memory leak across model rebuilds), and
    # a recycled id can never inherit a dead parameter's state
    def __init__(self, learning_rate: float = 1e-3, beta1: float = 0.9,
                 beta2: float = 0.999, epsilon: float = 1e-8):
        self.learning_rate = float(learning_rate)
        self.attrs = {"beta1": beta1, "beta2": beta2, "epsilon": epsilon}
        self._state: Dict[int, Any] = {}  # id -> (weakref(p), slots)

    def _apply(self, ctx, p: VarBase):
        import weakref

        key = id(p)
        hit = self._state.get(key)
        dev = p.value.device
        if hit is None or hit[0]() is not p:
            slots = {"Moment1": torch.zeros_like(p.value),
                     "Moment2": torch.zeros_like(p.value),
                     "Beta1Pow": torch.tensor([self.attrs["beta1"]],
                                              dtype=torch.float32,
                                              device=dev),
                     "Beta2Pow": torch.tensor([self.attrs["beta2"]],
                                              dtype=torch.float32,
                                              device=dev)}
            hit = (weakref.ref(
                p, lambda _ref, k=key, s=self._state: s.pop(k, None)),
                slots)
            self._state[key] = hit
        slots = hit[1]
        outs = get_op_impl("adam")(
            ctx, {"Param": [p.value], "Grad": [p.grad],
                  "LearningRate": [self._lr(dev)],
                  "Moment1": [slots["Moment1"]],
                  "Moment2": [slots["Moment2"]],
                  "Beta1Pow": [slots["Beta1Pow"]],
                  "Beta2Pow": [slots["Beta2Pow"]]}, dict(self.attrs))
        p.value = outs["ParamOut"][0]
        slots["Moment1"] = outs["Moment1Out"][0]
        slots["Moment2"] = outs["Moment2Out"][0]
        slots["Beta1Pow"] = outs["Beta1PowOut"][0]
        slots["Beta2Pow"] = outs["Beta2PowOut"][0]
