"""Op harness for the PyTorch port (the counterpart of op_test.py).

`run_torch_op` runs one registered op impl of paddle_tpu_torch on numpy
inputs, on the CPU, and returns numpy — so a test hands the SAME numpy
inputs to `op_test.run_op` (the JAX package) and to this, and compares.
bfloat16 has no numpy dtype here: pass float32 values already rounded to
bfloat16 (`round_bf16`) plus `dtypes={slot: torch.bfloat16}`.

Ops with several output slots and int companions (SeqLen) go through
`run_torch_op_all` / `run_ref_op_all` (every slot, as {slot: array}) and
`torch_op_grads` / `ref_op_grads` (gradients of one fixed weighted sum
of the chosen output slots, so no gradient path is vacuously zero); the
`ref_` functions run the JAX package's impl of the same op on the same
numpy inputs.
"""

from __future__ import annotations

import numpy as np
import torch

import paddle_tpu_torch  # noqa: F401  (registers the op impls)
from paddle_tpu_torch.core.registry import OpContext, get_op_impl


def round_bf16(x: np.ndarray) -> np.ndarray:
    """float32 values rounded to the nearest bfloat16 (kept float32)."""
    return torch.as_tensor(np.asarray(x, np.float32)).to(
        torch.bfloat16).to(torch.float32).numpy()


def to_torch(a, dtype=None) -> torch.Tensor:
    t = torch.as_tensor(np.array(a))
    return t if dtype is None else t.to(dtype)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.to(torch.float32)
    return t.numpy()


def run_torch_op(op_type, ins_np, attrs=None, out_slot="Out",
                 dtypes=None):
    """Execute one port op impl on numpy inputs (CPU).  ins_np: {slot:
    array or [arrays]}; dtypes: optional {slot: torch dtype}."""
    return run_torch_op_all(op_type, ins_np, attrs, dtypes)[out_slot]


def _listed(ins_np):
    return {s: (list(v) if isinstance(v, (list, tuple)) else [v])
            for s, v in ins_np.items()}


def run_torch_op_all(op_type, ins_np, attrs=None, dtypes=None):
    """Every output slot of one port op on numpy inputs (CPU), as
    {slot: first array}."""
    impl = get_op_impl(op_type)
    dtypes = dtypes or {}
    ins = {s: [to_torch(a, dtypes.get(s)) for a in vs]
           for s, vs in _listed(ins_np).items()}
    outs = impl(OpContext((0, 0), 0, device="cpu"), ins, dict(attrs or {}))
    return {s: to_numpy(v[0]) for s, v in outs.items()}


def run_ref_op_all(op_type, ins_np, attrs=None):
    """The JAX package's impl of the same op on the same inputs."""
    import jax
    import jax.numpy as jnp
    from paddle_tpu.core.registry import OpContext as RefContext
    from paddle_tpu.core.registry import get_op_impl as ref_impl

    ins = {s: [jnp.asarray(a) for a in vs]
           for s, vs in _listed(ins_np).items()}
    outs = ref_impl(op_type)(RefContext(jax.random.PRNGKey(0), 0), ins,
                             dict(attrs or {}))
    return {s: np.asarray(v[0]) for s, v in outs.items()}


def loss_weights(shape, i, dtype=np.float32):
    """Fixed weights of output i in the weighted-sum loss."""
    n = int(np.prod(shape)) if len(shape) else 1
    return np.cos(np.arange(n) * 0.1 + i).reshape(shape).astype(dtype)


def torch_op_grads(op_type, ins_np, attrs, grad_slots, out_slots,
                   dtype=None):
    """{slot: gradient} of sum_i <out_slots[i], loss_weights> w.r.t. the
    first array of each of `grad_slots`, through torch autograd.  `dtype`
    casts the floating inputs (float64 for a tight comparison)."""
    impl = get_op_impl(op_type)
    ins = {}
    for s, vs in _listed(ins_np).items():
        ts = [to_torch(a) for a in vs]
        if dtype is not None:
            ts = [t.to(dtype) if t.is_floating_point() else t for t in ts]
        ins[s] = ts
    leaves = []
    for s in grad_slots:
        ins[s][0] = ins[s][0].detach().requires_grad_()
        leaves.append(ins[s][0])
    outs = impl(OpContext((0, 0), 0, device="cpu"), ins, dict(attrs or {}))
    loss = 0.0
    for i, s in enumerate(out_slots):
        o = outs[s][0]
        w = torch.as_tensor(loss_weights(tuple(o.shape), i)).to(o.dtype)
        loss = loss + (o * w).sum()
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return {s: (np.zeros(tuple(l.shape), np.float32) if g is None
                else to_numpy(g))
            for s, l, g in zip(grad_slots, leaves, grads)}


def ref_op_grads(op_type, ins_np, attrs, grad_slots, out_slots):
    """The same gradients through jax.grad of the JAX package's impl."""
    import jax
    import jax.numpy as jnp
    from paddle_tpu.core.registry import OpContext as RefContext
    from paddle_tpu.core.registry import get_op_impl as ref_impl

    impl = ref_impl(op_type)
    base = _listed(ins_np)

    def f(*vals):
        ins = {s: [jnp.asarray(a) for a in vs] for s, vs in base.items()}
        for s, v in zip(grad_slots, vals):
            ins[s][0] = v
        outs = impl(RefContext(jax.random.PRNGKey(0), 0), ins,
                    dict(attrs or {}))
        loss = 0.0
        for i, s in enumerate(out_slots):
            o = outs[s][0]
            loss = loss + jnp.sum(o * jnp.asarray(loss_weights(o.shape, i)))
        return loss

    vals = tuple(jnp.asarray(base[s][0]) for s in grad_slots)
    grads = jax.grad(f, argnums=tuple(range(len(vals))))(*vals)
    return {s: np.asarray(g) for s, g in zip(grad_slots, grads)}
