"""Misc ops: the port of paddle_tpu/ops/misc.py — print (a tensor dump
that passes its input through), py_func (a Python call from inside a
program), conv_shift and random_crop (reference:
paddle/fluid/operators/print_op.cc, py_func_op.cc, conv_shift_op.cc,
random_crop_op.cc).

`print` and `py_func` run on the host: on the card each reads its
inputs back, which synchronizes, as a debug op or a host callback may.
"""

from __future__ import annotations

from typing import Callable, Dict

import numpy as np
import torch

from ..core.registry import register_op
from .common import dtype_name, first, out, to_torch_dtype

# py_func handles: the attr carries an integer handle, resolved here at
# run time (the reference keeps its own registry the same way; handles
# do not serialize)
_PY_FUNCS: Dict[int, Callable] = {}


def register_py_func(fn: Callable) -> int:
    handle = len(_PY_FUNCS)
    _PY_FUNCS[handle] = fn
    return handle


def _host(t):
    t = t.detach().cpu()
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


@register_op("print")
def print_op(ctx, ins, attrs):
    """Out = In, after printing "{message} shape={shape} dtype={dtype}
    data={first `summarize` values}" on the host, the reference's
    format (message "print_op" when empty)."""
    x = first(ins, "In")
    summarize = int(attrs.get("summarize", 20))
    data = x.reshape(-1)[:summarize] if summarize > 0 else x
    print(f"{attrs.get('message', '') or 'print_op'} "
          f"shape={tuple(x.shape)} dtype={dtype_name(x.dtype)} "
          f"data={_host(data)}", flush=True)
    return out(Out=x)


@register_op("py_func")
def py_func(ctx, ins, attrs):
    """The registered callable `handle` called on numpy copies of X; its
    results become tensors of the declared `out_dtypes` and
    `out_shapes` (a -1 dim is X[0]'s batch size) on the run's device.
    A result of another shape raises."""
    handle = int(attrs["handle"])
    fn = _PY_FUNCS.get(handle)
    if fn is None:
        raise KeyError(f"py_func handle {handle} is not registered in "
                       f"this process (handles do not serialize)")
    xs = ins.get("X", [])
    shapes, dtypes = attrs.get("out_shapes", []), attrs.get("out_dtypes", [])

    def resolve(shape):
        if -1 in shape and not xs:
            raise ValueError("py_func output declared with -1 dim but the "
                             "op has no inputs to infer the batch from")
        return tuple(xs[0].shape[0] if d == -1 else int(d) for d in shape)

    res = fn(*[_host(x) for x in xs])
    if not isinstance(res, (list, tuple)):
        res = (res,)
    outs = []
    for r, shape, dt in zip(res, shapes, dtypes):
        dt = to_torch_dtype(dt)
        a = np.asarray(r)
        if a.shape != resolve(shape):
            raise ValueError(f"py_func result of shape {a.shape}, declared "
                             f"{resolve(shape)}")
        outs.append(torch.as_tensor(a).to(device=ctx.device, dtype=dt))
    return {"Out": outs}


@register_op("conv_shift")
def conv_shift(ctx, ins, attrs):
    """Circular correlation as used by Neural Turing Machines: X (B, M),
    Y (B, N) with N odd, Out[b, i] = sum_j X[b, (i + j) mod M] *
    Y[b, j + (N - 1) / 2] over j in [-(N-1)/2, (N-1)/2]."""
    x, y = first(ins, "X"), first(ins, "Y")
    half = (y.shape[1] - 1) // 2
    shifted = torch.stack([torch.roll(x, -j, dims=1)
                           for j in range(-half, half + 1)], dim=1)
    return out(Out=torch.einsum("bnm,bn->bm", shifted, y).to(x.dtype))


@register_op("random_crop")
def random_crop(ctx, ins, attrs):
    """Each instance of X (N, d1..dk) cropped to attr `shape` over its
    trailing k dims at offsets drawn uniformly from the op's generator
    (ROADMAP C2: the reference draws from threefry), gathered by index
    on the device."""
    x = first(ins, "X")
    shape = [int(s) for s in attrs["shape"]]
    k = len(shape)
    lead = tuple(x.shape[:x.dim() - k])
    dims = tuple(x.shape[x.dim() - k:])
    n = 1
    for d in lead:
        n *= d
    flat = x.reshape((n,) + dims)
    gen = ctx.rng()
    index = [torch.arange(n, device=x.device).reshape((n,) + (1,) * k)]
    for i, (d, s) in enumerate(zip(dims, shape)):
        off = torch.randint(0, d - s + 1, (n,), generator=gen,
                            device=x.device)
        view = [n] + [1] * k
        view[i + 1] = s
        index.append((off[:, None] + torch.arange(
            s, device=x.device)).reshape(view))
    return out(Out=flat[tuple(index)].reshape(lead + tuple(shape)))
