"""Shared helpers for op implementations."""

from __future__ import annotations

import torch

_TORCH_DTYPES = {
    "float32": torch.float32,
    "float16": torch.float16,
    "bfloat16": torch.bfloat16,
    "int8": torch.int8,
    "uint8": torch.uint8,
    "int16": torch.int16,
    "int32": torch.int32,
    "bool": torch.bool,
}
_DTYPE_NAMES = {v: k for k, v in _TORCH_DTYPES.items()}
_DTYPE_NAMES[torch.int64] = "int64"
_DTYPE_NAMES[torch.float64] = "float64"

# The reference runs with jax's 64-bit types disabled, so a declared
# int64/float64 is 32 bits wide at run time there.  The port keeps the
# same widths: values, and the dtypes shape inference writes into the
# VarDescs, then match paddle_tpu's (Program.to_dict is identical).
_RUNTIME_NAME = {"int64": "int32", "uint64": "uint32",
                 "float64": "float32"}


def first(ins, slot):
    return ins[slot][0]


def opt_in(ins, slot):
    vals = ins.get(slot)
    return vals[0] if vals else None


def out(**slots):
    return {slot: [v] for slot, v in slots.items()}


def to_torch_dtype(name) -> torch.dtype:
    """API dtype name → runtime torch dtype (64-bit names narrowed as in
    the reference, see above)."""
    name = str(name)
    name = _RUNTIME_NAME.get(name, name)
    if name not in _TORCH_DTYPES:
        raise ValueError(f"unsupported dtype {name!r}")
    return _TORCH_DTYPES[name]


def dtype_name(dtype: torch.dtype) -> str:
    """torch dtype → the canonical name VarDescs carry."""
    return _DTYPE_NAMES[dtype]


def weak_scalar(value, x):
    """A Python number as jnp's weak typing applies it to tensor x: a
    float beside a bf16 or float16 x is first rounded to x's dtype (jnp
    converts the weak scalar to the array's type, then multiplies or
    adds in that type), where torch would compute with the unrounded
    number and round only the result.  Unchanged beside wider or
    integer tensors."""
    if isinstance(value, float) and x.dtype in (torch.bfloat16,
                                                torch.float16):
        return float(torch.tensor(value, dtype=x.dtype))
    return value


def promote_pair(x, y):
    """x and y cast to their common dtype as jnp promotes two arrays.
    torch gives a 0-dim tensor no say in the result type when the other
    operand is a tensor of the same kind (a bf16 tensor times a float32
    0-dim tensor stays bf16), while jnp promotes on a non-weak 0-d array
    as on any other (float32)."""
    if isinstance(x, torch.Tensor) and isinstance(y, torch.Tensor) \
            and x.dtype != y.dtype:
        dt = torch.promote_types(x.dtype, y.dtype)
        return x.to(dt), y.to(dt)
    return x, y


def broadcast_y(x, y, axis: int = -1):
    """Fluid elementwise broadcast: align y's dims to x starting at `axis`
    (reference: paddle/fluid/operators/elementwise/elementwise_op_function.h
    — the trailing-alignment rule with explicit axis).  When y outranks x
    (e.g. scalar-constant X from `1.0 / var`), fall back to torch
    broadcasting, which handles the shape-(1,) constant case."""
    if x.dim() >= y.dim():
        if x.dim() == y.dim():
            return y
        if axis == -1:
            axis = x.dim() - y.dim()
        new_shape = ([1] * axis + list(y.shape)
                     + [1] * (x.dim() - axis - y.dim()))
        return y.reshape(new_shape)
    return y


def fill_index(ids, size):
    """jnp's gather semantics for integer ids into an axis of `size`
    (mode "fill"): a negative id wraps once (-1 is size-1), and an id
    still outside [0, size) selects nothing.  Returns (idx, bad): int64
    ids clamped into range, safe for any gather and for a CUDA index op
    (which would assert, killing the context, on an out-of-range id), and
    the bool mask where the gathered value must read NaN."""
    idx = ids.to(torch.int64)
    idx = torch.where(idx < 0, idx + size, idx)
    bad = (idx < 0) | (idx >= size)
    return idx.clamp(0, max(size - 1, 0)), bad


def nan_where(bad, x):
    """x with NaN where `bad` (broadcast over x's trailing dims)."""
    bad = bad.reshape(tuple(bad.shape) + (1,) * (x.dim() - bad.dim()))
    return torch.where(bad, torch.full((), float("nan"), dtype=x.dtype,
                                       device=x.device), x)


def pair(value, n=2):
    """An int-or-list spatial attr as a tuple of length n (a one-element
    list repeats)."""
    if isinstance(value, (list, tuple)):
        if len(value) == 1:
            return tuple(value) * n
        return tuple(value)
    return (value,) * n
