"""Shape/dtype inference by running ops on "meta" tensors.

The port of paddle_tpu/core/shape_inference.py.  The reference gets
every op's InferShape (reference: paddle/fluid/framework/
shape_inference.h) from `jax.eval_shape`; here the op's own torch
implementation runs on tensors of the "meta" device, which carry shape
and dtype but no storage, so no value is computed and nothing is
allocated.  The resulting output shapes/dtypes are written back into the
output VarDescs.

Dynamic dims (-1) are represented during evaluation by the same large
prime sentinel as the reference; output dims divisible by the sentinel
are restored to -1.  Keeping the scheme is what makes the declared var
shapes — and so `Program.to_dict()` — match paddle_tpu's.
"""

from __future__ import annotations

import torch

from ..ops.common import dtype_name, to_torch_dtype

# Large prime sentinel standing in for a dynamic (-1) dimension.
DYNAMIC_DIM_SENTINEL = 1000003


def _encode_shape(shape):
    return tuple(DYNAMIC_DIM_SENTINEL if d == -1 else int(d) for d in shape)


def _decode_dim(d: int) -> int:
    if d >= DYNAMIC_DIM_SENTINEL and d % DYNAMIC_DIM_SENTINEL == 0:
        return -1
    return int(d)


def _decode_shape(shape):
    return tuple(_decode_dim(d) for d in shape)


# Op types the executor handles specially; their outputs keep declared
# shapes (the reference's list, kept so the same vars stay uninferred).
_SKIP_INFERENCE = {
    "backward_marker", "py_func", "print",
    "create_array", "array_write", "array_read", "array_length",
    "array_to_tensor",
}


def infer_op_shapes(op_desc, block) -> bool:
    """Best-effort shape inference for one appended op.  Returns True when
    output VarDescs were updated."""
    if op_desc.type in _SKIP_INFERENCE:
        return False
    from .registry import OpContext, get_op_impl, has_op

    if not has_op(op_desc.type):
        return False

    ins = {}
    for slot, names in op_desc.inputs.items():
        metas = []
        for n in names:
            if not block.has_var(n):
                return False
            v = block.var(n)
            metas.append(torch.empty(_encode_shape(v.shape),
                                     dtype=to_torch_dtype(v.dtype),
                                     device="meta"))
        ins[slot] = metas

    impl = get_op_impl(op_desc.type)
    ctx = OpContext(None, op_index=0,
                    is_test=bool(op_desc.attrs.get("is_test", False)),
                    device="meta")
    try:
        outs = impl(ctx, ins, op_desc.attrs)
    except Exception:  # noqa: BLE001 — leave declared shapes; the
        return False   # executor still runs the op, as in the reference

    for slot, names in op_desc.outputs.items():
        vals = outs.get(slot, [])
        if len(vals) != len(names):
            continue
        for n, val in zip(names, vals):
            if not block.has_var(n):
                continue
            v = block.var(n)
            v.desc.shape = _decode_shape(val.shape)
            v.desc.dtype = dtype_name(val.dtype)
    return True
