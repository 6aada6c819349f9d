"""Op harness for the PyTorch port (the counterpart of op_test.py).

`run_torch_op` runs one registered op impl of paddle_tpu_torch on numpy
inputs, on the CPU, and returns numpy — so a test hands the SAME numpy
inputs to `op_test.run_op` (the JAX package) and to this, and compares.
bfloat16 has no numpy dtype here: pass float32 values already rounded to
bfloat16 (`round_bf16`) plus `dtypes={slot: torch.bfloat16}`.
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
    impl = get_op_impl(op_type)
    dtypes = dtypes or {}
    ins = {}
    for slot, v in ins_np.items():
        vs = v if isinstance(v, (list, tuple)) else [v]
        ins[slot] = [to_torch(a, dtypes.get(slot)) for a in vs]
    ctx = OpContext((0, 0), 0, device="cpu")
    outs = impl(ctx, ins, dict(attrs or {}))
    return to_numpy(outs[out_slot][0])
