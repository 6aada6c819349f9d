"""Carry weights across packages.

The one documented way weights enter the port from outside it: a mapping
of parameter name -> numpy array (for example a paddle_tpu scope taken
as `{n: np.asarray(v) for n, v in scope.vars.items()}`) becomes torch
tensors on a device, under the same names.  Parameter names are the
reference's by construction (the port builds the same programs), so no
renaming happens.  The executor's RNG state entry (`__rng_key__`) and
empty scope slots are not parameters and are left out; they may be
present in the mapping.

    arrays = {n: np.asarray(v) for n, v in jax_scope.vars.items()}
    params = convert.params_from_arrays(arrays, "cuda:0",
                                        program=lm.step["main"])
    engine = DecodeEngine(lm, cfg, params=params)
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from .core.executor import RNG_STATE_VAR
from .ops.common import to_torch_dtype


def params_from_arrays(arrays: Mapping[str, Any], device,
                       program=None) -> Dict[str, torch.Tensor]:
    """name -> array mapping -> name -> tensor on `device`.

    Each array keeps its shape; its dtype becomes the port's runtime
    dtype of the same name (64-bit names narrow to 32 bits, as in the
    reference).  With `program`, every persistable var of the program's
    global block must be present with its declared shape, and nothing
    else is carried over; a missing or misshapen parameter raises
    ValueError."""
    src = {n: np.asarray(v) for n, v in arrays.items()
           if v is not None and n != RNG_STATE_VAR}
    if program is not None:
        want = {v.name: tuple(v.shape)
                for v in program.global_block().vars.values()
                if v.persistable}
        missing = sorted(set(want) - set(src))
        if missing:
            raise ValueError(f"{len(missing)} parameter(s) missing from "
                             f"the arrays: {missing[:4]}")
        bad = [(n, want[n], src[n].shape) for n in want
               if tuple(src[n].shape) != want[n]]
        if bad:
            raise ValueError(f"parameter shape mismatch (name, declared, "
                             f"given): {bad[:4]}")
        src = {n: src[n] for n in want}
    return {n: torch.tensor(a, dtype=to_torch_dtype(a.dtype.name),
                            device=device)
            for n, a in src.items()}

