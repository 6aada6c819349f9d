"""Operator registry: op type name → torch implementation.

The port of paddle_tpu/core/registry.py (reference:
paddle/fluid/framework/op_registry.h:197,237,240 — REGISTER_OPERATOR /
REGISTER_OP_*_KERNEL).  Same API and the same op names; an impl is a
plain function on torch tensors, and the tensors' device picks the
kernel (ops/kernels/ routes a CUDA tensor to its hand-written kernel and
a CPU tensor to the kernel's plain version).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

import torch

# impl signature: impl(ctx, ins: Dict[slot, List[Tensor]], attrs: Dict) ->
#                 Dict[slot, List[Tensor]]
OpImpl = Callable[..., Dict[str, List[Any]]]

_REGISTRY: Dict[str, OpImpl] = {}


def register_op(op_type: str):
    """Decorator registering an implementation for `op_type`."""

    def deco(fn: OpImpl) -> OpImpl:
        if op_type in _REGISTRY:
            raise ValueError(f"op {op_type!r} registered twice")
        _REGISTRY[op_type] = fn
        return fn

    return deco


def get_op_impl(op_type: str) -> OpImpl:
    impl = _REGISTRY.get(op_type)
    if impl is None:
        raise NotImplementedError(
            f"no implementation registered for op {op_type!r} in "
            f"paddle_tpu_torch (ROADMAP queue A lists the ops still to "
            f"port); known ops: {sorted(_REGISTRY)}")
    return impl


def has_op(op_type: str) -> bool:
    return op_type in _REGISTRY


def registered_ops() -> List[str]:
    return sorted(_REGISTRY)


# 2**63 - 1: torch.Generator seeds are taken modulo this
_SEED_MASK = (1 << 63) - 1


class OpContext:
    """Per-execution context handed to op impls.

    `rng()` gives each op its own deterministic `torch.Generator`,
    derived from the run's seed material (the program's random seed and
    the executor's run counter, and under gradient accumulation the
    micro-batch's index) and the op's index — the port of the
    reference's per-op `jax.random.fold_in(step_key, op_index)`.  The
    streams differ from jax's threefry bits by construction, so parity
    tests carry parameters across (convert.py) instead of re-drawing
    them.

    `device` None means CUDAPlace(0) and raises when CUDA is not
    available (`executor.place_device`); the CPU runs only when asked
    for.

    `amp_lists` is the program's bf16 policy (amp.py) when it has one,
    else None, as in the reference's OpContext.

    `sparse_rows` maps the op index of each is_sparse lookup on the
    SparseGrad path to the rows the Executor gathered for it (the
    autograd leaves the table's gradient is taken through); None
    elsewhere.

    `row_block` (None: off) asks the ops whose row results depend on how
    many rows run together for batch invariance: each row is computed
    as in a run of `row_block` rows.  `mul` runs its product in blocks
    of `row_block` rows (cuBLAS picks its kernel, and so its summation
    order, by the row count) and `paged_attention` launches with the
    split plan of `row_block` rows.  The speculative decode engine sets
    it to the slot count, so its verify run at S*(k+1) rows gives each
    row the bits of the step run at S rows (serving/decode.py).
    """

    def __init__(self, seed=None, op_index: int = 0, is_test: bool = False,
                 program=None, device=None, sparse_rows=None,
                 amp_lists=None, row_block=None):
        self._seed = seed
        self.op_index = op_index
        self.is_test = is_test
        self.program = program
        self.amp_lists = amp_lists
        self.sparse_rows = sparse_rows
        self.row_block = row_block
        if device is None:
            # no implicit CPU: None is CUDAPlace(0), as for the Executor
            from .executor import place_device

            self.device = place_device(None)
        else:
            self.device = torch.device(device)

    def rng(self) -> Optional[torch.Generator]:
        """A generator unique to this op within the run, on the run's
        device (None under shape inference, where tensors are on the
        "meta" device and hold no values)."""
        if self.device.type == "meta":
            return None
        if self._seed is None:
            raise RuntimeError(
                "op requested randomness but the executor has no RNG "
                "state")
        base, run = self._seed[:2]
        seed = ((int(base) * 1000003 + int(run)) * 7919
                + self.op_index) & _SEED_MASK
        if len(self._seed) > 2:
            # a micro-batch of gradient accumulation: its index folded
            # in, so each micro-batch draws its own streams
            seed = (seed * 1000033 + int(self._seed[2])) & _SEED_MASK
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        return gen
