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

# Macro ops are interpreter-level: their impls receive the whole
# environment and the OpDesc (signature impl(ctx, env, desc) -> None,
# mutating env) so they can run sub-blocks (ops/control_flow.py).  The
# reference's interpreter-level control-flow operators (reference:
# paddle/fluid/operators/controlflow/while_op.cc:50 — ops that run
# sub-blocks through a nested Executor).  They stay out of `has_op`, so
# shape inference skips them, as the reference's does.
_MACRO_OPS: Dict[str, Any] = {}


def register_op(op_type: str):
    """Decorator registering an implementation for `op_type`."""

    def deco(fn: OpImpl) -> OpImpl:
        if op_type in _REGISTRY:
            raise ValueError(f"op {op_type!r} registered twice")
        _REGISTRY[op_type] = fn
        return fn

    return deco


def register_macro_op(op_type: str):
    """Decorator registering an interpreter-level (env + sub-block) op."""

    def deco(fn):
        if op_type in _MACRO_OPS or op_type in _REGISTRY:
            raise ValueError(f"op {op_type!r} registered twice")
        _MACRO_OPS[op_type] = fn
        return fn

    return deco


def is_macro_op(op_type: str) -> bool:
    return op_type in _MACRO_OPS


def get_macro_op_impl(op_type: str):
    return _MACRO_OPS[op_type]


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

# Folded into the seed material of sub-block b as SUB_BLOCK_SEED_BASE + b
# (the reference's fold_in(key, 7919 + block_idx), registry.py:131).
SUB_BLOCK_SEED_BASE = 7919


class OpContext:
    """Per-execution context handed to op impls.

    `rng()` gives each op its own deterministic `torch.Generator`,
    derived from the run's seed material (the program's random seed and
    the executor's run counter, then any folds: under gradient
    accumulation the micro-batch's, inside a control-flow sub-block the
    block's) and the op's index — the port of the reference's per-op
    `jax.random.fold_in(step_key, op_index)`.  The
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
    order, by the row count), `layer_norm` its statistics (torch's row
    reduction picks its thread layout by the row count below 16 rows)
    and `paged_attention` launches with the split plan of `row_block`
    rows.  The speculative decode engine sets it to the slot count, so
    its verify run at S*(k+1) rows gives each row the bits of the step
    run at S rows; a disagg decode worker's steps take the prefill
    workers' slot count (serving/decode.py, ROADMAP C8, C15).

    `cross_rank` (None: off) is a `parallel.collectives.DataGroup`, given
    by a data-parallel step to an op that reduces over the batch dim
    (its cross-rank branch computes the global value), to `dropout`
    (which draws the global batch's mask and keeps its rows) and to an
    update op running on ZeRO slices (`lars_momentum` sums its norms
    over the slice's group); parallel/data_parallel.py.
    """

    def __init__(self, seed=None, op_index: int = 0, is_test: bool = False,
                 program=None, device=None, sparse_rows=None,
                 amp_lists=None, row_block=None, cross_rank=None):
        self._seed = seed
        self.cross_rank = cross_rank
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
        for fold in self._seed[2:]:
            # a micro-batch of gradient accumulation or a sub-block:
            # its number folded in, so each draws its own streams
            seed = (seed * 1000033 + int(fold)) & _SEED_MASK
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        return gen

    def run_block(self, block_idx: int, env):
        """Run a sub-block's ops over `env` (mutated in place), on this
        context's device, `row_block` and AMP lists.  Used by the
        control-flow macro ops (the reference's `run_block`,
        registry.py:111-134).

        The sub-block draws its own streams: SUB_BLOCK_SEED_BASE +
        block_idx is folded into the seed material, and each op's
        index within the block picks its stream.  Nothing folds in the
        iteration, so every iteration of a loop draws the same streams,
        as the reference's loop body, traced once with one key, does.
        No sparse rows go down: the Executor keys them by block-0 op
        index, which a sub-block's block-local indices would collide
        with (the reference passes none either).  The numerics bitmap
        is popped from `env`: sub-block op indices are block-local, so
        the owning macro op's bit stands for them."""
        from ..observe.numerics import NUMERICS_BITS_VAR
        from .executor import run_ops

        if self.program is None:
            raise RuntimeError("OpContext has no program; sub-block "
                               "execution requires a program")
        env.pop(NUMERICS_BITS_VAR, None)
        sub_seed = (None if self._seed is None
                    else tuple(self._seed)
                    + (SUB_BLOCK_SEED_BASE + block_idx,))
        run_ops(self.program.blocks[block_idx].ops, env, sub_seed,
                program=self.program, device=self.device,
                row_block=self.row_block)
        return env
