"""In-step update guard: skip non-finite optimizer updates on device.

The port of paddle_tpu/resilience/guard.py.  A single NaN/Inf step
corrupts training silently — telemetry *counts* nonfinite grads
(observe/metrics.py) but the optimizer applies them anyway, and every
parameter is NaN one step later.  The guard closes that hole INSIDE the
step, on the card, with no host round-trip (no `.item()`, no
`bool(tensor)`, no Python branch on a device value):

1. after gradients are computed, an all-finite reduction runs over the
   loss and every gradient leaf (SparseGrad rows included),
2. the optimizer/update ops execute unconditionally, then every value
   they wrote is `torch.where(all_finite, new, old)`-selected against
   its pre-update snapshot — a poisoned step is a full state no-op,
3. the telemetry accumulator (`__telemetry__`, which the guard rides)
   gains `skipped_update_steps` plus the dynamic loss-scale state.

Dynamic loss scaling (`amp.decorate(..., use_dynamic_loss_scaling=
True)`, the fp16/bf16 underflow story): the loss is multiplied by a
device-resident scale before autodiff, gradients are unscaled before
the finite check and the update ops, and the scale adapts — halved
(decr_ratio) after `decr_every_n_nan_or_inf` consecutive overflow
steps, multiplied by incr_ratio after `incr_every_n_steps` consecutive
good steps (reference: fluid's update_loss_scaling op semantics).

The executor's training step (`core/executor.py _train_step`) calls
the helpers below; everything here is torch ops on the step's device.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional

import torch


@dataclass
class LossScaleConfig:
    """Dynamic loss-scale schedule (reference: fluid
    update_loss_scaling_op attrs)."""

    init_loss_scaling: float = 2.0 ** 15
    incr_every_n_steps: int = 1000
    decr_every_n_nan_or_inf: int = 1
    incr_ratio: float = 2.0
    decr_ratio: float = 0.5
    min_loss_scaling: float = 1.0
    max_loss_scaling: float = 2.0 ** 24

    def __post_init__(self):
        if self.init_loss_scaling <= 0:
            raise ValueError("init_loss_scaling must be > 0")
        if self.incr_every_n_steps < 1 or self.decr_every_n_nan_or_inf < 1:
            raise ValueError("loss-scale step intervals must be >= 1")
        if not (self.incr_ratio > 1.0 and 0.0 < self.decr_ratio < 1.0):
            raise ValueError("need incr_ratio > 1 and 0 < decr_ratio < 1")


class UpdateGuardConfig:
    """Program-level guard switch; `loss_scaling=None` guards updates
    at scale 1.0 (finite-check only)."""

    def __init__(self, loss_scaling: Optional[LossScaleConfig] = None):
        self.loss_scaling = loss_scaling

    @property
    def init_loss_scale(self) -> float:
        return (self.loss_scaling.init_loss_scaling
                if self.loss_scaling else 1.0)


def enable_update_guard(program,
                        loss_scaling: Optional[LossScaleConfig] = None
                        ) -> UpdateGuardConfig:
    """Opt a Program's training step into the non-finite update guard.

    Implies device-side telemetry (the skip counter and loss-scale
    scalar live in the `__telemetry__` scope entry).  Bumps the program
    version, as the reference does."""
    from ..observe import metrics as _metrics

    cfg = UpdateGuardConfig(loss_scaling)
    program._update_guard = cfg
    _metrics.enable_telemetry(program)
    program._bump()
    return cfg


def guard_config(program) -> Optional[UpdateGuardConfig]:
    return getattr(program, "_update_guard", None)


# ---------------------------------------------------------------------------
# Step helpers (called from core/executor.py; device ops only)
# ---------------------------------------------------------------------------

def _float_leaves(grads: Dict[str, Any]):
    from ..core.selected_rows import SparseGrad

    for g in grads.values():
        yield g.rows if isinstance(g, SparseGrad) else g


def all_finite(loss, grads: Dict[str, Any]) -> torch.Tensor:
    """0-dim bool on the device: loss and every gradient leaf finite.
    SparseGrad contributes its rows (ids are ints, always finite)."""
    ok = torch.isfinite(loss).all()
    for a in _float_leaves(grads):
        ok = ok & torch.isfinite(a).all()
    return ok


def scale_grads(grads: Dict[str, Any], factor) -> Dict[str, Any]:
    """grads * factor (a 0-dim float32 tensor), preserving SparseGrad
    structure and leaf dtypes (the multiply must not upcast bf16
    leaves)."""
    from ..core.selected_rows import SparseGrad

    def one(g):
        if isinstance(g, SparseGrad):
            return SparseGrad(g.ids, (g.rows * factor).to(g.rows.dtype),
                              g.dense_shape)
        return (g * factor).to(g.dtype)

    return {k: one(g) for k, g in grads.items()}


def snapshot_env(env: Dict[str, Any], names) -> Dict[str, Any]:
    """Pre-update values of every tensor env entry in `names` — what a
    skipped step rolls back to.  The update ops return new tensors and
    never write into their inputs, so holding the references is the
    snapshot."""
    return {n: env[n] for n in names
            if n in env and isinstance(env[n], torch.Tensor)}


def select_updates(finite, env: Dict[str, Any],
                   pre: Dict[str, Any]) -> None:
    """env[n] = where(finite, updated, pre-update) for every
    snapshotted name the update ops rewrote — pure selects on the
    device, no host branch."""
    for n, old in pre.items():
        new = env.get(n)
        if new is None or new is old:
            continue
        env[n] = torch.where(finite, new, old).to(new.dtype)


def guard_telemetry_update(tel: Dict[str, Any], finite,
                           cfg: UpdateGuardConfig) -> Dict[str, Any]:
    """Accumulate the skip counter and advance the loss-scale schedule,
    on the device."""
    out = dict(tel)
    out["skipped_update_steps"] = (tel["skipped_update_steps"]
                                   + (~finite).to(torch.int32))
    ls = cfg.loss_scaling
    if ls is None:
        return out
    scale = tel["loss_scale"].to(torch.float32)
    good = tel["ls_good_steps"].to(torch.int32)
    bad = tel["ls_bad_steps"].to(torch.int32)
    zero = torch.zeros_like(good)
    good = torch.where(finite, good + 1, zero)
    bad = torch.where(finite, zero, bad + 1)
    decr = bad >= ls.decr_every_n_nan_or_inf
    scale = torch.where(
        decr, torch.clamp(scale * ls.decr_ratio, min=ls.min_loss_scaling),
        scale)
    bad = torch.where(decr, zero, bad)
    incr = good >= ls.incr_every_n_steps
    scale = torch.where(
        incr, torch.clamp(scale * ls.incr_ratio, max=ls.max_loss_scaling),
        scale)
    good = torch.where(incr, zero, good)
    out["loss_scale"] = scale
    out["ls_good_steps"] = good
    out["ls_bad_steps"] = bad
    return out
