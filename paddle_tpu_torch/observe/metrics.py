"""StepTelemetry: device-side training-health accumulator.

The port of paddle_tpu/observe/metrics.py.  Per-step scalars (loss,
grad norm, update norm, non-finite counts) ACCUMULATE ON THE CARD as
torch tensors on the executor's device and are fetched every N steps
in one host sync ("device-accumulate, periodic-fetch").  The
accumulator is a flat dict of 0-dim (and, with numerics, small vector)
tensors living in the scope under `TELEMETRY_VAR`;
`core/executor.py` seeds it before a step and carries it through the
step (and through `iterations=K`, so K iterations accumulate K
updates).  Nothing here reads a device value on the host during a step
— no `.item()`, no `bool(tensor)`, no Python branch on a tensor: only
`fetch_telemetry` does, once per window.

reference analog: the reference's per-op NaN scan ran on HOST after
every op (operator.cc:943 FLAGS_check_nan_inf), a per-step
device->host sync here.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional

import numpy as np
import torch

TELEMETRY_VAR = "__telemetry__"

_F32_FIELDS = ("loss_sum", "loss_last", "grad_norm_sum", "grad_norm_last",
               "update_norm_sum", "update_norm_last")
_I32_FIELDS = ("steps", "nonfinite_grad_steps", "nonfinite_loss_steps",
               "skipped_update_steps")
# update-guard state (resilience/guard.py) rides the same accumulator
# but is NOT a window counter: a telemetry reset must preserve it, or
# the loss-scale schedule would restart every fetch
_PERSISTENT_FIELDS = ("loss_scale", "ls_good_steps", "ls_bad_steps")


def enable_telemetry(program) -> None:
    """Opt a Program's training step into device-side telemetry (the
    executor seeds the accumulator on the next run)."""
    program._telemetry_enabled = True


def telemetry_enabled(program) -> bool:
    return bool(getattr(program, "_telemetry_enabled", False))


def init_telemetry(loss_scale: float = 1.0,
                   device=None) -> Dict[str, torch.Tensor]:
    """Fresh zeroed accumulator on `device` (None: CUDAPlace(0), as for
    the Executor).  `loss_scale` seeds the dynamic loss-scale scalar
    (resilience update guard); 1.0 = inert."""
    from ..core.executor import _run_device

    dev = _run_device(device)
    out = {f: torch.zeros((), dtype=torch.float32, device=dev)
           for f in _F32_FIELDS}
    out.update({f: torch.zeros((), dtype=torch.int32, device=dev)
                for f in _I32_FIELDS})
    out["loss_scale"] = torch.tensor(loss_scale, dtype=torch.float32,
                                     device=dev)
    out["ls_good_steps"] = torch.zeros((), dtype=torch.int32, device=dev)
    out["ls_bad_steps"] = torch.zeros((), dtype=torch.int32, device=dev)
    return out


def init_telemetry_for(program, device=None) -> Dict[str, torch.Tensor]:
    """Accumulator sized for one program: guard loss-scale seed plus,
    when the program opted into numerics observability
    (observe.numerics), the per-group vectors and the latched
    first-nonfinite bitmap (one bit per fluid op)."""
    guard_cfg = getattr(program, "_update_guard", None)
    out = init_telemetry(loss_scale=guard_cfg.init_loss_scale
                         if guard_cfg is not None else 1.0, device=device)
    if getattr(program, "_numerics_enabled", False):
        from . import numerics as _numerics

        out.update(_numerics.init_numerics_fields(
            len(program.global_block().ops), device=device))
    return out


def ensure_numerics_fields(program, tel: Dict[str, Any],
                           device=None) -> Dict[str, Any]:
    """Patch an EXISTING scope accumulator when numerics was enabled
    after telemetry already ran (or the program grew ops): merge in
    correctly-sized zeroed numerics fields, preserving every window
    counter and the guard's loss-scale schedule.  Returns `tel`
    unchanged when nothing is missing."""
    if not getattr(program, "_numerics_enabled", False):
        return tel
    from . import numerics as _numerics

    n_ops = len(program.global_block().ops)
    words = tel.get(_numerics.NONFINITE_WORDS)
    if words is not None and \
            words.shape[0] == _numerics.n_bit_words(n_ops):
        return tel
    out = dict(tel)
    out.update(_numerics.init_numerics_fields(n_ops, device=device))
    return out


def _grad_parts(g):
    """The float tensors of one gradient: a SparseGrad's rows (its
    touched rows carry the whole gradient mass), else the tensor."""
    from ..core.selected_rows import SparseGrad

    return (g.rows,) if isinstance(g, SparseGrad) else (g,)


def device_update(tel: Dict[str, torch.Tensor], loss, grads: Dict[str, Any],
                  params_before: Dict[str, torch.Tensor],
                  env: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """One step's accumulation, all on the device (no host read).
    grads may hold SparseGrads (the norm over their rows is the true
    table-grad norm up to duplicate-id merging)."""
    dev = tel["steps"].device
    gsq = torch.zeros((), dtype=torch.float32, device=dev)
    bad_grad = torch.zeros((), dtype=torch.bool, device=dev)
    for g in grads.values():
        for a in _grad_parts(g):
            af = a.float()
            gsq = gsq + torch.sum(af * af)
            bad_grad = bad_grad | ~torch.isfinite(af).all()
    usq = torch.zeros((), dtype=torch.float32, device=dev)
    for pname, old in params_before.items():
        new = env.get(pname)
        if new is None or new is old:
            continue
        d = new.float() - old.float()
        usq = usq + torch.sum(d * d)
    gnorm = torch.sqrt(gsq)
    unorm = torch.sqrt(usq)
    lf = loss.float().reshape(())
    loss_bad = (~torch.isfinite(lf)).to(torch.int32)
    out = dict(tel)  # guard/loss-scale fields pass through untouched
    out.update({
        "steps": tel["steps"] + 1,
        "loss_sum": tel["loss_sum"] + lf,
        "loss_last": lf,
        "grad_norm_sum": tel["grad_norm_sum"] + gnorm,
        "grad_norm_last": gnorm,
        "update_norm_sum": tel["update_norm_sum"] + unorm,
        "update_norm_last": unorm,
        "nonfinite_grad_steps": tel["nonfinite_grad_steps"]
        + bad_grad.to(torch.int32),
        "nonfinite_loss_steps": tel["nonfinite_loss_steps"] + loss_bad,
    })
    return out


@dataclass
class StepTelemetry:
    """Host-side view of one telemetry window (the periodic fetch)."""

    steps: int
    loss_last: float
    loss_mean: float
    grad_norm_last: float
    grad_norm_mean: float
    update_norm_last: float
    update_norm_mean: float
    nonfinite_grad_steps: int
    nonfinite_loss_steps: int
    # resilience update guard (0 / 1.0 when the guard is not enabled)
    skipped_update_steps: int = 0
    loss_scale: float = 1.0
    # numerics observability (observe.numerics; None when the program
    # did not opt in): per-group dynamics + first-nonfinite provenance
    groups: Optional[Dict[str, Dict[str, float]]] = None
    first_nonfinite_op: Optional[Dict[str, Any]] = None

    def as_dict(self) -> Dict[str, Any]:
        out = {
            "steps": self.steps,
            "loss_last": self.loss_last,
            "loss_mean": self.loss_mean,
            "grad_norm_last": self.grad_norm_last,
            "grad_norm_mean": self.grad_norm_mean,
            "update_norm_last": self.update_norm_last,
            "update_norm_mean": self.update_norm_mean,
            "nonfinite_grad_steps": self.nonfinite_grad_steps,
            "nonfinite_loss_steps": self.nonfinite_loss_steps,
            "skipped_update_steps": self.skipped_update_steps,
            "loss_scale": self.loss_scale,
        }
        if self.groups is not None:
            out["groups"] = self.groups
        if self.first_nonfinite_op is not None:
            out["first_nonfinite_op"] = self.first_nonfinite_op
        return out

    @property
    def healthy(self) -> bool:
        return (self.nonfinite_grad_steps == 0
                and self.nonfinite_loss_steps == 0)


def fetch_telemetry(scope, reset: bool = True,
                    program=None) -> Optional[StepTelemetry]:
    """The host sync: pull the device accumulator out of `scope`,
    convert to a window summary, and (by default) re-zero it on its
    device so the next window starts fresh.  Returns None when the
    scope carries no telemetry (program not enabled, or no step ran
    yet).

    `program`: when given and the window latched a nonfinite bitmap
    (observe.numerics), the first set bit is joined back to the fluid
    op desc — `first_nonfinite_op` then carries op type/index/group,
    not just the index."""
    raw = scope.find_var(TELEMETRY_VAR)
    if raw is None:
        return None
    host: Dict[str, Any] = {}
    for k, v in raw.items():
        a = v.detach().cpu().numpy()
        host[k] = a.item() if a.ndim == 0 else a
    if reset:
        # re-zero by SHAPE (scalars and numerics vectors alike) so the
        # next window starts fresh whatever fields this program carries
        scope.set_var(TELEMETRY_VAR, {
            k: v if k in _PERSISTENT_FIELDS else torch.zeros_like(v)
            for k, v in raw.items()})
    groups = first = None
    from . import numerics as _numerics

    if _numerics.NONFINITE_WORDS in host:
        # the words are int32 on the device (torch has no uint32
        # bitwise ops on every device): the same 32 bits, read unsigned
        host[_numerics.NONFINITE_WORDS] = np.asarray(
            host[_numerics.NONFINITE_WORDS], np.int32).view(np.uint32)
        groups = _numerics.summarize_groups(host)
        if int(host.get(_numerics.NONFINITE_LATCH, 0)):
            first = _numerics.join_first_nonfinite(
                host[_numerics.NONFINITE_WORDS], program=program)
    n = max(int(host["steps"]), 1)
    return StepTelemetry(
        steps=int(host["steps"]),
        loss_last=host["loss_last"],
        loss_mean=host["loss_sum"] / n,
        grad_norm_last=host["grad_norm_last"],
        grad_norm_mean=host["grad_norm_sum"] / n,
        update_norm_last=host["update_norm_last"],
        update_norm_mean=host["update_norm_sum"] / n,
        nonfinite_grad_steps=int(host["nonfinite_grad_steps"]),
        nonfinite_loss_steps=int(host["nonfinite_loss_steps"]),
        skipped_update_steps=int(host.get("skipped_update_steps", 0)),
        loss_scale=float(host.get("loss_scale", 1.0)),
        groups=groups,
        first_nonfinite_op=first,
    )
