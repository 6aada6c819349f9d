"""Divergence autopilot: anomaly-triggered in-run rollback-and-replay
— a copy of paddle_tpu/resilience/autopilot.py (host-only, it imports
nothing of jax), reading the port's StepTelemetry windows and running
the port's observe.alerts AnomalyRule.

The observe stack *detects* every training pathology (guard skip
counters, latched first-nonfinite op provenance, z-score anomaly rules);
`RecoveryController` *recovers* from one with a bounded escalation
ladder, driven by contrib.Trainer:

1. ABSORB — the in-step update guard / dynamic loss scale already
   neutralizes transient non-finite steps on the card; below the
   configured streak nothing else happens.
2. ROLLBACK — after `skip_streak` consecutive guard-skipped steps, a
   latched non-finite window, or a loss/grad-norm z-trip (the same
   `AnomalyRule` machinery the AlertEngine runs, evaluated
   synchronously on each telemetry window), the Trainer restores the
   newest *verified-good* checkpoint IN PROCESS (the program was built
   under `unique_name.guard()`, so the restored arrays bind to the same
   variables — the contrib/trainer.py resume contract).
3. QUARANTINE — the data window between the rollback cursor and the
   failure step is never re-trained: the replay fast-forwards the
   resume cursor past those batches, records which, and optionally
   backs the learning rate off on re-entry.
4. HALT — when the rollback budget is exhausted (or no verified-good
   serial exists) the run stops with a structured
   `TrainingDivergedError` carrying full provenance plus a
   FlightRecorder bundle, instead of skipping updates forever.

Discipline: the controller is PURE HOST and consumes only the telemetry
windows the Trainer already fetches (device-accumulate, periodic-fetch —
never per-step).  It launches nothing and the step runs the same
kernels with the autopilot on or off.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

from .errors import TrainingDivergedError  # noqa: F401  (re-export)


class AutopilotConfig:
    """Escalation-ladder policy for one training run.

    skip_streak: consecutive guard-skipped/non-finite steps (summed
        across telemetry windows; reset by any clean window) that
        escalate from rung 1 (absorb) to rung 2 (rollback).
    loss_spike_z / grad_norm_z: z-score thresholds for the window-mean
        loss ("above") and last grad norm ("both") anomaly rules —
        the finite-divergence triggers the guard cannot see.  None
        disables a rule.
    min_baseline_windows: telemetry windows an anomaly rule absorbs
        into its baseline before it may trip (AnomalyRule
        min_samples).
    max_rollbacks: rollback budget per run; once spent (or with 0),
        the next trigger halts with TrainingDivergedError.
    lr_backoff: optional multiplier (< 1.0) applied to every
        `.learning_rate` variable after a rollback restore — re-entry
        at a gentler step size.  None keeps the LR bit-identical,
        which the chaos parity proof requires.
    """

    def __init__(self, skip_streak: int = 2,
                 loss_spike_z: Optional[float] = 8.0,
                 grad_norm_z: Optional[float] = 8.0,
                 min_baseline_windows: int = 5,
                 max_rollbacks: int = 2,
                 lr_backoff: Optional[float] = None):
        if skip_streak < 1:
            raise ValueError("skip_streak must be >= 1")
        if max_rollbacks < 0:
            raise ValueError("max_rollbacks must be >= 0")
        if lr_backoff is not None and not 0.0 < lr_backoff <= 1.0:
            raise ValueError("lr_backoff must be in (0, 1]")
        self.skip_streak = int(skip_streak)
        self.loss_spike_z = loss_spike_z
        self.grad_norm_z = grad_norm_z
        self.min_baseline_windows = int(min_baseline_windows)
        self.max_rollbacks = int(max_rollbacks)
        self.lr_backoff = lr_backoff


class RecoveryController:
    """Host-side state machine of the autopilot (one per Trainer).

    The Trainer feeds it two streams: `note_checkpoint` after every
    save (with the verified-good verdict) and `observe_window` after
    every telemetry publish.  `observe_window` returns None while the
    guard is absorbing, or a trigger dict once the ladder escalates —
    the Trainer then performs the rollback (it owns the scope and the
    checkpoint files) and reports back via `on_rollback`.
    """

    def __init__(self, config: Optional[AutopilotConfig] = None):
        self.cfg = config or AutopilotConfig()
        self.rollbacks = 0
        self.halted = False
        self.skip_streak = 0
        self.windows_seen = 0
        self.quarantined_batches = 0
        self.quarantine_windows: List[Dict[str, int]] = []
        self.last_trigger: Optional[Dict[str, Any]] = None
        # newest-last [(serial, epoch, step_in_epoch)] of serials whose
        # trailing telemetry window was clean — the rollback anchors
        self._verified: List[Tuple[int, int, int]] = []
        self._rules = self._build_rules()

    # -- z-rules (the AlertEngine's AnomalyRule, run synchronously) ----
    def _build_rules(self):
        from ..observe.alerts import AnomalyRule

        rules = []
        c = self.cfg
        if c.loss_spike_z is not None:
            rules.append(AnomalyRule(
                "autopilot_loss_spike",
                lambda s: s.get("loss_mean"),
                z=c.loss_spike_z, direction="above",
                min_samples=c.min_baseline_windows,
                description="window-mean loss spiked vs baseline"))
        if c.grad_norm_z is not None:
            rules.append(AnomalyRule(
                "autopilot_grad_norm",
                lambda s: s.get("grad_norm"),
                z=c.grad_norm_z, direction="both",
                min_samples=c.min_baseline_windows,
                description="grad-norm excursion vs baseline"))
        return rules

    # -- checkpoint stream ---------------------------------------------
    def note_checkpoint(self, serial: int, epoch: int, step: int,
                        verified: bool) -> None:
        if verified:
            self._verified.append((int(serial), int(epoch), int(step)))

    def verified_serials(self) -> List[Tuple[int, int, int]]:
        """Rollback candidates, oldest-first (Trainer walks them
        newest-first, falling past serials that fail to load)."""
        return list(self._verified)

    def forget_serial(self, serial: int) -> None:
        """Drop a serial that turned out unloadable (torn/corrupt on
        disk despite its clean marking)."""
        self._verified = [v for v in self._verified if v[0] != serial]

    # -- telemetry stream ----------------------------------------------
    @property
    def healthy(self) -> bool:
        """No unresolved anomaly: clean streak, no firing z-rule, not
        halted.  Gates the verified-good marking of saves."""
        if self.halted or self.skip_streak > 0:
            return False
        return all(r.state != "firing" for r in self._rules)

    def observe_window(self, tel, epoch: int, step: int
                       ) -> Optional[Dict[str, Any]]:
        """Consume one published StepTelemetry window.  Returns None
        (keep training) or a trigger dict naming the signal that
        escalated past rung 1."""
        import math

        self.windows_seen += 1
        poisoned_steps = max(
            int(tel.skipped_update_steps),
            int(tel.nonfinite_grad_steps),
            int(tel.nonfinite_loss_steps),
            1 if tel.first_nonfinite_op is not None else 0)
        if poisoned_steps > 0:
            self.skip_streak += poisoned_steps
        else:
            self.skip_streak = 0
        trigger: Optional[Dict[str, Any]] = None
        if self.skip_streak >= self.cfg.skip_streak:
            trigger = {"signal": "skip_streak",
                       "streak": self.skip_streak,
                       "first_nonfinite_op": tel.first_nonfinite_op}
        # z-rules see only finite samples: a NaN window already trips
        # the streak path above, and a NaN in the rolling baseline
        # would poison the z-score of every later window
        snapshot = {}
        for key, v in (("loss_mean", tel.loss_mean),
                       ("grad_norm", tel.grad_norm_last)):
            if v is not None and math.isfinite(float(v)):
                snapshot[key] = float(v)
        for rule in self._rules:
            rule.step(snapshot, now=float(self.windows_seen))
            if rule.state == "firing" and trigger is None:
                trigger = {"signal": rule.id, "z": rule.value,
                           "sample": rule.sample,
                           "first_nonfinite_op": tel.first_nonfinite_op}
        if trigger is not None:
            trigger.update(epoch=epoch, step=step)
            self.last_trigger = dict(trigger)
        return trigger

    def on_rollback(self, window: Dict[str, int]) -> None:
        """The Trainer restored a verified-good serial: consume one
        budget unit, record the quarantined window, and restart the
        anomaly baselines (re-entry begins a fresh regime — keeping a
        baseline that straddles the divergence would re-trip on the
        first healthy window)."""
        self.rollbacks += 1
        self.skip_streak = 0
        self.quarantine_windows.append(dict(window))
        self._rules = self._build_rules()

    def note_quarantined_feed(self, n: int = 1) -> None:
        """Admission-rejected batches (Trainer(validate_feed=True))
        join the same quarantine ledger —
        poison stopped at the door instead of after a device step."""
        self.quarantined_batches += int(n)

    # -- export ---------------------------------------------------------
    def snapshot(self) -> Dict[str, Any]:
        """The metrics-collector view (observe.registry
        recovery_collector) — plain scalars only."""
        return {
            "rollbacks": self.rollbacks,
            "budget": self.cfg.max_rollbacks,
            "halted": int(self.halted),
            "skip_streak": self.skip_streak,
            "quarantined_batches": self.quarantined_batches,
            "quarantine_windows": len(self.quarantine_windows),
            "verified_serials": len(self._verified),
        }
