"""Model-compression framework: pruning passes + distillation helpers —
the port of paddle_tpu/contrib/slim.py.

reference: python/paddle/fluid/contrib/slim/ — core/compress_pass.py:1
(CompressPass/Context driving strategies through epoch/batch events),
core/strategy.py (Strategy event hooks), prune/pruner.py:1
(MagnitudePruner/RatioPruner producing zero-masks),
prune/prune_strategy.py:38 (PruneStrategy re-applying masks every K
batches so pruned weights stay dead through fine-tuning).

As in paddle_tpu: the reference built throwaway mask programs and ran
them through a graph executor per trigger; here parameters live as
device tensors in the Scope, so a pruning pass computes masks with torch
ops on the parameter's own device and writes `param * mask` back between
steps — no extra program build, no weights to the host (`sparsity` reads
one count per parameter).  Sparsity is *simulated* via zero weights (the
reference did the same): the steps run dense kernels, so the win is
model size / distillation-target quality, not FLOPs.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from ..core.executor import global_scope
from ..core.program import Parameter, default_main_program

__all__ = ["Pruner", "MagnitudePruner", "RatioPruner", "SlimContext",
           "PruneStrategy", "CompressPass", "Strategy",
           "sparsity", "distillation_loss"]


# ---------------------------------------------------------------------------
# Pruners: parameter -> 0/1 keep-mask
# ---------------------------------------------------------------------------

class Pruner:
    """Base pruner (reference prune/pruner.py Pruner)."""

    def mask(self, value, name: str = ""):
        """value: device tensor (+ the parameter's name, for pruners
        with per-name policies) -> 0/1 keep-mask of the same shape."""
        raise NotImplementedError


class MagnitudePruner(Pruner):
    """Keep weights with |w| >= threshold (reference MagnitudePruner —
    whose less_than mask keeps small weights zeroed)."""

    def __init__(self, threshold: float):
        self.threshold = float(threshold)

    def mask(self, value, name: str = ""):
        return (value.abs() >= self.threshold).to(value.dtype)


class RatioPruner(Pruner):
    """Prune the smallest-|w| `ratio` fraction per parameter (reference
    RatioPruner's per-param ratios; a float applies to every param, a
    dict overrides per name)."""

    def __init__(self, ratio: float = 0.5,
                 ratios: Optional[Dict[str, float]] = None):
        self.ratio = float(ratio)
        self.ratios = dict(ratios or {})

    def ratio_for(self, name: str) -> float:
        return float(self.ratios.get(name, self.ratio))

    def mask(self, value, name: str = ""):
        import torch

        r = self.ratio_for(name)
        if r <= 0:
            return torch.ones_like(value)
        k = int(np.floor(value.numel() * r))
        if k <= 0:
            return torch.ones_like(value)
        flat = value.abs().reshape(-1)
        # threshold = k-th smallest magnitude (inclusive): exactly k
        # entries prune when magnitudes are distinct
        thresh = torch.kthvalue(flat, k).values
        return (value.abs() > thresh).to(value.dtype)


# ---------------------------------------------------------------------------
# Strategies + compress pass
# ---------------------------------------------------------------------------

class Strategy:
    """Event-hook base (reference core/strategy.py): override any of
    the on_* callbacks; active inside [start_epoch, end_epoch)."""

    def __init__(self, start_epoch: int = 0, end_epoch: int = 10):
        self.start_epoch = int(start_epoch)
        self.end_epoch = int(end_epoch)

    def on_compress_begin(self, context):
        pass

    def on_epoch_begin(self, context):
        pass

    def on_epoch_end(self, context):
        pass

    def on_batch_begin(self, context):
        pass

    def on_batch_end(self, context):
        pass

    def on_compress_end(self, context):
        pass


class SlimContext:
    """Compression state handed to strategy hooks (reference
    core/compress_pass.py Context)."""

    def __init__(self, exe, program, scope):
        self.exe = exe
        self.program = program
        self.scope = scope
        self.epoch = 0
        self.epoch_id = 0
        self.batch_id = 0
        self.last_fetch = None


class PruneStrategy(Strategy):
    """Iterative magnitude pruning (reference
    prune/prune_strategy.py:38): every `frequency` batches inside the
    active window, recompute masks and zero the pruned weights — the
    optimizer may revive them between triggers, the re-application
    keeps them dead, and after end_epoch the final masks are pinned via
    on_compress_end."""

    def __init__(self, pruner: Pruner, params: Optional[Sequence[str]]
                 = None, mini_batch_pruning_frequency: int = 1,
                 start_epoch: int = 0, end_epoch: int = 10):
        super().__init__(start_epoch, end_epoch)
        self.pruner = pruner
        self.params = list(params) if params is not None else None
        self.frequency = max(1, int(mini_batch_pruning_frequency))
        self.masks: Dict[str, object] = {}

    def _target_params(self, context) -> List[str]:
        if self.params is not None:
            return self.params
        return [v.name for v in context.program.list_vars()
                if isinstance(v, Parameter)]

    def apply_masks(self, context):
        """Recompute masks from current magnitudes and zero the pruned
        entries in the scope (device-side multiply)."""
        for name in self._target_params(context):
            val = context.scope.find_var(name)
            if val is None:
                continue
            m = self.pruner.mask(val, name)
            self.masks[name] = m
            context.scope.set_var(name, val * m)

    def reapply(self, context):
        """Re-zero with the LAST computed masks (no recompute) — used
        after optimizer steps once pruning has converged."""
        for name, m in self.masks.items():
            val = context.scope.find_var(name)
            if val is not None:
                context.scope.set_var(name, val * m)

    def on_batch_end(self, context):
        if not (self.start_epoch <= context.epoch_id < self.end_epoch):
            return
        if context.batch_id % self.frequency == 0:
            self.apply_masks(context)
        else:
            self.reapply(context)

    def on_compress_end(self, context):
        self.reapply(context)


class CompressPass:
    """Drive a training loop while strategies compress the model
    (reference core/compress_pass.py CompressPass.apply/run).

    reader: callable -> iterable of feed dicts; fetch_list: vars to
    fetch per batch (last fetch lands in context.last_fetch)."""

    def __init__(self, executor, program=None, scope=None,
                 strategies: Optional[Sequence[Strategy]] = None):
        self.exe = executor
        self.program = program or default_main_program()
        self.scope = scope or global_scope()
        self.strategies = list(strategies or [])

    def add_strategy(self, strategy: Strategy):
        self.strategies.append(strategy)
        return self

    def run(self, reader: Callable, epochs: int,
            fetch_list: Optional[Sequence] = None,
            event_handler: Optional[Callable] = None):
        ctx = SlimContext(self.exe, self.program, self.scope)
        ctx.epoch = epochs
        for s in self.strategies:
            s.on_compress_begin(ctx)
        for epoch in range(epochs):
            ctx.epoch_id = epoch
            for s in self.strategies:
                s.on_epoch_begin(ctx)
            for batch_id, feed in enumerate(reader()):
                ctx.batch_id = batch_id
                for s in self.strategies:
                    s.on_batch_begin(ctx)
                ctx.last_fetch = self.exe.run(
                    self.program, feed=feed,
                    fetch_list=list(fetch_list or []), scope=self.scope)
                for s in self.strategies:
                    s.on_batch_end(ctx)
                if event_handler:
                    event_handler(ctx)
            for s in self.strategies:
                s.on_epoch_end(ctx)
        for s in self.strategies:
            s.on_compress_end(ctx)
        return ctx


def sparsity(scope=None, params: Optional[Sequence[str]] = None,
             program=None) -> float:
    """Fraction of exactly-zero entries across the given params (all
    Parameters by default) — the measurement the reference's pruning
    demos report."""
    scope = scope or global_scope()
    if params is None:
        program = program or default_main_program()
        params = [v.name for v in program.list_vars()
                  if isinstance(v, Parameter)]
    zeros = total = 0
    for name in params:
        val = scope.find_var(name)
        if val is None:
            continue
        zeros += int((val == 0).sum())
        total += val.numel()
    return zeros / max(total, 1)


# ---------------------------------------------------------------------------
# Distillation
# ---------------------------------------------------------------------------

def distillation_loss(student_logits, teacher_logits, temperature=2.0,
                      hard_loss=None, soft_weight=0.7):
    """Hinton soft-target distillation loss, composed in-graph.

    L = soft_weight * T^2 * KL(softmax(t/T) || softmax(s/T))
        + (1 - soft_weight) * hard_loss

    The T^2 factor keeps soft-gradient magnitudes comparable across
    temperatures (Hinton et al., 2015).  teacher_logits should come
    from a frozen teacher branch (build it under stop_gradient or a
    separate for_test program).  reference analog: contrib/slim's
    distillation strategies (the framework shipped the pass plumbing;
    the loss is the standard one)."""
    from .. import layers

    t = float(temperature)
    s_scaled = layers.scale(student_logits, scale=1.0 / t)
    t_scaled = layers.scale(teacher_logits, scale=1.0 / t)
    # KL(teacher || student) = sum p_t * (log p_t - log p_s); the
    # log p_t entropy term is constant w.r.t. the student but keeps the
    # reported loss >= 0 and -> 0 at a perfect match
    p_t = layers.softmax(t_scaled)
    log_p_t = layers.log_softmax(t_scaled)
    log_p_s = layers.log_softmax(s_scaled)
    kl = layers.reduce_sum(
        layers.elementwise_mul(
            p_t, layers.elementwise_sub(log_p_t, log_p_s)),
        dim=[-1])
    soft = layers.scale(layers.reduce_mean(kl), scale=t * t)
    if hard_loss is None:
        return soft
    w = float(soft_weight)
    return layers.elementwise_add(
        layers.scale(soft, scale=w),
        layers.scale(hard_loss, scale=1.0 - w))
