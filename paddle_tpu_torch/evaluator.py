"""Evaluator API (reference: python/paddle/fluid/evaluator.py:1): the
port of paddle_tpu/evaluator.py.

Two tiers, matching the reference:
- `fluid.metrics.*` python accumulators (the reference's recommended
  path — its evaluator docstrings say "Better to use fluid.metrics").
- IN-GRAPH evaluators carrying accumulator STATE as persistable graph
  variables updated by ops every step (reference evaluator.py
  ChunkEvaluator:251 with create_state + counter-sum ops): the
  counters are updated by the step's own ops on the device — no
  per-batch host round-trip — and eval() reads the device-resident
  totals.
"""

from __future__ import annotations

from .metrics import (Accuracy, Auc, DetectionMAP,  # noqa: F401
                      EditDistance, MetricBase)
from .metrics import ChunkEvaluator as PyChunkEvaluator  # noqa: F401


class Evaluator(MetricBase):
    """Historical extension base (reference evaluator.py Evaluator):
    subclasses implement update()/eval() like any MetricBase."""


class ChunkEvaluator:
    """In-graph chunk precision/recall/F1 (reference evaluator.py
    ChunkEvaluator:251): builds chunk_eval on (input, label), creates
    persistable counter states, and appends counter-accumulation ops to
    the CURRENT program — every executor step updates the totals on
    the device, as the step's own ops.  eval() computes P/R/F1 from the
    accumulated counters; reset() zeroes them.

    The python-accumulator variant remains available as
    fluid.metrics.ChunkEvaluator (aliased here as PyChunkEvaluator).
    """

    def __init__(self, input, label, chunk_scheme, num_chunk_types,
                 excluded_chunk_types=None, seq_len=None):
        from . import layers
        from .core import unique_name
        from .core.program import (default_main_program,
                                   default_startup_program)
        from .initializer import Constant

        (precision, recall, f1, num_infer, num_label,
         num_correct) = layers.chunk_eval(
            input=input, label=label, chunk_scheme=chunk_scheme,
            num_chunk_types=num_chunk_types,
            excluded_chunk_types=excluded_chunk_types, seq_len=seq_len)
        self.batch_metrics = (precision, recall, f1)

        block = default_main_program().current_block()
        sblock = default_startup_program().current_block()
        self._states = []
        for nm, batch_var in (("total_infer_chunks", num_infer),
                              ("total_label_chunks", num_label),
                              ("total_correct_chunks", num_correct)):
            state_name = unique_name.generate(f"chunk_evaluator.{nm}")
            state = block.create_var(name=state_name, shape=(1,),
                                     dtype="float32", persistable=True,
                                     stop_gradient=True)
            sv = sblock.create_var(name=state_name, shape=(1,),
                                   dtype="float32", persistable=True,
                                   stop_gradient=True)
            Constant(0.0)(sv, sblock)
            # state += batch count, in-graph (the output slot IS the
            # persistable state var, so the executor carries it forward
            # like optimizer state)
            cast = block.create_var(
                name=unique_name.generate(f"{state_name}.cast"),
                shape=(1,), dtype="float32")
            block.append_op(type="cast", inputs={"X": [batch_var]},
                            outputs={"Out": [cast]},
                            attrs={"out_dtype": "float32"})
            block.append_op(type="elementwise_add",
                            inputs={"X": [state], "Y": [cast]},
                            outputs={"Out": [state]})
            self._states.append(state)

    def reset(self, executor=None, scope=None):
        """Zero the accumulated counters (reference Evaluator.reset), on
        the device they live on."""
        import torch

        from .core.executor import global_scope

        scope = scope or global_scope()
        for s in self._states:
            old = scope.find_var(s.name)
            scope.set_var(s.name, torch.zeros((1,), dtype=torch.float32)
                          if old is None else torch.zeros_like(old))

    def eval(self, executor=None, scope=None):
        """(precision, recall, f1) over every step since reset()."""
        from .core.executor import global_scope

        scope = scope or global_scope()
        infer, label, correct = (
            float(scope.find_var(s.name).reshape(-1)[0])
            for s in self._states)
        precision = correct / infer if infer else 0.0
        recall = correct / label if label else 0.0
        f1 = (2 * precision * recall / (precision + recall)
              if correct else 0.0)
        return precision, recall, f1
