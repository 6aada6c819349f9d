"""serve(): the one-call serving entry point, mirroring contrib.Trainer.

Trainer is "give me a program and I'll run the training loop with
checkpoints and telemetry"; serve() is "give me a saved inference model
and I'll run the serving loop with batching, admission control, and
telemetry".  It wires the pieces a production caller would otherwise
assemble by hand (serving.ServingEngine + BucketConfig + RunEventLog)
and returns a STARTED engine — warmed up, accepting traffic (on
CUDAPlace(0) for a model directory; pass an AnalysisConfig with
`disable_gpu()` for the CPU):

    engine = fluid.contrib.serve(
        model_dir, example_feed={"data": example_img},
        batch_sizes=(1, 4, 16), max_wait_ms=5,
        log_path="serving_events.jsonl")
    y = engine.infer({"data": img})
    ...
    engine.close()   # drain + stop (or use it as a context manager)
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np


def serve(model_dir, example_feed: Dict[str, np.ndarray],
          batch_sizes: Sequence[int] = (1, 2, 4, 8),
          seq_lens: Optional[Sequence[int]] = None,
          max_wait_ms: float = 5.0, queue_capacity: int = 128,
          default_deadline_ms: Optional[float] = None,
          log_path: Optional[str] = None, **engine_kwargs):
    """Build, warm up, and start a serving.ServingEngine.

    model_dir: a save_inference_model dir (or AnalysisConfig/Predictor —
        anything serving.ServingEngine accepts; pass an int8-enabled
        AnalysisConfig for quantized serving).
    example_feed: one per-example array per model input (shape/dtype
        template; ragged inputs use their natural (L, ...) shape).
    batch_sizes / seq_lens: the shape-bucket ladder, warmed before this
        returns (see docs/SERVING.md for sizing guidance).
    log_path: write serving_* telemetry events to this JSONL file.

    Returns the started engine; the caller owns close().
    """
    from ..serving import BucketConfig, ServingEngine

    engine = ServingEngine(
        model_dir, example_feed,
        buckets=BucketConfig(batch_sizes, seq_lens=seq_lens),
        max_wait_ms=max_wait_ms, queue_capacity=queue_capacity,
        default_deadline_ms=default_deadline_ms, log_path=log_path,
        **engine_kwargs)
    return engine.start()
