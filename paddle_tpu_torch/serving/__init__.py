"""paddle_tpu_torch.serving — serving over the Predictor and the paged
decode engine (the port of paddle_tpu/serving):

- `engine.ServingEngine`: shape-bucketed dynamic batching (a warmed
  bucket ladder, zero steady-state compiles) + request normalization,
- `batcher.DynamicBatcher`: dynamic micro-batching with futures
  (max_batch_size / max_wait_ms, whichever first),
- `admission.AdmissionController`: bounded queue with fast-reject load
  shedding, per-request deadlines, the circuit breaker, health/drain,
- `stats.ServingStats` / `stats.DecodeStats`: latency percentiles,
  occupancy, padding waste, TTFT/TPOT, shed/deadline counters, merged
  across replicas,
- `decode.DecodeEngine`: continuous-batching autoregressive decode over
  a paged KV cache, with speculative decoding (`speculate.py`),
- `fleet.Fleet`: N engine replicas behind one health-checked router —
  least-loaded routing, per-replica breakers, hedging, in-flight decode
  failover (token-identical regeneration), and rolling hot weight
  reload,
- `disagg.DisaggFleet`: disaggregated prefill/decode serving — prefill
  workers hand KV pages to decode workers, cross-hop token-parity
  failover, and the SLO-driven `disagg.Autoscaler` over
  AlertEngine.signals().

    from paddle_tpu_torch.serving import BucketConfig, ServingEngine
    engine = ServingEngine(model_dir, example_feed={"x": example},
                           buckets=BucketConfig((1, 2, 4, 8)))
    engine.start()
    y = engine.infer({"x": x})
    engine.close()
"""

from .admission import (AdmissionController,  # noqa: F401
                        CircuitBreaker, CircuitOpenError,
                        DeadlineExceededError, ExecutorFailureError,
                        QueueFullError, ServingClosedError,
                        ServingError, WeightReloadError)
from .batcher import DynamicBatcher, Request  # noqa: F401
from .decode import (DecodeBucketMissError,  # noqa: F401
                     DecodeConfig, DecodeEngine, DecodeMemoryError,
                     DecodeReplicaFailedError, DecodeRequest, PagePool)
from .engine import (BucketConfig, BucketMemoryError,  # noqa: F401
                     BucketMissError, ServingEngine)
from . import disagg  # noqa: F401
from .disagg import (Autoscaler, DisaggFleet,  # noqa: F401
                     DisaggStats, PhaseWorker)
from .fleet import (FailoverParityError, Fleet,  # noqa: F401
                    FleetClosedError, FleetConfig, FleetResponse,
                    FleetSaturatedError, FleetStats, ReplicaHandle)
from .speculate import (Drafter, ModelDrafter,  # noqa: F401
                        NGramDrafter, ngram_propose)
from .stats import DecodeStats, ServingStats  # noqa: F401
