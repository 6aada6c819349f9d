"""Typed runtime flags with an env-var bridge: the port of
paddle_tpu/flags.py.

reference: the gflags system (SURVEY.md §5.6) — DEFINE_* flags read from
env via python __bootstrap__ (python/paddle/fluid/__init__.py:125-147).
One typed registry (`FLAGS`) with the reference package's names, defaults
and types (paddle_tpu/flags.py:63-157); an env variable `FLAGS_<name>`
overrides a default when the flag is defined, and `init_from_env()`
reads them again.  A bool flag reads "1", "true" or "yes" (any case) as
True and anything else as False.

Modules read a flag when they build the object that uses it
(`HealthConfig`, `Supervisor`, `io.barrier_timeout_s`, `Executor.run`,
`DeviceFeeder`, `AsyncExecutor.run`), so a value set in the process
reaches the next such object.

`fraction_of_tpu_memory_to_use` keeps the reference's name, so a script
written for it runs here: set (by env or by assignment), it caps this
process's CUDA caching allocator with
`torch.cuda.set_per_process_memory_fraction` at the next device use
(`apply_memory_fraction`, called by `executor.place_device`).  It is
never applied by default, as the reference exports its XLA variable only
when the flag is set (paddle_tpu/flags.py:81-92).  A cap below what the
allocator already holds raises instead of pretending to cap it.
"""

from __future__ import annotations

import os
import threading
from dataclasses import dataclass
from typing import Any, Dict, Set


@dataclass
class _FlagDef:
    name: str
    default: Any
    help: str
    type: type


_TRUE = ("1", "true", "yes")
_MEM_FLAG = "fraction_of_tpu_memory_to_use"


def _parse(t: type, text: str):
    if t is bool:
        return text.strip().lower() in _TRUE
    return t(text)


class FlagRegistry:
    def __init__(self):
        self._defs: Dict[str, _FlagDef] = {}
        self._values: Dict[str, Any] = {}
        self._set_by_user: Set[str] = set()

    def define(self, name: str, default, help_: str = ""):
        t = type(default)
        self._defs[name] = _FlagDef(name, default, help_, t)
        env = os.environ.get(f"FLAGS_{name}")
        if env is not None:
            self._values[name] = _parse(t, env)
            self._set_by_user.add(name)
        else:
            self._values[name] = default

    def __getattr__(self, name: str):
        values = object.__getattribute__(self, "_values")
        if name in values:
            return values[name]
        raise AttributeError(f"unknown flag {name!r}")

    def __setattr__(self, name: str, value):
        if name.startswith("_"):
            object.__setattr__(self, name, value)
            return
        if name not in self._defs:
            raise AttributeError(f"unknown flag {name!r}")
        t = self._defs[name].type
        self._values[name] = (_parse(t, value) if isinstance(value, str)
                              else t(value))
        self._set_by_user.add(name)
        if name == _MEM_FLAG:
            _mem_applied.clear()

    def is_set(self, name: str) -> bool:
        """Whether `name` was set by env or assignment (not left at its
        default)."""
        return name in self._set_by_user

    def to_dict(self) -> Dict[str, Any]:
        return dict(self._values)


FLAGS = FlagRegistry()

# Correctness / debugging (reference: operator.cc:943 FLAGS_check_nan_inf)
FLAGS.define("check_nan_inf", False,
             "scan every fetch and every updated persistable for NaN/Inf "
             "after each Executor.run; raises FloatingPointError naming "
             "the var")
FLAGS.define("benchmark", False,
             "block after every Executor.run until the card is done "
             "(torch.cuda.synchronize), for accurate timing "
             "(reference operator.cc:940)")
FLAGS.define("cpu_deterministic", True,
             "parity no-op: the port sets no CPU determinism mode (torch's "
             "CPU index_add, the dense embedding backward among them, sums "
             "in a thread-dependent order; the card's kernels do not)")
# Memory (reference: FLAGS_fraction_of_gpu_memory_to_use)
FLAGS.define(_MEM_FLAG, 0.9,
             "when set (env or assignment): caps this process's CUDA "
             "caching allocator at this fraction of the card "
             "(torch.cuda.set_per_process_memory_fraction) at the next "
             "device use; never applied by default")
# Executor behavior
FLAGS.define("use_mkldnn", False, "parity no-op (MKLDNN is x86-only)")
FLAGS.define("reader_queue_speed_test_mode", False,
             "non-destructive reader queue for throughput tests: "
             "DeviceFeeder serves its first batch repeatedly so consumer "
             "speed is measured without producer cost (reference "
             "FLAGS_reader_queue_speed_test_mode)")
FLAGS.define("eager_delete_tensor_gb", 0.0,
             "parity no-op: the interpreter drops each tensor with its "
             "last Python reference, and the caching allocator reuses it")
# Host-side parallelism (reference FLAGS_paddle_num_threads sized the CPU
# math thread pool; here it sizes host data-parsing pools)
FLAGS.define("paddle_num_threads", 2,
             "default worker-thread count for host pipelines "
             "(AsyncExecutor parser shards)")
# Distributed (reference FLAGS_rpc_deadline guarded the gRPC client)
FLAGS.define("rpc_deadline", 180000,
             "multi-trainer bootstrap timeout in ms "
             "(parallel.init_distributed's store timeout)")
# Resilience timeouts (the same table as the reference's)
FLAGS.define("ckpt_barrier_timeout_s", 600.0,
             "cross-process checkpoint barrier timeout; legacy env "
             "PADDLE_TPU_CKPT_BARRIER_TIMEOUT_S overrides when set")
FLAGS.define("heartbeat_interval_s", 1.0,
             "health plane: seconds between a rank's store heartbeats "
             "(resilience/health.py)")
FLAGS.define("heartbeat_miss_budget", 5,
             "health plane: a peer whose heartbeat has not changed for "
             "interval*budget seconds is declared lost (PeerLostError)")
FLAGS.define("gang_stall_timeout_s", 0.0,
             "health plane: a peer heartbeating but with a frozen step "
             "counter for this long is declared stalled "
             "(PeerStalledError); 0 disables — the dispatch watchdog "
             "is the primary hung-step detector")
FLAGS.define("supervisor_grace_s", 10.0,
             "gang supervisor: seconds a broken gang's survivors get "
             "between SIGTERM and SIGKILL")
FLAGS.define("supervisor_max_restarts", 3,
             "gang supervisor: total relaunches before GangFailedError")
FLAGS.define("supervisor_backoff_base_s", 1.0,
             "gang supervisor: failure-restart backoff base "
             "(base * 2**failures, deterministic retry_call schedule)")
FLAGS.define("supervisor_backoff_max_s", 30.0,
             "gang supervisor: failure-restart backoff cap")
# Determinism aliases
FLAGS.define("cudnn_deterministic", True,
             "parity no-op: the port's hand-written kernels reduce in a "
             "fixed order, and its cuDNN convolutions run with their "
             "default algorithm choice")
FLAGS.define("sync_nccl_allreduce", True,
             "parity no-op: the port's collectives are synchronous "
             "within the step")
FLAGS.define("enable_parallel_graph", False,
             "parity no-op: the interpreter runs the ops in program order")
FLAGS.define("init_allocated_mem", False,
             "parity no-op: the port never reads an uninitialized buffer")
FLAGS.define("free_idle_memory", False,
             "parity no-op: the caching allocator keeps its blocks "
             "(torch.cuda.empty_cache frees them)")
FLAGS.define("inner_op_parallelism", 0,
             "parity no-op: op-internal parallelism is the kernels'")


def init_from_env():
    """Re-read FLAGS_* env vars (the reference's __bootstrap__ pass)."""
    for name in FLAGS._defs:
        env = os.environ.get(f"FLAGS_{name}")
        if env is not None:
            setattr(FLAGS, name, env)


_mem_lock = threading.Lock()
_mem_applied: Set[int] = set()   # device indices the current cap is on


def apply_memory_fraction(device) -> None:
    """Cap the caching allocator of CUDA `device` at
    FLAGS.fraction_of_tpu_memory_to_use, once per device and value, when
    the flag was set; a no-op otherwise.  Raises ValueError when the
    allocator already holds more than the cap (the cap could not take
    effect for what it holds)."""
    if not FLAGS.is_set(_MEM_FLAG):
        return
    import torch

    index = torch.device(device).index or 0
    with _mem_lock:
        if index in _mem_applied:
            return
        frac = float(FLAGS.fraction_of_tpu_memory_to_use)
        if not 0.0 < frac <= 1.0:
            raise ValueError(f"FLAGS.{_MEM_FLAG} = {frac}: must be in "
                             f"(0, 1]")
        total = torch.cuda.get_device_properties(index).total_memory
        held = torch.cuda.memory_reserved(index)
        if held > frac * total:
            raise ValueError(
                f"FLAGS.{_MEM_FLAG} = {frac} caps cuda:{index} at "
                f"{frac * total:.0f} bytes, but its allocator already "
                f"holds {held} bytes; set the flag before the first "
                f"device use")
        torch.cuda.set_per_process_memory_fraction(frac, index)
        _mem_applied.add(index)
