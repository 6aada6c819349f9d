"""Inference serving: the Predictor over a saved inference model.

The port of paddle_tpu/inference.py (reference: paddle/fluid/inference/
api/analysis_predictor.cc AnalysisPredictor, api/paddle_analysis_config.h
AnalysisConfig, api/paddle_api.h PaddlePredictor).

- A `save_inference_model` directory loads through `io.
  load_inference_model` (the reference's file format, so a directory
  either package saved serves in the other); the parameters land on the
  device ONCE and stay there between runs (the zero-copy contract), and
  `clone()` shares them.
- The reference AOT-compiles one XLA executable per input signature.
  The port runs the pruned program eagerly, so there is nothing to
  compile: `compile_signature(feed_spec)` is one warm run on zeros of
  that signature, which puts the kernels' builds and cuBLAS/cuDNN's
  set-up into warmup and records the signature as warmed.  A `run` at a
  signature that was never warmed records a compile in
  `observe.runtime_stats`, so a serving engine's
  `post_warmup_compiles` stays the shape-leak detector it is in the
  reference.
- The reference's portable artifact (`__model__.export`, jax.export
  bytes) cannot be read here, and `torch.export` cannot trace the
  ctypes kernel launches.  The Predictor ignores those bytes and serves
  the directory from `__model__`; the sidecar's signature, while its
  hash still matches `__model__`, is warmed at load, so the exported
  signature's first run counts no compile (the artifact's purpose in
  the reference: a cold start that skips the trace).
  `export_serialized_model` keeps the sidecar's contract — the
  signature, the model hash, invalidation when the model is saved
  again — and writes no artifact of its own (ROADMAP C14).

Places: `AnalysisConfig` carries the place, `CUDAPlace(0)` by default
(raising without CUDA); `disable_gpu()` selects the CPU, with upstream
Fluid's meaning (the reference's `disable_gpu` is a no-op; ROADMAP C14).
"""

from __future__ import annotations

import collections
import hashlib
import json
import os
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from .core.executor import (RNG_STATE_VAR, Executor, Scope, _to_numpy,
                            interpret_program, scope_guard)
from .io import EXPORT_FILENAME, MODEL_FILENAME, load_inference_model
from .observe.monitoring import runtime_stats

# One input of a signature: what `compile_signature` takes in place of
# the reference's jax.ShapeDtypeStruct.  Any object with `.shape` and
# `.dtype` (a numpy array, a torch tensor) serves as well.
FeedSpec = collections.namedtuple("FeedSpec", ["shape", "dtype"])


class AnalysisConfig:
    """reference: api/paddle_analysis_config.h.  `place` is CUDAPlace(0)
    unless the caller sets another (or calls `disable_gpu()`)."""

    def __init__(self, model_dir: Optional[str] = None):
        self.model_dir = model_dir
        # warm the export sidecar's signature at load (off under int8:
        # the converted program is not the one the sidecar describes)
        self.use_serialized_artifact = True
        self.use_int8 = False
        self.place = None   # None: CUDAPlace(0)

    # -- fluid-style setters (parity) -----------------------------------
    def set_model(self, model_dir: str):
        self.model_dir = model_dir

    def enable_int8(self):
        """Serve with real int8 products: the trained QAT scales freeze
        into quantized_conv2d/quantized_matmul ops at load time
        (quantize.convert_to_int8; `Predictor.int8_converted` holds its
        plan).  A model without the QAT pattern loads unchanged."""
        self.use_int8 = True
        self.use_serialized_artifact = False
        return self

    def disable_gpu(self):
        """Run on the CPU (upstream Fluid's meaning; the reference's is a
        no-op because its device comes from the JAX platform)."""
        from . import CPUPlace

        self.place = CPUPlace()
        return self

    def switch_ir_optim(self, _on=True):
        pass  # no graph passes: the program runs op by op

    def enable_memory_optim(self):
        pass  # the caching allocator reuses freed blocks


def _dtype_name(dtype) -> str:
    return str(dtype).replace("torch.", "")


def _model_hash(dirname: str) -> str:
    h = hashlib.sha256()
    with open(os.path.join(dirname, MODEL_FILENAME), "rb") as f:
        h.update(f.read())
    return h.hexdigest()


def _read_sidecar(dirname: str):
    """The export sidecar's signature when its model hash is this
    directory's `__model__`'s, else None (a re-saved model, or a
    malformed sidecar, invalidates it)."""
    path = os.path.join(dirname, EXPORT_FILENAME + ".json")
    if not os.path.exists(path):
        return None
    try:
        with open(path) as f:
            meta = json.load(f)
        if not (isinstance(meta, dict)
                and meta.get("model_hash") == _model_hash(dirname)):
            return None
        sig = tuple((n, tuple(s), d) for n, s, d in meta["signature"])
        if not all(isinstance(getattr(torch, d, None), torch.dtype)
                   for _, _, d in sig):
            return None
        return sig
    except (ValueError, KeyError, TypeError, OSError):
        return None


class Predictor:
    """Inference engine over a saved model (reference AnalysisPredictor::
    Run, analysis_predictor.cc:170; ZeroCopyRun :444).

    run(feed) returns numpy fetches in the export's fetch order; the
    parameters stay on the config's device across runs.  Signatures
    (per input: name, shape, dtype) warmed by `compile_signature` or by
    an earlier run count no compile.
    """

    def __init__(self, config: AnalysisConfig | str):
        if isinstance(config, str):
            config = AnalysisConfig(config)
        self.config = config
        self._exe = Executor(config.place)
        self.device = self._exe.device
        self._scope = Scope()
        self.int8_converted: Dict[int, tuple] = {}
        with scope_guard(self._scope):
            self._program, self._feed_names, fetch_vars = \
                load_inference_model(config.model_dir, self._exe)
            if config.use_int8:
                from .quantize import convert_to_int8

                self.int8_converted = convert_to_int8(self._program,
                                                      self._scope)
        self._fetch_names = [v.name for v in fetch_vars]
        # the loaded values are on the device already: held once,
        # shared by every run and every clone
        self._params = {n: v for n, v in self._scope.vars.items()
                        if v is not None and n != RNG_STATE_VAR}
        self._warm: set = set()
        # the reference's serialized artifact is not readable here; the
        # sidecar's signature, while it still describes __model__, is
        # warmed now, so the exported signature serves with no compile
        self._export_sig = (_read_sidecar(config.model_dir)
                            if config.use_serialized_artifact else None)
        if self._export_sig is not None:
            self.compile_signature({n: FeedSpec(s, getattr(torch, d))
                                    for n, s, d in self._export_sig})

    # -- introspection (PaddlePredictor parity) -------------------------
    def get_input_names(self) -> List[str]:
        return list(self._feed_names)

    def get_output_names(self) -> List[str]:
        return list(self._fetch_names)

    # -- execution ------------------------------------------------------
    def _feeds(self, feed) -> Dict[str, torch.Tensor]:
        if not isinstance(feed, dict):
            if len(feed) != len(self._feed_names):
                raise ValueError(
                    f"expected {len(self._feed_names)} inputs "
                    f"({self._feed_names}), got {len(feed)}")
            feed = dict(zip(self._feed_names, feed))
        block = self._program.global_block()
        # Executor.run's conversion: each input on the device in its
        # var's dtype
        return {n: self._exe._to_tensor(v, block, n)
                for n, v in feed.items()}

    @staticmethod
    def _signature(feeds) -> tuple:
        return tuple(sorted((n, tuple(v.shape), _dtype_name(v.dtype))
                            for n, v in feeds.items()))

    def _infer(self, params, feeds) -> List[torch.Tensor]:
        env = dict(params)
        env.update(feeds)
        with torch.no_grad():
            env = interpret_program(
                self._program, env, (self._program.random_seed, 0),
                fetch_names=tuple(self._fetch_names), device=self.device)
        return [env[n] for n in self._fetch_names]

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def zero_feeds(self, feed_spec: Dict[str, object]
                   ) -> Dict[str, torch.Tensor]:
        """Inputs of one signature on the device, zeros (a `.seq_len`
        companion lengths of 1): `feed_spec` maps each input name to a
        `FeedSpec(shape, dtype)` or anything with `.shape` and
        `.dtype`."""
        feeds = {}
        block = self._program.global_block()
        for n, s in feed_spec.items():
            dtype = s.dtype if isinstance(s.dtype, torch.dtype) \
                else np.dtype(s.dtype)
            fill = 1 if n.endswith(".seq_len") else 0
            arr = (torch.full(tuple(s.shape), fill, dtype=dtype)
                   if isinstance(dtype, torch.dtype)
                   else np.full(tuple(s.shape), fill, dtype))
            feeds[n] = self._exe._to_tensor(arr, block, n)
        return feeds

    def compile_signature(self, feed_spec: Dict[str, object],
                          donate_feeds: bool = False):
        """Warm one input signature WITHOUT example data (the serving
        warmup): `feed_spec` maps each input name to a `FeedSpec(shape,
        dtype)` (or anything with `.shape` and `.dtype`), dtypes as numpy
        or torch dtypes.  One run on zeros of that signature under
        `torch.no_grad()` (a `.seq_len` companion gets lengths of 1)
        builds what the signature needs; it is recorded as a compile,
        and a later run() of exactly this signature counts none.

        donate_feeds: accepted for the reference's signature; the port
        runs eagerly and keeps no executable to donate buffers to.
        Idempotent per signature; returns the signature."""
        feeds = self.zero_feeds(feed_spec)
        sig = self._signature(feeds)
        if sig in self._warm:
            return sig
        t0 = time.perf_counter()
        self._infer(self._params, feeds)
        self._sync()
        runtime_stats.record_compile(time.perf_counter() - t0)
        self._warm.add(sig)
        return sig

    def run(self, feed: Dict[str, np.ndarray] | Sequence[np.ndarray]):
        """Returns the fetches as numpy arrays (fetch order of the
        export).  A signature never warmed before records a compile."""
        feeds = self._feeds(feed)
        sig = self._signature(feeds)
        if sig in self._warm:
            outs = self._infer(self._params, feeds)
            return [_to_numpy(o) for o in outs]
        t0 = time.perf_counter()
        outs = [_to_numpy(o) for o in self._infer(self._params, feeds)]
        runtime_stats.record_compile(time.perf_counter() - t0)
        self._warm.add(sig)
        return outs

    def benchmark(self, feed, iters: int = 50, warmup: int = 5,
                  zero_copy: bool = True):
        """Serving latency probe: {p50_ms, mean_ms, compute_ms}.

        zero_copy=True places the inputs on the device once and times
        run() on them (the reference's ZeroCopyRun measurement); False
        times it from host arrays, the host→device copy included.  Each
        run() ends in the fetches' copy back to the host.  compute_ms
        is the per-inference time of k back-to-back runs with one
        synchronize at the end (`_chained_latency_ms`)."""
        if zero_copy and isinstance(feed, dict):
            feed = self._feeds(feed)
            self._sync()
        for _ in range(warmup):
            self.run(feed)
        times = []
        for _ in range(iters):
            t0 = time.perf_counter()
            self.run(feed)
            times.append((time.perf_counter() - t0) * 1e3)
        times.sort()
        result = {"p50_ms": times[len(times) // 2],
                  "mean_ms": sum(times) / len(times)}
        result["compute_ms"] = self._chained_latency_ms(feed)
        return result

    def _chained_latency_ms(self, feed, k: int = 20):
        """Per-inference time with the host's dispatch overlapped over k
        back-to-back runs on device-resident inputs: nothing is read
        back between them and one synchronize ends the chain, timed
        with CUDA events on the card (the reference chains k calls in
        one lax.scan)."""
        feeds = self._feeds(feed)
        self._infer(self._params, feeds)
        self._sync()
        if self.device.type != "cuda":
            t0 = time.perf_counter()
            for _ in range(k):
                self._infer(self._params, feeds)
            return (time.perf_counter() - t0) * 1e3 / k
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(k):
            self._infer(self._params, feeds)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / k

    def clone(self) -> "Predictor":
        """Sibling predictor SHARING the device-resident parameters and
        the warmed signatures (reference AnalysisPredictor::Clone): one
        clone per serving thread; torch's eager ops are thread-safe and
        the parameters are not written at serving time."""
        twin = object.__new__(Predictor)
        twin.__dict__.update(self.__dict__)
        return twin


def create_paddle_predictor(config: AnalysisConfig) -> Predictor:
    """reference: CreatePaddlePredictor<AnalysisConfig>
    (analysis_predictor.cc:359)."""
    return Predictor(config)


def export_serialized_model(dirname: str, example_feed: Dict[str, np.ndarray],
                            executor=None):
    """Record the input signature of `example_feed` as the saved model's
    export: the model is loaded and run once at that signature (on the
    executor's device, CUDAPlace(0) by default), then the sidecar
    `__model__.export.json` is written with the signature and the hash
    of `__model__` — a later save of the model invalidates it.  The port
    writes no artifact beside it (ROADMAP C14); a reference artifact the
    new sidecar would contradict is removed.  Returns the sidecar's
    path."""
    exe = executor or Executor()
    scope = Scope()
    with scope_guard(scope):
        program, feed_names, fetch_vars = load_inference_model(dirname, exe)
    missing = set(feed_names) - set(example_feed)
    if missing:
        raise ValueError(f"example_feed missing inputs: {sorted(missing)}")
    block = program.global_block()
    feeds = {n: exe._to_tensor(v, block, n)
             for n, v in sorted(example_feed.items())}
    env = {n: v for n, v in scope.vars.items()
           if v is not None and n != RNG_STATE_VAR}
    env.update(feeds)
    with torch.no_grad():
        interpret_program(program, env, (program.random_seed, 0),
                          fetch_names=tuple(v.name for v in fetch_vars),
                          device=exe.device)
    sig = sorted((n, list(v.shape), _dtype_name(v.dtype))
                 for n, v in feeds.items())
    path = os.path.join(dirname, EXPORT_FILENAME)
    old = _read_sidecar(dirname)
    if os.path.exists(path) and old != tuple(
            (n, tuple(s), d) for n, s, d in sig):
        os.remove(path)
    with open(path + ".json", "w") as f:
        json.dump({"signature": sig, "model_hash": _model_hash(dirname)},
                  f)
    return path + ".json"
