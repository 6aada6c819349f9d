"""Continuous-batching autoregressive decode over a paged KV cache.

The port of paddle_tpu/serving/decode.py (role "unified"): requests
produce tokens one iteration at a time, each slot's K/V lives in
fixed-size PAGES of one shared pool addressed through per-slot page
tables (Ragged Paged Attention, PAPERS.md arxiv 2604.15464).

- **fixed-slot batch, paged KV pool** — `num_slots` decode lanes; pages
  are allocated on admit, extended as a slot grows, and returned the
  moment it finishes.
- **iteration-level (continuous) batching** — new requests join an
  open slot BETWEEN decode chunks (prefill-on-join through a bucketed
  prompt ladder).  The admission/circuit-breaker plane (`admission.py`)
  is the reference's: bounded queue, fast-reject shedding, deadline
  drops, breaker on executor failures.
- **preemption** — when the pool runs dry, the lowest-priority slot is
  evicted and requeued; greedy decode regenerates identical tokens.
- **chunked decode** — each dispatch runs up to `decode_chunk` step
  programs in a Python loop with the reference `lax.while_loop`'s exact
  condition (paddle_tpu/serving/decode.py:418-421): stop after
  `decode_chunk` iterations, as soon as any slot finishes, or when no
  slot is active.  The loop state lives on the host; each iteration
  reads the step's next tokens back, which is the one host sync it
  needs.
- **speculative decoding** (`speculate_k > 0`, serving/speculate.py) —
  a drafter proposes up to k tokens per slot, ONE verify run (the step
  program at folded batch S*(k+1)) scores them all, and greedy
  longest-accepted-prefix acceptance commits 1..k+1 tokens a slot: the
  sequential engine's tokens.  The verify run replaces the chunk loop.
- **request tracing** (`tracer=`, observe/reqtrace.py) — host
  timestamps at the queue boundaries only: join_wait, one dispatch span
  per prefill, chunk or verify round, preempt/evacuated/rejected
  markers.

Every run has a FIXED shape — the slot batch, the pool and the page
tables never change across joins/leaves/preemptions — and `start()`
runs every prefill bucket and one decode step before opening, so the
kernels' builds and cuBLAS's set-up land in warmup: steady state counts
ZERO post-warmup compiles.  The pools are updated in place by the write
ops (the JAX engine's buffer donation).

Entry points run on `CUDAPlace(0)` unless the caller passes a place;
without CUDA the default raises.  The disagg roles and weight
reload/evacuation (ROADMAP queue A item 7) and the `plan_fit` memory
gate (item 9) are not ported yet.
"""

from __future__ import annotations

import threading
import time
from concurrent.futures import Future
from typing import Any, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from ..core.executor import RNG_STATE_VAR, interpret_program, place_device
from ..observe.events import RunEventLog
from ..observe.monitoring import runtime_stats
from .admission import (AdmissionController, CircuitBreaker,
                        DeadlineExceededError, ExecutorFailureError,
                        ServingError)
from .engine import BucketConfig
from .stats import DecodeStats


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def run_model_program(built, params, pools, cache_names, device, fetch,
                      row_block=None, **feeds):
    """Run one program of a DecoderLM build over params + pools + feeds;
    returns (env, the new pools).  The write ops update the pools in
    place; adopting their outputs keeps the functional contract
    explicit.  `row_block`: interpret_program's batch-invariance
    option."""
    env = dict(params)
    env.update(pools)
    env.update(feeds)
    cache_outs = built["cache_outs"]
    env = interpret_program(built["main"], env, None,
                            fetch_names=(*fetch, *cache_outs),
                            device=device, row_block=row_block)
    return env, {n: env[o] for n, o in zip(cache_names, cache_outs)}


class DecodeBucketMissError(ServingError):
    """The request fits no prefill bucket / exceeds the slot length
    budget (structured: carries the offending lengths and ladder)."""

    kind = "decode_bucket_miss"


class DecodeReplicaFailedError(ServingError):
    """An accepted request was pulled off the engine mid-generation — the
    scheduler died, or the engine shut down with it unresolved.
    RETRYABLE: greedy decode regenerates token-identically from the
    prompt, so the error carries the requeue `descriptor`."""

    kind = "decode_replica_failed"
    retryable = True


class DecodeConfig:
    """Geometry + scheduling knobs of the decode engine.

    num_slots: fixed decode lanes (the device batch).
    page_size: tokens per KV page.
    max_len: per-slot budget (prompt + generated); sets the page-table
        width `max_pages_per_slot`.
    num_pages: shared pool size.  Default: slots * pages-per-slot (no
        preemption pressure).
    prefill_buckets: ascending prompt-length ladder (a prompt pads UP to
        the smallest fitting bucket).
    decode_chunk: max step runs per decode dispatch (early-exits when a
        slot finishes).
    eos_id: optional stop token.
    kv_dtype: pool storage — "float32", "bfloat16" or "int8".
    """

    def __init__(self, num_slots: int = 8, page_size: int = 16,
                 max_len: int = 256, num_pages: Optional[int] = None,
                 prefill_buckets: Sequence[int] = (32, 64, 128),
                 decode_chunk: int = 8, eos_id: Optional[int] = None,
                 kv_dtype: str = "bfloat16"):
        if num_slots < 1 or page_size < 1 or max_len < 2:
            raise ValueError("num_slots/page_size >= 1, max_len >= 2")
        if decode_chunk < 1:
            raise ValueError("decode_chunk must be >= 1")
        self.num_slots = int(num_slots)
        self.page_size = int(page_size)
        self.max_len = int(max_len)
        self.max_pages_per_slot = _cdiv(self.max_len, self.page_size)
        self.num_pages = int(num_pages) if num_pages is not None else \
            self.num_slots * self.max_pages_per_slot
        self.prefill_buckets = BucketConfig._ladder("prefill_buckets",
                                                    prefill_buckets)
        if self.prefill_buckets[-1] > self.max_len:
            raise ValueError(
                f"largest prefill bucket {self.prefill_buckets[-1]} "
                f"exceeds max_len {self.max_len}")
        if self.num_pages < self.max_pages_per_slot:
            raise ValueError(
                f"num_pages {self.num_pages} below max_pages_per_slot "
                f"{self.max_pages_per_slot}: one max-length request "
                f"could never be served, even alone")
        self.decode_chunk = int(decode_chunk)
        self.eos_id = eos_id
        self.kv_dtype = str(kv_dtype)


class DecodeRequest:
    """One accepted generation request."""

    __slots__ = ("prompt", "max_new_tokens", "priority", "future",
                 "deadline", "t_submit", "preempted", "trace")

    def __init__(self, prompt: np.ndarray, max_new_tokens: int,
                 priority: int = 0, deadline: Optional[float] = None,
                 trace=None):
        self.prompt = prompt
        self.max_new_tokens = int(max_new_tokens)
        self.priority = int(priority)
        self.future: Future = Future()
        self.deadline = deadline
        self.t_submit = time.monotonic()
        self.preempted = 0
        self.trace = trace       # observe.reqtrace.RequestTrace or None

    def descriptor(self, generated: Optional[List[int]] = None
                   ) -> Dict[str, Any]:
        """The requeue wire form: everything that defines the greedy
        generation, plus what this engine had already committed."""
        gen = [int(t) for t in (generated or [])]
        return {"prompt": [int(t) for t in self.prompt],
                "max_new_tokens": self.max_new_tokens,
                "priority": self.priority,
                "deadline": self.deadline,
                "committed_tokens": len(gen),
                "generated": gen,
                "preempted": self.preempted}


class PagePool:
    """Host-side free-list allocator over the device pool's page
    indices.  Single-threaded (the scheduler owns it)."""

    def __init__(self, num_pages: int):
        self.num_pages = int(num_pages)
        self._free = list(range(num_pages - 1, -1, -1))

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def in_use(self) -> int:
        return self.num_pages - len(self._free)

    def alloc(self, n: int) -> Optional[List[int]]:
        if n > len(self._free):
            return None
        got = self._free[-n:][::-1]
        del self._free[-n:]
        return got

    def free(self, pages: List[int]):
        self._free.extend(reversed(pages))


class _Slot:
    """Scheduler-side state of one decode lane."""

    __slots__ = ("req", "pages", "committed", "generated", "cur_tok",
                 "remaining")

    def __init__(self, req: DecodeRequest, pages: List[int]):
        self.req = req
        self.pages = pages
        self.committed = len(req.prompt)   # tokens whose KV is pooled
        self.generated: List[int] = []     # tokens produced so far
        self.cur_tok = 0                   # pending (uncommitted) token
        self.remaining = req.max_new_tokens

    @property
    def cap_tokens(self) -> int:
        # the LAST generated token is never committed to KV
        return len(self.req.prompt) + self.req.max_new_tokens - 1

    def importance(self):
        # higher tuple = more important (kept under preemption)
        return (self.req.priority, -self.req.t_submit)


class DecodeEngine:
    """Continuous-batching decode endpoint over a DecoderLM.

        lm = DecoderLM(vocab_size=...)
        engine = DecodeEngine(lm, DecodeConfig(num_slots=8))
        engine.start()                       # warmup
        fut = engine.submit(prompt_ids, max_new_tokens=64)
        tokens = fut.result()                # np.int32 generated ids
        engine.close()

    model: a models.decoder_lm.DecoderLM.
    params: name -> tensor weights (convert.params_from_arrays); None
        runs the model's startup program on the engine's device.
    place: CUDAPlace(id) (the default, CUDAPlace(0); raises without
        CUDA) or CPUPlace().
    donate_pools: accepted for the reference's signature and ignored:
        the reference donates the KV pools to its compiled step only on
        a TPU (paddle_tpu/serving/decode.py:335-339), and the port's
        eager steps update the pools in place.
    tracer: an observe.ReqTracer, or None (no tracing).
    speculate_k: drafts per slot per verify round (0: the sequential
        chunk loop); drafter: a serving.speculate.Drafter with k ==
        speculate_k (default NGramDrafter(speculate_k)).
    Threading: submit() from any thread; ONE scheduler thread owns
    dispatch, the page pool, and the slot table.
    """

    def __init__(self, model, config: Optional[DecodeConfig] = None,
                 queue_capacity: int = 128,
                 default_deadline_ms: Optional[float] = None,
                 event_log: Optional[RunEventLog] = None,
                 log_path: Optional[str] = None,
                 stats_window: int = 64,
                 breaker: Union[CircuitBreaker, bool, None] = None,
                 memory_budget_bytes: Union[int, bool, None] = None,
                 donate_pools: Optional[bool] = None, tracer=None,
                 role: str = "unified", speculate_k: int = 0,
                 drafter=None,
                 params: Optional[Dict[str, torch.Tensor]] = None,
                 place=None):
        if role not in ("unified", "prefill", "decode"):
            raise ValueError(
                f"role must be 'unified', 'prefill' or 'decode'; "
                f"got {role!r}")
        self.speculate_k = int(speculate_k or 0)
        if self.speculate_k < 0:
            raise ValueError(
                f"speculate_k must be >= 0, got {speculate_k}")
        if self.speculate_k and role == "prefill":
            raise ValueError(
                "speculate_k requires a decoding role — a "
                "role='prefill' worker never runs decode steps")
        if drafter is not None and not self.speculate_k:
            raise ValueError("drafter given but speculate_k is 0")
        if role != "unified":
            raise NotImplementedError(
                f"role={role!r} (disaggregated prefill/decode serving) "
                f"is not ported yet: ROADMAP queue A item 7")
        self.drafter = None
        if self.speculate_k:
            from .speculate import NGramDrafter

            self.drafter = (drafter if drafter is not None
                            else NGramDrafter(self.speculate_k))
            if getattr(self.drafter, "k", None) != self.speculate_k:
                raise ValueError(
                    f"drafter.k {getattr(self.drafter, 'k', None)} != "
                    f"speculate_k {self.speculate_k}")
        self.device = place_device(place)
        self.model = model
        self.tracer = tracer
        self.config = config or DecodeConfig(kv_dtype=model.kv_dtype)
        if self.config.kv_dtype != model.kv_dtype:
            raise ValueError(
                f"config.kv_dtype {self.config.kv_dtype!r} != model "
                f"kv_dtype {model.kv_dtype!r}")
        self._own_log = None
        if event_log is None and log_path is not None:
            event_log = self._own_log = RunEventLog(
                log_path, meta={"component": "decode_engine"})
        self._event_log = event_log
        self.stats = DecodeStats(event_log=event_log,
                                 window=stats_window)
        if self.speculate_k:
            self.stats.configure_speculation(self.speculate_k)
        if breaker is None:
            breaker = CircuitBreaker(failure_threshold=5, cooldown_s=5.0)
        elif breaker is False:
            breaker = None
        self.admission = AdmissionController(
            queue_capacity, default_deadline_ms=default_deadline_ms,
            breaker=breaker)
        self.memory_budget_bytes = memory_budget_bytes
        self.fit_plan: Optional[Dict[str, Any]] = None
        if params is None:
            scope = model.init_params(place=place)
            params = {n: v for n, v in scope.vars.items()
                      if v is not None and n != RNG_STATE_VAR}
        self._params = {n: v.to(self.device) for n, v in params.items()}
        self._cache_names = model.cache_feed_names()
        self._pools: Optional[Dict[str, torch.Tensor]] = None
        self.page_pool = PagePool(self.config.num_pages)
        self._page_tables = np.zeros(
            (self.config.num_slots, self.config.max_pages_per_slot),
            np.int32)
        self._slots: List[Optional[_Slot]] = \
            [None] * self.config.num_slots
        self._queue: List[DecodeRequest] = []
        self._unresolved = 0      # accepted requests not yet resolved
        self._cv = threading.Condition()
        self._worker: Optional[threading.Thread] = None
        self._stop = False
        self._started = False

    # -- program runs ----------------------------------------------------
    def _run(self, built, fetch=None, row_block=None,
             **feeds) -> Dict[str, torch.Tensor]:
        """Run one program of the model over params + pools + feeds
        (fetching `fetch`, default the next token) and adopt its pool
        outputs; returns the env."""
        env, self._pools = run_model_program(
            built, self._params, self._pools, self._cache_names,
            self.device, fetch or (built["next_token"],),
            row_block=row_block, **feeds)
        return env

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _prefill_run(self, bucket, tokens, seq_len, last_idx):
        built = self.model.prefill(bucket)
        env = self._run(built, tokens=self._tensor(tokens),
                        seq_len=self._tensor(seq_len),
                        last_idx=self._tensor(last_idx),
                        page_table=self._tensor(self._page_tables))
        return env[built["next_token"]].to(torch.int32).cpu().numpy()

    def _chunk_run(self, tokens, write_pos, active, remaining):
        """Up to decode_chunk step runs with the reference While loop's
        condition and body (host-side loop state).  Returns (outbuf,
        steps, tok, wp, act, rem) as numpy."""
        chunk = self.config.decode_chunk
        eos = self.config.eos_id
        step = self.model.step
        outbuf = np.full((tokens.shape[0], chunk), -1, np.int32)
        pt = self._tensor(self._page_tables)
        tok, wp, act, rem = tokens, write_pos, active, remaining
        i, fin_any = 0, False
        while i < chunk and not fin_any and act.sum() > 0:
            # one host->device copy carries the four per-step feeds
            feed = self._tensor(np.stack([tok, wp, wp + 1, act]))
            env = self._run(step, tokens=feed[0], write_pos=feed[1],
                            lengths=feed[2], active=feed[3],
                            page_table=pt)
            nxt = env[step["next_token"]].to(torch.int32).cpu().numpy()
            produced = act > 0
            outbuf[:, i] = np.where(produced, nxt, -1)
            wp = wp + act
            rem = rem - act
            fin = produced & (rem <= 0)
            if eos is not None:
                fin = fin | (produced & (nxt == eos))
            act = np.where(fin, 0, act).astype(np.int32)
            tok = np.where(produced, nxt, tok).astype(np.int32)
            fin_any = bool(fin.any())
            i += 1
        return outbuf, i, tok, wp, act, rem

    def _verify_run(self, folded, drafts, slot_meta, page_table):
        """One speculative verify run: folded rows [tokens, write_pos,
        lengths, active] at (4, S*(k+1)), drafts (S, k), slot_meta rows
        [draft_len, slot_active] at (2, S), page_table (S*(k+1),
        max_pages).  Returns (accepted (S,), tokens (S, k+1)) as numpy,
        read back in one copy.  The run is batch-invariant at S rows
        (OpContext.row_block): each folded row gets the bits the step
        run at S rows would give it, so the committed tokens are the
        sequential engine's on the card too."""
        ver = self.model.verify(self.speculate_k)
        f = self._tensor(folded)
        meta = self._tensor(slot_meta)
        env = self._run(ver, (ver["accepted"], ver["tokens"]),
                        row_block=self.config.num_slots, tokens=f[0],
                        write_pos=f[1], lengths=f[2], active=f[3],
                        drafts=self._tensor(drafts), draft_len=meta[0],
                        slot_active=meta[1],
                        page_table=self._tensor(page_table))
        both = torch.cat([env[ver["accepted"]].to(torch.int32)[:, None],
                          env[ver["tokens"]].to(torch.int32)], dim=1)
        both = both.cpu().numpy()
        return both[:, 0], both[:, 1:]

    def _warmup(self):
        """Run every prefill bucket and one decode step (with
        speculate_k, one verify run instead) with nothing to write
        (seq_len 0, active 0): kernel builds, cuBLAS set-up and the
        allocator's first pool growth land here, and the pools stay as
        they were."""
        cfg = self.config
        s = cfg.num_slots
        zeros = np.zeros((s,), np.int32)
        for t in cfg.prefill_buckets:
            self._prefill_run(t, np.zeros((s, t), np.int32), zeros,
                              np.zeros((s, 1), np.int32))
        if self.speculate_k:
            k1 = self.speculate_k + 1
            folded = np.zeros((4, s * k1), np.int32)
            folded[2] = 1                                  # lengths
            self._verify_run(
                folded, np.zeros((s, self.speculate_k), np.int32),
                np.zeros((2, s), np.int32),
                np.zeros((s * k1, cfg.max_pages_per_slot), np.int32))
        else:
            feed = self._tensor(np.stack([zeros, zeros, zeros + 1,
                                          zeros]))
            self._run(self.model.step, tokens=feed[0], write_pos=feed[1],
                      lengths=feed[2], active=feed[3],
                      page_table=self._tensor(self._page_tables))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return len(cfg.prefill_buckets) + 1

    # -- lifecycle ------------------------------------------------------
    def start(self) -> "DecodeEngine":
        """Allocate the pools, warm every program up, then open for
        traffic.  Steady state builds no kernel."""
        with self._cv:
            if self._started:
                raise RuntimeError("engine already started")
            self._started = True
        cfg = self.config
        if self._event_log is not None:
            self._event_log.event(
                "serving_decode_start",
                num_slots=cfg.num_slots, page_size=cfg.page_size,
                num_pages=cfg.num_pages, max_len=cfg.max_len,
                prefill_buckets=list(cfg.prefill_buckets),
                decode_chunk=cfg.decode_chunk, kv_dtype=cfg.kv_dtype,
                device=str(self.device),
                queue_capacity=self.admission.queue_capacity)
        if self.memory_budget_bytes is not False:
            self.fit_plan = {"skipped": "plan_fit not ported",
                             "budget_bytes": self.memory_budget_bytes
                             or None}
        snap = runtime_stats.snapshot()
        t0 = time.perf_counter()
        self._pools = self.model.fresh_pools(cfg.num_pages, cfg.page_size,
                                             self.device)
        n_runs = self._warmup()
        if self.drafter is not None:
            # drafter warmup lands inside the warmup window, so the
            # zero-post-warmup-compile contract covers drafting too
            self.drafter.start(self)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            if self._event_log is not None:
                self._event_log.event(
                    "serving_decode_speculate",
                    speculate_k=self.speculate_k,
                    drafter=type(self.drafter).__name__)
        delta = runtime_stats.delta(snap)
        self.stats.record_warmup(n_runs, delta["compiles"],
                                 delta["compile_time_s"],
                                 time.perf_counter() - t0)
        self.admission.start()
        self._worker = threading.Thread(target=self._loop,
                                        name="decode-scheduler",
                                        daemon=True)
        self._worker.start()
        return self

    def drain(self, timeout_s: float = 120.0) -> bool:
        """Stop admission, let every accepted request finish decoding.
        Idempotent."""
        self.admission.begin_drain()
        end = time.monotonic() + timeout_s
        with self._cv:
            self._cv.notify_all()
            while self._unresolved > 0:
                remaining = end - time.monotonic()
                if remaining <= 0:
                    return False
                self._cv.wait(min(remaining, 0.05))
        if self._event_log is not None:
            self.stats.emit("serving_decode_drain", drained=True)
        return True

    def close(self, timeout_s: float = 120.0):
        if self.admission.state == "running":
            self.drain(timeout_s)
        with self._cv:
            self._stop = True
            self._cv.notify_all()
        if self._worker is not None:
            self._worker.join(timeout_s)
        # shutdown never strands a future: anything a timed-out drain
        # left behind resolves with the RETRYABLE structured error
        self._pull_all("shutdown")
        self.admission.finish_drain()
        if self._own_log is not None:
            self._own_log.close()

    def __enter__(self) -> "DecodeEngine":
        return self.start() if not self._started else self

    def __exit__(self, *exc):
        self.close()
        return False

    def health(self) -> Dict[str, Any]:
        return self.admission.health(
            active_slots=sum(s is not None for s in self._slots),
            num_slots=self.config.num_slots,
            queue_depth=len(self._queue),
            pages_in_use=self.page_pool.in_use,
            num_pages=self.config.num_pages,
            completed=self.stats.completed,
            post_warmup_compiles=self.stats.post_warmup_compiles())

    def evacuate(self, timeout_s: float = 30.0):
        raise NotImplementedError(
            "DecodeEngine.evacuate (fleet weight roll) is not ported "
            "yet: ROADMAP queue A item 7")

    def reload(self, source, version: Optional[int] = None,
               timeout_s: float = 60.0):
        raise NotImplementedError(
            "DecodeEngine.reload (hot weight swap) is not ported yet: "
            "ROADMAP queue A item 7")

    # -- request path ---------------------------------------------------
    def submit(self, prompt, max_new_tokens: int = 32,
               priority: int = 0,
               deadline_ms: Optional[float] = None) -> Future:
        """Accept one generation request; returns a Future of the
        generated token ids (np.int32, includes the eos token when one
        stopped it).  Raises DecodeBucketMissError / QueueFullError /
        CircuitOpenError / ServingClosedError synchronously."""
        trace = None
        if self.tracer is not None:
            trace = self.tracer.new_trace("decode")
        prompt = np.asarray(prompt)
        if prompt.ndim != 1 or prompt.size < 1:
            raise DecodeBucketMissError(
                "prompt must be a non-empty 1-D token array",
                got_shape=list(prompt.shape))
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        cfg = self.config
        plen = int(prompt.size)
        if BucketConfig.pick(cfg.prefill_buckets, plen) is None:
            self.stats.record_bucket_miss()
            raise DecodeBucketMissError(
                f"prompt length {plen} exceeds the largest prefill "
                f"bucket {cfg.prefill_buckets[-1]}",
                prompt_len=plen,
                prefill_buckets=list(cfg.prefill_buckets))
        if plen + max_new_tokens > cfg.max_len:
            self.stats.record_bucket_miss()
            raise DecodeBucketMissError(
                f"prompt {plen} + max_new_tokens {max_new_tokens} "
                f"exceeds the per-slot budget max_len {cfg.max_len}",
                prompt_len=plen, max_new_tokens=int(max_new_tokens),
                max_len=cfg.max_len)
        deadline = self.admission.deadline_for(deadline_ms)
        req = DecodeRequest(prompt.astype(np.int32), max_new_tokens,
                            priority=priority, deadline=deadline,
                            trace=trace)
        try:
            with self._cv:
                self.admission.check(self._unresolved)
                self._queue.append(req)
                self._unresolved += 1
                self._cv.notify_all()
        except ServingError as e:
            if e.kind == "queue_full":
                self.stats.record_shed()
            elif e.kind == "circuit_open":
                self.stats.record_circuit_reject()
            if trace is not None:
                trace.point("rejected", reject=e.kind)
                self.tracer.finish(trace, error=e)
            raise
        self.stats.record_submit()
        return req.future

    def generate(self, prompt, max_new_tokens: int = 32,
                 timeout_s: Optional[float] = None,
                 **kw) -> np.ndarray:
        """Synchronous submit()+result() convenience."""
        return self.submit(prompt, max_new_tokens, **kw).result(
            timeout_s)

    # -- scheduler ------------------------------------------------------
    def _loop(self):
        if self.device.type == "cuda":
            # this thread launches on its own current stream of the
            # engine's device
            torch.cuda.set_device(self.device)
        while True:
            with self._cv:
                while (not self._stop and not self._queue
                       and not any(self._slots)):
                    self._cv.wait(0.05)
                if self._stop:
                    return
            try:
                self._admit()
                self._decode()
            except BaseException as e:  # noqa: BLE001 — the scheduler
                #                         thread must never die silently
                self._fail_everything(e)
                return
            self.stats.maybe_emit()

    def _pull_all(self, reason: str, cause: Optional[str] = None
                  ) -> List[Dict[str, Any]]:
        """Remove EVERY accepted-but-unresolved request (active slots +
        queue), resolve each future with the structured, retryable
        DecodeReplicaFailedError carrying its requeue descriptor, free
        the pages, and return the descriptors.  Only safe on the
        scheduler thread or once the scheduler is stopped/dead."""
        victims: List[tuple] = []
        for i, slot in enumerate(self._slots):
            if slot is None:
                continue
            self._slots[i] = None
            self.page_pool.free(slot.pages)
            self._page_tables[i, :] = 0
            victims.append((slot.req, slot.generated))
        with self._cv:
            victims += [(r, []) for r in self._queue]
            self._queue = []
            self._unresolved -= len(victims)
            self._cv.notify_all()
        descs: List[Dict[str, Any]] = []
        if not victims:
            return descs
        self.stats.record_evacuation(len(victims))
        if self._event_log is not None:
            self._event_log.event(
                "serving_decode_evacuate", reason=reason, cause=cause,
                requests=len(victims),
                pages_free_after=self.page_pool.free_pages)
        for req, gen in victims:
            d = req.descriptor(gen)
            descs.append(d)
            err = DecodeReplicaFailedError(
                f"request pulled off the engine ({reason}) after "
                f"{len(gen)} committed token(s); requeue the descriptor",
                reason=reason, cause=cause, descriptor=d)
            if req.trace is not None:
                req.trace.point("evacuated", reason=reason,
                                committed=len(gen))
                self.tracer.finish(req.trace, error=err)
            if not req.future.done():
                req.future.set_exception(err)
        return descs

    def _fail_everything(self, exc: BaseException):
        """The scheduler died: stop accepting, then resolve every
        accepted request with the structured retryable error."""
        try:
            self.admission.begin_drain()
        except ServingError:
            pass
        self._pull_all("scheduler_failed",
                       cause=f"{type(exc).__name__}: {exc}")

    def _resolve(self, slot_id: int,
                 error: Optional[BaseException] = None):
        slot = self._slots[slot_id]
        self._slots[slot_id] = None
        self.page_pool.free(slot.pages)
        self._page_tables[slot_id, :] = 0
        with self._cv:
            self._unresolved -= 1
            self._cv.notify_all()
        tr = slot.req.trace
        if error is not None:
            if not slot.req.future.done():
                slot.req.future.set_exception(error)
            if tr is not None:
                self.tracer.finish(tr, error=error)
            return
        if not slot.req.future.done():
            slot.req.future.set_result(
                np.asarray(slot.generated, np.int32))
        self.stats.record_done()
        if tr is not None:
            self.tracer.finish(tr)

    def _requeue(self, slot_id: int):
        """Preempt: pages returned, request re-enters the queue head
        and will regenerate from the prompt (greedy => identical
        tokens)."""
        slot = self._slots[slot_id]
        self._slots[slot_id] = None
        self.page_pool.free(slot.pages)
        self._page_tables[slot_id, :] = 0
        slot.req.preempted += 1
        if slot.req.trace is not None:
            slot.req.trace.point(
                "preempt", slot=slot_id, committed=slot.committed,
                generated=len(slot.generated))
        with self._cv:
            self._queue.insert(0, slot.req)
        self.stats.record_preemption()
        if self._event_log is not None:
            self._event_log.event(
                "serving_decode_preempt", slot=slot_id,
                priority=slot.req.priority,
                committed=slot.committed,
                generated=len(slot.generated),
                pages_freed=len(slot.pages),
                pages_free_after=self.page_pool.free_pages)

    def _set_pages(self, slot_id: int, pages: List[int]):
        self._page_tables[slot_id, :] = 0
        self._page_tables[slot_id, :len(pages)] = pages

    def _admit(self):
        """Fill open slots from the queue (prefill-on-join): pick
        joiners, allocate prompt pages, run ONE bucket-padded prefill
        over the whole slot batch (non-joiners masked out by seq_len
        0)."""
        cfg = self.config
        now = time.monotonic()
        joiners: List[int] = []
        while True:
            free_ids = [i for i, s in enumerate(self._slots)
                        if s is None]
            if not free_ids:
                break
            req = None
            with self._cv:
                # priority first, then FIFO; expired requests drop
                # before any device time is spent on them
                self._queue.sort(key=lambda r: (-r.priority,
                                                r.t_submit))
                while self._queue:
                    cand = self._queue[0]
                    if cand.deadline is not None \
                            and now > cand.deadline:
                        self._queue.pop(0)
                        self._unresolved -= 1
                        self.stats.record_deadline_miss()
                        exc = DeadlineExceededError(
                            "deadline expired before a slot opened",
                            queued_ms=round(
                                (now - cand.t_submit) * 1e3, 3))
                        if cand.trace is not None:
                            cand.trace.add("join_wait", cand.t_submit,
                                           now, expired=True)
                            self.tracer.finish(cand.trace, error=exc)
                        cand.future.set_exception(exc)
                        continue
                    req = cand
                    break
                if req is not None:
                    need = _cdiv(len(req.prompt), cfg.page_size)
                    pages = self.page_pool.alloc(need)
                    if pages is None:
                        req = None  # pool dry: decode frees pages,
                        #             not admission
                    else:
                        self._queue.pop(0)
            if req is None:
                break
            slot_id = free_ids[0]
            self._slots[slot_id] = _Slot(req, pages)
            self._set_pages(slot_id, pages)
            joiners.append(slot_id)
        if joiners:
            self._dispatch_prefill(joiners)

    def _dispatch_prefill(self, joiners: List[int]):
        cfg = self.config
        bucket = BucketConfig.pick(
            cfg.prefill_buckets,
            max(len(self._slots[i].req.prompt) for i in joiners))
        tokens = np.zeros((cfg.num_slots, bucket), np.int32)
        seq_len = np.zeros((cfg.num_slots,), np.int32)
        last_idx = np.zeros((cfg.num_slots, 1), np.int32)
        for i in joiners:
            p = self._slots[i].req.prompt
            tokens[i, :len(p)] = p
            seq_len[i] = len(p)
            last_idx[i, 0] = len(p) - 1
        t_p0 = time.monotonic()  # join_wait ends / prefill begins
        for i in joiners:
            tr = self._slots[i].req.trace
            if tr is not None:
                tr.add("join_wait", self._slots[i].req.t_submit, t_p0,
                       slot=i)
        try:
            nxt = self._prefill_run(bucket, tokens, seq_len, last_idx)
        except Exception as e:  # noqa: BLE001 — resolved, not raised
            # the failed run may have written part of the joiners' pages
            # in place; those pages are freed with the joiners below
            self.stats.record_executor_failure()
            self._breaker_result(False, len(joiners))
            err = ExecutorFailureError(
                f"prefill dispatch failed for {len(joiners)} join(s): "
                f"{type(e).__name__}: {e}",
                error_type=type(e).__name__, joins=len(joiners))
            self._trace_dispatch(joiners, t_p0, kind="prefill",
                                 error=type(e).__name__)
            for i in joiners:
                self._resolve(i, error=err)
            return
        self._trace_dispatch(joiners, t_p0, kind="prefill", bucket=bucket)
        self._breaker_result(True, len(joiners))
        now = time.monotonic()
        ttfts = []
        for i in joiners:
            slot = self._slots[i]
            tok = int(nxt[i])
            slot.cur_tok = tok
            slot.generated.append(tok)
            slot.remaining = slot.req.max_new_tokens - 1
            ttfts.append((now - slot.req.t_submit) * 1e3)
        self.stats.record_prefill(len(joiners), ttfts)
        if self.drafter is not None:
            # mirror the join into the draft pool (same buffers, same
            # page tables: the pools share geometry by construction)
            self.drafter.on_prefill(self, joiners, tokens, seq_len,
                                    last_idx)
        # a request satisfied by its very first token resolves here
        for i in joiners:
            slot = self._slots[i]
            if slot.remaining <= 0 or (cfg.eos_id is not None
                                       and slot.cur_tok == cfg.eos_id):
                self._resolve(i)

    def _trace_dispatch(self, slot_ids, t0, **attrs):
        """One `dispatch` span [t0, now) on each traced slot's request."""
        t1 = time.monotonic()
        for i in slot_ids:
            tr = self._slots[i].req.trace
            if tr is not None:
                tr.add("dispatch", t0, t1, slot=i, **attrs)

    def _breaker_result(self, ok: bool, n: int):
        res = self.admission.record_dispatch_result(ok)
        if res and self._event_log is not None:
            self._event_log.event(
                f"serving_breaker_{'open' if res == 'opened' else 'close'}",
                state=self.admission.state, component="decode_engine",
                breaker=self.admission.breaker.snapshot(),
                batch=n)

    def _ensure_decode_pages(self) -> List[int]:
        """Extend every active slot's pages to cover the next chunk,
        preempting the least-important slots when the pool runs dry.
        Returns the slot ids still active afterwards."""
        cfg = self.config
        # speculative rounds commit at most k+1 tokens per run
        # (positions committed..committed+k), the chunk loop at most
        # decode_chunk: the page window follows whichever path runs
        window = (self.speculate_k + 1) if self.speculate_k \
            else cfg.decode_chunk
        order = sorted(
            (i for i, s in enumerate(self._slots) if s is not None),
            key=lambda i: self._slots[i].importance(), reverse=True)
        for i in order:
            slot = self._slots[i]
            if slot is None:
                continue  # preempted as a victim earlier in the loop
            target = _cdiv(min(slot.committed + window,
                               slot.cap_tokens), cfg.page_size)
            while slot is not None and target > len(slot.pages):
                got = self.page_pool.alloc(target - len(slot.pages))
                if got is not None:
                    slot.pages.extend(got)
                    self._set_pages(i, slot.pages)
                    break
                # pool dry: evict the least-important active slot
                # (possibly this one)
                victims = [j for j, sj in enumerate(self._slots)
                           if sj is not None]
                victim = min(victims,
                             key=lambda j: self._slots[j].importance())
                self._requeue(victim)
                slot = self._slots[i]
        return [i for i, s in enumerate(self._slots) if s is not None]

    def _decode(self):
        if self.speculate_k:
            self._decode_speculative()
            return
        cfg = self.config
        active_ids = self._ensure_decode_pages()
        if not active_ids:
            return
        s = cfg.num_slots
        tokens = np.zeros((s,), np.int32)
        write_pos = np.zeros((s,), np.int32)
        active = np.zeros((s,), np.int32)
        remaining = np.zeros((s,), np.int32)
        for i in active_ids:
            slot = self._slots[i]
            tokens[i] = slot.cur_tok
            write_pos[i] = slot.committed
            active[i] = 1
            remaining[i] = slot.remaining
        t0 = time.perf_counter()
        t_d0 = time.monotonic()
        try:
            (outbuf, steps, new_tok, new_wp, new_act,
             new_rem) = self._chunk_run(tokens, write_pos, active,
                                        remaining)
        except Exception as e:  # noqa: BLE001 — resolved, not raised
            self._fail_decode(active_ids, "decode", t_d0, e)
            return
        elapsed_ms = (time.perf_counter() - t0) * 1e3
        self._trace_dispatch(active_ids, t_d0, kind="decode",
                             iterations=int(steps))
        self._breaker_result(True, len(active_ids))
        total_tokens = 0
        for i in active_ids:
            slot = self._slots[i]
            produced = int(new_wp[i]) - slot.committed
            toks = [int(t) for t in outbuf[i, :produced] if t >= 0]
            slot.generated.extend(toks)
            total_tokens += len(toks)
            slot.committed = int(new_wp[i])
            slot.cur_tok = int(new_tok[i])
            slot.remaining = int(new_rem[i])
        self.stats.record_decode(
            steps, len(active_ids), cfg.num_slots, total_tokens,
            self.page_pool.in_use, cfg.num_pages, elapsed_ms)
        for i in active_ids:
            if int(new_act[i]) == 0:
                self._resolve(i)

    def _fail_decode(self, active_ids, what, t_d0, e):
        """A decode or verify run raised: count it, trace it, and
        resolve every slot it carried with the structured error."""
        self.stats.record_executor_failure()
        self._breaker_result(False, len(active_ids))
        err = ExecutorFailureError(
            f"{what} dispatch failed for {len(active_ids)} "
            f"slot(s): {type(e).__name__}: {e}",
            error_type=type(e).__name__, slots=len(active_ids))
        self._trace_dispatch(active_ids, t_d0, kind="decode",
                             error=type(e).__name__)
        for i in active_ids:
            self._resolve(i, error=err)

    def _decode_speculative(self):
        """One verify round: draft, score all drafts in ONE folded run,
        commit the accepted prefix (+1 model token) per slot.  The
        sequential chunk's tokens by the greedy-acceptance argument of
        ops/paged_kv.py `speculative_accept`; rollback of a rejected
        tail is not advancing `committed` — the stale rows sit past
        every length and are overwritten before any attention reads
        them."""
        cfg = self.config
        k = self.speculate_k
        k1 = k + 1
        active_ids = self._ensure_decode_pages()
        if not active_ids:
            return
        s = cfg.num_slots
        proposals, prop_len = self.drafter.draft(self, active_ids)
        folded = np.zeros((4, s * k1), np.int32)
        tokens, write_pos, lengths, active = folded
        slot_meta = np.zeros((2, s), np.int32)
        draft_len, slot_active = slot_meta
        drafts = np.zeros((s, k), np.int32)
        pt = np.zeros((s * k1, cfg.max_pages_per_slot), np.int32)
        ar = np.arange(k1)
        for i in active_ids:
            slot = self._slots[i]
            # cap so emitted (accepted+1) never exceeds the remaining
            # budget and the last write position stays under cap_tokens
            m = int(min(int(prop_len[i]), k, slot.remaining - 1))
            draft_len[i] = m
            drafts[i, :m] = proposals[i, :m]
            slot_active[i] = 1
            base = i * k1
            live = ar <= m          # row 0 always live (m >= 0)
            # dead rows pin to the slot's current position: their writes
            # drop (active 0) and their predictions are discarded, but
            # their feeds stay in range
            off = np.where(live, ar, 0)
            tokens[base] = slot.cur_tok
            tokens[base + 1:base + k1] = drafts[i]
            write_pos[base:base + k1] = slot.committed + off
            lengths[base:base + k1] = slot.committed + off + 1
            active[base:base + k1] = live
            pt[base:base + k1] = self._page_tables[i]
        drafted_total = int(draft_len.sum())
        t0 = time.perf_counter()
        t_d0 = time.monotonic()
        try:
            accepted, emitted = self._verify_run(folded, drafts, slot_meta,
                                                 pt)
        except Exception as e:  # noqa: BLE001 — resolved, not raised
            self._fail_decode(active_ids, "speculative verify", t_d0, e)
            return
        elapsed_ms = (time.perf_counter() - t0) * 1e3
        t_d1 = time.monotonic()
        self._breaker_result(True, len(active_ids))
        total_tokens = 0
        accept_counts = []
        finished = []
        for i in active_ids:
            slot = self._slots[i]
            a = int(accepted[i])
            accept_counts.append(a)
            toks = emitted[i, :a + 1].tolist()
            if cfg.eos_id is not None and cfg.eos_id in toks:
                # the sequential engine stops at the FIRST eos; tokens
                # the verify scored past it were never really emitted
                toks = toks[:toks.index(cfg.eos_id) + 1]
            n = len(toks)
            slot.generated.extend(toks)
            total_tokens += n
            slot.committed += n
            slot.cur_tok = toks[-1]
            slot.remaining -= n
            tr = slot.req.trace
            if tr is not None:
                tr.add("dispatch", t_d0, t_d1, kind="decode",
                       iterations=1, slot=i)
                tr.add("speculate", t_d0, t_d1, slot=i,
                       drafted=int(draft_len[i]), accepted=a, emitted=n)
            if slot.remaining <= 0 or (cfg.eos_id is not None
                                       and cfg.eos_id in toks):
                finished.append(i)
        self.stats.record_decode(
            1, len(active_ids), cfg.num_slots, total_tokens,
            self.page_pool.in_use, cfg.num_pages, elapsed_ms)
        self.stats.record_verify(drafted_total, total_tokens,
                                 accept_counts)
        for i in finished:
            self._resolve(i)
