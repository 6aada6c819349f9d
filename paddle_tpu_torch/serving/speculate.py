"""Drafting for speculative decoding: the port of
paddle_tpu/serving/speculate.py.

`DecodeEngine(speculate_k=k)` replaces the one-token-per-iteration chunk
loop with verified multi-token steps: a drafter proposes up to k tokens
per slot, one verify run (the step program at folded batch S*(k+1),
models/decoder_lm.py `verify`) scores all of them, and greedy
longest-accepted-prefix acceptance commits 1..k+1 tokens — the
sequential engine's tokens, because the verify forward is the
sequential forward at every drafted position.

Two interchangeable drafters behind one protocol:

- `NGramDrafter` (the default): host-side prompt-lookup drafting —
  propose the tokens that followed the most recent earlier occurrence of
  the current suffix n-gram in (prompt + generated).  No device work,
  deterministic, effective on repetitive streams.
- `ModelDrafter`: a small draft `DecoderLM` with its OWN KV pools at the
  ENGINE's (num_pages, page_size) geometry, addressed by the ENGINE's
  page tables, so join/leave/preempt keep both pools aligned with no
  extra bookkeeping.  Its k draft steps are a host loop of step-program
  runs at batch S (the port's form of the reference's `fori_loop`, as
  the engine's chunk is), the tokens carried on the device between
  them; prefill-on-join (and, on a disagg decode worker, each KV
  import) mirrors into the draft pool through the same bucket ladder.

Draft-pool consistency needs no rollback hook: accepted-prefix rows are
what a sequential draft run over the committed stream would have
written, and rejected-tail rows sit past every slot's length.  The draft
loop writes positions committed..committed+k-1 only, as the reference's
does: when all k drafts are accepted, the K/V of the last draft
(position committed+k) never enters the draft pool, and the next round
attends whatever that row held before; and near a slot's budget its k
steps write past the slot's pages, through page-table entries 0, into
page 0.  So even a drafter with the target's own weights does not
accept every draft (ROADMAP C7).

All drafter warmup runs happen inside `DecodeEngine.start()`'s warmup
window, so the zero-post-warmup-compile contract covers drafting too.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from ..core.executor import RNG_STATE_VAR


def ngram_propose(context, k: int, ngram: int = 3) -> List[int]:
    """Prompt-lookup drafting: find the MOST RECENT earlier occurrence
    of the trailing g-gram of `context` (g = ngram down to 1) and
    propose the <= k tokens that followed it.  Among the occurrences of
    a g-gram, the most recent one with a FULL k-token continuation wins
    over a nearer one truncated by the context end — in a short-period
    cycle the nearest match sits within k tokens of the tail and would
    cap every proposal below k.  Pure and deterministic.  Returns []
    when nothing matches."""
    ctx = np.asarray(context, dtype=np.int64).ravel()
    n = int(ctx.size)
    k = int(k)
    if n < 2 or k < 1:
        return []
    for g in range(min(int(ngram), n - 1), 0, -1):
        # vectorized window match: starts 0..n-g-1, window == tail
        tail = ctx[n - g:]
        match = ctx[:n - g] == tail[0]
        for j in range(1, g):
            match &= ctx[j:j + n - g] == tail[j]
        idx = np.nonzero(match)[0]
        if idx.size:
            full = idx[idx + g + k <= n]
            if full.size:
                start = int(full[-1])
            else:
                part = idx[idx + g < n]
                if not part.size:
                    continue
                start = int(part[-1])
            return [int(t) for t in ctx[start + g:start + g + k]]
    return []


class Drafter:
    """Protocol between DecodeEngine and a drafting strategy.

    The engine calls, always on its scheduler thread:
    - `start(engine)` inside the warmup window;
    - `on_prefill(engine, joiners, tokens, seq_len, last_idx)` after
      every successful prefill-on-join run (the same padded host
      buffers the engine ran);
    - `on_import(engine, slot_id)` after a disagg KV handoff seeds a
      slot on a decode-role worker;
    - `draft(engine, active_ids) -> (drafts (S, k) int32, draft_len
      (S,) int32)` once per verify round.  Proposals may be shorter than
      k (ragged draft_len); the ENGINE caps them again to the slot's
      remaining budget.
    """

    k: int = 0

    def start(self, engine) -> None:
        pass

    def on_prefill(self, engine, joiners, tokens, seq_len,
                   last_idx) -> None:
        pass

    def on_import(self, engine, slot_id) -> None:
        pass

    def draft(self, engine, active_ids
              ) -> Tuple[np.ndarray, np.ndarray]:
        raise NotImplementedError


class NGramDrafter(Drafter):
    """Host-side prompt-lookup drafting (the default drafter): no device
    work, no state — the context is the slot's (prompt + generated)
    stream the scheduler already holds."""

    def __init__(self, k: int, ngram: int = 3):
        if int(k) < 1:
            raise ValueError(f"k must be >= 1, got {k}")
        if int(ngram) < 1:
            raise ValueError(f"ngram must be >= 1, got {ngram}")
        self.k = int(k)
        self.ngram = int(ngram)

    def draft(self, engine, active_ids):
        s = engine.config.num_slots
        drafts = np.zeros((s, self.k), np.int32)
        draft_len = np.zeros((s,), np.int32)
        for i in active_ids:
            slot = engine._slots[i]
            ctx = np.concatenate([
                np.asarray(slot.req.prompt, np.int64).ravel(),
                np.asarray(slot.generated, np.int64)])
            follow = ngram_propose(ctx, self.k, self.ngram)
            draft_len[i] = len(follow)
            drafts[i, :len(follow)] = follow
        return drafts, draft_len


class ModelDrafter(Drafter):
    """A small draft DecoderLM following the target slot for slot.

    model: a models.decoder_lm.DecoderLM (its parameter names come out of
        the same `unique_name.guard()` discipline as the target's).
    params: name -> tensor weights (convert.params_from_arrays), as the
        engine takes them; None runs the model's startup program on the
        engine's device at `start`.
    Pools are allocated at the ENGINE's page geometry on the engine's
    device and addressed by the ENGINE's page tables.  A draft model with
    the target's own architecture and weights is the oracle drafter.
    """

    def __init__(self, model, k: int, params=None):
        if int(k) < 1:
            raise ValueError(f"k must be >= 1, got {k}")
        self.model = model
        self.k = int(k)
        self._given = params
        self._params = None
        self._pools = None
        self._device = None

    # -- lifecycle (inside the engine's warmup window) -----------------
    def start(self, engine) -> None:
        from .. import CPUPlace, CUDAPlace

        cfg = engine.config
        dev = self._device = engine.device
        params = self._given
        if params is None:
            place = CPUPlace() if dev.type == "cpu" \
                else CUDAPlace(dev.index or 0)
            scope = self.model.init_params(place=place)
            params = {n: v for n, v in scope.vars.items()
                      if v is not None and n != RNG_STATE_VAR}
        self._params = {n: v.to(dev) for n, v in params.items()}
        self._pools = self.model.fresh_pools(cfg.num_pages, cfg.page_size,
                                             dev)
        # every program this drafter runs, once, with nothing to write
        # (seq_len 0, active 0): the pools stay as they were
        s = cfg.num_slots
        zeros = np.zeros((s,), np.int32)
        for t in cfg.prefill_buckets:
            self.on_prefill(engine, [], np.zeros((s, t), np.int32), zeros,
                            np.zeros((s, 1), np.int32))
        self._draft_steps(engine, zeros, zeros, zeros)

    def _run(self, built, fetch, **feeds):
        from .decode import run_model_program

        env, self._pools = run_model_program(
            built, self._params, self._pools, self.model.cache_feed_names(),
            self._device, fetch, **feeds)
        return env

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self._device)

    def _draft_steps(self, engine, tokens, write_pos, active):
        """k step runs at batch S: write the pending token's K/V, attend,
        argmax, advance (the reference's draft fori_loop body, no early
        exit).  Tokens and positions stay on the device between steps;
        one read-back at the end.  Returns (S, k) int32 numpy."""
        st = self.model.step
        pt = self._tensor(engine._page_tables)
        feed = self._tensor(np.stack([tokens, write_pos, active]))
        tok, wp, act = feed[0], feed[1], feed[2]
        buf = []
        for _ in range(self.k):
            env = self._run(st, (st["next_token"],), tokens=tok,
                            write_pos=wp, lengths=wp + 1, active=act,
                            page_table=pt)
            nxt = env[st["next_token"]].to(torch.int32)
            buf.append(nxt)
            tok = torch.where(act > 0, nxt, tok)
            wp = wp + act
        return torch.stack(buf, dim=1).cpu().numpy()

    # -- engine hooks ---------------------------------------------------
    def on_prefill(self, engine, joiners, tokens, seq_len,
                   last_idx) -> None:
        """Mirror a prefill-on-join into the draft pool: the same padded
        host buffers the engine ran, addressed by the same page
        tables."""
        self._run(self.model.prefill(tokens.shape[1]), (),
                  tokens=self._tensor(tokens),
                  seq_len=self._tensor(seq_len),
                  last_idx=self._tensor(last_idx),
                  page_table=self._tensor(engine._page_tables))

    def on_import(self, engine, slot_id) -> None:
        """Disagg decode-role hook: a KV handoff seeded the target slot
        but no draft-model KV crossed the wire, so re-prefill the raw
        prompt into the draft pool here (a single joiner, every other
        slot masked out by seq_len 0)."""
        from .engine import BucketConfig

        slot = engine._slots[slot_id]
        prompt = np.asarray(slot.req.prompt)
        plen = int(prompt.size)
        bucket = BucketConfig.pick(engine.config.prefill_buckets, plen)
        if bucket is None:
            raise ValueError(
                f"draft-pool import re-prefill: prompt length {plen} "
                f"fits no prefill bucket "
                f"{list(engine.config.prefill_buckets)}")
        s = engine.config.num_slots
        tokens = np.zeros((s, bucket), np.int32)
        seq_len = np.zeros((s,), np.int32)
        last_idx = np.zeros((s, 1), np.int32)
        tokens[slot_id, :plen] = prompt
        seq_len[slot_id] = plen
        last_idx[slot_id, 0] = plen - 1
        self.on_prefill(engine, [slot_id], tokens, seq_len, last_idx)

    def draft(self, engine, active_ids):
        s = engine.config.num_slots
        tokens = np.zeros((s,), np.int32)
        wp = np.zeros((s,), np.int32)
        act = np.zeros((s,), np.int32)
        draft_len = np.zeros((s,), np.int32)
        for i in active_ids:
            slot = engine._slots[i]
            tokens[i] = slot.cur_tok
            wp[i] = slot.committed
            act[i] = 1
            draft_len[i] = self.k
        return self._draft_steps(engine, tokens, wp, act), draft_len
