"""Decoder-only causal LM for paged continuous-batching decode.

The port of paddle_tpu/models/decoder_lm.py: the same builder, the same
programs and the same parameter names, so `Program.to_dict()` of each
build equals the reference's.  A pre-norm transformer decoder whose
attention lives in the paged-KV contract — prefill writes a prompt's K/V
into pool pages through the slot's page table, every decode step commits
one token and attends over the pages (ops/paged_kv.py).

TWO fluid program families share one parameter set (the same layer
sequence built under `unique_name.guard()`, so generated parameter names
line up):

- the **prefill** program (one per sequence bucket, T static): tokens
  (S, T) -> causal flash attention over the prompt (head-major "nthd"
  layout, key-padding bias from seq_len) + `paged_kv_prefill_write` of
  all prompt K/V, then the FIRST generated token from the last valid
  position's logits.
- the **step** program (ONE, shape-polymorphic in slots/pool): token
  (S,) at write_pos -> `paged_kv_write` + `paged_attention` per layer,
  next-token argmax.
- the **verify** program (one per draft length k): the step body at the
  folded batch S*(k+1) plus in-step greedy acceptance
  (`speculative_accept`) — the speculative engine's one run a round.

`use_pallas` and `prefill_pallas` are kept as op attrs so the serialized
programs stay identical to the reference's; the port routes attention by
the tensors' device instead (CUDA: the hand-written kernels).  Greedy
decode only (argmax): deterministic, which is what makes the
continuous-batching parity suite exact.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import layers
from ..core import unique_name
from ..core.program import Program, program_guard
from ..initializer import Normal
from ..param_attr import ParamAttr

_POOL_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                "int8": torch.int8}


class DecoderLM:
    """Builder holding the architecture; programs are built on demand.

    kv_dtype: pool storage dtype — "float32" (exact parity),
        "bfloat16", or "int8" (per-row scale sidecars).
    use_pallas / prefill_pallas: recorded on the attention ops as the
        reference records them (they do not route in the port).
    """

    def __init__(self, vocab_size=1000, n_layer=2, n_head=4,
                 d_model=256, d_inner=512, use_pallas=None,
                 prefill_pallas=None, kv_dtype="float32", seed=0):
        if d_model % n_head:
            raise ValueError(f"d_model {d_model} % n_head {n_head}")
        self.vocab_size = int(vocab_size)
        self.n_layer = int(n_layer)
        self.n_head = int(n_head)
        self.d_model = int(d_model)
        self.d_inner = int(d_inner)
        self.d_head = self.d_model // self.n_head
        self.use_pallas = use_pallas
        self.prefill_pallas = prefill_pallas
        self.kv_dtype = str(kv_dtype)
        if self.kv_dtype not in _POOL_DTYPES:
            raise ValueError(f"unsupported kv_dtype {kv_dtype!r}")
        self.seed = int(seed)
        self.step = self._build("step")
        self._prefill_cache = {}
        self._verify_cache = {}

    @property
    def int8_kv(self) -> bool:
        return self.kv_dtype == "int8"

    def prefill(self, t_bucket: int):
        """The prefill build for one sequence bucket (cached)."""
        t_bucket = int(t_bucket)
        if t_bucket not in self._prefill_cache:
            self._prefill_cache[t_bucket] = self._build("prefill",
                                                        t_bucket)
        return self._prefill_cache[t_bucket]

    def verify(self, k: int):
        """The speculative-verify build for draft length k (cached).

        The step body run at folded batch S*(k+1): row (s, j) scores
        position committed_s + j with staggered per-row lengths, so
        layer i's `paged_kv_write` feeds `paged_attention` in the same
        run and each drafted token attends causally over the slot's
        committed pages plus the earlier drafted rows — what the
        sequential engine would have seen.  Ragged per-slot draft
        lengths ride the `draft_len` (S,) companion, so any accept
        pattern runs through this one shape; rejected tails are rolled
        back by not advancing lengths (their rows are overwritten before
        they are attended).  Greedy acceptance (`speculative_accept`)
        runs in-step: one run emits up to k+1 tokens per slot."""
        k = int(k)
        if k < 1:
            raise ValueError(f"speculate k must be >= 1, got {k}")
        if k not in self._verify_cache:
            self._verify_cache[k] = self._build("verify", k=k)
        return self._verify_cache[k]

    # -- program construction -------------------------------------------
    def _cache_vars(self):
        """Declare the per-layer pool feed vars (dynamic pool dims: one
        step program serves any pool geometry)."""
        caches = []
        for i in range(self.n_layer):
            entry = {
                "k": layers.data(f"kv_k_{i}", shape=[-1, self.d_model],
                                 dtype=self.kv_dtype,
                                 append_batch_size=True),
                "v": layers.data(f"kv_v_{i}", shape=[-1, self.d_model],
                                 dtype=self.kv_dtype,
                                 append_batch_size=True),
            }
            if self.int8_kv:
                entry["ks"] = layers.data(f"kv_ks_{i}", shape=[-1, 1],
                                          dtype="float32",
                                          append_batch_size=True)
                entry["vs"] = layers.data(f"kv_vs_{i}", shape=[-1, 1],
                                          dtype="float32",
                                          append_batch_size=True)
            caches.append(entry)
        return caches

    def _attention(self, mode, x, cache, page_table, seq_len, write_pos,
                   lengths, active, attn_bias):
        """One pre-norm attention sublayer in either mode.  Returns
        (residual output, [cache-out vars])."""
        nfd = 2 if mode == "prefill" else 1
        h = layers.layer_norm(x, begin_norm_axis=nfd)
        q = layers.fc(h, size=self.d_model, num_flatten_dims=nfd,
                      bias_attr=False, name="attn_qkv")
        k = layers.fc(h, size=self.d_model, num_flatten_dims=nfd,
                      bias_attr=False, name="attn_qkv")
        v = layers.fc(h, size=self.d_model, num_flatten_dims=nfd,
                      bias_attr=False, name="attn_qkv")
        ks = cache.get("ks")
        vs = cache.get("vs")
        if mode == "prefill":
            cache_outs = layers.paged_kv_prefill_write(
                k, v, cache["k"], cache["v"], page_table, seq_len,
                k_scale=ks, v_scale=vs)
            # prompt self-attention: causal flash over the head-major
            # grouped layout with the key-padding bias — pages play no
            # part in scoring the prompt against itself
            ctx = layers.flash_attention(
                q, k, v, attn_bias, scale=self.d_head ** -0.5,
                causal=True, use_pallas=self.prefill_pallas,
                layout="nthd", n_head=self.n_head)
        else:
            cache_outs = layers.paged_kv_write(
                k, v, cache["k"], cache["v"], page_table, write_pos,
                active=active, k_scale=ks, v_scale=vs)
            kc_out, vc_out = cache_outs[0], cache_outs[1]
            ctx = layers.paged_attention(
                q, kc_out, vc_out, page_table, lengths, self.n_head,
                scale=self.d_head ** -0.5, use_pallas=self.use_pallas,
                k_scale=cache_outs[2] if self.int8_kv else None,
                v_scale=cache_outs[3] if self.int8_kv else None)
        o = layers.fc(ctx, size=self.d_model, num_flatten_dims=nfd,
                      bias_attr=False, name="attn_out")
        return layers.elementwise_add(x, o), list(cache_outs)

    def _ffn(self, mode, x):
        nfd = 2 if mode == "prefill" else 1
        h = layers.layer_norm(x, begin_norm_axis=nfd)
        h = layers.fc(h, size=self.d_inner, num_flatten_dims=nfd,
                      act="relu", name="ffn_in")
        h = layers.fc(h, size=self.d_model, num_flatten_dims=nfd,
                      name="ffn_out")
        return layers.elementwise_add(x, h)

    def _build(self, mode, t_bucket=None, k=None):
        main, startup = Program(), Program()
        main.random_seed = self.seed
        startup.random_seed = self.seed
        with program_guard(main, startup), unique_name.guard():
            seq_len = write_pos = lengths = active = bias = None
            drafts = draft_len = slot_active = None
            if mode == "prefill":
                tokens = layers.data("tokens", shape=[t_bucket],
                                     dtype="int64")
                seq_len = layers.data("seq_len", shape=[],
                                      dtype="int32")
                last_idx = layers.data("last_idx", shape=[1],
                                       dtype="int32")
                # key-padding bias, exactly the training decoder's form
                m = layers.sequence_mask(seq_len, maxlen=t_bucket,
                                         dtype="float32")
                bias = layers.unsqueeze(
                    layers.unsqueeze(
                        layers.scale(m, scale=1e9, bias=-1e9),
                        axes=[1]),
                    axes=[1])
            else:
                # step and verify share this var set; verify feeds them
                # at the folded batch S*(k+1), step at (S,)
                tokens = layers.data("tokens", shape=[], dtype="int64")
                write_pos = layers.data("write_pos", shape=[],
                                        dtype="int32")
                lengths = layers.data("lengths", shape=[],
                                      dtype="int32")
                active = layers.data("active", shape=[], dtype="int32")
                if mode == "verify":
                    # S-batched companions for in-step acceptance
                    drafts = layers.data("drafts", shape=[k],
                                         dtype="int64")
                    draft_len = layers.data("draft_len", shape=[],
                                            dtype="int32")
                    slot_active = layers.data("slot_active", shape=[],
                                              dtype="int32")
            page_table = layers.data("page_table", shape=[-1],
                                     dtype="int32")
            caches = self._cache_vars()

            emb = layers.embedding(
                tokens, size=[self.vocab_size, self.d_model],
                param_attr=ParamAttr(
                    name="tok_emb",
                    initializer=Normal(0.0, self.d_model ** -0.5)))
            x = layers.scale(emb, scale=self.d_model ** 0.5)
            if mode == "prefill":
                x = layers.add_position_encoding(x)
            else:
                x = layers.add_position_encoding_at(x, write_pos)

            cache_out_names = []
            for i in range(self.n_layer):
                x, cache_outs = self._attention(
                    mode, x, caches[i], page_table, seq_len, write_pos,
                    lengths, active, bias)
                cache_out_names.extend(v.name for v in cache_outs)
                x = self._ffn(mode, x)
            x = layers.layer_norm(
                x, begin_norm_axis=2 if mode == "prefill" else 1)

            if mode == "prefill":
                # logits only at the last valid prompt position
                last = layers.batched_gather(x, last_idx)  # (S, 1, D)
                x = layers.squeeze(last, axes=[1])         # (S, D)
            logits = layers.fc(x, size=self.vocab_size,
                               num_flatten_dims=1, bias_attr=False,
                               name="lm_head")
            next_tok = layers.argmax(logits, axis=1)       # (S,) int
            result = {"main": main, "startup": startup,
                      "next_token": next_tok.name,
                      "logits": logits.name,
                      "cache_outs": cache_out_names}
            if mode == "verify":
                # fold (S*(k+1),) predictions back to (S, k+1) and
                # accept the longest matched draft prefix in-step
                preds = layers.reshape(next_tok, shape=[-1, k + 1])
                accepted, out_toks = layers.speculative_accept(
                    drafts, preds, draft_len, active=slot_active)
                result["accepted"] = accepted.name
                result["tokens"] = out_toks.name
                result["speculate_k"] = k
        return result

    # -- runtime helpers -------------------------------------------------
    def init_params(self, scope=None, place=None):
        """Run the step build's startup once on `place` (default
        CUDAPlace(0); raises without CUDA); returns the scope holding the
        shared parameter set (both program families run against it)."""
        from ..core.executor import Executor, Scope, scope_guard

        scope = scope or Scope()
        with scope_guard(scope):
            Executor(place).run(self.step["startup"])
        return scope

    def fresh_pools(self, num_pages, page_size, device):
        """Zeroed per-layer KV pools (+ scale sidecars of ones for int8)
        on `device`, as a feed dict keyed by the cache feed var names."""
        dt = _POOL_DTYPES[self.kv_dtype]
        pools = {}
        for i in range(self.n_layer):
            shape = (int(num_pages), int(page_size), self.d_model)
            pools[f"kv_k_{i}"] = torch.zeros(shape, dtype=dt,
                                             device=device)
            pools[f"kv_v_{i}"] = torch.zeros(shape, dtype=dt,
                                             device=device)
            if self.int8_kv:
                sshape = (int(num_pages), int(page_size), 1)
                pools[f"kv_ks_{i}"] = torch.ones(
                    sshape, dtype=torch.float32, device=device)
                pools[f"kv_vs_{i}"] = torch.ones(
                    sshape, dtype=torch.float32, device=device)
        return pools

    def pool_specs(self, num_pages, page_size):
        """{name: (shape, torch dtype)} of fresh_pools' tensors, without
        allocating them (the reference's ShapeDtypeStructs: a memory gate
        sizes the pool before any device allocation exists)."""
        dt = _POOL_DTYPES[self.kv_dtype]
        specs = {}
        for i in range(self.n_layer):
            shape = (int(num_pages), int(page_size), self.d_model)
            specs[f"kv_k_{i}"] = (shape, dt)
            specs[f"kv_v_{i}"] = (shape, dt)
            if self.int8_kv:
                ss = (int(num_pages), int(page_size), 1)
                specs[f"kv_ks_{i}"] = (ss, torch.float32)
                specs[f"kv_vs_{i}"] = (ss, torch.float32)
        return specs

    def cache_feed_names(self):
        names = []
        for i in range(self.n_layer):
            names += [f"kv_k_{i}", f"kv_v_{i}"]
            if self.int8_kv:
                names += [f"kv_ks_{i}", f"kv_vs_{i}"]
        return names


def make_prompts(n, vocab_size, min_len=4, max_len=48, seed=0):
    """Ragged synthetic prompt stream for benches/tests."""
    rng = np.random.RandomState(seed)
    lens = rng.randint(min_len, max_len + 1, size=n)
    return [rng.randint(1, vocab_size, size=int(l)).astype(np.int64)
            for l in lens]
