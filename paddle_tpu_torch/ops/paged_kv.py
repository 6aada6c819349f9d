"""Paged KV-cache ops: the port of the decode-step half of
paddle_tpu/ops/paged_kv.py.

- `paged_kv_write`: commit ONE token's K/V per slot at its current
  length (the decode-step write).
- `paged_kv_prefill_write`: commit a whole prompt's K/V (the
  prefill-on-join write), positions 0..seq_len-1 per slot.
- `paged_attention`: one query token per slot attends over its pages,
  masked to its true length — the hand-written Hopper kernel on a CUDA
  tensor, its plain PyTorch version on a CPU one
  (ops/kernels/paged_attention.py).
- `add_position_encoding_at`: the sinusoid at one position per row.
- `speculative_accept`: greedy longest-accepted-prefix acceptance of a
  speculative verify run (plain torch integer ops, as the reference
  computes it in jnp outside any kernel).

Layouts are the reference's head-major ones: K/V rows (S, H*D) and pools
(P, page, H*D), so a page write is a plain row scatter.  Optional int8
pools carry one f32 scale per row in (P, page, 1) sidecars; the writes
quantize (symmetric, absmax/127).

Two differences from the reference, both in how, not what:

- The pools are updated IN PLACE and the same tensors are returned as
  the outputs.  The JAX engine got the same effect from buffer donation;
  the port's engine never reads a pool's old contents after a write.
- The reference drops writes with `.at[...].set(mode="drop")` on an
  out-of-bounds index.  Torch has no drop mode, so the rows to drop
  (inactive slots, positions past seq_len, logical pages past the table)
  are masked out explicitly before the scatter.

The disagg import (`paged_kv_import`) is not ported yet (ROADMAP
queue A item 7, A step 9).
"""

from __future__ import annotations

import torch

from ..core.registry import register_op
from .common import first, opt_in, out
from . import kernels
from .kernels import composed_calls
from .kernels import paged_attention as pk
from .sequence import sinusoid

_INT8_MAX = 127.0


def _quantize_rows(x):
    """Per-row symmetric int8: x (..., HD) -> (codes int8, scale f32
    (..., 1)); zero rows quantize to scale 1 (all-zero codes)."""
    xf = x.to(torch.float32)
    absmax = xf.abs().amax(dim=-1, keepdim=True)
    scale = torch.where(absmax > 0, absmax / _INT8_MAX,
                        torch.ones((), dtype=torch.float32,
                                   device=x.device))
    codes = torch.clamp(torch.round(xf / scale), -_INT8_MAX, _INT8_MAX)
    return codes.to(torch.int8), scale


def _write(ins, k, v, phys, off, keep):
    """Scatter rows k/v (R, HD) into the pools at [phys, off] for the
    rows where `keep` holds, in place; returns the op's outputs."""
    kc, vc = first(ins, "KCache"), first(ins, "VCache")
    ks, vs = opt_in(ins, "KScale"), opt_in(ins, "VScale")
    int8 = kc.dtype == torch.int8
    if int8 and (ks is None or vs is None):
        raise ValueError("int8 KV cache needs KScale/VScale sidecar pools")
    if kc.device.type != "meta":
        # the rows to drop never reach the scatter (the reference's
        # mode="drop"); one nonzero (a device sync) selects the kept rows
        idx = torch.nonzero(keep).squeeze(1)
        phys, off, k, v = (t.index_select(0, idx) for t in (phys, off, k, v))
        if int8:
            k, k_sc = _quantize_rows(k)
            v, v_sc = _quantize_rows(v)
            ks[phys, off] = k_sc
            vs[phys, off] = v_sc
        kc[phys, off] = k.to(kc.dtype)
        vc[phys, off] = v.to(vc.dtype)
    res = out(KCacheOut=kc, VCacheOut=vc)
    if int8:
        res.update(out(KScaleOut=ks, VScaleOut=vs))
    return res


@register_op("paged_kv_write")
def paged_kv_write(ctx, ins, attrs):
    """One decode step's K/V commit.

    K/V (S, HD); KCache/VCache (P, page, HD); PageTable (S, max_pages)
    int32; WritePos (S,) int32 (the position being committed = current
    length); optional Active (S,) — 0/false rows write nothing.  With
    int8 caches, KScale/VScale (P, page, 1) f32 sidecars are required
    inputs and updated alongside.
    Outputs: KCacheOut/VCacheOut (+KScaleOut/VScaleOut for int8)."""
    k, v = first(ins, "K"), first(ins, "V")
    pt = first(ins, "PageTable").to(torch.int64)
    wp = first(ins, "WritePos").to(torch.int64)
    active = opt_in(ins, "Active")
    page = first(ins, "KCache").shape[1]
    page_idx = wp // page
    off = wp % page
    phys = torch.gather(
        pt, 1, torch.clamp(page_idx, 0, pt.shape[1] - 1)[:, None])[:, 0]
    keep = page_idx < pt.shape[1]
    if active is not None:
        keep = keep & (active.to(torch.int32) != 0)
    return _write(ins, k, v, phys, off, keep)


@register_op("paged_kv_prefill_write")
def paged_kv_prefill_write(ctx, ins, attrs):
    """A whole prompt's K/V commit (prefill-on-join).

    K/V (S, T, HD); caches/table as in paged_kv_write; SeqLen (S,)
    int32 — positions t >= SeqLen[s] (padding, and every position of a
    non-joining slot, whose SeqLen is 0) are dropped."""
    k, v = first(ins, "K"), first(ins, "V")
    pt = first(ins, "PageTable").to(torch.int64)
    seq_len = first(ins, "SeqLen").to(torch.int64)
    page = first(ins, "KCache").shape[1]
    s, t, hd = k.shape
    pos = torch.arange(t, device=k.device)[None, :]            # (1, T)
    page_idx = (pos // page).expand(s, t)
    off = (pos % page).expand(s, t)
    phys = torch.gather(pt, 1, torch.clamp(page_idx, 0, pt.shape[1] - 1))
    keep = (pos < seq_len[:, None]) & (page_idx < pt.shape[1])
    return _write(ins, k.reshape(s * t, hd), v.reshape(s * t, hd),
                  phys.reshape(-1), off.reshape(-1), keep.reshape(-1))


@register_op("paged_attention")
def paged_attention(ctx, ins, attrs):
    """Decode-step ragged paged attention (see module docstring).

    Q (S, H*D) head-grouped; KCache/VCache (P, page, H*D); PageTable
    (S, max_pages) int32; Lengths (S,) int32; KScale/VScale for int8
    pools.  attrs: n_head (required), scale (default d^-0.5).  On the
    card, with use_pallas false, operands the kernel does not take (a
    head dim outside {32, 64, 128}: `pk.kernel_takes`) go to the port of
    the reference's dense-gather composition (`pk.paged_attention_plain`),
    counted in `kernels.composed_calls`; with use_pallas true they reach
    the kernel, which raises.  Otherwise use_pallas does not route.  The
    run's `row_block` (OpContext) sets the kernel's split plan."""
    q = first(ins, "Q")
    n_head = int(attrs.get("n_head") or 0)
    if not n_head:
        raise ValueError("paged_attention needs the n_head attr "
                         "(operands are head-grouped (S, H*D))")
    kc, vc = first(ins, "KCache"), first(ins, "VCache")
    args = (q, kc, vc, first(ins, "PageTable").to(torch.int32),
            first(ins, "Lengths").to(torch.int32))
    scales = dict(k_scales=opt_in(ins, "KScale"),
                  v_scales=opt_in(ins, "VScale"))
    if not attrs.get("use_pallas") and kernels.on_card(q) \
            and not pk.kernel_takes(q, kc, vc, n_head):
        composed_calls["paged_attention"] += 1
        return out(Out=pk.paged_attention_plain(
            *args, n_head, attrs.get("scale"), **scales))
    return out(Out=pk.paged_attention(*args, n_head=n_head,
                                      scale=attrs.get("scale"),
                                      plan_rows=ctx.row_block, **scales))


@register_op("speculative_accept")
def speculative_accept(ctx, ins, attrs):
    """Greedy longest-accepted-prefix acceptance for speculative decode.

    The verify program scores k drafted tokens per slot in one run (the
    step body at folded batch S*(k+1), staggered lengths); its argmax
    Predictions (S, k+1) are what the sequential engine would have
    produced at positions L..L+k given the drafted prefix.  A draft is
    accepted iff every earlier draft matched:

      match_i   = (Drafts[:, i-1] == Predictions[:, i-1]) & (i <= DraftLen)
      Accepted  = sum(cumprod(match))          # in 0..k, -1 if inactive
      Tokens[j] = Predictions[j] if j <= Accepted else -1

    Inputs: Drafts (S, k) int, Predictions (S, k+1) int, DraftLen (S,)
    int, optional Active (S,).  Outputs: Accepted (S,) int32, Tokens
    (S, k+1) int32 (-1 padding)."""
    drafts = first(ins, "Drafts").to(torch.int32)
    preds = first(ins, "Predictions").to(torch.int32)
    dlen = first(ins, "DraftLen").to(torch.int32)
    active = opt_in(ins, "Active")
    if preds.dim() != 2 or drafts.dim() != 2:
        raise ValueError("speculative_accept: Drafts (S, k) and "
                         "Predictions (S, k+1) must be rank-2")
    s, k1 = preds.shape
    k = k1 - 1
    if tuple(drafts.shape) != (s, k):
        raise ValueError(
            f"speculative_accept: Drafts {tuple(drafts.shape)} must be "
            f"(S, k) = ({s}, {k}) for Predictions {tuple(preds.shape)}")
    idx = torch.arange(1, k + 1, dtype=torch.int32,
                       device=preds.device)[None, :]           # (1, k)
    match = (drafts == preds[:, :k]) & (idx <= dlen[:, None])
    accepted = torch.cumprod(match.to(torch.int32), dim=1).sum(
        dim=1).to(torch.int32)                                  # (S,)
    if active is not None:
        accepted = torch.where(active.to(torch.int32) != 0, accepted,
                               torch.full_like(accepted, -1))
    pos = torch.arange(k1, dtype=torch.int32, device=preds.device)[None, :]
    tokens = torch.where(pos <= accepted[:, None], preds,
                         torch.full_like(preds, -1))
    return out(Accepted=accepted, Tokens=tokens)


@register_op("add_position_encoding_at")
def add_position_encoding_at(ctx, ins, attrs):
    """X (S, D) + sinusoid(Position[s]) — the single-token decode twin
    of add_position_encoding (same formula, per-row position instead of
    0..T-1)."""
    x = first(ins, "X")
    alpha = attrs.get("alpha", 1.0)
    beta = attrs.get("beta", 1.0)
    pe = sinusoid(first(ins, "Position"), x.shape[-1])
    return out(Out=(alpha * x + beta * pe).to(x.dtype))
