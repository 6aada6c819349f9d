"""Ragged paged attention for decode: CUDA kernel + plain PyTorch version.

Replaces the TPU kernel paddle_tpu/ops/pallas/paged_attention.py
`ragged_paged_attention` (kernel body `_paged_attn_kernel`): one query
token per slot, (S, H*D) head-grouped, attends over that slot's K/V
pages of the shared (P, page, H*D) pools, addressed through the
(S, max_pages) page table and masked to the slot's length; optional
int8 pools carry per-row f32 scales (P, page, 1).

Kernel: csrc/paged_attention.cu — flash-decoding: one block per (slot,
head, split), a split being a fixed run of `pages_per_split` of the
slot's pages; 16-byte loads with several tokens in flight a warp, the
online softmax in registers, each split's page-table entries read once.
With more than one split each split's (m, l, acc) goes to a workspace
(`torch.empty`, allocated here) that a second kernel merges in split
order.  The split size is a function of shapes only (`pages_per_split`:
max_pages, S x H and the SM count), never of the lengths, so a decode
step reads nothing back from the card to launch it.  What bounds it on
the card: memory (each K/V row below a slot's length is read once, 4
flops per element); rows past a length (NaN from an evicted slot) and
page-table entries past the used range are never touched.

Plain version: `paged_attention_plain`, the torch port of the
reference's dense-gather twin `_xla_paged_attention` — it gathers every
slot's pages, masks to the length (zeroing invalid V rows so 0 * NaN
never poisons the sum) and runs a dense softmax.  Same function, same
arguments; it is the CPU path and the card's reference.
`paged_attention_split_plain` is the same function blocked as the kernel
blocks it (each split's state, merged in split order), for the tests.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import launch_counts, plain_calls
from . import _build

NEG_INF = -1e30
_NAME = "paged_attention"
# the split size (csrc/paged_attention.cu): about this many blocks an SM,
# splits of at least this many tokens, at most this many pages a split
SPLIT_BLOCKS_PER_SM = 4
MIN_SPLIT_TOKENS = 64
MAX_SPLIT_PAGES = 1024
_KV_TYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_HEAD_DIMS = (32, 64, 128)


def _gather_pool(pool, page_table):
    """(P, page, C) gathered through (S, maxp) -> (S, maxp*page, C)."""
    g = pool[page_table.to(torch.int64)]          # (S, maxp, page, C)
    s, maxp, page, c = g.shape
    return g.reshape(s, maxp * page, c)


def _gathered(q, k_pages, v_pages, page_table, lengths, n_head, k_scales,
              v_scales):
    """q (S, H, D), every slot's K and V rows (S, T_cap, H, D), float32
    and dequantised, V zero at and past each length, and the (S, T_cap)
    mask of the rows below each length."""
    s, hd = q.shape
    d = hd // n_head
    k = _gather_pool(k_pages, page_table).to(torch.float32)
    v = _gather_pool(v_pages, page_table).to(torch.float32)
    if k_scales is not None:
        k = k * _gather_pool(k_scales, page_table).to(torch.float32)
    if v_scales is not None:
        v = v * _gather_pool(v_scales, page_table).to(torch.float32)
    t_cap = k.shape[1]
    valid = (torch.arange(t_cap, device=q.device)[None, :]
             < lengths.to(torch.int64)[:, None])            # (S, T_cap)
    # zero invalid v rows: 0 * NaN would poison the sum even at weight 0
    v = torch.where(valid[:, :, None], v, torch.zeros((), device=q.device))
    return (q.to(torch.float32).reshape(s, n_head, d),
            k.reshape(s, t_cap, n_head, d), v.reshape(s, t_cap, n_head, d),
            valid)


def paged_attention_plain(q, k_pages, v_pages, page_table, lengths, n_head,
                          scale=None, k_scales=None, v_scales=None):
    """Plain PyTorch paged attention (see module docstring)."""
    if scale is None:
        scale = (q.shape[1] // n_head) ** -0.5
    q4, k4, v4, valid = _gathered(q, k_pages, v_pages, page_table, lengths,
                                  n_head, k_scales, v_scales)
    logits = torch.einsum("shd,sthd->sht", q4, k4) * scale
    logits = torch.where(valid[:, None, :], logits,
                         torch.full((), NEG_INF, device=q.device))
    w = torch.softmax(logits, dim=-1)
    o = torch.einsum("sht,sthd->shd", w, v4)
    return o.reshape(q.shape).to(q.dtype)


def _split_state(q4, k, v, valid, scale):
    """One split's online-softmax state over its tokens: (m, l, acc) with
    m the max score (NEG_INF where the split holds no token), l the sum of
    exp(score - m) and acc that sum's weights times v."""
    neg = torch.full((), NEG_INF, device=q4.device)
    logits = torch.einsum("shd,sthd->sht", q4, k) * scale
    logits = torch.where(valid[:, None, :], logits, neg)
    m = logits.amax(dim=-1) if logits.shape[-1] else \
        neg.expand(logits.shape[:2])
    p = torch.where(valid[:, None, :], torch.exp(logits - m[..., None]),
                    torch.zeros((), device=q4.device))
    return m, p.sum(dim=-1), torch.einsum("sht,sthd->shd", p, v)


def paged_attention_split_plain(q, k_pages, v_pages, page_table, lengths,
                                n_head, scale=None, k_scales=None,
                                v_scales=None, *, pages_per_split):
    """`paged_attention_plain` blocked as the kernel blocks it: each run
    of `pages_per_split` pages of a slot gives its (m, l, acc), a split
    past the slot's length the empty state (NEG_INF, 0), and the splits
    are merged in split order — the max over the non-empty splits, then
    l and acc rescaled and summed, and acc / max(l, 1e-30)."""
    if scale is None:
        scale = (q.shape[1] // n_head) ** -0.5
    q4, k, v, valid = _gathered(q, k_pages, v_pages, page_table, lengths,
                                n_head, k_scales, v_scales)
    span = pages_per_split * k_pages.shape[1]
    states = [_split_state(q4, k[:, t0:t0 + span], v[:, t0:t0 + span],
                           valid[:, t0:t0 + span], scale)
              for t0 in range(0, max(k.shape[1], 1), max(span, 1))]
    zero = torch.zeros((), device=q.device)
    held = [l > 0 for _, l, _ in states]
    mm = torch.stack([torch.where(h, m, torch.full((), NEG_INF,
                                                   device=q.device))
                      for (m, _, _), h in zip(states, held)]).amax(dim=0)
    ll, o = torch.zeros_like(mm), torch.zeros_like(q4)
    for (m, l, acc), h in zip(states, held):
        f = torch.where(h, torch.exp(m - mm), zero)
        ll = ll + l * f
        o = o + torch.where(h[..., None], acc * f[..., None], zero)
    o = o / torch.clamp(ll, min=1e-30)[..., None]
    return o.reshape(q.shape).to(q.dtype)


def pages_per_split(max_pages, page, slots_heads, sms):
    """Pages of a slot one block of the kernel walks: enough splits that
    S x H x splits blocks give about SPLIT_BLOCKS_PER_SM blocks an SM,
    each split at least MIN_SPLIT_TOKENS tokens and at most
    MAX_SPLIT_PAGES pages, never more than max_pages.  A function of
    shapes and the card alone: the lengths never enter."""
    want = max(1, -(-SPLIT_BLOCKS_PER_SM * sms // max(slots_heads, 1)))
    pps = max(-(-max_pages // want), -(-MIN_SPLIT_TOKENS // max(page, 1)))
    return max(1, min(pps, max_pages, MAX_SPLIT_PAGES))


def launch_plan(q, k_pages, page_table, n_head, sms, plan_rows=None):
    """{"pages_per_split", "n_splits", "workspace_floats"} of a launch on
    these operands' shapes and a card of `sms` SMs.  The workspace holds
    each split's m, l and acc (D floats) when there is more than one
    split.  Shapes only, so a decode step's grid never waits on data.
    `plan_rows`: size the splits as for that many rows (a row's result
    depends on the split size; the speculative verify run takes the
    step run's plan), not q's."""
    s, hd = q.shape
    page, maxp = k_pages.shape[1], page_table.shape[1]
    pps = pages_per_split(maxp, page, (plan_rows or s) * n_head, sms)
    n_splits = max(1, -(-maxp // pps))
    ws = s * n_head * n_splits * (2 + hd // n_head) if n_splits > 1 else 0
    return {"pages_per_split": pps, "n_splits": n_splits,
            "workspace_floats": ws}


def _check(q, k_pages, v_pages, page_table, lengths, n_head, k_scales,
           v_scales):
    if q.dim() != 2 or k_pages.dim() != 3:
        raise ValueError(f"paged_attention: q must be (S, H*D) and the "
                         f"pools (P, page, H*D); got {tuple(q.shape)}, "
                         f"{tuple(k_pages.shape)}")
    s, hd = q.shape
    if tuple(v_pages.shape) != tuple(k_pages.shape) \
            or k_pages.shape[2] != hd:
        raise ValueError(f"paged_attention: pools {tuple(k_pages.shape)}/"
                         f"{tuple(v_pages.shape)} do not match q minor dim "
                         f"{hd}")
    if hd % n_head:
        raise ValueError(f"paged_attention: minor dim {hd} not divisible "
                         f"by n_head {n_head}")
    if page_table.dim() != 2 or page_table.shape[0] != s \
            or tuple(lengths.shape) != (s,):
        raise ValueError(f"paged_attention: page_table "
                         f"{tuple(page_table.shape)} / lengths "
                         f"{tuple(lengths.shape)} do not match {s} slots")
    if (k_pages.dtype == torch.int8) != (k_scales is not None) \
            or (k_scales is None) != (v_scales is None):
        raise ValueError("paged_attention: int8 pools need both scale "
                         "sidecars, and float pools must not carry them")
    tensors = [q, k_pages, v_pages, page_table, lengths]
    tensors += [t for t in (k_scales, v_scales) if t is not None]
    if len({t.device for t in tensors}) != 1:
        raise ValueError("paged_attention: operands on different devices: "
                         f"{sorted({str(t.device) for t in tensors})}")


def paged_attention(q, k_pages, v_pages, page_table, lengths, *, n_head,
                    scale=None, k_scales=None, v_scales=None,
                    plan_rows=None):
    """Decode-step attention over paged KV; routes by the operands'
    device (CUDA: the kernel; CPU: the plain version, whose rows do not
    depend on one another).  `plan_rows`: the kernel's split plan as for
    that many rows (`launch_plan`).  Returns (S, H*D) in q's dtype."""
    _check(q, k_pages, v_pages, page_table, lengths, n_head, k_scales,
           v_scales)
    if scale is None:
        scale = (q.shape[1] // n_head) ** -0.5
    kind = q.device.type
    if kind == "meta":
        return torch.empty_like(q)
    if kind == "cpu":
        plain_calls[_NAME] += 1
        return paged_attention_plain(q, k_pages, v_pages, page_table,
                                     lengths, n_head, scale, k_scales,
                                     v_scales)
    if kind != "cuda":
        raise ValueError(f"paged_attention: unsupported device {q.device}")
    return _launch(q, k_pages, v_pages, page_table, lengths, n_head,
                   float(scale), k_scales, v_scales, plan_rows)


def kernel_takes(q, k_pages, v_pages, n_head) -> bool:
    """Does the kernel take these operands: float32 q, float32, bf16 or
    int8 pools, head dim in {32, 64, 128}?  The paged_attention op's
    route on the card (ops/paged_kv.py); `_launch` raises on the same
    limits."""
    return (q.dtype == torch.float32 and k_pages.dtype in _KV_TYPES
            and v_pages.dtype == k_pages.dtype
            and q.shape[1] // n_head in _HEAD_DIMS)


def _launch(q, k_pages, v_pages, page_table, lengths, n_head, scale,
            k_scales, v_scales, plan_rows=None):
    s, hd = q.shape
    d = hd // n_head
    if q.dtype != torch.float32:
        raise TypeError(f"paged_attention kernel: q must be float32 "
                        f"(ROADMAP B.3), got {q.dtype}")
    if k_pages.dtype not in _KV_TYPES or v_pages.dtype != k_pages.dtype:
        raise TypeError(f"paged_attention kernel: pools must be one of "
                        f"{list(_KV_TYPES)}, got {k_pages.dtype}/"
                        f"{v_pages.dtype}")
    if d not in _HEAD_DIMS:
        raise ValueError(f"paged_attention kernel: head dim {d} not in "
                         f"{_HEAD_DIMS} (ROADMAP B.2); use_pallas=False "
                         f"takes the composed route")
    if page_table.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise TypeError("paged_attention kernel: page_table and lengths "
                        "must be int32")
    ops = [q, k_pages, v_pages, page_table, lengths]
    if k_scales is not None:
        if k_scales.dtype != torch.float32 \
                or tuple(k_scales.shape) != tuple(k_pages.shape[:2]) + (1,) \
                or tuple(v_scales.shape) != tuple(k_scales.shape) \
                or v_scales.dtype != torch.float32:
            raise ValueError("paged_attention kernel: scale sidecars must "
                             "be float32 (P, page, 1)")
        ops += [k_scales, v_scales]
    if not all(t.is_contiguous() for t in ops):
        raise ValueError("paged_attention kernel: operands must be "
                         "contiguous")
    # the kernel reads the pools 16 bytes at a time
    k_pages, v_pages = (t if t.data_ptr() % 16 == 0 else t.clone()
                        for t in (k_pages, v_pages))
    plan = launch_plan(q, k_pages, page_table, n_head,
                       _sm_count(q.device), plan_rows)
    out = torch.empty_like(q)
    ws = torch.empty(plan["workspace_floats"], dtype=torch.float32,
                     device=q.device) if plan["workspace_floats"] else None
    lib = _bind()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = lib.paged_attention_launch(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        None if k_scales is None else k_scales.data_ptr(),
        None if v_scales is None else v_scales.data_ptr(),
        page_table.data_ptr(), lengths.data_ptr(), out.data_ptr(),
        None if ws is None else ws.data_ptr(), s, n_head, d,
        k_pages.shape[1], page_table.shape[1], plan["pages_per_split"],
        scale, _KV_TYPES[k_pages.dtype], q.device.index or 0, stream)
    if rc != 0:
        raise RuntimeError(f"paged_attention kernel launch failed: CUDA "
                           f"error {rc}")
    launch_counts[_NAME] += 1
    return out


def _sm_count(device) -> int:
    return _sm_count_of(device.index or 0)


@functools.lru_cache(maxsize=None)
def _sm_count_of(index: int) -> int:
    """The card's SM count, asked once per device."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def _bind() -> ctypes.CDLL:
    lib = _build.load(_NAME)
    fn = lib.paged_attention_launch
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * 9 + [i] * 6 + [ctypes.c_float, i, i, p]
        fn.restype = i
    return lib


def bound_bytes_and_flops(q, k_pages, page_table, lengths, n_head,
                          scaled: bool = False):
    """(bytes, flops) the function needs on these inputs: q and out once,
    each K/V row below a length once (plus its scale for int8) — rows
    that share a page table (a slot's rows in the speculative verify
    run) read the longest of their lengths once between them — the page
    table and the lengths; 2 flops per element for q.k and 2 for p.v, for
    every row.  Data-dependent: counts the rows these lengths need."""
    s, hd = q.shape
    cap = page_table.shape[1] * k_pages.shape[1]
    lens = torch.clamp(lengths.to(torch.int64), 0, cap)
    _, table = torch.unique(page_table, dim=0, return_inverse=True)
    read = torch.zeros(s, dtype=torch.int64, device=lens.device)
    read = read.scatter_reduce(0, table.reshape(-1), lens, "amax")
    rows_read, rows = int(read.sum()), int(lens.sum())
    kv_el = k_pages.element_size()
    nbytes = (2 * s * hd * q.element_size()
              + 2 * rows_read * hd * kv_el
              + (2 * rows_read * 4 if scaled else 0)
              + page_table.numel() * 4 + s * 4)
    return nbytes, 4 * rows * hd
