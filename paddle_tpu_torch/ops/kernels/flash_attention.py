"""Flash attention: CUDA kernels + plain PyTorch versions, forward and
backward.

Replaces the TPU kernels of paddle_tpu/ops/pallas/flash_attention.py:
the forward `_flash_fwd` (kernel body `_fwd_kernel`; public entry
`pallas_flash_attention`), O = softmax(scale * Q K^T + key_bias
[+ causal mask with q/k offsets]) V and the per-row logsumexp, never
materialising the score matrix in device memory; and its custom-VJP
backward `_flash_bwd`, whose two kernels `_bwd_dkv_kernel` (dK, dV and
the key-bias gradient) and `_bwd_dq_kernel` (dQ) recompute the
probabilities from the saved logsumexp.  Both of the reference's
layouts: "nthd" (N, T, H*D) head-grouped and "nhtd" (N, H, T, D).  The
kernels take a key-padding bias broadcastable to (N, 1, 1, Tk), one row
per batch element, never repeated per head.

Kernels: csrc/flash_attention_fwd.cu (one block per (64-query tile,
batch*head), 4 warps of 16 queries, Q resident, K/V tiles streamed
through a double-buffered cp.async ring, the online softmax per row in
registers) and csrc/flash_attention_bwd.cu (dK/dV: one block per key
tile, 8 warps; dQ: one block per (64-query tile, batch*head), 4 warps of
16 queries), whose products all run on the tensor cores as 3xTF32
`mma.sync` (float32-accurate: every operand split into a TF32 big and
small part; the shared pieces are csrc/flash_mma.cuh).  Head dims 32, 64
and 128 (`_HEAD_DIMS`).  Every operand is read in place through its
batch, head and row strides, so a transposed view (the nhtd operands of
the Transformer come straight from a transpose(perm=[0, 2, 1, 3])) and
the cotangent autograd hands the backward are not copied; only a tensor
the kernels' 16-byte copies cannot read in place is: one whose last
dimension is not contiguous, or whose data pointer or batch/head/row
strides are not multiples of 4 floats (`_aligned_rows`).  What bounds
them on the card: the forward's bytes at the training shape and its
3xTF32 operations at long T (`tensor_core_bound_ms`), the backward's
operations (`tensor_core_bound_ms_bwd`); both count 3 TF32 operations
per product flop at the TF32 peak (PERF.md).

bf16 operands (q, k and v all bf16, as the AMP policy hands them to the
flash op) take the kernels' bf16 paths, counted as
`flash_attention_fwd_bf16`, `flash_attention_bwd_dkv_bf16` and
`flash_attention_bwd_dq_bf16`: the reference kernel's bf16 semantics —
float32 scores and softmax from exact bf16 products, P rounded to bf16
before P V, O stored bf16 and lse float32.  The backward's bf16 kernels
(`flash_bwd_dkv_bf16_kernel`, `flash_bwd_dq_bf16_kernel`) stage bf16
tiles and multiply on the bf16 tensor cores: s and dp in one pass of
exact bf16 products, p, delta and ds in float32, and p and ds split
into hi = bf16(x) and lo = bf16(x - hi) for two passes of dV, dK and dQ
(one rounding of p and ds misses the bf16 gradient gate,
tests/test_torch_flash_backward.py); float32 sums, bf16 gradients
rounded once.  A bias of either dtype is widened exactly to float32 for
the kernels.  Their bound counts 2-byte operands and the 989 TFLOP/s
bf16 peak.

Plain versions: `flash_attention_fwd_plain` and `flash_attention_bwd_plain`,
the same functions as dense torch compositions (the scores are
materialised, masked with the kernels' NEG_INF = -1e30, the forward's
normaliser clamped at 1e-30; the backward writes the gradient formulas
out without autograd).  They are the CPU path, where they also take any
broadcastable bias, and the card's reference for the kernels.

`FlashAttentionFn` is the autograd Function of the flash_attention op:
its forward is `flash_attention_fwd`, its backward `flash_attention_bwd`.
"""

from __future__ import annotations

import ctypes

import torch

from . import (BF16_FLOP_PER_S, HBM_BYTES_PER_S, TF32_FLOP_PER_S, bump,
               charge, launch_counts, plain_calls, register_kernel_cost,
               routed)
from . import _build

NEG_INF = -1e30
_NAME = "flash_attention_fwd"
_BWD_SOURCE = "flash_attention_bwd"
_DKV = "flash_attention_bwd_dkv"
_DQ = "flash_attention_bwd_dq"
_HEAD_DIMS = (32, 64, 128)
# the operand dtypes the kernels take, and the suffix of their counts
_KERNEL_DTYPES = {torch.float32: "", torch.bfloat16: "_bf16"}


# The kernels' flops in the reference's dense-equivalent convention
# (paddle_tpu/ops/pallas/flash_attention.py:60-121), over the flattened
# heads nh = N*H: every score of the t_q x t_k square counted (the dense
# composition computes the masked ones too), the backward's recompute of
# s and p not; the softmax's elementwise work at 8 flops a score each
# way, the backward's split 0.625 / 0.375 between dK/dV and dQ.
_SOFTMAX_FWD_PER_SCORE = 8.0
_SOFTMAX_BWD_PER_SCORE = 8.0


def flash_fwd_cost(nh, t_q, t_k, d):
    return nh * t_q * t_k * (4.0 * d + _SOFTMAX_FWD_PER_SCORE)


def flash_dkv_cost(nh, t_q, t_k, d):
    return nh * t_q * t_k * (6.0 * d + 0.625 * _SOFTMAX_BWD_PER_SCORE)


def flash_dq_cost(nh, t_q, t_k, d):
    return nh * t_q * t_k * (2.0 * d + 0.375 * _SOFTMAX_BWD_PER_SCORE)


def kernel_name(base, dtype):
    """The count name of kernel `base` on operands of `dtype`:
    "flash_attention_fwd" for float32, "flash_attention_fwd_bf16" for
    bf16."""
    return base + _KERNEL_DTYPES.get(dtype, "")


for _sfx in _KERNEL_DTYPES.values():
    register_kernel_cost(_NAME + _sfx, flash_fwd_cost)
    register_kernel_cost(_DKV + _sfx, flash_dkv_cost)
    register_kernel_cost(_DQ + _sfx, flash_dq_cost)


def dims(q, k, layout, n_head):
    """(n, h, t_q, t_k, d) of either layout."""
    if layout == "nthd":
        if not n_head:
            raise ValueError("flash_attention layout='nthd' needs n_head "
                             "(operands are (N, T, H*D))")
        n, t_q, hd = q.shape
        if hd % n_head:
            raise ValueError(f"nthd minor dim {hd} not divisible by "
                             f"n_head {n_head}")
        return n, int(n_head), t_q, k.shape[1], hd // n_head
    if layout == "nhtd":
        n, h, t_q, d = q.shape
        return n, h, t_q, k.shape[2], d
    raise ValueError(f"flash_attention: unknown layout {layout!r}")


def key_bias_ok(bias, n, t_k) -> bool:
    """True for a bias the kernels take: broadcastable to (N, 1, 1, Tk)
    (the reference's `_kernel_bias_ok`, paddle_tpu/ops/attention.py:151)."""
    target = (n, 1, 1, t_k)
    return bias.dim() <= 4 and all(
        bd == 1 or bd == td
        for bd, td in zip(reversed(bias.shape), reversed(target)))


def key_bias(bias, n, t_k):
    """A bias broadcastable to (N, 1, 1, Tk) as a contiguous (N, Tk) f32
    tensor, or None.  Any other bias (per-head, (Tq, Tk)) is not what the
    kernels take: the flash_attention op sends those to the composed
    route (ops/attention.py), as the reference sends them to its XLA
    composition."""
    if bias is None:
        return None
    if not key_bias_ok(bias, n, t_k):
        raise NotImplementedError(
            f"the flash-attention kernels take a key-padding bias "
            f"broadcastable to {(n, 1, 1, t_k)}; got {tuple(bias.shape)} "
            f"(the flash_attention op routes such biases to the composed "
            f"attention of ops/attention.py)")
    return bias.to(torch.float32).broadcast_to((n, 1, 1, t_k)) \
        .reshape(n, t_k).contiguous()


def _heads(x, layout, n, h, t, d):
    """x as an (N, H, T, D) view (nthd: a reshape + transpose, no copy)."""
    if layout == "nthd":
        return x.reshape(n, t, h, d).transpose(1, 2)
    return x


def _causal_mask(t_q, t_k, q_offset, k_offset, device):
    qp = torch.arange(t_q, device=device)[:, None] + q_offset
    kp = torch.arange(t_k, device=device)[None, :] + k_offset
    return qp >= kp


def flash_attention_fwd_plain(q, k, v, bias=None, scale=None, causal=False,
                              layout="nhtd", n_head=None, q_offset=0,
                              k_offset=0):
    """Plain PyTorch version of the forward kernel: returns (O, lse) with
    O in q's layout and dtype and lse (N*H, Tq) f32 (f64 for f64 q).
    bf16 operands follow the reference kernel's bf16 semantics: the
    scores, the softmax and O's sum in float32, P rounded to V's dtype
    before P V (`p.astype(vv.dtype)`), O rounded to q's dtype."""
    n, h, t_q, t_k, d = dims(q, k, layout, n_head)
    if scale is None:
        scale = d ** -0.5
    q4, k4, v4 = (_heads(x, layout, n, h, t, d)
                  for x, t in ((q, t_q), (k, t_k), (v, t_k)))
    acc = _acc_dtype(q)
    s = torch.matmul(q4.to(acc), k4.to(acc).transpose(-1, -2)) * scale
    if bias is not None:
        s = s + bias.to(acc)                # broadcast to (N, H, Tq, Tk)
    if causal:
        s = torch.where(_causal_mask(t_q, t_k, q_offset, k_offset,
                                     q.device),
                        s, torch.full((), NEG_INF, device=q.device))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    o = torch.matmul(p.to(v.dtype).to(acc), v4.to(acc)) / l   # (N,H,Tq,D)
    lse = (m + torch.log(l)).reshape(n * h, t_q)
    if layout == "nthd":
        o = o.transpose(1, 2).reshape(n, t_q, h * d)
    return o.to(q.dtype), lse


def _acc_dtype(x):
    """float32 for float32 and narrower operands (the kernels' type),
    float64 for float64 ones (gradcheck)."""
    return torch.promote_types(x.dtype, torch.float32)


def _check_devices(*tensors):
    ts = [t for t in tensors if t is not None]
    if len({t.device for t in ts}) != 1:
        raise ValueError("flash_attention: operands on different devices: "
                         f"{sorted({str(t.device) for t in ts})}")


@routed
def flash_attention_fwd(q, k, v, bias=None, scale=None, causal=False,
                        layout="nhtd", n_head=None, q_offset=0,
                        k_offset=0):
    """Flash-attention forward; routes by the operands' device (CUDA: the
    kernel; CPU: the plain version).  Returns (O, lse)."""
    n, h, t_q, t_k, d = dims(q, k, layout, n_head)
    if tuple(k.shape) != tuple(v.shape):
        raise ValueError(f"flash_attention: k {tuple(k.shape)} and v "
                         f"{tuple(v.shape)} differ")
    _check_devices(q, k, v, bias)
    if scale is None:
        scale = d ** -0.5
    kind = q.device.type
    if kind == "meta":
        return (torch.empty_like(q),
                torch.empty((n * h, t_q), dtype=torch.float32,
                            device=q.device))
    def cost():
        return bound_bytes_and_flops(q, k, bias, causal, layout, n_head,
                                     q_offset, k_offset)[0]

    if kind == "cpu":
        bump(plain_calls, kernel_name(_NAME, q.dtype))
        charge(kernel_name(_NAME, q.dtype), (n * h, t_q, t_k, d), cost)
        return flash_attention_fwd_plain(q, k, v, bias, scale, causal,
                                         layout, n_head, q_offset,
                                         k_offset)
    if kind != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    _check_kernel_operands(q, k, v, d)
    name = kernel_name(_NAME, q.dtype)
    q = _aligned_rows(q, layout, n, h, t_q, d)
    k, v = (_aligned_rows(x, layout, n, h, t_k, d) for x in (k, v))
    view = {name: _heads(x, layout, n, h, t, d) for name, x, t in
            (("q", q, t_q), ("k", k, t_k), ("v", v, t_k))}
    if view["k"].stride() != view["v"].stride():
        k, v = (_fresh(x) for x in (k, v))
        view["k"], view["v"] = (_heads(x, layout, n, h, t_k, d)
                                for x in (k, v))
    o = torch.empty_like(q)
    if _heads(o, layout, n, h, t_q, d).stride() != view["q"].stride():
        q = _fresh(q)
        o = torch.empty_like(q)
        view["q"] = _heads(q, layout, n, h, t_q, d)
    lse = torch.empty((n * h, t_q), dtype=torch.float32, device=q.device)
    rc = getattr(_bind_fwd(), name + "_launch")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        _ptr(key_bias(bias, n, t_k)), o.data_ptr(), lse.data_ptr(), n, h,
        d, t_q, t_k, *view["q"].stride()[:3], *view["k"].stride()[:3],
        float(scale), int(bool(causal)), int(q_offset), int(k_offset),
        q.device.index or 0, _stream(q))
    if rc != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {rc}")
    bump(launch_counts, name)
    charge(name, (n * h, t_q, t_k, d), cost)
    return o, lse


def flash_attention_bwd_plain(q, k, v, bias, o, lse, do, dlse=None,
                              scale=None, causal=False, layout="nhtd",
                              n_head=None, q_offset=0, k_offset=0):
    """Plain PyTorch version of the backward kernels, written out densely
    without autograd: returns (dq, dk, dv, dbias), dq/dk/dv in the
    operands' layout and dbias summed to the bias's shape (None without a
    bias)."""
    n, h, t_q, t_k, d = dims(q, k, layout, n_head)
    if scale is None:
        scale = d ** -0.5
    acc = _acc_dtype(q)
    q4, o4, do4 = (_heads(x, layout, n, h, t_q, d).to(acc)
                   for x in (q, o, do))
    k4, v4 = (_heads(x, layout, n, h, t_k, d).to(acc) for x in (k, v))
    s = torch.matmul(q4, k4.transpose(-1, -2)) * scale
    if bias is not None:
        s = s + bias.to(acc)
    p = torch.exp(s - lse.reshape(n, h, t_q, 1))
    if causal:
        p = torch.where(_causal_mask(t_q, t_k, q_offset, k_offset,
                                     q.device),
                        p, torch.zeros((), device=q.device))
    dv = torch.matmul(p.transpose(-1, -2), do4)
    dp = torch.matmul(do4, v4.transpose(-1, -2))
    delta = (do4 * o4).sum(dim=-1, keepdim=True)
    if dlse is not None:
        delta = delta - dlse.reshape(n, h, t_q, 1).to(acc)
    ds = p * (dp - delta)
    dq = torch.matmul(ds, k4) * scale
    dk = torch.matmul(ds.transpose(-1, -2), q4) * scale
    dbias = None if bias is None else _sum_to(ds, bias.shape).to(bias.dtype)

    def back(x, t, like):
        if layout == "nthd":
            x = x.transpose(1, 2).reshape(n, t, h * d)
        return x.to(like.dtype)

    return back(dq, t_q, q), back(dk, t_k, k), back(dv, t_k, v), dbias


def _sum_to(x, shape):
    """x summed over the dims that `shape` broadcasts (right-aligned)."""
    lead = x.dim() - len(shape)
    x = x.sum(dim=tuple(range(lead))) if lead else x
    axes = tuple(i for i, s in enumerate(shape) if s == 1 and x.shape[i] != 1)
    return x.sum(dim=axes, keepdim=True) if axes else x


@routed
def flash_attention_bwd(q, k, v, bias, o, lse, do, dlse=None, scale=None,
                        causal=False, layout="nhtd", n_head=None, q_offset=0,
                        k_offset=0, need_dbias=True):
    """Flash-attention backward; routes by the operands' device (CUDA: the
    dK/dV and dQ kernels; CPU: the plain version).  Returns (dq, dk, dv,
    dbias); dbias is None without a bias or when `need_dbias` is False."""
    n, h, t_q, t_k, d = dims(q, k, layout, n_head)
    _check_devices(q, k, v, bias, o, lse, do, dlse)
    if scale is None:
        scale = d ** -0.5
    kind = q.device.type
    logical = (n * h, t_q, t_k, d)

    def cost(which):
        return lambda: bound_bytes_and_flops_bwd(
            q, k, bias, causal, layout, n_head, dlse is not None,
            need_dbias and bias is not None, q_offset, k_offset)[which][0]

    if kind == "cpu":
        bump(plain_calls, kernel_name(_DKV, q.dtype))
        bump(plain_calls, kernel_name(_DQ, q.dtype))
        charge(kernel_name(_DKV, q.dtype), logical, cost("dkv"))
        charge(kernel_name(_DQ, q.dtype), logical, cost("dq"))
        dq, dk, dv, db = flash_attention_bwd_plain(
            q, k, v, bias, o, lse, do, dlse, scale, causal, layout, n_head,
            q_offset, k_offset)
        return dq, dk, dv, (db if need_dbias else None)
    if kind != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    _check_kernel_operands(q, k, v, d)
    if any(t.dtype != q.dtype for t in (o, do)):
        raise TypeError(f"flash_attention backward kernels: o and do must "
                        f"be {q.dtype} as q is, got {o.dtype}/{do.dtype}")
    dkv_name, dq_name = (kernel_name(x, q.dtype) for x in (_DKV, _DQ))
    q, o, do = (_aligned_rows(x, layout, n, h, t_q, d) for x in (q, o, do))
    k, v = (_aligned_rows(x, layout, n, h, t_k, d) for x in (k, v))
    lse = lse.to(torch.float32).contiguous()
    dlse = None if dlse is None else dlse.to(torch.float32).contiguous()
    kb = key_bias(bias, n, t_k)
    dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
    strides = (ctypes.c_int64 * 24)(*[
        s for x, t in ((q, t_q), (k, t_k), (v, t_k), (o, t_q), (do, t_q),
                       (dq, t_q), (dk, t_k), (dv, t_k))
        for s in _heads(x, layout, n, h, t, d).stride()[:3]])
    db = None
    if need_dbias and bias is not None:
        db = torch.empty((n * h, t_k), dtype=torch.float32,
                         device=q.device)
    lib = _bind_bwd()
    common = (n, h, d, t_q, t_k, strides, float(scale), int(bool(causal)),
              int(q_offset), int(k_offset), q.device.index or 0, _stream(q))
    ins = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
           do.data_ptr(), lse.data_ptr(), _ptr(dlse), _ptr(kb))
    rc = getattr(lib, dkv_name + "_launch")(
        *ins, dk.data_ptr(), dv.data_ptr(), _ptr(db), *common)
    if rc != 0:
        raise RuntimeError(f"flash_attention dK/dV kernel launch failed: "
                           f"CUDA error {rc}")
    bump(launch_counts, dkv_name)
    charge(dkv_name, logical, cost("dkv"))
    rc = getattr(lib, dq_name + "_launch")(*ins, dq.data_ptr(), *common)
    if rc != 0:
        raise RuntimeError(f"flash_attention dQ kernel launch failed: CUDA "
                           f"error {rc}")
    bump(launch_counts, dq_name)
    charge(dq_name, logical, cost("dq"))
    dbias = None
    if db is not None:
        dbias = _sum_to(db.reshape(n, h, 1, t_k), bias.shape) \
            .to(bias.dtype)
    return dq, dk, dv, dbias


class FlashAttentionFn(torch.autograd.Function):
    """Differentiable flash attention: (q, k, v, bias) -> (O, lse).

    Forward: `flash_attention_fwd`, saving q, k, v, bias, O (in q's
    dtype: the bf16 O the backward's delta reads on the bf16 path) and
    the float32 lse; the gradients come back in the operands' dtypes.
    Backward: `flash_attention_bwd` (the dK/dV and dQ kernels on CUDA),
    with the lse cotangent folded in when lse was used.  The bias gets a
    gradient only when it requires one."""

    @staticmethod
    def forward(ctx, q, k, v, bias, scale, causal, layout, n_head,
                q_offset, k_offset):
        o, lse = flash_attention_fwd(q, k, v, bias, scale, causal, layout,
                                     n_head, q_offset, k_offset)
        ctx.save_for_backward(q, k, v, bias, o, lse)
        ctx.cfg = (scale, causal, layout, n_head, q_offset, k_offset)
        ctx.set_materialize_grads(False)
        return o, lse

    @staticmethod
    def backward(ctx, do, dlse):
        q, k, v, bias, o, lse = ctx.saved_tensors
        if do is None:
            do = torch.zeros_like(o)
        dq, dk, dv, dbias = flash_attention_bwd(
            q, k, v, bias, o, lse, do, dlse, *ctx.cfg,
            need_dbias=ctx.needs_input_grad[3])
        return dq, dk, dv, dbias, None, None, None, None, None, None


def flash_attention(q, k, v, bias=None, scale=None, causal=False,
                    layout="nhtd", n_head=None, q_offset=0, k_offset=0):
    """(O, lse) through `FlashAttentionFn`, the scale resolved first."""
    d = dims(q, k, layout, n_head)[4]
    return FlashAttentionFn.apply(q, k, v, bias,
                                  d ** -0.5 if scale is None else scale,
                                  bool(causal), layout, n_head,
                                  int(q_offset), int(k_offset))


def kernel_takes(q, k, v, d) -> bool:
    """Do the kernels take these operands: q/k/v all float32 or all
    bf16, head dim in {32, 64, 128}?  The op's route on the card
    (ops/attention.py); `_check_kernel_operands` raises on the same
    limits."""
    return q.dtype in _KERNEL_DTYPES and k.dtype == q.dtype \
        and v.dtype == q.dtype and d in _HEAD_DIMS


def _check_kernel_operands(q, k, v, d):
    if q.dtype not in _KERNEL_DTYPES or not (k.dtype == v.dtype == q.dtype):
        raise TypeError(f"flash_attention kernel: q/k/v must be all "
                        f"float32 or all bf16, got {q.dtype}/{k.dtype}/"
                        f"{v.dtype}; use_pallas=False takes the composed "
                        f"route")
    if d not in _HEAD_DIMS:
        raise ValueError(f"flash_attention kernel: head dim {d} not in "
                         f"{_HEAD_DIMS} (ROADMAP B.2); use_pallas=False "
                         f"takes the composed route")


def _aligned_rows(x, layout, n, h, t, d):
    """x itself when the kernels' 16-byte copies read it in place (last
    dimension contiguous, data pointer and batch, head and row strides
    multiples of 16 bytes: 4 floats, 8 bf16 values), else a contiguous
    copy in fresh, aligned memory."""
    el = x.element_size()
    if x.stride(-1) == 1 and x.data_ptr() % 16 == 0 and all(
            s * el % 16 == 0
            for s in _heads(x, layout, n, h, t, d).stride()[:3]):
        return x
    return _fresh(x)


def _fresh(x):
    """A contiguous copy of x in fresh memory (`contiguous()` would return
    a contiguous tensor with a misaligned start as it is)."""
    return torch.empty_like(x, memory_format=torch.contiguous_format) \
        .copy_(x)


def _ptr(t):
    return None if t is None else t.data_ptr()


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _bind_fwd() -> ctypes.CDLL:
    lib = _build.load(_NAME)
    p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    for suffix in _KERNEL_DTYPES.values():
        fn = getattr(lib, f"{_NAME}{suffix}_launch")
        if fn.argtypes is None:
            fn.argtypes = ([p] * 6 + [i] * 5 + [i64] * 6
                           + [ctypes.c_float, i, i, i, i, p])
            fn.restype = i
    return lib


def _bind_bwd() -> ctypes.CDLL:
    lib = _build.load(_BWD_SOURCE)
    p, i = ctypes.c_void_p, ctypes.c_int
    tail = [i] * 5 + [ctypes.POINTER(ctypes.c_int64), ctypes.c_float,
                      i, i, i, i, p]
    for suffix in _KERNEL_DTYPES.values():
        for base, n_ptr in ((_DKV, 11), (_DQ, 9)):
            fn = getattr(lib, f"{base}{suffix}_launch")
            if fn.argtypes is None:
                fn.argtypes = [p] * n_ptr + tail
                fn.restype = i
    return lib


def _visible_pairs(t_q, t_k, causal, q_offset=0, k_offset=0):
    """(q, k) pairs the mask leaves visible in one (batch, head)."""
    if not causal:
        return t_q * t_k
    return sum(min(t_k, max(0, q_offset + i - k_offset + 1))
               for i in range(t_q))


def bound_bytes_and_flops(q, k, bias, causal, layout, n_head, q_offset=0,
                          k_offset=0):
    """(bytes, flops) the forward needs on these inputs: q, k, v, the
    bias rows and O, lse once; 4*D flops per (q, k) pair that the mask
    leaves visible (q.k and p.v) — data-dependent under causal."""
    n, h, t_q, t_k, d = dims(q, k, layout, n_head)
    el = q.element_size()
    nbytes = (2 * n * h * t_q * d * el + 2 * n * h * t_k * d * el
              + n * h * t_q * 4
              + (n * t_k * bias.element_size() if bias is not None else 0))
    pairs = _visible_pairs(t_q, t_k, causal, q_offset, k_offset)
    return nbytes, 4 * d * n * h * pairs


def _product_seconds_per_flop(q):
    """Tensor-core seconds for one product flop on q's dtype: float32
    operands as 3xTF32 (3 TF32 operations at 495 TFLOP/s), bf16 ones at
    the dense bf16 peak of 989 TFLOP/s."""
    if q.dtype == torch.bfloat16:
        return 1 / BF16_FLOP_PER_S
    return 3 / TF32_FLOP_PER_S


def tensor_core_bound_ms(q, k, bias, causal, layout, n_head, q_offset=0,
                         k_offset=0):
    """(ms, by): the forward kernel's least time on the H100, the larger
    of its bytes (`bound_bytes_and_flops`) at 3.35 TB/s and the 4*D
    product flops of each visible pair on the tensor cores — for float32
    operands as 3xTF32 work, 3 TF32 operations a flop at 495 TFLOP/s, for
    bf16 ones at 989 TFLOP/s; `by` names the larger, "bytes" or
    "operations".  The softmax's exp and rescaling run on the CUDA cores
    beside them and are left out."""
    nbytes, flops = bound_bytes_and_flops(q, k, bias, causal, layout,
                                          n_head, q_offset, k_offset)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops * _product_seconds_per_flop(q) * 1e3
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms \
        else (ops_ms, "operations")


def bound_bytes_and_flops_bwd(q, k, bias, causal, layout, n_head,
                              dlse=False, dbias=False, q_offset=0,
                              k_offset=0):
    """{"dkv": (bytes, flops), "dq": (bytes, flops)}: what each backward
    kernel's function needs on these inputs, each input read once and
    each output written once.  dK/dV reads q, k, v, O, dO, lse (+ dlse,
    the bias rows) and writes dK, dV (+ the per-head bias gradient); it
    does 8*D flops per visible pair (q.k, p*dO, dO.v, ds*q) plus 2*D per
    query row for delta.  dQ reads the same inputs and writes dQ, with
    6*D flops per visible pair (q.k, dO.v, ds*k) plus delta."""
    n, h, t_q, t_k, d = dims(q, k, layout, n_head)
    el = q.element_size()
    qrow, krow = n * h * t_q * d * el, n * h * t_k * d * el
    stats = n * h * t_q * 4 * (2 if dlse else 1)
    brow = n * t_k * bias.element_size() if bias is not None else 0
    ins = 3 * qrow + 2 * krow + stats + brow
    pairs = n * h * _visible_pairs(t_q, t_k, causal, q_offset, k_offset)
    delta = 2 * d * n * h * t_q
    return {"dkv": (ins + 2 * krow + (n * h * t_k * 4 if dbias else 0),
                    8 * d * pairs + delta),
            "dq": (ins + qrow, 6 * d * pairs + delta)}


def tensor_core_bound_ms_bwd(q, k, bias, causal, layout, n_head,
                             q_offset=0, k_offset=0):
    """{"dkv": (ms, by), "dq": (ms, by)}: each backward kernel's least
    time on the H100, the larger of its bytes (`bound_bytes_and_flops_bwd`)
    at 3.35 TB/s and the 8*D (dK/dV) or 6*D (dQ) product flops of each
    visible pair on the tensor cores (`_product_seconds_per_flop`: 3xTF32
    for float32 operands, the bf16 peak for bf16 ones); `by` names the
    larger, "bytes" or "operations".  delta's 2*D flops a row run on the
    CUDA cores beside them and are left out."""
    n, h, t_q, t_k, d = dims(q, k, layout, n_head)
    pairs = n * h * _visible_pairs(t_q, t_k, causal, q_offset, k_offset)
    b = bound_bytes_and_flops_bwd(q, k, bias, causal, layout, n_head,
                                  q_offset=q_offset, k_offset=k_offset)
    out = {}
    for name, per_pair in (("dkv", 8), ("dq", 6)):
        bytes_ms = b[name][0] / HBM_BYTES_PER_S * 1e3
        ops_ms = per_pair * d * pairs * _product_seconds_per_flop(q) * 1e3
        out[name] = ((bytes_ms, "bytes") if bytes_ms >= ops_ms
                     else (ops_ms, "operations"))
    return out
