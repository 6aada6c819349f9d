"""Flash-attention forward: CUDA kernel + plain PyTorch version.

Replaces the TPU kernel paddle_tpu/ops/pallas/flash_attention.py
`_flash_fwd` (kernel body `_fwd_kernel`; public entry
`pallas_flash_attention`): O = softmax(scale * Q K^T + key_bias
[+ causal mask with q/k offsets]) V and the per-row logsumexp, never
materialising the score matrix in device memory.  Both of the
reference's layouts: "nthd" (N, T, H*D) head-grouped and "nhtd"
(N, H, T, D).  The kernel takes a key-padding bias broadcastable to
(N, 1, 1, Tk), one row per batch element, never repeated per head.

Kernel: csrc/flash_attention_fwd.cu — one block per (64-row q tile,
batch*head), one thread per query row holding its q row and output
accumulator in registers, 64-row K/V tiles in shared memory, K tiles
above the causal diagonal skipped.  The nthd layout is read in place
through strides, so nothing is transposed or copied at the boundary.
What bounds it on the card: by the roofline, bytes — at the prefill
shape T=128 (N=16, H=8, D=64, f32) q/k/v/o are ~17 MB, ~5 us on an
H100, against ~0.27 GFLOP of visible pairs, ~4 us at the f32 peak.  The
kernel itself is held far above that by each thread's serial f32 FMA
loop on the CUDA cores (PERF.md); the tensor-core (wgmma) version is a
later PR's work.

Plain version: `flash_attention_fwd_plain`, the same function as a dense
torch composition (the scores are materialised, masked with the kernel's
NEG_INF = -1e30 and normalised with l clamped at 1e-30).  It is the CPU
path, where it also takes any broadcastable bias as the reference's XLA
composition does, and the card's reference for the kernel.  The backward kernels
(`_flash_bwd`) are not ported yet (ROADMAP queue B).
"""

from __future__ import annotations

import ctypes

import torch

from . import launch_counts, plain_calls
from . import _build

NEG_INF = -1e30
_NAME = "flash_attention_fwd"
_HEAD_DIMS = (32, 64)


def _dims(q, k, layout, n_head):
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


def key_bias(bias, n, t_k):
    """A bias broadcastable to (N, 1, 1, Tk) as a contiguous (N, Tk) f32
    tensor, or None.  Any other bias (per-head, (Tq, Tk)) is not what the
    kernel takes: the reference sends those to its XLA composition
    (paddle_tpu/ops/attention.py:163-172), which this port has not
    decided to keep on the card yet (ROADMAP queue A item 3)."""
    if bias is None:
        return None
    target = (n, 1, 1, t_k)
    if bias.dim() > 4 or any(bd != 1 and bd != td for bd, td in
                             zip(reversed(bias.shape), reversed(target))):
        raise NotImplementedError(
            f"flash_attention on CUDA takes a key-padding bias "
            f"broadcastable to {target}; got {tuple(bias.shape)} "
            f"(richer biases: ROADMAP queue A item 3)")
    return bias.to(torch.float32).broadcast_to(target).reshape(n, t_k) \
        .contiguous()


def flash_attention_fwd_plain(q, k, v, bias=None, scale=None, causal=False,
                              layout="nhtd", n_head=None, q_offset=0,
                              k_offset=0):
    """Plain PyTorch version of the kernel: returns (O, lse) with O in
    q's layout and dtype and lse (N*H, Tq) f32."""
    n, h, t_q, t_k, d = _dims(q, k, layout, n_head)
    if scale is None:
        scale = d ** -0.5
    if layout == "nthd":
        q4 = q.reshape(n, t_q, h, d).transpose(1, 2)
        k4 = k.reshape(n, t_k, h, d).transpose(1, 2)
        v4 = v.reshape(n, t_k, h, d).transpose(1, 2)
    else:
        q4, k4, v4 = q, k, v
    s = torch.matmul(q4.to(torch.float32),
                     k4.to(torch.float32).transpose(-1, -2)) * scale
    if bias is not None:
        s = s + bias.to(torch.float32)      # broadcast to (N, H, Tq, Tk)
    if causal:
        qp = torch.arange(t_q, device=q.device)[:, None] + q_offset
        kp = torch.arange(t_k, device=q.device)[None, :] + k_offset
        s = torch.where(qp >= kp, s, torch.full((), NEG_INF,
                                                device=q.device))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    o = torch.matmul(p, v4.to(torch.float32)) / l          # (N, H, Tq, D)
    lse = (m + torch.log(l)).reshape(n * h, t_q)
    if layout == "nthd":
        o = o.transpose(1, 2).reshape(n, t_q, h * d)
    return o.to(q.dtype), lse


def flash_attention_fwd(q, k, v, bias=None, scale=None, causal=False,
                        layout="nhtd", n_head=None, q_offset=0,
                        k_offset=0):
    """Flash-attention forward; routes by the operands' device (CUDA: the
    kernel; CPU: the plain version).  Returns (O, lse)."""
    n, h, t_q, t_k, d = _dims(q, k, layout, n_head)
    if tuple(k.shape) != tuple(v.shape):
        raise ValueError(f"flash_attention: k {tuple(k.shape)} and v "
                         f"{tuple(v.shape)} differ")
    tensors = [t for t in (q, k, v, bias) if t is not None]
    if len({t.device for t in tensors}) != 1:
        raise ValueError("flash_attention: operands on different devices: "
                         f"{sorted({str(t.device) for t in tensors})}")
    if scale is None:
        scale = d ** -0.5
    kind = q.device.type
    if kind == "meta":
        return (torch.empty_like(q),
                torch.empty((n * h, t_q), dtype=torch.float32,
                            device=q.device))
    if kind == "cpu":
        plain_calls[_NAME] += 1
        return flash_attention_fwd_plain(q, k, v, bias, scale, causal,
                                         layout, n_head, q_offset,
                                         k_offset)
    if kind != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    return _launch(q, k, v, key_bias(bias, n, t_k), float(scale),
                   bool(causal), layout, n, h, t_q, t_k, d,
                   int(q_offset), int(k_offset))


def _launch(q, k, v, bias, scale, causal, layout, n, h, t_q, t_k, d,
            q_off, k_off):
    if any(t.dtype != torch.float32 for t in (q, k, v)):
        raise TypeError(f"flash_attention kernel: q/k/v must be float32, "
                        f"got {q.dtype}/{k.dtype}/{v.dtype}")
    if d not in _HEAD_DIMS:
        raise ValueError(f"flash_attention kernel: head dim {d} not in "
                         f"{_HEAD_DIMS}")
    if not all(t.is_contiguous() for t in (q, k, v)):
        raise ValueError("flash_attention kernel: q/k/v must be "
                         "contiguous")
    if layout == "nthd":
        q_strides = (t_q * h * d, d, h * d)          # batch, head, row
        kv_strides = (t_k * h * d, d, h * d)
    else:
        q_strides = (h * t_q * d, t_q * d, d)
        kv_strides = (h * t_k * d, t_k * d, d)
    o = torch.empty_like(q)
    lse = torch.empty((n * h, t_q), dtype=torch.float32, device=q.device)
    lib = _bind()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = lib.flash_attention_fwd_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        None if bias is None else bias.data_ptr(), o.data_ptr(),
        lse.data_ptr(), n, h, d, t_q, t_k, *q_strides, *kv_strides, scale,
        int(causal), q_off, k_off, q.device.index or 0, stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {rc}")
    launch_counts[_NAME] += 1
    return o, lse


def _bind() -> ctypes.CDLL:
    lib = _build.load(_NAME)
    fn = lib.flash_attention_fwd_launch
    if fn.argtypes is None:
        p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        fn.argtypes = ([p] * 6 + [i] * 5 + [i64] * 6
                       + [ctypes.c_float, i, i, i, i, p])
        fn.restype = i
    return lib


def bound_bytes_and_flops(q, k, bias, causal, layout, n_head):
    """(bytes, flops) the forward needs on these inputs: q, k, v, the
    bias rows and O, lse once; 4*D flops per (q, k) pair that the mask
    leaves visible (q.k and p.v) — data-dependent under causal."""
    n, h, t_q, t_k, d = _dims(q, k, layout, n_head)
    el = q.element_size()
    nbytes = (2 * n * h * t_q * d * el + 2 * n * h * t_k * d * el
              + n * h * t_q * 4 + (n * t_k * 4 if bias is not None else 0))
    if causal:
        pairs = sum(min(t_k, i + 1) for i in range(t_q))
    else:
        pairs = t_q * t_k
    return nbytes, 4 * d * n * h * pairs
