"""Fused vocabulary projection + label-smoothed softmax cross-entropy:
CUDA kernels + plain PyTorch versions, forward and backward.

Replaces the TPU kernels of paddle_tpu/ops/pallas/vocab_ce.py: the
forward `_fwd` (kernel body `_fwd_kernel`) and the custom-VJP backward
`_bwd` (kernels `_bwd_dh_kernel` and `_bwd_dw_kernel`).  For tokens h
(N, D), the projection W (D, V) and labels (a label outside [0, V)
selects no logit), with z = h W:

    loss = lse - (1 - eps) * z_label - (eps / V) * z_sum
    dz   = g * (softmax(z) - (1 - eps) * onehot(label) - eps / V)
    dh   = dz W^T,   dW = h^T dz

The kernels (csrc/vocab_ce.cu) never write the (N, V) logits to device
memory: each recomputes its tiles of z and reduces them in registers.
They take float32 h and W with D <= 512; what bounds them on the card is
operations (PERF.md).  All three run on the tensor cores (mma.sync TF32,
split 3xTF32 so they stay float32-accurate).

Plain versions: `vocab_ce_fwd_plain` and `vocab_ce_bwd_plain`, the same
functions with the (N, V) logits materialised and the gradient formulas
written out without autograd.  They are the CPU path and the card's
reference for the kernels.

`VocabCEFn` is the autograd Function of the fused_vocab_softmax_ce op
(the port of `_fused_ce` / `_vjp_fwd` / `_vjp_bwd`); `fused_vocab_ce`
flattens leading dimensions and clamps the labels, as the reference's
Pallas entry does, or fills them, as its composition does;
`composed_vocab_ce` is that composition, the op's route on the card for
what the kernels do not take (`kernel_takes`).
"""

from __future__ import annotations

import ctypes

import torch

from ..common import fill_index, nan_where
from . import TF32_FLOP_PER_S, _build, launch_counts, plain_calls

# Hopper tiles of csrc/vocab_ce.cu: 64 tokens or vocabulary columns per
# block; z tiles 64 wide in the backward, 128 in the forward; D is held
# whole (at most 512)
DEFAULT_BLOCK_T = 64
DEFAULT_BLOCK_V = 64
MAX_D = 512
# dynamic shared memory of a block (float32): the forward's resident
# 64 x 512 tile, three 32 x 136 K-slice stages and 4 x 4 x 64 merge
# buffer; the backward's resident 64 x 512 tile, three 64 x 36
# (= 32 x 72) K-slice stages, the 64 x 68 dz tile split in two planes and
# 3 x 64 per-token stats
SMEM_BYTES = {"fwd": (64 * 512 + 3 * 32 * 136 + 4 * 4 * 64) * 4,
              "bwd": (64 * 512 + 3 * 64 * 36 + 2 * 64 * 68 + 3 * 64) * 4}
NEG = -1e30     # csrc/vocab_ce.cu kNeg, the reference's NEG
_SOURCE = "vocab_ce"
_FWD, _DH, _DW = "vocab_ce_fwd", "vocab_ce_dh", "vocab_ce_dw"


def vocab_ce_fwd_plain(h, w, labels):
    """Plain version of the forward kernel: (lse, z_label, z_sum), each
    (N,) float32, from h (N, D), w (D, V) and int labels (N,).  A label
    outside [0, V) selects no logit: its z_label is NEG, as in the
    kernel."""
    z = torch.matmul(h.to(torch.float32), w.to(torch.float32))
    lse = torch.logsumexp(z, dim=-1)
    lbl, none = _label_index(labels, w.shape[1])
    z_label = z.gather(1, lbl.reshape(-1, 1)).reshape(-1)
    z_label = torch.where(none, torch.full((), NEG, device=z.device),
                          z_label)
    return lse, z_label, z.sum(dim=-1)


def vocab_ce_bwd_plain(h, w, labels, lse, g, eps):
    """Plain version of the dh and dW kernels: (dh, dw) in float32.  A
    label outside [0, V) adds no one-hot term, as in the kernels."""
    hf, wf = h.to(torch.float32), w.to(torch.float32)
    z = torch.matmul(hf, wf)
    p = torch.exp(z - lse.reshape(-1, 1))
    lbl, none = _label_index(labels, w.shape[1])
    rows = torch.arange(z.shape[0], device=z.device)
    p[rows, lbl] -= torch.where(none, 0.0, 1.0 - eps)
    dz = (p - eps / w.shape[1]) * g.to(torch.float32).reshape(-1, 1)
    return torch.matmul(dz, wf.t()), torch.matmul(hf.t(), dz)


def _label_index(labels, v):
    """(labels clamped into [0, V) as int64, mask of those outside)."""
    lbl = labels.to(torch.int64)
    return lbl.clamp(0, v - 1), (lbl < 0) | (lbl >= v)


def composed_vocab_ce(hidden, weight, labels, epsilon=0.0):
    """The reference op's `use_pallas=False` route as torch ops, for what
    the kernels do not take (D > 512, a dtype other than float32): the
    (N, V) logits materialised in float32, loss = lse - (1-eps) z_label
    - (eps/V) sum z, a label wrapped and filled as `fill_index` says
    (NaN loss outside [-V, V)).  Differentiable through torch autograd."""
    v = weight.shape[1]
    z = torch.matmul(hidden, weight).to(torch.float32)
    lse = torch.logsumexp(z, dim=-1)
    idx, bad = fill_index(labels, v)
    zt = nan_where(bad, z.gather(-1, idx.unsqueeze(-1)).squeeze(-1))
    return lse - (1.0 - epsilon) * zt - (epsilon / v) * z.sum(dim=-1)


def kernel_takes(h, w) -> bool:
    """Do the kernels take h (..., D) and w (D, V): float32, D <= 512?
    The op's route on the card (ops/attention.py); `_check_kernel` raises
    on the same limits."""
    return (h.dtype == torch.float32 and w.dtype == torch.float32
            and h.shape[-1] <= MAX_D)


def _check(h, w, labels, *rest):
    if h.dim() != 2 or w.dim() != 2 or h.shape[1] != w.shape[0]:
        raise ValueError(f"vocab_ce: h {tuple(h.shape)} and w "
                         f"{tuple(w.shape)} are not (N, D) and (D, V)")
    if tuple(labels.shape) != (h.shape[0],):
        raise ValueError(f"vocab_ce: {h.shape[0]} tokens but labels of "
                         f"shape {tuple(labels.shape)}")
    for t in rest:
        if tuple(t.shape) != (h.shape[0],):
            raise ValueError(f"vocab_ce: per-token operand of shape "
                             f"{tuple(t.shape)}, want ({h.shape[0]},)")
    devices = {t.device for t in (h, w, labels, *rest)}
    if len(devices) != 1:
        raise ValueError(f"vocab_ce: operands on different devices: "
                         f"{sorted(str(d) for d in devices)}")
    return h.device.type


def _check_kernel(h, w, labels, *rest):
    """Raise for what the kernels do not take (no quiet fallback)."""
    if h.dtype == torch.bfloat16 or w.dtype == torch.bfloat16:
        raise NotImplementedError(
            "the vocab-CE kernels take float32 only; bf16 operands wait on "
            "bf16 kernels and the AMP policy: ROADMAP queue A item 2 and "
            "queue B (bf16 kernels, B.3); use_pallas=False takes the "
            "composed route")
    if any(t.dtype != torch.float32 for t in (h, w, *rest)):
        raise TypeError(f"vocab_ce kernels: float32 operands (ROADMAP "
                        f"B.3), got {[str(t.dtype) for t in (h, w, *rest)]}")
    if labels.dtype != torch.int32:
        raise TypeError(f"vocab_ce kernels: int32 labels, got "
                        f"{labels.dtype}")
    if h.shape[1] > MAX_D:
        raise ValueError(f"vocab_ce kernels: D = {h.shape[1]} > {MAX_D} "
                         f"(ROADMAP B.2; use_pallas=False takes the "
                         f"composed route)")
    if not all(t.is_contiguous() for t in (h, w, labels, *rest)):
        raise ValueError("vocab_ce kernels: operands must be contiguous")


def vocab_ce_fwd(h, w, labels):
    """Forward: (lse, z_label, z_sum).  Routes by device: CUDA launches
    the kernel, CPU runs the plain version, meta allocates the outputs."""
    kind = _check(h, w, labels)
    n = h.shape[0]
    if kind == "meta":
        return tuple(torch.empty(n, dtype=torch.float32, device=h.device)
                     for _ in range(3))
    if kind == "cpu":
        plain_calls[_FWD] += 1
        return vocab_ce_fwd_plain(h, w, labels)
    if kind != "cuda":
        raise ValueError(f"vocab_ce: unsupported device {h.device}")
    _check_kernel(h, w, labels)
    lse, z_label, z_sum = (torch.empty(n, dtype=torch.float32,
                                       device=h.device) for _ in range(3))
    rc = _bind().vocab_ce_fwd_launch(
        h.data_ptr(), w.data_ptr(), labels.data_ptr(), lse.data_ptr(),
        z_label.data_ptr(), z_sum.data_ptr(), n, h.shape[1], w.shape[1],
        h.device.index or 0, _stream(h))
    if rc != 0:
        raise RuntimeError(f"vocab_ce forward kernel launch failed: CUDA "
                           f"error {rc}")
    launch_counts[_FWD] += 1
    return lse, z_label, z_sum


def vocab_ce_bwd(h, w, labels, lse, g, eps):
    """Backward: (dh, dw).  Routes by device as `vocab_ce_fwd`; on CUDA
    the dh kernel, then the dW kernel."""
    kind = _check(h, w, labels, lse, g)
    if kind == "meta":
        return torch.empty_like(h), torch.empty_like(w)
    if kind == "cpu":
        plain_calls[_DH] += 1
        plain_calls[_DW] += 1
        return vocab_ce_bwd_plain(h, w, labels, lse, g, eps)
    if kind != "cuda":
        raise ValueError(f"vocab_ce: unsupported device {h.device}")
    _check_kernel(h, w, labels, lse, g)
    (n, d), v = h.shape, w.shape[1]
    dh = torch.empty_like(h)
    dw = torch.empty_like(w) if n else torch.zeros_like(w)
    lib = _bind()
    args = (h.data_ptr(), w.data_ptr(), labels.data_ptr(), lse.data_ptr(),
            g.data_ptr())
    tail = (n, d, v, float(eps), h.device.index or 0, _stream(h))
    rc = lib.vocab_ce_dh_launch(*args, dh.data_ptr(), *tail)
    if rc != 0:
        raise RuntimeError(f"vocab_ce dh kernel launch failed: CUDA error "
                           f"{rc}")
    launch_counts[_DH] += 1
    rc = lib.vocab_ce_dw_launch(*args, dw.data_ptr(), *tail)
    if rc != 0:
        raise RuntimeError(f"vocab_ce dW kernel launch failed: CUDA error "
                           f"{rc}")
    launch_counts[_DW] += 1
    return dh, dw


class VocabCEFn(torch.autograd.Function):
    """Differentiable fused projection + CE: (h, w, labels, eps) -> the
    per-token loss (N,).  Forward: `vocab_ce_fwd`, saving h, w, labels
    and lse.  Backward: `vocab_ce_bwd` (the dh and dW kernels on CUDA);
    labels get no gradient."""

    @staticmethod
    def forward(ctx, h, w, labels, eps):
        lse, z_label, z_sum = vocab_ce_fwd(h, w, labels)
        ctx.save_for_backward(h, w, labels, lse)
        ctx.eps = eps
        return lse - (1.0 - eps) * z_label - (eps / w.shape[1]) * z_sum

    @staticmethod
    def backward(ctx, g):
        h, w, labels, lse = ctx.saved_tensors
        dh, dw = vocab_ce_bwd(h, w, labels, lse, g.contiguous(), ctx.eps)
        return dh, dw, None, None


def fused_vocab_ce(hidden, weight, labels, epsilon=0.0, fill_labels=False):
    """Per-token label-smoothed CE of `hidden @ weight` without the
    logits: hidden (..., D), weight (D, V), labels with hidden's leading
    shape.  Returns the loss with hidden's leading shape.

    Labels as the reference's two routes take them: clamped into [0, V),
    as its Pallas entry `fused_vocab_ce` clamps them (the default); or,
    with `fill_labels`, as its composition's gather does (`fill_index`):
    -1 is V-1, and a label outside [-V, V) gives a NaN loss.  Such a
    row's gradients are those of the composition: its label selects no
    logit in the kernels."""
    lead = hidden.shape[:-1]
    h2 = hidden.reshape(-1, hidden.shape[-1])
    lbl = labels.reshape(-1)
    if lbl.shape[0] != h2.shape[0]:
        raise ValueError(f"fused_vocab_ce: {h2.shape[0]} tokens but "
                         f"{lbl.shape[0]} labels")
    v = weight.shape[1]
    if fill_labels:
        idx, bad = fill_index(lbl, v)
        lbl = torch.where(bad, -1, idx)
    else:
        lbl = lbl.clamp(0, v - 1)
    lbl = lbl.to(torch.int32).contiguous()
    loss = VocabCEFn.apply(h2, weight, lbl, float(epsilon))
    if fill_labels:
        # NaN where the label was out of range; a constant, so the row's
        # cotangent still reaches the kernels' backward
        loss = loss + nan_where(bad, torch.zeros_like(loss))
    return loss.reshape(lead)


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _bind() -> ctypes.CDLL:
    lib = _build.load(_SOURCE)
    p, i = ctypes.c_void_p, ctypes.c_int
    for fn, n_ptr, with_eps in ((lib.vocab_ce_fwd_launch, 6, False),
                                (lib.vocab_ce_dh_launch, 6, True),
                                (lib.vocab_ce_dw_launch, 6, True)):
        if fn.argtypes is None:
            fn.argtypes = ([p] * n_ptr + [i] * 3
                           + ([ctypes.c_float] if with_eps else [])
                           + [i, p])
            fn.restype = i
    return lib


def tensor_core_bound_ms(n, d, v):
    """{"fwd" | "dh" | "dw": ms}: the least time of each kernel's 3xTF32
    products on the tensor cores, 3 * 2*N*D*V (forward) or 3 * 4*N*D*V
    (each backward kernel) TF32 operations at the H100's 495 TFLOP/s (a
    bound that assumes the 3xTF32 split; the float32 bound of
    `bound_bytes_and_flops` assumes the CUDA cores)."""
    ms = 3 * 4 * n * d * v / TF32_FLOP_PER_S * 1e3
    return {"fwd": ms / 2, "dh": ms, "dw": ms}


def bound_bytes_and_flops(n, d, v, el=4):
    """{"fwd" | "dh" | "dw": (bytes, flops)} that each kernel's function
    needs: each input read once, each output written once; 2*N*D*V flops
    for the forward's z, 4*N*D*V for each backward kernel (its recompute
    of z and its product)."""
    h, w, tok = n * d * el, d * v * el, n * 4
    ndv = n * d * v
    return {"fwd": (h + w + tok + 3 * tok, 2 * ndv),
            "dh": (h + w + 3 * tok + h, 4 * ndv),
            "dw": (h + w + 3 * tok + w, 4 * ndv)}
