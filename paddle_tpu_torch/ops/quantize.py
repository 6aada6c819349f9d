"""Fake-quantization operators (QAT simulation) and the int8 serving ops:
the port of paddle_tpu/ops/quantize.py (reference: paddle/fluid/
operators/fake_quantize_op.cc, fake_dequantize_op.cc; real int8
execution in the inference engines, quantize_mkldnn_op.cc and TensorRT's
int8 engine).

The simulation follows the reference term by term, since the bits depend
on it: the scale floored at 1e-8, codes round(x / s * qmax) (half to
even, as jnp.round) clipped to +-qmax, the dequantized value q * s /
qmax, and the straight-through gradient as x + (dq - x).detach() (not
dq: the two differ in the last bit).

`quantized_conv2d` and `quantized_matmul` multiply int8 codes by int8
weights with exact int32 accumulation, as the reference's XLA int8 conv
and dot do, through `torch._int_mm` (cuBLASLt's int8 GEMM on the card).
A convolution is an im2col of the activation codes (taken on a float32
copy of the codes, exact for |q| <= 127) and one int8 GEMM per group.
`_int_mm` wants more than 16 rows and K and N multiples of 8 on the
card: the operands are padded with zeros, which keeps every sum exact.
A shape `_int_mm` still refuses raises; nothing falls back to a float
product (float32 accumulation is not exact past 2^24, and K reaches
3 * 3 * 512).  Every division by a number divides by a 0-d tensor on
the operand's device: torch on CUDA divides by a host scalar as a
multiply by its reciprocal, which can move a code by one step or a
dequantized value by an ulp from the CPU's (and the reference's) bits.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..core.registry import register_op
from .common import first, out, pair
from .nn import _back, _conv_pads, _nchw


def _qmax(bits) -> float:
    return float(2 ** (int(bits) - 1) - 1)


def _scalar(value, x):
    """A Python number as a 0-d float32 tensor on x's device: a divisor
    torch divides by, where a host scalar would become a multiply by
    its reciprocal on CUDA."""
    return torch.full((), float(value), dtype=torch.float32,
                      device=x.device)


def _qdq(x, scale, bits):
    """x on the signed (2^(bits-1) - 1) grid at `scale`, dequantized,
    with the straight-through gradient."""
    qmax = _qmax(bits)
    s = scale.clamp(min=1e-8)
    q = torch.clamp(torch.round(x / s * qmax), -qmax, qmax)
    dq = q * s / _scalar(qmax, x)
    return x + (dq - x).detach()


def _abs_max(x):
    return x.detach().abs().amax()


@register_op("fake_quantize_abs_max")
def fake_quantize_abs_max(ctx, ins, attrs):
    """Out the codes on the dynamic abs-max grid, OutScale the scale used
    (reference FakeQuantizeAbsMaxOp)."""
    x = first(ins, "X")
    qmax = _qmax(attrs.get("bit_length", 8))
    s = _abs_max(x).clamp(min=1e-8)
    q = torch.clamp(torch.round(x / s * qmax), -qmax, qmax)
    return out(Out=q, OutScale=s.reshape((1,)))


@register_op("fake_dequantize_max_abs")
def fake_dequantize_max_abs(ctx, ins, attrs):
    """Out = X * Scale / max_range (reference FakeDequantizeMaxAbsOp)."""
    x = first(ins, "X")
    scale = first(ins, "Scale").reshape(())
    return out(Out=x * scale / _scalar(attrs.get("max_range", 127.0), x))


@register_op("fake_quantize_dequantize_abs_max")
def fake_quantize_dequantize_abs_max(ctx, ins, attrs):
    """One-shot QAT simulation on the dynamic per-tensor scale, with the
    straight-through gradient (the op QuantizeTranspiler inserts for
    weights)."""
    x = first(ins, "X")
    scale = _abs_max(x)
    return out(Out=_qdq(x, scale, attrs.get("bit_length", 8)),
               OutScale=scale.reshape((1,)))


@register_op("fake_quantize_dequantize_moving_average_abs_max")
def fake_qdq_moving_average(ctx, ins, attrs):
    """QAT simulation on a moving-average scale held in persistable state
    (reference FakeQuantizeMovingAverageAbsMaxOp): training sets scale =
    rate * scale + (1 - rate) * absmax, a zero state (the first step)
    adopting the batch's absmax; is_test reads the stored scale.  The
    transpiler writes OutScale into the InScale var, as batch_norm
    writes its moving statistics."""
    x = first(ins, "X")
    in_scale = first(ins, "InScale").reshape(())
    rate = float(attrs.get("moving_rate", 0.9))
    if attrs.get("is_test", False):
        scale = in_scale
    else:
        cur = _abs_max(x)
        scale = torch.where(in_scale > 0,
                            rate * in_scale + (1 - rate) * cur, cur)
    return out(Out=_qdq(x, scale, attrs.get("bit_length", 8)),
               OutScale=scale.reshape((1,)))


# ---------------------------------------------------------------------------
# Real int8 execution (serving): quantized conv / matmul
# ---------------------------------------------------------------------------

# torch._int_mm's shape rules on the card: rows > 16, K and N multiples
# of 8 (the operands are zero-padded to them, on every device alike)
MIN_ROWS = 17
ALIGN = 8


def _round_up(n, m):
    return -(-n // m) * m


def quantize_codes(x, scale, qmax):
    """The activation's int8 codes, as float32 values: round(x / s *
    qmax) clipped to +-qmax, s = max(scale, 1e-8), in the reference's
    order (`_quantize_in`)."""
    s = _scalar(max(float(scale), 1e-8), x)
    return torch.clamp(torch.round(x.to(torch.float32) / s * qmax),
                       -qmax, qmax)


def int8_matmul(a, w_rows):
    """Exact int32 product a @ w_rows.T of codes `a` (M, K; float32
    holding integers) and int8 `w_rows` (N, K), through torch._int_mm on
    operands zero-padded to its shape rules (the codes' int8 copy is
    the padded one)."""
    m, k = a.shape
    n = w_rows.shape[0]
    mp, kp, np_ = max(m, MIN_ROWS), _round_up(k, ALIGN), _round_up(n, ALIGN)
    ap = torch.empty((mp, kp), dtype=torch.int8, device=a.device)
    ap[:m, :k] = a
    ap[m:].zero_()
    ap[:m, k:].zero_()
    if (np_, kp) == (n, k):
        wp = w_rows.contiguous()
    else:
        wp = torch.zeros((np_, kp), dtype=torch.int8, device=a.device)
        wp[:n, :k] = w_rows
    acc = torch._int_mm(ap, wp.t())
    return acc[:m, :n]


def int8_conv2d_acc(codes, w, strides, pads, dilations, groups):
    """The int32 accumulators (N, O, OH, OW) of an NCHW convolution of
    activation codes `codes` (float32 holding integers) with the int8
    OIHW filter `w`: zero padding `pads` ((lo, hi) per spatial dim), an
    im2col and one int8 GEMM per group."""
    n, c, h, wd = codes.shape
    o, cg, kh, kw = w.shape
    (sh, sw), (dh, dw) = strides, dilations
    (pt, pb), (pl, pr) = pads
    oh = (h + pt + pb - dh * (kh - 1) - 1) // sh + 1
    ow = (wd + pl + pr - dw * (kw - 1) - 1) // sw + 1
    if (kh, kw) == (1, 1) and not any((pt, pb, pl, pr)):
        cols = codes[:, :, ::sh, ::sw].permute(0, 2, 3, 1).reshape(
            n * oh * ow, c)
    else:
        xp = F.pad(codes, (pl, pr, pt, pb))
        cols = F.unfold(xp, (kh, kw), dilation=(dh, dw), stride=(sh, sw))
        cols = cols.transpose(1, 2).reshape(n * oh * ow, c * kh * kw)
    og, kg = o // groups, cg * kh * kw
    w2 = w.reshape(o, kg)
    accs = [int8_matmul(cols[:, g * kg:(g + 1) * kg],
                        w2[g * og:(g + 1) * og]) for g in range(groups)]
    acc = accs[0] if groups == 1 else torch.cat(accs, dim=1)
    return acc.reshape(n, oh, ow, o).permute(0, 3, 1, 2)


def conv_accumulators(x, w, attrs):
    """(codes, int32 accumulators) of `quantized_conv2d` on x and its
    attrs, both NCHW."""
    qmax = _qmax(attrs.get("bit_length", 8))
    fmt = attrs.get("data_format", "NCHW")
    if fmt not in ("NCHW", "NHWC"):
        raise ValueError(f"quantized_conv2d data_format must be NCHW or "
                         f"NHWC, got {fmt!r}")
    codes = _nchw(quantize_codes(x, attrs["in_scale"], qmax), fmt == "NHWC")
    strides = pair(attrs.get("strides", 1))
    dilations = pair(attrs.get("dilations", 1))
    pads = _conv_pads(attrs.get("paddings", 0), tuple(codes.shape[2:]),
                      tuple(w.shape[2:]), strides, dilations)
    acc = int8_conv2d_acc(codes, w.to(torch.int8), strides, pads, dilations,
                          attrs.get("groups", 1) or 1)
    return codes, acc


@register_op("quantized_conv2d")
def quantized_conv2d(ctx, ins, attrs):
    """int8 convolution: the activation quantized on the trained fixed
    scale `in_scale`, the int8 filter from convert_to_int8, int32
    accumulation, and the float output acc * (in_scale * weight_scale /
    qmax^2)."""
    x = first(ins, "Input")
    qmax = _qmax(attrs.get("bit_length", 8))
    _, acc = conv_accumulators(x, first(ins, "Filter"), attrs)
    o = acc.to(torch.float32) * (float(attrs["in_scale"])
                                 * float(attrs["weight_scale"])
                                 / (qmax * qmax))
    nhwc = attrs.get("data_format", "NCHW") == "NHWC"
    return {"Output": [_back(o, nhwc).contiguous().to(x.dtype)]}


@register_op("quantized_matmul")
def quantized_matmul(ctx, ins, attrs):
    """int8 matmul of a float activation X and an int8 weight Y, with the
    mul op's x_num_col_dims/y_num_col_dims flattening (operators/
    mul_op.cc), so it drops in where a fc's mul was."""
    x, y = first(ins, "X"), first(ins, "Y")
    qmax = _qmax(attrs.get("bit_length", 8))
    xnc = attrs.get("x_num_col_dims", 1)
    ync = attrs.get("y_num_col_dims", 1)
    xs, ys = tuple(x.shape), tuple(y.shape)
    xq = quantize_codes(x, attrs["in_scale"], qmax).reshape(
        int(np.prod(xs[:xnc])), int(np.prod(xs[xnc:])))
    y2 = y.to(torch.int8).reshape(int(np.prod(ys[:ync])),
                                  int(np.prod(ys[ync:])))
    acc = int8_matmul(xq, y2.t())
    o = acc.to(torch.float32) * (float(attrs["in_scale"])
                                 * float(attrs["weight_scale"])
                                 / (qmax * qmax))
    return out(Out=o.reshape(xs[:xnc] + ys[ync:]).to(x.dtype))
