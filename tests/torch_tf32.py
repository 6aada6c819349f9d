"""Emulation, in numpy, of the products the port's tensor-core kernels
compute: mma.sync with TF32 operands, one pass or split 3xTF32
(csrc/vocab_ce.cu's dh/dW and csrc/flash_attention_bwd.cu).  The tests
use it to show why the kernels split every operand: one TF32 pass misses
chip_smoke.py's float32 tolerances, 3xTF32 meets them."""

from __future__ import annotations

import numpy as np


def tf32(x):
    """float32 rounded to TF32's 10 mantissa bits, to nearest with ties
    away from zero (cvt.rna.tf32.f32), with integer ops on the bits."""
    b = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return ((b + np.uint32(0x1000)) & np.uint32(0xffffe000)) \
        .view(np.float32)


def tf32_truncated(x):
    """What the tensor core reads of an unrounded float32 operand."""
    b = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return (b & np.uint32(0xffffe000)).view(np.float32)


def tc_matmul(a, b, passes):
    """a @ b as the kernels' mma.sync products: 1 pass of TF32 operands,
    or 3xTF32 (a_small b_big + a_big b_small + a_big b_big).  The
    products of TF32 values are exact in float64; the sums are taken in
    float64 and rounded once, so only the operands' rounding is shown."""
    f = np.float64
    ab, bb = tf32(a), tf32(b)
    if passes == 1:
        return (ab.astype(f) @ bb.astype(f)).astype(np.float32)
    a_s, b_s = tf32_truncated(a - ab), tf32_truncated(b - bb)
    return (a_s.astype(f) @ bb.astype(f) + ab.astype(f) @ b_s.astype(f)
            + ab.astype(f) @ bb.astype(f)).astype(np.float32)


def tc_matmul_tiled(a, b, passes, depth=64):
    """a @ b with the contraction cut into `depth`-deep tiles: each tile's
    product is `tc_matmul` (one tensor-core accumulator), and the partial
    sums are added in float32, as the kernels add them to registers."""
    out = np.zeros((a.shape[0], b.shape[1]), np.float32)
    for k0 in range(0, a.shape[1], depth):
        out += tc_matmul(a[:, k0:k0 + depth], b[k0:k0 + depth], passes)
    return out
