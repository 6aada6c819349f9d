"""Flash-attention forward: the PyTorch port's plain version against the
JAX package's XLA compositions (`_xla_attention_nthd`, `_xla_attention`)
and its Pallas kernel (`pallas_flash_attention`, interpret mode on the
CPU), on the same numpy inputs.

Cases: both layouts (head-grouped "nthd" and "nhtd"), causal or not, a
key-padding bias (N, 1, 1, Tk), and T not a multiple of the Pallas
block.  The XLA twin masks causal keys with -1e9 where the kernels use
-1e30, so rows whose every key is masked (a prefill row of a slot that
is not joining) are compared with the Pallas kernel only, which shares
the kernels' constants.

Tolerance 2e-5 (abs and rel): float32 throughout, summation order
differs.  bf16 operands: the plain version's bf16 semantics against the
Pallas kernel on bf16 operands (tolerances in
`test_bf16_plain_matches_pallas`).

Also: the forward kernel's error budget (csrc/flash_attention_fwd.cu
emulated with tests/torch_tf32.py: one TF32 pass misses chip_smoke.py's
TOL_KERNEL, 3xTF32 meets it) and its bounds.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.ops.attention import _xla_attention, _xla_attention_nthd
from paddle_tpu.ops.pallas.flash_attention import pallas_flash_attention
from paddle_tpu_torch.ops.kernels import flash_attention as tk

from op_test import run_op
from torch_op_test import run_torch_op, to_torch
from torch_tf32 import tc_matmul

torch.set_num_threads(2)

TOL = dict(rtol=2e-5, atol=2e-5)


def _qkv(seed, n, t, h, d, layout):
    rng = np.random.RandomState(seed)
    shape = (n, t, h * d) if layout == "nthd" else (n, h, t, d)
    return [rng.randn(*shape).astype(np.float32) for _ in range(3)]


def _key_bias(seq_lens, t):
    """The decoder's prefill bias: 0 on valid keys, -1e9 on padding."""
    m = (np.arange(t)[None, :] < np.asarray(seq_lens)[:, None])
    return ((m.astype(np.float32) * 1e9 - 1e9)
            .reshape(len(seq_lens), 1, 1, t))


def _plain(q, k, v, bias, causal, layout, h):
    o, lse = tk.flash_attention_fwd_plain(
        to_torch(q), to_torch(k), to_torch(v),
        None if bias is None else to_torch(bias), None, causal,
        layout=layout, n_head=h)
    return o.numpy(), lse.numpy()


@pytest.mark.parametrize("layout", ["nthd", "nhtd"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("with_bias", [True, False])
@pytest.mark.parametrize("d", [16, 128])
def test_plain_matches_xla_twin(layout, causal, with_bias, d):
    n, t, h = 3, 40, 2
    q, k, v = _qkv(0, n, t, h, d, layout)
    bias = _key_bias([40, 17, 1], t) if with_bias else None
    jb = None if bias is None else jnp.asarray(bias)
    if layout == "nthd":
        want = _xla_attention_nthd(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), jb, d ** -0.5, causal,
                                   h)
    else:
        want = _xla_attention(jnp.asarray(q), jnp.asarray(k),
                              jnp.asarray(v), jb, d ** -0.5, causal)
    got, _ = _plain(q, k, v, bias, causal, layout, h)
    np.testing.assert_allclose(got, np.asarray(want), **TOL)


@pytest.mark.parametrize("layout", ["nthd", "nhtd"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [16, 128])
def test_plain_matches_pallas_including_lse(layout, causal, d):
    """T=40 against 16-row Pallas blocks (a ragged last block); one batch
    row has seq_len 0, so every key of it carries the -1e9 bias."""
    n, t, h = 3, 40, 2
    q, k, v = _qkv(1, n, t, h, d, layout)
    bias = _key_bias([40, 0, 23], t)
    o, lse = pallas_flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(bias),
        None, causal, block_q=16, block_k=16, return_lse=True,
        layout=layout, n_head=h)
    got, got_lse = _plain(q, k, v, bias, causal, layout, h)
    assert np.isfinite(got).all() and np.isfinite(got_lse).all()
    np.testing.assert_allclose(got, np.asarray(o), **TOL)
    lse = np.asarray(lse)
    if layout == "nthd":                      # (N, T, H) -> (N*H, T)
        lse = np.moveaxis(lse, 2, 1)
    np.testing.assert_allclose(got_lse, lse.reshape(n * h, t),
                               rtol=1e-5, atol=1e-3)


def _bf16(*arrays):
    """float32 numpy arrays rounded to bf16, as (jax bf16, torch bf16)
    pairs holding the same values."""
    js = [jnp.asarray(a, jnp.bfloat16) for a in arrays]
    return [(j, torch.from_numpy(np.array(j.astype(jnp.float32)))
             .bfloat16()) for j in js]


@pytest.mark.parametrize("layout", ["nthd", "nhtd"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [64, 128])
def test_bf16_plain_matches_pallas(layout, causal, d):
    """The bf16 semantics the kernel's bf16 path implements, held
    against the Pallas kernel in interpret mode on bf16 operands and a
    ragged bf16 key bias (the AMP policy casts the bias too): float32
    scores and softmax, P rounded to bf16 before P V, O returned bf16
    and lse float32.  O within 2^-6 of max |O| (two bf16 ulps: Pallas
    rounds p against its running row max over 16-key blocks, the plain
    version against the final max, and both round O); lse as for
    float32, since the scores' products are exact on both sides."""
    n, t, h = 2, 40, 2
    q, k, v = _qkv(5, n, t, h, d, layout)
    (jq, tq), (jk, tk_), (jv, tv), (jb, tb) = _bf16(
        q, k, v, _key_bias([40, 23], t))
    o, lse = pallas_flash_attention(jq, jk, jv, jb, None, causal,
                                    block_q=16, block_k=16, return_lse=True,
                                    layout=layout, n_head=h)
    assert o.dtype == jnp.bfloat16
    got, got_lse = tk.flash_attention_fwd_plain(tq, tk_, tv, tb, None,
                                                causal, layout=layout,
                                                n_head=h)
    assert got.dtype == torch.bfloat16 and got_lse.dtype == torch.float32
    want = np.asarray(o.astype(jnp.float32))
    err = np.abs(got.float().numpy() - want).max()
    assert err <= 2 ** -6 * np.abs(want).max(), err
    lse = np.asarray(lse)
    if layout == "nthd":
        lse = np.moveaxis(lse, 2, 1)
    np.testing.assert_allclose(got_lse.numpy(), lse.reshape(n * h, t),
                               rtol=1e-5, atol=1e-3)


def test_op_matches_jax_op_with_a_general_bias():
    """On the CPU the port's op takes any broadcastable bias, as the
    reference's XLA composition does ((Tq, Tk)-shaped here)."""
    n, t, h, d = 2, 12, 2, 8
    q, k, v = _qkv(2, n, t, h, d, "nthd")
    bias = np.random.RandomState(3).randn(1, 1, t, t).astype(np.float32)
    ins = {"Q": q, "K": k, "V": v, "Bias": bias}
    attrs = {"layout": "nthd", "n_head": h, "causal": False,
             "scale": d ** -0.5}
    want = run_op("flash_attention", ins, attrs)
    got = run_torch_op("flash_attention", ins, attrs)
    np.testing.assert_allclose(got, want, **TOL)


def test_key_bias_contract_of_the_kernel():
    """The kernel's bias form: (N, 1, 1, Tk)-broadcastable biases become
    one (N, Tk) row per batch element; anything else is refused by the
    kernels (the op sends it to the composed route instead)."""
    b = torch.arange(6, dtype=torch.float32).reshape(1, 1, 1, 6)
    kb = tk.key_bias(b, 3, 6)
    assert tuple(kb.shape) == (3, 6) and kb.is_contiguous()
    with pytest.raises(NotImplementedError, match="composed attention"):
        tk.key_bias(torch.zeros(3, 2, 1, 6), 3, 6)    # per-head bias


def test_bound_counts_the_visible_pairs():
    n, t, h, d = 2, 10, 2, 8
    q, k, _ = _qkv(4, n, t, h, d, "nthd")
    nbytes, flops = tk.bound_bytes_and_flops(
        to_torch(q), to_torch(k), torch.zeros(n, 1, 1, t), True, "nthd",
        h)
    assert flops == 4 * d * n * h * (t * (t + 1) // 2)
    assert nbytes == 4 * (4 * n * t * h * d + n * h * t + n * t)


def test_forward_tensor_core_bound():
    """The forward's 3xTF32 bound at the training shape (N=64, H=8,
    T=256, D=64): its bytes at 3.35 TB/s against 3 TF32 operations for
    each of the 4*D product flops of a visible pair at 495 TFLOP/s."""
    n, h, t, d = 64, 8, 256, 64
    q = torch.empty(n, h, t, d, device="meta")
    bias = torch.empty(n, 1, 1, t, device="meta")
    nbytes = 4 * n * h * t * d * 4 + n * h * t * 4 + n * t * 4
    for causal, pairs in ((True, t * (t + 1) // 2), (False, t * t)):
        bytes_ms = nbytes / 3.35e12 * 1e3
        ops_ms = 3 * 4 * d * n * h * pairs / 495e12 * 1e3
        got = tk.tensor_core_bound_ms(q, q, bias, causal, "nhtd", None)
        assert got == (pytest.approx(max(bytes_ms, ops_ms)),
                       "bytes" if bytes_ms >= ops_ms else "operations")
    assert tk.tensor_core_bound_ms(q, q, bias, True, "nhtd", None) == \
        (pytest.approx(0.040241, abs=1e-6), "bytes")
    assert tk.tensor_core_bound_ms(q, q, bias, False, "nhtd", None) == \
        (pytest.approx(0.052060, abs=1e-6), "operations")
    # with offsets only the pairs the mask leaves visible count: q_offset
    # 0 and k_offset 1000 leave none
    assert tk.tensor_core_bound_ms(q, q, bias, True, "nhtd", None, 0,
                                   1000) == \
        (pytest.approx(nbytes / 3.35e12 * 1e3), "bytes")


# -- why the forward kernel splits 3xTF32 (csrc/flash_attention_fwd.cu) ---

TOL_KERNEL = 2e-5   # chip_smoke.py phase 3: the kernel against plain


def _tc_forward(q, k, v, bias, causal, scale, passes, keys):
    """One head's forward as the kernel computes it: the online softmax
    over `keys`-key tiles in float32, each tile's S = Q K^T over the
    depth D in one tensor-core tile and its P V in its own accumulator,
    added to the rescaled O in float32."""
    f32 = np.float32
    t_q, t_k = q.shape[0], k.shape[0]
    m = np.full((t_q, 1), -1e30, f32)
    l = np.zeros((t_q, 1), f32)
    o = np.zeros((t_q, q.shape[1]), f32)
    for k0 in range(0, t_k, keys):
        kp = np.arange(k0, min(k0 + keys, t_k))
        s = tc_matmul(q, k[kp].T, passes) * f32(scale) + bias[None, kp]
        if causal:
            s = np.where(np.arange(t_q)[:, None] >= kp[None, :], s,
                         f32(-1e30))
        m_new = np.maximum(m, s.max(axis=1, keepdims=True))
        alpha = np.exp(m - m_new)
        p = np.exp(s - m_new).astype(f32)
        l = l * alpha + p.sum(axis=1, keepdims=True, dtype=f32)
        o = o * alpha + tc_matmul(p, v[kp], passes)
        m = m_new
    return o / np.maximum(l, f32(1e-30))


@pytest.mark.parametrize("passes,meets", [(1, False), (3, True)])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("layout", ["nhtd", "nthd"])
@pytest.mark.parametrize("causal", [True, False])
def test_error_budget_of_the_tensor_core_forward(causal, layout, d, passes,
                                                 meets):
    """The forward with both products emulated as TF32 tensor-core passes
    over the kernel's key tiles (64 keys, 32 at D = 128), against the
    float64 plain forward, on phase 3's kind of inputs (unit normal q,
    k, v, a key-padding bias of ragged lengths, T = 256): one TF32 pass
    misses TOL_KERNEL on O, 3xTF32 meets it."""
    n, h, t = 2, 2, 256
    rng = np.random.RandomState(3 + causal)
    shape = (n, t, h * d) if layout == "nthd" else (n, h, t, d)
    q, k, v = (torch.as_tensor(rng.randn(*shape)) for _ in range(3))
    lens = np.array([t, 150])
    bias = torch.as_tensor(((np.arange(t)[None, :] < lens[:, None]) * 1e9
                            - 1e9).reshape(n, 1, 1, t))
    scale = d ** -0.5
    want, _ = tk.flash_attention_fwd_plain(q, k, v, bias, scale, causal,
                                           layout, h)
    want = tk._heads(want, layout, n, h, t, d).numpy()
    f32 = np.float32
    heads = [tk._heads(x, layout, n, h, t, d).numpy().astype(f32)
             for x in (q, k, v)]
    got = np.zeros((n, h, t, d), f32)
    for i in range(n):
        for j in range(h):
            got[i, j] = _tc_forward(
                *(x[i, j] for x in heads),
                bias[i, 0, 0].numpy().astype(f32), causal, scale, passes,
                keys=32 if d > 64 else 64)
    err = float(np.abs(got - want).max())
    assert (err <= TOL_KERNEL + TOL_KERNEL * float(np.abs(want).max())) \
        == meets, err
