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
differs.
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
def test_plain_matches_xla_twin(layout, causal, with_bias):
    n, t, h, d = 3, 40, 2, 16
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
def test_plain_matches_pallas_including_lse(layout, causal):
    """T=40 against 16-row Pallas blocks (a ragged last block); one batch
    row has seq_len 0, so every key of it carries the -1e9 bias."""
    n, t, h, d = 3, 40, 2, 16
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
