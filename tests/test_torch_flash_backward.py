"""Flash-attention backward and the flash_attention op's two routes: the
PyTorch port against the JAX package on the same numpy inputs.

- `flash_attention_bwd_plain` (the CPU route and the card's reference
  for the dK/dV and dQ kernels) against `jax.grad` of the reference's
  Pallas `pallas_flash_attention` (interpret mode on the CPU, 16-row
  blocks so T=40 and T=100 end on ragged blocks) and of its XLA
  compositions `_xla_attention` / `_xla_attention_nthd`: both layouts,
  causal or not, a key-padding bias with its gradient, and the lse
  cotangent (`return_lse`).  Ragged lengths are at least 1, so no row is
  fully masked (the XLA twin fills causal keys with -1e9, the kernels
  with -1e30; they differ only on such rows).
- `torch.autograd.gradcheck` of `FlashAttentionFn` in float64 over the
  CPU route.
- The composed route for biases that are not key-padding biases
  ((Tq, Tk) and per-head), forward and gradient, against the JAX op.

Tolerance 2e-5 (abs and rel) forward, 1e-4 for gradients: float32 on
both sides, sums over T in other orders.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.ops.attention import _xla_attention, _xla_attention_nthd
from paddle_tpu.ops.pallas.flash_attention import pallas_flash_attention
from paddle_tpu_torch.ops import kernels
from paddle_tpu_torch.ops.kernels import flash_attention as tk

from op_test import run_op
from torch_op_test import run_torch_op, to_torch

torch.set_num_threads(2)

TOL = dict(rtol=2e-5, atol=2e-5)
GTOL = dict(rtol=1e-4, atol=1e-4)


def _case(seed, n, t, h, d, layout, lens):
    rng = np.random.RandomState(seed)
    shape = (n, t, h * d) if layout == "nthd" else (n, h, t, d)
    q, k, v, do = (rng.randn(*shape).astype(np.float32) * 0.5
                   for _ in range(4))
    m = np.arange(t)[None, :] < np.asarray(lens)[:, None]
    bias = ((m.astype(np.float32) * 1e9 - 1e9).reshape(n, 1, 1, t)
            + rng.randn(n, 1, 1, t).astype(np.float32) * 0.1)
    dlse = rng.randn(n * h, t).astype(np.float32)
    return q, k, v, do, bias, dlse


def _torch_bwd(q, k, v, do, bias, dlse, causal, layout, h):
    tq, tk_, tv, tb = (to_torch(x) for x in (q, k, v, bias))
    o, lse = tk.flash_attention_fwd_plain(tq, tk_, tv, tb, None, causal,
                                          layout, h)
    return tk.flash_attention_bwd_plain(
        tq, tk_, tv, tb, o, lse, to_torch(do),
        None if dlse is None else to_torch(dlse), None, causal, layout, h)


def _lse_flat(lse, layout, n, h, t):
    """The reference's returned lse -> the port's (N*H, T)."""
    if layout == "nthd":                          # (N, T, H) -> (N, H, T)
        lse = jnp.moveaxis(lse, 2, 1)
    return lse.reshape(n * h, t)


@pytest.mark.parametrize("layout", ["nthd", "nhtd"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("t", [40, 100])
def test_plain_backward_matches_pallas_grad(layout, causal, t):
    """dq, dk, dv, dbias with an lse cotangent against jax.grad through
    the Pallas kernel's custom VJP (its _bwd_dkv_kernel/_bwd_dq_kernel
    in interpret mode)."""
    n, h, d = 3, 2, 16
    q, k, v, do, bias, dlse = _case(t, n, t, h, d, layout, [t, 17, 1])

    def loss(q, k, v, b):
        o, lse = pallas_flash_attention(q, k, v, b, None, causal,
                                        block_q=16, block_k=16,
                                        return_lse=True, layout=layout,
                                        n_head=h)
        return jnp.sum(o * do) + jnp.sum(_lse_flat(lse, layout, n, h, t)
                                         * dlse)

    want = jax.grad(loss, argnums=(0, 1, 2, 3))(
        *(jnp.asarray(x) for x in (q, k, v, bias)))
    got = _torch_bwd(q, k, v, do, bias, dlse, causal, layout, h)
    for name, a, b in zip(("dq", "dk", "dv", "dbias"), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **GTOL,
                                   err_msg=name)


@pytest.mark.parametrize("layout", ["nthd", "nhtd"])
@pytest.mark.parametrize("causal", [True, False])
def test_plain_backward_matches_xla_twin_grad(layout, causal):
    n, h, d, t = 2, 2, 8, 40
    q, k, v, do, bias, _ = _case(7, n, t, h, d, layout, [40, 5])

    def loss(q, k, v, b):
        if layout == "nthd":
            o = _xla_attention_nthd(q, k, v, b, d ** -0.5, causal, h)
        else:
            o = _xla_attention(q, k, v, b, d ** -0.5, causal)
        return jnp.sum(o * do)

    want = jax.grad(loss, argnums=(0, 1, 2, 3))(
        *(jnp.asarray(x) for x in (q, k, v, bias)))
    got = _torch_bwd(q, k, v, do, bias, None, causal, layout, h)
    for name, a, b in zip(("dq", "dk", "dv", "dbias"), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **GTOL,
                                   err_msg=name)


@pytest.mark.parametrize("layout,causal", [("nhtd", True),
                                           ("nthd", False)])
def test_flash_fn_gradcheck_float64(layout, causal):
    g = torch.Generator().manual_seed(0)
    n, h, t, d = 1, 2, 6, 4
    shape = (n, h, t, d) if layout == "nhtd" else (n, t, h * d)
    q, k, v = (torch.randn(*shape, generator=g, dtype=torch.float64)
               .requires_grad_() for _ in range(3))
    bias = (torch.randn(n, 1, 1, t, generator=g, dtype=torch.float64)
            .requires_grad_())

    def f(q, k, v, b):
        return tk.flash_attention(q, k, v, b, None, causal, layout, h)

    assert torch.autograd.gradcheck(f, (q, k, v, bias))


def test_flash_fn_routes_cpu_to_the_plain_versions():
    n, h, t, d = 2, 2, 8, 4
    q, k, v, do, bias, _ = _case(3, n, t, h, d, "nhtd", [8, 3])
    xs = [to_torch(x).requires_grad_() for x in (q, k, v)]
    before = dict(kernels.plain_calls)
    o, _ = tk.flash_attention(*xs, to_torch(bias), None, True, "nhtd", h)
    grads = torch.autograd.grad(o, xs, to_torch(do))
    for name in ("flash_attention_fwd", "flash_attention_bwd_dkv",
                 "flash_attention_bwd_dq"):
        assert kernels.plain_calls[name] == before[name] + 1, name
    assert all(torch.isfinite(g).all() for g in grads)


def test_backward_kernel_bounds():
    n, h, t, d = 2, 2, 10, 8
    q = torch.zeros(n, h, t, d)
    b = tk.bound_bytes_and_flops_bwd(q, q, torch.zeros(n, 1, 1, t), True,
                                     "nhtd", None, dbias=True)
    pairs = n * h * t * (t + 1) // 2
    row = n * h * t * d * 4
    ins = 5 * row + n * h * t * 4 + n * t * 4
    assert b["dkv"] == (ins + 2 * row + n * h * t * 4,
                        8 * d * pairs + 2 * d * n * h * t)
    assert b["dq"] == (ins + row, 6 * d * pairs + 2 * d * n * h * t)


# -- the composed route (biases the kernels do not take) ------------------

def _bias_cases():
    rng = np.random.RandomState(5)
    return {"tq_tk": rng.randn(1, 1, 12, 12).astype(np.float32),
            "per_head": rng.randn(2, 2, 1, 12).astype(np.float32)}


@pytest.mark.parametrize("kind", ["tq_tk", "per_head"])
@pytest.mark.parametrize("layout", ["nthd", "nhtd"])
@pytest.mark.parametrize("causal", [True, False])
def test_composed_route_matches_jax_op(kind, layout, causal):
    n, t, h, d = 2, 12, 2, 8
    q, k, v, _, _, _ = _case(9, n, t, h, d, layout, [t, t])
    ins = {"Q": q, "K": k, "V": v, "Bias": _bias_cases()[kind]}
    attrs = {"layout": layout, "n_head": h, "causal": causal,
             "scale": d ** -0.5, "use_pallas": True}
    want = run_op("flash_attention", ins, attrs)
    before = dict(kernels.counts())
    got = run_torch_op("flash_attention", ins, attrs)
    after = kernels.counts()
    np.testing.assert_allclose(got, want, **TOL)
    assert after["composed"]["flash_attention"] == \
        before["composed"]["flash_attention"] + 1
    assert after["plain"] == before["plain"]


@pytest.mark.parametrize("kind", ["tq_tk", "per_head"])
def test_composed_route_gradients_match_jax(kind):
    from paddle_tpu.core.registry import OpContext as JaxCtx
    from paddle_tpu.core.registry import get_op_impl as jax_impl
    from paddle_tpu_torch.core.registry import OpContext, get_op_impl

    n, t, h, d = 2, 12, 2, 8
    q, k, v, do, _, _ = _case(11, n, t, h, d, "nthd", [t, t])
    bias = _bias_cases()[kind]
    attrs = {"layout": "nthd", "n_head": h, "causal": True,
             "scale": d ** -0.5, "use_pallas": True}

    def jloss(q, k, v, b):
        o = jax_impl("flash_attention")(
            JaxCtx(jax.random.PRNGKey(0), 0),
            {"Q": [q], "K": [k], "V": [v], "Bias": [b]}, attrs)["Out"][0]
        return jnp.sum(o * do)

    want = jax.grad(jloss, argnums=(0, 1, 2, 3))(
        *(jnp.asarray(x) for x in (q, k, v, bias)))
    xs = [to_torch(x).requires_grad_() for x in (q, k, v, bias)]
    o = get_op_impl("flash_attention")(
        OpContext((0, 0), 0, device="cpu"),
        {"Q": [xs[0]], "K": [xs[1]], "V": [xs[2]], "Bias": [xs[3]]},
        attrs)["Out"][0]
    got = torch.autograd.grad(o, xs, to_torch(do))
    for name, a, b in zip(("dq", "dk", "dv", "dbias"), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **GTOL,
                                   err_msg=name)
