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
both sides, sums over T in other orders.  bf16 operands: the plain
backward against the Pallas VJP from the same bf16 O, to one bf16 ulp
(`test_bf16_plain_backward_matches_pallas_vjp`).

The error budgets of the kernels' arithmetic, emulated in numpy: the
float32 kernels' 3xTF32 products against one TF32 pass, and the bf16
kernels' hi + lo split of p and ds against one bf16 rounding, each held
to chip_smoke.py's gate for the kernels against the plain backward.
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
from torch_tf32 import tc_matmul, tc_matmul_tiled

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
@pytest.mark.parametrize("d", [16, 128])
def test_plain_backward_matches_pallas_grad(layout, causal, t, d):
    """dq, dk, dv, dbias with an lse cotangent against jax.grad through
    the Pallas kernel's custom VJP (its _bwd_dkv_kernel/_bwd_dq_kernel
    in interpret mode)."""
    n, h = 3, 2
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
@pytest.mark.parametrize("d", [64, 128])
def test_bf16_plain_backward_matches_pallas_vjp(layout, causal, d):
    """bf16 operands and a ragged bf16 key bias: the plain backward
    against the Pallas kernel's custom VJP in interpret mode, both fed the
    Pallas forward's own bf16 O and float32 lse, so the backward alone is
    compared.  Both widen q, k, v, dO and the bf16 O to float32, compute
    in float32 and round dQ, dK, dV and the bias gradient to bf16 once:
    each within 2^-7 relative (one bf16 ulp), plus 2^-12 of the largest
    magnitude for the sums near 0."""
    n, h, t = 2, 2, 40
    q, k, v, do, bias, dlse = _case(d + causal, n, t, h, d, layout,
                                    [t, 17])
    jq, jk, jv, jdo, jb = (jnp.asarray(x, jnp.bfloat16)
                           for x in (q, k, v, do, bias))

    def fwd(q, k, v, b):
        o, lse = pallas_flash_attention(q, k, v, b, None, causal,
                                        block_q=16, block_k=16,
                                        return_lse=True, layout=layout,
                                        n_head=h)
        return o, _lse_flat(lse, layout, n, h, t)

    (o, lse), vjp = jax.vjp(fwd, jq, jk, jv, jb)
    want = vjp((jdo, jnp.asarray(dlse)))
    assert all(w.dtype == jnp.bfloat16 for w in want)

    def tb(x):
        return torch.from_numpy(np.array(x.astype(jnp.float32))).bfloat16()

    got = tk.flash_attention_bwd_plain(
        tb(jq), tb(jk), tb(jv), tb(jb), tb(o), to_torch(np.array(lse)),
        tb(jdo), to_torch(dlse), None, causal, layout, h)
    for name, a, w in zip(("dq", "dk", "dv", "dbias"), got, want):
        assert a.dtype == torch.bfloat16, name
        w = np.asarray(w.astype(jnp.float32))
        np.testing.assert_allclose(a.float().numpy(), w, rtol=2 ** -7,
                                   atol=2 ** -12 * np.abs(w).max(),
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


def test_backward_tensor_core_bounds():
    """The 3xTF32 bound of each backward kernel at the training shape:
    bytes at 3.35 TB/s against 3 TF32 operations for each of 8*D (dK/dV)
    or 6*D (dQ) product flops a visible pair at 495 TFLOP/s, each with
    the limit that sets it."""
    n, h, t, d = 64, 8, 256, 64
    q = torch.empty(n, h, t, d, device="meta")
    bias = torch.empty(n, 1, 1, t, device="meta")
    for causal, pairs in ((True, t * (t + 1) // 2), (False, t * t)):
        got = tk.tensor_core_bound_ms_bwd(q, q, bias, causal, "nhtd", None)
        nbytes = tk.bound_bytes_and_flops_bwd(q, q, bias, causal, "nhtd",
                                              None)
        for name, per_pair in (("dkv", 8), ("dq", 6)):
            ops_ms = 3 * per_pair * d * n * h * pairs / 495e12 * 1e3
            bytes_ms = nbytes[name][0] / 3.35e12 * 1e3
            assert got[name][0] == pytest.approx(max(bytes_ms, ops_ms))
            assert got[name][1] == ("bytes" if bytes_ms >= ops_ms
                                    else "operations")
    got = tk.tensor_core_bound_ms_bwd(q, q, bias, False, "nhtd", None)
    assert {k: ms for k, (ms, _) in got.items()} == \
        pytest.approx({"dkv": 0.104120, "dq": 0.078090}, abs=1e-6)
    assert {k: by for k, (_, by) in got.items()} == \
        {"dkv": "operations", "dq": "operations"}
    got = tk.tensor_core_bound_ms_bwd(q, q, bias, True, "nhtd", None)
    assert {k: ms for k, (ms, _) in got.items()} == \
        pytest.approx({"dkv": 0.070290, "dq": 0.060274}, abs=1e-6)
    assert {k: by for k, (_, by) in got.items()} == \
        {"dkv": "bytes", "dq": "bytes"}


# -- why the backward kernels split 3xTF32 (csrc/flash_attention_bwd.cu) ---

TOL_BWD = 2e-5      # chip_smoke.py phase 3b: the kernels against plain


def _tc_backward(q, k, v, do, o, lse, bias, causal, scale, passes, depth):
    """One head's backward with every product as the kernels compute it:
    s and dp over the depth D in one tensor-core tile, dV, dK and dQ over
    `depth`-deep tiles of queries or keys added in float32; p, ds and
    delta in float32 as the kernels form them."""
    t_q, t_k = q.shape[0], k.shape[0]
    s = tc_matmul(q, k.T, passes) * np.float32(scale) + bias[None, :]
    p = np.exp(s - lse[:, None])
    if causal:
        p = np.where(np.arange(t_q)[:, None] >= np.arange(t_k)[None, :],
                     p, np.float32(0))
    dp = tc_matmul(do, v.T, passes)
    delta = (do * o).sum(axis=1, dtype=np.float32)
    ds = (p * (dp - delta[:, None])).astype(np.float32)
    p = p.astype(np.float32)
    return (tc_matmul_tiled(ds, k, passes, depth) * np.float32(scale),
            tc_matmul_tiled(ds.T, q, passes, depth) * np.float32(scale),
            tc_matmul_tiled(p.T, do, passes, depth))


@pytest.mark.parametrize("passes,meets", [(1, False), (3, True)])
@pytest.mark.parametrize("layout", ["nhtd", "nthd"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [64, 128])
def test_error_budget_of_the_tensor_core_backward(causal, layout, passes,
                                                  meets, d):
    """The backward with every product emulated as TF32 tensor-core
    passes, against the float64 plain backward, on phase 3b's kind of
    inputs (unit normal q, k, v, dO, a key-padding bias of ragged
    lengths, T = 256; the kernels' tiles of 64 queries or keys, 32 at
    D = 128): one TF32 pass misses TOL_BWD for each of dq, dk and dv,
    3xTF32 meets it."""
    n, h, t = 2, 2, 256
    rng = np.random.RandomState(1 + causal)
    shape = (n, t, h * d) if layout == "nthd" else (n, h, t, d)
    q, k, v, do = (torch.as_tensor(rng.randn(*shape)) for _ in range(4))
    lens = np.array([t, 150])
    bias = torch.as_tensor(((np.arange(t)[None, :] < lens[:, None]) * 1e9
                            - 1e9).reshape(n, 1, 1, t))
    scale = d ** -0.5
    o, lse = tk.flash_attention_fwd_plain(q, k, v, bias, scale, causal,
                                          layout, h)
    want = tk.flash_attention_bwd_plain(q, k, v, bias, o, lse, do, None,
                                        scale, causal, layout, h)[:3]
    f32 = np.float32
    heads = [tk._heads(x, layout, n, h, t, d).numpy().astype(f32)
             for x in (q, k, v, do, o)]
    lse4 = lse.reshape(n, h, t).numpy().astype(f32)
    got = np.zeros((3, n, h, t, d), f32)
    for i in range(n):
        for j in range(h):
            got[:, i, j] = _tc_backward(
                *(x[i, j] for x in heads), lse4[i, j],
                bias[i, 0, 0].numpy().astype(f32), causal, scale, passes,
                depth=32 if d > 64 else 64)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        b = tk._heads(b, layout, n, h, t, d).numpy()
        err = float(np.abs(a - b).max())
        assert (err <= TOL_BWD + TOL_BWD * float(np.abs(b).max())) == \
            meets, (name, err)


# -- why the bf16 backward kernels split P and dS into hi + lo -------------

TOL_BF16_GRAD = 2 ** -7     # chip_smoke.py phase 3g, plus 2^-10 of max


def _bf16(x):
    """float32 rounded to nearest even bf16, as float32."""
    return torch.from_numpy(np.ascontiguousarray(x, np.float32)) \
        .bfloat16().float().numpy()


def _bf16_product(a, b):
    """a @ b of bf16 values with float32 accumulation: the products are
    exact, the sums taken in float64 and rounded once."""
    return (a.astype(np.float64) @ b.astype(np.float64)).astype(np.float32)


def _bf16_product_tiled(a, b, passes, depth=64):
    """a @ b for a float32 a and a bf16 b as the kernels' second products
    take it: a rounded to bf16 once (1 pass) or split into hi = bf16(a)
    and lo = bf16(a - hi) (2 passes, lo first), over `depth`-deep tiles of
    the contraction, each tile's product one accumulator, the partial
    sums added in float32."""
    out = np.zeros((a.shape[0], b.shape[1]), np.float32)
    for k0 in range(0, a.shape[1], depth):
        at, bt = a[:, k0:k0 + depth], b[k0:k0 + depth].astype(np.float64)
        hi = _bf16(at)
        part = hi.astype(np.float64) @ bt
        if passes == 2:
            part = _bf16(at - hi).astype(np.float64) @ bt + part
        out += part.astype(np.float32)
    return out


def _bf16_tc_backward(q, k, v, do, o, lse, bias, causal, scale, passes):
    """One head's bf16 backward as the bf16 kernels compute it: s and dp
    as one bf16 pass over the depth D; p, delta and ds in float32; dV,
    dK and dQ with p and ds rounded or split (`_bf16_product_tiled`) over
    the kernels' 64-deep q and key tiles; one bf16 rounding at the end."""
    f32 = np.float32
    t_q, t_k = q.shape[0], k.shape[0]
    s = _bf16_product(q, k.T) * f32(scale) + bias[None, :]
    p = np.exp(s - lse[:, None])
    if causal:
        p = np.where(np.arange(t_q)[:, None] >= np.arange(t_k)[None, :],
                     p, f32(0))
    dp = _bf16_product(do, v.T)
    delta = (do * o).sum(axis=1, dtype=f32)
    ds = (p * (dp - delta[:, None])).astype(f32)
    p = p.astype(f32)
    return [_bf16(x) for x in (
        _bf16_product_tiled(ds, k, passes) * f32(scale),
        _bf16_product_tiled(ds.T, q, passes) * f32(scale),
        _bf16_product_tiled(p.T, do, passes))]


@pytest.mark.parametrize("passes,meets", [(1, False), (2, True)])
@pytest.mark.parametrize("layout", ["nhtd", "nthd"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [64, 128])
def test_error_budget_of_the_bf16_tensor_core_backward(causal, layout,
                                                       passes, meets, d):
    """The bf16 backward with its products emulated as the bf16 kernels
    take them (csrc/flash_attention_bwd.cu), against the bf16 plain
    backward, on phase 3g's kind of inputs (unit normal bf16 q, k, v, dO,
    a ragged bf16 key-padding bias, O and lse from the bf16 plain forward,
    T = 256 as at phase 6i): with p and ds rounded to bf16 once before the
    second products, some gradient misses chip_smoke's TOL_BF16_GRAD gate
    (2^-7 relative plus 2^-10 of max, element by element); split into
    hi + lo, every gradient meets it."""
    n, h, t = 2, 2, 256
    rng = np.random.RandomState(1 + causal)
    shape = (n, t, h * d) if layout == "nthd" else (n, h, t, d)
    q, k, v, do = (torch.as_tensor(rng.randn(*shape).astype(np.float32))
                   .bfloat16() for _ in range(4))
    lens = np.array([t, 150])
    bias = torch.as_tensor(((np.arange(t)[None, :] < lens[:, None]) * 1e9
                            - 1e9).reshape(n, 1, 1, t).astype(np.float32)) \
        .bfloat16()
    scale = d ** -0.5
    o, lse = tk.flash_attention_fwd_plain(q, k, v, bias, scale, causal,
                                          layout, h)
    want = tk.flash_attention_bwd_plain(q, k, v, bias, o, lse, do, None,
                                        scale, causal, layout, h)[:3]
    heads = [tk._heads(x, layout, n, h, t, d).float().numpy()
             for x in (q, k, v, do, o)]
    lse4 = lse.reshape(n, h, t).numpy()
    got = np.zeros((3, n, h, t, d), np.float32)
    for i in range(n):
        for j in range(h):
            got[:, i, j] = _bf16_tc_backward(
                *(x[i, j] for x in heads), lse4[i, j],
                bias[i, 0, 0].float().numpy(), causal, scale, passes)
    within = {}
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        b = tk._heads(b, layout, n, h, t, d).float().numpy()
        over = np.abs(a - b) - (TOL_BF16_GRAD * np.abs(b)
                                + 2 ** -10 * np.abs(b).max())
        within[name] = float(over.max()) <= 0
    assert all(within.values()) == meets, within


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
