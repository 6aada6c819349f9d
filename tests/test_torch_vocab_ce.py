"""The fused vocab-projection + label-smoothed CE of the port
(ops/kernels/vocab_ce.py) against the JAX package's Pallas kernels
(paddle_tpu/ops/pallas/vocab_ce.py, run through the Pallas interpreter
on the CPU, as tests/test_vocab_ce.py runs them), on the same numpy
inputs.

Tolerances: the loss at 2e-5 (abs and rel) — float32 on both sides,
other summation orders, as tests/test_vocab_ce.py holds the kernel to
its composition; gradients at 2e-4 relative plus 2e-5 absolute, the
reference test's own tolerance for its kernel against AD
(tests/test_vocab_ce.py:59-62).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops.pallas.vocab_ce import fused_vocab_ce as ref_ce
from paddle_tpu_torch.core.registry import get_op_impl
from paddle_tpu_torch.ops import kernels
from paddle_tpu_torch.ops.kernels import vocab_ce as vk

from op_test import run_op
from torch_op_test import run_torch_op
from torch_tf32 import tc_matmul, tc_matmul_tiled

torch.set_num_threads(2)

LOSS_TOL = dict(rtol=2e-5, atol=2e-5)
GRAD_TOL = dict(rtol=2e-4, atol=2e-5)


def _inputs(n, d, v, seed, lead=None):
    rng = np.random.RandomState(seed)
    h = rng.randn(n, d).astype(np.float32)
    w = (rng.randn(d, v) * 0.1).astype(np.float32)
    lbl = rng.randint(0, v, size=n).astype(np.int64)
    if lead is not None:
        h = h.reshape(*lead, d)
        lbl = lbl.reshape(lead)
    return h, w, lbl


@pytest.mark.parametrize("eps", [0.0, 0.1])
@pytest.mark.parametrize("n,d,v,bt,bv", [
    (16, 8, 64, 8, 16),      # even blocks
    (10, 8, 50, 8, 16),      # ragged token AND vocab tails
    (4, 16, 33, 16, 32),     # single token block, ragged vocab
])
def test_loss_matches_the_reference_kernel(n, d, v, bt, bv, eps):
    h, w, lbl = _inputs(n, d, v, seed=n + v)
    want = np.asarray(ref_ce(jnp.asarray(h), jnp.asarray(w),
                             jnp.asarray(lbl), eps, bt, bv))
    got = vk.fused_vocab_ce(torch.as_tensor(h), torch.as_tensor(w),
                            torch.as_tensor(lbl), eps)
    np.testing.assert_allclose(got.numpy(), want, **LOSS_TOL)


@pytest.mark.parametrize("eps", [0.0, 0.1])
@pytest.mark.parametrize("n,d,v", [(12, 8, 40), (10, 8, 50)])
def test_gradients_match_jax_grad_of_the_reference(n, d, v, eps):
    h, w, lbl = _inputs(n, d, v, seed=3 + n)
    cot = np.random.RandomState(6).randn(n).astype(np.float32)
    cot[::4] = 0.0                                  # masked tokens

    def via_kernel(hh, ww):
        return jnp.sum(ref_ce(hh, ww, jnp.asarray(lbl), eps, 8, 16)
                       * jnp.asarray(cot))

    gh, gw = jax.grad(via_kernel, argnums=(0, 1))(jnp.asarray(h),
                                                  jnp.asarray(w))
    th = torch.as_tensor(h).requires_grad_()
    tw = torch.as_tensor(w).requires_grad_()
    loss = vk.fused_vocab_ce(th, tw, torch.as_tensor(lbl), eps)
    dh, dw = torch.autograd.grad((loss * torch.as_tensor(cot)).sum(),
                                 (th, tw))
    np.testing.assert_allclose(dh.numpy(), np.asarray(gh), **GRAD_TOL)
    np.testing.assert_allclose(dw.numpy(), np.asarray(gw), **GRAD_TOL)


def test_out_of_range_labels_clamp_like_the_reference():
    h, w, lbl = _inputs(8, 8, 20, seed=11)
    lbl[:3] = [-5, 20, 1000]
    want = np.asarray(ref_ce(jnp.asarray(h), jnp.asarray(w),
                             jnp.asarray(lbl), 0.1, 8, 16))
    got = vk.fused_vocab_ce(torch.as_tensor(h), torch.as_tensor(w),
                            torch.as_tensor(lbl), 0.1).numpy()
    np.testing.assert_allclose(got, want, **LOSS_TOL)
    assert np.all(np.abs(got) < 1e3)                # no ~1e30 loss


def test_leading_dims():
    h, w, lbl = _inputs(12, 8, 32, seed=7, lead=(2, 6))
    want = np.asarray(ref_ce(jnp.asarray(h), jnp.asarray(w),
                             jnp.asarray(lbl), 0.1, 8, 16))
    got = vk.fused_vocab_ce(torch.as_tensor(h), torch.as_tensor(w),
                            torch.as_tensor(lbl), 0.1)
    assert tuple(got.shape) == (2, 6) == want.shape
    np.testing.assert_allclose(got.numpy(), want, **LOSS_TOL)
    with pytest.raises(ValueError, match="labels"):
        vk.fused_vocab_ce(torch.as_tensor(h), torch.as_tensor(w),
                          torch.as_tensor(lbl[:, :5]), 0.1)


def test_plain_versions_are_the_formulas():
    """The plain forward/backward against autograd of the materialised
    composition, and the plain path counted as plain calls."""
    h, w, lbl = _inputs(9, 8, 21, seed=5)
    th, tw = torch.as_tensor(h), torch.as_tensor(w)
    tl = torch.as_tensor(lbl).to(torch.int32)
    kernels.reset_counts()
    lse, zl, zs = vk.vocab_ce_fwd(th, tw, tl)
    z = th @ tw
    np.testing.assert_allclose(lse.numpy(), torch.logsumexp(z, -1).numpy(),
                               **LOSS_TOL)
    np.testing.assert_allclose(zl.numpy(), z[torch.arange(9), tl.long()]
                               .numpy(), **LOSS_TOL)
    np.testing.assert_allclose(zs.numpy(), z.sum(-1).numpy(), rtol=2e-5,
                               atol=1e-5)
    g = torch.as_tensor(np.random.RandomState(1).randn(9).astype(np.float32))
    dh, dw = vk.vocab_ce_bwd(th, tw, tl, lse, g, 0.1)
    ah, aw = th.clone().requires_grad_(), tw.clone().requires_grad_()
    ref = torch.nn.functional.cross_entropy(
        ah @ aw, tl.long(), label_smoothing=0.1, reduction="none")
    rh, rw = torch.autograd.grad((ref * g).sum(), (ah, aw))
    np.testing.assert_allclose(dh.numpy(), rh.numpy(), **GRAD_TOL)
    np.testing.assert_allclose(dw.numpy(), rw.numpy(), **GRAD_TOL)
    c = kernels.counts()
    assert c["plain"]["vocab_ce_fwd"] == 1 and c["plain"]["vocab_ce_dh"] == 1
    assert c["plain"]["vocab_ce_dw"] == 1
    assert not any(c["launches"].values())


def test_meta_tensors_get_shapes_only():
    h = torch.empty(3, 5, 8, device="meta")
    w = torch.empty(8, 40, device="meta")
    lbl = torch.empty(3, 5, dtype=torch.int64, device="meta")
    kernels.reset_counts()
    loss = vk.fused_vocab_ce(h, w, lbl, 0.1)
    assert loss.device.type == "meta" and tuple(loss.shape) == (3, 5)
    assert loss.dtype == torch.float32
    assert not any(kernels.counts()["plain"].values())
    out = get_op_impl("fused_vocab_softmax_ce")(
        None, {"Hidden": [h], "W": [w], "Label": [lbl]}, {"epsilon": 0.1})
    assert tuple(out["Loss"][0].shape) == (3, 5)


def test_cuda_kernels_refuse_bf16_and_what_they_do_not_take(monkeypatch):
    """A bf16 operand on CUDA raises naming B.3, before anything
    launches; so do float64, non-contiguous operands and D > 512.  (The
    checks run before the kernel is built: no card is needed.)"""
    h = torch.zeros(4, 8)
    w = torch.zeros(8, 16)
    lbl = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="B.3"):
        vk._check_kernel(h.to(torch.bfloat16), w, lbl)
    with pytest.raises(TypeError, match="float32"):
        vk._check_kernel(h.double(), w.double(), lbl)
    with pytest.raises(ValueError, match="contiguous"):
        vk._check_kernel(h, torch.zeros(16, 8).t(), lbl)
    with pytest.raises(ValueError, match="512"):
        vk._check_kernel(torch.zeros(4, 520), torch.zeros(520, 16), lbl)
    # the route: a CUDA-typed tensor goes to the checks, never the plain
    # version (the device type is what routes)
    calls = []
    monkeypatch.setattr(vk, "_check",
                        lambda *a: calls.append("check") or "cuda")
    with pytest.raises(NotImplementedError, match="bf16"):
        vk.vocab_ce_fwd(h.to(torch.bfloat16), w, lbl)
    with pytest.raises(NotImplementedError, match="bf16"):
        vk.vocab_ce_bwd(h.to(torch.bfloat16), w, lbl, torch.zeros(4),
                        torch.zeros(4), 0.1)
    assert calls == ["check", "check"]


def test_bound_counts_bytes_and_recompute_flops():
    b = vk.bound_bytes_and_flops(16384, 512, 32000)
    ndv = 16384 * 512 * 32000
    assert b["fwd"][1] == 2 * ndv and b["dh"][1] == b["dw"][1] == 4 * ndv
    h, w = 16384 * 512 * 4, 512 * 32000 * 4
    assert b["fwd"][0] == h + w + 4 * 16384 * 4
    assert b["dh"][0] == 2 * h + w + 3 * 16384 * 4
    assert b["dw"][0] == h + 2 * w + 3 * 16384 * 4


def _sweep_f32(shape, seed, lo=0.15, hi=0.85):
    """tests/test_op_sweep.py's f32(): |x| in [lo, hi], random signs."""
    r = np.random.RandomState(seed)
    mag = r.uniform(lo, hi, shape)
    return (mag * np.where(r.rand(*shape) < 0.5, -1.0, 1.0)) \
        .astype(np.float32)


@pytest.mark.parametrize("attrs", [{"epsilon": 0.1},
                                   {"epsilon": 0.0, "block_t": 8,
                                    "block_v": 16}])
def test_op_matches_the_reference_op(attrs):
    """The op on the inputs of the reference sweep's case
    (tests/test_op_sweep.py S["fused_vocab_softmax_ce"]), with the
    reference op on its kernel route (use_pallas=True, interpreted)."""
    ins = {"Hidden": _sweep_f32((6, 8), 244), "W": _sweep_f32((8, 32), 245),
           "Label": np.random.RandomState(246).randint(0, 32, (6,))
           .astype(np.int64)}
    want = run_op("fused_vocab_softmax_ce", ins,
                  dict(attrs, use_pallas=True), out_slot="Loss")
    got = run_torch_op("fused_vocab_softmax_ce", ins, attrs,
                       out_slot="Loss")
    assert got.shape == (6,)
    np.testing.assert_allclose(got, np.asarray(want), **LOSS_TOL)


# -- why the dh and dW kernels split 3xTF32 (csrc/vocab_ce.cu) ------------

TOL_VOCAB = 2e-5    # chip_smoke.py phase 3c: the kernels against plain


def _within(got, want, tol=TOL_VOCAB):
    """chip_smoke.check_close's test: tol absolute plus tol of max|want|."""
    return float(np.abs(got - want).max()) <= tol + tol * float(
        np.abs(want).max())


@pytest.mark.parametrize("passes,meets", [(1, False), (3, True)])
def test_error_budget_of_the_tensor_core_backward(passes, meets):
    """The kernels' backward with every product emulated as TF32 tensor-
    core passes (the z recompute, dh = dz W^T and dW = h^T dz), against
    the float32 plain version, on phase 3c's kind of inputs: one TF32
    pass misses TOL_VOCAB for both dh and dW, 3xTF32 meets it."""
    n, d, v, eps = 64, 128, 300, 0.1
    rng = np.random.RandomState(0)
    h = rng.randn(n, d).astype(np.float32)
    w = (rng.randn(d, v) * 0.05).astype(np.float32)
    lbl = rng.randint(0, v, n).astype(np.int32)
    g = rng.randn(n).astype(np.float32)
    g[rng.rand(n) < 0.25] = 0.0
    th, tw, tl, tg = (torch.as_tensor(x) for x in (h, w, lbl, g))
    lse = vk.vocab_ce_fwd_plain(th, tw, tl)[0]
    want = [x.numpy() for x in vk.vocab_ce_bwd_plain(th, tw, tl, lse, tg,
                                                     eps)]
    z = tc_matmul(h, w, passes)
    p = np.exp(z - lse.numpy()[:, None])
    p[np.arange(n), lbl] -= 1.0 - eps
    dz = ((p - eps / v) * g[:, None]).astype(np.float32)
    got = (tc_matmul(dz, w.T, passes), tc_matmul(h.T, dz, passes))
    for name, a, b in zip(("dh", "dw"), got, want):
        assert _within(a, b) == meets, (name, float(np.abs(a - b).max()))


def _fwd_stats(z, lbl):
    """lse, z_label (NEG where the label is outside [0, V)) and z_sum of
    logits z, as the forward kernel reduces them, in float64."""
    z = z.astype(np.float64)
    m = z.max(axis=1)
    lse = m + np.log(np.exp(z - m[:, None]).sum(axis=1))
    ok = (lbl >= 0) & (lbl < z.shape[1])
    zl = np.where(ok, z[np.arange(len(lbl)), np.clip(lbl, 0, None)
                        % z.shape[1]], np.float32(vk.NEG))
    return lse, zl, z.sum(axis=1)


@pytest.mark.parametrize("passes,meets", [
    (1, {"lse": True, "z_label": False, "z_sum": False}),
    (3, {"lse": True, "z_label": True, "z_sum": True})])
def test_error_budget_of_the_tensor_core_forward(passes, meets):
    """The forward kernel's z emulated as TF32 tensor-core passes over its
    32-deep K-slices (each slice one accumulator, the slices added in
    float32), reduced to lse, z_label and z_sum, against the float32
    plain version at the main path's D = 512: 3xTF32 keeps all three
    within TOL_VOCAB; one pass misses it for z_label and z_sum (about
    10x), and only the lse, whose logsumexp averages the logits' errors,
    stays inside."""
    n, d, v = 64, 512, 700
    rng = np.random.RandomState(1)
    h = rng.randn(n, d).astype(np.float32)
    w = (rng.randn(d, v) * 0.05).astype(np.float32)
    lbl = rng.randint(0, v, n).astype(np.int32)
    lbl[:2] = (-1, v + 3)                 # select no logit
    want = vk.vocab_ce_fwd_plain(torch.as_tensor(h), torch.as_tensor(w),
                                 torch.as_tensor(lbl))
    got = _fwd_stats(tc_matmul_tiled(h, w, passes, depth=32), lbl)
    for name, a, b in zip(("lse", "z_label", "z_sum"), got, want):
        b = b.numpy().astype(np.float64)
        if name == "z_label":           # the NEG rows match exactly
            assert (a[:2] == b[:2]).all()
            a, b = a[2:], b[2:]
        assert _within(a, b) == meets[name], (name,
                                              float(np.abs(a - b).max()))


def test_tensor_core_bound_is_three_tf32_passes():
    b = vk.tensor_core_bound_ms(16384, 512, 32000)
    assert b["dh"] == b["dw"] == pytest.approx(6.507, abs=1e-3)
    assert b["fwd"] == pytest.approx(3.254, abs=1e-3)
    assert b["fwd"] * 2 == pytest.approx(b["dh"])


def test_plain_versions_select_no_logit_for_a_label_out_of_range():
    """The label the op's composition route hands the kernels for a bad
    label (-1): no z_label (NEG, as the kernels' kNeg) and no one-hot."""
    h, w, lbl = _inputs(5, 8, 12, seed=3)
    th, tw = torch.as_tensor(h), torch.as_tensor(w)
    tl = torch.as_tensor(lbl).to(torch.int32)
    tl[1] = -1
    lse, zl, _ = vk.vocab_ce_fwd_plain(th, tw, tl)
    assert float(zl[1]) == float(torch.tensor(vk.NEG))    # float32 NEG
    assert torch.isfinite(zl[[0, 2, 3, 4]]).all()
    g = torch.ones(5)
    dh, dw = vk.vocab_ce_bwd_plain(th, tw, tl, lse, g, 0.1)
    p = torch.softmax(th @ tw, -1) - 0.1 / 12
    np.testing.assert_allclose(dh[1].numpy(), (p[1] @ tw.t()).numpy(),
                               **GRAD_TOL)
