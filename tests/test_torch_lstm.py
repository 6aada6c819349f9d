"""The port's fused LSTM recurrence against the JAX package's.

On the CPU the port's `fused_lstm` runs the plain versions of its CUDA
kernels (`lstm_fwd_plain`, `lstm_bwd_plain` behind `LSTMFn`); the
reference runs its Pallas kernels through the interpreter
(`use_pallas=True`), as tests/test_pallas_recurrence.py runs them.  The
same numpy inputs go through both; the tolerances are that file's own
(forward rtol 2e-5 / atol 2e-6, gradients rtol 3e-5 / atol 3e-6: float32
on both sides, sums over H and T in another order).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops.pallas import recurrence as ref_rec
from paddle_tpu_torch.ops import kernels
from paddle_tpu_torch.ops.kernels import lstm as lk
from torch_op_test import (ref_op_grads, run_ref_op_all, run_torch_op_all,
                           torch_op_grads)
from torch_tf32 import tc_matmul_tiled

N, T, H = 3, 10, 4      # T deliberately not a multiple of the TPU time block
SLOTS = ("Hidden", "Cell", "LastH", "LastC")
FWD_TOL = dict(rtol=2e-5, atol=2e-6)
GRAD_TOL = dict(rtol=3e-5, atol=3e-6)


def lstm_ins(seed=0, with_states=False, with_seq_len=False,
             peephole_bias=False, lengths=(T, T - 4, 3)):
    r = np.random.RandomState(seed)
    h4 = 4 * H
    ins = {
        "Input": (r.randn(N, T, h4) * 0.3).astype(np.float32),
        "Weight": (r.randn(H, h4) * 0.3).astype(np.float32),
        "Bias": (r.randn(1, 7 * H if peephole_bias else h4)
                 * 0.3).astype(np.float32),
    }
    if with_states:
        ins["H0"] = (r.randn(N, H) * 0.3).astype(np.float32)
        ins["C0"] = (r.randn(N, H) * 0.3).astype(np.float32)
    if with_seq_len:
        ins["SeqLen"] = np.array(lengths, np.int32)
    return ins


@pytest.mark.parametrize("with_states", [False, True])
@pytest.mark.parametrize("with_seq_len", [False, True])
@pytest.mark.parametrize("is_reverse", [False, True])
def test_forward_matches_reference_kernel(with_states, with_seq_len,
                                          is_reverse):
    ins = lstm_ins(7, with_states, with_seq_len)
    attrs = {"use_peepholes": False, "is_reverse": is_reverse,
             "use_pallas": True}
    kernels.reset_counts()
    got = run_torch_op_all("dynamic_lstm", ins, attrs)
    assert kernels.counts()["plain"]["lstm_fwd"] == 1
    assert kernels.counts()["composed"]["dynamic_lstm"] == 0
    ref = run_ref_op_all("dynamic_lstm", ins, attrs)
    for slot in SLOTS:
        np.testing.assert_allclose(got[slot], ref[slot], **FWD_TOL,
                                   err_msg=slot)


def test_default_configuration_takes_the_fused_route_without_use_pallas():
    """Attrs serialize, the configuration routes: no peepholes and the
    default activations reach fused_lstm whatever use_pallas says, and
    agree with the reference's scan path."""
    ins = lstm_ins(8, True, True)
    attrs = {"use_peepholes": False, "is_reverse": True}
    kernels.reset_counts()
    got = run_torch_op_all("dynamic_lstm", ins, attrs)
    assert kernels.counts()["plain"]["lstm_fwd"] == 1
    ref = run_ref_op_all("dynamic_lstm", ins, attrs)
    for slot in SLOTS:
        np.testing.assert_allclose(got[slot], ref[slot], **FWD_TOL,
                                   err_msg=slot)


@pytest.mark.parametrize("with_seq_len", [False, True])
@pytest.mark.parametrize("is_reverse", [False, True])
def test_grad_matches_reference_kernel(with_seq_len, is_reverse):
    """torch autograd through LSTMFn (its backward is lstm_bwd_plain)
    against jax.grad through the reference's custom VJP, under a loss
    that weights Hidden, Cell and both last states."""
    ins = lstm_ins(11, True, with_seq_len)
    attrs = {"use_peepholes": False, "is_reverse": is_reverse,
             "use_pallas": True}
    slots = ["Input", "Weight", "Bias", "H0", "C0"]
    kernels.reset_counts()
    got = torch_op_grads("dynamic_lstm", ins, attrs, slots, SLOTS)
    assert kernels.counts()["plain"]["lstm_bwd"] == 1
    ref = ref_op_grads("dynamic_lstm", ins, attrs, slots, SLOTS)
    for slot in slots:
        np.testing.assert_allclose(got[slot], ref[slot], **GRAD_TOL,
                                   err_msg=f"d{slot}")


def _time_major_case(seed, rev, dtype=torch.float32, lengths=(T, 0, 3)):
    r = np.random.RandomState(seed)

    def t(*shape):
        return torch.as_tensor(r.randn(*shape) * 0.3).to(dtype)

    xs, w, h0, c0 = t(T, N, 4 * H), t(H, 4 * H), t(N, H), t(N, H)
    sl = torch.as_tensor(np.array(lengths, np.int32))
    return xs, w, h0, c0, sl, rev


@pytest.mark.parametrize("rev", [False, True])
def test_bwd_plain_matches_autograd_of_fwd_plain(rev):
    """The hand-derived backward against torch autograd of the plain
    forward, in float64, with a length-0 row."""
    xs, w, h0, c0, sl, _ = _time_major_case(3, rev, torch.float64)
    leaves = [x.requires_grad_() for x in (xs, w, h0, c0)]
    hs, cs = lk.lstm_fwd_plain(*leaves, sl, rev)
    r = np.random.RandomState(4)
    dhs = torch.as_tensor(r.randn(*hs.shape))
    dcs = torch.as_tensor(r.randn(*cs.shape))
    want = torch.autograd.grad((hs * dhs).sum() + (cs * dcs).sum(), leaves)
    with torch.no_grad():
        got = lk.lstm_bwd_plain(xs, w, h0, c0, sl, hs, cs, dhs, dcs, rev)
    for name, a, b in zip(("dxs", "dw", "dh0", "dc0"), got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-10,
                                   atol=1e-12, err_msg=name)


def test_length_zero_row_keeps_its_initial_state():
    ins = lstm_ins(5, True, True, lengths=(T, 0, 1))
    attrs = {"use_peepholes": False, "use_pallas": True}
    got = run_torch_op_all("dynamic_lstm", ins, attrs)
    ref = run_ref_op_all("dynamic_lstm", ins, attrs)
    np.testing.assert_array_equal(got["LastH"][1], ins["H0"][1])
    np.testing.assert_array_equal(got["LastC"][1], ins["C0"][1])
    np.testing.assert_array_equal(
        got["Hidden"][1], np.broadcast_to(ins["H0"][1], (T, H)))
    for slot in SLOTS:
        np.testing.assert_allclose(got[slot], ref[slot], **FWD_TOL,
                                   err_msg=slot)


def test_gradcheck_float64():
    xs, w, h0, c0, sl, rev = _time_major_case(6, True, torch.float64,
                                              lengths=(4, 2, 0))
    xs = xs[:4]
    leaves = [x.clone().requires_grad_() for x in (xs, w, h0, c0)]
    assert torch.autograd.gradcheck(
        lambda a, b, c, d: lk.LSTMFn.apply(a, b, c, d, sl, rev), leaves,
        eps=1e-6, atol=1e-7, rtol=1e-6)


# -- the loud rejections ---------------------------------------------------

def test_rejects_peepholes_loudly():
    ins = lstm_ins(3, peephole_bias=True)
    with pytest.raises(ValueError, match="peephole"):
        run_torch_op_all("dynamic_lstm", ins, {"use_peepholes": True,
                                               "use_pallas": True})


def test_rejects_nonstandard_activations_loudly():
    with pytest.raises(ValueError, match="activation"):
        run_torch_op_all("dynamic_lstm", lstm_ins(4),
                         {"use_peepholes": False, "use_pallas": True,
                          "gate_activation": "relu"})


@pytest.mark.parametrize("use_pallas", [False, True])
def test_rejects_nested_lod2_loudly(use_pallas):
    ins = lstm_ins(5)
    ins["SeqLen"] = np.array([T, T, T], np.int32)
    ins["SeqLen2"] = np.full((N, T), 1, np.int32)
    with pytest.raises(NotImplementedError, match="nested"):
        run_torch_op_all("dynamic_lstm", ins, {"use_peepholes": False,
                                               "use_pallas": use_pallas})


def test_fused_lstm_direct_rejections_match_the_reference():
    x = np.zeros((2, 4, 4 * H), np.float32)
    w = np.zeros((H, 4 * H), np.float32)
    cases = [(dict(use_peepholes=True), "peephole", x),
             (dict(cell_activation="relu"), "activation", x),
             ({}, "4\\*H", np.zeros((2, 4, 13), np.float32))]
    for kw, match, xx in cases:
        with pytest.raises(ValueError, match=match):
            lk.fused_lstm(torch.as_tensor(xx), torch.as_tensor(w), **kw)
        with pytest.raises(ValueError, match=match):
            ref_rec.fused_lstm(jnp.asarray(xx), jnp.asarray(w), **kw)


def test_kernel_wrapper_limits():
    """What the CUDA route refuses, checked without a card: the wrapper's
    own checks run before any launch."""
    xs, w, h0, c0, sl, _ = _time_major_case(1, False)
    with pytest.raises(NotImplementedError, match="queue B"):
        lk._check_kernel(xs.bfloat16(), w.bfloat16(), h0.bfloat16(),
                         c0.bfloat16(), sl)
    with pytest.raises(TypeError, match="int32"):
        lk._check_kernel(xs, w, h0, c0, sl.long())
    wide = torch.zeros(2, 3, 4 * 516)
    with pytest.raises(ValueError, match="at most 512"):
        lk._check_kernel(wide, torch.zeros(516, 4 * 516),
                         torch.zeros(3, 516), torch.zeros(3, 516),
                         torch.zeros(3, dtype=torch.int32))
    with pytest.raises(ValueError, match="multiple of 4"):
        lk._check_kernel(torch.zeros(2, 3, 24), torch.zeros(6, 24),
                         torch.zeros(3, 6), torch.zeros(3, 6),
                         torch.zeros(3, dtype=torch.int32))
    with pytest.raises(ValueError, match="want"):
        lk.lstm_fwd(xs, w[:, :-1], h0, c0, sl)


def test_bounds_at_the_bench_shape():
    b = lk.bound_bytes_and_flops(128, 128, 512)
    assert b["fwd"][1] == 2 * 128 * 128 * 512 * 2048
    assert b["bwd"][1] == 3 * b["fwd"][1]
    # xs 134 MB + hs, cs 67 MB + W 4 MB; backward ~411 MB
    assert 205e6 < b["fwd"][0] < 207e6
    assert 410e6 < b["bwd"][0] < 413e6


def test_kernel_source_computes_its_own_products():
    """The recurrence's three products are the kernel's own code: the
    CUDA source calls no library, and the wrapper's CUDA route reaches no
    torch product (only the plain versions call torch.matmul)."""
    import inspect
    from pathlib import Path

    src = (Path(lk.__file__).resolve().parents[2] / "csrc" /
           "lstm.cu").read_text()
    for banned in ("cublas", "cudnn", "cutlass"):
        assert banned not in src.lower(), banned
    assert "lstm_fwd_kernel" in src and "lstm_bwd_kernel" in src
    assert "grid.sync()" in src and "__ldcg" in src
    for fn in (lk.lstm_fwd, lk.lstm_bwd, lk.LSTMFn.forward,
               lk.LSTMFn.backward, lk.fused_lstm):
        code = inspect.getsource(fn)
        assert "matmul" not in code and "nn.LSTM" not in code \
            and "compile" not in code, fn.__name__


# -- the composed route ----------------------------------------------------

@pytest.mark.parametrize("attrs", [
    {"use_peepholes": True},
    {"use_peepholes": True, "is_reverse": True},
    {"use_peepholes": False, "gate_activation": "relu"},
    {"use_peepholes": False, "cell_activation": "identity",
     "candidate_activation": "relu", "is_reverse": True},
], ids=["peepholes", "peepholes-reverse", "relu-gate", "other-acts"])
def test_composed_route_matches_reference_scan(attrs):
    ins = lstm_ins(9, True, True, peephole_bias=attrs["use_peepholes"])
    kernels.reset_counts()
    got = run_torch_op_all("dynamic_lstm", ins, attrs)
    c = kernels.counts()
    assert c["composed"]["dynamic_lstm"] == 1 and \
        c["plain"]["lstm_fwd"] == 0
    ref = run_ref_op_all("dynamic_lstm", ins, attrs)
    for slot in SLOTS:
        np.testing.assert_allclose(got[slot], ref[slot], **FWD_TOL,
                                   err_msg=slot)
    slots = ["Input", "Weight", "Bias", "H0", "C0"]
    g = torch_op_grads("dynamic_lstm", ins, attrs, slots, SLOTS)
    r = ref_op_grads("dynamic_lstm", ins, attrs, slots, SLOTS)
    for slot in slots:
        np.testing.assert_allclose(g[slot], r[slot], **GRAD_TOL,
                                   err_msg=f"d{slot}")


# -- why the kernels split 3xTF32 (csrc/lstm.cu) --------------------------

TOL_LSTM = 1e-4     # chip_smoke.py phase 3d: the kernels against plain
UNITS_PER_BWD_BLOCK = 8     # csrc/lstm.cu kBUnits


def _within(got, want, tol=TOL_LSTM):
    """chip_smoke.check_close's test: tol absolute plus tol of max|want|."""
    return float(np.abs(got - want).max()) <= tol + tol * float(
        np.abs(want).max())


def _block_columns(b, h):
    """The gate columns of backward block b's 8 units, in the kernel's
    order (csrc/lstm.cu gate_col: column c holds gate 2((c >> 3) & 1) +
    (c & 1) of unit 4(c >> 4) + ((c & 7) >> 1)); units past H dropped."""
    cols = []
    for c in range(4 * UNITS_PER_BWD_BLOCK):
        q, u = 2 * ((c >> 3) & 1) + (c & 1), 4 * (c >> 4) + ((c & 7) >> 1)
        if UNITS_PER_BWD_BLOCK * b + u < h:
            cols.append(q * h + UNITS_PER_BWD_BLOCK * b + u)
    return np.array(cols)


def _partials_in_kernel_order(dg, w, matmul):
    """dh = dg W^T as the kernel forms it: each block's partial
    dg[:, cols_b] W[:, cols_b]^T, then, per row, lane q sums the
    partials of blocks q, q + 4, .. in order and the four lanes meet as
    (s0 + s1) + (s2 + s3), in float32."""
    h = w.shape[0]
    parts = [matmul(dg[:, c], w[:, c].T) for c in
             (_block_columns(b, h) for b in range(-(-h // 8)))]
    lanes = []
    for q in range(4):
        s = np.zeros((dg.shape[0], h), np.float32)
        for p in parts[q::4]:
            s = s + p
        lanes.append(s)
    return (lanes[0] + lanes[1]) + (lanes[2] + lanes[3])


@pytest.mark.parametrize("h", [24, 64, 132])
def test_partial_dh_in_fixed_order_is_dg_wt(h):
    """The fixed-order sum of the blocks' partial dh equals dg W^T: every
    gate column lies in exactly one block, and the order of the float32
    sum is fixed, so two evaluations give the same bits."""
    r = np.random.RandomState(h)
    dg = r.randn(9, 4 * h).astype(np.float32)
    w = r.randn(h, 4 * h).astype(np.float32)
    cols = np.concatenate([_block_columns(b, h) for b in range(-(-h // 8))])
    assert sorted(cols) == list(range(4 * h))
    f64 = (lambda a, b: (a.astype(np.float64) @ b.astype(np.float64))
           .astype(np.float32))
    got = _partials_in_kernel_order(dg, w, f64)
    want = dg.astype(np.float64) @ w.T.astype(np.float64)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert np.array_equal(got, _partials_in_kernel_order(dg, w, f64))


def _kernel_bwd(xs, w, h0, c0, sl, hs, cs, dhs, dcs, passes):
    """The backward kernel's arithmetic in numpy float32, each product
    emulated as TF32 tensor-core passes with the kernel's accumulators:
    the gate recompute over two halves of H in 64-deep slices, dW per
    64-row tile added to one of two row groups' float32 sums, the partial
    dh per block of 8 units summed in the kernel's order."""
    t_len, n, g4 = xs.shape
    h = g4 // 4
    half = -(-(-(-h // 32) * 32 // 8) // 2) * 8       # depth of a half

    def tc(a, b, depth=64):
        return tc_matmul_tiled(a, b, passes, depth)

    sig = (lambda v: np.float32(1) / (np.float32(1) + np.exp(-v)))
    dh = np.zeros((n, h), np.float32)
    dc = np.zeros((n, h), np.float32)
    dw = np.zeros((2, h, g4), np.float32)
    dxs = np.zeros_like(xs)
    for t in range(t_len - 1, -1, -1):
        hp = hs[t - 1] if t else h0
        cp = cs[t - 1] if t else c0
        pre = xs[t] + (tc(hp[:, :half], w[:half]) +
                       tc(hp[:, half:], w[half:]))
        ca, ig = np.tanh(pre[:, :h]), sig(pre[:, h:2 * h])
        fg, og = sig(pre[:, 2 * h:3 * h]), sig(pre[:, 3 * h:])
        tc_ = np.tanh(fg * cp + ig * ca)
        dh_tot, dc_pass = dhs[t] + dh, dcs[t] + dc
        dc_tot = dc_pass + dh_tot * og * (1 - tc_ * tc_)
        dg = np.concatenate([(dc_tot * ig) * (1 - ca * ca),
                             (dc_tot * ca) * ig * (1 - ig),
                             (dc_tot * cp) * fg * (1 - fg),
                             (dh_tot * tc_) * og * (1 - og)], axis=1)
        ok = (t < sl)[:, None]
        dg = np.where(ok, dg, np.float32(0))
        dxs[t] = dg
        for r0 in range(0, n, 64):
            dw[(r0 // 64) % 2] += tc(hp[r0:r0 + 64].T, dg[r0:r0 + 64])
        dh = np.where(ok, _partials_in_kernel_order(
            dg, w, lambda a, b: tc(a, b, depth=32)), dh_tot)
        dc = np.where(ok, dc_tot * fg, dc_pass)
    return dxs, dw[0] + dw[1], dh, dc


@pytest.mark.parametrize("passes,meets", [(1, False), (3, True)])
def test_error_budget_of_the_tensor_core_backward(passes, meets):
    """The backward kernel's three products (the gate recompute, dW and
    the partial dh) emulated as TF32 tensor-core passes over a 40-step
    recurrence, against the float64 plain backward on the same float32
    inputs: 3xTF32 keeps dxs, dW, dh0 and dc0 within TOL_LSTM (at about
    1/500 of it); one pass misses it for dW, whose sums run over all T
    and N (about 2x), and uses a quarter to four fifths of it for the
    others."""
    t_len, n, h = 40, 70, 64
    r = np.random.RandomState(5)

    def f(*shape, scale):
        return (r.randn(*shape) * scale).astype(np.float32)

    xs, w = f(t_len, n, 4 * h, scale=0.5), f(h, 4 * h, scale=h ** -0.5)
    h0, c0 = f(n, h, scale=0.3), f(n, h, scale=0.3)
    sl = r.randint(t_len // 2, t_len + 1, n).astype(np.int32)
    sl[0] = 0
    dhs, dcs = f(t_len, n, h, scale=1.0), f(t_len, n, h, scale=1.0)
    as64 = (lambda *a: [torch.as_tensor(x, dtype=torch.float64) for x in a])
    hs, cs = lk.lstm_fwd_plain(*as64(xs, w, h0, c0), torch.as_tensor(sl))
    hs, cs = hs.numpy().astype(np.float32), cs.numpy().astype(np.float32)
    want = lk.lstm_bwd_plain(*as64(xs, w, h0, c0), torch.as_tensor(sl),
                             *as64(hs, cs, dhs, dcs))
    got = _kernel_bwd(xs, w, h0, c0, sl, hs, cs, dhs, dcs, passes)
    within = {name: _within(a, b.numpy()) for name, a, b in
              zip(("dxs", "dw", "dh0", "dc0"), got, want)}
    if meets:
        assert all(within.values()), within
    else:
        assert not within["dw"], within


def _kernel_fwd(xs, w, h0, c0, sl, rev, passes):
    """The forward kernel's arithmetic in numpy float32: the gate product
    emulated as TF32 tensor-core passes with the kernel's accumulators
    (each half of the depth in 64-deep K-slices added in float32, then
    the halves summed and added to xs[t]), the cell update thread-local,
    frozen rows keeping (h, c)."""
    t_len, n, g4 = xs.shape
    h = g4 // 4
    half = -(-(-(-h // 32) * 32 // 8) // 2) * 8       # depth of a half
    sig = (lambda v: np.float32(1) / (np.float32(1) + np.exp(-v)))
    hc, cc, hs, cs = h0, c0, [], []
    for t in range(t_len):
        pre = xs[t] + (tc_matmul_tiled(hc[:, :half], w[:half], passes) +
                       tc_matmul_tiled(hc[:, half:], w[half:], passes))
        ca, ig = np.tanh(pre[:, :h]), sig(pre[:, h:2 * h])
        fg, og = sig(pre[:, 2 * h:3 * h]), sig(pre[:, 3 * h:])
        c_new = fg * cc + ig * ca
        h_new = og * np.tanh(c_new)
        ok = ((t_len - 1 - t if rev else t) < sl)[:, None]
        hc, cc = np.where(ok, h_new, hc), np.where(ok, c_new, cc)
        hs.append(hc)
        cs.append(cc)
    return np.stack(hs), np.stack(cs)


def _budget_used(got, want, tol=TOL_LSTM):
    """|got - want| as a share of chip_smoke's allowance, tol absolute
    plus tol of max |want|."""
    return float(np.abs(got - want).max()) / (tol + tol * float(
        np.abs(want).max()))


@pytest.mark.parametrize("rev", [False, True])
def test_error_budget_of_the_tensor_core_forward(rev):
    """The forward kernel's gate product emulated as TF32 tensor-core
    passes over a 40-step recurrence at H = 512 (ragged lengths, a row
    that never steps and one that steps once), against the float64
    plain forward on the same float32 inputs: 3xTF32 keeps hs and cs
    within TOL_LSTM at under a hundredth of it (about 1/1500 found);
    one pass used 53-99% of it here (cs the most), and the error grows
    with T."""
    t_len, n, h = 40, 24, 512
    r = np.random.RandomState(11)

    def f(*shape, scale):
        return (r.randn(*shape) * scale).astype(np.float32)

    xs, w = f(t_len, n, 4 * h, scale=0.5), f(h, 4 * h, scale=h ** -0.5)
    h0, c0 = f(n, h, scale=0.3), f(n, h, scale=0.3)
    sl = r.randint(t_len // 2, t_len + 1, n).astype(np.int32)
    sl[:2] = 0, 1
    want = [x.numpy() for x in lk.lstm_fwd_plain(
        *(torch.as_tensor(x, dtype=torch.float64) for x in (xs, w, h0, c0)),
        torch.as_tensor(sl), rev)]
    three = [_budget_used(a, b) for a, b in
             zip(_kernel_fwd(xs, w, h0, c0, sl, rev, 3), want)]
    one = [_budget_used(a, b) for a, b in
           zip(_kernel_fwd(xs, w, h0, c0, sl, rev, 1), want)]
    assert max(three) < 0.01, three
    assert one[1] > 0.25 and min(one) > 30 * max(three), (one, three)


def test_tensor_core_bound_of_the_forward():
    """3 TF32 passes of 2*T*N*H*4H operations at 495 TFLOP/s: 0.208 ms at
    the main path's T = N = 128, H = 512, a third of the backward's."""
    tc = lk.tensor_core_bound_ms(128, 128, 512)
    assert tc["fwd"] == pytest.approx(0.2082, abs=1e-4)
    assert tc["bwd"] / tc["fwd"] == pytest.approx(3.0)


def test_tensor_core_bound_of_the_backward():
    """3 TF32 passes of 6*T*N*H*4H operations at 495 TFLOP/s: 0.62 ms at
    the main path's T = N = 128, H = 512, 2.5x under the float32 bound."""
    tc = lk.tensor_core_bound_ms(128, 128, 512)["bwd"]
    assert tc == pytest.approx(0.6247, abs=1e-4)
    f32 = lk.bound_bytes_and_flops(128, 128, 512)["bwd"][1] / \
        kernels.F32_FLOP_PER_S * 1e3
    assert f32 / tc == pytest.approx(495 / 67 / 3)


@pytest.mark.parametrize("n,h,mb", [(128, 512, 40.0), (300, 512, 83.0),
                                    (5, 4, 2 * 1 * 5 * 8 * 4 / 2 ** 20
                                     + 2 * 4 * 32 * 4 / 2 ** 20)])
def test_backward_scratch_size(n, h, mb):
    """The backward kernel's scratch: two parity buffers of partial dh,
    [U][U][N][8] with U = ceil(H / 8), and the two row groups' partial dW,
    [2][U][H][32], in float32."""
    assert lk.scratch_floats(n, h) * 4 / 2 ** 20 == pytest.approx(mb,
                                                                   rel=1e-3)
