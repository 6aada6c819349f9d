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
