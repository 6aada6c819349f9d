"""Faults of the port against the reference, repaired (ROADMAP C3-C6):
the port's op and the JAX package's op on the same numpy inputs
(`run_torch_op_all` / `run_ref_op_all`), NaN included.

- C3: an out-of-range class label or id gives NaN, as jnp's gather
  does (a negative one wraps once first), and never reaches an index op;
- C4: fused_vocab_softmax_ce follows the label semantics of the route
  its `use_pallas` attr names;
- C5: top_k puts the lower index first among equal values;
- C6: on the card, what a kernel does not take goes, with `use_pallas`
  false, to the op's counted composed route.  Here the card is stood in
  for by `kernels.on_card`; the routes run on the card in chip_smoke.py's
  phase 3e.

Tolerances: 1e-5 (abs and rel) where both sides run the same float32
formula in another summation order or libm; 2e-5 for the vocab-CE
losses and 2e-4 relative plus 2e-5 absolute for their gradients, as
tests/test_torch_vocab_ce.py holds them.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops import kernels
from paddle_tpu_torch.ops.kernels import flash_attention as fk
from paddle_tpu_torch.ops.kernels import lstm as lk
from paddle_tpu_torch.ops.kernels import paged_attention as pk
from paddle_tpu_torch.ops.kernels import vocab_ce as vk

from torch_op_test import (ref_op_grads, run_ref_op_all, run_torch_op_all,
                           torch_op_grads)

torch.set_num_threads(2)

TOL = dict(rtol=1e-5, atol=1e-5, equal_nan=True)
LOSS_TOL = dict(rtol=2e-5, atol=2e-5, equal_nan=True)
GRAD_TOL = dict(rtol=2e-4, atol=2e-5)


def _same(op, ins, attrs, slots):
    got = run_torch_op_all(op, ins, attrs)
    want = run_ref_op_all(op, ins, attrs)
    for s in slots:
        assert got[s].shape == want[s].shape, s
        np.testing.assert_allclose(got[s], want[s], err_msg=s, **TOL)
    return got, want


# -- C3: out-of-range labels and ids --------------------------------------

C = 5
LABELS = np.array([[0], [4], [C], [C + 2], [-1], [-C - 1]], np.int64)


@pytest.mark.parametrize("attrs", [{}, {"ignore_index": -1},
                                   {"label_smooth_eps": 0.1},
                                   {"ignore_index": C + 2,
                                    "label_smooth_eps": 0.1}])
def test_softmax_ce_out_of_range_labels_give_nan(attrs):
    logits = np.random.RandomState(0).randn(6, C).astype(np.float32)
    got, _ = _same("softmax_with_cross_entropy",
                   {"Logits": logits, "Label": LABELS}, attrs,
                   ("Loss", "Softmax"))
    loss = got["Loss"].ravel()
    ignore = attrs.get("ignore_index", -100)
    for i, lbl in enumerate(LABELS.ravel()):
        # ignore_index wins over the NaN; -1 wraps to class C-1
        if lbl == ignore:
            assert loss[i] == 0.0
        else:
            assert np.isnan(loss[i]) == (not -C <= lbl < C), (i, lbl)


@pytest.mark.parametrize("attrs", [{}, {"ignore_index": C}])
def test_cross_entropy_out_of_range_labels_give_nan(attrs):
    x = np.abs(np.random.RandomState(1).randn(6, C)).astype(np.float32)
    x /= x.sum(axis=1, keepdims=True)
    got, _ = _same("cross_entropy", {"X": x, "Label": LABELS}, attrs,
                   ("Y",))
    assert np.isnan(got["Y"]).sum() == (3 if not attrs else 2)


@pytest.mark.parametrize("ids,padding_idx", [
    (np.array([[0], [3], [4], [-1], [-5], [2], [7]], np.int64), 2),
    (np.array([0, 3, 4, -1, -5, 2], np.int32), -1),
    (np.array([[1, 9], [-4, 0]], np.int64), 0),
])
def test_lookup_table_out_of_range_ids_give_nan_rows(ids, padding_idx):
    w = np.random.RandomState(2).randn(4, 3).astype(np.float32)
    got, _ = _same("lookup_table", {"W": w, "Ids": ids},
                   {"padding_idx": padding_idx}, ("Out",))
    flat = ids.reshape(got["Out"].shape[:-1])
    bad = (flat >= 4) | (flat < -4)
    assert np.isnan(got["Out"][bad]).all()
    assert not np.isnan(got["Out"][~bad]).any()
    if padding_idx >= 0:                    # -1: no padding row
        assert (got["Out"][flat == padding_idx] == 0).all()


def test_batched_gather_out_of_range_index_gives_nan():
    x = np.random.RandomState(3).randn(2, 4, 3).astype(np.float32)
    index = np.array([[0, 4, -1], [3, -5, 1]], np.int32)
    got, _ = _same("batched_gather", {"X": x, "Index": index}, {},
                   ("Out",))
    assert np.isnan(got["Out"][:, 1]).all()
    assert not np.isnan(got["Out"][:, [0, 2]]).any()


# -- C4: the fused vocab CE's label semantics follow use_pallas -----------

def _vocab_ins(n=8, d=8, v=20, seed=11):
    rng = np.random.RandomState(seed)
    lbl = rng.randint(0, v, size=n).astype(np.int64)
    lbl[-4:] = [v + 2, -v - 1, v, -1]
    return {"Hidden": rng.randn(n, d).astype(np.float32),
            "W": (rng.randn(d, v) * 0.1).astype(np.float32), "Label": lbl}


def test_fused_vocab_ce_without_pallas_wraps_and_fills_labels():
    """The reference composition: -1 is V-1, labels outside [-V, V) give
    NaN (the re-anchor's case: ref [..., nan, 4.4965], port clamped)."""
    ins = _vocab_ins()
    attrs = {"epsilon": 0.1, "use_pallas": False}
    got = run_torch_op_all("fused_vocab_softmax_ce", ins, attrs)["Loss"]
    want = run_ref_op_all("fused_vocab_softmax_ce", ins, attrs)["Loss"]
    np.testing.assert_allclose(got, want, **LOSS_TOL)
    assert np.isnan(got[-4:-1]).all()
    assert np.isfinite(got[:-4]).all() and np.isfinite(got[-1])
    wrapped = dict(ins, Label=np.where(ins["Label"] == -1, 19,
                                       ins["Label"]))
    np.testing.assert_allclose(
        got[-1], run_ref_op_all("fused_vocab_softmax_ce", wrapped,
                                attrs)["Loss"][-1], **LOSS_TOL)


def test_fused_vocab_ce_without_pallas_gradients_match():
    """Gradients of the composition route, rows with bad labels included:
    their label selects no logit on both sides."""
    ins = _vocab_ins(seed=12)
    attrs = {"epsilon": 0.1}
    got = torch_op_grads("fused_vocab_softmax_ce", ins, attrs,
                         ("Hidden", "W"), ("Loss",))
    want = ref_op_grads("fused_vocab_softmax_ce", ins, attrs,
                        ("Hidden", "W"), ("Loss",))
    for s in ("Hidden", "W"):
        assert np.isfinite(got[s]).all(), s
        np.testing.assert_allclose(got[s], want[s], err_msg=s, **GRAD_TOL)


def test_fused_vocab_ce_with_pallas_clamps_labels():
    ins = _vocab_ins(seed=13)
    attrs = {"epsilon": 0.1, "use_pallas": True}
    got = run_torch_op_all("fused_vocab_softmax_ce", ins, attrs)["Loss"]
    want = run_ref_op_all("fused_vocab_softmax_ce", ins, attrs)["Loss"]
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, **LOSS_TOL)


# -- C5: top_k ties --------------------------------------------------------

def test_top_k_ties_put_the_lower_index_first():
    x = np.array([[1, 1, 1, 0, 2]], np.float32)
    got, _ = _same("top_k", {"X": x}, {"k": 3}, ("Out", "Indices"))
    assert got["Indices"].tolist() == [[4, 0, 1]]


def test_top_k_ties_on_a_grid_of_few_values():
    x = np.random.RandomState(4).randint(0, 3, (7, 2, 9)).astype(np.float32)
    _same("top_k", {"X": x}, {"k": 4}, ("Out", "Indices"))


def test_accuracy_with_ties_straddling_k():
    x = np.array([[1, 1, 1, 0, 2], [3, 3, 0, 3, 1], [0, 5, 5, 5, 5]],
                 np.float32)
    label = np.array([[1], [3], [1]], np.int64)
    for k, correct in ((2, 1), (3, 3)):
        idx = {}
        for side, run in (("port", run_torch_op_all),
                          ("ref", run_ref_op_all)):
            idx[side] = run("top_k", {"X": x}, {"k": k})["Indices"]
            acc = run("accuracy", {"Out": x[:, :k], "Indices": idx[side],
                                   "Label": label}, {})
            idx[side + "_acc"] = (float(acc["Accuracy"][0]),
                                  int(acc["Correct"][0]))
        np.testing.assert_array_equal(idx["port"], idx["ref"])
        assert idx["port_acc"] == idx["ref_acc"], k
        # k = 2 cuts through the ties of rows 0 and 1, and both miss
        assert idx["port_acc"][1] == correct, k


# -- C6: what the kernels do not take -------------------------------------

def test_kernel_predicates_on_shapes_and_dtypes():
    def t(*shape, dtype=torch.float32):
        return torch.zeros(*shape, dtype=dtype)

    q = t(1, 2, 4, 64)
    assert fk.kernel_takes(q, q, q, 64) and fk.kernel_takes(q, q, q, 32)
    assert fk.kernel_takes(q, q, q, 128)
    assert not fk.kernel_takes(q, q, q, 96)
    assert not fk.kernel_takes(q.double(), q.double(), q.double(), 64)
    assert not fk.kernel_takes(q.bfloat16(), q, q, 64)
    qb = q.bfloat16()
    for d in (32, 64, 128):
        assert fk.kernel_takes(qb, qb, qb, d), d
    assert not fk.kernel_takes(qb, qb, qb, 96)
    assert not fk.kernel_takes(qb, qb, q, 64)
    assert not fk.kernel_takes(q.half(), q.half(), q.half(), 64)

    assert vk.kernel_takes(t(4, 512), t(512, 9))
    assert not vk.kernel_takes(t(4, 513), t(513, 9))
    assert not vk.kernel_takes(t(4, 8).double(), t(8, 9).double())
    assert not vk.kernel_takes(t(4, 8).bfloat16(), t(8, 9))

    def lstm(h, dtype=torch.float32):
        return (t(2, 3, 4 * h, dtype=dtype), t(h, 4 * h, dtype=dtype),
                t(2, h, dtype=dtype), t(2, h, dtype=dtype))

    assert lk.kernel_takes(*lstm(512)) and lk.kernel_takes(*lstm(8))
    for h in (514, 516, 6):
        assert not lk.kernel_takes(*lstm(h)), h
    assert not lk.kernel_takes(*lstm(8, torch.float64))

    pools = t(5, 4, 2 * 96)
    assert not pk.kernel_takes(t(3, 2 * 96), pools, pools, 2)
    for d in (32, 64, 128):
        pools = t(5, 4, 2 * d)
        assert pk.kernel_takes(t(3, 2 * d), pools, pools, 2)
        assert pk.kernel_takes(t(3, 2 * d), pools.to(torch.int8),
                               pools.to(torch.int8), 2)
        assert not pk.kernel_takes(t(3, 2 * d).bfloat16(), pools, pools, 2)


def test_kernel_checks_name_the_roadmap_and_the_composed_route():
    q = torch.zeros(1, 2, 4, 96)
    with pytest.raises(ValueError, match="B.2.*use_pallas=False"):
        fk._check_kernel_operands(q, q, q, 96)
    with pytest.raises(ValueError, match="B.2.*use_pallas=False"):
        vk._check_kernel(torch.zeros(4, 768), torch.zeros(768, 9),
                         torch.zeros(4, dtype=torch.int32))
    wide = 514
    with pytest.raises(ValueError, match="B.2.*use_pallas=False"):
        lk._check_kernel(torch.zeros(2, 3, 4 * wide),
                         torch.zeros(wide, 4 * wide),
                         torch.zeros(3, wide), torch.zeros(3, wide),
                         torch.zeros(3, dtype=torch.int32))
    with pytest.raises(TypeError, match="B.3"):
        lk._check_kernel(torch.zeros(2, 3, 32).double(),
                         torch.zeros(8, 32).double(),
                         torch.zeros(3, 8).double(),
                         torch.zeros(3, 8).double(),
                         torch.zeros(3, dtype=torch.int32))


def _paged_ins(d, s=3, h=2, p=7, page=4, maxp=3, seed=5):
    rng = np.random.RandomState(seed)
    lens = np.array([0, 5, 12], np.int32)[:s]
    pt = np.zeros((s, maxp), np.int32)
    pt[1, :2] = [3, 1]
    pt[2] = [6, 0, 2]
    return {"Q": rng.randn(s, h * d).astype(np.float32),
            "KCache": rng.randn(p, page, h * d).astype(np.float32),
            "VCache": rng.randn(p, page, h * d).astype(np.float32),
            "PageTable": pt, "Lengths": lens}, {"n_head": h}


def _lstm_ins(h, n=2, t=3, seed=6):
    rng = np.random.RandomState(seed)
    return {"Input": (rng.randn(n, t, 4 * h) * 0.5).astype(np.float32),
            "Weight": (rng.randn(h, 4 * h) * h ** -0.5).astype(np.float32),
            "Bias": (rng.randn(1, 4 * h) * 0.1).astype(np.float32),
            "SeqLen": np.array([t, t - 1], np.int32)}


def _flash_ins(d, seed=7):
    rng = np.random.RandomState(seed)
    return {s: rng.randn(1, 2, 8, d).astype(np.float32)
            for s in ("Q", "K", "V")}


# each op with a shape its kernel refuses: (op, inputs, attrs, slots)
REFUSED = {
    "flash D=96": ("flash_attention", lambda: _flash_ins(96),
                   {"causal": True}, ("Out",)),
    "vocab-CE D=768": ("fused_vocab_softmax_ce",
                       lambda: _vocab_ins(n=6, d=768, v=40, seed=8),
                       {"epsilon": 0.1}, ("Loss",)),
    "LSTM H=514": ("dynamic_lstm", lambda: _lstm_ins(514), {},
                   ("Hidden", "Cell")),
    "paged D=96": ("paged_attention", lambda: _paged_ins(96)[0],
                   _paged_ins(96)[1], ("Out",)),
}


@pytest.fixture
def on_card(monkeypatch):
    """The ops see every tensor as lying on the card, so the kernels'
    limits decide their route (the CPU's plain versions take any shape)."""
    monkeypatch.setattr(kernels, "on_card", lambda t: True)


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_refused_shape_takes_the_counted_composed_route(case, on_card):
    op, make, attrs, slots = REFUSED[case]
    ins = make()
    kernels.reset_counts()
    got = run_torch_op_all(op, ins, dict(attrs, use_pallas=False))
    c = kernels.counts()
    assert c["composed"][op] == 1 and sum(c["composed"].values()) == 1
    assert not any(c["launches"].values()) and not any(c["plain"].values())
    want = run_ref_op_all(op, ins, dict(attrs, use_pallas=False))
    for s in slots:
        np.testing.assert_allclose(got[s], want[s], err_msg=s,
                                   **(LOSS_TOL if op.startswith("fused")
                                      else TOL))


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_refused_shape_with_pallas_goes_to_the_kernel(case, on_card):
    """use_pallas=True never takes the composed route: the kernel's
    wrapper gets the call (on the card it raises; here the CPU tensor
    sends it to the plain version)."""
    op, make, attrs, _ = REFUSED[case]
    kernels.reset_counts()
    run_torch_op_all(op, make(), dict(attrs, use_pallas=True))
    c = kernels.counts()
    assert not any(c["composed"].values())
    assert any(c["plain"].values())


@pytest.mark.parametrize("op,ins,attrs", [
    ("flash_attention", _flash_ins(64), {"causal": True}),
    ("fused_vocab_softmax_ce", _vocab_ins(), {"epsilon": 0.1}),
    ("dynamic_lstm", _lstm_ins(8), {}),
    ("paged_attention", *_paged_ins(64)),
])
def test_shapes_the_kernels_take_keep_the_kernel_route(op, ins, attrs,
                                                       on_card):
    kernels.reset_counts()
    run_torch_op_all(op, ins, dict(attrs, use_pallas=False))
    c = kernels.counts()
    assert not any(c["composed"].values()) and any(c["plain"].values())
