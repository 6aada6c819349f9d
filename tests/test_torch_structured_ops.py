"""The structured, CTC and metric ops of paddle_tpu_torch (ops/
structured.py: chunk_eval, edit_distance, warpctc, ctc_align,
hierarchical_sigmoid, sampling_id, precision_recall, mean_iou,
modified_huber_loss, positive_negative_pair) against the JAX package on
the same numpy inputs, at the op sweep's tolerances (float outputs
within rtol 2e-3 and atol 1e-6; integer outputs exactly), beyond the
sweep's one spec each:

- chunk_eval: IOB tags with broken-I starts, adjacent chunks of one
  type, O runs and ragged lengths, with and without excluded types
  (the three counts exact, and checked against counts made by hand);
  the layer refuses the schemes the reference refuses (IOE, IOBES);
- warpctc: repeated labels (a blank must separate them), alignments
  that cannot exist (a large finite loss, log_epsilon -1e5, where
  torch's F.ctc_loss gives inf), zero label lengths, norm_by_times, a
  blank other than 0, and the gradients; where an alignment exists the
  loss also equals F.ctc_loss's;
- edit_distance: normalized, ignored tokens, zero lengths on either
  side, against the reference and a plain Python Levenshtein;
- hierarchical_sigmoid: the default tree at 2, 6, 7 and 16 classes with
  the gradients of X, W and Bias; a custom tree (PathTable/PathCode)
  against numpy;
- the metric ops' accumulation inputs (StatesInfo, InWrongs/InCorrects/
  InMeanIou, Accumulate*Pair), weights, ids out of range;
- ctc_align without merging, with a padding value and another blank.

Then the nine `layers` wrappers of the family build the reference's
`Program.to_dict()` and give its fetches (sampling_id by range).
"""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from torch_op_test import (ref_op_grads, run_ref_op_all, run_torch_op_all,
                           torch_op_grads)

torch.set_num_threads(2)

TOL = dict(rtol=2e-3, atol=1e-6)
R = np.random.RandomState(21)


def _same(got, want, what):
    assert got.shape == want.shape, f"{what}: {got.shape} != {want.shape}"
    assert got.dtype == want.dtype, f"{what}: {got.dtype} != {want.dtype}"
    if np.issubdtype(want.dtype, np.floating):
        np.testing.assert_allclose(got, want, err_msg=what, **TOL)
    else:
        np.testing.assert_array_equal(got, want, err_msg=what)


def _check(op, ins, attrs, out_slot=None, grad_slots=(), grad_tol=None):
    got = run_torch_op_all(op, ins, attrs)
    want = run_ref_op_all(op, ins, attrs)
    assert set(got) == set(want)
    for slot in want:
        _same(got[slot], want[slot], f"{op}: {slot}")
    for slot in grad_slots:
        g = torch_op_grads(op, ins, attrs, [slot], [out_slot])[slot]
        w = ref_op_grads(op, ins, attrs, [slot], [out_slot])[slot]
        assert np.abs(w).max() > 0, f"{op}: vacuous d/d{slot}"
        if grad_tol is None:
            _same(g, w, f"{op}: d{out_slot}/d{slot}")
        else:
            np.testing.assert_allclose(g, w, rtol=0, atol=grad_tol
                                       * np.abs(w).max())
    return got


# -- chunk_eval -------------------------------------------------------------

# 2 chunk types: B-0 = 0, I-0 = 1, B-1 = 2, I-1 = 3, O = 4
_INF = np.array([[0, 1, 4, 2, 3, 3, 1, 1, 4, 0],
                 [1, 1, 0, 0, 4, 3, 2, 4, 4, 4],
                 [4, 4, 4, 4, 4, 4, 4, 4, 4, 4]], np.int64)
_LAB = np.array([[0, 1, 4, 2, 3, 2, 1, 1, 4, 0],
                 [0, 1, 0, 0, 4, 3, 2, 1, 4, 4],
                 [0, 4, 2, 3, 4, 4, 4, 4, 4, 4]], np.int64)
_LEN = np.array([10, 7, 0], np.int32)


def _chunks(tags, n, nct, excluded=()):
    """The IOB chunks (start, end, type) of tags[:n], by hand."""
    tags = [2 * nct if t // 2 in excluded else t for t in tags[:n]]
    out, cur = [], None
    for i, t in enumerate(tags):
        if t >= 2 * nct:
            cur = None
            continue
        typ, inside = t // 2, t % 2 == 1
        if cur is not None and inside and cur[2] == typ:
            cur[1] = i
            continue
        cur = [i, i, typ]
        out.append(cur)
    return {tuple(c) for c in out}


@pytest.mark.parametrize("excluded", [[], [1], [0, 1]])
def test_chunk_eval_counts_match_the_reference_and_by_hand(excluded):
    attrs = {"num_chunk_types": 2, "chunk_scheme": "IOB",
             "excluded_chunk_types": excluded}
    got = _check("chunk_eval", {"Inference": _INF, "Label": _LAB,
                                "SeqLen": _LEN}, attrs)
    n_inf = n_lab = n_ok = 0
    for i, n in enumerate(_LEN):
        a = _chunks(_INF[i], n, 2, excluded)
        b = _chunks(_LAB[i], n, 2, excluded)
        n_inf, n_lab, n_ok = n_inf + len(a), n_lab + len(b), \
            n_ok + len(a & b)
    assert (got["NumInferChunks"][0], got["NumLabelChunks"][0],
            got["NumCorrectChunks"][0]) == (n_inf, n_lab, n_ok)
    if excluded == []:
        assert 0 < n_ok < min(n_inf, n_lab)


def test_chunk_eval_random_tags_match_the_reference():
    for seed in range(3):
        r = np.random.RandomState(seed)
        ins = {"Inference": r.randint(0, 7, (4, 12, 1)).astype(np.int64),
               "Label": r.randint(0, 7, (4, 12, 1)).astype(np.int64),
               "SeqLen": r.randint(0, 13, (4,)).astype(np.int32)}
        _check("chunk_eval", ins, {"num_chunk_types": 3})


@pytest.mark.parametrize("scheme", ["IOE", "IOBES"])
def test_chunk_eval_layer_refuses_the_schemes_the_reference_refuses(scheme):
    import paddle_tpu as jf
    import paddle_tpu_torch as tf

    for fluid in (jf, tf):
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup), fluid.unique_name.guard():
            x = fluid.layers.data("x", shape=[5], dtype="int64",
                                  lod_level=1)
            with pytest.raises(NotImplementedError):
                fluid.layers.chunk_eval(x, x, scheme, 2)


# -- warpctc ----------------------------------------------------------------

def _ctc_ins(b, t, c, u, seed, logit_len, label_len, labels=None):
    r = np.random.RandomState(seed)
    return {"Logits": r.randn(b, t, c).astype(np.float32),
            "Label": (labels if labels is not None else
                      r.randint(1, c, (b, u)).astype(np.int32)),
            "LogitsLen": np.asarray(logit_len, np.int64),
            "LabelLen": np.asarray(label_len, np.int64)}


_CTC = {
    "ragged": (_ctc_ins(3, 9, 5, 4, 1, [9, 6, 3], [4, 2, 1]), {}),
    "repeats": (_ctc_ins(2, 7, 4, 3, 2, [7, 5], [3, 3],
                         np.array([[2, 2, 2], [1, 3, 3]], np.int32)), {}),
    # row 0: "1 1 1" needs 5 frames, it has 4; row 1: 3 labels in 2
    "infeasible": (_ctc_ins(2, 4, 4, 3, 3, [4, 2], [3, 3],
                            np.array([[1, 1, 1], [1, 2, 3]], np.int32)),
                   {}),
    "zero label length": (_ctc_ins(2, 5, 3, 2, 4, [5, 3], [0, 2]), {}),
    "norm_by_times": (_ctc_ins(3, 8, 5, 3, 5, [8, 5, 1], [3, 2, 1]),
                      {"norm_by_times": True}),
    "blank 2": (_ctc_ins(2, 6, 4, 2, 6, [6, 4], [2, 2],
                         np.array([[0, 1], [3, 3]], np.int32)),
                {"blank": 2}),
}


# An impossible alignment puts the alphas near -1e5, where a float32 ulp
# is 2^-7: each posterior term exp(alpha - logZ) of the gradient then
# carries a relative error up to ~2^-7 in either package, and their
# roundings differ (other exp/log1p), so that case's gradients agree to
# 4 * 2^-7 of the largest, not to the sweep's rtol.
TOL_CTC_INFEASIBLE_GRAD = 4 * 2.0 ** -7


@pytest.mark.parametrize("case", sorted(_CTC))
def test_warpctc_loss_and_gradient_match_the_reference(case):
    ins, attrs = _CTC[case]
    got = _check("warpctc", ins, attrs, "Loss", ["Logits"],
                 TOL_CTC_INFEASIBLE_GRAD if case == "infeasible" else None)
    assert np.isfinite(got["Loss"]).all()
    if case == "infeasible":
        # log_epsilon -1e5 per impossible step: large and finite
        assert (got["Loss"] > 1e4).all()


def test_warpctc_equals_torch_ctc_loss_where_an_alignment_exists():
    """F.ctc_loss (time-major log-probabilities) gives the same losses on
    feasible rows; on the infeasible case it gives inf where the op
    keeps optax's finite value."""
    import torch.nn.functional as F

    for case in ("ragged", "repeats", "zero label length", "infeasible"):
        ins, attrs = _CTC[case]
        got = run_torch_op_all("warpctc", ins, attrs)["Loss"][:, 0]
        lp = torch.log_softmax(torch.as_tensor(ins["Logits"]), -1)
        ref = F.ctc_loss(lp.transpose(0, 1), torch.as_tensor(
            ins["Label"]).long(), torch.as_tensor(ins["LogitsLen"]),
            torch.as_tensor(ins["LabelLen"]), blank=0, reduction="none",
            zero_infinity=False).numpy()
        if case == "infeasible":
            assert np.isinf(ref).all() and np.isfinite(got).all()
        else:
            np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)


# -- edit_distance ----------------------------------------------------------

def _levenshtein(a, b):
    row = list(range(len(b) + 1))
    for i, x in enumerate(a):
        new = [i + 1]
        for j, y in enumerate(b):
            new.append(min(row[j] + (x != y), row[j + 1] + 1, new[j] + 1))
        row = new
    return row[-1]


_ED = {"Hyps": np.array([[1, 2, 3, 4, 5], [2, 0, 2, 0, 1],
                         [3, 3, 3, 3, 3], [1, 2, 1, 2, 1]], np.int64),
       "Refs": np.array([[1, 3, 4, 0, 0, 0], [0, 2, 2, 1, 0, 1],
                         [4, 4, 4, 4, 4, 4], [2, 1, 2, 1, 2, 1]], np.int64),
       "HypsLen": np.array([5, 4, 0, 5], np.int64),
       "RefsLen": np.array([3, 6, 6, 0], np.int64)}


@pytest.mark.parametrize("attrs", [
    {}, {"normalized": True}, {"ignored_tokens": [0]},
    {"ignored_tokens": [0, 2], "normalized": True}])
def test_edit_distance_matches_the_reference_and_levenshtein(attrs):
    got = _check("edit_distance", _ED, attrs)["Out"][:, 0]
    drop = set(attrs.get("ignored_tokens", []))
    for i in range(4):
        h = [t for t in _ED["Hyps"][i, :_ED["HypsLen"][i]] if t not in drop]
        r = [t for t in _ED["Refs"][i, :_ED["RefsLen"][i]] if t not in drop]
        want = _levenshtein(h, r)
        if attrs.get("normalized"):
            want = want / max(len(r), 1)
        assert got[i] == np.float32(want), (i, got[i], want)


def test_edit_distance_random_batch_matches_the_reference():
    r = np.random.RandomState(8)
    ins = {"Hyps": r.randint(0, 4, (16, 13)).astype(np.int64),
           "Refs": r.randint(0, 4, (16, 9)).astype(np.int64),
           "HypsLen": r.randint(0, 14, (16,)).astype(np.int64),
           "RefsLen": r.randint(0, 10, (16,)).astype(np.int64)}
    _check("edit_distance", ins, {"ignored_tokens": [3]})


# -- hierarchical_sigmoid ---------------------------------------------------

@pytest.mark.parametrize("classes", [2, 6, 7, 16])
def test_hsigmoid_default_tree_matches_the_reference(classes):
    r = np.random.RandomState(classes)
    ins = {"X": r.randn(5, 4).astype(np.float32),
           "Label": r.randint(0, classes, (5, 1)).astype(np.int64),
           "W": r.randn(classes - 1, 4).astype(np.float32),
           "Bias": r.randn(classes - 1).astype(np.float32)}
    _check("hierarchical_sigmoid", ins, {"num_classes": classes}, "Out",
           ["X", "W", "Bias"])


def test_hsigmoid_custom_tree_is_upstreams_custom_code():
    """PathTable/PathCode (upstream matrix_bit_code.h CustomCode): a
    row's path runs to its first negative node.  The reference package
    takes the default tree whatever these inputs say (ROADMAP C12), so
    the port is held against numpy here."""
    r = np.random.RandomState(3)
    x = r.randn(3, 4).astype(np.float32)
    w = r.randn(6, 4).astype(np.float32)
    b = r.randn(6).astype(np.float32)
    table = np.array([[0, 2, 5, -1], [1, 3, -1, 4], [4, 0, 1, 2]],
                     np.int64)
    code = np.array([[1, 0, 1, 1], [0, 1, 1, 0], [1, 1, 0, 0]], np.int64)
    got = run_torch_op_all("hierarchical_sigmoid", {
        "X": x, "W": w, "Bias": b, "Label": np.zeros((3, 1), np.int64),
        "PathTable": table, "PathCode": code}, {"num_classes": 7})
    want = np.zeros((3, 1), np.float32)
    for i in range(3):
        for j in range(4):
            if table[i, j] < 0:
                break
            z = float(x[i] @ w[table[i, j]] + b[table[i, j]])
            want[i, 0] += np.logaddexp(0.0, z) - code[i, j] * z
    np.testing.assert_allclose(got["Out"], want, rtol=1e-5, atol=1e-6)
    assert got["PreOut"].shape == (3, 4)


# -- the metric ops ---------------------------------------------------------

def test_precision_recall_with_weights_and_running_states():
    r = np.random.RandomState(4)
    ins = {"Indices": r.randint(0, 4, (9, 1)).astype(np.int32),
           "MaxProbs": r.rand(9, 1).astype(np.float32),
           "Labels": r.randint(0, 4, (9, 1)).astype(np.int64),
           "Weights": r.rand(9, 1).astype(np.float32),
           "StatesInfo": r.randint(0, 5, (4, 4)).astype(np.float32)}
    _check("precision_recall", ins, {"class_number": 4})
    preds = {"Predictions": r.rand(9, 4).astype(np.float32),
             "Labels": ins["Labels"]}
    _check("precision_recall", preds, {"class_number": 4})


def test_mean_iou_accumulates_and_drops_ids_out_of_range():
    r = np.random.RandomState(5)
    pred = r.randint(-1, 5, (3, 7)).astype(np.int32)   # -1 wraps, 4 drops
    ins = {"Predictions": pred, "Labels": r.randint(0, 4, (3, 7)).astype(
        np.int32),
           "InWrongs": [np.array([1, 0, 2, 0], np.int32),
                        np.array([0, 3, 0, 0], np.int32)],
           "InCorrects": [np.array([2, 2, 0, 1], np.int32)],
           "InMeanIou": [np.array([0.25], np.float32)]}
    _check("mean_iou", ins, {"num_classes": 4})


def test_positive_negative_pair_weights_ties_and_accumulators():
    score = np.array([[0.1, 0.5], [0.3, 0.5], [0.2, 0.9], [0.4, 0.1],
                      [0.4, 0.2], [0.7, 0.3]], np.float32)
    ins = {"Score": score,
           "Label": np.array([[1], [0], [2], [1], [0], [1]], np.float32),
           "QueryID": np.array([[0], [0], [0], [1], [1], [1]], np.int64),
           "Weight": np.array([[1.0], [2.0], [0.5], [1.0], [1.5], [1.0]],
                              np.float32),
           "AccumulatePositivePair": np.array([1.0], np.float32),
           "AccumulateNegativePair": np.array([2.0], np.float32),
           "AccumulateNeutralPair": np.array([0.5], np.float32)}
    for column in (0, 1, -1):
        _check("positive_negative_pair", ins, {"column": column})


def test_modified_huber_loss_branches_and_gradient():
    x = np.array([[-2.5], [-0.6], [0.2], [0.9], [1.7], [-1.4]], np.float32)
    y = np.array([[1], [1], [0], [1], [0], [0]], np.float32)
    _check("modified_huber_loss", {"X": x, "Y": y}, {}, "Out", ["X"])


@pytest.mark.parametrize("attrs", [
    {"merge_repeated": False}, {"padding_value": -1, "blank": 2},
    {"blank": 1}])
def test_ctc_align_options_match_the_reference(attrs):
    r = np.random.RandomState(6)
    ins = {"Input": r.randint(0, 4, (3, 9)).astype(np.int32),
           "SeqLen": np.array([9, 4, 0], np.int32)}
    _check("ctc_align", ins, attrs)
    _check("ctc_align", {"Input": ins["Input"]}, attrs)


# -- the layers ---------------------------------------------------------------

def _structured_layers(fluid):
    """One call of each of the family's nine layers; returns the outputs
    to fetch (sampling_id's last)."""
    L = fluid.layers
    feat = L.data("feat", shape=[6], dtype="float32")
    cls = L.data("cls", shape=[1], dtype="int64")
    hyp = L.data("hyp", shape=[7], dtype="int64", lod_level=1)
    ref = L.data("ref", shape=[5], dtype="int64", lod_level=1)
    logits = L.data("logits", shape=[9, 5], dtype="float32", lod_level=1)
    lab = L.data("lab", shape=[3], dtype="int32", lod_level=1)
    tags = L.data("tags", shape=[7], dtype="int64", lod_level=1)
    gold = L.data("gold", shape=[7], dtype="int64")
    outs = [L.hsigmoid(feat, cls, num_classes=6)]
    outs += list(L.edit_distance(hyp, ref, ignored_tokens=[0]))
    outs.append(L.warpctc(logits, lab, norm_by_times=True))
    outs += list(L.ctc_greedy_decoder(L.softmax(logits), blank=0))
    outs += list(L.chunk_eval(tags, gold, "IOB", 3,
                              excluded_chunk_types=[2]))
    outs += list(L.mean_iou(L.cast(cls, "int32"), L.cast(
        L.fill_constant_batch_size_like(cls, [-1, 1], "int64", 2),
        "int32"), 4))
    outs.append(L.modified_huber_loss(L.slice(feat, axes=[1], starts=[0],
                                              ends=[1]),
                                      L.cast(L.slice(cls, axes=[1],
                                                     starts=[0], ends=[1]),
                                             "float32")))
    outs += list(L.positive_negative_pair(feat, L.cast(cls, "float32"),
                                          cls, column=2))
    outs.append(L.sampling_id(L.softmax(feat)))
    return outs


def _feed(batch=4):
    r = np.random.RandomState(9)
    return {"feat": r.randn(batch, 6).astype(np.float32),
            "cls": r.randint(0, 4, (batch, 1)).astype(np.int64),
            "hyp": r.randint(0, 4, (batch, 7)).astype(np.int64),
            "hyp.seq_len": np.array([7, 3, 0, 5], np.int32),
            "ref": r.randint(0, 4, (batch, 5)).astype(np.int64),
            "ref.seq_len": np.array([5, 5, 2, 0], np.int32),
            "logits": r.randn(batch, 9, 5).astype(np.float32),
            "logits.seq_len": np.array([9, 7, 3, 1], np.int32),
            "lab": r.randint(1, 5, (batch, 3)).astype(np.int32),
            "lab.seq_len": np.array([3, 2, 1, 3], np.int32),
            "tags": r.randint(0, 7, (batch, 7)).astype(np.int64),
            "tags.seq_len": np.array([7, 6, 2, 0], np.int32),
            "gold": r.randint(0, 7, (batch, 7)).astype(np.int64)}


def test_structured_layers_build_and_run_the_reference_program():
    import paddle_tpu as jf
    import paddle_tpu_torch as tf

    progs, fetched = {}, {}
    for fluid in (jf, tf):
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup), fluid.unique_name.guard():
            outs = _structured_layers(fluid)
        progs[fluid.__name__] = (main, startup)
        scope = fluid.Scope()
        exe = fluid.Executor(fluid.CPUPlace())
        exe.run(startup, scope=scope)
        if fluid is tf:
            # the reference's parameters, carried over
            from paddle_tpu_torch.convert import params_from_arrays

            for n, t in params_from_arrays(arrays, "cpu").items():
                scope.set_var(n, t)
        else:
            arrays = {n: np.asarray(v) for n, v in scope.vars.items()
                      if v is not None}
        fetched[fluid.__name__] = [np.asarray(v) for v in exe.run(
            main, feed=_feed(), fetch_list=outs, scope=scope)]
    for a, b in zip(progs["paddle_tpu_torch"], progs["paddle_tpu"]):
        assert json.dumps(a.to_dict(), sort_keys=True) == \
            json.dumps(b.to_dict(), sort_keys=True)
    got, want = fetched["paddle_tpu_torch"], fetched["paddle_tpu"]
    for i, (g, w) in enumerate(zip(got[:-1], want[:-1])):
        _same(g, w, f"fetch {i}")
    ids = got[-1]
    assert ids.shape == want[-1].shape and ids.dtype == want[-1].dtype
    assert ids.min() >= 0 and ids.max() < 6
