"""The sequence family of paddle_tpu_torch (ops/sequence.py: the 14 ops
of the padded + SeqLen contract the registry's first half left out)
against the JAX package on the same numpy inputs, at the op sweep's
tolerances (float outputs within rtol 2e-3 and atol 1e-6; integer
outputs exactly), forward (every output slot) and gradients, beyond
the sweep's one spec each:

- sequence_expand with a nested Y (YLen2): a sequence X (the nested
  output and both companions) and a dense X (a level-1 output);
  sequence_expand_as;
- sequence_softmax with a row of length 0 (0 there, and a 0 gradient)
  and the (N, T, 1) form; sequence_reverse with and without lengths;
- sequence_concat of three ragged inputs, of nested inputs, and
  without companions;
- sequence_pad to a longer and a shorter length with a pad value,
  sequence_unpad, sequence_slice, sequence_enumerate, sequence_erase;
- im2sequence with channels, stride and padding (the patch layout);
- sequence_scatter with duplicate ids, ids negative and out of range,
  and IdsLen; sequence_reshape down and up (OutLen rounds up);
- lod_reset of a row stream and of a padded batch, and the reference's
  ValueErrors.

Then the 12 `layers` wrappers of the family build the reference's
`Program.to_dict()` and give its fetches.
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
R = np.random.RandomState(22)


def _f32(*shape):
    return R.randn(*shape).astype(np.float32)


def _same(got, want, what):
    assert got.shape == want.shape, f"{what}: {got.shape} != {want.shape}"
    assert got.dtype == want.dtype, f"{what}: {got.dtype} != {want.dtype}"
    if np.issubdtype(want.dtype, np.floating):
        np.testing.assert_allclose(got, want, err_msg=what, **TOL)
    else:
        np.testing.assert_array_equal(got, want, err_msg=what)


def _i32(*v):
    return np.array(v, np.int32)


_NESTED_Y = _f32(3, 4, 2)                    # (N, S1, S2)
_X_SEQ = _f32(3, 5, 2)                       # (N, Tx, D)

# (op, inputs, attrs, output slot of the gradients, gradient slots)
CASES = {
    "expand nested, sequence x": (
        "sequence_expand", {"X": _X_SEQ, "Y": _NESTED_Y,
                            "SeqLen": _i32(5, 2, 0), "YLen": _i32(4, 1, 3),
                            "YLen2": np.array([[2, 2, 1, 2], [1, 0, 0, 0],
                                               [2, 1, 1, 0]], np.int32)},
        {}, "Out", ["X"]),
    "expand nested, dense x": (
        "sequence_expand", {"X": _f32(3, 6), "Y": _NESTED_Y,
                            "YLen": _i32(2, 4, 0),
                            "YLen2": np.ones((3, 4), np.int32)},
        {}, "Out", ["X"]),
    "expand nested, no YLen": (
        "sequence_expand", {"X": _X_SEQ, "Y": _NESTED_Y,
                            "YLen2": np.ones((3, 4), np.int32)},
        {}, "Out", ["X"]),
    "expand 2-d x": ("sequence_expand", {"X": _f32(3, 1), "Y": _f32(3, 5)},
                     {}, "Out", ["X"]),
    "expand_as": ("sequence_expand_as", {"X": _f32(3, 1, 4),
                                         "Y": _f32(3, 6, 1)}, {}, "Out",
                  ["X"]),
    "softmax, a row of length 0": (
        "sequence_softmax", {"X": _f32(3, 5), "SeqLen": _i32(5, 0, 2)}, {},
        "Out", ["X"]),
    "softmax (N, T, 1), no lengths": (
        "sequence_softmax", {"X": _f32(2, 4, 1)}, {}, "Out", ["X"]),
    "reverse": ("sequence_reverse", {"X": _f32(3, 5, 2),
                                     "SeqLen": _i32(5, 0, 3)}, {}, "Y",
                ["X"]),
    "reverse, no lengths": ("sequence_reverse", {"X": _f32(2, 4)}, {}, "Y",
                            ["X"]),
    "concat three ragged": (
        "sequence_concat", {"X": [_f32(3, 4, 2), _f32(3, 2, 2),
                                  _f32(3, 3, 2)],
                            "SeqLen": [_i32(4, 0, 2), _i32(1, 2, 0),
                                       _i32(3, 3, 1)]},
        {}, "Out", ["X"]),
    "concat nested": (
        "sequence_concat", {"X": [_f32(2, 2, 3, 2), _f32(2, 3, 2, 2)],
                            "SeqLen": [_i32(2, 1), _i32(1, 3)],
                            "SeqLen2": [np.array([[3, 1], [2, 0]],
                                                 np.int32),
                                        np.array([[2, 0, 0], [1, 2, 2]],
                                                 np.int32)]},
        {}, "Out", ["X"]),
    "concat, no lengths": ("sequence_concat", {"X": [_f32(2, 3),
                                                     _f32(2, 2)]}, {},
                           "Out", ["X"]),
    "pad longer, pad value": (
        "sequence_pad", {"X": _f32(3, 4, 2), "SeqLen": _i32(4, 1, 0),
                         "PadValue": np.array([-1.5], np.float32)},
        {"padded_length": 6}, "Out", ["X"]),
    "pad shorter": ("sequence_pad", {"X": _f32(2, 5), "SeqLen": _i32(5, 2),
                                     "PadValue": np.zeros(1, np.float32)},
                    {"padded_length": 3}, "Out", ["X"]),
    "unpad": ("sequence_unpad", {"X": _f32(3, 4, 2),
                                 "Length": np.array([4, 0, 2], np.int64)},
              {}, "Out", ["X"]),
    "slice": ("sequence_slice", {"X": _f32(3, 5, 2),
                                 "Offset": np.array([[0], [3], [4]],
                                                    np.int64),
                                 "Length": np.array([[5], [2], [3]],
                                                    np.int64)},
              {}, "Out", ["X"]),
    "enumerate win 3": ("sequence_enumerate", {
        "X": R.randint(0, 9, (3, 5)).astype(np.int64)},
        {"win_size": 3, "pad_value": -2}, None, []),
    "erase two tokens": ("sequence_erase", {
        "X": R.randint(0, 5, (3, 6)).astype(np.int64)},
        {"tokens": [0, 3]}, None, []),
    "im2sequence stride and padding": (
        "im2sequence", {"X": _f32(2, 3, 5, 6)},
        {"kernels": [2, 3], "strides": [2, 1], "paddings": [1, 1, 1, 1]},
        "Out", ["X"]),
    "scatter duplicates, ids out of range": (
        "sequence_scatter", {"X": _f32(3, 5),
                             "Ids": np.array([[1, 1, 4, -1], [0, 7, 2, 2],
                                              [3, -6, 0, 1]], np.int64),
                             "Updates": _f32(3, 4),
                             "IdsLen": _i32(4, 3, 2)},
        {}, "Out", ["X", "Updates"]),
    "reshape down": ("sequence_reshape", {"X": _f32(3, 4, 6),
                                          "SeqLen": _i32(4, 1, 3)},
                     {"new_dim": 3}, "Out", ["X"]),
    "reshape up, OutLen rounds up": (
        "sequence_reshape", {"X": _f32(3, 4, 2), "SeqLen": _i32(3, 0, 1)},
        {"new_dim": 4}, "Out", ["X"]),
    "lod_reset of rows": ("lod_reset", {"X": _f32(7, 3)},
                          {"target_lod": [0, 3, 3, 7]}, "Out", ["X"]),
    "lod_reset of a padded batch": (
        "lod_reset", {"X": _f32(3, 4, 2), "SeqLen": _i32(4, 0, 3)},
        {"target_lod": [0, 1, 5, 7]}, "Out", ["X"]),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_sequence_op_matches_the_reference(case):
    op, ins, attrs, out_slot, grad_slots = CASES[case]
    got = run_torch_op_all(op, ins, attrs)
    want = run_ref_op_all(op, ins, attrs)
    assert set(got) == set(want), case
    for slot in want:
        _same(got[slot], want[slot], f"{case}: {slot}")
    for slot in grad_slots:
        g = torch_op_grads(op, ins, attrs, [slot], [out_slot])[slot]
        w = ref_op_grads(op, ins, attrs, [slot], [out_slot])[slot]
        assert np.abs(w).max() > 0, f"{case}: vacuous d/d{slot}"
        assert np.isfinite(g).all(), case
        _same(g, w, f"{case}: d{out_slot}/d{slot}")


def test_softmax_row_of_length_zero_is_zero_with_zero_gradient():
    ins = {"X": _f32(2, 4), "SeqLen": _i32(0, 4)}
    o = run_torch_op_all("sequence_softmax", ins, {})["Out"]
    assert not o[0].any() and abs(o[1].sum() - 1) < 1e-6
    g = torch_op_grads("sequence_softmax", ins, {}, ["X"], ["Out"])["X"]
    assert not g[0].any() and np.isfinite(g).all()


@pytest.mark.parametrize("target_lod", [[1, 3], [0], [0, 4, 2]])
def test_lod_reset_refuses_what_the_reference_refuses(target_lod):
    for run in (run_torch_op_all, run_ref_op_all):
        with pytest.raises(ValueError):
            run("lod_reset", {"X": _f32(3, 2)}, {"target_lod": target_lod})


def test_lod_reset_of_rows_must_cover_them():
    for run in (run_torch_op_all, run_ref_op_all):
        with pytest.raises(ValueError):
            run("lod_reset", {"X": _f32(5, 2)}, {"target_lod": [0, 2, 4]})


# -- the layers ---------------------------------------------------------------

def _sequence_layers(fluid):
    """One call of each of the family's 12 layers; the outputs and the
    names of the companions they emit."""
    L = fluid.layers
    seq = L.data("seq", shape=[5, 3], dtype="float32", lod_level=1)
    seq2 = L.data("seq2", shape=[4, 3], dtype="float32", lod_level=1)
    nest = L.data("nest", shape=[3, 2, 3], dtype="float32", lod_level=2)
    ids = L.data("ids", shape=[6], dtype="int64", lod_level=1)
    img = L.data("img", shape=[2, 4, 4], dtype="float32")
    vec = L.data("vec", shape=[3], dtype="float32")
    scores = L.data("scores", shape=[5], dtype="float32", lod_level=1)
    lens = L.data("lens", shape=[1], dtype="int64")
    outs = [L.sequence_softmax(scores), L.sequence_reverse(seq),
            L.sequence_expand(vec, seq), L.sequence_expand(seq, nest),
            L.sequence_expand(vec, nest), L.sequence_expand_as(
                L.reshape(vec, shape=[-1, 1, 3]), seq),
            L.sequence_concat([seq, seq2])]
    padded, length = L.sequence_pad(seq, L.fill_constant(
        shape=[1], dtype="float32", value=0.5), maxlen=7)
    outs += [padded, length, L.sequence_unpad(seq, lens),
             L.sequence_slice(seq, lens, lens),
             L.sequence_enumerate(ids, win_size=2, pad_value=1),
             L.sequence_erase(ids, tokens=[2, 5]),
             L.im2sequence(img, filter_size=2, stride=2),
             L.lod_reset(seq, y=[2, 0, 4]),
             L.lod_reset(seq, target_lod=[0, 1, 6])]
    block = fluid.default_main_program().global_block()
    companions = [f"{o.name}.{k}" for o in outs for k in ("seq_len",
                                                          "seq_len2")
                  if block.has_var(f"{o.name}.{k}")]
    return outs, companions


def _seq_feed():
    r = np.random.RandomState(12)
    return {"seq": r.randn(3, 5, 3).astype(np.float32),
            "seq.seq_len": np.array([5, 0, 2], np.int32),
            "seq2": r.randn(3, 4, 3).astype(np.float32),
            "seq2.seq_len": np.array([1, 4, 3], np.int32),
            "nest": r.randn(3, 3, 2, 3).astype(np.float32),
            "nest.seq_len": np.array([3, 1, 2], np.int32),
            "nest.seq_len2": np.array([[2, 1, 2], [1, 0, 0], [2, 2, 0]],
                                      np.int32),
            "ids": r.randint(0, 7, (3, 6)).astype(np.int64),
            "ids.seq_len": np.array([6, 3, 0], np.int32),
            "img": r.randn(3, 2, 4, 4).astype(np.float32),
            "vec": r.randn(3, 3).astype(np.float32),
            "scores": r.randn(3, 5).astype(np.float32),
            "scores.seq_len": np.array([5, 1, 0], np.int32),
            "lens": np.array([[1], [0], [2]], np.int64)}


def test_sequence_layers_build_and_run_the_reference_program():
    import paddle_tpu as jf
    import paddle_tpu_torch as tf

    progs, fetched = {}, {}
    for fluid in (jf, tf):
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup), fluid.unique_name.guard():
            outs, companions = _sequence_layers(fluid)
        progs[fluid.__name__] = (main, startup)
        exe = fluid.Executor(fluid.CPUPlace())
        fetched[fluid.__name__] = [np.asarray(v) for v in exe.run(
            main, feed=_seq_feed(), fetch_list=outs + companions,
            scope=fluid.Scope())]
    assert len(companions) >= 10
    for a, b in zip(progs["paddle_tpu_torch"], progs["paddle_tpu"]):
        assert json.dumps(a.to_dict(), sort_keys=True) == \
            json.dumps(b.to_dict(), sort_keys=True)
    for i, (g, w) in enumerate(zip(fetched["paddle_tpu_torch"],
                                   fetched["paddle_tpu"])):
        _same(g, w, f"fetch {i}")
