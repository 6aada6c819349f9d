"""The ops of the stacked-LSTM slice and the kernel-less recurrent ops,
PyTorch port vs the JAX package on the same numpy inputs: every output
slot and, for the differentiable ops, the gradient of one weighted sum of
the outputs w.r.t. each float input (torch autograd against jax.grad).

The recurrent ops (`dynamic_gru`, `lstm_unit`, `gru_unit`, `lstmp`) take
their inputs from the op sweep's own specs (tests/test_op_sweep.py `S`)
and extra cases with lengths, initial states and reversal.  Tolerance
1e-5 for values and 1e-4 for gradients (float32 on both sides, other
summation orders and libms); integer outputs are equal.
"""

from __future__ import annotations

import numpy as np
import pytest

from test_op_sweep import S
from torch_op_test import (ref_op_grads, run_ref_op_all, run_torch_op_all,
                           torch_op_grads)

TOL = dict(rtol=1e-5, atol=1e-5)
GTOL = dict(rtol=1e-4, atol=1e-4)
R = np.random.RandomState(0)


def _f(*shape, scale=1.0):
    return (R.randn(*shape) * scale).astype(np.float32)


def _probs(*shape):
    p = np.abs(_f(*shape)) + 0.05
    return (p / p.sum(-1, keepdims=True)).astype(np.float32)


def _sweep(op, extra_ins=None, **extra_attrs):
    spec = S[op]
    ins = dict(spec["ins"], **(extra_ins or {}))
    return (op, ins, dict(spec.get("attrs", {}), **extra_attrs),
            tuple(spec.get("grad", ())))


_POOL_X = _f(3, 5, 4)
_POOL_LEN = np.array([5, 2, 0], np.int32)

# name: (op, ins, attrs, slots to differentiate)
CASES = {
    **{f"sequence_pool_{p.lower()}_{'len' if sl else 'full'}": (
        "sequence_pool",
        {"X": _POOL_X, **({"SeqLen": _POOL_LEN} if sl else {})},
        {"pooltype": p}, ("X",))
       for p in ("SUM", "AVERAGE", "SQRT", "MAX", "FIRST", "LAST")
       for sl in (False, True)},
    "sequence_pool_nested": (
        "sequence_pool",
        {"X": _f(2, 3, 4, 2), "SeqLen": np.array([3, 2], np.int32),
         "SeqLen2": np.array([[4, 1, 2], [3, 0, 0]], np.int32)},
        {"pooltype": "SUM"}, ("X",)),
    "sequence_pool_nested_max": (
        "sequence_pool",
        {"X": _f(2, 3, 4, 2), "SeqLen": np.array([3, 2], np.int32),
         "SeqLen2": np.array([[4, 1, 2], [3, 2, 1]], np.int32)},
        {"pooltype": "MAX"}, ("X",)),
    "sequence_pool_sweep": _sweep("sequence_pool"),
    "cross_entropy_hard": (
        "cross_entropy", {"X": _probs(4, 6),
                          "Label": R.randint(0, 6, (4, 1)).astype(np.int32)},
        {}, ("X",)),
    "cross_entropy_ignore": (
        "cross_entropy", {"X": _probs(2, 3, 5),
                          "Label": np.array([[1, 3, 0], [3, 3, 4]],
                                            np.int32)},
        {"ignore_index": 3}, ("X",)),
    "cross_entropy_soft": (
        "cross_entropy", {"X": _probs(4, 6), "Label": _probs(4, 6)},
        {"soft_label": True}, ("X", "Label")),
    "cross_entropy_floor": (
        "cross_entropy", {"X": np.array([[0.0, 1.0], [1.0, 0.0]],
                                        np.float32),
                          "Label": np.array([[0], [0]], np.int32)},
        {}, ()),
    "cross_entropy_sweep": _sweep("cross_entropy"),
    "mean": ("mean", {"X": _f(3, 4, 2)}, {}, ("X",)),
    "top_k": ("top_k", {"X": _f(4, 7)}, {"k": 3}, ("X",)),
    "top_k_1": ("top_k", {"X": _probs(5, 2)}, {"k": 1}, ()),
    "accuracy": (
        "accuracy", {"Indices": R.randint(0, 4, (6, 2)).astype(np.int32),
                     "Label": R.randint(0, 4, (6, 1)).astype(np.int32)},
        {}, ()),
    "accuracy_sweep": _sweep("accuracy"),
    "tanh": ("tanh", {"X": _f(3, 5)}, {}, ("X",)),
    "sigmoid": ("sigmoid", {"X": _f(3, 5, scale=4.0)}, {}, ("X",)),
    "concat": _sweep("concat"),
    "dynamic_gru_sweep": _sweep("dynamic_gru"),
    "dynamic_gru_full": (
        "dynamic_gru",
        {"Input": _f(3, 6, 12, scale=0.5), "Weight": _f(4, 12, scale=0.5),
         "Bias": _f(1, 12, scale=0.3), "H0": _f(3, 4, scale=0.3),
         "SeqLen": np.array([6, 3, 0], np.int32)},
        {"is_reverse": True}, ("Input", "Weight", "Bias", "H0")),
    "dynamic_gru_relu": (
        "dynamic_gru",
        {"Input": _f(2, 4, 6, scale=0.5), "Weight": _f(2, 6, scale=0.5)},
        {"activation": "relu", "gate_activation": "sigmoid"},
        ("Input", "Weight")),
    "lstm_unit_sweep": _sweep("lstm_unit"),
    "lstm_unit_forget_bias": _sweep("lstm_unit", forget_bias=1.5),
    "gru_unit_sweep": _sweep("gru_unit"),
    "gru_unit_bias_enum_acts": (
        "gru_unit",
        {"Input": _f(3, 9, scale=0.5), "HiddenPrev": _f(3, 3, scale=0.5),
         "Weight": _f(3, 9, scale=0.5), "Bias": _f(1, 9, scale=0.3)},
        {"activation": 3, "gate_activation": 1},
        ("Input", "HiddenPrev", "Weight", "Bias")),
    "lstmp_sweep": _sweep("lstmp"),
    "lstmp_full": (
        "lstmp",
        {"Input": _f(3, 5, 16, scale=0.5), "Weight": _f(3, 16, scale=0.5),
         "ProjWeight": _f(4, 3, scale=0.5), "Bias": _f(1, 28, scale=0.3),
         "H0": _f(3, 4, scale=0.3), "C0": _f(3, 4, scale=0.3),
         "SeqLen": np.array([5, 2, 1], np.int32)},
        {"use_peepholes": True, "is_reverse": True,
         "proj_activation": "identity"},
        ("Input", "Weight", "ProjWeight", "Bias", "H0", "C0")),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_forward_matches_reference(name):
    op, ins, attrs, _ = CASES[name]
    got = run_torch_op_all(op, ins, attrs)
    ref = run_ref_op_all(op, ins, attrs)
    assert set(got) == set(ref)
    for slot in ref:
        assert got[slot].shape == ref[slot].shape, slot
        if np.issubdtype(ref[slot].dtype, np.integer):
            assert np.issubdtype(got[slot].dtype, np.integer), slot
            np.testing.assert_array_equal(got[slot], ref[slot], err_msg=slot)
        else:
            np.testing.assert_allclose(got[slot], ref[slot], **TOL,
                                       err_msg=slot)


def _float_slots(op, ins, attrs):
    ref = run_ref_op_all(op, ins, attrs)
    return tuple(s for s in sorted(ref)
                 if np.issubdtype(ref[s].dtype, np.floating))


@pytest.mark.parametrize("name", sorted(n for n, c in CASES.items()
                                        if c[3]))
def test_gradient_matches_reference(name):
    op, ins, attrs, slots = CASES[name]
    outs = _float_slots(op, ins, attrs)
    got = torch_op_grads(op, ins, attrs, slots, outs)
    ref = ref_op_grads(op, ins, attrs, slots, outs)
    for slot in slots:
        np.testing.assert_allclose(got[slot], ref[slot], **GTOL,
                                   err_msg=f"d{slot}")


def test_cross_entropy_floor_is_finite():
    """A probability of exactly 0 at the label gives -log(1e-12)."""
    _, ins, attrs, _ = CASES["cross_entropy_floor"]
    y = run_torch_op_all("cross_entropy", ins, attrs)["Y"]
    np.testing.assert_allclose(y[0, 0], -np.log(1e-12), rtol=1e-6)
    assert y[1, 0] == 0.0


@pytest.mark.parametrize("op", ["dynamic_gru", "lstmp"])
def test_recurrent_ops_reject_nested_inputs(op):
    ins = dict(S[op]["ins"])
    n, t = ins["Input"].shape[:2]
    ins["SeqLen"] = np.full((n,), t, np.int32)
    ins["SeqLen2"] = np.ones((n, t), np.int32)
    with pytest.raises(NotImplementedError, match="nested"):
        run_torch_op_all(op, ins, {})


def test_sequence_pool_unknown_type_raises():
    with pytest.raises(ValueError, match="pooltype"):
        run_torch_op_all("sequence_pool", {"X": _POOL_X},
                         {"pooltype": "MEDIAN"})
