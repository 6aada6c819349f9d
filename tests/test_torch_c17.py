"""ROADMAP C17: the default data-parallel mode refuses an op that mixes
rows along the batch dim, or computes the reference's global program.

Each case of C17 (an fc-tanh-fc MLP with one row-mixing op, 32 rows,
3 SGD steps from the reference's startup values) at dp = 2: the port
raises NotImplementedError naming C16 (from the port's own startup
values: the refusal comes before any arithmetic), or its losses and
state equal the reference's dp = 2 run (rtol 1e-5 on the losses, 1e-4
/ 1e-6 on the state).  The refusal holds under dp = 2 x mp = 2 too (the plan
the model axes share).  Which ops the plan flags is checked over every
spec of the op sweep (`tests/test_op_sweep.py` S) that takes an axis
attr: naming dim 0 of a batch input, each is flagged unless it moves
dims without mixing rows.
"""

import numpy as np
import pytest

import torch_mp_cases as mpc
from torch_dp_ref import (assert_ranks_identical, assert_state_close,
                          group_fixture, ref_arrays, ref_train)

group = group_fixture(4)

REFUSED = ("softmax", "cumsum", "argsort", "reverse", "gather",
           "concat_slice", "reduce_max", "l2_normalize", "xyt",
           "mul_transpose")


@pytest.mark.parametrize("case", REFUSED)
def test_row_mixing_op_refused_naming_c16(group, case):
    model = f"c17_{case}"
    feed = mpc.c17_feeds(case, steps=1)[0]
    msgs = group.run("torch_mp_cases:refusal", model=model, feed=feed,
                     arrays=None, mesh={"dp": 2})
    for msg in msgs[:2]:
        assert msg is not None and msg.startswith("NotImplementedError") \
            and "C16" in msg, msg
    op = {"concat_slice": "concat", "xyt": "matmul",
          "mul_transpose": "mul"}.get(case, case)
    assert f"op {op!r}" in msgs[0], msgs[0]


def test_cross_rank_reduce_mean_matches_reference(group):
    """reduce_mean(dim=0) feeding the forward runs cross-rank: the
    reference's dp = 2 losses and state."""
    model = "c17_reduce_mean"
    feeds = mpc.c17_feeds("reduce_mean")
    arrays = ref_arrays(model)
    handle = group.submit("torch_mp_cases:train", model=model, feeds=feeds,
                          arrays=arrays, mesh={"dp": 2})
    _, ref = ref_train(model, feeds, mesh={"dp": 2}, arrays=arrays)
    port = assert_ranks_identical(group.collect(handle, timeout=120))
    np.testing.assert_allclose(port["losses"], ref["losses"], rtol=1e-5,
                               atol=1e-7)
    assert_state_close(port["state"], ref["state"])


def test_refusal_holds_under_dp_x_mp(group):
    """The same plan on dp = 2 x mp = 2: the row-mixing op refused,
    naming C16, on every rank."""
    feed = mpc.c17_feeds("cumsum", steps=1)[0]
    msgs = group.run("torch_mp_cases:refusal", model="c17_cumsum",
                     feed=feed, arrays=None, mesh={"dp": 2, "mp": 2})
    for msg in msgs:
        assert msg is not None and msg.startswith("NotImplementedError") \
            and "C16" in msg and "'cumsum'" in msg, msg


def _sweep_axis_specs():
    import test_op_sweep as sweep

    from paddle_tpu_torch.parallel import data_parallel as dpm

    out = []
    for name, spec in sorted(sweep.S.items()):
        attrs = spec.get("attrs") or {}
        if any(k in attrs for k in dpm.AXIS_ATTRS) or \
                name in dpm.IMPLICIT_LAST_AXIS:
            out.append((name, spec))
    return out


def test_every_axis_op_of_the_sweep_is_classified():
    """Every op of the sweep's specs with an axis attr (or an implicit
    last axis), its axis set to 0 and its first input of the batch:
    flagged, unless a reduction (the plan's reducing rule), a
    permutation or size-1/stack dims (AXIS_KEEPS_ROWS)."""
    from paddle_tpu_torch.parallel import data_parallel as dpm

    specs = _sweep_axis_specs()
    assert len(specs) >= 20, [n for n, _ in specs]
    flagged = []
    for name, spec in specs:
        attrs = dict(spec.get("attrs") or {})
        key = next((k for k in dpm.AXIS_ATTRS if k in attrs), "axis")
        v = attrs.get(key)
        attrs[key] = [0] if isinstance(v, (list, tuple)) else 0
        inputs, in_cls, shapes = {}, {}, {}
        for slot, vals in spec["ins"].items():
            vals = vals if isinstance(vals, list) else [vals]
            names = [f"{slot}{i}" for i in range(len(vals))]
            inputs[slot] = names
            for n, a in zip(names, vals):
                shapes[n] = tuple(np.shape(a))
                in_cls[n] = "rep"
        first = next(iter(inputs.values()))[0]
        in_cls[first] = "batch"
        why = dpm.mixes_batch_rows(name, attrs, inputs, in_cls, shapes)
        keeps = (name.startswith("reduce_") or name in dpm.AXIS_KEEPS_ROWS
                 or name in dpm.CROSS_RANK_OPS)
        assert (why is None) == keeps, (name, attrs, why)
        if why:
            flagged.append(name)
    for op in ("argsort", "concat", "cumsum", "reverse", "slice", "split"):
        assert op in flagged, flagged
    # the gather family: a batch index into the batch flagged, a batch
    # index into a replicated table not
    assert dpm.mixes_batch_rows(
        "gather", {}, {"X": ["x"], "Index": ["i"]},
        {"x": "batch", "i": "batch"}, {"x": (3, 4), "i": (3,)})
    assert dpm.mixes_batch_rows(
        "gather", {}, {"X": ["x"], "Index": ["i"]},
        {"x": "rep", "i": "batch"}, {"x": (3, 4), "i": (3,)}) is None
    # an axis away from the batch dim mixes nothing
    assert dpm.mixes_batch_rows(
        "softmax", {"axis": -1}, {"X": ["x"]}, {"x": "batch"},
        {"x": (3, 4)}) is None
    # the batch moved off dim 0 (time-major): the axis naming it flagged
    assert dpm.mixes_batch_rows(
        "softmax", {"axis": -1}, {"X": ["x"]}, {"x": "other"},
        {"x": (5, 3)}, {"x": 1})
    assert dpm.mixes_batch_rows(
        "softmax", {"axis": 0}, {"X": ["x"]}, {"x": "other"},
        {"x": (5, 3)}, {"x": 1}) is None
    # expand tiling the batch dim flagged, tiling another dim not
    assert dpm.mixes_batch_rows(
        "expand", {"expand_times": [2, 1]}, {"X": ["x"]}, {"x": "batch"},
        {"x": (3, 4)})
    assert dpm.mixes_batch_rows(
        "expand", {"expand_times": [1, 2]}, {"X": ["x"]}, {"x": "batch"},
        {"x": (3, 4)}) is None


def test_batch_layout_breaks():
    """An output whose shape changes with the batch on two dims (x @ y^T
    of two batch inputs) pairs rows of the batch; a reshape keeps a
    rank's rows its slice only while the dims before the batch dim are
    1; a batch moved by a transpose keeps its layout."""
    from paddle_tpu_torch.parallel import data_parallel as dpm

    assert dpm._batch_dim((3, 3), (6, 6), 2) is None
    assert dpm._batch_dim((5, 3), (5, 6), 2) == 1
    assert dpm.breaks_batch_layout(
        "matmul", {"x": 0, "y": 0}, {"x": (3, 4), "y": (3, 4)},
        {"o": None}, {"o": (3, 3)})
    assert dpm.breaks_batch_layout(
        "transpose", {"x": 0}, {"x": (3, 4)}, {"o": 1}, {"o": (4, 3)}) \
        is None
    # (B, T, D) -> (B * T, D) keeps the slice; (T, B, D) -> (T * B, D)
    # and (B, D) -> (2, B * D / 2) do not
    assert dpm.breaks_batch_layout(
        "reshape", {"x": 0}, {"x": (3, 5, 4)}, {"o": 0}, {"o": (15, 4)}) \
        is None
    assert dpm.breaks_batch_layout(
        "reshape", {"x": 1}, {"x": (5, 3, 4)}, {"o": 0}, {"o": (15, 4)})
    assert dpm.breaks_batch_layout(
        "reshape", {"x": 0}, {"x": (4, 4)}, {"o": 1}, {"o": (2, 8)})
    assert dpm.breaks_batch_layout(
        "reshape", {"x": 0}, {"x": (4, 4)}, {"o": 1}, {"o": (1, 16)}) \
        is None
