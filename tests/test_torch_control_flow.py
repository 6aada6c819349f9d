"""Control flow in the port — While / Switch / IfElse / StaticRNN /
DynamicRNN, tensor arrays, beam search, gradients() — held against the
JAX package on the CPU.

- The 26 cases of tests/test_control_flow.py: each program is built in
  both packages (`Program.to_dict()` equal, sub-blocks included), both
  scopes hold the reference's startup values, and both run on the same
  numpy feeds.  Fetched values agree within rtol 1e-5 and atol 1e-6
  (float32 on both sides, other libm and summation orders; integer and
  boolean values exactly); training cases compare every step's loss at
  rtol 1e-5 and the parameters after the last step within 4 * sum(lr),
  as the port's other training parity tests do.  The build-time checks (the logical
  wrappers' module, the axis validation of tensor_array_to_tensor,
  lod_rank_table's sequence check, the failing op named in the error)
  run in the port alone.
- Added cases: a While whose body calls a parameterised `fc`; dropout
  inside a StaticRNN, where each package draws one mask and reuses it
  at every step (the port's sub-block stream differs from block 0's);
  a gradient penalty (a gradients() output inside the loss) trained 3
  Adam steps; tensor-array fetches (the port returns the (buffer,
  length) pair as numpy, the reference with return_numpy=False).
- The port's own properties: `while` reads the condition once per check
  and nothing else on the host; a kernel op's counts rise once per
  iteration inside a While; tensor arrays cross the training step
  detached and merge under gradient accumulation.
"""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

import paddle_tpu as jf
import paddle_tpu_torch as tf

from torch_twin import PKGS, persistables, twins

torch.set_num_threads(2)

TOL = dict(rtol=1e-5, atol=1e-6)


def _json(program):
    return json.dumps(program.to_dict(), sort_keys=True)


def _np(v):
    """A fetched value as numpy (a tensor array's pair as a pair)."""
    if isinstance(v, tuple):
        return tuple(_np(p) for p in v)
    return np.asarray(v)


def _assert_same(got, want, what, tol=TOL):
    if isinstance(want, tuple):
        assert isinstance(got, tuple) and len(got) == len(want), what
        for k, (g, w) in enumerate(zip(got, want)):
            _assert_same(g, w, f"{what}[{k}]", tol)
        return
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, f"{what}: {got.shape} != {want.shape}"
    assert got.dtype == want.dtype, f"{what}: {got.dtype} != {want.dtype}"
    if np.issubdtype(want.dtype, np.floating):
        np.testing.assert_allclose(got, want, err_msg=what, **tol)
    else:
        np.testing.assert_array_equal(got, want, err_msg=what)


# ---------------------------------------------------------------------------
# The cases: body(fluid) builds the program in the current guard and
# returns dict(fetch=[vars], feeds=[feed per run], lr=sum of the
# learning rates over the runs when it trains)
# ---------------------------------------------------------------------------

CASES = {}


def case(fn):
    CASES[fn.__name__] = fn
    return fn


@case
def while_sum(fluid):
    layers = fluid.layers
    i = layers.fill_constant(shape=[1], dtype="int32", value=0)
    n = layers.fill_constant(shape=[1], dtype="int32", value=10)
    acc = layers.fill_constant(shape=[1], dtype="float32", value=0.0)
    cond = layers.less_than(i, n)
    w = layers.While(cond)
    with w.block():
        layers.assign(acc + layers.cast(i, "float32"), acc)
        layers.increment(i, value=1, in_place=True)
        layers.less_than(i, n, cond=cond)
    return dict(fetch=[acc, i], feeds=[{}])


@case
def while_with_array(fluid):
    layers = fluid.layers
    i = layers.fill_constant(shape=[1], dtype="int32", value=0)
    n = layers.fill_constant(shape=[1], dtype="int32", value=5)
    arr = layers.create_array("float32", element_shape=[2], capacity=8)
    cond = layers.less_than(i, n)
    w = layers.While(cond)
    with w.block():
        v = layers.expand(layers.reshape(
            layers.cast(i, "float32"), [1]), [2])
        layers.array_write(v, i, arr)
        layers.increment(i, value=1, in_place=True)
        layers.less_than(i, n, cond=cond)
    stacked, idx = layers.array_to_tensor(arr)
    length = layers.array_length(arr)
    return dict(fetch=[stacked, idx, length], feeds=[{}])


@case
def nested_while(fluid):
    layers = fluid.layers
    i = layers.fill_constant([1], "int32", 0)
    ni = layers.fill_constant([1], "int32", 3)
    total = layers.fill_constant([1], "float32", 0.0)
    cond_o = layers.less_than(i, ni)
    wo = layers.While(cond_o)
    with wo.block():
        j = layers.fill_constant([1], "int32", 0)
        nj = layers.fill_constant([1], "int32", 4)
        cond_i = layers.less_than(j, nj)
        wi = layers.While(cond_i)
        with wi.block():
            layers.assign(total + 1.0, total)
            layers.increment(j, 1)
            layers.less_than(j, nj, cond=cond_i)
        layers.increment(i, 1)
        layers.less_than(i, ni, cond=cond_o)
    return dict(fetch=[total, i], feeds=[{}])


@case
def switch_lr_schedule(fluid):
    layers = fluid.layers
    step = layers.data("step", shape=[1], append_batch_size=False)
    lr = layers.fill_constant([1], "float32", 0.0)
    b1 = layers.fill_constant([1], "float32", 100.0)
    b2 = layers.fill_constant([1], "float32", 200.0)
    with layers.Switch() as sw:
        with sw.case(layers.less_than(step, b1)):
            layers.assign(layers.fill_constant([1], "float32", 0.1), lr)
        with sw.case(layers.less_than(step, b2)):
            layers.assign(layers.fill_constant([1], "float32", 0.01), lr)
        with sw.default():
            layers.assign(layers.fill_constant([1], "float32", 0.001), lr)
    return dict(fetch=[lr], feeds=[{"step": np.array([s], np.float32)}
                                   for s in (50.0, 150.0, 500.0)])


@case
def ifelse_per_row(fluid):
    layers = fluid.layers
    x = layers.data("x", shape=[6, 1], append_batch_size=False)
    zero = layers.fill_constant([6, 1], "float32", 0.0)
    cond = layers.greater_than(x, zero)
    ie = layers.IfElse(cond)
    with ie.true_block():
        ie.output(layers.scale(ie.input(x), scale=2.0))
    with ie.false_block():
        ie.output(layers.scale(ie.input(x), scale=-1.0))
    (o,) = ie()
    xv = np.array([[-2.0], [3.0], [0.5], [-1.0], [0.0], [4.0]], np.float32)
    return dict(fetch=[o], feeds=[{"x": xv}])


@case
def static_rnn_forward_and_grad(fluid):
    layers = fluid.layers
    T, B, D, H = 5, 4, 3, 8
    x = layers.data("x", shape=[T, B, D], append_batch_size=False)
    h0 = layers.fill_constant([B, H], "float32", 0.0)
    rnn = layers.StaticRNN()
    with rnn.step():
        xt = rnn.step_input(x)
        h_prev = rnn.memory(init=h0)
        h = layers.fc(input=[xt, h_prev], size=H, act="tanh",
                      bias_attr=False)
        rnn.update_memory(h_prev, h)
        rnn.step_output(h)
    out = rnn()
    loss = layers.reduce_mean(out)
    fluid.optimizer.SGD(learning_rate=0.5).minimize(loss)
    xv = np.random.RandomState(0).randn(T, B, D).astype(np.float32)
    return dict(fetch=[loss, out], feeds=[{"x": xv}] * 6, lr=None)


@case
def static_rnn_cumsum_semantics(fluid):
    layers = fluid.layers
    T, B, D = 4, 3, 2
    x = layers.data("x", shape=[T, B, D], append_batch_size=False)
    z = layers.fill_constant([B, D], "float32", 0.0)
    rnn = layers.StaticRNN()
    with rnn.step():
        xt = rnn.step_input(x)
        acc = rnn.memory(init=z)
        s = layers.elementwise_add(acc, xt)
        rnn.update_memory(acc, s)
        rnn.step_output(s)
    out = rnn()
    xv = np.random.RandomState(1).rand(T, B, D).astype(np.float32)
    return dict(fetch=[out], feeds=[{"x": xv}])


@case
def dynamic_rnn_masking(fluid):
    layers = fluid.layers
    B, T, D = 3, 5, 2
    x = layers.data("x", shape=[B, T, D], append_batch_size=False,
                    lod_level=1)
    drnn = layers.DynamicRNN()
    with drnn.block():
        xt = drnn.step_input(x)
        acc = drnn.memory(shape=[D], value=0.0)
        s = layers.elementwise_add(acc, xt)
        drnn.update_memory(acc, s)
        drnn.output(s)
    out = drnn()
    last = layers.sequence_last_step(out)
    xv = np.random.RandomState(2).rand(B, T, D).astype(np.float32)
    return dict(fetch=[out, last],
                feeds=[{"x": xv, "x.seq_len": np.array([2, 5, 3],
                                                       np.int32)}])


@case
def dynamic_rnn_trains(fluid):
    layers = fluid.layers
    B, T, D, H = 4, 6, 3, 8
    x = layers.data("x", shape=[B, T, D], append_batch_size=False,
                    lod_level=1)
    y = layers.data("y", shape=[B, 1], append_batch_size=False)
    drnn = layers.DynamicRNN()
    with drnn.block():
        xt = drnn.step_input(x)
        h_prev = drnn.memory(shape=[H], value=0.0)
        h = layers.fc(input=[xt, h_prev], size=H, act="tanh",
                      bias_attr=False)
        drnn.update_memory(h_prev, h)
        drnn.output(h)
    out = drnn()
    last = layers.sequence_last_step(out)
    pred = layers.fc(last, size=1)
    loss = layers.reduce_mean(layers.square_error_cost(pred, y))
    fluid.optimizer.Adam(learning_rate=0.01).minimize(loss)
    rng = np.random.RandomState(1)
    feed = {"x": rng.rand(B, T, D).astype(np.float32),
            "x.seq_len": np.array([3, 6, 2, 5], np.int32),
            "y": rng.rand(B, 1).astype(np.float32)}
    return dict(fetch=[loss], feeds=[feed] * 10, lr=10 * 0.01)


@case
def gradients_basic(fluid):
    layers = fluid.layers
    a = layers.data("a", shape=[3], append_batch_size=False)
    y = layers.reduce_sum(layers.elementwise_mul(a, a))
    (ga,) = fluid.gradients(y, a)
    return dict(fetch=[ga, y],
                feeds=[{"a": np.array([1.0, -2.0, 3.0], np.float32)}])


@case
def gradients_with_cotangent(fluid):
    layers = fluid.layers
    a = layers.data("a", shape=[3], append_batch_size=False)
    w = layers.data("w", shape=[3], append_batch_size=False)
    y = layers.elementwise_mul(a, a)
    (ga,) = fluid.gradients([y], [a], target_gradients=[w])
    return dict(fetch=[ga],
                feeds=[{"a": np.array([1.0, 2.0, 3.0], np.float32),
                        "w": np.array([1.0, 0.0, 2.0], np.float32)}])


@case
def gradients_wrt_intermediate_var(fluid):
    # the producer of an input must not overwrite its node (zeros)
    layers = fluid.layers
    a = layers.data("a", shape=[3], append_batch_size=False)
    b = layers.scale(a, scale=2.0)
    y = layers.reduce_sum(layers.elementwise_mul(b, b))
    (gb,) = fluid.gradients(y, b)
    return dict(fetch=[gb],
                feeds=[{"a": np.array([1.0, 2.0, 3.0], np.float32)}])


@case
def gradients_ignores_unrelated_unfed_branch(fluid):
    layers = fluid.layers
    a = layers.data("a", shape=[3], append_batch_size=False)
    yy = layers.data("yy", shape=[4], append_batch_size=False)
    layers.reduce_sum(yy)
    t = layers.reduce_sum(layers.elementwise_mul(a, a))
    (ga,) = fluid.gradients(t, a)
    return dict(fetch=[ga],
                feeds=[{"a": np.array([1.0, 2.0, 3.0], np.float32)}])


@case
def double_grad(fluid):
    layers = fluid.layers
    a = layers.data("a", shape=[3], append_batch_size=False)
    y = layers.reduce_sum(
        layers.elementwise_mul(layers.elementwise_mul(a, a), a))
    (g1,) = fluid.gradients(y, a)      # 3x^2
    s = layers.reduce_sum(g1)
    (g2,) = fluid.gradients(s, a)      # 6x
    return dict(fetch=[g1, g2],
                feeds=[{"a": np.array([1.0, 2.0, -1.0], np.float32)}])


@case
def beam_search_step(fluid):
    layers = fluid.layers
    B, K, V = 2, 3, 6
    pid = layers.data("pid", shape=[B, K], dtype="int64",
                      append_batch_size=False)
    psc = layers.data("psc", shape=[B, K], append_batch_size=False)
    sc = layers.data("sc", shape=[B, K, V], append_batch_size=False)
    ids, scores, parent = layers.beam_search(pid, psc, sc, beam_size=K,
                                             end_id=1)
    rng = np.random.RandomState(0)
    feed = {"pid": np.zeros((B, K), np.int64),
            "psc": rng.rand(B, K).astype(np.float32),
            "sc": np.log(rng.dirichlet(np.ones(V), size=(B, K)))
            .astype(np.float32)}
    # ties: equal totals across beams and tokens pick the lower index
    tied = {"pid": np.zeros((B, K), np.int64),
            "psc": np.zeros((B, K), np.float32),
            "sc": np.tile(np.log(np.full(V, 1.0 / V, np.float32)),
                          (B, K, 1))}
    return dict(fetch=[ids, scores, parent], feeds=[feed, tied])


@case
def beam_search_finished_beams_frozen(fluid):
    layers = fluid.layers
    B, K, V = 1, 2, 4
    pid = layers.data("pid", shape=[B, K], dtype="int64",
                      append_batch_size=False)
    psc = layers.data("psc", shape=[B, K], append_batch_size=False)
    sc = layers.data("sc", shape=[B, K, V], append_batch_size=False)
    ids, scores, parent = layers.beam_search(pid, psc, sc, beam_size=K,
                                             end_id=1)
    ids0, scores0, parent0 = layers.beam_search(pid, psc, sc, beam_size=K,
                                                end_id=1,
                                                is_first_step=True)
    feed = {"pid": np.array([[1, 0]], np.int64),
            "psc": np.array([[5.0, 0.0]], np.float32),
            "sc": np.full((B, K, V), -2.0, np.float32)}
    return dict(fetch=[ids, scores, parent, ids0, scores0, parent0],
                feeds=[feed])


@case
def beam_search_decode_backtrace(fluid):
    layers = fluid.layers
    T, B, K = 3, 1, 2
    ids = layers.data("ids", shape=[T, B, K], dtype="int64",
                      append_batch_size=False)
    par = layers.data("par", shape=[T, B, K], dtype="int32",
                      append_batch_size=False)
    n = layers.data("n", shape=[1], dtype="int32", append_batch_size=False)
    sents = layers.beam_search_decode(ids, par, end_id=0)
    cut = layers.beam_search_decode(ids, par, num_steps=n, end_id=0)
    feed = {"ids": np.array([[[5, 6]], [[7, 8]], [[9, 9]]], np.int64),
            "par": np.array([[[0, 0]], [[1, 0]], [[0, 0]]], np.int32),
            "n": np.array([2], np.int32)}
    return dict(fetch=[sents, cut], feeds=[feed])


MT_B, MT_TSRC, MT_TTRG, MT_V = 4, 8, 7, 50


def mt_feed(seed=0):
    rng = np.random.RandomState(seed)
    B, Ts, Tt, V = MT_B, MT_TSRC, MT_TTRG, MT_V
    return {
        "src_word_id": rng.randint(2, V, (B, Ts)).astype(np.int64),
        "src_word_id.seq_len": rng.randint(3, Ts + 1, B).astype(np.int32),
        "trg_word_id": rng.randint(2, V, (B, Tt)).astype(np.int64),
        "trg_word_id.seq_len": rng.randint(3, Tt + 1, B).astype(np.int32),
        "trg_next_id": rng.randint(2, V, (B, Tt)).astype(np.int64),
    }


@case
def machine_translation_train(fluid):
    from importlib import import_module

    mt = import_module(f"{fluid.__name__}.models.machine_translation")
    avg_cost, _ = mt.seq_to_seq_net(
        src_vocab_size=MT_V, trg_vocab_size=MT_V, embed_dim=16,
        hidden_dim=32, batch_size=MT_B, max_src_len=MT_TSRC,
        max_trg_len=MT_TTRG)
    fluid.optimizer.Adam(learning_rate=2e-3).minimize(avg_cost)
    return dict(fetch=[avg_cost], feeds=[mt_feed()] * 8, lr=8 * 2e-3)


@case
def tensor_array_to_tensor_concat_and_stack(fluid):
    layers = fluid.layers
    x = layers.data("x", shape=[3, 2, 4], append_batch_size=False)
    arr = layers.create_array("float32", element_shape=[2, 4], capacity=3)
    for i in range(3):
        xi = layers.squeeze(
            layers.slice(x, axes=[0], starts=[i], ends=[i + 1]), axes=[0])
        layers.array_write(xi, layers.fill_constant([1], "int64", i), arr)
    cat, cat_idx = layers.tensor_array_to_tensor(arr, axis=1)
    stk, stk_idx = layers.tensor_array_to_tensor(arr, axis=0,
                                                 use_stack=True)
    tail, _ = layers.tensor_array_to_tensor(arr, axis=2, use_stack=True)
    xv = np.random.RandomState(0).randn(3, 2, 4).astype(np.float32)
    return dict(fetch=[cat, cat_idx, stk, stk_idx, tail], feeds=[{"x": xv}])


@case
def lod_rank_table_and_reorder(fluid):
    layers = fluid.layers
    x = layers.data("x", shape=[4, 3, 2], append_batch_size=False,
                    lod_level=1)
    table = layers.lod_rank_table(x)
    y = layers.reorder_lod_tensor_by_rank(x, table)
    ylen = layers.seq_len_var(y)
    xv = np.arange(24, dtype=np.float32).reshape(4, 3, 2)
    return dict(fetch=[table, y, ylen],
                feeds=[{"x": xv, "x.seq_len": np.array([2, 3, 1, 3],
                                                       np.int32)}])


def _unrolled_static(fluid, unroll):
    layers = fluid.layers
    T, B, D = 6, 3, 2
    x = layers.data("x", shape=[T, B, D], append_batch_size=False)
    z = layers.fill_constant([B, D], "float32", 0.0)
    rnn = layers.StaticRNN(unroll=unroll)
    with rnn.step():
        xt = rnn.step_input(x)
        acc = rnn.memory(init=z)
        s = layers.tanh(layers.elementwise_add(acc, xt))
        rnn.update_memory(acc, s)
        rnn.step_output(s)
    return rnn()


@case
def static_rnn_unroll_equivalent(fluid):
    outs = [_unrolled_static(fluid, k) for k in (1, 2, 4)]
    xv = np.random.RandomState(5).randn(6, 3, 2).astype(np.float32)
    return dict(fetch=outs, feeds=[{"x": xv}])


def _unrolled_dynamic(fluid, unroll):
    layers = fluid.layers
    B, T, D = 3, 5, 2
    x = layers.data("x", shape=[B, T, D], append_batch_size=False,
                    lod_level=1)
    drnn = layers.DynamicRNN(unroll=unroll)
    with drnn.block():
        xt = drnn.step_input(x)
        mem = drnn.memory(shape=[D], value=0.0)
        s = layers.tanh(layers.elementwise_add(mem, xt))
        drnn.update_memory(mem, s)
        drnn.output(s)
    return drnn()


@case
def dynamic_rnn_unroll_equivalent(fluid):
    outs = [_unrolled_dynamic(fluid, k) for k in (1, 3)]
    xv = np.random.RandomState(6).randn(3, 5, 2).astype(np.float32)
    return dict(fetch=outs, feeds=[{"x": xv, "x.seq_len": np.array(
        [5, 3, 1], np.int32)}])


# -- added cases ------------------------------------------------------------

@case
def while_body_calls_fc(fluid):
    layers = fluid.layers
    x = layers.data("x", shape=[4, 6], append_batch_size=False)
    h = layers.assign(x)
    i = layers.fill_constant([1], "int32", 0)
    n = layers.fill_constant([1], "int32", 3)
    cond = layers.less_than(i, n)
    w = layers.While(cond)
    with w.block():
        nh = layers.fc(h, size=6, act="tanh",
                       param_attr=fluid.ParamAttr(name="loop.w"),
                       bias_attr=fluid.ParamAttr(name="loop.b"))
        layers.assign(nh, h)
        layers.increment(i, 1)
        layers.less_than(i, n, cond=cond)
    xv = np.random.RandomState(7).randn(4, 6).astype(np.float32)
    return dict(fetch=[h, i], feeds=[{"x": xv}])


@case
def gradient_penalty_trains(fluid):
    layers = fluid.layers
    x = layers.data("x", shape=[8, 5], append_batch_size=False)
    y = layers.data("y", shape=[8, 1], append_batch_size=False)
    h = layers.fc(x, size=16, act="tanh")
    pred = layers.fc(h, size=1)
    (gx,) = fluid.gradients(layers.reduce_sum(pred), x)
    penalty = layers.reduce_mean(layers.elementwise_mul(gx, gx))
    mse = layers.reduce_mean(layers.square_error_cost(pred, y))
    loss = layers.elementwise_add(mse, layers.scale(penalty, scale=0.5))
    fluid.optimizer.Adam(learning_rate=1e-2).minimize(loss)
    rng = np.random.RandomState(8)
    feed = {"x": rng.randn(8, 5).astype(np.float32),
            "y": rng.randn(8, 1).astype(np.float32)}
    return dict(fetch=[loss, penalty, gx], feeds=[feed] * 3, lr=3 * 1e-2)


@case
def tensor_array_fetches(fluid):
    layers = fluid.layers
    x = layers.data("x", shape=[2, 3], append_batch_size=False)
    arr = layers.create_array("float32", element_shape=[2, 3], capacity=4)
    ids = layers.create_array("int64", element_shape=[2], capacity=4)
    i = layers.fill_constant([1], "int32", 0)
    n = layers.fill_constant([1], "int32", 3)
    cond = layers.less_than(i, n)
    w = layers.While(cond)
    with w.block():
        layers.array_write(layers.scale(x, scale=2.0), i, arr)
        layers.array_write(layers.fill_constant([2], "int64", 7), i, ids)
        layers.increment(i, 1)
        layers.less_than(i, n, cond=cond)
    back = layers.array_read(arr, layers.fill_constant([1], "int32", 1))
    xv = np.random.RandomState(9).randn(2, 3).astype(np.float32)
    return dict(fetch=[arr, ids, back], feeds=[{"x": xv}])


def _run_side(side, tw, spec_of):
    main, scope, exe, spec = tw[side]
    fetch = spec["fetch"]
    outs = []
    for feed in spec["feeds"]:
        got = exe.run(main, feed=feed, fetch_list=fetch, scope=scope,
                      return_numpy=side == "port")
        outs.append([_np(v) for v in got])
    return outs


@pytest.mark.parametrize("name", sorted(CASES))
def test_case_matches_the_reference(name):
    tw = twins(CASES[name])
    assert _json(tw["port"][0]) == _json(tw["ref"][0])
    runs = {side: _run_side(side, tw, CASES[name]) for side in PKGS}
    spec = tw["port"][3]
    trains = "lr" in spec
    for step, (got, want) in enumerate(zip(runs["port"], runs["ref"])):
        for k, (g, w) in enumerate(zip(got, want)):
            what = f"{name} run {step} fetch {k}"
            if trains and k > 0 and step > 0:
                continue  # later steps: the loss, and parameters below
            _assert_same(g, w, what)
    if trains:
        got = persistables(tw["port"][0], tw["port"][1])
        want = persistables(tw["ref"][0], tw["ref"][1])
        assert set(got) == set(want)
        for n in want:
            if spec["lr"] is None:   # SGD: smooth in the parameters
                np.testing.assert_allclose(got[n], want[n], rtol=1e-4,
                                           atol=1e-6, err_msg=n)
            else:
                np.testing.assert_allclose(got[n], want[n], rtol=0,
                                           atol=4 * spec["lr"] + 1e-6,
                                           err_msg=n)


# ---------------------------------------------------------------------------
# Build-time checks (the port alone, as the reference's tests assert them)
# ---------------------------------------------------------------------------

def test_logical_wrappers_write_into_out():
    layers = tf.layers
    assert layers.logical_not.__module__ == \
        "paddle_tpu_torch.layers.control_flow"
    assert layers.less_than.__module__ == \
        "paddle_tpu_torch.layers.control_flow"
    main, startup = tf.Program(), tf.Program()
    with tf.program_guard(main, startup):
        a = layers.fill_constant([2], "bool", 1.0)
        o = layers.fill_constant([2], "bool", 0.0)
        assert layers.logical_not(a, out=o) is o
        assert layers.logical_and(a, a, out=o) is o


def test_error_context_names_failing_op():
    main, startup = tf.Program(), tf.Program()
    layers = tf.layers
    with tf.program_guard(main, startup):
        x = layers.data("x", shape=[4], append_batch_size=False)
        y = layers.data("y", shape=[5], append_batch_size=False)
        z = layers.elementwise_add(x, y)
    with pytest.raises(Exception) as ei:
        tf.Executor(tf.CPUPlace()).run(
            main, feed={"x": np.zeros(4, np.float32),
                        "y": np.zeros(5, np.float32)}, fetch_list=[z])
    assert "elementwise_add" in str(ei.value)


def test_error_inside_a_sub_block_names_both_ops():
    main, startup = tf.Program(), tf.Program()
    layers = tf.layers
    with tf.program_guard(main, startup):
        i = layers.fill_constant([1], "int32", 0)
        n = layers.fill_constant([1], "int32", 2)
        acc = layers.fill_constant([4], "float32", 0.0)
        bad = layers.fill_constant([5], "float32", 1.0)
        cond = layers.less_than(i, n)
        w = layers.While(cond)
        with w.block():
            layers.assign(layers.elementwise_add(acc, bad), acc)
            layers.increment(i, 1)
            layers.less_than(i, n, cond=cond)
    with pytest.raises(Exception) as ei:
        tf.Executor(tf.CPUPlace()).run(main, fetch_list=[acc])
    assert "'while'" in str(ei.value)
    assert "elementwise_add" in str(ei.value)


def test_lod_rank_table_requires_sequence():
    main, startup = tf.Program(), tf.Program()
    with tf.program_guard(main, startup):
        x = tf.layers.data("plain", shape=[4, 3], append_batch_size=False)
        with pytest.raises(ValueError, match="seq_len"):
            tf.layers.lod_rank_table(x)


def test_tensor_array_to_tensor_axis_validation():
    layers = tf.layers
    main, startup = tf.Program(), tf.Program()
    with tf.program_guard(main, startup):
        arr = layers.create_array("float32", element_shape=[2, 4],
                                  capacity=3)
        tail, _ = layers.tensor_array_to_tensor(arr, axis=2, use_stack=True)
        assert tuple(tail.shape) == (2, 4, 3)
        with pytest.raises(ValueError, match="out of range"):
            layers.tensor_array_to_tensor(arr, axis=2)
        with pytest.raises(ValueError, match="out of range"):
            layers.tensor_array_to_tensor(arr, axis=3, use_stack=True)
        scal = layers.create_array("float32", element_shape=[],
                                   capacity=3)
        with pytest.raises(ValueError, match="scalar"):
            layers.tensor_array_to_tensor(scal, axis=0)


def test_gradients_inside_a_sub_block_is_refused():
    layers = tf.layers
    main, startup = tf.Program(), tf.Program()
    with tf.program_guard(main, startup):
        a = layers.data("a", shape=[3], append_batch_size=False)
        i = layers.fill_constant([1], "int32", 0)
        cond = layers.less_than(i, layers.fill_constant([1], "int32", 1))
        w = layers.While(cond)
        with pytest.raises(RuntimeError, match="sub-block"):
            with w.block():
                tf.gradients(layers.reduce_sum(a), a)


# ---------------------------------------------------------------------------
# Random streams in sub-blocks
# ---------------------------------------------------------------------------

def _dropout_rnn(fluid, T=4, B=3, D=64):
    layers = fluid.layers
    z = layers.data("z", shape=[B, D], append_batch_size=False)
    x = layers.data("x", shape=[T, B, D], append_batch_size=False)
    # op 0 of block 0: a dropout of the step's shape, the index of the
    # sub-block's dropout within its own block
    top = layers.dropout(z, dropout_prob=0.5)
    init = layers.fill_constant([B, D], "float32", 0.0)
    rnn = layers.StaticRNN()
    with rnn.step():
        xt = rnn.step_input(x)
        acc = rnn.memory(init=init)
        d = layers.dropout(xt, dropout_prob=0.5)
        rnn.update_memory(acc, layers.elementwise_add(acc, d))
        rnn.step_output(d)
    return rnn(), top


@pytest.mark.parametrize("side", sorted(PKGS))
def test_dropout_in_static_rnn_reuses_one_mask(side):
    """Each package draws one dropout mask inside the StaticRNN and
    reuses it at every step (the reference's scan body is traced once
    with one key; the port's sub-block ops take their generators from
    the run's seed with the block folded in, never the iteration).  The
    sub-block's stream is not block 0's: the dropout at the same op
    index and shape in block 0 draws another mask.  The two packages'
    masks differ from each other (ROADMAP C2)."""
    fluid = PKGS[side]
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = 11
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        out, top = _dropout_rnn(fluid)
    assert main.global_block().ops[0].desc.type == "dropout"
    assert main.blocks[1].ops[0].desc.type == "dropout"
    exe = fluid.Executor(fluid.CPUPlace())
    o, t = exe.run(main, feed={"x": np.ones((4, 3, 64), np.float32),
                               "z": np.ones((3, 64), np.float32)},
                   fetch_list=[out, top])
    o, t = np.asarray(o), np.asarray(t)
    kept = o != 0
    assert 0.3 < kept.mean() < 0.7
    for step in range(1, 4):
        np.testing.assert_array_equal(o[step], o[0])
    assert not np.array_equal(t != 0, kept[0])


def test_sub_block_seed_material_folds_the_block(monkeypatch):
    """OpContext.run_block hands the sub-block the run's seed material
    with 7919 + block index folded in after any micro-batch fold (the
    reference's fold_in(key, 7919 + block_idx)); no sparse rows go
    down."""
    from paddle_tpu_torch.core import executor as texec
    from paddle_tpu_torch.core.registry import OpContext

    seen = []
    monkeypatch.setattr(texec, "run_ops",
                        lambda ops, env, seed, **kw: seen.append((seed, kw)))
    main = tf.Program()
    main._create_block()
    main._rollback()
    for seed, want in (((5, 2), (5, 2, 7920)),
                       ((5, 2, 31338), (5, 2, 31338, 7920))):
        OpContext(seed, program=main, device="cpu",
                  sparse_rows={0: None}).run_block(1, {})
        assert seen[-1][0] == want
        assert "sparse_rows" not in seen[-1][1]


# ---------------------------------------------------------------------------
# The port's own properties
# ---------------------------------------------------------------------------

def test_while_reads_the_condition_once_per_check(monkeypatch):
    """`while` makes one device→host read a condition check (n
    iterations: n + 1 reads), and no other op of the loop reads."""
    main, startup, spec = None, None, None
    main, startup = tf.Program(), tf.Program()
    with tf.program_guard(main, startup), tf.unique_name.guard():
        spec = while_with_array(tf)
    reads = []
    real = torch.Tensor.item

    def counting(self):
        reads.append(tuple(self.shape))
        return real(self)

    monkeypatch.setattr(torch.Tensor, "item", counting)
    out = tf.Executor(tf.CPUPlace()).run(main, fetch_list=spec["fetch"],
                                         return_numpy=False)
    assert len(reads) == 5 + 1
    assert int(out[2][0]) == 5


def test_switch_reads_the_branch_index_once(monkeypatch):
    main, startup = tf.Program(), tf.Program()
    with tf.program_guard(main, startup), tf.unique_name.guard():
        spec = switch_lr_schedule(tf)
    reads = []
    real = torch.Tensor.item
    monkeypatch.setattr(torch.Tensor, "item",
                        lambda self: reads.append(1) or real(self))
    exe = tf.Executor(tf.CPUPlace())
    for feed, want in zip(spec["feeds"], (0.1, 0.01, 0.001)):
        reads.clear()
        (v,) = exe.run(main, feed=feed, fetch_list=spec["fetch"],
                       return_numpy=False)
        assert len(reads) == 1
        assert float(v[0]) == pytest.approx(want)


def test_kernel_op_in_a_while_body_counts_each_iteration(monkeypatch):
    """A flash_attention op inside a While runs once per iteration: its
    wrapper's count rises by exactly the trip count (on the CPU the
    plain version's count; chip_smoke phase 6s holds the kernel's launch
    count on the card), and the result equals one call of the op."""
    from paddle_tpu_torch.ops import kernels

    layers = tf.layers
    N, H, T, D = 2, 2, 16, 8
    main, startup = tf.Program(), tf.Program()
    with tf.program_guard(main, startup), tf.unique_name.guard():
        q = layers.data("q", shape=[N, H, T, D], append_batch_size=False)
        o = layers.fill_constant([N, H, T, D], "float32", 0.0)
        i = layers.fill_constant([1], "int32", 0)
        n = layers.fill_constant([1], "int32", 8)
        cond = layers.less_than(i, n)
        w = layers.While(cond)
        with w.block():
            layers.assign(layers.flash_attention(q, q, q, causal=True), o)
            layers.increment(i, 1)
            layers.less_than(i, n, cond=cond)
        once = layers.flash_attention(q, q, q, causal=True)
    qv = np.random.RandomState(3).randn(N, H, T, D).astype(np.float32)
    kernels.reset_counts()
    got, ref = tf.Executor(tf.CPUPlace()).run(
        main, feed={"q": qv}, fetch_list=[o, once])
    counts = kernels.counts()
    assert counts["plain"]["flash_attention_fwd"] == 8 + 1
    np.testing.assert_array_equal(got, ref)


def test_tensor_arrays_cross_the_training_step_detached():
    """A tensor array written in a training forward comes back from the
    step without autograd history, with and without accumulation (under
    accumulation its parts merge by the micro-batches' fetch rule: a
    buffer whose leading dim is not the micro batch is averaged)."""
    layers = tf.layers
    main, startup = tf.Program(), tf.Program()
    with tf.program_guard(main, startup), tf.unique_name.guard():
        x = layers.data("x", shape=[4, 3], append_batch_size=False)
        h = layers.reduce_mean(layers.fc(x, size=2))
        arr = layers.create_array("float32", element_shape=[1],
                                  capacity=3)
        one = layers.fill_constant([1], "int32", 1)
        layers.array_write(h, one, arr)
        loss = layers.reduce_mean(layers.array_read(arr, one))
        tf.optimizer.SGD(learning_rate=0.1).minimize(loss)
    exe = tf.Executor(tf.CPUPlace())
    scope = tf.Scope()
    exe.run(startup, scope=scope)
    feed = {"x": np.random.RandomState(0).randn(4, 3).astype(np.float32)}
    for k in (1, 2):
        lv, (buf, length) = exe.run(main, feed=feed, fetch_list=[loss, arr],
                                    scope=scope, return_numpy=False,
                                    accumulation_steps=k)
        assert not buf.requires_grad and not length.requires_grad
        assert tuple(buf.shape) == (3, 1)
        np.testing.assert_allclose(float(lv.reshape(-1)[0]),
                                   float(buf[1, 0]), rtol=1e-6)
        assert float(length) == 2


def _rnn_regression(fluid, recompute=False):
    """fc → DynamicRNN (fc + tanh steps) → last step → fc, SGD; with
    `recompute` the first three inside one recompute_scope."""
    from contextlib import nullcontext

    layers = fluid.layers
    B, T, D, H = 4, 5, 3, 6
    x = layers.data("x", shape=[B, T, D], append_batch_size=False,
                    lod_level=1)
    y = layers.data("y", shape=[B, 1], append_batch_size=False)
    with fluid.recompute_scope() if recompute else nullcontext():
        xp = layers.fc(x, size=H, num_flatten_dims=2, act="tanh")
        drnn = layers.DynamicRNN()
        with drnn.block():
            xt = drnn.step_input(xp)
            h_prev = drnn.memory(shape=[H], value=0.0)
            h = layers.fc(input=[xt, h_prev], size=H, act="tanh")
            drnn.update_memory(h_prev, h)
            drnn.output(h)
        last = layers.sequence_last_step(drnn())
    pred = layers.fc(last, size=1)
    loss = layers.reduce_mean(layers.square_error_cost(pred, y))
    fluid.optimizer.SGD(learning_rate=0.1).minimize(loss)
    return loss


def _rnn_feed(seed=0):
    rng = np.random.RandomState(seed)
    return {"x": rng.rand(4, 5, 3).astype(np.float32),
            "x.seq_len": np.array([3, 5, 1, 4], np.int32),
            "y": rng.rand(4, 1).astype(np.float32)}


def test_numerics_attribute_a_sub_block_fault_to_its_macro_op():
    """With numerics on, a NaN fed to the first op is latched under that
    op, and one born inside the DynamicRNN's sub-block under the
    dynamic_rnn op's index, in both packages (the sub-block's
    block-local op indices never reach the bitmap)."""
    from paddle_tpu import observe as jobs
    from paddle_tpu_torch import observe as tobs

    obs = {"ref": jobs, "port": tobs}
    fno = {}
    for side, (main, scope, exe, loss) in twins(
            _rnn_regression,
            prepare=lambda f, m: obs["ref" if f is jf else "port"]
            .enable_numerics(m)).items():
        bad = _rnn_feed()
        bad["x"][1, 2, 0] = np.nan
        exe.run(main, feed=_rnn_feed(), fetch_list=[loss], scope=scope)
        exe.run(main, feed=bad, fetch_list=[loss], scope=scope)
        fno[side] = obs[side].fetch_telemetry(
            scope, program=main).first_nonfinite_op
        ops = main.global_block().ops
        assert ops[fno[side]["op_index"]].desc.type == "mul", fno[side]
    assert fno["port"] == fno["ref"]
    # a NaN that only the sub-block makes: log of a negative value
    fno = {}
    for side, (main, scope, exe, loss) in twins(
            _log_rnn,
            prepare=lambda f, m: obs["ref" if f is jf else "port"]
            .enable_numerics(m)).items():
        exe.run(main, feed=_rnn_feed(), fetch_list=[loss], scope=scope)
        fno[side] = obs[side].fetch_telemetry(
            scope, program=main).first_nonfinite_op
        ops = main.global_block().ops
        assert ops[fno[side]["op_index"]].desc.type == "dynamic_rnn", \
            fno[side]
    assert fno["port"] == fno["ref"]


def _log_rnn(fluid):
    """A DynamicRNN whose step takes the log of (memory - 1): NaN from
    the first step on, made inside the sub-block only."""
    layers = fluid.layers
    x = layers.data("x", shape=[4, 5, 3], append_batch_size=False,
                    lod_level=1)
    y = layers.data("y", shape=[4, 1], append_batch_size=False)
    drnn = layers.DynamicRNN()
    with drnn.block():
        xt = drnn.step_input(x)
        h_prev = drnn.memory(shape=[3], value=0.0)
        h = layers.log(layers.scale(layers.elementwise_add(h_prev, xt),
                                    bias=-1.0))
        drnn.update_memory(h_prev, h)
        drnn.output(h)
    last = layers.sequence_last_step(drnn())
    pred = layers.fc(last, size=1)
    loss = layers.reduce_mean(layers.square_error_cost(pred, y))
    fluid.optimizer.SGD(learning_rate=0.1).minimize(loss)
    return loss


def test_recompute_scope_around_a_dynamic_rnn():
    """A macro op never joins a recompute segment (the reference's
    run_ops, :200-204): a recompute_scope around fc + DynamicRNN +
    sequence_last_step trains bit for bit as the plain program in the
    port, and as the reference within rtol 1e-5."""
    runs = {}
    for label, rec in (("plain", False), ("recompute", True)):
        tw = twins(lambda f, rec=rec: _rnn_regression(f, rec))
        assert _json(tw["port"][0]) == _json(tw["ref"][0])
        for side, (main, scope, exe, loss) in tw.items():
            losses = [float(np.asarray(exe.run(
                main, feed=_rnn_feed(s), fetch_list=[loss],
                scope=scope)[0]).reshape(-1)[0]) for s in range(3)]
            runs[label, side] = (losses, persistables(main, scope))
    assert runs["recompute", "port"][0] == runs["plain", "port"][0]
    got, want = runs["recompute", "port"][1], runs["plain", "port"][1]
    for n in want:
        np.testing.assert_array_equal(got[n], want[n], err_msg=n)
    np.testing.assert_allclose(runs["recompute", "port"][0],
                               runs["recompute", "ref"][0], rtol=1e-5)


def _amp_rnn(fluid, mode, amp=True):
    """A tanh RNN, T 5, B 4, unrolled in block 0 or as a StaticRNN (the
    same ops, the same parameter names), then row sums and the
    regression loss; SGD, under AMP the fcs' `mul` ops the only
    white-list ops."""
    layers = fluid.layers
    T, B, D, H = 5, 4, 3, 6
    x = layers.data("x", shape=[T, B, D], append_batch_size=False)
    y = layers.data("y", shape=[B, 1], append_batch_size=False)
    h0 = layers.fill_constant([B, H], "float32", 0.0)

    def cell(xt, h):
        return layers.tanh(layers.elementwise_add(
            layers.fc(xt, size=H, param_attr=fluid.ParamAttr(name="w0"),
                      bias_attr=False),
            layers.fc(h, size=H, param_attr=fluid.ParamAttr(name="w1"),
                      bias_attr=fluid.ParamAttr(name="b"))))

    if mode == "unrolled":
        h = h0
        for t in range(T):
            h = cell(layers.reshape(layers.slice(
                x, axes=[0], starts=[t], ends=[t + 1]), [B, D]), h)
    else:
        rnn = layers.StaticRNN()
        with rnn.step():
            hp = rnn.memory(init=h0)
            h = cell(rnn.step_input(x), hp)
            rnn.update_memory(hp, h)
            rnn.step_output(h)
        h = layers.reshape(layers.slice(rnn(), axes=[0], starts=[T - 1],
                                        ends=[T]), [B, H])
    pred = layers.reduce_sum(h, dim=1, keep_dim=True)
    loss = layers.reduce_mean(layers.square_error_cost(pred, y))
    opt = fluid.optimizer.SGD(learning_rate=0.1)
    (fluid.amp.decorate(opt) if amp else opt).minimize(loss)
    return loss


def test_amp_policy_reaches_the_sub_block(monkeypatch):
    """The program's bf16 policy casts the ops of a sub-block as it
    casts block 0's: a StaticRNN under AMP trains bit for bit as the
    same cell unrolled in block 0, in the port; AMP moves the losses;
    and the step-1 loss is the reference's (its bf16 roundings kept,
    tests/torch_amp_parity.py) within rtol 1e-6.  Later steps are not
    held to the reference: its AMP gradients differ from the port's by
    a bf16 ulp with or without a sub-block (the unrolled program too;
    ROADMAP C's AMP rounding flips)."""
    from torch_amp_parity import keep_reference_roundings

    keep_reference_roundings(monkeypatch)
    rng = np.random.RandomState(0)
    feeds = [{"x": rng.rand(5, 4, 3).astype(np.float32),
              "y": rng.rand(4, 1).astype(np.float32)} for _ in range(3)]
    losses = {}
    for mode, amp in (("static", True), ("unrolled", True),
                      ("static", False)):
        for side, (main, scope, exe, loss) in twins(
                lambda f, m=mode, a=amp: _amp_rnn(f, m, a)).items():
            losses[side, mode, amp] = [
                float(np.asarray(exe.run(main, feed=f, fetch_list=[loss],
                                         scope=scope)[0]).reshape(-1)[0])
                for f in feeds]
    assert losses["port", "static", True] == \
        losses["port", "unrolled", True]
    assert losses["port", "static", True] != \
        losses["port", "static", False]
    np.testing.assert_allclose(losses["port", "static", True][0],
                               losses["ref", "static", True][0], rtol=1e-6)
    np.testing.assert_allclose(losses["port", "static", False],
                               losses["ref", "static", False], rtol=1e-5)
