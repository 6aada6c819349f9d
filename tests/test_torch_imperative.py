"""The port's imperative mode (paddle_tpu_torch/imperative.py) on the CPU:
the counterparts of tests/test_imperative.py, and eager gradients held
against the reference's eager gradients on the same inputs and weights
(the layers of one name draw the same default weights in both
packages): fc, conv and embedding layers and a shared var within 1e-5,
a dynamic_lstm on its plain version within the LSTM parity tolerance
of tests/test_torch_lstm.py (gradients rtol 3e-5 / atol 3e-6), and two
backward() calls accumulating."""

import gc

import numpy as np
import pytest
import torch

import paddle_tpu_torch as pt
from paddle_tpu import imperative as ref_imp
from paddle_tpu_torch import imperative

CPU = pt.CPUPlace()
TOL = dict(rtol=1e-5, atol=1e-6)
LSTM_GRAD_TOL = dict(rtol=3e-5, atol=3e-6)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def test_varbase_and_trace_outside_guard():
    v = imperative.to_variable(np.ones((2, 2), np.float32), place=CPU)
    assert v.shape == (2, 2) and v.dtype == "float32"
    with pytest.raises(RuntimeError):
        imperative.trace_op("square", {"X": [v]})
    with pytest.raises(RuntimeError):
        v.backward()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            imperative.to_variable(np.ones(2, np.float32))
        with pytest.raises(RuntimeError, match="CUDA"):
            with imperative.guard():
                pass


def _mlp_grads(mod, place_kw, twice=False):
    rng = np.random.RandomState(0)
    xv = rng.rand(4, 3).astype(np.float32)
    wv = rng.rand(3, 2).astype(np.float32)
    with mod.guard(**place_kw):
        x = mod.to_variable(xv, stop_gradient=True)
        w = mod.to_variable(wv)
        y = mod.trace_op("mul", {"X": [x], "Y": [w]},
                         {"x_num_col_dims": 1, "y_num_col_dims": 1})
        z = mod.trace_op("tanh", {"X": [y]})
        loss = mod.trace_op("reduce_mean", {"X": [z]},
                            {"reduce_all": True, "dim": [0],
                             "keep_dim": False})
        loss.backward()
        if twice:
            loss.backward()
        return _np(w.grad), x.grad, _np(loss.value)


@pytest.mark.parametrize("twice", [False, True])
def test_eager_grad_matches_the_reference_and_accumulates(twice):
    got, x_grad, loss = _mlp_grads(imperative, {"place": CPU}, twice)
    want, ref_x_grad, ref_loss = _mlp_grads(ref_imp, {}, twice)
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(loss, ref_loss, **TOL)
    assert x_grad is None and ref_x_grad is None   # stop_gradient
    if twice:
        once, _, _ = _mlp_grads(imperative, {"place": CPU})
        np.testing.assert_allclose(got, 2 * once, rtol=1e-6)


def test_eager_grad_accumulates_shared_var_and_non_scalar_root():
    v = np.array([1.0, 2.0], np.float32)
    out = {}
    for mod, kw in ((imperative, {"place": CPU}), (ref_imp, {})):
        with mod.guard(**kw):
            a = mod.to_variable(v)
            b = mod.trace_op("elementwise_mul", {"X": [a], "Y": [a]})
            s = mod.trace_op("reduce_sum", {"X": [b]},
                             {"reduce_all": True, "dim": [0],
                              "keep_dim": False})
            s.backward()
            # a non-scalar root takes ones_like(root) as its cotangent
            c = mod.trace_op("scale", {"X": [a]}, {"scale": 3.0})
            a.clear_gradient()
            c.backward()
            out[mod] = (_np(b.value), _np(a.grad), b.grad)
    np.testing.assert_allclose(out[imperative][0], v * v, rtol=1e-6)
    np.testing.assert_allclose(out[imperative][1], out[ref_imp][1], **TOL)
    np.testing.assert_allclose(out[imperative][1], [3.0, 3.0], rtol=1e-6)
    assert out[imperative][2] is None      # non-leaf grads dropped


def _layers_step(mod, kw):
    """fc, conv and embedding layers of fixed names: outputs and every
    parameter's gradient."""
    rng = np.random.RandomState(1)
    res = {}
    with mod.guard(**kw):
        fc = mod.FC(6, 3, act="relu", name="fc_t")
        x = mod.to_variable(rng.rand(5, 6).astype(np.float32),
                            stop_gradient=True)
        y = fc(x)
        conv = mod.Conv2D(3, 4, 3, padding=1, act="relu", name="conv_t")
        img = mod.to_variable(rng.rand(2, 3, 6, 6).astype(np.float32),
                              stop_gradient=True)
        z = conv(img)
        emb = mod.Embedding([10, 6], name="emb_t")
        ids = mod.to_variable(np.array([[1, 2], [3, 0]], np.int64),
                              stop_gradient=True)
        e = emb(ids)
        parts = [mod.trace_op("reduce_mean", {"X": [t]},
                              {"reduce_all": True, "dim": [0],
                               "keep_dim": False}) for t in (y, z, e)]
        s = mod.trace_op("sum", {"X": parts})
        s.backward()
        for layer in (fc, conv, emb):
            for p in layer.parameters():
                res[p.name] = _np(p.grad)
        res["out"] = [_np(t.value) for t in (y, z, e)]
    return res


def test_eager_layers_match_the_reference():
    got = _layers_step(imperative, {"place": CPU})
    want = _layers_step(ref_imp, {})
    assert sorted(got) == sorted(want) and len(got) == 6
    for k in want:
        if k == "out":
            for g, w in zip(got[k], want[k]):
                np.testing.assert_allclose(g, w, **TOL)
        else:
            np.testing.assert_allclose(got[k], want[k], **TOL, err_msg=k)


def _lstm_step(mod, kw, n=3, t=5, h=8):
    rng = np.random.RandomState(2)
    xv = rng.randn(n, t, 4 * h).astype(np.float32) * 0.5
    wv = rng.randn(h, 4 * h).astype(np.float32) * 0.3
    bv = rng.randn(1, 4 * h).astype(np.float32) * 0.1
    lens = np.array([5, 3, 1], np.int32)
    with mod.guard(**kw):
        x, w, b = (mod.to_variable(a) for a in (xv, wv, bv))
        sl = mod.to_variable(lens, stop_gradient=True)
        cell, hidden, last_c, last_h = mod.trace_op(
            "dynamic_lstm",
            {"Input": [x], "Weight": [w], "Bias": [b], "SeqLen": [sl]},
            {"use_peepholes": False, "is_reverse": False})
        loss = mod.trace_op("reduce_sum", {"X": [hidden]},
                            {"reduce_all": True, "dim": [0],
                             "keep_dim": False})
        loss.backward()
        return [_np(hidden.value)] + [_np(v.grad) for v in (x, w, b)]


def test_eager_dynamic_lstm_matches_the_reference():
    from paddle_tpu_torch.ops import kernels

    kernels.reset_counts()
    got = _lstm_step(imperative, {"place": CPU})
    counts = kernels.counts()
    want = _lstm_step(ref_imp, {})
    np.testing.assert_allclose(got[0], want[0], rtol=2e-5, atol=2e-6)
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g, w, **LSTM_GRAD_TOL)
    # the plain versions of the LSTM kernels, once forward and backward
    assert counts["plain"]["lstm_fwd"] == 1
    assert counts["plain"]["lstm_bwd"] == 1
    assert counts["composed"]["dynamic_lstm"] == 0


def test_eager_fc_layer_trains():
    rng = np.random.RandomState(1)
    xv = rng.rand(8, 4).astype(np.float32)
    yv = (xv @ rng.rand(4, 1)).astype(np.float32)
    with imperative.guard(place=CPU) as tracer:
        fc = imperative.FC(4, 1)
        losses = []
        for _ in range(30):
            tracer.reset()
            fc.clear_gradients()
            x = imperative.to_variable(xv, stop_gradient=True)
            y = imperative.to_variable(yv, stop_gradient=True)
            d = imperative.trace_op("elementwise_sub",
                                    {"X": [fc(x)], "Y": [y]})
            sq = imperative.trace_op("square", {"X": [d]})
            loss = imperative.trace_op(
                "reduce_mean", {"X": [sq]},
                {"reduce_all": True, "dim": [0], "keep_dim": False})
            loss.backward()
            losses.append(float(loss.numpy().reshape(())))
            for p in fc.parameters():
                p.value = p.value - 0.3 * p.grad
    assert losses[-1] < losses[0] * 0.1
    assert len(fc.parameters()) == 2


def test_sublayer_parameter_collection():
    class Net(imperative.Layer):
        def __init__(self):
            super().__init__(place=CPU)
            self.fc1 = imperative.FC(4, 8, place=CPU)
            self.fc2 = imperative.FC(8, 1, place=CPU)

        def forward(self, x):
            return self.fc2(self.fc1(x))

    assert len(Net().parameters()) == 4


@pytest.mark.parametrize("opt", ["sgd", "adam"])
def test_eager_optimizers_match_the_reference(opt):
    """Eager training, both packages from the same named layers: the
    losses and final weights within 1e-5; the tape resets each step."""
    rng = np.random.RandomState(1)
    xv = rng.rand(64, 16).astype(np.float32)
    yv = (xv[:, :4].sum(1, keepdims=True) > 2.0).astype(np.float32)
    runs = {}
    for mod, kw in ((imperative, {"place": CPU}), (ref_imp, {})):
        o = (mod.SGDOptimizer(learning_rate=0.5) if opt == "sgd"
             else mod.AdamOptimizer(learning_rate=0.05))
        with mod.guard(**kw) as tracer:
            l1 = mod.FC(16, 16, act="relu", name="l1")
            l2 = mod.FC(16, 1, name="l2")
            params = l1.parameters() + l2.parameters()
            losses = []
            for _ in range(20):
                x = mod.to_variable(xv, stop_gradient=True)
                y = mod.to_variable(yv, stop_gradient=True)
                pred = mod.trace_op("sigmoid", {"X": [l2(l1(x))]})
                err = mod.trace_op("elementwise_sub",
                                   {"X": [pred], "Y": [y]})
                sq = mod.trace_op("square", {"X": [err]})
                loss = mod.trace_op("reduce_mean", {"X": [sq]})
                losses.append(float(loss.numpy().reshape(())))
                o.minimize(loss, params)
                assert tracer.tape == []  # reset each step
            runs[mod] = (losses, [_np(p.value) for p in params])
    np.testing.assert_allclose(runs[imperative][0], runs[ref_imp][0],
                               rtol=1e-5)
    for g, w in zip(runs[imperative][1], runs[ref_imp][1]):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6)
    assert runs[imperative][0][-1] < runs[imperative][0][0]


def test_unnamed_layers_get_distinct_inits():
    with imperative.guard(place=CPU):
        c1, c2 = imperative.Conv2D(3, 4, 3), imperative.Conv2D(3, 4, 3)
        e1, e2 = imperative.Embedding([10, 6]), imperative.Embedding([10, 6])
    assert not np.array_equal(c1.w.numpy(), c2.w.numpy())
    assert not np.array_equal(e1.w.numpy(), e2.w.numpy())


def test_adam_state_drops_with_dead_params():
    opt = imperative.AdamOptimizer(learning_rate=0.01)
    with imperative.guard(place=CPU):
        for _ in range(3):
            fc = imperative.FC(8, 4)
            x = imperative.to_variable(np.ones((2, 8), np.float32),
                                       stop_gradient=True)
            loss = imperative.trace_op("reduce_mean", {"X": [fc(x)]})
            opt.minimize(loss, fc.parameters())
            del fc, x, loss
            gc.collect()
    assert len(opt._state) <= 2  # only the LAST model's 2 params remain
