"""The port's host metrics (paddle_tpu_torch/metrics.py), the in-graph
ChunkEvaluator (evaluator.py), contrib.slim's pruners and distillation
loss, debugger's text and the package surface, against the reference's
on the same inputs.  Metrics, masks, sparsity and text are held exactly;
the distillation loss (float32 softmaxes in both packages) within 1e-6."""

import numpy as np
import pytest
import torch

import paddle_tpu as jf
import paddle_tpu_torch as pt
from paddle_tpu import metrics as ref_metrics
from paddle_tpu.contrib import slim as ref_slim
from paddle_tpu_torch import metrics
from paddle_tpu_torch.contrib import slim

from tests.torch_twin import twins

CPU = pt.CPUPlace()
TOL_DISTILL = 1e-6


def _feeds(rng):
    """Per-metric update arguments: numpy for the reference, the same
    values as torch tensors (and numbers) for the port."""
    scores = rng.rand(200).astype(np.float32)
    labels = rng.randint(0, 2, 200)
    probs = np.stack([1 - scores, scores], 1)
    dist = rng.randint(0, 3, (7, 1)).astype(np.float32)
    return {
        "Precision": [(scores, labels)],
        "Recall": [(scores, labels)],
        "Accuracy": [(np.float32(0.5), 10), (np.float32(1.0), 30)],
        "ChunkEvaluator": [(10, 8, 6), (np.array([5]), 7, np.array([4]))],
        "EditDistance": [(dist, 7), (np.array([[0.0]]), 1)],
        "Auc": [(probs, labels), (scores, 1 - labels)],
        "DetectionMAP": [(np.float32(0.25), 2.0), (np.float32(0.75), 1.0)],
    }


def _torchify(args):
    return tuple(torch.as_tensor(a) if isinstance(a, np.ndarray) else a
                 for a in args)


@pytest.mark.parametrize("name", ["Precision", "Recall", "Accuracy",
                                  "ChunkEvaluator", "EditDistance", "Auc",
                                  "DetectionMAP"])
def test_metrics_equal_the_reference(name):
    feeds = _feeds(np.random.RandomState(0))[name]
    ref, port, port_t = (getattr(ref_metrics, name)(),
                         getattr(metrics, name)(), getattr(metrics, name)())
    for args in feeds:
        ref.update(*args)
        port.update(*args)
        port_t.update(*_torchify(args))
    assert port.eval() == ref.eval()
    assert port_t.eval() == ref.eval()
    assert port.get_config().keys() == ref.get_config().keys()
    port.reset()
    ref.reset()
    for k, v in ref.get_config().items():
        np.testing.assert_array_equal(port.get_config()[k], v)


def test_composite_metric_equals_the_reference():
    preds, labels = np.array([0.9, 0.1, 0.7]), np.array([1, 1, 0])
    res = []
    for mod in (ref_metrics, metrics):
        c = mod.CompositeMetric()
        c.add_metric(mod.Precision())
        c.add_metric(mod.Recall())
        c.update(preds, labels)
        res.append(c.eval())
        with pytest.raises(TypeError):
            c.add_metric(object())
    assert res[0] == res[1] == [0.5, 0.5]


def _chunk_body(fluid):
    ls = fluid.layers
    pred = ls.data(name="pred", shape=[6], dtype="int64")
    lab = ls.data(name="lab", shape=[6], dtype="int64")
    slen = ls.data(name="slen", shape=[], dtype="int32")
    return fluid.evaluator.ChunkEvaluator(pred, lab, chunk_scheme="IOB",
                                          num_chunk_types=2, seq_len=slen)


def test_in_graph_chunk_evaluator_equals_the_reference():
    perfect = np.array([[0, 1, 4, 2, 3, 4]], np.int64)
    noisy = np.array([[0, 4, 4, 2, 3, 4]], np.int64)
    slen = np.array([6], np.int32)
    tw = twins(_chunk_body)
    evals = {}
    for side, fluid in (("ref", jf), ("port", pt)):
        main, scope, exe, ev = tw[side]
        out = []
        with fluid.scope_guard(scope):
            for pred in (perfect, noisy):
                exe.run(main, feed={"pred": pred, "lab": perfect,
                                    "slen": slen},
                        fetch_list=[ev.batch_metrics[0]])
                out.append(ev.eval())
            ev.reset()
            out.append(ev.eval())
        evals[side] = out
    assert evals["port"] == evals["ref"]
    assert evals["port"][1] == pytest.approx((0.75, 0.75, 0.75))
    assert evals["port"][2] == (0.0, 0.0, 0.0)


# ---------------------------------------------------------------------------
# contrib.slim
# ---------------------------------------------------------------------------

_TIED = np.array([[0.2, -0.7, 0.5, -0.4], [0.5, -0.5, 0.2, 0.9],
                  [-0.2, 0.4, 0.7, 0.0]], np.float32)


@pytest.mark.parametrize("pruner", [
    ("MagnitudePruner", {"threshold": 0.5}),
    ("RatioPruner", {"ratio": 0.5}),          # k = 6: ties at 0.4 / 0.5
    ("RatioPruner", {"ratio": 0.25}),         # k = 3: threshold 0.2 tied
    ("RatioPruner", {"ratio": 0.5, "ratios": {"w": 0.0}})])
def test_pruner_masks_equal_the_reference_with_ties(pruner):
    import jax.numpy as jnp

    cls, kw = pruner
    ref = getattr(ref_slim, cls)(**kw).mask(jnp.asarray(_TIED), "w")
    got = getattr(slim, cls)(**kw).mask(torch.as_tensor(_TIED), "w")
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def _prune_body(fluid):
    ls = fluid.layers
    x = ls.data(name="x", shape=[16], dtype="float32")
    y = ls.data(name="y", shape=[1], dtype="int64")
    h = ls.fc(x, size=32, act="relu")
    logits = ls.fc(h, size=4)
    return ls.mean(ls.softmax_with_cross_entropy(logits, y))


def test_prune_strategy_masks_and_sparsity_equal_the_reference():
    """apply_masks on the same weights in both scopes: the same zeros,
    the same sparsity, and the masks re-applied after a write."""
    tw = twins(_prune_body)
    res = {}
    for side, mod, fluid in (("ref", ref_slim, jf), ("port", slim, pt)):
        main, scope, exe, _ = tw[side]
        strat = mod.PruneStrategy(mod.RatioPruner(ratio=0.6))
        ctx = mod.SlimContext(exe, main, scope)
        before = mod.sparsity(scope, program=main)
        strat.apply_masks(ctx)
        after = mod.sparsity(scope, program=main)
        w0 = main.global_block().all_parameters()[0].name
        val = scope.find_var(w0)
        scope.set_var(w0, val + 1.0)     # an optimizer "revives" weights
        strat.reapply(ctx)
        res[side] = (before, after, mod.sparsity(scope, program=main),
                     {n: np.asarray(scope.find_var(n)) if side == "ref"
                      else scope.find_var(n).numpy()
                      for n in sorted(strat.masks)})
    assert res["port"][:3] == res["ref"][:3]
    assert res["port"][1] >= 0.55
    for n, want in res["ref"][3].items():
        np.testing.assert_array_equal(res["port"][3][n], want, err_msg=n)


def test_compress_pass_prunes_while_training():
    rng = np.random.RandomState(0)
    w = rng.randn(16, 4) * 2.0
    x = rng.randn(128, 16).astype(np.float32)
    y = (x @ w).argmax(1)[:, None].astype(np.int64)
    main, startup = pt.Program(), pt.Program()
    scope = pt.Scope()
    with pt.program_guard(main, startup):
        loss = _prune_body(pt)
        pt.optimizer.AdamOptimizer(learning_rate=0.05).minimize(loss)
    exe = pt.Executor(CPU)
    exe.run(startup, scope=scope)

    def reader():
        for i in range(4):
            yield {"x": x[i * 32:(i + 1) * 32], "y": y[i * 32:(i + 1) * 32]}

    strategy = slim.PruneStrategy(slim.RatioPruner(ratio=0.6),
                                  mini_batch_pruning_frequency=2,
                                  start_epoch=0, end_epoch=2)
    seen = []
    ctx = slim.CompressPass(exe, main, scope, [strategy]).run(
        reader, epochs=2, fetch_list=[loss],
        event_handler=lambda c: seen.append((c.epoch_id, c.batch_id)))
    assert seen == [(e, b) for e in range(2) for b in range(4)]
    assert np.isfinite(ctx.last_fetch[0]).all()
    assert slim.sparsity(scope, program=main) >= 0.55


def _distill_body(fluid):
    ls = fluid.layers
    s = ls.data(name="s", shape=[4], dtype="float32")
    t = ls.data(name="t", shape=[4], dtype="float32")
    y = ls.data(name="y", shape=[1], dtype="int64")
    hard = ls.mean(ls.softmax_with_cross_entropy(s, y))
    mod = ref_slim if fluid is jf else slim
    return (mod.distillation_loss(s, t, temperature=3.0),
            mod.distillation_loss(s, t, temperature=2.0, hard_loss=hard,
                                  soft_weight=0.5))


def test_distillation_loss_equals_the_reference():
    rng = np.random.RandomState(2)
    logits = rng.randn(8, 4).astype(np.float32)
    feeds = [{"s": logits, "t": logits},
             {"s": logits, "t": -logits}]
    tw = twins(_distill_body)
    vals = {}
    for side in ("ref", "port"):
        main, scope, exe, (soft, total) = tw[side]
        vals[side] = np.array([
            [float(np.asarray(v).reshape(-1)[0]) for v in exe.run(
                main, feed=dict(f, y=np.zeros((8, 1), np.int64)),
                fetch_list=[soft, total], scope=scope)] for f in feeds])
    np.testing.assert_allclose(vals["port"], vals["ref"], rtol=TOL_DISTILL,
                               atol=TOL_DISTILL)
    assert abs(vals["port"][0, 0]) < 1e-6 and vals["port"][1, 0] > 0.01


# ---------------------------------------------------------------------------
# debugger and the package surface
# ---------------------------------------------------------------------------

def test_debugger_text_equals_the_reference():
    main, startup = jf.Program(), jf.Program()
    with jf.program_guard(main, startup), jf.unique_name.guard():
        _prune_body(jf)
    d = main.to_dict()
    ref_prog, port_prog = jf.Program.from_dict(d), pt.Program.from_dict(d)
    assert (pt.debugger.pprint_program_codes(port_prog)
            == jf.debugger.pprint_program_codes(ref_prog))
    hl = [ref_prog.global_block().all_parameters()[0].name]
    want = jf.debugger.draw_block_graphviz(ref_prog.global_block(),
                                           highlights=hl)
    got = pt.debugger.draw_block_graphviz(port_prog.global_block(),
                                          highlights=hl)
    assert got == want and got.startswith("digraph G {")


_SURFACE = r"""
import json, paddle_tpu, paddle_tpu.contrib, paddle_tpu.data
ref = {k: sorted(n for n in dir(m) if not n.startswith("_"))
       for k, m in (("top", paddle_tpu), ("data", paddle_tpu.data),
                    ("contrib", paddle_tpu.contrib))}
import paddle_tpu_torch as pt
port = {k: sorted(n for n in dir(m) if not n.startswith("_"))
        for k, m in (("top", pt), ("data", pt.data),
                     ("contrib", pt.contrib))}
print(json.dumps({"ref": ref, "port": port}))
"""


def test_namespaces_hold_the_references_names():
    """66 of the reference's 66 top-level names, and every name of its
    data and contrib packages, each package imported alone in a fresh
    interpreter (another test's imports add submodule names)."""
    import json
    import os
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", _SURFACE], cwd=root,
                         capture_output=True, text=True, timeout=120,
                         env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert out.returncode == 0, out.stderr[-2000:]
    names = json.loads(out.stdout.strip().splitlines()[-1])
    assert len(names["ref"]["top"]) == 66
    for part in ("top", "data", "contrib"):
        missing = set(names["ref"][part]) - set(names["port"][part])
        assert not missing, (part, sorted(missing))
    assert pt.TPUPlace is pt.CUDAPlace
    assert pt.WeightNormParamAttr is pt.ParamAttr
    assert pt.is_compiled_with_tpu() is False
    assert pt.FLAGS is pt.flags.FLAGS
