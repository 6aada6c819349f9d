"""paddle_tpu_torch.inference (Predictor, AnalysisConfig,
create_paddle_predictor, export_serialized_model) against the JAX
package's, on the CPU, from directories the reference saved:

- a small MLP and a cut conv net (conv, batch norm, pool, fc) served by
  both packages' Predictors agree within TOL (float32, other summation
  orders), and the port's Predictor equals its own Executor.run bit for
  bit;
- a directory carrying the reference's serialized artifact
  (`__model__.export` + sidecar) loads and serves in the port, which
  warms the sidecar's signature at load while it describes `__model__`
  (its first run counts no compile; not under `enable_int8`); the
  port's export writes the sidecar the reference reads, and a re-save
  invalidates it;
- `enable_int8()` in both packages on a QAT model the reference
  trained and exported: the same conversion plan, the same int8 codes,
  outputs within TOL_INT8 of tests/test_torch_quantize.py;
- after `compile_signature` a run counts 0 compiles, a signature never
  warmed counts 1; `clone()` shares the device parameters;
- the introspection names equal; the default place is CUDAPlace(0) and
  raises without CUDA.
"""

from __future__ import annotations

import json
import os
import shutil

import numpy as np
import pytest
import torch

import paddle_tpu as jf
import paddle_tpu_torch as tf
from paddle_tpu_torch.inference import FeedSpec
from paddle_tpu_torch.observe import runtime_stats

torch.set_num_threads(2)

TOL = 1e-5
TOL_INT8 = 2e-3     # tests/test_torch_quantize.py: int8 program outputs


def _save(d, body, feeds):
    """Build `body(fluid)` in the reference, run its startup and save it
    with the reference's save_inference_model to `d`."""
    main, startup = jf.Program(), jf.Program()
    scope = jf.Scope()
    with jf.program_guard(main, startup), jf.scope_guard(scope):
        out = body(jf)
        exe = jf.Executor()
        exe.run(startup)
        jf.io.save_inference_model(d, feeds, [out], exe,
                                   main_program=main)
    return d


def _mlp(fluid):
    x = fluid.layers.data("x", shape=[16], append_batch_size=True)
    h = fluid.layers.fc(x, size=32, act="relu")
    return fluid.layers.fc(h, size=4)


def _conv(fluid):
    L = fluid.layers
    img = L.data("img", shape=[3, 8, 8], dtype="float32")
    c = L.conv2d(img, num_filters=4, filter_size=3, padding=1)
    c = L.batch_norm(c, act="relu", is_test=True)
    p = L.pool2d(c, pool_size=2, pool_stride=2, pool_type="max")
    return L.fc(p, size=5, act="softmax")


FEEDS = {"mlp": {"x": np.random.RandomState(1).rand(6, 16)
                 .astype(np.float32)},
         "conv": {"img": np.random.RandomState(2).rand(4, 3, 8, 8)
                  .astype(np.float32)}}


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("inference")
    return {"mlp": _save(str(root / "mlp"), _mlp, ["x"]),
            "conv": _save(str(root / "conv"), _conv, ["img"])}


def _port(d, **kw):
    return tf.Predictor(tf.AnalysisConfig(d).disable_gpu())


@pytest.mark.parametrize("model", ["mlp", "conv"])
def test_predictors_agree_and_match_the_executor(dirs, model):
    d, feed = dirs[model], FEEDS[model]
    want = jf.Predictor(d).run(feed)[0]
    pred = tf.create_paddle_predictor(tf.AnalysisConfig(d).disable_gpu())
    got = pred.run(feed)[0]
    np.testing.assert_allclose(got, np.asarray(want), rtol=TOL, atol=TOL)
    # positional inputs, and the same run through Executor.run
    np.testing.assert_array_equal(pred.run(list(feed.values()))[0], got)
    exe = tf.Executor(tf.CPUPlace())
    with tf.scope_guard(tf.Scope()):
        prog, _, fetch = tf.io.load_inference_model(d, exe)
        ref = exe.run(prog, feed=feed, fetch_list=fetch)[0]
    np.testing.assert_array_equal(got, ref)
    stats = pred.benchmark(feed, iters=3, warmup=1)
    assert stats["p50_ms"] > 0 and stats["compute_ms"] > 0


def test_names_and_the_default_place(dirs):
    for d in dirs.values():
        jp, tp = jf.Predictor(d), _port(d)
        assert tp.get_input_names() == jp.get_input_names()
        assert tp.get_output_names() == jp.get_output_names()
    for name in ("inference", "Predictor", "AnalysisConfig",
                 "create_paddle_predictor", "serving"):
        assert hasattr(tf, name), name
    cfg = tf.AnalysisConfig(dirs["mlp"])
    assert cfg.place is None                 # CUDAPlace(0)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tf.Predictor(cfg)


def test_reference_artifact_loads_and_serves(dirs, tmp_path):
    from paddle_tpu.inference import export_serialized_model as jexport
    from paddle_tpu_torch.inference import (EXPORT_FILENAME,
                                            export_serialized_model)

    d = str(tmp_path / "exported")
    shutil.copytree(dirs["mlp"], d)
    feed = FEEDS["mlp"]
    jexport(d, feed)
    assert os.path.exists(os.path.join(d, EXPORT_FILENAME))
    want = np.asarray(jf.Predictor(d).run(feed)[0])
    snap = runtime_stats.snapshot()
    port = _port(d)
    assert runtime_stats.delta(snap)["compiles"] == 1    # warmed at load
    assert port._export_sig == (("x", (6, 16), "float32"),)
    snap = runtime_stats.snapshot()
    np.testing.assert_allclose(port.run(feed)[0], want, rtol=TOL, atol=TOL)
    assert runtime_stats.delta(snap)["compiles"] == 0
    # int8 serves another program than the sidecar's: nothing warmed
    snap = runtime_stats.snapshot()
    int8 = tf.Predictor(tf.AnalysisConfig(d).disable_gpu().enable_int8())
    assert runtime_stats.delta(snap)["compiles"] == 0
    int8.run(feed)
    assert runtime_stats.delta(snap)["compiles"] == 1

    # the port's export writes the sidecar the reference reads; a
    # matching signature keeps the reference's bytes, another drops them
    path = export_serialized_model(d, feed, tf.Executor(tf.CPUPlace()))
    with open(path) as f:
        meta = json.load(f)
    assert meta["signature"] == [["x", [6, 16], "float32"]]
    assert os.path.exists(os.path.join(d, EXPORT_FILENAME))
    np.testing.assert_allclose(np.asarray(jf.Predictor(d).run(feed)[0]),
                               want, rtol=0, atol=0)
    export_serialized_model(d, {"x": feed["x"][:2]},
                            tf.Executor(tf.CPUPlace()))
    assert not os.path.exists(os.path.join(d, EXPORT_FILENAME))
    port = _port(d)
    assert port._export_sig == (("x", (2, 16), "float32"),)
    snap = runtime_stats.snapshot()
    port.run({"x": feed["x"][:2]})
    assert runtime_stats.delta(snap)["compiles"] == 0
    port.run(feed)
    assert runtime_stats.delta(snap)["compiles"] == 1
    with pytest.raises(ValueError, match="missing"):
        export_serialized_model(d, {}, tf.Executor(tf.CPUPlace()))

    # a re-saved model invalidates the sidecar (the port's save removes
    # it; a stale hash would be ignored all the same)
    exe = tf.Executor(tf.CPUPlace())
    with tf.scope_guard(tf.Scope()):
        prog, feeds, fetch = tf.io.load_inference_model(d, exe)
        tf.io.save_inference_model(d, feeds, fetch, exe, main_program=prog)
    assert not os.path.exists(os.path.join(d, EXPORT_FILENAME + ".json"))
    snap = runtime_stats.snapshot()
    port = _port(d)
    assert port._export_sig is None
    port.run({"x": feed["x"][:2]})
    assert runtime_stats.delta(snap)["compiles"] == 1


def test_compile_signature_and_clone(dirs):
    pred = _port(dirs["mlp"])
    snap = runtime_stats.snapshot()
    sig = pred.compile_signature({"x": FeedSpec((3, 16), np.float32)},
                                 donate_feeds=True)
    assert runtime_stats.delta(snap)["compiles"] == 1
    assert pred.compile_signature(
        {"x": torch.zeros(3, 16)}) == sig      # idempotent, any spec
    x = FEEDS["mlp"]["x"]
    snap = runtime_stats.snapshot()
    pred.run({"x": x[:3]})
    pred.run({"x": x[:3].astype(np.float64)})  # fed in the var's dtype
    assert runtime_stats.delta(snap)["compiles"] == 0
    pred.run({"x": x[:5]})
    assert runtime_stats.delta(snap)["compiles"] == 1
    pred.run({"x": x[:5]})
    assert runtime_stats.delta(snap)["compiles"] == 1

    twin = pred.clone()
    assert twin._params is pred._params
    assert all(twin._params[n] is t for n, t in pred._params.items())
    snap = runtime_stats.snapshot()
    np.testing.assert_array_equal(twin.run({"x": x[:5]})[0],
                                  pred.run({"x": x[:5]})[0])
    assert runtime_stats.delta(snap)["compiles"] == 0


def _qat_net(fluid):
    """The small conv + fc net of tests/test_int8_serving.py, QAT
    transpiled before Adam."""
    L = fluid.layers
    x = L.data(name="x", shape=[1, 8, 8], dtype="float32")
    y = L.data(name="y", shape=[1], dtype="int64")
    conv = L.conv2d(x, num_filters=8, filter_size=3, padding=1, act="relu")
    pool = L.pool2d(conv, pool_size=2, pool_stride=2, pool_type="avg")
    probs = L.fc(pool, size=4, act="softmax")
    loss = L.mean(L.cross_entropy(probs, y))
    fluid.QuantizeTranspiler().training_transpile(
        fluid.default_main_program(), fluid.default_startup_program())
    fluid.optimizer.AdamOptimizer(learning_rate=0.02).minimize(loss)
    return loss, probs


def test_enable_int8_matches_the_reference(tmp_path):
    rng = np.random.RandomState(0)
    x = rng.rand(48, 1, 8, 8).astype(np.float32)
    y = rng.randint(0, 4, (48, 1)).astype(np.int64)
    main, startup = jf.Program(), jf.Program()
    scope = jf.Scope()
    d = str(tmp_path / "qat")
    with jf.program_guard(main, startup), jf.unique_name.guard(), \
            jf.scope_guard(scope):
        loss, probs = _qat_net(jf)
        exe = jf.Executor(jf.CPUPlace())
        exe.run(startup)
        for i in range(3):
            exe.run(main, feed={"x": x[i * 16:(i + 1) * 16],
                                "y": y[i * 16:(i + 1) * 16]},
                    fetch_list=[loss])
        infer = main.clone(for_test=True)
        jf.io.save_inference_model(
            d, ["x"], [infer.global_block().var(probs.name)], exe,
            main_program=infer)
    jp = jf.Predictor(jf.AnalysisConfig(d).enable_int8())
    tp = tf.Predictor(tf.AnalysisConfig(d).enable_int8().disable_gpu())
    assert [v[0] for v in tp.int8_converted.values()] == [
        "quantized_conv2d", "quantized_matmul"]
    assert tp.int8_converted == {k: tuple(v) for k, v in
                                 jp.int8_converted.items()}
    ints = [n for n, t in tp._params.items() if t.dtype == torch.int8]
    assert len(ints) == 2
    for n in ints:
        np.testing.assert_array_equal(tp._params[n].numpy(),
                                      np.asarray(jp._params[n]))
    got = tp.run({"x": x[:16]})[0]
    want = np.asarray(jp.run({"x": x[:16]})[0])
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL_INT8)
    # the int8 Predictor is Executor.run of the converted program
    exe = tf.Executor(tf.CPUPlace())
    qscope = tf.Scope()
    with tf.scope_guard(qscope):
        prog, _, fetch = tf.io.load_inference_model(d, exe)
    tf.quantize_module.convert_to_int8(prog, qscope)
    ref = exe.run(prog, feed={"x": x[:16]}, fetch_list=fetch,
                  scope=qscope)[0]
    np.testing.assert_array_equal(got, ref)
