"""ROADMAP C9, repaired: four public signatures take the reference's
parameters in the reference's order.

- `inspect.signature` parameter names, in order, equal the reference's
  for `Executor.run`, `RunEventLog.__init__`, the Transformer's
  `encoder_layer`/`decoder_layer` (and so BERT's, which imports them)
  and `DecodeEngine.__init__` (whose port-only `params` and `place` come
  last).
- `exe.run(main, feed, [y], None, True, False)` means
  `use_program_cache=False` in both packages, and runs.
- `iterations=K` runs the step K times on the same feeds and returns
  the last fetches: in the port, `iterations=3` draws the same dropout
  streams as three `run` calls (bit for bit), and on a program without
  randomness its fetches and state equal the reference's
  `iterations=3` (rtol 1e-5: float32, other summation orders).
- The options the port accepts without acting on them
  (`use_program_cache`, `donate_pools`) are documented no-ops; the
  ones it cannot serve yet (`max_bytes`, `moe_experts`) raise naming
  their ROADMAP step.
"""

from __future__ import annotations

import inspect
import json

import numpy as np
import pytest
import torch

import paddle_tpu as jf
import paddle_tpu_torch as tf
from paddle_tpu.models import transformer as jt
from paddle_tpu.observe import events as jevents
from paddle_tpu.serving import decode as jdecode
from paddle_tpu_torch.models import transformer as tt
from paddle_tpu_torch.observe import events as tevents
from paddle_tpu_torch.serving import decode as tdecode

from torch_twin import batches, linreg, persistables, twins

torch.set_num_threads(2)

PAIRS = {
    "Executor.run": (jf.Executor.run, tf.Executor.run),
    "RunEventLog.__init__": (jevents.RunEventLog.__init__,
                             tevents.RunEventLog.__init__),
    "encoder_layer": (jt.encoder_layer, tt.encoder_layer),
    "decoder_layer": (jt.decoder_layer, tt.decoder_layer),
}


def _names(fn):
    return list(inspect.signature(fn).parameters)


@pytest.mark.parametrize("name", sorted(PAIRS))
def test_signature_is_the_reference_order(name):
    ref, port = PAIRS[name]
    assert _names(port) == _names(ref)


def test_decode_engine_signature_then_params_and_place():
    ref = _names(jdecode.DecodeEngine.__init__)
    port = _names(tdecode.DecodeEngine.__init__)
    assert port[:len(ref)] == ref
    assert port[len(ref):] == ["params", "place"]


def test_positional_use_program_cache_runs():
    out = {}
    for side, (main, scope, exe, loss) in twins(linreg).items():
        fluid = jf if side == "ref" else tf
        b = batches(1)[0]
        with fluid.scope_guard(scope):
            out[side] = exe.run(main, b, [loss], None, True, False)[0]
    np.testing.assert_allclose(out["port"], out["ref"], rtol=1e-5)


def test_iterations_equal_the_reference():
    got, loss = {}, {}
    b = batches(1, seed=3)[0]
    for side, (main, scope, exe, lv) in twins(linreg).items():
        loss[side] = exe.run(main, feed=b, fetch_list=[lv], scope=scope,
                             iterations=3)[0]
        got[side] = persistables(main, scope)
    np.testing.assert_allclose(loss["port"], loss["ref"], rtol=1e-5)
    for n, want in got["ref"].items():
        np.testing.assert_allclose(got["port"][n], want, rtol=1e-5,
                                   atol=1e-7, err_msg=n)
    # and K iterations are K steps: the fetched loss is the third's
    main, scope, exe, lv = twins(linreg)["port"]
    steps = [exe.run(main, feed=b, fetch_list=[lv], scope=scope)[0]
             for _ in range(3)]
    np.testing.assert_array_equal(steps[-1], loss["port"])


def _dropout_net(fluid):
    layers = fluid.layers
    x = layers.data(name="x", shape=[16], dtype="float32")
    h = layers.dropout(layers.fc(x, size=32), dropout_prob=0.5,
                       dropout_implementation="upscale_in_train")
    loss = layers.mean(layers.fc(h, size=1))
    fluid.optimizer.SGDOptimizer(learning_rate=0.1).minimize(loss)
    return loss, h


def test_iterations_draw_the_dropout_streams_of_separate_runs():
    feed = {"x": np.random.RandomState(0).rand(8, 16).astype(np.float32)}
    runs = {}
    for how in ("iterations", "runs"):
        main, scope, exe, (loss, h) = twins(_dropout_net, seed=5)["port"]
        if how == "iterations":
            last = exe.run(main, feed=feed, fetch_list=[loss, h],
                           scope=scope, iterations=3)
        else:
            for _ in range(3):
                last = exe.run(main, feed=feed, fetch_list=[loss, h],
                               scope=scope)
        runs[how] = (last, persistables(main, scope),
                     scope.find_var(tf.core.executor.RNG_STATE_VAR))
    (li, si, ki), (lr, sr, kr) = runs["iterations"], runs["runs"]
    assert ki == kr == 3
    for a, b in zip(li, lr):
        np.testing.assert_array_equal(a, b)
    for n in sr:
        np.testing.assert_array_equal(si[n], sr[n], err_msg=n)
    assert (li[1] == 0).any()              # dropout did drop


def test_iterations_must_be_positive():
    main, scope, exe, loss = twins(linreg)["port"]
    with pytest.raises(ValueError, match="iterations"):
        exe.run(main, feed=batches(1)[0], fetch_list=[loss], scope=scope,
                iterations=0)


def test_run_event_log_records_mesh_shape(tmp_path):
    recs = {}
    for side, mod in (("ref", jevents), ("port", tevents)):
        path = tmp_path / f"{side}.jsonl"
        log = mod.RunEventLog(str(path), "run1", {"dp": 2, "mp": 4},
                              {"component": "test"})
        log.close()
        recs[side] = json.loads(path.read_text().splitlines()[0])
    for side in recs:
        assert recs[side]["mesh_shape"] == {"dp": 2, "mp": 4}
        assert recs[side]["component"] == "test"
        assert recs[side]["run_id"] == "run1"
    with pytest.raises(NotImplementedError, match="step 11"):
        tevents.RunEventLog(str(tmp_path / "x.jsonl"), max_bytes=4096)


def test_layer_moe_experts_raise_naming_their_step():
    for fn in (tt.encoder_layer, tt.decoder_layer):
        main, startup = tf.Program(), tf.Program()
        with tf.program_guard(main, startup), tf.unique_name.guard():
            x = tf.layers.data(name="x", shape=[4, 8], dtype="float32")
            args = ((x, None, 2, 4, 4, 8, 16, 0.0) if fn is tt.encoder_layer
                    else (x, x, None, None, 2, 4, 4, 8, 16, 0.0))
            with pytest.raises(NotImplementedError, match="item 6"):
                fn(*args, False, False, 4)     # moe_experts=4, positional


def test_decode_engine_accepts_donate_pools():
    from paddle_tpu_torch.models.decoder_lm import DecoderLM

    lm = DecoderLM(vocab_size=16, n_layer=1, n_head=2, d_model=8,
                   d_inner=16, kv_dtype="float32")
    cfg = tdecode.DecodeConfig(num_slots=1, page_size=4, max_len=8,
                               prefill_buckets=(4,), kv_dtype="float32")
    eng = tdecode.DecodeEngine(lm, cfg, donate_pools=True,
                               place=tf.CPUPlace())
    assert eng.tracer is None and eng.speculate_k == 0
