"""The three book models of the port — sequence tagging (db_lstm + CRF),
word2vec (NCE, and the softmax variant) and the recommender — against the
JAX package, and the NCE samplers.

- Each builds the same `Program.to_dict()` (main and startup) as the
  reference, and `make_fake_batch` gives the same arrays.
- From the reference's startup values (`convert.params_from_arrays`),
  three steps give the same losses (rtol 1e-5; the CRF's 1e-4: its
  forward recursion sums exp over 4 LSTM layers' outputs in another
  order) and the same parameters (the SGD tagger's at rtol 1e-4, atol
  1e-6; the Adam models' within 4 * sum(lr)); the sequence tagger's
  Viterbi paths at step 1 are the reference's exactly.
- Word2vec with NCE: the two packages draw other negatives (ROADMAP
  C2), so each port step takes the negatives the reference drew in the
  same step, read from the nce op's SampleLabels output.
- The samplers, on the op's generator: uniform, log-uniform
  (P(k) = log(1 + 1/(k+1)) / log(C+1)) and a custom distribution, each
  within 4 standard errors of its probabilities on 200000 draws.
- The book ops' layers and the `nets` helpers (`sequence_conv_pool`,
  `glu`, `scaled_dot_product_attention`) build and run as the
  reference's.
"""

from __future__ import annotations

import importlib
import json

import numpy as np
import pytest
import torch

import paddle_tpu as jf
import paddle_tpu_torch as tf
from paddle_tpu_torch.ops import structured as tstruct

from torch_twin import build, persistables, reference_arrays, scope_of

torch.set_num_threads(2)

MODELS = {
    "sequence_tagging": dict(kw={}, batch=dict(batch_size=4)),
    "word2vec": dict(kw={}, batch={}),
    "word2vec softmax": dict(kw=dict(use_nce=False), batch={}),
    "recommender": dict(kw={}, batch={}),
}


def _mod(pkg, case):
    name = case.split()[0]
    return importlib.import_module(f"{pkg}.models.{name}")


def _json(program):
    return json.dumps(program.to_dict(), sort_keys=True)


def _twins(case):
    kw = MODELS[case]["kw"]
    out = {}
    for side, fluid in (("ref", jf), ("port", tf)):
        mod = _mod("paddle_tpu" if side == "ref" else "paddle_tpu_torch",
                   case)
        main, startup, model = build(fluid, lambda f: mod.build_model(**kw))
        out[side] = (main, startup, model, mod)
    return out


@pytest.mark.parametrize("case", sorted(MODELS))
def test_book_model_serializes_as_the_reference(case):
    tw = _twins(case)
    assert _json(tw["port"][0]) == _json(tw["ref"][0])
    assert _json(tw["port"][1]) == _json(tw["ref"][1])
    want = tw["ref"][3].make_fake_batch(**MODELS[case]["batch"])
    got = tw["port"][3].make_fake_batch(**MODELS[case]["batch"])
    assert set(got) == set(want)
    for n in want:
        np.testing.assert_array_equal(got[n], want[n])


def _nce_labels(program):
    ops = [op for op in program.global_block().ops if op.type == "nce"]
    return ops[0].desc.outputs["SampleLabels"][0] if ops else None


@pytest.mark.parametrize("case", sorted(MODELS))
def test_book_model_trains_as_the_reference(case, monkeypatch):
    tw = _twins(case)
    arrays = reference_arrays(tw["ref"][1])
    batch = tw["ref"][3].make_fake_batch(**MODELS[case]["batch"])
    extra = {"sequence_tagging": "crf_decode"}.get(case.split()[0])
    labels = _nce_labels(tw["ref"][0])
    runs = {side: [] for side in tw}
    drawn = []
    if labels is not None:
        real = tstruct.nce_negatives

        def reference_draws(gen, sampler, num_classes, num_neg, device,
                            dist=None):
            if gen is None:              # shape inference
                return real(gen, sampler, num_classes, num_neg, device,
                            dist)
            return torch.as_tensor(drawn[-1], device=device)

        monkeypatch.setattr(tstruct, "nce_negatives", reference_draws)
    scopes = {}
    for side, fluid in (("ref", jf), ("port", tf)):
        main, _, model, _ = tw[side]
        scopes[side] = (scope_of(fluid, arrays, main),
                        fluid.Executor(fluid.CPUPlace()))
    for step in range(3):
        for side in ("ref", "port"):
            main, _, model, _ = tw[side]
            scope, exe = scopes[side]
            fetch = [model["loss"]]
            if extra and step == 0:
                fetch.append(model[extra])
            if labels is not None and side == "ref":
                fetch.append(labels)
            out = [np.asarray(v) for v in exe.run(
                main, feed=batch, fetch_list=fetch, scope=scope)]
            if labels is not None and side == "ref":
                num_true = batch["target_word"].shape[1]
                drawn.append(out.pop()[0, num_true:])
            runs[side].append(out)
    loss_rtol = 1e-4 if case == "sequence_tagging" else 1e-5
    for a, b in zip(runs["port"], runs["ref"]):
        np.testing.assert_allclose(a[0].reshape(-1), b[0].reshape(-1),
                                   rtol=loss_rtol)
    if extra:
        np.testing.assert_array_equal(runs["port"][0][1],
                                      runs["ref"][0][1])
    got = persistables(tw["port"][0], scopes["port"][0])
    want = persistables(tw["ref"][0], scopes["ref"][0])
    assert set(got) == set(want)
    # word2vec and the recommender train with Adam, which turns a
    # gradient near 0 into a step of about +-lr whose sign is float32
    # noise: their parameters are held within 4 * sum(lr), as the
    # Transformer's are (test_torch_training.py)
    adam_lr = {"word2vec": 1e-2, "recommender": 5e-3}.get(
        case.split()[0])
    for n in want:
        if adam_lr is None:
            np.testing.assert_allclose(got[n], want[n], rtol=1e-4,
                                       atol=1e-6, err_msg=n)
        else:
            np.testing.assert_allclose(got[n], want[n], rtol=0,
                                       atol=4 * 3 * adam_lr + 1e-6,
                                       err_msg=n)
    losses = [float(r[0].reshape(-1)[0]) for r in runs["port"]]
    assert np.all(np.isfinite(losses))


@pytest.mark.parametrize("sampler", [0, 1, 2])
def test_nce_samplers_draw_their_distributions(sampler):
    c, n = 12, 200000
    dist = torch.tensor([0.3, 0.05, 0.05, 0.1, 0.1, 0.05, 0.05, 0.1, 0.05,
                         0.05, 0.05, 0.05])
    gen = torch.Generator().manual_seed(3)
    neg = tstruct.nce_negatives(gen, sampler, c, n, "cpu", dist)
    assert neg.shape == (n,) and neg.dtype == torch.int64
    assert int(neg.min()) >= 0 and int(neg.max()) < c
    k = torch.arange(c)
    p = tstruct.nce_probs(k, sampler, c, dist).double()
    if sampler == 1:
        # the continuous sampler floors exp(u log(C+1)) - 1: the exact
        # law of the draws, which nce_probs approximates; the last class
        # also takes the clamped tail
        edges = torch.log(torch.arange(c + 1, dtype=torch.float64) + 1)
        p = torch.diff(edges) / np.log(c + 1)
        p[-1] += 1 - float(p.sum())
    freq = torch.bincount(neg, minlength=c).double() / n
    se = torch.sqrt(p * (1 - p) / n)
    assert torch.all((freq - p).abs() <= 4 * se + 1e-12), (freq, p)
    assert abs(float(p.sum()) - 1) < 1e-6
    # the same generator state draws the same negatives
    again = tstruct.nce_negatives(torch.Generator().manual_seed(3), sampler,
                                  c, n, "cpu", dist)
    assert torch.equal(neg, again)


def _nets(fluid):
    layers, nets = fluid.layers, fluid.nets
    x = layers.data("x", shape=[6, 8], dtype="float32", lod_level=1)
    seq = nets.sequence_conv_pool(x, num_filters=5, filter_size=3,
                                  act="tanh", pool_type="max")
    g = nets.glu(layers.fc(x, size=6, num_flatten_dims=2), dim=-1)
    att = nets.scaled_dot_product_attention(x, x, x, num_heads=2)
    n2 = layers.l2_normalize(att, axis=2)
    sq = layers.square_error_cost(layers.reduce_sum(n2, dim=2),
                                  layers.reduce_sum(g, dim=2))
    return seq, g, att, sq


def test_nets_helpers_and_book_layers_run_as_the_reference():
    rng = np.random.RandomState(4)
    feed = {"x": rng.randn(3, 6, 8).astype(np.float32),
            "x.seq_len": np.array([6, 2, 4], np.int32)}
    outs = {}
    for side, fluid in (("ref", jf), ("port", tf)):
        main, startup, vals = build(fluid, _nets)
        if side == "ref":
            arrays = reference_arrays(startup)
            ref_main = main
        else:
            assert _json(main) == _json(ref_main)
        scope = scope_of(fluid, arrays, main)
        outs[side] = [np.asarray(v) for v in fluid.Executor(
            fluid.CPUPlace()).run(main, feed=feed, fetch_list=list(vals),
                                  scope=scope)]
    for a, b in zip(outs["port"], outs["ref"]):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)
