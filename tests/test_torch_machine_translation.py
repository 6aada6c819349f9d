"""The machine-translation model of the port (`seq_to_seq_net` trained
through DynamicRNN, `beam_search_net` decoded through While, tensor
arrays, beam_search and beam_search_decode) against the JAX package at
a tiny size (vocabularies 50, embed 16, hidden 32, batch 4, as
tests/test_control_flow.py builds it).

- Both programs and their startups serialize as the reference's
  (`Program.to_dict()`, sub-blocks included).
- From the reference's startup values (`convert.params_from_arrays`),
  3 Adam steps give the reference's losses within rtol 1e-5, its step-1
  gradients within 1e-4 of each gradient's max |value|, and its
  parameters within 4 * sum(lr) (Adam turns a gradient near 0 into a
  step of about +-lr whose sign is float32 noise), as the port's other
  model parity tests hold theirs.
- The decode program, on the trained parameters (shared by their fixed
  `nmt.*` names), gives the reference's sentences exactly and its final
  beam scores within rtol 1e-5, also where beams emit the end token
  early and freeze.
"""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

import paddle_tpu as jf
import paddle_tpu_torch as tf
from paddle_tpu.models import machine_translation as jmt
from paddle_tpu_torch.models import machine_translation as tmt

from torch_twin import build, persistables, reference_arrays, scope_of

torch.set_num_threads(2)

V, EMBED, HIDDEN, B, TSRC, TTRG = 50, 16, 32, 4, 8, 7
LR, STEPS = 2e-3, 3
SIDES = (("ref", jf, jmt), ("port", tf, tmt))


def _train(fluid, mt):
    avg_cost, feeds = mt.seq_to_seq_net(
        src_vocab_size=V, trg_vocab_size=V, embed_dim=EMBED,
        hidden_dim=HIDDEN, batch_size=B, max_src_len=TSRC,
        max_trg_len=TTRG)
    params = fluid.optimizer.Adam(learning_rate=LR).minimize(avg_cost)[1]
    return avg_cost, feeds, params


def _decode(mt, beam=3, length=6, end_id=1):
    def body(fluid):
        return mt.beam_search_net(
            src_vocab_size=V, trg_vocab_size=V, embed_dim=EMBED,
            hidden_dim=HIDDEN, batch_size=B, max_src_len=TSRC,
            beam_size=beam, max_decode_len=length, start_id=0,
            end_id=end_id)
    return body


def _feed(seed=0):
    rng = np.random.RandomState(seed)
    return {
        "src_word_id": rng.randint(2, V, (B, TSRC)).astype(np.int64),
        "src_word_id.seq_len": rng.randint(3, TSRC + 1, B).astype(np.int32),
        "trg_word_id": rng.randint(2, V, (B, TTRG)).astype(np.int64),
        "trg_word_id.seq_len": rng.randint(3, TTRG + 1, B).astype(np.int32),
        "trg_next_id": rng.randint(2, V, (B, TTRG)).astype(np.int64),
    }


def _json(program):
    return json.dumps(program.to_dict(), sort_keys=True)


@pytest.fixture(scope="module")
def trained():
    """Both packages' training programs and scopes after STEPS Adam
    steps, with their per-step losses and step-1 gradients."""
    out, arrays = {}, None
    feed = _feed()
    for side, fluid, mt in SIDES:
        main, startup, (loss, _feeds, pg) = build(
            fluid, lambda f, mt=mt: _train(f, mt))
        if arrays is None:
            arrays = reference_arrays(startup)
        scope = scope_of(fluid, arrays, main)
        exe = fluid.Executor(fluid.CPUPlace())
        grads = [g.name for _p, g in pg]
        losses, g1 = [], None
        for step in range(STEPS):
            res = exe.run(main, feed=feed, fetch_list=[loss] + grads,
                          scope=scope)
            losses.append(float(np.asarray(res[0]).reshape(-1)[0]))
            if step == 0:
                g1 = dict(zip(grads, (np.asarray(r) for r in res[1:])))
        out[side] = dict(main=main, startup=startup, scope=scope, exe=exe,
                         losses=losses, grads=g1)
    return out


def test_programs_serialize_as_the_reference(trained):
    assert _json(trained["port"]["main"]) == _json(trained["ref"]["main"])
    assert _json(trained["port"]["startup"]) == \
        _json(trained["ref"]["startup"])
    for beam, length in ((4, 16), (3, 6)):
        progs = [build(f, _decode(mt, beam, length)) for _s, f, mt in SIDES]
        assert len(progs[0][0].blocks) == 2
        assert _json(progs[1][0]) == _json(progs[0][0])
        assert _json(progs[1][1]) == _json(progs[0][1])


def test_training_matches_the_reference(trained):
    ref, port = trained["ref"], trained["port"]
    np.testing.assert_allclose(port["losses"], ref["losses"], rtol=1e-5)
    assert port["losses"][-1] < port["losses"][0]
    assert set(port["grads"]) == set(ref["grads"])
    for n, want in ref["grads"].items():
        scale = max(float(np.abs(want).max()), 1e-30)
        np.testing.assert_allclose(port["grads"][n], want, rtol=0,
                                   atol=1e-4 * scale, err_msg=n)
    got = persistables(port["main"], port["scope"])
    want = persistables(ref["main"], ref["scope"])
    assert set(got) == set(want)
    for n in want:
        np.testing.assert_allclose(got[n], want[n], rtol=0,
                                   atol=4 * STEPS * LR + 1e-6, err_msg=n)


@pytest.mark.parametrize("beam,length,end_id", [(3, 6, 1), (4, 12, 1),
                                                (3, 30, "greedy")])
def test_beam_decode_matches_the_reference(trained, beam, length, end_id):
    """Decode from the trained parameters.  "greedy": end_id is the
    token beam 0 of row 0 picks first, so beams finish at the first step
    and stay frozen."""
    feed = _feed()
    src = {n: feed[n] for n in ("src_word_id", "src_word_id.seq_len")}
    if end_id == "greedy":
        end_id = _first_pick(trained, src)
    outs = {}
    for side, fluid, mt in SIDES:
        main, _startup, (sents, scores, _f) = build(
            fluid, _decode(mt, beam, length, end_id))
        t = trained[side]
        s, sc = t["exe"].run(main, feed=src, fetch_list=[sents, scores],
                             scope=t["scope"])
        outs[side] = (np.asarray(s), np.asarray(sc))
    (s_ref, sc_ref), (s_port, sc_port) = outs["ref"], outs["port"]
    assert s_port.shape == (B, beam, length) and sc_port.shape == (B, beam)
    np.testing.assert_array_equal(s_port, s_ref)
    np.testing.assert_allclose(sc_port, sc_ref, rtol=1e-5)
    assert (np.diff(sc_port, axis=1) <= 1e-5).all()


def _first_pick(trained, src):
    """The token beam 0 of batch row 0 picks at the first step."""
    t = trained["port"]
    main, _startup, (sents, _sc, _f) = build(tf, _decode(tmt, 3, 1, 1))
    (s,) = t["exe"].run(main, feed=src, fetch_list=[sents],
                        scope=t["scope"])
    return int(np.asarray(s)[0, 0, 0])
