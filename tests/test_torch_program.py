"""The port builds the reference's programs: `Program.to_dict()` of the
port's DecoderLM step, prefill and speculative-verify programs (and
their startup programs) equals the JAX package's, JSON for JSON, for
every KV dtype; and a reference dict loads into the port and serializes
back unchanged."""

from __future__ import annotations

import json

import pytest

from paddle_tpu.models.decoder_lm import DecoderLM as JaxLM
from paddle_tpu_torch.core.program import Program as TorchProgram
from paddle_tpu_torch.models.decoder_lm import DecoderLM as TorchLM


def _builds(kv_dtype, prefill_pallas):
    kw = dict(vocab_size=48, n_layer=2, n_head=2, d_model=32, d_inner=64,
              kv_dtype=kv_dtype, prefill_pallas=prefill_pallas, seed=7)
    return JaxLM(**kw), TorchLM(**kw)


def _json(program):
    return json.dumps(program.to_dict(), sort_keys=True)


@pytest.mark.parametrize("kv_dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("which", ["step", "prefill8", "prefill16",
                                   "verify1", "verify4"])
def test_to_dict_identical(kv_dtype, which):
    jlm, tlm = _builds(kv_dtype, prefill_pallas=True)
    if which == "step":
        j, t = jlm.step, tlm.step
    elif which.startswith("verify"):
        k = int(which[len("verify"):])
        j, t = jlm.verify(k), tlm.verify(k)
        assert (t["accepted"], t["tokens"], t["speculate_k"]) == \
            (j["accepted"], j["tokens"], k)
    else:
        bucket = int(which[len("prefill"):])
        j, t = jlm.prefill(bucket), tlm.prefill(bucket)
    for part in ("main", "startup"):
        assert _json(t[part]) == _json(j[part]), f"{which} {part}"
    assert t["next_token"] == j["next_token"]
    assert t["cache_outs"] == j["cache_outs"]


def test_reference_dict_round_trips_through_the_port():
    jlm, _ = _builds("bfloat16", prefill_pallas=None)
    for built in (jlm.step, jlm.prefill(8), jlm.verify(4)):
        d = json.loads(_json(built["main"]))
        assert _json(TorchProgram.from_dict(d)) == _json(built["main"])


def test_verify_build_is_not_ported_yet():
    """The verify build is ported now: it is cached per k, and a draft
    length below 1 raises as in the reference."""
    jlm, tlm = _builds("float32", prefill_pallas=None)
    assert tlm.verify(2) is tlm.verify(2)
    for lm in (jlm, tlm):
        with pytest.raises(ValueError, match="speculate k must be >= 1"):
            lm.verify(0)
