"""The Transformer under bf16 AMP on the CPU: the port against the JAX
package (tests/torch_amp_parity.py runs both).

The tiny Transformer of tests/test_torch_training.py (2 layers, d_model
32, 2 heads, vocab 100, T = 16, batch 4, ragged lengths of at least 1,
dropout 0) with `use_amp=True` and use_flash, in three forms: head_major
False and True, and with the fused vocab-CE op.  For each:

- both packages build the same `Program.to_dict()`, its "amp" field
  included;
- every op receives the same dtypes after the AMP cast on both sides,
  and the flash op receives Q, K, V and the key bias in bf16 while the
  fused CE's Hidden stays float32 (it comes from layer_norm);
- step 1: the loss and the gradients (L2 over all of them) each within a
  quarter of the reference's own AMP-vs-float32 difference on that step
  (measured: 0.01 and 0.13 of it unfused, 0.02 and 0.11 head-major).
  With the fused CE the vocabulary projection, where most of the
  unfused model's bf16 rounding lies, stays float32 inside the fused op,
  so AMP moves the step-1 loss by only 3.9e-5: the loss is held within
  half of that (measured 0.44), the gradients within a quarter
  (measured 0.13);
- steps 2 and 3: losses within 2e-3 (measured 9.4e-4: Adam with
  epsilon 1e-9 turns gradients of rounding noise into steps of about
  +-lr whose signs differ), parameters within 4 * sum(lr) of the
  reference's AMP run, as tests/test_torch_training.py holds them.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import paddle_tpu as jf
import paddle_tpu_torch as tf
from paddle_tpu.models import transformer as jt
from paddle_tpu_torch.models import transformer as tt

from torch_amp_parity import (build, check_amp_parity, check_state,
                              program_json, three_runs)

torch.set_num_threads(2)

ARCH = dict(src_vocab_size=100, trg_vocab_size=100, max_length=16,
            n_layer=2, n_head=2, d_model=32, d_inner_hid=64, dropout=0.0,
            use_flash=True, warmup_steps=100)
CASES = {"flash": {}, "flash head_major": dict(head_major=True),
         "fused CE": dict(use_fused_ce=True)}


def _batch():
    feed = tt.make_fake_batch(4, 16, 100, 100, seed=1)
    feed["src_len"] = np.array([16, 9, 1, 5], np.int32)
    feed["trg_len"] = np.array([3, 16, 12, 1], np.int32)
    return feed


def _noam(step, d_model=32, warmup=100, scale=2.0):
    return scale * d_model ** -0.5 * min(step ** -0.5,
                                         step * warmup ** -1.5)


@pytest.mark.parametrize("case", sorted(CASES))
def test_transformer_amp_trains_like_the_reference(case, monkeypatch):
    kw = dict(ARCH, **CASES[case])

    def make(fluid, mod):
        return lambda amp: build(fluid, mod.build_model, **kw,
                                 use_amp=amp)

    runs, arrays, progs, logs = three_runs(monkeypatch, make(jf, jt),
                                           make(tf, tt), _batch())
    assert program_json(progs["port_amp"]) == \
        program_json(progs["ref_amp"])
    assert progs["port_amp"].to_dict()["amp"] is not None
    assert logs["port"] == logs["ref"]
    flash = [sig for op, sig in logs["port"] if op == "flash_attention"]
    assert flash and all(dt == ("bfloat16",) for sig in flash
                         for slot, dt in sig), flash
    fused = [sig for op, sig in logs["port"]
             if op == "fused_vocab_softmax_ce"]
    if kw.get("use_fused_ce"):
        assert fused and all(dict(sig)["Hidden"] == ("float32",)
                             for sig in fused), fused
    check_amp_parity(runs, arrays,
                     loss_share=0.5 if kw.get("use_fused_ce") else 0.25)
    np.testing.assert_allclose(runs["port_amp"][0], runs["ref_amp"][0],
                               rtol=0, atol=2e-3)
    check_state(runs, arrays, 4 * sum(_noam(t) for t in (1, 2, 3)) + 1e-7)
