"""Tensor (Megatron) parallelism in the port
(paddle_tpu_torch/parallel/tensor_parallel.py) against the reference at
the same mesh sizes.

The port runs as one gloo group of 8 CPU processes for the whole file
(tests/torch_dist_harness.py); a case on a smaller mesh takes the
group's first ranks.  The reference runs on conftest's virtual 8-device
mesh.  Both start from the reference's startup values and take the same
numpy feeds.

- tests/test_hybrid_parallel.py's `_mp_rules` MLP at mp = 2 and at dp =
  4 x mp = 2: the default mode, the explicit bf16 and int8 exchanges
  over the data axis, as the reference's tests assert (losses within
  1e-5 of one device; int8 deterministic, quantizing, within 1e-2 of
  bf16) and against the reference's own dp4 x mp2 run; fsdp = 2 beside
  mp = 2 (ZeRO state sharded over both) against the reference's.
- A tiny Transformer (2+2 layers, 4 heads) under
  megatron_transformer_rules at mp = 2, in three forms: separate QKV
  with the soft-label CE, fused QKV with the fused CE, head-major:
  losses within 1e-5, state within rtol 1e-4 / atol 1e-5 (the first
  form against the reference, the others against the port's
  one-process run), step 1's gradients within 1e-5 relative L2 of the
  port's one-process run; the collectives a step
  inserts (one forward all-reduce an attention block and one an MLP
  block, two for the embeddings, two plus a max for the vocab-parallel
  CE; no forward all-gather: the heads stay sharded); each rank holds
  half of every sharded weight; replicated parameters' gradients are
  bit-identical on both ranks.
- Checkpoints: a dp = 8 save loads onto dp = 2 x mp = 2 (the mp weight
  lands sharded) and a dp = 4 x mp = 2 save onto one device, bit for
  bit.
"""

import numpy as np
import pytest

import torch_mp_cases as mpc
from torch_dp_ref import (assert_ranks_identical, assert_state_close,
                          group_fixture, ref_arrays, ref_train)

group = group_fixture(8)

TP = "torch_mp_cases:train_mp"


def _rel_l2(got, want):
    num = sum(float(np.sum((got[n].astype(np.float64) - want[n]) ** 2))
              for n in want)
    den = sum(float(np.sum(want[n].astype(np.float64) ** 2)) for n in want)
    return (num / den) ** 0.5


def test_mp_mlp_matches_one_device(group):
    feeds = mpc.hybrid_feeds()
    arrays = ref_arrays("hybrid_mlp")
    h = group.submit(TP, model="hybrid_mlp", feeds=feeds, arrays=arrays,
                     mesh={"mp": 2}, rules=mpc.mp_rules_spec(), grads=True,
                     local_bytes=True)
    h1 = group.submit(TP, model="hybrid_mlp", feeds=feeds, arrays=arrays,
                      mesh={"mp": 1}, grads=True)
    _, ref = ref_train("hybrid_mlp", feeds, arrays=arrays)
    port = assert_ranks_identical(group.collect(h, timeout=120))
    one = group.collect(h1, timeout=120)[0]
    np.testing.assert_allclose(port["losses"], ref["losses"], rtol=1e-5,
                               atol=1e-7)
    assert_state_close(port["state"], ref["state"])
    assert _rel_l2(port["grads"], one["grads"]) < 1e-5
    # one forward all-reduce (ffn_out's partial sum); ffn_in's bias
    # enters as a slice whose gradient is all-gathered
    assert port["counts"][-1] == {"all_reduce": 1, "all_gather_bwd": 1}
    for name in ("ffn_in.w_0", "ffn_out.w_0"):
        local, whole = port["bytes"][name]
        assert 2 * local == whole, (name, local, whole)


@pytest.mark.parametrize("mode", ["default", "bf16", "int8"])
def test_dp4_x_mp2_as_the_reference_asserts(group, mode):
    """tests/test_hybrid_parallel.py:185-219 at dp = 4 x mp = 2."""
    feeds = mpc.hybrid_feeds()
    arrays = ref_arrays("hybrid_mlp")
    kw = dict(model="hybrid_mlp", feeds=feeds, arrays=arrays,
              mesh={"dp": 4, "mp": 2}, rules=mpc.mp_rules_spec())
    if mode == "default":
        h = group.submit(TP, **kw)
        _, single = ref_train("hybrid_mlp", feeds, arrays=arrays)
        _, implicit = ref_train("hybrid_mlp", feeds, arrays=arrays,
                                mesh={"dp": 4, "mp": 2},
                                rules=mpc.mp_rules_spec())
        port = assert_ranks_identical(group.collect(h, timeout=120))
        np.testing.assert_allclose(port["losses"], single["losses"],
                                   rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(port["losses"], implicit["losses"],
                                   rtol=1e-5, atol=1e-7)
        assert_state_close(port["state"], implicit["state"])
        return
    if mode == "bf16":
        h = group.submit(TP, grad_sync="bf16", **kw)
        _, single = ref_train("hybrid_mlp", feeds, arrays=arrays)
        port = assert_ranks_identical(group.collect(h, timeout=120))
        np.testing.assert_allclose(port["losses"], single["losses"],
                                   rtol=1e-5, atol=1e-7)
        return
    runs = [group.submit(TP, grad_sync="int8", min_quant_numel=1, **kw)
            for _ in range(2)]
    hb = group.submit(TP, grad_sync="bf16", **kw)
    a, b = (assert_ranks_identical(group.collect(h, timeout=120))["losses"]
            for h in runs)
    bf16 = assert_ranks_identical(group.collect(hb, timeout=120))["losses"]
    a, b, bf16 = np.asarray(a), np.asarray(b), np.asarray(bf16)
    assert np.array_equal(a, b), "int8 on dp x mp not deterministic"
    assert not np.array_equal(a, bf16), "quantization inactive"
    rel = np.abs(a - bf16) / np.maximum(np.abs(bf16), 1e-6)
    assert rel.max() < 1e-2, rel
    assert np.isfinite(a).all()


def test_fsdp_beside_mp(group):
    """fsdp = 2 x mp = 2 with Adam: the moments sharded over both axes
    (ZeRO over fsdp on the first free dim, mp on the rule's), against
    the reference's run on the same mesh."""
    feeds = mpc.hybrid_feeds()
    arrays = ref_arrays("hybrid_mlp_adam")
    h = group.submit(TP, model="hybrid_mlp_adam", feeds=feeds,
                     arrays=arrays, mesh={"fsdp": 2, "mp": 2},
                     rules=mpc.mp_rules_spec())
    _, ref = ref_train("hybrid_mlp_adam", feeds, arrays=arrays,
                       mesh={"fsdp": 2, "mp": 2},
                       rules=mpc.mp_rules_spec())
    port = assert_ranks_identical(group.collect(h, timeout=120))
    np.testing.assert_allclose(port["losses"], ref["losses"], rtol=1e-5,
                               atol=1e-7)
    assert_state_close(port["state"], ref["state"])


# attention blocks and MLP blocks of the 2+2-layer Transformer
_BLOCKS = 2 + 2 * 2 + 2 + 2


@pytest.mark.parametrize("form", sorted(mpc.MP_FORMS))
def test_megatron_transformer(group, form):
    """The plain form against the reference; the others against the
    port's one-process run from the same start (the port's seeded
    startup values), which the one-process tests hold to the
    reference."""
    model = f"mp_transformer_{form}"
    feeds = mpc.transformer_feeds()
    arrays = ref_arrays(model) if form == "plain" else None
    h = group.submit(TP, model=model, feeds=feeds, arrays=arrays,
                     mesh={"mp": 2}, megatron={}, grads=True,
                     local_bytes=True)
    h1 = group.submit(TP, model=model, feeds=feeds, arrays=arrays,
                      mesh={"mp": 1}, grads=True)
    ref = None
    if form == "plain":
        ref = ref_train(model, feeds, arrays=arrays)[1]
    ranks = group.collect(h, timeout=120)
    one = group.collect(h1, timeout=120)[0]
    port = assert_ranks_identical(ranks)
    want = ref if ref is not None else one
    np.testing.assert_allclose(port["losses"], want["losses"], rtol=1e-5,
                               atol=1e-7)
    assert_state_close(port["state"], want["state"], atol=1e-5,
                       skip=("@lr_decay_counter@",))
    assert _rel_l2(port["grads"], one["grads"]) < 1e-5
    counts = port["counts"][-1]
    ce = 0 if form == "fused_qkv_ce" else 2
    assert counts.get("all_reduce") == _BLOCKS + 2 + ce, counts
    assert counts.get("all_reduce_max", 0) == (ce > 0), counts
    assert "all_gather" not in counts, counts
    sharded = {n: b for n, b in port["bytes"].items() if b[0] != b[1]}
    assert sharded and all(2 * loc == whole
                           for loc, whole in sharded.values()), sharded
    heads = {n for n in sharded if n.startswith(("attn_qkv", "attn_out"))}
    assert len(heads) >= 2 * 6, sorted(sharded)
    # replicated parameters' gradients: bit-identical on both mp ranks
    rep = [n for n, b in port["bytes"].items() if b[0] == b[1]]
    assert rep
    for n in rep:
        np.testing.assert_array_equal(ranks[0]["grads"][n],
                                      ranks[1]["grads"][n], err_msg=n)


def test_reshard_dp8_to_dp2_mp2_and_mp_to_one_device(group, tmp_path):
    """tests/test_hybrid_parallel.py:405-431 and :445-460's reshard: a
    dp = 8 checkpoint onto dp = 2 x mp = 2 (ffn_in's weight landing as
    its (32, 64) half) and an mp = 2 checkpoint onto one device, the
    logical values bit for bit (the mp save on dp = 4 x mp = 2: a save
    takes every rank of the group)."""
    feeds = mpc.hybrid_feeds(n=2)
    arrays = ref_arrays("hybrid_mlp")
    d8, dmp = str(tmp_path / "dp8"), str(tmp_path / "mp2")
    saved = group.run("torch_mp_cases:save_mp", model="hybrid_mlp",
                      feeds=feeds, arrays=arrays, mesh={"dp": 8},
                      dirname=d8, rules=None, timeout=120)[0]["state"]
    got = group.run("torch_mp_cases:load_local_shapes", model="hybrid_mlp",
                    dirname=d8, mesh={"dp": 2, "mp": 2},
                    rules=mpc.mp_rules_spec(), timeout=120)
    for r in got[:4]:
        for n, v in saved.items():
            np.testing.assert_array_equal(r["loaded"][n], v, err_msg=n)
        assert r["local"]["ffn_in.w_0"] == (32, 64), r["local"]
    saved = group.run("torch_mp_cases:save_mp", model="hybrid_mlp",
                      feeds=feeds, arrays=arrays, mesh={"dp": 4, "mp": 2},
                      dirname=dmp, rules=mpc.mp_rules_spec(),
                      timeout=120)[0]["state"]
    got = group.run("torch_mp_cases:load_local_shapes", model="hybrid_mlp",
                    dirname=dmp, timeout=120)[0]
    for n, v in saved.items():
        np.testing.assert_array_equal(got["loaded"][n], v, err_msg=n)
    assert got["local"] == {}
