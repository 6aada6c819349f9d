"""paddle_tpu_torch.parallel's surface against paddle_tpu.parallel:
the pure-Python sharding rules and strategies, the meshes, the
CompiledProgram call forms, and every collective — the blockwise-int8
exchange bit for bit — on a gloo group of 4 CPU processes (2- and
4-rank sub-meshes) against the reference on conftest's virtual mesh.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

import paddle_tpu as jf
import paddle_tpu_torch as pt
import torch_dp_cases as cases
from paddle_tpu.parallel import collectives as JC
from paddle_tpu.parallel import strategies as JS
from paddle_tpu_torch.parallel import collectives as TC
from paddle_tpu_torch.parallel import strategies as TS
from paddle_tpu_torch.parallel.mesh import Mesh
from torch_dp_ref import group_fixture, ref_train

group = group_fixture(4)

MESHES = [{"dp": 2}, {"dp": 8}, {"fsdp": 4}, {"dp": 2, "fsdp": 2},
          {"dp": 2, "fsdp": 2, "mp": 2}, {"sp": 4}]
NAMES = [("fc_0.w_0", (32, 128)), ("fc_0.b_0", (128,)),
         ("fc_0.w_0_moment1_0", (32, 128)), ("beta1_pow_acc_0", (1,)),
         ("ffn_in.w_0.velocity", (32, 128)), ("attn_qkv_0.w_0", (16, 48)),
         ("word_emb", (100, 16)), ("moe_expert_0.w_0", (4, 16, 32)),
         ("odd", (7, 3)), ("x", (8, 4)), ("x", (6, 4)), ("x", (3, 4)),
         ("scalar", ())]


def _rule_sets(pkg):
    return [pkg.ShardingRules(),
            pkg.ShardingRules(default="fsdp"),
            pkg.ShardingRules(default="fsdp", fsdp_axis="fsdp",
                              zero_axis=None),
            pkg.ShardingRules(rules=[(r"ffn_in\S*\.w", (None, "mp")),
                                     (r"special", (None, "dp"))]),
            pkg.megatron_transformer_rules(),
            pkg.megatron_transformer_rules(fsdp=True, moe_axis="ep")]


def _rules_call(rules, meth, *args):
    """A method's result, or the type of what it raised (an axis the
    mesh lacks raises KeyError in both packages)."""
    try:
        return getattr(rules, meth)(*args)
    except Exception as e:  # noqa: BLE001
        return type(e).__name__


@pytest.mark.parametrize("axes", MESHES,
                         ids=["x".join(f"{a}{s}" for a, s in m.items())
                              for m in MESHES])
def test_sharding_rules_match_the_reference(axes):
    """spec_for, data_axes_for, opt_state_spec_for, feed_spec_for and
    _validate on the same names, shapes and meshes."""
    jmesh = jf.parallel.make_mesh(axes)
    tmesh = Mesh(axes)
    for jr, tr in zip(_rule_sets(JS), _rule_sets(TS)):
        for ba in ("dp", "fsdp"):
            assert tr.data_axes_for(tmesh, ba) == \
                jr.data_axes_for(jmesh, ba)
        for name, shape in NAMES:
            for meth in ("spec_for", "opt_state_spec_for",
                         "feed_spec_for"):
                assert _rules_call(tr, meth, name, shape, tmesh) == \
                    _rules_call(jr, meth, name, shape, jmesh), (
                        meth, name, shape)
            assert TS.ShardingRules._validate(("dp", "mp"), shape, tmesh) \
                == JS.ShardingRules._validate(("dp", "mp"), shape, jmesh)


def test_grad_sync_config_and_strategies():
    assert TS.GradSyncConfig.normalize(None) is None
    cfg = TS.GradSyncConfig.normalize("int8")
    assert (cfg.mode, cfg.block_size, cfg.min_quant_numel) == \
        (JS.GradSyncConfig("int8").mode, 256, 4096)
    assert TS.GradSyncConfig.normalize(cfg) is cfg
    assert repr(cfg) == repr(JS.GradSyncConfig("int8"))
    with pytest.raises(ValueError, match="not in"):
        TS.GradSyncConfig.normalize("fp4")
    assert vars(pt.BuildStrategy()) == vars(jf.BuildStrategy())
    assert vars(pt.ExecutionStrategy()) == vars(jf.ExecutionStrategy())
    assert (pt.BuildStrategy.ReduceStrategy.AllReduce,
            pt.BuildStrategy.ReduceStrategy.Reduce) == (0, 1)


def test_names_and_mesh_without_a_group():
    """The reference's parallel names minus step 10b's; the five
    top-level names; a one-rank mesh without a process group, and the
    reference's error for a larger one."""
    want = {n for n in dir(jf.parallel) if not n.startswith("_")} - {
        "gpipe", "gpipe_loss_and_grad", "ring_attention",
        "ulysses_attention", "pipeline", "pipeline_engine",
        "ring_attention"}
    have = {n for n in dir(pt.parallel) if not n.startswith("_")}
    assert want <= have, want - have
    for n in ("gpipe", "ring_attention", "ulysses_attention"):
        assert not hasattr(pt.parallel, n)
    for n in ("parallel", "CompiledProgram", "BuildStrategy",
              "ExecutionStrategy", "ParallelExecutor"):
        assert hasattr(pt, n) and hasattr(jf, n)
    m = pt.parallel.make_mesh({"dp": 1})
    assert m.shape == {"dp": 1} and m.member and m.rank() == 0
    assert pt.parallel.get_default_mesh().shape == {"dp": 1}
    with pytest.raises(ValueError) as te:
        pt.parallel.make_mesh({"dp": 2})
    with pytest.raises(ValueError) as je:
        jf.parallel.make_mesh({"dp": 16})
    assert str(te.value) == "mesh needs 2 devices, only 1 available"
    assert str(je.value).startswith("mesh needs 16 devices, only")
    assert pt.parallel.init_distributed(trainer_id=0, num_trainers=1) \
        == (0, 1)
    pt.parallel.shutdown_distributed()
    pt.parallel.shutdown_distributed()
    with pytest.raises(ValueError, match="both dcn and ici"):
        pt.parallel.make_multihost_mesh({"dp": 1}, {"dp": 1})


def test_compiled_program_one_rank_is_the_plain_run():
    """Both call forms — exe.run(compiled) and exe.run(main) after
    with_data_parallel — at dp=1 equal plain Executor.run bit for bit;
    compiled_step/compiled_hlo_text name the cost plane (step 11); a
    model axis of size > 1 names step 10b."""
    feeds = [{"x": np.random.RandomState(i).randn(8, 16).astype(np.float32),
              "y": np.random.RandomState(i).randint(0, 4, (8, 1))
              .astype(np.int64)} for i in range(3)]
    arrays, _ = ref_train("mlp", [])
    runs = {}
    for form in ("plain", "compiled", "wrapped"):
        main, startup, out = cases.build(pt, "mlp")
        scope = cases._scope_from(arrays, main)
        exe = pt.Executor(pt.CPUPlace())
        target = main
        if form != "plain":
            cp = pt.CompiledProgram(main).with_data_parallel(
                loss_name=out["loss"].name,
                mesh=pt.parallel.make_mesh({"dp": 1}))
            target = cp if form == "compiled" else main
        runs[form] = [exe.run(target, feed=f, fetch_list=[out["loss"]],
                              scope=scope)[0] for f in feeds]
        runs[form].append(cases._logical(main, scope))
    for form in ("compiled", "wrapped"):
        for a, b in zip(runs[form][:-1], runs["plain"][:-1]):
            np.testing.assert_array_equal(a, b)
        for n, v in runs["plain"][-1].items():
            np.testing.assert_array_equal(runs[form][-1][n], v)
    with pytest.raises(NotImplementedError, match="step 11"):
        cp.compiled_step(feeds[0], [out["loss"].name])
    with pytest.raises(NotImplementedError, match="step 11"):
        cp.compiled_hlo_text(feeds[0], [out["loss"].name], None)
    main, startup, out = cases.build(pt, "mlp")
    scope = cases._scope_from(arrays, main)
    mp = pt.CompiledProgram(main).with_data_parallel(
        loss_name=out["loss"].name, mesh=Mesh({"dp": 1, "mp": 2}))
    with pytest.raises(NotImplementedError, match="step 10b"):
        pt.Executor(pt.CPUPlace()).run(mp, feed=feeds[0],
                                       fetch_list=[out["loss"]],
                                       scope=scope)


def test_moe_ep_refusal_names_step_10b():
    from paddle_tpu_torch.core.registry import OpContext, get_op_impl
    from paddle_tpu_torch.parallel.mesh import executing_mesh

    rng = np.random.RandomState(0)
    shapes = {"X": (6, 4), "GateW": (4, 2), "W1": (2, 4, 8), "B1": (2, 8),
              "W2": (2, 8, 4), "B2": (2, 4)}
    ins = {k: [torch.as_tensor(rng.randn(*s).astype(np.float32))]
           for k, s in shapes.items()}
    with executing_mesh(Mesh({"dp": 1, "ep": 2})):
        with pytest.raises(NotImplementedError, match="step 10b"):
            get_op_impl("moe_ffn")(OpContext((0, 0), 0, device="cpu"),
                                   ins, {"top_k": 1})


# -- the blockwise int8 quantization ----------------------------------------

def _quant_inputs(n, size, seed=0, dtype=np.float32, zero_chunk=False):
    rng = np.random.RandomState(seed)
    x = (rng.randn(n, size) * rng.uniform(0.1, 3.0, (n, 1))).astype(dtype)
    if zero_chunk:
        x[:, : size // 3] = 0       # whole zero blocks: scale 1
    return x


def test_quantize_blockwise_bit_for_bit():
    x = _quant_inputs(3, 4 * 256, seed=1, zero_chunk=True).reshape(
        3, 4, 256)
    x[0, 1, 5] = 0.5 * np.abs(x[0, 1]).max() / 127 * 3   # a .5 tie scaled
    jq, js = JC.quantize_blockwise(jnp.asarray(x), 256)
    tq, ts = TC.quantize_blockwise(torch.as_tensor(x), 256)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(
        TC.dequantize_blockwise(tq, ts).numpy(),
        np.asarray(JC.dequantize_blockwise(jq, js)))


QUANT = [  # (n, size, dtype, block, floor, op, zero chunk, psum form)
    (2, 5000, np.float32, 256, 4096, "mean", False, False),   # pads
    (4, 3 * 4096, np.float32, 256, 4096, "sum", True, True),  # zero blocks
    (4, 4095, np.float32, 256, 4096, "mean", False, False),   # the floor
    (4, 9000, np.int32, 256, 1, "mean", False, False),        # int: exact
]


@pytest.mark.parametrize("n,size,dtype,block,floor,op,zero,psum", QUANT)
def test_quantized_all_reduce_bit_for_bit(group, n, size, dtype, block,
                                          floor, op, zero, psum):
    """quantized_all_reduce_local (and the wrapper) equal the
    reference's on the same per-rank inputs bit for bit, the same bytes
    on every rank; the psum form (the explicit exchange's on dp x fsdp)
    equals the reference's psum form."""
    x = _quant_inputs(n, size, seed=n + size, zero_chunk=zero)
    if dtype == np.int32:
        x = (x * 10).astype(np.int32)
    handle = group.submit("quantized", n=n, inputs=list(x),
                          block_size=block, min_quant_numel=floor, op=op)
    jmesh = jf.parallel.make_mesh({"x": n})
    want = np.asarray(JC.quantized_all_reduce(
        jnp.asarray(x), jmesh, "x", op=op, block_size=block,
        min_quant_numel=floor))
    if psum:
        want_psum = np.asarray(JC.compat_shard_map(
            lambda xs: JC.quantized_all_reduce_psum(
                xs[0], "x", n, None, block_size=block,
                min_quant_numel=floor, op=op),
            jmesh, (P("x"),), P())(jnp.asarray(x)))
    got = group.collect(handle)
    for r in range(n):
        for k in ("local", "wrapper"):
            np.testing.assert_array_equal(got[r][k], want, err_msg=k)
            assert got[r][k].dtype == want.dtype
        if psum:
            np.testing.assert_array_equal(got[r]["psum"], want_psum)
    assert all(g is None for g in got[n:])


def test_every_collective_against_the_reference(group):
    """psum, all_reduce (sum/max/mean), all_gather, reduce_scatter,
    ppermute, all_to_all and barrier on 2 and 4 ranks: each rank's
    piece of the reference's global result (ROADMAP C16)."""
    for n in (2, 4):
        rng = np.random.RandomState(n)
        A = rng.randn(n, 3, 5).astype(np.float32)
        G = rng.randn(n * 2, 3).astype(np.float32)
        R = rng.randn(n * 2, 3).astype(np.float32)
        PP = rng.randn(n * 2, 3).astype(np.float32)
        T = rng.randn(n, n * 2, 3).astype(np.float32)
        perm = [(i, (i + 1) % n) for i in range(n - 1)]   # rank 0 gets 0s
        inputs = {"ar": [A[r:r + 1] for r in range(n)],
                  "ag": [G[2 * r:2 * r + 2] for r in range(n)],
                  "rs": [R] * n,
                  "pp": [PP[2 * r:2 * r + 2] for r in range(n)],
                  "a2a": [T[r:r + 1] for r in range(n)]}
        handle = group.submit("collectives", n=n, inputs=inputs, perm=perm)
        jm = jf.parallel.make_mesh({"x": n})
        want = {
            "all_reduce": np.asarray(JC.all_reduce(jnp.asarray(A), jm, "x")),
            "all_reduce_max": np.asarray(
                JC.all_reduce(jnp.asarray(A), jm, "x", op="max")),
            "all_reduce_mean": np.asarray(
                JC.all_reduce(jnp.asarray(A), jm, "x", op="mean")),
            "all_gather": np.asarray(JC.all_gather(jnp.asarray(G), jm,
                                                   "x")),
            "reduce_scatter": np.asarray(JC.reduce_scatter(
                jnp.asarray(R), jm, "x")),
            "ppermute": np.asarray(JC.ppermute(jnp.asarray(PP), jm, "x",
                                               perm)),
            "all_to_all": np.asarray(JC.all_to_all(
                jnp.asarray(T), jm, "x", split_dim=1, concat_dim=0)),
            "barrier": np.asarray(JC.barrier(jm, "x")),
        }
        got = group.collect(handle)
        for r in range(n):
            g = got[r]
            np.testing.assert_allclose(g["psum"], want["all_reduce"],
                                       rtol=1e-6)
            for k in ("all_reduce", "all_reduce_max", "all_reduce_mean",
                      "all_gather", "barrier"):
                np.testing.assert_allclose(g[k], want[k], rtol=1e-6,
                                           err_msg=k)
            np.testing.assert_allclose(
                g["reduce_scatter"], want["reduce_scatter"][2 * r:2 * r + 2],
                rtol=1e-6)
            np.testing.assert_array_equal(
                g["ppermute"], want["ppermute"][2 * r:2 * r + 2])
            np.testing.assert_array_equal(
                g["all_to_all"], want["all_to_all"][:, 2 * r:2 * r + 2])


def test_numerics_bitmap_ors_across_ranks(group):
    """observe.numerics.or_across_axis: the exact bitwise OR of every
    rank's bitmap, bit 31 (the int32 sign bit) included."""
    rng = np.random.RandomState(0)
    words = [rng.randint(-2 ** 31, 2 ** 31 - 1, 5).astype(np.int32)
             & rng.randint(-2 ** 31, 2 ** 31 - 1, 5).astype(np.int32)
             for _ in range(4)]
    words[2][0] = np.int32(-2 ** 31)
    got = group.run("bits_or", words=words)
    want = np.bitwise_or.reduce(np.stack(words), axis=0)
    for g in got:
        np.testing.assert_array_equal(g, want)
