"""Checkpoints and inference export in the port (`paddle_tpu_torch.io`),
against the JAX package's `paddle_tpu.io`: the file format is the
contract, so a checkpoint either package writes loads in the other,
bit for bit (tests/torch_twin.py builds the programs).

- Combined (`save_persistables`) and sharded (`save_sharded`) round
  trips in the port, with a bfloat16 and an int64 variable besides the
  trained float32 state: every value loads with its bits, on the
  executor's device; 64-bit arrays written by numpy load narrowed to 32
  bits as `convert.params_from_arrays` narrows them.
- Across packages, both tiers and both directions: the reference writes
  and the port loads, the port writes and the reference loads, bf16
  included, bit for bit.
- A reference checkpoint saved from the conftest's 8-device CPU mesh
  (dp2 x mp4, the Megatron rules of tests/test_sharded_ckpt.py: four
  shards of each fc weight) loads whole in the port, bit for bit.
- The structured errors of tests/test_resilience.py:277-382, raised by
  both packages with the same type and `kind`: missing manifest, corrupt
  and truncated shard, garbage manifest, newer format, a missing shard
  file, a torn checkpoint through the `ckpt:before_manifest` failpoint
  and through `tear_checkpoint`, and the combined tier's missing
  manifest and CRC mismatch.
- Inference export across packages: a model saved by either loads and
  runs in the other with the fetches of the saver's own reload (rtol
  1e-6: float32, one fc layer).
- Without ml_dtypes (and without jax) in the process, the port still
  writes and reads bf16 checkpoints, the reference's included.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as jf
import paddle_tpu_torch as tf

from torch_twin import PKGS, batches, build, linreg, twins

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
EXTRA = {"bf16_state": ("bfloat16", (3, 5)), "step_ids": ("int64", (4,))}


@pytest.fixture(autouse=True)
def _clear_failpoints():
    yield
    jf.resilience.chaos.clear()
    tf.resilience.chaos.clear()


def _bits(v):
    """The stored bits of a scope value of either package (bf16 as
    int16, so the comparison is of bits, not values)."""
    if isinstance(v, torch.Tensor):
        t = v.detach().cpu()
        return (t.view(torch.int16) if t.dtype == torch.bfloat16 else t) \
            .numpy()
    a = np.asarray(v)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def _extra_values(rng):
    a = rng.randn(*EXTRA["bf16_state"][1]).astype(np.float32)
    ids = rng.randint(0, 1 << 20, EXTRA["step_ids"][1])
    return {"ref": {"bf16_state": jnp.asarray(a).astype(jnp.bfloat16),
                    "step_ids": jnp.asarray(ids, jnp.int32)},
            "port": {"bf16_state": torch.tensor(a).to(torch.bfloat16),
                     "step_ids": torch.tensor(ids, dtype=torch.int32)}}


def _with_extras(fluid):
    loss = linreg(fluid)
    block = fluid.default_main_program().global_block()
    for name, (dtype, shape) in EXTRA.items():
        block.create_var(name=name, shape=shape, dtype=dtype,
                         persistable=True)
    return loss


def _trained(seed=0):
    """Both packages' twins of `_with_extras`, two momentum steps
    trained, the bf16 and int64 variables set (the same values)."""
    t = twins(_with_extras)
    extras = _extra_values(np.random.RandomState(seed))
    for side, (main, scope, exe, loss) in t.items():
        for b in batches(2):
            exe.run(main, feed=b, fetch_list=[loss], scope=scope)
        for n, v in extras[side].items():
            scope.set_var(n, v)
    return t


def _state(main, scope):
    return {v.name: _bits(scope.find_var(v.name))
            for v in main.list_vars() if v.persistable}


def _save(side, tier, t, d):
    fluid = PKGS[side]
    main, scope, exe, _ = t[side]
    with fluid.scope_guard(scope):
        if tier == "combined":
            fluid.io.save_persistables(exe, d, main_program=main)
        else:
            fluid.io.save_sharded(exe, d, main_program=main)


def _load(side, tier, t, d):
    """Load into a fresh scope of `side`'s program; returns the state."""
    fluid = PKGS[side]
    main, _, exe, _ = t[side]
    scope = fluid.Scope()
    with fluid.scope_guard(scope):
        if tier == "combined":
            fluid.io.load_persistables(exe, d, main_program=main)
        else:
            fluid.io.load_sharded(exe, d, main_program=main)
    return _state(main, scope), scope


def _assert_same_bits(got, want):
    assert set(got) == set(want)
    for n, w in want.items():
        assert got[n].dtype == w.dtype, (n, got[n].dtype, w.dtype)
        np.testing.assert_array_equal(got[n], w, err_msg=n)


@pytest.mark.parametrize("tier", ["combined", "sharded"])
def test_port_round_trip_keeps_every_bit(tier, tmp_path):
    t = _trained()
    main, scope, exe, _ = t["port"]
    _save("port", tier, t, str(tmp_path))
    got, loaded = _load("port", tier, t, str(tmp_path))
    _assert_same_bits(got, _state(main, scope))
    assert loaded.find_var("bf16_state").dtype == torch.bfloat16
    assert loaded.find_var("step_ids").dtype == torch.int32
    assert all(v.device.type == "cpu" for v in loaded.vars.values()
               if isinstance(v, torch.Tensor))


@pytest.mark.parametrize("tier", ["combined", "sharded"])
@pytest.mark.parametrize("writer", ["ref", "port"])
def test_checkpoints_cross_packages_bit_for_bit(writer, tier, tmp_path):
    t = _trained()
    reader = "port" if writer == "ref" else "ref"
    _save(writer, tier, t, str(tmp_path))
    got, _ = _load(reader, tier, t, str(tmp_path))
    _assert_same_bits(got, _state(*t[writer][:2]))
    # the two packages trained to the same values, within float32 noise
    want = _state(*t[reader][:2])
    for n in ("bf16_state", "step_ids"):
        np.testing.assert_array_equal(got[n], want[n])


def test_numpy_64_bit_arrays_load_narrowed(tmp_path):
    main, scope, exe, _ = _trained()["port"]
    state = {v.name: scope.find_var(v.name) for v in main.list_vars()
             if v.persistable}
    arrays = {n: (v.float() if v.dtype == torch.bfloat16 else v).numpy()
              for n, v in state.items()}
    arrays = {n: a.astype(np.float64 if a.dtype.kind == "f" else np.int64)
              for n, a in arrays.items()}
    np.savez(tmp_path / "params.npz", **arrays)
    with open(tmp_path / tf.io.MANIFEST, "w") as f:
        json.dump({"version": 1, "file": "params.npz",
                   "vars": sorted(arrays),
                   "dtypes": {n: str(a.dtype) for n, a in arrays.items()}},
                  f)
    loaded = tf.Scope()
    with tf.scope_guard(loaded):
        tf.io.load_persistables(exe, str(tmp_path), main_program=main)
    for n, a in arrays.items():
        v = loaded.find_var(n)
        assert v.dtype == (torch.float32 if a.dtype.kind == "f"
                           else torch.int32), n
        np.testing.assert_array_equal(v.numpy(), a.astype(v.numpy().dtype))


def _mlp(fluid):
    """tests/test_sharded_ckpt.py's `_build`."""
    layers = fluid.layers
    x = layers.data(name="x", shape=[16], dtype="float32")
    y = layers.data(name="y", shape=[1], dtype="int64")
    h = layers.fc(x, size=32, act="relu", name="ffn_in")
    logits = layers.fc(h, size=8, name="ffn_out")
    loss = layers.mean(layers.softmax_with_cross_entropy(logits, y))
    fluid.optimizer.MomentumOptimizer(learning_rate=0.1,
                                      momentum=0.9).minimize(loss)
    return loss


def test_reference_mesh_checkpoint_loads_whole(tmp_path):
    from paddle_tpu.parallel import ShardingRules, make_mesh

    mesh = make_mesh({"dp": 2, "mp": 4})
    main, startup, loss = build(jf, _mlp, seed=3)
    scope = jf.Scope()
    ckpt = str(tmp_path / "ckpt")
    rng = np.random.RandomState(5)
    with jf.scope_guard(scope):
        exe = jf.Executor()
        exe.run(startup)
        bs = jf.BuildStrategy()
        bs.sharding_rules = ShardingRules(rules=[
            (r"ffn_in\S*\.w", (None, "mp")),
            (r"ffn_out\S*\.w", ("mp", None))])
        prog = jf.CompiledProgram(main).with_data_parallel(
            loss_name=loss.name, build_strategy=bs, mesh=mesh)
        for _ in range(2):
            exe.run(prog, feed={
                "x": rng.randn(32, 16).astype(np.float32),
                "y": rng.randint(0, 8, (32, 1)).astype(np.int64)},
                fetch_list=[loss])
        jf.io.save_sharded(exe, ckpt, main_program=main)
    with open(os.path.join(ckpt, jf.io.SHARD_MANIFEST)) as f:
        metas = json.load(f)["vars"]
    w_in = next(n for n in metas if "ffn_in" in n and ".w" in n)
    assert len(metas[w_in]["shards"]) == 4          # mp = 4 slices
    want = {v.name: _bits(scope.find_var(v.name)) for v in main.list_vars()
            if v.persistable}
    tmain = build(tf, _mlp, seed=3)[0]
    tscope, texe = tf.Scope(), tf.Executor(tf.CPUPlace())
    with tf.scope_guard(tscope):
        tf.io.load_sharded(texe, ckpt, main_program=tmain)
    _assert_same_bits(_state(tmain, tscope), want)
    with pytest.raises(NotImplementedError, match="step 10"):
        tf.io.load_sharded(texe, ckpt, main_program=tmain, mesh=object())


# -- the structured errors (tests/test_resilience.py:277-382) -------------

def _missing_manifest(fluid, main, exe, ckpt, tmp):
    fluid.io.load_sharded(exe, os.path.join(tmp, "nowhere"),
                          main_program=main)


def _corrupt(mode):
    def case(fluid, main, exe, ckpt, tmp):
        fluid.resilience.chaos.corrupt_shard(ckpt, mode=mode)
        fluid.io.load_sharded(exe, ckpt, main_program=main)
    return case


def _garbage_manifest(fluid, main, exe, ckpt, tmp):
    with open(os.path.join(ckpt, fluid.io.SHARD_MANIFEST), "w") as f:
        f.write("{ not json")
    fluid.io.load_sharded(exe, ckpt, main_program=main)


def _newer_format(fluid, main, exe, ckpt, tmp):
    path = os.path.join(ckpt, fluid.io.SHARD_MANIFEST)
    with open(path) as f:
        manifest = json.load(f)
    manifest["version"] = 10 ** 6
    with open(path, "w") as f:
        json.dump(manifest, f)
    fluid.io.load_sharded(exe, ckpt, main_program=main)


def _missing_shard_file(fluid, main, exe, ckpt, tmp):
    os.remove(os.path.join(ckpt, "shards_p0.npz"))
    fluid.io.load_sharded(exe, ckpt, main_program=main)


def _torn_by_failpoint(fluid, main, exe, ckpt, tmp):
    torn = os.path.join(tmp, "torn")
    fluid.resilience.chaos.arm("ckpt:before_manifest")
    with pytest.raises(fluid.resilience.chaos.ChaosKilled):
        fluid.io.save_sharded(exe, torn, main_program=main)
    assert os.path.exists(os.path.join(torn, "shards_p0.npz"))
    assert not os.path.exists(os.path.join(torn, fluid.io.SHARD_MANIFEST))
    fluid.io.load_sharded(exe, torn, main_program=main)


def _torn_by_tear(fluid, main, exe, ckpt, tmp):
    fluid.resilience.chaos.tear_checkpoint(ckpt)
    fluid.io.load_sharded(exe, ckpt, main_program=main)


def _combined_missing(fluid, main, exe, ckpt, tmp):
    fluid.io.load_persistables(exe, os.path.join(tmp, "empty"),
                               main_program=main)


def _combined_crc(fluid, main, exe, ckpt, tmp):
    d = os.path.join(tmp, "plain")
    fluid.io.save_persistables(exe, d, main_program=main)
    fluid.io.load_persistables(exe, d, main_program=main)      # clean
    fluid.resilience.chaos.corrupt_file(os.path.join(d, "params.npz"))
    fluid.io.load_persistables(exe, d, main_program=main)


ERRORS = {
    "missing manifest": (_missing_manifest, "CheckpointNotFoundError"),
    "corrupt shard": (_corrupt("flip"), "CheckpointCorruptError"),
    "truncated shard": (_corrupt("truncate"), "CheckpointCorruptError"),
    "garbage manifest": (_garbage_manifest, "CheckpointCorruptError"),
    "newer format": (_newer_format, "CheckpointFormatError"),
    "missing shard file": (_missing_shard_file,
                           "CheckpointIncompleteError"),
    "torn by failpoint": (_torn_by_failpoint, "CheckpointNotFoundError"),
    "torn by tear_checkpoint": (_torn_by_tear, "CheckpointNotFoundError"),
    "combined missing manifest": (_combined_missing,
                                  "CheckpointNotFoundError"),
    "combined crc": (_combined_crc, "CheckpointCorruptError"),
}


@pytest.mark.parametrize("case", sorted(ERRORS))
def test_structured_checkpoint_errors(case, tmp_path):
    fn, err = ERRORS[case]
    raised = {}
    for side, (main, scope, exe, loss) in twins(linreg).items():
        fluid = PKGS[side]
        tmp = str(tmp_path / side)
        ckpt = os.path.join(tmp, "ck")
        with fluid.scope_guard(scope):
            for b in batches(2):
                exe.run(main, feed=b, fetch_list=[loss])
            fluid.io.save_sharded(exe, ckpt, main_program=main)
            with pytest.raises(getattr(fluid.resilience, err)) as ei:
                fn(fluid, main, exe, ckpt, tmp)
        raised[side] = ei.value.as_dict()
        assert raised[side]["error"] == ei.value.kind
    assert raised["port"]["error"] == raised["ref"]["error"]
    if case == "missing manifest":
        assert "nowhere" in raised["port"]["dirname"]


# -- inference export ------------------------------------------------------

def _regressor(fluid):
    layers = fluid.layers
    x = layers.data(name="x", shape=[4], dtype="float32")
    y = layers.data(name="y", shape=[1], dtype="float32")
    pred = layers.fc(x, size=3, act="relu")
    pred = layers.fc(pred, size=1)
    loss = layers.mean(layers.square(pred - y))
    fluid.optimizer.SGDOptimizer(learning_rate=0.1).minimize(loss)
    return loss, pred


@pytest.mark.parametrize("saver", ["ref", "port"])
def test_inference_export_crosses_packages(saver, tmp_path):
    t = twins(_regressor)
    x = batches(1, seed=4)[0]["x"]
    fetched = {}
    main, scope, exe, (loss, pred) = t[saver]
    fluid = PKGS[saver]
    with fluid.scope_guard(scope):
        for b in batches(2):
            exe.run(main, feed=b, fetch_list=[loss])
        fluid.io.save_inference_model(str(tmp_path), ["x"], [pred], exe,
                                      main_program=main)
    for side, fluid in PKGS.items():
        exe = t[side][2]
        with fluid.scope_guard(fluid.Scope()):
            prog, feeds, targets = fluid.io.load_inference_model(
                str(tmp_path), exe)
            assert feeds == ["x"]
            assert [v.name for v in targets] == [pred.name]
            assert prog._backward_info is None
            fetched[side] = exe.run(prog, feed={"x": x},
                                    fetch_list=targets)[0]
    np.testing.assert_allclose(fetched["port"], fetched["ref"], rtol=1e-6,
                               atol=1e-7)
    with open(tmp_path / "__model__") as f:
        assert json.load(f)["fetch_var_names"] == [pred.name]


# -- bf16 without ml_dtypes ------------------------------------------------

_NO_ML_DTYPES = """
import sys
sys.modules["ml_dtypes"] = None
sys.modules["jax"] = None
sys.modules["paddle_tpu"] = None
import numpy as np, torch
import paddle_tpu_torch as tf
ref_dir, work = sys.argv[1], sys.argv[2]
main = tf.Program()
blk = main.global_block()
blk.create_var(name="bf16_state", shape=(3, 5), dtype="bfloat16",
               persistable=True)
exe = tf.Executor(tf.CPUPlace())
want = np.load(ref_dir + "/bits.npy")
for tier, load in (("combined", tf.io.load_persistables),
                   ("sharded", tf.io.load_sharded)):
    scope = tf.Scope()
    with tf.scope_guard(scope):
        load(exe, ref_dir + "/" + tier, main_program=main)
        got = scope.find_var("bf16_state")
        assert got.dtype == torch.bfloat16
        assert (got.view(torch.int16).numpy() == want).all(), tier
        out = work + "/" + tier
        (tf.io.save_persistables if tier == "combined"
         else tf.io.save_sharded)(exe, out, main_program=main)
        scope.set_var("bf16_state", torch.zeros(3, 5, dtype=torch.bfloat16))
        load(exe, out, main_program=main)
        assert (scope.find_var("bf16_state").view(torch.int16).numpy()
                == want).all(), tier
assert "ml_dtypes" not in [m for m, v in sys.modules.items() if v]
print("ok")
"""


def test_bf16_round_trip_without_ml_dtypes(tmp_path):
    """The reference writes bf16 checkpoints (both tiers); a process with
    neither ml_dtypes nor jax loads them, writes its own and reads those
    back, every bit kept."""
    main, startup, _ = build(jf, lambda f: f.default_main_program()
                             .global_block().create_var(
                                 name="bf16_state", shape=(3, 5),
                                 dtype="bfloat16", persistable=True))
    value = jnp.asarray(np.random.RandomState(1).randn(3, 5)
                        .astype(np.float32)).astype(jnp.bfloat16)
    scope, exe = jf.Scope(), jf.Executor()
    scope.set_var("bf16_state", value)
    ref_dir = tmp_path / "ref"
    with jf.scope_guard(scope):
        jf.io.save_persistables(exe, str(ref_dir / "combined"),
                                main_program=main)
        jf.io.save_sharded(exe, str(ref_dir / "sharded"), main_program=main)
    np.save(ref_dir / "bits.npy", _bits(value))
    with open(ref_dir / "combined" / jf.io.MANIFEST) as f:
        assert json.load(f)["dtypes"]["bf16_state"] == "bfloat16"
    r = subprocess.run([sys.executable, "-c", _NO_ML_DTYPES, str(ref_dir),
                        str(tmp_path)], cwd=REPO, capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip() == "ok"
    # and the reference reads what that process wrote
    check = jf.Scope()
    with jf.scope_guard(check):
        jf.io.load_sharded(exe, str(tmp_path / "sharded"),
                           main_program=main)
    np.testing.assert_array_equal(_bits(check.find_var("bf16_state")),
                                  _bits(value))


def test_save_sharded_reports_its_phases(tmp_path):
    main, scope, exe, _ = _trained()["port"]
    with tf.scope_guard(scope):
        job = tf.io.save_sharded(exe, str(tmp_path), main_program=main)
        with pytest.raises(NotImplementedError, match="step 6c"):
            tf.io.save_sharded(exe, str(tmp_path), main_program=main,
                               async_=True)
    state = [scope.find_var(v.name) for v in main.list_vars()
             if v.persistable]
    assert job.bytes_total == sum(v.numel() * v.element_size()
                                  for v in state)
    assert os.path.getsize(tmp_path / "shards_p0.npz") > job.bytes_total
    assert job.snapshot_ms >= 0 and job.write_ms >= 0
    with open(tmp_path / tf.io.SHARD_MANIFEST) as f:
        metas = json.load(f)["vars"]
    assert all(len(m["shards"]) == 1 and "crc32" in m["shards"][0]
               for m in metas.values())
    assert metas["bf16_state"]["dtype"] == "bfloat16"
    assert not (tmp_path / (tf.io.SHARD_MANIFEST + ".tmp")).exists()
