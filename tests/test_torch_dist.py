"""The multi-trainer bootstrap and sharded checkpoints on a mesh: the
port's parallel.init_distributed (the file's 4 CPU processes join their
gloo group through it, from the PADDLE_* env variables), the
ParallelExecutor facade, Trainer(mesh=), and io.save_sharded /
load_sharded across mesh shapes, against the reference where it has the
same surface (tests/test_dist.py, tests/test_sharded_ckpt.py)."""

import json
import os

import numpy as np
import pytest

import paddle_tpu as jf
import paddle_tpu_torch as pt
import torch_dp_cases as cases
from torch_dp_ref import group_fixture, ref_train

group = group_fixture(4, bootstrap="env")


def _feeds(n=2, b=32, seed=0):
    rng = np.random.RandomState(seed)
    return [{"x": rng.randn(b, 32).astype(np.float32),
             "y": rng.randn(b, 1).astype(np.float32)} for _ in range(n)]


def test_init_distributed_from_the_env(group):
    """Each worker called init_distributed(place=CPUPlace(),
    health=False) with only PADDLE_TRAINER_ID / PADDLE_TRAINERS /
    PADDLE_COORDINATOR set: one gloo group of 4, the default mesh over
    it; global_batch assembles the trainers' local batches."""
    got = group.run("env_bootstrap")
    for r, g in enumerate(got):
        assert (g["rank"], g["world"], g["backend"]) == (r, 4, "gloo")
        assert g["mesh"] == {"dp": 4}
        assert g["env"] == [str(r), "4"]
        # global_batch: every trainer's local batch in rank order
        np.testing.assert_array_equal(
            g["global_batch"], np.repeat(np.arange(4, dtype=np.float32),
                                         2)[:, None].repeat(3, axis=1))


_HEALTH_RANK = """
import json, sys
import paddle_tpu_torch as pt
from paddle_tpu_torch.resilience import health
rank, world = pt.parallel.init_distributed(
    trainer_id=int(sys.argv[1]), num_trainers=2, coordinator=sys.argv[2],
    place=pt.CPUPlace())
plane = health.get_health_plane()
pt.io._barrier("health_started", timeout_s=60.0)
print(json.dumps({"rank": rank, "world": world,
                  "plane": [plane.rank, plane.num_ranks],
                  "started": plane._started}))
pt.parallel.shutdown_distributed()
print(json.dumps({"after": health.get_health_plane() is None}))
"""


def test_init_distributed_refusals():
    """The health plane (ROADMAP A step 11b, ported) starts with two
    trainers: two processes bootstrap with the default health=True and
    each finds its plane running, and shutdown_distributed stops it;
    CUDA is the default place and raises without it; one trainer and no
    coordinator is the reference's no-op."""
    import socket
    import subprocess
    import sys

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        coordinator = f"127.0.0.1:{sock.getsockname()[1]}"
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
         os.environ.get("PYTHONPATH", "")]))
    procs = [subprocess.Popen([sys.executable, "-c", _HEALTH_RANK, str(r),
                               coordinator], env=env,
                              stdout=subprocess.PIPE, text=True)
             for r in range(2)]
    outs = [p.communicate(timeout=120)[0] for p in procs]
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, out
        started, after = [json.loads(ln) for ln in out.splitlines()
                          if ln.startswith("{")]
        assert started == {"rank": r, "world": 2, "plane": [r, 2],
                           "started": True}
        assert after == {"after": True}
    with pytest.raises(RuntimeError, match="CUDA"):
        pt.parallel.init_distributed(trainer_id=0, num_trainers=2,
                                     coordinator="127.0.0.1:1",
                                     health=False)
    with pytest.raises(ValueError, match="coordinator"):
        pt.parallel.init_distributed(trainer_id=0, num_trainers=2,
                                     health=False)
    assert pt.parallel.init_distributed() == \
        jf.parallel.init_distributed(trainer_id=0, num_trainers=1)


def test_parallel_executor_run_for_run(group):
    """ParallelExecutor(loss_name, mesh).run against CompiledProgram, run
    for run, and both against the reference's ParallelExecutor."""
    feeds = _feeds(3)
    arrays, ref = ref_train("reg_mlp", feeds, mesh={"dp": 4})
    got = group.run("pe_vs_compiled", model="reg_mlp", feeds=feeds,
                    arrays=arrays, mesh={"dp": 4})
    for g in got:
        assert g["pe"][-1] == g["cp"][-1] == 4
        for a, b in zip(g["pe"][:-1], g["cp"][:-1]):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_allclose(
            [float(a.reshape(-1)[0]) for a in g["pe"][:-1]], ref["losses"],
            rtol=1e-5)
    main, startup, out = cases.build(jf, "reg_mlp")
    from torch_twin import scope_of

    scope = scope_of(jf, arrays, main)
    pe = jf.ParallelExecutor(loss_name=out["loss"].name, main_program=main,
                             scope=scope,
                             mesh=jf.parallel.make_mesh({"dp": 4}))
    jl = [float(np.asarray(pe.run([out["loss"]], feed=f)[0]).reshape(-1)[0])
          for f in feeds]
    np.testing.assert_allclose(jl, ref["losses"], rtol=1e-6)


def test_trainer_on_a_mesh_resumes_through_load_sharded(group, tmp_path):
    """Trainer(mesh=, build_strategy=int8) trains data-parallel (the
    reference's tests/test_grad_sync.py:291), checkpoints, and a second
    Trainer resumes onto the mesh with the first one's state bit for
    bit; every rank the same losses."""
    rng = np.random.RandomState(0)
    batches = [{"x": rng.rand(32, 16).astype(np.float32),
                "y": rng.rand(32, 1).astype(np.float32)} for _ in range(4)]
    got = group.run("trainer_dp", timeout=120,
                    ckpt_dir=str(tmp_path / "ck"), batches=batches,
                    mesh={"dp": 4})
    for g in got:
        first, resumed = g["first"], g["resumed"]
        assert first["compiled"] and first["mode"] == "int8"
        assert len(first["losses"]) == 4
        assert np.isfinite(first["losses"]).all()
        assert first["losses"] == got[0]["first"]["losses"]
        for n, v in first["state"].items():
            if n.startswith("fc_"):
                np.testing.assert_array_equal(resumed["state"][n], v)


def test_sharded_save_on_4_loads_onto_2_and_one(group, tmp_path):
    """A checkpoint saved on 4 ranks — ZeRO-1 (fsdp=4: Adam moments
    sliced) and ZeRO-3 (Reduce on dp=4: params sliced) — loads onto 2
    ranks (fsdp=2 / dp=2, resharded) and onto one device, every logical
    value bit for bit; each rank wrote only its own slices."""
    feeds = _feeds(2)
    arrays, _ = ref_train("reg_mlp_adam", [])
    for kw, small in (({"mesh": {"fsdp": 4}}, {"fsdp": 2}),
                      ({"mesh": {"dp": 4}, "reduce": True}, {"dp": 2})):
        d = str(tmp_path / "x".join(kw["mesh"]))
        saved = group.run("save_ckpt", model="reg_mlp_adam", feeds=feeds,
                          arrays=arrays, dirname=d, **kw)
        state = saved[0]["state"]
        for s in saved[1:]:
            for n, v in state.items():
                np.testing.assert_array_equal(s["state"][n], v)
        assert all(s["bytes"] > 0 for s in saved)
        with open(os.path.join(d, "__shards__.json")) as f:
            metas = json.load(f)["vars"]
        sliced = [n for n, m in metas.items() if len(m["shards"]) == 4]
        assert sliced and all(
            sorted(sh["file"] for sh in metas[n]["shards"])
            == [f"shards_p{r}.npz" for r in range(4)] for n in sliced)
        reduce = kw.get("reduce", False)
        two = group.run("load_ckpt", model="reg_mlp_adam", dirname=d,
                        mesh=small, reduce=reduce)
        one = group.run("load_ckpt", model="reg_mlp_adam", dirname=d)
        assert two[2] is None and two[3] is None
        for res in two[:2] + one:
            for n, v in state.items():
                np.testing.assert_array_equal(res["loaded"][n], v,
                                              err_msg=n)
        assert two[0]["sharded"] and not one[0]["sharded"]


def test_reference_dp_checkpoint_loads_bit_for_bit(group, tmp_path):
    """A sharded checkpoint the reference saved on a dp=4 mesh under
    Reduce (params sliced over dp, several shards a var) loads onto the
    port's dp=2 Reduce mesh and onto one device with the reference's
    arrays bit for bit, and the next step on dp=2 matches the
    reference's next step on its dp=2 mesh."""
    feeds = _feeds(3)
    main, startup, out = cases.build(jf, "reg_mlp_adam")
    from torch_twin import reference_arrays, scope_of

    arrays = reference_arrays(startup)
    scope = scope_of(jf, arrays, main)
    exe = jf.Executor()
    d = str(tmp_path / "ref")
    with jf.scope_guard(scope):
        bs = cases.build_strategy(jf, reduce=True)
        jf.CompiledProgram(main).with_data_parallel(
            loss_name=out["loss"].name, build_strategy=bs,
            mesh=jf.parallel.make_mesh({"dp": 4}))
        for f in feeds[:2]:
            exe.run(main, feed=f, fetch_list=[out["loss"]], scope=scope)
        jf.io.save_sharded(exe, d, main_program=main)
        want = {v.name: np.asarray(scope.find_var(v.name))
                for v in main.list_vars() if v.persistable}
        bs = cases.build_strategy(jf, reduce=True)
        jf.CompiledProgram(main).with_data_parallel(
            loss_name=out["loss"].name, build_strategy=bs,
            mesh=jf.parallel.make_mesh({"dp": 2}))
        (next_loss,) = exe.run(main, feed=feeds[2], fetch_list=[out["loss"]],
                               scope=scope)
    with open(os.path.join(d, "__shards__.json")) as f:
        assert any(len(m["shards"]) > 1 for m in json.load(f)["vars"].values())
    two = group.run("load_ckpt", model="reg_mlp_adam", dirname=d,
                    mesh={"dp": 2}, reduce=True, feed=feeds[2])
    one = group.run("load_ckpt", model="reg_mlp_adam", dirname=d)
    for res in two[:2] + one[:1]:
        for n, v in want.items():
            if n in res["loaded"]:
                np.testing.assert_array_equal(res["loaded"][n], v, err_msg=n)
    np.testing.assert_allclose(two[0]["loss"],
                               float(np.asarray(next_loss).reshape(-1)[0]),
                               rtol=1e-5)


def test_dead_peer_in_sharded_save_is_barrier_timeout_not_hang(group,
                                                               tmp_path):
    """tests/test_dist.py:149: a rank that dies inside the save window
    ends every other rank's save as a CheckpointBarrierTimeoutError
    naming it, within the timeout — no manifest, no orphaned shards.
    Last in the file: it ends the group."""
    d = str(tmp_path / "chaos")
    got = group.collect(group.submit("dead_peer_save", dirname=d, victim=3,
                                     timeout_s=3.0),
                        timeout=60, allow_exit=(3,))
    for r in range(3):
        g = got[r]
        err = g["error"]
        assert err is not None, g
        assert err["error"] == "checkpoint_barrier_timeout"
        assert err["missing_ranks"] == [3]
        assert err["tag"] == "save_sharded:shards"
        assert err["timeout_s"] == 3.0
        assert g["seconds"] < 30
        assert "__shards__.json" not in g["files"]
        assert f"shards_p{r}.npz" not in g["files"]
        assert f"shards_p{r}.crc.json" not in g["files"]
