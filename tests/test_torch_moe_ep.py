"""Expert parallelism in the port (moe_ffn on an `ep` mesh,
paddle_tpu_torch/ops/moe.py) against the reference at the same mesh
sizes.

The port runs as one gloo group of 8 CPU processes for the whole file
(tests/torch_dist_harness.py; a smaller mesh takes the first ranks);
the reference on conftest's virtual 8-device mesh.  The program is
tests/test_moe.py's (:179-291): a switch-MoE block (4 experts, top-1),
a 3-way classifier, CE + 0.01 x the load-balance loss, Momentum, 16
rows, 4 steps from the reference's startup values.

- capacity factor 4 (no token overflows): ep = 2 and dp = 2 x mp = 2 x
  ep = 2 under megatron_transformer_rules(moe_axis="ep") (experts over
  ep, each expert's hidden dim over mp), and dp = 2 x mp = 4 with the
  experts over mp, against the reference on the same meshes and
  against one device, losses within rtol 1e-4 / atol 1e-5 (the
  reference test's tolerance);
- capacity factor 1 (tokens overflow): the grouped routing of an ep
  mesh (G = ep groups, capacity per group) is the reference's own
  semantics, not one device's (ROADMAP C18): the port's ep = 2 and dp =
  2 x mp = 2 x ep = 2 runs against the reference's ep runs and against
  the port's one-process plain version of the same grouping
  (`moe_grouped(groups=2)`), losses within 1e-5, the dropped token
  choices equal (the ranks' groups summed against the plain version's);
  at dp = 2 the global batch routes as one group, as one device.
"""

import numpy as np
import pytest

import torch_dp_cases as cases
import torch_mp_cases as mpc
from torch_dp_ref import group_fixture, ref_arrays, ref_train
from torch_twin import scope_of

group = group_fixture(8)


def _ref_mesh_losses(model, feeds, arrays, mesh, moe_axis):
    import paddle_tpu as jf
    from paddle_tpu.parallel.strategies import megatron_transformer_rules

    main, startup, out = cases.build(jf, model)
    scope = scope_of(jf, arrays, main)
    exe = jf.Executor()
    bs = jf.BuildStrategy()
    bs.sharding_rules = megatron_transformer_rules(moe_axis=moe_axis)
    cp = jf.CompiledProgram(main).with_data_parallel(
        loss_name=out["loss"].name, build_strategy=bs,
        mesh=jf.parallel.make_mesh(mesh))
    losses = []
    with jf.scope_guard(scope):
        for f in feeds:
            (lv,) = exe.run(cp, feed=f, fetch_list=[out["loss"]],
                            scope=scope)
            losses.append(float(np.asarray(lv).reshape(-1)[0]))
    return losses


def _port(group, handle):
    """The live ranks' results, their losses bit-identical."""
    ranks = [r for r in group.collect(handle, timeout=120) if r is not None]
    for r in ranks[1:]:
        np.testing.assert_array_equal(r["losses"], ranks[0]["losses"])
    return ranks


@pytest.mark.parametrize("mesh,moe_axis", [
    ({"ep": 2}, "ep"), ({"dp": 2, "mp": 2, "ep": 2}, "ep"),
    ({"dp": 2, "mp": 4}, "mp")])
def test_ep_parity_without_overflow(group, mesh, moe_axis):
    feeds = mpc.moe_feeds()
    arrays = ref_arrays("moe_net")
    h = group.submit("torch_mp_cases:train_moe", model="moe_net",
                     feeds=feeds, arrays=arrays, mesh=mesh,
                     moe_axis=moe_axis)
    single = ref_train("moe_net", feeds, arrays=arrays)[1]["losses"]
    ref = _ref_mesh_losses("moe_net", feeds, arrays, mesh, moe_axis)
    ranks = _port(group, h)
    for want in (ref, single):
        np.testing.assert_allclose(ranks[0]["losses"], want, rtol=1e-4,
                                   atol=1e-5)
    assert not any(sum(r["drops"]) for r in ranks)
    assert ranks[0]["losses"][-1] < ranks[0]["losses"][0]


def test_grouped_routing_under_overflow(group):
    model = "moe_net_tight"
    feeds = mpc.moe_feeds()
    arrays = ref_arrays(model)
    h_plain = group.submit("torch_mp_cases:moe_grouped_plain", model=model,
                           feeds=feeds, arrays=arrays, groups=2)
    h_ep = group.submit("torch_mp_cases:train_moe", model=model,
                        feeds=feeds, arrays=arrays, mesh={"ep": 2})
    h_3 = group.submit("torch_mp_cases:train_moe", model=model, feeds=feeds,
                       arrays=arrays, mesh={"dp": 2, "mp": 2, "ep": 2})
    h_dp = group.submit("torch_mp_cases:train", model=model, feeds=feeds,
                        arrays=arrays, mesh={"dp": 2})
    single = ref_train(model, feeds, arrays=arrays)[1]["losses"]
    ref_ep = _ref_mesh_losses(model, feeds, arrays, {"ep": 2}, "ep")
    plain = group.collect(h_plain, timeout=120)[0]
    ep, three, dp = (_port(group, h) for h in (h_ep, h_3, h_dp))
    # the overflow makes the grouping matter
    assert max(abs(a - b) for a, b in zip(ref_ep, single)) > 1e-4
    for run in (plain, ep[0], three[0]):
        np.testing.assert_allclose(run["losses"], ref_ep, rtol=1e-5,
                                   atol=1e-7)
    np.testing.assert_allclose(dp[0]["losses"], single, rtol=1e-5,
                               atol=1e-7)
    # dropped choices: the plain version logs both groups' each call, an
    # ep rank its own group's
    assert sum(plain["drops"]) > 0
    assert [a + b for a, b in zip(ep[0]["drops"], ep[1]["drops"])] \
        == plain["drops"]
