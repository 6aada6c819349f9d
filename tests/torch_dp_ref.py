"""The reference's side of the data-parallel tests: the same programs
(tests/torch_dp_cases.py's builders) run by paddle_tpu on conftest's
virtual CPU mesh, and the gloo group fixture the test files share."""

from __future__ import annotations

import functools

import numpy as np
import pytest

import paddle_tpu as jf
import torch_dp_cases as cases
from torch_dist_harness import RankGroup
from torch_twin import reference_arrays, scope_of


def group_fixture(n, bootstrap="store"):
    """A module-scoped fixture: one RankGroup of n ranks for the whole
    file (spawning and importing cost seconds a group)."""

    @pytest.fixture(scope="module")
    def group(tmp_path_factory):
        g = RankGroup(n, str(tmp_path_factory.mktemp("ranks")),
                      bootstrap=bootstrap)
        try:
            yield g
        finally:
            g.close()

    return group


@functools.lru_cache(maxsize=None)
def ref_arrays(model):
    """The reference's startup values of `model` (memoized: read
    them, never write)."""
    return reference_arrays(cases.build(jf, model)[1])


def ref_train(model, feeds, mesh=None, grad_sync=None, reduce=False,
              rules=None, accum=1, run_accum=1, min_quant_numel=None,
              fetch=True, guard=False, arrays=None):
    """The reference's run of `model` (from `arrays`, default its own
    startup values): (startup arrays, {"losses", "fetches", "state"}),
    as `cases.train` returns the port's."""
    main, startup, out = cases.build(jf, model)
    if arrays is None:
        arrays = reference_arrays(startup)
    scope = scope_of(jf, arrays, main)
    exe = jf.Executor()
    if guard:
        from paddle_tpu.resilience import guard as _guard

        _guard.enable_update_guard(main)
    target = main
    if mesh is not None:
        bs = cases.build_strategy(jf, grad_sync, reduce, rules, accum,
                                  min_quant_numel)
        target = jf.CompiledProgram(main).with_data_parallel(
            loss_name=out["loss"].name, build_strategy=bs,
            mesh=jf.parallel.make_mesh(mesh))
    names = [out["loss"]] + (out["fetch"] if fetch else [])
    losses, fetches = [], []
    with jf.scope_guard(scope):
        for feed in feeds:
            res = exe.run(target, feed=feed, fetch_list=names, scope=scope,
                          accumulation_steps=run_accum)
            losses.append(float(np.asarray(res[0]).reshape(-1)[0]))
            fetches.append([np.asarray(r) for r in res[1:]])
    state = {v.name: np.asarray(scope.find_var(v.name))
             for v in main.list_vars()
             if v.persistable and scope.find_var(v.name) is not None}
    return arrays, {"losses": losses, "fetches": fetches, "state": state}


def assert_state_close(port, ref, rtol=1e-4, atol=1e-6, skip=()):
    """Every persistable var both runs hold, within the tolerance."""
    common = sorted(set(port) & set(ref) - set(skip))
    assert common, "no state in common"
    for n in common:
        np.testing.assert_allclose(port[n], ref[n], rtol=rtol, atol=atol,
                                   err_msg=n)


def assert_ranks_identical(results):
    """The ranks' results bit for bit equal (None: outside the mesh)."""
    live = [r for r in results if r is not None]
    for r in live[1:]:
        np.testing.assert_array_equal(r["losses"], live[0]["losses"])
        for n, v in live[0]["state"].items():
            np.testing.assert_array_equal(r["state"][n], v, err_msg=n)
    return live[0]
