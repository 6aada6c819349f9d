"""Pipeline parallelism in the port (paddle_tpu_torch/parallel/
pipeline.py and pipeline_engine.py) against the reference.

The port runs as one gloo group of 4 CPU processes for the whole file
(tests/torch_dist_harness.py; a smaller mesh takes the first ranks);
the reference on conftest's virtual 8-device mesh.

- tests/test_gpipe.py's cases: `gpipe` forward (replicated and
  scattered inputs, pytree activations) and `gpipe_loss_and_grad`
  (pp = 4, and dp = 2 x pp = 2) against the sequential composition of
  the stages, at the reference's tolerances (forward rtol 1e-5 / atol
  1e-6, gradients 1e-4 / 1e-5); each rank passes and gets back only its
  stage's slice of the parameters;
- tests/test_pipeline_engine.py's cases: the pipelined Transformer
  (pipeline=True, 4 layers a stack) at pp = 4, dp = 2 x pp = 2, pp = 2
  with 4 microbatches, pp = 4 with recompute inside each stage, and the
  tags inert on a dp mesh: two Adam steps within rtol 1e-4 /
  atol 1e-4 of the reference's unpipelined program (its tolerance;
  1e-5 for the inert tags), every rank holding 1/pp of the tagged
  layers' parameters; the structure errors, and pp x mp as the
  reference's designed PipelineStructureError.
"""

import functools

import numpy as np
import pytest

import torch_mp_cases as mpc
from torch_dp_ref import group_fixture, ref_arrays, ref_train

group = group_fixture(4)

S, D = 4, 8


def _params(seed, s=S):
    rng = np.random.RandomState(seed)
    return {"w": (rng.randn(s, D, D) * 0.4).astype(np.float32),
            "b": (rng.randn(s, D) * 0.1).astype(np.float32)}


def _sequential(params, micro_x, bias=None, grads_of=None):
    """tests/test_gpipe.py's `_sequential` (:28-33) in float64 torch:
    (output, and with `grads_of` (micro_y) the mean-square loss and the
    parameters' gradients)."""
    import torch

    p = {k: torch.as_tensor(v, dtype=torch.float64).requires_grad_()
         for k, v in params.items()}
    out = torch.as_tensor(micro_x, dtype=torch.float64)
    b = None if bias is None else torch.as_tensor(bias, dtype=torch.float64)
    for s in range(p["w"].shape[0]):
        z = out @ p["w"][s] + p["b"][s]
        out = torch.tanh(z if b is None else z + b)
    if grads_of is None:
        return out.detach().numpy()
    y = torch.as_tensor(grads_of, dtype=torch.float64)
    loss = torch.mean((out - y) ** 2)
    g = torch.autograd.grad(loss, [p["w"], p["b"]])
    return float(loss.detach()), {"w": g[0].numpy(), "b": g[1].numpy()}


@pytest.mark.parametrize("scatter", [False, True])
def test_gpipe_forward_matches_sequential(group, scatter):
    params = _params(0 if not scatter else 7)
    n_micro = 6 if not scatter else 2 * S
    micro_x = np.random.RandomState(1).randn(n_micro, 4, D).astype(
        np.float32)
    got = group.run("torch_mp_cases:gpipe_case", mesh={"pp": S},
                    params=params, micro_x=micro_x, scatter=scatter)
    want = _sequential(params, micro_x)
    for r in got:
        np.testing.assert_allclose(r["out"], want, rtol=1e-5, atol=1e-6)


def test_gpipe_pytree_activations(group):
    params = _params(9)
    rng = np.random.RandomState(10)
    micro_x = rng.randn(4, 4, D).astype(np.float32)
    bias = (rng.randn(4, 4, D) * 0.1).astype(np.float32)
    got = group.run("torch_mp_cases:gpipe_case", mesh={"pp": S},
                    params=params, micro_x=micro_x, pytree_bias=bias)
    want = _sequential(params, micro_x, bias=bias)
    for r in got:
        np.testing.assert_allclose(r["out"], want, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(r["bias"], bias)


@pytest.mark.parametrize("mesh,scatter", [({"pp": 4}, False),
                                          ({"dp": 2, "pp": 2}, False),
                                          ({"dp": 2, "pp": 2}, True)])
def test_gpipe_gradients_match_sequential(group, mesh, scatter):
    s = mesh["pp"]
    params = _params(2, s)
    rng = np.random.RandomState(3)
    micro_x = rng.randn(4, 4, D).astype(np.float32)
    micro_y = rng.randn(4, 4, D).astype(np.float32)
    got = group.run("torch_mp_cases:gpipe_case", mesh=mesh, params=params,
                    micro_x=micro_x, micro_y=micro_y, scatter=scatter,
                    batch_axis="dp" if "dp" in mesh else None)
    want_l, want_g = _sequential(params, micro_x, grads_of=micro_y)
    for r in got:
        np.testing.assert_allclose(r["loss"], want_l, rtol=1e-5)
        st = r["stage"]
        for k in ("w", "b"):
            np.testing.assert_allclose(r["grads"][k][0], want_g[k][st],
                                       rtol=1e-4, atol=1e-5)


@functools.lru_cache(maxsize=None)
def _unpipelined_losses():
    # the tags change no parameter: one set of startup values serves both
    return tuple(ref_train("pp_transformer_plain", FEEDS,
                           arrays=ref_arrays("pp_transformer"))[1][
        "losses"])


FEEDS = [mpc.pp_feed()] * 2


@pytest.mark.parametrize("key,model,mesh,micro,tol", [
    ("pp4", "pp_transformer", {"pp": 4}, 0, 1e-4),
    ("dp2xpp2", "pp_transformer", {"dp": 2, "pp": 2}, 0, 1e-4),
    ("pp2_micro4", "pp_transformer", {"pp": 2}, 4, 1e-4),
    ("pp4_recompute", "pp_transformer_recompute", {"pp": 4}, 0, 1e-4),
    ("inert", "pp_transformer", {"dp": 2}, 0, 1e-5)])
def test_pipelined_transformer_matches_unpipelined(group, key, model, mesh,
                                                   micro, tol):
    h = group.submit("torch_mp_cases:train_pp", model=model, feeds=FEEDS,
                     arrays=ref_arrays("pp_transformer"), mesh=mesh,
                     micro=micro,
                     held=True)
    ref = _unpipelined_losses()
    ranks = [r for r in group.collect(h, timeout=120) if r is not None]
    pp = mesh.get("pp", 1)
    for r in ranks:
        np.testing.assert_allclose(r["losses"], ref, rtol=tol, atol=tol)
        mine, total = r["held"]
        assert mine * pp == total, (mine, total)
    assert (ranks[0]["held"][1] > 0) == (pp > 1)


@pytest.mark.parametrize("model,mesh,error", [
    ("pp_unequal", {"pp": 2}, "structurally identical"),
    ("pp_transformer_l3", {"pp": 2}, "pp | n_layers"),
    ("pp_transformer_l2", {"pp": 2, "mp": 2},
     "cannot compose with in-stage sharded axes ['mp']")])
def test_structure_errors(group, model, mesh, error):
    feed = {"x": np.ones((4, 8), np.float32)} if model == "pp_unequal" \
        else mpc.pp_feed()
    msgs = group.run("torch_mp_cases:refusal", model=model, feed=feed,
                     arrays=None, mesh=mesh)
    for msg in msgs[:2]:
        assert msg is not None and "PipelineStructureError" in msg \
            and error in msg, msg
