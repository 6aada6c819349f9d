"""Sequence parallelism in the port (paddle_tpu_torch/parallel/
ring_attention.py and the flash op's sequence_parallel route) against
the reference at sp = 2.

The port runs as one gloo group of 4 CPU processes for the whole file
(tests/torch_dist_harness.py; a 2-rank case takes the first two); the
reference on conftest's virtual 8-device mesh.

- tests/test_ring_attention.py's cases: ring and Ulysses attention on
  each rank's T chunk of q/k/v (N 2, H 8, T 64, D 16; each strategy in
  both layouts and both maskings) against full attention on the same
  global arrays (the reference test's `_full_attention`, in float64),
  outputs at the reference's rtol 2e-4 / atol 2e-5 and gradients at
  its 2e-3 / 2e-4 (float32 chunks; the ring's merge and the ring
  backward from the final O and lse sum in another order than one
  process);
  the flash calls with a non-zero q/k offset counted;
- the fluid programs (an fc to head-grouped QKV, the flash op with
  sequence_parallel, mean of squares, SGD) at sp = 2, Ulysses too, and
  at dp = 2 x sp = 2: three steps' losses within rtol 1e-4 of the
  reference's unsharded program (its test's tolerance);
- the three refusals, with the reference's messages.
"""

import numpy as np
import pytest

import torch_mp_cases  # noqa: F401  (registers the sp builders)
from torch_dp_ref import group_fixture, ref_arrays, ref_train

group = group_fixture(4)


@pytest.fixture(scope="module")
def qkv():
    rng = np.random.RandomState(0)
    n, h, t, d = 2, 8, 64, 16
    return [(rng.randn(n, h, t, d) * 0.5).astype(np.float32)
            for _ in range(4)]


def _layout(a, layout):
    if layout == "nthd":
        n, h, t, d = a.shape
        return np.ascontiguousarray(a.transpose(0, 2, 1, 3)).reshape(
            n, t, h * d)
    return a


# each strategy in both layouts and both maskings, in four runs
FUNCTIONAL = [("ring", "nhtd", True), ("ring", "nthd", False),
              ("ulysses", "nthd", True), ("ulysses", "nhtd", False)]


def _full_attention(q, k, v, causal, layout, n_head):
    """tests/test_ring_attention.py's `_full_attention` (:16-23), in
    float64 torch, either layout."""
    import torch

    if layout == "nthd":
        n, t, hd = q.shape
        q, k, v = (x.reshape(n, t, n_head, hd // n_head).transpose(1, 2)
                   for x in (q, k, v))
    s = q @ k.transpose(-1, -2) * q.shape[-1] ** -0.5
    if causal:
        t = s.shape[-1]
        s = torch.where(torch.ones(t, t, dtype=torch.bool).tril(), s,
                        torch.full((), -1e30, dtype=s.dtype))
    o = torch.softmax(s, dim=-1) @ v
    if layout == "nthd":
        o = o.transpose(1, 2).reshape(n, t, hd)
    return o


@pytest.mark.parametrize("strategy,layout,causal", FUNCTIONAL)
def test_ring_and_ulysses_match_full_attention(group, qkv, layout, strategy,
                                               causal):
    import torch

    q, k, v, do = (_layout(a, layout) for a in qkv)
    n_head = 8 if layout == "nthd" else None
    h = group.submit("torch_mp_cases:ring_functional", strategy=strategy,
                     q=q, k=k, v=v, do=do, causal=causal, layout=layout,
                     n_head=n_head)
    ts = [torch.as_tensor(a, dtype=torch.float64).requires_grad_()
          for a in (q, k, v)]
    want = _full_attention(*ts, causal, layout, n_head)
    grads = torch.autograd.grad(want, ts, torch.as_tensor(
        do, dtype=torch.float64))
    got = group.collect(h, timeout=120)[:2]
    t_axis = 1 if layout == "nthd" else 2
    o = np.concatenate([r["o"] for r in got], axis=t_axis)
    np.testing.assert_allclose(o, want.detach().numpy(), rtol=2e-4,
                               atol=2e-5)
    for key, g in zip(("dq", "dk", "dv"), grads):
        np.testing.assert_allclose(
            np.concatenate([r[key] for r in got], axis=t_axis),
            g.numpy(), rtol=2e-3, atol=2e-4, err_msg=key)
    if strategy == "ring":
        # rank 1's chunks carry offsets; under causal rank 0 skips the
        # chunk wholly after its queries
        assert got[1]["offsets"] == {"flash_attention_fwd": 2,
                                     "flash_attention_bwd": 2}
        assert got[0]["offsets"] == ({} if causal else {
            "flash_attention_fwd": 1, "flash_attention_bwd": 1})


@pytest.mark.parametrize("model,mesh", [
    ("sp_ring", {"sp": 2}), ("sp_ulysses", {"sp": 2}),
    ("sp_ring", {"dp": 2, "sp": 2})])
def test_sequence_parallel_program_trajectory(group, model, mesh):
    """tests/test_ring_attention.py:101-182's programs: three SGD steps
    on a mesh with an sp axis against the reference's unsharded run."""
    x = np.random.RandomState(0).randn(2, 32, 16).astype(np.float32)
    feeds = [{"x": x}] * 3
    arrays = ref_arrays(model)
    h = group.submit("torch_mp_cases:train_mp", model=model, feeds=feeds,
                     arrays=arrays, mesh=mesh)
    _, ref = ref_train(model, feeds, arrays=arrays)
    ranks = [r for r in group.collect(h, timeout=120) if r is not None]
    for r in ranks:
        np.testing.assert_allclose(r["losses"], ref["losses"], rtol=1e-4,
                                   atol=1e-6)
    assert ranks[0]["losses"][-1] < ranks[0]["losses"][0]


@pytest.mark.parametrize("model,shape,words", [
    ("sp_bias", (2, 2, 16, 4), "does not take an additive Bias"),
    ("sp_heads", (2, 3, 16, 4), "must divide n_head (3)"),
    ("sp_length", (2, 2, 15, 4), "sequence length 15 must be divisible")])
def test_sequence_parallel_refusals(group, model, shape, words):
    feed = {"q": np.zeros(shape, np.float32)}
    if model == "sp_bias":
        feed["b"] = np.zeros((2, 1, 16, 16), np.float32)
    msgs = group.run("torch_mp_cases:forward_refusal", model=model,
                     feed=feed, mesh={"sp": 2})
    for msg in msgs[:2]:
        assert msg is not None and msg.startswith("ValueError") \
            and "sequence_parallel" in msg and words in msg, msg
