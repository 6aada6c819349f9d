"""Ragged paged attention: the PyTorch port's plain version against the
JAX package's dense-gather twin (`_xla_paged_attention`) and its Pallas
kernel (`ragged_paged_attention`, interpret mode on the CPU — the JAX
tests' own way), on the same numpy inputs.

Cases: float32, bfloat16 and int8 pools (int8 with per-row scale
sidecars), ragged lengths, page-table entries past a slot's used range
left 0 (as the engine keeps them), and rows at or past each length
poisoned with NaN / huge values, as an evicted slot would leave them.

The kernel's blocking (flash-decoding: each run of `pages_per_split`
pages of a slot gives its own online-softmax state, and the states are
merged in split order) is held against both reference functions through
its plain twin `paged_attention_split_plain`, at split sizes of 1, 2 and
all pages, with lengths 0, on a page or split boundary and wholly short
of later splits; the split size comes from shapes only.  The folded
shape of the speculative verify run (k+1 rows a slot on one page table
at staggered lengths, dead rows pinned to a slot's first row, inactive
slots of length 0) goes through the same checks.

Tolerance 1e-5 (abs and rel): both sides dequantize the same stored
values to float32 and differ only in summation order.
"""

from __future__ import annotations

import inspect

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.ops.paged_kv import _xla_paged_attention
from paddle_tpu.ops.pallas.paged_attention import ragged_paged_attention
from paddle_tpu_torch.ops.kernels import paged_attention as tk

from torch_op_test import round_bf16, run_torch_op, to_torch

torch.set_num_threads(2)

TOL = dict(rtol=1e-5, atol=1e-5)


def _case(seed, kv_dtype, s=4, h=2, dh=16, p=12, page=4, maxp=3,
          poison=True):
    """Numpy inputs of one decode step over a paged pool."""
    rng = np.random.RandomState(seed)
    hd = h * dh
    q = rng.randn(s, hd).astype(np.float32)
    lens = rng.randint(1, page * maxp + 1, s).astype(np.int32)
    lens[0] = 1                                  # a fresh slot
    pt = np.zeros((s, maxp), np.int32)
    perm = rng.permutation(p)
    for i in range(s):                           # disjoint pages, 0 past
        used = -(-int(lens[i]) // page)          # the used range
        pt[i, :used] = perm[i * maxp:i * maxp + used]
    if kv_dtype == "int8":
        kc = rng.randint(-127, 128, (p, page, hd)).astype(np.int8)
        vc = rng.randint(-127, 128, (p, page, hd)).astype(np.int8)
        ks = rng.uniform(0.001, 0.02, (p, page, 1)).astype(np.float32)
        vs = rng.uniform(0.001, 0.02, (p, page, 1)).astype(np.float32)
    else:
        kc = rng.randn(p, page, hd).astype(np.float32)
        vc = rng.randn(p, page, hd).astype(np.float32)
        if kv_dtype == "bfloat16":
            kc, vc = round_bf16(kc), round_bf16(vc)
        ks = vs = None
    if poison and kv_dtype != "int8":
        for i in range(s):
            for t in range(int(lens[i]), maxp * page):
                pg = pt[i, t // page]
                if t // page < -(-int(lens[i]) // page):
                    kc[pg, t % page] = 1e3
                    vc[pg, t % page] = np.nan
    return q, kc, vc, pt, lens, h, ks, vs


def _jax_pool(x, kv_dtype):
    return jnp.asarray(x, jnp.bfloat16 if kv_dtype == "bfloat16" else None)


def _torch_pool(x, kv_dtype):
    return to_torch(x, torch.bfloat16 if kv_dtype == "bfloat16" else None)


@pytest.mark.parametrize("kv_dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("seed", [0, 1])
def test_plain_matches_jax_twin_and_pallas(kv_dtype, seed):
    q, kc, vc, pt, lens, h, ks, vs = _case(seed, kv_dtype)
    jks = None if ks is None else jnp.asarray(ks)
    jvs = None if vs is None else jnp.asarray(vs)
    twin = np.asarray(_xla_paged_attention(
        jnp.asarray(q), _jax_pool(kc, kv_dtype), _jax_pool(vc, kv_dtype),
        jnp.asarray(pt), jnp.asarray(lens), h, (q.shape[1] // h) ** -0.5,
        ks=jks, vs=jvs))
    pallas = np.asarray(ragged_paged_attention(
        jnp.asarray(q), _jax_pool(kc, kv_dtype), _jax_pool(vc, kv_dtype),
        jnp.asarray(pt), jnp.asarray(lens), n_head=h, k_scales=jks,
        v_scales=jvs))
    got = tk.paged_attention_plain(
        to_torch(q), _torch_pool(kc, kv_dtype), _torch_pool(vc, kv_dtype),
        to_torch(pt), to_torch(lens), h,
        k_scales=None if ks is None else to_torch(ks),
        v_scales=None if vs is None else to_torch(vs)).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, twin, **TOL)
    np.testing.assert_allclose(got, pallas, **TOL)


def test_poisoned_rows_do_not_change_the_output():
    """Rows at/after each length hold NaN (V) and 1e3 (K): the output
    equals the unpoisoned one bit for bit."""
    clean = _case(3, "float32", poison=False)
    dirty = _case(3, "float32", poison=True)
    outs = []
    for q, kc, vc, pt, lens, h, _, _ in (clean, dirty):
        outs.append(tk.paged_attention_plain(
            to_torch(q), to_torch(kc), to_torch(vc), to_torch(pt),
            to_torch(lens), h).numpy())
    np.testing.assert_array_equal(outs[0], outs[1])


@pytest.mark.parametrize("kv_dtype", ["float32", "int8"])
def test_op_matches_jax_op(kv_dtype):
    """The registered `paged_attention` op, port vs reference (CPU)."""
    from op_test import run_op

    q, kc, vc, pt, lens, h, ks, vs = _case(5, kv_dtype)
    ins = {"Q": q, "KCache": kc, "VCache": vc, "PageTable": pt,
           "Lengths": lens}
    if ks is not None:
        ins.update(KScale=ks, VScale=vs)
    want = run_op("paged_attention", ins, {"n_head": h})
    got = run_torch_op("paged_attention", ins,
                       {"n_head": h, "use_pallas": True})
    np.testing.assert_allclose(got, want, **TOL)


def test_cpu_routes_to_plain_and_counts():
    """A CPU tensor takes the plain version and never the kernel."""
    from paddle_tpu_torch.ops import kernels

    q, kc, vc, pt, lens, h, _, _ = _case(6, "float32")
    before = dict(kernels.launch_counts), dict(kernels.plain_calls)
    tk.paged_attention(to_torch(q), to_torch(kc), to_torch(vc),
                       to_torch(pt), to_torch(lens), n_head=h)
    assert kernels.launch_counts == before[0]
    assert kernels.plain_calls["paged_attention"] == \
        before[1]["paged_attention"] + 1


def test_wrapper_rejects_mismatched_scales():
    q, kc, vc, pt, lens, h, _, _ = _case(7, "float32")
    with pytest.raises(ValueError, match="scale"):
        tk.paged_attention(to_torch(q), to_torch(kc), to_torch(vc),
                           to_torch(pt), to_torch(lens), n_head=h,
                           k_scales=torch.ones(kc.shape[:2] + (1,)),
                           v_scales=torch.ones(kc.shape[:2] + (1,)))


def test_bound_counts_only_the_rows_the_lengths_need():
    q, kc, vc, pt, lens, h, _, _ = _case(8, "float32")
    nbytes, flops = tk.bound_bytes_and_flops(
        to_torch(q), to_torch(kc), to_torch(pt), to_torch(lens), h)
    rows = int(lens.sum())
    hd = q.shape[1]
    assert flops == 4 * rows * hd
    assert nbytes == (2 * q.size * 4 + 2 * rows * hd * 4
                      + pt.size * 4 + lens.size * 4)


# -- the kernel's blocking: splits of a slot's pages, merged in order ------

def _edge_case(kv_dtype, seed=9):
    """Lengths 0, exactly one page, exactly two pages (a split boundary
    for splits of 1 and 2 pages), one past a page, and the full capacity,
    over 3 pages a slot; rows past each length hold NaN (V, int8 scales)
    and 1e3 (K) inside the used pages."""
    q, kc, vc, pt, _, h, ks, vs = _case(seed, kv_dtype, s=5, p=15,
                                        poison=False)
    page, maxp = kc.shape[1], pt.shape[1]
    lens = np.array([0, page, 2 * page, page + 1, maxp * page], np.int32)
    perm = np.random.RandomState(seed).permutation(kc.shape[0])
    pt[:] = 0
    for i, n in enumerate(lens):
        used = -(-int(n) // page)
        pt[i, :used] = perm[i * maxp:i * maxp + used]
        for t in range(int(n), used * page):
            pg = pt[i, t // page]
            if kv_dtype == "int8":
                ks[pg, t % page] = np.nan
                vs[pg, t % page] = np.nan
            else:
                kc[pg, t % page] = 1e3
                vc[pg, t % page] = np.nan
    return q, kc, vc, pt, lens, h, ks, vs


def _refs(q, kc, vc, pt, lens, h, ks, vs, kv_dtype):
    jks = None if ks is None else jnp.asarray(ks)
    jvs = None if vs is None else jnp.asarray(vs)
    twin = np.asarray(_xla_paged_attention(
        jnp.asarray(q), _jax_pool(kc, kv_dtype), _jax_pool(vc, kv_dtype),
        jnp.asarray(pt), jnp.asarray(lens), h, (q.shape[1] // h) ** -0.5,
        ks=jks, vs=jvs))
    pallas = np.asarray(ragged_paged_attention(
        jnp.asarray(q), _jax_pool(kc, kv_dtype), _jax_pool(vc, kv_dtype),
        jnp.asarray(pt), jnp.asarray(lens), n_head=h, k_scales=jks,
        v_scales=jvs))
    return twin, pallas


def _split(q, kc, vc, pt, lens, h, ks, vs, kv_dtype, pps):
    return tk.paged_attention_split_plain(
        to_torch(q), _torch_pool(kc, kv_dtype), _torch_pool(vc, kv_dtype),
        to_torch(pt), to_torch(lens), h,
        k_scales=None if ks is None else to_torch(ks),
        v_scales=None if vs is None else to_torch(vs),
        pages_per_split=pps).numpy()


@pytest.mark.parametrize("kv_dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("pps", [1, 2, 3])
@pytest.mark.parametrize("edges", [False, True], ids=["ragged", "edges"])
def test_split_twin_matches_jax_twin_and_pallas(kv_dtype, pps, edges):
    """The kernel's blocking in plain torch (each run of `pps` pages of a
    slot gives its (m, l, acc), merged in split order) against the
    reference's dense-gather twin and its Pallas kernel: split sizes of 1
    page, 2 pages and all 3; ragged lengths, or lengths of 0, exactly on
    a page or split boundary, splits wholly past the length, NaN past
    it."""
    case = _edge_case(kv_dtype) if edges else _case(2, kv_dtype)
    twin, pallas = _refs(*case, kv_dtype)
    got = _split(*case, kv_dtype, pps)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, twin, **TOL)
    np.testing.assert_allclose(got, pallas, **TOL)
    if edges:                          # length 0: the output is zero
        assert not got[0].any()


def test_split_twin_ignores_poisoned_rows():
    """NaN / 1e3 past each length changes no bit of the split twin."""
    outs = [_split(*_case(3, "float32", poison=p), "float32", 2)
            for p in (False, True)]
    np.testing.assert_array_equal(outs[0], outs[1])


@pytest.mark.parametrize("maxp,page,sh,sms,want", [
    (32, 16, 128, 132, (7, 5)),       # the serving shape: 5 splits
    (256, 16, 128, 132, (52, 5)),     # the long-length decode shape
    (32, 16, 4096, 132, (32, 1)),     # many slots: one split a slot
    (3, 4, 8, 132, (3, 1)),           # at least 64 tokens a split
    (64, 1, 1, 132, (64, 1)),
    (8192, 16, 1, 132, (16, 512)),    # one slot and head fills the SMs
    (100000, 16, 4096, 132, (1024, 98)),  # at most MAX_SPLIT_PAGES
    (0, 16, 4, 132, (1, 1)),          # no pages: one empty split
])
def test_pages_per_split_from_shapes(maxp, page, sh, sms, want):
    pps = tk.pages_per_split(maxp, page, sh, sms)
    n_splits = max(1, -(-maxp // pps))
    assert (pps, n_splits) == want
    assert 1 <= pps <= max(maxp, 1) and n_splits * pps >= maxp


def _verify_case(seed, kv_dtype, k=2):
    """The folded verify shape at a small size: 3 slots of k+1 rows, each
    slot's rows on its page table at lengths c+1..c+k+1, the rows past
    a slot's draft length pinned to length c+1, the last slot inactive
    (every row of it length 0 on the zero page table, as the engine
    leaves it)."""
    q, kc, vc, pt, lens, h, ks, vs = _case(seed, kv_dtype, s=3, p=15,
                                           maxp=4, poison=False)
    k1 = k + 1
    rng = np.random.RandomState(seed)
    committed = rng.randint(1, 4 * 4 - k1, 3)
    draft_len = [k, 1, 0]
    rows_pt = np.zeros((3 * k1, pt.shape[1]), np.int32)
    rows_len = np.zeros(3 * k1, np.int32)
    perm = rng.permutation(kc.shape[0])
    for i in range(2):
        used = -(-int(committed[i] + k1) // 4)
        rows_pt[i * k1:(i + 1) * k1, :used] = perm[i * 4:i * 4 + used]
        off = np.arange(k1)
        rows_len[i * k1:(i + 1) * k1] = committed[i] + 1 + np.where(
            off <= draft_len[i], off, 0)
    q = rng.randn(3 * k1, q.shape[1]).astype(np.float32)
    return q, kc, vc, rows_pt, rows_len, h, ks, vs


@pytest.mark.parametrize("kv_dtype", ["float32", "bfloat16", "int8"])
def test_folded_verify_shape_matches_jax_twin_and_pallas(kv_dtype):
    case = _verify_case(4, kv_dtype)
    twin, pallas = _refs(*case, kv_dtype)
    q, kc, vc, pt, lens, h, ks, vs = case
    got = tk.paged_attention_plain(
        to_torch(q), _torch_pool(kc, kv_dtype), _torch_pool(vc, kv_dtype),
        to_torch(pt), to_torch(lens), h,
        k_scales=None if ks is None else to_torch(ks),
        v_scales=None if vs is None else to_torch(vs)).numpy()
    for pps in (1, 2, 4):
        np.testing.assert_allclose(_split(*case, kv_dtype, pps), twin,
                                   **TOL)
    np.testing.assert_allclose(got, twin, **TOL)
    np.testing.assert_allclose(got, pallas, **TOL)
    assert not got[-3:].any()          # the inactive slot's rows


def test_bound_reads_a_shared_page_table_once():
    """The verify shape's rows of one slot read the slot's K/V rows once
    between them (up to the longest row); every row does its flops."""
    q, kc, _, pt, lens, h, _, _ = _verify_case(4, "float32")
    nbytes, flops = tk.bound_bytes_and_flops(
        to_torch(q), to_torch(kc), to_torch(pt), to_torch(lens), h)
    hd = q.shape[1]
    read = sum(int(lens[i * 3:(i + 1) * 3].max()) for i in range(3))
    assert read < int(lens.sum())
    assert flops == 4 * int(lens.sum()) * hd
    assert nbytes == (2 * q.size * 4 + 2 * read * hd * 4
                      + pt.size * 4 + lens.size * 4)


def test_launch_plan_takes_the_plan_of_plan_rows():
    """`plan_rows` sizes the splits as for that many rows (the verify run
    takes the step run's plan); the workspace still holds every row."""
    h = 2
    t = [torch.empty(shape, device="meta")
         for shape in ((40, 32), (1700, 16, 32), (40, 40))]
    step = tk.launch_plan(t[0][:8], t[1], t[2][:8], h, 132)
    folded = tk.launch_plan(*t, h, 132, plan_rows=8)
    assert tk.launch_plan(*t, h, 132) != folded
    assert folded["pages_per_split"] == step["pages_per_split"]
    assert folded["n_splits"] == step["n_splits"] > 1
    assert folded["workspace_floats"] == 5 * step["workspace_floats"]


def test_launch_plan_reads_shapes_only():
    """The grid and the workspace come from shapes and the SM count: the
    plan of operands that hold no data (the meta device) is the plan of
    real ones, whatever their lengths, so a launch never reads the
    lengths back from the card."""
    q, kc, _, pt, _, h, _, _ = _case(4, "float32", maxp=40, p=170)
    real = tk.launch_plan(to_torch(q), to_torch(kc), to_torch(pt), h, 132)
    meta = tk.launch_plan(*(torch.empty(x.shape, device="meta")
                            for x in (q, kc, pt)), h, 132)
    assert real == meta
    assert real["n_splits"] > 1
    d = q.shape[1] // h
    assert real["workspace_floats"] == \
        q.shape[0] * h * real["n_splits"] * (2 + d)
    assert "lengths" not in inspect.signature(tk.launch_plan).parameters
