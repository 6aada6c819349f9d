"""Every other op of the ported serving slice, PyTorch port vs the JAX
package (`op_test.run_op`), on the same numpy inputs.

Exact equality where both sides do the same float32 arithmetic on the
same values (gathers, scatters, int8 codes, comparisons); 1e-5 (abs and
rel) for reductions and transcendentals, whose order or libm differs.
Random ops draw from different generators by design (threefry vs
Philox), so they are held to shape, dtype, range and moments only.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from op_test import run_op
from torch_op_test import round_bf16, run_torch_op

torch.set_num_threads(2)

TOL = dict(rtol=1e-5, atol=1e-5)
R = np.random.RandomState(0)


def _both(op, ins, attrs=None, out_slot="Out", dtypes=None, jax_ins=None):
    want = run_op(op, jax_ins or ins, attrs, out_slot=out_slot)
    got = run_torch_op(op, ins, attrs, out_slot=out_slot, dtypes=dtypes)
    return np.asarray(got), np.asarray(want)


CASES = {
    "lookup_table": ({"W": R.randn(10, 6).astype(np.float32),
                      "Ids": R.randint(0, 10, (3, 4)).astype(np.int32)},
                     {"padding_idx": -1}),
    "lookup_table_padding": ({"W": R.randn(10, 6).astype(np.float32),
                              "Ids": np.array([[1], [0], [3]], np.int32)},
                             {"padding_idx": 0}),
    "scale": ({"X": R.randn(3, 5).astype(np.float32)},
              {"scale": 1e9, "bias": -1e9}),
    "layer_norm": ({"X": R.randn(2, 3, 8).astype(np.float32),
                    "Scale": R.randn(8).astype(np.float32),
                    "Bias": R.randn(8).astype(np.float32)},
                   {"begin_norm_axis": 2}),
    "mul": ({"X": R.randn(2, 3, 8).astype(np.float32),
             "Y": R.randn(8, 5).astype(np.float32)},
            {"x_num_col_dims": 2, "y_num_col_dims": 1}),
    "elementwise_add": ({"X": R.randn(2, 3, 5).astype(np.float32),
                         "Y": R.randn(5).astype(np.float32)},
                        {"axis": 2}),
    "elementwise_add_same": ({"X": R.randn(4, 5).astype(np.float32),
                              "Y": R.randn(4, 5).astype(np.float32)},
                             {"axis": -1}),
    "relu": ({"X": R.randn(4, 6).astype(np.float32)}, {}),
    "arg_max": ({"X": R.randn(4, 9).astype(np.float32)}, {"axis": 1}),
    "unsqueeze": ({"X": R.randn(3, 5).astype(np.float32)},
                  {"axes": [1]}),
    "squeeze": ({"X": R.randn(3, 1, 5).astype(np.float32)},
                {"axes": [1]}),
    "batched_gather": ({"X": R.randn(3, 6, 4).astype(np.float32),
                        "Index": np.array([[5], [0], [2]], np.int32)},
                       {}),
    "fill_constant": ({}, {"shape": [2, 3], "dtype": "int32",
                           "value": 7.0}),
    "add_position_encoding": ({"X": R.randn(2, 7, 8).astype(np.float32)},
                              {"alpha": 1.0, "beta": 1.0}),
    "add_position_encoding_at": ({"X": R.randn(4, 8).astype(np.float32),
                                  "Position": np.array([0, 3, 17, 200],
                                                       np.int32)},
                                 {"alpha": 1.0, "beta": 1.0}),
}
_SLOT = {"sequence_mask": "Y", "layer_norm": "Y"}


@pytest.mark.parametrize("name", sorted(CASES))
def test_op_matches_reference(name):
    ins, attrs = CASES[name]
    op = name.replace("_padding", "").replace("_same", "")
    got, want = _both(op, ins, attrs, out_slot=_SLOT.get(op, "Out"))
    assert got.shape == want.shape
    if got.dtype.kind in "iub":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("slot", ["Mean", "Variance"])
def test_layer_norm_statistics(slot):
    ins, attrs = CASES["layer_norm"]
    got, want = _both("layer_norm", ins, attrs, out_slot=slot)
    np.testing.assert_allclose(got, want, **TOL)


def test_sequence_mask():
    ins = {"X": np.array([0, 3, 8], np.int32)}
    attrs = {"maxlen": 8, "out_dtype": "float32"}
    got, want = _both("sequence_mask", ins, attrs, out_slot="Y")
    np.testing.assert_array_equal(got, want)


# -- paged KV writes -----------------------------------------------------

def _pool_case(kv_dtype, s=4, hd=8, p=6, page=4, maxp=2):
    rng = np.random.RandomState(1)
    if kv_dtype == "int8":
        kc = rng.randint(-127, 128, (p, page, hd)).astype(np.int8)
    else:
        kc = rng.randn(p, page, hd).astype(np.float32)
    vc = kc.copy()
    pt = np.array([[1, 2], [3, 0], [4, 5], [0, 0]], np.int32)[:s]
    k = rng.randn(s, hd).astype(np.float32)
    v = rng.randn(s, hd).astype(np.float32)
    k[1] = 0.0                                # a zero row (scale 1)
    ins = {"K": k, "V": v, "KCache": kc, "VCache": vc, "PageTable": pt}
    if kv_dtype == "int8":
        sc = rng.uniform(0.5, 2.0, (p, page, 1)).astype(np.float32)
        ins.update(KScale=sc, VScale=sc.copy())
    return ins


def _bf16(ins, kv_dtype):
    """(port ins, jax ins, port dtypes) for a pool dtype."""
    if kv_dtype != "bfloat16":
        return ins, ins, None
    import jax.numpy as jnp

    ins = dict(ins, KCache=round_bf16(ins["KCache"]),
               VCache=round_bf16(ins["VCache"]))
    jins = dict(ins, KCache=jnp.asarray(ins["KCache"], jnp.bfloat16),
                VCache=jnp.asarray(ins["VCache"], jnp.bfloat16))
    return ins, jins, {"KCache": torch.bfloat16, "VCache": torch.bfloat16}


_OUTS = {"float32": ["KCacheOut", "VCacheOut"],
         "bfloat16": ["KCacheOut", "VCacheOut"],
         "int8": ["KCacheOut", "VCacheOut", "KScaleOut", "VScaleOut"]}


@pytest.mark.parametrize("kv_dtype", ["float32", "bfloat16", "int8"])
def test_paged_kv_write(kv_dtype):
    """One decode write: slot 2 inactive (dropped), slot 3 writes past
    its page table (dropped), slot 1 crosses into its second page."""
    ins = _pool_case(kv_dtype)
    ins.update(WritePos=np.array([2, 5, 1, 9], np.int32),
               Active=np.array([1, 1, 0, 1], np.int32))
    tins, jins, dts = _bf16(ins, kv_dtype)
    for slot in _OUTS[kv_dtype]:
        got, want = _both("paged_kv_write", tins, out_slot=slot,
                          dtypes=dts, jax_ins=jins)
        np.testing.assert_array_equal(got, np.asarray(want, got.dtype))


@pytest.mark.parametrize("kv_dtype", ["float32", "bfloat16", "int8"])
def test_paged_kv_prefill_write(kv_dtype):
    """A prompt write: seq_len 0 (non-joiner) writes nothing, seq_len
    past the table drops the overflow, padding past seq_len drops."""
    ins = _pool_case(kv_dtype)
    t = 10
    rng = np.random.RandomState(2)
    ins["K"] = rng.randn(4, t, 8).astype(np.float32)
    ins["V"] = rng.randn(4, t, 8).astype(np.float32)
    ins["SeqLen"] = np.array([5, 0, 10, 3], np.int32)
    tins, jins, dts = _bf16(ins, kv_dtype)
    for slot in _OUTS[kv_dtype]:
        got, want = _both("paged_kv_prefill_write", tins, out_slot=slot,
                          dtypes=dts, jax_ins=jins)
        np.testing.assert_array_equal(got, np.asarray(want, got.dtype))


def test_paged_kv_write_updates_the_pool_in_place():
    """The port's writes mutate the pool and return the same tensor
    (what the reference got from buffer donation)."""
    from paddle_tpu_torch.core.registry import OpContext, get_op_impl

    ins = _pool_case("float32")
    tins = {s: [torch.as_tensor(np.array(a))] for s, a in ins.items()}
    tins["WritePos"] = [torch.tensor([0, 1, 2, 3], dtype=torch.int32)]
    outs = get_op_impl("paged_kv_write")(OpContext((0, 0), 0, device="cpu"),
                                          tins, {})
    assert outs["KCacheOut"][0] is tins["KCache"][0]
    np.testing.assert_array_equal(tins["KCache"][0][1, 0].numpy(),
                                  ins["K"][0])


# -- random ops (different generators by design) -------------------------

@pytest.mark.parametrize("op,attrs", [
    ("gaussian_random", {"shape": [4000], "mean": 1.0, "std": 2.0,
                         "dtype": "float32"}),
    ("uniform_random", {"shape": [4000], "min": -3.0, "max": 5.0,
                        "dtype": "float32"}),
])
def test_random_ops_shape_and_moments(op, attrs):
    got = run_torch_op(op, {}, attrs)
    want = run_op(op, {}, attrs)
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_allclose(got.mean(), want.mean(), atol=0.2)
    np.testing.assert_allclose(got.std(), want.std(), rtol=0.1)
    if op == "uniform_random":
        assert got.min() >= -3.0 and got.max() < 5.0
    again = run_torch_op(op, {}, attrs)
    np.testing.assert_array_equal(got, again)   # seeded per op index
