"""The ops of the training slice, PyTorch port vs the JAX package
(`op_test.run_op`), on the same numpy inputs: forward values and, for
the differentiable ones, the gradient of sum(out * cotangent) with
respect to each float input (torch autograd against jax.vjp of the
reference's op).

Tolerance 1e-5 (abs and rel) for values and 1e-4 for gradients: float32
on both sides, reductions and transcendentals in other orders or libms.
Exact equality for integer and one-hot outputs.  dropout draws from a
torch generator, not threefry: it is held to its keep rate and upscale.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from op_test import run_op
from paddle_tpu.core.registry import OpContext as JaxCtx
from paddle_tpu.core.registry import get_op_impl as jax_impl
from paddle_tpu_torch.core.registry import OpContext, get_op_impl
from torch_op_test import run_torch_op, to_torch

torch.set_num_threads(2)

TOL = dict(rtol=1e-5, atol=1e-5)
GTOL = dict(rtol=1e-4, atol=1e-4)
R = np.random.RandomState(0)


def _f(*shape):
    return R.randn(*shape).astype(np.float32)


def _labels(*shape, depth=7):
    return R.randint(0, depth, shape).astype(np.int32)


# name: (op, ins, attrs, out slot, slots to differentiate)
CASES = {
    "matmul": ("matmul", {"X": _f(2, 3, 4, 5), "Y": _f(2, 3, 5, 6)},
               {"alpha": 0.5}, "Out", ("X", "Y")),
    "matmul_transpose_y": ("matmul", {"X": _f(2, 3, 4, 5),
                                      "Y": _f(2, 3, 6, 5)},
                           {"transpose_Y": True, "alpha": 0.125}, "Out",
                           ("X", "Y")),
    "matmul_transpose_x": ("matmul", {"X": _f(3, 5, 4), "Y": _f(3, 5, 2)},
                           {"transpose_X": True}, "Out", ("X", "Y")),
    "reshape": ("reshape", {"X": _f(2, 3, 8)}, {"shape": [0, 0, 2, 4]},
                "Out", ("X",)),
    "reshape_infer": ("reshape", {"X": _f(2, 3, 8)}, {"shape": [-1, 4]},
                      "Out", ("X",)),
    "transpose": ("transpose", {"X": _f(2, 3, 4, 5)},
                  {"axis": [0, 2, 1, 3]}, "Out", ("X",)),
    "reduce_sum_all": ("reduce_sum", {"X": _f(3, 4)},
                       {"reduce_all": True, "dim": [0], "keep_dim": False},
                       "Out", ("X",)),
    "reduce_sum_dim": ("reduce_sum", {"X": _f(3, 4, 5)},
                       {"reduce_all": False, "dim": [1, -1],
                        "keep_dim": True}, "Out", ("X",)),
    "softmax": ("softmax", {"X": _f(3, 4, 9)}, {"axis": -1}, "Out",
                ("X",)),
    "softmax_axis1": ("softmax", {"X": _f(3, 4, 9)}, {"axis": 1}, "Out",
                      ("X",)),
    "sce_soft": ("softmax_with_cross_entropy",
                 {"Logits": _f(2, 3, 7),
                  "Label": np.abs(_f(2, 3, 7)) / 7.0},
                 {"soft_label": True}, "Loss", ("Logits", "Label")),
    "sce_hard": ("softmax_with_cross_entropy",
                 {"Logits": _f(2, 3, 7), "Label": _labels(2, 3, 1)},
                 {"soft_label": False, "ignore_index": 3}, "Loss",
                 ("Logits",)),
    "sce_hard_smoothed": ("softmax_with_cross_entropy",
                          {"Logits": _f(4, 7), "Label": _labels(4)},
                          {"soft_label": False, "label_smooth_eps": 0.1},
                          "Loss", ("Logits",)),
    "sce_softmax_out": ("softmax_with_cross_entropy",
                        {"Logits": _f(4, 7), "Label": _labels(4, 1)},
                        {}, "Softmax", ("Logits",)),
    "label_smooth": ("label_smooth", {"X": _f(3, 6)}, {"epsilon": 0.1},
                     "Out", ("X",)),
    "label_smooth_prior": ("label_smooth",
                           {"X": _f(3, 6), "PriorDist": np.abs(_f(1, 6))},
                           {"epsilon": 0.2}, "Out", ("X", "PriorDist")),
    "elementwise_mul": ("elementwise_mul", {"X": _f(2, 3), "Y": _f(2, 3)},
                        {"axis": -1}, "Out", ("X", "Y")),
    "elementwise_div": ("elementwise_div",
                        {"X": _f(2, 3), "Y": np.abs(_f(1)) + 1.0},
                        {"axis": -1}, "Out", ("X", "Y")),
    "elementwise_max": ("elementwise_max", {"X": _f(2, 3), "Y": _f(2, 3)},
                        {"axis": -1}, "Out", ("X", "Y")),
    "sum": ("sum", {"X": [_f(2, 3), _f(2, 3), _f(2, 3)]}, {}, "Out", ()),
    "sqrt": ("sqrt", {"X": np.abs(_f(3, 4)) + 0.1}, {}, "Out", ("X",)),
    "sign": ("sign", {"X": _f(3, 4)}, {}, "Out", ()),
    "clip": ("clip", {"X": _f(3, 4)}, {"min": -0.5, "max": 0.7}, "Out",
             ("X",)),
    "clip_by_norm": ("clip_by_norm", {"X": _f(3, 4)}, {"max_norm": 1.0},
                     "Out", ("X",)),
    "clip_by_norm_inactive": ("clip_by_norm", {"X": _f(3, 4) * 0.01},
                              {"max_norm": 10.0}, "Out", ("X",)),
    "increment": ("increment", {"X": np.array([3.0], np.float32)},
                  {"step": 1.0}, "Out", ()),
    "one_hot": ("one_hot", {"X": _labels(3, 4, 1)}, {"depth": 7}, "Out",
                ()),
    "one_hot_2d": ("one_hot", {"X": _labels(3, 4)}, {"depth": 7}, "Out",
                   ()),
    "sgd": ("sgd", {"Param": _f(3, 4), "Grad": _f(3, 4),
                    "LearningRate": np.array([0.1], np.float32)}, {},
            "ParamOut", ()),
}
_ADAM = {"Param": _f(3, 4), "Grad": _f(3, 4), "Moment1": _f(3, 4) * 0.1,
         "Moment2": np.abs(_f(3, 4)) * 0.1,
         "Beta1Pow": np.array([0.9 ** 3], np.float32),
         "Beta2Pow": np.array([0.997 ** 3], np.float32),
         "LearningRate": np.array([0.01], np.float32)}
_ADAM_ATTRS = {"beta1": 0.9, "beta2": 0.997, "epsilon": 1e-9}
for _slot in ("ParamOut", "Moment1Out", "Moment2Out", "Beta1PowOut",
              "Beta2PowOut"):
    CASES[f"adam_{_slot}"] = ("adam", _ADAM, _ADAM_ATTRS, _slot, ())


@pytest.mark.parametrize("name", sorted(CASES))
def test_op_matches_reference(name):
    op, ins, attrs, slot, _ = CASES[name]
    want = run_op(op, ins, attrs, out_slot=slot)
    got = run_torch_op(op, ins, attrs, out_slot=slot)
    assert got.shape == want.shape and got.dtype == want.dtype, \
        (got.shape, want.shape, got.dtype, want.dtype)
    if got.dtype.kind in "iub" or op == "one_hot":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, **TOL)


_GRAD_CASES = sorted((n, s) for n, c in CASES.items() for s in c[4])


@pytest.mark.parametrize("name,slot", _GRAD_CASES)
def test_op_gradient_matches_reference(name, slot):
    """d sum(out * cot) / d ins[slot]: torch autograd against jax.vjp."""
    op, ins, attrs, out_slot, _ = CASES[name]
    want_out = run_op(op, ins, attrs, out_slot=out_slot)
    cot = np.random.RandomState(1).randn(*want_out.shape) \
        .astype(np.float32)

    def jfn(x):
        jins = {s: [jnp.asarray(a)] for s, a in ins.items()}
        jins[slot] = [x]
        return jax_impl(op)(JaxCtx(jax.random.PRNGKey(0), 0), jins,
                            dict(attrs))[out_slot][0]

    _, vjp = jax.vjp(jfn, jnp.asarray(ins[slot]))
    want = np.asarray(vjp(jnp.asarray(cot))[0])
    tins = {s: [to_torch(a)] for s, a in ins.items()}
    x = tins[slot][0].requires_grad_()
    o = get_op_impl(op)(OpContext((0, 0), 0, device="cpu"), tins,
                        dict(attrs))[out_slot][0]
    got, = torch.autograd.grad(o, x, to_torch(cot))
    np.testing.assert_allclose(got.numpy(), want, **GTOL)


@pytest.mark.parametrize("impl", ["upscale_in_train",
                                  "downgrade_in_infer"])
def test_dropout_keep_rate_and_scaling(impl):
    x = np.ones((200, 100), np.float32) * 2.0
    attrs = {"dropout_prob": 0.3, "dropout_implementation": impl}
    tins = {"X": [to_torch(x)]}
    outs = get_op_impl("dropout")(OpContext((0, 0), 5, device="cpu"),
                                  tins, dict(attrs))
    y, mask = outs["Out"][0].numpy(), outs["Mask"][0].numpy()
    kept = mask.astype(bool)
    assert abs(kept.mean() - 0.7) < 0.01
    scale = 1 / 0.7 if impl == "upscale_in_train" else 1.0
    np.testing.assert_allclose(y[kept], 2.0 * scale, rtol=1e-6)
    assert (y[~kept] == 0).all()
    # test mode: the reference's scaling, no mask
    want = run_op("dropout", {"X": x}, dict(attrs, is_test=True))
    got = run_torch_op("dropout", {"X": x}, dict(attrs, is_test=True))
    np.testing.assert_allclose(got, want, **TOL)
    # the same op index draws the same mask; another index another one
    again = get_op_impl("dropout")(OpContext((0, 0), 5, device="cpu"),
                                   tins, dict(attrs))["Mask"][0].numpy()
    other = get_op_impl("dropout")(OpContext((0, 0), 6, device="cpu"),
                                   tins, dict(attrs))["Mask"][0].numpy()
    assert (again == mask).all() and (other != mask).any()


@pytest.mark.parametrize("kind,params", [
    ("noam", {"d_model": 64, "warmup_steps": 10}),
    ("exponential", {"learning_rate": 0.5, "decay_steps": 3,
                     "decay_rate": 0.9, "staircase": True}),
    ("natural_exp", {"learning_rate": 0.5, "decay_steps": 3,
                     "decay_rate": 0.9, "staircase": False}),
    ("inverse_time", {"learning_rate": 0.5, "decay_steps": 3,
                      "decay_rate": 0.9, "staircase": False}),
    ("polynomial", {"learning_rate": 0.5, "decay_steps": 4,
                    "end_learning_rate": 0.01, "power": 2.0,
                    "cycle": True}),
    ("piecewise", {"boundaries": [2.0, 5.0], "values": [1.0, 0.5, 0.1]}),
    ("cosine", {"learning_rate": 0.5, "step_each_epoch": 2,
                "epochs": 10}),
    ("linear_warmup", {"warmup_steps": 4, "start_lr": 0.0, "end_lr": 0.1,
                       "base_lr": 0.3}),
])
@pytest.mark.parametrize("step", [1.0, 3.0, 7.0])
def test_lr_schedule_matches_reference(kind, params, step):
    import paddle_tpu.layers.learning_rate_scheduler  # noqa: F401

    ins = {"Step": np.array([step], np.float32)}
    attrs = dict(params, kind=kind)
    want = run_op("lr_schedule", ins, attrs)
    got = run_torch_op("lr_schedule", ins, attrs)
    assert got.shape == want.shape == (1,)
    np.testing.assert_allclose(got, want, **TOL)
