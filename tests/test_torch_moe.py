"""The switch-MoE slice on the CPU: paddle_tpu_torch's moe_ffn,
layers.switch_moe and the MoE Transformer against the JAX package.

- The reference's tests/test_moe.py cases 1-5 on the port: top-1
  routing against a manual plan, capacity overflow dropping tokens in
  token order, top-2 routing as (p1 y1 + p2 y2) / (p1 + p2), a dropped
  second choice never amplifying the kept one, and the switch_moe layer
  training (its program's `to_dict()` the reference's, its losses the
  reference's from the same startup values, within 1e-5).
- moe_ffn forward (Out, AuxLoss, Fraction) and the gradients of X,
  GateW, W1, B1, W2 and B2 against the reference at top-1 and top-2, at
  capacity factors that drop tokens and that keep all, with gate logits
  forced into exact ties (ties go to the lower expert in both): Out
  within 1e-6 of max |Out| (float32, the expert products summed in
  another order than XLA's), Fraction exactly, gradients within 1e-5 of
  each gradient's max.
- The index route is the reference's einsum form: the expert input
  buffer built by `index_copy` equals, bit for bit, the one-hot (B, E,
  C) dispatch product, and the whole output equals the einsum form
  computed with the same expert products, bit for bit at top-1 and at
  top-2 within one float32 ulp of the sum of the two choices' |terms|
  (the two products added in another order; where they cancel, that
  is more than an ulp of the result).
- moe_ffn on a mesh with an `ep` axis raises naming ROADMAP A step 10b.
- A tiny MoE Transformer (2+2 layers, d_model 64, 4 experts, T = 16,
  batch 4, dropout 0): both programs' `to_dict()` equal; the expert
  weights (E, D, H) / (E, H, D) and their (E, H) / (E, D) biases carry
  across by name (`convert.params_from_arrays`); three Adam steps give
  the reference's losses (1e-5), step-1 gradients (1e-4 of each max)
  and parameters (within 4 * sum(lr)); under bf16 AMP the tolerances of
  tests/torch_amp_parity.py (step 1 within a quarter of the reference's
  own AMP-vs-float32 distance, later losses 2e-3, parameters
  4 * sum(lr)), moe_ffn receiving float32 in both (it is in neither AMP
  list).
"""

from __future__ import annotations

import json
import math
import types

import numpy as np
import pytest
import torch

import paddle_tpu as jf
import paddle_tpu_torch as tf
from paddle_tpu.models import transformer as jt
from paddle_tpu_torch.convert import params_from_arrays
from paddle_tpu_torch.core.registry import OpContext, get_op_impl
from paddle_tpu_torch.models import transformer as tt
from paddle_tpu_torch.ops.moe import route

from torch_amp_parity import (build, check_amp_parity, check_state,
                              program_json, three_runs)
from torch_op_test import (ref_op_grads, run_ref_op_all, run_torch_op_all,
                           torch_op_grads)
from torch_twin import twins

torch.set_num_threads(2)

SLOTS = ["X", "GateW", "W1", "B1", "W2", "B2"]


def _moe_ins(seed, b=24, d=8, e=4, h=16, tie=False):
    r = np.random.RandomState(seed)
    gate = r.randn(d, e).astype(np.float32)
    if tie:                 # experts 1 and 2 (and 0 and 3) tie exactly
        gate[:, 2] = gate[:, 1]
        gate[:, 3] = gate[:, 0]
    return {"X": r.randn(b, d).astype(np.float32), "GateW": gate,
            "W1": (r.randn(e, d, h) * 0.3).astype(np.float32),
            "B1": (r.randn(e, h) * 0.1).astype(np.float32),
            "W2": (r.randn(e, h, d) * 0.3).astype(np.float32),
            "B2": (r.randn(e, d) * 0.1).astype(np.float32)}


def _run(ins, **attrs):
    o = run_torch_op_all("moe_ffn", ins, attrs)
    return o["Out"], float(o["AuxLoss"][0]), o["Fraction"]


def _expert_ffn(x, w1, b1, w2, b2):
    return np.maximum(x @ w1 + b1, 0.0) @ w2 + b2


def _probs(logits):
    p = np.exp(logits - logits.max(1, keepdims=True))
    return p / p.sum(1, keepdims=True)


# -- the reference's tests/test_moe.py cases 1-5 on the port ---------------

def test_top1_routing_matches_manual():
    ins = _moe_ins(0, b=5, d=4, e=3, h=8)
    x, g = ins["X"], ins["GateW"]
    got, aux, frac = _run(ins, top_k=1, capacity_factor=6.0)
    logits = x @ g
    probs = _probs(logits)
    want = np.zeros_like(x)
    for i in range(5):
        ex = int(np.argmax(logits[i]))
        want[i] = probs[i, ex] * _expert_ffn(
            x[i], *(ins[s][ex] for s in SLOTS[2:]))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(frac.sum(), 1.0, rtol=1e-6)
    assert aux >= 1.0 - 1e-5


def test_capacity_overflow_drops_tokens():
    b, d, e, h = 3, 4, 2, 4
    x = np.tile(np.asarray([[1.0, 0.5, -0.3, 0.2]], np.float32), (b, 1))
    gate = np.zeros((d, e), np.float32)
    gate[0, 0] = 5.0                           # every token -> expert 0
    r = np.random.RandomState(1)
    ins = {"X": x, "GateW": gate,
           "W1": (r.randn(e, d, h) * 0.3).astype(np.float32),
           "B1": np.zeros((e, h), np.float32),
           "W2": (r.randn(e, h, d) * 0.3).astype(np.float32),
           "B2": np.zeros((e, d), np.float32)}
    got, _, frac = _run(ins, top_k=1, capacity_factor=0.5)   # C = 1
    assert np.abs(got[0]).sum() > 0
    np.testing.assert_allclose(got[1:], 0.0, atol=1e-6)
    np.testing.assert_allclose(frac, [1.0, 0.0], atol=1e-6)


def test_top2_routes_to_two_experts():
    ins = _moe_ins(2, b=4, d=4, e=3, h=6)
    ins["B1"][:] = 0
    ins["B2"][:] = 0
    x = ins["X"]
    got, _, _ = _run(ins, top_k=2, capacity_factor=6.0)
    logits = x @ ins["GateW"]
    probs = _probs(logits)
    want = np.zeros_like(x)
    for i in range(4):
        e1, e2 = np.argsort(-logits[i])[:2]
        y1, y2 = (_expert_ffn(x[i], *(ins[s][k] for s in SLOTS[2:]))
                  for k in (e1, e2))
        p1, p2 = probs[i, e1], probs[i, e2]
        want[i] = (p1 * y1 + p2 * y2) / (p1 + p2)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_top2_dropped_choice_never_amplifies():
    d = e = 3
    x = np.asarray([[3, 2, 1], [3, 1, 2]], np.float32)
    r = np.random.RandomState(6)
    ins = {"X": x, "GateW": np.eye(d, dtype=np.float32),
           "W1": (r.randn(e, d, 4) * 0.3).astype(np.float32),
           "B1": np.zeros((e, 4), np.float32),
           "W2": (r.randn(e, 4, d) * 0.3).astype(np.float32),
           "B2": np.zeros((e, d), np.float32)}
    # C = ceil(2 * 2 / 3 * 0.7) = 1: token 1's first choice (expert 0) is
    # taken by token 0; its second (expert 2) is kept
    got, _, _ = _run(ins, top_k=2, capacity_factor=0.7)
    probs = _probs(x)

    def y(i, k):
        return _expert_ffn(x[i], *(ins[s][k] for s in SLOTS[2:]))

    p0, p1 = probs[0, 0], probs[0, 1]
    np.testing.assert_allclose(got[0], (p0 * y(0, 0) + p1 * y(0, 1))
                               / (p0 + p1), rtol=1e-4, atol=1e-5)
    q0, q2 = probs[1, 0], probs[1, 2]
    np.testing.assert_allclose(got[1], q2 / (q0 + q2) * y(1, 2),
                               rtol=1e-4, atol=1e-5)


def _switch_net(fluid, top_k=1):
    layers = fluid.layers
    x = layers.data("x", shape=[16])
    y = layers.data("y", shape=[1], dtype="int64")
    h, aux, frac = layers.switch_moe(x, num_experts=4, d_inner=32,
                                     top_k=top_k)
    logits = layers.fc(h, size=4)
    ce = layers.mean(layers.softmax_with_cross_entropy(logits, y))
    loss = layers.elementwise_add(
        ce, layers.scale(layers.reduce_sum(aux), scale=0.01))
    fluid.optimizer.Adam(learning_rate=0.01).minimize(loss)
    return loss, aux, frac


@pytest.mark.parametrize("top_k", [1, 2])
def test_switch_moe_layer_trains_and_balances(top_k):
    """The layer in a program, 25 Adam steps from the reference's
    startup values: to_dict equal, losses the reference's (1e-5) and
    falling, the aux loss finite, the fractions summing to 1."""
    runs = twins(lambda fluid: _switch_net(fluid, top_k), seed=5)
    (jm, _, _, _), (tm, _, _, _) = runs["ref"], runs["port"]
    assert json.dumps(tm.to_dict(), sort_keys=True) == \
        json.dumps(jm.to_dict(), sort_keys=True)
    rng = np.random.RandomState(3)
    xv = rng.randn(64, 16).astype(np.float32)
    feed = {"x": xv, "y": np.abs(xv[:, :4]).argmax(1)[:, None]
            .astype(np.int64)}
    losses = {}
    for side, (main, scope, exe, (loss, aux, frac)) in runs.items():
        losses[side] = []
        for _ in range(25):
            lv, av, fv = exe.run(main, feed=feed, fetch_list=[loss, aux,
                                                              frac],
                                 scope=scope)
            losses[side].append(float(np.asarray(lv).reshape(-1)[0]))
            assert np.isfinite(np.asarray(av)).all()
        np.testing.assert_allclose(np.asarray(fv).sum(), 1.0, rtol=1e-5)
    np.testing.assert_allclose(losses["port"], losses["ref"], rtol=1e-5,
                               atol=1e-5)
    assert losses["port"][-1] < losses["port"][0]


# -- moe_ffn against the reference ------------------------------------------

CASES = {
    "top1 all kept": (dict(top_k=1, capacity_factor=4.0), False),
    "top1 drops": (dict(top_k=1, capacity_factor=0.5), False),
    "top1 ties": (dict(top_k=1, capacity_factor=1.25), True),
    "top2 all kept": (dict(top_k=2, capacity_factor=4.0), False),
    "top2 drops": (dict(top_k=2, capacity_factor=0.6), False),
    "top2 ties drops": (dict(top_k=2, capacity_factor=0.8), True),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_moe_ffn_matches_the_reference(case):
    attrs, tie = CASES[case]
    ins = _moe_ins(11, b=40, tie=tie)
    got = run_torch_op_all("moe_ffn", ins, attrs)
    want = run_ref_op_all("moe_ffn", ins, attrs)
    assert set(got) == set(want) == {"Out", "AuxLoss", "Fraction"}
    np.testing.assert_array_equal(got["Fraction"], want["Fraction"])
    np.testing.assert_allclose(got["AuxLoss"], want["AuxLoss"], rtol=1e-6)
    top = np.abs(want["Out"]).max()
    np.testing.assert_allclose(got["Out"], want["Out"], rtol=0,
                               atol=1e-6 * top)
    if attrs["capacity_factor"] < 1:      # some token really dropped
        assert (np.abs(want["Out"]).max(1) == 0).any()
    g = torch_op_grads("moe_ffn", ins, attrs, SLOTS, ["Out", "AuxLoss"])
    w = ref_op_grads("moe_ffn", ins, attrs, SLOTS, ["Out", "AuxLoss"])
    for s in SLOTS:
        assert np.abs(w[s]).max() > 0, s
        np.testing.assert_allclose(g[s], w[s], rtol=0,
                                   atol=1e-5 * np.abs(w[s]).max(),
                                   err_msg=f"d/d{s} ({case})")


def _einsum_form(t, top_k, cap_factor):
    """The reference's dense formulation in torch: (B, E, C) one-hot
    dispatch and combine tensors and their products, the experts by the
    same torch.bmm as the port's."""
    x, gate_w = t["X"], t["GateW"]
    b, e = x.shape[0], gate_w.shape[1]
    cap = max(1, int(math.ceil(b * top_k / e * cap_factor)))
    logits = (x @ gate_w).float()
    probs = torch.softmax(logits, -1)
    dispatch = torch.zeros((b, e, cap))
    combine = torch.zeros((b, e, cap))
    used = torch.zeros((b, e), dtype=torch.bool)
    for idx, pos, fits in route(logits, top_k, cap):
        onehot = torch.nn.functional.one_hot(idx, e).float()
        plan = (onehot[:, :, None] * torch.nn.functional.one_hot(
            torch.where(fits, pos, 0), cap).float()[:, None, :]
            * fits.float()[:, None, None])
        dispatch = dispatch + plan
        combine = combine + plan * probs.gather(1, idx[:, None])[:, :, None]
        used = used | onehot.bool()
    if top_k == 2:
        chosen = (probs * used).sum(-1)[:, None, None]
        combine = combine / torch.clamp(chosen, min=1e-9)
    expert_in = torch.einsum("bec,bd->ecd", dispatch, x)
    h = torch.relu(torch.bmm(expert_in, t["W1"]) + t["B1"][:, None, :])
    y_e = torch.bmm(h, t["W2"]) + t["B2"][:, None, :]
    return (expert_in, torch.einsum("bec,ecd->bd", combine, y_e),
            torch.einsum("bec,ecd->bd", combine.abs(), y_e.abs()))


@pytest.mark.parametrize("top_k,cf", [(1, 0.5), (1, 2.0), (2, 0.6),
                                      (2, 2.0)])
def test_index_route_is_the_einsum_form(top_k, cf, monkeypatch):
    ins = _moe_ins(5, b=33)
    t = {k: torch.as_tensor(v) for k, v in ins.items()}
    seen = {}
    real_bmm = torch.bmm

    def spy(a, b):                       # the port's expert input buffer
        seen.setdefault("in", a)
        return real_bmm(a, b)

    monkeypatch.setattr(torch, "bmm", spy)
    got = get_op_impl("moe_ffn")(OpContext((0, 0), 0, device="cpu"),
                                 {k: [v] for k, v in t.items()},
                                 {"top_k": top_k, "capacity_factor": cf})
    monkeypatch.setattr(torch, "bmm", real_bmm)
    expert_in, want, terms = _einsum_form(t, top_k, cf)
    assert torch.equal(seen["in"], expert_in)
    if top_k == 1:
        assert torch.equal(got["Out"][0], want)
    else:
        ulp = torch.finfo(torch.float32).eps * terms
        assert ((got["Out"][0] - want).abs() <= ulp).all()


def test_ep_mesh_raises_naming_step_10():
    ins = {k: [torch.as_tensor(v)] for k, v in _moe_ins(1).items()}
    ctx = OpContext((0, 0), 0, device="cpu")
    ctx.mesh = types.SimpleNamespace(shape={"dp": 2, "ep": 4})
    with pytest.raises(NotImplementedError, match="A step 10"):
        get_op_impl("moe_ffn")(ctx, ins, {"top_k": 1})
    ctx.mesh = types.SimpleNamespace(shape={"dp": 8})   # no ep: one group
    out = get_op_impl("moe_ffn")(ctx, ins, {"top_k": 1})
    assert out["Out"][0].shape == (24, 8)


# -- the MoE Transformer ----------------------------------------------------

ARCH = dict(src_vocab_size=100, trg_vocab_size=100, max_length=16,
            n_layer=2, n_head=2, d_model=64, d_inner_hid=128, dropout=0.0,
            use_flash=True, warmup_steps=100, moe_experts=4)


def _batch():
    feed = tt.make_fake_batch(4, 16, 100, 100, seed=1)
    feed["src_len"] = np.array([16, 9, 1, 5], np.int32)
    feed["trg_len"] = np.array([3, 16, 12, 1], np.int32)
    return feed


def _noam(step, d_model=64, warmup=100, scale=2.0):
    return scale * d_model ** -0.5 * min(step ** -0.5,
                                         step * warmup ** -1.5)


def _build(fluid, mod, **kw):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        out = mod.build_model(**dict(ARCH, **kw))
    return main, startup, out


def test_moe_transformer_trains_like_the_reference():
    jm, js, jmod = _build(jf, jt)
    tm, ts, tmod = _build(tf, tt)
    assert program_json(tm) == program_json(jm)
    assert program_json(ts) == program_json(js)
    types_ = [op.type for op in tm.global_block().ops]
    assert types_.count("moe_ffn") == 4 and "mul" in types_
    assert types_.count("flash_attention") == 4
    jscope = jf.Scope()
    jf.Executor(jf.CPUPlace()).run(js, scope=jscope)
    arrays = {n: np.asarray(v) for n, v in jscope.vars.items()
              if v is not None}
    ported = params_from_arrays(arrays, "cpu", program=tm)
    experts = {p.name: tuple(ported[p.name].shape)
               for p in tm.all_parameters()
               if p.name.startswith("moe_expert")}
    assert sorted(set(experts.values())) == [(4, 64), (4, 64, 128),
                                             (4, 128), (4, 128, 64)]
    tscope = tf.Scope()
    for n, t in ported.items():
        tscope.set_var(n, t)
    texe, jexe = tf.Executor(tf.CPUPlace()), jf.Executor(jf.CPUPlace())
    params = [p.name for p in jm.all_parameters()]
    fetch = [jmod["loss"].name] + [f"{p}@GRAD" for p in params]
    feed = _batch()
    for step in range(3):
        jo = jexe.run(jm, feed=feed, fetch_list=fetch, scope=jscope)
        to = texe.run(tm, feed=feed, fetch_list=fetch, scope=tscope)
        np.testing.assert_allclose(to[0], jo[0], rtol=1e-5, atol=1e-5)
        if step == 0:
            for name, a, b in zip(params, to[1:], jo[1:]):
                assert np.abs(b).max() > 0, name
                np.testing.assert_allclose(
                    a, b, rtol=0, atol=1e-4 * np.abs(b).max() + 1e-12,
                    err_msg=f"{name}@GRAD")
    bound = 4 * sum(_noam(t) for t in (1, 2, 3)) + 1e-7
    for name in params:
        a = tscope.find_var(name).numpy()
        assert np.abs(a - np.asarray(jscope.find_var(name))).max() <= bound, \
            name


def test_moe_transformer_amp_trains_like_the_reference(monkeypatch):
    def make(fluid, mod):
        return lambda amp: build(fluid, mod.build_model,
                                 **dict(ARCH, use_amp=amp))

    runs, arrays, progs, logs = three_runs(monkeypatch, make(jf, jt),
                                           make(tf, tt), _batch())
    assert program_json(progs["port_amp"]) == \
        program_json(progs["ref_amp"])
    assert logs["port"] == logs["ref"]
    moe = [dict(sig) for op, sig in logs["port"] if op == "moe_ffn"]
    assert moe and all(set(s.values()) == {("float32",)} for s in moe), moe
    check_amp_parity(runs, arrays)
    np.testing.assert_allclose(runs["port_amp"][0], runs["ref_amp"][0],
                               rtol=0, atol=2e-3)
    check_state(runs, arrays, 4 * sum(_noam(t) for t in (1, 2, 3)) + 1e-7)
