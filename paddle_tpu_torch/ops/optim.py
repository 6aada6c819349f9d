"""Optimizer update ops: the port of paddle_tpu/ops/optim.py whole
(reference: paddle/fluid/operators/optimizers/*_op.cc — sgd, momentum,
lars_momentum, adam, adamax, adagrad, decayed_adagrad, adadelta,
rmsprop, ftrl, proximal_gd, proximal_adagrad, average_accumulates; and
ema_accumulate, the reference package's fused EMA step).

Each op consumes Param/Grad plus accumulator state and returns the
updated values as new tensors; the Executor writes them back to the
persistable scope vars.  They run after the backward marker, under
`torch.no_grad()`, so autograd records none of them.

A SparseGrad (core/selected_rows.py: the gradient of an is_sparse
table) takes each op's lazy branch: only the merged rows of the
parameter and of its accumulators change, written with `index_copy`
(unique ids, so no atomic adds); every other row keeps its bits.
sgd, momentum, adam and adagrad have that branch (the reference's
SPARSE_AWARE_OPS); the other ops see the densified gradient.
"""

from __future__ import annotations

import torch

from ..core.registry import register_op
from ..core.selected_rows import SparseGrad
from .common import first


def _lr(ins):
    return first(ins, "LearningRate").reshape(())


@register_op("sgd")
def sgd(ctx, ins, attrs):
    p, g = first(ins, "Param"), first(ins, "Grad")
    if isinstance(g, SparseGrad):
        ids, rows = g.unique_rows()
        return {"ParamOut": [p.index_copy(0, ids, p[ids] - _lr(ins) * rows)]}
    return {"ParamOut": [p - _lr(ins) * g]}


@register_op("momentum")
def momentum(ctx, ins, attrs):
    """v = mu * v + g; p -= lr * v, or with `use_nesterov`
    p -= lr * (g + mu * v) (the new v)."""
    p, g, v = first(ins, "Param"), first(ins, "Grad"), first(ins, "Velocity")
    mu = attrs["mu"]
    lr = _lr(ins)
    nesterov = attrs.get("use_nesterov", False)
    if isinstance(g, SparseGrad):
        ids, rows = g.unique_rows()
        v_rows = mu * v[ids] + rows
        step = (rows + mu * v_rows) * lr if nesterov else lr * v_rows
        return {"ParamOut": [p.index_copy(0, ids, p[ids] - step)],
                "VelocityOut": [v.index_copy(0, ids, v_rows)]}
    v_new = mu * v + g
    step = (g + mu * v_new) * lr if nesterov else lr * v_new
    return {"ParamOut": [p - step], "VelocityOut": [v_new]}


@register_op("adam")
def adam(ctx, ins, attrs):
    """Adam with the bias corrections folded into the step size, as the
    reference computes it: lr_t = lr * sqrt(1 - beta2^t) / (1 - beta1^t),
    p -= lr_t * m1 / (sqrt(m2) + epsilon).  The sparse branch is lazy:
    the moments and the parameter change at the merged rows only, while
    the beta powers advance as in the dense one."""
    p, g = first(ins, "Param"), first(ins, "Grad")
    m1, m2 = first(ins, "Moment1"), first(ins, "Moment2")
    b1p = first(ins, "Beta1Pow").reshape(())
    b2p = first(ins, "Beta2Pow").reshape(())
    beta1 = attrs.get("beta1", 0.9)
    beta2 = attrs.get("beta2", 0.999)
    eps = attrs.get("epsilon", 1e-8)
    lr = _lr(ins) * torch.sqrt(1 - b2p) / (1 - b1p)
    beta_pows = {"Beta1PowOut": [(b1p * beta1).reshape((1,))],
                 "Beta2PowOut": [(b2p * beta2).reshape((1,))]}
    if isinstance(g, SparseGrad):
        ids, rows = g.unique_rows()
        m1r = beta1 * m1[ids] + (1 - beta1) * rows
        m2r = beta2 * m2[ids] + (1 - beta2) * torch.square(rows)
        p_rows = p[ids] - lr * m1r / (torch.sqrt(m2r) + eps)
        return {"ParamOut": [p.index_copy(0, ids, p_rows)],
                "Moment1Out": [m1.index_copy(0, ids, m1r)],
                "Moment2Out": [m2.index_copy(0, ids, m2r)], **beta_pows}
    m1n = beta1 * m1 + (1 - beta1) * g
    m2n = beta2 * m2 + (1 - beta2) * torch.square(g)
    return {
        "ParamOut": [p - lr * m1n / (torch.sqrt(m2n) + eps)],
        "Moment1Out": [m1n], "Moment2Out": [m2n], **beta_pows,
    }


_RUNTIME_WIDTH = {torch.int64: torch.int32, torch.float64: torch.float32}


def _count(ins, slot):
    """A window count as a 0-dim tensor at the runtime width (64-bit
    names run 32 bits wide, ops/common.py), whatever the caller hands
    in."""
    t = first(ins, slot).reshape(())
    return t.to(_RUNTIME_WIDTH.get(t.dtype, t.dtype))


def _norm(x):
    return torch.sqrt(torch.sum(torch.square(x)))


@register_op("lars_momentum")
def lars_momentum(ctx, ins, attrs):
    """Layer-wise adaptive rate: local_lr = lr * coeff * |p| /
    (|g| + wd * |p| + 1e-12); v = mu * v + local_lr * (g + wd * p);
    p -= v."""
    p, g, v = first(ins, "Param"), first(ins, "Grad"), first(ins, "Velocity")
    mu = attrs["mu"]
    lars_coeff = attrs.get("lars_coeff", 0.001)
    lars_wd = attrs.get("lars_weight_decay", 0.0005)
    p_norm, g_norm = _norm(p), _norm(g)
    local_lr = _lr(ins) * lars_coeff * p_norm / (
        g_norm + lars_wd * p_norm + 1e-12)
    v_new = mu * v + local_lr * (g + lars_wd * p)
    return {"ParamOut": [p - v_new], "VelocityOut": [v_new]}


@register_op("adamax")
def adamax(ctx, ins, attrs):
    """m = b1 m + (1 - b1) g; u = max(b2 u, |g|);
    p -= lr / (1 - b1^t) * m / (u + eps).  The beta1 power advances in
    a separate scale op (the optimizer class appends it)."""
    p, g = first(ins, "Param"), first(ins, "Grad")
    m, inf = first(ins, "Moment"), first(ins, "InfNorm")
    b1p = first(ins, "Beta1Pow").reshape(())
    beta1 = attrs.get("beta1", 0.9)
    beta2 = attrs.get("beta2", 0.999)
    eps = attrs.get("epsilon", 1e-8)
    lr = _lr(ins) / (1 - b1p)
    m_new = beta1 * m + (1 - beta1) * g
    inf_new = torch.maximum(beta2 * inf, torch.abs(g))
    return {"ParamOut": [p - lr * m_new / (inf_new + eps)],
            "MomentOut": [m_new], "InfNormOut": [inf_new]}


@register_op("adagrad")
def adagrad(ctx, ins, attrs):
    """m += g^2; p -= lr * g / (sqrt(m) + eps).  The sparse branch is
    lazy: the moment and the parameter change at the merged rows only
    (reference: optimizers/adagrad_op.h SparseAdagradFunctor)."""
    p, g, m = first(ins, "Param"), first(ins, "Grad"), first(ins, "Moment")
    eps = attrs.get("epsilon", 1e-6)
    if isinstance(g, SparseGrad):
        ids, rows = g.unique_rows()
        m_rows = m[ids] + torch.square(rows)
        p_rows = p[ids] - _lr(ins) * rows / (torch.sqrt(m_rows) + eps)
        return {"ParamOut": [p.index_copy(0, ids, p_rows)],
                "MomentOut": [m.index_copy(0, ids, m_rows)]}
    m_new = m + torch.square(g)
    return {"ParamOut": [p - _lr(ins) * g / (torch.sqrt(m_new) + eps)],
            "MomentOut": [m_new]}


@register_op("decayed_adagrad")
def decayed_adagrad(ctx, ins, attrs):
    """m = decay m + (1 - decay) g^2; p -= lr * g / (sqrt(m) + eps)."""
    p, g, m = first(ins, "Param"), first(ins, "Grad"), first(ins, "Moment")
    decay = attrs.get("decay", 0.95)
    eps = attrs.get("epsilon", 1e-6)
    m_new = decay * m + (1 - decay) * torch.square(g)
    return {"ParamOut": [p - _lr(ins) * g / (torch.sqrt(m_new) + eps)],
            "MomentOut": [m_new]}


@register_op("adadelta")
def adadelta(ctx, ins, attrs):
    """E[g^2] = rho E[g^2] + (1 - rho) g^2;
    d = -sqrt((E[d^2] + eps) / (E[g^2] + eps)) g;
    E[d^2] = rho E[d^2] + (1 - rho) d^2; p += d (no learning rate, as in
    the reference's op)."""
    p, g = first(ins, "Param"), first(ins, "Grad")
    avg_sq_g = first(ins, "AvgSquaredGrad")
    avg_sq_u = first(ins, "AvgSquaredUpdate")
    rho = attrs.get("rho", 0.95)
    eps = attrs.get("epsilon", 1e-6)
    g2 = rho * avg_sq_g + (1 - rho) * torch.square(g)
    update = -torch.sqrt((avg_sq_u + eps) / (g2 + eps)) * g
    u2 = rho * avg_sq_u + (1 - rho) * torch.square(update)
    return {"ParamOut": [p + update], "AvgSquaredGradOut": [g2],
            "AvgSquaredUpdateOut": [u2]}


@register_op("rmsprop")
def rmsprop(ctx, ins, attrs):
    """ms = decay ms + (1 - decay) g^2; mom = mu mom + lr g /
    sqrt(ms + eps) (centered: sqrt(ms - mg^2 + eps) with mg the mean
    gradient); p -= mom."""
    p, g = first(ins, "Param"), first(ins, "Grad")
    ms, mom = first(ins, "MeanSquare"), first(ins, "Moment")
    eps = attrs.get("epsilon", 1e-10)
    decay = attrs.get("decay", 0.9)
    mu = attrs.get("momentum", 0.0)
    lr = _lr(ins)
    ms_new = decay * ms + (1 - decay) * torch.square(g)
    if attrs.get("centered", False):
        mg_new = decay * first(ins, "MeanGrad") + (1 - decay) * g
        mom_new = mu * mom + lr * g / torch.sqrt(
            ms_new - torch.square(mg_new) + eps)
        return {"ParamOut": [p - mom_new], "MeanSquareOut": [ms_new],
                "MomentOut": [mom_new], "MeanGradOut": [mg_new]}
    mom_new = mu * mom + lr * g / torch.sqrt(ms_new + eps)
    return {"ParamOut": [p - mom_new], "MeanSquareOut": [ms_new],
            "MomentOut": [mom_new]}


@register_op("ftrl")
def ftrl(ctx, ins, attrs):
    """Follow-the-regularized-leader (reference ftrl_op.h): the squared
    and linear accumulators, then p = (l1 sign(lin) - lin) / denom where
    |lin| > l1, else 0."""
    p, g = first(ins, "Param"), first(ins, "Grad")
    sq = first(ins, "SquaredAccumulator")
    lin = first(ins, "LinearAccumulator")
    l1 = attrs.get("l1", 0.0)
    l2 = attrs.get("l2", 0.0)
    lr_power = attrs.get("lr_power", -0.5)
    lr = _lr(ins)
    new_sq = sq + torch.square(g)
    if lr_power == -0.5:
        new_root, old_root = torch.sqrt(new_sq), torch.sqrt(sq)
    else:
        new_root = torch.pow(new_sq, -lr_power)
        old_root = torch.pow(sq, -lr_power)
    new_lin = lin + g - (new_root - old_root) / lr * p
    denom = new_root / lr + 2 * l2
    x = l1 * torch.sign(new_lin) - new_lin
    p_new = torch.where(torch.abs(new_lin) > l1, x / denom,
                        torch.zeros((), dtype=p.dtype, device=p.device))
    return {"ParamOut": [p_new], "SquaredAccumOut": [new_sq],
            "LinearAccumOut": [new_lin]}


def _shrink(prox, lr, l1, l2):
    """The proximal step: sign(prox) max(|prox| - lr l1, 0) /
    (1 + lr l2)."""
    return torch.sign(prox) * torch.clamp(
        torch.abs(prox) - lr * l1, min=0.0) / (1.0 + lr * l2)


@register_op("proximal_gd")
def proximal_gd(ctx, ins, attrs):
    p, g = first(ins, "Param"), first(ins, "Grad")
    lr = _lr(ins)
    return {"ParamOut": [_shrink(p - lr * g, lr, attrs.get("l1", 0.0),
                                 attrs.get("l2", 0.0))]}


@register_op("proximal_adagrad")
def proximal_adagrad(ctx, ins, attrs):
    p, g, m = first(ins, "Param"), first(ins, "Grad"), first(ins, "Moment")
    m_new = m + torch.square(g)
    eff_lr = _lr(ins) / torch.sqrt(m_new)
    return {"ParamOut": [_shrink(p - eff_lr * g, eff_lr,
                                 attrs.get("l1", 0.0),
                                 attrs.get("l2", 0.0))],
            "MomentOut": [m_new]}


@register_op("average_accumulates")
def average_accumulates(ctx, ins, attrs):
    """The parameter-averaging window of ModelAverage (reference:
    optimizers/average_accumulates_op.cc), on the device with no host
    read:

      num_updates += 1;  num_accumulates += 1;  sum_1 += param
      if num_updates % max_window == 0:  sum_2 += sum_1; sum_1 = 0
      if num_accumulates >= min_window and
         num_accumulates >= min(max_window, num_updates * window_rate):
          sum_3 = sum_1 + sum_2; sum_1 = sum_2 = 0
          old_num_accumulates = num_accumulates; num_accumulates = 0
    """
    p = first(ins, "Param")
    s1, s2, s3 = (first(ins, k) for k in ("Sum1", "Sum2", "Sum3"))
    num_acc, old_num, num_upd = (
        _count(ins, k)
        for k in ("NumAccumulates", "OldNumAccumulates", "NumUpdates"))
    rate = float(attrs.get("average_window", 0.0))
    max_acc = int(attrs.get("max_average_window", 10000))
    min_w = int(attrs.get("min_average_window", 10000))
    zero = torch.zeros((), dtype=s1.dtype, device=s1.device)

    num_upd = num_upd + 1
    num_acc = num_acc + 1
    s1 = s1 + p
    roll = (num_upd % max(max_acc, 1)) == 0
    s2 = torch.where(roll, s2 + s1, s2)
    s1 = torch.where(roll, zero, s1)
    window = torch.clamp(num_upd.to(torch.float32) * rate,
                         max=float(max_acc))
    emit = (num_acc >= min_w) & (num_acc.to(torch.float32) >= window)
    s3 = torch.where(emit, s1 + s2, s3)
    s1 = torch.where(emit, zero, s1)
    s2 = torch.where(emit, zero, s2)
    old_num = torch.where(emit, num_acc, old_num)
    num_acc = torch.where(emit, torch.zeros_like(num_acc), num_acc)
    return {"Sum1Out": [s1], "Sum2Out": [s2], "Sum3Out": [s3],
            "NumAccumulatesOut": [num_acc.reshape((1,))],
            "OldNumAccumulatesOut": [old_num.reshape((1,))],
            "NumUpdatesOut": [num_upd.reshape((1,))]}


@register_op("ema_accumulate")
def ema_accumulate(ctx, ins, attrs):
    """ema = decay * ema + (1 - decay) * param (the reference package's
    one fused op for ExponentialMovingAverage)."""
    p, ema = first(ins, "Param"), first(ins, "Ema")
    decay = float(attrs.get("decay", 0.999))
    return {"EmaOut": [decay * ema + (1.0 - decay) * p]}
