"""Optimizer update ops: the port of paddle_tpu/ops/optim.py `sgd`,
`momentum` and `adam` (reference: paddle/fluid/operators/optimizers/
sgd_op.cc, momentum_op.cc, adam_op.cc).

Each op consumes Param/Grad plus accumulator state and returns the
updated values as new tensors; the Executor writes them back to the
persistable scope vars.  They run after the backward marker, under
`torch.no_grad()`, so autograd records none of them.

A SparseGrad (core/selected_rows.py: the gradient of an is_sparse
table) takes each op's lazy branch: only the merged rows of the
parameter and of its accumulators change, written with `index_copy`
(unique ids, so no atomic adds); every other row keeps its bits.  The
reference's other ten optimizer ops, and adagrad's sparse branch, are
not ported yet (ROADMAP queue A).
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
