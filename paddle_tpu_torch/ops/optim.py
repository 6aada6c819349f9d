"""Optimizer update ops: the port of paddle_tpu/ops/optim.py `sgd` and
`adam`, dense gradients only (reference:
paddle/fluid/operators/optimizers/sgd_op.cc, adam_op.cc).

Each op consumes Param/Grad plus accumulator state and returns the
updated values as new tensors; the Executor writes them back to the
persistable scope vars.  They run after the backward marker, under
`torch.no_grad()`, so autograd records none of them.  The reference's
SparseGrad (SelectedRows) branches and its other ten optimizer ops are
not ported yet (ROADMAP queue A item 2).
"""

from __future__ import annotations

import torch

from ..core.registry import register_op
from .common import first


def _lr(ins):
    return first(ins, "LearningRate").reshape(())


@register_op("sgd")
def sgd(ctx, ins, attrs):
    p, g = first(ins, "Param"), first(ins, "Grad")
    return {"ParamOut": [p - _lr(ins) * g]}


@register_op("adam")
def adam(ctx, ins, attrs):
    """Adam with the bias corrections folded into the step size, as the
    reference computes it: lr_t = lr * sqrt(1 - beta2^t) / (1 - beta1^t),
    p -= lr_t * m1 / (sqrt(m2) + epsilon)."""
    p, g = first(ins, "Param"), first(ins, "Grad")
    m1, m2 = first(ins, "Moment1"), first(ins, "Moment2")
    b1p = first(ins, "Beta1Pow").reshape(())
    b2p = first(ins, "Beta2Pow").reshape(())
    beta1 = attrs.get("beta1", 0.9)
    beta2 = attrs.get("beta2", 0.999)
    eps = attrs.get("epsilon", 1e-8)
    lr = _lr(ins) * torch.sqrt(1 - b2p) / (1 - b1p)
    m1n = beta1 * m1 + (1 - beta1) * g
    m2n = beta2 * m2 + (1 - beta2) * torch.square(g)
    return {
        "ParamOut": [p - lr * m1n / (torch.sqrt(m2n) + eps)],
        "Moment1Out": [m1n], "Moment2Out": [m2n],
        "Beta1PowOut": [(b1p * beta1).reshape((1,))],
        "Beta2PowOut": [(b2p * beta2).reshape((1,))],
    }
