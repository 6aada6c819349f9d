"""Weight-decay regularizers appended to gradients: a copy of
paddle_tpu/regularizer.py.

reference: python/paddle/fluid/regularizer.py — L1Decay/L2Decay append ops
rewriting each gradient before the optimizer update.  Without a
regularizer, append_regularization_ops passes (param, grad) through
unchanged.
"""

from __future__ import annotations


class WeightDecayRegularizer:
    def append_regularization_op(self, param, grad, block):
        raise NotImplementedError


class L2Decay(WeightDecayRegularizer):
    def __init__(self, regularization_coeff: float = 0.0):
        self.coeff = regularization_coeff

    def append_regularization_op(self, param, grad, block):
        decay = block.create_var(
            name=f"{param.name}.l2decay", dtype=grad.dtype,
            shape=grad.shape, stop_gradient=True)
        block.append_op(type="scale", inputs={"X": [param]},
                        outputs={"Out": [decay]},
                        attrs={"scale": self.coeff, "bias": 0.0,
                               "bias_after_scale": True})
        block.append_op(type="sum", inputs={"X": [grad, decay]},
                        outputs={"Out": [grad]})
        return grad


class L1Decay(WeightDecayRegularizer):
    def __init__(self, regularization_coeff: float = 0.0):
        self.coeff = regularization_coeff

    def append_regularization_op(self, param, grad, block):
        sign = block.create_var(
            name=f"{param.name}.l1sign", dtype=grad.dtype,
            shape=grad.shape, stop_gradient=True)
        block.append_op(type="sign", inputs={"X": [param]},
                        outputs={"Out": [sign]})
        decay = block.create_var(
            name=f"{param.name}.l1decay", dtype=grad.dtype,
            shape=grad.shape, stop_gradient=True)
        block.append_op(type="scale", inputs={"X": [sign]},
                        outputs={"Out": [decay]},
                        attrs={"scale": self.coeff, "bias": 0.0,
                               "bias_after_scale": True})
        block.append_op(type="sum", inputs={"X": [grad, decay]},
                        outputs={"Out": [grad]})
        return grad


L2DecayRegularizer = L2Decay
L1DecayRegularizer = L1Decay


def append_regularization_ops(params_grads, regularization=None):
    """Apply per-param regularizer (or the optimizer-wide default) to each
    gradient (reference regularizer.py append_regularization_ops)."""
    out = []
    for param, grad in params_grads:
        reg = param.regularizer or regularization
        if reg is not None:
            block = grad.block
            grad = reg.append_regularization_op(param, grad, block) or grad
        out.append((param, grad))
    return out
