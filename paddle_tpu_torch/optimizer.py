"""Optimizer classes: minimize = append_backward + update ops.

The port of paddle_tpu/optimizer.py `Optimizer`, `SGDOptimizer`,
`MomentumOptimizer` and `AdamOptimizer` (reference:
python/paddle/fluid/optimizer.py — Optimizer.minimize (:295) =
append_backward + _create_optimization_pass (:198)).  The code that
appends the ops is the reference's, so the update ops, accumulator vars
and their startup initializers serialize identically; the update rules
are the ops of ops/optim.py, run by the Executor after the backward
marker.  The other
optimizers (LarsMomentum, Adagrad, Adamax, DecayedAdagrad, Adadelta,
RMSProp, Ftrl), ModelAverage and EMA are not ported yet (ROADMAP queue A
item 2).
"""

from __future__ import annotations

from typing import Dict, Optional

from .clip import append_gradient_clip_ops
from .core.backward import append_backward
from .core.program import (Parameter, Variable, default_startup_program,
                           program_guard)
from .initializer import Constant
from .layer_helper import LayerHelper
from .regularizer import append_regularization_ops


class Optimizer:
    def __init__(self, learning_rate, regularization=None, name=None):
        self._learning_rate = learning_rate
        self.regularization = regularization
        self._name = name
        self._accumulators: Dict[str, Dict[str, Variable]] = {}
        self._lr_var: Optional[Variable] = None
        self.helper: Optional[LayerHelper] = None

    # -- learning rate ---------------------------------------------------
    def _create_global_learning_rate(self):
        if isinstance(self._learning_rate, Variable):
            self._lr_var = self._learning_rate
            return
        if self._lr_var is None:
            helper = LayerHelper(self.__class__.__name__)
            self._lr_var = helper.create_or_get_global_variable(
                name=f"{helper.name}.learning_rate", shape=[1],
                dtype="float32", persistable=True,
                initializer=Constant(float(self._learning_rate)))

    def _create_param_lr(self, param: Parameter) -> Variable:
        if getattr(param, "learning_rate", 1.0) == 1.0:
            return self._lr_var
        from . import layers

        return layers.scale(self._lr_var, scale=param.learning_rate)

    # -- accumulators ----------------------------------------------------
    def _add_accumulator(self, name: str, param: Parameter,
                         fill_value: float = 0.0, shape=None,
                         dtype=None) -> Variable:
        acc = self._accumulators.setdefault(name, {})
        if param.name in acc:
            return acc[param.name]
        helper = self.helper or LayerHelper(self.__class__.__name__)
        var = helper.create_or_get_global_variable(
            name=f"{param.name}.{name}",
            shape=list(shape if shape is not None else param.shape),
            dtype=dtype or param.dtype, persistable=True,
            initializer=Constant(fill_value))
        acc[param.name] = var
        return var

    def _get_accumulator(self, name, param):
        return self._accumulators[name][param.name]

    # -- main entry points ----------------------------------------------
    def backward(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        return append_backward(loss, parameter_list, no_grad_set)

    def apply_gradients(self, params_grads):
        params_grads = append_gradient_clip_ops(params_grads)
        params_grads = append_regularization_ops(params_grads,
                                                 self.regularization)
        block = params_grads[0][0].block
        self._create_global_learning_rate()
        for p, g in params_grads:
            self._create_accumulators(block, p)
        opt_ops = []
        for p, g in params_grads:
            opt_ops.append(self._append_optimize_op(block, p, g))
        self._finish_update(block, params_grads)
        return opt_ops

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        self.helper = LayerHelper(self.__class__.__name__)
        program = loss.block.program
        with program_guard(program, startup_program or
                           default_startup_program()):
            params_grads = self.backward(loss, startup_program,
                                         parameter_list, no_grad_set)
            opt_ops = self.apply_gradients(params_grads)
        return opt_ops, params_grads

    # -- per-optimizer hooks ---------------------------------------------
    def _create_accumulators(self, block, param):
        pass

    def _append_optimize_op(self, block, param, grad):
        raise NotImplementedError

    def _finish_update(self, block, params_grads):
        pass


class SGDOptimizer(Optimizer):
    def _append_optimize_op(self, block, param, grad):
        return block.append_op(
            type="sgd",
            inputs={"Param": [param], "Grad": [grad],
                    "LearningRate": [self._create_param_lr(param)]},
            outputs={"ParamOut": [param]})


class MomentumOptimizer(Optimizer):
    def __init__(self, learning_rate, momentum, use_nesterov=False,
                 regularization=None, name=None):
        super().__init__(learning_rate, regularization, name)
        self._momentum = momentum
        self._use_nesterov = use_nesterov

    def _create_accumulators(self, block, param):
        self._add_accumulator("velocity", param)

    def _append_optimize_op(self, block, param, grad):
        velocity = self._get_accumulator("velocity", param)
        return block.append_op(
            type="momentum",
            inputs={"Param": [param], "Grad": [grad],
                    "Velocity": [velocity],
                    "LearningRate": [self._create_param_lr(param)]},
            outputs={"ParamOut": [param], "VelocityOut": [velocity]},
            attrs={"mu": self._momentum,
                   "use_nesterov": self._use_nesterov})


class AdamOptimizer(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, regularization=None, name=None,
                 lazy_mode=False):
        super().__init__(learning_rate, regularization, name)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon

    def _create_accumulators(self, block, param):
        self._add_accumulator("moment1", param)
        self._add_accumulator("moment2", param)
        self._add_accumulator("beta1_pow_acc", param, self._beta1, [1])
        self._add_accumulator("beta2_pow_acc", param, self._beta2, [1])

    def _append_optimize_op(self, block, param, grad):
        m1 = self._get_accumulator("moment1", param)
        m2 = self._get_accumulator("moment2", param)
        b1p = self._get_accumulator("beta1_pow_acc", param)
        b2p = self._get_accumulator("beta2_pow_acc", param)
        return block.append_op(
            type="adam",
            inputs={"Param": [param], "Grad": [grad],
                    "Moment1": [m1], "Moment2": [m2],
                    "Beta1Pow": [b1p], "Beta2Pow": [b2p],
                    "LearningRate": [self._create_param_lr(param)]},
            outputs={"ParamOut": [param], "Moment1Out": [m1],
                     "Moment2Out": [m2], "Beta1PowOut": [b1p],
                     "Beta2PowOut": [b2p]},
            attrs={"beta1": self._beta1, "beta2": self._beta2,
                   "epsilon": self._epsilon})


SGD = SGDOptimizer
Momentum = MomentumOptimizer
Adam = AdamOptimizer
