"""Optimizer classes: minimize = append_backward + update ops.

The port of paddle_tpu/optimizer.py whole: `Optimizer`, SGD, Momentum,
LarsMomentum, Adam, Adamax, Adagrad, DecayedAdagrad, Adadelta, RMSProp
and Ftrl with their short aliases, `ModelAverage` and
`ExponentialMovingAverage` (reference:
python/paddle/fluid/optimizer.py — Optimizer.minimize (:295) =
append_backward + _create_optimization_pass (:198)).  The code that
appends the ops is the reference's, so the update ops, accumulator vars
and their startup initializers serialize identically; the update rules
are the ops of ops/optim.py, run by the Executor after the backward
marker.  ModelAverage's and EMA's `apply()` swap the averaged values
into the scope computed on the device (the reference computes them in
numpy), and `restore()` puts back the very tensors it took out.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Optional

import torch

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


class LarsMomentumOptimizer(Optimizer):
    def __init__(self, learning_rate, momentum, lars_coeff=0.001,
                 lars_weight_decay=0.0005, regularization=None, name=None):
        super().__init__(learning_rate, regularization, name)
        self._momentum = momentum
        self._lars_coeff = lars_coeff
        self._lars_weight_decay = lars_weight_decay

    def _create_accumulators(self, block, param):
        self._add_accumulator("velocity", param)

    def _append_optimize_op(self, block, param, grad):
        velocity = self._get_accumulator("velocity", param)
        return block.append_op(
            type="lars_momentum",
            inputs={"Param": [param], "Grad": [grad],
                    "Velocity": [velocity],
                    "LearningRate": [self._create_param_lr(param)]},
            outputs={"ParamOut": [param], "VelocityOut": [velocity]},
            attrs={"mu": self._momentum, "lars_coeff": self._lars_coeff,
                   "lars_weight_decay": self._lars_weight_decay})


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


class AdamaxOptimizer(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, regularization=None, name=None):
        super().__init__(learning_rate, regularization, name)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon

    def _create_accumulators(self, block, param):
        self._add_accumulator("moment", param)
        self._add_accumulator("inf_norm", param)
        self._add_accumulator("beta1_pow_acc", param, self._beta1, [1])

    def _append_optimize_op(self, block, param, grad):
        m = self._get_accumulator("moment", param)
        inf = self._get_accumulator("inf_norm", param)
        b1p = self._get_accumulator("beta1_pow_acc", param)
        op = block.append_op(
            type="adamax",
            inputs={"Param": [param], "Grad": [grad], "Moment": [m],
                    "InfNorm": [inf], "Beta1Pow": [b1p],
                    "LearningRate": [self._create_param_lr(param)]},
            outputs={"ParamOut": [param], "MomentOut": [m],
                     "InfNormOut": [inf]},
            attrs={"beta1": self._beta1, "beta2": self._beta2,
                   "epsilon": self._epsilon})
        # beta1_pow updated separately (reference adamax has no pow output)
        block.append_op(type="scale", inputs={"X": [b1p]},
                        outputs={"Out": [b1p]},
                        attrs={"scale": self._beta1, "bias": 0.0,
                               "bias_after_scale": True})
        return op


class AdagradOptimizer(Optimizer):
    def __init__(self, learning_rate, epsilon=1e-6, regularization=None,
                 name=None, initial_accumulator_value=0.0):
        super().__init__(learning_rate, regularization, name)
        self._epsilon = epsilon
        self._initial = initial_accumulator_value

    def _create_accumulators(self, block, param):
        self._add_accumulator("moment", param, self._initial)

    def _append_optimize_op(self, block, param, grad):
        m = self._get_accumulator("moment", param)
        return block.append_op(
            type="adagrad",
            inputs={"Param": [param], "Grad": [grad], "Moment": [m],
                    "LearningRate": [self._create_param_lr(param)]},
            outputs={"ParamOut": [param], "MomentOut": [m]},
            attrs={"epsilon": self._epsilon})


class DecayedAdagradOptimizer(Optimizer):
    def __init__(self, learning_rate, decay=0.95, epsilon=1e-6,
                 regularization=None, name=None):
        super().__init__(learning_rate, regularization, name)
        self._decay, self._epsilon = decay, epsilon

    def _create_accumulators(self, block, param):
        self._add_accumulator("moment", param)

    def _append_optimize_op(self, block, param, grad):
        m = self._get_accumulator("moment", param)
        return block.append_op(
            type="decayed_adagrad",
            inputs={"Param": [param], "Grad": [grad], "Moment": [m],
                    "LearningRate": [self._create_param_lr(param)]},
            outputs={"ParamOut": [param], "MomentOut": [m]},
            attrs={"decay": self._decay, "epsilon": self._epsilon})


class AdadeltaOptimizer(Optimizer):
    def __init__(self, learning_rate, epsilon=1e-6, rho=0.95,
                 regularization=None, name=None):
        super().__init__(learning_rate, regularization, name)
        self._epsilon, self._rho = epsilon, rho

    def _create_accumulators(self, block, param):
        self._add_accumulator("_avg_squared_grad", param)
        self._add_accumulator("_avg_squared_update", param)

    def _append_optimize_op(self, block, param, grad):
        g2 = self._get_accumulator("_avg_squared_grad", param)
        u2 = self._get_accumulator("_avg_squared_update", param)
        return block.append_op(
            type="adadelta",
            inputs={"Param": [param], "Grad": [grad],
                    "AvgSquaredGrad": [g2], "AvgSquaredUpdate": [u2],
                    "LearningRate": [self._create_param_lr(param)]},
            outputs={"ParamOut": [param], "AvgSquaredGradOut": [g2],
                     "AvgSquaredUpdateOut": [u2]},
            attrs={"epsilon": self._epsilon, "rho": self._rho})


class RMSPropOptimizer(Optimizer):
    def __init__(self, learning_rate, rho=0.95, epsilon=1e-6, momentum=0.0,
                 centered=False, regularization=None, name=None):
        super().__init__(learning_rate, regularization, name)
        self._rho, self._epsilon = rho, epsilon
        self._momentum, self._centered = momentum, centered

    def _create_accumulators(self, block, param):
        self._add_accumulator("momentum", param)
        self._add_accumulator("mean_square", param)
        if self._centered:
            self._add_accumulator("mean_grad", param)

    def _append_optimize_op(self, block, param, grad):
        mom = self._get_accumulator("momentum", param)
        ms = self._get_accumulator("mean_square", param)
        ins = {"Param": [param], "Grad": [grad], "Moment": [mom],
               "MeanSquare": [ms],
               "LearningRate": [self._create_param_lr(param)]}
        outs = {"ParamOut": [param], "MomentOut": [mom],
                "MeanSquareOut": [ms]}
        if self._centered:
            mg = self._get_accumulator("mean_grad", param)
            ins["MeanGrad"] = [mg]
            outs["MeanGradOut"] = [mg]
        return block.append_op(
            type="rmsprop", inputs=ins, outputs=outs,
            attrs={"decay": self._rho, "epsilon": self._epsilon,
                   "momentum": self._momentum, "centered": self._centered})


class FtrlOptimizer(Optimizer):
    def __init__(self, learning_rate, l1=0.0, l2=0.0, lr_power=-0.5,
                 regularization=None, name=None):
        super().__init__(learning_rate, regularization, name)
        self._l1, self._l2, self._lr_power = l1, l2, lr_power

    def _create_accumulators(self, block, param):
        self._add_accumulator("squared", param)
        self._add_accumulator("linear", param)

    def _append_optimize_op(self, block, param, grad):
        sq = self._get_accumulator("squared", param)
        lin = self._get_accumulator("linear", param)
        return block.append_op(
            type="ftrl",
            inputs={"Param": [param], "Grad": [grad],
                    "SquaredAccumulator": [sq], "LinearAccumulator": [lin],
                    "LearningRate": [self._create_param_lr(param)]},
            outputs={"ParamOut": [param], "SquaredAccumOut": [sq],
                     "LinearAccumOut": [lin]},
            attrs={"l1": self._l1, "l2": self._l2,
                   "lr_power": self._lr_power})


# fluid exposes both CamelCase and the short aliases
SGD = SGDOptimizer
Momentum = MomentumOptimizer
Adam = AdamOptimizer
Adamax = AdamaxOptimizer
Adagrad = AdagradOptimizer
DecayedAdagrad = DecayedAdagradOptimizer
Adadelta = AdadeltaOptimizer
RMSProp = RMSPropOptimizer
Ftrl = FtrlOptimizer
LarsMomentum = LarsMomentumOptimizer


class _ScopeSwapMixin:
    """Shared apply/restore protocol (the scope swap both
    ModelAverage.apply and ExponentialMovingAverage.apply perform in the
    reference): back up each parameter's tensor, install
    `_swap_values(param, scope)` — computed on the parameter's device —
    and put the very same tensors back on restore."""

    @contextlib.contextmanager
    def apply(self, executor=None, need_restore=True):
        """Swap the averaged values into the global scope for the body
        of the `with`; restore afterwards unless `need_restore` is
        False."""
        from .core.executor import global_scope

        scope = global_scope()
        self._backup = {p.name: scope.find_var(p.name)
                        for p in self._params}
        self._backup_scope = scope
        with torch.no_grad():
            swapped = {p.name: self._swap_values(p, scope).to(
                torch.float32) for p in self._params}
        for name, value in swapped.items():
            scope.set_var(name, value)
        try:
            yield
        finally:
            if need_restore:
                self.restore(executor)

    def restore(self, executor=None):
        """Put back the tensors `apply` took out."""
        scope = getattr(self, "_backup_scope", None)
        for name, val in getattr(self, "_backup", {}).items():
            scope.set_var(name, val)
        self._backup = {}


class ModelAverage(_ScopeSwapMixin, Optimizer):
    """Windowed parameter averaging for evaluation (reference:
    python/paddle/fluid/optimizer.py:1407 ModelAverage +
    operators/optimizers/average_accumulates_op.cc).

    Build AFTER minimize(): one average_accumulates op per trainable
    parameter is appended to the main program, so every training step
    updates the window sums.  `with ma.apply(exe): ...` evaluates with
    the averaged weights, (sum_1 + sum_2 + sum_3) / (num_accumulates +
    old_num_accumulates), and restores afterwards.
    """

    def __init__(self, average_window_rate, min_average_window=10000,
                 max_average_window=10000, regularization=None, name=None):
        super().__init__(0.0, regularization, name)
        self.average_window = float(average_window_rate)
        self.min_average_window = int(min_average_window)
        self.max_average_window = int(max_average_window)
        self.helper = LayerHelper(self.__class__.__name__)
        from .core.program import default_main_program

        block = default_main_program().global_block()
        self._params = [p for p in block.all_parameters()
                        if getattr(p, "trainable", True)]
        for param in self._params:
            self._append_average_accumulate_op(param)

    def _append_average_accumulate_op(self, param):
        s1 = self._add_accumulator("sum_1", param)
        s2 = self._add_accumulator("sum_2", param)
        s3 = self._add_accumulator("sum_3", param)
        num_acc = self._add_accumulator("num_accumulates", param,
                                        shape=[1], dtype="float32")
        old_num = self._add_accumulator("old_num_accumulates", param,
                                        shape=[1], dtype="float32")
        num_upd = self._add_accumulator("num_updates", param,
                                        shape=[1], dtype="float32")
        self.helper.append_op(
            type="average_accumulates",
            inputs={"Param": [param], "Sum1": [s1], "Sum2": [s2],
                    "Sum3": [s3], "NumAccumulates": [num_acc],
                    "OldNumAccumulates": [old_num],
                    "NumUpdates": [num_upd]},
            outputs={"Sum1Out": [s1], "Sum2Out": [s2], "Sum3Out": [s3],
                     "NumAccumulatesOut": [num_acc],
                     "OldNumAccumulatesOut": [old_num],
                     "NumUpdatesOut": [num_upd]},
            attrs={"average_window": self.average_window,
                   "min_average_window": self.min_average_window,
                   "max_average_window": self.max_average_window})

    def _swap_values(self, param, scope):
        """The window average, on the device (no host read): the
        parameter itself while the window is still empty."""
        def acc(name):
            return scope.find_var(f"{param.name}.{name}")

        total = (acc("num_accumulates").reshape(())
                 + acc("old_num_accumulates").reshape(()))
        avg = (acc("sum_1") + acc("sum_2") + acc("sum_3")) / total
        return torch.where(total > 0, avg, scope.find_var(param.name))


class ExponentialMovingAverage(_ScopeSwapMixin):
    """EMA shadow weights with apply/restore (fluid's
    ExponentialMovingAverage, built on the reference package's fused
    ema_accumulate op).  apply() installs the bias-corrected shadow
    ema / (1 - decay^t), t the count of `update` steps, computed on the
    device with one host read of t."""

    def __init__(self, decay=0.999, name=None):
        self._decay = float(decay)
        self.helper = LayerHelper("ema", name=name)
        from .core.program import default_main_program

        block = default_main_program().global_block()
        self._params = [p for p in block.all_parameters()
                        if getattr(p, "trainable", True)]
        self._ema_vars = {}
        for p in self._params:
            ema = self.helper.create_or_get_global_variable(
                name=f"{p.name}.ema", shape=list(p.shape), dtype=p.dtype,
                persistable=True, initializer=Constant(0.0))
            self._ema_vars[p.name] = ema
        self._step_var = self.helper.create_or_get_global_variable(
            name=f"{self.helper.name}.ema_step", shape=[1],
            dtype="float32", persistable=True, initializer=Constant(0.0))

    def update(self):
        """Append the per-step EMA update ops (call after minimize)."""
        from . import layers

        for p in self._params:
            ema = self._ema_vars[p.name]
            self.helper.append_op(
                type="ema_accumulate",
                inputs={"Param": [p], "Ema": [ema]},
                outputs={"EmaOut": [ema]},
                attrs={"decay": self._decay})
        layers.increment(self._step_var, value=1.0, in_place=True)

    @contextlib.contextmanager
    def apply(self, executor=None, need_restore=True):
        from .core.executor import global_scope

        # the one host read: t sets the correction, as the reference's
        # float(t) does
        self._t = float(global_scope().find_var(
            self._step_var.name).reshape(()))
        with super().apply(executor, need_restore):
            yield

    def _swap_values(self, param, scope):
        if self._t <= 0:
            return scope.find_var(param.name)
        correction = 1.0 - self._decay ** self._t
        return scope.find_var(f"{param.name}.ema") / correction
