"""Autodiff as a program transformation.

A copy of paddle_tpu/core/backward.py (reference:
python/paddle/fluid/backward.py:394, :613).
There are no per-op grad kernels: append_backward records a *backward
boundary* in the program — everything before it is the forward function
— and the Executor computes parameter gradients with `torch.autograd`
over that forward (core/executor.py `_train_step`).  Gradient variables
`<p>@GRAD` become real program vars so the optimizer update ops that
fluid appends after the backward section work unchanged.

`gradients` / `calc_gradient` take gradients of arbitrary targets
through the `calc_gradient` macro op (ops/control_flow.py).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Set, Tuple

from .program import Variable, grad_var_name


def append_backward(loss: Variable,
                    parameter_list: Optional[Sequence[str]] = None,
                    no_grad_set: Optional[Set[str]] = None,
                    callbacks=None) -> List[Tuple[Variable, Variable]]:
    """Mark the backward boundary and create gradient variables.

    Returns [(parameter, gradient_variable)] like the reference
    (backward.py:394).  Must be called once per program, after the forward
    graph is complete.
    """
    program = loss.block.program
    block = program.global_block()
    if program._backward_info is not None:
        raise RuntimeError("append_backward called twice on the same program")

    no_grad = set(no_grad_set or ())
    if parameter_list is not None:
        params = [block.var(p) if isinstance(p, str) else p
                  for p in parameter_list]
    else:
        params = block.all_parameters()
    params = [p for p in params
              if getattr(p, "trainable", True) and p.name not in no_grad]
    if not params:
        raise RuntimeError("no trainable parameters found for backward")

    index = len(block.ops)

    # Create grad vars (loss grad + one per param).
    loss_grad = block.create_var(
        name=grad_var_name(loss.name), shape=loss.shape, dtype=loss.dtype,
        stop_gradient=True)
    params_grads: List[Tuple[Variable, Variable]] = []
    grad_names = []
    for p in params:
        g = block.create_var(
            name=grad_var_name(p.name), shape=p.shape, dtype=p.dtype,
            stop_gradient=True)
        params_grads.append((p, g))
        grad_names.append(g.name)

    block.append_op(
        type="backward_marker",
        inputs={"Loss": [loss]},
        outputs={"LossGrad": [loss_grad], "ParamGrads": grad_names},
        attrs={"params": [p.name for p in params]},
    )
    program._backward_info = {
        "index": index,
        "loss": loss.name,
        "params": [p.name for p in params],
    }
    return params_grads


def gradients(targets, inputs, target_gradients=None, no_grad_set=None):
    """Grad of targets w.r.t. arbitrary input vars (fluid calc_gradient,
    backward.py:613).

    Appends a `calc_gradient` macro op (ops/control_flow.py) that
    captures the op span [0, here) of the current block; at run time the
    span is replayed with the inputs as fresh autograd nodes and
    differentiated with `torch.autograd.grad`.  Returns the gradient
    Variables, one per input (fetchable / composable with further ops —
    double grad works by calling gradients() again on a gradient
    output).
    """
    del no_grad_set  # only `inputs` get gradients anyway
    if isinstance(targets, Variable):
        targets = [targets]
    if isinstance(inputs, Variable):
        inputs = [inputs]
    if target_gradients is None:
        target_gradients = []
    elif isinstance(target_gradients, Variable):
        target_gradients = [target_gradients]
    if target_gradients and len(target_gradients) != len(targets):
        raise ValueError("target_gradients must match targets 1:1")

    program = targets[0].block.program
    block = program.current_block()
    if block.idx != 0:
        raise RuntimeError(
            "gradients() inside a control-flow sub-block is not supported; "
            "call it in the main block")
    index = len(block.ops)

    grad_vars = []
    grad_names = []
    for x in inputs:
        g = block.create_var(
            name=unique_grad_name(block, x.name), shape=x.shape,
            dtype=x.dtype, stop_gradient=True)
        grad_vars.append(g)
        grad_names.append(g.name)

    block.append_op(
        type="calc_gradient",
        inputs={"Targets": [t.name for t in targets],
                "Inputs": [x.name for x in inputs],
                "TargetGradients": [g.name for g in target_gradients]},
        outputs={"InputGrads": grad_names},
        attrs={"targets": [t.name for t in targets],
               "inputs": [x.name for x in inputs],
               "op_range": [0, index],
               "block": block.idx},
    )
    return grad_vars


def unique_grad_name(block, name: str) -> str:
    """`<name>@GRAD`, uniquified if taken (a var can be differentiated by
    both append_backward and gradients(), or by gradients() twice)."""
    g = grad_var_name(name)
    if not block.has_var(g):
        return g
    i = 1
    while block.has_var(f"{g}_{i}"):
        i += 1
    return f"{g}_{i}"


calc_gradient = gradients  # fluid exposes both names (backward.py:613)
