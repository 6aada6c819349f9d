"""Autodiff as a program transformation.

A copy of paddle_tpu/core/backward.py `append_backward` and
`unique_grad_name` (reference: python/paddle/fluid/backward.py:394).
There are no per-op grad kernels: append_backward records a *backward
boundary* in the program — everything before it is the forward function
— and the Executor computes parameter gradients with `torch.autograd`
over that forward (core/executor.py `_train_step`).  Gradient variables
`<p>@GRAD` become real program vars so the optimizer update ops that
fluid appends after the backward section work unchanged.

`gradients` / `calc_gradient` (gradients of arbitrary targets through
the `calc_gradient` macro op) need the control-flow macro ops and are
not ported yet (ROADMAP queue A item 6).
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
    """fluid calc_gradient (backward.py:613): not ported yet."""
    raise NotImplementedError(
        "gradients()/calc_gradient need the calc_gradient macro op, which "
        "is not ported yet: ROADMAP queue A item 6 (ops/control_flow.py)")


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
