"""Learning-rate schedules as in-graph ops over a step counter.

The port of paddle_tpu/layers/learning_rate_scheduler.py (reference:
python/paddle/fluid/layers/learning_rate_scheduler.py — noam_decay,
exponential_decay, natural_exp_decay, inverse_time_decay,
polynomial_decay, piecewise_decay, cosine_decay, linear_lr_warmup).
Like fluid, the schedule is part of the program: a persistable global-step
var is incremented every step and the lr var is recomputed from it by the
`lr_schedule` op in the same run.
"""

from __future__ import annotations

import math

import torch

from ..core.registry import register_op
from ..initializer import Constant
from ..layer_helper import LayerHelper

_COUNTER_NAME = "@lr_decay_counter@"


def _decay_step_counter(begin=0):
    """Persistable global step, incremented once per executed program run
    (reference learning_rate_scheduler.py _decay_step_counter /
    autoincreased_step_counter)."""
    helper = LayerHelper("global_step_counter")
    counter = helper.create_or_get_global_variable(
        _COUNTER_NAME, shape=[1], dtype="float32",
        initializer=Constant(float(begin)))
    block = helper.main_program.global_block()
    if not any(op.type == "increment" and
               op.output("Out") == [counter.name]
               for op in block.ops):
        block.append_op(type="increment", inputs={"X": [counter]},
                        outputs={"Out": [counter]}, attrs={"step": 1.0})
    return counter


@register_op("lr_schedule")
def _lr_schedule(ctx, ins, attrs):
    step = ins["Step"][0].reshape(()).to(torch.float32)
    kind = attrs["kind"]
    p = attrs
    if kind == "noam":
        lr = p["d_model"] ** -0.5 * torch.minimum(
            step ** -0.5, step * p["warmup_steps"] ** -1.5)
    elif kind in ("exponential", "natural_exp", "inverse_time"):
        e = step / p["decay_steps"]
        if p["staircase"]:
            e = torch.floor(e)
        if kind == "exponential":
            lr = p["learning_rate"] * p["decay_rate"] ** e
        elif kind == "natural_exp":
            lr = p["learning_rate"] * torch.exp(-p["decay_rate"] * e)
        else:
            lr = p["learning_rate"] / (1.0 + p["decay_rate"] * e)
    elif kind == "polynomial":
        decay_steps = p["decay_steps"]
        if p["cycle"]:
            decay_steps = decay_steps * torch.ceil(
                torch.clamp(step, min=1.0) / p["decay_steps"])
        gstep = torch.minimum(step, torch.as_tensor(
            decay_steps, dtype=torch.float32, device=step.device))
        lr = (p["learning_rate"] - p["end_learning_rate"]) * \
            (1 - gstep / decay_steps) ** p["power"] + p["end_learning_rate"]
    elif kind == "piecewise":
        bounds = torch.tensor(p["boundaries"], dtype=torch.float32,
                              device=step.device)
        values = torch.tensor(p["values"], dtype=torch.float32,
                              device=step.device)
        lr = values.index_select(0, (step >= bounds).sum().reshape(1))
    elif kind == "cosine":
        epoch = torch.floor(step / p["step_each_epoch"])
        lr = p["learning_rate"] / 2.0 * (
            torch.cos(epoch * math.pi / p["epochs"]) + 1.0)
    elif kind == "linear_warmup":
        base = ins["BaseLr"][0].reshape(()) if ins.get("BaseLr") \
            else torch.tensor(p["base_lr"], dtype=torch.float32,
                              device=step.device)
        frac = torch.clamp(step / p["warmup_steps"], 0.0, 1.0)
        warm = p["start_lr"] + (p["end_lr"] - p["start_lr"]) * frac
        lr = torch.where(step < p["warmup_steps"], warm, base)
    else:
        raise ValueError(f"unknown lr schedule {kind}")
    return {"Out": [lr.to(torch.float32).reshape((1,))]}


def _schedule(kind, extra_inputs=None, **params):
    helper = LayerHelper(f"lr_{kind}")
    step = _decay_step_counter()
    out = helper.create_variable_for_type_inference("float32")
    out.desc.stop_gradient = True
    ins = {"Step": [step]}
    if extra_inputs:
        ins.update(extra_inputs)
    helper.append_op(type="lr_schedule", inputs=ins,
                     outputs={"Out": [out]},
                     attrs=dict(params, kind=kind))
    return out


def noam_decay(d_model, warmup_steps):
    return _schedule("noam", d_model=d_model, warmup_steps=warmup_steps)


def exponential_decay(learning_rate, decay_steps, decay_rate,
                      staircase=False):
    return _schedule("exponential", learning_rate=learning_rate,
                     decay_steps=decay_steps, decay_rate=decay_rate,
                     staircase=staircase)


def natural_exp_decay(learning_rate, decay_steps, decay_rate,
                      staircase=False):
    return _schedule("natural_exp", learning_rate=learning_rate,
                     decay_steps=decay_steps, decay_rate=decay_rate,
                     staircase=staircase)


def inverse_time_decay(learning_rate, decay_steps, decay_rate,
                       staircase=False):
    return _schedule("inverse_time", learning_rate=learning_rate,
                     decay_steps=decay_steps, decay_rate=decay_rate,
                     staircase=staircase)


def polynomial_decay(learning_rate, decay_steps, end_learning_rate=0.0001,
                     power=1.0, cycle=False):
    return _schedule("polynomial", learning_rate=learning_rate,
                     decay_steps=decay_steps,
                     end_learning_rate=end_learning_rate, power=power,
                     cycle=cycle)


def piecewise_decay(boundaries, values):
    if len(values) != len(boundaries) + 1:
        raise ValueError("piecewise_decay needs one more value than "
                         "boundaries")
    return _schedule("piecewise", boundaries=[float(b) for b in boundaries],
                     values=[float(v) for v in values])


def cosine_decay(learning_rate, step_each_epoch, epochs):
    return _schedule("cosine", learning_rate=learning_rate,
                     step_each_epoch=step_each_epoch, epochs=epochs)


def linear_lr_warmup(learning_rate, warmup_steps, start_lr, end_lr):
    """Ramp start_lr->end_lr over warmup_steps, then use learning_rate
    (scalar or schedule Variable)."""
    from ..core.program import Variable

    extra = None
    base_lr = 0.0
    if isinstance(learning_rate, Variable):
        extra = {"BaseLr": [learning_rate]}
    else:
        base_lr = float(learning_rate)
    return _schedule("linear_warmup", extra_inputs=extra,
                     warmup_steps=warmup_steps, start_lr=float(start_lr),
                     end_lr=float(end_lr), base_lr=base_lr)
