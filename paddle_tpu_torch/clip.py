"""Gradient clipping: a copy of paddle_tpu/clip.py.

reference: python/paddle/fluid/clip.py — GradientClipByValue,
GradientClipByNorm, GradientClipByGlobalNorm, set_gradient_clip.  With
no clip attr on a parameter and no default set, append_gradient_clip_ops
passes (param, grad) through unchanged.
"""

from __future__ import annotations

from typing import List, Optional, Tuple


class BaseGradientClipAttr:
    def create_operators(self, param, grad):
        raise NotImplementedError

    def process_context(self, context, param, grad):
        pass


class NullGradientClipAttr(BaseGradientClipAttr):
    def create_operators(self, param, grad):
        return param, grad


class GradientClipByValue(BaseGradientClipAttr):
    def __init__(self, max, min=None):
        if min is None:
            min = -max
        self.max, self.min = float(max), float(min)

    def create_operators(self, param, grad):
        from . import layers

        new_grad = layers.clip(grad, self.min, self.max)
        return param, _rebind(grad, new_grad)


class GradientClipByNorm(BaseGradientClipAttr):
    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    def create_operators(self, param, grad):
        from . import layers

        new_grad = layers.clip_by_norm(grad, self.clip_norm)
        return param, _rebind(grad, new_grad)


class GradientClipByGlobalNorm(BaseGradientClipAttr):
    """Resolved group-wise by append_gradient_clip_ops below."""

    def __init__(self, clip_norm, group_name="default_group"):
        self.clip_norm = float(clip_norm)
        self.group_name = group_name


def _rebind(old_grad, new_value):
    """Route the clipped value back into the original grad var name so the
    optimizer op (which reads `<p>@GRAD`) sees it."""
    block = old_grad.block
    block.append_op(type="assign", inputs={"X": [new_value]},
                    outputs={"Out": [old_grad]})
    return old_grad


_clip_attr_default = None


def set_gradient_clip(clip, param_list=None, program=None):
    """reference clip.py set_gradient_clip — set clip attr on params (or as
    a global default)."""
    global _clip_attr_default
    if param_list:
        for p in param_list:
            p.gradient_clip_attr = clip
    else:
        _clip_attr_default = clip


def append_gradient_clip_ops(params_grads):
    from . import layers

    result = []
    global_groups: dict = {}
    for param, grad in params_grads:
        clip_attr = param.gradient_clip_attr or _clip_attr_default
        if clip_attr is None:
            result.append((param, grad))
            continue
        if isinstance(clip_attr, GradientClipByGlobalNorm):
            global_groups.setdefault(clip_attr.group_name,
                                     (clip_attr, []))[1].append((param, grad))
            continue
        result.append(clip_attr.create_operators(param, grad))

    for group_name, (clip_attr, pairs) in global_groups.items():
        sq_sum = None
        for _, grad in pairs:
            s = layers.reduce_sum(layers.elementwise_mul(grad, grad))
            sq_sum = s if sq_sum is None else layers.sums([sq_sum, s])
        global_norm = layers.sqrt(sq_sum)
        clip_var = layers.fill_constant([1], "float32", clip_attr.clip_norm)
        scale_factor = layers.elementwise_div(
            clip_var,
            layers.elementwise_max(global_norm, clip_var))
        for param, grad in pairs:
            scaled = layers.elementwise_mul(grad, scale_factor)
            result.append((param, _rebind(grad, scaled)))
    return result


class ErrorClipByValue:
    """Accepted for API parity; forward-activation error clipping is a
    no-op in whole-program AD (gradients flow through torch.autograd)."""

    def __init__(self, max, min=None):
        self.max, self.min = max, min
