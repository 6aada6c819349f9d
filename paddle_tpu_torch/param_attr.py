"""ParamAttr: per-parameter configuration.

reference: python/paddle/fluid/param_attr.py — name, initializer,
learning_rate, regularizer, trainable, gradient_clip.
"""

from __future__ import annotations

from typing import Optional


class ParamAttr:
    def __init__(self, name: Optional[str] = None, initializer=None,
                 learning_rate: float = 1.0, regularizer=None,
                 trainable: bool = True, gradient_clip=None):
        self.name = name
        self.initializer = initializer
        self.learning_rate = learning_rate
        self.regularizer = regularizer
        self.trainable = trainable
        self.gradient_clip = gradient_clip

    @staticmethod
    def _to_attr(arg) -> Optional["ParamAttr"]:
        """Normalize the many accepted forms (None/str/initializer/ParamAttr/
        False) like the reference's ParamAttr._to_attr."""
        if arg is None:
            return ParamAttr()
        if arg is False:
            return None
        if isinstance(arg, ParamAttr):
            return arg
        if isinstance(arg, str):
            return ParamAttr(name=arg)
        # assume initializer object
        return ParamAttr(initializer=arg)


WeightNormParamAttr = ParamAttr  # placeholder for API parity
