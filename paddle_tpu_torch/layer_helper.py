"""LayerHelper: shared plumbing for layer functions.

reference: python/paddle/fluid/layer_helper.py — parameter creation with
initializers/regularizers, dtype inference, activation append.
"""

from __future__ import annotations

from typing import Optional

from .core import unique_name
from .core.program import (Parameter, Program, Variable,
                           default_main_program, default_startup_program)
from .initializer import Constant, Xavier
from .param_attr import ParamAttr


class LayerHelper:
    def __init__(self, layer_type: str, **kwargs):
        self.kwargs = kwargs
        self.layer_type = layer_type
        name = kwargs.get("name")
        self.name = name if name else unique_name.generate(layer_type)

    @property
    def main_program(self) -> Program:
        return default_main_program()

    @property
    def startup_program(self) -> Program:
        return default_startup_program()

    # -- inputs ----------------------------------------------------------
    def input(self, input_param_name: str = "input"):
        inputs = self.kwargs.get(input_param_name)
        if isinstance(inputs, (list, tuple)):
            return list(inputs)
        return inputs

    def input_dtype(self, input_param_name: str = "input") -> str:
        inputs = self.input(input_param_name)
        if isinstance(inputs, list):
            return inputs[0].dtype
        return inputs.dtype

    # -- var/param creation ----------------------------------------------
    def create_parameter(self, attr, shape, dtype, is_bias: bool = False,
                         default_initializer=None) -> Optional[Parameter]:
        attr = ParamAttr._to_attr(attr)
        if attr is None:
            return None
        suffix = "b" if is_bias else "w"
        name = attr.name or unique_name.generate(f"{self.name}.{suffix}")
        if default_initializer is None:
            default_initializer = Constant(0.0) if is_bias else Xavier()
        init = attr.initializer or default_initializer

        main_block = self.main_program.global_block()
        if main_block.has_var(name):
            if not attr.name:
                raise ValueError(f"parameter {name!r} already exists")
            # fluid parameter sharing: an EXPLICITLY named ParamAttr
            # reuses the existing parameter (the reference book models
            # share embeddings this way — test_label_semantic_roles.py
            # binds 6 features to one 'emb' table); generated names
            # colliding is still a bug and still raises
            existing = main_block.var(name)
            if not isinstance(existing, Parameter):
                raise ValueError(
                    f"name {name!r} already belongs to a non-parameter "
                    f"variable; cannot share it as a layer weight")
            if (tuple(existing.shape) != tuple(shape)
                    or str(existing.dtype) != str(dtype)):
                raise ValueError(
                    f"shared parameter {name!r} re-declared with "
                    f"mismatched shape/dtype: existing "
                    f"{existing.shape}/{existing.dtype} vs requested "
                    f"{tuple(shape)}/{dtype}")
            # a second declaration cannot re-configure the parameter —
            # silently dropping its attrs would make hyperparameter
            # edits on the later site no-ops
            if attr.learning_rate != getattr(existing, "learning_rate",
                                             attr.learning_rate):
                raise ValueError(
                    f"shared parameter {name!r} re-declared with a "
                    f"different learning_rate "
                    f"({existing.learning_rate} vs "
                    f"{attr.learning_rate}); attrs bind at the FIRST "
                    f"declaration")
            if attr.initializer is not None or attr.regularizer is not None:
                raise ValueError(
                    f"shared parameter {name!r}: initializer/"
                    f"regularizer on a re-declaration cannot apply — "
                    f"set them where the parameter is first declared")
            return existing
        param = main_block.create_parameter(
            name, shape, dtype,
            regularizer=attr.regularizer,
            gradient_clip_attr=attr.gradient_clip,
            learning_rate=attr.learning_rate,
            trainable=attr.trainable,
        )
        # Mirror into the startup program with its init op (fluid
        # layer_helper.py creates the startup var + initializer op).
        startup_block = self.startup_program.global_block()
        sp_var = startup_block.create_parameter(name, shape, dtype)
        init(sp_var, startup_block)
        return param

    def create_variable_for_type_inference(self, dtype) -> Variable:
        # Temporaries live in the *current* block so layers called inside
        # control-flow sub-blocks (While/StaticRNN bodies) stay local to
        # them; parameters always live in the global block, as in fluid.
        return self.main_program.current_block().create_var(
            name=unique_name.generate(f"{self.name}.tmp"),
            dtype=dtype,
        )

    create_tmp_variable = create_variable_for_type_inference

    def create_global_variable(self, shape, dtype, name=None,
                               persistable=False) -> Variable:
        return self.main_program.global_block().create_var(
            name=name or unique_name.generate(f"{self.name}.global"),
            shape=shape, dtype=dtype, persistable=persistable,
        )

    def create_or_get_global_variable(self, name, shape, dtype,
                                      persistable=True,
                                      initializer=None) -> Variable:
        """Persistable non-parameter state var (metric buffers, counters),
        mirrored into the startup program with its initializer."""
        block = self.main_program.global_block()
        if block.has_var(name):
            return block.var(name)
        var = block.create_var(name=name, shape=shape, dtype=dtype,
                               persistable=persistable, stop_gradient=True)
        startup_block = self.startup_program.global_block()
        if not startup_block.has_var(name):
            sp = startup_block.create_var(
                name=name, shape=shape, dtype=dtype, persistable=True,
                stop_gradient=True)
            (initializer or Constant(0.0))(sp, startup_block)
        return var

    # -- op appending -----------------------------------------------------
    def append_op(self, **kwargs):
        return self.main_program.current_block().append_op(**kwargs)

    def append_activation(self, input_var: Variable) -> Variable:
        act = self.kwargs.get("act")
        if act is None:
            return input_var
        if isinstance(act, str):
            act = {"type": act}
        act = dict(act)
        act_type = act.pop("type")
        out = self.create_variable_for_type_inference(input_var.dtype)
        self.append_op(type=act_type, inputs={"X": [input_var]},
                       outputs={"Out": [out]}, attrs=act)
        return out

    def append_bias_op(self, input_var: Variable, dim_start: int = 1,
                       bias_attr=None) -> Variable:
        attr = ParamAttr._to_attr(
            bias_attr if bias_attr is not None
            else self.kwargs.get("bias_attr"))
        if attr is None:
            return input_var
        size = input_var.shape[dim_start:]
        b = self.create_parameter(attr, shape=size,
                                  dtype=input_var.dtype, is_bias=True)
        out = self.create_variable_for_type_inference(input_var.dtype)
        self.append_op(type="elementwise_add",
                       inputs={"X": [input_var], "Y": [b]},
                       outputs={"Out": [out]}, attrs={"axis": dim_start})
        return out
