"""QuantizeTranspiler (the QAT program rewrite) and convert_to_int8 (the
int8 serving program): the port of paddle_tpu/quantize.py (reference:
python/paddle/fluid/contrib/quantize/quantize_transpiler.py).

The training rewrite puts the combined quantize-dequantize simulation op
in front of each input of a quantizable op (conv2d, depthwise_conv2d,
mul, matmul): weights on their dynamic abs-max, activations on a
moving-average scale held in a persistable `<name>.quant_scale_state`,
and rewires the consumer to the simulated tensor.  Gradients flow by the
straight-through estimator inside the op (ops/quantize.py), so no grad
op surgery is needed: run it before append_backward/minimize, as the
reference's training_transpile runs on the undifferentiated program.

`convert_to_int8` freezes the trained scales: each quantizable op whose
activation and weight both pass through simulation ops becomes
quantized_conv2d/quantized_matmul on an int8 weight (the scope entry and
the var desc become int8), and the simulation ops nothing reads anymore
are dropped.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from .core import unique_name
from .core.desc import OpDesc
from .core.program import (Operator, Program, default_main_program,
                           default_startup_program)
from .initializer import Constant

QUANTIZABLE_OPS = {"conv2d", "depthwise_conv2d", "mul", "matmul"}
# the slot holding the weight operand per op type (quantized on abs_max)
_WEIGHT_SLOTS = {"conv2d": "Filter", "depthwise_conv2d": "Filter",
                 "mul": "Y", "matmul": "Y"}
_QDQ_TYPES = {"fake_quantize_dequantize_abs_max",
              "fake_quantize_dequantize_moving_average_abs_max"}


class QuantizeTranspiler:
    def __init__(self, weight_bits: int = 8, activation_bits: int = 8,
                 activation_quantize_type: str = "moving_average_abs_max",
                 weight_quantize_type: str = "abs_max",
                 moving_rate: float = 0.9):
        if activation_quantize_type not in ("abs_max",
                                            "moving_average_abs_max"):
            raise ValueError(
                f"unsupported activation_quantize_type "
                f"{activation_quantize_type!r}")
        self.weight_bits = weight_bits
        self.activation_bits = activation_bits
        self.act_type = activation_quantize_type
        self.weight_type = weight_quantize_type
        self.moving_rate = moving_rate

    def training_transpile(self, program: Optional[Program] = None,
                           startup_program: Optional[Program] = None):
        program = program or default_main_program()
        if startup_program is None:
            # the moving-average state needs its init op somewhere: the
            # no-argument call uses the default startup program
            startup_program = default_startup_program()
        if program._backward_info is not None:
            raise RuntimeError(
                "QuantizeTranspiler must run before append_backward/"
                "minimize (the reference transpiles the forward program)")
        self._rewrite(program, startup_program, is_test=False)
        return program

    def inference_transpile(self, program: Optional[Program] = None):
        """Rewrite a test/inference program: the same graph with is_test
        scales (the moving-average state is read, not updated)."""
        program = program or default_main_program()
        self._rewrite(program, None, is_test=True)
        return program

    def _rewrite(self, program: Program, startup_program, is_test: bool):
        block = program.global_block()
        # (source var name, is_weight) -> simulated var name
        quantized: Dict[tuple, str] = {}
        new_ops = []
        for op in block.ops:
            if op.desc.type in QUANTIZABLE_OPS:
                weight_slot = _WEIGHT_SLOTS[op.desc.type]
                for slot, names in op.desc.inputs.items():
                    rewired = []
                    for name in names:
                        var = block.var(name)
                        is_weight = (slot == weight_slot
                                     or getattr(var, "trainable", False))
                        key = (name, is_weight)
                        if key not in quantized:
                            qname, q_ops = self._make_qdq(
                                block, startup_program, name, is_weight,
                                is_test)
                            new_ops.extend(q_ops)
                            quantized[key] = qname
                        rewired.append(quantized[key])
                    op.desc.inputs[slot] = rewired
            new_ops.append(op)
        block.ops = new_ops
        program._bump()

    def _make_qdq(self, block, startup_program, name: str, is_weight: bool,
                  is_test: bool):
        src = block.var(name)
        qvar = block.create_var(
            name=unique_name.generate(f"{name}.quantized"),
            shape=src.shape, dtype=src.dtype)
        bits = self.weight_bits if is_weight else self.activation_bits
        if not is_weight and self.act_type == "moving_average_abs_max":
            state_name = f"{name}.quant_scale_state"
            if not block.has_var(state_name):
                block.create_var(name=state_name, shape=(1,),
                                 dtype="float32", persistable=True,
                                 stop_gradient=True)
                if startup_program is not None:
                    sb = startup_program.global_block()
                    if not sb.has_var(state_name):
                        sp = sb.create_var(name=state_name, shape=(1,),
                                           dtype="float32",
                                           persistable=True,
                                           stop_gradient=True)
                        Constant(0.0)(sp, sb)
            desc = OpDesc(
                type="fake_quantize_dequantize_moving_average_abs_max",
                inputs={"X": [name], "InScale": [state_name]},
                outputs={"Out": [qvar.name], "OutScale": [state_name]},
                attrs={"bit_length": bits, "moving_rate": self.moving_rate,
                       "is_test": is_test})
        else:
            scale_out = block.create_var(
                name=unique_name.generate(f"{name}.scale"),
                shape=(1,), dtype="float32", stop_gradient=True)
            desc = OpDesc(
                type="fake_quantize_dequantize_abs_max",
                inputs={"X": [name]},
                outputs={"Out": [qvar.name], "OutScale": [scale_out.name]},
                attrs={"bit_length": bits})
        return qvar.name, [Operator(block, desc)]


# ---------------------------------------------------------------------------
# Post-training int8 conversion (serving)
# ---------------------------------------------------------------------------

def _wants_transpose(t, attrs):
    return bool(t == "matmul" and (attrs.get("transpose_Y")
                                   or attrs.get("transpose_y")))


def convert_to_int8(program: Program, scope=None):
    """Freeze trained QAT scales into a really quantized serving program.

    For every quantizable op whose activation and weight both pass
    through simulation ops:
    - the weight in `scope` becomes int8 on its trained abs-max grid
      (the var's dtype turns int8),
    - the op becomes quantized_conv2d/quantized_matmul with the frozen
      in/weight scales as attrs,
    - the simulation ops nothing reads anymore are dropped.

    A weight converts only if every op touching it can run the int8
    form with one stored orientation; a weight shared with a float
    consumer, a QDQ output read by another op, and the matmul variants
    quantized_matmul cannot express stay float.  Returns {op_index:
    (type, in_scale, weight_scale)} of the converted ops (empty when the
    program has no QAT pattern)."""
    from .core.executor import global_scope
    from .ops.quantize import quantize_codes

    scope = scope or global_scope()
    block = program.global_block()

    producers = {}
    for op in block.ops:
        for names in op.desc.outputs.values():
            for n in names:
                producers[n] = op

    def qdq_source_and_scale(name):
        """(source name, frozen scale) if `name` comes out of a
        simulation op, else None."""
        op = producers.get(name)
        if op is None or op.desc.type not in _QDQ_TYPES:
            return None
        src = op.desc.inputs["X"][0]
        if op.desc.type.endswith("moving_average_abs_max"):
            state = scope.find_var(op.desc.inputs["InScale"][0])
            if state is None:
                return None
            scale = float(torch.as_tensor(state).reshape(-1)[0])
            if scale <= 0:
                return None  # an untrained scale state
        else:
            val = scope.find_var(src)
            if val is None:
                return None
            scale = float(torch.as_tensor(val).abs().max())
        return src, scale

    # ---- pass 1: plan, without mutation
    plans = {}               # op index -> plan
    weight_users = {}        # weight -> [(index, convertible, transpose)]
    raw_weight_readers = {}  # weight -> number of non-QDQ ops reading it
    weight_qdq_outs = {}     # weight -> the QDQ outputs carrying it
    qdq_out_consumers = {}   # QDQ output -> the op indices reading it
    for idx, op in enumerate(block.ops):
        t = op.desc.type
        if t not in QUANTIZABLE_OPS:
            continue
        w_slot = _WEIGHT_SLOTS[t]
        a_slot = "Input" if t in ("conv2d", "depthwise_conv2d") else "X"
        act = qdq_source_and_scale(op.desc.inputs[a_slot][0])
        wgt = qdq_source_and_scale(op.desc.inputs[w_slot][0])
        if act is None or wgt is None:
            continue
        (act_src, in_scale), (w_src, w_scale) = act, wgt
        attrs = dict(op.desc.attrs)
        convertible = True
        if t == "matmul":
            # quantized_matmul has the mul flattening contract: the
            # matmul variants it cannot express stay in float QDQ form
            wv_shape = tuple(block.var(w_src).shape)
            if (attrs.get("transpose_X") or attrs.get("transpose_x")
                    or float(attrs.get("alpha", 1.0) or 1.0) != 1.0
                    or len(wv_shape) != 2):
                convertible = False
            else:
                act_rank = len(block.var(act_src).shape)
                attrs["x_num_col_dims"] = max(act_rank - 1, 1)
                attrs["y_num_col_dims"] = 1
        transpose = _wants_transpose(t, attrs)
        plans[idx] = dict(t=t, act_src=act_src, in_scale=in_scale,
                          w_src=w_src, w_scale=w_scale, attrs=attrs,
                          transpose=transpose)
        weight_users.setdefault(w_src, []).append(
            (idx, convertible, transpose))
        weight_qdq_outs.setdefault(w_src, set()).add(
            op.desc.inputs[w_slot][0])
    qdq_out_names = {n for outs in weight_qdq_outs.values() for n in outs}
    for idx, op in enumerate(block.ops):
        if op.desc.type in _QDQ_TYPES:
            continue
        for names in op.desc.inputs.values():
            for n in names:
                if n in weight_users:
                    raw_weight_readers[n] = \
                        raw_weight_readers.get(n, 0) + 1
                if n in qdq_out_names:
                    qdq_out_consumers.setdefault(n, set()).add(idx)

    ok_weights = {}
    for w_src, users in weight_users.items():
        transposes = {tr for _, _, tr in users}
        planned = {i for i, conv, _ in users if conv}
        # the weight's QDQ output must feed only convertible quantizable
        # ops: another consumer would read the kept QDQ op dequantizing
        # int8 codes as floats
        qdq_clean = all(
            qdq_out_consumers.get(n, set()) <= planned
            for n in weight_qdq_outs.get(w_src, ()))
        if (all(conv for _, conv, _ in users)
                and len(transposes) == 1
                and raw_weight_readers.get(w_src, 0) == 0
                and qdq_clean):
            ok_weights[w_src] = transposes.pop()

    # ---- pass 2: apply
    bits = 8
    qmax = float(2 ** (bits - 1) - 1)
    weight_done = set()
    converted = {}
    new_ops = []
    for idx, op in enumerate(block.ops):
        plan = plans.get(idx)
        if plan is None or plan["w_src"] not in ok_weights:
            new_ops.append(op)
            continue
        t, attrs, transpose = plan["t"], plan["attrs"], plan["transpose"]
        act_src, in_scale = plan["act_src"], plan["in_scale"]
        w_src, w_scale = plan["w_src"], plan["w_scale"]
        if w_src not in weight_done:
            wv = torch.as_tensor(scope.find_var(w_src)).to(torch.float32)
            if transpose:
                # the weight is static: the transpose is baked into the
                # stored int8 tensor
                wv = wv.t().contiguous()
                block.var(w_src).desc.shape = tuple(wv.shape)
            scope.set_var(w_src, quantize_codes(wv, w_scale, qmax).to(
                torch.int8))
            block.var(w_src).desc.dtype = "int8"
            weight_done.add(w_src)
        if transpose:
            attrs.pop("transpose_Y", None)
            attrs.pop("transpose_y", None)
        attrs.update({"in_scale": in_scale, "weight_scale": w_scale,
                      "bit_length": bits})
        if t in ("conv2d", "depthwise_conv2d"):
            if t == "depthwise_conv2d":
                # the float op takes groups = C_in when it runs
                # (ops/nn.py depthwise_conv2d): freeze it here
                c_axis = 3 if attrs.get("data_format") == "NHWC" else 1
                attrs["groups"] = int(block.var(act_src).shape[c_axis])
            new_type = "quantized_conv2d"
            inputs = {"Input": [act_src], "Filter": [w_src]}
            outputs = {"Output": op.desc.outputs["Output"]}
        else:
            new_type = "quantized_matmul"
            inputs = {"X": [act_src], "Y": [w_src]}
            outputs = {"Out": op.desc.outputs["Out"]}
        new_ops.append(Operator(block, OpDesc(
            type=new_type, inputs=inputs, outputs=outputs, attrs=attrs)))
        converted[idx] = (new_type, in_scale, w_scale)

    # drop the simulation ops whose outputs nothing reads anymore
    used = set()
    for op in new_ops:
        if op.desc.type not in _QDQ_TYPES:
            for names in op.desc.inputs.values():
                used.update(names)
    block.ops = [
        op for op in new_ops
        if op.desc.type not in _QDQ_TYPES
        or any(n in used for n in op.desc.outputs.get("Out", []))
    ]
    program._bump()
    return converted
