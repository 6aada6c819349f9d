"""Sequence layer functions: the subset of paddle_tpu/layers/sequence.py
the ported slice builds (reference: python/paddle/fluid/layers/nn.py
sequence_* family).  Ragged inputs are padded (N, T, ...) vars with a
companion `<name>.seq_len` var; these wrappers wire the companion through
ops and propagate it to outputs that stay sequences.
"""

from __future__ import annotations

from ..core.program import Variable, default_main_program
from ..layer_helper import LayerHelper


def seq_len_var(x: Variable):
    """The companion length var of a sequence variable, if any."""
    block = default_main_program().current_block()
    name = f"{x.name}.seq_len"
    return block.var(name) if block.has_var(name) else None


def _propagate_seq_len(src: Variable, dst: Variable):
    sl = seq_len_var(src)
    if sl is None:
        return
    block = default_main_program().current_block()
    new = block.create_var(name=f"{dst.name}.seq_len", shape=sl.shape,
                           dtype=sl.dtype, stop_gradient=True)
    block.append_op(type="assign", inputs={"X": [sl]},
                    outputs={"Out": [new]})


def _require_level1(x: Variable, api: str):
    """Layer-level rejection for APIs without nested (lod_level=2)
    support — fails loudly at graph-build time instead of running
    level-1 semantics on the sub-sequence axis (only sequence_pool
    removes a nesting level)."""
    if seq_len2_var(x) is not None:
        raise NotImplementedError(
            f"{api} does not support nested (lod_level=2) inputs; pool "
            f"the inner level first (sequence_pool)")


def seq_len2_var(x: Variable):
    """The level-2 (nested) length companion, if any (lod_level=2
    inputs: data padded (B, S1, S2, ...) with seq_len (B,) counting
    sub-sequences and seq_len2 (B, S1) counting their items)."""
    block = default_main_program().current_block()
    name = f"{x.name}.seq_len2"
    return block.var(name) if block.has_var(name) else None


# ---------------------------------------------------------------------------
# RNNs
# ---------------------------------------------------------------------------


def sequence_mask(x, maxlen=None, dtype="int64", name=None):
    helper = LayerHelper("sequence_mask", name=name)
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op(type="sequence_mask", inputs={"X": [x]},
                     outputs={"Y": [out]},
                     attrs={"maxlen": maxlen if maxlen else -1,
                            "out_dtype": dtype})
    return out


def add_position_encoding(input, alpha=1.0, beta=1.0, name=None):
    _require_level1(input, "add_position_encoding")
    helper = LayerHelper("add_position_encoding", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(type="add_position_encoding", inputs={"X": [input]},
                     outputs={"Out": [out]},
                     attrs={"alpha": alpha, "beta": beta})
    _propagate_seq_len(input, out)
    return out
