"""Input layers.

reference: python/paddle/fluid/layers/io.py — data (:?), py_reader (:633),
double_buffer (:1002).  A copy of paddle_tpu/layers/io.py `data`, which
declares a feed var.
"""

from __future__ import annotations

from ..core.program import default_main_program


def data(name, shape, dtype="float32", lod_level=0, append_batch_size=True,
         stop_gradient=True):
    """Declare a feed variable (reference layers/io.py data).

    append_batch_size=True prepends a dynamic batch dim (-1), matching
    fluid.  lod_level>0 declares a ragged sequence input: the DataFeeder
    pads it and produces a companion `<name>.seq_len` int32 var with true
    lengths (segment-based replacement for LoD, SURVEY.md §5.7).
    """
    block = default_main_program().global_block()
    full_shape = list(shape)
    if append_batch_size:
        full_shape = [-1] + full_shape
    if lod_level > 2:
        # validate BEFORE creating vars so a rejected call leaves the
        # program clean
        raise NotImplementedError(
            "lod_level > 2: the padded representation covers two "
            "nesting levels (reference models use at most 2)")
    var = block.create_var(name=name, shape=full_shape, dtype=dtype,
                           is_data=True, stop_gradient=stop_gradient,
                           lod_level=lod_level)
    if lod_level > 0:
        # lengths share the data var's batch dim (static when it is)
        block.create_var(name=f"{name}.seq_len", shape=[full_shape[0]],
                         dtype="int32", is_data=True, stop_gradient=True)
    if lod_level > 1:
        # nested sequences (reference LoD level 2, lod_tensor.h:58): a
        # second per-sub-sequence length table — data is padded
        # (B, S1, S2, ...), seq_len counts sub-sequences per row,
        # seq_len2[b, i] counts items in sub-sequence i
        block.create_var(name=f"{name}.seq_len2",
                         shape=[full_shape[0], full_shape[1]],
                         dtype="int32", is_data=True, stop_gradient=True)
    return var
