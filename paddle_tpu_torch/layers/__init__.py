"""fluid.layers-equivalent namespace: the layers the ported slice builds
(reference: python/paddle/fluid/layers/__init__.py)."""

from .io import data  # noqa: F401
from .nn import (add_position_encoding_at, batched_gather,  # noqa: F401
                 elementwise_add, elementwise_op, embedding, fc,
                 flash_attention, layer_norm, paged_attention,
                 paged_kv_prefill_write, paged_kv_write, scale, squeeze,
                 unsqueeze)
from .sequence import add_position_encoding, sequence_mask  # noqa: F401
from .tensor import argmax, cast, fill_constant  # noqa: F401
