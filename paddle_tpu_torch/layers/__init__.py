"""fluid.layers-equivalent namespace: the layers the ported slices build
(reference: python/paddle/fluid/layers/__init__.py)."""

from .io import data  # noqa: F401
from .learning_rate_scheduler import (cosine_decay,  # noqa: F401
                                      exponential_decay,
                                      inverse_time_decay, linear_lr_warmup,
                                      natural_exp_decay, noam_decay,
                                      piecewise_decay, polynomial_decay)
from .nn import (add_position_encoding_at, batched_gather,  # noqa: F401
                 clip, clip_by_norm, dropout, elementwise_add,
                 elementwise_div, elementwise_max, elementwise_mul,
                 elementwise_op, embedding, fc, flash_attention,
                 fused_vocab_softmax_ce, label_smooth, layer_norm, matmul,
                 one_hot, paged_attention, paged_kv_prefill_write, paged_kv_write,
                 reduce_sum, reshape, scale, softmax,
                 softmax_with_cross_entropy, squeeze, transpose, unsqueeze)
from .ops import sqrt  # noqa: F401
from .sequence import add_position_encoding, sequence_mask  # noqa: F401
from .tensor import argmax, cast, fill_constant, sums  # noqa: F401
