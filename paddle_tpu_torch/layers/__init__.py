"""fluid.layers-equivalent namespace: the layers the ported slices build
(reference: python/paddle/fluid/layers/__init__.py)."""

from .control_flow import less_equal  # noqa: F401
from .io import data  # noqa: F401
from .learning_rate_scheduler import (cosine_decay,  # noqa: F401
                                      exponential_decay,
                                      inverse_time_decay, linear_lr_warmup,
                                      natural_exp_decay, noam_decay,
                                      piecewise_decay, polynomial_decay)
from .metric_op import accuracy, auc  # noqa: F401
from .nn import (add_position_encoding_at, batch_norm,  # noqa: F401
                 batched_gather, clip, clip_by_norm, conv2d, cross_entropy,
                 dropout, elementwise_add, elementwise_div, elementwise_max,
                 elementwise_mul, elementwise_op, elementwise_sub, embedding,
                 fc, flash_attention, fused_vocab_softmax_ce, label_smooth,
                 layer_norm, matmul, mean, one_hot, paged_attention,
                 paged_kv_prefill_write, paged_kv_write, pool2d, reduce_mean,
                 reduce_sum, reshape, scale, sigmoid_cross_entropy_with_logits,
                 slice, softmax, softmax_with_cross_entropy,
                 speculative_accept, squeeze, topk,
                 transpose, unsqueeze)
from .ops import gelu, sigmoid, sqrt, square, tanh  # noqa: F401
from .sequence import (add_position_encoding, dynamic_gru,  # noqa: F401
                       dynamic_lstm, dynamic_lstmp, gru_unit, lstm_unit,
                       sequence_first_step, sequence_last_step,
                       sequence_mask, sequence_pool)
from .tensor import (argmax, cast, concat, fill_constant,  # noqa: F401
                     fill_constant_batch_size_like, range, sums)
