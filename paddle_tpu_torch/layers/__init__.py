"""fluid.layers-equivalent namespace: the layers the ported slices build
(reference: python/paddle/fluid/layers/__init__.py)."""

from .io import data  # noqa: F401
from .learning_rate_scheduler import (cosine_decay,  # noqa: F401
                                      exponential_decay,
                                      inverse_time_decay, linear_lr_warmup,
                                      natural_exp_decay, noam_decay,
                                      piecewise_decay, polynomial_decay)
from .metric_op import accuracy, auc  # noqa: F401
from .nn import (add_position_encoding_at, batch_norm,  # noqa: F401
                 batched_gather, clip, clip_by_norm, conv2d, crf_decoding,
                 cross_entropy, dropout, elementwise_add, elementwise_div,
                 elementwise_floordiv, elementwise_max, elementwise_mul,
                 elementwise_op, elementwise_sub, embedding, expand, fc,
                 flash_attention, fused_vocab_softmax_ce, gather,
                 l2_normalize, label_smooth, layer_norm, linear_chain_crf,
                 matmul, mean, nce, one_hot, paged_attention,
                 paged_kv_prefill_write, paged_kv_write, pool2d, reduce_all,
                 reduce_any, reduce_mean, reduce_sum, reshape, scale,
                 sigmoid_cross_entropy_with_logits, slice, softmax,
                 softmax_with_cross_entropy, speculative_accept, split,
                 square_error_cost, squeeze, topk, transpose, unsqueeze)
from .ops import gelu, log, sigmoid, sqrt, square, tanh  # noqa: F401
from .sequence import (add_position_encoding, dynamic_gru,  # noqa: F401
                       dynamic_lstm, dynamic_lstmp, gru_unit, lstm_unit,
                       seq_len2_var, seq_len_var, sequence_conv,
                       sequence_first_step, sequence_last_step,
                       sequence_mask, sequence_pool)
from .tensor import (argmax, assign, cast, concat,  # noqa: F401
                     fill_constant, fill_constant_batch_size_like,
                     increment, range, sums, where)
# control_flow after the other imports: its comparison and logical layers
# (the cond=/out= forms While needs) are the namespace's, as in the
# reference
from .control_flow import (DynamicRNN, IfElse, StaticRNN,  # noqa: F401
                           Switch, While, array_length, array_read,
                           array_to_tensor, array_write, beam_search,
                           beam_search_decode, create_array, equal,
                           greater_than, is_empty, less_equal, less_than,
                           lod_rank_table, logical_and, logical_not,
                           logical_or, logical_xor, max_sequence_len,
                           not_equal, reorder_lod_tensor_by_rank,
                           tensor_array_to_tensor)
