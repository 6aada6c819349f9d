"""fluid.layers-equivalent namespace (reference: python/paddle/fluid/
layers/__init__.py), name for name: the reference's star import of
layers/nn.py also brings that module's own imports (the initializers,
LayerHelper, ParamAttr, Variable, numpy, typing's names, its
`tensor_layers` alias and the `annotations` future flag), so they are
here too."""

from __future__ import annotations

from typing import List, Optional, Sequence  # noqa: F401

import numpy as np  # noqa: F401

from ..core.program import Variable  # noqa: F401
from ..initializer import Constant, Normal, Xavier  # noqa: F401
from ..layer_helper import LayerHelper  # noqa: F401
from ..param_attr import ParamAttr  # noqa: F401
from . import detection  # noqa: F401
from . import tensor as tensor_layers  # noqa: F401
from .io import data  # noqa: F401
from .learning_rate_scheduler import (cosine_decay,  # noqa: F401
                                      exponential_decay,
                                      inverse_time_decay, linear_lr_warmup,
                                      natural_exp_decay, noam_decay,
                                      piecewise_decay, polynomial_decay)
from .metric_op import accuracy, auc  # noqa: F401
from .nn import (add_position_encoding_at,  # noqa: F401
                 affine_channel, affine_grid, batch_norm, batched_gather, chunk_eval, clip, clip_by_norm,
                 conv2d, conv2d_transpose, conv3d, conv3d_transpose,
                 conv_shift, cos_sim, crf_decoding, crop, cross_entropy,
                 ctc_greedy_decoder, cumsum, dropout, edit_distance,
                 elementwise_add, elementwise_div, elementwise_floordiv,
                 elementwise_max, elementwise_min, elementwise_mod,
                 elementwise_mul, elementwise_op, elementwise_pow,
                 elementwise_sub, embedding, expand, fc, flash_attention,
                 flatten, fused_vocab_softmax_ce, gather, gaussian_random,
                 greater_equal, grid_sampler, group_norm, hsigmoid,
                 huber_loss, image_resize, kldiv_loss, l2_normalize,
                 label_smooth, layer_norm, linear_chain_crf, log_loss, lrn,
                 matmul, maxout, mean, mean_iou, modified_huber_loss, mul,
                 nce, normalize_dtype, one_hot, pad, pad2d,
                 pad_constant_like, paged_attention, paged_kv_prefill_write,
                 paged_kv_write, pool2d, pool3d, positive_negative_pair,
                 prelu, Print, psroi_pool, py_func, random_crop,
                 reduce_all, reduce_any,
                 reduce_max, reduce_mean, reduce_min, reduce_prod,
                 reduce_sum, reshape, resize_bilinear, resize_nearest,
                 roi_align, roi_pool, sampling_id, scale, scatter, shape,
                 sigmoid_cross_entropy_with_logits, similarity_focus,
                 slice, smooth_l1, softmax, softmax_with_cross_entropy,
                 space_to_depth, speculative_accept, spp, split, square_error_cost, squeeze,
                 stack, switch_moe, teacher_student_sigmoid_loss, topk,
                 transpose, uniform_random, uniform_random_batch_size_like,
                 unpool, unsqueeze, unstack, warpctc)
from .ops import (abs, brelu, ceil, cos, elu, exp, floor,  # noqa: F401
                  gelu, hard_shrink, hard_sigmoid, leaky_relu, log,
                  log_softmax, logsigmoid, pow, reciprocal, relu, relu6,
                  round, rsqrt, selu, sigmoid, sign, sin, soft_relu,
                  softplus, softshrink, softsign, sqrt, square, stanh,
                  swish, tanh, tanh_shrink, thresholded_relu)
from .sequence import (add_position_encoding,  # noqa: F401
                       dynamic_gru, dynamic_lstm, dynamic_lstmp, gru_unit,
                       im2sequence, lod_reset, lstm_unit, row_conv,
                       seq_len2_var, seq_len_var, sequence_concat,
                       sequence_conv, sequence_enumerate, sequence_erase,
                       sequence_expand, sequence_expand_as,
                       sequence_first_step, sequence_last_step,
                       sequence_mask, sequence_pad, sequence_pool,
                       sequence_reverse, sequence_slice, sequence_softmax,
                       sequence_unpad)
from .tensor import (argmax, argmin, argsort, assign,  # noqa: F401
                     cast, concat, create_global_var, create_tensor,
                     fill_constant, fill_constant_batch_size_like,
                     increment, isfinite, ones, range, reverse, sums,
                     where, zeros, zeros_like)
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
