"""Composite network helpers: the port of paddle_tpu/nets.py whole —
`simple_img_conv_pool`, `img_conv_group`, `sequence_conv_pool`, `glu`
and `scaled_dot_product_attention` (reference:
python/paddle/fluid/nets.py)."""

from __future__ import annotations

from . import layers


def simple_img_conv_pool(input, num_filters, filter_size, pool_size,
                         pool_stride, pool_padding=0, pool_type="max",
                         global_pooling=False, conv_stride=1, conv_padding=0,
                         conv_dilation=1, conv_groups=1, param_attr=None,
                         bias_attr=None, act=None, use_cudnn=True):
    conv_out = layers.conv2d(
        input=input, num_filters=num_filters, filter_size=filter_size,
        stride=conv_stride, padding=conv_padding, dilation=conv_dilation,
        groups=conv_groups, param_attr=param_attr, bias_attr=bias_attr,
        act=act)
    return layers.pool2d(
        input=conv_out, pool_size=pool_size, pool_type=pool_type,
        pool_stride=pool_stride, pool_padding=pool_padding,
        global_pooling=global_pooling)


def img_conv_group(input, conv_num_filter, pool_size, conv_padding=1,
                   conv_filter_size=3, conv_act=None, param_attr=None,
                   conv_with_batchnorm=False, conv_batchnorm_drop_rate=0.0,
                   pool_stride=1, pool_type="max", use_cudnn=True):
    """VGG-style conv block stack (reference nets.py img_conv_group)."""
    tmp = input
    if not isinstance(conv_num_filter, (list, tuple)):
        raise TypeError("conv_num_filter must be a list or tuple")

    def _ext(v):
        if not hasattr(v, "__len__"):
            return [v] * len(conv_num_filter)
        return list(v)

    conv_padding = _ext(conv_padding)
    conv_filter_size = _ext(conv_filter_size)
    param_attr = _ext(param_attr)
    conv_with_batchnorm = _ext(conv_with_batchnorm)
    conv_batchnorm_drop_rate = _ext(conv_batchnorm_drop_rate)

    for i in range(len(conv_num_filter)):
        local_conv_act = conv_act
        if conv_with_batchnorm[i]:
            local_conv_act = None
        tmp = layers.conv2d(
            input=tmp, num_filters=conv_num_filter[i],
            filter_size=conv_filter_size[i], padding=conv_padding[i],
            param_attr=param_attr[i], act=local_conv_act)
        if conv_with_batchnorm[i]:
            tmp = layers.batch_norm(input=tmp, act=conv_act)
            drop_rate = conv_batchnorm_drop_rate[i]
            if abs(drop_rate) > 1e-5:
                tmp = layers.dropout(x=tmp, dropout_prob=drop_rate)
    return layers.pool2d(input=tmp, pool_size=pool_size,
                         pool_type=pool_type, pool_stride=pool_stride)


def sequence_conv_pool(input, num_filters, filter_size, param_attr=None,
                       act="sigmoid", pool_type="max"):
    conv_out = layers.sequence_conv(input=input, num_filters=num_filters,
                                    filter_size=filter_size,
                                    param_attr=param_attr, act=act)
    return layers.sequence_pool(input=conv_out, pool_type=pool_type)


def glu(input, dim=-1):
    a, b = layers.split(input, num_or_sections=2, dim=dim)
    return layers.elementwise_mul(a, layers.sigmoid(b))


def scaled_dot_product_attention(queries, keys, values, num_heads=1,
                                 dropout_rate=0.0):
    """Multi-head scaled dot-product attention (reference nets.py
    scaled_dot_product_attention) over (N, T, D) tensors."""
    head_dim = queries.shape[-1] // num_heads

    def _split_heads(x):
        # (N, T, D) -> (N, H, T, D/H)
        n, t = x.shape[0], x.shape[1]
        r = layers.reshape(x, shape=[0 if n == -1 else n, t, num_heads,
                                     head_dim])
        return layers.transpose(r, perm=[0, 2, 1, 3])

    q = _split_heads(queries)
    k = _split_heads(keys)
    v = _split_heads(values)
    product = layers.matmul(q, k, transpose_y=True,
                            alpha=head_dim ** -0.5)
    weights = layers.softmax(product)
    if dropout_rate:
        weights = layers.dropout(weights, dropout_prob=dropout_rate)
    ctx = layers.matmul(weights, v)
    ctx = layers.transpose(ctx, perm=[0, 2, 1, 3])
    n, t = queries.shape[0], queries.shape[1]
    return layers.reshape(ctx, shape=[0 if n == -1 else n, t,
                                      num_heads * head_dim])
