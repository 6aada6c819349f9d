"""SE-ResNeXt-50: the port of paddle_tpu/models/se_resnext.py
(reference: benchmark/fluid/models/se_resnext.py): grouped 3x3 convs
(cardinality 32), squeeze-and-excitation on every block, dropout 0.5
before the classifier, momentum 0.9 under an optional piecewise_decay.
The same build functions, so `Program.to_dict()` of a build equals the
reference's."""

from __future__ import annotations

from .. import layers, optimizer


def conv_bn_layer(input, num_filters, filter_size, stride=1, groups=1,
                  act=None):
    conv = layers.conv2d(input=input, num_filters=num_filters,
                         filter_size=filter_size, stride=stride,
                         padding=(filter_size - 1) // 2, groups=groups,
                         act=None, bias_attr=False)
    return layers.batch_norm(input=conv, act=act)


def squeeze_excitation(input, num_channels, reduction_ratio):
    pool = layers.pool2d(input=input, pool_type="avg", global_pooling=True)
    squeeze = layers.fc(input=pool, size=num_channels // reduction_ratio,
                        act="relu")
    excitation = layers.fc(input=squeeze, size=num_channels, act="sigmoid")
    return layers.elementwise_mul(x=input, y=excitation, axis=0)


def shortcut(input, ch_out, stride):
    ch_in = input.shape[1]
    if ch_in != ch_out:
        return conv_bn_layer(input, ch_out, 1, stride)
    return input


def bottleneck_block(input, num_filters, stride, cardinality,
                     reduction_ratio):
    conv0 = conv_bn_layer(input=input, num_filters=num_filters,
                          filter_size=1, act="relu")
    conv1 = conv_bn_layer(input=conv0, num_filters=num_filters,
                          filter_size=3, stride=stride, groups=cardinality,
                          act="relu")
    conv2 = conv_bn_layer(input=conv1, num_filters=num_filters * 2,
                          filter_size=1, act=None)
    scale = squeeze_excitation(conv2, num_channels=num_filters * 2,
                               reduction_ratio=reduction_ratio)
    short = shortcut(input, num_filters * 2, stride)
    return layers.elementwise_add(x=short, y=scale, act="relu")


def se_resnext(input, class_dim=1000, infer=False, layers_cfg=50):
    supported = {
        50: ([3, 4, 6, 3], [128, 256, 512, 1024]),
        152: ([3, 8, 36, 3], [128, 256, 512, 1024]),
    }
    depth, num_filters = supported[layers_cfg]
    cardinality = 32
    reduction_ratio = 16

    conv = conv_bn_layer(input=input, num_filters=64, filter_size=7,
                         stride=2, act="relu")
    conv = layers.pool2d(input=conv, pool_size=3, pool_stride=2,
                         pool_padding=1, pool_type="max")
    for block in range(len(depth)):
        for i in range(depth[block]):
            conv = bottleneck_block(
                input=conv, num_filters=num_filters[block],
                stride=2 if i == 0 and block != 0 else 1,
                cardinality=cardinality, reduction_ratio=reduction_ratio)
    pool = layers.pool2d(input=conv, pool_type="avg", global_pooling=True)
    if not infer:
        pool = layers.dropout(x=pool, dropout_prob=0.5)
    return layers.fc(input=pool, size=class_dim, act="softmax")


def build_model(class_dim=1000, learning_rate=0.1, with_optimizer=True,
                lr_boundaries=None, lr_values=None):
    input = layers.data(name="data", shape=[3, 224, 224], dtype="float32")
    label = layers.data(name="label", shape=[1], dtype="int64")
    out = se_resnext(input, class_dim)
    cost = layers.cross_entropy(input=out, label=label)
    avg_cost = layers.mean(x=cost)
    acc = layers.accuracy(input=out, label=label)
    if with_optimizer:
        if lr_boundaries:
            lr = layers.piecewise_decay(boundaries=lr_boundaries,
                                        values=lr_values)
        else:
            lr = learning_rate
        opt = optimizer.MomentumOptimizer(learning_rate=lr, momentum=0.9)
        opt.minimize(avg_cost)
    return {"loss": avg_cost, "accuracy": acc, "feeds": ["data", "label"]}
