"""VGG-16 with batch norm and dropout: the port of
paddle_tpu/models/vgg.py (reference: benchmark/fluid/models/vgg.py),
built from `nets.img_conv_group`; Adam.  The same build functions, so
`Program.to_dict()` of a build equals the reference's."""

from __future__ import annotations

from .. import layers, nets, optimizer


def vgg16_bn_drop(input):
    def conv_block(inp, num_filter, groups, dropouts):
        return nets.img_conv_group(
            input=inp, pool_size=2, pool_stride=2,
            conv_num_filter=[num_filter] * groups, conv_filter_size=3,
            conv_act="relu", conv_with_batchnorm=True,
            conv_batchnorm_drop_rate=dropouts, pool_type="max")

    conv1 = conv_block(input, 64, 2, [0.3, 0])
    conv2 = conv_block(conv1, 128, 2, [0.4, 0])
    conv3 = conv_block(conv2, 256, 3, [0.4, 0.4, 0])
    conv4 = conv_block(conv3, 512, 3, [0.4, 0.4, 0])
    conv5 = conv_block(conv4, 512, 3, [0.4, 0.4, 0])

    drop = layers.dropout(x=conv5, dropout_prob=0.5)
    fc1 = layers.fc(input=drop, size=512, act=None)
    bn = layers.batch_norm(input=fc1, act="relu")
    drop2 = layers.dropout(x=bn, dropout_prob=0.5)
    return layers.fc(input=drop2, size=512, act=None)


def build_model(dataset="cifar10", class_dim=10, learning_rate=1e-3,
                with_optimizer=True):
    dshape = [3, 32, 32] if dataset == "cifar10" else [3, 224, 224]
    if dataset == "flowers":
        class_dim = 102
    images = layers.data(name="data", shape=dshape, dtype="float32")
    label = layers.data(name="label", shape=[1], dtype="int64")
    net = vgg16_bn_drop(images)
    predict = layers.fc(input=net, size=class_dim, act="softmax")
    cost = layers.cross_entropy(input=predict, label=label)
    avg_cost = layers.mean(x=cost)
    batch_acc = layers.accuracy(input=predict, label=label)
    if with_optimizer:
        opt = optimizer.AdamOptimizer(learning_rate=learning_rate)
        opt.minimize(avg_cost)
    return {"loss": avg_cost, "accuracy": batch_acc,
            "feeds": ["data", "label"], "predict": predict}
