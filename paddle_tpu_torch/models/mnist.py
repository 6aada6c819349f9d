"""The MNIST CNN: the port of paddle_tpu/models/mnist.py (reference:
benchmark/fluid/models/mnist.py cnn_model): two
`nets.simple_img_conv_pool` blocks and a softmax classifier, Adam.  The
same build functions, so `Program.to_dict()` of a build equals the
reference's."""

from __future__ import annotations

from .. import layers, nets, optimizer


def cnn_model(data):
    conv_pool_1 = nets.simple_img_conv_pool(
        input=data, filter_size=5, num_filters=20, pool_size=2,
        pool_stride=2, act="relu")
    conv_pool_2 = nets.simple_img_conv_pool(
        input=conv_pool_1, filter_size=5, num_filters=50, pool_size=2,
        pool_stride=2, act="relu")
    return layers.fc(input=conv_pool_2, size=10, act="softmax")


def build_model(learning_rate=0.001, with_optimizer=True):
    images = layers.data(name="pixel", shape=[1, 28, 28], dtype="float32")
    label = layers.data(name="label", shape=[1], dtype="int64")
    predict = cnn_model(images)
    cost = layers.cross_entropy(input=predict, label=label)
    avg_cost = layers.mean(x=cost)
    batch_acc = layers.accuracy(input=predict, label=label)
    if with_optimizer:
        opt = optimizer.AdamOptimizer(learning_rate=learning_rate,
                                      beta1=0.9, beta2=0.999)
        opt.minimize(avg_cost)
    return {"loss": avg_cost, "accuracy": batch_acc,
            "feeds": ["pixel", "label"], "predict": predict}
