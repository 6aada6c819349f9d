"""DeepFM CTR model, the high-dimensional sparse-embedding config: the
port of paddle_tpu/models/deepfm.py.

26 id fields and 13 dense features; a first-order table (vocab x 1) and
an FM embedding table (vocab x 16), both `is_sparse=True`, so their
gradients take the Executor's SparseGrad path and Adam updates only the
rows a batch touches; the FM second-order term 0.5 * ((sum v)^2 -
sum v^2); a 400 x 3 ReLU DNN over the flattened embeddings and the dense
features; sigmoid cross-entropy, and a streaming AUC over persistable
histograms.  The same build function, so `Program.to_dict()` of a
build equals the reference's; `make_fake_batch` draws the reference's
numpy batch with the same RandomState calls.
"""

from __future__ import annotations

import numpy as np

from .. import layers, optimizer
from ..initializer import Normal, Uniform
from ..param_attr import ParamAttr


def build_model(num_fields=26, num_dense=13, vocab_size=1000001,
                embedding_dim=16, dnn_hidden=(400, 400, 400),
                learning_rate=1e-3, with_optimizer=True):
    sparse_ids = layers.data(name="sparse_ids", shape=[num_fields],
                             dtype="int64")
    dense_vals = layers.data(name="dense_vals", shape=[num_dense],
                             dtype="float32")
    label = layers.data(name="label", shape=[1], dtype="int64")

    # first order: a scalar weight per id
    w1 = layers.embedding(sparse_ids, size=[vocab_size, 1], is_sparse=True,
                          param_attr=ParamAttr(name="fm_w1",
                                               initializer=Normal(0, 1e-3)))
    first_order = layers.reduce_sum(layers.squeeze(w1, axes=[2]), dim=1,
                                    keep_dim=True)
    dense_w = layers.fc(dense_vals, size=1, bias_attr=False)
    first_order = layers.elementwise_add(first_order, dense_w)

    # second-order FM: 0.5 * ((sum v)^2 - sum v^2)
    emb = layers.embedding(
        sparse_ids, size=[vocab_size, embedding_dim], is_sparse=True,
        param_attr=ParamAttr(
            name="fm_emb",
            initializer=Uniform(-1.0 / embedding_dim ** 0.5,
                                1.0 / embedding_dim ** 0.5)))
    sum_emb = layers.reduce_sum(emb, dim=1)          # (N, D)
    sum_sq = layers.square(sum_emb)
    sq_emb = layers.square(emb)
    sq_sum = layers.reduce_sum(sq_emb, dim=1)
    second_order = layers.scale(
        layers.reduce_sum(layers.elementwise_sub(sum_sq, sq_sum), dim=1,
                          keep_dim=True), scale=0.5)

    # deep component
    deep = layers.reshape(emb, shape=[0, num_fields * embedding_dim])
    deep = layers.concat([deep, dense_vals], axis=1)
    for h in dnn_hidden:
        deep = layers.fc(deep, size=h, act="relu")
    deep_out = layers.fc(deep, size=1, bias_attr=False)

    logit = layers.elementwise_add(
        layers.elementwise_add(first_order, second_order), deep_out)
    flabel = layers.cast(label, "float32")
    loss = layers.mean(
        layers.sigmoid_cross_entropy_with_logits(logit, flabel))
    prob = layers.sigmoid(logit)
    prob2 = layers.concat([layers.elementwise_sub(
        layers.fill_constant_batch_size_like(prob, [-1, 1], "float32", 1.0),
        prob), prob], axis=1)
    auc_out, _stats = layers.auc(prob2, label)
    if with_optimizer:
        opt = optimizer.AdamOptimizer(learning_rate=learning_rate)
        opt.minimize(loss)
    return {"loss": loss, "auc": auc_out,
            "feeds": ["sparse_ids", "dense_vals", "label"]}


def make_fake_batch(batch_size, num_fields=26, num_dense=13,
                    vocab_size=1000001, seed=0):
    """The reference's batch: the same numpy RandomState calls in the
    same order."""
    rng = np.random.RandomState(seed)
    return {
        "sparse_ids": rng.randint(0, vocab_size,
                                  (batch_size, num_fields)).astype(np.int64),
        "dense_vals": rng.rand(batch_size, num_dense).astype(np.float32),
        "label": rng.randint(0, 2, (batch_size, 1)).astype(np.int64),
    }
