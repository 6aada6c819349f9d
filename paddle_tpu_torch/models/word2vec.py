"""Word2vec (an N-gram language model trained with NCE) — the book's
word2vec model: the port of paddle_tpu/models/word2vec.py.

reference: python/paddle/fluid/tests/book/test_word2vec.py (the N-gram
language model) and the NCE usage of nce_op.cc.  Context words embed and
concatenate, a hidden layer predicts the next word, trained with NCE
sampling (one shared negative set a batch, drawn from the nce op's own
generator) or with the full softmax-CE.  The same builder, so
`Program.to_dict()` of a build equals the reference's."""

from __future__ import annotations

import numpy as np

from .. import layers, optimizer
from ..param_attr import ParamAttr


def build_model(dict_size=1000, embed_dim=32, hidden_dim=64,
                window=4, batch_size=32, use_nce=True,
                neg_samples=16, learning_rate=1e-2, with_optimizer=True):
    """N-gram LM: `window` context ids → next word.  Returns
    {loss, feeds}."""
    words = layers.data("context_words", shape=[batch_size, window],
                        dtype="int64", append_batch_size=False)
    target = layers.data("target_word", shape=[batch_size, 1],
                         dtype="int64", append_batch_size=False)

    emb = layers.embedding(
        words, size=[dict_size, embed_dim],
        param_attr=ParamAttr(name="w2v_emb"))          # (B, W, E)
    concat = layers.reshape(emb, shape=[batch_size, window * embed_dim])
    hidden = layers.fc(concat, size=hidden_dim, act="sigmoid")

    if use_nce:
        cost = layers.nce(hidden, target, num_total_classes=dict_size,
                          num_neg_samples=neg_samples,
                          sampler="log_uniform",
                          param_attr=ParamAttr(name="w2v_nce.w"))
        loss = layers.reduce_mean(cost)
    else:
        logits = layers.fc(hidden, size=dict_size)
        loss = layers.reduce_mean(
            layers.softmax_with_cross_entropy(logits, target))

    if with_optimizer:
        optimizer.AdamOptimizer(learning_rate=learning_rate).minimize(loss)
    return {"loss": loss, "feeds": ["context_words", "target_word"]}


def make_fake_batch(batch_size=32, dict_size=1000, window=4, seed=0):
    """Synthetic corpus with learnable structure: the target is a
    deterministic function of the context (zero-egress stand-in for the
    imikolov dataset)."""
    rng = np.random.RandomState(seed)
    ctx = rng.randint(0, dict_size, (batch_size, window)).astype(np.int64)
    tgt = (ctx.sum(axis=1, keepdims=True) % dict_size).astype(np.int64)
    return {"context_words": ctx, "target_word": tgt}
