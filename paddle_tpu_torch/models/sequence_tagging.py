"""Semantic role labeling — the db_lstm sequence-tagging book model: the
port of paddle_tpu/models/sequence_tagging.py.

reference: python/paddle/fluid/tests/book/test_label_semantic_roles.py:53
(db_lstm) — 8 input features (word, 5 context windows, predicate, mark)
embedded and mixed, a `depth`-deep stack of alternating-direction
dynamic LSTMs with direct edges, a per-tag emission projection, and a
linear-chain CRF objective with crf_decoding inference.

The same builder, so `Program.to_dict()` of a build equals the
reference's.  Features are padded (B, T) int64 with one `.seq_len`
companion each instead of LoD.  db_lstm asks for a relu candidate and a
sigmoid cell activation, which the LSTM kernel does not take
(ops/kernels/lstm.py takes sigmoid/tanh/tanh only): its LSTMs run the
dynamic_lstm op's composed route, a per-step loop of torch ops, on the
card as on the CPU.
"""

from __future__ import annotations

import numpy as np

from .. import layers, optimizer
from ..param_attr import ParamAttr

FEATURES = ("word", "ctx_n2", "ctx_n1", "ctx_0", "ctx_p1", "ctx_p2")


def db_lstm(feats, predicate, mark, word_dict_len, label_dict_len,
            pred_dict_len, mark_dict_len=2, word_dim=32, mark_dim=5,
            hidden_dim=128, depth=4, emb_lr=2.0):
    """Emission scores (B, T, label_dict_len).  feats: list of the six
    word-feature vars in FEATURES order."""
    word_embs = [
        layers.embedding(
            x, size=[word_dict_len, word_dim],
            param_attr=ParamAttr(name="srl_word_emb",
                                 learning_rate=emb_lr))
        for x in feats
    ]
    pred_emb = layers.embedding(
        predicate, size=[pred_dict_len, word_dim],
        param_attr=ParamAttr(name="srl_vemb"))
    mark_emb = layers.embedding(mark, size=[mark_dict_len, mark_dim])
    emb_layers = word_embs + [pred_emb, mark_emb]

    hidden_0 = layers.sums([
        layers.fc(emb, size=hidden_dim * 4, num_flatten_dims=2)
        for emb in emb_layers
    ])
    lstm_0, _cell = layers.dynamic_lstm(
        hidden_0, size=hidden_dim * 4,
        candidate_activation="relu", gate_activation="sigmoid",
        cell_activation="sigmoid")

    # stack L-LSTM / R-LSTM with direct edges (reference depth loop)
    input_tmp = [hidden_0, lstm_0]
    for i in range(1, depth):
        mix_hidden = layers.sums([
            layers.fc(input_tmp[0], size=hidden_dim * 4,
                      num_flatten_dims=2),
            layers.fc(input_tmp[1], size=hidden_dim * 4,
                      num_flatten_dims=2),
        ])
        lstm, _cell = layers.dynamic_lstm(
            mix_hidden, size=hidden_dim * 4,
            candidate_activation="relu", gate_activation="sigmoid",
            cell_activation="sigmoid", is_reverse=((i % 2) == 1))
        input_tmp = [mix_hidden, lstm]

    return layers.sums([
        layers.fc(input_tmp[0], size=label_dict_len,
                  num_flatten_dims=2, act="tanh"),
        layers.fc(input_tmp[1], size=label_dict_len,
                  num_flatten_dims=2, act="tanh"),
    ])


def build_model(word_dict_len=200, label_dict_len=9, pred_dict_len=50,
                max_length=16, word_dim=32, mark_dim=5, hidden_dim=32,
                depth=4, learning_rate=0.01, with_optimizer=True):
    """Training graph: returns {"loss", "crf_decode", "feeds"}."""
    feats = [layers.data(name=n, shape=[max_length], dtype="int64",
                         lod_level=1) for n in FEATURES]
    predicate = layers.data(name="verb", shape=[max_length],
                            dtype="int64", lod_level=1)
    mark = layers.data(name="mark", shape=[max_length], dtype="int64",
                       lod_level=1)
    target = layers.data(name="target", shape=[max_length],
                         dtype="int64", lod_level=1)

    feature_out = db_lstm(feats, predicate, mark, word_dict_len,
                          label_dict_len, pred_dict_len,
                          word_dim=word_dim, mark_dim=mark_dim,
                          hidden_dim=hidden_dim, depth=depth)
    # the op emits the negative log-likelihood (the minimized cost,
    # matching the reference's usage: avg_cost = mean(crf_cost))
    crf_cost = layers.linear_chain_crf(
        feature_out, target,
        param_attr=ParamAttr(name="srl_crfw"))
    avg_cost = layers.mean(crf_cost)
    crf_decode = layers.crf_decoding(
        feature_out, param_attr=ParamAttr(name="srl_crfw"))
    if with_optimizer:
        optimizer.SGD(learning_rate=learning_rate).minimize(avg_cost)
    feeds = list(FEATURES) + ["verb", "mark", "target"]
    return {"loss": avg_cost, "crf_decode": crf_decode, "feeds": feeds}


def make_fake_batch(batch_size, max_length=16, word_dict_len=200,
                    label_dict_len=9, pred_dict_len=50, seed=0):
    """Synthetic tagged batch: the target tag is a deterministic
    function of the word id so the model can learn it."""
    rng = np.random.RandomState(seed)
    lens = rng.randint(max(2, max_length // 2), max_length + 1,
                       (batch_size,)).astype(np.int32)
    words = rng.randint(0, word_dict_len, (batch_size, max_length))
    batch = {}
    for name in FEATURES:
        shift = {"ctx_n2": -2, "ctx_n1": -1, "ctx_0": 0,
                 "ctx_p1": 1, "ctx_p2": 2}.get(name, 0)
        rolled = np.roll(words, shift, axis=1) if shift else words
        batch[name] = rolled.astype(np.int64)
        batch[f"{name}.seq_len"] = lens
    batch["verb"] = np.tile(
        rng.randint(0, pred_dict_len, (batch_size, 1)),
        (1, max_length)).astype(np.int64)
    batch["verb.seq_len"] = lens
    batch["mark"] = (words % 2).astype(np.int64)
    batch["mark.seq_len"] = lens
    batch["target"] = (words % label_dict_len).astype(np.int64)
    batch["target.seq_len"] = lens
    return batch
