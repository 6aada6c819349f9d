"""BERT-base pretraining (MLM + NSP): the port of
paddle_tpu/models/bert.py.

The same build function, so `Program.to_dict()` of a build equals the
reference's: word, sentence and learned position embeddings (the
position table's (1, T, D) rows broadcast over the batch in the add),
the Transformer's `encoder_layer` stack with a key-padding bias of -1e9
built in-graph from `seq_len`, a masked-LM head over the masked
positions gathered by a one-hot matmul, and a next-sentence head on
position 0; `build_model` trains the sum of both losses with Adam under
`linear_lr_warmup(polynomial_decay(...))`.  Attention goes through the
flash_attention op with `use_flash=True` (`head_major` False or True:
the flash kernels on CUDA) and is composed from matmul and softmax
otherwise.  `use_amp=True` wraps the optimizer with `amp.decorate`, as
the reference does: the bf16 policy at op dispatch, and on CUDA the
flash kernels' bf16 paths.  Not ported yet, raising NotImplementedError
with its ROADMAP item: `pipeline` (queue A item 2: executor scopes).
"""

from __future__ import annotations

import numpy as np

from .. import amp, layers, optimizer
from ..initializer import TruncatedNormal
from ..param_attr import ParamAttr
from .transformer import _unported, encoder_layer, pre_post_process


def bert_encoder(src_ids, sent_ids, input_mask_bias, vocab_size, max_len,
                 n_layer=12, n_head=12, d_model=768, d_inner=3072,
                 dropout=0.1, use_flash=False, pipeline=False,
                 head_major=False):
    if head_major and not use_flash:
        raise ValueError(
            "head_major=True requires use_flash=True (the head-major "
            "layout rides the flash op; see models/transformer.py)")
    if pipeline:
        _unported("pipeline",
                  "queue A item 2 (executor: recompute and pipeline scopes)")
    init = TruncatedNormal(0.0, 0.02)
    word_emb = layers.embedding(
        src_ids, size=[vocab_size, d_model],
        param_attr=ParamAttr(name="word_embedding", initializer=init))
    # ids 0..T-1, one row: the (1, T, D) embedding broadcasts in the add
    pos_ids = layers.reshape(layers.range(0, max_len, 1, "int64"),
                             shape=[1, max_len])
    pos_emb = layers.embedding(
        pos_ids, size=[max_len, d_model],
        param_attr=ParamAttr(name="pos_embedding", initializer=init))
    sent_emb = layers.embedding(
        sent_ids, size=[2, d_model],
        param_attr=ParamAttr(name="sent_embedding", initializer=init))
    emb = layers.elementwise_add(
        layers.elementwise_add(word_emb, sent_emb), pos_emb)
    emb = layers.layer_norm(emb, begin_norm_axis=2)
    if dropout:
        emb = layers.dropout(emb, dropout_prob=dropout,
                             dropout_implementation="upscale_in_train")
    x = emb
    for _ in range(n_layer):
        x = encoder_layer(x, input_mask_bias, n_head, d_model // n_head,
                          d_model // n_head, d_model, d_inner, dropout,
                          use_flash=use_flash, head_major=head_major)
    return pre_post_process(None, x, "n")


def build_model(vocab_size=30522, max_len=128, n_layer=12, n_head=12,
                d_model=768, d_inner=3072, max_predictions=20,
                learning_rate=1e-4, warmup_steps=10000, dropout=0.1,
                with_optimizer=True, use_flash=False, use_amp=False,
                pipeline=False, head_major=False):
    src_ids = layers.data(name="src_ids", shape=[max_len], dtype="int64")
    sent_ids = layers.data(name="sent_ids", shape=[max_len], dtype="int64")
    seq_len = layers.data(name="seq_len", shape=[], dtype="int32")
    mask_pos = layers.data(name="mask_pos", shape=[max_predictions],
                           dtype="int64")
    mask_label = layers.data(name="mask_label", shape=[max_predictions],
                             dtype="int64")
    mask_weight = layers.data(name="mask_weight", shape=[max_predictions],
                              dtype="float32")
    nsp_label = layers.data(name="nsp_label", shape=[1], dtype="int64")

    m = layers.sequence_mask(seq_len, maxlen=max_len, dtype="float32")
    bias = layers.scale(m, scale=1e9, bias=-1e9)
    bias = layers.unsqueeze(layers.unsqueeze(bias, axes=[1]), axes=[1])

    enc = bert_encoder(src_ids, sent_ids, bias, vocab_size, max_len,
                       n_layer, n_head, d_model, d_inner, dropout,
                       use_flash=use_flash, pipeline=pipeline,
                       head_major=head_major)

    # masked-LM head on the masked positions of each row
    gathered = _gather_rows(enc, mask_pos)
    mlm = layers.fc(gathered, size=d_model, act="gelu", num_flatten_dims=2)
    mlm = layers.layer_norm(mlm, begin_norm_axis=2)
    mlm_logits = layers.fc(mlm, size=vocab_size, num_flatten_dims=2)
    mlm_loss = layers.softmax_with_cross_entropy(
        mlm_logits, layers.unsqueeze(mask_label, axes=[2]))
    mlm_loss = layers.elementwise_mul(
        layers.squeeze(mlm_loss, axes=[2]), mask_weight)
    denom = layers.elementwise_max(
        layers.reduce_sum(mask_weight),
        layers.fill_constant([1], "float32", 1.0))
    mlm_loss = layers.elementwise_div(layers.reduce_sum(mlm_loss), denom)

    # next-sentence head on position 0 ([CLS])
    cls = layers.slice(enc, axes=[1], starts=[0], ends=[1])
    cls = layers.squeeze(cls, axes=[1])
    pooled = layers.fc(cls, size=d_model, act="tanh")
    nsp_logits = layers.fc(pooled, size=2)
    nsp_loss = layers.mean(
        layers.softmax_with_cross_entropy(nsp_logits, nsp_label))

    loss = layers.elementwise_add(mlm_loss, nsp_loss)
    if with_optimizer:
        lr = layers.linear_lr_warmup(
            layers.polynomial_decay(learning_rate, 1000000, 0.0, 1.0),
            warmup_steps, 0.0, learning_rate)
        opt = optimizer.AdamOptimizer(learning_rate=lr)
        if use_amp:
            opt = amp.decorate(opt)
        opt.minimize(loss)
    feeds = ["src_ids", "sent_ids", "seq_len", "mask_pos", "mask_label",
             "mask_weight", "nsp_label"]
    return {"loss": loss, "mlm_loss": mlm_loss, "nsp_loss": nsp_loss,
            "feeds": feeds}


def _gather_rows(enc, pos):
    """Per-row gather of the masked positions: enc (N, T, D), pos (N, P)
    -> (N, P, D) as one_hot(pos) (N, P, T) times enc, a batched matmul
    (the gradient reaches enc through the product)."""
    t = enc.shape[1]
    oh = layers.one_hot(pos, depth=t)           # (N, P, T)
    return layers.matmul(oh, enc)               # (N, P, D)


def make_fake_batch(batch_size, max_len=128, vocab_size=30522,
                    max_predictions=20, seed=0):
    """Synthetic pretraining batch (full lengths) for benchmarking."""
    rng = np.random.RandomState(seed)
    return {
        "src_ids": rng.randint(0, vocab_size,
                               (batch_size, max_len)).astype(np.int64),
        "sent_ids": rng.randint(0, 2,
                                (batch_size, max_len)).astype(np.int64),
        "seq_len": np.full((batch_size,), max_len, np.int32),
        "mask_pos": rng.randint(0, max_len,
                                (batch_size, max_predictions)).astype(np.int64),
        "mask_label": rng.randint(0, vocab_size,
                                  (batch_size, max_predictions)).astype(np.int64),
        "mask_weight": np.ones((batch_size, max_predictions), np.float32),
        "nsp_label": rng.randint(0, 2, (batch_size, 1)).astype(np.int64),
    }
