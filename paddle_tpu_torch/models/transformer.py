"""Transformer NMT (encoder-decoder): the port of
paddle_tpu/models/transformer.py, the repository's training headline
model.

The same builder, so `Program.to_dict()` of a build equals the
reference's: pre/post-process wrappers around multi-head attention and
FFN, masks as additive biases built in-graph from sequence lengths, and
`build_model`'s AdamOptimizer(noam_decay).minimize(loss).  Ported:
`use_flash=True` (the flash_attention op: key-padding bias, causal
decoder self-attention, autograd through the forward and backward
kernels on CUDA) with `head_major` False or True; without head_major
the decoder's cross attention is composed from matmul and softmax, as
in the reference (`flash_cross=True` sends it through the flash op
too); `use_flash=False` (every attention composed from matmul and
softmax, the decoder's causal bias built from `range` and
`less_equal`); `fused_qkv=True` (one head-grouped projection sliced
into q, k and v, either layout); and `use_fused_ce=True`, the final
projection and the label-smoothed CE in the fused_vocab_softmax_ce op
(the vocab-CE forward, dh and dW kernels on CUDA); and `use_amp=True`,
the optimizer wrapped with `amp.decorate` as in the reference (the bf16
policy at op dispatch; on CUDA the flash kernels' bf16 paths, while the
fused CE's Hidden arrives float32 from layer_norm and keeps the vocab-CE
kernels' float32 path).  Not ported yet, each raising
NotImplementedError with its ROADMAP item: `moe_experts`
(queue A item 6: ops/moe.py), `recompute` and `pipeline` (queue A item
2: executor scopes).
"""

from __future__ import annotations

import numpy as np

from .. import amp, layers, optimizer
from ..initializer import Normal
from ..param_attr import ParamAttr


def _unported(what, item):
    raise NotImplementedError(
        f"transformer {what} is not ported yet: ROADMAP {item}")


def multi_head_attention(queries, keys, values, attn_bias, d_key, d_value,
                         d_model, n_head, dropout_rate=0.0,
                         use_flash=False, fused_qkv=False,
                         flash_pallas=None, causal=False,
                         head_major=False):
    def split_heads(x, d):
        # (N, T, H*d) -> (N, H, T, d)
        rr = layers.reshape(x, shape=[0, 0, n_head, d])
        return layers.transpose(rr, perm=[0, 2, 1, 3])

    # fused_qkv (self-attention only): one (D, (2dk+dv)*H) projection
    # whose output is head-grouped ([q_h|k_h|v_h] for each head h),
    # viewed as (N, T, H, group) and sliced on its minor axis
    if keys is None and fused_qkv:
        group = 2 * d_key + d_value
        qkv = layers.fc(queries, size=group * n_head, num_flatten_dims=2,
                        bias_attr=False, name="attn_qkv")
        r = layers.reshape(qkv, shape=[0, 0, n_head, group])
        if not head_major:
            r = layers.transpose(r, perm=[0, 2, 1, 3])   # (N, H, T, group)

        def part(lo, hi, d):
            x = layers.slice(r, axes=[3], starts=[lo], ends=[hi])
            # head-major: merged back to (N, T, H*d), no transpose
            return layers.reshape(x, shape=[0, 0, n_head * d]) \
                if head_major else x

        q = part(0, d_key, d_key)
        k = part(d_key, 2 * d_key, d_key)
        v = part(2 * d_key, group, d_value)
    else:
        if keys is None:  # self-attention
            keys, values = queries, queries
        # layer names drive the Megatron row/col sharding rules of the
        # reference: attn_qkv_* column-parallel, attn_out_* row-parallel
        q = layers.fc(queries, size=d_key * n_head, num_flatten_dims=2,
                      bias_attr=False, name="attn_qkv")
        k = layers.fc(keys, size=d_key * n_head, num_flatten_dims=2,
                      bias_attr=False, name="attn_qkv")
        v = layers.fc(values, size=d_value * n_head, num_flatten_dims=2,
                      bias_attr=False, name="attn_qkv")
        if not head_major:
            q = split_heads(q, d_key)
            k = split_heads(k, d_key)
            v = split_heads(v, d_value)
    if head_major:
        # the projections' (N, T, H*d) head-grouped outputs feed the
        # flash op's layout="nthd" directly; no transpose anywhere.
        # Like the flash path below, no dropout on the attention weights
        # (the flash op's contract).
        ctx = layers.flash_attention(q, k, v, attn_bias,
                                     scale=d_key ** -0.5, causal=causal,
                                     use_pallas=flash_pallas,
                                     layout="nthd", n_head=n_head)
        return layers.fc(ctx, size=d_model, num_flatten_dims=2,
                         bias_attr=False, name="attn_out")
    if use_flash:
        # causal=True (decoder self-attention) masks in the op with a
        # key-padding-only bias, the form the kernels take natively
        ctx = layers.flash_attention(q, k, v, attn_bias,
                                     scale=d_key ** -0.5, causal=causal,
                                     use_pallas=flash_pallas)
    else:
        # composed attention (use_flash=False, and the decoder's cross
        # attention): matmul, bias, softmax, dropout on the weights,
        # matmul
        product = layers.matmul(q, k, transpose_y=True,
                                alpha=d_key ** -0.5)
        if attn_bias is not None:
            product = layers.elementwise_add(product, attn_bias)
        weights = layers.softmax(product)
        if dropout_rate:
            weights = layers.dropout(
                weights, dropout_prob=dropout_rate,
                dropout_implementation="upscale_in_train")
        ctx = layers.matmul(weights, v)
    ctx = layers.transpose(ctx, perm=[0, 2, 1, 3])
    ctx = layers.reshape(ctx, shape=[0, 0, n_head * d_value])
    return layers.fc(ctx, size=d_model, num_flatten_dims=2,
                     bias_attr=False, name="attn_out")


def positionwise_feed_forward(x, d_inner, d_model, act="relu"):
    hidden = layers.fc(x, size=d_inner, num_flatten_dims=2, act=act,
                       name="ffn_in")
    return layers.fc(hidden, size=d_model, num_flatten_dims=2,
                     name="ffn_out")


def pre_post_process(prev_out, out, process_cmd, dropout_rate=0.0):
    """'a' residual-add, 'n' layer-norm, 'd' dropout (reference
    pre_process_layer/post_process_layer convention)."""
    for cmd in process_cmd:
        if cmd == "a":
            out = layers.elementwise_add(out, prev_out) \
                if prev_out is not None else out
        elif cmd == "n":
            out = layers.layer_norm(out, begin_norm_axis=len(out.shape) - 1)
        elif cmd == "d":
            if dropout_rate:
                out = layers.dropout(
                    out, dropout_prob=dropout_rate,
                    dropout_implementation="upscale_in_train")
    return out


def encoder_layer(x, attn_bias, n_head, d_key, d_value, d_model, d_inner,
                  dropout, use_flash=False, fused_qkv=False,
                  moe_experts=0, aux_list=None, flash_pallas=None,
                  head_major=False):
    if moe_experts:
        _unported("moe_experts", "queue A item 6 (ops/moe.py)")
    attn = multi_head_attention(
        pre_post_process(None, x, "n"), None, None, attn_bias, d_key,
        d_value, d_model, n_head, dropout, use_flash=use_flash,
        fused_qkv=fused_qkv, flash_pallas=flash_pallas,
        head_major=head_major)
    attn = pre_post_process(x, attn, "ad", dropout)
    ff = positionwise_feed_forward(pre_post_process(None, attn, "n"),
                                   d_inner, d_model)
    return pre_post_process(attn, ff, "ad", dropout)


def decoder_layer(x, enc_out, self_bias, cross_bias, n_head, d_key, d_value,
                  d_model, d_inner, dropout, use_flash=False,
                  fused_qkv=False, moe_experts=0, aux_list=None,
                  flash_pallas=None, self_causal=False,
                  flash_cross=False, head_major=False):
    if moe_experts:
        _unported("moe_experts", "queue A item 6 (ops/moe.py)")
    self_attn = multi_head_attention(
        pre_post_process(None, x, "n"), None, None, self_bias, d_key,
        d_value, d_model, n_head, dropout, use_flash=use_flash,
        fused_qkv=fused_qkv, flash_pallas=flash_pallas,
        causal=self_causal, head_major=head_major)
    self_attn = pre_post_process(x, self_attn, "ad", dropout)
    q = pre_post_process(None, self_attn, "n")
    # cross attention goes through the flash op with flash_cross or
    # head_major; otherwise it is composed from matmul and softmax
    cross = multi_head_attention(q, enc_out, enc_out, cross_bias, d_key,
                                 d_value, d_model, n_head, dropout,
                                 use_flash=flash_cross or head_major,
                                 flash_pallas=(flash_pallas
                                               if flash_cross else None),
                                 head_major=head_major)
    cross = pre_post_process(self_attn, cross, "ad", dropout)
    ff = positionwise_feed_forward(pre_post_process(None, cross, "n"),
                                   d_inner, d_model)
    return pre_post_process(cross, ff, "ad", dropout)


def _word_embedding(ids, vocab_size, d_model, name):
    emb = layers.embedding(
        ids, size=[vocab_size, d_model],
        param_attr=ParamAttr(name=name,
                             initializer=Normal(0.0, d_model ** -0.5)))
    return layers.scale(emb, scale=d_model ** 0.5)


def _prepare_input(ids, vocab_size, d_model, max_len, dropout, name):
    emb = _word_embedding(ids, vocab_size, d_model, name)
    emb = layers.add_position_encoding(emb)
    if dropout:
        emb = layers.dropout(emb, dropout_prob=dropout,
                             dropout_implementation="upscale_in_train")
    return emb


def _padding_bias(seq_len, max_len):
    """(N,) lengths -> additive attention bias (N, 1, 1, T): 0 valid,
    -1e9 padded."""
    m = layers.sequence_mask(seq_len, maxlen=max_len, dtype="float32")
    bias = layers.scale(m, scale=1e9, bias=-1e9)
    return layers.unsqueeze(layers.unsqueeze(bias, axes=[1]), axes=[1])


def _causal_bias(max_len):
    """(1, 1, T, T) additive bias: 0 where col <= row else -1e9."""
    r = layers.range(0, max_len, 1, "float32")
    row = layers.reshape(r, shape=[max_len, 1])
    col = layers.reshape(r, shape=[1, max_len])
    allowed = layers.cast(layers.less_equal(col, row), "float32")
    bias = layers.scale(allowed, scale=1e9, bias=-1e9)
    return layers.unsqueeze(layers.unsqueeze(bias, axes=[0]), axes=[0])


def transformer(src_vocab_size=10000, trg_vocab_size=10000, max_length=64,
                n_layer=6, n_head=8, d_key=64, d_value=64, d_model=512,
                d_inner_hid=2048, dropout=0.1, label_smooth_eps=0.1,
                use_flash=False, use_fused_ce=False, fused_qkv=False,
                moe_experts=0, moe_aux_weight=0.01, flash_pallas=None,
                recompute=False, pipeline=False, flash_cross=False,
                head_major=False):
    """Build the full training graph; returns (avg_cost, logits, feeds).
    Only the ported options are accepted (module docstring)."""
    if head_major and not use_flash:
        raise ValueError(
            "head_major=True requires use_flash=True: the composed "
            "matmul+softmax attention path would reintroduce the "
            "boundary transposes the head-major layout deletes")
    if moe_experts:
        _unported("moe_experts", "queue A item 6 (ops/moe.py)")
    if recompute:
        _unported("recompute",
                  "queue A item 2 (executor: recompute and pipeline scopes)")
    if pipeline:
        _unported("pipeline",
                  "queue A item 2 (executor: recompute and pipeline scopes)")

    src_word = layers.data(name="src_word", shape=[max_length],
                           dtype="int64")
    trg_word = layers.data(name="trg_word", shape=[max_length],
                           dtype="int64")
    lbl_word = layers.data(name="lbl_word", shape=[max_length],
                           dtype="int64")
    src_len = layers.data(name="src_len", shape=[], dtype="int32")
    trg_len = layers.data(name="trg_len", shape=[], dtype="int32")

    src_bias = _padding_bias(src_len, max_length)
    self_bias = _padding_bias(trg_len, max_length)
    if use_flash:
        # decoder self-attention takes the key-padding bias and the
        # op's causal flag
        self_causal = True
    else:
        self_bias = layers.elementwise_add(self_bias,
                                           _causal_bias(max_length))
        self_causal = False

    x = _prepare_input(src_word, src_vocab_size, d_model, max_length,
                       dropout, "src_word_emb")
    for _ in range(n_layer):
        x = encoder_layer(x, src_bias, n_head, d_key, d_value, d_model,
                          d_inner_hid, dropout, use_flash=use_flash,
                          fused_qkv=fused_qkv, flash_pallas=flash_pallas,
                          head_major=head_major)
    enc_out = pre_post_process(None, x, "n")

    y = _prepare_input(trg_word, trg_vocab_size, d_model, max_length,
                       dropout, "trg_word_emb")
    for _ in range(n_layer):
        y = decoder_layer(y, enc_out, self_bias, src_bias, n_head, d_key,
                          d_value, d_model, d_inner_hid, dropout,
                          use_flash=use_flash, fused_qkv=fused_qkv,
                          flash_pallas=flash_pallas,
                          self_causal=self_causal, flash_cross=flash_cross,
                          head_major=head_major)
    dec_out = pre_post_process(None, y, "n")
    feeds = ["src_word", "trg_word", "lbl_word", "src_len", "trg_len"]

    if use_fused_ce:
        # the fused projection + CE owns the projection weight; the
        # logits var is still built from the same weight for the API
        # (the training step prunes it unless it is fetched)
        from ..layer_helper import LayerHelper

        helper = LayerHelper("vocab_proj")
        proj_w = helper.create_parameter(
            None, shape=[d_model, trg_vocab_size], dtype="float32")
        cost_tok = layers.fused_vocab_softmax_ce(
            dec_out, proj_w, lbl_word, epsilon=label_smooth_eps,
            use_pallas=True)
        logits = layers.matmul(dec_out, proj_w)
        tmask = layers.sequence_mask(trg_len, maxlen=max_length,
                                     dtype="float32")
        cost = layers.elementwise_mul(cost_tok, tmask)
        avg_cost = layers.elementwise_div(layers.reduce_sum(cost),
                                          layers.reduce_sum(tmask))
        return avg_cost, logits, feeds

    logits = layers.fc(dec_out, size=trg_vocab_size, num_flatten_dims=2,
                       bias_attr=False)
    if label_smooth_eps:
        label = layers.label_smooth(
            layers.one_hot(lbl_word, depth=trg_vocab_size),
            epsilon=label_smooth_eps)
        cost = layers.softmax_with_cross_entropy(logits, label,
                                                 soft_label=True)
    else:
        lbl3 = layers.unsqueeze(lbl_word, axes=[2])
        cost = layers.softmax_with_cross_entropy(logits, lbl3)

    # mask padded target positions out of the loss
    tmask = layers.sequence_mask(trg_len, maxlen=max_length,
                                 dtype="float32")
    cost = layers.elementwise_mul(layers.squeeze(cost, axes=[2]), tmask)
    sum_cost = layers.reduce_sum(cost)
    token_num = layers.reduce_sum(tmask)
    avg_cost = layers.elementwise_div(sum_cost, token_num)
    return avg_cost, logits, feeds


def build_model(src_vocab_size=10000, trg_vocab_size=10000, max_length=64,
                n_layer=6, n_head=8, d_model=512, d_inner_hid=2048,
                dropout=0.1, learning_rate=2.0, warmup_steps=4000,
                with_optimizer=True, label_smooth_eps=0.1, use_flash=False,
                use_amp=False, use_fused_ce=False, fused_qkv=False,
                moe_experts=0, flash_pallas=None, recompute=False,
                pipeline=False, flash_cross=False, head_major=False):
    avg_cost, logits, feeds = transformer(
        src_vocab_size, trg_vocab_size, max_length, n_layer, n_head,
        d_model // n_head, d_model // n_head, d_model, d_inner_hid,
        dropout, label_smooth_eps, use_flash=use_flash,
        use_fused_ce=use_fused_ce, fused_qkv=fused_qkv,
        moe_experts=moe_experts, flash_pallas=flash_pallas,
        recompute=recompute, pipeline=pipeline,
        flash_cross=flash_cross, head_major=head_major)
    if with_optimizer:
        lr = layers.noam_decay(d_model, warmup_steps)
        lr = layers.elementwise_mul(
            lr, layers.fill_constant([1], "float32", learning_rate))
        opt = optimizer.AdamOptimizer(learning_rate=lr, beta1=0.9,
                                      beta2=0.997, epsilon=1e-9)
        if use_amp:
            opt = amp.decorate(opt)
        opt.minimize(avg_cost)
    return {"loss": avg_cost, "logits": logits, "feeds": feeds}


def make_fake_batch(batch_size, max_length=64, src_vocab=10000,
                    trg_vocab=10000, seed=0):
    """Synthetic NMT batch for benchmarking (reference --use_fake_data)."""
    rng = np.random.RandomState(seed)
    src = rng.randint(1, src_vocab, (batch_size, max_length)).astype(np.int64)
    trg = rng.randint(1, trg_vocab, (batch_size, max_length)).astype(np.int64)
    lbl = rng.randint(1, trg_vocab, (batch_size, max_length)).astype(np.int64)
    src_len = np.full((batch_size,), max_length, np.int32)
    trg_len = np.full((batch_size,), max_length, np.int32)
    return {"src_word": src, "trg_word": trg, "lbl_word": lbl,
            "src_len": src_len, "trg_len": trg_len}
