"""Seq2seq NMT: GRU encoder-decoder with dot attention + beam-search decode.

The port of paddle_tpu/models/machine_translation.py (reference:
benchmark/fluid/machine_translation.py:1 — the lstm-encoder-decoder
bench model; python/paddle/fluid/tests/book/test_machine_translation.py —
the book model whose inference uses beam_search/beam_search_decode with
While + tensor arrays).  The same builders, so `Program.to_dict()` of
each program equals the reference's.

Training uses DynamicRNN (a step loop with seq_len masking, which
autograd differentiates through); decoding uses a While loop with
fixed-capacity tensor arrays, the dense (batch, beam) `beam_search` op
per step, and the `beam_search_decode` backtrace at the end.

Weights are shared between the training and decoding programs through
fixed parameter names, exactly how the reference shares them between
train/infer programs built from the same network function.
"""

from __future__ import annotations

from .. import layers
from ..param_attr import ParamAttr


def _p(name):
    return ParamAttr(name=name)


def _encoder(src, src_vocab_size, embed_dim, hidden_dim):
    """Embedding → input proj → GRU.  Returns (enc_out (B,T,H), last (B,H))."""
    emb = layers.embedding(src, size=(src_vocab_size, embed_dim),
                           param_attr=_p("nmt.src_emb"))
    proj = layers.fc(emb, size=3 * hidden_dim, num_flatten_dims=2,
                     param_attr=_p("nmt.enc_proj.w"),
                     bias_attr=_p("nmt.enc_proj.b"))
    enc_out = layers.dynamic_gru(proj, size=hidden_dim,
                                 param_attr=_p("nmt.enc_gru.w"),
                                 bias_attr=_p("nmt.enc_gru.b"))
    last = layers.sequence_last_step(enc_out)
    return enc_out, last


def _attention(h, enc_out, enc_mask):
    """Dot attention: h (N,H) against enc_out (N,T,H) with additive mask
    (N,T) of 0/-1e9.  Returns the (N,H) context."""
    scores = layers.reduce_sum(
        layers.elementwise_mul(enc_out, layers.unsqueeze(h, [1])), dim=2)
    scores = layers.elementwise_add(scores, enc_mask)
    attn = layers.softmax(scores)
    ctx = layers.reduce_sum(
        layers.elementwise_mul(enc_out, layers.unsqueeze(attn, [2])), dim=1)
    return ctx


def _dec_step(emb_t, h_prev, enc_out, enc_mask, hidden_dim):
    """One decoder step shared by training and beam decode."""
    ctx = _attention(h_prev, enc_out, enc_mask)
    inp = layers.concat([emb_t, ctx], axis=1)
    gate_in = layers.fc(inp, size=3 * hidden_dim,
                        param_attr=_p("nmt.dec_in.w"),
                        bias_attr=_p("nmt.dec_in.b"))
    h, _, _ = layers.gru_unit(gate_in, h_prev, 3 * hidden_dim,
                              param_attr=_p("nmt.dec_gru.w"),
                              bias_attr=_p("nmt.dec_gru.b"))
    return h


def _enc_additive_mask(seq_len, max_len):
    """(B,T) additive mask: 0 where t < len, -1e9 beyond."""
    mask = layers.sequence_mask(seq_len, maxlen=max_len, dtype="float32")
    return layers.scale(mask, scale=1e9, bias=-1e9)


def seq_to_seq_net(src_vocab_size=1000, trg_vocab_size=1000, embed_dim=64,
                   hidden_dim=128, batch_size=16, max_src_len=20,
                   max_trg_len=20):
    """Training network.  Returns (avg_cost, feeds)."""
    src = layers.data("src_word_id", shape=[batch_size, max_src_len],
                      dtype="int64", append_batch_size=False, lod_level=1)
    trg = layers.data("trg_word_id", shape=[batch_size, max_trg_len],
                      dtype="int64", append_batch_size=False, lod_level=1)
    label = layers.data("trg_next_id", shape=[batch_size, max_trg_len],
                        dtype="int64", append_batch_size=False)

    enc_out, enc_last = _encoder(src, src_vocab_size, embed_dim, hidden_dim)
    src_len = layers.seq_len_var(src)
    enc_mask = _enc_additive_mask(src_len, max_src_len)

    trg_emb = layers.embedding(trg, size=(trg_vocab_size, embed_dim),
                               param_attr=_p("nmt.trg_emb"))

    drnn = layers.DynamicRNN()
    with drnn.block():
        emb_t = drnn.step_input(trg_emb)
        h_prev = drnn.memory(init=enc_last)
        h = _dec_step(emb_t, h_prev, enc_out, enc_mask, hidden_dim)
        drnn.update_memory(h_prev, h)
        drnn.output(h)
    dec_out = drnn()  # (B, T_trg, H) padded

    logits = layers.fc(dec_out, size=trg_vocab_size, num_flatten_dims=2,
                       param_attr=_p("nmt.out.w"), bias_attr=_p("nmt.out.b"))
    cost = layers.softmax_with_cross_entropy(
        logits, layers.unsqueeze(label, [2]))
    trg_len = layers.seq_len_var(trg)
    trg_mask = layers.sequence_mask(trg_len, maxlen=max_trg_len,
                                    dtype="float32")
    cost = layers.elementwise_mul(layers.squeeze(cost, [2]), trg_mask)
    # mean over real (unpadded) tokens
    avg_cost = layers.elementwise_div(
        layers.reduce_sum(cost),
        layers.reduce_sum(trg_mask))
    feeds = ["src_word_id", "src_word_id.seq_len", "trg_word_id",
             "trg_word_id.seq_len", "trg_next_id"]
    return avg_cost, feeds


def beam_search_net(src_vocab_size=1000, trg_vocab_size=1000, embed_dim=64,
                    hidden_dim=128, batch_size=4, max_src_len=20,
                    beam_size=4, max_decode_len=16, start_id=0, end_id=1):
    """Beam-search decoding network (reference book model's decode(), built
    from While + arrays + beam_search + beam_search_decode).

    Returns (sentence_ids (B, K, max_decode_len), final_scores (B, K),
    feeds)."""
    B, K = batch_size, beam_size
    src = layers.data("src_word_id", shape=[B, max_src_len], dtype="int64",
                      append_batch_size=False, lod_level=1)
    enc_out, enc_last = _encoder(src, src_vocab_size, embed_dim, hidden_dim)
    src_len = layers.seq_len_var(src)
    enc_mask = _enc_additive_mask(src_len, max_src_len)  # (B, T)

    # Beam-expand encoder state: (B,...) → (B*K,...), beams contiguous per
    # batch row so `parent + row*K` flattens the reorder gather.
    enc_out_b = layers.reshape(
        layers.expand(layers.unsqueeze(enc_out, [1]), [1, K, 1, 1]),
        [B * K, max_src_len, hidden_dim])
    enc_mask_b = layers.reshape(
        layers.expand(layers.unsqueeze(enc_mask, [1]), [1, K, 1]),
        [B * K, max_src_len])
    hidden = layers.reshape(
        layers.expand(layers.unsqueeze(enc_last, [1]), [1, K, 1]),
        [B * K, hidden_dim])

    pre_ids = layers.fill_constant([B, K], "int64", float(start_id))
    # beams 1..K-1 start at -inf so step 0 only expands beam 0 (standard
    # dense-beam initialization; replaces the op's is_first_step attr)
    beam_iota = layers.reshape(
        layers.range(0, K, 1, "float32", num=K), [1, K])
    neg = layers.scale(
        layers.cast(layers.greater_than(
            layers.expand(beam_iota, [B, 1]),
            layers.fill_constant([B, K], "float32", 0.0)), "float32"),
        scale=-1e9)
    pre_scores = neg  # (B,K): [0, -1e9, ...]

    # flat row offsets: [0,0,..,K,K,..] for parent reordering
    row_offset = layers.scale(
        layers.elementwise_floordiv(
            layers.range(0, B * K, 1, "int32", num=B * K),
            layers.fill_constant([B * K], "int32", float(K))),
        scale=float(K))

    ids_arr = layers.create_array("int64", element_shape=[B, K],
                                  capacity=max_decode_len)
    par_arr = layers.create_array("int32", element_shape=[B, K],
                                  capacity=max_decode_len)

    step = layers.fill_constant([1], "int32", 0)
    max_steps = layers.fill_constant([1], "int32", float(max_decode_len))
    cond = layers.less_than(step, max_steps)
    w = layers.While(cond)
    with w.block():
        emb = layers.embedding(layers.reshape(pre_ids, [B * K]),
                               size=(trg_vocab_size, embed_dim),
                               param_attr=_p("nmt.trg_emb"))
        h = _dec_step(emb, hidden, enc_out_b, enc_mask_b, hidden_dim)
        logits = layers.fc(h, size=trg_vocab_size,
                           param_attr=_p("nmt.out.w"),
                           bias_attr=_p("nmt.out.b"))
        logp = layers.log(layers.softmax(logits))
        logp = layers.reshape(logp, [B, K, trg_vocab_size])
        sel_ids, sel_scores, parent = layers.beam_search(
            pre_ids, pre_scores, logp, beam_size=K, end_id=end_id)
        # reorder hidden by parent beam
        flat_parent = layers.elementwise_add(
            layers.reshape(parent, [B * K]), row_offset)
        layers.assign(layers.gather(h, flat_parent), hidden)
        layers.array_write(sel_ids, step, ids_arr)
        layers.array_write(parent, step, par_arr)
        layers.assign(sel_ids, pre_ids)
        layers.assign(sel_scores, pre_scores)
        layers.increment(step, value=1, in_place=True)
        # continue while step < max AND any beam unfinished
        finished = layers.equal(
            layers.cast(pre_ids, "int32"),
            layers.fill_constant([B, K], "int32", float(end_id)))
        all_done = layers.reduce_all(finished)
        layers.logical_and(
            layers.less_than(step, max_steps),
            layers.logical_not(layers.reshape(all_done, [1])),
            out=cond)

    ids_stack, _ = layers.array_to_tensor(ids_arr)     # (L, B, K)
    par_stack, _ = layers.array_to_tensor(par_arr)     # (L, B, K)
    sentences = layers.beam_search_decode(ids_stack, par_stack,
                                          num_steps=step, end_id=end_id)
    feeds = ["src_word_id", "src_word_id.seq_len"]
    return sentences, pre_scores, feeds
