"""Recommender system (two towers, cosine-scored): the port of
paddle_tpu/models/recommender.py.

reference: python/paddle/fluid/tests/book/test_recommender_system.py —
user tower (user id / gender / age / job embeddings) and movie tower
(movie id embedding + title sequence conv-pool), cosine-scored and
regressed onto the rating.  The title sequence is padded with a
`.seq_len` companion instead of LoD.  The same builder, so
`Program.to_dict()` of a build equals the reference's."""

from __future__ import annotations

import numpy as np

from .. import layers, optimizer
from ..param_attr import ParamAttr


def build_model(user_vocab=500, gender_vocab=2, age_vocab=7, job_vocab=21,
                movie_vocab=800, title_vocab=1000, title_len=12,
                embed_dim=32, batch_size=32, learning_rate=5e-3,
                with_optimizer=True):
    B = batch_size

    def emb_feature(name, vocab):
        ids = layers.data(name, shape=[B, 1], dtype="int64",
                          append_batch_size=False)
        e = layers.embedding(
            ids, size=[vocab, embed_dim],
            param_attr=ParamAttr(name=f"rec.{name}_emb"))
        return layers.reshape(e, shape=[B, embed_dim])

    # --- user tower ---
    usr = emb_feature("user_id", user_vocab)
    gender = emb_feature("gender_id", gender_vocab)
    age = emb_feature("age_id", age_vocab)
    job = emb_feature("job_id", job_vocab)
    usr_combined = layers.fc(
        layers.concat([usr, gender, age, job], axis=1),
        size=200, act="tanh")

    # --- movie tower ---
    mov = emb_feature("movie_id", movie_vocab)
    title = layers.data("title_ids", shape=[B, title_len], dtype="int64",
                        append_batch_size=False, lod_level=1)
    title_emb = layers.embedding(
        title, size=[title_vocab, embed_dim],
        param_attr=ParamAttr(name="rec.title_emb"))
    title_feat = layers.sequence_pool(
        layers.sequence_conv(title_emb, num_filters=embed_dim,
                             filter_size=3, act="tanh"), "sum")
    mov_combined = layers.fc(
        layers.concat([mov, title_feat], axis=1), size=200, act="tanh")

    # --- cosine similarity score scaled to rating range ---
    sim = layers.reduce_sum(
        layers.elementwise_mul(
            layers.l2_normalize(usr_combined, axis=1),
            layers.l2_normalize(mov_combined, axis=1)),
        dim=1, keep_dim=True)
    predict = layers.scale(sim, scale=5.0)

    rating = layers.data("score", shape=[B, 1], append_batch_size=False)
    loss = layers.reduce_mean(layers.square_error_cost(predict, rating))
    if with_optimizer:
        optimizer.AdamOptimizer(learning_rate=learning_rate).minimize(loss)
    feeds = ["user_id", "gender_id", "age_id", "job_id", "movie_id",
             "title_ids", "title_ids.seq_len", "score"]
    return {"loss": loss, "predict": predict, "feeds": feeds}


def make_fake_batch(batch_size=32, seed=0, **vocab_sizes):
    rng = np.random.RandomState(seed)
    v = {"user_vocab": 500, "gender_vocab": 2, "age_vocab": 7,
         "job_vocab": 21, "movie_vocab": 800, "title_vocab": 1000,
         "title_len": 12}
    v.update(vocab_sizes)
    B = batch_size
    uid = rng.randint(0, v["user_vocab"], (B, 1))
    mid = rng.randint(0, v["movie_vocab"], (B, 1))
    return {
        "user_id": uid.astype(np.int64),
        "gender_id": rng.randint(0, v["gender_vocab"],
                                 (B, 1)).astype(np.int64),
        "age_id": rng.randint(0, v["age_vocab"], (B, 1)).astype(np.int64),
        "job_id": rng.randint(0, v["job_vocab"], (B, 1)).astype(np.int64),
        "movie_id": mid.astype(np.int64),
        "title_ids": rng.randint(0, v["title_vocab"],
                                 (B, v["title_len"])).astype(np.int64),
        "title_ids.seq_len": rng.randint(
            3, v["title_len"] + 1, B).astype(np.int32),
        # learnable structure: rating derived from the id pair
        "score": ((uid + mid) % 5 + 1).astype(np.float32),
    }
