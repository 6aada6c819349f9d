"""The port's side of the model-axis tests (tensor, sequence, pipeline
and expert parallelism, and C17's row-mixing ops under data
parallelism): model builders both packages share, and the cases a
`torch_dist_harness.RankGroup` runs on every rank (named
"torch_mp_cases:<case>").

The builders register in `torch_dp_cases.BUILDERS`, so `cases.build`,
`cases.train` and `cases.refusal` take them by name.  This module
imports torch, numpy and the port only: the worker processes have no
jax.
"""

from __future__ import annotations

import numpy as np
import torch

import paddle_tpu_torch as pt
import torch_dp_cases as cases

# -- C17: one row-mixing op in an fc-tanh-fc MLP ---------------------------

C17_ROWS = 32
C17_CASES = ("softmax", "cumsum", "argsort", "reverse", "gather",
             "concat_slice", "reduce_mean", "reduce_max", "l2_normalize",
             "xyt", "mul_transpose")
# in-batch negatives: each row's scores against every row of the batch,
# (B, B), into a softmax cross-entropy whose label is the row's own index
C17_PAIRED = ("xyt", "mul_transpose")


def c17_mlp(fluid, case):
    layers = fluid.layers
    x = layers.data("x", shape=[16], dtype="float32")
    y = layers.data("y", shape=[1], dtype="float32")
    h = layers.fc(x, size=16, act="tanh")
    if case == "softmax":
        h = layers.softmax(h, axis=0)
    elif case == "cumsum":
        h = layers.cumsum(h, axis=0)
    elif case == "argsort":
        h = layers.argsort(h, axis=0)[0]
    elif case == "reverse":
        h = layers.reverse(h, axis=0)
    elif case == "gather":
        idx = layers.data("idx", shape=[1], dtype="int64")
        h = layers.gather(h, layers.reshape(idx, shape=[-1]))
    elif case == "concat_slice":
        c = layers.concat([h, layers.scale(h, scale=2.0)], axis=0)
        h = layers.slice(c, axes=[0], starts=[0], ends=[C17_ROWS])
    elif case == "reduce_mean":
        h = layers.elementwise_sub(h, layers.reduce_mean(h, dim=0,
                                                         keep_dim=True))
    elif case == "reduce_max":
        h = layers.elementwise_sub(h, layers.reduce_max(h, dim=0,
                                                        keep_dim=True))
    elif case == "l2_normalize":
        h = layers.l2_normalize(h, axis=0)
    elif case in C17_PAIRED:
        g = layers.fc(x, size=16, act="tanh")
        s = (layers.matmul(h, g, transpose_y=True) if case == "xyt"
             else layers.mul(h, layers.transpose(g, perm=[1, 0])))
        lbl = layers.data("lbl", shape=[1], dtype="int64")
        loss = layers.mean(layers.softmax_with_cross_entropy(s, lbl))
        fluid.optimizer.SGD(learning_rate=0.1).minimize(loss)
        return {"loss": loss, "fetch": []}
    pred = layers.fc(h, size=1)
    loss = layers.mean(layers.square_error_cost(pred, y))
    fluid.optimizer.SGD(learning_rate=0.1).minimize(loss)
    return {"loss": loss, "fetch": []}


def c17_feeds(case, steps=3, seed=0):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(steps):
        f = {"x": rng.randn(C17_ROWS, 16).astype(np.float32),
             "y": rng.randn(C17_ROWS, 1).astype(np.float32)}
        if case == "gather":
            f["idx"] = rng.permutation(C17_ROWS).astype(np.int64)[:, None]
        if case in C17_PAIRED:
            f["lbl"] = np.arange(C17_ROWS, dtype=np.int64)[:, None]
        out.append(f)
    return out


for _case in C17_CASES:
    cases.BUILDERS[f"c17_{_case}"] = (
        lambda fluid, _c=_case: c17_mlp(fluid, _c))


# the data-parallel cases, reached through this module so that its
# builders are registered in the worker first
train = cases.train
refusal = cases.refusal


# -- tensor parallelism ------------------------------------------------------

def mp_rules_spec():
    """tests/test_hybrid_parallel.py's `_mp_rules` (:49-54) as picklable
    (rules, kwargs) for `cases.make_rules`."""
    return ([(r"ffn_in\S*\.w", (None, "mp")),
             (r"ffn_out\S*\.w", ("mp", None))], {})


def hybrid_mlp(fluid, optimizer="momentum"):
    """tests/test_hybrid_parallel.py's `_build` (:57-70)."""
    layers = fluid.layers
    x = layers.data("x", shape=[32], dtype="float32")
    y = layers.data("y", shape=[1], dtype="float32")
    h = layers.fc(x, size=128, act="relu", name="ffn_in")
    pred = layers.fc(h, size=1, name="ffn_out")
    loss = layers.mean(layers.square_error_cost(pred, y))
    if optimizer == "adam":
        fluid.optimizer.AdamOptimizer(learning_rate=1e-3).minimize(loss)
    else:
        fluid.optimizer.MomentumOptimizer(
            learning_rate=0.1, momentum=0.9).minimize(loss)
    return {"loss": loss, "fetch": [pred]}


cases.BUILDERS["hybrid_mlp"] = hybrid_mlp
cases.BUILDERS["hybrid_mlp_adam"] = lambda fluid: hybrid_mlp(fluid, "adam")


def hybrid_feeds(n=5, b=64, seed=0):
    """tests/test_hybrid_parallel.py's `_batches` (:73-77)."""
    rng = np.random.RandomState(seed)
    return [{"x": rng.randn(b, 32).astype(np.float32),
             "y": rng.randn(b, 1).astype(np.float32)} for _ in range(n)]


def _counts(main):
    w = getattr(main, "_compiled_wrapper", None)
    return None if w is None else w.collective_counts()


def train_mp(rank, world, model, feeds, arrays, mesh, rules=None,
             megatron=None, grad_sync=None, min_quant_numel=None,
             grads=False, local_bytes=False):
    """`cases.train` on a mesh with model axes, with the rules of
    `rules` (picklable) or `megatron_transformer_rules(**megatron)`;
    adds step 1's parameter gradients (logical, when `grads`), the last
    step's collective counts, the bytes this rank holds of each
    parameter (`local_bytes`) and each param's gradient on this rank
    (its local chunk, for the identity check across mp ranks)."""
    from paddle_tpu_torch.parallel.data_parallel import logical_value
    from torch.distributed.tensor import DTensor

    main, startup, out = cases.build(pt, model)
    scope = cases._scope_from(arrays, main) if arrays is not None else None
    exe = pt.Executor(pt.CPUPlace())
    if scope is None:
        scope = pt.Scope()
        exe.run(startup, scope=scope)
    m = pt.parallel.make_mesh(mesh)
    if not m.member:
        return None
    bs = cases.build_strategy(pt, grad_sync, False, rules, 1,
                              min_quant_numel)
    if megatron is not None:
        bs.sharding_rules = pt.parallel.strategies.megatron_transformer_rules(
            **megatron)
    cp = pt.CompiledProgram(main).with_data_parallel(
        loss_name=out["loss"].name, build_strategy=bs, mesh=m)
    params = sorted(p.name for p in main.all_parameters())
    losses, fetches, first_grads, counts = [], [], {}, []
    for i, feed in enumerate(feeds):
        names = [out["loss"]] + list(out["fetch"])
        if grads and i == 0:
            names += [f"{p}@GRAD" for p in params]
        res = exe.run(cp, feed=feed, fetch_list=names, scope=scope)
        losses.append(float(np.asarray(res[0]).reshape(-1)[0]))
        fetches.append([np.asarray(r).copy() for r in
                        res[1:1 + len(out["fetch"])]])
        if grads and i == 0:
            first_grads = {p: np.asarray(g).copy() for p, g in
                           zip(params, res[1 + len(out["fetch"]):])}
        counts.append(cp.collective_counts())
    res = {"losses": losses, "fetches": fetches,
           "state": cases._logical(main, scope), "grads": first_grads,
           "counts": counts, "collective_ms": cp.collective_ms()}
    if local_bytes:
        held = {}
        for p in params:
            v = scope.find_var(p)
            loc = v.to_local() if isinstance(v, DTensor) else v
            held[p] = (loc.numel() * loc.element_size(),
                       logical_value(v).numel() * loc.element_size())
        res["bytes"] = held
    return res


# the tiny Transformer of the data-parallel tests with two layers and
# four heads, in the forms the Megatron rules meet: separate QKV and the
# soft-label CE (the decoder's cross attention composed from matmul and
# softmax); fused QKV and the fused vocab CE; the head-major layout
MP_TRANSFORMER = dict(cases.TINY_TRANSFORMER, n_layer=2, n_head=4,
                      d_model=32, d_inner_hid=64)
MP_FORMS = {"plain": {},
            "fused_qkv_ce": dict(fused_qkv=True, use_fused_ce=True),
            "head_major": dict(head_major=True, fused_qkv=True)}


def _transformer_form(fluid, form):
    m = cases._models(fluid, "transformer")
    out = m.build_model(**dict(MP_TRANSFORMER, **MP_FORMS[form]))
    return {"loss": out["loss"], "fetch": []}


for _form in MP_FORMS:
    cases.BUILDERS[f"mp_transformer_{_form}"] = (
        lambda fluid, _f=_form: _transformer_form(fluid, _f))


def transformer_feeds(steps=3, batch=8, seed=0):
    from paddle_tpu_torch.models import transformer as tt

    a = MP_TRANSFORMER
    rng = np.random.RandomState(seed)
    out = []
    for i in range(steps):
        feed = tt.make_fake_batch(batch, a["max_length"],
                                  a["src_vocab_size"], a["trg_vocab_size"],
                                  seed=seed + i)
        feed["src_len"] = rng.randint(1, a["max_length"] + 1,
                                      batch).astype(np.int32)
        feed["trg_len"] = rng.randint(1, a["max_length"] + 1,
                                      batch).astype(np.int32)
        out.append(feed)
    return out


# -- sequence parallelism ------------------------------------------------------

def ring_functional(rank, world, strategy, q, k, v, do, causal, layout="nhtd",
                    n_head=None, sp=2):
    """ring_attention / ulysses_attention on this rank's T chunks of
    q/k/v (float64 for the gradients' check), differentiated against
    this rank's chunk of `do`: (this rank's o, dq, dk, dv chunks)."""
    import importlib

    # the package's `ring_attention` is the function, as the reference's
    ra = importlib.import_module("paddle_tpu_torch.parallel.ring_attention")

    mesh = pt.parallel.make_mesh({"sp": sp})
    if not mesh.member:
        return None
    t_axis = 1 if layout == "nthd" else 2
    me = mesh.coordinate("sp")

    def chunk(a):
        t = torch.as_tensor(a)
        size = t.shape[t_axis] // sp
        return t.narrow(t_axis, me * size, size).contiguous()

    ql, kl, vl = (chunk(a).requires_grad_() for a in (q, k, v))
    fn = ra.ulysses_attention if strategy == "ulysses" else ra.ring_attention
    ra.offset_launches.clear()
    o = fn(ql, kl, vl, mesh, axis="sp", causal=causal, layout=layout,
           n_head=n_head)
    dq, dk, dv = torch.autograd.grad(o, (ql, kl, vl), chunk(do))
    return {"o": o.detach().numpy(), "dq": dq.numpy(), "dk": dk.numpy(),
            "dv": dv.numpy(), "offsets": dict(ra.offset_launches)}


def sp_program(fluid, strategy="ring", n=2, h=2, t=32, d=8, dp_feed=False):
    """tests/test_ring_attention.py's fluid programs (:101-150, :153-182):
    an fc to head-grouped QKV, flash_attention(causal,
    sequence_parallel=...), mean of squares, SGD."""
    layers = fluid.layers
    x = layers.data("x", shape=[n, t, h * d], append_batch_size=False)
    qkv = layers.fc(x, size=3 * h * d, num_flatten_dims=2, bias_attr=False,
                    name="attn_qkv")
    r = layers.reshape(qkv, shape=[0, 0, h, 3 * d])
    r = layers.transpose(r, perm=[0, 2, 1, 3])
    q = layers.slice(r, axes=[3], starts=[0], ends=[d])
    k = layers.slice(r, axes=[3], starts=[d], ends=[2 * d])
    v = layers.slice(r, axes=[3], starts=[2 * d], ends=[3 * d])
    att = layers.flash_attention(q, k, v, causal=True,
                                 sequence_parallel=strategy)
    loss = layers.reduce_mean(layers.square(att))
    fluid.optimizer.SGD(learning_rate=0.5).minimize(loss)
    return {"loss": loss, "fetch": []}


cases.BUILDERS["sp_ring"] = lambda fluid: sp_program(fluid, True)
cases.BUILDERS["sp_ulysses"] = lambda fluid: sp_program(fluid, "ulysses",
                                                        h=4, d=4)


def sp_bias(fluid):
    """tests/test_ring_attention.py:185-215: a Bias refused."""
    layers = fluid.layers
    q = layers.data("q", shape=[2, 2, 16, 4], append_batch_size=False)
    bias = layers.data("b", shape=[2, 1, 16, 16], append_batch_size=False)
    o = layers.flash_attention(q, q, q, bias=bias, causal=True,
                               sequence_parallel=True)
    loss = layers.reduce_mean(o)
    return {"loss": loss, "fetch": []}


def sp_heads(fluid):
    """Ulysses with 3 heads on sp = 2: refused."""
    layers = fluid.layers
    q = layers.data("q", shape=[2, 3, 16, 4], append_batch_size=False)
    o = layers.flash_attention(q, q, q, causal=True,
                               sequence_parallel="ulysses")
    return {"loss": layers.reduce_mean(o), "fetch": []}


def sp_length(fluid):
    """T = 15 on sp = 2: refused."""
    layers = fluid.layers
    q = layers.data("q", shape=[2, 2, 15, 4], append_batch_size=False)
    o = layers.flash_attention(q, q, q, causal=True, sequence_parallel=True)
    return {"loss": layers.reduce_mean(o), "fetch": []}


for _b in (sp_bias, sp_heads, sp_length):
    cases.BUILDERS[_b.__name__] = _b


def forward_refusal(rank, world, model, feed, mesh):
    """The error message of one forward-only run of `model` on `mesh`
    (None: it ran); a rank outside the mesh returns None."""
    main, startup, out = cases.build(pt, model)
    scope = pt.Scope()
    exe = pt.Executor(pt.CPUPlace())
    exe.run(startup, scope=scope)
    m = pt.parallel.make_mesh(mesh)
    if not m.member:
        return None
    cp = pt.CompiledProgram(main).with_data_parallel(mesh=m)
    try:
        exe.run(cp, feed=feed, fetch_list=[out["loss"]], scope=scope)
    except (ValueError, NotImplementedError) as e:
        return f"{type(e).__name__}: {e}"
    return None


# -- pipeline parallelism ------------------------------------------------------

PP_TRANSFORMER = dict(src_vocab_size=128, trg_vocab_size=128, max_length=16,
                      n_head=2, d_model=32, d_inner_hid=64, dropout=0.0,
                      with_optimizer=True, learning_rate=0.5,
                      warmup_steps=10, label_smooth_eps=0.1)


def _pp_transformer(fluid, pipeline=True, n_layer=4, recompute=False):
    """tests/test_pipeline_engine.py's Transformer (:21-34)."""
    m = cases._models(fluid, "transformer")
    out = m.build_model(n_layer=n_layer, pipeline=pipeline,
                        recompute=recompute, **PP_TRANSFORMER)
    return {"loss": out["loss"], "fetch": []}


cases.BUILDERS["pp_transformer"] = _pp_transformer
cases.BUILDERS["pp_transformer_plain"] = \
    lambda fluid: _pp_transformer(fluid, pipeline=False)
cases.BUILDERS["pp_transformer_recompute"] = \
    lambda fluid: _pp_transformer(fluid, recompute=True)
cases.BUILDERS["pp_transformer_l3"] = \
    lambda fluid: _pp_transformer(fluid, n_layer=3)
cases.BUILDERS["pp_transformer_l2"] = \
    lambda fluid: _pp_transformer(fluid, n_layer=2)


def pp_unequal(fluid):
    """tests/test_pipeline_engine.py:138-157: segments that differ."""
    layers = fluid.layers
    x = layers.data("x", shape=[8])
    with fluid.pipeline_scope():
        with fluid.pipeline_segment():
            x = layers.fc(x, size=8, act="relu")
        with fluid.pipeline_segment():
            x = layers.fc(x, size=8, act="tanh")
    loss = layers.mean(x)
    fluid.optimizer.SGD(learning_rate=0.1).minimize(loss)
    return {"loss": loss, "fetch": []}


cases.BUILDERS["pp_unequal"] = pp_unequal


def pp_feed():
    from paddle_tpu_torch.models import transformer as tt

    return tt.make_fake_batch(8, max_length=16, src_vocab=128,
                              trg_vocab=128)


def train_pp(rank, world, model, feeds, arrays, mesh, micro=0,
             held=False):
    """Steps of `model` on a mesh with a pp axis (pipeline_microbatches
    `micro`): losses, logical state, and (`held`) the bytes of the
    tagged layers' parameters this rank holds against their total."""
    from paddle_tpu_torch.parallel.pipeline_engine import StageHeld

    main, startup, out = cases.build(pt, model)
    scope = cases._scope_from(arrays, main)
    exe = pt.Executor(pt.CPUPlace())
    m = pt.parallel.make_mesh(mesh)
    if not m.member:
        return None
    bs = pt.BuildStrategy()
    bs.pipeline_microbatches = micro
    cp = pt.CompiledProgram(main).with_data_parallel(
        loss_name=out["loss"].name, build_strategy=bs, mesh=m)
    losses = []
    for feed in feeds:
        (lv,) = exe.run(cp, feed=feed, fetch_list=[out["loss"]],
                        scope=scope)
        losses.append(float(np.asarray(lv).reshape(-1)[0]))
    res = {"losses": losses, "state": cases._logical(main, scope)}
    if held:
        params = {p.name for p in main.all_parameters()}
        mine = total = 0
        for n, v in scope.vars.items():
            if isinstance(v, StageHeld) and n in params:
                size = int(np.prod(v.shape)) * v.dtype.itemsize
                total += size
                mine += size if v.value is not None else 0
        res["held"] = (mine, total)
    return res


def gpipe_case(rank, world, mesh, params, micro_x, micro_y=None,
               scatter=False, batch_axis=None, pytree_bias=None):
    """parallel.gpipe / gpipe_loss_and_grad on this rank's stage slice
    of `params` ({"w": (S, D, D), "b": (S, D)} numpy); micro_x whole
    (or, with `scatter`, this rank's n_micro/S microbatches); with
    `batch_axis` this rank's rows of each microbatch."""
    from paddle_tpu_torch.parallel import gpipe, gpipe_loss_and_grad

    m = pt.parallel.make_mesh(mesh)
    if not m.member:
        return None
    me = m.coordinate("pp")
    p = {k: torch.as_tensor(v[me:me + 1]) for k, v in params.items()}
    x = torch.as_tensor(micro_x)
    y = None if micro_y is None else torch.as_tensor(micro_y)
    if batch_axis:
        d, nd = m.coordinate(batch_axis), m.shape[batch_axis]
        x = x.chunk(nd, dim=1)[d]
        y = y.chunk(nd, dim=1)[d]
    if scatter:
        s = m.shape["pp"]
        x = x.chunk(s, dim=0)[me]
        y = None if y is None else y.chunk(s, dim=0)[me]

    def stage_fn(q, xt):
        return torch.tanh(xt @ q["w"] + q["b"])

    if pytree_bias is not None:
        b = torch.as_tensor(pytree_bias)

        def stage2(q, xt):
            h, bb = xt
            return (torch.tanh(h @ q["w"] + q["b"] + bb), bb)

        out, b_out = gpipe(stage2, m)(p, (x, b))
        return {"out": out.numpy(), "bias": b_out.numpy()}
    if y is None:
        return {"out": gpipe(stage_fn, m, scatter_inputs=scatter)(
            p, x).numpy()}

    def loss_fn(o, t):
        return torch.mean((o - t) ** 2)

    lv, g = gpipe_loss_and_grad(stage_fn, loss_fn, m, batch_axis=batch_axis,
                                scatter_inputs=scatter)(p, x, y)
    return {"loss": float(lv), "grads": {k: v.numpy() for k, v in
                                         g.items()}, "stage": me}


# -- expert parallelism --------------------------------------------------------

def moe_net(fluid, cap=4.0, experts=4):
    """tests/test_moe.py's expert-parallel program (:179-216, :219-291):
    a switch-MoE block, a 3-way classifier, CE + 0.01 x the
    load-balance loss, Momentum."""
    layers = fluid.layers
    x = layers.data("x", shape=[8])
    y = layers.data("y", shape=[1], dtype="int64")
    h, aux, frac = layers.switch_moe(x, num_experts=experts, d_inner=16,
                                     capacity_factor=cap)
    logits = layers.fc(h, size=3)
    ce = layers.mean(layers.softmax_with_cross_entropy(logits, y))
    loss = layers.elementwise_add(
        ce, layers.scale(layers.reduce_sum(aux), scale=0.01))
    fluid.optimizer.MomentumOptimizer(learning_rate=0.05,
                                      momentum=0.9).minimize(loss)
    return {"loss": loss, "fetch": [frac]}


cases.BUILDERS["moe_net"] = moe_net
# capacity 1.0: tokens overflow their expert, so the grouped routing of an
# ep mesh differs from the ungrouped one
cases.BUILDERS["moe_net_tight"] = lambda fluid: moe_net(fluid, cap=1.0)


def moe_feeds(steps=4, rows=16, seed=4):
    rng = np.random.RandomState(seed)
    xv = rng.randn(rows, 8).astype(np.float32)
    yv = rng.randint(0, 3, (rows, 1)).astype(np.int64)
    return [{"x": xv, "y": yv}] * steps


def moe_grouped_plain(rank, world, model, feeds, arrays, groups):
    """The port's one-process plain version of the grouped routing: the
    program's moe_ffn runs `ops.moe.moe_grouped(groups=...)` (the
    function the op computes on an ep mesh), with the drop counts."""
    from paddle_tpu_torch.ops import moe as M

    real = M.moe_grouped

    def grouped(*a, **kw):
        kw["groups"] = groups
        return real(*a, **kw)

    M.moe_grouped = grouped
    M.drop_log = []
    try:
        res = cases.train(rank, world, model, feeds, arrays)
        res["drops"] = [int(t) for t in M.drop_log]
    finally:
        M.moe_grouped = real
        M.drop_log = None
    return res


def train_moe(rank, world, model, feeds, arrays, mesh, moe_axis="ep"):
    """`train_mp` with megatron_transformer_rules(moe_axis=...), the
    drop counts of each moe_ffn call and the expert weights' local
    shapes."""
    from paddle_tpu_torch.ops import moe as M
    from torch.distributed.tensor import DTensor

    M.drop_log = []
    try:
        res = train_mp(rank, world, model, feeds, arrays, mesh,
                       megatron=dict(moe_axis=moe_axis))
        if res is None:
            return None
        drops = [int(t) for t in M.drop_log]
    finally:
        M.drop_log = None
    res["drops"] = drops
    return res


# -- checkpoints across meshes --------------------------------------------------

def load_local_shapes(rank, world, model, dirname, mesh=None, rules=None):
    """load_sharded onto `mesh` (None: whole): every persistable var's
    logical value and, for a DTensor, this rank's local shape."""
    from torch.distributed.tensor import DTensor

    main, startup, out = cases.build(pt, model)
    scope = pt.Scope()
    exe = pt.Executor(pt.CPUPlace())
    m = None
    if mesh is not None:
        m = pt.parallel.make_mesh(mesh)
        if not m.member:
            return None
        bs = cases.build_strategy(pt, None, False, rules, 1)
        pt.CompiledProgram(main).with_data_parallel(
            loss_name=out["loss"].name, build_strategy=bs, mesh=m)
    with pt.scope_guard(scope):
        pt.io.load_sharded(exe, dirname, main_program=main, mesh=m)
    shapes = {n: tuple(v.to_local().shape) for n, v in scope.vars.items()
              if isinstance(v, DTensor)}
    return {"loaded": cases._logical(main, scope), "local": shapes}


def save_mp(rank, world, model, feeds, arrays, mesh, dirname, rules):
    """Train on a mesh with model axes, then save_sharded from every
    rank: the logical state saved."""
    return cases.save_ckpt(rank, world, model, feeds, arrays, mesh, dirname,
                           rules=rules)
