"""The port's side of the data-parallel tests: model builders both
packages share, and the cases a `torch_dist_harness.RankGroup` runs on
every rank of a gloo group.

The builders take the package (`fluid`) and build the same program in
either; the test files build the reference's with them in the pytest
process and hand the reference's startup values and the feeds (numpy)
to the cases.  This module imports torch, numpy and the port only: the
worker processes have no jax.
"""

from __future__ import annotations

import importlib
import os

import numpy as np
import torch

import paddle_tpu_torch as pt

# -- builders --------------------------------------------------------------

TINY_TRANSFORMER = dict(src_vocab_size=64, trg_vocab_size=64, max_length=8,
                        n_layer=1, n_head=2, d_model=16, d_inner_hid=32,
                        dropout=0.0, use_flash=True, warmup_steps=100)
TINY_DEEPFM = dict(num_fields=4, num_dense=3, vocab_size=50,
                   embedding_dim=4, dnn_hidden=(16,), learning_rate=1e-2)
TINY_BERT = dict(vocab_size=64, max_len=8, n_layer=1, n_head=2, d_model=16,
                 d_inner=32, dropout=0.0, use_flash=True)
SPARSE_V, SPARSE_D, SPARSE_B, SPARSE_F = 64, 16, 32, 4


def mlp(fluid):
    """tests/test_parallel.py's classifier MLP (:21-28)."""
    layers = fluid.layers
    x = layers.data(name="x", shape=[16], dtype="float32")
    y = layers.data(name="y", shape=[1], dtype="int64")
    h = layers.fc(x, size=32, act="relu")
    logits = layers.fc(h, size=4)
    loss = layers.mean(layers.softmax_with_cross_entropy(logits, y))
    fluid.optimizer.SGDOptimizer(learning_rate=0.1).minimize(loss)
    return {"loss": loss, "fetch": [logits]}


def reg_mlp(fluid, opt="sgd"):
    """tests/test_grad_sync.py's regression MLP (:49-60): its 128 x 128
    weight is above the int8 exchange's floor."""
    layers = fluid.layers
    x = layers.data("x", shape=[32], dtype="float32")
    y = layers.data("y", shape=[1], dtype="float32")
    h = layers.fc(x, size=128, act="relu")
    h = layers.fc(h, size=128, act="relu")
    pred = layers.fc(h, size=1)
    loss = layers.mean(layers.square_error_cost(pred, y))
    if opt == "adam":
        fluid.optimizer.AdamOptimizer(learning_rate=0.01).minimize(loss)
    elif opt == "lars":
        fluid.optimizer.LarsMomentumOptimizer(
            learning_rate=0.1, momentum=0.9).minimize(loss)
    else:
        fluid.optimizer.SGD(learning_rate=0.1).minimize(loss)
    return {"loss": loss, "fetch": [pred]}


def reg_mlp_adam(fluid):
    return reg_mlp(fluid, "adam")


def reg_mlp_lars(fluid):
    return reg_mlp(fluid, "lars")


def sum_mlp(fluid):
    """A `reduce_sum` loss: its global gradient is the SUM of the
    ranks' shard gradients, a mean loss's their mean."""
    layers = fluid.layers
    x = layers.data("x", shape=[32], dtype="float32")
    y = layers.data("y", shape=[1], dtype="float32")
    pred = layers.fc(layers.fc(x, size=16, act="relu"), size=1)
    loss = layers.reduce_sum(layers.square_error_cost(pred, y))
    fluid.optimizer.SGD(learning_rate=0.01).minimize(loss)
    return {"loss": loss, "fetch": [pred]}


def max_mlp(fluid):
    """A loss through `reduce_max` over the batch: a reduction the
    port's global-batch mode has no cross-rank form of (C16)."""
    layers = fluid.layers
    x = layers.data("x", shape=[32], dtype="float32")
    y = layers.data("y", shape=[1], dtype="float32")
    pred = layers.fc(x, size=1)
    loss = layers.reduce_max(layers.square_error_cost(pred, y))
    fluid.optimizer.SGD(learning_rate=0.01).minimize(loss)
    return {"loss": loss, "fetch": []}


def time_major(fluid, use=None):
    """A feed turned time-major ([B, T, D] to [T, B, D]: its batch on
    dim 1, class "other"), then `use` on it ("dropout", "shape" or
    None) and a mean over time: dropout's and shape's global-batch
    forms take the batch as dim 0, so the default mode refuses them
    (C16); the means run."""
    layers = fluid.layers
    x = layers.data("x", shape=[4, 8], dtype="float32")
    y = layers.data("y", shape=[1], dtype="float32")
    xt = layers.transpose(x, perm=[1, 0, 2])
    if use == "dropout":
        xt = layers.dropout(xt, dropout_prob=0.5)
    pred = layers.fc(layers.reduce_mean(xt, dim=0), size=1)
    loss = layers.mean(layers.square_error_cost(pred, y))
    if use == "shape":
        size = layers.cast(layers.shape(xt), "float32")
        loss = loss + layers.reduce_sum(size) * 0.0
    fluid.optimizer.SGD(learning_rate=0.01).minimize(loss)
    return {"loss": loss, "fetch": []}


def time_major_dropout(fluid):
    return time_major(fluid, "dropout")


def time_major_shape(fluid):
    return time_major(fluid, "shape")


def bn_net(fluid):
    """A tiny batch-norm network with a top-1 accuracy: training
    normalises with the global batch's statistics."""
    layers = fluid.layers
    x = layers.data("x", shape=[3, 6, 6], dtype="float32")
    y = layers.data("y", shape=[1], dtype="int64")
    c = layers.conv2d(x, num_filters=4, filter_size=3, padding=1)
    c = layers.batch_norm(c, act="relu")
    h = layers.fc(c, size=8)
    h = layers.batch_norm(h, act="relu")
    logits = layers.fc(h, size=4)
    loss = layers.mean(layers.softmax_with_cross_entropy(logits, y))
    acc = layers.accuracy(input=layers.softmax(logits), label=y)
    fluid.optimizer.MomentumOptimizer(learning_rate=0.1,
                                      momentum=0.9).minimize(loss)
    return {"loss": loss, "fetch": [acc, logits]}


def sparse_net(fluid):
    """tests/test_grad_sync.py's SparseGrad program (:145-158): a
    fixed-shape feed (no -1 batch dim) and an is_sparse table."""
    layers = fluid.layers
    ids = layers.data("ids", shape=[SPARSE_B, SPARSE_F], dtype="int64",
                      append_batch_size=False)
    y = layers.data("y", shape=[SPARSE_B, 1], append_batch_size=False)
    emb = layers.embedding(
        ids, size=[SPARSE_V, SPARSE_D], is_sparse=True,
        param_attr=fluid.ParamAttr(
            name="tbl", initializer=fluid.initializer.Constant(0.05)))
    s = layers.reduce_sum(emb, dim=1)
    h = layers.fc(s, size=256, act="relu")
    p = layers.fc(h, size=1)
    loss = layers.reduce_mean(layers.square_error_cost(p, y))
    fluid.optimizer.SGD(learning_rate=0.1).minimize(loss)
    return {"loss": loss, "fetch": []}


def _models(fluid, name):
    return importlib.import_module(f"{fluid.__name__}.models.{name}")


def transformer(fluid):
    out = _models(fluid, "transformer").build_model(**TINY_TRANSFORMER)
    return {"loss": out["loss"], "fetch": []}


def deepfm(fluid):
    out = _models(fluid, "deepfm").build_model(**TINY_DEEPFM)
    return {"loss": out["loss"], "fetch": [out["auc"]]}


def bert(fluid):
    out = _models(fluid, "bert").build_model(**TINY_BERT)
    return {"loss": out["loss"], "fetch": []}


BUILDERS = {f.__name__: f for f in (mlp, reg_mlp, reg_mlp_adam,
                                    reg_mlp_lars, sum_mlp, max_mlp, time_major,
                                    time_major_dropout, time_major_shape,
                                    bn_net,
                                    sparse_net, transformer, deepfm, bert)}


def build(fluid, model, seed=7):
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = seed
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        out = BUILDERS[model](fluid)
    return main, startup, out


def make_rules(fluid, rules):
    """A ShardingRules of `fluid` from a picklable (rules, kwargs)."""
    if rules is None:
        return None
    pats, kw = rules
    return fluid.parallel.ShardingRules(rules=pats, **kw)


def build_strategy(fluid, grad_sync=None, reduce=False, rules=None,
                   accum=1, min_quant_numel=None):
    bs = fluid.BuildStrategy()
    if grad_sync is not None:
        kw = {} if min_quant_numel is None else dict(
            min_quant_numel=min_quant_numel)
        bs.grad_sync = fluid.parallel.GradSyncConfig(grad_sync, **kw)
    if reduce:
        bs.reduce_strategy = fluid.BuildStrategy.ReduceStrategy.Reduce
    bs.sharding_rules = make_rules(fluid, rules)
    bs.gradient_accumulation_steps = accum
    return bs


# -- the port's side -----------------------------------------------------

def _scope_from(arrays, main):
    scope = pt.Scope()
    persist = {v.name for v in main.list_vars() if v.persistable}
    from paddle_tpu_torch.convert import params_from_arrays

    for n, t in params_from_arrays(
            {n: a for n, a in arrays.items() if n in persist},
            "cpu").items():
        scope.set_var(n, t)
    return scope


def _logical(main, scope):
    """Every persistable var's logical value as numpy (a DTensor's
    gather is collective: every rank calls this)."""
    from paddle_tpu_torch.parallel.data_parallel import logical_value

    out = {}
    for v in sorted(main.list_vars(), key=lambda v: v.name):
        if not v.persistable:
            continue
        val = scope.find_var(v.name)
        if isinstance(val, torch.Tensor):
            out[v.name] = logical_value(val).detach().cpu().numpy().copy()
    return out


def _np(v):
    return np.asarray(v).copy()


def train(rank, world, model, feeds, arrays, mesh=None, devices=None,
          grad_sync=None, reduce=False, rules=None, accum=1, run_accum=1,
          min_quant_numel=None, fetch=True, numerics=False, guard=False):
    """Steps of `model` on this rank (one per feed), from `arrays` (None:
    the port's own startup values):
    {"losses", "fetches", "state", "opt_bytes"}; None on a rank outside
    the mesh.  `mesh` None: the plain one-process Executor.run."""
    main, startup, out = build(pt, model)
    exe = pt.Executor(pt.CPUPlace())
    if arrays is None:
        # the port's own startup values (a seeded program: the same on
        # every rank)
        scope = pt.Scope()
        exe.run(startup, scope=scope)
    else:
        scope = _scope_from(arrays, main)
    target = main
    wrapper = None
    if numerics:
        pt.observe.enable_telemetry(main)
        pt.observe.enable_numerics(main)
    if guard:
        from paddle_tpu_torch.resilience import guard as _guard

        _guard.enable_update_guard(main)
    if mesh is not None:
        m = pt.parallel.make_mesh(mesh, devices=devices)
        if not m.member:
            return None
        bs = build_strategy(pt, grad_sync, reduce, rules, accum,
                            min_quant_numel)
        wrapper = pt.CompiledProgram(main).with_data_parallel(
            loss_name=out["loss"].name, build_strategy=bs, mesh=m)
        target = wrapper
    names = [out["loss"]] + (out["fetch"] if fetch else [])
    losses, fetches = [], []
    for feed in feeds:
        res = exe.run(target, feed=feed, fetch_list=names, scope=scope,
                      accumulation_steps=run_accum)
        losses.append(float(np.asarray(res[0]).reshape(-1)[0]))
        fetches.append([_np(r) for r in res[1:]])
    from paddle_tpu_torch.parallel.data_parallel import opt_state_bytes

    res = {"losses": losses, "fetches": fetches,
           "state": _logical(main, scope),
           "opt_bytes": opt_state_bytes(scope, main)}
    if numerics:
        from paddle_tpu_torch.observe import metrics as _m

        tel = scope.find_var(_m.TELEMETRY_VAR)
        res["telemetry"] = {k: _np(v.cpu()) for k, v in tel.items()
                            if isinstance(v, torch.Tensor)}
    return res


def refusal(rank, world, model, feed, arrays, mesh, grad_sync=None,
            reduce=False, accum=1):
    """The message of the error one step raises (None: no error), from
    `arrays` (None: the port's own startup values)."""
    main, startup, out = build(pt, model)
    exe = pt.Executor(pt.CPUPlace())
    if arrays is None:
        scope = pt.Scope()
        exe.run(startup, scope=scope)
    else:
        scope = _scope_from(arrays, main)
    m = pt.parallel.make_mesh(mesh)
    bs = build_strategy(pt, grad_sync, reduce, None, 1)
    pt.CompiledProgram(main).with_data_parallel(
        loss_name=out["loss"].name, build_strategy=bs, mesh=m)
    try:
        exe.run(main, feed=feed, fetch_list=[out["loss"]], scope=scope,
                accumulation_steps=accum)
    except (ValueError, NotImplementedError) as e:
        return f"{type(e).__name__}: {e}"
    return None


def collectives(rank, world, n, inputs, perm):
    """Every collective of parallel.collectives on a sub-mesh of the
    first n ranks; `inputs[name][r]` is rank r's array for `name`."""
    from paddle_tpu_torch.parallel import collectives as C

    mesh = pt.parallel.make_mesh({"x": n})
    if not mesh.member:
        return None

    def get(name):
        return torch.as_tensor(inputs[name][rank])

    out = {
        "psum": C.psum(get("ar")[0], "x", mesh=mesh),
        "all_reduce": C.all_reduce(get("ar"), mesh, "x"),
        "all_reduce_max": C.all_reduce(get("ar"), mesh, "x", op="max"),
        "all_reduce_mean": C.all_reduce(get("ar"), mesh, "x", op="mean"),
        "all_gather": C.all_gather(get("ag"), mesh, "x"),
        "reduce_scatter": C.reduce_scatter(get("rs"), mesh, "x"),
        "ppermute": C.ppermute(get("pp"), mesh, "x", perm),
        "all_to_all": C.all_to_all(get("a2a"), mesh, "x", split_dim=1,
                                   concat_dim=0),
        "barrier": C.barrier(mesh, "x"),
    }
    return {k: v.numpy() for k, v in out.items()}


def quantized(rank, world, n, inputs, block_size, min_quant_numel, op):
    """quantized_all_reduce_local, its psum form and the
    `quantized_all_reduce` wrapper on the first n ranks."""
    from paddle_tpu_torch.parallel import collectives as C

    mesh = pt.parallel.make_mesh({"x": n})
    if not mesh.member:
        return None
    x = torch.as_tensor(inputs[rank])
    kw = dict(block_size=block_size, min_quant_numel=min_quant_numel,
              op=op)
    return {
        "local": C.quantized_all_reduce_local(x, "x", n, mesh=mesh,
                                              **kw).numpy(),
        "psum": C.quantized_all_reduce_psum(x, "x", n, None, mesh=mesh,
                                            **kw).numpy(),
        "wrapper": C.quantized_all_reduce(x[None], mesh, "x",
                                          **kw).numpy(),
    }


def bits_or(rank, world, words):
    """observe.numerics.or_across_axis of rank r's `words[r]`."""
    from paddle_tpu_torch.observe.numerics import or_across_axis
    from paddle_tpu_torch.parallel.collectives import data_group_of

    mesh = pt.parallel.make_mesh({"dp": world})
    g = data_group_of(mesh, ("dp",))
    return or_across_axis(torch.as_tensor(words[rank]), g).numpy()


# -- checkpoints ---------------------------------------------------------

def save_ckpt(rank, world, model, feeds, arrays, mesh, dirname,
              reduce=False, rules=None):
    """Train on `mesh`, then save_sharded from every rank."""
    main, startup, out = build(pt, model)
    scope = _scope_from(arrays, main)
    exe = pt.Executor(pt.CPUPlace())
    m = pt.parallel.make_mesh(mesh)
    bs = build_strategy(pt, None, reduce, rules, 1)
    pt.CompiledProgram(main).with_data_parallel(
        loss_name=out["loss"].name, build_strategy=bs, mesh=m)
    for feed in feeds:
        exe.run(main, feed=feed, fetch_list=[out["loss"]], scope=scope)
    with pt.scope_guard(scope):
        job = pt.io.save_sharded(exe, dirname, main_program=main)
    return {"state": _logical(main, scope), "bytes": job.bytes_total,
            "files": sorted(os.listdir(dirname))}


def load_ckpt(rank, world, model, dirname, mesh=None, reduce=False,
              rules=None, feed=None, devices=None):
    """load_sharded onto `mesh` (None: whole, one device), then one
    step on `feed` if given."""
    from torch.distributed.tensor import DTensor

    main, startup, out = build(pt, model)
    scope = pt.Scope()
    exe = pt.Executor(pt.CPUPlace())
    m = None
    if mesh is not None:
        m = pt.parallel.make_mesh(mesh, devices=devices)
        if not m.member:
            return None
        bs = build_strategy(pt, None, reduce, rules, 1)
        pt.CompiledProgram(main).with_data_parallel(
            loss_name=out["loss"].name, build_strategy=bs, mesh=m)
    with pt.scope_guard(scope):
        pt.io.load_sharded(exe, dirname, main_program=main, mesh=m)
    sharded = sorted(n for n, v in scope.vars.items()
                     if isinstance(v, DTensor))
    res = {"loaded": _logical(main, scope), "sharded": sharded}
    if feed is not None:
        (lv,) = exe.run(main, feed=feed, fetch_list=[out["loss"]],
                        scope=scope)
        res["loss"] = float(np.asarray(lv).reshape(-1)[0])
        res["state"] = _logical(main, scope)
    return res


def dead_peer_save(rank, world, dirname, victim, timeout_s):
    """`victim` dies before the save; every other rank's save must end
    as a CheckpointBarrierTimeoutError naming it."""
    import time

    from paddle_tpu_torch.resilience.errors import (
        CheckpointBarrierTimeoutError)

    main, startup, out = build(pt, "mlp")
    scope = pt.Scope()
    exe = pt.Executor(pt.CPUPlace())
    exe.run(startup, scope=scope)
    if rank == victim:
        os._exit(17)
    os.environ["PADDLE_TPU_CKPT_BARRIER_TIMEOUT_S"] = str(timeout_s)
    t0 = time.monotonic()
    try:
        with pt.scope_guard(scope):
            pt.io.save_sharded(exe, dirname, main_program=main)
    except CheckpointBarrierTimeoutError as e:
        return {"error": e.as_dict(), "seconds": time.monotonic() - t0,
                "files": sorted(os.listdir(dirname))}
    finally:
        del os.environ["PADDLE_TPU_CKPT_BARRIER_TIMEOUT_S"]
    return {"error": None}


# -- the surfaces --------------------------------------------------------

def env_bootstrap(rank, world):
    """What init_distributed left: the group and the default mesh."""
    import torch.distributed as dist

    mesh = pt.parallel.get_default_mesh()
    local = np.full((2, 3), rank, np.float32)
    return {"rank": dist.get_rank(), "world": dist.get_world_size(),
            "backend": dist.get_backend(), "mesh": dict(mesh.shape),
            "env": [os.environ.get(k) for k in (
                "PADDLE_TRAINER_ID", "PADDLE_TRAINERS")],
            "global_batch": pt.parallel.global_batch(mesh, local)}


def pe_vs_compiled(rank, world, model, feeds, arrays, mesh):
    """ParallelExecutor against CompiledProgram, run for run."""
    out_pe, out_cp = [], []
    for use_pe, acc in ((True, out_pe), (False, out_cp)):
        main, startup, out = build(pt, model)
        scope = _scope_from(arrays, main)
        m = pt.parallel.make_mesh(mesh)
        if use_pe:
            pe = pt.ParallelExecutor(use_cuda=False,
                                     loss_name=out["loss"].name,
                                     main_program=main, scope=scope, mesh=m)
            for feed in feeds:
                acc.append(_np(pe.run([out["loss"]], feed=feed)[0]))
            acc.append(pe.device_count)
        else:
            exe = pt.Executor(pt.CPUPlace())
            cp = pt.CompiledProgram(main).with_data_parallel(
                loss_name=out["loss"].name, mesh=m)
            for feed in feeds:
                acc.append(_np(exe.run(cp, feed=feed,
                                       fetch_list=[out["loss"]],
                                       scope=scope)[0]))
            acc.append(m.size)
    return {"pe": out_pe, "cp": out_cp}


def trainer_dp(rank, world, ckpt_dir, batches, mesh):
    """contrib.Trainer on a dp mesh with the int8 exchange, checkpoints
    on; then a second Trainer resumes from them through
    load_sharded(mesh=)."""
    from paddle_tpu_torch.contrib import (CheckpointConfig, EndStepEvent,
                                          Trainer)

    def train_func():
        layers = pt.layers
        x = layers.data(name="x", shape=[16], dtype="float32")
        y = layers.data(name="y", shape=[1], dtype="float32")
        pred = layers.fc(layers.fc(x, size=64, act="relu"), size=1)
        return layers.mean(layers.square_error_cost(pred, y))

    def run(n_batches, **kw):
        bs = pt.BuildStrategy()
        bs.grad_sync = "int8"
        t = Trainer(train_func,
                    lambda: pt.optimizer.SGD(learning_rate=0.05),
                    place=pt.CPUPlace(), mesh=pt.parallel.make_mesh(mesh),
                    build_strategy=bs, **kw)
        losses = []

        def handler(e):
            if isinstance(e, EndStepEvent):
                losses.append(float(np.asarray(e.metrics[0]).reshape(-1)[0]))

        t.train(num_epochs=1, reader=lambda: iter(batches[:n_batches]),
                event_handler=handler)
        state = _logical(t.train_program, t.scope)
        info = {"losses": losses, "state": state,
                "compiled": t.train_program._compiled_wrapper is not None,
                "mode": t.train_program._grad_sync.mode}
        t.stop()
        return info

    first = run(len(batches), checkpoint_config=CheckpointConfig(
        ckpt_dir, step_interval=2, max_num_checkpoints=5))
    resumed = run(0, checkpoint_config=CheckpointConfig(
        ckpt_dir, step_interval=2, max_num_checkpoints=5))
    return {"first": first, "resumed": resumed}


def infer(rank, world, model, feed, arrays, mesh):
    """The test clone of `model`'s program on one process and on
    `mesh`: the fetches of the loss and the first fetch var."""
    main, startup, out = build(pt, model)
    test = main.clone(for_test=True)
    scope = _scope_from(arrays, main)
    exe = pt.Executor(pt.CPUPlace())
    names = [out["loss"].name, out["fetch"][-1].name]
    single = exe.run(test, feed=feed, fetch_list=names, scope=scope)
    m = pt.parallel.make_mesh(mesh)
    if not m.member:
        return None
    cp = pt.CompiledProgram(test).with_data_parallel(mesh=m)
    got = exe.run(cp, feed=feed, fetch_list=names, scope=scope)
    return {"single": single, "dp": got}
