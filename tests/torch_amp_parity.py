"""Shared pieces of the bf16 AMP parity tests (tests/test_torch_amp*.py):
three training steps of one model in the JAX package (float32 and AMP)
and in the port (AMP) from the same startup scope and batch, with the
dtypes each op receives after the AMP cast recorded on both sides.

The reference is compiled by `jax.jit`, and XLA's algebraic simplifier
folds a float32 convert that follows a bf16 dot or convolution into the
product (on the CPU: `(x_bf16 @ w_bf16).astype(f32) + b` comes back
unrounded), so the compiled reference skips roundings its ops specify.
The port runs op by op and rounds every bf16 output as the ops say.
`keep_reference_roundings` makes the reference round where its ops do:
every bf16 input and output of a white-list op passes through
`jax.lax.optimization_barrier` (its cotangent too), which XLA cannot
fold a convert through.  Nothing in the JAX package changes: the test
wraps its registry entries and its `amp.cast_ins_for_op` with
monkeypatch.  With it, BERT's losses agree to 5e-7 (without it, 8e-4).

The flash ops of both programs get `use_pallas=True`: with it unset the
reference takes its XLA composition (bf16 logits), while the port takes
its kernels' semantics whatever `use_pallas` says (float32 scores); with
it set the reference runs its Pallas kernel in interpret mode, whose
bf16 semantics the port's kernels follow.
"""

from __future__ import annotations

import json

import jax
import jax.numpy as jnp
import numpy as np
import torch

import paddle_tpu as jf
import paddle_tpu_torch as tf
from paddle_tpu import amp as jamp
from paddle_tpu.core import registry as jreg
from paddle_tpu_torch import amp as tamp
from paddle_tpu_torch.convert import params_from_arrays


@jax.custom_vjp
def _keep(x):
    return jax.lax.optimization_barrier(x)


def _keep_fwd(x):
    return jax.lax.optimization_barrier(x), None


def _keep_bwd(_, g):
    return (jax.lax.optimization_barrier(g),)


_keep.defvjp(_keep_fwd, _keep_bwd)


def _kept(v):
    return _keep(v) if getattr(v, "dtype", None) == jnp.bfloat16 else v


def _signature(ins):
    return tuple(sorted(
        (slot, tuple(str(v.dtype).replace("torch.", "")
                     if hasattr(v, "dtype") else type(v).__name__
                     for v in vals))
        for slot, vals in ins.items()))


def keep_reference_roundings(monkeypatch):
    """Wrap the reference's white-list ops and its cast so their bf16
    values pass through an optimization barrier (module docstring)."""
    for op in jamp.DEFAULT_WHITE:
        impl = jreg._REGISTRY.get(op)
        if impl is None:
            continue

        def wrapped(ctx, ins, attrs, _impl=impl):
            outs = _impl(ctx, ins, attrs)
            return {s: [_kept(v) for v in vs] for s, vs in outs.items()}

        monkeypatch.setitem(jreg._REGISTRY, op, wrapped)


def record_casts(monkeypatch, module, log, keep=False):
    """Record (op type, input dtypes after the cast) of every op the
    executor dispatches through `module.cast_ins_for_op`; with `keep`,
    also pass a white op's bf16 inputs through the barrier."""
    orig = module.cast_ins_for_op

    def rec(op_type, ins, lists):
        ins = orig(op_type, ins, lists)
        if keep and op_type in lists.white_list:
            ins = {s: [_kept(v) for v in vs] for s, vs in ins.items()}
        log.add((op_type, _signature(ins)))
        return ins

    monkeypatch.setattr(module, "cast_ins_for_op", rec)


def build(fluid, build_fn, pallas=True, **kw):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        out = build_fn(**kw)
    if pallas:
        for op in main.global_block().ops:
            if op.type == "flash_attention":
                op.desc.attrs["use_pallas"] = True
        main._bump()
    return main, startup, out


def program_json(program):
    return json.dumps(program.to_dict(), sort_keys=True)


def three_runs(monkeypatch, jbuild, tbuild, feed, steps=3, lr_var=None,
               extra=()):
    """Run `steps` steps of the reference in float32 (`jbuild(False)`),
    of the reference with AMP (`jbuild(True)`) and of the port with AMP
    (`tbuild(True)`), each from the reference's float32 startup scope.
    Returns {side: (losses, step-1 grads, parameters after the last step
    as the scope holds them, learning rates)}, the startup arrays, the
    three main programs, and the cast logs ({"ref", "port"}: the set of
    (op type, input dtypes after the cast) of every op the AMP runs
    dispatched).  The variables named in `extra` are fetched at step 1
    and kept beside the gradients, under their own names."""
    keep_reference_roundings(monkeypatch)
    logs = {"ref": set(), "port": set()}
    record_casts(monkeypatch, jamp, logs["ref"], keep=True)
    record_casts(monkeypatch, tamp, logs["port"])
    arrays, runs, progs = None, {}, {}
    for side, fluid, make, amp in (("ref_f32", jf, jbuild, False),
                                   ("ref_amp", jf, jbuild, True),
                                   ("port_amp", tf, tbuild, True)):
        main, startup, out = make(amp)
        progs[side] = main
        if arrays is None:
            jscope = jf.Scope()
            jf.Executor(jf.CPUPlace()).run(startup, scope=jscope)
            arrays = {n: np.asarray(v) for n, v in jscope.vars.items()
                      if v is not None}
        if fluid is jf:
            scope = jf.Scope()
            for n, a in arrays.items():
                scope.set_var(n, jnp.asarray(a))
            exe = jf.Executor(jf.CPUPlace())
        else:
            scope = tf.Scope()
            for n, t in params_from_arrays(arrays, "cpu",
                                           program=main).items():
                scope.set_var(n, t)
            exe = tf.Executor(tf.CPUPlace())
        params = sorted(p.name for p in main.all_parameters())
        names = [f"{p}@GRAD" for p in params] + list(extra)
        fetch = [out["loss"].name] + names + ([lr_var] if lr_var else [])
        losses, grads, lrs = [], None, []
        for step in range(steps):
            got = exe.run(main, feed=feed, fetch_list=fetch, scope=scope)
            losses.append(float(np.asarray(got[0]).reshape(-1)[0]))
            if lr_var:
                lrs.append(float(np.asarray(got[-1]).reshape(-1)[0]))
            if step == 0:
                grads = {n.replace("@GRAD", ""): np.asarray(g) for n, g in
                         zip(names, got[1:1 + len(names)])}
        state = {p: scope.find_var(p) for p in params}
        runs[side] = (np.array(losses), grads, state, lrs)
    return runs, arrays, progs, logs


def l2_distance(a, b):
    """|a - b|_2 over all parameters' concatenated values."""
    return float(np.sqrt(sum(np.sum((a[p].astype(np.float64)
                                     - b[p].astype(np.float64)) ** 2)
                             for p in a)))


def check_amp_parity(runs, arrays, loss_share=0.25):
    """The port's AMP step 1 against the reference's: the gradients as a
    whole (L2 over every parameter's gradient) within a quarter of the
    reference's own AMP-vs-float32 difference on the same step, and the
    loss within `loss_share` of it.  Returns the two ratios."""
    lf, la, lp = (runs[s][0] for s in ("ref_f32", "ref_amp", "port_amp"))
    gf, ga, gp = ({p: runs[s][1][p] for p in runs[s][2]}
                  for s in ("ref_f32", "ref_amp", "port_amp"))
    loss_ratio = abs(lp[0] - la[0]) / abs(la[0] - lf[0])
    grad_ratio = l2_distance(gp, ga) / l2_distance(ga, gf)
    assert loss_ratio <= loss_share, (lp[0], la[0], lf[0])
    assert grad_ratio <= 0.25, grad_ratio
    for p, g in gp.items():
        assert g.dtype == np.float32 and np.isfinite(g).all(), p
    return loss_ratio, grad_ratio


def check_state(runs, arrays, bound):
    """After the steps: every port parameter float32, within `bound` of
    the reference's AMP run, and moved from its start."""
    moved = 0.0
    for p, t in runs["port_amp"][2].items():
        assert t.dtype == torch.float32, p
        a = t.numpy()
        b = np.asarray(runs["ref_amp"][2][p], np.float32)
        assert np.abs(a - b).max() <= bound, (p, np.abs(a - b).max())
        moved = max(moved, float(np.abs(a - arrays[p]).max()))
    assert moved > 0
