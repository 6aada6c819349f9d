"""Shared pieces of the resilience, telemetry and checkpoint parity tests
(tests/test_torch_{guard,telemetry,io,resume,signatures}.py): one
program built the same way in the JAX package and in the port, both
scopes holding the reference's startup values, and the small linear
regression of tests/test_resilience.py and tests/test_observe.py.

The reference's tests build the regression with `square_error_cost`,
which the port does not register yet (ROADMAP A step 8a); both
packages here build `mean(square(pred - y))`, the same function.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

import paddle_tpu as jf
import paddle_tpu_torch as tf
from paddle_tpu_torch.convert import params_from_arrays

PKGS = {"ref": jf, "port": tf}


def build(fluid, body, seed=None):
    """(main, startup, out) of `body(fluid)` built in one package."""
    main, startup = fluid.Program(), fluid.Program()
    if seed is not None:
        main.random_seed = seed
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        out = body(fluid)
    return main, startup, out


def reference_arrays(startup):
    """The reference's startup values, as numpy."""
    scope = jf.Scope()
    jf.Executor(jf.CPUPlace()).run(startup, scope=scope)
    return {n: np.asarray(v) for n, v in scope.vars.items()
            if v is not None}


def scope_of(fluid, arrays, program):
    """A fresh scope of `fluid` holding those of `arrays` that are
    persistable vars of `program` (the port's through
    convert.params_from_arrays, on the CPU)."""
    scope = fluid.Scope()
    persist = {v.name for v in program.list_vars() if v.persistable}
    arrays = {n: a for n, a in arrays.items() if n in persist}
    if fluid is tf:
        for n, t in params_from_arrays(arrays, "cpu").items():
            scope.set_var(n, t)
    else:
        import jax.numpy as jnp

        for n, a in arrays.items():
            scope.set_var(n, jnp.asarray(a))
    return scope


def twins(body, seed=None, prepare=None):
    """{"ref": (main, scope, exe, out), "port": (...)} of `body` built in
    both packages, both scopes holding the reference's startup values.
    `prepare(fluid, main)` runs on each main program before its first
    step (e.g. enabling the guard)."""
    out, arrays = {}, None
    for side, fluid in PKGS.items():
        main, startup, res = build(fluid, body, seed)
        if prepare is not None:
            prepare(fluid, main)
        if arrays is None:
            arrays = reference_arrays(startup)
        out[side] = (main, scope_of(fluid, arrays, main),
                     fluid.Executor(fluid.CPUPlace()), res)
    return out


def linreg(fluid, opt="momentum", amp=None, d=4, names=False):
    """The regression of tests/test_resilience.py (`names=True`: the
    named layers of tests/test_observe_numerics.py, three fc layers).
    `amp`: keyword arguments of `amp.decorate`, None for no AMP."""
    layers = fluid.layers
    x = layers.data(name="x", shape=[d], dtype="float32")
    y = layers.data(name="y", shape=[1], dtype="float32")
    if names:
        h = layers.fc(x, size=16, act="relu", name="attn_qkv")
        h = layers.fc(h, size=16, act="relu", name="ffn_in")
        pred = layers.fc(h, size=1, name="ffn_out")
    else:
        pred = layers.fc(x, size=1)
    loss = layers.mean(layers.square(pred - y))
    if opt == "momentum":
        o = fluid.optimizer.MomentumOptimizer(learning_rate=0.1,
                                              momentum=0.9)
    else:
        o = fluid.optimizer.SGDOptimizer(learning_rate=0.1)
    if amp is not None:
        o = fluid.amp.decorate(o, **amp)
    o.minimize(loss)
    return loss


def batches(n, seed=7, bs=8, d=4):
    rng = np.random.RandomState(seed)
    return [{"x": rng.rand(bs, d).astype(np.float32),
             "y": rng.rand(bs, 1).astype(np.float32)}
            for _ in range(n)]


def persistables(program, scope):
    """name -> numpy of every persistable var of `program` in `scope`
    (a bf16 tensor widened, exactly, to float32)."""
    out = {}
    for v in program.list_vars():
        if not v.persistable:
            continue
        val = scope.find_var(v.name)
        if isinstance(val, torch.Tensor):
            val = val.detach().float() if val.is_floating_point() else val
            val = val.cpu().numpy()
        out[v.name] = np.asarray(val)
    return out


@contextlib.contextmanager
def no_host_reads():
    """Make every tensor-to-host read raise while the block runs."""
    def refuse(*a, **k):
        raise AssertionError("host read of a tensor during the step")

    saved = {m: getattr(torch.Tensor, m)
             for m in ("item", "__bool__", "tolist", "cpu", "numpy")}
    for m in saved:
        setattr(torch.Tensor, m, refuse)
    try:
        yield
    finally:
        for m, f in saved.items():
            setattr(torch.Tensor, m, f)
