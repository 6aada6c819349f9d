"""The host ops of paddle_tpu_torch on the CPU (the port's counterpart of
tests/test_aux.py::test_print_op_passthrough_and_py_func): `print`
passes its input through and prints the reference's line on the host;
`py_func` calls a registered Python function on numpy copies of its
inputs, its results becoming the declared outputs.  Both programs build
the same `to_dict()` as the reference's and fetch the same values; a
py_func result of another shape than declared raises, and a handle
registered in no process raises naming that handles do not serialize.
"""

from __future__ import annotations

import json

import numpy as np
import pytest

import paddle_tpu as jf
import paddle_tpu_torch as tf


def _net(fluid):
    layers = fluid.layers
    x = layers.data("x", shape=[4], append_batch_size=False)
    y = layers.Print(layers.scale(x, 2.0), message="dbg")
    block = fluid.default_main_program().global_block()
    o = block.create_var(name="pyout", shape=(4,), dtype="float32")
    layers.py_func(lambda a: a + 1.0, y, o)
    o2 = block.create_var(name="pyout2", shape=(1,), dtype="float32")
    layers.py_func(lambda a: a.sum(keepdims=True), x, o2)
    return o, o2


def test_print_op_passthrough_and_py_func(capsys, monkeypatch):
    import paddle_tpu.ops.misc as jmisc
    import paddle_tpu_torch.ops.misc as tmisc

    # a handle numbers its package's registrations in this process: both
    # registries start empty here, so the two programs' handles agree
    # whichever tests ran before in the same process
    monkeypatch.setattr(jmisc, "_PY_FUNCS", {})
    monkeypatch.setattr(tmisc, "_PY_FUNCS", {})
    got = {}
    for fluid in (jf, tf):
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup), fluid.unique_name.guard():
            o, o2 = _net(fluid)
        exe = fluid.Executor(fluid.CPUPlace())
        got[fluid.__name__] = (json.dumps(main.to_dict(), sort_keys=True),
                               exe.run(main, feed={
                                   "x": np.arange(4, dtype=np.float32)},
                                   fetch_list=[o, o2]))
    (jd, (j1, j2)), (td, (t1, t2)) = got["paddle_tpu"], \
        got["paddle_tpu_torch"]
    assert td == jd
    np.testing.assert_allclose(t1, np.arange(4) * 2 + 1)
    np.testing.assert_allclose(t2, [6.0])
    np.testing.assert_array_equal(t1, j1)
    np.testing.assert_array_equal(t2, j2)
    assert "dbg shape=(4,) dtype=float32 data=[0. 2. 4. 6.]" in \
        capsys.readouterr().out


def test_py_func_result_shape_and_handle_are_checked():
    from paddle_tpu_torch.core.registry import OpContext, get_op_impl
    from paddle_tpu_torch.ops.misc import register_py_func

    import torch

    ctx = OpContext((0, 0), 0, device="cpu")
    x = torch.ones(3, 2)
    h = register_py_func(lambda a: a.sum(0))
    attrs = {"handle": h, "out_shapes": [[-1]], "out_dtypes": ["float32"]}
    with pytest.raises(ValueError, match="declared"):
        get_op_impl("py_func")(ctx, {"X": [x]}, attrs)
    out = get_op_impl("py_func")(ctx, {"X": [x]}, dict(
        attrs, out_shapes=[[2]]))["Out"][0]
    assert out.dtype == torch.float32 and out.tolist() == [3.0, 3.0]
    with pytest.raises(KeyError, match="do not serialize"):
        get_op_impl("py_func")(ctx, {"X": [x]}, dict(attrs, handle=10 ** 6))
