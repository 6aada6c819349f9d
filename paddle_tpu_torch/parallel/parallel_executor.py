"""ParallelExecutor API-parity wrapper.

The port of paddle_tpu/parallel/parallel_executor.py (reference:
python/paddle/fluid/parallel_executor.py + framework/parallel_executor.cc
:191): a thin facade over CompiledProgram, so fluid scripts using
ParallelExecutor(use_cuda, loss_name).run(...) work unchanged, with the
mesh's ranks standing in for the CUDA place list.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..core.executor import Executor, global_scope
from ..core.program import Program, default_main_program
from .compiler import CompiledProgram
from .mesh import get_default_mesh


class ParallelExecutor:
    def __init__(self, use_cuda: bool = True, loss_name: Optional[str] = None,
                 main_program: Optional[Program] = None,
                 share_vars_from=None, exec_strategy=None,
                 build_strategy=None, num_trainers: int = 1,
                 trainer_id: int = 0, scope=None, mesh=None):
        from .. import CPUPlace, CUDAPlace

        self._program = main_program or default_main_program()
        self._scope = scope or global_scope()
        # this rank's device: the current CUDA device (init_distributed
        # sets it from the local rank) unless the caller asked for the CPU
        if use_cuda:
            import torch

            place = CUDAPlace(torch.cuda.current_device()
                              if torch.cuda.is_available() else 0)
        else:
            place = CPUPlace()
        self._exe = Executor(place)
        self._compiled = CompiledProgram(self._program).with_data_parallel(
            loss_name=loss_name,
            build_strategy=build_strategy,
            exec_strategy=exec_strategy,
            mesh=mesh or get_default_mesh())

    def run(self, fetch_list, feed=None, feed_dict=None,
            return_numpy: bool = True):
        feed = feed if feed is not None else feed_dict
        names = [f if isinstance(f, str) else f.name for f in fetch_list]
        return self._exe.run(self._compiled, feed=feed, fetch_list=names,
                             scope=self._scope, return_numpy=return_numpy)

    @property
    def device_count(self) -> int:
        return int(np.prod(list(self._compiled._mesh.shape.values())))
