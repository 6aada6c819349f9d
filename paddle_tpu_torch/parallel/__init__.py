"""Data-parallel execution over the ranks of a process group.

The port of paddle_tpu/parallel/ (ROADMAP A step 10a): the reference's
ParallelExecutor and NCCL all-reduce op handles, which its GSPMD
replaces, become one process per rank with explicit torch.distributed
collectives (parallel/data_parallel.py).  The model axes — Megatron
`mp` rules, `sp` ring/Ulysses attention (`ring_attention`,
`ulysses_attention`), `pp` GPipe (`gpipe`, `gpipe_loss_and_grad`) and
`ep` expert all-to-alls — are ROADMAP A step 10b.
"""

from .collectives import (all_gather, all_reduce, all_to_all,  # noqa: F401
                          barrier, ppermute, psum,
                          quantized_all_reduce, reduce_scatter)
from .compiler import (BuildStrategy, CompiledProgram,  # noqa: F401
                       ExecutionStrategy)
from .dist import (global_batch, init_distributed,  # noqa: F401
                   make_multihost_mesh, shutdown_distributed)
from .mesh import get_default_mesh, make_mesh, set_default_mesh  # noqa: F401
from .parallel_executor import ParallelExecutor  # noqa: F401
from .strategies import GradSyncConfig, ShardingRules  # noqa: F401
