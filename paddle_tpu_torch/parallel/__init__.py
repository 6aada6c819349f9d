"""Parallel execution over the ranks of a process group.

The port of paddle_tpu/parallel/ (ROADMAP A steps 10a and 10b): the
reference's ParallelExecutor and NCCL all-reduce op handles, which its
GSPMD replaces, become one process per rank with explicit
torch.distributed collectives: data parallelism with ZeRO
(parallel/data_parallel.py), Megatron tensor parallelism over `mp`
(parallel/tensor_parallel.py), ring and Ulysses attention over `sp`
(`ring_attention`, `ulysses_attention`), GPipe over `pp` (`gpipe`,
`gpipe_loss_and_grad`, parallel/pipeline_engine.py) and the expert
all-to-alls of `moe_ffn` over `ep` (ops/moe.py).
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
from .pipeline import gpipe, gpipe_loss_and_grad  # noqa: F401
from .ring_attention import ring_attention, ulysses_attention  # noqa: F401
from .strategies import GradSyncConfig, ShardingRules  # noqa: F401
