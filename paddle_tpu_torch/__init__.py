"""paddle_tpu_torch — the PyTorch + CUDA port of paddle_tpu for an
NVIDIA H100.

Public API mirrors `paddle.fluid` as paddle_tpu does (reference:
python/paddle/fluid/__init__.py): Program/Block/Variable graph building,
layers, optimizers (`optimizer.minimize` = `append_backward` + update
ops) and Executor.  The runtime is PyTorch: the Executor interprets a
Program op by op on torch tensors, and every TPU kernel of the reference
package (Pallas) is a kernel written by hand for Hopper (`ops/kernels/`,
sources in `csrc/`).  This package imports torch and numpy only — never
jax and never paddle_tpu.

Places follow Paddle's idiom: `CUDAPlace(0)` is `torch.device("cuda:0")`
and `CPUPlace()` the CPU.  Entry points that take a place default to
`CUDAPlace(0)` and raise when CUDA is not available; only an explicit
`CPUPlace()` runs on the CPU.
"""


class CPUPlace:
    """Placement token for the host CPU (reference:
    paddle/fluid/platform/place.h:26-57)."""

    def __repr__(self):
        return "CPUPlace()"

    def __eq__(self, other):
        return isinstance(other, CPUPlace)

    def __hash__(self):
        return hash("CPUPlace")


class CUDAPlace:
    """Placement token for one CUDA device (`torch.device("cuda", id)`)."""

    def __init__(self, device_id: int = 0):
        self.device_id = int(device_id)

    def __repr__(self):
        return f"CUDAPlace({self.device_id})"

    def __eq__(self, other):
        return isinstance(other, CUDAPlace) and \
            other.device_id == self.device_id

    def __hash__(self):
        return hash(("CUDAPlace", self.device_id))


def is_compiled_with_cuda() -> bool:
    import torch

    return torch.backends.cuda.is_built()


from . import amp  # noqa: E402,F401
from . import clip  # noqa: E402,F401
from . import contrib  # noqa: E402,F401
from . import data  # noqa: E402,F401
from . import initializer  # noqa: E402,F401
from . import inference  # noqa: E402,F401
from . import io  # noqa: E402,F401
from . import layers  # noqa: E402,F401
from . import nets  # noqa: E402,F401
from . import observe  # noqa: E402,F401
from . import ops as _ops  # noqa: E402,F401  (registers all op impls)
from . import optimizer  # noqa: E402,F401
from . import parallel  # noqa: E402,F401
from . import profiler  # noqa: E402,F401
from . import quantize as quantize_module  # noqa: E402,F401
from . import regularizer  # noqa: E402,F401
from . import resilience  # noqa: E402,F401
from . import serving  # noqa: E402,F401
from .core import unique_name  # noqa: E402,F401
from .core.backward import append_backward, gradients  # noqa: E402,F401
from .core.executor import (Executor, Scope, global_scope,  # noqa: E402,F401
                            scope_guard)
from .core.program import (Block, Operator, Parameter,  # noqa: E402,F401
                           Program, Variable, default_main_program,
                           default_startup_program, name_scope,
                           pipeline_scope, pipeline_segment,
                           program_guard, recompute_scope)
from .inference import (AnalysisConfig, Predictor,  # noqa: E402,F401
                        create_paddle_predictor)
from .param_attr import ParamAttr  # noqa: E402,F401
from .parallel.compiler import (BuildStrategy,  # noqa: E402,F401
                                CompiledProgram, ExecutionStrategy)
from .parallel.parallel_executor import ParallelExecutor  # noqa: E402,F401
from .quantize import QuantizeTranspiler  # noqa: E402,F401

__version__ = "0.1.0"
