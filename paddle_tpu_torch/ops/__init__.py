"""Op implementations — importing this package registers all ops.

The port of paddle_tpu/ops: the same op names, slots and attrs, each a
plain function on torch tensors.  Every op of the reference is here.
"""

from ..core.registry import register_op, registered_ops  # noqa: F401
from . import attention  # noqa: F401
from . import basic  # noqa: F401
from . import control_flow  # noqa: F401
from . import detection  # noqa: F401
from . import misc  # noqa: F401
from . import moe  # noqa: F401
from . import nn  # noqa: F401
from . import optim  # noqa: F401
from . import paged_kv  # noqa: F401
from . import quantize  # noqa: F401
from . import rnn  # noqa: F401
from . import sequence  # noqa: F401
from . import sparse  # noqa: F401
from . import structured  # noqa: F401
from . import vision_extra  # noqa: F401
from ..layers import learning_rate_scheduler  # noqa: F401  (lr_schedule)


@register_op("backward_marker")
def _backward_marker(ctx, ins, attrs):
    raise RuntimeError(
        "backward_marker must be handled by the Executor's autodiff split "
        "(core/executor.py interpret_program); running it as a plain op "
        "means the program's _backward_info was lost")
