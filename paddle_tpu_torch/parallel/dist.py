"""Multi-trainer runtime bootstrap.

The port of paddle_tpu/parallel/dist.py, the analog of the reference's
nccl2 multi-trainer mode (`gen_nccl_id` exchanged an ncclUniqueId over
its own gRPC server, gen_nccl_id_op.cc:31,78; ParallelExecutor built
comms over `num_trainers * ndev` ranks, parallel_executor.cc:254).
Here every trainer is one process with one rank: `init_distributed`
opens a `torch.distributed.TCPStore` at the coordinator (trainer 0
hosts it) and starts the default process group on it — `nccl` on the
card, `gloo` when the caller asks for the CPU.  The cluster env
variables keep the reference's names (benchmark/fluid/
fluid_benchmark.py:63-110): PADDLE_TRAINER_ID, PADDLE_TRAINERS,
PADDLE_COORDINATOR, PADDLE_TRAINER_ENDPOINTS.

Multi-GPU NCCL across cards is unverified: the port has been run on
one card, several ranks sharing it over gloo.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np

# the bootstrap wait (the reference's FLAGS_rpc_deadline, 180000 ms)
DEFAULT_TIMEOUT_S = 180.0

_store = None


def get_store():
    """The store `init_distributed` opened (None before it or after
    `shutdown_distributed`); io's checkpoint barrier runs on it."""
    return _store


def init_distributed(trainer_id: Optional[int] = None,
                     num_trainers: Optional[int] = None,
                     coordinator: Optional[str] = None,
                     local_device_ids=None, health: bool = True,
                     place=None, backend: Optional[str] = None,
                     timeout_s: float = DEFAULT_TIMEOUT_S):
    """Bootstrap the multi-trainer runtime (the gen_nccl_id analog).

    Arguments default to the reference's cluster env vars:
    PADDLE_TRAINER_ID, PADDLE_TRAINERS, PADDLE_COORDINATOR (or the
    first entry of PADDLE_TRAINER_ENDPOINTS, as the reference used
    trainer 0's endpoint as the NCCLID broadcast root).  The
    coordinator is "host:port"; trainer 0 serves the store there.

    `place` None means CUDA: the `nccl` backend, this trainer's card
    `local_device_ids[0]` (default: trainer_id modulo the cards) made
    the current device; `CPUPlace()` means `gloo`.  `backend` overrides
    the choice (e.g. "gloo" for CUDA tensors of several ranks on one
    card, which NCCL refuses).

    One trainer without a coordinator is a no-op, as in the reference;
    with a coordinator the process group starts even for one trainer
    (the one-rank NCCL group).  The reference starts its health plane
    (heartbeats, peer-loss monitor) when `health` is set and there is
    more than one trainer; that plane is ROADMAP A step 11, so the port
    raises unless `health=False`.  Returns (trainer_id, num_trainers).
    """
    global _store
    from datetime import timedelta

    import torch
    import torch.distributed as dist

    if trainer_id is None:
        trainer_id = int(os.environ.get("PADDLE_TRAINER_ID", "0"))
    if num_trainers is None:
        num_trainers = int(os.environ.get("PADDLE_TRAINERS", "1"))
    if coordinator is None:
        coordinator = os.environ.get("PADDLE_COORDINATOR")
    if coordinator is None:
        eps = os.environ.get("PADDLE_TRAINER_ENDPOINTS", "")
        coordinator = eps.split(",")[0].strip() if eps else None
    if num_trainers <= 1 and coordinator is None:
        return trainer_id, num_trainers
    if coordinator is None:
        raise ValueError(
            "multi-trainer bootstrap needs a coordinator endpoint: pass "
            "coordinator= or set PADDLE_COORDINATOR / "
            "PADDLE_TRAINER_ENDPOINTS")
    if health and num_trainers > 1:
        raise NotImplementedError(
            "init_distributed(health=True): the distributed health plane "
            "(heartbeats, peer-loss monitor, gang poison key) is not "
            "ported yet: ROADMAP A step 11; pass health=False")
    from .. import CPUPlace

    on_cpu = isinstance(place, CPUPlace)
    if backend is None:
        backend = "gloo" if on_cpu else "nccl"
    if not on_cpu:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "init_distributed on CUDA (the default place) but CUDA is "
                "not available; pass place=CPUPlace() to run on gloo")
        dev = (int(local_device_ids[0]) if local_device_ids
               else trainer_id % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    host, port = coordinator.rsplit(":", 1)
    timeout = timedelta(seconds=float(timeout_s))
    _store = dist.TCPStore(host, int(port), num_trainers,
                           is_master=trainer_id == 0, timeout=timeout)
    dist.init_process_group(backend, store=dist.PrefixStore("pg", _store),
                            rank=trainer_id, world_size=num_trainers,
                            timeout=timeout)
    return trainer_id, num_trainers


def shutdown_distributed():
    """Tear down the multi-trainer runtime.  Idempotent: safe to call
    twice, and when init_distributed never ran or was a no-op."""
    global _store
    import torch.distributed as dist

    from . import mesh as _mesh

    _mesh.set_default_mesh(None)
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()
    _store = None


def make_multihost_mesh(ici_axes: Dict[str, int],
                        dcn_axes: Optional[Dict[str, int]] = None):
    """The reference's hybrid DCN x ICI mesh: the `dcn_axes` outermost
    (across hosts), the `ici_axes` inside (each host's cards), over
    every rank of the group in order.  Repeated axis names are
    rejected."""
    from .mesh import _world_size, make_mesh

    dcn_axes = dict(dcn_axes or {})
    overlap = set(dcn_axes) & set(ici_axes)
    if overlap:
        raise ValueError(f"axes {sorted(overlap)} appear in both dcn and "
                         f"ici dicts; use distinct axis names")
    if not dcn_axes:
        return make_mesh(ici_axes)
    n = int(np.prod(list(dcn_axes.values()))
            * np.prod(list(ici_axes.values())))
    if n != _world_size():
        raise ValueError(
            f"hybrid mesh axes {dcn_axes}×{ici_axes} need exactly "
            f"{n} devices, have {_world_size()}")
    return make_mesh({**dcn_axes, **ici_axes})


def global_batch(mesh, value, axis: str = "dp"):
    """The global batch from this trainer's local batch: every rank's
    `value` concatenated along dim 0 in the order of `axis` (dim 0 is
    local_batch * ranks along the axis).  Feed it to Executor.run with
    the CompiledProgram, which slices each rank's rows back (the
    reference returns a global jax.Array sharded over `axis`)."""
    import torch
    import torch.distributed as dist

    from .collectives import all_gather

    value = np.asarray(value)
    group = mesh.group(axis)
    dev = torch.device("cpu")
    if group is not None and dist.get_backend(group) == "nccl":
        dev = torch.device("cuda", torch.cuda.current_device())
    t = torch.as_tensor(value).to(dev)
    return all_gather(t, mesh, axis).cpu().numpy()
