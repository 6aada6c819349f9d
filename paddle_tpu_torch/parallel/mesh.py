"""Named-axis meshes over the ranks of a process group.

The port of paddle_tpu/parallel/mesh.py.  The reference's mesh is a
`jax.sharding.Mesh` over the devices of one program; the port runs one
process per rank (torch.distributed), and a `Mesh` names the axes of the
process group's ranks: it holds a `torch.distributed.device_mesh.
DeviceMesh` over those ranks (the axis names as its `mesh_dim_names`;
`init_device_mesh`'s constructor, which also takes a subset of the
ranks) and exposes `.shape` as the reference's ordered
{axis: size} dict, which `strategies.py` and the data-parallel step read.
A DeviceMesh's own `.shape` is a tuple that DTensor's internals read, so
the port wraps the DeviceMesh instead of overriding it (ROADMAP C16).

Conventional axis names: "dp" (data), "fsdp" (data with sharded
optimizer state), "mp" (tensor/model), "sp" (sequence), "pp" (pipeline),
"ep" (expert).  Every process group a mesh's code asks for is made
with the mesh: one a single axis (the DeviceMesh's) and one for each
set of several axes short of the whole mesh (`Mesh.group`), so a data
group beside a model axis exists on every rank.
"""

from __future__ import annotations

import contextvars
from typing import Dict, NamedTuple, Optional

import numpy as np


class Mesh:
    """Ranks of the process group laid out on named axes, row-major in
    the order the axes are given: `ranks` (the global ranks, one per
    position) reshaped to the axis sizes.  `device_mesh` is the
    DeviceMesh over them, None for a one-rank mesh, which needs no
    process group.  A rank of the group outside the mesh holds a Mesh
    too (`member` False) and must not run a step on it."""

    def __init__(self, axes: Dict[str, int], device_mesh=None,
                 ranks=None, whole_group=None, groups=None):
        self.shape: Dict[str, int] = {str(k): int(v) for k, v in
                                      axes.items()}
        self.axis_names = tuple(self.shape)
        self.device_mesh = device_mesh
        n = int(np.prod(list(self.shape.values()), dtype=np.int64))
        self.devices = np.asarray(
            list(range(n)) if ranks is None else list(ranks)).reshape(
                tuple(self.shape.values()))
        self._whole_group = whole_group
        # (axes in mesh order) -> this rank's group over those axes
        self._groups = dict(groups or {})

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def rank(self) -> Optional[int]:
        """This process's position in the mesh (0 without a process
        group; None for a rank outside the mesh)."""
        if self.device_mesh is None:
            return 0
        import torch.distributed as dist

        hits = np.flatnonzero(self.devices.reshape(-1) == dist.get_rank())
        return int(hits[0]) if hits.size else None

    @property
    def member(self) -> bool:
        return self.rank() is not None

    def coordinate(self, axis: str) -> int:
        """This rank's index along `axis`."""
        coords = np.unravel_index(self.rank(), self.devices.shape)
        return int(coords[self.axis_names.index(axis)])

    def rank_index(self, axes) -> int:
        """The linearized index of this rank over `axes`, row-major in
        the mesh's axis order (the reference's data-rank index)."""
        idx = 0
        for a in self.axis_names:
            if a in axes:
                idx = idx * self.shape[a] + self.coordinate(a)
        return idx

    def group(self, axes):
        """The process group over `axes` (a name or a tuple of names):
        the ranks that share this rank's coordinates on every other
        axis.  None for a one-rank group."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        n = int(np.prod([self.shape[a] for a in axes], dtype=np.int64))
        if n <= 1 or self.device_mesh is None:
            return None
        if n == self.size:
            return self._whole_group
        live = tuple(a for a in self.axis_names
                     if a in axes and self.shape[a] > 1)
        if len(live) == 1:
            return self.device_mesh.get_group(live[0])
        return self._groups[live]

    def get_group(self, axis: str):
        return self.group(axis)

    def __repr__(self):
        return f"Mesh({self.shape})"


def _world_size() -> int:
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def make_mesh(axes: Dict[str, int], devices=None) -> Mesh:
    """A Mesh with named axes over the process group's ranks, e.g.
    make_mesh({"dp": 4}) or make_mesh({"dp": 2, "fsdp": 2}); the first
    ranks of `devices` (default every rank of the group, in order), as
    the reference takes the first devices.  Every rank of the group
    makes the mesh (the DeviceMesh's groups are made collectively).
    Without a process group only a one-rank mesh can be made (the
    reference's single-device fallback)."""
    import torch
    import torch.distributed as dist

    n = int(np.prod(list(axes.values()), dtype=np.int64))
    world = _world_size()
    ranks = list(range(world)) if devices is None else [int(d) for d in
                                                        devices]
    if n > len(ranks):
        raise ValueError(
            f"mesh needs {n} devices, only {len(ranks)} available")
    if world == 1:
        return Mesh(axes)
    from torch.distributed.device_mesh import DeviceMesh

    ranks = ranks[:n]
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    dm = DeviceMesh(device_type, torch.tensor(ranks).reshape(
        tuple(int(v) for v in axes.values())),
        mesh_dim_names=tuple(axes))
    whole = dist.group.WORLD if n == world else dist.new_group(ranks)
    return Mesh(axes, dm, ranks, whole, _axis_set_groups(axes, ranks))


def _axis_set_groups(axes: Dict[str, int], ranks) -> dict:
    """This rank's process group over each set of two or more axes
    (larger than 1) short of the whole mesh: the ranks that share this
    rank's coordinates on every other axis.  `new_group` is collective,
    so every rank of the group makes every block, in one order."""
    import itertools

    import torch.distributed as dist

    names = [a for a in axes if axes[a] > 1]
    grid = np.asarray(ranks).reshape(tuple(int(v) for v in axes.values()))
    me = dist.get_rank()
    out = {}
    for k in range(2, len(names)):
        for subset in itertools.combinations(names, k):
            keep = [list(axes).index(a) for a in subset]
            blocks = np.moveaxis(grid, keep, list(range(
                grid.ndim - len(keep), grid.ndim))).reshape(
                    -1, int(np.prod([axes[a] for a in subset])))
            for block in blocks:
                g = dist.new_group([int(r) for r in block])
                if me in block:
                    out[subset] = g
    return out


_default_mesh: Optional[Mesh] = None


def set_default_mesh(mesh):
    global _default_mesh
    _default_mesh = mesh


class ExecContext(NamedTuple):
    """What a CompiledProgram run exposes to mesh-aware code: the mesh,
    the name of the mesh axis the batch dim is sharded over, and the
    pipeline microbatch count (0 = pipelining off)."""

    mesh: object
    batch_axis: str = "dp"
    pipeline_microbatches: int = 0


# ContextVar, not a module global: two CompiledPrograms running
# concurrently (threads) must not see each other's mesh.
_exec_ctx: contextvars.ContextVar = contextvars.ContextVar(
    "paddle_tpu_torch_exec_ctx", default=None)


class executing_mesh:
    """The mesh a CompiledProgram step runs under, set only while the
    wrapper runs its step; read through get_executing_mesh() /
    get_exec_context()."""

    def __init__(self, mesh, batch_axis: str = "dp",
                 pipeline_microbatches: int = 0):
        self._ctx = ExecContext(mesh, batch_axis, pipeline_microbatches)

    def __enter__(self):
        self._token = _exec_ctx.set(self._ctx)
        return self._ctx.mesh

    def __exit__(self, *exc):
        _exec_ctx.reset(self._token)
        return False


def get_executing_mesh():
    ctx = _exec_ctx.get()
    return None if ctx is None else ctx.mesh


def get_exec_context() -> Optional[ExecContext]:
    return _exec_ctx.get()


def get_default_mesh(create_dp: bool = True):
    """The process-wide mesh; lazily a pure-DP mesh over every rank."""
    global _default_mesh
    if _default_mesh is None and create_dp:
        _default_mesh = make_mesh({"dp": _world_size()})
    return _default_mesh
