"""Model/checkpoint IO: the port of paddle_tpu/io.py.

reference: python/paddle/fluid/io.py — save_vars:89, save_params:222,
save_persistables:270, load_vars:313, load_params, load_persistables,
save_inference_model:570, load_inference_model:704.  Persistence is
host-side (numpy containers + a JSON manifest with program-format
versioning), and the file format is the reference's, byte for byte in
every stored array: a checkpoint either package writes loads in the
other.  Two tiers:

- save_vars/save_params/save_persistables: combined single-file save
  (`params.npz` + `__manifest__.json` with a CRC32 per variable).
- save_sharded/load_sharded: `shards_p{proc}.npz` per process, a CRC
  sidecar, and `__shards__.json` mapping each variable to the global
  index of every shard — written LAST, so a save that dies before it is
  not a checkpoint.  On a mesh (parallel/, one process per rank) each
  rank writes the shards it owns: the slice a ZeRO-sharded DTensor
  holds, and a replicated value once, by its lowest rank; the writes
  run under a cross-process barrier on the torch.distributed store with
  a timeout (`barrier_timeout_s`), so a dead peer ends a save as a
  CheckpointBarrierTimeoutError naming it, not a hang — or, once the
  health plane (resilience/health.py) knows the gang is broken, as a
  CheckpointBarrierPoisonedError within seconds.  A rank of a gang that
  trains its own model writes a private checkpoint
  (`prepare_sharded_save(process_local=True)`), with no barrier.
  `load_sharded`
  assembles any checkpoint (either package's, from any mesh) whole, or
  with `mesh=` each rank's slice of the target mesh's shardings.

bfloat16 without ml_dtypes: numpy has no bfloat16, and the card's
machine lacks the package that adds one.  A bf16 tensor is stored as
the reference's `np.savez` stores its bf16 arrays — raw 2-byte `|V2`
records, with "bfloat16" in the manifest — written from the tensor's
int16 view, so the CRC32 over its bytes is the reference's; on load
the records become a torch.bfloat16 tensor through the same 2-byte
view.  Loaded values land on the executor's device; 64-bit names
narrow to 32 bits as convert.params_from_arrays narrows them.

`save_sharded(async_=True)` takes only the snapshot on the calling
thread and hands the write to a background `resilience.SnapshotWriter`.
The snapshot owns its memory: a tensor on the card is copied to the
host by `.cpu()`, and a CPU tensor, whose `.numpy()` would alias the
live storage, is copied too — so an update that wrote a parameter in
place after the snapshot could never reach the files.

A DTensor in the scope (ZeRO state) is saved by `save_vars` as its
logical value (`full_tensor()`, a collective: every rank of its mesh
saves).
"""

from __future__ import annotations

import json
import os
import time
import zlib
from typing import List, Optional, Sequence

import numpy as np
import torch

from .core.desc import (PROGRAM_FORMAT_VERSION, dump_program_dict,
                        load_program_dict)
from .core.executor import Executor, global_scope
from .core.program import Parameter, Program, Variable
from .ops.common import to_torch_dtype
from .resilience.errors import (CheckpointBarrierPoisonedError,
                                CheckpointCorruptError,
                                CheckpointFormatError,
                                CheckpointBarrierTimeoutError,
                                CheckpointIncompleteError,
                                CheckpointNotFoundError)

MODEL_FILENAME = "__model__"
MANIFEST = "__manifest__.json"
# the reference's serialized AOT inference artifact (its inference.py);
# the port writes none but removes a stale one on export, as there
EXPORT_FILENAME = "__model__.export"

BF16 = "bfloat16"


def _read_manifest(dirname: str, name: str) -> dict:
    """Manifest read with the structured CheckpointError contract:
    missing file → CheckpointNotFoundError (a save that died before its
    manifest is *by design* not a checkpoint), unparseable JSON →
    CheckpointCorruptError, newer format → CheckpointFormatError."""
    path = os.path.join(dirname, name)
    try:
        with open(path) as f:
            manifest = json.load(f)
    except FileNotFoundError as e:
        raise CheckpointNotFoundError(
            f"no checkpoint manifest {name!r} in {dirname!r} (missing "
            f"or torn/incomplete save)", dirname=dirname,
            manifest=name) from e
    except (json.JSONDecodeError, UnicodeDecodeError, OSError) as e:
        raise CheckpointCorruptError(
            f"unreadable checkpoint manifest {path!r}: {e}",
            dirname=dirname, manifest=name,
            cause=f"{type(e).__name__}: {e}") from e
    version = manifest.get("version", 0)
    if version > PROGRAM_FORMAT_VERSION:
        raise CheckpointFormatError(
            f"checkpoint in {dirname!r} written by format version "
            f"{version}; this build reads <= {PROGRAM_FORMAT_VERSION}",
            dirname=dirname, manifest=name, version=version,
            supported=PROGRAM_FORMAT_VERSION)
    return manifest


def _short(e: BaseException) -> str:
    """Error summary safe to embed in messages/events (BadZipFile can
    quote kilobytes of raw archive bytes)."""
    s = str(e)
    return f"{type(e).__name__}: {s[:160]}{'…' if len(s) > 160 else ''}"


def _open_container(dirname: str, fname: str, files: dict):
    """np.load a shard/param container with structured errors (cached
    in `files`)."""
    if fname in files:
        return files[fname]
    path = os.path.join(dirname, fname)
    try:
        files[fname] = np.load(path)
    except FileNotFoundError as e:
        raise CheckpointIncompleteError(
            f"checkpoint {dirname!r} manifest references missing file "
            f"{fname!r}", dirname=dirname, file=fname) from e
    except Exception as e:  # noqa: BLE001 — BadZipFile/zlib/ValueError
        raise CheckpointCorruptError(
            f"unreadable checkpoint container {path!r}: {_short(e)}",
            dirname=dirname, file=fname, cause=_short(e)) from e
    return files[fname]


def _read_member(container, dirname: str, fname: str, key: str,
                 want_crc: Optional[int]) -> np.ndarray:
    """One stored array out of a container, CRC32-verified against the
    manifest record when present (older checkpoints without CRCs still
    load)."""
    try:
        piece = container[key]
    except KeyError as e:
        raise CheckpointIncompleteError(
            f"checkpoint container {fname!r} in {dirname!r} is missing "
            f"key {key!r}", dirname=dirname, file=fname, key=key) from e
    except Exception as e:  # noqa: BLE001 — zlib error mid-member
        raise CheckpointCorruptError(
            f"corrupt member {key!r} in checkpoint container {fname!r}:"
            f" {_short(e)}", dirname=dirname, file=fname, key=key,
            cause=_short(e)) from e
    if want_crc is not None:
        got = zlib.crc32(piece.tobytes()) & 0xFFFFFFFF
        if got != want_crc:
            raise CheckpointCorruptError(
                f"CRC mismatch for {key!r} in {fname!r} ({dirname!r}): "
                f"stored {want_crc:#010x}, computed {got:#010x} — the "
                f"shard was corrupted after save", dirname=dirname,
                file=fname, key=key, crc_stored=want_crc, crc_got=got)
    return piece


def _is_parameter(var: Variable) -> bool:
    return isinstance(var, Parameter)


def _storage_dtype(dtype_str: str) -> np.dtype:
    """The numpy dtype a stored array is held in on the host: int16 for
    bfloat16 (numpy has none without ml_dtypes), else the named one."""
    return np.dtype(np.int16) if dtype_str == BF16 else np.dtype(dtype_str)


def _reinterpret(piece: np.ndarray, dtype_str: str) -> np.ndarray:
    """np.savez stores bfloat16 as raw void records ('|V2'); reinterpret
    them as the manifest's dtype (bfloat16 as its int16 storage).
    Same-size native dtypes pass through untouched."""
    dt = _storage_dtype(dtype_str)
    if piece.dtype == dt:
        return piece
    if piece.dtype.kind == "V" and piece.dtype.itemsize == dt.itemsize:
        return piece.view(dt)
    raise RuntimeError(
        f"checkpoint dtype mismatch: stored {piece.dtype} cannot be "
        f"reinterpreted as manifest dtype {dtype_str}")


def _to_host(value) -> np.ndarray:
    """A scope value as the numpy array the reference would store: a
    bf16 tensor as '|V2' records of its bits (see the module
    docstring); a DTensor as its logical value."""
    from .parallel.data_parallel import logical_value

    value = logical_value(value)
    if isinstance(value, torch.Tensor):
        t = value.detach()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).cpu().numpy().view("V2")
        return t.cpu().numpy()
    return np.asarray(value)


def _snapshot(value) -> np.ndarray:
    """`_to_host`, in host memory of its own: the copy of a CPU tensor
    (whose numpy view aliases the live storage) or of a numpy value; a
    card tensor's `.cpu()` already is one."""
    from torch.distributed.tensor import DTensor

    if isinstance(value, DTensor):
        value = value.full_tensor()
    arr = _to_host(value)
    if isinstance(value, torch.Tensor) and value.device.type != "cpu":
        return arr
    return arr.copy()


def _dtype_str(value, arr: np.ndarray) -> str:
    if isinstance(value, torch.Tensor) and value.dtype == torch.bfloat16:
        return BF16
    return str(arr.dtype)


def _to_device(arr: np.ndarray, dtype_str: str, device) -> torch.Tensor:
    """A host array in its storage dtype → a tensor on `device` in the
    port's runtime dtype (bf16 through its int16 view; 64-bit names
    narrowed)."""
    if dtype_str == BF16:
        t = torch.from_numpy(np.ascontiguousarray(arr)).view(torch.bfloat16)
        return t.to(device)
    return torch.as_tensor(np.ascontiguousarray(arr)).to(
        device=device, dtype=to_torch_dtype(dtype_str))


def _collect(program: Program, predicate) -> List[Variable]:
    return [v for v in program.list_vars() if predicate(v)]


def save_vars(executor: Executor, dirname: str,
              main_program: Optional[Program] = None,
              vars: Optional[Sequence[Variable]] = None,
              predicate=None, filename: Optional[str] = None):
    """Persist variables from the scope (reference io.py:89)."""
    from .core.program import default_main_program

    program = main_program or default_main_program()
    if vars is None:
        vars = _collect(program, predicate or (lambda v: v.persistable))
    scope = global_scope()
    os.makedirs(dirname, exist_ok=True)
    arrays, dtypes, names = {}, {}, []
    for v in vars:
        val = scope.find_var(v.name)
        if val is None:
            raise RuntimeError(f"variable {v.name!r} has no value in scope")
        arrays[v.name] = _to_host(val)
        dtypes[v.name] = _dtype_str(val, arrays[v.name])
        names.append(v.name)
    fname = filename or "params.npz"
    np.savez(os.path.join(dirname, fname), **arrays)
    manifest = {
        "version": PROGRAM_FORMAT_VERSION,
        "file": fname,
        "vars": names,
        "dtypes": {n: dtypes[n] for n in names},
        "crc32": {n: zlib.crc32(arrays[n].tobytes()) & 0xFFFFFFFF
                  for n in names},
    }
    with open(os.path.join(dirname, MANIFEST), "w") as f:
        json.dump(manifest, f, indent=1)


def save_params(executor, dirname, main_program=None, filename=None):
    return save_vars(executor, dirname, main_program,
                     predicate=_is_parameter, filename=filename)


def save_persistables(executor, dirname, main_program=None, filename=None):
    return save_vars(executor, dirname, main_program,
                     predicate=lambda v: v.persistable, filename=filename)


def load_vars(executor: Executor, dirname: str,
              main_program: Optional[Program] = None,
              vars: Optional[Sequence[Variable]] = None,
              predicate=None, filename: Optional[str] = None):
    """Load variables saved by save_vars (either package's) into the
    scope, on the executor's device (reference io.py:313)."""
    from .core.program import default_main_program

    program = main_program or default_main_program()
    if vars is None:
        vars = _collect(program, predicate or (lambda v: v.persistable))
    manifest = _read_manifest(dirname, MANIFEST)
    fname = filename or manifest["file"]
    data = _open_container(dirname, fname, {})
    scope = global_scope()
    for v in vars:
        if v.name not in data:
            raise CheckpointIncompleteError(
                f"checkpoint in {dirname!r} is missing variable "
                f"{v.name!r}", dirname=dirname, var=v.name)
        arr = _read_member(data, dirname, fname, v.name,
                           manifest.get("crc32", {}).get(v.name))
        want = manifest.get("dtypes", {}).get(v.name, str(arr.dtype))
        arr = _reinterpret(arr, want)
        if tuple(arr.shape) != tuple(v.shape) and -1 not in v.shape:
            raise RuntimeError(
                f"shape mismatch for {v.name!r}: checkpoint "
                f"{arr.shape} vs program {v.shape}")
        scope.set_var(v.name, _to_device(arr, want, executor.device))


def load_params(executor, dirname, main_program=None, filename=None):
    return load_vars(executor, dirname, main_program,
                     predicate=_is_parameter, filename=filename)


def load_persistables(executor, dirname, main_program=None, filename=None):
    return load_vars(executor, dirname, main_program,
                     predicate=lambda v: v.persistable, filename=filename)


# ---------------------------------------------------------------------------
# Sharded checkpointing
# ---------------------------------------------------------------------------
#
# reference analog: the DistributeTranspiler saved per-pserver parameter
# slices instead of one combined file
# (transpiler/distribute_transpiler.py:894 _get_slice_vars_and_attrs).
# Every process writes the shards it owns and a JSON manifest records
# each shard's global index.  One process on one device owns every
# variable whole: one shard each, in shards_p0.npz.

SHARD_MANIFEST = "__shards__.json"


class ShardedSaveJob:
    """One prepared sharded save, split into its two phases:

    - the BLOCKING snapshot already happened in `prepare_sharded_save`
      (device→host copy of every shard this process owns; the part a
      training loop must wait for, recorded as `snapshot_ms`),
    - `write()`: CRC, zip serialization, the cross-process barrier, the
      manifest written LAST by process 0 (through `os.replace`), timed
      as `write_ms`; safe on a background writer thread.

    A barrier timeout inside `write()` removes this process's own shard
    files before re-raising, so a dead-peer save leaves neither a
    manifest nor orphaned shards.

    A `local` job (`prepare_sharded_save(process_local=True)`) is one
    process's private checkpoint — each rank of a gang that trains its
    own model: no peer takes part in its directory, so it crosses no
    barrier (ranks that resumed at different cursors save at different
    times) and this process writes the manifest.
    """

    def __init__(self, dirname: str, proc: int, local_arrays: dict,
                 meta: dict, snapshot_ms: float, local: bool = False):
        self.dirname = dirname
        self.proc = proc
        self.local = bool(local)
        self.local_arrays = local_arrays
        self.meta = meta
        self.snapshot_ms = snapshot_ms
        self.bytes_total = sum(a.nbytes for a in local_arrays.values())
        self.write_ms: Optional[float] = None

    def write(self) -> "ShardedSaveJob":
        from .resilience.chaos import delaypoint, failpoint

        t0 = time.perf_counter()
        dirname, proc = self.dirname, self.proc
        # every process of the group takes part in a gang-wide save (the
        # barriers are no-ops for one process, and fail fast on a
        # poisoned gang); a local job crosses none
        # chaos hook: a delay here is a slow write phase
        delaypoint("ckpt:write")
        try:
            np.savez(os.path.join(dirname, f"shards_p{proc}.npz"),
                     **self.local_arrays)
            # per-shard CRC32 sidecar: process 0 folds every sidecar into
            # the manifest after the barrier
            crcs = {k: zlib.crc32(a.tobytes()) & 0xFFFFFFFF
                    for k, a in self.local_arrays.items()}
            with open(os.path.join(dirname, f"shards_p{proc}.crc.json"),
                      "w") as f:
                json.dump(crcs, f)
            if not self.local:
                _barrier("save_sharded:shards")
        except CheckpointBarrierTimeoutError:
            self._cleanup_partial()
            raise
        # fault-injection point (resilience/chaos.py): the
        # torn-checkpoint tests simulate preemption exactly here —
        # shards on disk, no manifest yet
        failpoint("ckpt:before_manifest")
        # the manifest is written LAST, once every process's shard file
        # exists: its presence marks the checkpoint complete, so a
        # process preempted mid-save can never leave a
        # torn-but-loadable checkpoint behind
        if proc == 0 or self.local:
            all_crcs: dict = {}
            for sfile in {sh["file"] for m in self.meta.values()
                          for sh in m["shards"]}:
                cpath = os.path.join(
                    dirname, sfile.replace(".npz", ".crc.json"))
                try:
                    with open(cpath) as f:
                        all_crcs.update(json.load(f))
                except (OSError, json.JSONDecodeError):
                    pass  # CRC is best-effort at save; load tolerates gaps
            for m in self.meta.values():
                for sh in m["shards"]:
                    if sh["key"] in all_crcs:
                        sh["crc32"] = all_crcs[sh["key"]]
            tmp = os.path.join(dirname, SHARD_MANIFEST + ".tmp")
            with open(tmp, "w") as f:
                json.dump({"version": PROGRAM_FORMAT_VERSION,
                           "vars": self.meta}, f, indent=1)
            os.replace(tmp, os.path.join(dirname, SHARD_MANIFEST))
        # a timeout here leaves a complete checkpoint (process 0 renamed
        # the manifest); nothing is removed
        if not self.local:
            _barrier("save_sharded:manifest")
        self.write_ms = (time.perf_counter() - t0) * 1000.0
        return self

    def _cleanup_partial(self) -> None:
        """Best-effort removal of this process's shard files after a
        failed shards-barrier (no manifest exists, or will)."""
        for name in (f"shards_p{self.proc}.npz",
                     f"shards_p{self.proc}.crc.json"):
            try:
                os.remove(os.path.join(self.dirname, name))
            except OSError:
                pass


def _process():
    """(this process's rank, the process count) of the default process
    group, (0, 1) without one."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _shard_owners(value):
    """{global index key: owning rank} of a value: a DTensor's slices,
    each owned by the lowest rank holding it; any other value one whole
    shard owned by rank 0 (the reference's lowest device id)."""
    from torch.distributed.tensor import DTensor, Shard

    shape = tuple(value.shape)
    if not isinstance(value, DTensor):
        return {tuple((0, int(d)) for d in shape): 0}
    dm = value.device_mesh
    ranks = dm.mesh.reshape(-1).tolist()
    grid = tuple(dm.mesh.shape)
    owners = {}
    for pos, rank in enumerate(ranks):
        rank = int(rank)
        coords = np.unravel_index(pos, grid)
        bounds = [[0, int(d)] for d in shape]
        for mdim, pl in enumerate(value.placements):
            if isinstance(pl, Shard):
                size = int(shape[pl.dim]) // int(grid[mdim])
                c = int(coords[mdim])
                bounds[pl.dim] = [c * size, (c + 1) * size]
        key = tuple(tuple(b) for b in bounds)
        if key not in owners or rank < owners[key]:
            owners[key] = rank
    return owners


def prepare_sharded_save(executor: Executor, dirname: str,
                         main_program: Optional[Program] = None,
                         vars: Optional[Sequence[Variable]] = None,
                         process_local: bool = False) -> ShardedSaveJob:
    """The blocking snapshot phase of a sharded save: resolve shard
    ownership and copy every shard this process owns device→host into
    memory the job owns.  Returns a ShardedSaveJob whose `write()`
    performs the rest (inline for a synchronous save, or on a background
    writer).  On a mesh every process calls it.

    `process_local`: this process's private checkpoint of its own values
    (each rank of a gang that trains its own model; the reference's
    saves whose every shard this process owns): every value is one
    whole shard owned here, and the job is `local` (no barrier)."""
    from torch.distributed.tensor import DTensor

    from .core.program import default_main_program
    from .parallel.pipeline_engine import StageHeld

    t0 = time.perf_counter()
    program = main_program or default_main_program()
    if vars is None:
        vars = _collect(program, lambda v: v.persistable)
    scope = global_scope()
    os.makedirs(dirname, exist_ok=True)
    proc, _ = _process()
    local_arrays, meta = {}, {}
    for v in vars:
        val = scope.find_var(v.name)
        if val is None:
            raise RuntimeError(f"variable {v.name!r} has no value in scope")
        if isinstance(val, StageHeld):
            # a pipelined layer's state: one whole shard, written by the
            # lowest rank of its pp stage
            owners = {tuple((0, int(d)) for d in val.shape):
                      val.owner_rank()}
            local = val.value if val.value is not None else torch.empty(
                (1,), dtype=val.dtype)
        elif process_local:
            owners = {tuple((0, int(d)) for d in val.shape): proc}
            local = val
        else:
            owners = _shard_owners(val)
            local = val.to_local() if isinstance(val, DTensor) else val
        shards_meta = []
        arr = None
        for si, (key, owner) in enumerate(sorted(owners.items())):
            shards_meta.append({"index": [list(k) for k in key],
                                "file": f"shards_p{owner}.npz",
                                "key": f"{v.name}::{si}"})
            if owner == proc:
                arr = _snapshot(local)
                local_arrays[f"{v.name}::{si}"] = arr
        if arr is None:
            # owned elsewhere: the dtype from one element
            arr = _to_host(local.reshape(-1)[:1]
                           if isinstance(local, torch.Tensor) else local)
        meta[v.name] = {
            "shape": [int(d) for d in val.shape],
            "dtype": _dtype_str(local, arr),
            "shards": shards_meta,
        }
    return ShardedSaveJob(dirname, proc, local_arrays, meta,
                          snapshot_ms=(time.perf_counter() - t0) * 1000.0,
                          local=process_local)


def save_sharded(executor: Executor, dirname: str,
                 main_program: Optional[Program] = None,
                 vars: Optional[Sequence[Variable]] = None,
                 async_: bool = False, writer=None):
    """Save persistables as a sharded checkpoint: `shards_p0.npz` + a
    manifest mapping each variable to its shard index and file.

    With `async_=True` only the device→host snapshot happens on the
    calling thread; the serialization/manifest phase runs on a
    background SnapshotWriter (the given `writer`, else a process-wide
    default) and the returned `resilience.PendingSave` tracks it —
    write failures surface as structured CheckpointWriteErrors on the
    writer's next submit/wait/close, never silently.  Synchronous saves
    return the completed ShardedSaveJob (`bytes_total`, `snapshot_ms`,
    `write_ms` on it)."""
    job = prepare_sharded_save(executor, dirname,
                               main_program=main_program, vars=vars)
    if not async_:
        return job.write()
    if writer is None:
        from .resilience.preempt import default_writer

        writer = default_writer()
    return writer.submit(job)


# barrier ordinal: appended to the store key namespace so repeated
# barriers with the same tag never collide.  Barriers are collective —
# every process calls them in the same order — so a local counter
# agrees across processes.
_barrier_seq = 0

def barrier_timeout_s() -> float:
    """Checkpoint-barrier timeout (seconds): generous — a slow peer
    flushing a big shard is normal; a dead one should fail in minutes,
    not hang the job.  The knob is FLAGS.ckpt_barrier_timeout_s, read
    at each call; the legacy env PADDLE_TPU_CKPT_BARRIER_TIMEOUT_S wins
    when set, as in the reference (paddle_tpu/io.py:483-494)."""
    legacy = os.environ.get("PADDLE_TPU_CKPT_BARRIER_TIMEOUT_S")
    if legacy is not None:
        try:
            return float(legacy)
        except ValueError:
            pass
    from .flags import FLAGS

    return float(FLAGS.ckpt_barrier_timeout_s)


def _dist_store():
    """The store of the process group: the one init_distributed opened,
    else the default group's."""
    from .parallel.dist import get_store

    store = get_store()
    if store is None:
        from torch.distributed import distributed_c10d

        store = distributed_c10d._get_default_store()
    return store


def _barrier(tag: str, timeout_s: Optional[float] = None):
    """Cross-process sync for sharded checkpointing (a no-op for one
    process), with a timeout: each process publishes an arrival key in
    the torch.distributed store, then waits for every peer's; a peer
    that died mid-save raises a CheckpointBarrierTimeoutError naming the
    ranks that never arrived instead of hanging the survivors, and a
    gang the health plane knows to be broken fails the wait within
    `_BARRIER_POISON_POLL_S` (CheckpointBarrierPoisonedError)."""
    global _barrier_seq
    proc, count = _process()
    if count <= 1:
        return
    if timeout_s is None:
        timeout_s = barrier_timeout_s()
    seq = _barrier_seq
    _barrier_seq += 1
    store = _dist_store()
    prefix = f"ptpu_ckpt_barrier/{tag}/{seq}/"
    store.set(prefix + str(proc), "ok")
    peers = [p for p in range(count) if p != proc]
    missing = _wait_barrier_peers(store, prefix, peers, tag, timeout_s)
    if missing:
        raise CheckpointBarrierTimeoutError(
            f"checkpoint barrier {tag!r} timed out after {timeout_s:.0f}s"
            f" waiting for rank(s) {missing} (of {count} processes) — "
            f"peer died or wedged inside a sharded save", tag=tag,
            timeout_s=timeout_s, missing_ranks=missing, dirname=None,
            process_count=count)


# while a barrier waits, the gang poison key is re-checked this often:
# the bounded-time bridge between "a peer died" and "this save fails"
# (well under the 600 s barrier default)
_BARRIER_POISON_POLL_S = 1.0


def _check_barrier_poison(store, tag: str, elapsed_s: float,
                          timeout_s: float) -> None:
    """Abort a waiting barrier the moment the gang is known broken.  Two
    sources, in order: the LOCAL health monitor's latched alarm (still
    works when the store died with its host — the poison key is
    unreachable exactly then), and the gang poison KEY (a peer's monitor
    or watchdog declared the break).  A store that fails the poison read
    is the local alarm's and the plain timeout's business."""
    from .resilience import health as _health

    plane = _health.get_health_plane()
    if plane is not None:
        alarm = plane.monitor.alarm()
        if alarm is not None:
            details = getattr(alarm, "details", {})
            missing = details.get("missing_ranks",
                                  details.get("stalled_ranks", []))
            raise CheckpointBarrierPoisonedError(
                f"checkpoint barrier {tag!r} aborted after "
                f"{elapsed_s:.1f}s: local health alarm — {alarm}",
                tag=tag, timeout_s=timeout_s,
                poison={"rank": plane.rank, "reason": str(alarm),
                        "kind": getattr(alarm, "kind", "alarm"),
                        "missing_ranks": missing},
                elapsed_s=round(elapsed_s, 3), missing_ranks=missing,
                dirname=None)
    try:
        poison = _health.read_poison(store)
    except _health.STORE_ERRORS:
        return
    if poison is None:
        return
    raise CheckpointBarrierPoisonedError(
        f"checkpoint barrier {tag!r} aborted after {elapsed_s:.1f}s: "
        f"gang poisoned by rank {poison.get('rank')} — "
        f"{poison.get('reason')} (kind={poison.get('kind')})",
        tag=tag, timeout_s=timeout_s, poison=poison,
        elapsed_s=round(elapsed_s, 3),
        missing_ranks=poison.get("missing_ranks", []), dirname=None)


def _wait_barrier_peers(store, prefix: str, peers, tag: str,
                        timeout_s: float,
                        poison_poll_s: Optional[float] = None) -> list:
    """Wait for every peer's arrival key in slices of `poison_poll_s`,
    checking the gang poison key between them.  Returns the ranks that
    never arrived (empty = all arrived); raises
    CheckpointBarrierPoisonedError on poison.  `store` is a TCPStore
    client (or `chaos.FakeKv`)."""
    from datetime import timedelta

    from .resilience.health import STORE_ERRORS

    if poison_poll_s is None:
        poison_poll_s = _BARRIER_POISON_POLL_S
    start = time.monotonic()
    deadline = start + timeout_s
    _check_barrier_poison(store, tag, 0.0, timeout_s)
    missing = []
    for p in peers:
        key = prefix + str(p)
        arrived = False
        while True:
            remaining = deadline - time.monotonic()
            # even past the deadline every peer gets one 1 ms look — a
            # rank that arrived while we waited on another must not be
            # reported missing
            slice_s = max(0.001, min(poison_poll_s, max(remaining, 0.0)))
            slice_end = time.monotonic() + slice_s
            try:
                store.wait([key], timedelta(seconds=slice_s))
                arrived = True
                break
            except STORE_ERRORS:
                _check_barrier_poison(
                    store, tag, time.monotonic() - start, timeout_s)
                if remaining <= 0:
                    break
                # a dead store fails at once: wait the slice out rather
                # than spin until the local alarm latches
                time.sleep(max(0.0, slice_end - time.monotonic()))
        if not arrived:
            missing.append(p)
    return missing


def _assemble_index(meta, files, dirname, index):
    """Read the sub-array covering `index` (tuple of slices) from the
    saved shards, reading only intersecting shard entries (a checkpoint
    the reference wrote from a mesh holds many per variable)."""
    shape = meta["shape"]
    starts = [sl.start or 0 for sl in index]
    stops = [sl.stop if sl.stop is not None else d
             for sl, d in zip(index, shape)]
    buf = np.empty([b - a for a, b in zip(starts, stops)],
                   _storage_dtype(meta["dtype"]))
    filled = 0
    for sh in meta["shards"]:
        s_idx = sh["index"]
        inter_a = [max(a, sa) for a, (sa, _) in zip(starts, s_idx)]
        inter_b = [min(b, sb) for b, (_, sb) in zip(stops, s_idx)]
        if any(a >= b for a, b in zip(inter_a, inter_b)):
            continue
        container = _open_container(dirname, sh["file"], files)
        raw = _read_member(container, dirname, sh["file"], sh["key"],
                           sh.get("crc32"))
        piece = _reinterpret(raw, meta["dtype"])
        src = tuple(slice(a - sa, b - sa) for a, b, (sa, _) in
                    zip(inter_a, inter_b, s_idx))
        dst = tuple(slice(a - oa, b - oa) for a, b, oa in
                    zip(inter_a, inter_b, starts))
        buf[dst] = piece[src]
        filled += int(np.prod([b - a for a, b in zip(inter_a, inter_b)]))
    if filled < int(np.prod(buf.shape)):
        raise CheckpointIncompleteError(
            "sharded checkpoint does not cover the requested slice "
            f"(covered {filled} of {int(np.prod(buf.shape))} elements) "
            "— missing shard files?", dirname=dirname,
            covered=filled, needed=int(np.prod(buf.shape)))
    return buf


def load_sharded(executor: Executor, dirname: str,
                 main_program: Optional[Program] = None,
                 vars: Optional[Sequence[Variable]] = None,
                 mesh=None, sharding_rules=None):
    """Load a sharded checkpoint (either package's, from any mesh it was
    saved on).  Without `mesh` every variable loads whole onto the
    executor's device.  With `mesh` (a parallel.Mesh; `sharding_rules`
    default to the program's CompiledProgram rules) each variable takes
    its target spec — optimizer state with the ZeRO axis composed in, as
    CompiledProgram shards it — and a sharded one loads as a DTensor of
    only this rank's slice, read from whichever saved shards intersect
    it.  Mesh-shape-agnostic: the manifest records each shard's GLOBAL
    index, so state saved on dp=4 (or fsdp=4) loads onto dp=2, fsdp=2 or
    one device with the same logical arrays, bit for bit."""
    from .core.program import default_main_program

    program = main_program or default_main_program()
    if vars is None:
        vars = _collect(program, lambda v: v.persistable)
    manifest = _read_manifest(dirname, SHARD_MANIFEST)
    metas = manifest["vars"]
    spec_fn = _load_spec_fn(program, mesh, sharding_rules)
    scope = global_scope()
    files: dict = {}
    for v in vars:
        if v.name not in metas:
            raise CheckpointIncompleteError(
                f"sharded checkpoint in {dirname!r} is missing variable "
                f"{v.name!r}", dirname=dirname, var=v.name)
        meta = metas[v.name]
        if tuple(meta["shape"]) != tuple(v.shape) and -1 not in v.shape:
            raise RuntimeError(
                f"shape mismatch for {v.name!r}: checkpoint "
                f"{tuple(meta['shape'])} vs program {tuple(v.shape)}")
        shape = tuple(meta["shape"])
        spec = spec_fn(v.name, shape) if spec_fn is not None else ()
        dims = [(d, a) for d, a in enumerate(spec) if a is not None]
        if not dims or mesh.device_mesh is None or not mesh.member:
            full = _assemble_index(meta, files, dirname,
                                   tuple(slice(0, d) for d in shape))
            scope.set_var(v.name, _to_device(full, meta["dtype"],
                                             executor.device))
            continue
        scope.set_var(v.name, _load_slice(meta, files, dirname, mesh,
                                          dims, executor.device))


def _load_spec_fn(program, mesh, sharding_rules):
    """The target spec of each state var on `mesh` (None off a mesh)."""
    if mesh is None:
        return None
    wrapper = getattr(program, "_compiled_wrapper", None)
    if sharding_rules is None and wrapper is not None \
            and wrapper._mesh is mesh:
        return wrapper.state_spec_for
    rules = sharding_rules if sharding_rules is not None else (
        wrapper._rules if wrapper is not None else None)
    if rules is None:
        return None
    from .parallel.compiler import program_var_buckets

    _params, opt = program_var_buckets(program)

    def spec_fn(name, shape):
        if name in opt:
            return rules.opt_state_spec_for(name, shape, mesh)
        return rules.spec_for(name, shape, mesh)

    return spec_fn


def _load_slice(meta, files, dirname, mesh, dims, device):
    """This rank's slice of a sharded variable, as a DTensor: `dims`
    [(dim, axis)] (several dims over their own axes: a model axis beside
    a data axis, or two model axes)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    axes = [a for _, a in dims]
    if len(set(axes)) != len(axes):
        raise ValueError(f"a spec sharding two dims over one axis: {dims}")
    shape = tuple(meta["shape"])
    index = [slice(0, s) for s in shape]
    for dim, axis in dims:
        size, coord = mesh.shape[axis], mesh.coordinate(axis)
        step = shape[dim] // size
        index[dim] = slice(coord * step, (coord + 1) * step)
    local = _to_device(_assemble_index(meta, files, dirname, tuple(index)),
                       meta["dtype"], device)
    by_axis = {a: d for d, a in dims}
    placements = [Shard(by_axis[a]) if a in by_axis else Replicate()
                  for a in mesh.axis_names]
    return DTensor.from_local(local.contiguous(), mesh.device_mesh,
                              placements, run_check=False,
                              shape=torch.Size(shape),
                              stride=torch.empty(shape,
                                                 device="meta").stride())


# ---------------------------------------------------------------------------
# Inference export
# ---------------------------------------------------------------------------

def save_inference_model(dirname: str, feeded_var_names: Sequence[str],
                         target_vars: Sequence[Variable],
                         executor: Executor,
                         main_program: Optional[Program] = None,
                         model_filename: Optional[str] = None,
                         params_filename: Optional[str] = None):
    """Prune to the inference subgraph and export (reference io.py:570):
    writes `__model__` (serialized program) + params."""
    from .core.executor import prune_ops
    from .core.program import default_main_program

    program = (main_program or default_main_program()).clone(for_test=True)
    fetch_names = [t.name for t in target_vars]

    # prune ops to fetch ancestors, then drop unused vars
    program._backward_info = None
    kept_ops = prune_ops(program, fetch_names)
    block = program.global_block()
    block.ops = list(kept_ops)
    used = set(fetch_names) | set(feeded_var_names)
    for op in block.ops:
        used.update(op.desc.input_names())
        used.update(op.desc.output_names())
    block.vars = {n: v for n, v in block.vars.items() if n in used}

    os.makedirs(dirname, exist_ok=True)
    with open(os.path.join(dirname, model_filename or MODEL_FILENAME),
              "w") as f:
        d = program.to_dict()
        d["feed_var_names"] = list(feeded_var_names)
        d["fetch_var_names"] = fetch_names
        f.write(dump_program_dict(d))
    # a re-saved model invalidates any serialized AOT artifact the
    # reference exported from the previous one
    for stale in (EXPORT_FILENAME, EXPORT_FILENAME + ".json"):
        p = os.path.join(dirname, stale)
        if os.path.exists(p):
            os.remove(p)
    params = [v for v in program.list_vars() if v.persistable]
    save_vars(executor, dirname, program, vars=params,
              filename=params_filename)
    return fetch_names


def load_inference_model(dirname: str, executor: Executor,
                         model_filename: Optional[str] = None,
                         params_filename: Optional[str] = None):
    """reference io.py:704 — returns (program, feed_names, fetch_vars)."""
    with open(os.path.join(dirname, model_filename or MODEL_FILENAME)) as f:
        d = load_program_dict(f.read())
    program = Program.from_dict(d)
    load_vars(executor, dirname, program,
              predicate=lambda v: v.persistable, filename=params_filename)
    fetch_vars = [program.global_block().var(n)
                  for n in d.get("fetch_var_names", [])]
    return program, d.get("feed_var_names", []), fetch_vars
