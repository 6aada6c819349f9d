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
  not a checkpoint.  The port is one process on one device: each
  variable is one full shard.  `load_sharded` still assembles
  checkpoints the reference wrote from a multi-device mesh (many shards
  per variable) into one full tensor.

bfloat16 without ml_dtypes: numpy has no bfloat16, and the card's
machine lacks the package that adds one.  A bf16 tensor is stored as
the reference's `np.savez` stores its bf16 arrays — raw 2-byte `|V2`
records, with "bfloat16" in the manifest — written from the tensor's
int16 view, so the CRC32 over its bytes is the reference's; on load
the records become a torch.bfloat16 tensor through the same 2-byte
view.  Loaded values land on the executor's device; 64-bit names
narrow to 32 bits as convert.params_from_arrays narrows them.

Left out, each raising or listed under its ROADMAP queue A step: the
asynchronous save (`async_=True`, resilience/preempt.py SnapshotWriter,
step 6c), loading into a mesh (`mesh=`/`sharding_rules=`) and the
cross-process barrier (step 10).
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
from .resilience.errors import (CheckpointCorruptError,
                                CheckpointFormatError,
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
    docstring)."""
    if isinstance(value, torch.Tensor):
        t = value.detach()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).cpu().numpy().view("V2")
        return t.cpu().numpy()
    return np.asarray(value)


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
      (device→host copy of every shard; the part a training loop must
      wait for, recorded as `snapshot_ms`),
    - `write()`: CRC, zip serialization, the manifest written LAST
      (through `os.replace`), timed as `write_ms`.
    """

    def __init__(self, dirname: str, proc: int, local_arrays: dict,
                 meta: dict, snapshot_ms: float):
        self.dirname = dirname
        self.proc = proc
        self.local_arrays = local_arrays
        self.meta = meta
        self.snapshot_ms = snapshot_ms
        self.bytes_total = sum(a.nbytes for a in local_arrays.values())
        self.write_ms: Optional[float] = None

    def write(self) -> "ShardedSaveJob":
        from .resilience.chaos import delaypoint, failpoint

        t0 = time.perf_counter()
        dirname, proc = self.dirname, self.proc
        # chaos hook: a delay here is a slow write phase
        delaypoint("ckpt:write")
        np.savez(os.path.join(dirname, f"shards_p{proc}.npz"),
                 **self.local_arrays)
        # per-shard CRC32 sidecar (the reference folds every process's
        # sidecar into the manifest; here there is one)
        crcs = {k: zlib.crc32(a.tobytes()) & 0xFFFFFFFF
                for k, a in self.local_arrays.items()}
        with open(os.path.join(dirname, f"shards_p{proc}.crc.json"),
                  "w") as f:
            json.dump(crcs, f)
        # fault-injection point (resilience/chaos.py): the
        # torn-checkpoint tests simulate preemption exactly here —
        # shards on disk, no manifest yet
        failpoint("ckpt:before_manifest")
        # the manifest is written LAST: its presence marks the
        # checkpoint complete, so a process preempted mid-save can never
        # leave a torn-but-loadable checkpoint behind
        for m in self.meta.values():
            for sh in m["shards"]:
                if sh["key"] in crcs:
                    sh["crc32"] = crcs[sh["key"]]
        tmp = os.path.join(dirname, SHARD_MANIFEST + ".tmp")
        with open(tmp, "w") as f:
            json.dump({"version": PROGRAM_FORMAT_VERSION,
                       "vars": self.meta}, f, indent=1)
        os.replace(tmp, os.path.join(dirname, SHARD_MANIFEST))
        self.write_ms = (time.perf_counter() - t0) * 1000.0
        return self


def prepare_sharded_save(executor: Executor, dirname: str,
                         main_program: Optional[Program] = None,
                         vars: Optional[Sequence[Variable]] = None
                         ) -> ShardedSaveJob:
    """The blocking snapshot phase of a sharded save: copy every
    variable device→host (one full shard each).  Returns a
    ShardedSaveJob whose `write()` performs the rest."""
    from .core.program import default_main_program

    t0 = time.perf_counter()
    program = main_program or default_main_program()
    if vars is None:
        vars = _collect(program, lambda v: v.persistable)
    scope = global_scope()
    os.makedirs(dirname, exist_ok=True)
    proc = 0
    local_arrays, meta = {}, {}
    for v in vars:
        val = scope.find_var(v.name)
        if val is None:
            raise RuntimeError(f"variable {v.name!r} has no value in scope")
        arr = _to_host(val)
        key = f"{v.name}::0"
        local_arrays[key] = arr
        meta[v.name] = {
            "shape": list(arr.shape),
            "dtype": _dtype_str(val, arr),
            "shards": [{"index": [[0, d] for d in arr.shape],
                        "file": f"shards_p{proc}.npz", "key": key}],
        }
    return ShardedSaveJob(dirname, proc, local_arrays, meta,
                          snapshot_ms=(time.perf_counter() - t0) * 1000.0)


def save_sharded(executor: Executor, dirname: str,
                 main_program: Optional[Program] = None,
                 vars: Optional[Sequence[Variable]] = None,
                 async_: bool = False, writer=None):
    """Save persistables as a sharded checkpoint: `shards_p0.npz` + a
    manifest mapping each variable to its shard index and file.  Returns
    the completed ShardedSaveJob (`bytes_total`, `snapshot_ms`,
    `write_ms` on it)."""
    if async_ or writer is not None:
        raise NotImplementedError(
            "save_sharded(async_=True) (the background SnapshotWriter of "
            "resilience/preempt.py) is not ported yet: ROADMAP queue A "
            "step 6c")
    job = prepare_sharded_save(executor, dirname,
                               main_program=main_program, vars=vars)
    return job.write()


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
    """Load a sharded checkpoint (either package's, from any mesh the
    reference saved on) whole onto the executor's device.  The manifest
    records each shard's GLOBAL index, so assembly reads whichever saved
    shards intersect the variable: a dp×mp-sharded reference checkpoint
    loads as the same logical arrays, bit for bit."""
    if mesh is not None or sharding_rules is not None:
        raise NotImplementedError(
            "load_sharded(mesh=, sharding_rules=) (loading into a device "
            "mesh) is not ported yet: ROADMAP queue A step 10 (parallel)")
    from .core.program import default_main_program

    program = main_program or default_main_program()
    if vars is None:
        vars = _collect(program, lambda v: v.persistable)
    manifest = _read_manifest(dirname, SHARD_MANIFEST)
    metas = manifest["vars"]
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
        full = _assemble_index(meta, files, dirname,
                               tuple(slice(0, d) for d in meta["shape"]))
        scope.set_var(v.name, _to_device(full, meta["dtype"],
                                         executor.device))


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
