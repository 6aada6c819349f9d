"""Per-op cost attribution: flops, transcendentals and bytes of one
recorded step, joined to fluid ops and measured device time.

The port of paddle_tpu/observe/cost.py.  The reference recomputes both
sides analytically from the optimized HLO module of its one compiled
step.  The port has no compiled module (ROADMAP C21): it records one run
of the step instead (`StepRecorder`, behind `Executor.compiled_step`):

- **Every aten op** the step dispatches is seen by a `TorchDispatchMode`
  below autograd, forward, backward and update alike, and charged to the
  fluid op that made it: the executor's current op in the forward and
  the update ops (observe/trace.py labels them), the op whose forward
  made the executing autograd node in the backward (the node's
  `metadata["fluid_op"]`), as the reference's `fluid_op_of` sees through
  `transpose(jvp(...))`.
- **FLOPS**: 2·M·N·K for `mm`/`bmm`/`addmm`/`baddbmm` (the add of
  `addmm`/`baddbmm` one flop an element more), 2 · output elements ·
  kernel window · input features a group for a convolution and each
  gradient its backward computes, input minus output elements for a
  reduction, one a result element for other arithmetic;
  transcendentals (exp, log, tanh, sigmoid, erf, ...) tallied apart, as
  XLA splits them.  Data movement (copies, gathers, concatenation,
  fills) counts no flops.
- **BYTES**: the materialized-buffers model: every aten op reads each
  distinct input once and writes each output once; a view moves
  nothing.  Eager torch materializes what XLA would fuse, so the port's
  bytes are the traffic of the eager step, larger than the reference's
  fused module's (C21).
- **Kernels**: a hand-written kernel's launch is a ctypes call torch
  never sees.  Each kernel wrapper reports its call (ops/kernels
  `charge`) with the registry's dense-equivalent flops (`KERNEL_COSTS`)
  and its kernel's bytes, bucket `custom_call`; the wrapper's own aten
  ops (the plain version's on the CPU) are not counted again, so the
  CPU and the card count the same flops for one program.
- **Loops** count every iteration they ran: `while`, `dynamic_rnn` and
  the LSTM run eagerly, so their work is trip-multiplied by
  construction; the reference's `[loop?]` bucket has no counterpart
  (C21).
- **BUCKETS**: matmul (mm, bmm, addmm, baddbmm), conv, layout (`copy_`,
  `clone`, so the contiguous copy of a strided view), comm
  (collectives), custom_call (a kernel), noop (views, allocations: 0
  bytes), elementwise (everything else).  An eager `transpose` is a
  view, so the port's layout rows hold only the copies that follow one
  (C21).

The same recorder keeps the memory ledger observe/memory.py reads: each
storage an aten op creates, charged to its op, and its free.
"""

from __future__ import annotations

import contextlib
import threading
import weakref
from typing import Any, Dict, Iterable, List, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from . import trace as _trace

# --------------------------------------------------------------------------
# device peaks
# --------------------------------------------------------------------------

# dense bf16 tensor-core FLOP/s and HBM bytes/s by device name prefix (the
# H100 SXM's data sheet, the constants of ops/kernels)
DEVICE_PEAKS = {"NVIDIA H100": (989e12, 3.35e12)}


def device_peaks(kind: Optional[str] = None):
    """(peak_flops, hbm_bw) for a device name, or (None, None) when it is
    unknown (the CPU) — callers treat None as "no roofline denominator",
    never assume a card."""
    if kind is None:
        if not torch.cuda.is_available():
            return None, None
        kind = torch.cuda.get_device_name(torch.cuda.current_device())
    for prefix, peaks in DEVICE_PEAKS.items():
        if kind.startswith(prefix):
            return peaks
    return None, None


# --------------------------------------------------------------------------
# the aten op model
# --------------------------------------------------------------------------

_MATMUL = {"mm", "bmm", "addmm", "baddbmm", "mv", "addmv", "dot"}
_CONV = {"convolution", "convolution_backward"}
_LAYOUT = {"copy_", "clone"}
# allocations and aliases that the schema does not flag as views: no
# flops, no bytes (a reshape is `_unsafe_view` of its copy, or of its
# input where the input is contiguous — which differs by device)
_NOOP = {"empty", "empty_like", "empty_strided", "new_empty",
         "new_empty_strided", "detach", "alias", "lift_fresh",
         "_local_scalar_dense", "set_", "resize_", "record_stream",
         "_unsafe_view", "_reshape_alias"}
_TRANSCENDENTAL = {
    "exp", "exp_", "exp2", "expm1", "log", "log_", "log2", "log10",
    "log1p", "tanh", "tanh_", "sigmoid", "sigmoid_", "sqrt", "sqrt_",
    "rsqrt", "rsqrt_", "pow", "pow_", "erf", "erf_", "erfinv", "sin",
    "cos", "tan", "atan", "atan2", "sinh", "cosh", "asin", "acos",
    "reciprocal", "logit", "softplus", "lgamma", "digamma"}
_REDUCE = {"sum", "mean", "amax", "amin", "max", "min", "prod", "var",
           "std", "var_mean", "std_mean", "norm", "linalg_vector_norm",
           "logsumexp", "argmax", "argmin", "any", "all", "cumsum",
           "cumprod", "nansum", "count_nonzero", "aminmax"}
# data movement and fills: no flops (XLA's gathers, concatenations,
# slices and broadcasts count none either)
_MOVE = {"cat", "stack", "index_select", "gather", "embedding",
         "embedding_dense_backward", "index", "index_put",
         "index_put_", "slice_scatter", "select_scatter",
         "as_strided_scatter", "zeros", "zeros_like", "ones",
         "ones_like", "full", "full_like", "fill_", "zero_", "fill",
         "arange", "constant_pad_nd", "repeat", "scalar_tensor",
         "_to_copy", "copy_", "clone", "masked_select", "nonzero",
         "flip", "roll", "tril", "triu", "take_along_dim", "unfold",
         "im2col", "col2im", "lift_fresh_copy", "_unsafe_index",
         "randperm", "bernoulli", "bernoulli_", "uniform_", "normal_",
         "rand", "randn", "randint", "split_with_sizes_copy",
         "unbind_copy", "expand_copy", "permute_copy", "view_copy",
         "_reshape_copy", "diag_embed", "index_copy", "index_copy_",
         "scatter", "scatter_", "index_fill", "index_fill_",
         "sort", "topk", "unique", "_unique2", "unique_dim",
         "searchsorted", "bucketize", "isin", "equal", "max_pool2d_with_indices"}
# per result element: softmax (max, subtract, sum, divide) and its
# backward, layer norm's statistics and affine, and their backward
_PER_ELEMENT = {"_softmax": (4.0, 1.0), "_log_softmax": (4.0, 1.0),
                "_softmax_backward_data": (3.0, 0.0),
                "_log_softmax_backward_data": (3.0, 1.0),
                "native_layer_norm": (7.0, 0.0),
                "native_layer_norm_backward": (10.0, 0.0),
                "gelu": (5.0, 1.0), "gelu_backward": (8.0, 1.0),
                "native_batch_norm": (7.0, 0.0),
                "native_batch_norm_backward": (10.0, 0.0)}


def _numel(x) -> int:
    return x.numel() if isinstance(x, torch.Tensor) else 0


def _tensors(xs) -> Iterable[torch.Tensor]:
    for x in xs:
        if isinstance(x, torch.Tensor):
            yield x
        elif isinstance(x, (list, tuple)):
            yield from _tensors(x)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def aten_bucket(func) -> str:
    """The reference's bucket of one aten op overload."""
    ns = func.namespace
    if ns in ("c10d", "_c10d_functional", "c10d_functional"):
        return "comm"
    name = func._overloadpacket.__name__
    if name in _MATMUL:
        return "matmul"
    if name in _CONV:
        return "conv"
    if name in _LAYOUT:
        return "layout"
    if func.is_view or name in _NOOP:
        return "noop"
    return "elementwise"


def _conv_flops(out_numel, weight, transposed, groups, in_numel):
    k = weight.shape
    window = 1
    for d in k[2:]:
        window *= int(d)
    if transposed:
        # weight (Cin, Cout/g, k...): every input element scatters into
        # Cout/g outputs per window position
        return 2.0 * in_numel * int(k[1]) * window
    return 2.0 * out_numel * int(k[1]) * window


def aten_flops(func, args, kwargs, out) -> Tuple[float, float]:
    """(flops, transcendentals) of one aten op call."""
    name = func._overloadpacket.__name__
    outs = list(_tensors(out if isinstance(out, (list, tuple)) else [out]))
    out_n = sum(t.numel() for t in outs)
    if name in ("mm", "addmm", "bmm", "baddbmm", "mv", "addmv", "dot"):
        a, b = (args[1], args[2]) if name in ("addmm", "baddbmm",
                                              "addmv") else args[:2]
        k = a.shape[-1]
        extra = out_n if name in ("addmm", "baddbmm", "addmv") else 0
        return 2.0 * out_n * int(k) + extra, 0.0
    if name == "convolution":
        x, w = args[0], args[1]
        return _conv_flops(out_n, w, bool(args[6]), int(args[8]),
                           x.numel()), 0.0
    if name == "convolution_backward":
        g, x, w = args[0], args[1], args[2]
        mask = args[10]
        one = _conv_flops(g.numel(), w, bool(args[7]), int(args[9]),
                          x.numel())
        return one * (int(bool(mask[0])) + int(bool(mask[1]))) + (
            g.numel() if mask[2] else 0), 0.0
    if func.is_view or name in _NOOP or name in _MOVE:
        return 0.0, 0.0
    if name in _PER_ELEMENT:
        f, t = _PER_ELEMENT[name]
        return f * out_n, t * out_n
    if name in _REDUCE:
        ins = _numel(args[0]) if args else 0
        return float(max(ins - out_n, 0)), (
            float(ins) if name == "logsumexp" else 0.0)
    if name in _TRANSCENDENTAL:
        return 0.0, float(out_n)
    return float(out_n), 0.0


def aten_bytes(args, kwargs, out) -> int:
    """Materialized-buffers bytes: each distinct input tensor read once,
    each output written once."""
    seen, total = set(), 0
    for t in _tensors(list(args) + list((kwargs or {}).values())):
        if id(t) not in seen:
            seen.add(id(t))
            total += _nbytes(t)
    for t in _tensors(out if isinstance(out, (list, tuple)) else [out]):
        if id(t) not in seen:
            seen.add(id(t))
            total += _nbytes(t)
    return total


# --------------------------------------------------------------------------
# the step recorder
# --------------------------------------------------------------------------

class _Mode(TorchDispatchMode):
    def __init__(self, rec: "StepRecorder"):
        super().__init__()
        self.rec = rec

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self.rec.aten(func, args, kwargs, out)
        return out


class StepRecorder:
    """Records one region of work (a step): cost rows and the memory
    ledger.  Use as a context manager on the thread that runs the step;
    the autograd engine carries the dispatch mode onto its device thread.

    rows: one per counted aten op or kernel call — {seq, op (the
    "<op_type>:<op_index>" label or None), op_type, phase ("forward" or
    "backward"), bucket, name (aten op or kernel), flops,
    transcendentals, bytes}.
    allocs: one per storage created — {seq, free (the seq it died at,
    None while alive), bytes, op, op_type, phase, name (the aten op),
    param (a named state's or feed's name), bucket (None for a temp:
    observe/memory.py classifies)}.
    """

    def __init__(self, window=None):
        self.rows: List[Dict[str, Any]] = []
        self.allocs: List[Dict[str, Any]] = []
        self.seq = 0
        # on the card, an observe/memory.py `allocator_window`: each
        # event ends one of its samples (the allocator's peak since the
        # last event)
        self._window = window
        self.active = False
        self._mode = _Mode(self)
        self._tls = threading.local()
        self._lock = threading.Lock()
        self._live: Dict[int, Dict[str, Any]] = {}
        self._ranges = _trace.op_ranges(ranges=False)
        self._saved_recorder = None

    # -- lifecycle -------------------------------------------------------
    def __enter__(self):
        from ..ops import kernels

        self.active = True
        self._saved_recorder = kernels.recorder[0]
        kernels.recorder[0] = self
        self._ranges.__enter__()
        self._mode.__enter__()
        return self

    def __exit__(self, *exc):
        from ..ops import kernels

        self._mode.__exit__(*exc)
        self._ranges.__exit__(*exc)
        kernels.recorder[0] = self._saved_recorder
        self.active = False
        return False

    # -- attribution -----------------------------------------------------
    @staticmethod
    def _where() -> Tuple[Optional[str], str]:
        node = torch._C._current_autograd_node()
        label = _trace.current_op()
        phase = "forward" if node is None else "backward"
        if label is None and node is not None:
            label = _trace.node_op(node)
        return label, phase

    def kernel_region(self):
        return _Quiet(self._tls)

    def _quiet(self) -> bool:
        return getattr(self._tls, "depth", 0) > 0

    # -- events ----------------------------------------------------------
    def resident(self, tensor, name: str, bucket: str) -> None:
        """Register a tensor that exists before the step (state, feeds)
        in the ledger under its name and bucket."""
        if isinstance(tensor, torch.Tensor):
            self._track(tensor, {"op": None, "op_type": None,
                                 "phase": "state", "name": "resident",
                                 "param": name, "bucket": bucket},
                        tensor.numel() * tensor.element_size())

    def _track(self, t: torch.Tensor, info: Dict[str, Any],
               nbytes: Optional[int] = None) -> None:
        try:
            st = t.untyped_storage()
        except (RuntimeError, NotImplementedError):
            return
        n = st.nbytes() if nbytes is None else nbytes
        if n <= 0 or t.device.type == "meta":
            return
        key = id(st)
        with self._lock:
            if key in self._live:
                return
            entry = dict(info, seq=self.seq, free=None, bytes=int(n))
            self._live[key] = entry
            self.allocs.append(entry)
        weakref.finalize(st, self._freed, key)

    def _freed(self, key: int) -> None:
        with self._lock:
            entry = self._live.pop(key, None)
            if entry is not None and self.active:
                entry["free"] = self.seq

    def aten(self, func, args, kwargs, out) -> None:
        label, phase = self._where()
        op_type = _trace.fluid_op_of(label) if label else None
        name = func._overloadpacket.__name__
        outs = out if isinstance(out, (list, tuple)) else [out]
        for t in _tensors(outs):
            self._track(t, {"op": label, "op_type": op_type,
                            "phase": phase, "name": name, "param": None,
                            "bucket": None})
        if not self._quiet():
            flops, transc = aten_flops(func, args, kwargs, out)
            bucket = aten_bucket(func)
            self.rows.append({
                "seq": self.seq, "op": label, "op_type": op_type,
                "phase": phase, "bucket": bucket, "name": name,
                "flops": flops, "transcendentals": transc,
                "bytes": 0 if bucket == "noop" else aten_bytes(
                    args, kwargs, out)})
        self._advance()

    def _advance(self) -> None:
        if self._window is not None:
            self._window.sample()
        self.seq += 1

    def kernel_call(self, name: str, dims, nbytes) -> None:
        """ops/kernels `charge`: one call of kernel `name`'s function."""
        from ..ops.kernels import KERNEL_COSTS
        from torch.utils._python_dispatch import _disable_current_modes

        label, phase = self._where()
        with _disable_current_modes():
            nb = nbytes() if callable(nbytes) else nbytes
        self.rows.append({
            "seq": self.seq, "op": label,
            "op_type": _trace.fluid_op_of(label) if label else None,
            "phase": phase, "bucket": "custom_call", "name": name,
            "flops": float(KERNEL_COSTS[name](*dims)),
            "transcendentals": 0.0, "bytes": float(nb),
            "kernel": name})
        self._advance()


class _Quiet:
    def __init__(self, tls):
        self.tls = tls

    def __enter__(self):
        self.tls.depth = getattr(self.tls, "depth", 0) + 1

    def __exit__(self, *exc):
        self.tls.depth -= 1
        return False


class StepRecord:
    """One recorded run of a program's step: the port's counterpart of
    the reference's compiled step (ROADMAP C21).  `cost_analysis()` and
    `memory_analysis()` have the reference's shapes; `rows` are the
    recorder's cost rows, `allocs` its ledger."""

    def __init__(self, recorder: StepRecorder, labels, device,
                 window=None, held: int = 0):
        self.rows = recorder.rows
        self.allocs = recorder.allocs
        self.n_events = recorder.seq
        self.labels = labels
        self.device = device
        # the card only: the allocator's peak during each event (and
        # after the last), and over the run, above what was allocated
        # before it, plus `held`, the bytes of the tensors the run
        # needed that were on the card before it (its feeds)
        self.allocator_curve: List[int] = []
        self.allocator_peak_bytes: Optional[int] = None
        if window is not None:
            self.allocator_curve = [x - window.base + held
                                    for x in window.samples]
            self.allocator_peak_bytes = window.peak + held

    def cost_analysis(self) -> Dict[str, float]:
        t = total_costs(self)
        return {"flops": t["flops"],
                "transcendentals": t["transcendentals"],
                "bytes accessed": t["bytes"]}

    def memory_analysis(self) -> Dict[str, Any]:
        from .memory import ledger_peak

        peak, _ = ledger_peak(self)
        state = sum(a["bytes"] for a in self.allocs
                    if a["phase"] == "state")
        return {"peak_bytes": peak, "argument_bytes": state,
                "temp_bytes": max(peak - state, 0),
                "allocator_peak_bytes": self.allocator_peak_bytes}


def record_step(exe, program, feed=None, fetch_names=(), scope=None,
                run=None) -> StepRecord:
    """Record one run of `program`'s step on copies of `scope`'s state:
    the scope, its run counter (`__rng_key__`) and the kernels' launch
    counts are as they were after it.  `run(exe, program, feeds,
    fetch_names, scope)` runs the step (default: the executor's run
    path; a CompiledProgram passes its own).  On the card the caching
    allocator's peak over the copies and the run is kept beside the
    ledger's."""
    from ..core.executor import RNG_STATE_VAR, Scope
    from ..ops import kernels

    block = program.global_block()
    feeds = {n: exe._to_tensor(v, block, n) for n, v in (feed or {}).items()}
    names = sorted(v.name for v in block.vars.values()
                   if v.persistable and scope.find_var(v.name) is not None)
    counts = kernels.counts()
    dev = exe.device
    from .memory import _state_bucket, allocator_window, program_var_buckets

    window = allocator_window(dev) if dev.type == "cuda" else None
    rec = StepRecorder(window)
    tmp = Scope()
    tmp.set_var(RNG_STATE_VAR, scope.find_var(RNG_STATE_VAR))
    params, opt = program_var_buckets(program)
    try:
        with window or contextlib.nullcontext():
            for n in names:
                v = scope.find_var(n)
                copy = v.clone() if isinstance(v, torch.Tensor) else v
                tmp.set_var(n, copy)
                rec.resident(_local(copy), n,
                             _state_bucket(n, params, opt))
            for n, t in feeds.items():
                rec.resident(t, n, "activations")
            with rec:
                if run is None:
                    exe._run_program(program, feeds, list(fetch_names),
                                     tmp)
                else:
                    run(exe, program, feeds, list(fetch_names), tmp)
    finally:
        kernels.restore_counts(counts)
    for a in rec.allocs:
        # a state value the step replaced: its buffer was free to reuse
        a["donated"] = a["phase"] == "state" and a["param"] in names \
            and a["free"] is not None
    # the feeds were on the card before the window: the step needs
    # them all the same
    return StepRecord(rec, [("state", n) for n in names]
                      + [("feed", n) for n in feeds], dev, window,
                      sum(_nbytes(t) for t in feeds.values()))


def _local(v):
    """The tensor a scope value holds on this process (a DTensor's local
    slice), or None."""
    from torch.distributed.tensor import DTensor

    if isinstance(v, DTensor):
        return v.to_local()
    return v if isinstance(v, torch.Tensor) else None


# --------------------------------------------------------------------------
# tables
# --------------------------------------------------------------------------

def _step_record(program=None, feed=None, fetch_list=None, scope=None,
                 exe=None, record=None) -> StepRecord:
    if record is not None:
        return record
    if program is None:
        raise ValueError("needs a program or a step record")
    from ..core.executor import Executor

    exe = exe or Executor()
    return exe.compiled_step(program, feed=feed, fetch_list=fetch_list,
                             scope=scope)


def total_costs(record: StepRecord) -> Dict[str, Any]:
    """Whole-step totals over a step record's rows.  `kernel_flops` is
    the hand-written kernels' share; `custom_calls` counts their calls
    (every one of them carries its registered cost)."""
    rows = record.rows
    kern = [r for r in rows if r["bucket"] == "custom_call"]
    return {
        "flops": sum(r["flops"] for r in rows),
        "transcendentals": sum(r["transcendentals"] for r in rows),
        "bytes": float(sum(r["bytes"] for r in rows)),
        "kernel_flops": sum(r["flops"] for r in kern),
        "custom_calls": len(kern),
        "bucket_bytes": _sum_by(rows, "bytes"),
        "bucket_flops": _sum_by(rows, "flops"),
    }


def _sum_by(rows: Iterable[Dict[str, Any]], key: str) -> Dict[str, float]:
    out: Dict[str, float] = {}
    for r in rows:
        out[r["bucket"]] = out.get(r["bucket"], 0.0) + float(r[key])
    return out


def program_costs(program, feed=None, fetch_list=None, scope=None,
                  exe=None) -> Dict[str, Any]:
    """`total_costs` of a program's recorded step, with the step's peak
    device memory (`peak_hbm_bytes`, the memory ledger's peak, and on
    the card `allocator_peak_bytes`)."""
    rec = _step_record(program, feed, fetch_list, scope, exe)
    out = total_costs(rec)
    from .memory import ledger_peak

    out["peak_hbm_bytes"] = ledger_peak(rec)[0]
    out["allocator_peak_bytes"] = rec.allocator_peak_bytes
    return out


def _event_bucket(name: str, on_card: bool) -> str:
    """The bucket of one traced device event: a kernel's by its name on
    the card, an aten op's by its op on the CPU."""
    from ..ops.kernels import KERNELS

    n = name.lower()
    if on_card:
        if any(k in n for k in ("flash_", "vocab_ce_", "lstm_fwd",
                                "lstm_bwd", "paged_split", "paged_merge")):
            return "custom_call"
        if any(k in n for k in ("gemm", "gemv", "nvjet", "cutlass",
                                "xmma", "cublas", "splitk")):
            return "matmul"
        if "conv" in n or "cudnn" in n or "implicit" in n:
            return "conv"
        if "nccl" in n:
            return "comm"
        if "memcpy" in n or "copy" in n or "transpose" in n:
            return "layout"
        return "elementwise"
    base = n.split("::")[-1]
    if base in KERNELS:
        return "custom_call"
    if base in _MATMUL:
        return "matmul"
    if base in _CONV:
        return "conv"
    if base in _LAYOUT:
        return "layout"
    return "elementwise"


def op_cost_table(program=None, feed=None, fetch_list=None, scope=None,
                  exe=None, profile_dir: Optional[str] = None,
                  peak_flops: Optional[float] = None,
                  hbm_bw: Optional[float] = None,
                  record: Optional[StepRecord] = None
                  ) -> List[Dict[str, Any]]:
    """Per-framework-op cost rows of a program's recorded step.

    Each row aggregates the counted aten ops and kernel calls of one
    (fluid op type, bucket) pair:

        {op_type, bucket, instructions, flops, transcendentals, bytes,
         time_ms, arith_intensity, achieved_flops_frac,
         roofline_time_ms}

    - `time_ms` joins measured device time from the `torch.profiler`
      trace under `profile_dir` (observe/trace.py): each event goes to
      its op's row of the event's bucket, or, when the op has no row of
      that bucket (a plain version's products inside a kernel route on
      the CPU), to the op's row with the most flops.  None without a
      trace.
    - `achieved_flops_frac` = (flops / time) / peak_flops when both are
      known; `roofline_time_ms` = max(flops / peak, bytes / bw).
    Pass `record` (a StepRecord) to tabulate an existing record.
    """
    rec = _step_record(program, feed, fetch_list, scope, exe, record)
    if peak_flops is None and hbm_bw is None:
        peak_flops, hbm_bw = device_peaks() if rec.device.type == "cuda" \
            else (None, None)
    grouped: Dict[Tuple[str, str], Dict[str, Any]] = {}
    for r in rec.rows:
        if r["bucket"] == "noop":
            continue
        key = (r["op_type"] or "[unattributed]", r["bucket"])
        g = grouped.setdefault(key, {
            "op_type": key[0], "bucket": key[1], "instructions": 0,
            "flops": 0.0, "transcendentals": 0.0, "bytes": 0.0,
            "time_ms": None})
        g["instructions"] += 1
        g["flops"] += r["flops"]
        g["transcendentals"] += r["transcendentals"]
        g["bytes"] += float(r["bytes"])
    if profile_dir is not None:
        for name, label, ms, on_card in _trace.device_events(profile_dir):
            op = (_trace.fluid_op_of(label) if label else None) \
                or "[unattributed]"
            g = grouped.get((op, _event_bucket(name, on_card)))
            if g is None:
                mine = [x for (o, _b), x in grouped.items() if o == op]
                if not mine:
                    continue
                g = max(mine, key=lambda x: x["flops"])
            g["time_ms"] = (g["time_ms"] or 0.0) + ms
    out = []
    for g in grouped.values():
        g["arith_intensity"] = (round(g["flops"] / g["bytes"], 3)
                                if g["bytes"] else None)
        g["achieved_flops_frac"] = None
        g["roofline_time_ms"] = None
        if peak_flops:
            if g["time_ms"]:
                g["achieved_flops_frac"] = round(
                    (g["flops"] / (g["time_ms"] / 1e3)) / peak_flops, 4)
            if hbm_bw:
                g["roofline_time_ms"] = round(
                    max(g["flops"] / peak_flops,
                        g["bytes"] / hbm_bw) * 1e3, 4)
        out.append(g)
    out.sort(key=lambda g: (-(g["time_ms"] or 0.0), -g["flops"],
                            -g["bytes"]))
    return out


def layout_byte_share(record: StepRecord) -> float:
    """Fraction of the step's modeled bytes spent in the layout bucket
    (the contiguous copies of strided views, C21)."""
    rows = [r for r in record.rows if r["bucket"] != "noop"]
    total = sum(r["bytes"] for r in rows)
    if not total:
        return 0.0
    return sum(r["bytes"] for r in rows if r["bucket"] == "layout") / total


def copyish_instructions(record: StepRecord,
                         op_types: Optional[set] = None
                         ) -> List[Dict[str, Any]]:
    """The step's copies (`copy_`, `clone`), optionally only those
    charged to the given fluid op types."""
    return [{"name": r["name"], "opcode": r["name"],
             "op_type": r["op_type"], "bytes": float(r["bytes"])}
            for r in record.rows if r["bucket"] == "layout"
            and (op_types is None or r["op_type"] in op_types)]


def flash_boundary_layout(record: StepRecord,
                          kernel_prefix: str = "flash"
                          ) -> List[Dict[str, Any]]:
    """Copies charged to the same fluid op as a flash kernel call, next
    to it in the step's order: the copies a flash op's operands needed
    at the kernel's boundary (head-major operands need none)."""
    rows = record.rows
    out = []
    for i, r in enumerate(rows):
        if r["bucket"] != "custom_call" \
                or not r["name"].startswith(kernel_prefix):
            continue
        for j in (i - 1, i + 1):
            if 0 <= j < len(rows) and rows[j]["bucket"] == "layout" \
                    and rows[j]["op"] == r["op"]:
                out.append({"custom_call": r["name"], "kernel": r["name"],
                            "neighbor": rows[j]["name"],
                            "opcode": rows[j]["name"]})
    return out


def bucket_summary(rows: List[Dict[str, Any]]
                   ) -> Dict[str, Dict[str, float]]:
    """Collapse op_cost_table rows to per-bucket totals."""
    out: Dict[str, Dict[str, float]] = {}
    for r in rows:
        b = out.setdefault(r["bucket"], {"flops": 0.0, "bytes": 0.0,
                                         "time_ms": 0.0,
                                         "instructions": 0})
        b["flops"] += r["flops"]
        b["bytes"] += r["bytes"]
        b["time_ms"] += r["time_ms"] or 0.0
        b["instructions"] += r["instructions"]
    return out


def format_cost_table(rows: List[Dict[str, Any]], top: int = 30) -> str:
    """Human-readable per-op cost report."""
    hdr = (f"{'Op':<24}{'Bucket':<12}{'Instrs':>7}{'GFLOP':>10}"
           f"{'MB':>10}{'Time(ms)':>10}{'AI':>8}{'Ach.MFU':>9}")
    lines = ["-------> Per-op cost attribution <-------", hdr,
             "-" * len(hdr)]
    for r in rows[:top]:
        lines.append(
            f"{r['op_type']:<24}{r['bucket']:<12}{r['instructions']:>7}"
            f"{r['flops'] / 1e9:>10.3f}{r['bytes'] / 1e6:>10.2f}"
            f"{(r['time_ms'] if r['time_ms'] is not None else -1):>10.3f}"
            f"{(r['arith_intensity'] or 0):>8.1f}"
            f"{(r['achieved_flops_frac'] if r['achieved_flops_frac'] is not None else -1):>9.4f}")
    if len(rows) > top:
        lines.append(f"... ({len(rows) - top} more rows)")
    return "\n".join(lines)
