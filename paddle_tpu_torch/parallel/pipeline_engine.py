"""Pipeline engine: tagged fluid-program layer segments run as GPipe.

The port of paddle_tpu/parallel/pipeline_engine.py.  A user builds an
ordinary Program with the repeated layers tagged by `pipeline_scope()` /
`pipeline_segment()` (core/program.py); when it runs under a
CompiledProgram whose mesh has a `pp` axis, the executor hands each
tagged op run to `run_pipelined_group`, which

1. splits the run into per-segment op lists and canonicalizes each
   (per-layer parameter names -> positional slots, carried activation
   vs invariant inputs), checking that every segment is structurally
   identical (`analyze_group`, `PipelineStructureError`);
2. gives pp stage s the layers s*L/S .. (s+1)*L/S - 1: this rank runs
   only its stage's layers, with its stage's parameters, which are the
   only ones it holds (`StageHeld`, `stage_ownership`);
3. microbatches the carried activation (and the invariants with a batch
   dim; `_pick_n_micro`, 2 x pp by default or
   `BuildStrategy.pipeline_microbatches`) and runs the GPipe schedule
   of parallel/pipeline.py, replaying segment 0's op descs with each
   layer's parameters as the stage function (each layer under
   `torch.utils.checkpoint` when the layers carry `recompute_scope`
   tags);
4. writes the final carry (replicated over pp) into the env under the
   last segment's output names.

The ops outside the group run replicated on every pp rank: the last
stage's carry is broadcast, and so is stage 0's input cotangent, so the
replicated parameters get identical gradients on every pp rank.  The
loss is computed after the group on the whole batch, so the result is
the unpipelined program's (up to the order of sums).  On a mesh without
a pp axis the tags are inert.  pp x mp is the reference's designed
error.  Dropout inside a stage draws per (layer, microbatch), as the
reference folds them into its key.
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch


class PipelineStructureError(ValueError):
    """Raised when tagged segments cannot form a legal pipeline."""


_TAG_ATTRS = ("__pp_group__", "__pp_seg__", "__recompute__")
# folded with the layer's global index into a stage op's seed material
# (the reference's fold_in(key, 104729 + layer))
LAYER_SEED_BASE = 104729


def _clean_attrs(attrs: Dict[str, Any]) -> Dict[str, Any]:
    return {k: v for k, v in attrs.items() if k not in _TAG_ATTRS}


def _canonicalize(seg_ops, is_param) -> Dict[str, Any]:
    """Positional renaming of one segment's dataflow (the reference's
    `_canonicalize`): pattern, params in first-use order, externals
    (non-param names read before written) and the name -> token map."""
    canon: Dict[str, str] = {}
    params: List[str] = []
    externals: List[str] = []
    pattern = []
    for j, op in enumerate(seg_ops):
        d = op.desc
        ins_tok = {}
        for slot in sorted(d.inputs):
            toks = []
            for n in d.inputs[slot]:
                if n not in canon:
                    if is_param(n):
                        canon[n] = f"P{len(params)}"
                        params.append(n)
                    else:
                        canon[n] = f"X{len(externals)}"
                        externals.append(n)
                toks.append(canon[n])
            ins_tok[slot] = tuple(toks)
        out_tok = {}
        for slot in sorted(d.outputs):
            toks = []
            for i, n in enumerate(d.outputs[slot]):
                canon[n] = f"V{j}.{slot}.{i}"
                toks.append(canon[n])
            out_tok[slot] = tuple(toks)
        pattern.append((d.type, tuple(sorted(_clean_attrs(d.attrs).items(),
                                             key=lambda kv: kv[0])),
                        tuple(sorted(ins_tok.items())),
                        tuple(sorted(out_tok.items()))))
    return {"pattern": pattern, "params": params,
            "externals": externals, "canon": canon}


def _hashable(v):
    if isinstance(v, (list, tuple)):
        return tuple(_hashable(x) for x in v)
    if isinstance(v, dict):
        return tuple(sorted((k, _hashable(x)) for k, x in v.items()))
    if isinstance(v, np.ndarray):
        return (v.shape, str(v.dtype), v.tobytes())
    return v


def analyze_group(group_ops, block) -> Dict[str, Any]:
    """Split a tagged op run into segments and verify pipelineability
    (the reference's checks and messages).  Returns the carry /
    invariant / param structure shared by all segments."""
    from ..core.program import Parameter

    def is_param(name: str) -> bool:
        return block.has_var(name) and isinstance(block.var(name),
                                                  Parameter)

    segs: List[List[Any]] = []
    for op in group_ops:
        seg = op.desc.attrs["__pp_seg__"]
        if seg == len(segs):
            segs.append([op])
        elif seg == len(segs) - 1:
            segs[-1].append(op)
        else:
            raise PipelineStructureError(
                f"pipeline segments out of order: op {op.desc.type!r} "
                f"has segment {seg}, expected {len(segs) - 1} or "
                f"{len(segs)}")
    if len(segs) < 2:
        raise PipelineStructureError(
            "a pipeline_scope needs at least 2 pipeline_segment() "
            f"layers; got {len(segs)}")

    infos = [_canonicalize(s, is_param) for s in segs]
    p0 = tuple(_hashable(infos[0]["pattern"]))
    for k, info in enumerate(infos[1:], 1):
        if tuple(_hashable(info["pattern"])) != p0:
            raise PipelineStructureError(
                f"pipeline segment {k} is not structurally identical to "
                f"segment 0 (op sequence/attrs/dataflow differ); "
                f"pipeline_segment() layers must be exact repeats")

    n_ext = len(infos[0]["externals"])
    carry_pos, invariant_pos = [], []
    for i in range(n_ext):
        names = [info["externals"][i] for info in infos]
        if all(n == names[0] for n in names):
            invariant_pos.append(i)
        else:
            carry_pos.append(i)
    if not carry_pos:
        raise PipelineStructureError(
            "pipeline segments share every input — no carried "
            "activation flows layer to layer")

    carry_out_tokens: List[str] = []
    for i in carry_pos:
        toks = set()
        for k in range(1, len(segs)):
            name_k = infos[k]["externals"][i]
            tok = infos[k - 1]["canon"].get(name_k)
            if tok is None or tok.startswith(("P", "X")):
                raise PipelineStructureError(
                    f"segment {k} input {name_k!r} is not produced by "
                    f"segment {k - 1}; carried activations must flow "
                    f"layer to layer")
            toks.add(tok)
        if len(toks) != 1:
            raise PipelineStructureError(
                f"carry slot {i} is fed by different producer ops "
                f"across segments: {sorted(toks)}")
        carry_out_tokens.append(toks.pop())

    for k, s in enumerate(segs):
        for op in s:
            for n in op.desc.output_names():
                if block.has_var(n) and block.var(n).persistable:
                    raise PipelineStructureError(
                        f"pipeline segment {k} writes persistable var "
                        f"{n!r}; stateful layers (e.g. batch_norm "
                        f"moving stats) cannot be pipelined")

    seen: Dict[str, int] = {}
    for k, info in enumerate(infos):
        for n in info["params"]:
            if n in seen:
                raise PipelineStructureError(
                    f"parameter {n!r} is used by segments {seen[n]} "
                    f"and {k}; pipelined layers must not share "
                    f"parameters")
            seen[n] = k

    out_names_by_token = {}
    for k_out in carry_out_tokens:
        for n, t in infos[-1]["canon"].items():
            if t == k_out:
                out_names_by_token[k_out] = n
    return {
        "segs": segs,
        "infos": infos,
        "carry_pos": carry_pos,
        "invariant_pos": invariant_pos,
        "carry_out_tokens": carry_out_tokens,
        "final_out_names": [out_names_by_token[t]
                            for t in carry_out_tokens],
        "recompute": all(
            op.desc.attrs.get("__recompute__") is not None
            for op in segs[0]),
    }


def _pick_n_micro(requested: int, batch: int, s: int,
                  dp: int = 1) -> int:
    """The reference's microbatch count over the global `batch`: the
    request, else 2 x pp or pp, preferring a count whose microbatch
    divides the data axis."""
    if requested:
        if batch % requested != 0:
            raise PipelineStructureError(
                f"pipeline_microbatches={requested} must divide the "
                f"batch size {batch}")
        return requested
    cands = [c for c in (2 * s, s) if batch % c == 0]
    for cand in cands:
        if (batch // cand) % dp == 0:
            return cand
    if cands:
        return cands[0]
    raise PipelineStructureError(
        f"cannot auto-pick a microbatch count: batch {batch} is not "
        f"divisible by {2 * s} or {s} (pp={s}); set "
        f"BuildStrategy.pipeline_microbatches explicitly")


def pipeline_groups(ops):
    """The maximal runs of consecutive ops sharing a `__pp_group__` tag,
    as (start, end) index pairs into `ops`."""
    out, i, n = [], 0, len(ops)
    while i < n:
        gid = ops[i].desc.attrs.get("__pp_group__")
        if gid is None:
            i += 1
            continue
        j = i
        while j < n and ops[j].desc.attrs.get("__pp_group__") == gid:
            j += 1
        out.append((i, j))
        i = j
    return out


def stage_ownership(program, s: int) -> Dict[str, int]:
    """{state var: its pp stage} for a pp axis of size s: each tagged
    group's layer k (of L) on stage k // (L / s), with its parameters
    and the optimizer state only their update ops read.  Empty when a
    group's layers do not divide over s (the run raises)."""
    from .compiler import OPTIMIZER_OP_TYPES

    block = program.global_block()
    ops = block.ops
    info = getattr(program, "_backward_info", None)
    fwd = ops[:info["index"]] if info else ops
    owner: Dict[str, int] = {}
    for i, j in pipeline_groups(fwd):
        try:
            g = analyze_group(fwd[i:j], block)
        except PipelineStructureError:
            return {}
        n_layers = len(g["segs"])
        if n_layers % s:
            return {}
        per = n_layers // s
        for k, inf in enumerate(g["infos"]):
            for p in inf["params"]:
                owner[p] = k // per
    users: Dict[str, set] = {}
    for op in ops:
        if op.desc.type not in OPTIMIZER_OP_TYPES:
            continue
        param = (op.desc.inputs.get("Param") or [None])[0]
        names = [n for slot, ns in op.desc.inputs.items()
                 if slot not in ("Param", "Grad", "LearningRate")
                 for n in ns]
        names += [n for slot, ns in op.desc.outputs.items()
                  if slot != "ParamOut" for n in ns]
        for n in names:
            users.setdefault(n, set()).add(owner.get(param))
    for n, stages in users.items():
        if len(stages) == 1 and None not in stages:
            owner[n] = stages.pop()
    return owner


class StageHeld:
    """A scope value of a pipelined layer's state var on a pp mesh: the
    tensor on the rank of its stage, None on the others.
    `full_tensor()` is the logical value (a broadcast from the owning
    rank: every rank of the pp group calls it)."""

    def __init__(self, value, owner: int, mesh, shape, dtype):
        self.value, self.owner, self.mesh = value, int(owner), mesh
        self.shape, self.dtype = tuple(shape), dtype

    def full_tensor(self):
        import torch.distributed as dist

        from .pipeline import _broadcast

        group = self.mesh.group("pp")
        v = self.value
        if v is None:
            dev = torch.device("cpu") if dist.get_backend(group) == "gloo" \
                else torch.device("cuda", torch.cuda.current_device())
            v = torch.empty(self.shape, dtype=self.dtype, device=dev)
        src = dist.get_process_group_ranks(group)[self.owner]
        return _broadcast([v], src, group)[0]

    def owner_rank(self) -> int:
        """The lowest global rank of the stage that holds the value."""
        axis = self.mesh.axis_names.index("pp")
        return int(np.take(self.mesh.devices, self.owner, axis=axis).min())

    def __repr__(self):
        return (f"StageHeld(stage {self.owner}, {list(self.shape)}, "
                f"{'held' if self.value is not None else 'elsewhere'})")


def run_pipelined_group(group_ops, env: Dict[str, Any], seed,
                        start_index: int, program, mesh,
                        batch_axis: str = "dp", n_micro_req: int = 0,
                        amp_lists=None, downstream_reads=None, device=None,
                        data_n: int = 1) -> None:
    """Execute a tagged group through the GPipe schedule, mutating env
    in place.  `data_n`: the data-parallel degree (the rank's carry is
    its 1/data_n of the batch)."""
    from ..core.executor import _run_one_op
    from .pipeline import run_schedule

    block = program.global_block()
    composed = sorted(a for a, size in mesh.shape.items()
                      if a not in ("pp", batch_axis) and size > 1)
    if composed:
        raise PipelineStructureError(
            f"pipeline parallelism cannot compose with in-stage "
            f"sharded axes {composed} on this backend: the pp "
            f"shard_map would replicate {composed}-sharded params "
            f"inside every stage (silent "
            f"{'x'.join(str(mesh.shape[a]) for a in composed)}-fold "
            f"redundant compute), and partial-auto shard_map is "
            f"rejected by this XLA.  Use a dp×pp mesh, or mp without "
            f"pp (docs/DIST.md, pp×mp status).")
    info = analyze_group(group_ops, block)
    segs, infos = info["segs"], info["infos"]
    n_layers = len(segs)
    s = mesh.shape["pp"]
    if n_layers % s != 0:
        raise PipelineStructureError(
            f"{n_layers} pipeline segments cannot split over pp={s} stages "
            f"(need pp | n_layers)")
    per = n_layers // s
    me = mesh.coordinate("pp")

    ext0 = infos[0]["externals"]
    carry_names0 = [ext0[i] for i in info["carry_pos"]]
    invariant_names = [ext0[i] for i in info["invariant_pos"]]
    param_order = infos[0]["params"]

    if downstream_reads is not None:
        internal = set()
        for seg in segs:
            for op in seg:
                internal.update(op.desc.output_names())
        internal -= set(info["final_out_names"])
        leaked = sorted(internal & set(downstream_reads))
        if leaked:
            raise PipelineStructureError(
                f"vars {leaked} are internal to a pipelined region but "
                f"read downstream; fetch/consume only the region's "
                f"final output (or disable pipelining)")

    layers = range(me * per, (me + 1) * per)
    missing = [n for k in layers for n in infos[k]["params"] if n not in env]
    if missing:
        raise PipelineStructureError(
            f"pp stage {me} does not hold its layers' parameters "
            f"{missing[:4]}")
    stage_params = [env[n] for k in layers for n in infos[k]["params"]]

    carries = [env[n] for n in carry_names0]
    batch = carries[0].shape[0]
    n_micro = _pick_n_micro(n_micro_req, batch * data_n, s, dp=data_n)
    if batch % n_micro:
        raise PipelineStructureError(
            f"{n_micro} microbatches do not divide this rank's batch "
            f"{batch} (the global {batch * data_n} over {data_n} data "
            f"ranks)")
    mb = batch // n_micro

    def split(v):
        return v.reshape((n_micro, mb) + tuple(v.shape[1:]))

    x_carry = [split(c) for c in carries]
    x_inv = []
    for n in invariant_names:
        v = env[n]
        if v.dim() >= 1 and v.shape[0] == batch and batch > 1:
            x_inv.append(split(v))
        else:
            x_inv.append(v.unsqueeze(0).expand((n_micro,)
                                               + tuple(v.shape)))
    n_carry = len(x_carry)
    canon_rev = {t: n for n, t in infos[0]["canon"].items()}
    carry_out_names0 = [canon_rev[t] for t in info["carry_out_tokens"]]
    seg0 = segs[0]
    n_p = len(param_order)

    def layer_fn(layer_params, carry, inv, layer_global, m):
        local = dict(zip(param_order, layer_params))
        local.update(zip(carry_names0, carry))
        local.update(zip(invariant_names, inv))
        key = None if seed is None else tuple(seed) + (
            LAYER_SEED_BASE + layer_global, m)
        for j, op in enumerate(seg0):
            _run_one_op(op, local, key, start_index + j, program=program,
                        device=device, amp_lists=amp_lists)
        return [local[n] for n in carry_out_names0]

    def stage_fn(params, xs, m):
        carry, inv = list(xs[:n_carry]), list(xs[n_carry:])
        for li in range(per):
            lp = params[li * n_p:(li + 1) * n_p]
            if info["recompute"] and torch.is_grad_enabled():
                from torch.utils.checkpoint import checkpoint

                carry = list(checkpoint(
                    lambda *a, _g=me * per + li: tuple(layer_fn(
                        list(a[:n_p]), list(a[n_p:n_p + n_carry]),
                        list(a[n_p + n_carry:]), _g, m)),
                    *lp, *carry, *inv, use_reentrant=False,
                    preserve_rng_state=False))
            else:
                carry = layer_fn(lp, carry, inv, me * per + li, m)
        return carry + inv

    out = run_schedule(stage_fn, mesh, "pp", x_carry + x_inv, stage_params)
    for n, v in zip(info["final_out_names"], out[:n_carry]):
        env[n] = v.reshape((batch,) + tuple(v.shape[2:]))
