"""Observe pillar 6: numerics observability — per-layer training
dynamics and first-nonfinite op provenance, all on the device.

The port of paddle_tpu/observe/numerics.py.  The reference ran a
per-op NaN scan on HOST after every op (operator.cc:943 under
FLAGS_check_nan_inf); here every piece is a torch op on the executor's
device and nothing is read back during a step.  Two capabilities:

1. PER-LAYER TRAINING DYNAMICS — grad norm, param norm and update
   ratio (|dw|/|w|) accumulated per NAMED PARAMETER GROUP: attn_qkv /
   attn_out / ffn_in / ffn_out / moe_gate / moe_expert / embedding /
   other.  The group vocabulary is FIXED and bounded so the telemetry
   accumulator carries only a few (G,) vectors, fetched with it by
   `fetch_telemetry`.

2. FIRST-NONFINITE OP PROVENANCE — each step builds a packed per-op
   finite bitmap (one bit per fluid op, 32 bits per word, keyed by the
   op's program index so pruning never shifts a bit) from every op's
   outputs (`update_bits`, called by the executor's `_run_one_op`).
   The bitmap is LATCHED into the accumulator on the first poisoned
   step of a window; later clean or poisoned steps never overwrite it.
   Host-side, `join_first_nonfinite` joins the latched bit back to the
   fluid op type/name/group via the program desc.

The words are int32 tensors on the device (torch lacks uint32 bitwise
ops on some devices); `fetch_telemetry` reads the same 32 bits as
uint32.  Scope notes: the backward (autodiff) region is not a fluid
op, so a step whose op outputs are all finite but whose grads are not
latches with ZERO bits and reports origin "backward/autodiff";
provenance applies to training programs.

Enabling is a program-level flag (`enable_numerics`) exactly like
`enable_telemetry`.  Disabled, every hook is one dict-membership check
per op: the step launches exactly what it launches without this
module.
"""

from __future__ import annotations

import math
import re
from typing import Any, Dict, Iterable, List, Optional

import numpy as np
import torch

# Per-step bitmap riding `env` (never part of the scope: it is zeroed
# at the top of every step and folded into the telemetry accumulator's
# latch at the bottom).
NUMERICS_BITS_VAR = "__numerics_bits__"

# Latched-bitmap fields inside the `__telemetry__` accumulator.
NONFINITE_WORDS = "nonfinite_op_words"
NONFINITE_LATCH = "nonfinite_latched"

# The bounded group vocabulary — ordered, first match wins.  These are
# the NAMED transformer-layer prefixes the sharding rules key on
# (parallel/strategies.py); `switch_moe(name=...)` APPENDS user names
# to the moe_gate/moe_expert prefixes, and LayerHelper prefixes every
# generated param/tmp name with the layer name, so an un-anchored
# substring search is the stable match.
GROUP_NAMES = ("attn_qkv", "attn_out", "ffn_in", "ffn_out",
               "moe_gate", "moe_expert", "embedding", "other")
N_GROUPS = len(GROUP_NAMES)

_GROUP_PATTERNS = [
    ("attn_qkv", re.compile(r"attn_qkv")),
    ("attn_out", re.compile(r"attn_out")),
    ("ffn_in", re.compile(r"ffn_in")),
    ("ffn_out", re.compile(r"ffn_out")),
    ("moe_gate", re.compile(r"moe_gate")),
    ("moe_expert", re.compile(r"moe_expert")),
    # word_emb / src_word_emb / word_embedding / fm_emb / pos_enc emb
    ("embedding", re.compile(r"emb")),
]

# per-group window fields (all (G,) float32 vectors; squared norms so
# cross-group sums compose exactly: sum_g group_gsq == global gnorm^2)
GROUP_FIELDS = ("group_gsq_last", "group_gsq_sum", "group_usq_last",
                "group_usq_sum", "group_psq_last")


def group_of(name: str) -> int:
    """Group index for one parameter/variable name (first pattern that
    matches anywhere in the name wins; unmatched -> other)."""
    for i, (_g, pat) in enumerate(_GROUP_PATTERNS):
        if pat.search(name):
            return i
    return N_GROUPS - 1  # "other"


def param_groups(names: Iterable[str]) -> Dict[str, int]:
    """name -> group index for a parameter set (host-side, step
    setup)."""
    return {n: group_of(n) for n in names}


# ---------------------------------------------------------------------------
# Program-level switch (mirrors metrics.enable_telemetry)
# ---------------------------------------------------------------------------

def enable_numerics(program) -> None:
    """Opt a Program's training step into numerics observability
    (per-group dynamics + first-nonfinite provenance).  Implies
    device-side telemetry; bumps the program version, as the
    reference does."""
    from . import metrics as _metrics

    program._numerics_enabled = True
    _metrics.enable_telemetry(program)
    program._bump()


def numerics_enabled(program) -> bool:
    return bool(getattr(program, "_numerics_enabled", False))


# ---------------------------------------------------------------------------
# Accumulator fields
# ---------------------------------------------------------------------------

def n_bit_words(n_ops: int) -> int:
    return max(1, int(math.ceil(n_ops / 32.0)))


def init_numerics_fields(n_ops: int, device=None) -> Dict[str, Any]:
    """Zeroed numerics fields merged into init_telemetry()'s dict when
    the program opted in (metrics.init_telemetry_for), on `device`
    (None: CUDAPlace(0))."""
    from ..core.executor import _run_device

    dev = _run_device(device)
    out: Dict[str, Any] = {
        f: torch.zeros(N_GROUPS, dtype=torch.float32, device=dev)
        for f in GROUP_FIELDS}
    out[NONFINITE_WORDS] = torch.zeros(n_bit_words(n_ops),
                                       dtype=torch.int32, device=dev)
    out[NONFINITE_LATCH] = torch.zeros((), dtype=torch.int32, device=dev)
    return out


# ---------------------------------------------------------------------------
# Step helpers (called from core/executor.py; device ops only)
# ---------------------------------------------------------------------------

def init_step_bits(n_ops: int, device) -> torch.Tensor:
    """Fresh all-finite bitmap for one step."""
    return torch.zeros(n_bit_words(n_ops), dtype=torch.int32,
                       device=device)


def _float_parts(values):
    """Float tensors of a list of op outputs: SparseGrad contributes
    rows, tuples and host constants are skipped, non-float dtypes are
    always finite."""
    from ..core.selected_rows import SparseGrad

    for v in values:
        if isinstance(v, SparseGrad):
            v = v.rows
        if isinstance(v, torch.Tensor) and v.is_floating_point():
            yield v


def _bit_value(bit: int) -> int:
    """The int32 value whose only set bit is `bit` (bit 31 is the sign
    bit)."""
    return (1 << bit) - (1 << 32 if bit == 31 else 0)


def update_bits(bits: torch.Tensor, op_index: int, values) -> torch.Tensor:
    """OR op `op_index`'s nonfinite flag into the step bitmap (one
    isfinite-all reduction per float output, no host read)."""
    bad = None
    for a in _float_parts(values):
        b = ~torch.isfinite(a.detach()).all()
        bad = b if bad is None else (bad | b)
    if bad is None:
        return bits
    word, bit = divmod(int(op_index), 32)
    if word >= bits.shape[0]:  # defensive: op beyond the built bitmap
        return bits
    # in place: the step's bitmap is created per step and shared by
    # nothing else
    bits[word] |= bad.to(torch.int32) * _bit_value(bit)
    return bits


def or_across_axis(words: torch.Tensor, group) -> torch.Tensor:
    """Exact bitwise-OR all-reduce of a bitmap over a data-parallel
    group (a `parallel.collectives.DataGroup`, None for one rank): a
    per-bit MAX, as the reference's (paddle_tpu/observe/numerics.py:196)
    — NCCL has no bitwise-OR reduction, and a MAX over packed words
    would keep one rank's word."""
    if group is None:
        return words
    shifts = torch.arange(32, dtype=torch.int64, device=words.device)
    w = words.to(torch.int64) & 0xFFFFFFFF
    bits = ((w[:, None] >> shifts) & 1).to(torch.int32)
    bits = group.all_reduce(bits, "max").to(torch.int64)
    packed = (bits << shifts).sum(dim=1)
    # back to int32 through the low 32 bits (bit 31 is the sign bit)
    return (packed - (packed >= 2 ** 31).to(torch.int64) * 2 ** 32).to(
        torch.int32)


def device_group_update(tel: Dict[str, Any], grads: Dict[str, Any],
                        params_before: Dict[str, Any],
                        env: Dict[str, Any],
                        groups: Dict[str, int]) -> Dict[str, Any]:
    """One step's per-group accumulation, on the device.  Mirrors
    metrics.device_update's global norms but adds each parameter's
    squared norm into its group slot, so sum_g group_gsq_last ==
    grad_norm_last^2 (summation order aside).  params_before are the
    PRE-update values (the |w| denominator of the update ratio); env
    holds the post-update values."""
    from ..core.selected_rows import SparseGrad

    dev = tel["group_gsq_sum"].device
    gsq = torch.zeros(N_GROUPS, dtype=torch.float32, device=dev)
    psq = torch.zeros(N_GROUPS, dtype=torch.float32, device=dev)
    usq = torch.zeros(N_GROUPS, dtype=torch.float32, device=dev)
    for pname, g in grads.items():
        idx = groups.get(pname, N_GROUPS - 1)
        parts = (g.rows,) if isinstance(g, SparseGrad) else (g,)
        for a in parts:
            af = a.float()
            gsq[idx] += torch.sum(af * af)
    for pname, old in params_before.items():
        idx = groups.get(pname, N_GROUPS - 1)
        of = old.float()
        psq[idx] += torch.sum(of * of)
        new = env.get(pname)
        if new is None or new is old:
            continue
        d = new.float() - of
        usq[idx] += torch.sum(d * d)
    out = dict(tel)
    out.update({
        "group_gsq_last": gsq,
        "group_gsq_sum": tel["group_gsq_sum"] + gsq,
        "group_usq_last": usq,
        "group_usq_sum": tel["group_usq_sum"] + usq,
        "group_psq_last": psq,
    })
    return out


def latch_step_bits(tel: Dict[str, Any], bits,
                    poisoned_extra=None) -> Dict[str, Any]:
    """Latch the step bitmap into the accumulator: the FIRST poisoned
    step of a window wins; clean steps never clear it and later
    poisoned steps never overwrite it.  `poisoned_extra` (optional
    device bool, e.g. ~all_finite from the update guard) latches a
    backward-origin nonfinite even when every op output was finite —
    with zero bits, which the host join reports as backward/autodiff."""
    poisoned = torch.any(bits != 0)
    if poisoned_extra is not None:
        poisoned = poisoned | poisoned_extra
    latched = tel[NONFINITE_LATCH] > 0
    out = dict(tel)
    # when not yet latched the stored words are all-zero, so taking
    # `bits` unconditionally on the not-latched branch is exact for
    # clean steps too (bits == 0 == stored)
    out[NONFINITE_WORDS] = torch.where(latched, tel[NONFINITE_WORDS], bits)
    out[NONFINITE_LATCH] = (latched | poisoned).to(torch.int32)
    return out


# ---------------------------------------------------------------------------
# Host-side joins (the periodic fetch / reports)
# ---------------------------------------------------------------------------

def join_first_nonfinite(words, program=None) -> Optional[Dict[str, Any]]:
    """Join a latched bitmap back to the fluid op: lowest set bit ->
    {op_index, op_type, group, outputs}.  With no program the index
    stands alone; with zero bits (backward-origin latch) the origin is
    named explicitly."""
    arr = np.asarray(words)
    idx = None
    for w in range(arr.shape[0]):
        word = int(arr[w])
        if word:
            idx = w * 32 + ((word & -word).bit_length() - 1)
            break
    if idx is None:
        return {"op_index": None, "op_type": "backward/autodiff",
                "group": None,
                "note": "all op outputs finite; nonfinite arose in "
                        "the gradient computation"}
    info: Dict[str, Any] = {"op_index": idx}
    if program is not None:
        ops = program.global_block().ops
        if idx < len(ops):
            desc = ops[idx].desc
            outs = desc.output_names()
            info["op_type"] = desc.type
            info["outputs"] = outs[:4]
            info["group"] = (GROUP_NAMES[group_of(outs[0])] if outs
                             else None)
    return info


def summarize_groups(host: Dict[str, Any]) -> Dict[str, Dict[str, float]]:
    """Per-group window summary from fetched (host) accumulator
    fields.  Groups with no parameters (all-zero everywhere) are
    omitted; `grad_norm_rms`/`update_ratio_rms` are RMS-over-steps of
    the per-step norms (sqrt of the mean squared norm)."""
    n = max(int(host.get("steps", 0)), 1)
    gsql = np.asarray(host["group_gsq_last"], np.float64)
    gsqs = np.asarray(host["group_gsq_sum"], np.float64)
    usql = np.asarray(host["group_usq_last"], np.float64)
    usqs = np.asarray(host["group_usq_sum"], np.float64)
    psql = np.asarray(host["group_psq_last"], np.float64)
    out: Dict[str, Dict[str, float]] = {}
    for i, gname in enumerate(GROUP_NAMES):
        if not (gsql[i] or gsqs[i] or usql[i] or usqs[i] or psql[i]):
            continue  # no parameters in this group
        pn = float(np.sqrt(psql[i]))
        un = float(np.sqrt(usql[i]))
        out[gname] = {
            "grad_norm_last": float(np.sqrt(gsql[i])),
            "grad_norm_rms": float(np.sqrt(gsqs[i] / n)),
            "param_norm": pn,
            "update_norm_last": un,
            "update_ratio": (un / pn) if pn > 0 else 0.0,
            "update_ratio_rms": (float(np.sqrt(usqs[i] / n)) / pn)
            if pn > 0 else 0.0,
        }
    return out


def worst_update_ratio(groups: Optional[Dict[str, Dict[str, float]]]):
    """(group_name, ratio) with the LARGEST update ratio (explosion
    attribution), or (None, None) when no groups reported."""
    if not groups:
        return None, None
    name = max(groups, key=lambda g: groups[g]["update_ratio"])
    return name, groups[name]["update_ratio"]


# update ratio below this while |w| > 0 flags a group as dead (no
# optimizer movement at all — e.g. a detached layer or a zero lr)
DEAD_RATIO = 1e-10


def numerics_report(tel) -> Dict[str, Any]:
    """Structured numerics health report from one fetched
    StepTelemetry window: per-group dynamics, dead-layer flags,
    explosion attribution, and the first-nonfinite provenance."""
    groups = getattr(tel, "groups", None) or {}
    dead = sorted(g for g, s in groups.items()
                  if s["param_norm"] > 0
                  and s["update_ratio"] < DEAD_RATIO)
    wname, wratio = worst_update_ratio(groups)
    return {
        "steps": tel.steps,
        "healthy": tel.healthy,
        "groups": groups,
        "dead_groups": dead,
        "worst_update_ratio_group": wname,
        "worst_update_ratio": wratio,
        "first_nonfinite_op": getattr(tel, "first_nonfinite_op", None),
        "nonfinite_grad_steps": tel.nonfinite_grad_steps,
        "skipped_update_steps": tel.skipped_update_steps,
    }


def format_numerics_table(tel) -> str:
    """The report as an aligned text table (the observe pillar-6 analog
    of format_memory_table/format_cost_table)."""
    rep = numerics_report(tel)
    lines: List[str] = []
    lines.append(f"{'group':<12} {'grad_norm':>12} {'param_norm':>12} "
                 f"{'upd_ratio':>11}  flags")
    for gname in GROUP_NAMES:
        s = rep["groups"].get(gname)
        if s is None:
            continue
        flags = "DEAD" if gname in rep["dead_groups"] else ""
        if gname == rep["worst_update_ratio_group"]:
            flags = (flags + " worst").strip()
        lines.append(f"{gname:<12} {s['grad_norm_last']:>12.4e} "
                     f"{s['param_norm']:>12.4e} "
                     f"{s['update_ratio']:>11.3e}  {flags}")
    fno = rep["first_nonfinite_op"]
    if fno is not None:
        where = (f"op {fno.get('op_index')} "
                 f"{fno.get('op_type', '?')!r}"
                 + (f" (group {fno['group']})" if fno.get("group")
                    else ""))
        lines.append(f"first nonfinite: {where}")
    lines.append(f"steps={rep['steps']} healthy={rep['healthy']} "
                 f"nonfinite_grad_steps={rep['nonfinite_grad_steps']} "
                 f"skipped_update_steps={rep['skipped_update_steps']}")
    return "\n".join(lines)
