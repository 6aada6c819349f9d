"""Parameter/activation sharding rules: the port of
paddle_tpu/parallel/strategies.py, pure Python, kept line for line.

Replaces the reference's BuildStrategy reduce modes + DistributeTranspiler
param slicing (build_strategy.h:55, distribute_transpiler.py:80 — params
sliced into blocks round-robin over pservers).  A rule maps var-name
patterns to specs: a tuple of mesh-axis names (or None) per tensor dim.
The port's data-parallel step (parallel/data_parallel.py) reads them:
the feeds' dim 0 over the data axes, optimizer state (and, under
`default="fsdp"`, parameters) sliced over the ZeRO axis.  `mesh` is a
`parallel.mesh.Mesh`, whose `.shape` is the ordered {axis: size} dict.
"""

from __future__ import annotations

import re
from typing import Optional, Sequence, Tuple


class GradSyncConfig:
    """Opt-in gradient-synchronization mode for data parallelism
    (EQuARX, arxiv 2506.17615).

    mode:
      - "bf16": the explicit exchange with exact all-reduces — the
        control arm: the same code path, communication and RNG layout
        as "int8" with quantization off, so A/Bs isolate quantization
        error from everything else.
      - "int8": the blockwise-int8 two-phase exchange
        (collectives.quantized_all_reduce_local) — ~2x fewer gradient
        bytes per phase.  Dense grads only; SparseGrad stays sparse
        (ids+rows all_gather, O(touched)); tensors below
        `min_quant_numel` ride the exact all-reduce.
    Under either mode every rank differentiates its own batch shard's
    loss (batch_norm statistics stay local), as in the reference's
    shard_map.  The default (no GradSyncConfig) computes the
    global-batch program instead (parallel/data_parallel.py).  Params
    sharded over a DATA axis (ZeRO-3) raise under an explicit mode, as
    in the reference."""

    MODES = ("bf16", "int8")

    def __init__(self, mode: str = "int8", block_size: int = 256,
                 min_quant_numel: int = 4096):
        if mode not in self.MODES:
            raise ValueError(
                f"grad_sync mode {mode!r} not in {self.MODES}")
        self.mode = mode
        self.block_size = int(block_size)
        self.min_quant_numel = int(min_quant_numel)

    @classmethod
    def normalize(cls, value) -> Optional["GradSyncConfig"]:
        """None | mode-string | GradSyncConfig -> GradSyncConfig|None
        (the BuildStrategy.grad_sync coercion)."""
        if value is None:
            return None
        if isinstance(value, cls):
            return value
        return cls(mode=str(value))

    def __repr__(self):
        return (f"GradSyncConfig(mode={self.mode!r}, "
                f"block_size={self.block_size}, "
                f"min_quant_numel={self.min_quant_numel})")


class ShardingRules:
    """Ordered (regex, spec) rules; first match wins.

    spec is a tuple of mesh-axis names (or None) per tensor dim, e.g.
    (None, "mp") shards dim 1 over the "mp" axis.  `default` applies to
    unmatched params (None = replicated; "fsdp" = shard dim 0 over the
    given axis when divisible).

    zero_axis (ISSUE 13, ZeRO-style hybrid parallelism): the mesh axis
    OPTIMIZER STATE shards over, composed on top of whatever spec the
    rules produce (`opt_state_spec_for`) — per-device opt-state bytes
    drop ~1/N while params stay wherever their own rules put them
    (replicated for pure dp/fsdp, mp-sharded under Megatron rules).
    Inert on meshes without the axis, so the default ("fsdp") makes
    `make_mesh({"dp": ..., "fsdp": ...})` — or a pure {"fsdp": N}
    mesh — ZeRO-1 without any rule changes.  The axis is a DATA axis:
    the batch additionally shards over it (`data_axes_for`), so fsdp=N
    behaves like dp=N plus 1/N opt state.
    """

    def __init__(self, rules: Optional[Sequence[Tuple[str, tuple]]] = None,
                 default: Optional[str] = None,
                 fsdp_axis: str = "dp",
                 zero_axis: Optional[str] = "fsdp"):
        self.rules = [(re.compile(p), spec) for p, spec in (rules or [])]
        self.default = default
        self.fsdp_axis = fsdp_axis
        self.zero_axis = zero_axis

    def spec_for(self, name: str, shape, mesh) -> tuple:
        for pat, spec in self.rules:
            if pat.search(name):
                return self._validate(spec, shape, mesh)
        if self.default == "fsdp":
            ax_size = mesh.shape[self.fsdp_axis]
            for dim, d in enumerate(shape):
                if d % ax_size == 0 and d >= ax_size:
                    spec = [None] * len(shape)
                    spec[dim] = self.fsdp_axis
                    return tuple(spec)
        return (None,) * len(shape)

    def data_axes_for(self, mesh, batch_axis: str = "dp") -> tuple:
        """The mesh axes that carry DATA parallelism: the batch axis
        plus the ZeRO axis when present (fsdp is dp with sharded
        optimizer state — the batch shards over both).  Order is the
        mesh's axis order so rank linearization is deterministic."""
        wanted = {batch_axis}
        if self.zero_axis is not None:
            wanted.add(self.zero_axis)
        return tuple(a for a in mesh.shape
                     if a in wanted and mesh.shape[a] > 1)

    def opt_state_spec_for(self, name: str, shape, mesh) -> tuple:
        """PartitionSpec dims for an OPTIMIZER-STATE var (moments,
        velocities, …): the rule-derived spec with `zero_axis` composed
        onto the first unsharded divisible dim (ZeRO-1).  Accumulators
        named `<param>.<acc>` match their param's rule, so an
        mp-sharded param's moments stay mp-sharded AND additionally
        shard over the zero axis when a dim allows it."""
        spec = list(self.spec_for(name, shape, mesh))
        za = self.zero_axis
        if za is None or mesh.shape.get(za, 1) <= 1:
            return tuple(spec)
        n = mesh.shape[za]
        for dim, (d, ax) in enumerate(zip(shape, spec)):
            if ax is None and d >= n and d % n == 0:
                spec[dim] = za
                break
        return tuple(spec)

    def feed_spec_for(self, name: str, shape, mesh,
                      batch_axis: str = "dp") -> tuple:
        """PartitionSpec dims for a FEED (the data axes of the mesh):
        dim 0 shards over `batch_axis` — plus the ZeRO/fsdp axis when
        the mesh has one (data_axes_for) — when the batch divides the
        combined degree.  GSPMD then partitions the whole forward by
        batch and inserts the gradient all-reduce implicitly (the
        ParallelExecutor AllReduce mode).  An explicit rule matching
        the feed name wins, so ragged companions or non-batch-major
        feeds can override the data-axis default.  Non-divisible (or
        scalar) feeds replicate — a final partial batch stays correct,
        it just loses the dp speedup for that one step."""
        for pat, spec in self.rules:
            if pat.search(name):
                return self._validate(spec, shape, mesh)
        axes = self.data_axes_for(mesh, batch_axis)
        n = 1
        for a in axes:
            n *= mesh.shape[a]
        if (n > 1 and len(shape) >= 1 and shape[0] > 0
                and shape[0] % n == 0):
            first = axes[0] if len(axes) == 1 else tuple(axes)
            return (first,) + (None,) * (len(shape) - 1)
        # the combined degree does not divide: fall back to the batch
        # axis alone (the dp speedup survives an fsdp-indivisible batch)
        dp = mesh.shape.get(batch_axis, 1)
        if (dp > 1 and n != dp and len(shape) >= 1 and shape[0] > 0
                and shape[0] % dp == 0):
            return (batch_axis,) + (None,) * (len(shape) - 1)
        return (None,) * len(shape)

    @staticmethod
    def _validate(spec, shape, mesh) -> tuple:
        spec = tuple(spec) + (None,) * (len(shape) - len(spec))
        out = []
        for d, ax in zip(shape, spec):
            if ax is None:
                out.append(None)
            else:
                # an axis the mesh doesn't have degrades to replicated
                # (one rule set serves dp, dp x mp and dp x mp x ep
                # meshes)
                size = mesh.shape.get(ax, 1)
                out.append(ax if size > 1 and d % size == 0 else None)
        return tuple(out)


# Ready-made rule set for the transformer/bert models in models/:
# embedding tables sharded over "mp" on the vocab dim, and the classic
# Megatron column/row pairing keyed by layer names
# (models/transformer.py): attn_qkv + ffn_in weights column-parallel
# (output dim over mp, activations stay head/hidden-sharded), attn_out +
# ffn_out row-parallel (input dim over mp) — GSPMD then inserts exactly
# one all-reduce per attention block and one per MLP block, matching
# Megatron-LM's layout instead of the column-everywhere fallback.
def megatron_transformer_rules(fsdp: bool = False,
                               moe_axis: str = "mp") -> ShardingRules:
    """moe_axis: mesh axis the expert (E) dim of MoE weights shards
    over.  "mp" (default) reuses the tensor-parallel axis — fine when
    ep and tp don't need to compose.  "ep" gives experts their OWN axis
    on a dp x mp x ep mesh (the GShard formulation): the E dim shards
    over ep AND each expert's FFN matrices shard over mp on the hidden
    dim, so expert parallelism and tensor parallelism compose
    multiplicatively.  Axes absent from the executing mesh degrade to
    replicated (see _validate), so one rule set serves every mesh."""
    if moe_axis == "mp":
        moe_rules = [
            # expert parallelism riding the tensor-parallel axis: the E
            # axis of per-expert MoE weights shards over mp (GShard
            # dispatch/combine all-to-alls are GSPMD-inserted); the
            # router gate stays replicated
            (r"moe_expert\S*\.w", ("mp", None, None)),
            (r"moe_expert\S*\.b", ("mp", None)),
        ]
    else:
        moe_rules = [
            # dedicated expert axis composing with tensor parallelism:
            # w1 (E, D, H) -> (ep, -, mp); w2 (E, H, D) -> (ep, mp, -)
            (r"moe_expert\S*\.w_0", (moe_axis, None, "mp")),
            (r"moe_expert\S*\.w_1", (moe_axis, "mp", None)),
            (r"moe_expert\S*\.w", (moe_axis, None, None)),
            (r"moe_expert\S*\.b", (moe_axis, None)),
        ]
    return ShardingRules(
        rules=[
            (r"(word_emb|src_word_emb|trg_word_emb|word_embedding|fm_emb)",
             ("mp", None)),
            (r"(attn_qkv|ffn_in)\S*\.w", (None, "mp")),
            (r"(attn_out|ffn_out)\S*\.w", ("mp", None)),
            *moe_rules,
            # any remaining fc (e.g. the softmax projection): column
            (r"fc_\d+\.w_\d+", (None, "mp")),
        ],
        default="fsdp" if fsdp else None,
    )
