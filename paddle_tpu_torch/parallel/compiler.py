"""CompiledProgram: a Program run data-parallel over a mesh.

The port of paddle_tpu/parallel/compiler.py (reference:
python/paddle/fluid/compiler.py:33 CompiledProgram.with_data_parallel,
wrapping ParallelExecutor, parallel_executor.cc:191).  The reference
jits one program with NamedShardings and lets GSPMD partition it; the
port runs one process per rank, each interpreting the program on its
dim-0 slice of the feeds, with explicit collectives between the ranks
(parallel/data_parallel.py): the default mode computes the global-batch
program's results, `BuildStrategy.grad_sync` ("bf16"/"int8") the
reference's explicit per-rank exchange.  Optimizer state on a ZeRO axis
(`fsdp`), and every state var under `ReduceStrategy.Reduce`, is held
sliced over the mesh.

The model axes run on the same runner: `mp` as Megatron tensor
parallelism (parallel/tensor_parallel.py, the rules' specs), `sp` in
the flash op's ring/Ulysses route (parallel/ring_attention.py), `pp`
as the GPipe schedule of pipeline_scope groups (parallel/
pipeline_engine.py, `BuildStrategy.pipeline_microbatches`), `ep` in
moe_ffn's grouped routing and all-to-alls (ops/moe.py); pp x mp is the
reference's designed PipelineStructureError.
`compiled_step` returns this rank's step record (observe/cost.py; the
reference's XLA executable, ROADMAP C21); `compiled_hlo_text` raises.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

from .mesh import executing_mesh, get_default_mesh
from .strategies import GradSyncConfig, ShardingRules

# the optimizer state the ZeRO axis shards (observe/memory.py)
from ..observe.memory import (OPTIMIZER_OP_TYPES,  # noqa: E402,F401
                              program_var_buckets)

MODEL_AXES = ("mp", "sp", "pp", "ep")


class ReduceStrategy:
    AllReduce = 0  # replicated params, grads all-reduced
    Reduce = 1     # FSDP-style: params sharded over the batch axis


class BuildStrategy:
    """reference: framework/details/build_strategy.h:55."""

    ReduceStrategy = ReduceStrategy

    def __init__(self):
        self.reduce_strategy = ReduceStrategy.AllReduce
        self.sharding_rules: Optional[ShardingRules] = None
        self.memory_optimize = False  # the caching allocator's business
        self.enable_inplace = True
        # multi-trainer topology; parallel/dist.py init_distributed
        # (reference: nccl2 mode, parallel_executor.cc:254)
        self.num_trainers = 1
        self.trainer_id = 0
        # K-micro-batch gradient accumulation (reference:
        # ir/multi_batch_merge_pass.cc)
        self.gradient_accumulation_steps = 1
        # GPipe microbatch count on a pp axis (0: 2 x pp, or pp)
        self.pipeline_microbatches = 0
        # explicit gradient synchronization (strategies.GradSyncConfig or
        # a mode string): None computes the global-batch program; "int8"
        # routes dense grads through the blockwise-quantized two-phase
        # exchange (collectives.quantized_all_reduce_local), "bf16" the
        # same explicit path without quantization
        self.grad_sync = None


class ExecutionStrategy:
    """reference: framework/details/execution_strategy.h (inert knobs
    kept for API parity)."""

    def __init__(self):
        self.num_threads = 0
        self.allow_op_delay = False
        self.num_iteration_per_drop_scope = 1


class CompiledProgram:
    def __init__(self, program):
        self._program = program
        self._mesh = None
        self._batch_axis = "dp"
        self._rules: Optional[ShardingRules] = None
        self._loss_name = None
        self._accum_steps = 1
        self._pp_microbatches = 0
        self._opt_names = None  # lazy: optimizer-state var names
        self._runner = None     # lazy: data_parallel.DataParallelRunner

    def with_data_parallel(self, loss_name: Optional[str] = None,
                           build_strategy: Optional[BuildStrategy] = None,
                           exec_strategy: Optional[ExecutionStrategy] = None,
                           share_vars_from=None, places=None,
                           mesh=None, batch_axis: str = "dp"):
        self._loss_name = loss_name
        self._mesh = mesh or get_default_mesh()
        self._batch_axis = batch_axis
        bs = build_strategy or BuildStrategy()
        self._accum_steps = int(getattr(bs, "gradient_accumulation_steps",
                                        1) or 1)
        self._pp_microbatches = int(getattr(bs, "pipeline_microbatches",
                                            0) or 0)
        if bs.sharding_rules is not None:
            self._rules = bs.sharding_rules
        elif bs.reduce_strategy == ReduceStrategy.Reduce:
            self._rules = ShardingRules(default="fsdp",
                                        fsdp_axis=batch_axis)
        else:
            self._rules = ShardingRules()
        # the explicit grad-sync mode rides the PROGRAM, as in the
        # reference (the executor reads it)
        self._program._grad_sync = GradSyncConfig.normalize(
            getattr(bs, "grad_sync", None))
        self._program._compiled_wrapper = self
        self._runner = None
        return self

    # -- shardings -------------------------------------------------------
    def _optimizer_state_names(self) -> set:
        """Names of the program's optimizer-state vars (accumulators,
        pow counters, the lr var): the set the ZeRO axis shards."""
        if self._opt_names is None:
            _params, opt = program_var_buckets(self._program)
            self._opt_names = opt
        return self._opt_names

    def state_spec_for(self, name: str, shape) -> tuple:
        """The spec this wrapper assigns to a STATE var: the rule spec,
        with the ZeRO axis composed in for optimizer-state vars.  Public
        because io.load_sharded reshards checkpoints into exactly these
        specs."""
        if name in self._optimizer_state_names():
            return self._rules.opt_state_spec_for(name, shape, self._mesh)
        return self._rules.spec_for(name, shape, self._mesh)

    def data_axes(self) -> tuple:
        """Mesh axes the batch shards over (batch axis + fsdp/ZeRO)."""
        return self._rules.data_axes_for(self._mesh, self._batch_axis)

    def _ensure_mesh(self):
        if self._mesh is None:
            # bare CompiledProgram(program): one rank, like fluid without
            # with_data_parallel
            from .mesh import make_mesh

            self._mesh = make_mesh({"dp": 1})
            if self._rules is None:
                self._rules = ShardingRules()


    # -- execution -------------------------------------------------------
    def run(self, executor, feed: Dict[str, Any], fetch_names, scope,
            return_numpy: bool = True, iterations: int = 1,
            accumulation_steps: int = 1):
        from .data_parallel import DataParallelRunner

        # an explicit per-run override wins over the BuildStrategy knob
        accum = (accumulation_steps if accumulation_steps != 1
                 else self._accum_steps)
        self._ensure_mesh()
        if not self._mesh.member:
            raise ValueError(
                f"rank outside the mesh {self._mesh.shape} ran its "
                f"CompiledProgram")
        if self._runner is None:
            self._runner = DataParallelRunner(self)
        with executing_mesh(self._mesh, batch_axis=self._batch_axis,
                            pipeline_microbatches=self._pp_microbatches):
            return executor._run_program(
                self._program, feed, fetch_names, scope, return_numpy,
                iterations, accum, dp=self._runner)

    def collective_counts(self) -> Dict[str, int]:
        """The collectives the model axes inserted in the last step, by
        kind (tensor parallelism: "all_reduce", "all_reduce_bwd",
        "all_reduce_max", "all_gather", "all_gather_bwd"); empty off
        an mp axis."""
        tp = None if self._runner is None else self._runner.tp
        return {} if tp is None else dict(tp.last_counts)

    def collective_ms(self) -> float:
        """Host milliseconds the last step spent in those collectives."""
        tp = None if self._runner is None else self._runner.tp
        return 0.0 if tp is None else tp.last_ms

    def compiled_step(self, feed=None, fetch_list=None, scope=None,
                      with_names: bool = False, exe=None):
        """This rank's step record (observe/cost.py `StepRecord`): one
        recorded run of the compiled program on copies of this rank's
        state (a DTensor's local slice stays local), the port's
        counterpart of the reference's partitioned executable (ROADMAP
        C21).  `exe`: the Executor to run it (default CUDAPlace(0)).
        with_names=True returns (record, labels)."""
        from ..core.executor import Executor, global_scope
        from ..core.program import Variable
        from ..observe.cost import record_step

        exe = exe or Executor()
        names = [f.name if isinstance(f, Variable) else str(f)
                 for f in (fetch_list or [])]
        record = record_step(
            exe, self._program, dict(feed or {}), names,
            scope if scope is not None else global_scope(),
            run=lambda e, _prog, feeds, fetch, sc: self.run(
                e, feeds, fetch, sc))
        return (record, record.labels) if with_names else record

    def compiled_hlo_text(self, *args, **kwargs):
        raise NotImplementedError(
            "CompiledProgram.compiled_hlo_text returns the reference's "
            "post-partitioning HLO; the port compiles no step and has no "
            "HLO (ROADMAP C21): compiled_step returns its step record")
