"""`Session`: the staged front-end of the port.

The counterpart of ``repro.api.session``, for an arch config's LLM
phases and for frontend (HPC) workloads::

    from repro_torch.api import Session

    plan = (Session("granite-3-8b")                 # device="cuda"
            .trace("prefill", batch=1, seq=1024)    # -> TracedGraph
            .analyze()                              # -> AnalyzedGraph
            .codesign()                             # -> CoDesigned
            .lower())                               # -> CompiledPlan
    bundle = plan.serve()                           # prefill / decode

    plan = (Session()
            .trace(workload="cg", n=4096, iters=64)
            .analyze().codesign().lower())
    out = plan.run()                                # on the Hopper kernels

A session runs on one torch device.  ``device=None`` means ``"cuda"``, and
a session without CUDA raises instead of running elsewhere; pass
``device="cpu"`` to run on the CPU, where every kernel takes its plain
torch version.  ``lower()`` of a frontend trace defaults to the ``cuda``
backend (the JAX package's ``lower()`` defaults to ``reference``).

``codesign`` results are kept in a disk cache (``api.cache``), keyed by
(arch or workload, phase, shape, hardware model, capacity, strategy, search
knobs, graph fingerprint, shard count when > 1): a repeated search is
replayed from it, bit-identical.  ``Session(use_cache=False)`` or
``CodesignConfig(use_cache=False)`` turns it off, ``cache_dir`` moves it.
"""
from __future__ import annotations

import re
import threading
import time
from contextlib import contextmanager
from typing import Optional, Union

import torch

from .. import obs
from ..configs import get_config, list_archs
from ..configs.base import ArchConfig
from ..core.costmodel import HardwareModel, V5E
from ..core.graph import OpGraph
from ..core.lowering import (decode_graph, layer_graph, partition_plan,
                             plan_execution, select_group_kernels)
from ..core.policy import CelloPlan
from ..core.policy import default_plan as _default_plan
from ..core.policy import lower_codesign
from ..core.reuse import analyze as _analyze
from ..core.schedule import sparse_operand_groups
from ..core.search import DEFAULT_SPLITS, get_strategy, run_codesign
from .artifacts import AnalyzedGraph, CoDesigned, CompiledPlan, TracedGraph
from .cache import (CodesignCache, algo_fingerprint, cache_disabled_by_env,
                    frontend_fingerprint, graph_fingerprint, hw_fingerprint,
                    strategy_fingerprint)
from .config import CodesignConfig, ExecConfig

DEFAULT_BACKEND = "cuda"
PHASES = ("train", "prefill", "decode")

# observability: per-stage wall-clock always lands in the port's registry;
# spans additionally record when the tracer is enabled (CELLO_OBS)
_STAGE_S = obs.registry().histogram(
    "session.stage_s", "wall-clock per pipeline stage "
    "(trace | analyze | codesign | lower)", unit="s")
_STAGE_RUNS = obs.registry().counter(
    "session.stage_runs", "pipeline stage executions")


@contextmanager
def _stage(stage: str, **meta):
    """One pipeline-stage measurement: a span (tracing on) + a labeled
    duration histogram (always)."""
    t0 = time.perf_counter()
    with obs.span(f"session.{stage}", **meta) as sp:
        yield sp
    _STAGE_S.observe(time.perf_counter() - t0, stage=stage)
    _STAGE_RUNS.inc(stage=stage)

# paper-table default shapes per phase (override per trace() call)
_PHASE_DEFAULTS = {
    "train": dict(batch=4, seq=4096),
    "prefill": dict(batch=1, seq=32768),
    "decode": dict(batch=128, kv_len=32768),
}


def resolve_device(device=None) -> str:
    """``None`` → ``"cuda"``; a CUDA device without CUDA raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: the port runs on an NVIDIA GPU by "
            "default; pass device='cpu' to run the plain kernel versions "
            "on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return str(dev)


def _resolve_arch(arch: Union[str, ArchConfig, None]) -> Optional[ArchConfig]:
    if arch is None or arch == "hpc":
        # arch-less session: only frontend traces (trace(workload=...) /
        # Session.from_graph) are available
        return None
    if isinstance(arch, ArchConfig):
        return arch
    try:
        return get_config(arch)
    except KeyError:
        # accept python-identifier spellings (gemma_7b == gemma-7b), incl.
        # dotted registry names (llama_3_2_vision_11b == llama-3.2-vision-11b)
        def squash(s: str) -> str:
            return re.sub(r"[^a-z0-9]", "", s.lower())
        matches = [n for n in list_archs() if squash(n) == squash(arch)]
        if len(matches) != 1:
            raise
        return get_config(matches[0])


def _check_config(config, cls, where: str):
    if config is None:
        return cls()
    if not isinstance(config, cls):
        raise TypeError(f"{where}: config= takes a {cls.__name__}, got "
                        f"{type(config).__name__}")
    return config


class Session:
    """Staged compilation session for one (arch, hardware model, device)."""

    def __init__(self, arch: Union[str, ArchConfig, None] = None, *,
                 device=None, hw: HardwareModel = V5E,
                 capacity_bytes: Optional[int] = None,
                 use_cache: bool = True, cache_dir=None):
        self.cfg = _resolve_arch(arch)
        self.device = resolve_device(device)
        self.hw = hw
        self.capacity_bytes = capacity_bytes or hw.vmem_bytes
        # env kill-switch is checked per codesign() call, not frozen here
        self.use_cache = use_cache
        self.cache = CodesignCache(cache_dir)
        # trace memoization is thread-safe: the lock spans
        # lookup+build+insert, so one (workload, params) cell is built once
        self._trace_memo = {}
        self._trace_lock = threading.Lock()

    # -- stage 1: trace -------------------------------------------------
    def trace(self, phase: Optional[str] = None, *,
              batch: Optional[int] = None,
              seq: Optional[int] = None, kv_len: Optional[int] = None,
              layer_kind: Optional[str] = None,
              workload: Optional[str] = None,
              **workload_params) -> TracedGraph:
        """The analysis-level op DAG for one phase of this arch — or, with
        ``workload=``, of a registered HPC workload::

            Session("granite-3-8b").trace("prefill", batch=1, seq=1024)
            Session().trace(workload="cg", n=4096, iters=4)

        HPC traces carry ``phase="hpc"`` and need no arch config; extra
        keyword arguments go to the workload builder
        (``repro_torch.frontends.hpc``).  Traces are memoized per (phase,
        shape) or (workload, params).
        """
        with _stage("trace", arch=self.cfg.name if self.cfg else None,
                    phase=phase, workload=workload):
            return self._trace(phase, batch=batch, seq=seq, kv_len=kv_len,
                               layer_kind=layer_kind, workload=workload,
                               **workload_params)

    def _trace(self, phase, *, batch, seq, kv_len, layer_kind, workload,
               **workload_params) -> TracedGraph:
        if workload is not None:
            if any(v is not None for v in (batch, seq, kv_len, layer_kind)):
                raise ValueError("workload= traces take workload builder "
                                 "params, not batch/seq/kv_len/layer_kind")
            if phase is not None:
                raise ValueError("workload= traces have phase='hpc'; do "
                                 f"not combine workload with "
                                 f"phase={phase!r}")
            return self._trace_workload(workload, workload_params)
        phase = "train" if phase is None else phase
        if workload_params:
            raise TypeError(f"unexpected trace() kwargs "
                            f"{sorted(workload_params)} (workload builder "
                            "params need workload=)")
        if self.cfg is None:
            raise ValueError("this Session has no arch config; pass arch= "
                             "to Session() or trace a frontend workload "
                             "via trace(workload=...)")
        if phase not in PHASES:
            raise ValueError(f"phase {phase!r} not in {PHASES}")
        if phase == "decode" and self.cfg.encoder_only:
            raise ValueError(f"{self.cfg.name} is encoder-only: no decode")
        defaults = _PHASE_DEFAULTS[phase]
        batch = batch if batch is not None else defaults["batch"]
        if phase == "decode":
            if seq is not None:
                raise ValueError("decode traces take kv_len=, not seq=")
            if layer_kind is not None:
                raise ValueError("decode traces pick their layer kind from "
                                 "the arch; layer_kind= is train/prefill-only")
            kv_len = kv_len if kv_len is not None else defaults["kv_len"]
        else:
            if kv_len is not None:
                raise ValueError(f"{phase} traces take seq=, not kv_len=")
            seq = seq if seq is not None else defaults["seq"]
        memo_key = (phase, batch, seq, kv_len, layer_kind)
        with self._trace_lock:
            hit = self._trace_memo.get(memo_key)
            if hit is not None:
                return hit
            if phase == "decode":
                graph = decode_graph(self.cfg, batch, kv_len)
            else:
                graph = layer_graph(self.cfg, batch, seq,
                                    layer_kind=layer_kind)
            traced = TracedGraph(arch=self.cfg.name, phase=phase,
                                 batch=batch, seq=seq, kv_len=kv_len,
                                 layer_kind=layer_kind, graph=graph,
                                 session=self)
            self._trace_memo[memo_key] = traced
            return traced

    def _trace_workload(self, workload: str, params: dict) -> TracedGraph:
        from ..frontends.hpc import build_workload
        wl_params = tuple(sorted(params.items()))
        memo_key = ("hpc", workload, wl_params)
        with self._trace_lock:
            hit = self._trace_memo.get(memo_key)
            if hit is not None:
                return hit
            program = build_workload(workload, **params)
            traced = TracedGraph(arch=f"hpc:{workload}", phase="hpc",
                                 batch=1, seq=None, kv_len=None,
                                 layer_kind=None, graph=program.to_graph(),
                                 session=self, program=program,
                                 workload=workload, wl_params=wl_params)
            self._trace_memo[memo_key] = traced
            return traced

    @classmethod
    def from_graph(cls, obj, *, device=None, hw: HardwareModel = V5E,
                   capacity_bytes: Optional[int] = None,
                   use_cache: bool = True, cache_dir=None) -> TracedGraph:
        """Wrap a frontend ``Program`` / ``Expr`` or a raw ``OpGraph`` as a
        TracedGraph on a fresh session.  An ``Expr`` is marked as its
        program's output when none is set; a raw ``OpGraph`` lowers to a
        plan but cannot ``run()``."""
        from ..frontends.expr import Expr, Program
        if isinstance(obj, TracedGraph):
            return obj
        sess = cls(device=device, hw=hw, capacity_bytes=capacity_bytes,
                   use_cache=use_cache, cache_dir=cache_dir)
        if isinstance(obj, Expr):
            if not obj.program.outputs:
                obj.program.output(obj)
            obj = obj.program
        if isinstance(obj, Program):
            return TracedGraph(arch=f"hpc:{obj.name}", phase="hpc", batch=1,
                               seq=None, kv_len=None, layer_kind=None,
                               graph=obj.to_graph(), session=sess,
                               program=obj)
        if isinstance(obj, OpGraph):
            obj.validate()
            return TracedGraph(arch=f"graph:{obj.name}", phase="hpc",
                               batch=1, seq=None, kv_len=None,
                               layer_kind=None, graph=obj, session=sess)
        raise TypeError(f"from_graph takes a Program, Expr, OpGraph or "
                        f"TracedGraph, got {type(obj).__name__}")

    # -- stage 2: analyze -----------------------------------------------
    def analyze(self, traced: TracedGraph) -> AnalyzedGraph:
        """Reuse-distance/frequency analysis over the natural order."""
        with _stage("analyze", arch=traced.arch, phase=traced.phase):
            return AnalyzedGraph(trace=traced,
                                 analysis=_analyze(traced.graph))

    # -- stage 3: codesign ----------------------------------------------
    def codesign(self, staged: Union[TracedGraph, AnalyzedGraph],
                 config: Optional[CodesignConfig] = None) -> CoDesigned:
        """The joint schedule × buffer search (disk-cached)."""
        cfg = _check_config(config, CodesignConfig, "Session.codesign")
        traced = staged if isinstance(staged, TracedGraph) else staged.trace
        with _stage("codesign", arch=traced.arch, phase=traced.phase) as sp:
            return self._codesign(
                traced, sp,
                natural_analysis=(staged.analysis
                                  if isinstance(staged, AnalyzedGraph)
                                  else None),
                strategy=cfg.strategy, capacity_bytes=cfg.capacity_bytes,
                max_orders=cfg.max_orders, splits=cfg.splits,
                overbook=cfg.overbook, use_cache=cfg.use_cache)

    def _codesign(self, traced: TracedGraph, sp, *, natural_analysis,
                  strategy, capacity_bytes, max_orders, splits, overbook,
                  use_cache, shards: int = 1) -> CoDesigned:
        splits = list(splits)    # one-shot iterables: key + search see same
        capacity = capacity_bytes or self.capacity_bytes
        strategy_obj = get_strategy(strategy)
        strategy_name = strategy_obj.name
        sp.annotate(strategy=strategy_name)
        cached = self.use_cache if use_cache is None else use_cache
        if cache_disabled_by_env():     # env kill-switch beats per-call opts
            cached = False
        if cached:
            # the key tracks the strategy's own code + instance state, not
            # just its name; None = no stable identity: don't cache
            strategy_src = strategy_fingerprint(strategy_obj)
            if strategy_src is None:
                cached = False
        key = None
        if cached:
            # shards only enters the key when > 1, so a mesh plan's search
            # and an unsharded one never alias
            shard_key = {"shards": shards} if shards > 1 else {}
            key = self.cache.key(
                **shard_key,
                # any edit to the search/sim/cost code invalidates entries
                algo=algo_fingerprint(),
                arch=traced.arch, phase=traced.phase, batch=traced.batch,
                seq=traced.seq, kv_len=traced.kv_len,
                layer_kind=traced.layer_kind, hw=hw_fingerprint(self.hw),
                capacity=capacity, strategy=strategy_name,
                strategy_src=strategy_src, max_orders=max_orders,
                splits=list(splits), overbook=overbook,
                graph=graph_fingerprint(traced.graph),
                # frontend-built graphs fold in the expression DAG + the
                # frontend lowering code (None for registry traces)
                frontend=frontend_fingerprint(traced.program))
            hit = self.cache.get(key)
            if hit is not None:
                sp.annotate(cache="hit")
                return CoDesigned(trace=traced, result=hit,
                                  strategy=strategy_name,
                                  capacity_bytes=capacity, from_cache=True)
        sp.annotate(cache="miss" if cached else "off")
        # the resolved object, so the strategy the key checks is the one
        # the search runs
        result = run_codesign(traced.graph, capacity_bytes=capacity,
                              hw=self.hw, max_orders=max_orders,
                              strategy=strategy_obj, splits=splits,
                              overbook=overbook,
                              natural_analysis=natural_analysis)
        if cached:
            self.cache.put(key, result)
        return CoDesigned(trace=traced, result=result,
                          strategy=strategy_name, capacity_bytes=capacity,
                          from_cache=False)

    # -- stage 4: lower --------------------------------------------------
    def lower(self, designed: CoDesigned,
              config: Optional[ExecConfig] = None, *,
              seq: Optional[int] = None,
              backend: Optional[str] = None, mesh=None) -> CompiledPlan:
        """Turn the co-design decision into an executable plan.

        An LLM trace lowers through ``core.policy.lower_codesign`` to a
        plan that serves (``seq`` sizes its blocks; it defaults to the
        traced shape).  A frontend trace lowers to a plan that runs:
        ``backend`` picks the default backend of ``plan.run()``, ``"cuda"``
        (the default) or ``"reference"``.

        ``mesh`` (frontend plans only) partitions the co-designed DAG into
        K row blocks over the device slots of a solver mesh
        (``launch.mesh``): the shard count ``K`` or an ``(axis, K)`` pair.
        For K > 1 the schedule × buffer search runs again at the mesh's
        aggregate capacity ``K·C`` (each shard pins or streams its own row
        block), and the plan runs on the mesh: ``ShardedProgram`` on the
        ``cuda`` backend, ``ShardedReference`` on ``reference``
        (``exec.sharded``).  An :class:`ExecConfig` carries both knobs.
        """
        if config is not None:
            if backend is not None or mesh is not None:
                raise TypeError("Session.lower: pass either config= or "
                                "backend=/mesh=, not both")
            config = _check_config(config, ExecConfig, "Session.lower")
            backend, mesh = config.backend, config.mesh
        backend = backend if backend is not None else DEFAULT_BACKEND
        traced = designed.trace
        with _stage("lower", arch=traced.arch, phase=traced.phase,
                    backend=backend):
            return self._lower(designed, traced, seq, backend, mesh)

    def _lower(self, designed: CoDesigned, traced: TracedGraph,
               seq: Optional[int], backend: str, mesh) -> CompiledPlan:
        if traced.phase != "hpc":
            if mesh is not None:
                raise ValueError("mesh= partitioning applies to frontend "
                                 "(HPC) plans; LLM plans serve on one "
                                 "device")
            if seq is None:
                seq = traced.seq if traced.seq is not None else \
                    (traced.kv_len or 4096)
            plan = lower_codesign(self.cfg, designed.result, seq=seq,
                                  hw=self.hw)
            return CompiledPlan(plan=plan, cfg=self.cfg, trace=traced,
                                codesigned=designed, backend=backend)
        if seq is not None:
            raise ValueError("frontend (HPC) plans take no seq=: block "
                             "sizing comes from the expression shapes")
        axis, n_shards = ("shards", 1) if mesh is None else \
            (("shards", mesh) if isinstance(mesh, int)
             else (mesh[0], int(mesh[1])))
        if n_shards > 1:
            # co-design the global graph against the mesh's aggregate
            # buffer capacity K·C: each shard holds a 1/K row block, so a
            # pin that fits K·C globally fits C per shard (TABLE 11's
            # crossover)
            with _stage("codesign", arch=traced.arch, phase=traced.phase,
                        shards=n_shards) as sp:
                designed = self._codesign(
                    traced, sp, natural_analysis=None,
                    strategy=designed.strategy,
                    capacity_bytes=designed.capacity_bytes * n_shards,
                    max_orders=16, splits=DEFAULT_SPLITS,
                    overbook=getattr(designed.result, "overbook", 0.0),
                    use_cache=None, shards=n_shards)
        sched = designed.result.best.schedule
        partial = dict(getattr(sched.pins, "partial", None) or {})
        kernels = select_group_kernels(traced.graph, sched.groups,
                                       sched.config.explicit_bytes,
                                       partial=partial)
        sparse_note = ""
        sparse_grps = sparse_operand_groups(traced.graph)
        if sparse_grps:
            prefix = sum(any(m in partial for m in g) for g in sparse_grps)
            pinned = sum(all(m in sched.pins for m in g)
                         and not any(m in partial for m in g)
                         for g in sparse_grps)
            sparse_note = (f" sparse-operands={len(sparse_grps)} "
                           f"pinned-by-nnz-footprint={pinned}")
            if prefix:
                sparse_note += f" prefix-pinned={prefix}"
        exec_plan = plan_execution(traced.graph, kernels,
                                   sched.config.explicit_bytes,
                                   program=traced.program, partial=partial)
        sharded = None
        if mesh is not None:
            # K=1 still goes through partition_plan, so the degenerate
            # mesh validates as a real one does; the executors take the
            # sharded route only for n_shards > 1
            sharded = partition_plan(exec_plan, (axis, n_shards),
                                     program=traced.program)
            sparse_note += f" mesh={axis}:{n_shards}"
        plan = CelloPlan(
            arch=traced.arch,
            use_flash_attention=False, q_block=0, kv_block=0,
            use_fused_mlp=False, mlp_block_m=0, mlp_block_f=0,
            use_fused_rmsnorm=False, remat_save_names=(),
            explicit_frac=sched.config.explicit_frac,
            notes=(f"frontend graph: groups={len(sched.groups)} "
                   f"pins={len(sched.pins)} "
                   f"speedup={designed.result.speedup():.2f}x"
                   + sparse_note))
        return CompiledPlan(plan=plan, trace=traced, codesigned=designed,
                            backend=backend, group_kernels=kernels,
                            exec_plan=exec_plan, sharded=sharded)

    # -- fast path (no search) -------------------------------------------
    def default_plan(self, *, seq: int = 4096) -> CompiledPlan:
        """Paper-faithful default plan without running the search."""
        if self.cfg is None:
            raise ValueError("default_plan needs an arch config; frontend "
                             "workloads always go through codesign()")
        plan = _default_plan(self.cfg, seq=seq, hw=self.hw)
        return CompiledPlan(plan=plan, cfg=self.cfg, session=self)

    # -- one-shot convenience --------------------------------------------
    def compile(self, phase: str = "train", *,
                lower_seq: Optional[int] = None,
                **trace_kwargs) -> CompiledPlan:
        """trace → analyze → codesign → lower in one call.

        ``trace_kwargs`` (batch/seq/kv_len/layer_kind) go to :meth:`trace`;
        ``lower_seq`` overrides the block-sizing seq used by :meth:`lower`
        (defaults to the traced shape).
        """
        traced = self.trace(phase, **trace_kwargs)
        return self.lower(self.codesign(traced), seq=lower_seq)

    def __repr__(self) -> str:
        on = self.use_cache and not cache_disabled_by_env()
        name = self.cfg.name if self.cfg is not None else "<frontend>"
        return (f"Session({name!r}, device={self.device!r}, "
                f"hw={self.hw.name!r}, "
                f"capacity={self.capacity_bytes // 1024 // 1024} MiB, "
                f"cache={'on' if on else 'off'})")
