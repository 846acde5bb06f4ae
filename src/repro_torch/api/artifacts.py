"""Frozen stage artifacts of the port's staged pipeline.

The counterparts of ``repro.api.artifacts``, for LLM traces of an arch
config (``phase`` train / prefill / decode; the lowered plan serves) and
for frontend (HPC) traces (``phase="hpc"``; the lowered plan runs)::

    Session.trace()          -> TracedGraph
    TracedGraph.analyze()    -> AnalyzedGraph
    AnalyzedGraph.codesign() -> CoDesigned
    CoDesigned.lower()       -> CompiledPlan

Each keeps a reference to its session so the stages chain; all decision
state is in the artifact itself.
"""
from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Any, Dict, List, Optional, Tuple

from ..configs.base import ArchConfig
from ..core.graph import OpGraph
from ..core.lowering import ExecPlan, GroupKernel, ShardedExecPlan
from ..core.policy import CelloPlan
from ..core.reuse import ReuseAnalysis
from ..core.schedule import CoDesignResult, EvaluatedSchedule

if TYPE_CHECKING:                                      # pragma: no cover
    from ..frontends.expr import Program
    from .session import Session


@dataclasses.dataclass(frozen=True)
class TracedGraph:
    """Stage 1: the analysis-level op DAG for one (arch, phase, shape).

    ``Session.trace`` memoizes these, so the carried ``graph`` is shared
    between repeat calls — treat it as read-only.  Frontend traces
    (``phase="hpc"``) carry ``program``, the source expression DAG, which
    the lowered plan executes.
    """
    arch: str
    phase: str                # "train" | "prefill" | "decode" | "hpc"
    batch: int
    seq: Optional[int]                # train/prefill
    kv_len: Optional[int]             # decode
    layer_kind: Optional[str]
    graph: OpGraph = dataclasses.field(repr=False, compare=False)
    session: "Session" = dataclasses.field(repr=False, compare=False)
    program: Optional["Program"] = dataclasses.field(
        default=None, repr=False, compare=False)
    workload: Optional[str] = None
    wl_params: Tuple[Tuple[str, Any], ...] = ()

    @property
    def shape_key(self) -> str:
        if self.phase == "hpc":
            return ("-".join(f"{k}{v}" for k, v in self.wl_params)
                    or self.graph.name)
        span = f"s{self.seq}" if self.phase != "decode" else f"kv{self.kv_len}"
        return f"b{self.batch}{span}"

    def analyze(self) -> "AnalyzedGraph":
        return self.session.analyze(self)

    def codesign(self, config=None) -> "CoDesigned":
        """Convenience: codesign straight from the trace."""
        return self.session.codesign(self, config)

    def __repr__(self) -> str:
        return (f"TracedGraph({self.arch!r}, phase={self.phase!r}, "
                f"{self.shape_key}, {len(self.graph.ops)} ops, "
                f"{self.graph.total_flops:.3e} FLOPs)")


@dataclasses.dataclass(frozen=True)
class AnalyzedGraph:
    """Stage 2: reuse distances/frequencies over the natural schedule."""
    trace: TracedGraph
    analysis: ReuseAnalysis = dataclasses.field(repr=False, compare=False)

    @property
    def session(self) -> "Session":
        return self.trace.session

    def reuse_of(self, tensor: str):
        return self.analysis.tensors[tensor]

    def pin_candidates(self):
        return self.analysis.ranked_pin_candidates()

    def codesign(self, config=None) -> "CoDesigned":
        return self.session.codesign(self, config)

    def __repr__(self) -> str:
        multi = sum(1 for t in self.analysis.tensors.values()
                    if t.frequency > 1)
        return (f"AnalyzedGraph({self.trace.arch!r}, "
                f"phase={self.trace.phase!r}, "
                f"{len(self.analysis.tensors)} tensors, "
                f"{multi} with reuse)")


@dataclasses.dataclass(frozen=True)
class CoDesigned:
    """Stage 3: the joint schedule × buffer decision (plus baselines)."""
    trace: TracedGraph
    result: CoDesignResult = dataclasses.field(repr=False, compare=False)
    strategy: str = "default"
    capacity_bytes: int = 0

    @property
    def session(self) -> "Session":
        return self.trace.session

    @property
    def best(self) -> EvaluatedSchedule:
        return self.result.best

    @property
    def baselines(self) -> Dict[str, EvaluatedSchedule]:
        return self.result.baselines

    @property
    def split_sweep(self):
        return self.result.split_sweep

    def speedup(self, baseline: str = "seq-implicit") -> float:
        return self.result.speedup(baseline)

    def energy_ratio(self, baseline: str = "seq-implicit") -> float:
        return self.result.energy_ratio(baseline)

    def lower(self, config=None, *, seq: Optional[int] = None,
              backend: Optional[str] = None,
              mesh=None) -> "CompiledPlan":
        return self.session.lower(self, config, seq=seq, backend=backend,
                                  mesh=mesh)

    def __repr__(self) -> str:
        s = self.best.schedule
        return (f"CoDesigned({self.trace.arch!r}, phase={self.trace.phase!r}, "
                f"split={s.config.explicit_frac:.3f}, "
                f"{len(s.groups)} groups, {len(s.pins)} pins, "
                f"speedup={self.speedup():.2f}x)")


@dataclasses.dataclass(frozen=True)
class CompiledPlan:
    """Stage 4: the lowered plan, ready to serve or run.

    An LLM plan (``cfg`` set) serves: :meth:`serve` returns the prefill
    and decode entry points and the greedy driver bound to ``(cfg,
    plan)``; the plan's kernel flags pick the hand-written kernels (B5
    flash attention, B6 fused MLP, B7 RMSNorm) for tensors on the card,
    and a prefill's recurrences run on B8 (RG-LRU) and B9 (WKV6).

    A frontend (HPC) plan (``cfg=None``) runs: :meth:`run` hands it to a
    registered execution backend (``repro_torch.exec``): ``cuda`` (the
    default) runs its units on the hand-written Hopper kernels,
    ``reference`` replays the scheduled op order through the torch
    interpreter.
    """
    plan: CelloPlan = dataclasses.field(repr=False)
    cfg: Optional[ArchConfig] = dataclasses.field(default=None, repr=False)
    trace: Optional[TracedGraph] = dataclasses.field(
        default=None, repr=False, compare=False)
    codesigned: Optional[CoDesigned] = dataclasses.field(
        default=None, repr=False, compare=False)
    backend: str = "cuda"
    # the kernel shape chosen for every fusion group
    # (`core.lowering.select_group_kernels`)
    group_kernels: Tuple[GroupKernel, ...] = dataclasses.field(
        default=(), repr=False, compare=False)
    # fused dispatch units, residency spans, rolled iteration segment
    # (`core.lowering.plan_execution`)
    exec_plan: Optional[ExecPlan] = dataclasses.field(
        default=None, repr=False, compare=False)
    # mesh partitioning (frontend plans lowered with mesh=): row blocks,
    # CSR entry windows, gather/psum/halo exchange sets
    # (`core.lowering.partition_plan`); None for single-device plans
    sharded: Optional[ShardedExecPlan] = dataclasses.field(
        default=None, repr=False, compare=False)

    @property
    def arch(self) -> str:
        return self.cfg.name if self.cfg is not None else self.plan.arch

    @property
    def device(self) -> str:
        return self.trace.session.device

    # -- execution ------------------------------------------------------
    def serve(self, *, unroll: bool = False):
        """Serving bundle (prefill/decode fns + greedy generate loop);
        ``unroll`` is kept on it and changes no output (see
        ``launch.serve``)."""
        if self.cfg is None:
            raise ValueError("frontend (HPC) plans have no LLM serving "
                             "stack; execute them with plan.run()")
        from ..launch.serve import make_serving
        return make_serving(self.cfg, self.plan, unroll=unroll)

    def run(self, feeds=None, *, seed: int = 0,
            backend: Optional[str] = None,
            config=None) -> Dict[str, Any]:
        """Execute the plan through an execution backend on the session's
        device.  ``backend`` (or ``config=ExecConfig(backend=...)``)
        overrides the plan's default.  ``feeds`` are torch tensors or
        numpy arrays (moved to the device); without them the feeds are
        made from ``seed``.  On a CUDA device the call returns once the
        work is enqueued: synchronize before timing it.  A plan lowered
        with ``mesh=`` runs on its mesh on either backend."""
        if config is not None:
            if backend is not None:
                raise TypeError("run(): pass either config= or backend=, "
                                "not both")
            _fixed_mesh(config)
            backend = config.backend
        if self.trace is None or self.trace.program is None:
            raise ValueError("run() needs a frontend-traced plan "
                             "(Session.trace(workload=...) or "
                             "Session.from_graph(program))")
        from ..exec import get_backend
        return get_backend(backend or self.backend).run(
            self, feeds=feeds, seed=seed)

    def batched(self, config=None, *, backend: Optional[str] = None):
        """Wrap this frontend plan for batched serving: one dispatch (one
        CUDA-graph replay on the ``cuda`` backend) answers a whole batch of
        requests, operator leaves shared and input leaves batched — see
        ``repro_torch.serve.BatchedPlan``.  ``backend`` (or
        ``config=ExecConfig(backend=...)``) overrides the plan's default.
        An spmv op whose operand holds an overbooked (prefix) pin runs on
        B3's lane form.  A mesh-sharded plan raises :class:`ValueError`."""
        if config is not None:
            if backend is not None:
                raise TypeError("batched(): pass either config= or "
                                "backend=, not both")
            _fixed_mesh(config)
            backend = config.backend
        if self.trace is None or self.trace.program is None:
            raise ValueError("batched() needs a frontend-traced plan "
                             "(Session.trace(workload=...) or "
                             "Session.from_graph(program))")
        from ..serve import BatchedPlan
        return BatchedPlan(self, backend=backend)

    def compiled(self, backend: Optional[str] = None):
        """The backend's memoized compile of this plan (for ``cuda``, a
        :class:`~repro_torch.exec.cuda.CudaProgram` with ``stats``)."""
        from ..exec import get_backend
        return get_backend(backend or self.backend).compiled(self)

    # -- introspection --------------------------------------------------
    def report(self) -> Dict[str, Any]:
        """Headline co-design metrics."""
        out: Dict[str, Any] = {
            "arch": self.arch,
            "plan": dataclasses.asdict(self.plan),
        }
        if self.trace is not None:
            out["phase"] = self.trace.phase
            out["shape"] = self.trace.shape_key
            out["device"] = self.device
        if self.cfg is None:
            out["backend"] = self.backend
            out["group_kernel_kinds"] = [gk.kind
                                         for gk in self.group_kernels]
        if self.exec_plan is not None:
            ep = self.exec_plan
            out["exec_units"] = len(ep.units)
            out["exec_fused_from"] = ep.n_prefuse
            out["rolled_iters"] = (ep.roll.n_iters
                                   if ep.roll is not None else 0)
        if self.sharded is not None:
            out["mesh"] = {"axis": self.sharded.axis,
                           "n_shards": self.sharded.n_shards,
                           "rows_per_shard": self.sharded.rows_per_shard,
                           "plan": self.sharded.describe()}
        cd = self.codesigned
        if cd is not None:
            m = cd.best.metrics
            out.update({
                "strategy": cd.strategy,
                "capacity_bytes": cd.capacity_bytes,
                "overbook": getattr(cd.result, "overbook", 0.0),
                "explicit_frac": cd.best.schedule.config.explicit_frac,
                "time_s": m.time_s,
                "energy_j": m.energy_j,
                "hbm_bytes": m.hbm_bytes,
                "arithmetic_intensity": m.ai,
                "speedup_vs_implicit": cd.speedup(),
                "energy_ratio_vs_implicit": cd.energy_ratio(),
                "baselines": {
                    name: {"time_s": ev.metrics.time_s,
                           "energy_j": ev.metrics.energy_j,
                           "hbm_bytes": ev.metrics.hbm_bytes}
                    for name, ev in cd.baselines.items()},
            })
        return out

    def explain(self) -> str:
        """Human-readable schedule / pin / split / kernel summary."""
        p = self.plan
        lines = [f"CompiledPlan for {self.arch}"]
        if self.trace is not None:
            lines.append(f"  traced phase      : {self.trace.phase} "
                         f"({self.trace.shape_key})")
        cd = self.codesigned
        if cd is not None:
            s = cd.best.schedule
            cap = cd.capacity_bytes
            lines += [
                f"  search strategy   : {cd.strategy}",
                f"  buffer split      : {s.config.explicit_frac:.3f} explicit"
                f" ({s.config.explicit_bytes // 1024 // 1024} MiB of"
                f" {cap // 1024 // 1024} MiB)",
                f"  fusion groups     : "
                + (", ".join("{" + "+".join(g) + "}"
                             for g in s.groups if len(g) > 1) or "(none)"),
                f"  explicit pins     : "
                + (", ".join(f"{t}[g{a}..g{b}]"
                             for t, (a, b) in sorted(s.pins.items()))
                   or "(none)"),
                f"  speedup           : {cd.speedup():.3f}x vs implicit-only,"
                f" energy {cd.energy_ratio():.3f}x better",
                f"  HBM traffic       : "
                f"{cd.best.metrics.hbm_bytes / 1e6:,.1f} MB "
                f"(AI {cd.best.metrics.ai:,.1f} FLOP/B)",
            ]
            ob = getattr(cd.result, "overbook", 0.0)
            if ob:
                lines.append(f"  pin overbook      : {ob:.3f} of the "
                             "explicit region (prefix pins allowed)")
            if self.trace is not None:
                from ..core.schedule import sparse_operand_groups
                partial = dict(getattr(s.pins, "partial", None) or {})
                terms = []
                for grp in sparse_operand_groups(self.trace.graph):
                    base = grp[0].rsplit(".", 1)[0]
                    pp = next((partial[m] for m in grp if m in partial),
                              None)
                    if pp is not None:
                        terms.append(
                            f"{base} pinned=prefix(rows={pp.rows}/"
                            f"{pp.total_rows}, frac={pp.frac:.2f})")
                    elif all(m in s.pins for m in grp):
                        terms.append(f"{base} pinned=full")
                    else:
                        terms.append(f"{base} pinned=streamed")
                if terms:
                    lines.append("  sparse operands   : "
                                 + ", ".join(terms))
        else:
            lines.append("  (default plan — no search was run)")
        if self.cfg is None:
            g = self.trace.graph if self.trace is not None else None
            lines.append(
                f"  execution backend : {self.backend}"
                + (f" over {len(g.ops)} ops" if g is not None else "")
                + (f" on {self.device}" if self.trace is not None else "")
                + " (run(backend=...) to override)")
            if self.group_kernels:
                lines.append("  group kernels     :")
                for i, gk in enumerate(self.group_kernels):
                    lines.append(f"    g{i} {{{'+'.join(gk.ops)}}}: "
                                 f"{gk.describe()}")
            if self.exec_plan is not None:
                lines.append(f"  execution plan    : "
                             f"{self.exec_plan.describe()}")
                lines += [f"  cuda spmv kernel  : {ln}" for ln in
                          _spmv_kernels(self.trace.program, self.exec_plan)]
            if self.sharded is not None:
                from ..launch.mesh import make_solver_mesh
                mesh = make_solver_mesh(self.sharded.n_shards,
                                        axis=self.sharded.axis,
                                        device=self.device)
                lines.append(f"  device mesh       : "
                             f"{self.sharded.describe()}; "
                             f"{mesh.describe()}")
        else:
            lines += [
                f"  flash attention   : {p.use_flash_attention} "
                f"(q_block={p.q_block}, kv_block={p.kv_block})",
                f"  fused MLP         : {p.use_fused_mlp} "
                f"(m={p.mlp_block_m}, f={p.mlp_block_f})",
                f"  fused RMSNorm     : {p.use_fused_rmsnorm}",
                f"  remat save-set    : {', '.join(p.remat_save_names)}",
            ]
        if p.notes:
            lines.append(f"  notes             : {p.notes}")
        return "\n".join(lines)

    def __repr__(self) -> str:
        tag = (f"phase={self.trace.phase!r}, " if self.trace else "")
        how = "codesigned" if self.codesigned else "default"
        if self.cfg is not None:
            return (f"CompiledPlan({self.arch!r}, {tag}{how}, "
                    f"flash={self.plan.use_flash_attention}, "
                    f"fused_mlp={self.plan.use_fused_mlp})")
        return (f"CompiledPlan({self.arch!r}, {tag}{how}, "
                f"backend={self.backend!r})")


def _fixed_mesh(config) -> None:
    """A run or batch takes the plan's mesh: a config naming one raises."""
    if config.mesh is not None:
        raise ValueError("the mesh is fixed when the plan is lowered; "
                         "re-lower with Session.lower(..., mesh=...)")


def _spmv_kernels(program, exec_plan) -> List[str]:
    """One line per kernel that the ``cuda`` backend runs spmv ops on:
    B3 (the op's operand holds a prefix pin that the arrangement accepts)
    or B2, with the ops it runs."""
    from ..exec.cuda import spmv_prefixes
    ops: Dict[str, List[str]] = {}
    for unit in exec_plan.units:
        if unit.sp is None:
            continue
        for op, rows in spmv_prefixes(program, unit.sp).items():
            key = ("B2 (whole operand)" if rows is None else
                   f"B3 (resident prefix {rows}/{unit.sp.rows} rows)")
            ops.setdefault(key, []).append(op)
    return [f"{k} for {', '.join(v)}" for k, v in ops.items()]
