"""Composable pass pipeline for the CELLO co-design search.

The joint schedule × buffer search is factored into a registry of passes run
over a stream of candidate :class:`SearchPoint`\\ s:

  ``OrderPass``      — expand one seed point into candidate topological
                       orders, delegating to a pluggable
                       :class:`SearchStrategy` (exhaustive / greedy / ALAP…),
  ``SplitSweepPass`` — expand each order across explicit/implicit splits,
  ``FusionPass``     — greedy maximal fusion chains per (order, split),
  ``PinPass``        — reuse analysis + greedy pin selection,
  ``EvaluatePass``   — hybrid-buffer simulation + speedup/energy model.

:func:`run_codesign` streams points through the default pipeline and reduces
them to a :class:`~repro.core.schedule.CoDesignResult`.  The enumeration
order, tie-breaking, and per-point arithmetic are exactly those of the
original monolithic ``schedule.co_design`` loop, so results are bit-identical
— new strategies or passes plug in without perturbing the default search.

New orderings register with :func:`register_strategy`; new passes with
:func:`register_pass`.  ``repro_torch.api`` re-exports this module's surface.

A copy of ``repro.core.search``, spans and instruments included (on the
port's own ``repro_torch.obs`` registry and tracer); the search is the
same code, so plans agree with the JAX package's bit for bit.
"""
from __future__ import annotations

import dataclasses
import time
from typing import (Dict, Iterable, Iterator, List, Optional, Sequence,
                    Tuple, Type)

from .. import obs
from .buffer import BufferConfig, TrafficReport, sequential_groups, simulate
from .costmodel import HardwareModel, Metrics, V5E, evaluate
from .graph import OpGraph, TensorKind
from .reuse import ReuseAnalysis, analyze

DEFAULT_SPLITS = (0.0, 0.125, 0.25, 0.375, 0.5, 0.625, 0.75, 0.875, 1.0)

_SEARCH_S = obs.registry().histogram(
    "codesign.search_s", "joint schedule x buffer search wall-clock",
    unit="s")
_POINTS = obs.registry().counter(
    "codesign.points", "design points streamed through the search pipeline")
_PINS = obs.registry().counter(
    "codesign.pins", "sparse-operand pin decisions of winning schedules, "
    "by outcome label: full | prefix | streamed")
_OVERBOOK_FRAC = obs.registry().histogram(
    "codesign.overbook_frac", "resident row fraction of prefix-pinned "
    "sparse operands in winning schedules")


# --------------------------------------------------------------------------
# search state
# --------------------------------------------------------------------------

@dataclasses.dataclass
class SearchPoint:
    """One candidate design flowing through the pass pipeline."""
    order: Optional[List[str]] = None
    split: Optional[float] = None
    config: Optional[BufferConfig] = None
    groups: Optional[List[List[str]]] = None
    analysis: Optional[ReuseAnalysis] = None
    pins: Optional[Dict[str, Tuple[int, int]]] = None
    report: Optional[TrafficReport] = None
    metrics: Optional[Metrics] = None
    # baseline knobs (the paper's ablations flow through the same pipeline)
    fuse: bool = True
    pin: bool = True
    last_use_invalidate: bool = True


@dataclasses.dataclass
class SearchContext:
    """Shared, read-only inputs plus per-run caches for the passes."""
    graph: OpGraph
    hw: HardwareModel = V5E
    capacity_bytes: int = 0
    max_orders: int = 16
    splits: Sequence[float] = DEFAULT_SPLITS
    # allow sparse pins to exceed the explicit region by this fraction of
    # its capacity, pinning an indptr-aligned row prefix and streaming the
    # spill tail (0.0 = all-or-nothing pins, the pre-overbook behaviour)
    overbook: float = 0.0
    # analyze(graph, order) is pure in (graph, order): cache it per order so
    # the split sweep doesn't recompute the same reuse analysis nine times.
    _analysis_cache: Dict[Tuple[str, ...], ReuseAnalysis] = \
        dataclasses.field(default_factory=dict)

    def analysis_for(self, order: Sequence[str]) -> ReuseAnalysis:
        key = tuple(order)
        hit = self._analysis_cache.get(key)
        if hit is None:
            hit = self._analysis_cache[key] = analyze(self.graph, list(order))
        return hit


# --------------------------------------------------------------------------
# ordering strategies (pluggable)
# --------------------------------------------------------------------------

class SearchStrategy:
    """Protocol: produce candidate topological orders for the search."""
    name: str = "base"

    def orders(self, graph: OpGraph, max_orders: int) -> List[List[str]]:
        raise NotImplementedError


STRATEGY_REGISTRY: Dict[str, SearchStrategy] = {}


def register_strategy(strategy) -> SearchStrategy:
    """Register a strategy instance (or class, instantiated with no args)."""
    inst = strategy() if isinstance(strategy, type) else strategy
    STRATEGY_REGISTRY[inst.name] = inst
    return strategy


def get_strategy(name_or_obj) -> SearchStrategy:
    if isinstance(name_or_obj, str):
        if name_or_obj not in STRATEGY_REGISTRY:
            raise KeyError(f"unknown search strategy {name_or_obj!r}; "
                           f"have {sorted(STRATEGY_REGISTRY)}")
        return STRATEGY_REGISTRY[name_or_obj]
    if isinstance(name_or_obj, type):    # mirror register_strategy: a bare
        return name_or_obj()             # class is instantiated with no args
    return name_or_obj


def _lazy_order(graph: OpGraph, natural: Sequence[str]) -> List[str]:
    """ALAP-flavoured topological order: among ready ops, prefer the one
    whose output is consumed soonest (shrinks late-use reuse distances)."""
    remaining = set(natural)
    placed: List[str] = []
    produced = {t.name for t in graph.tensors.values()
                if t.kind in (TensorKind.INPUT, TensorKind.WEIGHT)}
    natural = list(natural)
    while remaining:
        ready = [o for o in natural
                 if o in remaining
                 and all(t in produced for t in graph.ops[o].inputs)]

        def urgency(o: str) -> int:
            t = graph.ops[o].output
            for j, other in enumerate(natural):
                if other in remaining and other != o and t in graph.ops[other].inputs:
                    return j
            return len(natural)
        ready.sort(key=urgency)
        pick = ready[0]
        placed.append(pick)
        remaining.discard(pick)
        produced.add(graph.ops[pick].output)
    return placed


@register_strategy
class DefaultStrategy(SearchStrategy):
    """The paper's search: exhaustive for small DAGs (≤10 ops), natural +
    ALAP heuristic otherwise."""
    name = "default"

    def orders(self, graph: OpGraph, max_orders: int) -> List[List[str]]:
        orders = [graph.topo_order()]
        if len(graph.ops) <= 10:
            for o in graph.all_topo_orders(limit=max_orders):
                if o not in orders:
                    orders.append(o)
        else:
            lazy = _lazy_order(graph, graph.topo_order())
            if lazy not in orders:
                orders.append(lazy)
        return orders[:max_orders]


@register_strategy
class ExhaustiveStrategy(SearchStrategy):
    """Enumerate topological orders up to ``max_orders`` regardless of size."""
    name = "exhaustive"

    def orders(self, graph: OpGraph, max_orders: int) -> List[List[str]]:
        orders = [graph.topo_order()]
        for o in graph.all_topo_orders(limit=max_orders):
            if o not in orders:
                orders.append(o)
        return orders[:max_orders]


@register_strategy
class GreedyStrategy(SearchStrategy):
    """Construction (natural) order only — the cheapest search."""
    name = "greedy"

    def orders(self, graph: OpGraph, max_orders: int) -> List[List[str]]:
        return [graph.topo_order()]


@register_strategy
class AlapStrategy(SearchStrategy):
    """Natural + ALAP orders only (skip exhaustive enumeration)."""
    name = "alap"

    def orders(self, graph: OpGraph, max_orders: int) -> List[List[str]]:
        orders = [graph.topo_order()]
        lazy = _lazy_order(graph, graph.topo_order())
        if lazy not in orders:
            orders.append(lazy)
        return orders[:max_orders]


# --------------------------------------------------------------------------
# passes (composable; registered by name)
# --------------------------------------------------------------------------

class Pass:
    """Protocol: transform/expand a stream of search points."""
    name: str = "base"

    def run(self, ctx: SearchContext,
            points: Iterable[SearchPoint]) -> Iterator[SearchPoint]:
        raise NotImplementedError


PASS_REGISTRY: Dict[str, Type[Pass]] = {}


def register_pass(cls: Type[Pass]) -> Type[Pass]:
    PASS_REGISTRY[cls.name] = cls
    return cls


@register_pass
class OrderPass(Pass):
    """Expand each seed point into one point per candidate order."""
    name = "order"

    def __init__(self, strategy="default"):
        self.strategy = get_strategy(strategy)

    def run(self, ctx, points):
        for pt in points:
            for order in self.strategy.orders(ctx.graph, ctx.max_orders):
                yield dataclasses.replace(pt, order=order)


@register_pass
class SplitSweepPass(Pass):
    """Expand each point across the explicit/implicit split grid."""
    name = "split-sweep"

    def __init__(self, splits: Optional[Sequence[float]] = None):
        self.splits = splits

    def run(self, ctx, points):
        splits = self.splits if self.splits is not None else ctx.splits
        for pt in points:
            for split in splits:
                cfg = BufferConfig(
                    capacity_bytes=ctx.capacity_bytes, explicit_frac=split,
                    last_use_invalidate=pt.last_use_invalidate)
                yield dataclasses.replace(pt, split=split, config=cfg)


@register_pass
class FusionPass(Pass):
    """Greedy maximal fusion chains along the order (or op-by-op when the
    point is a no-fusion baseline)."""
    name = "fusion"

    def run(self, ctx, points):
        from .schedule import build_groups     # late: avoid import cycle
        for pt in points:
            groups = (build_groups(ctx.graph, pt.order,
                                   pt.config.explicit_bytes)
                      if pt.fuse else sequential_groups(ctx.graph, pt.order))
            yield dataclasses.replace(pt, groups=groups)


@register_pass
class PinPass(Pass):
    """Reuse analysis + greedy explicit-region pin selection."""
    name = "pin"

    def run(self, ctx, points):
        from .schedule import choose_pins      # late: avoid import cycle
        for pt in points:
            if pt.pin and pt.config.explicit_bytes > 0:
                analysis = ctx.analysis_for(pt.order)
                pins = choose_pins(ctx.graph, pt.groups, analysis,
                                   pt.config.explicit_bytes,
                                   overbook=ctx.overbook)
                if getattr(pins, "partial", None):
                    # Overbooking is speculative: yield the conservative
                    # all-or-nothing pin set FIRST so the strict-< best
                    # comparison keeps it on ties — EvaluatePass rejects
                    # the overbooked point whenever its per-pass streamed
                    # tail traffic dominates the prefix's captured reuse.
                    conservative = choose_pins(ctx.graph, pt.groups,
                                               analysis,
                                               pt.config.explicit_bytes)
                    yield dataclasses.replace(pt, analysis=analysis,
                                              pins=conservative)
            else:
                analysis, pins = None, {}
            yield dataclasses.replace(pt, analysis=analysis, pins=pins)


@register_pass
class EvaluatePass(Pass):
    """Hybrid-buffer simulation + roofline/energy scoring."""
    name = "evaluate"

    def run(self, ctx, points):
        for pt in points:
            rep = simulate(ctx.graph, pt.groups, pt.config, pt.pins)
            met = evaluate(ctx.graph, pt.groups, rep, ctx.hw)
            yield dataclasses.replace(pt, report=rep, metrics=met)


def default_pipeline(strategy="default",
                     splits: Optional[Sequence[float]] = None) -> List[Pass]:
    return [OrderPass(strategy), SplitSweepPass(splits), FusionPass(),
            PinPass(), EvaluatePass()]


def run_pipeline(ctx: SearchContext, passes: Sequence[Pass],
                 seed: Optional[SearchPoint] = None) -> Iterator[SearchPoint]:
    points: Iterable[SearchPoint] = iter([seed or SearchPoint()])
    for p in passes:
        points = p.run(ctx, points)
    return iter(points)


class _TimedIter:
    """Wraps one pass's generator, accumulating wall-clock spent inside
    ``next()``.  The passes are lazy, so a pull on stage N runs every
    upstream stage too: ``elapsed`` is *inclusive* time, and a stage's
    exclusive self-time is ``elapsed[N] - elapsed[N-1]``."""

    __slots__ = ("_it", "elapsed", "count")

    def __init__(self, it: Iterable[SearchPoint]):
        self._it = iter(it)
        self.elapsed = 0.0
        self.count = 0

    def __iter__(self) -> "_TimedIter":
        return self

    def __next__(self) -> SearchPoint:
        t0 = time.perf_counter()
        try:
            item = next(self._it)
        except StopIteration:
            self.elapsed += time.perf_counter() - t0
            raise
        self.elapsed += time.perf_counter() - t0
        self.count += 1
        return item


def _timed_pipeline(ctx: SearchContext, passes: Sequence[Pass]):
    """Like :func:`run_pipeline` with a :class:`_TimedIter` between stages,
    so per-pass self-time is recoverable from the lazy stream."""
    points: Iterable[SearchPoint] = iter([SearchPoint()])
    timers: List[Tuple[str, _TimedIter]] = []
    for p in passes:
        timer = _TimedIter(p.run(ctx, points))
        timers.append((p.name, timer))
        points = timer
    return points, timers


# --------------------------------------------------------------------------
# the co-design driver
# --------------------------------------------------------------------------

def _pin_outcomes(graph: OpGraph, pins) -> List[Tuple[str, str, float]]:
    """Classify each sparse CSR triple under a pin set.

    Returns ``(operand, outcome, resident_frac)`` rows where outcome is
    ``full`` (whole triple pinned), ``prefix`` (overbooked: row prefix
    resident, tail streamed) or ``streamed`` (nothing pinned).
    """
    from .schedule import sparse_operand_groups    # late: import cycle
    partial = dict(getattr(pins, "partial", None) or {})
    spans = dict(pins or {})
    out: List[Tuple[str, str, float]] = []
    for grp in sparse_operand_groups(graph):
        base = grp[0].rsplit(".", 1)[0]
        pp = next((partial[m] for m in grp if m in partial), None)
        if pp is not None:
            out.append((base, "prefix", pp.frac))
        elif all(m in spans for m in grp):
            out.append((base, "full", 1.0))
        else:
            out.append((base, "streamed", 0.0))
    return out


def _to_evaluated(pt: SearchPoint):
    from .schedule import EvaluatedSchedule, Schedule
    return EvaluatedSchedule(
        Schedule(pt.order, pt.groups, pt.pins, pt.config), pt.report,
        pt.metrics)


def evaluate_point(ctx: SearchContext, order: List[str], split: float, *,
                   last_use_invalidate: bool = True, fuse: bool = True,
                   pin: bool = True):
    """Score a single (order, split, knobs) design point."""
    seed = SearchPoint(order=order, fuse=fuse, pin=pin,
                       last_use_invalidate=last_use_invalidate)
    passes = [SplitSweepPass([split]), FusionPass(), PinPass(),
              EvaluatePass()]
    return _to_evaluated(next(run_pipeline(ctx, passes, seed)))


def run_codesign(graph: OpGraph, *, capacity_bytes: Optional[int] = None,
                 hw: HardwareModel = V5E, max_orders: int = 16,
                 strategy="default",
                 splits: Sequence[float] = DEFAULT_SPLITS,
                 overbook: float = 0.0,
                 natural_analysis: Optional[ReuseAnalysis] = None):
    """Joint schedule × buffer-split search. Returns best + baselines.

    The engine behind the staged ``repro.api.Session.codesign`` stage (and
    the removed 0.2-era ``co_design``).  ``natural_analysis`` (from a
    prior analyze() stage) pre-seeds the per-order analysis cache — analyze
    is pure in (graph, order), so seeding cannot change results.

    ``overbook`` lets sparse pins exceed the explicit region by that
    fraction of its capacity: the operand's indptr-aligned row prefix is
    pinned and the spill tail streamed per pass.  Both the conservative
    and the overbooked pin sets compete in the search, so overbooking is
    only kept when the cost model says the prefix's reuse beats the tail's
    streamed traffic.  ``overbook=0`` is bit-identical to the historical
    all-or-nothing search.
    """
    from .schedule import CoDesignResult
    graph.validate()
    if overbook < 0:
        raise ValueError(f"overbook must be >= 0, got {overbook}")
    splits = list(splits)    # normalize once: a one-shot iterable must not
    if not splits:           # be consumed by the guard before the sweep
        raise ValueError("splits must be a non-empty sequence of fractions")
    ctx = SearchContext(graph=graph, hw=hw,
                        capacity_bytes=capacity_bytes or hw.vmem_bytes,
                        max_orders=max_orders, splits=splits,
                        overbook=overbook)
    if natural_analysis is not None:
        ctx._analysis_cache[tuple(natural_analysis.order)] = natural_analysis

    strat_name = get_strategy(strategy).name
    tracer = obs.tracer()
    passes = default_pipeline(strategy, splits)
    best: Optional[SearchPoint] = None
    split_sweep: Dict[float, Metrics] = {}
    t_search = time.perf_counter()
    with obs.span("codesign.search", strategy=strat_name,
                  max_orders=max_orders, splits=len(splits)) as sp:
        start = tracer.now()
        timers: List[Tuple[str, _TimedIter]] = []
        if tracer.enabled:
            points, timers = _timed_pipeline(ctx, passes)
        else:
            points = run_pipeline(ctx, passes)
        n_points = 0
        for pt in points:
            n_points += 1
            cur = split_sweep.get(pt.split)
            if cur is None or pt.metrics.time_s < cur.time_s:
                split_sweep[pt.split] = pt.metrics
            if (best is None
                    or (pt.metrics.time_s, pt.metrics.energy_j)
                    < (best.metrics.time_s, best.metrics.energy_j)):
                best = pt
        sp.annotate(points=n_points)
        outcomes = (_pin_outcomes(graph, best.pins)
                    if best is not None else [])
        # per-pass self-time as synthetic consecutive child spans: the
        # stages stream lazily, so real intervals interleave per point —
        # aggregate self-time is the honest per-pass number.
        cursor, prev = start, 0.0
        for pass_name, timer in timers:
            self_s = max(timer.elapsed - prev, 0.0)
            meta = {}
            if pass_name == "pin" and outcomes:
                # annotate the pin span with the winning pin set:
                # "A=prefix(0.77)+x=full" style, one term per operand
                meta["pins"] = "+".join(
                    f"{name}={kind}" if kind != "prefix"
                    else f"{name}=prefix({frac:.2f})"
                    for name, kind, frac in outcomes)
            tracer.record(f"codesign.pass.{pass_name}", cursor, self_s,
                          points=timer.count, **meta)
            cursor += self_s
            prev = timer.elapsed
    _SEARCH_S.observe(time.perf_counter() - t_search, strategy=strat_name)
    _POINTS.inc(n_points, strategy=strat_name)
    if best is None:    # a custom strategy returned no candidate orders
        raise ValueError(f"search produced no candidates: strategy "
                         f"{strat_name!r} yielded no "
                         "orders for this graph")
    for _name, kind, frac in outcomes:
        _PINS.inc(outcome=kind)
        if kind == "prefix":
            _OVERBOOK_FRAC.observe(frac)

    nat = graph.topo_order()
    with obs.span("codesign.baselines"):
        baselines = {
            # plain cache, op-by-op, no hints — the "implicit-only"
            # accelerator
            "seq-implicit": evaluate_point(ctx, nat, 0.0,
                                           last_use_invalidate=False,
                                           fuse=False, pin=False),
            # scratchpad-only: pinning but no cache for the rest
            "seq-explicit": evaluate_point(ctx, nat, 1.0, fuse=False,
                                           pin=True),
            # fusion, all capacity explicit, no implicit region
            "fused-only": evaluate_point(ctx, nat, 1.0, fuse=True, pin=True),
        }
    return CoDesignResult(best=_to_evaluated(best), baselines=baselines,
                          split_sweep=split_sweep, overbook=overbook)
