"""Serving: prefill + decode steps and a batched greedy generation driver.

The counterpart of ``repro.launch.serve`` on one device.  PyTorch runs
eagerly, so the prefill and the plain decode step are plain functions;
every tensor stays on the device of the parameters and the prompt.

``jit_decode_step`` is the counterpart of the JAX package's jitted,
cache-donating step, without its mesh (that comes with the device mesh):
on a CUDA device it captures the donating decode step
(``models.decode_step(..., donate=True)``) into one CUDA graph and replays
it once per step.  ``ServeBundle.generate`` decodes through it.

Every entry point takes the reference's ``unroll=`` and the bundle keeps
it (``ServeBundle.unroll``).  In the JAX package it swaps the layer
period's ``lax.scan`` for a Python loop; the port always walks the layers
in a Python loop (and a decode step is one captured graph either way), so
``unroll`` changes no launch and no output.
"""
from __future__ import annotations

import dataclasses
import functools
import threading
from typing import Any, Dict, Optional, Tuple

import torch

from .. import kernels, obs
from ..configs.base import ArchConfig
from ..core.policy import CelloPlan
from ..models import decode_step, forward, init_cache

_TRACES = obs.registry().counter(
    "serve.decode.traces", "captures of the donating decode step into a "
    "CUDA graph (on the CPU: first steps on a (params, cache) pair), per "
    "step object (scope label)")
_DISPATCHES = obs.registry().counter(
    "serve.decode.dispatches", "decode steps dispatched: CUDA-graph "
    "replays (on the CPU: eager steps), per step object (scope label)")


def make_prefill_fn(cfg: ArchConfig, plan: CelloPlan, *,
                    unroll: bool = False):
    # ``unroll``: the layers already run in a Python loop (module docstring)
    def prefill(params, tokens):
        logits, _ = forward(params, cfg, plan, tokens, mode="prefill")
        return logits
    return prefill


def make_decode_fn(cfg: ArchConfig, plan: CelloPlan, *,
                   donate: bool = False, unroll: bool = False):
    def serve_step(params, cache, tokens, pos):
        return decode_step(params, cache, cfg, plan, tokens, pos,
                           donate=donate)
    return serve_step


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


class DecodeStep:
    """A decode step ``(params, cache, tokens, pos) -> (logits, cache)``
    that writes the caller's cache in place, one CUDA-graph replay a step.

    On a CUDA device the first call on a (params object, cache buffers)
    pair runs the donating step once eagerly, on a side stream and into a
    copy of the cache (it builds the kernels and leaves the cache as it
    was), then captures the step into a graph that reads ``params``, the
    cache and two step-owned buffers, the tokens and the position.  Every
    call copies ``tokens`` into its buffer and fills the position (a fill,
    no host sync), replays the graph and returns a clone of the logits with
    the cache, now one step further.  Another params object or other cache
    buffers capture anew; the step keeps the params object it captured
    with, so its identity stays its own.  A capture that fails raises.

    On the CPU the step runs eagerly (donating) and counts the same
    ``stats``: ``traces`` per (params, cache) pair and ``dispatches`` per
    step, from the ``serve.decode.traces`` and ``serve.decode.dispatches``
    counters under the step's own ``obs`` scope.  A replay adds the
    capture's kernel counts through ``kernels.count``, so launch counts keep
    meaning kernels run on the device; the warm-up and the capture count
    nowhere.
    """

    def __init__(self, cfg: ArchConfig, plan: CelloPlan, batch: int,
                 seq_len: int, *, unroll: bool = False):
        self.cfg, self.plan = cfg, plan
        self.batch, self.seq_len = batch, seq_len
        # the cache this step serves, as init_cache shapes it
        self._shapes = [(t.shape, t.dtype) for t in _leaves(
            init_cache(cfg, batch, seq_len, device="meta"))]
        self._step = make_decode_fn(cfg, plan, donate=True, unroll=unroll)
        self._scope = obs.next_scope("decode")
        self._lock = threading.Lock()
        self._key: Optional[Tuple] = None
        self._params = None   # held, so that its id in the key stays its own
        self._graph: Optional[torch.cuda.CUDAGraph] = None
        self._tokens = self._pos = self._logits = None
        self._counts: Dict[str, int] = {}
        self._done: Optional[torch.cuda.Event] = None   # last copy-out

    @property
    def stats(self) -> Dict[str, int]:
        return {"traces": int(_TRACES.value(scope=self._scope)),
                "dispatches": int(_DISPATCHES.value(scope=self._scope))}

    def __call__(self, params, cache, tokens: torch.Tensor, pos):
        if tokens.shape != (self.batch, 1):
            raise ValueError(f"decode step for batch {self.batch}: tokens "
                             f"{tuple(tokens.shape)}, want ({self.batch}, 1)")
        leaves = list(_leaves(cache))
        if [(t.shape, t.dtype) for t in leaves] != self._shapes:
            raise ValueError(f"decode step for (batch, seq_len) = "
                             f"({self.batch}, {self.seq_len}): the cache is "
                             "not one that init_cache makes for them")
        key = (id(params), tokens.dtype, tuple(t.data_ptr() for t in leaves))
        with self._lock:
            traced = key != self._key
            if tokens.device.type != "cuda":
                logits, _ = self._step(params, cache, tokens, pos)
            else:
                stream = torch.cuda.current_stream(tokens.device)
                if traced:
                    self._capture(params, cache, tokens)
                elif self._done is not None:
                    stream.wait_event(self._done)
                self._tokens.copy_(tokens)
                if isinstance(pos, torch.Tensor):
                    self._pos.copy_(pos)
                else:
                    self._pos.fill_(int(pos))
                self._graph.replay()
                logits = self._logits.clone()
                self._done = torch.cuda.Event()
                self._done.record(stream)
                for name, n in self._counts.items():
                    kernels.count(name, n)
            self._key, self._params = key, params
            if traced:
                _TRACES.inc(scope=self._scope)
            _DISPATCHES.inc(scope=self._scope)
        return logits, cache

    def _capture(self, params, cache, tokens) -> None:
        self._graph = self._logits = None      # free the old graph first
        dev = tokens.device
        self._tokens = tokens.clone()
        self._pos = torch.zeros((), dtype=torch.int32, device=dev)
        current = torch.cuda.current_stream(dev)
        side = torch.cuda.Stream(dev)
        side.wait_stream(current)
        # the warm-up builds the kernels (a capture cannot); it decodes
        # into a copy of the cache and, like the capture, counts nowhere
        with torch.cuda.stream(side), kernels.capturing() as warm:
            scratch = {"layers": [{k: v.clone() for k, v in e.items()}
                                  for e in cache["layers"]]}
            self._step(params, scratch, self._tokens, self._pos)
        current.wait_stream(side)
        del scratch
        graph = torch.cuda.CUDAGraph()
        with kernels.capturing() as counts:
            with torch.cuda.graph(graph, capture_error_mode="thread_local"):
                self._logits, _ = self._step(params, cache, self._tokens,
                                             self._pos)
        if counts != warm:
            raise RuntimeError(f"the captured step launched {counts}, the "
                               f"warm-up {warm}")
        self._graph = graph
        self._counts = {k: v for k, v in counts.items() if v}


def jit_decode_step(cfg: ArchConfig, plan: CelloPlan, batch: int,
                    seq_len: int, *, unroll: bool = False) -> DecodeStep:
    """The decode step ``(params, cache, tokens, pos) -> (logits, cache)``
    for ``batch`` sequences and a cache of ``seq_len`` positions: the
    donating step, one CUDA-graph replay a step (:class:`DecodeStep`)."""
    return DecodeStep(cfg, plan, batch, seq_len, unroll=unroll)


def greedy_generate(params, cfg: ArchConfig, plan: CelloPlan,
                    prompt: torch.Tensor, n_new: int,
                    cache_len: Optional[int] = None, *, step_fn=None,
                    cache=None) -> torch.Tensor:
    """Batched greedy decoding.

    prompt: (B, P) int.  Returns (B, P + n_new).  The prompt is fed token
    by token through the decode step, as the JAX package's does.  ``step_fn``
    lets a caller supply a step (``jit_decode_step``'s) and ``cache`` the
    fresh cache it decodes into; otherwise the plain step and a new cache
    are used.
    """
    B, Plen = prompt.shape
    Z = cache_len or (Plen + n_new)
    if cache is None:
        cache = init_cache(cfg, B, Z, device=prompt.device)
    step = step_fn if step_fn is not None else make_decode_fn(cfg, plan)
    toks = prompt
    logits = None
    for t in range(Plen):
        logits, cache = step(params, cache, toks[:, t:t + 1], t)
    for t in range(n_new):
        nxt = torch.argmax(logits[:, -1], dim=-1).to(prompt.dtype)[:, None]
        toks = torch.cat([toks, nxt], dim=1)
        if t < n_new - 1:
            logits, cache = step(params, cache, nxt, Plen + t)
    return toks


def reset_cache(cache) -> None:
    """Put ``cache`` back to what ``init_cache`` builds: zeros, with every
    ``pos_idx`` at -1 (device fills, no host sync)."""
    for entry in cache["layers"]:
        for name, t in entry.items():
            t.fill_(-1 if name == "pos_idx" else 0)


@dataclasses.dataclass(frozen=True)
class ServeBundle:
    """Serving entry points bound to one (cfg, plan) pair, produced by
    ``repro_torch.api.CompiledPlan.serve()``.  It keeps one decode step
    (``jit_decode``) and one cache per (batch, cache_len), and ``generate``
    decodes through them, resetting the cache first: a second ``generate``
    of the same shape on the same params captures nothing.  ``unroll`` is
    passed to every function the bundle makes (see the module docstring)."""
    cfg: ArchConfig
    plan: CelloPlan
    unroll: bool = False
    _steps: Dict[Any, DecodeStep] = dataclasses.field(
        default_factory=dict, compare=False, repr=False)
    _caches: Dict[Any, Any] = dataclasses.field(
        default_factory=dict, compare=False, repr=False)
    _lock: Any = dataclasses.field(default_factory=threading.Lock,
                                   compare=False, repr=False)

    @functools.cached_property
    def prefill_fn(self):
        return make_prefill_fn(self.cfg, self.plan, unroll=self.unroll)

    @functools.cached_property
    def decode_fn(self):
        return make_decode_fn(self.cfg, self.plan, unroll=self.unroll)

    def jit_decode(self, batch: int, seq_len: int) -> DecodeStep:
        """The bundle's decode step for (batch, seq_len), made once."""
        with self._lock:
            step = self._steps.get((batch, seq_len))
            if step is None:
                step = self._steps[batch, seq_len] = jit_decode_step(
                    self.cfg, self.plan, batch, seq_len, unroll=self.unroll)
            return step

    def generate(self, params, prompt: torch.Tensor, n_new: int,
                 cache_len: Optional[int] = None) -> torch.Tensor:
        B, Plen = prompt.shape
        Z = cache_len or (Plen + n_new)
        step = self.jit_decode(B, Z)
        key = (B, Z, str(prompt.device))
        with self._lock:
            cache = self._caches.get(key)
            if cache is None:
                cache = self._caches[key] = init_cache(
                    self.cfg, B, Z, device=prompt.device)
            else:
                reset_cache(cache)
        return greedy_generate(params, self.cfg, self.plan, prompt, n_new,
                               step_fn=step, cache=cache)


def make_serving(cfg: ArchConfig, plan: CelloPlan, *,
                 unroll: bool = False) -> ServeBundle:
    return ServeBundle(cfg=cfg, plan=plan, unroll=unroll)


@dataclasses.dataclass
class ServeStats:
    tokens_generated: int
    steps: int
    wall_s: float

    @property
    def tok_per_s(self) -> float:
        return self.tokens_generated / max(self.wall_s, 1e-9)
