"""The traffic loops: one general generator that a traffic mix's data file
(``traffic/<mix>.json``) drives by its ``kind`` and parameters.

``solve``: one client in a closed loop on ``CompiledPlan.run()`` (the
``cuda`` backend), each run with a right-hand side from a seeded pool made
in set-up, dispatched up to ``ahead`` runs ahead of the device; the window
ends at a ``torch.cuda.synchronize()``.

``serve``: ``clients`` closed-loop clients on
``Server(PlanRouter(Session()))``, kept by one thread (so the load adds
one Python thread, not one a client, to the server's process), each
submitting a request that carries a right-hand side from a seeded pool
(numpy, as a client holds it) and nothing else, as users send it, and
waiting for its answer; a request's latency runs from ``submit`` to its
result being set.

Both keep a sample of their answers, drawn from the seed, for the
comparison with the plain reference after the window.  Every size is
fixed by the configuration and the mix; the seed changes values and their
order only.
"""
from __future__ import annotations

import os
import queue
import random
import time
from collections import deque
from typing import Dict, List, Optional

import torch

DTYPES = {"float64": torch.float64, "float32": torch.float32}


def _cache_dir() -> Optional[str]:
    return os.environ.get("CELLO_CACHE_DIR")


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class _Window:
    """What one measured window produced."""

    def __init__(self):
        self.seconds = 0.0
        self.attempted = 0
        self.completed = 0
        self.failed = 0
        self.latencies_s: List[float] = []


class SolveTraffic:
    def __init__(self, spec, cfg: dict, mix: dict, seed: int, device,
                 run_dtype: Optional[str] = None):
        self.spec, self.cfg, self.mix = spec, cfg, mix
        self.device = torch.device(device)
        self.dtype = DTYPES[cfg["dtype"]]
        # what the program is fed in: the configuration's precision, or
        # the control's, one step down
        self.run_dtype = DTYPES[run_dtype or cfg["dtype"]]
        self.n = int(cfg["params"]["n"])
        self.gen = torch.Generator(self.device).manual_seed(seed % 2**63)
        self.rng = random.Random(seed)
        self.sample: List[tuple] = []        # (pool index, outputs)
        self.plan = None

    # -- set-up ----------------------------------------------------------
    def make_inputs(self) -> None:
        pat = self.spec.operands(self.cfg["operand"])
        self.operand = pat.make(self.cfg, self.gen, self.device,
                                self.dtype)
        self.pool = torch.randn((int(self.mix["rhs_pool"]), self.n),
                                generator=self.gen, device=self.device,
                                dtype=self.dtype)
        self.order = list(range(self.pool.shape[0]))
        self.rng.shuffle(self.order)
        self.x0 = torch.zeros(self.n, device=self.device, dtype=self.dtype)
        self.fed = (self.operand[2].to(self.run_dtype),
                    self.pool.to(self.run_dtype), self.x0.to(self.run_dtype))

    def make_plan(self) -> None:
        from repro_torch.api import Session
        sess = Session(device=str(self.device), cache_dir=_cache_dir())
        traced = sess.trace(workload=self.cfg["workload"],
                            **self.cfg["params"])
        self.plan = traced.analyze().codesign().lower(backend="cuda")
        self.outputs = list(traced.program.outputs)

    def feeds(self, j: int) -> Dict[str, torch.Tensor]:
        indptr, indices, _ = self.operand
        data, pool, x0 = self.fed
        return {"A.indptr": indptr, "A.indices": indices, "A.data": data,
                "b": pool[j], "x0": x0}

    def warm(self) -> None:
        for i in range(int(self.mix["warm_runs"])):
            self.plan.run(self.feeds(self.order[i % len(self.order)]))
        _sync(self.device)

    # -- windows ---------------------------------------------------------
    def window(self, seconds: float, keep: bool = True) -> _Window:
        w = _Window()
        ahead = int(self.mix["ahead"])
        k = int(self.mix["sample"])
        pending: deque = deque()
        n = 0
        t0 = time.perf_counter()
        t_end = t0 + seconds
        while time.perf_counter() < t_end:
            if len(pending) >= ahead:
                ev = pending.popleft()
                if ev is not None:
                    ev.synchronize()
            j = self.order[n % len(self.order)]
            out = self.plan.run(self.feeds(j))
            ev = None
            if self.device.type == "cuda":
                ev = torch.cuda.Event()
                ev.record()
            pending.append(ev)
            if keep:            # a reservoir sample, drawn from the seed
                if n < k:
                    self.sample.append((j, out))
                else:
                    m = self.rng.randrange(n + 1)
                    if m < k:
                        self.sample[m] = (j, out)
            n += 1
        _sync(self.device)
        w.seconds = time.perf_counter() - t0
        w.attempted = w.completed = n
        return w

    def answers(self):
        """``(b, x0, x, r)`` of each sampled solve."""
        return [(self.pool[j], self.x0, out[self.outputs[0]],
                 out[self.outputs[1]]) for j, out in self.sample]

    def reference_operand(self):
        return self.operand

    def release(self) -> None:
        self.plan = None


class ServeTraffic:
    def __init__(self, spec, cfg: dict, mix: dict, seed: int, device,
                 run_dtype: Optional[str] = None):
        self.spec, self.cfg, self.mix = spec, cfg, mix
        self.device = torch.device(device)
        self.dtype = DTYPES[cfg["dtype"]]
        self.run_dtype = run_dtype or cfg["dtype"]
        self.n = int(cfg["params"]["n"])
        self.gen = torch.Generator(self.device).manual_seed(seed % 2**63)
        self.rng = random.Random(seed)
        self.sample: List[tuple] = []        # (pool index, x, r)
        self._seen = 0
        self.server = self.router = None

    # -- set-up ----------------------------------------------------------
    def make_inputs(self) -> None:
        pool = torch.randn((int(self.mix["rhs_pool"]), self.n),
                           generator=self.gen, device=self.device,
                           dtype=self.dtype)
        self.pool = pool.cpu().numpy()
        self.fed_pool = self.pool.astype(self.run_dtype, copy=False)
        clients = int(self.mix["clients"])
        # each client walks the pool from its own seeded start
        self.starts = [self.rng.randrange(len(self.pool))
                       for _ in range(clients)]

    def request(self, j: int):
        from repro_torch.serve import request
        return request(self.cfg["workload"], dtype=self.run_dtype,
                       backend="cuda", feeds={"b": self.fed_pool[j]},
                       **self.cfg["params"])

    def make_plan(self) -> None:
        """The router's first build of the bucket: trace, codesign,
        lower, the bucket's operator and its lane program."""
        from repro_torch.api import Session
        from repro_torch.serve import PlanRouter
        sess = Session(device=str(self.device), cache_dir=_cache_dir())
        self.router = PlanRouter(sess)
        entry = self.router.plan_for(self.request(0).bucket())
        self.outputs = list(entry.program.outputs)

    def _server(self, autostart: bool):
        from repro_torch.api.config import ServeConfig
        from repro_torch.serve import Server
        return Server(self.router, ServeConfig(
            max_batch_size=int(self.mix["max_batch_size"]),
            max_wait_us=float(self.mix["max_wait_us"]),
            autostart=autostart))

    def warm(self) -> None:
        """Every lane count the traffic can hit, each as one batch of that
        many requests (a server that starts once they are queued)."""
        for lanes in self.mix["warm_lanes"]:
            srv = self._server(autostart=False)
            futs = [srv.submit(self.request(j % len(self.pool)))
                    for j in range(int(lanes))]
            srv.start()
            for f in futs:
                f.result(timeout=600)
            srv.close()
        self.server = self._server(autostart=True)

    # -- windows ---------------------------------------------------------
    def window(self, seconds: float, keep: bool = True) -> _Window:
        """``clients`` requests kept outstanding by one thread: each that
        completes is stamped where its result is set and replaced by its
        client's next, until the window closes; then every request still
        out is waited for (late: not counted in the window)."""
        w = _Window()
        done: "queue.SimpleQueue[tuple]" = queue.SimpleQueue()
        out = 0

        def submit(c: int, j: int) -> None:
            t_sub = time.monotonic()
            fut = self.server.submit(self.request(j))
            # runs where the result is set: the moment it is ready
            fut.add_done_callback(lambda f: done.put(
                (f, c, j, t_sub, time.monotonic())))

        t0 = time.monotonic()
        t_end = t0 + seconds
        for c, j in enumerate(self.starts):
            submit(c, j)
            out += 1
        while out:
            try:
                fut, c, j, t_sub, t_done = done.get(timeout=seconds + 120)
            except queue.Empty:
                raise RuntimeError("no served request finished within two "
                                   "minutes") from None
            out -= 1
            w.attempted += 1
            try:
                res = fut.result()
            except Exception:   # noqa: BLE001 — counted as failed
                w.failed += 1
            else:
                if t_done <= t_end:
                    w.completed += 1
                    w.latencies_s.append(t_done - t_sub)
                if keep:
                    self._offer(j, res)
                del res
            if time.monotonic() < t_end:
                submit(c, (j + 1) % len(self.pool))
                out += 1
        w.seconds = t_end - t0
        return w

    def _offer(self, j: int, res) -> None:
        """A reservoir sample of the answers, drawn from the seed in the
        order the answers arrive."""
        k = int(self.mix["sample"])
        self._seen += 1
        slot = (len(self.sample) if len(self.sample) < k
                else self.rng.randrange(self._seen))
        if slot >= k:
            return
        x = res.outputs[self.outputs[0]].clone()
        r = res.outputs[self.outputs[1]].clone()
        if self.device.type == "cuda":
            # the copies finish before the batch's buffers can go back to
            # the worker's stream
            torch.cuda.current_stream().synchronize()
        if slot == len(self.sample):
            self.sample.append((j, x, r))
        else:
            self.sample[slot] = (j, x, r)

    def answers(self):
        # a request without x0 starts from the workload's zero start
        x0 = torch.zeros(self.n, dtype=self.dtype)
        return [(torch.from_numpy(self.pool[j]), x0, x, r)
                for j, x, r in self.sample]

    def reference_operand(self):
        """The bucket's operator rebuilt by the operand module's ``served``
        (the router builds its own; the reference takes nothing of it)."""
        pat = self.spec.operands(self.cfg["operand"])
        return pat.served(self.cfg, self.device, self.dtype)

    def release(self) -> None:
        if self.server is not None:
            self.server.close()
        self.server = self.router = None


KINDS = {"solve": SolveTraffic, "serve": ServeTraffic}


def traffic_for(spec, cfg: dict, mix: dict, seed: int, device,
                run_dtype: Optional[str] = None):
    return KINDS[mix["kind"]](spec, cfg, mix, seed, device, run_dtype)
