"""Chaos suite for the port's serving stack (``tests/test_robustness.py``
on ``repro_torch.serve``).

Drives every failure-handling layer end to end with the port's
deterministic fault-injection harness (``repro_torch.testing.faults``),
``backend="cuda"`` where the JAX suite used ``pallas``:

(a) a bucket whose ``cuda`` compile always fails serves the reference
    backend's answers through the fallback (the same reference batched
    program, so bitwise equal), with its breaker open and the transition
    visible in ``stats()``;
(b) under sustained overload with ``reject`` — capacity pinned by a slow
    ``serve.dispatch`` — every request ends in a typed outcome (served,
    ``Overloaded`` at submit, or ``DeadlineExceeded``), the queue depth
    stays within ``max_queue`` and no future hangs.  Unlike the JAX suite
    it asserts no wall-clock latency ratio, which does not hold under a
    loaded test machine;
(c) a worker crash mid-batch fails exactly the in-flight futures and
    later submits succeed after a supervised restart;
(d) a lane kernel that does not build or launch fails the batch's
    futures with ``KernelError``: no retry, no fallback, the breaker
    untouched.

The JAX suite's ``TestCacheCorruption`` has its twin in
``tests/test_torch_cache.py``.
"""
import contextlib
import threading
import time

import numpy as np
import pytest
import torch

from repro_torch import obs
from repro_torch.api import ServeConfig, Session
from repro_torch.serve import (CircuitBreaker, CircuitOpen, DeadlineExceeded,
                               Overloaded, PlanRouter, RetryPolicy, Server,
                               ServerClosed, WorkerCrashed, request)
from repro_torch.testing import faults


@pytest.fixture(autouse=True)
def _clean_rules():
    faults.clear()
    yield
    faults.clear()


def _server(**cfg):
    return Server(PlanRouter(Session(device="cpu")), ServeConfig(**cfg))


def _reconciles(st):
    served = sum(size * cnt for b in st["buckets"].values()
                 for size, cnt in b["batch_sizes"].items())
    return st["requests"] == (st["queue_depth"] + st["in_flight"]
                              + st["errors"] + served)


# ---------------------------------------------------------------------------
# resilience primitives
# ---------------------------------------------------------------------------

class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


class TestCircuitBreaker:
    def test_opens_after_threshold_consecutive_failures(self):
        br = CircuitBreaker(failure_threshold=3, reset_timeout_s=10.0)
        br.record_failure()
        br.record_failure()
        br.record_success()
        br.record_failure()
        br.record_failure()
        assert br.state == "closed" and br.allow()
        br.record_failure()
        assert br.state == "open" and not br.allow()

    def test_half_open_probe_success_closes(self):
        clk = _Clock()
        br = CircuitBreaker(2, reset_timeout_s=5.0, clock=clk)
        br.record_failure()
        br.record_failure()
        assert not br.allow()
        clk.t = 5.0
        assert br.allow()
        assert br.state == "half_open"
        assert not br.allow()
        br.record_success()
        assert br.state == "closed" and br.allow()

    def test_half_open_probe_failure_reopens(self):
        clk = _Clock()
        br = CircuitBreaker(1, reset_timeout_s=1.0, clock=clk)
        br.record_failure()
        clk.t = 1.0
        assert br.allow()
        br.record_failure()
        assert br.state == "open" and not br.allow()
        clk.t = 1.5
        assert not br.allow()
        clk.t = 2.0
        assert br.allow()
        assert br.stats()["opens"] == 2

    def test_release_hands_the_half_open_probe_out_again(self):
        clk = _Clock()
        br = CircuitBreaker(1, reset_timeout_s=1.0, clock=clk)
        br.record_failure()
        clk.t = 1.0
        assert br.allow() and not br.allow()
        br.release()
        assert br.state == "half_open" and br.allow()
        assert br.stats()["opens"] == 1

    def test_transition_counter(self):
        c = obs.registry().counter("serve.breaker.transitions")
        labels = {"name": "t.bucket", "from": "closed", "to": "open",
                  "scope": "t"}
        before = c.value(**labels)
        br = CircuitBreaker(1, name="t.bucket", scope="t")
        br.record_failure()
        assert c.value(**labels) == before + 1


class TestRetryPolicy:
    def test_backoff_schedule(self):
        p = RetryPolicy(max_retries=4, backoff_s=0.1, multiplier=2.0,
                        max_backoff_s=0.3)
        assert [p.delay_s(k) for k in (1, 2, 3, 4)] == [0.1, 0.2, 0.3, 0.3]

    def test_validation(self):
        with pytest.raises(ValueError):
            RetryPolicy(max_retries=-1)
        with pytest.raises(ValueError):
            RetryPolicy(multiplier=0.5)
        with pytest.raises(ValueError):
            RetryPolicy().delay_s(0)


# ---------------------------------------------------------------------------
# (a) fallback chain: the cuda compile always fails -> reference serves
# ---------------------------------------------------------------------------

class TestFallbackChain:
    def test_broken_cuda_bucket_serves_exact_reference_answers(self):
        seeds = list(range(4))
        router = PlanRouter(Session(device="cpu"))

        def serve(backend, ctx):
            srv = Server(router, ServeConfig(
                max_batch_size=4, max_wait_us=500, autostart=False,
                breaker_failures=2,
                retry=RetryPolicy(max_retries=1, backoff_s=0.001)))
            with ctx:
                futs = [srv.submit(request("cg", n=32, iters=2, seed=s,
                                           backend=backend))
                        for s in seeds]
                srv.start()
                res = [f.result(timeout=120) for f in futs]
            st = srv.stats()
            srv.close()
            return res, st

        oracle, _ = serve("reference", contextlib.nullcontext())
        broken, st = serve("cuda",
                           faults.inject("exec.compile@cuda", kind="fail"))
        for o, b in zip(oracle, broken):
            assert b.degraded and b.backend == "reference"
            assert not o.degraded
            assert set(b.outputs) == set(o.outputs)
            for k in o.outputs:
                # the fallback runs the same reference batched program
                assert torch.equal(b.outputs[k], o.outputs[k]), k
        lb = [k for k in st["buckets"] if k.endswith("/cuda")][0]
        b = st["buckets"][lb]
        assert b["fallbacks"] == len(seeds)
        assert b["errors"] == 0
        assert b["retries"] >= 1
        assert _reconciles(st)

    def test_breaker_opens_and_is_visible_in_stats(self):
        srv = _server(max_batch_size=2, max_wait_us=200, breaker_failures=2,
                      breaker_reset_s=60.0)
        with faults.inject("exec.compile@cuda", kind="fail") as rule:
            for s in range(4):
                res = srv.solve(request("cg", n=32, iters=2, seed=s,
                                        backend="cuda"))
                assert res.degraded
        st = srv.stats()
        lb = [k for k in st["buckets"] if k.endswith("/cuda")][0]
        assert st["buckets"][lb]["breaker"] == "open"
        assert st["buckets"][lb]["breaker_opens"] == 1
        assert srv.health()["status"] == "degraded"
        assert srv.health()["breakers"][lb] == "open"
        srv.close()
        # with the breaker open the primary is not attempted
        assert rule.fired == 2

    def test_breaker_open_no_fallback_fails_typed(self):
        srv = _server(max_batch_size=1, max_wait_us=100, breaker_failures=1,
                      breaker_reset_s=60.0, fallback=None)
        with faults.inject("exec.compile@cuda", kind="fail"):
            with pytest.raises(faults.InjectedFault):
                srv.solve(request("cg", n=32, iters=2, backend="cuda"))
            with pytest.raises(CircuitOpen):
                srv.solve(request("cg", n=32, iters=2, seed=1,
                                  backend="cuda"))
        srv.close()

    def test_transient_failure_recovered_by_retry_not_fallback(self):
        srv = _server(max_batch_size=2, max_wait_us=200,
                      retry=RetryPolicy(max_retries=2, backoff_s=0.001))
        with faults.inject("serve.dispatch@cuda", kind="fail", times=1):
            res = srv.solve(request("cg", n=32, iters=2, backend="cuda"))
        assert not res.degraded and res.backend == "cuda"
        st = srv.stats()
        assert st["retries"] == 1 and st["fallbacks"] == 0
        assert st["errors"] == 0
        srv.close()


# ---------------------------------------------------------------------------
# (d) a lane kernel that does not build or launch raises
# ---------------------------------------------------------------------------

class TestKernelFailure:
    @pytest.mark.parametrize("what", ["build", "launch"])
    def test_kernel_failure_raises_and_never_falls_back(self, monkeypatch,
                                                       tmp_path, what):
        from repro_torch.kernels import build
        from repro_torch.kernels.stream import LaneStreamKernel
        # a real failing build (the compiler exits 1) or a launch that
        # reports a CUDA error, where the lane pass would run
        monkeypatch.setenv("CELLO_TORCH_BUILD_DIR", str(tmp_path))
        monkeypatch.setattr(build, "_lib", None)
        monkeypatch.setattr(build, "_nvcc", lambda: "false")

        def broken(self, env):
            if what == "build":
                build.cuda_library()
            build.check(700, "stream_lanes")

        monkeypatch.setattr(LaneStreamKernel, "plain", broken)
        srv = _server(max_batch_size=4, max_wait_us=500, autostart=False,
                      breaker_failures=1, breaker_reset_s=60.0,
                      retry=RetryPolicy(max_retries=2, backoff_s=0.001))
        futs = [srv.submit(request("cg", n=32, iters=2, seed=s,
                                   backend="cuda")) for s in range(3)]
        srv.start()
        for f in futs:
            with pytest.raises(build.KernelError):
                f.result(timeout=60)
        # the breaker did not open: the next batch tries the kernels again
        with pytest.raises(build.KernelError):
            srv.submit(request("cg", n=32, iters=2, seed=3,
                               backend="cuda")).result(timeout=60)
        st = srv.stats()
        lb = [k for k in st["buckets"] if k.endswith("/cuda")][0]
        b = st["buckets"][lb]
        assert b["fallbacks"] == 0 and b["retries"] == 0
        assert b["errors"] == 4 and b["breaker"] == "closed"
        assert _reconciles(st)
        srv.close()


# ---------------------------------------------------------------------------
# (b) overload: bounded queue, typed outcomes, no hung future
# ---------------------------------------------------------------------------

class TestOverload:
    def test_sustained_overload_with_reject_ends_every_request_typed(self):
        dispatch_s = 0.05
        srv = _server(max_batch_size=4, max_wait_us=500, max_queue=8,
                      overload="reject")
        srv.solve(request("cg", n=32, iters=2))          # warm the plan
        with faults.inject("serve.dispatch", kind="slow",
                           delay_s=dispatch_s):
            # open-loop arrivals at ~4x the pinned capacity (4 / 0.05 s)
            period = dispatch_s / (4 * srv.max_batch_size)
            futs, rejected, depths = [], 0, []
            t_end = time.monotonic() + 0.4
            while time.monotonic() < t_end:
                try:
                    futs.append(srv.submit(
                        request("cg", n=32, iters=2, seed=len(futs) % 17),
                        deadline_s=2.0))
                except Overloaded:
                    rejected += 1
                depths.append(srv.stats()["queue_depth"])
                time.sleep(period)
            served, expired = 0, 0
            for f in futs:
                try:
                    assert f.result(timeout=20).batch_size >= 1
                    served += 1
                except DeadlineExceeded:
                    expired += 1
        assert rejected > 0                       # overload happened
        assert served > 0                         # and service went on
        assert served + expired == len(futs)      # nothing else, no hang
        assert max(depths) <= srv.max_queue
        st = srv.stats()
        assert st["rejected"] == rejected
        assert st["deadline_missed"] == expired
        assert _reconciles(st)
        srv.close()

    def test_shed_oldest_fails_head_serves_tail(self):
        srv = _server(max_batch_size=4, max_wait_us=500, max_queue=2,
                      overload="shed_oldest", autostart=False)
        f1 = srv.submit(request("cg", n=32, iters=2, seed=1))
        f2 = srv.submit(request("cg", n=32, iters=2, seed=2))
        f3 = srv.submit(request("cg", n=32, iters=2, seed=3))
        with pytest.raises(Overloaded, match="shed"):
            f1.result(timeout=5)
        srv.start()
        assert f2.result(timeout=60).batch_size == 2
        assert f3.result(timeout=60).batch_size == 2
        st = srv.stats()
        assert st["shed"] == 1 and _reconciles(st)
        srv.close()

    def test_block_policy_waits_for_space(self):
        srv = _server(max_batch_size=1, max_wait_us=100, max_queue=1,
                      overload="block", autostart=False)
        f1 = srv.submit(request("cg", n=32, iters=2, seed=1))
        blocked = {}

        def submitter():
            blocked["fut"] = srv.submit(request("cg", n=32, iters=2,
                                                seed=2))

        t = threading.Thread(target=submitter)
        t.start()
        t.join(timeout=0.2)
        assert t.is_alive()
        srv.start()
        t.join(timeout=60)
        assert not t.is_alive()
        assert f1.result(timeout=60).batch_size == 1
        assert blocked["fut"].result(timeout=60).batch_size == 1
        srv.close()

    def test_block_policy_honours_deadline(self):
        srv = _server(max_batch_size=1, max_wait_us=100, max_queue=1,
                      overload="block", autostart=False)
        srv.submit(request("cg", n=32, iters=2, seed=1))
        t0 = time.monotonic()
        with pytest.raises(DeadlineExceeded, match="admission"):
            srv.submit(request("cg", n=32, iters=2, seed=2), deadline_s=0.1)
        assert time.monotonic() - t0 < 5.0
        srv.close(flush=False)


# ---------------------------------------------------------------------------
# deadlines
# ---------------------------------------------------------------------------

class TestDeadlines:
    def test_deadline_caps_coalescing_wait(self):
        srv = _server(max_batch_size=16, max_wait_us=10_000_000)
        t0 = time.monotonic()
        res = srv.submit(request("cg", n=32, iters=2),
                         deadline_s=1.0).result(timeout=30)
        assert res.batch_size == 1
        assert time.monotonic() - t0 < 5.0
        assert srv.stats()["deadline_missed"] == 0
        srv.close()

    def test_expiry_fails_only_the_affected_future(self):
        srv = _server(max_batch_size=1, max_wait_us=100)
        srv.solve(request("cg", n=32, iters=2))
        srv.solve(request("cg", n=48, iters=2))
        with faults.inject("serve.dispatch", kind="slow", delay_s=0.5,
                           times=1):
            f_busy = srv.submit(request("cg", n=32, iters=2, seed=1))
            time.sleep(0.05)
            f_live = srv.submit(request("cg", n=48, iters=2, seed=2))
            f_dead = srv.submit(request("cg", n=48, iters=2, seed=3),
                                deadline_s=0.1)
            with pytest.raises(DeadlineExceeded):
                f_dead.result(timeout=30)
            assert f_busy.result(timeout=30).batch_size == 1
            assert f_live.result(timeout=30).batch_size == 1
        st = srv.stats()
        assert st["deadline_missed"] == 1
        assert st["errors"] == 1 and _reconciles(st)
        srv.close()

    def test_submit_validates_deadline(self):
        srv = _server(autostart=False)
        with pytest.raises(ValueError, match="deadline_s"):
            srv.submit(request("cg", n=32, iters=2), deadline_s=0.0)
        srv.close()


# ---------------------------------------------------------------------------
# (c) worker supervision
# ---------------------------------------------------------------------------

class TestWorkerSupervision:
    def test_crash_fails_exactly_in_flight_then_recovers(self):
        srv = _server(max_batch_size=4, max_wait_us=500, autostart=False,
                      max_worker_restarts=2)
        doomed = [srv.submit(request("cg", n=32, iters=2, seed=s,
                                     backend="cuda")) for s in range(4)]
        queued = [srv.submit(request("cg", n=48, iters=2, seed=s,
                                     backend="cuda")) for s in range(2)]
        with faults.inject("serve.worker", kind="fail", times=1):
            srv.start()
            for f in doomed:
                with pytest.raises(WorkerCrashed):
                    f.result(timeout=60)
            for f in queued:
                assert f.result(timeout=60).batch_size == 2
        res = srv.submit(request("cg", n=32, iters=2, seed=9,
                                 backend="cuda")).result(timeout=60)
        assert res.batch_size == 1 and np.isfinite(res.residual)
        h = srv.health()
        assert h["status"] == "degraded" and h["worker_restarts"] == 1
        st = srv.stats()
        assert st["errors"] == len(doomed)
        assert st["worker_restarts"] == 1
        assert _reconciles(st)
        srv.close()

    def test_restart_exhaustion_goes_down_and_fails_fast(self):
        srv = _server(max_batch_size=1, max_wait_us=100,
                      max_worker_restarts=0, autostart=False)
        f1 = srv.submit(request("cg", n=32, iters=2, seed=1))
        f2 = srv.submit(request("cg", n=32, iters=2, seed=2))
        with faults.inject("serve.worker", kind="fail"):
            srv.start()
            with pytest.raises(WorkerCrashed):
                f1.result(timeout=60)
            with pytest.raises(WorkerCrashed):
                f2.result(timeout=60)
        assert srv.health()["status"] == "down"
        with pytest.raises(ServerClosed, match="down"):
            srv.submit(request("cg", n=32, iters=2, seed=3))
        st = srv.stats()
        assert st["errors"] == 2 and _reconciles(st)
        srv.close()


class TestSupervisionInternals:
    def test_crash_after_accounting_does_not_double_count(self):
        from concurrent.futures import Future

        from repro_torch.serve.server import _InFlightBatch, _Item
        srv = _server(autostart=False)
        req = request("cg", n=32, iters=2)
        key = srv.router.bucket(req)
        fut = Future()
        srv._current = _InFlightBatch(key, [_Item(req, fut,
                                                  time.monotonic())],
                                      accounted=True)
        srv._on_worker_crash(RuntimeError("boom"))
        with pytest.raises(WorkerCrashed):
            fut.result(timeout=1)
        st = srv.stats()
        assert st["errors"] == 0
        assert st["worker_restarts"] == 1
        srv.close()

    def test_health_degraded_not_down_during_restart_window(self):
        srv = _server()
        assert srv.health()["status"] == "ok"
        with srv._cv:
            real = srv._worker
            srv._worker = threading.Thread(target=lambda: None, daemon=True)
            srv._worker_restarts = 1
        h = srv.health()
        assert h["status"] == "degraded" and not h["worker_alive"]
        with srv._cv:
            srv._worker = real
            srv._worker_restarts = 0
        assert srv.health()["status"] == "ok"
        srv.close()

    def test_close_bounded_when_replacement_never_starts(self):
        srv = _server()
        with srv._cv:
            srv._worker = threading.Thread(target=lambda: None, daemon=True)
        t0 = time.monotonic()
        srv.close()
        assert time.monotonic() - t0 < 5.0
