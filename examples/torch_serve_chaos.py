"""Chaos demo on the port: the serving stack absorbing injected failures,
end to end.

The PyTorch/CUDA twin of ``examples/serve_chaos.py``: the same flags,
incidents, injected faults and printed lines.  Drives one
:class:`repro_torch.serve.Server` through three incidents using the
deterministic fault-injection harness (``repro_torch.testing.faults``,
``docs/robustness.md``) and prints what the failure-handling layer did
about each:

1. **Broken backend** — every compile of the kernel backend (``cuda``,
   the port's twin of ``pallas``) fails: the per-bucket retry policy
   runs, the circuit breaker opens, and every request is still answered
   *exactly* via the reference fallback (the reference interpreter is the
   bitwise oracle, so degraded mode loses speed, not precision).  The
   fault fires before any kernel is built, so no kernel runs here.
2. **Overload** — open-loop arrivals at several times capacity against a
   bounded queue with ``overload="reject"``: excess load fails fast and
   typed, served latency stays bounded.
3. **Worker crash** — the worker thread dies mid-batch: in-flight
   futures fail with :class:`~repro_torch.serve.WorkerCrashed`, the
   supervisor restarts the worker, and the very next submit succeeds.

Incidents 2 and 3 send requests with the request's default backend,
``reference``, as the JAX example does.

Faults can also be armed without touching code via the environment::

    CELLO_FAULTS='exec.compile@cuda=fail:x2' python examples/torch_serve_chaos.py

    PYTHONPATH=src python examples/torch_serve_chaos.py --n 64 --iters 2

``--device cuda`` (the default) raises without a card; ``--device cpu``
serves on the CPU.  ``main(argv)`` returns what it printed as data, with
each request's outcome.
"""
from __future__ import annotations

import argparse
import time

from repro_torch.api import Session
from repro_torch.serve import (Overloaded, PlanRouter, RetryPolicy,
                               ServeConfig, Server, WorkerCrashed, request)
from repro_torch.testing import faults


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--n", type=int, default=64, help="operator size "
                    "(perfect square: the cg_sparse grid needs one)")
    ap.add_argument("--iters", type=int, default=2,
                    help="unrolled CG iterations")
    ap.add_argument("--requests", type=int, default=8,
                    help="requests per incident")
    ap.add_argument("--device", default="cuda",
                    help="the serving session's device: cuda (raises "
                         "without a card) or cpu")
    args = ap.parse_args(argv)

    srv = Server(PlanRouter(Session(device=args.device)), ServeConfig(
        max_batch_size=4, max_wait_us=500.0,
        max_queue=8, overload="reject",
        retry=RetryPolicy(max_retries=1, backoff_s=0.001),
        fallback="reference", breaker_failures=2))
    out = {}

    # -- incident 1: the kernel backend cannot compile ------------------
    print("# incident 1: cuda compile fails -> reference fallback")
    first = []
    with faults.inject("exec.compile@cuda", kind="fail"):
        for seed in range(args.requests):
            res = srv.solve(request("cg", n=args.n, iters=args.iters,
                                    seed=seed, backend="cuda"))
            assert res.degraded and res.backend == "reference"
            first.append(dict(degraded=res.degraded, backend=res.backend,
                              residual=res.residual))
    st = srv.stats()
    lb = next(k for k in st["buckets"] if "/cuda" in k)
    health1 = srv.health()["status"]
    print(f"  served={args.requests} degraded, fallbacks="
          f"{st['fallbacks']}, retries={st['retries']}, "
          f"breaker[{lb}]={st['buckets'][lb]['breaker']}")
    print(f"  health: {health1}")
    out["incident1"] = dict(requests=first, fallbacks=st["fallbacks"],
                            retries=st["retries"],
                            breaker=st["buckets"][lb]["breaker"],
                            health=health1)

    # -- incident 2: sustained overload against a bounded queue --------
    print("# incident 2: overload with a bounded queue (reject)")
    srv.solve(request("cg", n=args.n, iters=args.iters))    # warm plan
    futs, rejected = [], 0
    with faults.inject("serve.dispatch", kind="slow", delay_s=0.02):
        for seed in range(6 * args.requests):
            try:
                futs.append(srv.submit(
                    request("cg", n=args.n, iters=args.iters,
                            seed=seed % 7),
                    deadline_s=5.0))
            except Overloaded:
                rejected += 1
            time.sleep(0.001)
        served = [f.result(timeout=60) for f in futs]
    assert rejected > 0 and served
    depth = srv.stats()["queue_depth"]
    print(f"  offered={6 * args.requests} served={len(served)} "
          f"rejected fast+typed={rejected} "
          f"queue_depth={depth}")
    out["incident2"] = dict(offered=6 * args.requests, served=len(served),
                            rejected=rejected, queue_depth=depth)

    # -- incident 3: the worker thread crashes mid-batch ----------------
    print("# incident 3: worker crash -> supervised restart")
    with faults.inject("serve.worker", kind="fail", times=1):
        fut = srv.submit(request("cg", n=args.n, iters=args.iters,
                                 seed=99))
        try:
            fut.result(timeout=60)
            raise AssertionError("expected WorkerCrashed")
        except WorkerCrashed as e:
            crashed = type(e).__name__
            print(f"  in-flight future failed typed: {crashed}")
    res = srv.solve(request("cg", n=args.n, iters=args.iters, seed=100))
    h = srv.health()
    print(f"  next solve served (batch={res.batch_size}), health="
          f"{h['status']}, worker_restarts={h['worker_restarts']}")
    out["incident3"] = dict(crashed=crashed, batch_size=res.batch_size,
                            health=h["status"],
                            worker_restarts=h["worker_restarts"])

    srv.close()
    print("chaos absorbed: fallback exact, overload typed, crash "
          "supervised")
    return out


if __name__ == "__main__":
    main()
