"""Serve a batch of CG solves through ``repro_torch.serve``, end to end.

The PyTorch/CUDA twin of ``examples/serve_cg.py``: the same flags and
printed lines.  Spins up a :class:`repro_torch.serve.Server`, submits a
burst of mixed-bucket requests (dense ``cg`` + CSR-sparse ``cg_sparse``,
each with its own right-hand side), and shows the serving pipeline at
work: the router canonicalizes requests into bucket keys, a bounded LRU
keeps one lane-batched :class:`~repro_torch.serve.BatchedPlan` resident
per bucket, and the worker coalesces same-bucket requests so each batch
is answered in **one device dispatch** — which ``stats()`` then proves.

    PYTHONPATH=src python examples/torch_serve_cg.py --n 256 --requests 32 --max-batch 16

``--backend cuda`` (the default) answers each batch with one CUDA-graph
replay of the lane forms of B1 (dense passes) and B2 (CSR SpMV);
``reference`` runs the torch interpreter.  ``--device cuda`` (the
default) raises without a card; ``--device cpu`` runs the kernels' plain
torch versions.  ``main(argv)`` returns what it printed as data.
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.api import Session
from repro_torch.serve import PlanRouter, ServeConfig, Server, request


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--n", type=int, default=256, help="operator size")
    ap.add_argument("--iters", type=int, default=4,
                    help="unrolled CG iterations")
    ap.add_argument("--requests", type=int, default=32,
                    help="requests per workload")
    ap.add_argument("--max-batch", type=int, default=16,
                    help="coalesce up to this many same-bucket requests")
    ap.add_argument("--max-wait-us", type=float, default=2000.0,
                    help="close a batch after its head waited this long")
    ap.add_argument("--backend", default="cuda",
                    help="execution backend (cuda | reference)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels; raises without a card) or cpu "
                         "(their plain torch versions)")
    args = ap.parse_args(argv)

    # autostart=False + submit-all + start(): every request is queued
    # before the first batch closes, so coalescing is deterministic —
    # ceil(requests / max_batch) batches per bucket
    srv = Server(PlanRouter(Session(device=args.device)),
                 ServeConfig(max_batch_size=args.max_batch,
                             max_wait_us=args.max_wait_us,
                             autostart=False))
    futs = []
    for seed in range(args.requests):
        futs.append(srv.submit(request(
            "cg", n=args.n, iters=args.iters, seed=seed,
            backend=args.backend)))
        futs.append(srv.submit(request(
            "cg_sparse", n=args.n, iters=args.iters, seed=seed,
            backend=args.backend)))
    # an explicit right-hand side rides along as a feeds overlay (input
    # leaves only — the operator is the bucket's shared one)
    futs.append(srv.submit(request(
        "cg", n=args.n, iters=args.iters, backend=args.backend,
        feeds={"b": np.ones(args.n, np.float32)})))

    srv.start()
    results = [f.result() for f in futs]
    srv.close()

    for res in results[:3] + results[-1:]:
        print(f"{res.bucket:60s} batch={res.batch_size:2d} "
              f"latency={res.latency_s * 1e3:7.2f}ms "
              f"residual={res.residual:.3g}")
    print(f"... {len(results)} results total\n")

    st = srv.stats()
    print(f"requests={st['requests']} batches={st['batches']} "
          f"plans_cached={st['plans_cached']}")
    for label, b in st["buckets"].items():
        print(f"  {label}")
        print(f"    requests={b['requests']} batches={b['batches']} "
              f"sizes={b['batch_sizes']} cache={b['cache_hits']}h/"
              f"{b['cache_misses']}m")
        # the serving guarantee: every coalesced batch was ONE dispatch
        assert b["dispatches"] == b["batches"], (b["dispatches"],
                                                 b["batches"])
    print("one dispatch per coalesced batch: verified")
    return {"results": [dict(bucket=r.bucket, batch_size=r.batch_size,
                             latency_s=r.latency_s, residual=r.residual,
                             backend=r.backend, degraded=r.degraded,
                             outputs={k: v.cpu().numpy()
                                      for k, v in r.outputs.items()})
                        for r in results],
            "stats": st}


if __name__ == "__main__":
    main()
