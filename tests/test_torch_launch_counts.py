"""Launch counts per call: ``kernels.count`` / ``kernels.counting`` and
``CudaProgram.stats`` under threads.

Every kernel wrapper calls ``kernels.count(name)`` once per launch.  It adds
one to the process-wide ``LAUNCHES`` (under a lock) and to every counter the
calling thread has open (``kernels.counting()``).  ``CudaProgram`` runs
each ``run()`` inside its own counter, so a program's ``stats`` hold its own
runs and launches, whatever other threads launch at the same time (the
counterpart of the JAX package's per-program dispatch scope,
``repro/exec/pallas.py:882-888``).

Here on the CPU the wrappers run their plain versions and launch nothing,
so the program tests patch each execution unit to call ``count`` before it
runs, as a wrapper does on the card.  The ``gpu`` test runs two real plans
on two threads when a card is present.
"""
import threading
import time

import pytest
import torch

import repro_torch.api as pt_api
import repro_torch.frontends as pt_fe
from repro_torch import kernels

#: small plans of two workloads, each with its own mix of units
PLANS = (("cg", dict(n=64, iters=4)), ("jacobi2d", dict(n=16, sweeps=3)))


def test_counting_sees_only_the_calling_threads_launches():
    """Two threads count into their own scopes, interleaved step by step at
    a barrier; each scope holds its own thread's launches and the
    process-wide counts the sum."""
    steps = 50
    plan = {0: ["spmv", "stream"], 1: ["wkv6", "stream", "stream"]}
    barrier = threading.Barrier(2)
    seen, errors = {}, []

    def work(who):
        try:
            with kernels.counting() as mine:
                for _ in range(steps):
                    barrier.wait()
                    for name in plan[who]:
                        kernels.count(name)
                seen[who] = dict(mine)
        except BaseException as exc:
            errors.append(exc)
            barrier.abort()

    before = kernels.launches()
    threads = [threading.Thread(target=work, args=(w,)) for w in plan]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    assert not errors, errors
    after = kernels.launches()
    for who, names in plan.items():
        want = dict.fromkeys(kernels.LAUNCHES, 0)
        for name in names:
            want[name] += steps
        assert seen[who] == want
    assert {k: after[k] - before[k] for k in after} == {
        k: seen[0][k] + seen[1][k] for k in after}


def test_counting_scopes_nest_and_close():
    with kernels.counting() as outer:
        kernels.count("rmsnorm")
        with kernels.counting() as inner:
            kernels.count("rmsnorm")
            kernels.count("fused_mlp")
        kernels.count("fused_mlp")
    kernels.count("rmsnorm")                  # no scope open: neither sees it
    assert inner["rmsnorm"] == 1 and inner["fused_mlp"] == 1
    assert outer["rmsnorm"] == 2 and outer["fused_mlp"] == 2
    with pytest.raises(KeyError):
        kernels.count("no such kernel")


def _program(workload, params, kernel_name):
    """A fresh ``CudaProgram`` of a small CPU plan whose every unit counts one
    launch of ``kernel_name`` (yielding the GIL once) before it runs, and
    its feeds."""
    from repro_torch.exec.cuda import CudaProgram
    traced = pt_api.Session(device="cpu").trace(workload=workload, **params)
    plan = traced.analyze().codesign().lower(backend="cuda")
    prog = CudaProgram(plan)

    def counted(unit):
        def call(env):
            kernels.count(kernel_name)
            time.sleep(0)                     # let the other thread in
            return unit(env)
        return call
    for units in (prog._pro, prog._tmpl, prog._epi):
        units[:] = [counted(u) for u in units]
    feeds = pt_fe.feeds_from_numpy(pt_fe.make_feeds(traced.program, seed=3))
    return prog, feeds


def test_cuda_program_stats_count_their_own_runs_under_two_threads():
    """Two programs, each run ``reps`` times on its own thread at once: each
    one's ``stats`` equal ``reps`` lone runs', and its outputs its lone
    run's."""
    reps = 6
    progs = [_program(w, p, name) for (w, p), name in
             zip(PLANS, ("spmv", "stencil2d"))]
    alone = []
    for prog, feeds in progs:
        out = prog(feeds)
        alone.append((prog.stats, out))
        assert prog.stats["runs"] == 1
        assert sum(prog.stats["launches"].values()) > 0
    fresh = [_program(w, p, name) for (w, p), name in
             zip(PLANS, ("spmv", "stencil2d"))]
    barrier = threading.Barrier(len(fresh))
    outs, errors = {}, []

    def work(i):
        prog, feeds = fresh[i]
        try:
            barrier.wait()
            outs[i] = [prog(feeds) for _ in range(reps)]
        except BaseException as exc:
            errors.append(exc)
            barrier.abort()

    before = kernels.launches()
    threads = [threading.Thread(target=work, args=(i,))
               for i in range(len(fresh))]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    assert not errors, errors
    after = kernels.launches()
    for i, (prog, _feeds) in enumerate(fresh):
        stats_alone, out_alone = alone[i]
        assert prog.stats == {
            "runs": reps, "traces": 1, "dispatches": reps,
            "launches": {k: reps * v for k, v in
                         stats_alone["launches"].items()}}
        for out in outs[i]:
            assert out.keys() == out_alone.keys()
            assert all(torch.equal(out[k], out_alone[k]) for k in out)
    assert {k: after[k] - before[k] for k in after} == {
        k: sum(prog.stats["launches"][k] for prog, _ in fresh)
        for k in after}


def test_a_failed_run_counts_nothing():
    prog, feeds = _program(*PLANS[0], "spmv")
    with pytest.raises(KeyError, match="feeds missing leaf"):
        prog({})
    assert prog.stats == {"runs": 0, "traces": 0, "dispatches": 0,
                          "launches": dict.fromkeys(kernels.LAUNCHES, 0)}
    prog(feeds)
    assert prog.stats["runs"] == 1


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
def test_two_real_plans_on_two_threads_on_the_card(cuda_device):
    """cg and jacobi2d lowered to ``cuda`` and run at once on two threads,
    each on its own stream: each program's stats grow as its lone runs'
    do, and its outputs equal its lone run's bitwise."""
    reps = 3
    jobs = []
    for workload, params in PLANS:
        traced = pt_api.Session(device="cuda").trace(workload=workload,
                                                     **params)
        plan = traced.analyze().codesign().lower(backend="cuda")
        feeds = pt_fe.feeds_from_numpy(pt_fe.make_feeds(traced.program,
                                                        seed=3), "cuda")
        prog = plan.compiled()
        before = prog.stats
        alone = plan.run(feeds)
        torch.cuda.synchronize()
        one = {k: prog.stats["launches"][k] - before["launches"][k]
               for k in before["launches"]}
        assert sum(one.values()) > 0
        jobs.append(dict(plan=plan, prog=prog, feeds=feeds, alone=alone,
                         one=one, start=prog.stats))
    barrier = threading.Barrier(len(jobs))
    errors = []

    def work(job):
        try:
            stream = torch.cuda.Stream()
            with torch.cuda.stream(stream):
                barrier.wait()
                job["outs"] = [job["plan"].run(job["feeds"])
                               for _ in range(reps)]
                stream.synchronize()
        except BaseException as exc:
            errors.append(exc)
            barrier.abort()

    threads = [threading.Thread(target=work, args=(job,)) for job in jobs]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    torch.cuda.synchronize()
    assert not errors, errors
    for job in jobs:
        stats = job["prog"].stats
        assert stats["runs"] - job["start"]["runs"] == reps
        assert {k: stats["launches"][k] - job["start"]["launches"][k]
                for k in stats["launches"]} == {
            k: reps * v for k, v in job["one"].items()}
        for out in job["outs"]:
            assert all(torch.equal(out[k], job["alone"][k]) for k in out)
