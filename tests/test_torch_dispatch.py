"""One dispatch per ``run()``: the ``cuda`` backend's ``stats`` contract
on the CPU, in the manner of the JAX package's single program
(``tests/test_exec.py::TestSingleProgram``), and the ``cuda-perunit``
backend against ``pallas-perunit``.

On the CPU no graph exists, so a run walks the units eagerly; the same
signature cache and counters hold as on the card: ``stats`` start at 0
traces and 0 dispatches, ``dispatches == runs`` after every run,
``traces`` is 1 per signature (float dtype and every leaf's shape and
dtype), and the outputs equal the eager walk's bitwise.  The JAX side's
``pallas`` and ``pallas-perunit`` backends run their Pallas kernels in
interpret mode; cross-package tolerances are ``tests/test_torch_exec.py``'s
(fp32 rtol 2e-4 / atol 1e-5).
"""
import numpy as np
import pytest
import torch

import repro.api as jx_api
import repro.frontends as jx_fe
import repro_torch.api as pt_api
import repro_torch.frontends as pt_fe
from repro_torch import kernels, obs
from repro_torch.core.lowering import flatten_units
from repro_torch.exec import get_backend, list_backends

TOL = dict(rtol=2e-4, atol=1e-5)

DISPATCH_SET = [
    ("cg", dict(n=64, iters=3)),
    ("bicgstab", dict(n=64, iters=3)),
    ("jacobi2d", dict(n=16, sweeps=3)),
    ("power_iteration", dict(n=64, iters=3)),
]
IDS = [w for w, _ in DISPATCH_SET]


def _plan(workload, params):
    traced = pt_api.Session(device="cpu").trace(workload=workload, **params)
    return traced, traced.analyze().codesign().lower()


def _feeds(program, seed, dtype=np.float32):
    return pt_fe.feeds_from_numpy(pt_fe.make_feeds(program, seed=seed,
                                                   dtype=dtype))


@pytest.mark.parametrize("workload,params", DISPATCH_SET, ids=IDS)
def test_exactly_one_dispatch_per_run(workload, params):
    traced, plan = _plan(workload, params)
    prog = get_backend("cuda").compile(plan)
    assert prog.stats == {"runs": 0, "traces": 0, "dispatches": 0,
                          "launches": dict.fromkeys(kernels.LAUNCHES, 0)}
    for runs in (1, 2, 3):
        out = prog(_feeds(traced.program, seed=runs))
        assert prog.stats["dispatches"] == prog.stats["runs"] == runs
        assert prog.stats["traces"] == 1
        walked = prog.walk(_feeds(traced.program, seed=runs))
        assert out.keys() == walked.keys()
        for k in out:
            assert torch.equal(out[k], walked[k]), k
    # on CPU tensors every wrapper runs its plain version: no launches
    assert not any(prog.stats["launches"].values())


@pytest.mark.parametrize("workload,params", DISPATCH_SET, ids=IDS)
def test_a_second_dtype_makes_a_second_trace(workload, params):
    traced, plan = _plan(workload, params)
    prog = get_backend("cuda").compile(plan)
    f32, f64 = (_feeds(traced.program, 0, dt)
                for dt in (np.float32, np.float64))
    out32 = prog(f32)
    out64 = prog(f64)
    prog(f32)
    prog(f64)
    assert prog.stats["traces"] == 2
    assert prog.stats["dispatches"] == prog.stats["runs"] == 4
    assert all(v.dtype == torch.float32 for v in out32.values())
    assert all(v.dtype == torch.float64 for v in out64.values())


@pytest.mark.parametrize("workload,params", DISPATCH_SET, ids=IDS)
def test_stats_match_the_jax_single_program(workload, params):
    """The JAX package's contract and the port's, side by side on the same
    feeds: equal traces and dispatches after the same runs, outputs within
    the cross-package tolerance."""
    jx = jx_api.Session(use_cache=False).trace(workload=workload, **params)
    jx_prog = jx_api.get_backend("pallas").compile(
        jx.analyze().codesign().lower())
    traced, plan = _plan(workload, params)
    prog = get_backend("cuda").compile(plan)
    np_feeds = jx_fe.make_feeds(jx.program, seed=4)
    for _ in range(2):
        want = jx_prog(np_feeds)
        got = prog(pt_fe.feeds_from_numpy(np_feeds))
    assert {k: prog.stats[k] for k in ("traces", "dispatches")} == \
        jx_prog.stats == {"traces": 1, "dispatches": 2}
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   **TOL, err_msg=k)


def test_run_uses_one_memoized_program():
    """``CompiledPlan.run`` memoizes one program per plan: two runs share
    it and dispatch it twice, tracing once."""
    traced, plan = _plan("power_iteration", dict(n=64, iters=3))
    plan.run(_feeds(traced.program, 1))
    plan.run(_feeds(traced.program, 2))
    prog = plan.compiled()
    assert prog is get_backend("cuda").compiled(plan)
    assert prog.stats["dispatches"] == 2 and prog.stats["traces"] == 1


def test_counters_live_under_the_programs_scope():
    traced, plan = _plan("cg", dict(n=64, iters=3))
    a = get_backend("cuda").compile(plan)
    b = get_backend("cuda").compile(plan)
    a(_feeds(traced.program, 0))
    assert a._scope != b._scope
    assert b.stats["dispatches"] == 0 and a.stats["dispatches"] == 1
    snap = obs.registry().snapshot(a._scope)
    units = {c["labels"]["kind"]: c["value"]
             for c in snap["exec.units"]["cells"]}
    ep = plan.exec_plan
    n_built = (ep.roll.first + ep.roll.per_iter
               + len(ep.units) - ep.roll.stop) if ep.roll else len(ep.units)
    assert sum(units.values()) == n_built
    assert snap["exec.dispatches"]["cells"][0]["value"] == 1.0
    assert snap["exec.traces"]["cells"][0]["value"] == 1.0


SPARSE_SET = [
    ("cg_sparse", dict(n=1024, iters=6, pattern="laplacian5")),
    ("bicgstab_sparse", dict(n=1024, iters=6, pattern="random",
                             density=27 / 1024)),
]


@pytest.mark.parametrize("workload,params", SPARSE_SET,
                         ids=[w for w, _ in SPARSE_SET])
def test_stream_bytes_count_every_b1_launch_of_a_run(workload, params):
    """``exec.stream_bytes`` grows by the pass table's total at each run:
    every pass's least bytes a launch times its launches a run.  For cg,
    counted by hand from the shapes: a rolled iteration streams 11
    vectors (r and ``A p`` in, r out; r and p in, p out; p, ``A p``, the
    previous p and x in, x out), 9 scalars in and out (4, 1 and 4 in its
    three passes) and each of its two reductions' partials written and
    read once."""
    traced, plan = _plan(workload, params)
    prog = get_backend("cuda").compile(plan)
    assert prog.passes() == []
    streamed = obs.registry().counter("exec.stream_bytes")
    for runs in (1, 2, 3):
        prog(_feeds(traced.program, seed=runs, dtype=np.float64))
        rows = prog.passes()
        total = sum(r["bytes"] * r["launches"] for r in rows)
        assert streamed.value(backend="cuda", scope=prog._scope) == \
            runs * total
    prog(_feeds(traced.program, seed=4, dtype=np.float32))
    half = prog.passes()
    assert [2 * r["bytes"] for r in half] == [r["bytes"] for r in rows]
    assert streamed.value(backend="cuda", scope=prog._scope) == \
        3.5 * total
    # the table counts the launches the walk made: the rolled loop's
    # template passes once an iteration, every other pass once
    roll = plan.exec_plan.roll
    loop = [r for r in rows if r["launches"] == roll.n_iters]
    assert loop and {r["unit"] for r in loop} == set(range(
        roll.first, roll.first + roll.per_iter))
    assert all(r["launches"] == 1 for r in rows if r not in loop)
    assert all(r["kernel"].startswith("main_kernel_") for r in rows)
    if workload == "cg_sparse":
        n, n_prog = params["n"], params["n"] // 256
        assert len(loop) == 3
        assert sum(r["bytes"] for r in loop) == (11 * n + 9
                                                 + 2 * 2 * n_prog) * 8


def test_stream_bytes_count_each_shards_launch():
    """On a mesh of 4 every shard launches each pass on its quarter of the
    rows: the pass table has the single program's units and launches
    four times over, and the counter its total."""
    traced, plan = _plan("cg_sparse", SPARSE_SET[0][1])
    feeds = _feeds(traced.program, seed=5, dtype=np.float64)
    single = get_backend("cuda").compile(plan)
    sharded = get_backend("cuda").compile(traced.analyze().codesign()
                                          .lower(mesh=4))
    single(feeds)
    sharded(feeds)
    one, four = single.passes(), sharded.passes()
    assert [r["unit"] for r in four] == [r["unit"] for r in one]
    assert [r["launches"] for r in four] == [4 * r["launches"] for r in one]
    assert obs.registry().counter("exec.stream_bytes").value(
        backend="cuda", scope=sharded._scope) == sum(
            r["bytes"] * r["launches"] for r in four)


def test_cuda_perunit_is_registered_and_unfused():
    assert {"cuda", "cuda-perunit", "reference"} <= set(list_backends())
    traced, plan = _plan("cg", dict(n=64, iters=3))
    before = obs.registry().snapshot()
    plan.compiled("cuda-perunit")
    after = obs.registry().snapshot()

    def count(snap):
        return sum(c["value"] for c in snap.get("exec.units", {}).get(
            "cells", ()) if c["labels"]["backend"] == "cuda-perunit")
    assert count(after) - count(before) == len(
        flatten_units(plan.group_kernels))
    assert len(flatten_units(plan.group_kernels)) > len(
        plan.exec_plan.units)                    # residency fusion merges


@pytest.mark.parametrize("workload,params", DISPATCH_SET
                         + [("cg_sparse", dict(n=64, iters=3))],
                         ids=IDS + ["cg_sparse"])
def test_cuda_perunit_matches_pallas_perunit(workload, params):
    jx = jx_api.Session(use_cache=False).trace(workload=workload, **params)
    jx_plan = jx.analyze().codesign().lower()
    traced, plan = _plan(workload, params)
    np_feeds = jx_fe.make_feeds(jx.program, seed=6)
    want = jx_plan.run(np_feeds, backend="pallas-perunit")
    feeds = pt_fe.feeds_from_numpy(np_feeds)
    got = plan.run(feeds, backend="cuda-perunit")
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   **TOL, err_msg=k)
    # and against the port's one-dispatch program on the same feeds
    one = plan.run(feeds)
    for k in one:
        np.testing.assert_allclose(got[k].numpy(), one[k].numpy(), **TOL,
                                   err_msg=k)
