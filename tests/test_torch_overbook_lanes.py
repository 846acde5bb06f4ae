"""``CompiledPlan.batched()`` on an overbooked plan: B3's lane form against
the JAX package's vmapped sliced kernel.

The JAX package batches a plan by vmapping its single program
(``repro/serve/batched.py``); on an overbooked plan that program runs the
sliced Pallas kernel (``repro/exec/pallas.py:616``) over the layout of
``_StreamCall._arrange`` (``:300``) with a batch axis on its grid.  The
port runs such an spmv op on B3's lane form (``kernels/spmv.py::
spmv_sliced_lanes``, ``csrc/spmv.cu::spmv_tiled_lanes_kernel``); here on
the CPU its plain version, with the JAX package's kernels in interpret
mode.

* B3's lane form's plain version per lane bitwise equal to B3's
  (``spmv_sliced_plain``), at 1, 3, 16 and 17 lanes with a prefix of no,
  some and all rows;
* every case of ``tests/test_torch_overbook.py``'s ``CASES``, fp32 and
  fp64, 4 requests (seeds 0-3): the port's ``batched(backend="cuda")`` and
  ``"cuda-perunit"`` against the JAX package's ``batched(backend=
  "pallas")`` and ``batched(backend="reference")`` within
  ``tests/test_torch_exec.py``'s ``TOL`` (fp32 rtol 2e-4 / atol 1e-5,
  fp64 rtol 1e-9 / atol 1e-12);
* each port lane bitwise equal to the port's unbatched ``run()`` of its
  request, padded batches (3 requests on 4 lanes) included.

The JAX package's sliced kernel reads its resident blocks with ``pl.load``,
which the installed JAX no longer has; this file's ``pallas_load`` fixture
gives it back as the plain ref read (``ref[idx]``) for the duration of a
test, as ``tests/test_torch_overbook.py``'s does.
"""
import jax
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import repro.api as jx_api
import repro.frontends as jx_fe
import repro_torch.api as pt_api
from repro_torch import kernels
from repro_torch.exec.cuda import CudaLaneProgram, spmv_prefixes
from repro_torch.frontends import feeds_from_numpy
from repro_torch.kernels.spmv import (B3_TILE_ROWS, spmv, spmv_lanes_plain,
                                      spmv_sliced_lanes,
                                      spmv_sliced_lanes_plain,
                                      spmv_sliced_plain)

TOL = {np.float32: dict(rtol=2e-4, atol=1e-5),
       np.float64: dict(rtol=1e-9, atol=1e-12)}
DTYPES = [np.float32, np.float64]
DT_IDS = ["fp32", "fp64"]
N_REQ = 4

# tests/test_torch_overbook.py's CASES: (workload, params, capacity_bytes)
# with overbook=0.25, each plan taking a prefix pin
CASES = {
    "cg_n64": ("cg_sparse", dict(n=64, iters=3, pattern="banded",
                                 bandwidth=2), 4500),
    "jacobi_n64": ("jacobi_sparse", dict(n=64, sweeps=3, pattern="banded",
                                         bandwidth=2), 6000),
    "cg_n4096_tiles": ("cg_sparse", dict(n=4096, iters=3, pattern="banded",
                                         bandwidth=16), 1317278),
    "cg_n4096_rows": ("cg_sparse", dict(n=4096, iters=3, pattern="banded",
                                        bandwidth=16), 1372165),
    "jacobi_n4096_rows": ("jacobi_sparse", dict(n=4096, sweeps=3,
                                                pattern="banded",
                                                bandwidth=16), 1317278),
}
IDS = list(CASES)


@pytest.fixture
def pallas_load(monkeypatch):
    if not hasattr(pl, "load"):
        monkeypatch.setattr(pl, "load", lambda ref, idx: ref[idx],
                            raising=False)


def _np(v):
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) \
        else np.asarray(v)


def _pt_plan(case):
    workload, params, cap = CASES[case]
    return pt_api.Session(device="cpu").trace(
        workload=workload, **params).analyze().codesign(
        pt_api.CodesignConfig(capacity_bytes=cap, overbook=0.25)).lower()


def _b3_ops(plan):
    """The spmv ops that run on B3 (a prefix the arrangement accepts)."""
    prog = plan.trace.program
    return sorted(o for u in plan.exec_plan.units if u.kind == "stream"
                  for o, k in spmv_prefixes(prog, u.sp).items()
                  if k is not None)


_JAX_OUTS = {}


def _jax_batched(case, dtype):
    """The JAX BatchedPlan's outputs on its pallas and reference backends
    for requests 0..N_REQ-1, with the feeds, memoized per case."""
    key = (case, dtype)
    if key not in _JAX_OUTS:
        workload, params, cap = CASES[case]
        with jax.enable_x64(dtype == np.float64):
            traced = jx_api.Session(use_cache=False).trace(
                workload=workload, **params)
            plan = traced.analyze().codesign(jx_api.CodesignConfig(
                capacity_bytes=cap, overbook=0.25)).lower()
            bp = plan.batched(backend="pallas")
            shared = jx_fe.make_feeds(traced.program, seed=0, dtype=dtype,
                                      only=bp.shared_leaves)
            per_req = [jx_fe.make_feeds(traced.program, seed=s, dtype=dtype,
                                        only=bp.batched_leaves)
                       for s in range(N_REQ)]
            outs = {be: [{k: np.asarray(v) for k, v in o.items()}
                         for o in plan.batched(backend=be).run_many(
                             per_req, shared)]
                    for be in ("pallas", "reference")}
        _JAX_OUTS[key] = (shared, per_req, outs)
    return _JAX_OUTS[key]


# ---------------------------------------------------------------------------
# the lane form's plain version
# ---------------------------------------------------------------------------

def _csr(rng, rows):
    counts = rng.integers(0, 12, rows)
    counts[::9] = 0
    indptr = np.concatenate(([0], np.cumsum(counts))).astype(np.int32)
    indices = np.concatenate([np.sort(rng.choice(rows, c, replace=False))
                              for c in counts]).astype(np.int32)
    return indptr, indices


@pytest.mark.parametrize("where", ["none", "partial", "all"])
@pytest.mark.parametrize("lanes", [1, 3, 16, 17])
@pytest.mark.parametrize("dtype", DTYPES, ids=DT_IDS)
def test_lane_plain_is_bitwise_b3_plain_per_lane(dtype, lanes, where):
    rng = np.random.default_rng(21)
    rows = 389
    indptr, indices = _csr(rng, rows)
    data = rng.standard_normal(indices.shape[0]).astype(dtype)
    x = rng.standard_normal((lanes, rows)).astype(dtype)
    t = [torch.from_numpy(v) for v in (indptr, indices, data)]
    X = torch.from_numpy(x)
    prefix = {"none": 0, "partial": 2 * B3_TILE_ROWS, "all": rows}[where]
    got = spmv_sliced_lanes(*t, X, rows, prefix)
    assert got.shape == (lanes, rows) and got.dtype == X.dtype
    assert torch.equal(got, spmv_sliced_lanes_plain(*t, X, rows, prefix))
    for lane in range(lanes):
        one = spmv_sliced_plain(*t, X[lane], rows, prefix)
        assert torch.equal(got[lane], one), lane
        assert torch.equal(got[lane], spmv(*t, X[lane], rows, prefix))
    # B2's lane form adds in the same entry order
    assert torch.equal(got, spmv_lanes_plain(*t, X, rows))


def test_lane_wrapper_refuses_bad_arguments():
    t = [torch.zeros(5, dtype=torch.int32), torch.zeros(0, dtype=torch.int32),
         torch.zeros(0)]
    for bad in (-1, 5):
        with pytest.raises(ValueError, match="prefix_rows"):
            spmv_sliced_lanes(*t, torch.zeros(2, 4), 4, bad)
    with pytest.raises(ValueError, match="lane-major"):
        spmv_sliced_lanes(*t, torch.zeros(4), 4, 2)
    with pytest.raises(ValueError, match="devices"):
        spmv_sliced_lanes(*t, torch.zeros(2, 4, device="meta"), 4, 2)
    assert torch.equal(spmv_sliced_lanes(*t, torch.zeros(2, 4), 4, 2),
                       torch.zeros(2, 4))


# ---------------------------------------------------------------------------
# the batched plan against the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", ["cuda", "cuda-perunit"])
@pytest.mark.parametrize("dtype", DTYPES, ids=DT_IDS)
@pytest.mark.parametrize("case", IDS)
def test_batched_overbooked_matches_jax(case, dtype, backend, pallas_load):
    shared, per_req, want = _jax_batched(case, dtype)
    plan = _pt_plan(case)
    assert _b3_ops(plan), "the plan runs no spmv op on B3"
    bp = plan.batched(backend=backend)
    assert bp.backend == backend
    assert sorted(bp.shared_leaves) == sorted(shared)
    before = kernels.launches()
    got = bp.run_many(per_req, shared)
    assert kernels.launches() == before      # plain versions on the CPU
    assert len(got) == N_REQ
    for i, g in enumerate(got):
        for be in ("pallas", "reference"):
            w = want[be][i]
            assert sorted(g) == sorted(w)
            for k in w:
                assert _np(g[k]).dtype == w[k].dtype == dtype, k
                np.testing.assert_allclose(
                    _np(g[k]), w[k], **TOL[dtype],
                    err_msg=f"{case} lane {i} {k} {backend} vs JAX {be}")


@pytest.mark.parametrize("n_req", [N_REQ, 3])
@pytest.mark.parametrize("dtype", DTYPES, ids=DT_IDS)
@pytest.mark.parametrize("case", IDS)
def test_each_lane_is_its_unbatched_run(case, dtype, n_req, monkeypatch):
    """Each lane of ``cuda`` and ``cuda-perunit`` bitwise equal to the
    port's unbatched ``run()``; 3 requests pad to 4 lanes.  The lane
    program sends every B3 op to B3's lane form."""
    plan = _pt_plan(case)
    prog = plan.trace.program
    shared = feeds_from_numpy(jx_fe.make_feeds(
        prog, seed=0, dtype=dtype,
        only=[nd.name for nd in prog.leaves() if nd.op == "operator"]))
    per_req = [feeds_from_numpy(jx_fe.make_feeds(
        prog, seed=s, dtype=dtype,
        only=[nd.name for nd in prog.leaves() if nd.op != "operator"]))
        for s in range(n_req)]
    from repro_torch.exec import cuda as pt_cuda
    seen = []
    lanes_b3 = pt_cuda.spmv_sliced_lanes

    def spy(indptr, indices, data, x, rows, prefix_rows):
        seen.append((int(x.shape[0]), prefix_rows))
        return lanes_b3(indptr, indices, data, x, rows, prefix_rows)
    monkeypatch.setattr(pt_cuda, "spmv_sliced_lanes", spy)
    for backend in ("cuda", "cuda-perunit"):
        seen.clear()
        outs = plan.batched(backend=backend).run_many(per_req, shared)
        assert seen and {n for n, _ in seen} == {4}, seen
        assert all(k > 0 for _, k in seen) or case.endswith("n64"), seen
        for r, out in zip(per_req, outs):
            one = plan.run({**shared, **r})
            assert sorted(one) == sorted(out)
            for k in one:
                assert torch.equal(out[k], one[k]), (case, backend, k)


def test_lane_program_keeps_the_arrangements_choice(monkeypatch):
    """An op the arrangement declines runs on B2's lane form, as the JAX
    package's vmapped program falls back to its whole-resident kernel."""
    import dataclasses
    from repro_torch.exec import cuda as pt_cuda
    plan = _pt_plan("cg_n4096_tiles")
    prog = plan.trace.program
    feeds = feeds_from_numpy(jx_fe.make_feeds(prog, seed=0))
    nd = prog.nodes["A.indptr"]
    prog.nodes["A.indptr"] = dataclasses.replace(nd, params=tuple(
        (k, v) for k, v in nd.params if k != "pattern"))
    assert not _b3_ops(plan)
    calls = []
    for name in ("spmv_lanes", "spmv_sliced_lanes"):
        def fn(*a, _name=name, _real=getattr(pt_cuda, name), **kw):
            calls.append(_name)
            return _real(*a, **kw)
        monkeypatch.setattr(pt_cuda, name, fn)
    lane = CudaLaneProgram(plan)
    lane({n: feeds[n] for n in lane.shared_leaves},
         {n: torch.stack([feeds[n]] * 2) for n in lane.batched_leaves})
    assert calls and set(calls) == {"spmv_lanes"}


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("where", ["none", "partial", "all"])
@pytest.mark.parametrize("lanes", [1, 3, 16, 17])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=DT_IDS)
def test_b3_lanes_on_the_card(cuda_device, dtype, lanes, where):
    """B3's lane form bitwise against its plain version and, lane by lane,
    against single-request B3; lanes past L are never written."""
    rng = np.random.default_rng(22)
    rows = 5000
    indptr, indices = _csr(rng, rows)
    t = [torch.from_numpy(v).to(cuda_device) for v in (indptr, indices)]
    data = torch.from_numpy(rng.standard_normal(indices.shape[0])).to(
        cuda_device, dtype)
    X = torch.from_numpy(rng.standard_normal((lanes, rows))).to(
        cuda_device, dtype)
    prefix = {"none": 0, "partial": rows // 2 // B3_TILE_ROWS * B3_TILE_ROWS,
              "all": rows}[where]
    before = kernels.launches()["spmv_sliced_lanes"]
    got = spmv_sliced_lanes(t[0], t[1], data, X, rows, prefix)
    torch.cuda.synchronize()
    assert kernels.launches()["spmv_sliced_lanes"] == before + 1
    assert torch.equal(got, spmv_sliced_lanes_plain(t[0], t[1], data, X,
                                                    rows, prefix))
    for lane in range(lanes):
        assert torch.equal(got[lane], spmv(t[0], t[1], data, X[lane], rows,
                                           prefix)), lane
