"""Overbooked (prefix) pins on the port's ``cuda`` backend against the JAX
package.

An overbooked pin keeps an indptr-aligned row prefix of a CSR operand
resident and streams the rest; the JAX package runs such an spmv op on its
sliced Pallas kernel (``repro/exec/pallas.py:616``) over the layout of
``_StreamCall._arrange`` (``:300``), the port on B3 (``kernels/spmv.py``,
``csrc/spmv.cu``).  Here on the CPU the ``cuda`` backend runs B3's plain
version, and the JAX package's Pallas kernels run in interpret mode, as
its own tests run them.

* the whole overbooked plan, ``cuda`` backend against the JAX ``pallas``
  backend, fp32 at rtol 2e-4 / atol 1e-5 and fp64 at rtol 1e-9 / atol
  1e-12 (``tests/test_torch_exec.py``'s table: the two packages sum their
  reductions in other orders); the ``reference`` backend against the
  natural order bitwise;
* the arrangement against the JAX package's: the same resident rows and
  entries, and the same declines, which run B2, as the overbook-0 twin
  does;
* B3's plain version against B2's plain version, bitwise.

The JAX package's sliced kernel reads its resident blocks with ``pl.load``,
which the installed JAX no longer has; the ``pallas_load`` fixture gives
``pl.load`` back as the plain ref read it was (``ref[idx]``) for the
duration of a test, without touching the JAX package's files.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import repro.api as jx_api
import repro.frontends as jx_fe
import repro_torch.api as pt_api
import repro_torch.frontends as pt_fe
from repro.exec.pallas import _StreamCall
from repro_torch import kernels
from repro_torch.exec import cuda as pt_cuda
from repro_torch.kernels.spmv import (B3_TILE_ROWS, B3_WINDOW, arrange,
                                      spmv, spmv_plain, spmv_sliced_plain)

TOL = {np.float32: dict(rtol=2e-4, atol=1e-5),
       np.float64: dict(rtol=1e-9, atol=1e-12)}
DTYPES = [np.float32, np.float64]
DT_IDS = ["fp32", "fp64"]

# (workload, params, capacity_bytes) with overbook=0.25; each plan takes a
# prefix pin.  At n=64 the stream pass is one tile (nothing resident, as in
# the JAX package); at n=4096 the operand exceeds the 1 MiB floor of the
# explicit region, so tiles are smaller than the pass
CASES = {
    "cg_n64": ("cg_sparse", dict(n=64, iters=3, pattern="banded",
                                 bandwidth=2), 4500),
    "jacobi_n64": ("jacobi_sparse", dict(n=64, sweeps=3, pattern="banded",
                                         bandwidth=2), 6000),
    # tile_rows 4 and 8, prefix of 3206 rows: a partially resident
    # boundary tile
    "cg_n4096_tiles": ("cg_sparse", dict(n=4096, iters=3, pattern="banded",
                                         bandwidth=16), 1317278),
    # tile_rows 1
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


def _plans(case):
    workload, params, cap = CASES[case]
    jx = jx_api.Session(use_cache=False).trace(workload=workload, **params)
    pt = pt_api.Session(device="cpu").trace(workload=workload, **params)
    jx_plan = jx.analyze().codesign(jx_api.CodesignConfig(
        capacity_bytes=cap, overbook=0.25)).lower()
    pt_plan = pt.analyze().codesign(pt_api.CodesignConfig(
        capacity_bytes=cap, overbook=0.25)).lower()
    return jx_plan, pt_plan


def _sliced_units(plan):
    return [u for u in plan.exec_plan.units
            if u.sp is not None and u.sp.slices]


def _np(v):
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) \
        else np.asarray(v)


@pytest.mark.parametrize("dtype", DTYPES, ids=DT_IDS)
@pytest.mark.parametrize("case", IDS)
def test_cuda_backend_matches_pallas(case, dtype, pallas_load):
    jx_plan, pt_plan = _plans(case)
    assert pt_plan.backend == "cuda"
    assert "pinned=prefix(rows=" in pt_plan.explain()
    assert "B3 (resident prefix" in pt_plan.explain()
    assert "B2" not in pt_plan.explain()
    feeds = jx_fe.make_feeds(jx_plan.trace.program, seed=7, dtype=dtype)
    with jax.enable_x64(dtype == np.float64):
        pal = {k: np.asarray(v) for k, v in
               jx_plan.run(feeds, backend="pallas").items()}
    before = kernels.launches()
    got = pt_plan.run(pt_fe.feeds_from_numpy(feeds))
    assert kernels.launches() == before      # plain versions on the CPU
    assert sorted(got) == sorted(pal)
    ref = pt_plan.run(pt_fe.feeds_from_numpy(feeds), backend="reference")
    for k in pal:
        assert _np(got[k]).dtype == pal[k].dtype == dtype, k
        np.testing.assert_allclose(_np(got[k]), pal[k], **TOL[dtype],
                                   err_msg=f"{case} {k} cuda vs pallas")
        np.testing.assert_allclose(_np(got[k]), _np(ref[k]), **TOL[dtype],
                                   err_msg=f"{case} {k} cuda vs reference")
    assert "spmv_sliced" in pt_plan.compiled().stats["launches"]


def test_overbook_zero_twin_runs_b2():
    workload, params, cap = CASES["cg_n4096_tiles"]
    plan = pt_api.Session(device="cpu").trace(
        workload=workload, **params).analyze().codesign(
        pt_api.CodesignConfig(capacity_bytes=cap, overbook=0.0)).lower()
    assert not _sliced_units(plan)
    spmv_ops = [o for u in plan.exec_plan.units if u.sp is not None
                for o in u.sp.ops if plan.trace.program.nodes[o].op == "spmv"]
    assert spmv_ops
    text = plan.explain()
    assert f"B2 (whole operand) for {', '.join(spmv_ops)}" in text
    assert "B3" not in text


@pytest.mark.parametrize("case", IDS)
def test_reference_backend_is_bitwise_natural_order(case):
    _jx_plan, pt_plan = _plans(case)
    program = pt_plan.trace.program
    feeds = pt_fe.feeds_from_numpy(pt_fe.make_feeds(program, seed=5))
    want = pt_fe.evaluate(program, feeds)
    got = pt_plan.run(feeds, backend="reference")
    assert sorted(got) == sorted(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("case", IDS)
def test_arrangement_matches_jax(case):
    jx_plan, pt_plan = _plans(case)
    jx_units, pt_units = _sliced_units(jx_plan), _sliced_units(pt_plan)
    assert [dataclasses.asdict(u.sp) for u in pt_units] == \
        [dataclasses.asdict(u.sp) for u in jx_units]
    assert pt_units, "the plan holds no prefix pin"
    jx_prog, pt_prog = jx_plan.trace.program, pt_plan.trace.program
    feeds = jx_fe.make_feeds(jx_prog, seed=0)
    seen = set()
    for ju, pu in zip(jx_units, pt_units):
        sp = pu.sp
        call = _StreamCall(jx_prog, ju.sp, set(ju.sp.ops))
        ours = {o: rows for o, rows in
                pt_cuda.spmv_prefixes(pt_prog, sp).items()
                if rows is not None}
        assert sorted(ours) == sorted(call._sliced)
        for op, rows in ours.items():
            jam = call._sliced[op]
            tr = sp.tile_rows
            assert rows % tr == 0
            assert (rows // tr, sp.rows // tr) == (jam["p"], jam["n_tiles"])
            # the JAX layout's resident entries: its prefix blocks' valid
            # slots, counted by arranging a data vector of ones
            nd = jx_prog.nodes[op]
            indptr = feeds[nd.inputs[0]]
            ones = {nd.inputs[2]: np.ones(jx_prog.nodes[nd.inputs[2]]
                                          .shape, np.float32)}
            pre = (float(jnp.sum(call.arranged[jam["pre"][0]](
                ones, jnp.float32))) if jam["pre"] else 0.0)
            tail = float(jnp.sum(call.arranged[jam["tail"][0]](
                ones, jnp.float32)))
            assert indptr[rows] == pre
            assert pre + tail == jx_prog.nodes[nd.inputs[1]].shape[0]
            assert jam["budget"] * jam["n_tiles"] >= pre + tail
            seen.add((tr, sp.slices[0].rows % tr != 0 and rows > 0))
    if case == "cg_n4096_tiles":      # a partially resident boundary tile
        assert any(tr > 1 and partial for tr, partial in seen), seen
    if case.endswith("_rows"):
        assert {tr for tr, _ in seen} == {1}


def _strip(program, name, **changes):
    """``program`` with the params of leaf ``name`` changed (None drops
    the key)."""
    nd = program.nodes[name]
    params = dict(nd.params)
    for k, v in changes.items():
        if v is None:
            params.pop(k, None)
        else:
            params[k] = v
    program.nodes[name] = dataclasses.replace(
        nd, params=tuple(sorted(params.items())))


# how an operand fails the JAX package's checks at pallas.py:322-332
DECLINES = {
    "no_pattern": dict(pattern=None),             # a hand-built program
    "counts_not_nnz": dict(bandwidth=15),         # cumsum != nnz
    "meta_refused": dict(bandwidth=None),         # row_counts raises
    "tile_not_dividing": {},                      # n % tile_rows != 0
}


@pytest.mark.parametrize("how", list(DECLINES))
def test_declined_arrangement_runs_b2(how, monkeypatch):
    jx_plan, pt_plan = _plans("cg_n4096_tiles")
    jx_prog, pt_prog = jx_plan.trace.program, pt_plan.trace.program
    feeds = pt_fe.feeds_from_numpy(pt_fe.make_feeds(pt_prog, seed=4))
    ju, pu = _sliced_units(jx_plan)[1], _sliced_units(pt_plan)[1]
    jsp, psp = ju.sp, pu.sp
    if how == "tile_not_dividing":
        jsp = dataclasses.replace(jsp, tile_rows=3)
        psp = dataclasses.replace(psp, tile_rows=3)
        pu = dataclasses.replace(pu, sp=psp)
    else:
        for prog in (jx_prog, pt_prog):
            _strip(prog, "A.indptr", **DECLINES[how])
    assert _StreamCall(jx_prog, jsp, set(jsp.ops))._sliced == {}
    spmv_ops = [o for o in psp.ops if pt_prog.nodes[o].op == "spmv"]
    assert pt_cuda.spmv_prefixes(pt_prog, psp) == dict.fromkeys(spmv_ops)
    prefixes = []
    b2_b3 = pt_cuda.spmv

    def spy(*a, prefix_rows=None, **kw):
        prefixes.append(prefix_rows)
        return b2_b3(*a, prefix_rows=prefix_rows, **kw)
    monkeypatch.setattr(pt_cuda, "spmv", spy)
    unit = pt_cuda._StreamUnit(pt_prog, pu, set(pu.ops))
    nat = _natural(pt_prog, feeds)
    out = unit({k: nat[k] for k in unit.in_names})
    assert prefixes == [None] * len(spmv_ops)      # B2 for every op
    assert sorted(out) == sorted(pu.ops)
    for k, v in out.items():
        np.testing.assert_allclose(_np(v), _np(nat[k]), **TOL[np.float32],
                                   err_msg=k)


def _natural(program, feeds):
    """Every node's value in the program's natural order."""
    from repro_torch.exec.reference import eval_node
    vals = dict(feeds)
    for o in program.schedulable_order():
        nd = program.nodes[o]
        vals[o] = eval_node(nd, [vals[t] for t in nd.inputs])
    return vals


def _csr(rng, rows, empty_every=0):
    """A random CSR operand with 0-9 entries a row (every
    ``empty_every``-th row empty) and sorted columns."""
    counts = rng.integers(1, 10, rows)
    if empty_every:
        counts[::empty_every] = 0
    indptr = np.concatenate(([0], np.cumsum(counts))).astype(np.int32)
    indices = np.concatenate([np.sort(rng.choice(rows, c, replace=False))
                              for c in counts]).astype(np.int32)
    return indptr, indices


@pytest.mark.parametrize("where", ["none", "middle", "all"])
@pytest.mark.parametrize("dtype", DTYPES, ids=DT_IDS)
def test_b3_plain_is_bitwise_b2_plain(dtype, where):
    rng = np.random.default_rng(11)
    rows = 301
    indptr, indices = _csr(rng, rows, empty_every=7)
    data = rng.standard_normal(indices.shape[0]).astype(dtype)
    x = rng.standard_normal(rows).astype(dtype)
    t = [torch.from_numpy(v) for v in (indptr, indices, data, x)]
    prefix = {"none": 0, "middle": 150, "all": rows}[where]
    got = spmv(*t, rows, prefix)
    assert got.dtype == t[2].dtype
    assert torch.equal(got, spmv_sliced_plain(*t, rows, prefix))
    assert torch.equal(got, spmv_plain(*t, rows))
    dense = np.zeros((rows, rows), np.float64)
    dense[np.repeat(np.arange(rows), np.diff(indptr)), indices] = data
    np.testing.assert_allclose(got.numpy(), dense @ x.astype(np.float64),
                               **TOL[dtype])


def test_b3_wrapper_refuses_bad_arguments():
    t = [torch.zeros(5, dtype=torch.int32), torch.zeros(0, dtype=torch.int32),
         torch.zeros(0), torch.zeros(4)]
    for bad in (-1, 5):
        with pytest.raises(ValueError, match="prefix_rows"):
            spmv(*t, 4, bad)
    with pytest.raises(ValueError, match="devices"):
        spmv(t[0], t[1], t[2], torch.zeros(4, device="meta"), 4, 2)
    assert torch.equal(spmv(*t, 4, 2), torch.zeros(4))


def test_arrange_declines_like_jax_without_a_leaf():
    from repro_torch.core.lowering import ResidentSlice
    sl = ResidentSlice(tensors=("A.indptr",), rows=40, total_rows=64,
                       entries=100, total_entries=160)
    assert arrange(sl, None, 64, 8, 160) is None


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _card_pattern(rng, pattern):
    """(rows, indptr, indices) of one B3 operand for the card: the 5-point
    Laplacian, a random pattern, a skewed one whose first rows are longer
    than one staged window (``B3_WINDOW``), and a banded one."""
    if pattern == "laplacian5":
        g = 64
        r, c = np.divmod(np.arange(g * g), g)
        counts = 1 + (r > 0) + (r < g - 1) + (c > 0) + (c < g - 1)
        return g * g, *_with_counts(rng, g * g, counts)
    if pattern == "random":
        rows = 5000
        return rows, *_csr(rng, rows, empty_every=13)
    if pattern == "skewed":
        rows = 3000
        counts = np.clip((2 * B3_WINDOW / np.sqrt(np.arange(rows) + 1.0)
                          ).astype(np.int64), 1, rows)
        assert counts.max() > B3_WINDOW
        return rows, *_with_counts(rng, rows, counts)
    rows, bw = 4096, 16
    counts = (np.minimum(np.arange(rows), bw)
              + np.minimum(rows - 1 - np.arange(rows), bw) + 1)
    return rows, *_with_counts(rng, rows, counts)


def _with_counts(rng, rows, counts):
    indptr = np.concatenate(([0], np.cumsum(counts))).astype(np.int32)
    indices = rng.integers(0, rows, int(indptr[-1])).astype(np.int32)
    return indptr, indices


@pytest.mark.gpu
@pytest.mark.parametrize("where", ["none", "middle", "all"])
@pytest.mark.parametrize("pattern",
                         ["laplacian5", "random", "skewed", "banded"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=DT_IDS)
def test_b3_matches_plain_version_on_the_card(cuda_device, dtype, pattern,
                                              where):
    """B3 bitwise against its plain version and B2, with a resident prefix
    of no rows, whole tiles up to the middle, or all rows."""
    rng = np.random.default_rng(12)
    rows, indptr, indices = _card_pattern(rng, pattern)
    t = [torch.from_numpy(v).to(cuda_device) for v in (indptr, indices)]
    data = torch.from_numpy(rng.standard_normal(indices.shape[0])).to(
        cuda_device, dtype)
    x = torch.from_numpy(rng.standard_normal(rows)).to(cuda_device, dtype)
    prefix = {"none": 0, "middle": rows // 2 // B3_TILE_ROWS * B3_TILE_ROWS,
              "all": rows}[where]
    before = kernels.launches()["spmv_sliced"]
    got = spmv(t[0], t[1], data, x, rows, prefix)
    torch.cuda.synchronize()
    assert kernels.launches()["spmv_sliced"] == before + 1
    assert torch.equal(got, spmv_sliced_plain(t[0], t[1], data, x, rows,
                                              prefix))
    assert torch.equal(got, spmv(t[0], t[1], data, x, rows))


@pytest.mark.gpu
def test_b3_refuses_unaligned_operands_on_the_card(cuda_device):
    """B3 stages 16-byte chunks: an operand that does not start 16-byte
    aligned raises; it does not run B2 instead."""
    rows = 8
    dev = cuda_device
    indptr = torch.arange(rows + 1, dtype=torch.int32, device=dev)
    indices = torch.zeros(rows, dtype=torch.int32, device=dev)
    data, x = torch.ones(rows, device=dev), torch.ones(rows, device=dev)
    # views one element into a fresh allocation: 4 bytes past alignment
    off_indices = torch.zeros(rows + 1, dtype=torch.int32, device=dev)[1:]
    off_data = torch.ones(rows + 1, device=dev)[1:]
    assert torch.equal(spmv(indptr, indices, data, x, rows, 4),
                       torch.ones(rows, device=dev))
    for bad in ((indptr, off_indices, data, x), (indptr, indices, off_data,
                                                  x)):
        with pytest.raises(ValueError, match="16-byte aligned"):
            spmv(*bad, rows, 4)
