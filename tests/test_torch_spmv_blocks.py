"""B2's blocks form (``csrc/spmv.cu::csr_spmv_blocks_kernel``) in torch.

``kernels.spmv.spmv_blocks_plain`` repeats the kernel's row-block
ownership (CTA ``b`` owns the rows whose first entry lies in ``[b E,
(b + 1) E)``, each of its ``B2_WARPS`` warps those in its share of E),
its groups of 32 rows a warp, its steps of 64 or 128 entries and its
in-order fold.  Here it is held, at both steps:

* bitwise against ``spmv_plain`` (B2's plain version; the CPU wrapper's)
  and within ``TOL`` of the JAX package's reference rule, on each pattern
  of the frontends at sizes where several CTAs run and, for ``skewed``,
  rows span many steps and warps' shares;
* on hand-built operands: empty rows, trailing empty rows, empty rows at
  a multiple of E, rows longer than E, ``nnz == 0``, and a mesh shard's
  padded entry window as ``exec.sharded._csr_windows`` cuts it (entries
  past ``indptr[rows]``, an unaligned start);
* for ownership: every row has exactly one owning CTA and one owning
  warp, the one whose range holds its first entry;
* against ``csrc/spmv.cu``: the Python values of the warps a CTA and E
  are the source's constants, parsed from it.

The kernel itself runs only on the card (``chip_smoke.py``, phase 3, and
``scripts/b2_vs_parent.py``).
"""
import pathlib
import re
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.frontends as jx_fe
from repro.exec.reference import eval_node as jx_eval_node
from repro_torch.exec.sharded import _csr_windows
from repro_torch.kernels import spmv as spmv_mod
from repro_torch.kernels.spmv import (B2_BLOCK_ENTRIES, B2_WARPS,
                                      b2_block_rows, spmv, spmv_blocks_plain,
                                      spmv_plain, spmv_sliced_plain)

TOL = {np.float32: dict(rtol=2e-4, atol=1e-5),
       np.float64: dict(rtol=1e-9, atol=1e-12)}
DTYPES = [np.float32, np.float64]
DT_IDS = ["fp32", "fp64"]
#: the entries of a warp's step, as the launcher picks them
STEPS = (64, 128)
SOURCE = (pathlib.Path(spmv_mod.__file__).resolve().parent.parent / "csrc"
          / "spmv.cu")

#: the frontends' patterns at sizes with several CTAs (entries > E);
#: skewed's first rows are longer than a warp's share
PATTERNS = [("laplacian5", 4096, {}), ("banded", 1024, dict(bandwidth=16)),
            ("random", 600, dict(density=0.1)),
            ("skewed", 1200, dict(density=0.1))]
WARP_SHARE = B2_BLOCK_ENTRIES // B2_WARPS


def _reference(indptr, indices, data, x, rows, dtype):
    """The JAX package's reference rule for spmv on these arrays."""
    p = jx_fe.Program("spmv")
    A = p.sparse_operator("A", (rows, rows), pattern="random", density=0.5)
    p.output(p.spmv(A, p.input("x", (rows,)), name="y"))
    with jax.enable_x64(dtype == np.float64):
        return np.asarray(jx_eval_node(p.nodes["y"], [
            jnp.asarray(v) for v in (indptr, indices, data, x)]))


def _hold(indptr, indices, data, x, rows, dtype):
    """The blocks form's plain version bitwise ``spmv_plain`` (and the CPU
    wrapper) and B3's ordered plain version, and within ``TOL`` of the
    reference rule."""
    t = [torch.from_numpy(np.ascontiguousarray(v))
         for v in (indptr, indices, data, x)]
    got = spmv_blocks_plain(*t, rows)
    assert got.dtype == t[2].dtype and got.shape == (rows,)
    assert torch.equal(got, spmv_blocks_plain(*t, rows, step=STEPS[1]))
    assert torch.equal(got, spmv_plain(*t, rows))
    assert torch.equal(got, spmv(*t, rows))
    assert torch.equal(got, spmv_sliced_plain(*t, rows, 0))
    np.testing.assert_allclose(
        got.numpy(), _reference(indptr, indices, data, x, rows, dtype),
        **TOL[dtype])
    return got


def _with_counts(rng, counts, cols):
    indptr = np.concatenate(([0], np.cumsum(counts))).astype(np.int32)
    return indptr, rng.integers(0, cols, int(indptr[-1])).astype(np.int32)


@pytest.mark.parametrize("dtype", DTYPES, ids=DT_IDS)
@pytest.mark.parametrize("pattern,n,kw", PATTERNS,
                         ids=[p for p, _n, _k in PATTERNS])
def test_blocks_plain_matches_plain_and_reference(pattern, n, kw, dtype):
    p = jx_fe.Program("spmv")
    A = p.sparse_operator("A", (n, n), pattern=pattern, **kw)
    x = p.input("x", (n,))
    p.output(p.spmv(A, x, name="y"))
    feeds = jx_fe.make_feeds(p, seed=6, dtype=dtype)
    indptr, indices, data, xv = (feeds[k] for k in p.nodes["y"].inputs)
    assert indptr[-1] > 2 * B2_BLOCK_ENTRIES          # several CTAs
    if pattern == "skewed":
        assert np.diff(indptr).max() > WARP_SHARE     # longer than a share
    _hold(indptr, indices, data, xv, n, dtype)


def _edge_cases():
    rng = np.random.default_rng(32)
    E = B2_BLOCK_ENTRIES
    # empty rows every few rows, then a run of trailing empty rows
    counts = rng.integers(0, 60, 900)
    counts[::7] = 0
    counts[-40:] = 0
    yield "empty rows, trailing empty rows", counts, 500
    # rows whose first entry is a multiple of E, with empty rows there
    counts = np.array([E, 0, 0, E - 3, 3, 0, 1, E, 0], np.int64)
    yield "empty rows at multiples of E", counts, 300
    # rows longer than E and than many steps, among short ones
    counts = np.array([3, 2 * E + 5, 0, 7, 9000, 1, WARP_SHARE, 2], np.int64)
    yield "rows longer than E", counts, 700
    # more rows a warp than lanes: short rows, several groups of 32
    yield "groups of short rows", rng.integers(0, 3, 5 * WARP_SHARE), 64
    yield "nnz == 0", np.zeros(37, np.int64), 37


EDGE = list(_edge_cases())


@pytest.mark.parametrize("dtype", DTYPES, ids=DT_IDS)
@pytest.mark.parametrize("what,counts,cols", EDGE,
                         ids=[w for w, _c, _n in EDGE])
def test_blocks_plain_edges(what, counts, cols, dtype):
    rng = np.random.default_rng(33)
    rows = counts.shape[0]
    indptr, indices = _with_counts(rng, counts, cols)
    data = rng.standard_normal(indices.shape[0]).astype(dtype)
    # rows x cols operand; the reference rule's x is the columns' values
    x = rng.standard_normal(max(rows, cols)).astype(dtype)
    got = _hold(indptr, indices, data, x, rows, dtype)
    if what == "nnz == 0":
        assert not got.any()


@pytest.mark.parametrize("dtype", DTYPES, ids=DT_IDS)
def test_blocks_plain_on_a_mesh_shards_padded_window(dtype):
    """Shards cut as ``_csr_windows`` cuts them: each shard's indptr
    rebased to 0 and a ``pad_entries`` window of the zero-padded arrays,
    which starts at any entry and reaches into the next shard's entries
    (or the padding): those belong to no row of the shard."""
    rng = np.random.default_rng(34)
    rows, shards = 480, 4
    counts = rng.integers(0, 300, rows)            # several CTAs a shard
    counts[100:140] = 0
    indptr, indices = _with_counts(rng, counts, rows)
    data = rng.standard_normal(indices.shape[0]).astype(dtype)
    x = rng.standard_normal(rows).astype(dtype)
    rl = rows // shards
    starts = tuple(int(indptr[k * rl]) for k in range(shards + 1))
    pad = max(b - a for a, b in zip(starts[:-1], starts[1:])) + 5
    lay = SimpleNamespace(slices=[SimpleNamespace(rows=rl)],
                          pad_entries=pad, entry_starts=starts)
    t = [torch.from_numpy(v) for v in (indptr, indices, data, x)]
    windows = _csr_windows(lay, *t[:3])
    whole = spmv_plain(*t, rows)
    for k, (ip, ix, dv) in enumerate(windows):
        assert dv.shape[0] == pad and int(ip[-1]) <= pad
        assert pad > 2 * B2_BLOCK_ENTRIES
        got = spmv_blocks_plain(ip, ix, dv, t[3], rl)
        assert torch.equal(got, spmv_plain(ip, ix, dv, t[3], rl))
        assert torch.equal(got, whole[k * rl:(k + 1) * rl])
        # the shard's own entries alone give the same bits
        own = int(ip[-1])
        assert torch.equal(got, spmv_blocks_plain(ip, ix[:own], dv[:own],
                                                  t[3], rl))


@pytest.mark.parametrize("share", [B2_BLOCK_ENTRIES, WARP_SHARE],
                         ids=["cta", "warp"])
@pytest.mark.parametrize("what,counts,cols", EDGE + [
    ("padded window", np.array([0, 5, 4200, 0, 3], np.int64), 9)],
    ids=[w for w, _c, _n in EDGE] + ["padded window"])
def test_every_row_has_one_owner(what, counts, cols, share):
    rng = np.random.default_rng(35)
    indptr, _ = _with_counts(rng, counts, cols)
    rows = counts.shape[0]
    entries = int(indptr[-1]) + (B2_BLOCK_ENTRIES + 17
                                 if what == "padded window" else 0)
    owned = b2_block_rows(torch.from_numpy(indptr), rows, entries, share)
    ranges = (entries // B2_BLOCK_ENTRIES + 1) * (B2_BLOCK_ENTRIES // share)
    assert owned.shape == (ranges + 1,)
    assert int(owned[0]) == 0 and int(owned[-1]) == rows
    assert bool((owned[1:] >= owned[:-1]).all())
    owner = np.zeros(rows, np.int64)
    hits = np.zeros(rows, np.int64)
    for b in range(ranges):
        r0, r1 = int(owned[b]), int(owned[b + 1])
        hits[r0:r1] += 1
        owner[r0:r1] = b
    assert (hits == 1).all()
    starts = indptr[:-1].astype(np.int64)
    assert (owner * share <= starts).all()
    assert (starts < (owner + 1) * share).all()
    if share != B2_BLOCK_ENTRIES:     # a warp's rows lie in its CTA's
        ctas = b2_block_rows(torch.from_numpy(indptr), rows, entries)
        per = B2_BLOCK_ENTRIES // share
        assert torch.equal(owned[::per], ctas)


def _constant(name):
    m = re.search(rf"constexpr int {name} = (\d+);", SOURCE.read_text())
    assert m, f"{name} not found in {SOURCE.name}"
    return int(m.group(1))


def test_python_shape_is_the_sources():
    assert B2_WARPS == _constant("kB2Warps")
    assert B2_BLOCK_ENTRIES == _constant("kB2Entries")
    assert B2_BLOCK_ENTRIES % B2_WARPS == 0
    # the steps the launcher picks, by its rule, and nowhere in Python
    assert "launch_b2_blocks<T, kB2Warps, 2, kB2Entries>" in SOURCE.read_text()
    assert "launch_b2_blocks<T, kB2Warps, 4, kB2Entries>" in SOURCE.read_text()
    _constant("kB2BlocksMinPerRow")
    _constant("kB2LongRow")
    text = pathlib.Path(spmv_mod.__file__).read_text()
    assert "MIN_PER_ROW" not in text and "LONG_ROW" not in text
