"""B7's launch shape and its plain version at the registered widths.

* ``launch_shape(d, dtype)`` (``kernels/rmsnorm.py``) at every width a
  registered arch runs B7 at, in bf16 and fp32: a row group of G threads
  (a multiple of 32) with V 16-byte vectors each covers the row exactly,
  R row groups make a CTA of 128-256 threads; widths that no vector
  covers exactly take the general path, which covers them with padding;
* the V that ``launch_shape`` can return against the instantiations of
  ``csrc/rmsnorm.cu::dispatch``, parsed from the source;
* ``rmsnorm_plain`` against the JAX package's ``rmsnorm`` (Pallas in
  interpret mode) at each registered width and at 1, 4 and 5 rows: fp32
  within 1e-5 of the output's scale, bf16 within one rounding;
* widths past one CTA's registers (above 8192 in fp32, 16384 in bf16):
  walked in chunks of the largest V, with no refusal; every width up to
  that cap keeps the shape of the rule before chunks existed (a frozen
  copy below); the plain version against JAX there too.

The kernel itself runs only on the card (``chip_smoke.py``, phase 3).
"""
import pathlib
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.kernels.rmsnorm import rmsnorm as jx_rmsnorm
from repro_torch.configs import get_config, list_archs
from repro_torch.kernels import rmsnorm as rms_mod
from repro_torch.kernels.rmsnorm import (MAX_THREADS, VECTORS, launch_shape,
                                         rmsnorm, rmsnorm_plain)

TOL = 1e-5
DTYPES = {"bf16": torch.bfloat16, "fp32": torch.float32}
#: the widths B7 runs at: every registered arch's d_model
WIDTHS = sorted({get_config(a).d_model for a in list_archs()})
#: widths that no 16-byte vector covers exactly in one dtype or both
ODD_WIDTHS = (1001, 1004, 1030, 100, 7, 264)


def _per_vector(dtype):
    return 16 // torch.empty((), dtype=dtype).element_size()


def test_the_registered_widths():
    assert WIDTHS == [1024, 1280, 2048, 2560, 3072, 4096]


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("d", WIDTHS)
def test_launch_shape_covers_a_registered_width_with_vectors(d, dt):
    s = launch_shape(d, DTYPES[dt])
    assert s.vector
    assert s.threads % 32 == 0 and s.threads > 0
    assert s.threads * s.vectors * _per_vector(DTYPES[dt]) == d
    assert s.vectors in VECTORS
    assert 128 <= s.threads * s.rows <= MAX_THREADS <= 1024


def test_launch_shape_examples():
    assert launch_shape(1024, torch.bfloat16) == (64, 2, 2, True)
    assert launch_shape(4096, torch.bfloat16) == (128, 4, 1, True)
    assert launch_shape(4096, torch.float32) == (256, 4, 1, True)
    assert launch_shape(1001, torch.bfloat16) == (256, 1, 1, False)


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("d", ODD_WIDTHS)
def test_widths_no_vector_covers_take_the_general_path(d, dt):
    s = launch_shape(d, DTYPES[dt])
    per = _per_vector(DTYPES[dt])
    if d % per:
        assert not s.vector
    if not s.vector:
        # one row a CTA of every thread, the least V that covers the row
        assert (s.threads, s.rows) == (MAX_THREADS, 1)
        assert s.vectors == min(v for v in VECTORS
                                if s.threads * v * per >= d)
    assert s.threads % 32 == 0 and s.threads * s.rows <= MAX_THREADS


def test_launch_shape_refuses_a_row_too_wide_for_a_cta():
    """A row too wide for one CTA's registers is no longer refused: past
    ``MAX_THREADS`` x ``max(VECTORS)`` vectors the kernel walks it in
    chunks, one row a CTA of every thread with the largest V (here, a width
    no vector divides, on the general path's scalars)."""
    cap = MAX_THREADS * max(VECTORS) * 4
    assert launch_shape(cap, torch.float32).vector
    assert launch_shape(cap + 1, torch.float32) == (
        MAX_THREADS, max(VECTORS), 1, False)


def test_every_vector_count_is_instantiated_in_the_source():
    src = (pathlib.Path(rms_mod.__file__).resolve().parent.parent / "csrc"
           / "rmsnorm.cu").read_text()
    cases = [int(v) for v, again in re.findall(
        r"case (\d+): return launch<T, (\d+), kVec>", src) if v == again]
    assert sorted(cases) == sorted(VECTORS)
    assert re.findall(r"^constexpr int kMaxThreads = (\d+);", src,
                      re.M) == [str(MAX_THREADS)]
    returned = set()
    for dtype in DTYPES.values():
        for d in range(1, MAX_THREADS * max(VECTORS) * _per_vector(dtype)
                       + 1, 7):
            returned.add(launch_shape(d, dtype).vectors)
    assert returned <= set(cases)


def _bf16_close(got: torch.Tensor, want):
    g = got.double().numpy()
    w = np.asarray(jnp.asarray(want).astype(jnp.float32), np.float64)
    mag = np.maximum(np.maximum(np.abs(g), np.abs(w)), 2.0 ** -126)
    ulp = np.exp2(np.floor(np.log2(mag)) - 7)
    assert (np.abs(g - w) <= ulp + TOL * np.abs(w).max()).all()


@pytest.mark.parametrize("rows", [1, 4, 5])
@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("d", WIDTHS)
def test_plain_version_matches_pallas_at_the_registered_widths(d, dt, rows):
    rng = np.random.default_rng(d + rows)
    x = (rng.standard_normal((rows, d)) * 2.0).astype(np.float32)
    w = (rng.standard_normal(d) * 0.1).astype(np.float32)
    xj, xt = jnp.asarray(x), torch.from_numpy(x)
    if dt == "bf16":
        xj, xt = xj.astype(jnp.bfloat16), xt.bfloat16()
    want = jx_rmsnorm(xj, jnp.asarray(w), eps=1e-6, interpret=True)
    got = rmsnorm_plain(xt, torch.from_numpy(w), eps=1e-6)
    assert got.dtype == xt.dtype and got.shape == (rows, d)
    # on CPU tensors the wrapper is the plain version
    assert torch.equal(rmsnorm(xt, torch.from_numpy(w), eps=1e-6), got)
    if dt == "bf16":
        _bf16_close(got, want)
    else:
        want = np.asarray(want, np.float64)
        err = np.abs(got.double().numpy() - want).max()
        assert err <= TOL * np.abs(want).max(), err


def _capped_launch_shape(d, dtype):
    """The rule as it stood before the general path walked rows in chunks
    (it refused wider rows): every width it took must keep its shape."""
    per = 16 // dtype.itemsize
    slots = -(-d // per)
    exact = [(slots // v, v) for v in (1, 2, 3, 4, 5, 6, 8)
             if d % per == 0 and slots % v == 0 and (slots // v) % 32 == 0
             and slots // v <= 256]
    if exact:
        pool = [s for s in exact if s[1] in range(2, 7)] or exact
        g, v = min(pool, key=lambda s: (abs(s[0] - 128), -s[0]))
        return (g, v, max(1, 128 // g), True)
    fits = [v for v in (1, 2, 3, 4, 5, 6, 8) if v * 256 >= slots]
    if not fits:
        raise ValueError(d)
    return (256, fits[0], 1, False)


#: the shapes at the registered widths, (bf16, fp32), as the rule gave
#: them before the chunked walk: phase 3 holds these launches' bits
REGISTERED_SHAPES = {
    1024: ((64, 2, 2, True), (128, 2, 1, True)),
    1280: ((32, 5, 4, True), (160, 2, 1, True)),
    2048: ((128, 2, 1, True), (128, 4, 1, True)),
    2560: ((160, 2, 1, True), (128, 5, 1, True)),
    3072: ((128, 3, 1, True), (128, 6, 1, True)),
    4096: ((128, 4, 1, True), (256, 4, 1, True)),
}
#: the widest row one CTA's registers cover: the cap the rule had
CAP = {dt: MAX_THREADS * max(VECTORS) * _per_vector(DTYPES[dt])
       for dt in DTYPES}


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("d", WIDTHS)
def test_registered_widths_keep_their_shape(d, dt):
    want = REGISTERED_SHAPES[d][0 if dt == "bf16" else 1]
    assert tuple(launch_shape(d, DTYPES[dt])) == want
    assert _capped_launch_shape(d, DTYPES[dt]) == want


@pytest.mark.parametrize("dt", DTYPES)
def test_every_width_up_to_the_old_cap_keeps_its_shape(dt):
    dtype = DTYPES[dt]
    per = _per_vector(dtype)
    widths = set(range(1, CAP[dt] + 1, 13)) | {CAP[dt], CAP[dt] - per}
    widths |= {v * g * per for v in VECTORS for g in range(32, 257, 32)}
    for d in sorted(widths):
        assert tuple(launch_shape(d, dtype)) == _capped_launch_shape(
            d, dtype), d


@pytest.mark.parametrize("d, dt", [(8200, "fp32"), (16392, "bf16"),
                                   (12288, "fp32"), (20480, "bf16"),
                                   (8201, "fp32"), (16390, "bf16")])
def test_a_row_past_the_cap_takes_the_chunked_path(d, dt):
    """Every thread of one CTA, the largest V, on 16-byte vectors where the
    width is a multiple of one (else the general path's scalars)."""
    assert d > CAP[dt]
    s = launch_shape(d, DTYPES[dt])
    assert s == (MAX_THREADS, max(VECTORS), 1,
                 d % _per_vector(DTYPES[dt]) == 0)
    # the chunks: MAX_THREADS x max(VECTORS) vectors each, the last masked
    span = MAX_THREADS * max(VECTORS) * _per_vector(DTYPES[dt])
    assert -(-d // span) >= 2


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("d", [1 << k for k in range(0, 17)])
def test_every_power_of_two_up_to_65536_has_a_shape(d, dt):
    s = launch_shape(d, DTYPES[dt])
    per = _per_vector(DTYPES[dt])
    if d > CAP[dt]:
        assert s == (MAX_THREADS, max(VECTORS), 1, True)
    elif s.vector:
        assert s.threads * s.vectors * per == d
    else:
        assert s.threads * s.vectors * per >= d


@pytest.mark.parametrize("rows", [1, 4, 5])
@pytest.mark.parametrize("d, dt", [(12288, "fp32"), (20480, "bf16")])
def test_plain_version_matches_pallas_past_the_cap(d, dt, rows):
    """fp32 within 1e-5 of the output's scale, bf16 within one rounding,
    as at the registered widths."""
    test_plain_version_matches_pallas_at_the_registered_widths(d, dt, rows)


def test_the_source_walks_wide_rows_with_the_largest_vector_count():
    src = (pathlib.Path(rms_mod.__file__).resolve().parent.parent / "csrc"
           / "rmsnorm.cu").read_text()
    assert re.findall(r"^constexpr int kWideV = (\d+);", src,
                      re.M) == [str(max(VECTORS))]
