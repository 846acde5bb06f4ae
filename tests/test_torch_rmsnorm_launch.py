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
  within 1e-5 of the output's scale, bf16 within one rounding.

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
    assert launch_shape(MAX_THREADS * max(VECTORS) * 4,
                        torch.float32).vector
    with pytest.raises(ValueError, match="takes d up to"):
        launch_shape(MAX_THREADS * max(VECTORS) * 4 + 1, torch.float32)


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
