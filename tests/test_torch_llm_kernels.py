"""The LLM kernels' plain versions against the JAX package's Pallas kernels.

* B5 — ``flash_attention_plain`` against ``repro.kernels.flash_attention``
  (Pallas in interpret mode on the CPU, ``ops.py:32``): causal and not, a
  sliding window, GQA 4:1, T > S (queries aligned to the end of the keys),
  ragged S and T, E = 64 / 80 / 128 / 256;
* B6 — ``fused_mlp_plain`` against ``repro.kernels.fused_mlp``: gated silu
  and gelu, plain relu², ragged M and F;
* B7 — ``rmsnorm_plain`` against ``repro.kernels.rmsnorm``;
* the attention functions of ``models/attention.py`` against their JAX
  twins.

All in fp32: max |port - JAX| <= 1e-5 x max |JAX| (``TOL``), the two sum
in other orders (the Pallas kernels by their own blocks, torch by its BLAS).
In bf16 the two round one fp32 result each, so they agree to one bf16 ulp
of the element plus that fp32 margin (``_bf16_close``).

Here on the CPU the wrappers take their plain versions and count no launch;
``chip_smoke.py`` holds the CUDA kernels against these same plain versions
on the card, and the ``gpu`` tests below do so when a card is present.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.kernels.flash_attention import flash_attention as jx_flash
from repro.kernels.fused_mlp import fused_mlp as jx_mlp
from repro.kernels.rmsnorm import rmsnorm as jx_rmsnorm
from repro.models import attention as jx_attn
from repro_torch import kernels
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_plain)
from repro_torch.kernels.fused_mlp import fused_mlp, fused_mlp_plain
from repro_torch.kernels.rmsnorm import rmsnorm, rmsnorm_plain
from repro_torch.models import attention as pt_attn

TOL = 1e-5


def _close(got, want, tol=TOL):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = max(np.abs(want).max(), 1e-30)
    err = np.abs(got - want).max()
    assert err <= tol * scale, (err, scale)


def _bf16_close(got: torch.Tensor, want, tol=TOL):
    """At most one bf16 ulp of the element apart, beyond the fp32 margin."""
    g = got.double().numpy()
    w = np.asarray(jnp.asarray(want).astype(jnp.float32), np.float64)
    mag = np.maximum(np.maximum(np.abs(g), np.abs(w)), 2.0 ** -126)
    ulp = np.exp2(np.floor(np.log2(mag)) - 7)
    assert (np.abs(g - w) <= ulp + tol * np.abs(w).max()).all()


def _randn(rng, shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


# ---------------------------------------------------------------------------
# B5 · flash attention
# ---------------------------------------------------------------------------

#: (B, H, KVH, S, T, E, causal, window)
FLASH_CASES = {
    "causal-mha": (2, 4, 4, 64, 64, 128, True, None),
    "noncausal-gqa4": (1, 8, 2, 48, 48, 128, False, None),
    "window-gqa4": (1, 8, 2, 96, 96, 64, True, 24),
    "t-gt-s-ragged": (2, 4, 1, 37, 101, 128, True, None),
    "noncausal-t-gt-s": (1, 2, 1, 20, 70, 80, False, None),
    "e256-ragged": (1, 2, 1, 45, 45, 256, True, None),
    "window-t-gt-s": (1, 4, 2, 50, 130, 80, True, 33),
}


@pytest.mark.parametrize("case", FLASH_CASES, ids=list(FLASH_CASES))
def test_flash_attention_plain_matches_pallas(case):
    B, H, KVH, S, T, E, causal, window = FLASH_CASES[case]
    rng = np.random.default_rng(sum(map(ord, case)))
    q, k, v = (_randn(rng, (B, H, S, E)), _randn(rng, (B, KVH, T, E)),
               _randn(rng, (B, KVH, T, E)))
    want = jx_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                    causal=causal, window=window, q_block=32, kv_block=32)
    before = kernels.launches()
    got = flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                          torch.from_numpy(v), causal=causal, window=window)
    assert kernels.launches() == before      # CPU: the plain version
    assert got.dtype == torch.float32 and got.shape == (B, H, S, E)
    _close(got, want)


def test_flash_attention_bf16_within_one_rounding():
    B, H, KVH, S, T, E = 1, 4, 1, 40, 72, 128
    rng = np.random.default_rng(5)
    q, k, v = (_randn(rng, (B, H, S, E)), _randn(rng, (B, KVH, T, E)),
               _randn(rng, (B, KVH, T, E)))
    jb = [jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v)]
    tb = [torch.from_numpy(a).bfloat16() for a in (q, k, v)]
    want = jx_flash(*jb, causal=True, q_block=32, kv_block=32)
    got = flash_attention(*tb, causal=True)
    assert got.dtype == torch.bfloat16
    _bf16_close(got, want)


def test_flash_attention_bshe_matches_pallas_attention():
    B, S, H, KVH, E = 2, 40, 4, 2, 64
    rng = np.random.default_rng(6)
    q, k, v = (_randn(rng, (B, S, H, E)), _randn(rng, (B, S, KVH, E)),
               _randn(rng, (B, S, KVH, E)))
    want = jx_attn.pallas_attention(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), causal=True, window=9,
                                    q_block=16, kv_block=16)
    got = pt_attn.flash_attention_bshe(torch.from_numpy(q),
                                       torch.from_numpy(k),
                                       torch.from_numpy(v), causal=True,
                                       window=9)
    assert got.shape == (B, S, H, E)
    _close(got, want)


# ---------------------------------------------------------------------------
# models/attention.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("causal,window,q_offset",
                         [(True, None, 0), (False, None, 0), (True, 7, 0),
                          (True, None, 5)],
                         ids=["causal", "full", "window", "offset"])
def test_naive_and_chunked_attention_match_jax(causal, window, q_offset):
    B, S, T, H, KVH, E = 2, 24, 24 + q_offset, 4, 2, 16
    rng = np.random.default_rng(7)
    q, k, v = (_randn(rng, (B, S, H, E)), _randn(rng, (B, T, KVH, E)),
               _randn(rng, (B, T, KVH, E)))
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    _close(pt_attn.naive_attention(tq, tk, tv, causal=causal, window=window,
                                   q_offset=q_offset),
           jx_attn.naive_attention(jq, jk, jv, causal=causal, window=window,
                                   q_offset=q_offset))
    _close(pt_attn.chunked_flash_attention(tq, tk, tv, causal=causal,
                                           window=window, kv_block=8,
                                           q_offset=q_offset),
           jx_attn.chunked_flash_attention(jq, jk, jv, causal=causal,
                                           window=window, kv_block=8,
                                           q_offset=q_offset))


@pytest.mark.parametrize("window", [None, 5], ids=["full", "window"])
def test_decode_attention_matches_jax(window):
    B, Z, H, KVH, E, pos = 2, 16, 4, 2, 16, 11
    rng = np.random.default_rng(8)
    q, kc, vc = (_randn(rng, (B, 1, H, E)), _randn(rng, (B, Z, KVH, E)),
                 _randn(rng, (B, Z, KVH, E)))
    want = jx_attn.decode_attention(jnp.asarray(q), jnp.asarray(kc),
                                    jnp.asarray(vc), jnp.int32(pos),
                                    window=window)
    got = pt_attn.decode_attention(torch.from_numpy(q), torch.from_numpy(kc),
                                   torch.from_numpy(vc), pos, window=window)
    _close(got, want)


# ---------------------------------------------------------------------------
# B6 · fused MLP
# ---------------------------------------------------------------------------

#: (M, D, F, gated, activation)
MLP_CASES = {
    "gated-silu": (64, 64, 256, True, "silu"),
    "gated-gelu": (48, 64, 192, True, "gelu"),
    "plain-relu2": (32, 64, 128, False, "relu2"),
    "ragged-m-f-silu": (37, 64, 200, True, "silu"),
    "ragged-m-f-relu2": (5, 32, 77, False, "relu2"),
}


@pytest.mark.parametrize("case", MLP_CASES, ids=list(MLP_CASES))
def test_fused_mlp_plain_matches_pallas(case):
    M, D, F, gated, act = MLP_CASES[case]
    rng = np.random.default_rng(sum(map(ord, case)))
    x = _randn(rng, (M, D))
    wg = _randn(rng, (D, F), D ** -0.5) if gated else None
    wu, wd = _randn(rng, (D, F), D ** -0.5), _randn(rng, (F, D), F ** -0.5)
    want = jx_mlp(jnp.asarray(x), None if wg is None else jnp.asarray(wg),
                  jnp.asarray(wu), jnp.asarray(wd), activation=act,
                  m_block=16, f_block=128)
    before = kernels.launches()
    got = fused_mlp(torch.from_numpy(x),
                    None if wg is None else torch.from_numpy(wg),
                    torch.from_numpy(wu), torch.from_numpy(wd),
                    activation=act)
    assert kernels.launches() == before
    _close(got, want)


def test_fused_mlp_bf16_x_fp32_weights():
    """The path's call: bf16 x, fp32 weights, bf16 out."""
    M, D, F = 20, 64, 96
    rng = np.random.default_rng(9)
    x = _randn(rng, (M, D))
    wg, wu = _randn(rng, (D, F), D ** -0.5), _randn(rng, (D, F), D ** -0.5)
    wd = _randn(rng, (F, D), F ** -0.5)
    want = jx_mlp(jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(wg),
                  jnp.asarray(wu), jnp.asarray(wd), activation="silu",
                  m_block=16, f_block=32)
    got = fused_mlp(torch.from_numpy(x).bfloat16(), torch.from_numpy(wg),
                    torch.from_numpy(wu), torch.from_numpy(wd))
    assert got.dtype == torch.bfloat16
    _bf16_close(got, want)


def test_fused_mlp_rejects_unknown_activation():
    x = torch.zeros(2, 4)
    w = torch.zeros(4, 8)
    with pytest.raises(ValueError, match="activation"):
        fused_mlp(x, None, w, w.T.contiguous(), activation="tanh")


# ---------------------------------------------------------------------------
# B7 · RMSNorm
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(64, 128), (5, 96), (2, 3, 64)],
                         ids=["rows64", "rows5", "rank3"])
def test_rmsnorm_plain_matches_pallas(shape):
    rng = np.random.default_rng(len(shape) * 10 + shape[0])
    x = _randn(rng, shape, 3.0)
    w = _randn(rng, shape[-1:], 0.2)
    want = jx_rmsnorm(jnp.asarray(x), jnp.asarray(w), eps=1e-6, row_block=8)
    got = rmsnorm(torch.from_numpy(x), torch.from_numpy(w), eps=1e-6)
    _close(got, want)
    _close(rmsnorm_plain(torch.from_numpy(x), torch.from_numpy(w)), want)


def test_rmsnorm_bf16_within_one_rounding():
    rng = np.random.default_rng(10)
    x, w = _randn(rng, (16, 128)), _randn(rng, (128,), 0.2)
    want = jx_rmsnorm(jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(w))
    got = rmsnorm(torch.from_numpy(x).bfloat16(), torch.from_numpy(w))
    assert got.dtype == torch.bfloat16
    _bf16_close(got, want)


def test_wrappers_refuse_a_device_they_cannot_run_on():
    """Operands on more than one device (the CPU and meta): the wrappers
    raise, they do not fall back.  All on meta is the dry run's path (the
    kernel's checks and empty outputs, nothing launched,
    ``tests/test_torch_dryrun.py``)."""
    q = torch.empty((1, 2, 4, 16), device="meta")
    with pytest.raises(ValueError, match="devices"):
        flash_attention(q, torch.zeros(1, 2, 4, 16), q)
    x = torch.empty((4, 16), device="meta")
    with pytest.raises(ValueError, match="devices"):
        rmsnorm(x, torch.zeros(16))
    with pytest.raises(ValueError, match="devices"):
        fused_mlp(torch.zeros(4, 16), None, torch.empty((16, 8),
                                                        device="meta"),
                  torch.empty((8, 16), device="meta"))
    before = kernels.launches()
    assert flash_attention(q, q, q).is_meta
    assert rmsnorm(x, torch.empty(16, device="meta")).is_meta
    assert fused_mlp(x, None, torch.empty((16, 8), device="meta"),
                     torch.empty((8, 16), device="meta")).is_meta
    assert kernels.launches() == before


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_kernels_match_plain_versions_on_the_card(cuda_device, dtype):
    g = torch.Generator(device=cuda_device).manual_seed(0)

    def rnd(*shape, scale=1.0):
        return torch.randn(shape, generator=g, device=cuda_device) * scale

    def hold(got, want):
        if dtype == torch.float32:
            _close(got.cpu(), want.cpu())
        else:
            _bf16_close(got.cpu(), want.float().cpu().numpy())

    for e in (128, 80, 256):
        q, k, v = (rnd(1, 8, 100, e).to(dtype), rnd(1, 2, 164, e).to(dtype),
                   rnd(1, 2, 164, e).to(dtype))
        hold(flash_attention(q, k, v, causal=True, window=50),
             flash_attention_plain(q, k, v, causal=True, window=50))
    wg, wu = rnd(256, 300, scale=0.06), rnd(256, 300, scale=0.06)
    wd = rnd(300, 256, scale=0.06)
    for rows in (37, 77, 5, 3):      # the tensor-core and the rows kernel
        x = rnd(rows, 256).to(dtype)
        hold(fused_mlp(x, wg, wu, wd), fused_mlp_plain(x, wg, wu, wd))
    w = rnd(256, scale=0.1)
    hold(rmsnorm(x, w), rmsnorm_plain(x, w))
