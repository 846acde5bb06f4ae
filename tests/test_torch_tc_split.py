"""The split arithmetic of the tensor-core kernels B5 and B6, on the CPU.

* B6 (``kernels/fused_mlp.py``) takes its products from 17 rows up in the
  3×TF32 split: each fp32 operand as ``hi = tf32(a)`` and ``lo =
  tf32(a - hi)``, three terms (two for a bf16 x, which is exact in TF32).
  Against an fp64 product at D = 4096 the split keeps max |err| <= 2e-6 x
  max |product| (``SPLIT_TOL``); one TF32 pass does not.
* B5 (``kernels/flash_attention.py``) in bf16 splits P into ``P_hi =
  bf16(P)`` and ``P_lo = bf16(P - P_hi)``: its plain version stays within
  one bf16 rounding of JAX's fp32 ``flash_attention`` (Pallas, interpret
  mode) on the same bf16 values, the rule of ``_bf16_close`` in
  ``test_torch_llm_kernels.py``.  The one-rounding form ``bf16(P)·V`` is
  logged beside it, not asserted.

The CUDA kernels repeat this arithmetic; ``chip_smoke.py`` holds them
against these plain versions on the card.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.kernels.flash_attention import flash_attention as jx_flash
from repro_torch.kernels import flash_attention as flash_mod
from repro_torch.kernels.flash_attention import (flash_attention_plain,
                                                 split_bf16)
from repro_torch.kernels.fused_mlp import (TC_MIN_ROWS, fused_mlp_plain,
                                           launch_shape, matmul_3xtf32,
                                           split_tf32, tf32_round)

SPLIT_TOL = 2e-6
#: the fp32 margin of the one-bf16-rounding rule (``_bf16_close``)
FP32_MARGIN = 1e-5


def _rel_err(got: torch.Tensor, want: np.ndarray) -> float:
    return float(np.abs(got.double().numpy() - want).max()
                 / np.abs(want).max())


def _operands(seed, m=8, d=4096, n=64, bf16_a=False):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((m, d)).astype(np.float32)
    if bf16_a:
        a = torch.from_numpy(a).bfloat16().float().numpy()
    b = (rng.standard_normal((d, n)) * d ** -0.5).astype(np.float32)
    return torch.from_numpy(a), torch.from_numpy(b), a.astype(np.float64) @ b


def test_tf32_round_is_rna():
    """To nearest, ties away from zero, the low 13 bits cleared."""
    one = 1.0
    ulp = 2.0 ** -10
    t = torch.tensor([one + ulp / 2, -(one + ulp / 2), one + ulp / 4,
                      one + 3 * ulp / 4, 3.0], dtype=torch.float32)
    got = tf32_round(t)
    assert got.tolist() == [one + ulp, -(one + ulp), one, one + ulp, 3.0]
    assert not bool((got.view(torch.int32) & 0x1FFF).any())
    hi, lo = split_tf32(torch.tensor([1.0 + 2.0 ** -20], dtype=torch.float32))
    assert hi.item() == 1.0 and lo.item() == 2.0 ** -20


@pytest.mark.parametrize("terms,bf16_a", [(2, True), (3, False)],
                         ids=["2-term-bf16-x", "3-term-fp32"])
def test_3xtf32_within_2e6_of_fp64(terms, bf16_a):
    a, b, want = _operands(terms, bf16_a=bf16_a)
    assert _rel_err(matmul_3xtf32(a, b, terms), want) <= SPLIT_TOL


@pytest.mark.parametrize("bf16_a", [True, False], ids=["bf16-x", "fp32"])
def test_one_tf32_pass_fails_the_same_limit(bf16_a):
    a, b, want = _operands(7, bf16_a=bf16_a)
    err = _rel_err(tf32_round(a) @ tf32_round(b), want)
    assert err > SPLIT_TOL, err


@pytest.mark.parametrize("dtype,gated", [(torch.float32, True),
                                         (torch.bfloat16, True),
                                         (torch.float32, False)],
                         ids=["fp32-gated", "bf16-valued-x-gated", "fp32-relu2"])
def test_fused_mlp_plain_split_within_2e6_of_fp64(dtype, gated):
    """The whole MLP from ``TC_MIN_ROWS`` rows up: both products split.  A
    bf16 x takes the 2-term path and returns bf16: within 2e-6 of fp64
    before its one rounding to bf16 (half a bf16 ulp)."""
    M, D, F = TC_MIN_ROWS + 7, 4096, 96
    rng = np.random.default_rng(11)
    x = torch.from_numpy(rng.standard_normal((M, D)).astype(np.float32))
    x = x.to(dtype)
    wg, wu = ((rng.standard_normal((D, F)) * D ** -0.5).astype(np.float32)
              for _ in range(2))
    wd = (rng.standard_normal((F, D)) * F ** -0.5).astype(np.float32)
    act = "silu" if gated else "relu2"
    xd = x.double()
    up = xd @ torch.from_numpy(wu).double()
    if gated:
        gate = xd @ torch.from_numpy(wg).double()
        h = gate * torch.sigmoid(gate) * up
    else:
        h = torch.relu(up) ** 2
    want = (h @ torch.from_numpy(wd).double()).numpy()
    got = fused_mlp_plain(x, torch.from_numpy(wg) if gated else None,
                          torch.from_numpy(wu), torch.from_numpy(wd),
                          activation=act)
    assert got.dtype == dtype
    if dtype == torch.float32:
        assert _rel_err(got, want) <= SPLIT_TOL
        return
    g = got.double().numpy()
    mag = np.maximum(np.maximum(np.abs(g), np.abs(want)), 2.0 ** -126)
    half_ulp = np.exp2(np.floor(np.log2(mag)) - 8)
    assert (np.abs(g - want) <= half_ulp + SPLIT_TOL * np.abs(want).max()).all()


def test_fused_mlp_plain_rows_regime_is_exact_fp32():
    """Up to 16 rows (a decode step) the products are plain fp32."""
    rng = np.random.default_rng(12)
    x = torch.from_numpy(rng.standard_normal((4, 64)).astype(np.float32))
    wu = torch.from_numpy(rng.standard_normal((64, 32)).astype(np.float32))
    wd = torch.from_numpy(rng.standard_normal((32, 64)).astype(np.float32))
    got = fused_mlp_plain(x, None, wu, wd, activation="relu2")
    assert torch.equal(got, (torch.relu(x @ wu) ** 2) @ wd)


@pytest.mark.parametrize("m,f,want", [
    (1024, 12800, (64, 256)), (TC_MIN_ROWS, 7680, (64, 256)),
    (4, 12800, (4, 64)), (4, 7680, (4, 32)), (16, 14336, (16, 64)),
    (5, 1000, (16, 32))], ids=lambda v: str(v))
def test_launch_shape_regimes(m, f, want):
    assert launch_shape(m, f) == want


def _bf16_excess(got: torch.Tensor, want: np.ndarray) -> float:
    """max |got - want| / (one bf16 ulp of the element + the fp32 margin of
    max |want|): at most 1 under ``_bf16_close``'s rule."""
    g = got.double().numpy()
    mag = np.maximum(np.maximum(np.abs(g), np.abs(want)), 2.0 ** -126)
    ulp = np.exp2(np.floor(np.log2(mag)) - 7)
    return float((np.abs(g - want) / (ulp + FP32_MARGIN
                                      * np.abs(want).max())).max())


#: (B, H, KVH, S, T, E, causal, window)
SPLIT_CASES = {
    "e64-causal": (1, 4, 2, 96, 96, 64, True, None),
    "e80-window": (1, 4, 1, 70, 70, 80, True, 17),
    "e128-t-gt-s": (2, 4, 1, 40, 104, 128, True, None),
    "e256-noncausal": (1, 2, 1, 33, 50, 256, False, None),
}


@pytest.mark.parametrize("case", SPLIT_CASES, ids=list(SPLIT_CASES))
def test_flash_bf16_split_p_within_one_rounding(case, monkeypatch):
    B, H, KVH, S, T, E, causal, window = SPLIT_CASES[case]
    rng = np.random.default_rng(sum(map(ord, case)))
    tb = [torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
          .bfloat16() for shape in ((B, H, S, E), (B, KVH, T, E),
                                    (B, KVH, T, E))]
    want = np.asarray(jx_flash(*(jnp.asarray(t.float().numpy()) for t in tb),
                               causal=causal, window=window, q_block=32,
                               kv_block=32), np.float64)
    got = flash_attention_plain(*tb, causal=causal, window=window)
    assert got.dtype == torch.bfloat16
    excess = _bf16_excess(got, want)
    # the one-rounding form bf16(P)·V: P_lo taken as 0
    monkeypatch.setattr(flash_mod, "split_bf16", lambda p: (
        p.to(torch.bfloat16).float(), torch.zeros_like(p)))
    unsplit = _bf16_excess(flash_attention_plain(
        *tb, causal=causal, window=window), want)
    print(f"{case}: bf16 excess, P split {excess:.3f}, one bf16(P) "
          f"{unsplit:.3f}")
    assert excess <= 1.0


def test_split_bf16_keeps_sixteen_bits():
    p = torch.rand(4096, dtype=torch.float64).float()
    hi, lo = split_bf16(p)
    assert torch.equal(hi, hi.bfloat16().float())
    assert torch.equal(lo, lo.bfloat16().float())
    rel = ((hi + lo - p).abs() / p.abs().clamp_min(1e-30)).max().item()
    assert rel <= 2.0 ** -16
