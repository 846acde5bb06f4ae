"""The port's roofline accounting (``repro_torch.launch.roofline``) against
the JAX package's (``repro.launch.roofline``), and the B5–B9 work
formulas (``kernels.<k>.work``) against the counts ``chip_smoke.py``
wrote inline before they moved into the package.

Every comparison is exact: the same formulas on the same integers and
constants give the same floats.
"""
import pytest
import torch

from repro.configs import SHAPES as JX_SHAPES
from repro.configs import get_config as jx_get
from repro.configs import list_archs as jx_archs
from repro.launch.roofline import model_flops as jx_model_flops
from repro.launch.roofline import roofline as jx_roofline
from repro_torch.configs import SHAPES, get_config, list_archs
from repro_torch.kernels import flash_attention, fused_mlp, rglru, rmsnorm
from repro_torch.kernels import rwkv6
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.launch.roofline import (H100, V5E, collectives, model_flops,
                                         roofline)


def test_archs_and_shapes_are_the_references():
    assert list_archs() == jx_archs()
    assert list(SHAPES) == list(JX_SHAPES)


@pytest.mark.parametrize("arch", list_archs())
def test_model_flops_equals_the_reference(arch):
    """All ten archs × four shapes, exactly."""
    for name in SHAPES:
        assert model_flops(get_config(arch), SHAPES[name]) == \
            jx_model_flops(jx_get(arch), JX_SHAPES[name]), (arch, name)


GRID = [(197e12, 819e9, 0.0, 256, 197e12 * 256),     # test_roofline_terms_math
        (1.0e12, 3.0e9, 2.5e9, 256, 4.2e14),
        (5.0e10, 9.0e11, 1.0e6, 512, 1.0e13),
        (0.0, 0.0, 0.0, 8, 0.0),
        (3.3e13, 1.2e10, 4.4e11, 16, 5.0e14)]


@pytest.mark.parametrize("args", GRID)
def test_roofline_on_v5e_equals_the_reference(args):
    assert roofline(*args, hw=V5E).to_dict() == jx_roofline(*args).to_dict()


def test_roofline_terms_math_on_both_rows():
    """The reference's ``test_roofline_terms_math`` on each row's own
    peaks: one second of compute and one of memory."""
    for hw in (V5E, H100):
        peak = hw.flops["bfloat16"]
        t = roofline(flops_per_chip=peak, bytes_per_chip=hw.hbm_bw,
                     coll_bytes_per_chip=0.0, n_chips=256,
                     model_flops_total=peak * 256, hw=hw)
        assert t.compute_s == pytest.approx(1.0)
        assert t.memory_s == pytest.approx(1.0)
        assert t.dominant in ("compute", "memory")
        assert t.useful_flops_ratio == pytest.approx(1.0)
    # the port's default row is the H100's data sheet
    assert roofline(989e12, 0.0, 50e9, 1, 0.0).compute_s == 1.0
    assert roofline(989e12, 0.0, 50e9, 1, 0.0).collective_s == 1.0
    assert H100.hbm_bw == 3.35e12 and H100.flops["tf32"] == 495e12


def test_collectives_of_the_synthetic_exchanges():
    """``test_parse_collectives_synthetic``'s three collectives run as mesh
    exchanges on a (2, 2) mesh: an f32[128,256] all-reduce over all four
    slots, a bf16[64,64] all-gather (result) in groups of two, an f32[32]
    collective-permute; ``collectives`` gives that test's bytes."""
    mesh = make_local_mesh(2, 2, device="cpu")
    mesh.psum([torch.zeros(128, 256) for _ in range(4)],
              ("data", "model"))
    mesh.all_gather([torch.zeros(32, 64, dtype=torch.bfloat16)
                     for _ in range(4)], ("model",), 0)
    mesh.ppermute([torch.zeros(32) for _ in range(4)], ("data", "model"), 1)
    out = collectives(mesh)
    ar = 128 * 256 * 4 * 2 * 3 / 4          # 2(N-1)/N × bytes
    ag = 64 * 64 * 2 * 1 / 2                # (N-1)/N × bytes, N=2
    cp = 32 * 4
    assert out["all-reduce"] == pytest.approx(ar)
    assert out["all-gather"] == pytest.approx(ag)
    assert out["collective-permute"] == pytest.approx(cp)
    assert out["total"] == pytest.approx(ar + ag + cp)
    assert (out["n_all-reduce"], out["n_all-gather"],
            out["n_collective-permute"]) == (1, 1, 1)
    assert out["reduce-scatter"] == out["all-to-all"] == 0.0
    # slot 0's gather stands beside the kinds, outside the total
    mesh.gather([torch.zeros(16) for _ in range(4)], [0, 1, 2, 3], 0)
    out = collectives(mesh)
    assert out["gather"] == 3 * 16 * 4 and out["n_gather"] == 1
    assert out["total"] == pytest.approx(ar + ag + cp)
    mesh.reset_exchanged()
    assert collectives(mesh)["total"] == 0.0
    assert set(mesh.exchanged.values()) == {0}


def test_ppermute_moves_each_part_along_the_ring():
    mesh = make_local_mesh(2, 2, device="cpu")
    parts = [torch.full((3,), float(k)) for k in range(4)]
    out = mesh.ppermute(parts, ("model",), 1)
    # groups along "model": (0, 1) and (2, 3)
    assert [float(t[0]) for t in out] == [1.0, 0.0, 3.0, 2.0]


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def _attn_pairs(S, T, causal, window):
    """chip_smoke.py's former count: the mask's kept pairs."""
    qi = torch.arange(S)[:, None] + (T - S)
    kj = torch.arange(T)[None, :]
    keep = torch.ones(S, T, dtype=torch.bool)
    if causal:
        keep &= kj <= qi
    if window is not None:
        keep &= kj > qi - window
    return int(keep.sum())


@pytest.mark.parametrize("S,T,causal,window", [
    (1024, 1024, True, None), (300, 300, True, 96), (100, 164, True, None),
    (96, 130, False, None), (200, 200, False, 50), (164, 100, True, None)])
def test_b5_work_is_the_smoke_count(S, T, causal, window):
    B, H, KVH, E = 2, 8, 2, 64
    for dt in (torch.float32, torch.bfloat16):
        q, k = _meta(B, H, S, E, dtype=dt), _meta(B, KVH, T, E, dtype=dt)
        flops, nbytes = flash_attention.work(q, k, k, causal=causal,
                                             window=window)
        assert flops == 4 * B * H * E * _attn_pairs(S, T, causal, window)
        assert nbytes == (q.numel() * 2 + k.numel() * 2) * q.element_size()


def test_b6_b7_b8_b9_work_is_the_smoke_count():
    D, F_ = 4096, 12800
    for rows, gated in ((1024, True), (4, True), (300, False)):
        for dt in (torch.float32, torch.bfloat16):
            x = _meta(rows, D, dtype=dt)
            w = _meta(D, F_)
            flops, nbytes = fused_mlp.work(x, w if gated else None, w,
                                           _meta(F_, D))
            assert flops == (6 if gated else 4) * rows * D * F_
            assert nbytes == ((3 if gated else 2) * D * F_ * 4
                              + 2 * x.numel() * x.element_size())
            assert rmsnorm.work(x, _meta(D)) == (
                4 * x.numel(), 2 * x.numel() * x.element_size() + D * 4)
    B, S, D = 1, 4096, 2560
    for dt in (torch.float32, torch.bfloat16):
        x = _meta(B, S, D, dtype=dt)
        es = x.element_size()
        for h0 in (None, _meta(B, D)):
            assert rglru.work(x, x, x, _meta(D), h0) == (
                16 * B * S * D,
                4 * es * B * S * D + 4 * D
                + 4 * B * D * (1 if h0 is None else 2))
    B, H, S, E = 1, 64, 1024, 64
    n = B * H * S * E
    for dt in (torch.float32, torch.bfloat16):
        r = _meta(B, H, S, E, dtype=dt)
        es = r.element_size()
        for s0 in (None, _meta(B, H, E, E)):
            assert rwkv6.work(r, r, r, _meta(B, H, S, E), _meta(H, E),
                              s0) == (
                5 * n * E + 7 * n,
                4 * es * n + 4 * n + 4 * H * E
                + 4 * B * H * E * E * (1 if s0 is None else 2))
