"""The recurrent kernels' plain versions against the JAX package's.

* B8 — ``rglru_plain`` (the kernel's chunked scan) against
  ``repro.kernels.rglru.rglru`` (Pallas in interpret mode, which its
  ``ops.py`` picks on the CPU) and against ``rglru_reference``: bf16 and
  fp32, h0 given and absent, a D that is not a multiple of the JAX
  kernel's ``d_block`` (which pads D, the port does not), S over several
  chunks with a ragged end, below one chunk, a 4096-step sequence (63
  carries), and a sequence split in two, also inside a chunk, whose
  second half starts from the first half's state; and long memory (Λ over
  [-12, -7], a close to 1, where the carries decide the result) against
  an fp64 scan of the plain version's own a and b, and against JAX beside
  a sequential fp32 scan (see that test for why);
* B9 — ``wkv6_plain`` (the kernel's chunked form) against
  ``repro.kernels.rwkv6.wkv6`` and ``wkv6_reference`` with the same cases
  (E = 16, 32, 64; S within one chunk, below one, over several with a
  ragged end; strong decays, w over [-8, 3]; a split inside a chunk);
* ``softplus`` against ``jax.nn.softplus``.

Tolerances: fp32 outputs and the fp32 states within ``TOL`` = 1e-5 of the
output's largest magnitude — both sides run the same fp32 recurrence, but
XLA's and torch's exp, sigmoid and sums round differently by an ulp or
two, and the scan carries those differences forward (decayed, not grown:
|a| < 1 and the WKV decay is < 1).  bf16 outputs are one bf16 rounding of
those fp32 values, so they agree to one bf16 ulp of the element beyond
the fp32 margin (``_bf16_close``).

Here on the CPU the wrappers take their plain versions and count no
launch; ``chip_smoke.py`` holds the CUDA kernels against these plain
versions on the card, and the ``gpu`` test below does so when a card is
present.
"""
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.kernels.rglru import rglru as jx_rglru
from repro.kernels.rglru import rglru_reference as jx_rglru_ref
from repro.kernels.rwkv6 import wkv6 as jx_wkv6
from repro.kernels.rwkv6 import wkv6_reference as jx_wkv6_ref
from repro_torch import kernels
from repro_torch.kernels import build
import repro_torch.kernels.rglru as pt_rglru
import repro_torch.kernels.rwkv6 as pt_rwkv6
from repro_torch.kernels.rglru import CHUNK as RGLRU_CHUNK
from repro_torch.kernels.rglru import rglru, rglru_plain, softplus
from repro_torch.kernels.rwkv6 import CHUNK, wkv6, wkv6_plain

TOL = 1e-5
DTYPES = {"fp32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _close(got, want, tol=TOL):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = max(np.abs(want).max(), 1e-30)
    err = np.abs(got - want).max()
    assert err <= tol * scale, (err, scale)


def _bf16_close(got, want, tol=TOL):
    """At most one bf16 ulp of the element apart, beyond the fp32 margin."""
    g = np.asarray(got, np.float64)
    w = np.asarray(want, np.float64)
    assert g.shape == w.shape
    mag = np.maximum(np.maximum(np.abs(g), np.abs(w)), 2.0 ** -126)
    ulp = np.exp2(np.floor(np.log2(mag)) - 7)
    assert (np.abs(g - w) <= ulp + tol * np.abs(w).max()).all(), \
        float(np.abs(g - w).max())


def _hold(got: torch.Tensor, want, dtype_id):
    """A port output against a JAX one of the same dtype."""
    g = got.float().numpy()
    w = np.asarray(jnp.asarray(want).astype(jnp.float32))
    if dtype_id == "fp32":
        _close(g, w)
    else:
        _bf16_close(g, w)


def _randn(rng, shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _pair(a: np.ndarray, dtype_id):
    """The same values as a JAX and a torch array of the dtype."""
    jdt, tdt = DTYPES[dtype_id]
    return jnp.asarray(a).astype(jdt), torch.from_numpy(a).to(tdt)


# ---------------------------------------------------------------------------
# B8 · RG-LRU
# ---------------------------------------------------------------------------

#: (B, S, D, the JAX kernel's d_block): the port's plain version runs
#: chunks of ``RGLRU_CHUNK`` steps, so S spans one chunk's part, several
#: with a ragged end, and less than one
RGLRU_CASES = {
    "aligned": (2, 24, 128, 64),
    "d-not-multiple-of-block": (1, 33, 200, 128),
    "d-below-block": (3, 9, 96, 512),
    "multi-chunk": (1, 3 * RGLRU_CHUNK + 5, 96, 64),
    "below-chunk": (2, RGLRU_CHUNK - 27, 64, 64),
}
#: long memory: Λ over [-12, -7] makes a step's decay a run from ~0.993 to
#: ~0.99995, so the state carries across many chunks
LONG_MEMORY = (-12.0, -7.0)


def _rglru_inputs(rng, B, S, D, dtype_id, with_h0, a_range=None):
    x, gr, gi = (_randn(rng, (B, S, D)) for _ in range(3))
    ap = (_randn(rng, (D,)) if a_range is None else
          rng.uniform(*a_range, D).astype(np.float32))
    h0 = _randn(rng, (B, D)) if with_h0 else None
    jx = [_pair(t, dtype_id)[0] for t in (x, gr, gi)] + [jnp.asarray(ap)]
    pt = [_pair(t, dtype_id)[1] for t in (x, gr, gi)] + [
        torch.from_numpy(ap)]
    jh0 = None if h0 is None else jnp.asarray(h0)
    ph0 = None if h0 is None else torch.from_numpy(h0)
    return jx, jh0, pt, ph0


@pytest.mark.parametrize("with_h0", [True, False], ids=["h0", "no-h0"])
@pytest.mark.parametrize("dtype_id", list(DTYPES))
@pytest.mark.parametrize("case", RGLRU_CASES, ids=list(RGLRU_CASES))
def test_rglru_plain_matches_pallas_and_reference(case, dtype_id, with_h0):
    B, S, D, db = RGLRU_CASES[case]
    rng = np.random.default_rng(31)
    jx, jh0, pt, ph0 = _rglru_inputs(rng, B, S, D, dtype_id, with_h0)
    y, hT = rglru_plain(*pt, ph0)
    assert y.dtype == pt[0].dtype and hT.dtype == torch.float32
    for jy, jhT in (jx_rglru(*jx, jh0, d_block=db), jx_rglru_ref(*jx, jh0)):
        _hold(y, jy, dtype_id)
        _close(hT.numpy(), np.asarray(jhT))


@pytest.mark.parametrize("dtype_id", list(DTYPES))
def test_rglru_split_sequence_carries_the_state(dtype_id):
    B, S, D = 2, 32, 200
    rng = np.random.default_rng(32)
    jx, _, pt, _ = _rglru_inputs(rng, B, S, D, dtype_id, False)
    jy, jhT = jx_rglru(*jx, d_block=128)
    cut = 13
    y1, h1 = rglru_plain(*[t[:, :cut] for t in pt[:3]], pt[3])
    y2, h2 = rglru_plain(*[t[:, cut:] for t in pt[:3]], pt[3], h1)
    _hold(torch.cat([y1, y2], 1), jy, dtype_id)
    _close(h2.numpy(), np.asarray(jhT))


@pytest.mark.parametrize("dtype_id", list(DTYPES))
def test_rglru_split_inside_a_chunk_carries_the_state(dtype_id):
    """Cut in the middle of the plain version's second chunk: the second
    call's chunks start at the cut, so the two halves are chunked
    differently from the whole; both agree with JAX's interpret-mode
    kernel and its sequential reference."""
    B, S, D = 1, 3 * RGLRU_CHUNK + 3, 96
    rng = np.random.default_rng(37)
    jx, _, pt, _ = _rglru_inputs(rng, B, S, D, dtype_id, False)
    cut = RGLRU_CHUNK + 7
    y1, h1 = rglru_plain(*[t[:, :cut] for t in pt[:3]], pt[3])
    y2, h2 = rglru_plain(*[t[:, cut:] for t in pt[:3]], pt[3], h1)
    for jy, jhT in (jx_rglru(*jx, d_block=128), jx_rglru_ref(*jx)):
        _hold(torch.cat([y1, y2], 1), jy, dtype_id)
        _close(h2.numpy(), np.asarray(jhT))


def test_rglru_plain_long_sequence_within_tol_of_reference():
    """4096 steps, 64 chunks, in fp32: the error the 63 carries add stays
    within ``TOL`` of scale of JAX's sequential reference."""
    B, S, D = 1, 4096, 16
    rng = np.random.default_rng(38)
    jx, jh0, pt, ph0 = _rglru_inputs(rng, B, S, D, "fp32", True)
    y, hT = rglru_plain(*pt, ph0)
    jy, jhT = jx_rglru_ref(*jx, jh0)
    _close(y.numpy(), np.asarray(jy))
    _close(hT.numpy(), np.asarray(jhT))


#: (B, S, D) of the long-memory cases: several chunks with a ragged end,
#: and 4096 steps (63 carries)
RGLRU_LONG_CASES = {"multi-chunk": (1, 3 * RGLRU_CHUNK + 5, 128),
                    "4096-steps": (1, 4096, 16)}


@pytest.mark.parametrize("with_h0", [True, False], ids=["h0", "no-h0"])
@pytest.mark.parametrize("dtype_id", list(DTYPES))
@pytest.mark.parametrize("case", RGLRU_LONG_CASES,
                         ids=list(RGLRU_LONG_CASES))
def test_rglru_plain_long_memory_carries(case, dtype_id, with_h0):
    """Long memory, where the carries between chunks decide the result.

    The scan h = a·h + b is well conditioned (a ≤ 1), but b's factor
    sqrt(1 − a²) is not at a near 1: one ulp of a moves it by up to ~6e-4.
    torch's and XLA's exp part by an ulp for ~3% of the a here, so two
    fp32 evaluations of the reference's own formula, the port's sequential
    one and JAX's, sit up to ~1.6e-4 of scale apart over 4096 steps, chunks
    or none (``-s`` prints the gap).  So the chunked form is held, within
    ``TOL``, to an fp64 scan of its own a and b (the carries' error
    alone), and against JAX's kernel and reference to no farther than a
    sequential fp32 scan of the same a and b is, plus ``TOL`` of scale."""
    B, S, D = RGLRU_LONG_CASES[case]
    rng = np.random.default_rng(39)
    jx, jh0, pt, ph0 = _rglru_inputs(rng, B, S, D, dtype_id, with_h0,
                                     LONG_MEMORY)
    y, hT = rglru_plain(*pt, ph0)
    a, b = pt_rglru.decay_and_input(*pt)
    h = np.zeros((B, D)) if ph0 is None else ph0.double().numpy()
    h32 = torch.zeros((B, D)) if ph0 is None else ph0.clone()
    exact = np.empty((B, S, D))
    seq = torch.empty((B, S, D))
    a64, b64 = a.double().numpy(), b.double().numpy()
    for t in range(S):
        h = a64[:, t] * h + b64[:, t]
        exact[:, t] = h
        h32 = a[:, t] * h32 + b[:, t]
        seq[:, t] = h32
    got = y.float().numpy()
    if dtype_id == "fp32":
        _close(got, exact)
    else:
        _bf16_close(got, torch.from_numpy(exact).to(y.dtype).float().numpy())
    _close(hT.numpy(), h)
    seq = seq.to(y.dtype).float().numpy()
    gaps = []
    for jy, jhT in (jx_rglru(*jx, jh0, d_block=128), jx_rglru_ref(*jx, jh0)):
        for mine, theirs, ref in (
                (got, seq, np.asarray(jnp.asarray(jy).astype(jnp.float32))),
                (hT.numpy(), h32.numpy(), np.asarray(jhT))):
            scale = np.abs(ref).max()
            gap = np.abs(theirs - ref).max()
            err = np.abs(mine - ref).max()
            assert err <= gap + TOL * scale, (err, gap, scale)
            gaps.append(gap / scale)
    print(f"{case} {dtype_id}: chunked vs fp64 scan "
          f"{np.abs(hT.numpy() - h).max() / np.abs(h).max():.2e} (hT); "
          f"sequential fp32 vs JAX up to {max(gaps):.2e} of scale")


# ---------------------------------------------------------------------------
# B9 · WKV6
# ---------------------------------------------------------------------------

#: (B, H, S, E): the port's plain version runs chunks of ``CHUNK`` steps,
#: so S spans one chunk, below one chunk, and several with a ragged end
WKV6_CASES = {"e32": (1, 2, 16, 32), "e64": (2, 3, 9, 64),
              "e16-long": (1, 1, 40, 16),
              "multi-chunk": (1, 2, 2 * CHUNK + 5, 32),
              "below-chunk": (2, 2, CHUNK - 11, 64),
              "strong-decay": (1, 2, 2 * CHUNK + 5, 64)}
#: the log decay's draw per case (default: normal, sd 0.5): strong decays,
#: w over [-8, 3], make a step's decay run from ~0.9997 to ~2e-9
WKV6_W_RANGE = {"strong-decay": (-8.0, 3.0)}


def _wkv6_inputs(rng, B, H, S, E, dtype_id, with_s0, w_range=None):
    r = _randn(rng, (B, H, S, E))
    k = _randn(rng, (B, H, S, E), 0.3)
    v = _randn(rng, (B, H, S, E))
    w = (_randn(rng, (B, H, S, E), 0.5) if w_range is None else
         rng.uniform(*w_range, (B, H, S, E)).astype(np.float32))
    u = _randn(rng, (H, E), 0.3)
    s0 = _randn(rng, (B, H, E, E), 0.2) if with_s0 else None
    jx = [_pair(t, dtype_id)[0] for t in (r, k, v)] + [
        jnp.asarray(w), jnp.asarray(u)]
    pt = [_pair(t, dtype_id)[1] for t in (r, k, v)] + [
        torch.from_numpy(w), torch.from_numpy(u)]
    js0 = None if s0 is None else jnp.asarray(s0)
    ps0 = None if s0 is None else torch.from_numpy(s0)
    return jx, js0, pt, ps0


@pytest.mark.parametrize("with_s0", [True, False], ids=["s0", "no-s0"])
@pytest.mark.parametrize("dtype_id", list(DTYPES))
@pytest.mark.parametrize("case", WKV6_CASES, ids=list(WKV6_CASES))
def test_wkv6_plain_matches_pallas_and_reference(case, dtype_id, with_s0):
    B, H, S, E = WKV6_CASES[case]
    rng = np.random.default_rng(33)
    jx, js0, pt, ps0 = _wkv6_inputs(rng, B, H, S, E, dtype_id, with_s0,
                                    WKV6_W_RANGE.get(case))
    y, sT = wkv6_plain(*pt, ps0)
    assert y.dtype == pt[0].dtype and sT.dtype == torch.float32
    for jy, jsT in (jx_wkv6(*jx, js0), jx_wkv6_ref(*jx, js0)):
        _hold(y, jy, dtype_id)
        _close(sT.numpy(), np.asarray(jsT))


@pytest.mark.parametrize("dtype_id", list(DTYPES))
def test_wkv6_split_sequence_carries_the_state(dtype_id):
    B, H, S, E = 1, 2, 24, 32
    rng = np.random.default_rng(34)
    jx, _, pt, _ = _wkv6_inputs(rng, B, H, S, E, dtype_id, False)
    jy, jsT = jx_wkv6(*jx)
    cut = 11
    y1, s1 = wkv6_plain(*[t[:, :, :cut] for t in pt[:4]], pt[4])
    y2, s2 = wkv6_plain(*[t[:, :, cut:] for t in pt[:4]], pt[4], s1)
    _hold(torch.cat([y1, y2], 2), jy, dtype_id)
    _close(s2.numpy(), np.asarray(jsT))


@pytest.mark.parametrize("dtype_id", list(DTYPES))
def test_wkv6_split_inside_a_chunk_carries_the_state(dtype_id):
    """Cut in the middle of the plain version's second chunk, with strong
    decays: the second call's chunks start at the cut, so the two halves
    are chunked differently from the whole; both agree with JAX's
    interpret-mode kernel and its sequential reference."""
    B, H, S, E = 1, 2, 3 * CHUNK + 3, 64
    rng = np.random.default_rng(36)
    jx, _, pt, _ = _wkv6_inputs(rng, B, H, S, E, dtype_id, False,
                                (-8.0, 3.0))
    cut = CHUNK + 7
    y1, s1 = wkv6_plain(*[t[:, :, :cut] for t in pt[:4]], pt[4])
    y2, s2 = wkv6_plain(*[t[:, :, cut:] for t in pt[:4]], pt[4], s1)
    for jy, jsT in (jx_wkv6(*jx), jx_wkv6_ref(*jx)):
        _hold(torch.cat([y1, y2], 2), jy, dtype_id)
        _close(s2.numpy(), np.asarray(jsT))


# ---------------------------------------------------------------------------
# the wrappers on the CPU
# ---------------------------------------------------------------------------

def test_softplus_is_jax_form():
    x = np.array([-100.0, -20.0, -1.0, -1e-3, 0.0, 1e-3, 0.5, 1.0, 15.0,
                  20.0, 25.0, 100.0], np.float32)
    got = softplus(torch.from_numpy(x)).numpy()
    want = np.asarray(jax.nn.softplus(jnp.asarray(x)))
    # XLA on the CPU flushes subnormal results (softplus(-100)) to zero
    np.testing.assert_allclose(got, want, rtol=2e-7,
                               atol=np.finfo(np.float32).tiny)


def test_wrappers_on_cpu_tensors_run_plain_and_count_no_launch():
    rng = np.random.default_rng(35)
    _, _, pt, ph0 = _rglru_inputs(rng, 2, 10, 48, "bf16", True)
    _, _, qt, qs0 = _wkv6_inputs(rng, 1, 2, 10, 16, "bf16", True)
    before = kernels.launches()
    got = rglru(*pt, ph0)
    want = rglru_plain(*pt, ph0)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    got = wkv6(*qt, qs0)
    want = wkv6_plain(*qt, qs0)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert kernels.launches() == before
    assert {"rglru", "wkv6"} <= set(before)


def test_wrappers_refuse_a_device_they_cannot_run_on():
    """Neither the CPU nor a CUDA device, or a mix: the wrappers raise,
    they do not fall back."""
    x = torch.empty((1, 4, 16), device="meta")
    ap = torch.empty(16, device="meta")
    with pytest.raises(ValueError, match="devices"):
        rglru(x, x, x, ap)
    with pytest.raises(ValueError, match="devices"):
        rglru(torch.zeros(1, 4, 16), torch.zeros(1, 4, 16),
              torch.zeros(1, 4, 16), torch.zeros(16),
              torch.empty((1, 16), device="meta"))
    r = torch.empty((1, 2, 4, 16), device="meta")
    with pytest.raises(ValueError, match="devices"):
        wkv6(r, r, r, r, torch.empty((2, 16), device="meta"))


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
    """B8 at a D that no block divides, over two chunks with a ragged end,
    and over several chunks with long memory (Λ over [-12, -7]); B9 at E =
    16 and 64 on the model's transposed (B, S, H, E) views (at E = 64 also
    with strong decays, w over [-8, 3]); both with and without a state.
    B8 counts one launch a call and repeats bitwise."""
    g = torch.Generator(device=cuda_device).manual_seed(0)

    def rnd(*shape, scale=1.0):
        return torch.randn(shape, generator=g, device=cuda_device) * scale

    def hold(got, want):
        if got.dtype == torch.float32:
            _close(got.cpu().numpy(), want.cpu().numpy())
        else:
            _bf16_close(got.float().cpu().numpy(),
                        want.float().cpu().numpy())

    B, S, D = 2, 70, 300
    ap, h0 = rnd(D), rnd(B, D)
    ap_long = torch.rand(D, generator=g, device=cuda_device) * 5.0 - 12.0
    for S_, a_ in ((S, ap), (5 * RGLRU_CHUNK + 9, ap_long)):
        x, gr, gi = (rnd(B, S_, D).to(dtype) for _ in range(3))
        for init in (None, h0):
            before = kernels.launches()["rglru"]
            got = rglru(x, gr, gi, a_, init)
            assert kernels.launches()["rglru"] == before + 1
            for a, b, c in zip(got, rglru(x, gr, gi, a_, init),
                               rglru_plain(x, gr, gi, a_, init)):
                assert torch.equal(a, b)
                hold(a, c)
    for H, E, strong in ((3, 16, False), (2, 64, False), (2, 64, True)):
        r, k, v = (rnd(B, S, H, E, scale=sc).to(dtype).transpose(1, 2)
                   for sc in (1.0, 0.3, 1.0))
        w = (torch.rand((B, S, H, E), generator=g, device=cuda_device)
             * 11.0 - 8.0 if strong else rnd(B, S, H, E, scale=0.5)
             ).transpose(1, 2)
        u, s0 = rnd(H, E, scale=0.3), rnd(B, H, E, E, scale=0.2)
        for init in (None, s0):
            got = wkv6(r, k, v, w, u, init)
            assert got[0].stride() == r.stride()
            for a, b in zip(got, wkv6_plain(r, k, v, w, u, init)):
                hold(a, b)
