"""The port's decode step in the form a CUDA graph captures, against its
own functional step and against the JAX package's.

Reduced configs of the three ported families, granite-3-8b (dense),
recurrentgemma-2b (hybrid, a local window of 32) and rwkv6-7b (ssm), with
identical weights from JAX ``init_params`` through numpy.  On the CPU:

* a 0-d int32 device-tensor ``pos`` gives the same logits and caches as a
  host-int ``pos``, bitwise;
* the donating form (``decode_step(..., donate=True)``, the counterpart of
  ``donate_argnums=(1,)``) equals the functional form bitwise and leaves
  its result in the caller's cache, which it returns;
* the donating step with a tensor ``pos`` holds against JAX's jitted
  ``decode_step`` within ``ULPS`` bf16 ulps at the tensor's largest
  magnitude, past the window and the cache length (the ring buffer wraps);
* ``ServeBundle.generate`` decodes through ``jit_decode_step``: tokens
  equal JAX's ``greedy_generate`` (or parted at a near tie), one dispatch
  a step, one trace a (params, cache) pair, and a second ``generate``
  traces nothing and gives the same tokens.
Both plan variants run: plain paths, and the kernel flags on (the port's
wrappers take their plain versions on the CPU).
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.configs import get_config as jx_get
from repro.core.policy import default_plan as jx_default_plan
from repro.launch.serve import greedy_generate as jx_generate
from repro.launch.serve import make_decode_fn as jx_make_decode
from repro.models import init_cache as jx_init_cache
from repro.models import init_params as jx_init_params
from repro.models.transformer import period_structure as jx_periods
from repro_torch.api import Session
from repro_torch.configs import get_config as pt_get
from repro_torch.core.policy import default_plan as pt_default_plan
from repro_torch.launch import jit_decode_step, reset_cache
from repro_torch.models import (decode_step, init_cache, params_from_numpy)

ARCHS = ["granite-3-8b", "recurrentgemma-2b", "rwkv6-7b"]
ULPS = 8
NEAR_TIE = 2e-2
CACHE_LEN, N_STEPS = 36, 40


def _bf16_ulps(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    ulp = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
    return float(np.abs(got - want).max() / ulp)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


@pytest.fixture(scope="module", params=ARCHS)
def arch(request):
    jcfg = jx_get(request.param).reduced()
    pcfg = pt_get(request.param).reduced()
    jparams = jx_init_params(jax.random.PRNGKey(0), jcfg)
    tree = jax.tree.map(lambda a: np.array(a), jparams)
    return dict(name=request.param, jcfg=jcfg, pcfg=pcfg, jparams=jparams,
                pparams=params_from_numpy(tree, pcfg, device="cpu"))


def _plans(a, flags: bool):
    kw = dict(use_flash_attention=flags, use_fused_mlp=flags)
    jplan = dataclasses.replace(jx_default_plan(a["jcfg"], seq=64), **kw)
    pplan = dataclasses.replace(pt_default_plan(a["pcfg"], seq=64), **kw,
                                use_fused_rmsnorm=flags)
    return jplan, pplan


def _tokens(a, shape, seed):
    return np.random.default_rng(seed).integers(0, a["jcfg"].vocab, shape)


def _assert_caches_equal(got, want):
    assert len(got["layers"]) == len(want["layers"])
    for g, w in zip(got["layers"], want["layers"]):
        assert g.keys() == w.keys()
        for k in g:
            assert g[k].dtype == w[k].dtype, k
            assert torch.equal(g[k], w[k]), k


FLAGS = pytest.mark.parametrize("flags", [False, True],
                                ids=["plain-paths", "kernel-paths"])


@FLAGS
def test_tensor_pos_equals_int_pos(arch, flags):
    _, pplan = _plans(arch, flags)
    cfg, params = arch["pcfg"], arch["pparams"]
    toks = torch.from_numpy(_tokens(arch, (2, N_STEPS), 2))
    c_int = init_cache(cfg, 2, CACHE_LEN, device="cpu")
    c_ten = init_cache(cfg, 2, CACHE_LEN, device="cpu")
    for t in range(N_STEPS):
        l_int, c_int = decode_step(params, c_int, cfg, pplan,
                                   toks[:, t:t + 1], t)
        l_ten, c_ten = decode_step(params, c_ten, cfg, pplan,
                                   toks[:, t:t + 1],
                                   torch.tensor(t, dtype=torch.int32))
        assert torch.equal(l_int, l_ten), t
        _assert_caches_equal(c_ten, c_int)


@FLAGS
def test_donating_step_equals_functional_bitwise(arch, flags):
    _, pplan = _plans(arch, flags)
    cfg, params = arch["pcfg"], arch["pparams"]
    toks = torch.from_numpy(_tokens(arch, (2, N_STEPS), 3))
    c_fun = init_cache(cfg, 2, CACHE_LEN, device="cpu")
    c_don = init_cache(cfg, 2, CACHE_LEN, device="cpu")
    held = [t for e in c_don["layers"] for t in e.values()]
    for t in range(N_STEPS):
        before = {id(x): x.clone() for x in held}
        l_fun, c_new = decode_step(params, c_fun, cfg, pplan,
                                   toks[:, t:t + 1], t)
        # the functional form leaves its input cache as it was
        l_don, c_ret = decode_step(params, c_don, cfg, pplan,
                                   toks[:, t:t + 1],
                                   torch.tensor(t, dtype=torch.int32),
                                   donate=True)
        assert c_ret is c_don
        assert [x for e in c_ret["layers"] for x in e.values()] == held
        assert torch.equal(l_fun, l_don), t
        _assert_caches_equal(c_don, c_new)
        assert any(not torch.equal(before[id(x)], x) for x in held)
        c_fun = c_new


@FLAGS
def test_donating_step_matches_jax(arch, flags):
    """Steps past the reduced window (32) and past the cache length, so the
    ring buffer of an attention layer wraps."""
    jplan, pplan = _plans(arch, flags)
    toks = _tokens(arch, (2, N_STEPS), 1)
    jstep = jax.jit(jx_make_decode(arch["jcfg"], jplan))
    jc = jx_init_cache(arch["jcfg"], 2, CACHE_LEN)
    pc = init_cache(arch["pcfg"], 2, CACHE_LEN, device="cpu")
    worst = 0.0
    for t in range(N_STEPS):
        jl, jc = jstep(arch["jparams"], jc,
                       jnp.asarray(toks[:, t:t + 1], jnp.int32), jnp.int32(t))
        pl, pc = decode_step(arch["pparams"], pc, arch["pcfg"], pplan,
                             torch.from_numpy(toks[:, t:t + 1]),
                             torch.tensor(t, dtype=torch.int32), donate=True)
        worst = max(worst, _bf16_ulps(_np(pl), _np(jl)))
    assert worst <= ULPS
    period, _n_periods, _rest = jx_periods(arch["jcfg"])
    for layer, entry in enumerate(pc["layers"]):
        p_, s = divmod(layer, len(period))
        want = {k: v[p_] for k, v in jc["periods"][f"slot{s}"].items()}
        assert entry.keys() == want.keys()
        for k, v in entry.items():
            if k == "pos_idx":
                np.testing.assert_array_equal(v.numpy(), np.asarray(want[k]))
            else:
                assert _bf16_ulps(_np(v), _np(want[k])) <= ULPS, k


def _near_tie_or_equal(a, jplan, jtoks, ptoks):
    if np.array_equal(jtoks, ptoks):
        return
    col = int(np.argmax((jtoks != ptoks).any(0)))
    cache = jx_init_cache(a["jcfg"], jtoks.shape[0], jtoks.shape[1])
    jstep = jax.jit(jx_make_decode(a["jcfg"], jplan))
    lg = None
    for t in range(col):
        lg, cache = jstep(a["jparams"], cache,
                          jnp.asarray(jtoks[:, t:t + 1]), jnp.int32(t))
    lg = np.asarray(lg[:, -1])
    top2 = np.sort(lg, -1)[:, -2:]
    gap = (top2[:, 1] - top2[:, 0]).min()
    assert gap <= NEAR_TIE * np.abs(lg).max(), (col, gap)


@FLAGS
def test_generate_through_the_step_matches_jax(arch, flags):
    """``generate`` of 4 x (16 + 32) tokens: 47 dispatches and one trace,
    then 94 and still one for a second call, whose tokens are the same."""
    jplan, pplan = _plans(arch, flags)
    prompt = _tokens(arch, (4, 16), 5)
    jtoks = np.asarray(jx_generate(arch["jparams"], arch["jcfg"], jplan,
                                   jnp.asarray(prompt, jnp.int32), 32))
    bundle = Session(arch["pcfg"], device="cpu").default_plan(seq=64)
    bundle = dataclasses.replace(bundle, plan=pplan).serve()
    first = bundle.generate(arch["pparams"], torch.from_numpy(prompt), 32)
    step = bundle.jit_decode(None, 4, 48)
    assert step.stats == {"traces": 1, "dispatches": 47}
    again = bundle.generate(arch["pparams"], torch.from_numpy(prompt), 32)
    assert step.stats == {"traces": 1, "dispatches": 94}
    assert torch.equal(first, again)
    assert first.shape == (4, 48)
    np.testing.assert_array_equal(first[:, :16].numpy(), prompt)
    _near_tie_or_equal(arch, jplan, jtoks, first.numpy())


def test_step_traces_once_per_params_and_cache(arch):
    _, pplan = _plans(arch, False)
    cfg, params = arch["pcfg"], arch["pparams"]
    step = jit_decode_step(cfg, pplan, None, 2, CACHE_LEN)
    assert step.stats == {"traces": 0, "dispatches": 0}
    tok = torch.from_numpy(_tokens(arch, (2, 1), 4))
    c1 = init_cache(cfg, 2, CACHE_LEN, device="cpu")
    c2 = init_cache(cfg, 2, CACHE_LEN, device="cpu")
    step(params, c1, tok, 0)
    step(params, c1, tok, 1)
    assert step.stats == {"traces": 1, "dispatches": 2}
    step(params, c2, tok, 0)                     # other cache buffers
    step(params, c2, tok, 1)
    other = dict(params)                          # another params object
    step(other, c2, tok, 2)
    assert step.stats == {"traces": 3, "dispatches": 5}
    with pytest.raises(ValueError, match="batch 2"):
        step(params, c1, torch.zeros((3, 1), dtype=torch.long), 2)
    with pytest.raises(ValueError, match="init_cache"):
        step(params, init_cache(cfg, 3, CACHE_LEN, device="cpu"), tok, 2)


def test_reset_cache_is_init_cache(arch):
    cfg = arch["pcfg"]
    _, pplan = _plans(arch, False)
    cache = init_cache(cfg, 2, CACHE_LEN, device="cpu")
    tok = torch.from_numpy(_tokens(arch, (2, 1), 6))
    for t in range(3):
        decode_step(arch["pparams"], cache, cfg, pplan, tok, t, donate=True)
    reset_cache(cache)
    _assert_caches_equal(cache, init_cache(cfg, 2, CACHE_LEN, device="cpu"))
