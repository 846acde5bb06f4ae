"""The port's dense models and serving driver against the JAX package's.

Reduced configs (``ArchConfig.reduced()``: 3 layers, d 64, 4 heads of 16)
of granite-3-8b (gated silu, GQA), gemma-7b (gated tanh-gelu), minitron-8b
(non-gated relu²) and h2o-danube-1.8b (sliding window of 32 in the reduced
config); identical weights from JAX ``init_params`` through numpy and
``params_from_numpy``.

Both packages compute in bf16 with fp32 sums, but at different places in
different orders (XLA's and torch's einsum kernels; the port's B5 and B6
plain versions against the JAX package's CPU paths), so single bf16
roundings flip and the flips carry through the layers.  Logits and caches
are therefore held to ``ULPS`` bf16 ulps at the tensor's largest
magnitude (max |Δ| <= 8 · 2^(⌊log2 max|x|⌋ - 7), 3–6% of it); the
readings at writing were at most 3.5 ulps over every logit, cache and
decode step below.  A wrong mask, position or scale moves logits by
their own magnitude.  Generated tokens are held to equality, or, where they part,
to a near tie (top-2 gap of the JAX logits <= ``NEAR_TIE`` x max |logit|).

With the plan's kernel flags on, the JAX side is driven down its TPU
kernel path — ``pallas_attention`` and ``fused_mlp`` in Pallas interpret
mode — by a stand-in for the ``jax`` module inside ``repro.models.
transformer`` whose ``default_backend()`` answers "tpu" (nothing in
``src/repro`` changes); the port takes its kernels' plain versions on the
CPU tensors.
"""
import dataclasses
import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.configs import get_config as jx_get
from repro.core.policy import default_plan as jx_default_plan
from repro.launch.serve import greedy_generate as jx_generate
from repro.launch.serve import make_decode_fn as jx_make_decode
from repro.models import decode_step as jx_decode
from repro.models import forward as jx_forward
from repro.models import init_cache as jx_init_cache
from repro.models import init_params as jx_init_params
import repro.models.transformer as jx_transformer
from repro_torch import kernels
from repro_torch.api import Session
from repro_torch.configs import get_config as pt_get
from repro_torch.core.policy import default_plan as pt_default_plan
from repro_torch.launch.serve import ServeStats, greedy_generate
from repro_torch.models import (decode_step, forward, init_cache,
                                init_params, params_from_numpy)

ARCHS = ["granite-3-8b", "gemma-7b", "minitron-8b", "h2o-danube-1.8b"]
ULPS = 8
NEAR_TIE = 2e-2
#: the package module (``repro.kernels``'s attribute of that name is the
#: function it re-exports)
jx_fused_mlp = importlib.import_module("repro.kernels.fused_mlp")


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


class _TpuJax:
    """``jax`` as seen by ``repro.models.transformer`` with the kernel path
    selected: ``default_backend()`` says "tpu", everything else is jax."""

    def __getattr__(self, name):
        return getattr(jax, name)

    @staticmethod
    def default_backend():
        return "tpu"


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


@pytest.mark.parametrize("flags", [False, True],
                         ids=["plain-paths", "kernel-paths"])
def test_prefill_logits_and_caches_match_jax(arch, flags, monkeypatch):
    jplan, pplan = _plans(arch, flags)
    toks = _tokens(arch, (2, 40), 0)
    calls = []
    if flags:
        monkeypatch.setattr(jx_transformer, "jax", _TpuJax())
        for mod, name in ((jx_transformer, "pallas_attention"),
                          (jx_fused_mlp, "fused_mlp")):
            fn = getattr(mod, name)
            monkeypatch.setattr(mod, name, lambda *a, _fn=fn, _n=name, **k:
                                calls.append(_n) or _fn(*a, **k))
    jlogits, jcaches = jx_forward(arch["jparams"], arch["jcfg"], jplan,
                                  jnp.asarray(toks, jnp.int32),
                                  mode="prefill")
    # the JAX side took its Pallas kernels (in interpret mode) when asked
    assert set(calls) == ({"pallas_attention", "fused_mlp"} if flags
                          else set())
    before = kernels.launches()
    plogits, pcaches = forward(arch["pparams"], arch["pcfg"], pplan,
                               torch.from_numpy(toks))
    assert kernels.launches() == before          # CPU: plain versions
    assert plogits.dtype == torch.float32
    assert plogits.shape == (2, 40, arch["pcfg"].padded_vocab)
    assert _bf16_ulps(_np(plogits), _np(jlogits)) <= ULPS
    for layer, (k, v) in enumerate(pcaches):
        jk, jv = (c[layer] for c in jcaches["periods"][0])
        assert _bf16_ulps(_np(k), _np(jk)) <= ULPS
        assert _bf16_ulps(_np(v), _np(jv)) <= ULPS


@pytest.mark.parametrize("flags", [False, True],
                         ids=["plain-paths", "kernel-paths"])
def test_decode_steps_match_jax(arch, flags, monkeypatch):
    """Steps past the reduced window (32) and past the cache length, so the
    ring buffer wraps for h2o-danube."""
    jplan, pplan = _plans(arch, flags)
    if flags:
        monkeypatch.setattr(jx_transformer, "jax", _TpuJax())
    cache_len, n_steps = 36, 40
    toks = _tokens(arch, (2, n_steps), 1)
    jstep = jax.jit(jx_make_decode(arch["jcfg"], jplan))
    jc = jx_init_cache(arch["jcfg"], 2, cache_len)
    pc = init_cache(arch["pcfg"], 2, cache_len, device="cpu")
    worst = 0.0
    for t in range(n_steps):
        jl, jc = jstep(arch["jparams"], jc,
                       jnp.asarray(toks[:, t:t + 1], jnp.int32), jnp.int32(t))
        pl, pc = decode_step(arch["pparams"], pc, arch["pcfg"], pplan,
                             torch.from_numpy(toks[:, t:t + 1]), t)
        worst = max(worst, _bf16_ulps(_np(pl), _np(jl)))
    assert worst <= ULPS
    slot = jc["periods"]["slot0"]
    for layer, entry in enumerate(pc["layers"]):
        np.testing.assert_array_equal(entry["pos_idx"].numpy(),
                                      np.asarray(slot["pos_idx"][layer]))
        assert _bf16_ulps(_np(entry["k"]), _np(slot["k"][layer])) <= ULPS
        assert _bf16_ulps(_np(entry["v"]), _np(slot["v"][layer])) <= ULPS


def _near_tie_or_equal(a, jplan, jtoks, ptoks):
    if np.array_equal(jtoks, ptoks):
        return
    col = int(np.argmax((jtoks != ptoks).any(0)))
    cache = jx_init_cache(a["jcfg"], jtoks.shape[0], jtoks.shape[1])
    lg = None
    for t in range(col):
        lg, cache = jx_decode(a["jparams"], cache, a["jcfg"], jplan,
                              jnp.asarray(jtoks[:, t:t + 1]), jnp.int32(t))
    lg = np.asarray(lg[:, -1])
    top2 = np.sort(lg, -1)[:, -2:]
    gap = (top2[:, 1] - top2[:, 0]).min()
    assert gap <= NEAR_TIE * np.abs(lg).max(), (col, gap)


@pytest.mark.parametrize("flags", [False, True],
                         ids=["plain-paths", "kernel-paths"])
def test_generate_matches_jax(arch, flags):
    """The JAX side runs its CPU paths here (chunked attention, a bf16 MLP
    hidden); with the flags on the port computes the MLP hidden in fp32
    (B6), so there only a near tie may part them."""
    jplan, pplan = _plans(arch, flags)
    prompt = _tokens(arch, (2, 6), 1)
    jtoks = np.asarray(jx_generate(arch["jparams"], arch["jcfg"], jplan,
                                   jnp.asarray(prompt, jnp.int32), 10))
    bundle = Session(arch["pcfg"], device="cpu").default_plan(seq=64)
    bundle = dataclasses.replace(bundle, plan=pplan).serve()
    ptoks = bundle.generate(arch["pparams"], torch.from_numpy(prompt),
                            10).numpy()
    assert ptoks.shape == (2, 16)
    np.testing.assert_array_equal(ptoks[:, :6], prompt)
    if flags:
        _near_tie_or_equal(arch, jplan, jtoks, ptoks)
    else:
        np.testing.assert_array_equal(ptoks, jtoks)


def test_params_from_numpy_unstacks_layers(arch):
    p, cfg = arch["pparams"], arch["pcfg"]
    assert len(p["layers"]) == cfg.n_layers
    mine = init_params(cfg, seed=3, device="cpu")
    assert mine.keys() == p.keys()
    for got, ref in zip(p["layers"], mine["layers"]):
        assert got.keys() == ref.keys()
        for name in ("attn", "mlp"):
            for w in ref[name]:
                assert got[name][w].shape == ref[name][w].shape
                assert got[name][w].dtype == torch.float32
    stacked = np.asarray(arch["jparams"]["periods"]["slot0"]["attn"]["wq"])
    for i, layer in enumerate(p["layers"]):
        np.testing.assert_array_equal(layer["attn"]["wq"].numpy(),
                                      stacked[i])


def test_init_params_is_seeded():
    cfg = pt_get("granite-3-8b").reduced()
    a = init_params(cfg, seed=5, device="cpu")
    b = init_params(cfg, seed=5, device="cpu")
    c = init_params(cfg, seed=6, device="cpu")
    assert torch.equal(a["layers"][1]["mlp"]["w_gate"],
                       b["layers"][1]["mlp"]["w_gate"])
    assert not torch.equal(a["embed"], c["embed"])
    assert a["lm_head"].shape == (cfg.d_model, cfg.padded_vocab)


@pytest.mark.parametrize("name", ["granite-moe-1b-a400m", "rwkv6-7b",
                                  "recurrentgemma-2b"])
def test_other_families_are_not_ported(name):
    cfg = pt_get(name).reduced()
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        init_params(cfg, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        init_cache(cfg, 1, 8, device="cpu")


def test_session_serving_path_on_the_cpu():
    """The slice end to end on a reduced granite: trace -> analyze ->
    codesign -> lower -> serve() -> prefill + generate."""
    cfg = pt_get("granite-3-8b").reduced()
    plan = (Session(cfg, device="cpu").trace("prefill", batch=1, seq=64)
            .analyze().codesign().lower())
    assert plan.cfg is cfg
    bundle = plan.serve()
    params = init_params(cfg, seed=0, device="cpu")
    prompt = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab, (3, 8)))
    logits = bundle.prefill_fn(params, prompt)
    assert logits.shape == (3, 8, cfg.padded_vocab)
    assert bool(torch.isfinite(logits).all())
    toks = bundle.generate(params, prompt, 5)
    assert toks.shape == (3, 13)
    # the greedy driver is the decode step fed token by token
    again = greedy_generate(params, cfg, plan.plan, prompt, 5)
    assert torch.equal(toks, again)
    stats = ServeStats(tokens_generated=15, steps=12, wall_s=0.5)
    assert stats.tok_per_s == 30.0


def test_serving_path_runs_with_jax_absent():
    import os
    import pathlib
    import subprocess
    import sys
    root = pathlib.Path(__file__).resolve().parent.parent
    code = """
import sys
sys.modules["jax"] = None          # any import of jax now fails
from repro_torch.api import Session
from repro_torch.configs import get_config
from repro_torch.models import init_params
import torch
cfg = get_config("h2o-danube-1.8b").reduced()
bundle = (Session(cfg, device="cpu").trace("prefill", batch=1, seq=32)
          .analyze().codesign().lower().serve())
params = init_params(cfg, seed=0, device="cpu")
toks = bundle.generate(params, torch.zeros((1, 4), dtype=torch.long), 3)
loaded = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "repro") and sys.modules[m])
assert not loaded, loaded
print("ok", tuple(toks.shape))
"""
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300,
                         env={**os.environ, "PYTHONPATH": str(root / "src")})
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok (1, 7)"


def test_slice_cache_update_equals_select_update(arch):
    """``cache_select_update=False`` writes the ring-buffer slot in place
    of the broadcast-select: the same caches and logits, bitwise, past the
    window and the cache length."""
    _, plan = _plans(arch, False)
    cfg = arch["pcfg"]
    toks = torch.from_numpy(_tokens(arch, (2, 40), 3))
    caches = [init_cache(cfg, 2, 36, device="cpu") for _ in range(2)]
    plans = [plan, dataclasses.replace(plan, cache_select_update=False)]
    for t in range(40):
        out = [decode_step(arch["pparams"], c, cfg, p, toks[:, t:t + 1], t)
               for c, p in zip(caches, plans)]
        assert torch.equal(out[0][0], out[1][0])
        caches = [o[1] for o in out]
    for a, b in zip(*(c["layers"] for c in caches)):
        assert all(torch.equal(a[k], b[k]) for k in ("k", "v", "pos_idx"))
