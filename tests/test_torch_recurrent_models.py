"""The port's recurrent families against the JAX package's.

Reduced configs (``ArchConfig.reduced()``: d 64, 4 heads of 16) of
recurrentgemma-2b (``hybrid``: ``[rglru, rglru, attn]``, MQA, a local
window of 32, gated tanh-gelu) and rwkv6-7b (``ssm``: 3 ``rwkv`` layers,
E = 16, relu²); identical weights from JAX ``init_params`` through numpy
and ``params_from_numpy``.

Held as ``tests/test_torch_models.py`` holds the dense family, and for the
same reasons: logits and caches (k/v, the RG-LRU's hT, the WKV state sT)
within ``ULPS`` bf16 ulps at the tensor's largest magnitude, generated
tokens equal or parted at a near tie.  Plain paths: the JAX side runs its
``lax.scan`` references and jnp attention/MLP, the port its plain
versions.  Kernel paths: the plan's kernel flags on, the JAX side driven
down its Pallas kernels in interpret mode — flash attention and the fused
MLP through a ``jax`` stand-in whose ``default_backend()`` answers "tpu",
and the recurrences by patching ``repro.models.transformer``'s
``apply_rglru_seq`` / ``apply_rwkv_seq`` to pass ``use_kernel=True``
(test-only; nothing in ``src/repro`` changes).  The port always sends the
prefill's recurrences through the B8/B9 wrappers, which take their plain
versions on the CPU.
"""
import dataclasses
import functools
import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import repro.api as jx_api
from repro.configs import get_config as jx_get
from repro.core.policy import default_plan as jx_default_plan
from repro.launch.serve import greedy_generate as jx_generate
from repro.launch.serve import make_decode_fn as jx_make_decode
from repro.models import decode_step as jx_decode
from repro.models import forward as jx_forward
from repro.models import init_cache as jx_init_cache
from repro.models import init_params as jx_init_params
from repro.models.transformer import period_structure as jx_periods
import repro.models.transformer as jx_transformer
import repro_torch.api as pt_api
from repro_torch import kernels
from repro_torch.api import Session
from repro_torch.configs import get_config as pt_get
from repro_torch.core.policy import default_plan as pt_default_plan
from repro_torch.models import (decode_step, forward, init_cache,
                                init_params, params_from_numpy)

ARCHS = ["recurrentgemma-2b", "rwkv6-7b"]
ULPS = 8
NEAR_TIE = 2e-2
jx_fused_mlp = importlib.import_module("repro.kernels.fused_mlp")
pt_rglru = importlib.import_module("repro_torch.kernels.rglru")
pt_rwkv6 = importlib.import_module("repro_torch.kernels.rwkv6")


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


def _jax_kernel_paths(monkeypatch, calls):
    """Drive the JAX model down its Pallas kernels (interpret mode) and
    record which were called."""
    monkeypatch.setattr(jx_transformer, "jax", _TpuJax())
    for mod, name in ((jx_transformer, "pallas_attention"),
                      (jx_fused_mlp, "fused_mlp")):
        fn = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _fn=fn, _n=name, **k:
                            calls.append(_n) or _fn(*a, **k))
    for name in ("apply_rglru_seq", "apply_rwkv_seq"):
        fn = functools.partial(getattr(jx_transformer, name),
                               use_kernel=True)
        monkeypatch.setattr(jx_transformer, name, lambda *a, _fn=fn,
                            _n=name, **k: calls.append(_n) or _fn(*a, **k))


def _jax_layer_caches(jcfg, jcaches):
    """The JAX prefill caches (stacked per period slot) in layer order."""
    period, n_periods, _rest = jx_periods(jcfg)
    out = [jax.tree.map(lambda t, _p=p_: t[_p], jcaches["periods"][s])
           for p_ in range(n_periods) for s in range(len(period))]
    return out + list(jcaches["rest"])


@pytest.mark.parametrize("flags", [False, True],
                         ids=["plain-paths", "kernel-paths"])
def test_prefill_logits_and_caches_match_jax(arch, flags, monkeypatch):
    jplan, pplan = _plans(arch, flags)
    toks = _tokens(arch, (2, 40), 0)
    calls = []
    if flags:
        _jax_kernel_paths(monkeypatch, calls)
    jlogits, jcaches = jx_forward(arch["jparams"], arch["jcfg"], jplan,
                                  jnp.asarray(toks, jnp.int32),
                                  mode="prefill")
    kinds = arch["pcfg"].layer_kinds()
    if flags:       # the JAX side took its Pallas kernels (interpret mode)
        want = {"fused_mlp"} | {
            {"attn": "pallas_attention", "rglru": "apply_rglru_seq",
             "rwkv": "apply_rwkv_seq"}[k] for k in kinds}
        assert set(calls) == want
    before = kernels.launches()
    plogits, pcaches = forward(arch["pparams"], arch["pcfg"], pplan,
                               torch.from_numpy(toks))
    assert kernels.launches() == before          # CPU: plain versions
    assert plogits.dtype == torch.float32
    assert plogits.shape == (2, 40, arch["pcfg"].padded_vocab)
    assert _bf16_ulps(_np(plogits), _np(jlogits)) <= ULPS
    jlayers = _jax_layer_caches(arch["jcfg"], jcaches)
    assert len(pcaches) == len(jlayers) == len(kinds)
    for kind, got, want in zip(kinds, pcaches, jlayers):
        if kind == "attn":
            for g, w in zip(got, want):
                assert _bf16_ulps(_np(g), _np(w)) <= ULPS
        else:
            assert got.dtype == torch.float32
            assert _bf16_ulps(_np(got), _np(want)) <= ULPS, kind


def test_prefill_goes_through_the_recurrence_wrappers(arch, monkeypatch):
    """``apply_block`` calls the B8/B9 wrappers (imported at call time, so
    a swap of the module attribute takes effect), once per layer."""
    calls = []
    for mod, name in ((pt_rglru, "rglru"), (pt_rwkv6, "wkv6")):
        fn = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _fn=fn, _n=name, **k:
                            calls.append(_n) or _fn(*a, **k))
    _, pplan = _plans(arch, False)
    forward(arch["pparams"], arch["pcfg"], pplan,
            torch.from_numpy(_tokens(arch, (1, 8), 4)))
    kinds = arch["pcfg"].layer_kinds()
    assert calls == [{"rglru": "rglru", "rwkv": "wkv6"}[k] for k in kinds
                     if k != "attn"]


@pytest.mark.parametrize("flags", [False, True],
                         ids=["plain-paths", "kernel-paths"])
def test_decode_steps_match_jax(arch, flags, monkeypatch):
    """Steps past the reduced window (32) and past the cache length, so the
    ring buffer of recurrentgemma's attention layer wraps."""
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
    period, n_periods, _rest = jx_periods(arch["jcfg"])
    kinds = arch["pcfg"].layer_kinds()
    for layer, entry in enumerate(pc["layers"]):
        p_, s = divmod(layer, len(period))
        want = {k: v[p_] for k, v in jc["periods"][f"slot{s}"].items()}
        assert entry.keys() == want.keys()
        if kinds[layer] == "attn":
            np.testing.assert_array_equal(entry["pos_idx"].numpy(),
                                          np.asarray(want["pos_idx"]))
            assert _bf16_ulps(_np(entry["k"]), _np(want["k"])) <= ULPS
            assert _bf16_ulps(_np(entry["v"]), _np(want["v"])) <= ULPS
        else:
            (key,) = entry
            assert entry[key].dtype == torch.float32
            assert _bf16_ulps(_np(entry[key]), _np(want[key])) <= ULPS


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
    """Tokens equal, or parted where the JAX logits hold a near tie: the
    logits are bf16 products over a 128-word reduced vocab, so exact ties
    occur (recurrentgemma's plain run ties at its 9th step)."""
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
    _near_tie_or_equal(arch, jplan, jtoks, ptoks)


def test_params_from_numpy_takes_mixed_period_slots(arch):
    p, cfg = arch["pparams"], arch["pcfg"]
    kinds = cfg.layer_kinds()
    assert len(p["layers"]) == cfg.n_layers
    mine = init_params(cfg, seed=3, device="cpu")
    assert mine.keys() == p.keys()
    period, n_periods, _rest = jx_periods(arch["jcfg"])
    for i, (kind, got, ref) in enumerate(zip(kinds, p["layers"],
                                             mine["layers"])):
        assert got.keys() == ref.keys() == {"ln1", "ln2", kind, "mlp"}
        for name in (kind, "mlp"):
            assert got[name].keys() == ref[name].keys()
            for w in ref[name]:
                assert got[name][w].shape == ref[name][w].shape
                assert got[name][w].dtype == ref[name][w].dtype \
                    == torch.float32
        p_, s = divmod(i, len(period))
        stacked = arch["jparams"]["periods"][f"slot{s}"][kind]
        for w, arr in stacked.items():
            np.testing.assert_array_equal(got[kind][w].numpy(),
                                          np.asarray(arr)[p_])


def test_full_hybrid_layout_and_remainder():
    """recurrentgemma-2b at full depth: 8 periods of [rglru, rglru, attn]
    and a remainder of 2 rglru layers; the cache entries follow the
    kinds."""
    cfg = pt_get("recurrentgemma-2b")
    kinds = cfg.layer_kinds()
    assert len(kinds) == 26 and kinds[-2:] == ["rglru", "rglru"]
    assert kinds.count("attn") == 8 and kinds.count("rglru") == 18
    small = dataclasses.replace(cfg.reduced(), n_layers=26)
    cache = init_cache(small, 2, 48, device="cpu")["layers"]
    for kind, entry in zip(small.layer_kinds(), cache):
        if kind == "attn":
            assert entry["k"].shape == (2, 32, 1, 16)       # window 32
        else:
            assert entry["h"].shape == (2, 64)
            assert entry["h"].dtype == torch.float32
    jtree = jax.tree.map(np.array, jx_init_params(
        jax.random.PRNGKey(1), dataclasses.replace(
            jx_get("recurrentgemma-2b").reduced(), n_layers=26)))
    layers = params_from_numpy(jtree, small, device="cpu")["layers"]
    assert [next(k for k in lay if k in ("attn", "rglru")) for lay in
            layers] == small.layer_kinds()
    np.testing.assert_array_equal(layers[25]["rglru"]["a_param"].numpy(),
                                  jtree["rest"][1]["rglru"]["a_param"])


def test_init_params_is_seeded():
    for name in ARCHS:
        cfg = pt_get(name).reduced()
        a = init_params(cfg, seed=5, device="cpu")
        b = init_params(cfg, seed=5, device="cpu")
        c = init_params(cfg, seed=6, device="cpu")
        kind = cfg.layer_kinds()[0]
        for w in a["layers"][0][kind]:
            assert torch.equal(a["layers"][0][kind][w],
                               b["layers"][0][kind][w])
            assert not torch.equal(a["layers"][0][kind][w],
                                   c["layers"][0][kind][w])
    ap = init_params(pt_get("recurrentgemma-2b").reduced(), seed=0,
                     device="cpu")["layers"][0]["rglru"]["a_param"]
    assert bool(((ap >= 0.9) & (ap < 1.1)).all())


#: (arch, prefill seq, layer_kind, the plan's flash / fused MLP / fused
#: RMSNorm): the traces the chip smoke plans each arch with, and the
#: default recurrentgemma trace, whose rglru layer turns flash off
PLAN_TRACES = [("recurrentgemma-2b", 4096, None, (False, True, True)),
               ("recurrentgemma-2b", 4096, "attn", (True, True, True)),
               ("rwkv6-7b", 1024, None, (False, True, True))]


@pytest.mark.parametrize("name,seq,layer_kind,flags", PLAN_TRACES,
                         ids=["recurrentgemma-default", "recurrentgemma-attn",
                              "rwkv6-default"])
def test_plan_equals_jax(name, seq, layer_kind, flags):
    kw = dict(batch=1, seq=seq, layer_kind=layer_kind)
    jx = jx_api.Session(name, use_cache=False).trace("prefill", **kw)
    pt = pt_api.Session(name, device="cpu").trace("prefill", **kw)
    jplan = jx.analyze().codesign().lower().plan
    pplan = pt.analyze().codesign().lower().plan
    assert dataclasses.asdict(pplan) == dataclasses.asdict(jplan)
    assert (pplan.use_flash_attention, pplan.use_fused_mlp,
            pplan.use_fused_rmsnorm) == flags


@pytest.mark.parametrize("name", ARCHS)
def test_session_serving_path_on_the_cpu(name):
    """The slice end to end on a reduced config: trace -> analyze ->
    codesign -> lower -> serve() -> prefill + generate, no launch."""
    cfg = pt_get(name).reduced()
    kind = "attn" if "attn" in cfg.layer_kinds() else None
    plan = (Session(cfg, device="cpu")
            .trace("prefill", batch=1, seq=64, layer_kind=kind)
            .analyze().codesign().lower())
    bundle = plan.serve()
    params = init_params(cfg, seed=0, device="cpu")
    prompt = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab, (3, 40)))
    before = kernels.launches()
    logits = bundle.prefill_fn(params, prompt)
    toks = bundle.generate(params, prompt[:, :8], 5)
    assert kernels.launches() == before
    assert logits.shape == (3, 40, cfg.padded_vocab)
    assert bool(torch.isfinite(logits).all())
    assert toks.shape == (3, 13)
    # decode logits at the last prompt position against the prefill's
    cache = init_cache(cfg, 3, 8, device="cpu")
    for t in range(8):
        dec, cache = bundle.decode_fn(params, cache, prompt[:, t:t + 1], t)
    pre = bundle.prefill_fn(params, prompt[:, :8])
    assert _bf16_ulps(_np(dec[:, -1]), _np(pre[:, -1])) <= ULPS
