"""How the LLM mesh partitions attention and the loss, on the CPU: the
three attention forms of ``models.sharded`` (split, query-split, gather),
the sequence-sharded decode combine, the vocab-parallel cross-entropy of
``launch.train``, and the exchanges each moves, against the unsharded
port and the JAX package's compiled decode cell.

Reduced configs take weights from JAX ``init_params`` through
``params_from_numpy``.  Logits are held to ``LLM_TOL`` / ``DECODE_TOL``
(the largest difference over the largest magnitude, as ``chip_smoke.py``
holds them), caches to ``ULPS`` bf16 ulps at the tensor's largest
magnitude (``tests/test_torch_mesh_serve.py``'s standard), the loss and
gradients to ``max(MIN_TOL, 2 x spread)`` of the unsharded step's, the
spread being its kernel-flags run's against its flags-off run's.
"""
import dataclasses
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
from repro.configs import get_config as jx_get
from repro.models import init_params as jx_init_params
from repro_torch.configs import get_config, list_archs
from repro_torch.configs.base import ShapeSpec
from repro_torch.core.policy import default_plan
from repro_torch.launch import dryrun
from repro_torch.launch import shardings as shd
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.launch.roofline import collectives
from repro_torch.launch.serve import jit_decode_step
from repro_torch.launch.train import (TrainConfig, cross_entropy,
                                      make_loss_fn, make_mesh_loss_fn,
                                      value_and_grad,
                                      vocab_parallel_cross_entropy)
from repro_torch.models import (decode_step, forward, init_cache,
                                init_params, params_from_numpy, sharded)
from repro_torch.models import transformer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LLM_TOL = 5e-2
DECODE_TOL = 5e-2
ULPS = 8
MIN_TOL = 1e-3
IS_SHARDED = lambda x: isinstance(x, shd.Sharded)  # noqa: E731


def _rel(got, want) -> float:
    return float((got.float() - want.float()).abs().max()
                 / want.float().abs().max())


def _norm_rel(a, b) -> float:
    return float(torch.linalg.vector_norm(a.float() - b.float())
                 / torch.linalg.vector_norm(b.float()))


def _bf16_ulps(got, want) -> float:
    """The largest difference in bf16 ulps at ``want``'s largest
    magnitude; a block of zeros (never written) must be zeros."""
    got, want = got.double(), want.double()
    if not bool(want.any()):
        return 0.0 if not bool(got.any()) else float("inf")
    ulp = 2.0 ** (np.floor(np.log2(float(want.abs().max()))) - 7)
    return float((got - want).abs().max() / ulp)


def _reduced(arch, seed=0):
    """The reduced config with JAX's initial weights, and a kernel plan."""
    torch.set_num_threads(1)
    cfg = get_config(arch).reduced()
    tree = jax.tree.map(np.array, jx_init_params(jax.random.PRNGKey(seed),
                                                 jx_get(arch).reduced()))
    params = params_from_numpy(tree, cfg, device="cpu")
    plan = dataclasses.replace(default_plan(cfg, seq=64),
                               use_flash_attention=True, use_fused_mlp=True,
                               use_fused_rmsnorm=True)
    return cfg, plan, params


def _shard(cfg, params, mesh):
    return shd.shard_tree(params, shd.params_for(cfg, mesh)[1])


class _B5Heads:
    """B5's (query heads, kv heads) of every call, for the test only."""

    def __init__(self, monkeypatch):
        self.calls = []
        orig = transformer.FlashAttentionFn

        class Recorded:
            @staticmethod
            def apply(q, k, v, *args):
                self.calls.append((q.shape[2], k.shape[2]))
                return orig.apply(q, k, v, *args)
        monkeypatch.setattr(transformer, "FlashAttentionFn", Recorded)


# -- which form each block takes -------------------------------------------


def _expected_form(cfg, tp):
    if cfg.n_heads % tp:
        return "gather"
    return "split" if cfg.n_kv_heads % tp == 0 else "query"


@pytest.mark.parametrize("tp", [2, 4, 8, 16])
@pytest.mark.parametrize("arch", list_archs())
def test_every_arch_attention_form(arch, tp):
    """Every registered arch at its published widths, TP 2 to 16 on a
    meta mesh: split where TP divides the kv heads, query-split where it
    divides the query heads only, the gather fallback only where it does
    not divide the query heads (recurrentgemma-2b's 10 at TP 4, 8 and
    16, as the reference leaves its q unconstrained)."""
    cfg = get_config(arch)
    mesh = make_local_mesh(1, tp, device="meta")
    sp = _shard(cfg, init_params(cfg, device="meta"), mesh)
    walk = sharded._Walk(sp, cfg, default_plan(cfg, seq=64))
    forms = {walk.attn_form(L["attn"]) for L in sp["layers"] if "attn" in L}
    kinds = set(cfg.layer_kinds())
    assert bool(forms) == bool(kinds & {"attn", "xattn"})
    assert forms <= {_expected_form(cfg, tp)}
    if arch == "recurrentgemma-2b":
        assert forms == {"query" if tp == 2 else "gather"}
    if arch in ("granite-3-8b", "granite-moe-1b-a400m", "h2o-danube-1.8b",
                "llama-3.2-vision-11b", "minitron-8b"):
        assert forms == {"query" if tp == 16 else "split"}


# -- reduced granite-3-8b on (2, 4) against the unsharded port ---------------


@pytest.fixture(scope="module")
def granite():
    cfg, plan, params = _reduced("granite-3-8b")
    tok = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab, (4, 16)))
    return cfg, plan, params, tok


def test_query_split_prefill_matches_the_port(granite, monkeypatch):
    """2 kv heads at TP 4: every layer query-split, B5 on 1 query head
    and 1 kv head a slot (8 calls a layer); logits within ``LLM_TOL``
    and the gathered cache entries within ``ULPS`` of the unsharded run;
    the k / v columns all-gathered in runs of TP/KVH = 2 slots."""
    cfg, plan, params, tok = granite
    want, want_c = forward(params, cfg, plan, tok)
    mesh = make_local_mesh(2, 4, device="cpu")
    sp = _shard(cfg, params, mesh)
    walk = sharded._Walk(sp, cfg, plan)
    assert [walk.attn_form(L["attn"]) for L in sp["layers"]] == \
        ["query"] * cfg.n_layers
    b5 = _B5Heads(monkeypatch)
    got, got_c = sharded.forward(sp, cfg, plan, tok)
    assert b5.calls == [(1, 1)] * (8 * cfg.n_layers)
    assert _rel(got, want) <= LLM_TOL
    assert _rel(got[:, 1:], want[:, :-1]) > LLM_TOL
    for g, w in zip(got_c, want_c):
        for a, b in zip(g, w):
            assert a.shape == b.shape and _bf16_ulps(a, b) <= ULPS
    # k and v: each slot's (2, 16, 8) bf16 columns, runs of 2 slots
    B_l, S = 2, tok.shape[1]
    part = B_l * S * (cfg.n_kv_heads * cfg.resolved_head_dim // 4) * 2
    assert mesh.exchanged["all_gather"] == cfg.n_layers * 2 * 4 * (
        2 * 1 * part)
    assert mesh.exchanged["n_all_gather"] == 2 * cfg.n_layers


def test_sequence_sharded_decode_matches_the_port(granite):
    """``jit_decode_step`` on (2, 4), a 16-entry cache sequence-sharded
    4 ways, 5 steps: logits within ``DECODE_TOL`` of the unsharded step
    at each, every slot's cache block within ``ULPS`` of the unsharded
    cache's slice (``pos_idx`` equal); the step's exchanges are the
    formula's, with no cache bytes all-gathered."""
    cfg, plan, params, tok = granite
    B, Z, steps = 4, 16, 5
    mesh = make_local_mesh(2, 4, device="cpu")
    step = jit_decode_step(cfg, plan, mesh, B, Z)
    sp = _shard(cfg, params, mesh)
    sc = shd.shard_tree(init_cache(cfg, B, Z, device="cpu"),
                        step.c_shardings)
    assert sc["layers"][0]["k"].sharding.spec == ("data", "model", None,
                                                  None)
    cache = init_cache(cfg, B, Z, device="cpu")
    for t in range(steps):
        want, cache = decode_step(params, cache, cfg, plan, tok[:, t:t + 1],
                                  t)
        got, _ = step(sp, sc, tok[:, t:t + 1], t)
        assert _rel(got, want) <= DECODE_TOL, t
    for e_got, e_want in zip(sc["layers"], cache["layers"]):
        for name in ("k", "v"):
            leaf = e_got[name]
            for k, part in enumerate(leaf.parts):
                block = e_want[name][leaf.sharding.block(k, leaf.shape)]
                assert _bf16_ulps(part, block) <= ULPS, (name, k)
        for part in e_got["pos_idx"].parts:
            assert torch.equal(part, e_want["pos_idx"])
    # per layer and data group of 4 model slots (n = 4, n(n-1) b a
    # gather, 2(n-1) b a psum / pmax): q (2, 1, 16) bf16 gathered;
    # k_new, v_new (2, 1, 8) bf16 gathered; the scores' max and sum (2,
    # 2, 2, 1) fp32; the context (2, 2, 2, 16) fp32; wo's and the MLP's
    # partials (2, 1, 64) fp32; and the embedding's psum (2, 1, 64) fp32
    n, L, groups = 4, cfg.n_layers, 2
    ag = n * (n - 1) * (2 * 16 * 2 + 2 * (2 * 8 * 2))
    mx = 2 * (n - 1) * 2 * 2 * 2 * 4
    ps = 2 * (n - 1) * (2 * 2 * 2 * 4 + 2 * 2 * 2 * 16 * 4
                        + 2 * 2 * 64 * 4)
    x = step.exchanged
    assert x["all_gather"] == groups * L * ag
    assert x["pmax"] == groups * L * mx
    assert x["psum"] == groups * (L * ps + 2 * (n - 1) * 2 * 64 * 4)
    assert (x["n_all_gather"], x["n_pmax"], x["n_psum"]) == (
        3 * L, L, 4 * L + 1)
    # all of it is less than one slot's block of one layer's k cache
    block = 2 * (Z // n) * cfg.n_kv_heads * cfg.resolved_head_dim * 2
    assert x["all_gather"] / (groups * L * n) < block


def test_vocab_parallel_train_step_matches_the_port(granite, monkeypatch):
    """One train step on (2, 4): attention query-split (B5 on 1 query
    head and 1 kv head a slot, in the forward and again in each layer's
    remat recompute); loss and every gathered gradient leaf within
    ``max(MIN_TOL, 2 x spread)`` of the unsharded step's; no logits
    gathered (``gather`` 0), the loss's max an all-reduce (``pmax``)."""
    cfg, plan, params, tok = granite
    labels = torch.from_numpy(np.random.default_rng(4).integers(
        0, cfg.vocab, tok.shape))
    batch = {"tokens": tok, "labels": labels}
    tc = TrainConfig()
    loss_u, g_u = value_and_grad(make_loss_fn(cfg, plan, tc))(params, batch)
    off = dataclasses.replace(plan, use_flash_attention=False,
                              use_fused_mlp=False, use_fused_rmsnorm=False)
    loss_o, g_o = value_and_grad(make_loss_fn(cfg, off, tc))(params, batch)
    leaves_u = shd.tree_leaves(g_u)
    spread = max(_norm_rel(a, b) for a, b in zip(shd.tree_leaves(g_o),
                                                 leaves_u))
    mesh = make_local_mesh(2, 4, device="cpu")
    sp = _shard(cfg, params, mesh)
    b5 = _B5Heads(monkeypatch)
    loss_s, g_s = sharded.value_and_grad(
        make_mesh_loss_fn(cfg, plan, tc))(sp, batch)
    assert b5.calls == [(1, 1)] * (2 * 8 * cfg.n_layers)
    loss_tol = max(MIN_TOL, 2 * abs(float(loss_o - loss_u)) / float(loss_u))
    assert abs(float(loss_s - loss_u)) / float(loss_u) <= loss_tol
    err = max(_norm_rel(a, b) for a, b in zip(
        shd.tree_leaves(shd.gather_tree(g_s)), leaves_u))
    assert err <= max(MIN_TOL, 2 * spread), (err, spread)
    assert mesh.exchanged["gather"] == mesh.exchanged["n_gather"] == 0
    assert mesh.exchanged["n_pmax"] == 1


@pytest.mark.parametrize("mesh_shape", [(1, 1), (2, 1), (1, 4), (2, 2)])
def test_vocab_parallel_cross_entropy_is_the_global_one(mesh_shape):
    """``vocab_parallel_cross_entropy`` of the slots' blocks of random
    logits against ``cross_entropy`` of the whole, value and gradient
    (labels in every slot's columns); on one slot it is that function."""
    torch.manual_seed(0)
    B, S, V = 4, 6, 256
    mesh = make_local_mesh(*mesh_shape, device="cpu")
    lm = shd.shard_tree({"w": torch.zeros(8, V)},
                        {"w": shd.NamedSharding(mesh, (None, "model"))})["w"]
    logits = (torch.randn(B, S, V) * 4).requires_grad_(True)
    labels = torch.randint(0, V, (B, S))
    want = cross_entropy(logits, labels)
    (g_want,) = torch.autograd.grad(want, logits)
    want = want.detach()
    dp, tp = mesh_shape
    b, v = B // dp, V // tp
    parts = [logits[mesh.index(k, "data") * b:(mesh.index(k, "data") + 1) * b,
                    :, mesh.index(k, "model") * v:
                    (mesh.index(k, "model") + 1) * v]
             for k in range(mesh.size)]
    got = vocab_parallel_cross_entropy(parts, labels, lm)
    (g_got,) = torch.autograd.grad(got, logits)
    got = got.detach()
    if mesh.size == 1:
        assert torch.equal(got, want) and torch.equal(g_got, g_want)
    assert float(got) == pytest.approx(float(want), rel=1e-6)
    assert torch.allclose(g_got, g_want, rtol=1e-5, atol=1e-8)
    assert mesh.exchanged["gather"] == 0


# -- reduced recurrentgemma-2b on (2, 2): the ring past its window ----------


def test_recurrentgemma_ring_write_lands_on_its_slot():
    """1 kv head at TP 2: its attention layer query-split; window 32, a
    40-entry cache of 32 ring entries sequence-sharded 2 ways, 40 decode
    steps (8 past the window, so the ring wraps onto slot 0's block):
    logits within ``DECODE_TOL`` at every step, every slot's block
    within ``ULPS`` of the unsharded cache's slice, ``pos_idx`` equal."""
    cfg, plan, params = _reduced("recurrentgemma-2b")
    assert cfg.window == 32 and cfg.n_kv_heads == 1
    B, Z, steps = 4, 40, 40
    tok = torch.from_numpy(np.random.default_rng(5).integers(
        0, cfg.vocab, (B, steps)))
    mesh = make_local_mesh(2, 2, device="cpu")
    sp = _shard(cfg, params, mesh)
    walk = sharded._Walk(sp, cfg, plan)
    assert {walk.attn_form(L["attn"]) for L in sp["layers"]
            if "attn" in L} == {"query"}
    step = jit_decode_step(cfg, plan, mesh, B, Z)
    sc = shd.shard_tree(init_cache(cfg, B, Z, device="cpu"),
                        step.c_shardings)
    cache = init_cache(cfg, B, Z, device="cpu")
    attn = [i for i, k in enumerate(cfg.layer_kinds()) if k == "attn"]
    assert sc["layers"][attn[0]]["k"].parts[0].shape[1] == 16
    for t in range(steps):
        want, cache = decode_step(params, cache, cfg, plan,
                                  tok[:, t:t + 1], t)
        got, _ = step(sp, sc, tok[:, t:t + 1], t)
        assert _rel(got, want) <= DECODE_TOL, t
    for i in attn:
        e_got, e_want = sc["layers"][i], cache["layers"][i]
        assert int(e_want["pos_idx"].max()) == steps - 1
        for name in ("k", "v"):
            leaf = e_got[name]
            for k, part in enumerate(leaf.parts):
                block = e_want[name][leaf.sharding.block(k, leaf.shape)]
                assert _bf16_ulps(part, block) <= ULPS, (i, name, k)
        for part in e_got["pos_idx"].parts:
            assert torch.equal(part, e_want["pos_idx"])
    assert step.exchanged["n_pmax"] == len(attn)


@pytest.mark.parametrize("Z", [64, 36], ids=["sequence-sharded",
                                             "replicated"])
def test_gather_form_decode(Z):
    """4 query heads at TP 8 (reduced gemma-7b on (1, 8)): the gather
    fallback.  A 64-entry cache is sequence-sharded 8 ways (each slot
    computes every head against its block, the slots combine), a 36-entry
    one replicated (every slot attends it whole); neither is gathered,
    only the attention weights are; logits within ``DECODE_TOL``."""
    cfg, plan, params = _reduced("gemma-7b")
    B, steps = 2, 4
    tok = torch.from_numpy(np.random.default_rng(6).integers(
        0, cfg.vocab, (B, steps)))
    mesh = make_local_mesh(1, 8, device="cpu")
    step = jit_decode_step(cfg, plan, mesh, B, Z)
    sp = _shard(cfg, params, mesh)
    walk = sharded._Walk(sp, cfg, plan)
    assert walk.attn_form(sp["layers"][0]["attn"]) == "gather"
    sc = shd.shard_tree(init_cache(cfg, B, Z, device="cpu"),
                        step.c_shardings)
    seq = Z % 8 == 0
    assert sc["layers"][0]["k"].parts[0].shape[1] == (Z // 8 if seq else Z)
    cache = init_cache(cfg, B, Z, device="cpu")
    for t in range(steps):
        want, cache = decode_step(params, cache, cfg, plan, tok[:, t:t + 1],
                                  t)
        got, _ = step(sp, sc, tok[:, t:t + 1], t)
        assert _rel(got, want) <= DECODE_TOL, t
    for e_got, e_want in zip(shd.gather_tree(sc)["layers"], cache["layers"]):
        for name in ("k", "v"):
            assert _bf16_ulps(e_got[name], e_want[name]) <= ULPS
    # the weights' all-gather alone: wq, wk, wv, wo of each layer
    D, HE = cfg.d_model, cfg.n_heads * cfg.resolved_head_dim
    KE = cfg.n_kv_heads * cfg.resolved_head_dim
    per_layer = 8 * 7 * (2 * D * HE + 2 * D * KE) // 8 * 4
    assert step.exchanged["all_gather"] == cfg.n_layers * per_layer
    assert step.exchanged["n_pmax"] == (cfg.n_layers if seq else 0)


# -- the DeviceMesh exchanges the forms add ----------------------------------


def test_pmax_and_runs_of_an_all_gather():
    """``DeviceMesh.pmax``: the group's maximum on every slot, charged as
    a psum and read by ``collectives`` as an all-reduce; ``all_gather``
    with ``span``: runs of ``span`` slots of each group, XLA's replica
    groups ``[n/span, span]``."""
    mesh = make_local_mesh(2, 4, device="cpu")
    parts = [torch.tensor([float(k), -float(k)]) for k in range(8)]
    out = mesh.pmax(parts, ("model",))
    assert [t.tolist() for t in out] == [[3.0, 0.0]] * 4 + [[7.0, -4.0]] * 4
    assert mesh.exchanged["pmax"] == 2 * (2 * 3 * 8)
    assert collectives(mesh)["all-reduce"] == 2 * (2 * 3 * 8) / 8
    assert collectives(mesh)["n_all-reduce"] == 1
    assert mesh.groups(("model",), 2) == [[0, 1], [2, 3], [4, 5], [6, 7]]
    got = mesh.all_gather([torch.full((1,), float(k)) for k in range(8)],
                          ("model",), 0, span=2)
    assert [t.tolist() for t in got] == [[0.0, 1.0]] * 2 + [[2.0, 3.0]] * 2 \
        + [[4.0, 5.0]] * 2 + [[6.0, 7.0]] * 2
    assert mesh.exchanged["all_gather"] == 4 * (2 * 1 * 4)


# -- a decode cell against the reference's compiled one ----------------------

#: the reference's decode step for reduced granite-3-8b on an 8-device
#: forced host mesh (2, 4), 4 sequences and a 64-entry cache, layers
#: unrolled as ``repro/launch/dryrun.py`` compiles its cells; the
#: collectives read by ``parse_collectives`` and every all-gather's result
#: bytes
_JAX_DECODE_SCRIPT = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
os.environ["JAX_PLATFORMS"] = "cpu"
import sys; sys.path.insert(0, "src")
import json, re
import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from repro.configs import get_config
from repro.configs.base import ShapeSpec
from repro.core.policy import default_plan
from repro.models import decode_step, set_mesh_context
from repro.launch import shardings as shd
from repro.launch.roofline import parse_collectives

mesh = Mesh(np.array(jax.devices()).reshape(2, 4), ("data", "model"))
cfg = get_config("granite-3-8b").reduced()
set_mesh_context(mesh)
plan = default_plan(cfg, seq=64)
params_sds, p_sh = shd.params_for_split(cfg, mesh)
specs = shd.input_specs(cfg, ShapeSpec("cell", 64, 4, "decode"), mesh)
def serve_step(params, cache, tokens, pos):
    return decode_step(params, cache, cfg, plan, tokens, pos, unroll=True)
compiled = jax.jit(
    serve_step,
    in_shardings=(p_sh, specs["cache_shardings"], specs["tokens"].sharding,
                  NamedSharding(mesh, P())),
    out_shardings=(NamedSharding(mesh, P(None, None, "model")),
                   specs["cache_shardings"]),
    donate_argnums=(1,)).lower(params_sds, specs["cache"], specs["tokens"],
                               specs["pos"]).compile()
hlo = compiled.as_text()
size = {"f32": 4, "bf16": 2, "s32": 4}
gathers = []
for m in re.finditer(r"= (f32|bf16|s32)\[([0-9,]*)\]\S* all-gather(-start)?\(",
                     hlo):
    n = size[m.group(1)]
    for d in m.group(2).split(","):
        n *= int(d) if d else 1
    gathers.append(n)
k = specs["cache"]["periods"][0]["slot0"]["k"]
print(json.dumps({"devices": len(jax.devices()),
                  "coll": parse_collectives(hlo), "gathers": gathers,
                  "k_spec": list(k.sharding.spec),
                  "k_bytes": int(np.prod(k.shape)) * k.dtype.itemsize}))
"""


@pytest.fixture(scope="module")
def jax_decode_cell():
    res = subprocess.run([sys.executable, "-c", _JAX_DECODE_SCRIPT],
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["devices"] == 8
    return out


def test_decode_cell_collectives_against_the_reference(jax_decode_cell):
    """The port's decode cell (reduced granite-3-8b, 4 sequences, a
    64-entry cache, (2, 4) meta mesh) walked by ``launch.dryrun``: its
    collective bytes a chip within [1/3, 3] of the reference's compiled
    count; neither side all-gathers a cache-sized tensor (the
    reference's largest all-gather is under a quarter of one layer's k
    cache of a data group, the port gathers less than one slot's block
    of it over the whole step)."""
    ref = jax_decode_cell
    assert ref["k_spec"] == ["data", "model", None, None]
    torch.set_num_threads(1)
    cfg = get_config("granite-3-8b").reduced()
    mesh = make_local_mesh(2, 4, device="meta")
    got = dryrun.walk_cell(cfg, ShapeSpec("cell", 64, 4, "decode"), mesh,
                           default_plan(cfg, seq=64))
    ratio = got["collectives"]["total"] / ref["coll"]["total"]
    assert 1 / 3 <= ratio <= 3, (ratio, got["collectives"], ref["coll"])
    assert got["collectives"]["n_all-reduce"] > 0
    group_k = ref["k_bytes"] // 2           # one data group's rows
    assert max(ref["gathers"]) < group_k / 4, ref
    assert got["exchanged"]["all_gather"] / mesh.size < group_k / 4, got
