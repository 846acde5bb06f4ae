"""The port's LLM mesh pieces against the JAX package's: the logical spec
trees (``param_pspecs``, ``cache_pspecs``, ``zero1_pspecs``), their
resolution on a mesh (``resolve_tree`` through ``params_for`` /
``cache_for``, ``zero1_shardings``), ``input_specs``, the mesh context,
and the mesh constructors.

The JAX side resolves on ``jax.sharding.AbstractMesh`` (no devices
needed), the port's on ``make_local_mesh(..., device="cpu")`` or
``make_production_mesh(device="meta")``.  The JAX package stacks each
period's layers (``params["periods"]``); ``pspecs_from_reference`` carries
its trees into the port's one-entry-a-layer layout, so the two compare
leaf for leaf, as tuples of axis entries.
"""
import numpy as np
import pytest
import torch

import jax
from jax.sharding import AbstractMesh
from repro.configs import get_config as jx_get
from repro.configs.base import SHAPES as JX_SHAPES
from repro.launch import shardings as jx_shd
from repro.launch.train import zero1_shardings as jx_zero1_shardings
from repro.models import cache_pspecs as jx_cache_pspecs
from repro.models import common as jx_common
from repro.models import init_params as jx_init_params
from repro.models import param_pspecs as jx_param_pspecs
from repro.models import period_structure as jx_period_structure
from repro.optim import zero1_pspecs as jx_zero1_pspecs
from repro_torch.configs import get_config as pt_get
from repro_torch.configs import list_archs
from repro_torch.configs.base import SHAPES as PT_SHAPES
from repro_torch.launch import shardings as shd
from repro_torch.launch.mesh import (DeviceMesh, NamedSharding,
                                     PartitionSpec, make_local_mesh,
                                     make_production_mesh)
from repro_torch.launch.train import optimizer_shardings, zero1_shardings
from repro_torch.models import (cache_pspecs, constrain, get_mesh,
                                init_params, named_sharding,
                                param_pspecs, pspec, pspecs_from_reference,
                                set_mesh_context)
from repro_torch.optim import zero1_pspecs

ARCHS = list_archs()
#: (JAX mesh shape, axis names, the port's mesh)
MESHES = {
    "1x1": ((1, 1), ("data", "model"),
            lambda: make_local_mesh(1, 1, device="cpu")),
    "2x4": ((2, 4), ("data", "model"),
            lambda: make_local_mesh(2, 4, device="cpu")),
    "16x16": ((16, 16), ("data", "model"),
              lambda: make_production_mesh(device="meta")),
    "2x16x16": ((2, 16, 16), ("pod", "data", "model"),
                lambda: make_production_mesh(multi_pod=True,
                                             device="meta")),
}


def _jx_specs(tree):
    return jax.tree.map(lambda s: tuple(s.spec), tree,
                        is_leaf=lambda x: hasattr(x, "spec"))


def _pt_specs(tree):
    return shd.map_tree(lambda s: tuple(s.spec), tree)


def _meshes(name):
    shape, axes, make = MESHES[name]
    return AbstractMesh(shape, axes), make()


@pytest.mark.parametrize("arch", ARCHS)
def test_param_pspecs_equal_jax(arch):
    got = param_pspecs(pt_get(arch))
    want = pspecs_from_reference(jx_param_pspecs(jx_get(arch)), pt_get(arch))
    assert got == want
    assert len(got["layers"]) == pt_get(arch).n_layers


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_pspecs_equal_jax(arch):
    jcfg, pcfg = jx_get(arch), pt_get(arch)
    for batch in (1, 4):
        for tp in (1, 2, 16):
            for seq_len in (0, 64, 4096):
                got = cache_pspecs(pcfg, batch, seq_len=seq_len, tp=tp)
                want = pspecs_from_reference(
                    jx_cache_pspecs(jcfg, batch, seq_len=seq_len, tp=tp),
                    pcfg)
                assert got == want, (batch, tp, seq_len)


def _jx_split(cfg):
    """The JAX package's split (one tree a layer) param pspecs and
    shapes, as its dry-run builds them."""
    shapes = jax.eval_shape(lambda k: jx_init_params(k, cfg),
                            jax.random.PRNGKey(0))
    pspecs = jx_param_pspecs(cfg)
    _, n_periods, _ = jx_period_structure(cfg)
    shapes, pspecs = dict(shapes), dict(pspecs)
    shapes["periods"], pspecs["periods"] = jx_shd._split_tree(
        shapes["periods"], pspecs["periods"], n_periods)
    return shapes, pspecs


@pytest.mark.parametrize("arch", ARCHS)
def test_zero1_pspecs_equal_jax(arch):
    jcfg, pcfg = jx_get(arch), pt_get(arch)
    jshapes, jspecs = _jx_split(jcfg)
    pshapes = init_params(pcfg, device="meta")
    for size, axes in ((2, "data"), (16, "data"), (32, ("pod", "data"))):
        got = zero1_pspecs(param_pspecs(pcfg), pshapes, size, axes)
        want = pspecs_from_reference(
            jx_zero1_pspecs(jspecs, jshapes, size, axes), pcfg)
        assert got == want, size


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_resolved_shardings_equal_jax(arch, mesh_name):
    jm, pm = _meshes(mesh_name)
    jcfg, pcfg = jx_get(arch), pt_get(arch)
    _, js = jx_shd.params_for(jcfg, jm)
    psds, ps = shd.params_for(pcfg, pm)
    assert _pt_specs(ps) == pspecs_from_reference(_jx_specs(js), pcfg)
    assert _pt_specs(shd.params_for_split(pcfg, pm)[1]) == _pt_specs(ps)
    # a stand-in is a meta tensor of the global shape with its sharding
    leaf = psds["layers"][0]["ln1"]
    assert leaf.device.type == "meta" and leaf.sharding.mesh is pm
    for batch, seq_len in ((1, 64), (4, 4096)):
        _, jc = jx_shd.cache_for(jcfg, jm, batch, seq_len)
        _, pc = shd.cache_for(pcfg, pm, batch, seq_len)
        assert _pt_specs(pc) == pspecs_from_reference(_jx_specs(jc), pcfg)
    # ZeRO-1 moments from the split param shardings (the dry-run's form)
    jshapes, jspecs = _jx_split(jcfg)
    jsh = jx_shd.resolve_tree(jm, jspecs, jshapes)
    want = _jx_specs(jx_zero1_shardings(jshapes, jsh, jm)["m"])
    got = zero1_shardings(psds, ps, pm)
    assert _pt_specs(got["m"]) == pspecs_from_reference(want, pcfg)
    assert got["count"].spec == PartitionSpec()


@pytest.mark.parametrize("mesh_name", ["2x4", "2x16x16"])
@pytest.mark.parametrize("arch", ["granite-3-8b", "hubert-xlarge",
                                  "llama-3.2-vision-11b",
                                  "recurrentgemma-2b"])
def test_input_specs_equal_jax(arch, mesh_name):
    jm, pm = _meshes(mesh_name)
    for name in JX_SHAPES:                       # train, prefill, decode
        js = jx_shd.input_specs(jx_get(arch), JX_SHAPES[name], jm)
        ps = shd.input_specs(pt_get(arch), PT_SHAPES[name], pm)
        assert set(js) == set(ps)
        for k in js:
            if k in ("cache", "cache_shardings"):
                continue
            assert tuple(ps[k].shape) == tuple(js[k].shape), (name, k)
            assert ps[k].dtype == {"int32": torch.int32,
                                   "bfloat16": torch.bfloat16}[
                str(js[k].dtype)]
            if js[k].sharding is None:
                assert ps[k].sharding is None
            else:
                assert tuple(ps[k].sharding.spec) == \
                    tuple(js[k].sharding.spec), (name, k)
        if "cache" in js:
            assert _pt_specs(ps["cache_shardings"]) == pspecs_from_reference(
                _jx_specs(js["cache_shardings"]), pt_get(arch))


def test_mesh_context_and_pspec_equal_jax():
    for shape, axes in (((2, 4), ("data", "model")),
                        ((2, 16, 16), ("pod", "data", "model"))):
        pm = DeviceMesh(shape, axes, ["cpu"] * int(np.prod(shape)))
        jm = AbstractMesh(shape, axes)
        set_mesh_context(pm)
        jx_common.set_mesh_context(jm)
        try:
            assert get_mesh() is pm
            for logical in (("batch", None, "model"), ("data",),
                            ("model", "seq", None)):
                assert tuple(pspec(*logical)) == \
                    tuple(jx_common.pspec(*logical))
                assert named_sharding(*logical) == NamedSharding(
                    pm, pspec(*logical))
            x = torch.zeros(4, 6, 10)
            assert constrain(x, "batch", None, "model") is x
            with pytest.raises(ValueError, match="logical axes"):
                constrain(x, "batch", None, "model", None)
        finally:
            set_mesh_context(None)
            jx_common.set_mesh_context(None)
    assert get_mesh() is None and named_sharding("batch") is None
    x = torch.zeros(2)
    assert constrain(x, "batch", "model", None) is x      # no mesh: no check


def test_mesh_constructors():
    m = make_local_mesh(2, 4, device="cpu")
    assert m.axis_names == ("data", "model")
    assert m.shape == {"data": 2, "model": 4} and list(m.shape) == [
        "data", "model"]
    assert m.size == 8 and set(m.devices) == {torch.device("cpu")}
    assert [m.coords(k) for k in (0, 5)] == [{"data": 0, "model": 0},
                                             {"data": 1, "model": 1}]
    assert m.groups(("model",)) == [[0, 1, 2, 3], [4, 5, 6, 7]]
    assert m.groups(("data",)) == [[0, 4], [1, 5], [2, 6], [3, 7]]
    p = make_production_mesh(device="meta")
    assert p.shape == {"data": 16, "model": 16} and p.size == 256
    pp = make_production_mesh(multi_pod=True, device="meta")
    assert pp.axis_names == ("pod", "data", "model") and pp.size == 512
    assert pp.index(511, ("pod", "data")) == 31
    # one device a slot: the CPU is one device, as in the JAX package on
    # one CPU (tests/test_configs_launch.py)
    with pytest.raises(ValueError, match="need 256 devices"):
        make_production_mesh(device="cpu")
    with pytest.raises(ValueError, match="extents"):
        make_local_mesh(0, 2, device="cpu")


def test_init_params_on_meta_allocates_nothing():
    for arch in ("granite-3-8b", "recurrentgemma-2b", "rwkv6-7b",
                 "moonshot-v1-16b-a3b"):
        cfg = pt_get(arch)
        shapes = init_params(cfg, device="meta")
        jshapes = jax.eval_shape(lambda k: jx_init_params(k, jx_get(arch)),
                                 jax.random.PRNGKey(0))
        leaves = shd.tree_leaves(shapes)
        assert all(t.device.type == "meta" for t in leaves)
        assert sum(t.numel() for t in leaves) == sum(
            int(np.prod(s.shape)) for s in jax.tree.leaves(jshapes))


@pytest.mark.parametrize("mesh", [(2, 2), (1, 4), (4, 2)])
def test_shard_and_gather_round_trip(mesh):
    """Every slot holds its block of every leaf (per-slot bytes as the
    specs count them), and gathering gives the tree back bitwise."""
    cfg = pt_get("granite-3-8b").reduced()
    params = init_params(cfg, seed=3, device="cpu")
    m = make_local_mesh(*mesh, device="cpu")
    _, sh = shd.params_for(cfg, m)
    sp = shd.shard_tree(params, sh)
    back = shd.gather_tree(sp)
    for a, b in zip(shd.tree_leaves(back), shd.tree_leaves(params)):
        assert torch.equal(a, b)
    tp = mesh[1]
    for k in range(m.size):
        want = 0
        for t, s in zip(shd.tree_leaves(params), shd.tree_leaves(sh)):
            split = 1
            for ax in s.spec:
                if ax is not None:
                    split *= m.axis_size(ax)
            want += t.numel() * t.element_size() // split
        assert shd.slot_bytes(sp, k) == want
    # a model-split leaf's block is its columns, contiguous
    wq = sp["layers"][0]["attn"]["wq"]
    H = wq.shape[1] // tp
    assert wq.parts[1].is_contiguous()
    assert torch.equal(wq.parts[1], params["layers"][0]["attn"]["wq"][
        :, (1 % tp) * H:(1 % tp + 1) * H])


def test_optimizer_shardings_zero1_and_off():
    cfg = pt_get("granite-3-8b").reduced()
    m = make_local_mesh(2, 2, device="cpu")
    on = optimizer_shardings(cfg, m, zero1=True)
    off = optimizer_shardings(cfg, m, zero1=False)
    _, ps = shd.params_for(cfg, m)
    assert _pt_specs(off["m"]) == _pt_specs(ps)
    # wq (64, 64): columns on "model", rows take "data"
    assert on["m"]["layers"][0]["attn"]["wq"].spec == ("data", "model")
    assert on["v"]["embed"].spec == ("model", "data")
    assert on["m"]["final_norm"].spec == ("data",)
    assert on["count"].spec == ()
