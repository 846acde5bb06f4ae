"""The port's dry run (``repro_torch.launch.dryrun``) on the CPU: the step
walked on the meta device under ``CostCounter``, held against the JAX
package's compiled cell, the kernels' meta path, every reduced arch ×
shape, and the CLI's files.
"""
import json
import os
import subprocess
import sys
import types

import pytest
import torch

from repro_torch import kernels
from repro_torch.configs import SHAPES, get_config, list_archs
from repro_torch.configs.base import ShapeSpec
from repro_torch.core.policy import default_plan
from repro_torch.kernels import flash_attention, fused_mlp, rglru, rmsnorm
from repro_torch.kernels import rwkv6
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.launch.train import TrainConfig, jit_train_step
from repro_torch.models import init_params
from repro_torch.launch import shardings as shd
from repro_torch.optim import AdamWConfig

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: tests/test_integration.py's dry-run cell, with the figures read out, and
#: the reference's skipped cells
_JAX_CELL_SCRIPT = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
os.environ["JAX_PLATFORMS"] = "cpu"
import sys; sys.path.insert(0, "src")
import jax, json
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
import numpy as np
from repro.configs import get_config
from repro.core.policy import default_plan
from repro.models import forward, set_mesh_context
from repro.launch import shardings as shd
from repro.launch.roofline import parse_collectives

mesh = Mesh(np.array(jax.devices()).reshape(2, 4), ("data", "model"))
cfg = get_config("granite-3-8b").reduced()
set_mesh_context(mesh)
plan = default_plan(cfg, seq=64)
params_sds, p_sh = shd.params_for_split(cfg, mesh)
tok = jax.ShapeDtypeStruct((4, 64), jnp.int32,
                           sharding=NamedSharding(mesh, P("data", None)))
def fwd(params, tokens):
    return forward(params, cfg, plan, tokens, mode="prefill", unroll=True)[0]
compiled = jax.jit(fwd, in_shardings=(p_sh, tok.sharding),
                   out_shardings=NamedSharding(mesh, P("data", None, "model"))
                   ).lower(params_sds, tok).compile()
ma = compiled.memory_analysis()
ca = compiled.cost_analysis()
ca = ca[0] if isinstance(ca, list) else ca
coll = parse_collectives(compiled.as_text())
from repro.launch.dryrun import lower_cell
skipped = [lower_cell(a, s, False) for a, s in
           (("hubert-xlarge", "decode_32k"), ("granite-3-8b", "long_500k"))]
print(json.dumps({"devices": len(jax.devices()),
                  "argument_bytes": ma.argument_size_in_bytes,
                  "output_bytes": ma.output_size_in_bytes,
                  "flops": ca.get("flops", 0.0),
                  "bytes": ca.get("bytes accessed", 0.0),
                  "coll_total": coll["total"], "skipped": skipped}))
"""


@pytest.fixture(scope="module")
def jax_cell():
    res = subprocess.run([sys.executable, "-c", _JAX_CELL_SCRIPT], cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["devices"] == 8
    return out


def _reduced_cell(mesh_shape, **kw):
    torch.set_num_threads(1)
    cfg = get_config("granite-3-8b").reduced()
    mesh = make_local_mesh(*mesh_shape, device="meta")
    return dryrun.walk_cell(cfg, ShapeSpec("cell", 64, 4, "prefill"), mesh,
                            default_plan(cfg, seq=64), **kw)


def test_reduced_prefill_cell_against_the_jax_dry_run(jax_cell):
    """tests/test_integration.py's cell (reduced granite-3-8b, 4 × 64
    prefill, (2, 4) mesh, logits out ``P("data", None, "model")``) walked
    on meta against the JAX package's compiled one on 8 forced host
    devices.  A slot's argument bytes (126,720 of params, 512 of tokens)
    and output bytes equal XLA's exactly.  The counts are another
    program's, so they agree within stated ratios:

    * FLOPs within [0.7, 0.91] of XLA's (a band 1.3 wide): at TP 4 the
      reduced config's attention is query-split, one query head a slot
      as GSPMD splits it, so both count the same products; but the port
      counts no elementwise op where XLA adds about one an element, and
      B5 counts the causal pairs it keeps where XLA's CPU attention
      computes the masked half too (the port counts ~0.77x; with the
      masked pairs ~0.85x);
    * bytes within [1/3, 3]: eager ops are unfused (every intermediate
      written and read again), while XLA fuses them but counts each
      fusion's operands, and its attention re-reads K/V per query block;
    * collective bytes within [1/3, 3]: the query-split form all-gathers
      the k and v columns in runs of TP/KVH = 2 slots, as GSPMD's replica
      groups do, but applies rope after the gather where GSPMD exchanges
      halves of heads for it (the port moves ~0.8x); and 0 on an (8, 1)
      mesh, where nothing is exchanged."""
    got = _reduced_cell((2, 4), logits_batch_split=True)
    mem = got["memory"]
    assert mem["arguments"] == {"params": 126720, "batch": 512}
    assert mem["argument_bytes"] == jax_cell["argument_bytes"] == 127232
    assert mem["output_bytes"] == jax_cell["output_bytes"] == 32768
    assert mem["alias_bytes"] == 0 and mem["temp_bytes"] > 0
    flops = got["cost"]["flops_per_chip"] / jax_cell["flops"]
    nbytes = got["cost"]["bytes_per_chip"] / jax_cell["bytes"]
    coll = got["collectives"]["total"] / jax_cell["coll_total"]
    assert 0.7 <= flops <= 0.91, (flops, got["cost"], jax_cell)
    assert 1 / 3 <= nbytes <= 3.0, (nbytes, got["cost"], jax_cell)
    assert 1 / 3 <= coll <= 3.0, (coll, got["collectives"], jax_cell)
    assert got["collectives"]["gather"] == 0.0
    calls = {k: v["calls"] for k, v in got["kernels"].items()}
    layers = get_config("granite-3-8b").reduced().n_layers
    assert calls == {"flash_attention": 8 * layers, "fused_mlp": 8 * layers,
                     "rmsnorm": 8 * (2 * layers + 1), "rglru": 0, "wkv6": 0}
    dp = _reduced_cell((8, 1))
    assert dp["collectives"]["total"] == 0.0
    # every slot holds the whole model and the whole batch (4 rows do not
    # split over 8 data slots)
    whole = sum(t.numel() * t.element_size() for t in shd.tree_leaves(
        init_params(get_config("granite-3-8b").reduced(), device="meta")))
    assert dp["memory"]["arguments"] == {"params": whole,
                                         "batch": 4 * 64 * 4}


def test_skipped_cells_are_the_references(jax_cell, tmp_path):
    """``lower_cell`` returns the reference's skipped dict word for word,
    and ``run_cells`` writes it under the reference's file name."""
    for want in jax_cell["skipped"]:
        assert dryrun.lower_cell(want["arch"], want["shape"], False) == want
    args = types.SimpleNamespace(
        arch="hubert-xlarge", shape="decode_32k", mesh="single",
        outdir=str(tmp_path), tag="", skip_existing=False,
        attention="flash", no_remat=False, no_zero1=False, accum=1,
        kv_block=None, cache_dus=False, moe_cf=None, serve_dtype="f32",
        layers=None)
    assert dryrun.run_cells(args) == 0
    with open(tmp_path / "hubert-xlarge__decode_32k__single.json") as f:
        assert json.load(f) == jax_cell["skipped"][0]


def _cells():
    return [(a, s) for a in list_archs() for s in SHAPES]


@pytest.mark.parametrize("arch,shape", _cells())
def test_every_reduced_cell_walks_on_meta(arch, shape):
    """Every arch × shape of the reduced configs at the cell's own batch
    and sequence on a (2, 2) meta mesh, the plan's kernel flags on (B5-B9
    through their meta path) and remat on for train: ``ok`` figures, or
    the reference's skipped dict."""
    cfg = get_config(arch)
    if shape not in cfg.supported_shapes():
        res = dryrun.lower_cell(arch, shape, False)
        assert res["status"] == "skipped" and set(res) == {
            "arch", "shape", "mesh", "status", "reason"}
        return
    torch.set_num_threads(1)
    cfg = cfg.reduced()
    spec = SHAPES[shape]
    plan = dryrun._plan_for(cfg, spec, "flash")
    assert plan.use_flash_attention and plan.use_fused_mlp and \
        plan.use_fused_rmsnorm
    got = dryrun.walk_cell(cfg, spec, make_local_mesh(2, 2, device="meta"),
                           plan, remat=True)
    mem, cost = got["memory"], got["cost"]
    assert mem["argument_bytes"] > 0 and mem["temp_bytes"] >= 0
    assert cost["flops_per_chip"] > 0 and cost["bytes_per_chip"] > 0
    assert got["roofline"]["bound_s"] > 0
    kinds = cfg.layer_kinds()
    calls = {k: v["calls"] for k, v in got["kernels"].items()}
    assert calls["rmsnorm"] > 0
    if not cfg.is_moe:
        assert calls["fused_mlp"] > 0
    if spec.mode != "decode":
        assert (calls["flash_attention"] > 0) == any(
            k in ("attn", "xattn") for k in kinds)
        assert (calls["rglru"] > 0) == ("rglru" in kinds)
        assert (calls["wkv6"] > 0) == ("rwkv" in kinds)
    if spec.mode == "train":
        assert mem["alias_bytes"] == mem["argument_bytes"] - \
            mem["arguments"]["batch"]


def test_remat_train_step_runs_on_meta():
    """The repaired ``repro_torch::tag`` fake: the reduced granite mesh
    train step on a (2, 4) meta mesh with ``TrainConfig(remat=True)``;
    remat runs each layer's kernels twice and lowers the peak.  At 64
    tokens a row the activations held at the loss set the peak; at 16,
    with the loss vocab-parallel (no global logits on slot 0), the peak
    is layer 0's backward, where every parameter gradient is live and
    remat holds its recomputed layer besides (640 bytes a slot more)."""
    torch.set_num_threads(1)
    cfg = get_config("granite-3-8b").reduced()
    mesh = make_local_mesh(2, 4, device="meta")
    plan = default_plan(cfg, seq=64)
    spec = ShapeSpec("cell", 64, 4, "train")
    on = dryrun.walk_cell(cfg, spec, mesh, plan, remat=True)
    off = dryrun.walk_cell(cfg, spec, mesh, plan, remat=False)
    n = 8 * cfg.n_layers
    assert on["kernels"]["flash_attention"]["calls"] == 2 * n
    assert off["kernels"]["flash_attention"]["calls"] == n
    assert on["memory"]["temp_bytes"] < off["memory"]["temp_bytes"]
    # the step itself, outside the dry run
    specs = shd.input_specs(cfg, spec, mesh)
    step = jit_train_step(cfg, plan, AdamWConfig(), mesh,
                          TrainConfig(remat=True), batch_specs={
                              k: specs[k] for k in ("tokens", "labels")})
    p, _ = shd.params_for(cfg, mesh)
    sp, so = step.shard(dryrun._slots(p, step.p_shardings, mesh))
    _, _, m = step(sp, so, {k: specs[k] for k in ("tokens", "labels")})
    assert m["loss"].is_meta and m["loss"].shape == ()


def test_kernels_meta_outputs_are_the_plain_versions_shapes():
    """B5-B9 on meta tensors: the plain version's output shapes and dtypes
    on CPU tensors, no launch counted, the work reported."""
    gen = torch.Generator().manual_seed(0)

    def pair(shape, dtype=torch.float32):
        t = torch.randn(shape, generator=gen).to(dtype)
        return t, torch.empty(shape, dtype=dtype, device="meta")

    def same(a, b):
        a = a if isinstance(a, tuple) else (a,)
        b = b if isinstance(b, tuple) else (b,)
        assert [(t.shape, t.dtype) for t in a] == \
            [(t.shape, t.dtype) for t in b]
        assert all(t.is_meta for t in b)

    for dt in (torch.float32, torch.bfloat16):
        q, qm = pair((2, 4, 70, 64), dt)
        k, km = pair((2, 2, 90, 64), dt)
        v, vm = pair((2, 2, 90, 64), dt)
        x, xm = pair((2, 5, 64), dt)
        w, wm = pair((64,))
        wu, wum = pair((64, 96))
        wd, wdm = pair((96, 64))
        h0, h0m = pair((2, 64))
        r, rm = pair((1, 2, 20, 16), dt)
        lw, lwm = pair((1, 2, 20, 16))
        u, um = pair((2, 16))
        s0, s0m = pair((1, 2, 16, 16))
        before = kernels.launches()
        with kernels.costing() as cost:
            same(flash_attention.flash_attention(q, k, v, causal=True,
                                                 window=32),
                 flash_attention.flash_attention(qm, km, vm, causal=True,
                                                 window=32))
            same(fused_mlp.fused_mlp(x, wu, wu, wd),
                 fused_mlp.fused_mlp(xm, wum, wum, wdm))
            same(rmsnorm.rmsnorm(x, w), rmsnorm.rmsnorm(xm, wm))
            same(rglru.rglru(x, x, x, w, h0),
                 rglru.rglru(xm, xm, xm, wm, h0m))
            same(rwkv6.wkv6(r, r, r, lw, u, s0),
                 rwkv6.wkv6(rm, rm, rm, lwm, um, s0m))
        assert kernels.launches() == before
        assert {k: v["calls"] for k, v in cost.items()} == dict.fromkeys(
            kernels.WORK_KERNELS, 1)         # the CPU calls report none
        assert cost["fused_mlp"]["flops"] == 6 * 10 * 64 * 96
        assert cost["rmsnorm"]["flops"] == 4 * 10 * 64
    # the same argument checks as on the card
    with pytest.raises(ValueError, match="E <="):
        m = torch.empty((1, 1, 4, 300), device="meta")
        flash_attention.flash_attention(m, m, m)
    with pytest.raises(TypeError, match="float32 weights"):
        fused_mlp.fused_mlp(xm, None, wum.bfloat16(), wdm)
    with pytest.raises(ValueError, match="devices"):
        rmsnorm.rmsnorm(x, wm)                        # CPU + meta


class _Watch(torch.utils._python_dispatch.TorchDispatchMode):
    """The largest tensor a dispatched op puts on the CPU."""

    def __init__(self):
        super().__init__()
        self.cpu_bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in dryrun._tensors(out, []):
            if t.device.type == "cpu":
                self.cpu_bytes = max(self.cpu_bytes,
                                     t.numel() * t.element_size())
        return out


@pytest.mark.parametrize("mode", ["train", "prefill", "decode"])
def test_a_meta_cell_touches_no_card_and_no_host_memory(mode, monkeypatch):
    """A cell's stand-ins and walk make no CUDA call and put nothing on
    the CPU beyond a 0-d host scalar (the embedding's scale)."""
    def no_cuda(*a, **k):
        raise AssertionError("CUDA touched")
    monkeypatch.setattr(torch.cuda, "_lazy_init", no_cuda)
    monkeypatch.setattr(torch.cuda, "synchronize", no_cuda)
    torch.set_num_threads(1)
    cfg = get_config("granite-3-8b").reduced()
    spec = ShapeSpec("cell", 32, 4, mode)
    with _Watch() as watch:
        got = dryrun.walk_cell(cfg, spec, make_local_mesh(2, 2,
                                                          device="meta"),
                               default_plan(cfg, seq=32))
    assert watch.cpu_bytes <= 8, watch.cpu_bytes
    assert got["ops"] > 0
    assert not torch.cuda.is_initialized()


def test_layers_cut_and_the_production_mesh():
    """``lower_cell`` on the 256-slot meta mesh, one layer of
    hubert-xlarge's prefill_32k at full width: the reference's keys, the
    H100 row."""
    torch.set_num_threads(1)
    res = dryrun.lower_cell("hubert-xlarge", "prefill_32k", False, layers=1)
    assert res["status"] == "ok" and res["n_chips"] == 256
    assert res["layers"] == 1 and res["compile_s"] == 0.0
    for key in ("argument_bytes", "output_bytes", "temp_bytes",
                "alias_bytes", "peak_estimate_bytes"):
        assert key in res["memory"]
    assert set(res["roofline"]) >= {"compute_s", "memory_s", "collective_s",
                                    "dominant", "bound_s"}
    assert "H100" in res["hardware"]
    m = res["memory"]
    assert m["peak_estimate_bytes"] == (m["argument_bytes"]
                                        + m["output_bytes"]
                                        + m["temp_bytes"]
                                        - m["alias_bytes"])
