"""The port's LLM planning layer equals the JAX package's, field by field.

For all ten arch configs and every phase each supports, at small shapes,
the two packages build the same layer (or decode) graph, reach the same
co-design decision and lower it to the same ``CelloPlan``; the default
plans and the HPC plans (whose ``CelloPlan`` sets the LLM fields off)
match too.  The port's copy is pure Python and is held to equality, not to
a tolerance.
"""
import dataclasses

import pytest

import repro.api as jx_api
from repro.configs import get_config as jx_get, list_archs as jx_archs
import repro_torch.api as pt_api
from repro_torch.configs import get_config as pt_get, list_archs as pt_archs

ARCHS = jx_archs()
CELLS = [(a, ph) for a in ARCHS for ph in ("train", "prefill", "decode")
         if not (ph == "decode" and jx_get(a).encoder_only)]
SHAPES = {"train": dict(batch=2, seq=128), "prefill": dict(batch=1, seq=256),
          "decode": dict(batch=4, kv_len=512)}


def test_arch_registry_matches():
    assert pt_archs() == ARCHS


@pytest.mark.parametrize("arch", ARCHS)
def test_arch_config_equal(arch):
    jx, pt = jx_get(arch), pt_get(arch)
    assert dataclasses.asdict(pt) == dataclasses.asdict(jx)
    assert dataclasses.asdict(pt.reduced()) == dataclasses.asdict(jx.reduced())
    assert pt.layer_kinds() == jx.layer_kinds()
    assert pt.total_params() == jx.total_params()
    assert pt.supported_shapes() == jx.supported_shapes()


def _graph_view(g):
    ops = [(o.name, o.spec, tuple(o.inputs), o.output, o.flops, o.irregular)
           for o in g.ops.values()]
    tensors = {n: (tuple(t.shape), t.dtype_bytes, t.kind.name, t.meta)
               for n, t in g.tensors.items()}
    return g.name, ops, tensors


@pytest.mark.parametrize("arch,phase", CELLS,
                         ids=[f"{a}-{p}" for a, p in CELLS])
def test_llm_plan_equal(arch, phase):
    jx_tr = jx_api.Session(arch, use_cache=False).trace(phase, **SHAPES[phase])
    pt_tr = pt_api.Session(arch, device="cpu").trace(phase, **SHAPES[phase])
    assert pt_tr.shape_key == jx_tr.shape_key
    assert _graph_view(pt_tr.graph) == _graph_view(jx_tr.graph)
    jx_cd, pt_cd = jx_tr.analyze().codesign(), pt_tr.analyze().codesign()
    js, ps = jx_cd.best.schedule, pt_cd.best.schedule
    assert ps.order == js.order and ps.groups == js.groups
    assert dict(ps.pins) == dict(js.pins)
    assert pt_cd.speedup() == jx_cd.speedup()
    jx_plan, pt_plan = jx_cd.lower(), pt_cd.lower()
    assert dataclasses.asdict(pt_plan.plan) == dataclasses.asdict(
        jx_plan.plan)
    assert pt_plan.cfg is pt_tr.session.cfg and pt_plan.arch == arch


@pytest.mark.parametrize("arch", ARCHS)
def test_default_plan_equal(arch):
    jx = jx_api.Session(arch, use_cache=False).default_plan(seq=512)
    pt = pt_api.Session(arch, device="cpu").default_plan(seq=512)
    assert dataclasses.asdict(pt.plan) == dataclasses.asdict(jx.plan)


def test_lower_seq_override_and_compile_equal():
    jx = jx_api.Session("gemma-7b", use_cache=False)
    pt = pt_api.Session("gemma_7b", device="cpu")     # identifier spelling
    assert pt.cfg.name == "gemma-7b"
    for lower_seq in (None, 2048):
        a = jx.compile("prefill", batch=1, seq=512, lower_seq=lower_seq)
        b = pt.compile("prefill", batch=1, seq=512, lower_seq=lower_seq)
        assert dataclasses.asdict(b.plan) == dataclasses.asdict(a.plan)


HPC = [("cg", dict(n=64, iters=4)), ("jacobi2d", dict(n=16, sweeps=4)),
       ("cg_sparse", dict(n=64, iters=4))]


@pytest.mark.parametrize("workload,params", HPC, ids=[w for w, _ in HPC])
def test_hpc_cello_plan_equal(workload, params):
    """The HPC lowering sets every CelloPlan field as the JAX package does
    (the LLM kernel flags off)."""
    jx = jx_api.Session(use_cache=False).trace(workload=workload, **params)
    pt = pt_api.Session(device="cpu").trace(workload=workload, **params)
    jx_plan = jx.analyze().codesign().lower()
    pt_plan = pt.analyze().codesign().lower()
    assert dataclasses.asdict(pt_plan.plan) == dataclasses.asdict(
        jx_plan.plan)
    assert pt_plan.cfg is None and not pt_plan.plan.use_flash_attention


@pytest.mark.parametrize("kwargs,err", [
    (dict(phase="decode", seq=128), "kv_len"),
    (dict(phase="prefill", kv_len=128), "seq="),
    (dict(phase="decode", layer_kind="attn"), "layer_kind"),
    (dict(phase="serve"), "not in"),
    (dict(phase="prefill", workload="cg"), "phase='hpc'"),
    (dict(workload="cg", seq=4), "workload builder"),
], ids=["decode-seq", "prefill-kvlen", "decode-kind", "bad-phase",
        "phase-and-workload", "workload-seq"])
def test_trace_argument_checks_match(kwargs, err):
    for sess in (jx_api.Session("granite-3-8b", use_cache=False),
                 pt_api.Session("granite-3-8b", device="cpu")):
        with pytest.raises(ValueError, match=err):
            sess.trace(**kwargs)


def test_archless_and_encoder_only_sessions_refuse():
    with pytest.raises(ValueError, match="no arch config"):
        pt_api.Session(device="cpu").trace("prefill")
    with pytest.raises(ValueError, match="default_plan needs"):
        pt_api.Session(device="cpu").default_plan()
    with pytest.raises(ValueError, match="encoder-only"):
        pt_api.Session("hubert-xlarge", device="cpu").trace("decode")


def test_llm_plan_serves_and_explains():
    plan = pt_api.Session("granite-3-8b", device="cpu").trace(
        "prefill", batch=1, seq=1024).analyze().codesign().lower()
    assert plan.plan.use_flash_attention and plan.plan.use_fused_mlp
    text = plan.explain()
    assert "flash attention   : True" in text
    assert "fused RMSNorm     : True" in text
    assert "flash=True" in repr(plan)
    bundle = plan.serve()
    assert bundle.cfg is plan.cfg and bundle.plan is plan.plan
    assert bundle.prefill_fn is bundle.prefill_fn        # cached
    report = plan.report()
    assert report["phase"] == "prefill" and report["shape"] == "b1s1024"
    assert "backend" not in report
    hpc = pt_api.Session(device="cpu").trace(workload="cg", n=64,
                                             iters=2).codesign().lower()
    with pytest.raises(ValueError, match="no LLM serving"):
        hpc.serve()
