"""The PyTorch port stands alone: it imports neither jax nor the JAX
package, and it runs on the CPU only when asked to."""
import ast
import os
import pathlib
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def _imported_modules(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_no_jax_or_repro_import(path):
    bad = [m for m in _imported_modules(path) if _forbidden(m)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_imports_and_runs_cg_with_jax_absent():
    code = """
import sys
sys.modules["jax"] = None          # any import of jax now fails
import repro_torch
from repro_torch.api import Session
plan = (Session(device="cpu").trace(workload="cg", n=64, iters=4)
        .analyze().codesign().lower())
out = plan.run()
assert set(out) == {"x4", "r4"}
assert all(bool(v.isfinite().all()) for v in out.values())
loaded = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "repro") and sys.modules[m])
assert not loaded, loaded
print("ok", plan.backend)
"""
    env_path = str(ROOT / "src")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300,
                         env={**os.environ, "PYTHONPATH": env_path})
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok cuda"


def test_mesh_lowers_and_runs_with_jax_absent():
    """``lower(mesh=4)``, its ``ShardedProgram`` and ``ShardedReference``
    import and run with jax absent."""
    code = """
import sys
sys.modules["jax"] = None          # any import of jax now fails
import torch
from repro_torch.api import Session
plan = (Session(device="cpu").trace(workload="cg_sparse", n=64, iters=3)
        .analyze().codesign().lower(mesh=4))
out = plan.run()
ref = plan.run(backend="reference")
assert type(plan.compiled()).__name__ == "ShardedProgram"
assert set(out) == set(ref) == {"x3", "r3"}
assert all(bool(torch.allclose(out[k], ref[k], rtol=2e-4, atol=1e-5))
           for k in out)
loaded = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "repro") and sys.modules[m])
assert not loaded, loaded
print("ok", plan.sharded.n_shards)
"""
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300,
                         env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok 4"


def test_recurrent_families_serve_with_jax_absent():
    """The recurrent models and the B8/B9 modules import and serve a
    reduced recurrentgemma-2b and rwkv6-7b with jax absent."""
    code = """
import sys
sys.modules["jax"] = None          # any import of jax now fails
import torch
from repro_torch.api import Session
from repro_torch.configs import get_config
from repro_torch.kernels import rglru, rwkv6
from repro_torch.models import init_params, recurrent
for name, kind in (("recurrentgemma-2b", "attn"), ("rwkv6-7b", None)):
    cfg = get_config(name).reduced()
    bundle = (Session(cfg, device="cpu")
              .trace("prefill", batch=1, seq=32, layer_kind=kind)
              .analyze().codesign().lower().serve())
    params = init_params(cfg, seed=0, device="cpu")
    logits = bundle.prefill_fn(params, torch.zeros((1, 6), dtype=torch.long))
    toks = bundle.generate(params, torch.zeros((1, 4), dtype=torch.long), 3)
    assert bool(torch.isfinite(logits).all()) and toks.shape == (1, 7)
loaded = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "repro") and sys.modules[m])
assert not loaded, loaded
print("ok")
"""
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300,
                         env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


def test_obs_and_faults_import_and_report_with_jax_absent():
    """``repro_torch.obs`` and ``repro_torch.testing`` import with jax
    absent, and a run reports through them: spans, counters and a fault
    site."""
    code = """
import sys
sys.modules["jax"] = None          # any import of jax now fails
from repro_torch import obs
from repro_torch.testing import faults
from repro_torch.testing.faults import InjectedFault
from repro_torch.api import Session
obs.enable()
plan = (Session(device="cpu").trace(workload="cg", n=32, iters=2)
        .analyze().codesign().lower())
with faults.inject("exec.dispatch@cuda", times=1):
    try:
        plan.run()
    except InjectedFault:
        pass
    else:
        raise AssertionError("the fault site did not fire")
plan.run()
names = {r["name"] for r in obs.tracer().spans()}
assert {"session.trace", "codesign.search", "exec.compile",
        "exec.dispatch"} <= names, names
assert plan.compiled().stats["dispatches"] == 1
assert obs.registry().counter("faults.injected").value(
    site="exec.dispatch", kind="fail") == 1
loaded = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "repro") and sys.modules[m])
assert not loaded, loaded
print("ok")
"""
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300,
                         env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


def test_solver_serving_imports_and_runs_with_jax_absent():
    code = """
import sys
sys.modules["jax"] = None          # any import of jax now fails
from repro_torch.api import ServeConfig, Session
from repro_torch.runtime import run_with_restarts
from repro_torch.serve import PlanRouter, Server, request
srv = Server(PlanRouter(Session(device="cpu")),
             ServeConfig(max_batch_size=4, autostart=False))
futs = [srv.submit(request("cg_sparse", n=64, iters=2, seed=s,
                           backend="cuda")) for s in range(3)]
srv.start()
res = [f.result(timeout=120) for f in futs]
srv.close()
assert [r.batch_size for r in res] == [3, 3, 3], res
assert srv.stats()["batches"] == 1
assert run_with_restarts(lambda s: None, lambda s: s, 2)["completed"] == 2
loaded = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "repro") and sys.modules[m])
assert not loaded, loaded
print("ok")
"""
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300,
                         env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


def test_session_without_cuda_raises(monkeypatch):
    from repro_torch.api import Session
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Session()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Session(device="cuda")
    assert Session(device="cpu").device == "cpu"


def test_lower_defaults_to_cuda_backend_and_rejects_mesh():
    from repro_torch.api import ExecConfig, Session
    designed = Session(device="cpu").trace(workload="cg", n=64,
                                           iters=2).codesign()
    assert designed.lower().backend == "cuda"
    assert designed.lower(ExecConfig(backend="reference")).backend == \
        "reference"
    # frontend plans lower onto a mesh (tests/test_torch_sharded.py); a
    # mesh that does not split the plan's rows is rejected at lower time
    assert designed.lower(mesh=2).sharded.n_shards == 2
    with pytest.raises(ValueError, match="shards"):
        designed.lower(mesh=3)


def test_tf32_is_off():
    import repro_torch  # noqa: F401
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32
    assert torch.get_float32_matmul_precision() == "highest"


def test_overbooked_batches_and_wide_tiles_run_with_jax_absent():
    """``batched()`` on an overbooked plan (B3's lane form), a B1 pass with
    a tile wider than 256 columns and ``serve(unroll=True)`` import and run
    with jax absent."""
    code = """
import sys
sys.modules["jax"] = None          # any import of jax now fails
import torch
from repro_torch import frontends
from repro_torch.api import CodesignConfig, Session
from repro_torch.configs import get_config
from repro_torch.kernels.stream import StreamKernel
from repro_torch.models import init_params
plan = (Session(device="cpu").trace(workload="cg_sparse", n=4096, iters=2,
                                    pattern="banded", bandwidth=16)
        .analyze().codesign(CodesignConfig(capacity_bytes=1317278,
                                           overbook=0.25)).lower())
prog = plan.trace.program
ops = [nd.name for nd in prog.leaves() if nd.op == "operator"]
shared = frontends.make_feeds(prog, seed=0, only=ops)
reqs = [frontends.make_feeds(prog, seed=s, only=[
    nd.name for nd in prog.leaves() if nd.op != "operator"]) for s in range(3)]
for backend in ("cuda", "cuda-perunit"):
    outs = plan.batched(backend=backend).run_many(reqs, shared)
    for r, o in zip(reqs, outs):
        one = plan.run({**shared, **r})
        assert all(torch.equal(o[k], one[k]) for k in one)
p = frontends.Program("wide")
X = p.input("X", (64, 300))
p.output(p.add(p.matmul(p.operator("A", (64, 64)), X, name="AX"), X,
               name="Y"))
wide = Session.from_graph(p, device="cpu").codesign().lower()
assert bool(torch.isfinite(wide.run()["Y"]).all())
nodes = [p.nodes["AX"], p.nodes["Y"]]
shapes = {n: p.nodes[n].shape for nd in nodes for n in (*nd.inputs, nd.name)}
assert "c300_1" in StreamKernel(nodes, shapes, {"Y"}, 64).source(torch.float32)
cfg = get_config("granite-3-8b").reduced()
bundle = (Session(cfg, device="cpu").trace("prefill", batch=1, seq=32)
          .analyze().codesign().lower().serve(unroll=True))
assert bundle.unroll
params = init_params(cfg, seed=0, device="cpu")
toks = bundle.generate(params, torch.zeros((1, 4), dtype=torch.long), 3)
assert toks.shape == (1, 7)
loaded = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "repro") and sys.modules[m])
assert not loaded, loaded
print("ok")
"""
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300,
                         env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"
