"""Multi-pod dry run: cost every (arch × shape × mesh) cell without a card.

The counterpart of ``repro.launch.dryrun``.  The reference lowers and
compiles each cell's step for 512 placeholder host devices and reads XLA's
memory and cost analyses.  The port has no compiler to ask: it walks the
step eagerly on the ``meta`` device, which allocates nothing and runs no
arithmetic, under :class:`CostCounter`, a ``TorchDispatchMode`` that sees
every aten op the step dispatches.  Per cell:

  1. builds the production mesh on meta (16×16 slots single-pod, 2×16×16
     multi-pod),
  2. builds stand-ins for params / optimizer / cache / batch: ``meta``
     tensors, one a slot (no allocation anywhere),
  3. walks the step under the counter —
       train_4k      → ``jit_train_step``'s ``MeshTrainStep`` (forward,
                       backward, AdamW / ZeRO-1, donated),
       prefill_32k   → ``models.sharded.forward``,
       decode_*      → ``models.sharded.decode_step``, the cache donated,
  4. reports the memory figures (per slot, the reference's keys) and the
     cost figures (per chip),
  5. reads the collective bytes from the mesh's exchange counter and
     writes the JSON with the reference's keys, the roofline on the
     ``H100`` data-sheet constants (predictions, not measurements).

The port walks its layers in a Python loop, so every layer is costed, as
the reference's ``unroll=True`` makes XLA cost every layer.

**What is counted.**

* ``flops``: the contractions of every dispatched op by
  ``torch.utils.flop_counter``'s formulas (2·M·N·K a product; elementwise
  ops count none, where XLA's count adds about one an element), plus
  each B5–B9 call's own ``work`` (``kernels.<k>.work``):
  the kernels run on meta as on the card up to their launch, and report
  the operations of the function they compute (B5 counts the causal
  pairs it keeps, not the masked ones).  Per chip = total / slots, the
  reference's convention for balanced shards.
* ``bytes``: every dispatched op's tensor inputs and outputs (eager
  PyTorch fuses nothing), except views and uninitialized allocations,
  which move none; an op that writes an argument in place is charged its
  other inputs and at most as many bytes written.  Each kernel call adds
  its ``work`` bytes (its operands read and its outputs written once).
* ``memory``: ``argument_bytes`` is a slot's bytes of parameters,
  optimizer state, cache and batch.  ``output_bytes`` are the step's
  outputs on a slot, ``alias_bytes`` those of them that are donated
  arguments written in place (the train step's params and moments, the
  decode step's cache).  The counter tracks every storage that an op
  allocates while it lives (its size, a weak reference to each tensor
  on it); ``temp_bytes`` is the peak of those over the walk, less the
  step's fresh outputs, over the slots, so that ``peak_estimate_bytes =
  argument + output + temp - alias`` (the reference's formula) is the
  arguments plus the walk's peak.
* ``collectives``: ``roofline.collectives(mesh)``, the exchanges' ring
  bytes per chip.

**Where the logits end up.**  The reference's prefill and decode cells
keep the logits sharded ``P(None, None, "model")``: each device holds the
whole batch's share of the vocab, the batch all-gathered over the data
axes.  The walk counts that: it takes each slot's block of the logits
(``gather_logits=False``) and all-gathers it over the data axes where the
batch is split, an all-gather in ``collectives`` as in the reference's
HLO.  ``models.sharded``'s own gather of the logits to slot 0 is not run
for these cells.  The train step's loss is vocab-parallel on each slot's
block (``launch.train.vocab_parallel_cross_entropy``), as the reference's
loss runs on its sharded logits, so it gathers nothing either: a max, two
sums and the data groups' sum, all-reduces in ``collectives``.

The reference's prefill cell returns the logits alone (the cache entries
are dead code to XLA), so the walk runs the forward without building
cache entries.  ``--cache-dus`` sets the plan's flag as the reference
does; the mesh decode step always writes its cache in place, so it
changes nothing here.  The port's B6 and B7 take fp32 weights, so with
``--serve-dtype bf16`` a decode cell runs the plain MLP and norm.

``lower_s`` is the walk's seconds, ``compile_s`` 0.0 (nothing compiles),
and ``ops``, the count of dispatched ops, stands where the reference has
``hlo_bytes``.  ``--layers N`` cuts each arch to its first N layers.

Run it on the CPU: ``PYTHONPATH=src python -m repro_torch.launch.dryrun
--arch granite-3-8b --shape decode_32k --mesh single``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
import traceback
import weakref
from typing import Any, Dict, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from .. import kernels
from ..configs import SHAPES, get_config, list_archs
from ..configs.base import ArchConfig, ShapeSpec
from ..core.policy import CelloPlan, default_plan
from ..models import init_cache, init_params, sharded
from ..models.common import PARAM_DTYPE
from ..optim import AdamWConfig
from . import shardings as shd
from .mesh import DeviceMesh, make_production_mesh
from .roofline import H100, collectives, model_flops, roofline
from .train import (TrainConfig, init_opt_state, jit_train_step,
                    zero1_shardings)

__all__ = ["CostCounter", "lower_cell", "main", "run_cells", "walk_cell"]

_aten = torch.ops.aten
#: allocations that write nothing
_EMPTIES = {_aten.empty.memory_format, _aten.empty_like.default,
            _aten.empty_strided.default, _aten.new_empty.default,
            _aten.new_empty_strided.default}
_WRITES: Dict[Any, tuple] = {}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(x, out: list) -> list:
    """The tensors in an op's arguments or results (flat, lists, tuples,
    dicts)."""
    if isinstance(x, torch.Tensor):
        out.append(x)
    elif isinstance(x, (list, tuple)):
        for v in x:
            _tensors(v, out)
    elif isinstance(x, dict):
        for v in x.values():
            _tensors(v, out)
    return out


def _written(func) -> tuple:
    """(position, name) of every argument ``func`` writes in place."""
    if func not in _WRITES:
        _WRITES[func] = tuple(
            (i, a.name) for i, a in enumerate(func._schema.arguments)
            if a.alias_info is not None and a.alias_info.is_write)
    return _WRITES[func]


class CostCounter(TorchDispatchMode):
    """Counts what a step dispatches (see the module docstring): ``flops``
    and ``bytes`` of the aten ops, ``ops``, the B5–B9 calls' ``kernels``
    work (``kernels.costing``), and ``peak`` / ``live``, the bytes of the
    storages allocated inside the block.  Works on meta and on a card
    alike: the same code dispatches the same ops, and a kernel reports the
    same work whether it launches or not."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.ops = 0
        self.live = 0
        self.peak = 0
        self._storages: Dict[int, list] = {}
        self._costing = None
        self.kernels: Dict[str, Dict[str, int]] = {}

    def __enter__(self):
        self._costing = kernels.costing()
        self.kernels = self._costing.__enter__()
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            self._costing.__exit__(*exc)

    @property
    def kernel_flops(self) -> int:
        return sum(v["flops"] for v in self.kernels.values())

    @property
    def kernel_bytes(self) -> int:
        return sum(v["bytes"] for v in self.kernels.values())

    def _drop(self, key: int) -> None:
        entry = self._storages.get(key)
        if entry is None:
            return
        entry[1] -= 1
        if entry[1] == 0:
            del self._storages[key]
            self.live -= entry[0]

    def _track(self, t: torch.Tensor, inputs: set) -> None:
        key = t.untyped_storage()._cdata
        entry = self._storages.get(key)
        if entry is None:
            if key in inputs:          # an argument's storage, written
                return
            entry = self._storages[key] = [t.untyped_storage().nbytes(), 0]
            self.live += entry[0]
            self.peak = max(self.peak, self.live)
        entry[1] += 1
        weakref.finalize(t, self._drop, key)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self.ops += 1
        formula = flop_registry.get(func.overloadpacket)
        if formula is not None:
            self.flops += int(formula(*args, **kwargs, out_val=out))
        ins = _tensors(kwargs, _tensors(args, []))
        outs = _tensors(out, [])
        if not func.is_view and func not in _EMPTIES:
            written = _written(func)
            if written:
                hit = {id(args[i] if i < len(args) else kwargs.get(n))
                       for i, n in written}
                read = sum(_nbytes(t) for t in ins if id(t) not in hit)
                wrote = sum(_nbytes(t) for t in outs)
                self.bytes += read + (min(wrote, read) if read else wrote)
            else:
                self.bytes += (sum(_nbytes(t) for t in ins)
                               + sum(_nbytes(t) for t in outs))
        keys = {t.untyped_storage()._cdata for t in ins}
        for t in outs:
            self._track(t, keys)
        return out


# ---------------------------------------------------------------------------
# a cell's arguments
# ---------------------------------------------------------------------------

def _plan_for(cfg: ArchConfig, shape: ShapeSpec, attention: str,
              serve_dtype: str = "f32") -> CelloPlan:
    plan = default_plan(cfg, seq=shape.seq_len)
    if attention == "naive":
        plan = dataclasses.replace(plan, use_flash_attention=False,
                                   use_fused_mlp=False,
                                   notes="seq-implicit baseline")
    if serve_dtype == "bf16" and shape.mode == "decode":
        # B6 and B7 take fp32 weights: bf16 ones run the plain forms
        plan = dataclasses.replace(plan, use_fused_mlp=False,
                                   use_fused_rmsnorm=False)
    return plan


def _slots(tree, shardings, mesh: DeviceMesh):
    """An uninitialized per-slot tree for the global shapes ``tree``."""
    return shd.map_tree(
        lambda t, sh: shd.Sharded(
            [torch.empty(sh.shard_shape(t.shape), dtype=t.dtype, device=d)
             for d in mesh.devices], sh, t.shape), tree, shardings)


def _local_bytes(t: torch.Tensor) -> int:
    """A slot's bytes of the global batch tensor ``t`` (its ``.sharding``
    stand-in's)."""
    sh = t.sharding
    shape = sh.shard_shape(tuple(t.shape)) if sh is not None else t.shape
    n = 1
    for e in shape:
        n *= e
    return n * t.element_size()


def _batch(cfg: ArchConfig, specs: Dict[str, Any], device
           ) -> Dict[str, torch.Tensor]:
    """The batch's tensors: the stand-ins themselves on meta, else values
    from seed 0 on ``device`` (tokens below the vocab)."""
    names = [k for k in ("tokens", "labels", "frames", "img", "pos")
             if k in specs]
    if device.type == "meta":
        return {k: specs[k] for k in names}
    gen = torch.Generator().manual_seed(0)
    out = {}
    for k in names:
        s = specs[k]
        if k == "pos":
            v = torch.tensor(0, dtype=s.dtype)
        elif s.dtype.is_floating_point:
            v = torch.randn(tuple(s.shape), generator=gen).to(s.dtype)
        else:
            v = torch.randint(0, cfg.vocab, tuple(s.shape), generator=gen,
                              dtype=s.dtype)
        out[k] = v.to(device)
        out[k].sharding = s.sharding
    return out


# ---------------------------------------------------------------------------
# the walk
# ---------------------------------------------------------------------------

def walk_cell(cfg: ArchConfig, shape: ShapeSpec, mesh: DeviceMesh,
              plan: CelloPlan, *, remat: bool = True, zero1: bool = True,
              accum: int = 1, serve_dtype: str = "f32",
              logits_batch_split: bool = False,
              timed_runs: int = 0) -> Dict[str, Any]:
    """One cell's step on ``mesh`` under a :class:`CostCounter`: on a meta
    mesh over stand-ins, on a real device over random arguments from seed
    0 (the same counts: nothing counted reads a value).  Returns the
    figures of the module docstring (``memory``, ``cost``,
    ``collectives``, ``roofline`` on ``H100``), the kernels' work and the
    walk's seconds.  ``logits_batch_split`` leaves the logits split over
    the data axes (``P("data", None, "model")``) instead of gathering
    the batch.  On a card the result also has ``device_memory``, the
    bytes allocated before the walk and the most allocated during it
    (``torch.cuda.max_memory_allocated`` from a reset), and with
    ``timed_runs`` the least seconds of that many more runs of the step
    outside the counter (``run_seconds``)."""
    dev = mesh.devices[0]
    meta = dev.type == "meta"
    K = mesh.size
    specs = shd.input_specs(cfg, shape, mesh)
    dtype = (torch.bfloat16 if serve_dtype == "bf16"
             and shape.mode == "decode" else None)
    p_sds, p_sh = shd.params_for_split(cfg, mesh, dtype=dtype)
    if meta:
        params = _slots(p_sds, p_sh, mesh)
    else:
        params = shd.shard_tree(init_params(
            cfg, seed=0, device=dev,
            dtype=PARAM_DTYPE if dtype is None else dtype), p_sh)
    batch = _batch(cfg, specs, dev)
    args = {"params": shd.slot_bytes(params, 0),
            "batch": sum(_local_bytes(t) for t in batch.values())}
    donated = 0
    if shape.mode == "train":
        o_sh = zero1_shardings(p_sds, p_sh, mesh, zero1)
        opt = init_opt_state(params, o_sh)
        args["opt_state"] = shd.slot_bytes(opt, 0)
        donated = args["params"] + args["opt_state"]
        step = jit_train_step(
            cfg, plan, AdamWConfig(), mesh,
            TrainConfig(remat=remat, unroll=True, zero1=zero1,
                        accum_steps=accum, donate=True),
            batch_specs=batch, p_shardings=p_sh, o_shardings=o_sh)

        def run():
            return step(params, opt, batch)[2]
    else:
        split = mesh.data_axes and shape.global_batch % mesh.axis_size(
            mesh.data_axes) == 0
        if shape.mode == "decode":
            c_sh = specs["cache_shardings"]
            cache = (_slots(specs["cache"], c_sh, mesh) if meta else
                     shd.shard_tree(init_cache(cfg, shape.global_batch,
                                               shape.seq_len, device=dev),
                                    c_sh))
            args["cache"] = donated = shd.slot_bytes(cache, 0)

            def logits_parts():
                return sharded.decode_step(params, cache, cfg, plan,
                                           batch["tokens"], batch["pos"],
                                           gather_logits=False)[0]
        else:
            def logits_parts():
                # the reference's cell returns the logits alone: no
                # cache entries ("train" builds none; no grad, no tags)
                return sharded.forward(params, cfg, plan, batch["tokens"],
                                       frames=batch.get("frames"),
                                       img=batch.get("img"), mode="train",
                                       gather_logits=False)[0]

        def run():
            with torch.no_grad():
                parts = logits_parts()
                if split and not logits_batch_split:
                    parts = mesh.all_gather(parts, mesh.data_axes, 0)
                return parts
    mesh.reset_exchanged()
    device_memory = None
    if not meta:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        device_memory = {
            "allocated_before": torch.cuda.memory_allocated(dev)}
    t0 = time.perf_counter()
    with CostCounter() as counter:
        out = run()
        if not meta:
            torch.cuda.synchronize(dev)
    seconds = time.perf_counter() - t0
    exchanged = dict(mesh.exchanged)
    coll = collectives(mesh)
    run_seconds = None
    if not meta:
        device_memory["max_allocated"] = torch.cuda.max_memory_allocated(dev)
        times = []
        for _ in range(timed_runs):
            t1 = time.perf_counter()
            run()
            torch.cuda.synchronize(dev)
            times.append(time.perf_counter() - t1)
        run_seconds = min(times) if times else None
    fresh = (sum(_nbytes(t) for t in out.values()) if isinstance(out, dict)
             else _nbytes(out[0]))
    arg_bytes = sum(args.values())
    out_bytes = fresh + donated
    temp = max(0, counter.peak // K - fresh)
    flops = (counter.flops + counter.kernel_flops) / K
    nbytes = (counter.bytes + counter.kernel_bytes) / K
    terms = roofline(flops, nbytes, coll["total"], K,
                     model_flops(cfg, shape))
    return {
        "n_chips": K,
        "seconds": seconds,
        "run_seconds": run_seconds,
        "device_memory": device_memory,
        "ops": counter.ops,
        "counted": {"contraction_flops": counter.flops,
                    "bytes": counter.bytes},
        "memory": {
            "argument_bytes": arg_bytes,
            "output_bytes": out_bytes,
            "temp_bytes": temp,
            "alias_bytes": donated,
            "peak_estimate_bytes": arg_bytes + out_bytes + temp - donated,
            "arguments": args,
            "peak_live_bytes_all_slots": counter.peak,
        },
        "cost": {"flops_per_chip": flops, "bytes_per_chip": nbytes,
                 "contraction_flops_per_chip": counter.flops / K,
                 "kernel_flops_per_chip": counter.kernel_flops / K,
                 "kernel_bytes_per_chip": counter.kernel_bytes / K},
        "kernels": {k: dict(v) for k, v in counter.kernels.items()},
        "collectives": coll,
        "exchanged": exchanged,
        "roofline": terms.to_dict(),
        "hardware": H100.name,
    }


def lower_cell(arch: str, shape_name: str, multi_pod: bool, *,
               attention: str = "flash", remat: bool = True,
               zero1: bool = True, accum: int = 1,
               kv_block: Optional[int] = None,
               cache_dus: bool = False,
               moe_cf: Optional[float] = None,
               serve_dtype: str = "f32",
               layers: Optional[int] = None) -> Dict:
    """One cell of the production mesh on meta (the reference's
    arguments; ``layers`` cuts the arch to its first ``layers``)."""
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    if shape_name not in cfg.supported_shapes():
        return {"arch": arch, "shape": shape_name,
                "mesh": "multi" if multi_pod else "single",
                "status": "skipped",
                "reason": ("encoder-only: no decode step"
                           if cfg.encoder_only else
                           "full-attention arch: 500k decode skipped "
                           "(see DESIGN.md)")}
    if layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    mesh = make_production_mesh(multi_pod=multi_pod, device="meta")
    plan = _plan_for(cfg, shape, attention, serve_dtype)
    if kv_block:
        plan = dataclasses.replace(plan, kv_block=kv_block)
    if cache_dus:
        plan = dataclasses.replace(plan, cache_select_update=False)
    if moe_cf is not None:
        plan = dataclasses.replace(plan, moe_capacity_factor=moe_cf)
    walk = walk_cell(cfg, shape, mesh, plan, remat=remat, zero1=zero1,
                     accum=accum, serve_dtype=serve_dtype)
    return {
        "arch": arch, "shape": shape_name,
        "mesh": "multi" if multi_pod else "single",
        "status": "ok",
        "n_chips": walk["n_chips"],
        "attention": attention, "remat": remat, "zero1": zero1,
        "cache_dus": cache_dus,
        "accum": accum, "kv_block": plan.kv_block,
        "layers": cfg.n_layers,
        "lower_s": round(walk["seconds"], 2), "compile_s": 0.0,
        "memory": walk["memory"],
        "cost": walk["cost"],
        "kernels": walk["kernels"],
        "collectives": walk["collectives"],
        "roofline": walk["roofline"],
        "hardware": walk["hardware"],
        "ops": walk["ops"],
    }


def run_cells(args) -> int:
    archs = [args.arch] if args.arch else list_archs()
    shapes = [args.shape] if args.shape else list(SHAPES)
    meshes = ({"single": [False], "multi": [True],
               "both": [False, True]})[args.mesh]
    os.makedirs(args.outdir, exist_ok=True)
    failures = 0
    for arch in archs:
        for shape in shapes:
            for multi in meshes:
                tagpart = f"__{args.tag}" if args.tag else ""
                name = (f"{arch}__{shape}__"
                        f"{'multi' if multi else 'single'}{tagpart}.json")
                out_path = os.path.join(args.outdir, name)
                if args.skip_existing and os.path.exists(out_path):
                    print(f"[skip-existing] {name}")
                    continue
                print(f"=== {arch} × {shape} × "
                      f"{'multi' if multi else 'single'} ===", flush=True)
                try:
                    res = lower_cell(arch, shape, multi,
                                     attention=args.attention,
                                     remat=not args.no_remat,
                                     zero1=not args.no_zero1,
                                     accum=args.accum,
                                     kv_block=args.kv_block,
                                     cache_dus=args.cache_dus,
                                     moe_cf=args.moe_cf,
                                     serve_dtype=args.serve_dtype,
                                     layers=args.layers)
                except Exception as e:           # a failure here is a bug
                    traceback.print_exc()
                    res = {"arch": arch, "shape": shape,
                           "mesh": "multi" if multi else "single",
                           "status": "error", "error": repr(e)}
                    failures += 1
                if res.get("status") == "ok":
                    r = res["roofline"]
                    print(f"  compute {r['compute_s']*1e3:9.3f} ms | "
                          f"memory {r['memory_s']*1e3:9.3f} ms | "
                          f"collective {r['collective_s']*1e3:9.3f} ms | "
                          f"dominant {r['dominant']} (H100 data-sheet "
                          f"peaks; walk {res['lower_s']} s)", flush=True)
                with open(out_path, "w") as f:
                    json.dump(res, f, indent=1)
    return failures


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", choices=list_archs())
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="both")
    ap.add_argument("--outdir", default="experiments/dryrun_torch")
    ap.add_argument("--tag", default="",
                    help="suffix for §Perf hillclimb variants")
    ap.add_argument("--attention", choices=["flash", "naive"],
                    default="flash")
    ap.add_argument("--no-remat", action="store_true")
    ap.add_argument("--no-zero1", action="store_true")
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--kv-block", type=int, default=None)
    ap.add_argument("--cache-dus", action="store_true",
                    help="baseline: dynamic_update_slice cache writes")
    ap.add_argument("--moe-cf", type=float, default=None,
                    help="MoE capacity factor override")
    ap.add_argument("--serve-dtype", choices=["f32", "bf16"], default="f32",
                    help="param dtype for decode cells (serving precision)")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut every arch to its first N layers")
    ap.add_argument("--skip-existing", action="store_true")
    args = ap.parse_args()
    failures = run_cells(args)
    sys.exit(1 if failures else 0)


if __name__ == "__main__":
    main()
