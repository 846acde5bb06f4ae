"""Fault-tolerance demo on the port: training with injected node failures —
every failure restores the latest committed checkpoint, re-partitions the
data stream for the surviving capacity (elastic), and continues.

The PyTorch/CUDA twin of ``examples/elastic_restart.py``: the same flags,
defaults and printed lines.  Reduced granite-3-8b, random weights from
seed 0, batches of 8 x 32 from the Markov source; each step's forward runs
on the kernels the plan turns on (B5, B6, B7), the backward through their
plain forms, AdamW on the card.  Every 4 steps an ``AsyncCheckpointer``
copies the state (parameters, moments, step count: CUDA tensors) to the
host and writes it beside the data stream's state (the step its next
batch is drawn for); a failure restores both from the newest committed
step, each leaf onto the device the state lives on with its dtype, and
training goes on from there with the same losses as an uninterrupted run
(each batch is a pure function of the stream's seed and step, and no
step draws other random numbers).

    PYTHONPATH=src python examples/torch_elastic_restart.py
    PYTHONPATH=src python examples/torch_elastic_restart.py --fail-at   # no failure
    PYTHONPATH=src python examples/torch_elastic_restart.py --device cpu

``--ckpt-dir`` defaults to a new temporary directory, so no checkpoint of
an earlier run is restored.  ``--device cuda`` (the default) raises
without a card; ``--device cpu`` runs the kernels' plain torch versions.
``main(argv)`` returns what it printed as data, with the final state and,
for each restore, the restored leaves' devices and dtypes beside the
dtypes the checkpoint recorded.
"""
import argparse
import json
import os
import tempfile

import torch
import torch.utils._pytree as pytree

from repro_torch.api import Session
from repro_torch.checkpoint import (AsyncCheckpointer, latest_step,
                                    load_checkpoint)
from repro_torch.configs import get_config
from repro_torch.data import DataConfig, SyntheticLMData
from repro_torch.launch.train import TrainConfig, make_train_step
from repro_torch.models import init_params
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.runtime import ElasticScaler, run_with_restarts

KEEP = 3


def _dtype(t) -> str:
    return str(t.dtype).removeprefix("torch.")


def saved_dtypes(directory: str, step: int):
    """The dtype each leaf of a committed checkpoint was saved with, in the
    tree's leaf order."""
    with open(os.path.join(directory, f"step_{step:08d}", "meta.json")) as f:
        return [a["dtype"] for a in json.load(f)["arrays"].values()]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=24)
    ap.add_argument("--fail-at", type=int, nargs="*", default=[7, 15])
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint directory (default: a new temporary "
                         "one)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels; raises without a card) or cpu "
                         "(their plain torch versions)")
    args = ap.parse_args(argv)
    ckpt_dir = args.ckpt_dir or tempfile.mkdtemp(prefix="cello_elastic_")

    cfg = get_config("granite-3-8b").reduced()
    compiled = Session(cfg, device=args.device).default_plan(seq=32)
    plan = compiled.plan
    opt_cfg = AdamWConfig(lr=1e-3, warmup_steps=4, total_steps=args.steps)
    params = init_params(cfg, seed=0, device=compiled.device)
    opt_state = adamw_init(params)
    data = SyntheticLMData(DataConfig(vocab=cfg.vocab, seq_len=32,
                                      global_batch=8, seed=0))
    step_fn = make_train_step(cfg, plan, opt_cfg, TrainConfig(donate=False))
    ck = AsyncCheckpointer(ckpt_dir, keep=KEEP)
    scaler = ElasticScaler(model_axis=16, pod_chips=256)
    state = {"params": params, "opt": opt_state}
    fleet = {"devices": 768}           # three pods; each failure drops one
    to_fail = set(args.fail_at)
    log = {"steps": [], "restores": []}

    def train_one(step: int) -> None:
        if step in to_fail:
            to_fail.discard(step)
            fleet["devices"] -= 256            # a whole pod drops out
            raise RuntimeError(f"pod failure at step {step}")
        x, y = next(data)                      # the stream's step-th batch
        batch = {"tokens": torch.as_tensor(x).to(compiled.device),
                 "labels": torch.as_tensor(y).to(compiled.device)}
        state["params"], state["opt"], m = step_fn(state["params"],
                                                   state["opt"], batch)
        loss = float(m["loss"])
        log["steps"].append({"step": step, "loss": loss,
                             "devices": fleet["devices"]})
        print(f"  step {step:3d}  loss {loss:.4f}  "
              f"devices={fleet['devices']}")
        if (step + 1) % 4 == 0:
            # the snapshot is copied to the host before save() returns,
            # so the next step's update cannot reach it
            ck.save(step + 1, state, extra={"step": step + 1,
                                            "data": data.state_dict()})
            ck.wait()

    def restore(failed_step: int) -> int:
        last = latest_step(ckpt_dir) or 0
        plan_ = scaler.plan(fleet["devices"], restore_step=last)
        print(f"  !! restoring step {last} onto mesh {plan_.mesh_shape} "
              f"({plan_.n_devices} chips)")
        record = {"failed_step": failed_step, "step": last,
                  "mesh": plan_.mesh_shape, "chips": plan_.n_devices}
        data.step = 0
        if last > 0:
            restored, extra = load_checkpoint(ckpt_dir, last, state)
            state.update(restored)
            data.load_state_dict(extra["data"])     # back to step `last`
            record["leaves"] = [(t.device.type, _dtype(t))
                                for t in pytree.tree_leaves(restored)]
            record["saved_dtypes"] = saved_dtypes(ckpt_dir, last)
        log["restores"].append(record)
        # elastic data repartition (single host here: shard 0 of 1)
        return last

    stats = run_with_restarts(train_one, restore, n_steps=args.steps,
                              max_restarts=5)
    ck.wait()
    print(f"\ncompleted {stats['completed']} steps with "
          f"{stats['restarts']} restarts; final capacity "
          f"{fleet['devices']} chips")
    kept = sorted(int(n[len("step_"):]) for n in os.listdir(ckpt_dir)
                  if n.startswith("step_") and not n.endswith(".tmp"))
    return {**log, "completed": stats["completed"],
            "restarts": stats["restarts"], "devices": fleet["devices"],
            "ckpt_dir": ckpt_dir, "kept_steps": kept, "keep": KEEP,
            "state": state}


if __name__ == "__main__":
    main()
