"""Training step and loop: micro-batch accumulation, the CELLO remat
policy, AdamW, checkpoints and the straggler detector.

The counterpart of ``repro.launch.train`` on one device.  PyTorch runs
eagerly, so the step is a plain function: the loss's forward goes through
``models.forward(mode="train")`` (B5, B6 and B7 launched where the plan
turns them on, each under its ``models.autograd`` Function), its gradient
through ``torch.autograd.grad``, and the update through
``optim.adamw_update`` under ``torch.no_grad()``.  CUDA graphs stay
serving's; nothing here is captured.

``TrainConfig`` keeps the JAX package's five fields.  ``remat`` and
``accum_steps`` act as there and ``donate`` makes the update write
parameters and moments in place.  ``unroll`` changes nothing (the port
walks its layers in a Python loop, as ``launch.serve`` says for
serving's ``unroll=``), and ``zero1`` waits for the LLM mesh, with
``jit_train_step``, ``optimizer_shardings`` and ``zero1_shardings``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict

import torch
import torch.nn.functional as F
import torch.utils._pytree as pytree

from ..configs.base import ArchConfig
from ..core.policy import CelloPlan
from ..models import forward, init_params
from ..optim import AdamWConfig, adamw_init, adamw_update


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    accum_steps: int = 1
    remat: bool = True
    unroll: bool = False                 # no scan to unroll in the port
    zero1: bool = True                   # the LLM mesh's (not ported yet)
    donate: bool = True


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean next-token CE in nats. logits (B,S,Vp) f32; labels (B,S) int."""
    logp = F.log_softmax(logits.float(), dim=-1)
    ll = torch.gather(logp, -1, labels[..., None].long())[..., 0]
    return -ll.mean()


def make_loss_fn(cfg: ArchConfig, plan: CelloPlan, train_cfg: TrainConfig):
    """``loss_fn(params, batch)``: the mean cross-entropy of the training
    forward, every layer checkpointed under the plan's policy when
    ``train_cfg.remat`` (``models.forward`` raises for a family it does
    not train)."""
    policy = plan.checkpoint_policy() if train_cfg.remat else None

    def loss_fn(params, batch):
        logits, _ = forward(params, cfg, plan, batch["tokens"],
                            mode="train", remat_policy=policy)
        return cross_entropy(logits, batch["labels"])

    return loss_fn


def value_and_grad(loss_fn):
    """``(params, batch) -> (loss, grads)``, the gradient a tree like
    ``params``; the caller's tensors are not marked (each leaf is a
    detached alias that requires grad)."""
    def fn(params, batch):
        leaves, spec = pytree.tree_flatten(params)
        alias = [p.detach().requires_grad_(True) for p in leaves]
        loss = loss_fn(pytree.tree_unflatten(alias, spec), batch)
        grads = torch.autograd.grad(loss, alias)
        return loss.detach(), pytree.tree_unflatten(list(grads), spec)
    return fn


def make_train_step(cfg: ArchConfig, plan: CelloPlan, opt_cfg: AdamWConfig,
                    train_cfg: TrainConfig = TrainConfig()):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``; with ``accum_steps`` a > 1 the batch splits into a
    micro-batches whose losses and gradients are summed in order and
    divided by a."""
    grad_fn = value_and_grad(make_loss_fn(cfg, plan, train_cfg))

    def train_step(params, opt_state, batch):
        a = train_cfg.accum_steps
        if a > 1:
            micro = {k: v.reshape((a, v.shape[0] // a) + v.shape[1:])
                     for k, v in batch.items()}
            loss = torch.zeros((), device=batch["tokens"].device)
            grads = pytree.tree_map(
                lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                      device=p.device), params)
            for i in range(a):
                loss_i, grads_i = grad_fn(params,
                                          {k: v[i] for k, v in micro.items()})
                loss = loss + loss_i
                grads = pytree.tree_map(torch.add, grads, grads_i)
            loss = loss / a
            grads = pytree.tree_map(lambda g: g / a, grads)
        else:
            loss, grads = grad_fn(params, batch)
        params, opt_state, info = adamw_update(opt_cfg, grads, opt_state,
                                               params,
                                               inplace=train_cfg.donate)
        metrics = {"loss": loss, "lr": info["lr"],
                   "grad_norm": info["grad_norm"]}
        return params, opt_state, metrics

    return train_step


def train_loop(cfg: ArchConfig, plan: CelloPlan, opt_cfg: AdamWConfig, *,
               data_iter, n_steps: int, params=None, opt_state=None,
               start_step: int = 0,
               checkpointer=None, checkpoint_every: int = 0,
               straggler=None,
               log_every: int = 10,
               train_cfg: TrainConfig = TrainConfig(donate=False),
               seed: int = 0, device=None) -> Dict[str, Any]:
    """init → step* → metrics history, on ``device`` (the parameters'
    device when ``params`` are given — ``models.params_from_numpy`` output,
    say — else ``"cuda"`` unless the caller asks for the CPU).  Each step's
    wall time (ended by reading its loss) goes to ``straggler.record``;
    every ``checkpoint_every`` steps ``checkpointer.save(step + 1,
    {"params", "opt"}, extra={"step"})``."""
    if params is None:
        params = init_params(cfg, seed=seed, device=device or "cuda")
    device = pytree.tree_leaves(params)[0].device
    if opt_state is None:
        opt_state = adamw_init(params)
    step_fn = make_train_step(cfg, plan, opt_cfg, train_cfg)
    history = []
    for step in range(start_step, n_steps):
        inputs, labels = next(data_iter)
        batch = {"tokens": torch.as_tensor(inputs).to(device),
                 "labels": torch.as_tensor(labels).to(device)}
        t0 = time.perf_counter()
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        loss = float(metrics["loss"])
        dt = time.perf_counter() - t0
        if straggler is not None:
            straggler.record(dt)
        history.append({"step": step, "loss": loss, "time_s": dt})
        if log_every and (step % log_every == 0 or step == n_steps - 1):
            print(f"step {step:5d}  loss {loss:.4f}  "
                  f"lr {float(metrics['lr']):.2e}  {dt*1e3:.0f} ms")
        if checkpointer is not None and checkpoint_every and \
                (step + 1) % checkpoint_every == 0:
            checkpointer.save(step + 1,
                              {"params": params, "opt": opt_state},
                              extra={"step": step + 1})
    if checkpointer is not None:
        checkpointer.wait()
    return {"params": params, "opt_state": opt_state, "history": history}
