"""Training step and loop: micro-batch accumulation, the CELLO remat
policy, AdamW, checkpoints and the straggler detector.

The counterpart of ``repro.launch.train`` on one device.  PyTorch runs
eagerly, so the step is a plain function: the loss's forward goes through
``models.forward(mode="train")`` (B5, B6 and B7 launched where the plan
turns them on, each under its ``models.autograd`` Function), its gradient
through ``torch.autograd.grad``, and the update through
``optim.adamw_update`` under ``torch.no_grad()``.  CUDA graphs stay
serving's; nothing here is captured.

The audio and vlm families train on stubbed inputs, as in the JAX
package: :func:`stub_inputs` makes ``frames`` (audio, in place of the
token embedding) and ``img`` (vlm, the image embeddings the ``xattn``
layers attend to), and ``make_loss_fn`` passes a batch's ``frames`` and
``img`` to the forward.

``TrainConfig`` keeps the JAX package's five fields.  ``remat`` and
``accum_steps`` act as there and ``donate`` makes the update write
parameters and moments in place.  ``unroll`` changes nothing (the port
walks its layers in a Python loop, as ``launch.serve`` says for
serving's ``unroll=``).  ``zero1`` acts on the mesh step.

Over a ``DeviceMesh``, ``jit_train_step(cfg, plan, opt_cfg, mesh,
train_cfg, batch_specs=, p_shardings=, o_shardings=)`` (the reference's
arguments) returns :class:`MeshTrainStep`: the loss's forward through
``models.sharded.forward`` on the per-slot params, its gradient through
``models.sharded.value_and_grad`` (each leaf's gradient summed over the
slots that hold its replicas), then AdamW a slot at a time.  The moments
take ``optimizer_shardings`` (``zero1``: a data slot holds its slice of
each moment, ``optim.zero1_pspecs``): each slot updates its slice of its
parameter block, then every parameter block is all-gathered over the data
slots, so the data replicas stay bitwise equal.  ``accum_steps`` and
``remat`` act per slot as above; ``donate`` writes every slot's params
and moments in place.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F
import torch.utils._pytree as pytree

from ..configs.base import ArchConfig
from ..core.policy import CelloPlan
from ..models import forward, init_params, param_pspecs
from ..optim import AdamWConfig, adamw_init, adamw_update, zero1_pspecs
from ..optim.adamw import _zero1_spec, clip_scale, schedule, update_leaf
from . import shardings as shd
from .mesh import DeviceMesh, NamedSharding, PartitionSpec


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    accum_steps: int = 1
    remat: bool = True
    unroll: bool = False                 # no scan to unroll in the port
    zero1: bool = True                   # the mesh step's (MeshTrainStep)
    donate: bool = True


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean next-token CE in nats. logits (B,S,Vp) f32; labels (B,S) int."""
    logp = F.log_softmax(logits.float(), dim=-1)
    ll = torch.gather(logp, -1, labels[..., None].long())[..., 0]
    return -ll.mean()


def make_loss_fn(cfg: ArchConfig, plan: CelloPlan, train_cfg: TrainConfig):
    """``loss_fn(params, batch)``: the mean cross-entropy of the training
    forward on ``batch["tokens"]`` (and its ``frames`` / ``img`` where
    given), every layer checkpointed under the plan's policy when
    ``train_cfg.remat``."""
    policy = plan.checkpoint_policy() if train_cfg.remat else None

    def loss_fn(params, batch):
        logits, _ = forward(params, cfg, plan, batch["tokens"],
                            frames=batch.get("frames"), img=batch.get("img"),
                            mode="train", remat_policy=policy)
        return cross_entropy(logits, batch["labels"])

    return loss_fn


def stub_inputs(cfg: ArchConfig, batch: int, seq: int, step: int,
                device) -> Dict[str, torch.Tensor]:
    """The stubbed frontend inputs of step ``step``: bf16 standard normal
    ``frames`` (batch, seq, d_model) for the audio family and ``img``
    (batch, vision_seq, d_model) for the vlm, none for the others, drawn
    on ``device`` by a ``torch.Generator`` seeded with ``step``.  The JAX
    package draws its stubs with ``jax.random.PRNGKey(step)``
    (``repro/launch/train.py:184-192``), so the numbers differ from its
    (the shapes, dtype and distribution are the same); tests that hold
    the two packages together feed both the same arrays."""
    shape = {"audio": ("frames", seq), "vlm": ("img", cfg.vision_seq)}
    if cfg.family not in shape:
        return {}
    name, rows = shape[cfg.family]
    gen = torch.Generator(device=device)
    gen.manual_seed(step)
    return {name: torch.randn((batch, rows, cfg.d_model), generator=gen,
                              device=device, dtype=torch.bfloat16)}


def value_and_grad(loss_fn):
    """``(params, batch) -> (loss, grads)``, the gradient a tree like
    ``params``; the caller's tensors are not marked (each leaf is a
    detached alias that requires grad).  A leaf the loss does not use (the
    token embedding of an audio model, which reads ``frames``) gets zeros,
    as ``jax.grad`` gives it."""
    def fn(params, batch):
        leaves, spec = pytree.tree_flatten(params)
        alias = [p.detach().requires_grad_(True) for p in leaves]
        loss = loss_fn(pytree.tree_unflatten(alias, spec), batch)
        grads = torch.autograd.grad(loss, alias, materialize_grads=True)
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


# ---------------------------------------------------------------------------
# the mesh step
# ---------------------------------------------------------------------------

def optimizer_shardings(cfg: ArchConfig, mesh: DeviceMesh,
                        zero1: bool = True) -> Dict[str, Any]:
    """NamedSharding tree for the AdamW state (ZeRO-1 over the data
    axes)."""
    pshapes = init_params(cfg, device="meta")
    pspecs = param_pspecs(cfg)
    if zero1:
        axes = mesh.data_axes
        mspecs = zero1_pspecs(pspecs, pshapes, mesh.axis_size(axes or None),
                              axes)
    else:
        mspecs = pspecs
    moments = shd.resolve_tree(mesh, mspecs, pshapes)
    return {"m": moments, "v": moments,
            "count": NamedSharding(mesh, PartitionSpec())}


def zero1_shardings(params_sds, p_shardings, mesh: DeviceMesh,
                    zero1: bool = True) -> Dict[str, Any]:
    """Moment shardings derived from param shardings (``params_for``'s,
    say) and a matching tree of shapes."""
    if not zero1:
        moments = p_shardings
    else:
        axes = mesh.data_axes
        size = mesh.axis_size(axes or None)
        moments = shd.map_tree(
            lambda sharding, sds: NamedSharding(mesh, PartitionSpec(
                *_zero1_spec(sharding.spec, tuple(sds.shape), size, axes))),
            p_shardings, params_sds)
    return {"m": moments, "v": moments,
            "count": NamedSharding(mesh, PartitionSpec())}


def init_opt_state(params, o_shardings) -> Dict[str, Any]:
    """Zero moments in per-slot form by ``o_shardings`` for the per-slot
    ``params``, and a step count on every slot."""
    def zeros(p: shd.Sharded, sharding: NamedSharding) -> shd.Sharded:
        shape = sharding.shard_shape(p.shape)
        return shd.Sharded([torch.zeros(shape, dtype=torch.float32,
                                        device=d)
                            for d in sharding.mesh.devices], sharding,
                           p.shape)
    is_leaf = lambda x: isinstance(x, shd.Sharded)  # noqa: E731
    count = o_shardings["count"]
    return {"m": shd.map_tree(zeros, params, o_shardings["m"],
                              is_leaf=is_leaf),
            "v": shd.map_tree(zeros, params, o_shardings["v"],
                              is_leaf=is_leaf),
            "count": shd.Sharded([torch.zeros((), dtype=torch.int32,
                                              device=d)
                                  for d in count.mesh.devices], count, ())}


def _sub_block(p: shd.Sharded, moment: NamedSharding, slot: int):
    """The index of the moment's block within the slot's param block."""
    pb = p.sharding.block(slot, p.shape)
    mb = moment.block(slot, p.shape)
    out = []
    for ps, ms, n in zip(pb, mb, p.shape):
        p0 = ps.start or 0
        m0, m1 = ms.start or 0, n if ms.stop is None else ms.stop
        out.append(slice(m0 - p0, m1 - p0))
    return tuple(out)


@torch.no_grad()
def mesh_adamw_update(cfg: AdamWConfig, grads, state, params, *,
                      inplace: bool = False):
    """``optim.adamw_update`` on per-slot trees (``grads`` already summed
    over replicas).  The global norm sums, on each slot, the squares of
    the leaves whose replica it owns (index 0 along the axes its sharding
    does not name), then psums over all slots; each slot updates its
    moment slice of its param block; param blocks are then all-gathered
    over the data slots.  Returns ``(params, state, {"lr",
    "grad_norm"})`` on slot 0; with ``inplace`` the given trees, updated."""
    is_leaf = lambda x: isinstance(x, shd.Sharded)  # noqa: E731
    P = shd.tree_leaves(params, is_leaf)
    G = shd.tree_leaves(grads, is_leaf)
    M = shd.tree_leaves(state["m"], is_leaf)
    V = shd.tree_leaves(state["v"], is_leaf)
    mesh = P[0].mesh
    K = mesh.size

    def owner(s: shd.Sharded, k: int) -> bool:
        axes = tuple(a for a in mesh.axis_names
                     if a not in s.sharding.axes())
        return mesh.index(k, axes or None) == 0
    sums = []
    for k in range(K):
        own = [torch.sum(torch.square(g.parts[k].float())) for g in G
               if owner(g, k)]
        sums.append(torch.stack(own).sum() if own else
                    torch.zeros((), device=mesh.devices[k]))
    norms = [torch.sqrt(t) for t in mesh.psum(sums, mesh.axis_names)]
    counts = [c + 1 for c in state["count"].parts]
    sched = [schedule(cfg, c) for c in counts]
    scales = [clip_scale(cfg, n) for n in norms]
    new_p, new_m, new_v = [], [], []
    for p, g, m, v in zip(P, G, M, V):
        ps, ms, vs = [], [], []
        for k in range(K):
            rel = _sub_block(p, m.sharding, k)
            part = p.parts[k] if inplace else p.parts[k].clone()
            lr, bc1, bc2 = sched[k]
            _, mk, vk = update_leaf(
                cfg, g.parts[k][rel], m.parts[k] if inplace else
                m.parts[k].clone(), v.parts[k] if inplace else
                v.parts[k].clone(), part[rel], lr=lr, scale=scales[k],
                bc1=bc1, bc2=bc2, inplace=True)
            ps.append(part)
            ms.append(mk)
            vs.append(vk)
        # the data slots' updated slices, to every replica
        if m.sharding.axes() != p.sharding.axes():
            moved = 0
            for members in mesh.groups(mesh.data_axes):
                for j in members:
                    rel = _sub_block(p, m.sharding, j)
                    for k in members:
                        if k != j:
                            ps[k][rel].copy_(ps[j][rel])
                n = len(members)
                block = ps[members[0]][_sub_block(p, m.sharding,
                                                  members[0])]
                moved += n * (n - 1) * block.numel() * block.element_size()
            mesh.record("all_gather", moved)
        new_p.append(shd.Sharded(ps, p.sharding, p.shape))
        new_m.append(shd.Sharded(ms, m.sharding, m.shape))
        new_v.append(shd.Sharded(vs, v.sharding, v.shape))
    info = {"lr": sched[0][0], "grad_norm": norms[0]}
    if inplace:
        for c, n in zip(state["count"].parts, counts):
            c.copy_(n)
        return params, state, info
    it_p, it_m, it_v = iter(new_p), iter(new_m), iter(new_v)
    return (shd.map_tree(lambda _: next(it_p), params, is_leaf=is_leaf),
            {"m": shd.map_tree(lambda _: next(it_m), state["m"],
                               is_leaf=is_leaf),
             "v": shd.map_tree(lambda _: next(it_v), state["v"],
                               is_leaf=is_leaf),
             "count": shd.Sharded(counts, state["count"].sharding, ())},
            info)


def vocab_parallel_cross_entropy(parts, labels: torch.Tensor,
                                 lm_head: shd.Sharded) -> torch.Tensor:
    """``cross_entropy`` of the global logits, from the slots' blocks of
    them (``models.sharded.forward(..., gather_logits=False)``: each slot
    its data group's rows and, where ``lm_head`` splits, its block of the
    padded vocab), with no logits gathered.  Over the model slots: each
    row's max (``DeviceMesh.pmax``, a shift the gradient does not see),
    the sum of the exponentials and the label's logit, given by the slot
    that holds its column (psums); then the sum of the rows' losses over
    the data groups (a psum) over the global rows.  The log-softmax runs
    over all ``padded_vocab`` columns, as ``repro/launch/train.py:33-37``
    does.  Returns the loss on slot 0 (``cross_entropy`` of its logits
    where slot 0 holds them all)."""
    mesh = lm_head.mesh
    width = parts[0].shape[-1]
    split_v = width != lm_head.shape[-1]
    rows = parts[0].shape[0]
    split_b = rows != labels.shape[0]
    if not (split_v or split_b):          # slot 0 holds the global logits
        return cross_entropy(parts[0], labels.to(parts[0].device))
    model = ("model",) if split_v else ()
    xs = [p.float() for p in parts]
    tops = [x.detach().amax(-1, keepdim=True) for x in xs]
    if split_v:
        tops = mesh.pmax(tops, model)
    sums, picked = [], []
    for k, x in enumerate(xs):
        g = mesh.index(k, mesh.data_axes or None) if split_b else 0
        lab = labels[g * rows:(g + 1) * rows].to(x.device).long()
        local = lab - mesh.index(k, "model") * width if split_v else lab
        inside = (local >= 0) & (local < width)
        at = torch.gather(x, -1, local.clamp(0, width - 1)[..., None])
        picked.append(torch.where(inside, at[..., 0],
                                  torch.zeros_like(at[..., 0])))
        sums.append(torch.exp(x - tops[k]).sum(-1))
    if split_v:
        sums = mesh.psum(sums, model)
        picked = mesh.psum(picked, model)
    losses = [(torch.log(s) + t[..., 0] - ll).sum()
              for s, t, ll in zip(sums, tops, picked)]
    if split_b:
        losses = mesh.psum(losses, mesh.data_axes)
    return losses[0].to(mesh.devices[0]) / labels.numel()


def make_mesh_loss_fn(cfg: ArchConfig, plan: CelloPlan,
                      train_cfg: TrainConfig):
    """``make_loss_fn`` over the mesh: the per-slot forward's blocks of
    the logits against the global labels, by
    :func:`vocab_parallel_cross_entropy` (no logits gathered)."""
    from ..models import sharded
    policy = plan.checkpoint_policy() if train_cfg.remat else None

    def loss_fn(params, batch):
        parts, _ = sharded.forward(params, cfg, plan, batch["tokens"],
                                   frames=batch.get("frames"),
                                   img=batch.get("img"), mode="train",
                                   remat_policy=policy, gather_logits=False)
        return vocab_parallel_cross_entropy(parts, batch["labels"],
                                            params["lm_head"])

    return loss_fn


class MeshTrainStep:
    """``step(params, opt_state, batch) -> (params, opt_state, metrics)``
    over a mesh (see the module docstring).  ``params`` and ``opt_state``
    in per-slot form (``shard_tree`` / :func:`init_opt_state`), or global
    (an ``init_params`` tree, an ``adamw_init`` state), which the step
    shards first (so nothing of the caller's is written then); ``batch``
    holds global tensors shaped as ``batch_specs`` says.  ``exchanged``
    holds the bytes the last step's exchanges moved, by kind."""

    def __init__(self, cfg: ArchConfig, plan: CelloPlan,
                 opt_cfg: AdamWConfig, mesh: DeviceMesh,
                 train_cfg: TrainConfig, batch_specs: Dict[str, Any],
                 p_shardings, o_shardings):
        from ..models import sharded
        self.cfg, self.plan, self.opt_cfg = cfg, plan, opt_cfg
        self.mesh, self.train_cfg = mesh, train_cfg
        self.batch_specs = batch_specs
        self.p_shardings, self.o_shardings = p_shardings, o_shardings
        self._grad_fn = sharded.value_and_grad(
            make_mesh_loss_fn(cfg, plan, train_cfg))
        self.exchanged: Dict[str, int] = {}

    def shard(self, params, opt_state=None):
        """(params, opt_state) in per-slot form: global trees sharded,
        per-slot ones as they are; no ``opt_state``: fresh moments."""
        if not isinstance(params["embed"], shd.Sharded):
            params = shd.shard_tree(params, self.p_shardings)
        if opt_state is None:
            opt_state = init_opt_state(params, self.o_shardings)
        elif not isinstance(opt_state["count"], shd.Sharded):
            opt_state = shd.shard_tree(opt_state, self.o_shardings)
        return params, opt_state

    def __call__(self, params, opt_state, batch):
        if set(batch) != set(self.batch_specs):
            raise ValueError(f"batch keys {sorted(batch)}, batch_specs "
                             f"{sorted(self.batch_specs)}")
        for k, v in batch.items():
            if tuple(v.shape) != tuple(self.batch_specs[k].shape):
                raise ValueError(f"batch[{k!r}] {tuple(v.shape)}, "
                                 f"batch_specs {tuple(self.batch_specs[k].shape)}")
        params, opt_state = self.shard(params, opt_state)
        before = dict(self.mesh.exchanged)
        a = self.train_cfg.accum_steps
        if a > 1:
            micro = {k: v.reshape((a, v.shape[0] // a) + v.shape[1:])
                     for k, v in batch.items()}
            loss, grads = self._grad_fn(params, {k: v[0]
                                                 for k, v in micro.items()})
            for i in range(1, a):
                loss_i, g_i = self._grad_fn(params, {k: v[i] for k, v in
                                                     micro.items()})
                loss = loss + loss_i
                grads = shd.map_tree(
                    lambda x, y: shd.Sharded([p + q for p, q in zip(
                        x.parts, y.parts)], x.sharding, x.shape), grads, g_i,
                    is_leaf=lambda x: isinstance(x, shd.Sharded))
            loss = loss / a
            grads = shd.map_tree(
                lambda x: shd.Sharded([p / a for p in x.parts], x.sharding,
                                      x.shape), grads,
                is_leaf=lambda x: isinstance(x, shd.Sharded))
        else:
            loss, grads = self._grad_fn(params, batch)
        params, opt_state, info = mesh_adamw_update(
            self.opt_cfg, grads, opt_state, params,
            inplace=self.train_cfg.donate)
        self.exchanged = {k: self.mesh.exchanged[k] - before[k]
                          for k in before}
        metrics = {"loss": loss, "lr": info["lr"],
                   "grad_norm": info["grad_norm"]}
        return params, opt_state, metrics


def jit_train_step(cfg: ArchConfig, plan: CelloPlan, opt_cfg: AdamWConfig,
                   mesh: DeviceMesh, train_cfg: TrainConfig = TrainConfig(),
                   batch_specs: Optional[Dict] = None,
                   p_shardings=None, o_shardings=None) -> MeshTrainStep:
    """The train step over ``mesh`` with its param, optimizer and batch
    shardings bound (the reference's arguments; ``batch_specs`` from
    ``shardings.input_specs``)."""
    if p_shardings is None:
        _, p_shardings = shd.params_for(cfg, mesh)
    if o_shardings is None:
        o_shardings = optimizer_shardings(cfg, mesh, train_cfg.zero1)
    if batch_specs is None:
        raise ValueError("batch_specs required (from shardings.input_specs)")
    return MeshTrainStep(cfg, plan, opt_cfg, mesh, train_cfg, batch_specs,
                         p_shardings, o_shardings)


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
    say — else ``"cuda"`` unless the caller asks for the CPU).  The audio
    and vlm families' steps get :func:`stub_inputs` of their step.  Each
    step's wall time (ended by reading its loss) goes to
    ``straggler.record``;
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
        batch.update(stub_inputs(cfg, inputs.shape[0], inputs.shape[1], step,
                                 device))
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
