"""The port's training loop: it tracks the JAX package's, reduces the loss on
the Markov source, and a checkpoint-restart equals the continuous run.

Reduced granite-3-8b and minitron-8b (3 layers, d 64), the default plan
(kernel flags on: the port's forward through its autograd Functions on
their plain versions, the JAX package's through ``chunked_flash_attention``
and its plain MLP), batches of 4 x 16 from both packages' identical
``SyntheticLMData``, weights from JAX ``init_params`` through
``params_from_numpy``."""
import numpy as np
import pytest
import torch
import torch.utils._pytree as pytree

import jax
from repro.configs import get_config as jx_get
from repro.core.policy import default_plan as jx_default_plan
from repro.data import DataConfig as JxDataConfig
from repro.data import SyntheticLMData as JxSyntheticLMData
from repro.launch.train import AdamWConfig as JxAdamWConfig
from repro.launch.train import train_loop as jx_train_loop
from repro.models import init_params as jx_init_params
from repro_torch.checkpoint import (AsyncCheckpointer, latest_step,
                                    load_checkpoint)
from repro_torch.configs import get_config
from repro_torch.core.policy import default_plan
from repro_torch.data import DataConfig, SyntheticLMData
from repro_torch.launch.train import train_loop
from repro_torch.models import params_from_numpy
from repro_torch.optim import AdamWConfig
from repro_torch.runtime import StragglerDetector

#: a step's loss, port against JAX, relative: the two differentiate the
#: same forms in bf16 with sums in their own orders (``test_torch_train``),
#: so each step moves the weights by slightly different updates; readings
#: at writing: at most 3.7e-4 over four steps of both archs
LOSS_REL = 1e-3


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _data(vocab, pkg=None, B=4, S=16, seed=0):
    if pkg == "jax":
        return iter(JxSyntheticLMData(JxDataConfig(
            vocab=vocab, seq_len=S, global_batch=B, seed=seed)))
    return iter(SyntheticLMData(DataConfig(vocab=vocab, seq_len=S,
                                           global_batch=B, seed=seed)))


@pytest.mark.parametrize("name", ["granite-3-8b", "minitron-8b"])
def test_four_steps_track_the_jax_package(name):
    jcfg, cfg = jx_get(name).reduced(), get_config(name).reduced()
    jparams = jx_init_params(jax.random.PRNGKey(3), jcfg)
    kw = dict(lr=1e-3, warmup_steps=2, total_steps=20)
    ref = jx_train_loop(jcfg, jx_default_plan(jcfg, seq=16),
                        JxAdamWConfig(**kw), data_iter=_data(jcfg.vocab,
                                                             "jax"),
                        n_steps=4, params=jparams, log_every=0)
    straggler = StragglerDetector()
    out = train_loop(cfg, default_plan(cfg, seq=16), AdamWConfig(**kw),
                     data_iter=_data(cfg.vocab), n_steps=4,
                     params=params_from_numpy(
                         jax.tree.map(np.array, jparams), cfg,
                         device="cpu"),
                     straggler=straggler, log_every=0)
    want = [h["loss"] for h in ref["history"]]
    got = [h["loss"] for h in out["history"]]
    assert np.allclose(got, want, rtol=LOSS_REL, atol=0), (got, want)
    assert straggler.median_step_s is not None
    assert int(out["opt_state"]["count"]) == int(ref["opt_state"]["count"])


def test_training_reduces_loss():
    """The JAX package's convergence check (``tests/test_integration.py``):
    60 steps on the Markov source (conditional entropy ~log 4 = 1.39 nats
    against log 128 = 4.85) take the mean loss down by more than 0.5."""
    cfg = get_config("granite-3-8b").reduced()
    opt = AdamWConfig(lr=3e-3, warmup_steps=5, total_steps=60,
                      weight_decay=0.01)
    out = train_loop(cfg, default_plan(cfg, seq=16), opt,
                     data_iter=_data(cfg.vocab), n_steps=60, log_every=0,
                     device="cpu")
    first = np.mean([h["loss"] for h in out["history"][:5]])
    last = np.mean([h["loss"] for h in out["history"][-5:]])
    assert last < first - 0.5, (first, last)


def test_checkpoint_restart_is_bitwise_the_continuous_run(tmp_path):
    """8 steps straight against 4 steps, a checkpoint, a restore and 4 more
    from the replayed data stream: the same ops on the same numbers, so
    parameters and optimizer state are bitwise equal."""
    cfg = get_config("granite-3-8b").reduced()
    plan = default_plan(cfg, seq=16)
    opt = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=20)
    kw = dict(log_every=0, seed=3, device="cpu")
    cont = train_loop(cfg, plan, opt, data_iter=_data(cfg.vocab), n_steps=8,
                      **kw)
    ck = AsyncCheckpointer(str(tmp_path))
    part = train_loop(cfg, plan, opt, data_iter=_data(cfg.vocab), n_steps=4,
                      checkpointer=ck, checkpoint_every=4, **kw)
    assert latest_step(str(tmp_path)) == 4
    target = {"params": part["params"], "opt": part["opt_state"]}
    restored, extra = load_checkpoint(str(tmp_path), 4, target)
    assert extra == {"step": 4}
    ds = _data(cfg.vocab)
    for _ in range(4):                      # the data stream replays to 4
        next(ds)
    resumed = train_loop(cfg, plan, opt, data_iter=ds, n_steps=8,
                         start_step=4, params=restored["params"],
                         opt_state=restored["opt"], **kw)
    assert [h["loss"] for h in resumed["history"]] == \
        [h["loss"] for h in cont["history"][4:]]
    for a, b in zip(pytree.tree_leaves((cont["params"], cont["opt_state"])),
                    pytree.tree_leaves((resumed["params"],
                                        resumed["opt_state"]))):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("name", ["granite-3-8b", "minitron-8b"])
def test_donated_loop_is_bitwise_the_undonated_one(name):
    """``TrainConfig(donate=True)`` writes weights and moments in place:
    three steps give bitwise the losses, weights and optimizer state of
    the ``donate=False`` loop, and step 0's loss is the one-step loss of
    ``value_and_grad`` on the same weights and batch."""
    from repro_torch.launch.train import (TrainConfig, make_loss_fn,
                                          value_and_grad)
    from repro_torch.models import init_params
    cfg = get_config(name).reduced()
    plan = default_plan(cfg, seq=16)
    opt = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=20)
    params = init_params(cfg, seed=3, device="cpu")
    copy = pytree.tree_map(torch.clone, params)
    x, y = SyntheticLMData(DataConfig(vocab=cfg.vocab, seq_len=16,
                                      global_batch=4)).batch_at(0)
    one, _ = value_and_grad(make_loss_fn(cfg, plan, TrainConfig()))(
        params, {"tokens": torch.from_numpy(x),
                 "labels": torch.from_numpy(y)})
    runs = {donate: train_loop(cfg, plan, opt, data_iter=_data(cfg.vocab),
                               n_steps=3, params=p, log_every=0,
                               train_cfg=TrainConfig(donate=donate))
            for donate, p in ((False, params), (True, copy))}
    assert runs[True]["history"][0]["loss"] == float(one)
    assert [h["loss"] for h in runs[True]["history"]] == \
        [h["loss"] for h in runs[False]["history"]]
    assert runs[True]["params"] is copy          # written in place
    for a, b in zip(pytree.tree_leaves((runs[True]["params"],
                                        runs[True]["opt_state"])),
                    pytree.tree_leaves((runs[False]["params"],
                                        runs[False]["opt_state"]))):
        assert a.dtype == b.dtype and torch.equal(a, b)
