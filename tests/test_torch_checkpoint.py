"""The port's checkpoint store on leaves numpy has no type for, and its
async writer under in-place updates.

A bf16 (or float8) leaf is written as its raw bytes with its dtype in
``meta.json`` and restored bitwise, onto the target leaf's device and in
its dtype; the files are the ones the JAX package writes for the same
tree, and each package's bf16 leaves load in the port.  An
``AsyncCheckpointer`` snapshot is taken before ``save`` returns, so a
donated AdamW step right after it (``optim.adamw_update(inplace=True)``)
does not reach the checkpoint."""
import json
import os

import numpy as np
import pytest
import torch
import torch.utils._pytree as pytree

import jax.numpy as jnp
from repro.checkpoint import load_checkpoint as jx_load
from repro.checkpoint import save_checkpoint as jx_save
from repro_torch import checkpoint, optim

FLOAT8 = [n for n in ("float8_e4m3fn", "float8_e5m2") if hasattr(torch, n)]


def _bf16_tree(seed=0):
    rng = np.random.default_rng(seed)
    w = torch.from_numpy(rng.standard_normal((6, 5), dtype=np.float32))
    special = torch.tensor([0.0, -0.0, float("inf"), -float("inf"),
                            float("nan"), 1e-40, 3.0e38, 1.0 + 2 ** -7])
    return {"w": w.bfloat16(), "special": special.bfloat16(),
            "f32": w.clone(), "count": torch.tensor(7, dtype=torch.int32),
            "nested": [w[:2].bfloat16(), w[2:, :3]]}


def _bits(t):
    """A float tensor's bits (NaN payloads compared too)."""
    ints = {2: torch.int16, 4: torch.int32}
    return t.view(ints[t.element_size()]) if t.is_floating_point() else t


def test_bf16_leaves_round_trip_bitwise(tmp_path):
    tree = _bf16_tree()
    path = checkpoint.save_checkpoint(str(tmp_path), 5, tree,
                                      extra={"step": 5})
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    dtypes = [a["dtype"] for a in meta["arrays"].values()]
    assert dtypes == [str(t.dtype).removeprefix("torch.")
                      for t in pytree.tree_leaves(tree)]
    target = pytree.tree_map(torch.zeros_like, tree)
    loaded, extra = checkpoint.load_checkpoint(str(tmp_path), 5, target)
    assert extra == {"step": 5}
    for got, want in zip(pytree.tree_leaves(loaded),
                         pytree.tree_leaves(tree)):
        assert got.dtype == want.dtype and got.device == want.device
        assert torch.equal(_bits(got), _bits(want))     # NaN bits too


@pytest.mark.parametrize("name", FLOAT8)
def test_float8_leaves_round_trip_bitwise(tmp_path, name):
    x = torch.linspace(-4, 4, 33).to(getattr(torch, name))
    checkpoint.save_checkpoint(str(tmp_path), 1, {"x": x})
    got, _ = checkpoint.load_checkpoint(str(tmp_path), 1,
                                        {"x": torch.zeros_like(x)})
    assert got["x"].dtype == x.dtype
    assert torch.equal(got["x"].view(torch.uint8), x.view(torch.uint8))


def test_restore_takes_the_targets_dtype_and_device(tmp_path):
    """A leaf comes back in the target leaf's dtype on its device: bf16
    saved into an fp32 target (exact), fp32 saved into a bf16 target (one
    rounding, as ``Tensor.to`` rounds)."""
    tree = _bf16_tree(1)
    checkpoint.save_checkpoint(str(tmp_path), 2, tree)
    flip = {torch.bfloat16: torch.float32, torch.float32: torch.bfloat16,
            torch.int32: torch.int32}
    target = pytree.tree_map(
        lambda t: torch.zeros(t.shape, dtype=flip[t.dtype]), tree)
    loaded, _ = checkpoint.load_checkpoint(str(tmp_path), 2, target)
    for got, saved, want in zip(pytree.tree_leaves(loaded),
                                pytree.tree_leaves(tree),
                                pytree.tree_leaves(target)):
        assert got.dtype == want.dtype and got.device == want.device
        assert torch.equal(_bits(got), _bits(saved.to(want.dtype)))


def test_bf16_files_are_the_jax_packages(tmp_path):
    """The same bf16 tree written by both packages: the same meta dtypes
    and the same bytes in each array; the port loads either bitwise."""
    tree = {"w": _bf16_tree(2)["w"], "b": _bf16_tree(3)["special"]}
    mine = checkpoint.save_checkpoint(str(tmp_path / "pt"), 1, tree)
    ref = jx_save(str(tmp_path / "jx"), 1,          # the same bits in JAX
                  {k: jnp.asarray(v.view(torch.int16).numpy().view(
                      jnp.bfloat16)) for k, v in tree.items()})
    for d in (mine, ref):
        with open(os.path.join(d, "meta.json")) as f:
            assert {k: v["dtype"] for k, v in json.load(f)[
                "arrays"].items()} == {"__w__": "bfloat16",
                                       "__b__": "bfloat16"}
    for name in ("__w__.npy", "__b__.npy"):
        a, b = (np.load(os.path.join(d, "arrays", name)) for d in (mine, ref))
        assert a.shape == b.shape and a.dtype.itemsize == b.dtype.itemsize
        assert a.tobytes() == b.tobytes()
    target = pytree.tree_map(torch.zeros_like, tree)
    for d in ("pt", "jx"):
        got, _ = checkpoint.load_checkpoint(str(tmp_path / d), 1, target)
        for k in tree:
            assert torch.equal(_bits(got[k]), _bits(tree[k]))
    # the JAX package reads the port's non-bf16 leaves back unchanged
    checkpoint.save_checkpoint(str(tmp_path / "f32"), 1,
                               {"w": tree["w"].float()})
    back, _ = jx_load(str(tmp_path / "f32"), 1,
                      {"w": jnp.zeros((6, 5), jnp.float32)})
    assert np.array_equal(np.asarray(back["w"]), tree["w"].float().numpy())


def test_async_snapshot_is_not_reached_by_a_donated_step(tmp_path):
    """bf16 parameters and fp32 moments: ``save`` then, at once, a donated
    AdamW step that writes every parameter and moment in place.  The
    checkpoint holds the state before the step, bitwise; the live state
    moved."""
    rng = np.random.default_rng(4)
    params = {"a": torch.from_numpy(rng.standard_normal(
                  (8, 4), dtype=np.float32)).bfloat16(),
              "b": torch.from_numpy(rng.standard_normal(
                  16, dtype=np.float32))}
    state = {"params": params, "opt": optim.adamw_init(params)}
    before = pytree.tree_map(torch.clone, state)
    grads = pytree.tree_map(lambda p: torch.ones_like(p, dtype=torch.float32),
                            params)
    ck = checkpoint.AsyncCheckpointer(str(tmp_path), keep=1)
    ck.save(1, state, extra={"step": 1})
    new_p, new_opt, _ = optim.adamw_update(optim.AdamWConfig(lr=0.1),
                                           grads, state["opt"], params,
                                           inplace=True)
    assert new_p is params and new_opt is state["opt"]
    ck.wait()
    assert not torch.equal(params["b"], before["params"]["b"])
    assert int(state["opt"]["count"]) == 1
    loaded, extra = checkpoint.load_checkpoint(str(tmp_path), 1, before)
    assert extra == {"step": 1}
    for got, want in zip(pytree.tree_leaves(loaded),
                         pytree.tree_leaves(before)):
        assert got.dtype == want.dtype and torch.equal(_bits(got),
                                                       _bits(want))
