"""Checkpointing with an async writer, on the port's tree.

The counterpart of ``repro.checkpoint.store``, with its layout:
``<dir>/step_<k>/{meta.json, arrays/<flat-key>.npy}`` plus a
``COMMITTED`` marker written last, so a crash mid-write never corrupts the
latest checkpoint (restore only considers committed steps).  A leaf's flat
key is its tree path as the JAX package writes it (``['layers']--[0]--
['attn']--['wq']`` with every character outside ``[A-Za-z0-9_.-]`` made
``_``).  ``meta.json`` records each leaf's shape, dtype and PartitionSpec.
A leaf whose dtype numpy lacks (``bfloat16``, the float8 types) is stored
as its raw bytes (a ``V2`` / ``V1`` array, the file numpy writes for the
JAX package's ``ml_dtypes`` arrays) with its own dtype in ``meta.json``:
it comes back bitwise.

Elasticity, as in the JAX package: a leaf is stored in full (gathered)
form.  A per-slot tree (``launch.shardings.shard_tree``'s ``Sharded``
leaves) is saved by gathering each leaf, with its spec recorded (a list
of axis entries; ``null`` for a global tensor), so the layout on disk is
the reference's whatever the mesh.  ``load_checkpoint(shardings=)``
restores each leaf into the given sharding's per-slot form, on whatever
mesh that is: a run checkpointed on a (2, 2) mesh restores onto a (1, 4)
one unchanged.  Without ``shardings`` each leaf is restored onto the
target leaf's device.

``AsyncCheckpointer.save`` snapshots every tensor to host memory on the
caller's thread (a copy: an in-place optimizer step may overwrite the
tensor next), then writes on a worker thread off the training critical
path; ``wait()`` joins before the next save.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import threading
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.utils._pytree as pytree

Tree = Any
_SAFE = re.compile(r"[^A-Za-z0-9_.-]")


def _key_of(path) -> str:
    return "--".join(_SAFE.sub("_", str(p)) for p in path)


def _is_sharded(x) -> bool:
    from ..launch.shardings import Sharded
    return isinstance(x, Sharded)


def _spec_of(leaf):
    if _is_sharded(leaf):
        return [list(e) if isinstance(e, tuple) else e
                for e in leaf.sharding.spec]
    return None


#: torch dtypes numpy has no type for, by name: each is stored as its raw
#: bytes and read back through the integer type of its width
_AS_BITS = {name: getattr(torch, name) for name in (
    "bfloat16", "float8_e4m3fn", "float8_e5m2", "float8_e4m3fnuz",
    "float8_e5m2fnuz") if hasattr(torch, name)}
_BITS_OF_WIDTH = {1: (torch.uint8, np.uint8), 2: (torch.int16, np.int16)}


def _host(leaf) -> Tuple[np.ndarray, str]:
    """A copy of ``leaf`` in host memory (synchronous: the copy is taken
    before any later in-place write to the tensor) and its dtype's name."""
    if _is_sharded(leaf):
        leaf = leaf.gather()
    if not isinstance(leaf, torch.Tensor):
        arr = np.array(leaf)
        return arr, str(arr.dtype)
    t = leaf.detach().to("cpu", copy=True)
    name = str(t.dtype).removeprefix("torch.")
    if name in _AS_BITS:
        # raw bytes, as numpy writes the JAX package's ml_dtypes arrays
        return (t.view(_BITS_OF_WIDTH[t.element_size()][0]).numpy()
                .view(f"V{t.element_size()}"), name)
    return t.numpy(), name


def _flatten_with_paths(tree: Tree
                        ) -> Dict[str, Tuple[np.ndarray, Any, str]]:
    """flat key -> (host array, recorded spec, dtype name)."""
    flat = {}
    for path, leaf in pytree.tree_flatten_with_path(tree)[0]:
        arr, dtype = _host(leaf)
        flat[_key_of(path)] = (arr, _spec_of(leaf), dtype)
    return flat


def save_checkpoint(directory: str, step: int, tree: Tree,
                    extra: Optional[Dict] = None) -> str:
    """Write a committed checkpoint; returns its path."""
    return _write_flat(directory, step, _flatten_with_paths(tree), extra)


def _write_flat(directory: str, step: int, flat,
                extra: Optional[Dict]) -> str:
    path = os.path.join(directory, f"step_{step:08d}")
    tmp = path + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(os.path.join(tmp, "arrays"), exist_ok=True)
    meta = {"step": step, "extra": extra or {},
            "arrays": {k: {"shape": list(v.shape), "dtype": dtype,
                           "pspec": spec}
                       for k, (v, spec, dtype) in flat.items()}}
    for k, (v, _, _) in flat.items():
        np.save(os.path.join(tmp, "arrays", k + ".npy"), v)
    with open(os.path.join(tmp, "meta.json"), "w") as f:
        json.dump(meta, f)
    with open(os.path.join(tmp, "COMMITTED"), "w") as f:
        f.write("ok")
    if os.path.exists(path):
        shutil.rmtree(path)
    os.rename(tmp, path)
    return path


def _steps(directory: str):
    for name in os.listdir(directory):
        m = re.fullmatch(r"step_(\d+)", name)
        if m:
            yield int(m.group(1)), name


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = [s for s, name in _steps(directory)
             if os.path.exists(os.path.join(directory, name, "COMMITTED"))]
    return max(steps) if steps else None


def load_checkpoint(directory: str, step: int, target: Tree,
                    shardings: Optional[Tree] = None) -> Tuple[Tree, Dict]:
    """Restore into the structure of ``target`` (global tensors, ``meta``
    ones, or ``Sharded`` leaves).  Returns ``(tree, extra)``.  Without
    ``shardings`` each leaf gets the target leaf's dtype and device; with
    ``shardings`` (a tree of the target's structure whose leaves are
    ``NamedSharding``s, or None for a leaf restored as above) a leaf is
    restored into that sharding's per-slot form, in the target leaf's
    dtype: the JAX package's elastic re-shard."""
    from ..launch.mesh import NamedSharding
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    leaves, spec = pytree.tree_flatten_with_path(target)
    if shardings is None:
        shard_leaves = [None] * len(leaves)
    else:
        shard_leaves = spec.flatten_up_to(shardings)
        for s in shard_leaves:
            if s is not None and not isinstance(s, NamedSharding):
                raise TypeError(f"load_checkpoint(shardings=...): a leaf is "
                                f"a {type(s).__name__}, not a NamedSharding "
                                "of a launch.mesh.DeviceMesh")
    out = []
    for (pth, leaf), sharding in zip(leaves, shard_leaves):
        key = _key_of(pth)
        arr = np.load(os.path.join(path, "arrays", key + ".npy"))
        if tuple(arr.shape) != tuple(leaf.shape):
            raise ValueError(f"{key}: checkpoint shape {arr.shape} != "
                             f"target {tuple(leaf.shape)}")
        saved = meta["arrays"][key]["dtype"]
        if saved in _AS_BITS:
            # raw bytes (or an ml_dtypes array where jax is loaded)
            bits = _BITS_OF_WIDTH[arr.dtype.itemsize][1]
            host = torch.from_numpy(arr.view(bits)).view(_AS_BITS[saved])
        else:
            host = torch.from_numpy(arr)
        if sharding is not None:
            from ..launch.shardings import shard_leaf
            out.append(shard_leaf(host.to(dtype=leaf.dtype), sharding))
        else:
            device = (leaf.parts[0].device if _is_sharded(leaf)
                      else leaf.device)
            out.append(host.to(device=device, dtype=leaf.dtype))
    return pytree.tree_unflatten(out, spec), meta["extra"]


class AsyncCheckpointer:
    """Snapshot-then-write checkpointing off the critical path, keeping the
    newest ``keep`` steps."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def save(self, step: int, tree: Tree, extra: Optional[Dict] = None
             ) -> None:
        self.wait()
        flat = _flatten_with_paths(tree)     # snapshot on this thread

        def _write():
            try:
                _write_flat(self.directory, step, flat, extra)
                self._gc()
            except BaseException as e:          # surfaced on next wait()
                self._error = e

        self._thread = threading.Thread(target=_write, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self) -> None:
        if not os.path.isdir(self.directory):
            return
        steps = sorted(s for s, _ in _steps(self.directory))
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"),
                          ignore_errors=True)
