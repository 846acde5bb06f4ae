"""Checkpointing with an async writer, on the port's tree.

The counterpart of ``repro.checkpoint.store``, with its layout:
``<dir>/step_<k>/{meta.json, arrays/<flat-key>.npy}`` plus a
``COMMITTED`` marker written last, so a crash mid-write never corrupts the
latest checkpoint (restore only considers committed steps).  A leaf's flat
key is its tree path as the JAX package writes it (``['layers']--[0]--
['attn']--['wq']`` with every character outside ``[A-Za-z0-9_.-]`` made
``_``).  ``meta.json`` records each leaf's shape, dtype and PartitionSpec;
the port has no device mesh yet, so every spec is ``null`` and
``load_checkpoint`` restores onto the target leaf's device.

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


def _host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True).numpy()
    return np.array(leaf)


def _flatten_with_paths(tree: Tree) -> Dict[str, np.ndarray]:
    return {_key_of(path): _host(leaf)
            for path, leaf in pytree.tree_flatten_with_path(tree)[0]}


def save_checkpoint(directory: str, step: int, tree: Tree,
                    extra: Optional[Dict] = None) -> str:
    """Write a committed checkpoint; returns its path."""
    path = os.path.join(directory, f"step_{step:08d}")
    tmp = path + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(os.path.join(tmp, "arrays"), exist_ok=True)
    flat = _flatten_with_paths(tree)
    meta = {"step": step, "extra": extra or {},
            "arrays": {k: {"shape": list(v.shape), "dtype": str(v.dtype),
                           "pspec": None}
                       for k, v in flat.items()}}
    for k, v in flat.items():
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
    """Restore into the structure of ``target``: each leaf gets the target
    leaf's dtype and device.  Returns ``(tree, extra)``.  ``shardings``
    (the JAX package's elastic re-shard) waits for the LLM mesh."""
    if shardings is not None:
        raise NotImplementedError("load_checkpoint(shardings=...): the port "
                                  "has no LLM device mesh yet")
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    leaves, spec = pytree.tree_flatten_with_path(target)
    out = []
    for pth, leaf in leaves:
        key = _key_of(pth)
        arr = np.load(os.path.join(path, "arrays", key + ".npy"))
        if tuple(arr.shape) != tuple(leaf.shape):
            raise ValueError(f"{key}: checkpoint shape {arr.shape} != "
                             f"target {tuple(leaf.shape)}")
        out.append(torch.from_numpy(arr).to(device=leaf.device,
                                            dtype=leaf.dtype))
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
        host_tree = pytree.tree_map(_host, tree)   # snapshot on this thread

        def _write():
            try:
                save_checkpoint(self.directory, step, host_tree, extra)
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
