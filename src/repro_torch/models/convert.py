"""Carry a parameter tree of the JAX package's layout into the port's.

The JAX package stacks each period slot's layers along a leading
``n_periods`` axis (``params["periods"]["slot{s}"]``) and keeps a
remainder in ``params["rest"]``; the port keeps one dict per layer in
``params["layers"]``, in layer order (layer ``p·len(period) + s``, then
the remainder).  The slots of a period may be of mixed kinds
(recurrentgemma's ``[rglru, rglru, attn]``, whose remainder is two
``rglru`` layers; llama-vision's ``[attn]*4 + [xattn]``); each layer keeps
its own sub-dict (``attn``, ``rglru`` or ``rwkv``, and ``mlp``, or for an
MoE arch ``moe``: ``w_router`` (D, E) and the ``(E, D, F)`` / ``(E, F,
D)`` expert weights).  The tree comes in as numpy arrays
(``np.asarray`` of each JAX leaf), so the port imports nothing of the JAX
package.

``pspecs_from_reference`` carries a spec tree of the JAX package's
layout (``param_pspecs``, ``cache_pspecs``, or either resolved: its
leaves tuples of axis entries) into the port's, so that the two
packages' trees compare leaf for leaf.
"""
from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch

from ..configs.base import ArchConfig
from .transformer import Params, _check_family, period_structure


def _to_torch(tree: Any, device, index=None) -> Any:
    if isinstance(tree, dict):
        return {k: _to_torch(v, device, index) for k, v in tree.items()}
    arr = np.asarray(tree)
    if index is not None:
        arr = arr[index]
    return torch.from_numpy(np.ascontiguousarray(arr)).to(device)


def params_from_numpy(tree: Dict[str, Any], cfg: ArchConfig, *,
                      device="cuda") -> Params:
    """The port's parameter dict from a JAX ``init_params`` tree of numpy
    arrays; dtypes are kept (fp32 weights, and the recurrences' fp32
    ``a_param``, ``u`` and ``w_bias``, stay fp32)."""
    _check_family(cfg)
    period, n_periods, rest = period_structure(cfg)
    layers = []
    for p_ in range(n_periods):
        for s in range(len(period)):
            layers.append(_to_torch(tree["periods"][f"slot{s}"], device,
                                    index=p_))
    layers += [_to_torch(layer, device) for layer in tree["rest"]]
    if len(layers) != cfg.n_layers:
        raise ValueError(f"{cfg.name}: the tree holds {len(layers)} layers, "
                         f"the config {cfg.n_layers}")
    return {"embed": _to_torch(tree["embed"], device),
            "final_norm": _to_torch(tree["final_norm"], device),
            "lm_head": _to_torch(tree["lm_head"], device),
            "layers": layers}


def _is_spec(x) -> bool:
    return isinstance(x, tuple) and all(
        e is None or isinstance(e, (str, tuple)) for e in x)


def _map_specs(fn, tree):
    if _is_spec(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map_specs(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map_specs(fn, v) for v in tree]
    raise TypeError(f"not a spec tree leaf: {tree!r}")


def pspecs_from_reference(tree: Dict[str, Any], cfg: ArchConfig
                          ) -> Dict[str, Any]:
    """The JAX package's spec tree in the port's layout: the period slots'
    leaves, stacked (``{"slot{s}": ...}``, each spec led by the period
    axis's ``None``, which is dropped) or split (a list of one tree a
    period, as ``repro/launch/shardings.py``'s ``_split_tree`` makes),
    unstacked into one entry a layer, in layer order, then ``rest``; the
    other keys as they are.  A leaf is a tuple of axis entries (a
    ``PartitionSpec`` taken as ``tuple(spec)``)."""
    period, n_periods, _ = period_structure(cfg)
    periods = tree["periods"]
    layers: List[Any] = []
    for p_ in range(n_periods):
        for s in range(len(period)):
            if isinstance(periods, list):
                layers.append(periods[p_][f"slot{s}"])
            else:
                layers.append(_map_specs(lambda sp: tuple(sp)[1:],
                                         periods[f"slot{s}"]))
    layers += list(tree["rest"])
    if len(layers) != cfg.n_layers:
        raise ValueError(f"{cfg.name}: the tree holds {len(layers)} layers, "
                         f"the config {cfg.n_layers}")
    out = {k: v for k, v in tree.items() if k not in ("periods", "rest")}
    out["layers"] = layers
    return out
