"""Carry a parameter tree of the JAX package's layout into the port's.

The JAX package stacks each period slot's layers along a leading
``n_periods`` axis (``params["periods"]["slot{s}"]``) and keeps a
remainder in ``params["rest"]``; the port keeps one dict per layer in
``params["layers"]``, in layer order (layer ``p·len(period) + s``, then
the remainder).  The tree comes in as numpy arrays (``np.asarray`` of each
JAX leaf), so the port imports nothing of the JAX package.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ..configs.base import ArchConfig
from .transformer import Params, _dense_only, period_structure


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
    arrays; dtypes are kept (fp32 weights stay fp32)."""
    _dense_only(cfg)
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
