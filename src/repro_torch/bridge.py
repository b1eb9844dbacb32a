"""Bring the reference's params and caches into the port.

The JAX package hands its pytrees over as trees of numpy arrays (nested
dicts and tuples); these functions rebuild the same structure out of
tensors on ``device``. Period params and caches stay stacked on their
leading ``n_periods`` axis, exactly as the port's own ``init_params`` /
``init_cache`` lay them out. ``bfloat16`` arrays (an ml_dtypes type that
``torch.from_numpy`` refuses) cross as a ``uint16`` view of the same bits.

The port itself never imports the reference; the tests call these with
arrays the reference produced.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig


def tensor_from_numpy(arr: Any, device) -> torch.Tensor:
    # a writable copy the tensor owns (the reference's arrays are read-only)
    arr = np.array(arr, copy=True, order="C")
    if arr.dtype.name == "bfloat16":
        t = torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    return t.to(device)


def _convert(tree: Any, device) -> Any:
    if isinstance(tree, dict):
        return {k: _convert(v, device) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return tuple(_convert(v, device) for v in tree)
    return tensor_from_numpy(tree, device)


def _check_stacked(cfg: ArchConfig, period: Any, what: str) -> None:
    def leaves(t):
        if isinstance(t, dict):
            for v in t.values():
                yield from leaves(v)
        elif isinstance(t, (tuple, list)):
            for v in t:
                yield from leaves(v)
        else:
            yield t

    for leaf in leaves(period):
        if leaf.shape[0] != cfg.n_periods:
            raise ValueError(
                f"{what}: period leaf of shape {tuple(leaf.shape)} is not "
                f"stacked over n_periods={cfg.n_periods}"
            )


def params_from_numpy(cfg: ArchConfig, tree: dict, device) -> dict:
    """The reference's params (numpy leaves) as the port's params."""
    _check_stacked(cfg, tree["period"], "params")
    return _convert(tree, device)


def cache_from_numpy(cfg: ArchConfig, tree: dict, device) -> dict:
    """The reference's decode caches (numpy leaves) as the port's."""
    _check_stacked(cfg, tree["period"], "cache")
    return _convert(tree, device)
