"""Bring the reference's params and caches into the port.

The JAX package hands its pytrees over as trees of numpy arrays (nested
dicts and tuples); these functions rebuild the same structure out of
tensors on ``device``. Period params and caches stay stacked on their
leading ``n_periods`` axis, exactly as the port's own ``init_params`` /
``init_cache`` lay them out. ``bfloat16`` arrays (an ml_dtypes type that
``torch.from_numpy`` refuses) cross as a ``uint16`` view of the same bits.

``opt_state_from_numpy`` brings the reference's AdamW state over, and
``tree_to_numpy`` hands a port tree back as numpy arrays. The port
itself never imports the reference; the tests call these with arrays
the reference produced.
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


def _check_stacked(n: int, period: Any, what: str) -> None:
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
        if leaf.shape[0] != n:
            raise ValueError(
                f"{what}: leaf of shape {tuple(leaf.shape)} is not "
                f"stacked over its {n} layers"
            )


def _check_params(cfg: ArchConfig, tree: dict) -> None:
    if cfg.family == "audio":  # enc-dec: layers stacked under enc and dec
        _check_stacked(cfg.encoder_layers, tree["enc"], "params['enc']")
        _check_stacked(cfg.n_layers, tree["dec"], "params['dec']")
    else:
        _check_stacked(cfg.n_periods, tree["period"], "params")


def params_from_numpy(cfg: ArchConfig, tree: dict, device) -> dict:
    """The reference's params (numpy leaves) as the port's params, for
    the decoder families and the enc-dec one."""
    _check_params(cfg, tree)
    return _convert(tree, device)


def opt_state_from_numpy(cfg: ArchConfig, state: dict, device) -> dict:
    """The reference's AdamW state ``{"step", "m", "v"}`` (numpy leaves)
    as the port's (``optim/adamw.py``)."""
    return {"step": tensor_from_numpy(state["step"], device),
            "m": params_from_numpy(cfg, state["m"], device),
            "v": params_from_numpy(cfg, state["v"], device)}


def tree_to_numpy(tree: Any) -> Any:
    """The reverse of ``_convert``: the same structure with numpy leaves
    on the host; a bfloat16 leaf comes back as its raw bits (``uint16``,
    which ``.view(ml_dtypes.bfloat16)`` turns into the reference's
    type)."""
    if isinstance(tree, dict):
        return {k: tree_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return tuple(tree_to_numpy(v) for v in tree)
    t = tree.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def cache_from_numpy(cfg: ArchConfig, tree: dict, device) -> dict:
    """The reference's decode caches (numpy leaves) as the port's."""
    _check_stacked(cfg.n_periods, tree["period"], "cache")
    return _convert(tree, device)
