"""Flat-npz checkpoints of param/optimizer trees (port of the reference's
``checkpoint/ckpt.py``), in the reference's on-disk format exactly.

The leaves go into ``path.npz`` as ``arr_i`` in the reference's flatten
order (dict keys sorted), beside ``path.npz.meta.json`` holding
``{"keys": [...], "meta": {...}}`` with the ``jax.tree_util.keystr``
path of every leaf. The write goes through ``.tmp.npz`` and
``os.replace``. A bfloat16 leaf is stored as numpy stores the
reference's: 2-byte void (``|V2``) holding the raw bits; restore reads
those bits back as bfloat16. A checkpoint written by either package
restores in the other.
"""

from __future__ import annotations

import json
import os
from typing import Any

import numpy as np
import torch

from repro_torch.core.unified import iter_leaves
from repro_torch.tree_util import from_leaves


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16).view("V2")
    return t.numpy()


def _from_numpy(a: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    if a.dtype.kind == "V" and a.dtype.itemsize == 2:  # raw bfloat16 bits
        t = torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a, copy=True))
    return t.to(device=like.device, dtype=like.dtype)


def save(path: str, tree: Any, meta: dict | None = None) -> None:
    flat = list(iter_leaves(tree))
    arrays = {f"arr_{i}": _to_numpy(x) for i, (_, x) in enumerate(flat)}
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp.npz"
    np.savez(tmp, **arrays)
    os.replace(tmp, path + ".npz" if not path.endswith(".npz") else path)
    real = path if path.endswith(".npz") else path + ".npz"
    with open(real + ".meta.json", "w") as f:
        json.dump({"keys": [k for k, _ in flat], "meta": meta or {}}, f)


def restore(path: str, like: Any) -> tuple[Any, dict]:
    """(the tree saved at ``path`` with ``like``'s structure, dtypes and
    devices, its meta); ``ValueError`` if the saved keys are not
    ``like``'s."""
    real = path if path.endswith(".npz") else path + ".npz"
    data = np.load(real)
    with open(real + ".meta.json") as f:
        info = json.load(f)
    flat_like = list(iter_leaves(like))
    if [k for k, _ in flat_like] != info["keys"]:
        raise ValueError("checkpoint tree structure mismatch")
    flat = [_from_numpy(data[f"arr_{i}"], x) for i, (_, x) in enumerate(flat_like)]
    return from_leaves(like, flat), info["meta"]
