"""Checkpoints: a tree -> ``.npz`` (port of ``repro/training/checkpoint.py``).

The file holds one array a leaf (``a0``, ``a1``, ... in the reference's
leaf order) and ``__paths__``, the JSON list of the reference's path
strings (``training/tree.py::flatten``), so the JAX package's
``checkpoint.restore`` reads a file written here and :func:`restore`
reads one written there.  bfloat16 leaves are written as float32 (numpy
has no bfloat16; the value is exact and the reader casts it back);
bfloat16 arrays the reference wrote (raw two-byte values) are read as
such.  :func:`restore` casts each leaf to its template's dtype, on its
template's device (a template of numpy leaves, such as
``bridge.params_to_numpy``'s tree, gives numpy leaves); the saved
shapes must be the template's.
"""
from __future__ import annotations

import json
import os

import numpy as np
import torch

from repro_torch.training.tree import flatten, unflatten


def _to_numpy(leaf) -> np.ndarray:
    if torch.is_tensor(leaf):
        t = leaf.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    return np.asarray(leaf)


def _like(a: np.ndarray, leaf):
    """Array ``a`` as a leaf of ``leaf``'s kind, dtype and device."""
    if a.dtype.kind == "V" and a.dtype.itemsize == 2:      # bfloat16 bits
        t = torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))
    if torch.is_tensor(leaf):
        return t.to(device=leaf.device, dtype=leaf.dtype)
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy().astype(np.asarray(leaf).dtype)


def save(path: str, tree) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    flat = flatten(tree)
    arrays = {f"a{i}": _to_numpy(leaf) for i, (_, leaf) in enumerate(flat)}
    np.savez(path, __paths__=json.dumps([p for p, _ in flat]), **arrays)


def restore(path: str, like):
    """Restore into the structure of ``like`` (a template tree)."""
    data = np.load(path, allow_pickle=False)
    paths_saved = json.loads(str(data["__paths__"]))
    flat = flatten(like)
    if paths_saved != [p for p, _ in flat]:
        raise ValueError(f"{path}: checkpoint/template structure mismatch")
    arrays = [data[f"a{i}"] for i in range(len(flat))]
    bad = [p for (p, leaf), a in zip(flat, arrays)
           if tuple(a.shape) != tuple(leaf.shape)]
    if bad:
        raise ValueError(f"{path}: leaves {bad} differ in shape from the "
                         f"template")
    return unflatten(like, [_like(a, leaf)
                            for (_, leaf), a in zip(flat, arrays)])
