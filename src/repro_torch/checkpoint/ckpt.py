"""Tree checkpoints: the port of ``repro.checkpoint.ckpt``, on the same
files, so each package restores the other's.

Layout: ``<dir>/step_<N:08d>/arrays.npz`` + ``manifest.json`` holding the
flattened key paths, dtypes and shapes. A key path joins the dict keys and
list indices from the root with ``/`` (``layers/0/mixer/wq``), as
``jax.tree_util``'s paths print. bfloat16 leaves are stored as float32
(``.npz`` has no bfloat16), which is exact. Written to a ``.tmp``
directory and renamed into place, so a reader never sees half a
checkpoint. Restore checks every shape against the tree it fills.
"""
from __future__ import annotations

import json
import os
import shutil
from typing import Any

import numpy as np
import torch

__all__ = ["save_checkpoint", "latest_step", "restore_checkpoint",
           "key_paths"]

_SEP = "/"


def key_paths(tree: Any, prefix: tuple = ()):
    """(key path, leaf) pairs of a nested dict/list tree, in the order
    ``jax.tree_util`` flattens it (dict keys sorted)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from key_paths(tree[k], prefix + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, t in enumerate(tree):
            yield from key_paths(t, prefix + (str(i),))
    else:
        yield _SEP.join(prefix), tree


def _flatten(tree: Any) -> dict[str, np.ndarray]:
    flat = {}
    for key, leaf in key_paths(tree):
        t = torch.as_tensor(leaf).detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        flat[key] = t.cpu().numpy()
    return flat


def save_checkpoint(directory: str, step: int, tree: Any) -> str:
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    flat = _flatten(tree)
    np.savez(os.path.join(tmp, "arrays.npz"), **flat)
    manifest = {
        "step": step,
        "keys": sorted(flat),
        "dtypes": {k: str(v.dtype) for k, v in flat.items()},
        "shapes": {k: list(v.shape) for k, v in flat.items()},
    }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def latest_step(directory: str) -> int | None:
    if not os.path.isdir(directory):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(directory)
             if d.startswith("step_") and not d.endswith(".tmp")]
    return max(steps) if steps else None


def restore_checkpoint(directory: str, step: int, like: Any) -> Any:
    """A tree shaped like ``like`` (dicts, lists and tensors) with each
    leaf read from the checkpoint in ``like``'s dtype, on its device."""
    path = os.path.join(directory, f"step_{step:08d}")
    with np.load(os.path.join(path, "arrays.npz")) as data:
        flat = {k: data[k] for k in data.files}

    def fill(t, prefix):
        if isinstance(t, dict):
            return {k: fill(v, prefix + (str(k),)) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(fill(v, prefix + (str(i),))
                           for i, v in enumerate(t))
        key = _SEP.join(prefix)
        arr = flat[key]
        if tuple(arr.shape) != tuple(t.shape):
            raise ValueError(f"shape mismatch for {key}: {arr.shape} vs "
                             f"{tuple(t.shape)}")
        return torch.from_numpy(np.ascontiguousarray(arr)).to(
            dtype=t.dtype, device=t.device)

    return fill(like, ())
