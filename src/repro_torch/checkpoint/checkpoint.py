"""Fault-tolerant checkpointing: atomic, step-tagged, resumable.

The counterpart of ``repro.checkpoint.checkpoint``, with its layout:

    <dir>/step_00000420/           (atomic rename from .tmp)
        manifest.json              (leaf keys, shapes, dtypes)
        arr_00000.npy ...          (one file per leaf, on the host)
        extra.json                 (VPE state, data cursor, step)
    <dir>/LATEST                   (text file: newest complete step dir)

Leaves are keyed as the reference keys them (``['opt']['m']['embed']``,
dict keys sorted), and a bfloat16 leaf is stored as its ``uint16`` bit
view with the logical dtype in the manifest's ``jax_dtype`` field — numpy
has no bfloat16 without ``ml_dtypes``, which a PyTorch-only installation
lacks.  So each package reads the other's checkpoints.

Atomicity: everything is written into ``.tmp`` and renamed only after
fsync — a job killed mid-save leaves the previous checkpoint intact.
:func:`restore` writes into the tensors of the tree it is given, in place
and on their device, after checking every key, shape and dtype against
the manifest: a restore on a full card needs no second copy of the
training state.  A checkpoint is the whole tree whatever mesh wrote it: a
rank of a model-parallel mesh restores its slice of each leaf (``cut``).
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.distributed import sharding

def _flatten(tree: Any, prefix: str = "") -> List[Tuple[str, torch.Tensor]]:
    """(key, leaf) pairs in the reference's order: dict keys sorted, each
    key written as ``['name']``."""
    if isinstance(tree, dict):
        return [kv for k in sorted(tree) for kv in _flatten(tree[k], f"{prefix}[{k!r}]")]
    return [(prefix, tree)]


def _to_numpy(leaf: torch.Tensor) -> Tuple[np.ndarray, str]:
    """(array to store, logical dtype name)."""
    t = leaf.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    arr = t.numpy()
    return arr, str(arr.dtype)


def save(
    directory: str,
    step: int,
    tree: Any,
    *,
    extra: Optional[Dict] = None,
    keep: int = 3,
) -> str:
    os.makedirs(directory, exist_ok=True)
    name = f"step_{step:08d}"
    tmp = os.path.join(directory, name + ".tmp")
    final = os.path.join(directory, name)
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)

    manifest = {"step": step, "leaves": []}
    for i, (key, leaf) in enumerate(_flatten(tree)):
        arr, logical_dtype = _to_numpy(leaf)
        fname = f"arr_{i:05d}.npy"
        np.save(os.path.join(tmp, fname), arr)
        manifest["leaves"].append(
            {"key": key, "file": fname, "shape": list(arr.shape),
             "dtype": str(arr.dtype), "jax_dtype": logical_dtype})
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    with open(os.path.join(tmp, "extra.json"), "w") as f:
        json.dump(extra or {}, f)
    # fsync the directory entries then atomically publish
    fd = os.open(tmp, os.O_RDONLY)
    os.fsync(fd)
    os.close(fd)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    with open(os.path.join(directory, "LATEST.tmp"), "w") as f:
        f.write(name)
    os.replace(os.path.join(directory, "LATEST.tmp"), os.path.join(directory, "LATEST"))
    _gc(directory, keep)
    return final


def _gc(directory: str, keep: int) -> None:
    steps = sorted(d for d in os.listdir(directory)
                   if d.startswith("step_") and not d.endswith(".tmp"))
    for d in steps[:-keep]:
        shutil.rmtree(os.path.join(directory, d), ignore_errors=True)


def latest_step(directory: str) -> Optional[int]:
    latest = os.path.join(directory, "LATEST")
    if not os.path.exists(latest):
        return None
    with open(latest) as f:
        name = f.read().strip()
    if not os.path.isdir(os.path.join(directory, name)):
        return None
    return int(name.split("_")[1])


def _load(path: str, item: Dict) -> torch.Tensor:
    arr = np.load(path)
    if item["jax_dtype"] == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def restore(
    directory: str,
    like: Any,
    *,
    step: Optional[int] = None,
    cut: Optional[Callable[[str, Tuple[int, ...]],
                           List[sharding.Cut]]] = None,
) -> Tuple[Any, Dict, int]:
    """Restore into the tensors of ``like`` (a tree of tensors), in place.

    Every leaf of ``like`` must be in the checkpoint with its shape and
    dtype; all of them are checked before any is written.  ``cut(key,
    stored shape)``, where given, lists the cuts (``sharding.rank_cuts``:
    (dim, start, size), or ``Runs`` of several ranges), applied in turn, of the slice of a stored leaf that ``like`` holds, none for
    all of it (a rank of a mesh restores its shard of the whole tree).  Returns
    (like, extra, step).
    """
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {directory}")
    d = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    with open(os.path.join(d, "extra.json")) as f:
        extra = json.load(f)

    by_key = {item["key"]: item for item in manifest["leaves"]}
    flat = _flatten(like)
    cuts = {}
    for key, leaf in flat:
        item = by_key.get(key)
        if item is None:
            raise KeyError(f"checkpoint missing leaf {key}")
        shape = tuple(item["shape"])
        cuts[key] = list(cut(key, shape)) if cut is not None else []
        shape = sharding.cut_shape(shape, cuts[key])
        if shape != tuple(leaf.shape):
            raise ValueError(f"shape mismatch for {key}: ckpt {shape} "
                             f"vs model {tuple(leaf.shape)}")
        if item["jax_dtype"] != str(leaf.dtype).removeprefix("torch."):
            raise TypeError(f"dtype mismatch for {key}: ckpt {item['jax_dtype']} "
                            f"vs model {leaf.dtype}")
    with torch.no_grad():
        for key, leaf in flat:
            t = _load(os.path.join(d, by_key[key]["file"]), by_key[key])
            for c in cuts[key]:
                t = sharding.narrow(t, c)
            leaf.copy_(t)
    return like, extra, step
