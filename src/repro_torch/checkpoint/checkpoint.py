"""Checkpointing: atomic, resumable, asynchronous — the reference's
on-disk layout, written from tensors.

Layout on disk::

    <dir>/step_<N>/
        manifest.json        # leaf shapes and dtypes, shard map, metadata
        shard_<i>.npz        # leaf groups (~512 MB per shard file)
    <dir>/LATEST             # atomic pointer (written last)

  * **atomic**: writes go to ``step_<N>.tmp`` and are renamed only after
    ``os.sync`` — a killed writer never corrupts the latest checkpoint,
  * **resumable**: ``latest_step`` + ``restore`` bring back params,
    optimizer state and the data-pipeline step (in the metadata),
  * **async**: ``save(..., async_=True)`` copies every leaf to the host
    first, then writes on a thread and returns; ``wait_pending`` drains
    the writers.  The host copy is taken before ``save`` returns, so the
    train step may update the parameters in place meanwhile.

Leaves are numbered in the order the JAX package flattens the same tree
(:func:`repro_torch.tree.leaves`), so a checkpoint of
``(params, OptState)`` has the reference's ``leaf_<i>`` names and either
package can read the other's.  The tree's structure comes from the
caller's ``target`` at restore.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.tree import leaves as tree_leaves, unflatten

__all__ = ["save", "restore", "latest_step", "all_steps", "wait_pending",
           "prune"]

_SHARD_BYTES = 512 * 1024 * 1024
_pending: List[threading.Thread] = []


def _describe(tree) -> str:
    """A readable summary of the structure, for the manifest."""
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k}: {_describe(tree[k])}"
                               for k in sorted(tree)) + "}"
    if isinstance(tree, (tuple, list)):
        name = type(tree).__name__
        return name + "(" + ", ".join(_describe(t) for t in tree) + ")"
    return "*"


def _to_host(leaf) -> np.ndarray:
    """A host copy of a leaf that the caller may go on changing."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True).numpy()
    return np.array(leaf)


def _plan_shards(flat: Dict[str, np.ndarray]) -> List[List[str]]:
    shards, cur, cur_bytes = [], [], 0
    for name, arr in flat.items():
        if cur and cur_bytes + arr.nbytes > _SHARD_BYTES:
            shards.append(cur)
            cur, cur_bytes = [], 0
        cur.append(name)
        cur_bytes += arr.nbytes
    if cur:
        shards.append(cur)
    return shards


def save(directory, step: int, tree, *, metadata: Optional[dict] = None,
         async_: bool = False) -> Path:
    """Write the checkpoint of ``step``; returns its final path."""
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    final = directory / f"step_{step:08d}"
    tmp = directory / f"step_{step:08d}.tmp"
    # gathered to the host before any thread handoff
    flat = {f"leaf_{i}": _to_host(x) for i, x in enumerate(tree_leaves(tree))}
    treedef = _describe(tree)

    def _write():
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        shards = _plan_shards(flat)
        manifest = {
            "step": step,
            "treedef": treedef,
            "leaves": {k: {"shape": list(v.shape), "dtype": str(v.dtype),
                           "shard": si}
                       for si, names in enumerate(shards)
                       for k, v in ((n, flat[n]) for n in names)},
            "n_shards": len(shards),
            "metadata": metadata or {},
        }
        for si, names in enumerate(shards):
            np.savez(tmp / f"shard_{si}.npz", **{n: flat[n] for n in names})
        (tmp / "manifest.json").write_text(json.dumps(manifest))
        os.sync()
        if final.exists():
            shutil.rmtree(final)
        tmp.rename(final)
        latest = directory / "LATEST"
        tmp_latest = directory / "LATEST.tmp"
        tmp_latest.write_text(str(step))
        tmp_latest.rename(latest)

    if async_:
        t = threading.Thread(target=_write, daemon=True)
        t.start()
        _pending.append(t)
    else:
        _write()
    return final


def wait_pending() -> None:
    """Join every asynchronous writer started so far."""
    while _pending:
        _pending.pop(0).join()


def latest_step(directory) -> Optional[int]:
    p = Path(directory) / "LATEST"
    if not p.exists():
        return None
    try:
        return int(p.read_text().strip())
    except ValueError:
        return None


def all_steps(directory) -> List[int]:
    d = Path(directory)
    if not d.exists():
        return []
    out = []
    for c in d.iterdir():
        if c.is_dir() and c.name.startswith("step_") and \
                not c.name.endswith(".tmp"):
            out.append(int(c.name.split("_")[1]))
    return sorted(out)


def restore(directory, step: Optional[int] = None, *, target: Any = None,
            device=None) -> Tuple[Any, dict]:
    """Load a checkpoint (``step``, default the latest): (tree,
    metadata).  ``target`` (a matching tree; its contents are not read)
    gives the structure, else the leaves come back as a list.  Leaves
    keep their saved dtype and land on ``device``, or, where that is
    None, on the device of ``target``'s leaf in the same place (the
    host for a list)."""
    directory = Path(directory)
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {directory}")
    path = directory / f"step_{step:08d}"
    manifest = json.loads((path / "manifest.json").read_text())
    arrays: Dict[str, np.ndarray] = {}
    for si in range(manifest["n_shards"]):
        with np.load(path / f"shard_{si}.npz") as z:
            for k in z.files:
                arrays[k] = z[k]
    leaves = [arrays[f"leaf_{i}"] for i in range(len(arrays))]
    places = (tree_leaves(target) if target is not None
              else [None] * len(leaves))
    if len(places) != len(leaves):
        raise ValueError(f"checkpoint {path} holds {len(leaves)} leaves, "
                         f"the target {len(places)}")
    tensors = []
    for arr, like in zip(leaves, places):
        where = device if device is not None else (
            like.device if isinstance(like, torch.Tensor) else "cpu")
        tensors.append(torch.from_numpy(arr).to(where))
    if target is None:
        return tensors, manifest["metadata"]
    return unflatten(target, tensors), manifest["metadata"]


def prune(directory, keep: int = 3) -> None:
    """Delete all but the newest ``keep`` checkpoints."""
    steps = all_steps(directory)
    for s in steps[:-keep]:
        shutil.rmtree(Path(directory) / f"step_{s:08d}", ignore_errors=True)
