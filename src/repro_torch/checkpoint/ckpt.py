"""Checkpointing: parameter trees <-> ``.npz`` with path-keyed entries
(port of ``repro.checkpoint.ckpt``).

Each leaf is one entry named by ``tree.keystr`` of its path, which is how
``jax.tree_util.keystr`` names it (``['blocks']['runs'][0]['attn']['wq']``,
``.mu[...]`` for an ``OptState``), so either package reads the other's
files.  A bf16 leaf is written as its raw 2-byte values, which numpy
stores as ``|V2`` void, as the reference's writes are.  The reference's
``load`` hands such an entry back as ``|V2`` unconverted; the port's
reads it back as bf16 when the ``like`` leaf is bf16.

On a mesh (``models.partitioning``) ``save`` takes a tree of this rank's
blocks with their specs, gathers each leaf whole and writes once, on
rank 0, so that the file is the one-rank file; ``load`` takes specs to
hand back this rank's blocks (``launch.shardings.local_shard``).
"""

from __future__ import annotations

import json
import os
import re
from typing import Optional

import numpy as np
import torch
import torch.distributed

from repro_torch.tree import flatten_with_path, keystr, unflatten_like

_BF16_VOID = np.dtype("V2")


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(_BF16_VOID)
        return t.numpy()
    return np.asarray(leaf)


def _mesh():
    from repro_torch.models import partitioning
    mesh = partitioning.active_mesh()
    if mesh is None:
        raise RuntimeError("a sharded save or load needs the mesh of its "
                           "specs active (partitioning.mesh_context)")
    return mesh


def save(path: str, tree, metadata: Optional[dict] = None,
         shardings=None) -> None:
    """Write ``tree`` to ``path`` (``.npz``).  With ``shardings`` (the
    specs of ``tree``'s blocks on the active mesh) every rank of the mesh
    must call it: each leaf is gathered whole, rank 0 writes, and every
    rank returns once the file is there."""
    items = flatten_with_path(tree)
    mesh = None
    if shardings is not None:
        from repro_torch.launch.shardings import gather_leaf
        from repro_torch.models.partitioning import spec_leaves
        mesh = _mesh()
        items = [(p, _to_numpy(gather_leaf(leaf, spec, mesh)))
                 for (p, leaf), spec in zip(items,
                                            spec_leaves(shardings, tree))]
    if mesh is None or mesh.rank == 0:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        np.savez(path, **{keystr(p): _to_numpy(leaf) for p, leaf in items})
        if metadata is not None:
            with open(path + ".meta.json", "w") as f:
                json.dump(metadata, f, indent=2, default=str)
    if mesh is not None and mesh.group("world") is not None:
        torch.distributed.barrier(mesh.group("world").group)


def _to_tensor(arr: np.ndarray, like) -> torch.Tensor:
    """An entry as a tensor on ``like``'s device (the CPU when ``like`` is
    not a tensor); ``|V2`` entries as bf16 when ``like`` is bf16."""
    device = like.device if isinstance(like, torch.Tensor) else "cpu"
    if arr.dtype == _BF16_VOID:
        if getattr(like, "dtype", None) != torch.bfloat16:
            raise TypeError("a |V2 (bf16) entry needs a bf16 like leaf")
        return torch.from_numpy(arr.view(np.int16).copy()).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(np.array(arr, copy=True)).to(device)


def load(path: str, like, shardings=None):
    """Restore into the structure of ``like`` (a tree of tensors of the
    whole leaves' shapes): each leaf on its ``like`` leaf's device, in
    the dtype the file holds.  With ``shardings`` (specs on the active
    mesh) each leaf comes back as this rank's block of it, one leaf
    whole at a time."""
    mesh = None
    if shardings is not None:
        from repro_torch.launch.shardings import local_shard
        from repro_torch.models.partitioning import spec_leaves
        mesh = _mesh()
        specs = spec_leaves(shardings, like)
    if not path.endswith(".npz"):
        path = path + ".npz"
    leaves = []
    with np.load(path) as data:
        for p, leaf in flatten_with_path(like):
            key = keystr(p)
            if key not in data:
                raise KeyError(f"checkpoint missing {key}")
            arr = data[key]
            if tuple(arr.shape) != tuple(leaf.shape):
                raise ValueError(f"{key}: shape {arr.shape} != "
                                 f"{tuple(leaf.shape)}")
            t = _to_tensor(arr, leaf)
            leaves.append(t if mesh is None
                          else local_shard(t, specs[len(leaves)], mesh))
    return unflatten_like(like, leaves)


def load_metadata(path: str) -> Optional[dict]:
    meta = path if path.endswith(".meta.json") else path + ".meta.json"
    if not os.path.exists(meta):
        return None
    with open(meta) as f:
        return json.load(f)


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = []
    for name in os.listdir(ckpt_dir):
        m = re.match(r"step_(\d+)\.npz$", name)
        if m:
            steps.append(int(m.group(1)))
    return max(steps) if steps else None


def step_path(ckpt_dir: str, step: int) -> str:
    return os.path.join(ckpt_dir, f"step_{step:08d}")
