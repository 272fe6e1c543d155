"""Checkpointing: parameter trees <-> ``.npz`` with path-keyed entries
(port of ``repro.checkpoint.ckpt``).

Each leaf is one entry named by ``tree.keystr`` of its path, which is how
``jax.tree_util.keystr`` names it (``['blocks']['runs'][0]['attn']['wq']``,
``.mu[...]`` for an ``OptState``), so either package reads the other's
files.  A bf16 leaf is written as its raw 2-byte values, which numpy
stores as ``|V2`` void, as the reference's writes are.  The reference's
``load`` hands such an entry back as ``|V2`` unconverted; the port's
reads it back as bf16 when the ``like`` leaf is bf16.
"""

from __future__ import annotations

import json
import os
import re
from typing import Optional

import numpy as np
import torch

from repro_torch.tree import flatten_with_path, keystr, unflatten_like

_BF16_VOID = np.dtype("V2")


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(_BF16_VOID)
        return t.numpy()
    return np.asarray(leaf)


def save(path: str, tree, metadata: Optional[dict] = None) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    arrays = {keystr(p): _to_numpy(leaf) for p, leaf in
              flatten_with_path(tree)}
    np.savez(path, **arrays)
    if metadata is not None:
        with open(path + ".meta.json", "w") as f:
            json.dump(metadata, f, indent=2, default=str)


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
    """Restore into the structure of ``like`` (a tree of tensors): each
    leaf on its ``like`` leaf's device, in the dtype the file holds.
    ``shardings`` must be None until the training mesh (ROADMAP A9.2)
    brings sharded restores."""
    if shardings is not None:
        raise NotImplementedError("sharded restores are not ported yet "
                                  "(ROADMAP A9.2)")
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
            leaves.append(_to_tensor(arr, leaf))
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
