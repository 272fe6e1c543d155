"""Parameters of the JAX reference, as numpy arrays, into the port.

The reference's ``init_params`` pytree (nested dicts and lists of
arrays) and the port's parameters share one structure, so conversion is
a leaf-by-leaf copy.  The caller turns JAX arrays into numpy first
(``jax.tree.map(np.asarray, tree)``), so nothing here imports JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device


def params_from_jax(tree, device=None):
    """Copy a reference parameter tree of numpy arrays onto ``device``
    (``None`` means CUDA), keeping its dict/list structure and dtypes."""
    device = resolve_device(device)

    def convert(node):
        if isinstance(node, dict):
            return {k: convert(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [convert(v) for v in node]
        arr = np.asarray(node)
        if arr.dtype.name == "bfloat16":      # numpy has no native bf16
            return torch.from_numpy(arr.astype(np.float32)).to(
                device=device, dtype=torch.bfloat16)
        return torch.from_numpy(np.array(arr, copy=True)).to(device)

    return convert(tree)


def opt_state_from_jax(state, device=None):
    """The reference's ``OptState`` (its leaves numpy arrays:
    ``jax.tree.map(np.asarray, state)``) as the port's, on ``device``."""
    from repro_torch.optim import OptState
    return OptState(step=params_from_jax(state.step, device),
                    mu=params_from_jax(state.mu, device),
                    nu=params_from_jax(state.nu, device))
