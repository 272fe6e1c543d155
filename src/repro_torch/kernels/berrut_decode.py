"""CUDA fused coded-round decode tail (``csrc/fused_group_decode.cu``).

Replaces the Pallas TPU kernel
``repro.kernels.berrut_decode.fused_group_decode``: per-group decode
matrices are rebuilt from the masks inside the kernel and contracted with
the (G, N+1, V) coded-logit block in one pass, with the locator's strided
vote columns as an optional second output of the same pass.
``kernels.ops.fused_group_decode`` calls this for CUDA tensors and
``ref.fused_group_decode_ref`` for CPU tensors.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core.error_locator import vote_layout
from repro_torch.kernels.build import Kernel, dtype_code, require_cuda

KERNEL = Kernel("fused_group_decode.cu", "fused_group_decode_launch", [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,      # x, masks, stride
    ctypes.c_void_p, ctypes.c_void_p,                    # alphas, betas
    ctypes.c_void_p, ctypes.c_void_p,                    # out, votes
    ctypes.c_int, ctypes.c_int, ctypes.c_int,            # G, K, N+1
    ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong,  # V, C, stride
    ctypes.c_int,                                        # dtype
])
MAX_NODES = 64          # K and N+1 bound the kernel's shared-memory tiles
MAX_GROUPS = 65535      # the grid's second dimension


def fused_group_decode(grouped: torch.Tensor, masks: torch.Tensor,
                       alphas: torch.Tensor, betas: torch.Tensor, *,
                       c_vote: int = 0):
    """(G, N+1, V) block + masks -> (G, K, V) decoded logits on the card.

    masks: (N+1,) shared availability or (G, N+1) per-group masks.  With
    ``c_vote > 0`` also returns the (G, N+1, C) float32 vote columns
    ``grouped[..., :C*stride:stride]`` from the same pass.
    """
    device = require_cuda("fused_group_decode", grouped, masks, alphas, betas)
    code = dtype_code("fused_group_decode", grouped.dtype,
                      (torch.float32, torch.bfloat16))
    g, n1, v = grouped.shape
    k = alphas.shape[0]
    if masks.shape not in ((n1,), (g, n1)) or betas.shape != (n1,):
        raise ValueError(f"masks {tuple(masks.shape)} / betas "
                         f"{tuple(betas.shape)} do not match {n1} nodes")
    if k > MAX_NODES or n1 > MAX_NODES or g > MAX_GROUPS:
        raise ValueError(f"fused_group_decode takes K, N+1 <= {MAX_NODES} "
                         f"and G <= {MAX_GROUPS}, got {k}, {n1}, {g}")
    x = grouped.contiguous()
    m = masks.to(torch.float32).contiguous()
    a = alphas.to(torch.float32).contiguous()
    b = betas.to(torch.float32).contiguous()
    out = torch.empty((g, k, v), dtype=grouped.dtype, device=device)
    votes, c_count, stride = None, 0, 1
    if c_vote > 0:
        c_count, stride = vote_layout(v, c_vote)
        votes = torch.empty((g, n1, c_count), dtype=torch.float32,
                            device=device)
    if out.numel():
        KERNEL.launch(device, x.data_ptr(), m.data_ptr(),
                      0 if m.dim() == 1 else n1, a.data_ptr(), b.data_ptr(),
                      out.data_ptr(),
                      None if votes is None else votes.data_ptr(),
                      g, k, n1, v, c_count, stride, code)
    if c_vote <= 0:
        return out
    return out, votes
