"""CUDA fused coded-round decode tail (``csrc/fused_group_decode.cu``).

Replaces the Pallas TPU kernel
``repro.kernels.berrut_decode.fused_group_decode``: per-group decode
matrices are rebuilt from the masks inside the kernel and contracted with
the (G, N+1, V) coded-logit block in one pass, with the locator's strided
vote columns as an optional second output of the same pass.  The block
is read through its group and stream strides (its vocabulary axis with
unit stride), so the worker-major tail's transposed views reach the
kernel without a copy.  ``kernels.ops.fused_group_decode`` calls this for
CUDA tensors and ``ref.fused_group_decode_ref`` for CPU tensors.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core.error_locator import vote_layout
from repro_torch.kernels.build import Kernel, dtype_code, require_cuda

KERNEL = Kernel("fused_group_decode.cu", "fused_group_decode_launch", [
    ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,  # x, strides
    ctypes.c_void_p, ctypes.c_int,                       # masks, stride
    ctypes.c_void_p, ctypes.c_void_p,                    # alphas, betas
    ctypes.c_void_p, ctypes.c_void_p,                    # out, votes
    ctypes.c_int, ctypes.c_int, ctypes.c_int,            # G, K, N+1
    ctypes.c_int, ctypes.c_int, ctypes.c_int,            # V, C, vote stride
    ctypes.c_int, ctypes.c_int,                          # vector, dtype
])
MAX_NODES = 64          # K and N+1 bound the kernel's shared-memory tiles
MAX_GROUPS = 65535      # the grid's second dimension
MAX_VOCAB = 2 ** 31 - 1  # the kernel's column arithmetic is 32-bit
ACCESS_BYTES = 16       # the widest load and store of one thread


def plan_vector(v: int, strides, itemsize: int, ptrs) -> int:
    """Columns a thread of the kernel moves per access for a (., ., V)
    block of ``itemsize``-byte elements: 16 bytes' worth (4 fp32, 8 bf16)
    when V and every stride (in elements) are multiples of that and every
    pointer is 16-byte aligned, else 1.  A ragged vocabulary, an odd
    stride or a view at an unaligned offset takes the kernel's one-column
    instantiation: the same kernel, narrower accesses."""
    width = ACCESS_BYTES // itemsize
    if v % width or any(s % width for s in strides) or any(
            p % ACCESS_BYTES for p in ptrs):
        return 1
    return width


def fused_group_decode(grouped: torch.Tensor, masks: torch.Tensor,
                       alphas: torch.Tensor, betas: torch.Tensor, *,
                       c_vote: int = 0):
    """(G, N+1, V) block + masks -> (G, K, V) decoded logits on the card.

    ``grouped`` may be any view whose last dimension has unit stride (a
    transposed worker-major block, for one); it is read in place.  masks:
    (N+1,) shared availability or (G, N+1) per-group masks.  With
    ``c_vote > 0`` also returns the (G, N+1, C) float32 vote columns
    ``grouped[..., :C*stride:stride]`` from the same pass.
    """
    code = dtype_code("fused_group_decode", grouped.dtype,
                      (torch.float32, torch.bfloat16))
    g, n1, v = grouped.shape
    k = alphas.shape[0]
    if masks.shape not in ((n1,), (g, n1)) or betas.shape != (n1,):
        raise ValueError(f"masks {tuple(masks.shape)} / betas "
                         f"{tuple(betas.shape)} do not match {n1} nodes")
    if k > MAX_NODES or n1 > MAX_NODES or g > MAX_GROUPS or v > MAX_VOCAB:
        raise ValueError(f"fused_group_decode takes K, N+1 <= {MAX_NODES}, "
                         f"G <= {MAX_GROUPS} and V <= {MAX_VOCAB}, got {k}, "
                         f"{n1}, {g}, {v}")
    if v > 1 and grouped.stride(2) != 1:
        raise ValueError("fused_group_decode reads the vocabulary axis with "
                         f"unit stride; got strides {grouped.stride()}")
    device = require_cuda("fused_group_decode", grouped, masks, alphas, betas)
    # a stride of a dimension of size 1 is never taken
    strides = tuple(s if d > 1 else 0
                    for s, d in zip(grouped.stride()[:2], (g, n1)))
    m = masks.to(torch.float32)
    if m.stride(-1) != 1:
        m = m.contiguous()
    a = alphas.to(torch.float32).contiguous()
    b = betas.to(torch.float32).contiguous()
    out = torch.empty((g, k, v), dtype=grouped.dtype, device=device)
    votes, c_count, vote_stride = None, 0, 1
    if c_vote > 0:
        c_count, vote_stride = vote_layout(v, c_vote)
        votes = torch.empty((g, n1, c_count), dtype=torch.float32,
                            device=device)
    if out.numel():
        vec = plan_vector(v, strides, grouped.element_size(),
                          (grouped.data_ptr(), out.data_ptr()))
        KERNEL.launch(device, grouped.data_ptr(), *strides, m.data_ptr(),
                      0 if m.dim() == 1 else m.stride(0), a.data_ptr(),
                      b.data_ptr(), out.data_ptr(),
                      None if votes is None else votes.data_ptr(),
                      g, k, n1, v, c_count, vote_stride, vec, code)
    if c_vote <= 0:
        return out
    return out, votes
