"""CUDA Berrut coded encode/decode contraction (``csrc/berrut_apply.cu``).

``berrut_apply`` replaces the Pallas TPU kernel
``repro.kernels.berrut_matmul.berrut_apply``; ``berrut_encode_dispatch``
replaces ``repro.kernels.berrut_matmul.berrut_encode_dispatch``, the
same contraction written straight into the worker-major ``o*G + g`` row
order (a second entry point of the same kernel source).
``kernels.ops`` calls these for CUDA tensors and the plain versions in
``ref`` for CPU tensors.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.build import Kernel, dtype_code, require_cuda

_ARGS = [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,   # w, x, out
    ctypes.c_int, ctypes.c_int, ctypes.c_longlong,       # O, I, F
    ctypes.c_int, ctypes.c_int,                          # groups, dtype
]
KERNEL = Kernel("berrut_apply.cu", "berrut_apply_launch", _ARGS)
DISPATCH_KERNEL = Kernel("berrut_apply.cu", "berrut_encode_dispatch_launch",
                         _ARGS)
MAX_DIM = 64            # I: the kernel's register column; O: shared W
MAX_GROUPS = 65535      # the grid's second dimension


def berrut_apply(weights: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """(O, I) @ (..., I, F) -> (..., O, F) on the card, fp32 accumulation,
    output in x's dtype (float32 or bfloat16)."""
    device = require_cuda("berrut_apply", weights, x)
    code = dtype_code("berrut_apply", x.dtype, (torch.float32, torch.bfloat16))
    o_dim, i_dim = weights.shape
    if x.shape[-2] != i_dim:
        raise ValueError(f"weights {tuple(weights.shape)} do not contract "
                         f"with x {tuple(x.shape)}")
    if o_dim > MAX_DIM or i_dim > MAX_DIM:
        raise ValueError(f"berrut_apply takes O, I <= {MAX_DIM}, got "
                         f"{o_dim}, {i_dim}")
    lead, f = x.shape[:-2], x.shape[-1]
    xg = x.reshape(-1, i_dim, f).contiguous()
    groups = xg.shape[0]
    if groups > MAX_GROUPS:
        raise ValueError(f"berrut_apply takes at most {MAX_GROUPS} groups")
    w = weights.to(torch.float32).contiguous()
    out = torch.empty((groups, o_dim, f), dtype=x.dtype, device=device)
    if out.numel():
        KERNEL.launch(device, w.data_ptr(), xg.data_ptr(), out.data_ptr(),
                      o_dim, i_dim, f, groups, code)
    return out.reshape(*lead, o_dim, f)


def berrut_encode_dispatch(weights: torch.Tensor,
                           x: torch.Tensor) -> torch.Tensor:
    """(O, I) @ (G, I, F) -> (O*G, F) on the card, row ``o*G + g``, fp32
    accumulation, output in x's dtype.  ``weights`` may be any row slice
    of the encode matrix (a worker rank encodes its own streams only)."""
    device = require_cuda("berrut_encode_dispatch", weights, x)
    code = dtype_code("berrut_encode_dispatch", x.dtype,
                      (torch.float32, torch.bfloat16))
    o_dim, i_dim = weights.shape
    if x.dim() != 3 or x.shape[1] != i_dim:
        raise ValueError(f"weights {tuple(weights.shape)} do not contract "
                         f"with x {tuple(x.shape)} (need (G, I, F))")
    if o_dim > MAX_DIM or i_dim > MAX_DIM:
        raise ValueError(f"berrut_encode_dispatch takes O, I <= {MAX_DIM}, "
                         f"got {o_dim}, {i_dim}")
    groups, _, f = x.shape
    if groups > MAX_GROUPS:
        raise ValueError(f"berrut_encode_dispatch takes at most "
                         f"{MAX_GROUPS} groups")
    xg = x.contiguous()
    w = weights.to(torch.float32).contiguous()
    out = torch.empty((o_dim * groups, f), dtype=x.dtype, device=device)
    if out.numel():
        DISPATCH_KERNEL.launch(device, w.data_ptr(), xg.data_ptr(),
                               out.data_ptr(), o_dim, i_dim, f, groups, code)
    return out
