"""CUDA online-softmax prefill attention (``csrc/flash_attention.cu``).

Replaces the Pallas TPU kernel
``repro.kernels.flash_attention.flash_attention``: causal, sliding-window,
prefix-LM, softcap and ``q_offset`` rules, keys beyond ``kv_len`` masked,
GQA through the head index.  ``kernels.ops.attention`` calls this for
CUDA tensors and ``ref.attention_ref`` for CPU tensors.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels.build import Kernel, dtype_code, require_cuda

KERNEL = Kernel("flash_attention.cu", "flash_attention_launch", [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_int, ctypes.c_int, ctypes.c_int,            # B, S, L
    ctypes.c_int, ctypes.c_int, ctypes.c_int,            # H, KV, D
    ctypes.c_int, ctypes.c_int, ctypes.c_int,            # causal, window, prefix
    ctypes.c_float, ctypes.c_int, ctypes.c_float,        # softcap, q_offset, scale
    ctypes.c_int,                                        # dtype
])
HEAD_DIMS = (64, 80, 128, 256)


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` when it starts on 16 bytes (the kernel copies 16-byte
    chunks), else a fresh copy, which does."""
    if t.data_ptr() % 16 == 0:
        return t
    return torch.empty_like(t, memory_format=torch.contiguous_format).copy_(t)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    prefix: int = 0, softcap: float = 0.0,
                    q_offset: int = 0) -> torch.Tensor:
    """q: (B, S, H, D); k, v: (B, L, KV, D) -> (B, S, H, D) on the card."""
    device = require_cuda("flash_attention", q, k, v)
    code = dtype_code("flash_attention", q.dtype,
                      (torch.float32, torch.bfloat16))
    b, s, h, d = q.shape
    l, kv = k.shape[1], k.shape[2]
    if k.dtype != q.dtype or v.dtype != q.dtype or v.shape != k.shape:
        raise ValueError("flash_attention needs k and v of q's dtype and "
                         "one shape")
    if k.shape[0] != b or k.shape[3] != d or h % kv:
        raise ValueError(f"q {tuple(q.shape)} does not match k "
                         f"{tuple(k.shape)} (GQA needs H % KV == 0)")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention takes head_dim in {HEAD_DIMS}, "
                         f"got {d}")
    if window is not None and window < 1:
        raise ValueError(f"window must be positive, got {window}")
    q, k, v = (_aligned(t.contiguous()) for t in (q, k, v))
    out = torch.empty_like(q)
    if out.numel() and l:
        KERNEL.launch(device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                      out.data_ptr(), b, s, l, h, kv, d, int(causal),
                      -1 if window is None else window, prefix, softcap,
                      q_offset, 1.0 / d ** 0.5, code)
    return out
