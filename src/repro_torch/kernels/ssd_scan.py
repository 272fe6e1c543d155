"""CUDA chunked Mamba2 SSD scan (``csrc/ssd_scan.cu``).

Replaces the Pallas TPU kernel ``repro.kernels.ssd_scan.ssd_chunked``.
``kernels.ops.ssd`` calls this for CUDA tensors and
``ref.ssd_chunked_ref`` for CPU tensors.  The kernel tiles the sequence
by its own chunk of ``CHUNK`` steps, so it takes any S; the chunked
algebra is exact, and the result does not depend on the chunk beyond
rounding.  Each call launches two kernels of ``csrc/ssd_scan.cu``, each
counted: ``SCORES_KERNEL``, the chunks' C B^T shared by every head, then
``KERNEL``, the scan over the chunks of each (stream, head).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels.build import Kernel, dtype_code, require_cuda

_ARGTYPES = [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,   # x, dt, a_log
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,   # b, c, d_skip
    ctypes.c_void_p, ctypes.c_void_p,                    # h0, scores
    ctypes.c_void_p, ctypes.c_void_p,                    # y, h_final
    ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,  # x strides
    ctypes.c_longlong, ctypes.c_longlong,                # b strides
    ctypes.c_longlong, ctypes.c_longlong,                # c strides
    ctypes.c_int, ctypes.c_int, ctypes.c_int,            # B, S, H
    ctypes.c_int, ctypes.c_int, ctypes.c_int,            # P, N, dtype
    ctypes.c_int,                                        # ring stages
]
SCORES_KERNEL = Kernel("ssd_scan.cu", "ssd_chunk_scores_launch", _ARGTYPES)
KERNEL = Kernel("ssd_scan.cu", "ssd_chunked_launch", _ARGTYPES)
CHUNK = 32                          # the kernels' own chunk (kQ)
STATE_DIMS = (16, 32, 64, 128)      # N: the state accumulator's widths
MAX_HEAD_DIM = 128                  # P: 16 rows of the state a warp, 8 warps
MAX_BATCH = 65535                   # the grid's second dimension
# Shared-memory stages of the chunk ring, by dtype, as measured on an
# H100 at the mamba2 prefill's shapes: fp32 is faster with one stage (its
# 48 KB footprint lets four blocks share an SM, which hide each other's
# loads), bf16 with two.
STAGES = {torch.float32: 1, torch.bfloat16: 2}


def _rows(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself when its rows can be copied 16 bytes at a time (unit
    last stride, 16-byte aligned start and row strides), else a fresh
    contiguous copy."""
    size = t.element_size()
    if t.stride(-1) == 1 and t.data_ptr() % 16 == 0 and all(
            st * size % 16 == 0 for st in t.stride()[:-1]):
        return t
    return torch.empty_like(t, memory_format=torch.contiguous_format).copy_(t)


def ssd_chunk_scores(b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """The scores pass alone: b, c (B, S, N) -> (B, ceil(S / CHUNK),
    CHUNK, CHUNK) fp32 C B^T of each chunk, steps past S zeros (what
    ``ssd_chunked`` launches first; ``ref.ssd_chunk_scores_ref`` is its
    plain version)."""
    device = require_cuda("ssd_chunk_scores", b, c)
    code = dtype_code("ssd_chunk_scores", b.dtype,
                      (torch.float32, torch.bfloat16))
    bsz, s, n = b.shape
    if c.shape != b.shape or c.dtype != b.dtype:
        raise ValueError(f"b {tuple(b.shape)} {b.dtype} and c "
                         f"{tuple(c.shape)} {c.dtype} differ")
    if n not in STATE_DIMS or bsz > MAX_BATCH or s < 1:
        raise ValueError(f"ssd_chunk_scores takes N in {STATE_DIMS}, B up "
                         f"to {MAX_BATCH} and S >= 1, got {tuple(b.shape)}")
    b, c = _rows(b), _rows(c)
    scores = torch.empty((bsz, -(-s // CHUNK), CHUNK, CHUNK),
                         dtype=torch.float32, device=device)
    SCORES_KERNEL.launch(device, None, None, None, b.data_ptr(),
                         c.data_ptr(), None, None, scores.data_ptr(), None,
                         None, 0, 0, 0, b.stride(0), b.stride(1),
                         c.stride(0), c.stride(1), bsz, s, 1, 8, n, code,
                         STAGES[b.dtype])
    return scores


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor,
                b: torch.Tensor, c: torch.Tensor, d_skip: torch.Tensor,
                h0: Optional[torch.Tensor] = None):
    """x: (B, S, H, P); dt: (B, S, H); a_log, d_skip: (H,); b, c:
    (B, S, N); h0: optional (B, H, P, N).  Returns (y (B, S, H, P) in x's
    dtype, float32 or bfloat16, and h_final (B, H, P, N) float32).

    x, b and c are read through their strides (the model hands in
    slices of one conv output); only a non-unit last stride is copied.
    """
    device = require_cuda("ssd_chunked", x, dt, a_log, b, c, d_skip)
    code = dtype_code("ssd_chunked", x.dtype, (torch.float32, torch.bfloat16))
    bsz, s, h, p = x.shape
    n = b.shape[-1]
    if dt.shape != (bsz, s, h) or a_log.shape != (h,) or \
            d_skip.shape != (h,) or b.shape != (bsz, s, n) or \
            c.shape != (bsz, s, n):
        raise ValueError(
            f"ssd_chunked shapes do not match: x {tuple(x.shape)}, dt "
            f"{tuple(dt.shape)}, a_log {tuple(a_log.shape)}, b "
            f"{tuple(b.shape)}, c {tuple(c.shape)}, d_skip "
            f"{tuple(d_skip.shape)}")
    if b.dtype != x.dtype or c.dtype != x.dtype:
        raise TypeError(f"b and c must be x's dtype {x.dtype}, got "
                        f"{b.dtype}, {c.dtype}")
    if n not in STATE_DIMS:
        raise ValueError(f"ssd_chunked takes N in {STATE_DIMS}, got {n}")
    if p % 8 or p > MAX_HEAD_DIM:
        raise ValueError(f"ssd_chunked takes P a multiple of 8 up to "
                         f"{MAX_HEAD_DIM}, got {p}")
    if bsz > MAX_BATCH:
        raise ValueError(f"ssd_chunked takes at most {MAX_BATCH} streams")
    x, b, c = _rows(x), _rows(b), _rows(c)
    dtf = dt.to(torch.float32).contiguous()
    a32 = a_log.to(torch.float32).contiguous()
    d32 = d_skip.to(torch.float32).contiguous()
    y = torch.empty((bsz, s, h, p), dtype=x.dtype, device=device)
    if h0 is None:
        h_final = torch.empty((bsz, h, p, n), dtype=torch.float32,
                              device=device)
        h0_ptr = None
    else:
        require_cuda("ssd_chunked", x, h0)
        if h0.shape != (bsz, h, p, n):
            raise ValueError(f"h0 {tuple(h0.shape)} is not "
                             f"{(bsz, h, p, n)}")
        h0 = h0.to(torch.float32).contiguous()
        h_final = torch.empty_like(h0)
        h0_ptr = h0.data_ptr()
    scores = torch.empty((bsz, -(-s // CHUNK), CHUNK, CHUNK),
                         dtype=torch.float32, device=device)
    args = (x.data_ptr(), dtf.data_ptr(), a32.data_ptr(), b.data_ptr(),
            c.data_ptr(), d32.data_ptr(), h0_ptr, scores.data_ptr(),
            y.data_ptr(), h_final.data_ptr(),
            x.stride(0), x.stride(1), x.stride(2),
            b.stride(0), b.stride(1), c.stride(0), c.stride(1),
            bsz, s, h, p, n, code, STAGES[x.dtype])
    if bsz and s:
        SCORES_KERNEL.launch(device, *args)
    if bsz and h:              # S = 0 launches too: h_final is then h0 or 0
        KERNEL.launch(device, *args)
    return y, h_final
