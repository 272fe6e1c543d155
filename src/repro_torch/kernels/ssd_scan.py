"""CUDA chunked Mamba2 SSD scan (``csrc/ssd_scan.cu``) and its backward
(``csrc/ssd_scan_bwd.cu``).

The forward replaces the Pallas TPU kernel
``repro.kernels.ssd_scan.ssd_chunked``.  ``kernels.ops.ssd`` calls this
for CUDA tensors and ``ref.ssd_chunked_ref`` for CPU tensors.  The kernel
tiles the sequence by its own chunk of ``CHUNK`` steps, so it takes any
S; the chunked algebra is exact, and the result does not depend on the
chunk beyond rounding.  Each call launches two kernels of
``csrc/ssd_scan.cu``, each counted: ``SCORES_KERNEL``, the chunks' C B^T
shared by every head, then ``KERNEL``, the scan over the chunks of each
(stream, head).

The reference has no Pallas backward: it trains through XLA's autodiff of
``repro.kernels.ref.ssd_chunked_ref``, and ``ssd_chunked_bwd`` computes
that gradient in two counted launches of ``csrc/ssd_scan_bwd.cu``:
``BWD_KERNEL`` (per (stream, head), 8 warps on the tensor cores by
3xTF32: the chunks' entry states recomputed into a scratch, then the
reverse walk, each product tiled over every warp, the chunk's inputs
staged by cp.async) and ``HEAD_SUM_KERNEL`` (db and dc summed over the
heads in order).  ``bwd_info`` reads, without a launch, the stages,
registers, spills and blocks an SM of the first launch's instantiation.
``SsdFn`` puts the forward and the backward under autograd;
``ref.ssd_chunked_bwd_ref`` is the plain version.
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
BWD_KERNEL = Kernel("ssd_scan_bwd.cu", "ssd_chunked_bwd_launch", [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,   # x, dt, a_log
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,   # b, c, d_skip
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,   # h0, dy, dh_final
    ctypes.c_void_p,                                     # states scratch
    ctypes.c_void_p, ctypes.c_void_p,                    # dx, ddt
    ctypes.c_void_p, ctypes.c_void_p,                    # db, dc partials
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,   # dh0, da, dd parts
    ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,  # x strides
    ctypes.c_longlong, ctypes.c_longlong,                # b strides
    ctypes.c_longlong, ctypes.c_longlong,                # c strides
    ctypes.c_int, ctypes.c_int, ctypes.c_int,            # B, S, H
    ctypes.c_int, ctypes.c_int, ctypes.c_int,            # P, N, dtype
])
# what the backward runs at (P, N, dtype), read without a launch
BWD_INFO = Kernel("ssd_scan_bwd.cu", "ssd_chunked_bwd_info", [
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
BWD_INFO_KEYS = ("stages", "smem_bytes", "registers", "local_bytes",
                 "blocks_per_sm", "max_threads")
HEAD_SUM_KERNEL = Kernel("ssd_scan_bwd.cu", "ssd_bwd_head_sum_launch", [
    ctypes.c_void_p, ctypes.c_void_p,                    # db, dc partials
    ctypes.c_void_p, ctypes.c_void_p,                    # db, dc
    ctypes.c_int, ctypes.c_int, ctypes.c_int,            # B, H, S
    ctypes.c_int, ctypes.c_int,                          # N, dtype
])
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


def _checked(name: str, x: torch.Tensor, dt: torch.Tensor,
             a_log: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
             d_skip: torch.Tensor):
    """(device, dtype code) of valid scan inputs; raises on anything the
    kernels do not take."""
    device = require_cuda(name, x, dt, a_log, b, c, d_skip)
    code = dtype_code(name, x.dtype, (torch.float32, torch.bfloat16))
    bsz, s, h, p = x.shape
    n = b.shape[-1]
    if dt.shape != (bsz, s, h) or a_log.shape != (h,) or \
            d_skip.shape != (h,) or b.shape != (bsz, s, n) or \
            c.shape != (bsz, s, n):
        raise ValueError(
            f"{name} shapes do not match: x {tuple(x.shape)}, dt "
            f"{tuple(dt.shape)}, a_log {tuple(a_log.shape)}, b "
            f"{tuple(b.shape)}, c {tuple(c.shape)}, d_skip "
            f"{tuple(d_skip.shape)}")
    if b.dtype != x.dtype or c.dtype != x.dtype:
        raise TypeError(f"b and c must be x's dtype {x.dtype}, got "
                        f"{b.dtype}, {c.dtype}")
    if n not in STATE_DIMS:
        raise ValueError(f"{name} takes N in {STATE_DIMS}, got {n}")
    if p % 8 or p > MAX_HEAD_DIM:
        raise ValueError(f"{name} takes P a multiple of 8 up to "
                         f"{MAX_HEAD_DIM}, got {p}")
    if bsz > MAX_BATCH:
        raise ValueError(f"{name} takes at most {MAX_BATCH} streams")
    return device, code


def _state(name: str, t: Optional[torch.Tensor], shape: tuple,
           device: torch.device) -> Optional[torch.Tensor]:
    """A (B, H, P, N) state argument as contiguous fp32, or None."""
    if t is None:
        return None
    require_cuda(name, t)
    if t.device != device or t.shape != shape:
        raise ValueError(f"{name}: state {tuple(t.shape)} on {t.device} is "
                         f"not {shape} on {device}")
    return t.to(torch.float32).contiguous()


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor,
                b: torch.Tensor, c: torch.Tensor, d_skip: torch.Tensor,
                h0: Optional[torch.Tensor] = None):
    """x: (B, S, H, P); dt: (B, S, H); a_log, d_skip: (H,); b, c:
    (B, S, N); h0: optional (B, H, P, N).  Returns (y (B, S, H, P) in x's
    dtype, float32 or bfloat16, and h_final (B, H, P, N) float32).

    x, b and c are read through their strides (the model hands in
    slices of one conv output); only a non-unit last stride is copied.
    """
    device, code = _checked("ssd_chunked", x, dt, a_log, b, c, d_skip)
    bsz, s, h, p = x.shape
    n = b.shape[-1]
    x, b, c = _rows(x), _rows(b), _rows(c)
    dtf = dt.to(torch.float32).contiguous()
    a32 = a_log.to(torch.float32).contiguous()
    d32 = d_skip.to(torch.float32).contiguous()
    y = torch.empty((bsz, s, h, p), dtype=x.dtype, device=device)
    h0 = _state("ssd_chunked", h0, (bsz, h, p, n), device)
    h_final = torch.empty((bsz, h, p, n), dtype=torch.float32, device=device)
    h0_ptr = None if h0 is None else h0.data_ptr()
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


def ssd_chunked_bwd(x: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor,
                    b: torch.Tensor, c: torch.Tensor, d_skip: torch.Tensor,
                    dy: torch.Tensor, h0: Optional[torch.Tensor] = None,
                    dh_final: Optional[torch.Tensor] = None):
    """The gradient of ``ssd_chunked`` on the card, given the output
    gradient ``dy`` (B, S, H, P) in x's dtype and an optional
    ``dh_final`` (B, H, P, N): (dx, ddt, da_log, db, dc, dd, dh0), each in
    its input's dtype (dh0 None without h0), summed in fp32 in a fixed
    order (the same bits from run to run).  The inputs are those of the
    forward, read the same way (rows the kernel cannot copy 16 bytes at a
    time are copied first, as ``ssd_chunked`` does); the chunks' entry
    states are recomputed into a scratch that lives for this call only."""
    device, code = _checked("ssd_chunked_bwd", x, dt, a_log, b, c, d_skip)
    bsz, s, h, p = x.shape
    n = b.shape[-1]
    require_cuda("ssd_chunked_bwd", x, dy)
    if dy.shape != x.shape or dy.dtype != x.dtype:
        raise ValueError(f"ssd_chunked_bwd needs dy of x's shape "
                         f"{tuple(x.shape)} and dtype {x.dtype}, got "
                         f"{tuple(dy.shape)} {dy.dtype}")
    state = (bsz, h, p, n)
    h0f = _state("ssd_chunked_bwd", h0, state, device)
    dhf = _state("ssd_chunked_bwd", dh_final, state, device)
    x, b, c = _rows(x), _rows(b), _rows(c)
    dy = _rows(dy.contiguous())
    dtf = dt.to(torch.float32).contiguous()
    a32 = a_log.to(torch.float32).contiguous()
    d32 = d_skip.to(torch.float32).contiguous()
    f32 = dict(dtype=torch.float32, device=device)
    # the kernel writes every element of these
    states = torch.empty((bsz, h, -(-s // CHUNK), p, n), **f32)
    dx = torch.empty((bsz, s, h, p), dtype=x.dtype, device=device)
    ddt = torch.empty((bsz, s, h), **f32)
    parts = torch.empty((2, bsz, h, s, n), **f32)      # db, dc a head
    dh0 = None if h0 is None else torch.empty(state, **f32)
    sums = torch.zeros((2, bsz, h), **f32)             # d a_log, dD a head
    if bsz and h:              # S = 0 launches too: dh0 is then dh_final or 0
        BWD_KERNEL.launch(
            device, x.data_ptr(), dtf.data_ptr(), a32.data_ptr(),
            b.data_ptr(), c.data_ptr(), d32.data_ptr(),
            None if h0f is None else h0f.data_ptr(), dy.data_ptr(),
            None if dhf is None else dhf.data_ptr(), states.data_ptr(),
            dx.data_ptr(), ddt.data_ptr(), parts[0].data_ptr(),
            parts[1].data_ptr(), None if dh0 is None else dh0.data_ptr(),
            sums[0].data_ptr(), sums[1].data_ptr(),
            x.stride(0), x.stride(1), x.stride(2), b.stride(0), b.stride(1),
            c.stride(0), c.stride(1), bsz, s, h, p, n, code)
    if bsz and h and s:
        db, dc = ssd_bwd_head_sum(parts, x.dtype)
    else:
        db = torch.zeros((bsz, s, n), dtype=x.dtype, device=device)
        dc = torch.zeros_like(db)
    da_log, dd = sums.sum(1)
    return (dx, ddt.to(dt.dtype), da_log.to(a_log.dtype), db, dc,
            dd.to(d_skip.dtype), None if h0 is None else dh0.to(h0.dtype))


def ssd_bwd_head_sum(parts: torch.Tensor, dtype: torch.dtype):
    """The backward's second launch: per-head partials ``parts`` (2, B, H,
    S, N) fp32 of db and dc -> (db, dc) (B, S, N) in ``dtype``, each the
    sum over the heads in order (``ref.ssd_bwd_head_sum_ref`` is its plain
    version)."""
    device = require_cuda("ssd_bwd_head_sum", parts)
    code = dtype_code("ssd_bwd_head_sum", dtype,
                      (torch.float32, torch.bfloat16))
    if parts.dim() != 5 or parts.shape[0] != 2 or \
            parts.dtype != torch.float32 or not parts.numel():
        raise ValueError(f"ssd_bwd_head_sum takes (2, B, H, S, N) float32 "
                         f"partials, got {tuple(parts.shape)} {parts.dtype}")
    _, bsz, h, s, n = parts.shape
    parts = parts.contiguous()
    db = torch.empty((bsz, s, n), dtype=dtype, device=device)
    dc = torch.empty_like(db)
    HEAD_SUM_KERNEL.launch(device, parts[0].data_ptr(), parts[1].data_ptr(),
                           db.data_ptr(), dc.data_ptr(), bsz, h, s, n, code)
    return db, dc


def bwd_info(p: int, n: int, dtype: torch.dtype,
             device: torch.device) -> dict:
    """What ``ssd_chunked_bwd``'s first launch runs at head dim ``p``,
    state ``n`` and ``dtype`` on ``device``, read from the built kernel and
    the CUDA occupancy calculator without launching it: its shared-memory
    stages and bytes, registers and local (spill) bytes a thread, and the
    blocks an SM can hold."""
    require_cuda("bwd_info", torch.empty(0, device=device))
    code = dtype_code("bwd_info", dtype, (torch.float32, torch.bfloat16))
    out = (ctypes.c_int * len(BWD_INFO_KEYS))()
    fn = BWD_INFO._entry()
    with torch.cuda.device(device):
        err = fn(p, n, code, ctypes.addressof(out), None)
    if err != 0:
        raise RuntimeError(f"ssd_chunked_bwd_info failed with CUDA error "
                           f"{err} at P={p} N={n} {dtype}")
    return dict(zip(BWD_INFO_KEYS, out))


class SsdFn(torch.autograd.Function):
    """B7 under autograd: the forward launches ``ssd_chunked`` and saves
    its inputs only, the backward launches ``ssd_chunked_bwd``.  Under
    activation checkpointing the forward is launched again when the block
    is recomputed.  A gradient that autograd leaves undefined (h_final
    unused, as in training) reaches the backward as None, not as zeros.
    The backward kernels have no backward of their own, so a double
    backward raises rather than dropping terms."""

    @staticmethod
    def forward(ctx, x, dt, a_log, b, c, d_skip, h0):
        y, h_final = ssd_chunked(x, dt, a_log, b, c, d_skip, h0=h0)
        ctx.save_for_backward(x, dt, a_log, b, c, d_skip, h0)
        ctx.set_materialize_grads(False)
        return y, h_final

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dy, dh_final):
        x, dt, a_log, b, c, d_skip, h0 = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros_like(x, memory_format=torch.contiguous_format)
        return ssd_chunked_bwd(x, dt, a_log, b, c, d_skip, dy, h0=h0,
                               dh_final=dh_final)
