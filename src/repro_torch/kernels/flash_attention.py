"""CUDA online-softmax prefill attention (``csrc/flash_attention.cu``) and
its backward (``csrc/flash_attention_bwd.cu``: a Delta launch, then one
launch of dk/dv and dq blocks side by side).

The forward replaces the Pallas TPU kernel
``repro.kernels.flash_attention.flash_attention``: causal, sliding-window,
prefix-LM, softcap and ``q_offset`` rules, keys beyond ``kv_len`` masked,
GQA through the head index.  The reference has no Pallas backward: it
trains through XLA's autodiff of ``repro.kernels.ref.attention_ref``, and
the backward kernel computes that gradient from the forward's row
log-sum-exp.  ``FlashAttentionFn`` puts the two under autograd.
``kernels.ops.attention`` calls these for CUDA tensors and
``ref.attention_ref`` for CPU tensors.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels.build import Kernel, dtype_code, require_cuda

KERNEL = Kernel("flash_attention.cu", "flash_attention_launch", [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,   # q, k, v
    ctypes.c_void_p, ctypes.c_void_p,                    # out, lse (or null)
    ctypes.c_int, ctypes.c_int, ctypes.c_int,            # B, S, L
    ctypes.c_int, ctypes.c_int, ctypes.c_int,            # H, KV, D
    ctypes.c_int, ctypes.c_int, ctypes.c_int,            # causal, window, prefix
    ctypes.c_float, ctypes.c_int, ctypes.c_float,        # softcap, q_offset, scale
    ctypes.c_int,                                        # dtype
])
BWD_KERNEL = Kernel("flash_attention_bwd.cu", "flash_attention_bwd_launch", [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,   # q, k, v
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,   # dO, lse, delta
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,   # dq, dk, dv
    ctypes.c_int, ctypes.c_int, ctypes.c_int,            # B, S, L
    ctypes.c_int, ctypes.c_int, ctypes.c_int,            # H, KV, D
    ctypes.c_int, ctypes.c_int, ctypes.c_int,            # causal, window, prefix
    ctypes.c_float, ctypes.c_int, ctypes.c_float,        # softcap, q_offset, scale
    ctypes.c_int,                                        # dtype
])
DELTA_KERNEL = Kernel("flash_attention_bwd.cu",
                      "flash_attention_bwd_delta_launch", [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,   # o, dO, delta
    ctypes.c_int, ctypes.c_int, ctypes.c_int,            # B, S, H
    ctypes.c_int, ctypes.c_int,                          # D, dtype
])
BWD_INFO = Kernel("flash_attention_bwd.cu", "flash_attention_bwd_info", [
    ctypes.c_int, ctypes.c_int, ctypes.c_void_p])        # D, dtype, out
# flash_attention_bwd_info's numbers of each launch, in its order
BWD_INFO_KEYS = {
    "main": ("stages", "smem_bytes", "registers", "local_bytes",
             "blocks_per_sm", "threads", "rows", "tile", "split_d",
             "split_n"),
    "delta": ("stages", "smem_bytes", "registers", "local_bytes",
              "blocks_per_sm", "threads"),
}
HEAD_DIMS = (64, 80, 128, 256)


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` when it starts on 16 bytes (the kernel copies 16-byte
    chunks), else a fresh copy, which does."""
    if t.data_ptr() % 16 == 0:
        return t
    return torch.empty_like(t, memory_format=torch.contiguous_format).copy_(t)


def _checked(name: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             window: Optional[int]):
    """(device, dtype code) of a valid q, k, v; raises on anything the
    kernels do not take."""
    device = require_cuda(name, q, k, v)
    code = dtype_code(name, q.dtype, (torch.float32, torch.bfloat16))
    b, _, h, d = q.shape
    kv = k.shape[2]
    if k.dtype != q.dtype or v.dtype != q.dtype or v.shape != k.shape:
        raise ValueError(f"{name} needs k and v of q's dtype and one shape")
    if k.shape[0] != b or k.shape[3] != d or h % kv:
        raise ValueError(f"q {tuple(q.shape)} does not match k "
                         f"{tuple(k.shape)} (GQA needs H % KV == 0)")
    if d not in HEAD_DIMS:
        raise ValueError(f"{name} takes head_dim in {HEAD_DIMS}, got {d}")
    if window is not None and window < 1:
        raise ValueError(f"window must be positive, got {window}")
    return device, code


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    prefix: int = 0, softcap: float = 0.0,
                    q_offset: int = 0, return_lse: bool = False):
    """q: (B, S, H, D); k, v: (B, L, KV, D) -> (B, S, H, D) on the card.

    With ``return_lse`` also the rows' log-sum-exp, (B, H, S) fp32 in the
    scaled and softcapped score space (-inf for a row that sees no key),
    which ``flash_attention_bwd`` reads."""
    device, code = _checked("flash_attention", q, k, v, window)
    b, s, h, d = q.shape
    l, kv = k.shape[1], k.shape[2]
    q, k, v = (_aligned(t.contiguous()) for t in (q, k, v))
    out = torch.empty_like(q)
    lse = (torch.full((b, h, s), float("-inf"), dtype=torch.float32,
                      device=device) if return_lse else None)
    if out.numel() and l:
        KERNEL.launch(device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                      out.data_ptr(), None if lse is None else lse.data_ptr(),
                      b, s, l, h, kv, d, int(causal),
                      -1 if window is None else window, prefix, softcap,
                      q_offset, 1.0 / d ** 0.5, code)
    return (out, lse) if return_lse else out


def flash_attention_bwd_delta(o: torch.Tensor,
                              do: torch.Tensor) -> torch.Tensor:
    """Delta = rowsum(dO * o) of the forward's output ``o`` and the output
    gradient ``do`` (B, S, H, D) on the card: (B, H, S) fp32, the first of
    the backward's two launches (``ref.attention_delta_ref`` is its plain
    version)."""
    device = require_cuda("flash_attention_bwd_delta", o, do)
    code = dtype_code("flash_attention_bwd_delta", o.dtype,
                      (torch.float32, torch.bfloat16))
    if o.dim() != 4 or do.shape != o.shape or do.dtype != o.dtype:
        raise ValueError(f"flash_attention_bwd_delta needs o and do of one "
                         f"(B, S, H, D) shape and dtype, got "
                         f"{tuple(o.shape)} {o.dtype}, {tuple(do.shape)} "
                         f"{do.dtype}")
    b, s, h, d = o.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention_bwd_delta takes head_dim in "
                         f"{HEAD_DIMS}, got {d}")
    o, do = (_aligned(t.contiguous()) for t in (o, do))
    delta = torch.empty((b, h, s), dtype=torch.float32, device=device)
    if delta.numel():
        DELTA_KERNEL.launch(device, o.data_ptr(), do.data_ptr(),
                            delta.data_ptr(), b, s, h, d, code)
    return delta


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, lse: torch.Tensor,
                        do: torch.Tensor, *, causal: bool = True,
                        window: Optional[int] = None, prefix: int = 0,
                        softcap: float = 0.0, q_offset: int = 0):
    """The gradient of ``flash_attention`` on the card: (dq, dk, dv) in
    q's, k's and v's dtype (accumulated in fp32), from the forward's
    output ``o``, its log-sum-exp ``lse`` and the output gradient ``do``;
    the same visibility rules as the forward.  Two launches: Delta
    (``flash_attention_bwd_delta``), then one grid of dk/dv blocks (a
    block of keys of one kv-head, over its q-heads' rows) and dq blocks
    (a block of rows over their keys), which run side by side and write
    every element once: no atomics, and a call is bitwise deterministic.
    ``bwd_info`` says what each launch runs at a head dim and dtype."""
    device, code = _checked("flash_attention_bwd", q, k, v, window)
    b, s, h, d = q.shape
    l, kv = k.shape[1], k.shape[2]
    if o.shape != q.shape or do.shape != q.shape or o.dtype != q.dtype \
            or do.dtype != q.dtype:
        raise ValueError(f"flash_attention_bwd needs o and do of q's shape "
                         f"{tuple(q.shape)} and dtype")
    if lse.shape != (b, h, s) or lse.dtype != torch.float32:
        raise ValueError(f"flash_attention_bwd needs a ({b}, {h}, {s}) "
                         f"float32 lse, got {tuple(lse.shape)} {lse.dtype}")
    require_cuda("flash_attention_bwd", q, o, do, lse)
    q, k, v, do = (_aligned(t.contiguous()) for t in (q, k, v, do))
    lse = lse.contiguous()
    if not (q.numel() and l):      # no key anywhere: no gradient
        return torch.zeros_like(q), torch.zeros_like(k), torch.zeros_like(v)
    delta = flash_attention_bwd_delta(o, do)
    # the kernel writes every row of dq, dk and dv
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    BWD_KERNEL.launch(device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                      do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                      dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, s, l,
                      h, kv, d, int(causal),
                      -1 if window is None else window, prefix, softcap,
                      q_offset, 1.0 / d ** 0.5, code)
    return dq, dk, dv


def bwd_info(d: int, dtype: torch.dtype, device: torch.device) -> dict:
    """What ``flash_attention_bwd``'s two launches run at head dim ``d``
    and ``dtype`` on ``device``, read from the built kernels and the CUDA
    occupancy calculator without launching them: {"main": its cp.async
    stages, shared bytes, registers and local (spill) bytes a thread,
    blocks an SM, threads a block, a block's own rows, the streamed tile's
    rows, the warps splitting D and the tile; "delta": the same first
    six}."""
    require_cuda("bwd_info", torch.empty(0, device=device))
    code = dtype_code("bwd_info", dtype, (torch.float32, torch.bfloat16))
    if d not in HEAD_DIMS:
        raise ValueError(f"bwd_info takes head_dim in {HEAD_DIMS}, got {d}")
    sizes = [len(keys) for keys in BWD_INFO_KEYS.values()]
    out = (ctypes.c_int * sum(sizes))()
    fn = BWD_INFO._entry()
    with torch.cuda.device(device):
        err = fn(d, code, ctypes.addressof(out), None)
    if err != 0:
        raise RuntimeError(f"flash_attention_bwd_info failed with CUDA error "
                           f"{err} at D={d} {dtype}")
    values = list(out)
    return {"main": dict(zip(BWD_INFO_KEYS["main"], values[:sizes[0]])),
            "delta": dict(zip(BWD_INFO_KEYS["delta"], values[sizes[0]:]))}


class FlashAttentionFn(torch.autograd.Function):
    """B3 under autograd: the forward launches ``flash_attention`` and
    keeps its log-sum-exp, the backward launches ``flash_attention_bwd``.
    Under activation checkpointing the forward is launched again when
    the block is recomputed.  The backward kernel has no backward of its
    own, so a double backward raises rather than dropping terms."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, prefix, softcap, q_offset):
        rule = dict(causal=causal, window=window, prefix=prefix,
                    softcap=softcap, q_offset=q_offset)
        out, lse = flash_attention(q, k, v, return_lse=True, **rule)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.rule = rule
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, do, **ctx.rule)
        return dq, dk, dv, None, None, None, None, None
