"""CUDA single-token decode attention (``csrc/flash_decode.cu``).

``flash_decode`` replaces the Pallas TPU kernel
``repro.kernels.flash_decode.flash_decode``: one query row per stream
over a (B, W, KV, D) ring cache with an explicit (B, W) validity mask.
``pool_flash_decode`` replaces ``repro.kernels.flash_decode.
pool_flash_decode``, the slot-pool decode: validity comes from each
stream's (B,) ring position and optional (B,) live flag, and the kernel
reads only the slots at depth <= pos.  In both, the rep q-heads of a
kv-head share one pass and int8 caches are dequantised in the kernel by
``kv_scale``.  ``kernels.ops.decode_attention`` and
``kernels.ops.pool_decode_attention`` call these for CUDA tensors and
the plain versions in ``ref`` for CPU tensors.

The kernel splits each (stream, kv-head)'s keys into ``plan_splits``
even shares (flash-decoding): one block per (kv-head, stream, split)
streams its share through shared memory with 16-byte async copies, and
when there is more than one split a second kernel of the same call
merges their partial softmaxes from an fp32 workspace that the wrapper
allocates.  The split count depends on the shapes and the card's SM
count only, never on ``pos`` or the mask, so a call needs no host sync
and can be captured in a CUDA graph.

``return_lse=True`` is the block form, for a cache that holds one block
of a ring's slots (a model-axis rank's, where the axis does not divide
the kv-heads): the kernel then writes an fp32 output and each (stream,
q-head) row's log-sum-exp, and the pool wrapper's ``slot0`` names the
ring slot of the block's first slot.  The blocks' results are merged
outside the kernel (``ref.merge_blocks_ref``,
``models.partitioning.ModelGroup.merge_ring_blocks``).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels.build import Kernel, dtype_code, require_cuda

_SHAPE_ARGS = [
    ctypes.c_int, ctypes.c_int, ctypes.c_int,            # B, W, H
    ctypes.c_int, ctypes.c_int,                          # KV, D
    ctypes.c_float, ctypes.c_float, ctypes.c_float,      # softcap, scale, kv_scale
    ctypes.c_int, ctypes.c_int,                          # dtype, cache dtype
    ctypes.c_int, ctypes.c_void_p,                       # splits, workspace
    ctypes.c_void_p,                                     # lse (or null)
]
KERNEL = Kernel("flash_decode.cu", "flash_decode_launch", [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,   # q, k, v
    ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,  # mask, stride, out
    *_SHAPE_ARGS,
])
POOL_KERNEL = Kernel("flash_decode.cu", "pool_flash_decode_launch", [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,   # q, k, v
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,      # pos, live, slot0
    ctypes.c_void_p,                                     # out
    *_SHAPE_ARGS,
])
HEAD_DIMS = (64, 80, 128, 256)
# The fewest keys of the ring worth a split of their own.
MIN_SPLIT_KEYS = 64


def plan_splits(batch: int, kv_heads: int, width: int, sm_count: int) -> int:
    """Key splits per (stream, kv-head) for a (batch, width, kv_heads)
    cache on a card of ``sm_count`` SMs.

    Each block keeps enough bytes in flight that a block or two per SM
    already hold device memory busy, and a split costs a second launch
    and a workspace pass; so one split when the batch * kv_heads blocks
    cover the SMs one and a half times (in the pool a dead stream's
    blocks exit at once, so fewer leave SMs idle).  Below that, each
    block's serial chain of stages sets the time: then enough splits for
    two blocks an SM, but none of fewer than ``MIN_SPLIT_KEYS`` keys of
    the ring.  Shapes and the SM count only: never the positions or the
    mask, so the plan needs no host sync.  ``scripts/flash_decode_ab.py
    --sweep`` times every split count on the card.
    """
    blocks = batch * kv_heads
    if 2 * blocks >= 3 * sm_count:
        return 1
    want = -(-2 * sm_count // blocks)
    return max(1, min(want, width // MIN_SPLIT_KEYS))


def _split_args(q: torch.Tensor, kv: int, w: int):
    """(splits, workspace, its pointer) of a call: fp32 scratch of
    B * H * S * (D + 2) floats when S > 1, none when S = 1."""
    b, h, d = q.shape
    splits = plan_splits(b, kv, w, torch.cuda.get_device_properties(
        q.device).multi_processor_count)
    if splits == 1:
        return 1, None, 0
    ws = torch.empty(b * h * splits * (d + 2), dtype=torch.float32,
                     device=q.device)
    return splits, ws, ws.data_ptr()


def _check(name: str, q: torch.Tensor, k_cache: torch.Tensor,
           v_cache: torch.Tensor, kv_scale: float):
    """(dtype code, cache dtype code, k cache, v cache) of a decode call,
    the caches contiguous; raises on what the kernel does not take."""
    code = dtype_code(name, q.dtype, (torch.float32, torch.bfloat16))
    b, h, d = q.shape
    kv = k_cache.shape[2]
    if v_cache.shape != k_cache.shape or v_cache.dtype != k_cache.dtype:
        raise ValueError(f"{name} needs k and v caches of one shape and "
                         "dtype")
    if k_cache.shape[0] != b or k_cache.shape[3] != d or h % kv:
        raise ValueError(f"q {tuple(q.shape)} does not match the cache "
                         f"{tuple(k_cache.shape)} (GQA needs H % KV == 0)")
    if d not in HEAD_DIMS:
        raise ValueError(f"{name} takes head_dim in {HEAD_DIMS}, got {d}")
    if (k_cache.dtype == torch.int8) != (kv_scale > 0.0):
        raise ValueError("int8 caches need kv_scale > 0 and only they take "
                         "one")
    if k_cache.dtype not in (q.dtype, torch.int8):
        raise TypeError(f"cache dtype {k_cache.dtype} with q {q.dtype}")
    cache_code = dtype_code(name, k_cache.dtype,
                            (torch.float32, torch.bfloat16, torch.int8))
    # the kernel copies the caches in 16-byte chunks (a row is a multiple
    # of 16 bytes), so each must start on a 16-byte boundary: a contiguous
    # view at an odd storage offset would fault on the card
    k_cache, v_cache = k_cache.contiguous(), v_cache.contiguous()
    if k_cache.data_ptr() % 16 or v_cache.data_ptr() % 16:
        raise ValueError(f"{name} needs caches whose data start 16-byte "
                         "aligned; got a view at an unaligned offset")
    return code, cache_code, k_cache, v_cache


def _outputs(q: torch.Tensor, return_lse: bool):
    """(out, lse) of a call: out in q's dtype, or with the block form fp32
    beside a (B, H) fp32 lse; lse None without it."""
    if not return_lse:
        return torch.empty_like(q), None
    return (torch.empty(q.shape, dtype=torch.float32, device=q.device),
            torch.empty(q.shape[:2], dtype=torch.float32, device=q.device))


def flash_decode(q: torch.Tensor, k_cache: torch.Tensor,
                 v_cache: torch.Tensor, kv_mask: torch.Tensor, *,
                 softcap: float = 0.0, kv_scale: float = 0.0,
                 return_lse: bool = False):
    """q: (B, H, D); caches: (B, W, KV, D); kv_mask: (B, W) -> (B, H, D).

    ``kv_scale > 0`` marks int8 caches quantised as round(x * kv_scale).
    A mask whose rows are one broadcast row (stride 0) is read as is.
    ``return_lse``: the block form, (out fp32, lse (B, H) fp32).
    """
    device = require_cuda("flash_decode", q, k_cache, v_cache, kv_mask)
    code, cache_code, k_cache, v_cache = _check(
        "flash_decode", q, k_cache, v_cache, kv_scale)
    b, h, d = q.shape
    w, kv = k_cache.shape[1], k_cache.shape[2]
    if kv_mask.shape != (b, w):
        raise ValueError(f"kv_mask {tuple(kv_mask.shape)} != {(b, w)}")
    mask = kv_mask.to(torch.uint8)
    if mask.stride(1) != 1 or (mask.stride(0) != 0 and mask.stride(0) != w):
        mask = mask.contiguous()
    q = q.contiguous()
    out, lse = _outputs(q, return_lse)
    if out.numel() and w:
        splits, ws, ws_ptr = _split_args(q, kv, w)
        KERNEL.launch(device, q.data_ptr(), k_cache.data_ptr(),
                      v_cache.data_ptr(), mask.data_ptr(), mask.stride(0),
                      out.data_ptr(), b, w, h, kv, d, softcap,
                      1.0 / d ** 0.5, kv_scale, code, cache_code, splits,
                      ws_ptr, 0 if lse is None else lse.data_ptr())
    return out if lse is None else (out, lse)


def pool_flash_decode(q: torch.Tensor, k_cache: torch.Tensor,
                      v_cache: torch.Tensor, pos: torch.Tensor,
                      live: Optional[torch.Tensor] = None, *,
                      softcap: float = 0.0, kv_scale: float = 0.0,
                      slot0: int = 0, return_lse: bool = False):
    """q: (B, H, D); caches: (B, W, KV, D); pos: (B,) integer ring
    positions on the card; live: optional (B,) mask (None: all live)
    -> (B, H, D).

    Stream b attends over ring slots kvpos <= pos[b] (and < W); a stream
    with live[b] == 0 gives exact zeros.  ``pos`` and ``live`` stay on the
    card: the kernel reads them, so no host sync is needed.
    ``return_lse``: the block form over ring slots [slot0, slot0 + W),
    (out fp32, lse (B, H) fp32).
    """
    tensors = (q, k_cache, v_cache, pos) + (() if live is None else (live,))
    device = require_cuda("pool_flash_decode", *tensors)
    code, cache_code, k_cache, v_cache = _check(
        "pool_flash_decode", q, k_cache, v_cache, kv_scale)
    b, h, d = q.shape
    w, kv = k_cache.shape[1], k_cache.shape[2]
    if pos.shape != (b,) or (live is not None and live.shape != (b,)):
        raise ValueError(f"pos {tuple(pos.shape)} and live "
                         f"{None if live is None else tuple(live.shape)} "
                         f"must be ({b},)")
    pos = pos.to(torch.int32).contiguous()
    live_ptr = 0
    if live is not None:
        # the kernel reads one byte per stream (0 = dead): a bool or uint8
        # mask is passed as it is, anything else is converted
        if live.dtype not in (torch.bool, torch.uint8):
            live = live > 0
        live = live.contiguous()
        live_ptr = live.data_ptr()
    q = q.contiguous()
    out, lse = _outputs(q, return_lse)
    if out.numel() and w:
        splits, ws, ws_ptr = _split_args(q, kv, w)
        POOL_KERNEL.launch(device, q.data_ptr(), k_cache.data_ptr(),
                           v_cache.data_ptr(), pos.data_ptr(), live_ptr,
                           slot0, out.data_ptr(), b, w, h, kv, d, softcap,
                           1.0 / d ** 0.5, kv_scale, code, cache_code,
                           splits, ws_ptr,
                           0 if lse is None else lse.data_ptr())
    return out if lse is None else (out, lse)
