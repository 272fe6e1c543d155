"""Kernel dispatch of the port, by the device of the tensor.

A CUDA tensor goes to the hand-written CUDA kernel, which launches or
raises; a CPU tensor goes to the plain PyTorch version in ``ref.py``.
Nothing else selects the path: no environment variable, no global
switch, no fallback from a failed kernel to the plain version.  This
takes the place of the reference's ``KernelType`` dispatch
(``repro.kernels.ops``).

Gradients: on the card, prefill attention runs under autograd as
``flash_attention.FlashAttentionFn`` (B3 forward, then its backward
kernel) and the SSD scan as ``ssd_scan.SsdFn`` (B7 forward, then its
backward kernels) whenever grad is enabled and an input requires it.
Every other kernel has no backward, so on the card it raises in that
case rather than hand autograd an output with no history.  On the CPU
the plain versions are differentiated by autograd as they are.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import (berrut_decode, berrut_matmul,
                                 flash_attention, flash_decode, ref,
                                 ssd_scan)

# The kernels of the coded serving rounds, batch and slot pool, and B3's
# and B7's backward (training), by name.
KERNELS = {
    "berrut_apply": berrut_matmul.KERNEL,
    "berrut_encode_dispatch": berrut_matmul.DISPATCH_KERNEL,
    "fused_group_decode": berrut_decode.KERNEL,
    "flash_attention": flash_attention.KERNEL,
    "flash_attention_bwd": flash_attention.BWD_KERNEL,
    "flash_decode": flash_decode.KERNEL,
    "pool_flash_decode": flash_decode.POOL_KERNEL,
    "ssd_chunked": ssd_scan.KERNEL,
    "ssd_chunk_scores": ssd_scan.SCORES_KERNEL,
    "ssd_chunked_bwd": ssd_scan.BWD_KERNEL,
    "ssd_bwd_head_sum": ssd_scan.HEAD_SUM_KERNEL,
}


def launch_counts() -> dict:
    """{kernel name: launches so far} for the kernels above."""
    return {name: k.launches for name, k in KERNELS.items()}


def reset_launch_counts() -> None:
    for k in KERNELS.values():
        k.launches = 0


def _on_card(x: torch.Tensor) -> bool:
    if x.device.type == "cuda":
        return True
    if x.device.type == "cpu":
        return False
    raise ValueError(f"no kernel or plain path for device {x.device}")


def _needs_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


# the ROADMAP entry of each kernel that has no backward: queue B's serving
# kernels, which no training path reaches, and B7's scores pass alone
# (``ssd`` differentiates the whole scan)
_NO_BACKWARD = "B: a serving kernel, which no training path reaches"
_SCORES_ALONE = "B7: the scores pass alone; ops.ssd differentiates the scan"


def _refuse_grad(name: str, item: str, *tensors) -> None:
    """On the card: raise if autograd would have to differentiate kernel
    ``name``, which has no backward kernel."""
    if _needs_grad(*tensors):
        raise RuntimeError(
            f"{name} has no backward kernel on the card (ROADMAP {item}); "
            f"call it under torch.no_grad() or on tensors that do not "
            f"require grad")


def berrut_apply(weights: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """(O, I) @ (..., I, F) -> (..., O, F), fp32 accumulation."""
    if _on_card(x):
        _refuse_grad("berrut_apply", _NO_BACKWARD, weights, x)
        return berrut_matmul.berrut_apply(weights, x)
    return ref.berrut_apply_ref(weights, x)


def berrut_encode_dispatch(weights: torch.Tensor,
                           x: torch.Tensor) -> torch.Tensor:
    """(O, I) @ (G, I, F) -> (O*G, F) coded streams in the worker-major
    ``o*G + g`` row order, fp32 accumulation; ``weights`` may be a row
    slice of the encode matrix."""
    if _on_card(x):
        _refuse_grad("berrut_encode_dispatch", _NO_BACKWARD, weights, x)
        return berrut_matmul.berrut_encode_dispatch(weights, x)
    return ref.berrut_encode_dispatch_ref(weights, x)


def fused_group_decode(grouped: torch.Tensor, masks: torch.Tensor,
                       alphas: torch.Tensor, betas: torch.Tensor, *,
                       c_vote: int = 0):
    """Coded-round tail: per-group decode matrices from the masks fused
    with the (G, N+1, V) -> (G, K, V) contraction (plus the strided vote
    columns when ``c_vote > 0``).  masks: (N+1,) or (G, N+1).  ``grouped``
    may be a strided view (a transposed worker-major block): the kernel
    reads it in place, its vocabulary axis with unit stride, and raises
    on any other."""
    if _on_card(grouped):
        _refuse_grad("fused_group_decode", _NO_BACKWARD, grouped, masks,
                     alphas, betas)
        return berrut_decode.fused_group_decode(grouped, masks, alphas, betas,
                                                c_vote=c_vote)
    return ref.fused_group_decode_ref(grouped, masks, alphas, betas,
                                      c_vote=c_vote)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: Optional[int] = None,
              prefix: int = 0, softcap: float = 0.0,
              q_offset: int = 0) -> torch.Tensor:
    """Prefill attention: q (B, S, H, D), k and v (B, L, KV, D).  On the
    card, under autograd when grad is enabled and an input requires it
    (B3 forward and its backward kernel)."""
    if _on_card(q):
        if _needs_grad(q, k, v):
            return flash_attention.FlashAttentionFn.apply(
                q, k, v, causal, window, prefix, softcap, q_offset)
        return flash_attention.flash_attention(
            q, k, v, causal=causal, window=window, prefix=prefix,
            softcap=softcap, q_offset=q_offset)
    return ref.attention_ref(q, k, v, causal=causal, window=window,
                             prefix=prefix, softcap=softcap,
                             q_offset=q_offset)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, kv_mask: torch.Tensor, *,
                     softcap: float = 0.0,
                     kv_scale: float = 0.0) -> torch.Tensor:
    """Decode attention over a (B, W, KV, D) ring cache with a (B, W)
    mask.  kv_scale > 0 marks int8 caches quantised as round(x*scale):
    the kernel dequantises in registers, the plain path up front."""
    if _on_card(q):
        _refuse_grad("flash_decode", _NO_BACKWARD, q, k_cache, v_cache)
        return flash_decode.flash_decode(q, k_cache, v_cache, kv_mask,
                                         softcap=softcap, kv_scale=kv_scale)
    if kv_scale > 0.0:
        k_cache = k_cache.to(torch.float32) / kv_scale
        v_cache = v_cache.to(torch.float32) / kv_scale
    return ref.decode_attention_ref(q, k_cache.to(q.dtype),
                                    v_cache.to(q.dtype), kv_mask,
                                    softcap=softcap)


def pool_decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                          v_cache: torch.Tensor, pos: torch.Tensor,
                          live: Optional[torch.Tensor] = None, *,
                          softcap: float = 0.0,
                          kv_scale: float = 0.0) -> torch.Tensor:
    """Slot-pool decode attention: per-stream (B,) ring positions and an
    optional (B,) live mask instead of a (B, W) mask.  A stream that sees
    no key (live 0) gives exact zeros on both paths."""
    if _on_card(q):
        _refuse_grad("pool_flash_decode", _NO_BACKWARD, q, k_cache, v_cache)
        return flash_decode.pool_flash_decode(
            q, k_cache, v_cache, pos, live, softcap=softcap,
            kv_scale=kv_scale)
    return ref.pool_decode_attention_ref(q, k_cache, v_cache, pos, live,
                                         softcap=softcap, kv_scale=kv_scale)


def ssd(x: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor,
        b: torch.Tensor, c: torch.Tensor, d_skip: torch.Tensor,
        h0: Optional[torch.Tensor] = None, chunk: int = 128):
    """Mamba2 chunked SSD scan: x (B, S, H, P), dt (B, S, H), b and c
    (B, S, N), a_log and d_skip (H,), optional h0 (B, H, P, N).  Returns
    (y in x's dtype, h_final fp32).  ``chunk`` is the plain version's
    chunk; the kernel tiles S its own way, which the chunked algebra
    allows.  On the card, under autograd when grad is enabled and an
    input requires it (B7 forward and its backward kernels)."""
    if _on_card(x):
        if _needs_grad(x, dt, a_log, b, c, d_skip, h0):
            return ssd_scan.SsdFn.apply(x, dt, a_log, b, c, d_skip, h0)
        return ssd_scan.ssd_chunked(x, dt, a_log, b, c, d_skip, h0=h0)
    return ref.ssd_chunked_ref(x, dt, a_log, b, c, d_skip, h0=h0, chunk=chunk)


def ssd_chunk_scores(b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """The SSD scan's scores pass: C B^T within each of the kernel's
    chunks, (B, S, N) -> (B, ceil(S / CHUNK), CHUNK, CHUNK) fp32."""
    if _on_card(b):
        _refuse_grad("ssd_chunk_scores", _SCORES_ALONE, b, c)
        return ssd_scan.ssd_chunk_scores(b, c)
    return ref.ssd_chunk_scores_ref(b, c, ssd_scan.CHUNK)


def ssd_step(h: torch.Tensor, x_t: torch.Tensor, dt_t: torch.Tensor,
             a_log: torch.Tensor, b_t: torch.Tensor, c_t: torch.Tensor,
             d_skip: torch.Tensor):
    """Single-token SSD state update, plain PyTorch on every device as in
    the reference (elementwise work and one small contraction)."""
    return ref.ssd_step_ref(h, x_t, dt_t, a_log, b_t, c_t, d_skip)
