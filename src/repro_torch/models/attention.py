"""Attention blocks with RoPE, qk-norm, GQA, sliding window, prefix-LM and
softcap, plus the ring KV cache (port of ``repro.models.attention``).

Ported: ``_qkv``, the full-sequence ``attention_block`` (no cache),
``attention_prefill`` with its ring-cache population, and both branches
of ``attention_decode``: one position shared by every stream (a Python
int), or per-stream positions (a (B,) int tensor on the device, the
slot-pool decode).  JAX returns fresh caches; the port writes
the caller's cache buffers in place, where the reference's serving
executors donate them.  Head counts come from the parameters and caches
(a model-axis rank holds its block of the q- and kv-heads), and the
output projection's partial sums are all-reduced over the model axis.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import ops
from repro_torch.models import layers, partitioning
from repro_torch.models.config import ModelConfig

INT8_KV_SCALE = 32.0   # static symmetric scale of int8 KV caches


def attention_axes(cfg: ModelConfig) -> dict:
    ax = {
        "wq": ("fsdp", "heads", "head_dim"),
        "wk": ("fsdp", "kv_heads", "head_dim"),
        "wv": ("fsdp", "kv_heads", "head_dim"),
        "wo": ("heads", "head_dim", "fsdp"),
    }
    if cfg.qk_norm:
        ax["q_norm"] = ("head_dim",)
        ax["k_norm"] = ("head_dim",)
    return ax


def init_attention(cfg: ModelConfig, gen: torch.Generator, dtype,
                   device) -> dict:
    h, kv, hd, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, cfg.d_model
    p = {
        "wq": layers.trunc_normal(gen, (d, h, hd), d ** -0.5, dtype, device),
        "wk": layers.trunc_normal(gen, (d, kv, hd), d ** -0.5, dtype, device),
        "wv": layers.trunc_normal(gen, (d, kv, hd), d ** -0.5, dtype, device),
        "wo": layers.trunc_normal(
            gen, (h, hd, d), (h * hd) ** -0.5 / (2 * cfg.num_layers) ** 0.5,
            dtype, device),
    }
    if cfg.qk_norm:
        p["q_norm"] = torch.ones((hd,), dtype=dtype, device=device)
        p["k_norm"] = torch.ones((hd,), dtype=dtype, device=device)
    return p


def _project(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("bsd,dhk->bshk") as one (B*S, d) @ (d, h*k) product."""
    return (x @ w.reshape(w.shape[0], -1)).reshape(
        *x.shape[:-1], w.shape[1], w.shape[2])


def _out_project(cfg: ModelConfig, o: torch.Tensor,
                 wo: torch.Tensor) -> torch.Tensor:
    """einsum("...hk,hkd->...d") as one product over the flattened heads;
    with a model-axis rank's block of the heads (``wo``'s leading axis
    short of ``cfg.num_heads``) a partial sum, all-reduced over the
    axis."""
    out = o.reshape(*o.shape[:-2], -1) @ wo.reshape(-1, wo.shape[-1])
    if wo.shape[0] == cfg.num_heads:
        return out
    return partitioning.model_group().all_reduce(out)


def _qkv(cfg: ModelConfig, p: dict, x: torch.Tensor,
         positions: torch.Tensor):
    q = _project(x, p["wq"])
    k = _project(x, p["wk"])
    v = _project(x, p["wv"])
    if cfg.qk_norm:
        q = layers.rms_norm_head(q, p["q_norm"], cfg.norm_eps)
        k = layers.rms_norm_head(k, p["k_norm"], cfg.norm_eps)
    q = layers.apply_rope(cfg, q, positions)
    k = layers.apply_rope(cfg, k, positions)
    return q, k, v


def _attend(cfg: ModelConfig, q, k, v) -> torch.Tensor:
    """The sequence's attention under the config's visibility rules."""
    return ops.attention(
        q, k, v, causal=cfg.causal, window=cfg.sliding_window,
        prefix=cfg.num_patches if cfg.prefix_lm else 0,
        softcap=cfg.attn_logit_softcap)


def attention_block(cfg: ModelConfig, p: dict, x: torch.Tensor,
                    positions: torch.Tensor) -> torch.Tensor:
    """Full-sequence attention (forward and training): no cache."""
    q, k, v = _qkv(cfg, p, x, positions)
    return _out_project(cfg, _attend(cfg, q, k, v), p["wo"])


# --------------------------------------------------------------- KV caching

def cache_width(cfg: ModelConfig, max_len: int) -> int:
    """Ring-buffer width: the SWA window bounds the live KV footprint."""
    if cfg.sliding_window is not None:
        return min(max_len, cfg.sliding_window)
    return max_len


def quantize_kv(x: torch.Tensor, store_dtype) -> torch.Tensor:
    if store_dtype == torch.int8:
        return torch.clamp(torch.round(x.to(torch.float32) * INT8_KV_SCALE),
                           -127, 127).to(torch.int8)
    return x.to(store_dtype)


def init_kv_cache(cfg: ModelConfig, batch: int, max_len: int, dtype,
                  device, layers_in_run: int,
                  kv_heads: Optional[int] = None) -> dict:
    """Zeroed (layers, B, W, KV, D) caches of one run of layers; KV is
    ``kv_heads``, a model-axis rank's block of them (default all)."""
    w = cache_width(cfg, max_len)
    shape = (layers_in_run, batch, w, kv_heads or cfg.num_kv_heads,
             cfg.head_dim)
    store = torch.int8 if cfg.kv_cache_dtype == "int8" else dtype
    return {"k": torch.zeros(shape, dtype=store, device=device),
            "v": torch.zeros(shape, dtype=store, device=device)}


def kv_cache_axes() -> dict:
    # "kv_seq" is separately mappable: where kv_heads does not divide the
    # model axis the reference's launcher shards the cache length instead
    # (``launch.shardings.cache_rules``; the port refuses that case, A9.4)
    return {"k": ("batch", "kv_seq", "kv_heads", "head_dim"),
            "v": ("batch", "kv_seq", "kv_heads", "head_dim")}


def attention_prefill(cfg: ModelConfig, p: dict, x: torch.Tensor,
                      positions: torch.Tensor, cache: dict
                      ) -> Tuple[torch.Tensor, dict]:
    """Prefill: full attention AND populate the layer's (ring) KV cache,
    written in place.  With s >= W only the last W keys are kept, at ring
    slot pos % W."""
    q, k, v = _qkv(cfg, p, x, positions)
    out = _attend(cfg, q, k, v)
    w = cache["k"].shape[1]
    s = k.shape[1]
    kq = quantize_kv(k, cache["k"].dtype)
    vq = quantize_kv(v, cache["v"].dtype)
    if s >= w:
        slots = torch.arange(s - w, s, device=k.device) % w
        cache["k"][:, slots] = kq[:, s - w:]
        cache["v"][:, slots] = vq[:, s - w:]
    else:
        cache["k"][:, :s] = kq
        cache["v"][:, :s] = vq
    return _out_project(cfg, out, p["wo"]), cache


def attention_decode(cfg: ModelConfig, p: dict, x: torch.Tensor, pos,
                     cache: dict, live: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, dict]:
    """One-token decode: x (B, 1, d).  ``pos`` is a Python int shared by
    every stream, or a (B,) int tensor of per-stream positions on x's
    device (slot-pool continuous batching, DESIGN.md §10).  Writes the
    new KV at slot pos % W in place and attends over the slots at depth
    <= pos.  The per-stream branch hands the positions, and the optional
    (B,) ``live`` mask, to ``ops.pool_decode_attention`` without reading
    them on the host; ``live`` is ignored with a shared position."""
    w = cache["k"].shape[1]
    kv_scale = INT8_KV_SCALE if cache["k"].dtype == torch.int8 else 0.0
    if isinstance(pos, torch.Tensor):
        q, k, v = _qkv(cfg, p, x, pos[:, None])
        rows = torch.arange(x.shape[0], device=x.device)
        slot = torch.remainder(pos, w).long()
        cache["k"][rows, slot] = quantize_kv(k[:, 0], cache["k"].dtype)
        cache["v"][rows, slot] = quantize_kv(v[:, 0], cache["v"].dtype)
        out = ops.pool_decode_attention(q[:, 0], cache["k"], cache["v"], pos,
                                        live,
                                        softcap=cfg.attn_logit_softcap,
                                        kv_scale=kv_scale)
        return _out_project(cfg, out, p["wo"])[:, None], cache
    if not isinstance(pos, int):
        raise TypeError(f"pos must be an int or a (B,) tensor, got "
                        f"{type(pos).__name__}")
    positions = torch.full((1,), pos, dtype=torch.int32, device=x.device)
    q, k, v = _qkv(cfg, p, x, positions)
    slot = pos % w
    cache["k"][:, slot] = quantize_kv(k[:, 0], cache["k"].dtype)
    cache["v"][:, slot] = quantize_kv(v[:, 0], cache["v"].dtype)
    # one (1, W) row broadcast over the batch (stride 0, never copied)
    valid = (torch.arange(w, device=x.device) <= pos).to(torch.uint8)
    valid = valid[None, :].expand(x.shape[0], w)
    out = ops.decode_attention(q[:, 0], cache["k"], cache["v"], valid,
                               softcap=cfg.attn_logit_softcap,
                               kv_scale=kv_scale)
    return _out_project(cfg, out, p["wo"])[:, None], cache
