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

Where the model axis does not divide the kv-heads, the reference keeps
them whole on every rank and splits the cache length over the axis
instead (``launch.shardings.cache_rules``): a rank's cache is then a
``RingBlock`` of the ring's slots, or, where the axis does not divide
the ring width either, the whole ring (``resolve_spec`` replicates it).
A rank computes k and v for every kv-head and attends with its own
q-heads in prefill; in decode it gathers every rank's q-heads, runs the
block form of B4/B5 over its slots and the ranks merge their partial
softmaxes (``partitioning.ModelGroup.merge_ring_blocks``).
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
    """q, k and v with RoPE (and qk-norm).  On a model-axis rank's block
    of the q-heads, ``x`` and each leaf that the rank holds whole but
    uses for its heads only (q_norm, k_norm, and wk / wv where the axis
    does not divide the kv-heads) enter through ``ModelGroup.enter``, so
    that their gradients are summed over the axis."""
    wk, wv = p["wk"], p["wv"]
    q_norm, k_norm = p.get("q_norm"), p.get("k_norm")
    if p["wq"].shape[1] < cfg.num_heads:
        group = partitioning.model_group()
        x = group.enter(x)
        if wk.shape[1] == cfg.num_kv_heads:
            wk, wv = group.enter(wk), group.enter(wv)
        if cfg.qk_norm:
            q_norm, k_norm = group.enter(q_norm), group.enter(k_norm)
    q = _project(x, p["wq"])
    k = _project(x, wk)
    v = _project(x, wv)
    if cfg.qk_norm:
        q = layers.rms_norm_head(q, q_norm, cfg.norm_eps)
        k = layers.rms_norm_head(k, k_norm, cfg.norm_eps)
    q = layers.apply_rope(cfg, q, positions)
    k = layers.apply_rope(cfg, k, positions)
    return q, k, v


def _q_block(cfg: ModelConfig, q_heads: int, kv_heads: int) -> bool:
    """Whether a model-axis rank holds a block of the q-heads against
    every kv-head (the axis divides the q-heads, not the kv-heads)."""
    return q_heads < cfg.num_heads and kv_heads == cfg.num_kv_heads


def _kv_of_q_block(cfg: ModelConfig, q_heads: int, k, v):
    """The kv-heads a model-axis rank's block of ``q_heads`` q-heads
    reads, from k and v (B, L, KV, D) of every kv-head: one kv-head
    gathered a q-head, so B3 runs at rep 1 whether or not the block starts
    and ends on a kv-head boundary."""
    rep = cfg.num_heads // cfg.num_kv_heads
    h0 = partitioning.model_group().rank * q_heads
    idx = torch.tensor([(h0 + i) // rep for i in range(q_heads)],
                       device=k.device)
    return k.index_select(2, idx), v.index_select(2, idx)


def _attend(cfg: ModelConfig, q, k, v) -> torch.Tensor:
    """The sequence's attention under the config's visibility rules; a
    rank's block of the q-heads against every kv-head reads the kv-heads
    of its q-heads."""
    if _q_block(cfg, q.shape[2], k.shape[2]):
        k, v = _kv_of_q_block(cfg, q.shape[2], k, v)
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


class RingBlock(dict):
    """A run's {"k", "v"} caches that hold a model-axis rank's block of
    the ring slots: rank r of M holds slots [r W / M, (r + 1) W / M) of a
    W-slot ring, for every kv-head (the reference's cache-length split,
    ``kv_seq`` over "model").  A plain dict holds the whole ring."""


def _ring_block(cfg: ModelConfig, cache: dict) -> Tuple[int, int]:
    """(ring slot of the cache's first slot, ring width): (0, W) for a
    whole ring, (r W / M, W) for a ``RingBlock`` of W / M slots.  Raises
    for a plain dict that the cache rules would have split (every
    kv-head of a ring whose width the model axis divides, where it does
    not divide the kv-heads): the layout is in the type alone, and such
    a dict would be read as a whole ring."""
    w, kv = cache["k"].shape[1:3]
    if isinstance(cache, RingBlock):
        group = partitioning.model_group()
        return group.rank * w, group.size * w
    model = partitioning.axis_size("model")
    if model > 1 and kv == cfg.num_kv_heads and kv % model \
            and w % model == 0:
        raise ValueError(
            f"a cache of every kv-head over {w} ring slots on a {model}-way "
            f"model axis must be an attention.RingBlock of its rank's slots "
            f"(the cache rules split its length); got a {type(cache).__name__}")
    return 0, w


def init_kv_cache(cfg: ModelConfig, batch: int, max_len: int, dtype,
                  device, layers_in_run: int, model: int = 1) -> dict:
    """Zeroed (layers, B, W, KV, D) caches of one run of layers, laid out
    on a ``model``-way model axis as the reference's cache rules and
    ``resolve_spec`` lay out the whole cache: a rank's block of the
    kv-heads where the axis divides them, else a ``RingBlock`` of W /
    ``model`` ring slots where it divides the ring width, else the whole
    ring."""
    w = cache_width(cfg, max_len)
    kv = cfg.num_kv_heads
    split = model > 1 and kv % model != 0 and w % model == 0
    if kv % model == 0:
        kv //= model
    elif split:
        w //= model
    shape = (layers_in_run, batch, w, kv, cfg.head_dim)
    store = torch.int8 if cfg.kv_cache_dtype == "int8" else dtype
    cache = {"k": torch.zeros(shape, dtype=store, device=device),
             "v": torch.zeros(shape, dtype=store, device=device)}
    return RingBlock(cache) if split else cache


def kv_cache_axes() -> dict:
    # "kv_seq" is separately mappable: where kv_heads does not divide the
    # model axis the reference's launcher shards the cache length instead
    # (``launch.shardings.cache_rules``, ``RingBlock``)
    return {"k": ("batch", "kv_seq", "kv_heads", "head_dim"),
            "v": ("batch", "kv_seq", "kv_heads", "head_dim")}


def attention_prefill(cfg: ModelConfig, p: dict, x: torch.Tensor,
                      positions: torch.Tensor, cache: dict
                      ) -> Tuple[torch.Tensor, dict]:
    """Prefill: full attention AND populate the layer's (ring) KV cache,
    written in place.  With s >= W only the last W keys are kept, at ring
    slot pos % W; a ``RingBlock`` keeps those whose slot lies in its
    block."""
    q, k, v = _qkv(cfg, p, x, positions)
    out = _attend(cfg, q, k, v)
    w = cache["k"].shape[1]
    s = k.shape[1]
    kq = quantize_kv(k, cache["k"].dtype)
    vq = quantize_kv(v, cache["v"].dtype)
    slot0, ring = _ring_block(cfg, cache)
    if isinstance(cache, RingBlock):
        pos = torch.arange(max(0, s - ring), s)
        slot = pos % ring - slot0
        keep = (slot >= 0) & (slot < w)
        pos, slot = pos[keep].to(k.device), slot[keep].to(k.device)
        cache["k"][:, slot] = kq[:, pos]
        cache["v"][:, slot] = vq[:, pos]
    elif s >= w:
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
    them on the host; ``live`` is ignored with a shared position.

    A ``RingBlock`` takes the new key only on the rank that holds slot
    pos % W (in the pool a masked write by each stream's position), and
    attends with every rank's q-heads over its block (the block form);
    the ranks then merge their partial softmaxes.  A rank with a block
    of the q-heads and the whole ring of every kv-head attends with
    every rank's q-heads and keeps its own."""
    w = cache["k"].shape[1]
    slot0, ring = _ring_block(cfg, cache)
    split = isinstance(cache, RingBlock)
    kv_scale = INT8_KV_SCALE if cache["k"].dtype == torch.int8 else 0.0
    if isinstance(pos, torch.Tensor):
        q, k, v = _qkv(cfg, p, x, pos[:, None])
        rows = torch.arange(x.shape[0], device=x.device)
        slot = torch.remainder(pos, ring).long() - slot0
        new_k = quantize_kv(k[:, 0], cache["k"].dtype)
        new_v = quantize_kv(v[:, 0], cache["v"].dtype)
        if split:
            # the streams whose slot lies in another rank's block rewrite
            # what they read here
            mine = ((slot >= 0) & (slot < w))[:, None, None]
            slot = slot.clamp(0, w - 1)
            new_k = torch.where(mine, new_k, cache["k"][rows, slot])
            new_v = torch.where(mine, new_v, cache["v"][rows, slot])
        cache["k"][rows, slot] = new_k
        cache["v"][rows, slot] = new_v

        def attend(qa, **kw):
            return ops.pool_decode_attention(
                qa, cache["k"], cache["v"], pos, live,
                softcap=cfg.attn_logit_softcap, kv_scale=kv_scale,
                slot0=slot0, **kw)
    else:
        if not isinstance(pos, int):
            raise TypeError(f"pos must be an int or a (B,) tensor, got "
                            f"{type(pos).__name__}")
        positions = torch.full((1,), pos, dtype=torch.int32,
                               device=x.device)
        q, k, v = _qkv(cfg, p, x, positions)
        slot = pos % ring - slot0
        if 0 <= slot < w:
            cache["k"][:, slot] = quantize_kv(k[:, 0], cache["k"].dtype)
            cache["v"][:, slot] = quantize_kv(v[:, 0], cache["v"].dtype)
        # one (1, W) row broadcast over the batch (stride 0, never copied)
        valid = (torch.arange(slot0, slot0 + w, device=x.device)
                 <= pos).to(torch.uint8)
        valid = valid[None, :].expand(x.shape[0], w)

        def attend(qa, **kw):
            return ops.decode_attention(
                qa, cache["k"], cache["v"], valid,
                softcap=cfg.attn_logit_softcap, kv_scale=kv_scale, **kw)
    q = q[:, 0]
    q_heads = q.shape[1]
    gather = _q_block(cfg, q_heads, cache["k"].shape[2])
    if not (split or gather):
        return _out_project(cfg, attend(q), p["wo"])[:, None], cache
    group = partitioning.model_group()
    qa = group.all_gather(q, 1) if gather else q
    if split:
        out, lse = attend(qa, return_lse=True)
        out = group.merge_ring_blocks(out, lse, gather).to(q.dtype)
    else:
        out = attend(qa).narrow(1, group.rank * q_heads, q_heads)
    return _out_project(cfg, out, p["wo"])[:, None], cache
