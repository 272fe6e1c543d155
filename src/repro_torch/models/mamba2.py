"""Mamba2 (SSD, state-space duality) block (port of
``repro.models.mamba2``).

Prefill runs the chunked SSD scan through ``ops.ssd`` (the CUDA kernel
on the card); decode is the O(1) recurrent state update ``ops.ssd_step``,
plain PyTorch on every device as in the reference.  Each coded stream
carries its own SSM cache: the last K-1 raw (pre-conv) inputs of the
depthwise conv, in the cache dtype, and the (H, P, N) fp32 state.  As
for attention, the port writes the caller's cache buffers in place where
the reference returns new ones.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models import layers
from repro_torch.models.config import ModelConfig


def mamba2_axes(cfg: ModelConfig) -> dict:
    return {
        "in_proj": ("fsdp", "ffn"), "conv_w": ("conv", "ffn"),
        "conv_b": ("ffn",), "a_log": (None,), "d_skip": (None,),
        "dt_bias": (None,), "gate_norm": ("ffn",),
        "out_proj": ("ffn", "fsdp"),
    }


def init_mamba2(cfg: ModelConfig, gen: torch.Generator, dtype,
                device) -> dict:
    d, din, n, h = cfg.d_model, cfg.ssm_d_inner, cfg.ssm_state, cfg.ssm_heads
    conv_dim = din + 2 * n
    f32 = torch.float32
    # in_proj emits [z (din), x (din), B (n), C (n), dt (h)]
    return {
        "in_proj": layers.dense_init(gen, d, 2 * din + 2 * n + h, dtype,
                                     device),
        "conv_w": layers.trunc_normal(gen, (cfg.ssm_conv, conv_dim),
                                      cfg.ssm_conv ** -0.5, dtype, device),
        "conv_b": torch.zeros((conv_dim,), dtype=dtype, device=device),
        "a_log": torch.log(torch.linspace(1.0, 16.0, h, dtype=f32,
                                          device=device)),
        "d_skip": torch.ones((h,), dtype=f32, device=device),
        "dt_bias": torch.zeros((h,), dtype=f32, device=device),
        "gate_norm": torch.ones((din,), dtype=dtype, device=device),
        "out_proj": layers.dense_init(gen, din, d, dtype, device,
                                      1.0 / (2 * cfg.num_layers) ** 0.5),
    }


def _split_proj(cfg: ModelConfig, proj: torch.Tensor):
    din, n = cfg.ssm_d_inner, cfg.ssm_state
    return (proj[..., :din], proj[..., din:2 * din + 2 * n],
            proj[..., 2 * din + 2 * n:])


def _gated_out(cfg: ModelConfig, p: dict, y: torch.Tensor,
               z: torch.Tensor) -> torch.Tensor:
    """Gated RMSNorm (in fp32) then the output projection; y, z: (..., din)."""
    gf = (y * F.silu(z)).to(torch.float32)
    ms = gf.square().mean(-1, keepdim=True)
    g = (gf * torch.rsqrt(ms + cfg.norm_eps)).to(y.dtype) * p["gate_norm"]
    return g @ p["out_proj"]


def _ssd_inputs(cfg: ModelConfig, p: dict, xbc: torch.Tensor,
                dt: torch.Tensor):
    """Conv output (..., din + 2n) and raw dt -> per-head x (..., H, P)
    and the b, c views of it, and softplus'd fp32 dt."""
    din, n = cfg.ssm_d_inner, cfg.ssm_state
    xs = xbc[..., :din].unflatten(-1, (cfg.ssm_heads, cfg.ssm_head_dim))
    dt = F.softplus(dt.to(torch.float32) + p["dt_bias"])
    return xs, xbc[..., din:din + n], xbc[..., din + n:], dt


def ssd_chunk(chunk: int, s: int) -> int:
    """The plain scan's chunk for S steps: min(chunk, S), halved until it
    divides S.  The CUDA kernel tiles S its own way and ignores it."""
    q = min(chunk, s)
    while s % q:
        q //= 2
    return q


def mamba2_forward(cfg: ModelConfig, p: dict, x: torch.Tensor):
    """Full-sequence path from a zero state; returns (y (B, S, d), the
    last K-1 raw conv inputs, h_final fp32)."""
    bsz, s, _ = x.shape
    z, xbc, dt = _split_proj(cfg, x @ p["in_proj"])
    # depthwise causal conv over (x, B, C), zero-padded on the left
    k = cfg.ssm_conv
    xbc_pad = torch.cat([xbc.new_zeros((bsz, k - 1, xbc.shape[-1])), xbc], 1)
    conv = sum(xbc_pad[:, i:i + s] * p["conv_w"][i] for i in range(k))
    xs, b, c, dt = _ssd_inputs(cfg, p, F.silu(conv + p["conv_b"]), dt)
    y, h_final = ops.ssd(xs, dt, p["a_log"], b, c, p["d_skip"],
                         chunk=ssd_chunk(cfg.ssm_chunk, s))
    out = _gated_out(cfg, p, y.reshape(bsz, s, cfg.ssm_d_inner), z)
    return out, xbc_pad[:, -(k - 1):], h_final


def mamba2_block(cfg: ModelConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    """Full-sequence SSD (forward and training): no state returned."""
    return mamba2_forward(cfg, p, x)[0]


def ssm_cache_axes() -> dict:
    return {"conv": ("batch", "conv", "ffn"),
            "state": ("batch", "ffn", None, "state")}


def init_ssm_cache(cfg: ModelConfig, batch: int, dtype, device,
                   layers_in_run: int) -> dict:
    """Zeroed SSM caches of one run of layers: conv (layers, B, K-1,
    din + 2n) in ``dtype`` and state (layers, B, H, P, N) in fp32."""
    conv_dim = cfg.ssm_d_inner + 2 * cfg.ssm_state
    return {
        "conv": torch.zeros((layers_in_run, batch, cfg.ssm_conv - 1,
                             conv_dim), dtype=dtype, device=device),
        "state": torch.zeros((layers_in_run, batch, cfg.ssm_heads,
                              cfg.ssm_head_dim, cfg.ssm_state),
                             dtype=torch.float32, device=device),
    }


def mamba2_prefill(cfg: ModelConfig, p: dict, x: torch.Tensor,
                   cache: dict):
    """Prefill from a zero state; writes the layer's conv window and
    state into ``cache`` in place."""
    y, conv_tail, h_final = mamba2_forward(cfg, p, x)
    cache["conv"].copy_(conv_tail)
    cache["state"].copy_(h_final)
    return y, cache


def mamba2_decode(cfg: ModelConfig, p: dict, x: torch.Tensor, cache: dict):
    """One recurrent step, x (B, 1, d); updates ``cache`` in place."""
    bsz = x.shape[0]
    z, xbc_t, dt = _split_proj(cfg, x[:, 0] @ p["in_proj"])
    # conv window: the cached K-1 raw inputs and the current one
    window = torch.cat([cache["conv"],
                        xbc_t[:, None].to(cache["conv"].dtype)], 1)
    xbc = F.silu(torch.einsum("bkc,kc->bc", window, p["conv_w"])
                 + p["conv_b"])
    cache["conv"].copy_(window[:, 1:])
    x_t, b_t, c_t, dt_t = _ssd_inputs(cfg, p, xbc, dt)
    y_t, h_new = ops.ssd_step(cache["state"], x_t, dt_t, p["a_log"], b_t,
                              c_t, p["d_skip"])
    cache["state"].copy_(h_new)
    y = y_t.reshape(bsz, 1, cfg.ssm_d_inner)
    return _gated_out(cfg, p, y, z[:, None]), cache
