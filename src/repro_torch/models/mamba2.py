"""Mamba2 (SSD, state-space duality) block (port of
``repro.models.mamba2``).

Prefill runs the chunked SSD scan through ``ops.ssd`` (the CUDA kernel
on the card); decode is the O(1) recurrent state update ``ops.ssd_step``,
plain PyTorch on every device as in the reference.  Each coded stream
carries its own SSM cache: the last K-1 raw (pre-conv) inputs of the
depthwise conv, in the cache dtype, and the (H, P, N) fp32 state.  As
for attention, the port writes the caller's cache buffers in place where
the reference returns new ones.

On a model axis that divides the SSM heads a rank computes its block of
the heads (``ssm_block_layout``): its heads' z, x and dt columns of
``in_proj`` and B and C whole (one group), its heads' conv channels
behind B and C's, its block of the gated norm and ``out_proj``'s rows.
The reference's spec of ``in_proj`` cuts contiguous blocks across the
z / x / B / C / dt segments, so the rank's layout lies beneath that
spec: ``launch.shardings`` gives the S leaves a
``partitioning.IndexSpec`` of it.  The block input enters the rank's
work through ``ModelGroup.enter`` for the heads' columns only; B and C,
computed whole on every rank, enter after the conv, as do the per-head
vectors before they are sliced, so that each gradient is summed over
the axis once.  The gated norm's statistic is over all of din: its sums
of squares are all-reduced both ways (``enter`` of an ``all_reduce``),
and ``out_proj``'s partial sums are all-reduced.  Where the axis does
not divide the heads every rank runs the whole block on whole leaves,
with no collective.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models import layers, partitioning
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


# The leaves of an "S" block (and of its caches) that a model-axis rank
# holds in the head-aligned layout: name -> (dimension of the leaf, less
# the run's layer axis; the ``ssm_block_layout`` key along it)
PARAM_LAYOUT = {"in_proj": (1, "in_proj"), "conv_w": (1, "conv"),
                "conv_b": (0, "conv"), "gate_norm": (0, "inner"),
                "out_proj": (0, "inner")}
CACHE_LAYOUT = {"conv": (2, "conv"), "state": (1, "heads")}


def ssm_block_layout(cfg: ModelConfig, model: int, rank: int
                     ) -> Optional[dict]:
    """The layout of rank ``rank``'s block of an "S" block on a
    ``model``-way model axis: {key: [(start, length), ...]}, the pieces of
    the whole leaf's dimension that the rank's block joins in order:
    - "heads": its block of the H / M heads (``a_log``, ``d_skip``,
      ``dt_bias``, the state cache);
    - "inner": their din / M channels (``gate_norm``, ``out_proj``'s rows);
    - "in_proj": [z_r | x_r | B | C | dt_r] of the [z | x | B | C | dt]
      columns, B and C whole on every rank;
    - "conv": [x_r | B | C] of the conv's [x | B | C] channels (``conv_w``,
      ``conv_b``, the conv cache).
    None at one rank, and where the axis does not divide the heads: each
    rank then holds every S leaf and cache whole and runs the whole
    block."""
    h = cfg.ssm_heads
    if model <= 1 or h % model:
        return None
    din, n = cfg.ssm_d_inner, cfg.ssm_state
    hr = h // model
    dr = hr * cfg.ssm_head_dim
    h0, i0 = rank * hr, rank * dr
    return {"heads": [(h0, hr)], "inner": [(i0, dr)],
            "in_proj": [(i0, dr), (din + i0, dr), (2 * din, 2 * n),
                        (2 * din + 2 * n + h0, hr)],
            "conv": [(i0, dr), (din, 2 * n)]}


def layout_index(pieces) -> torch.Tensor:
    """A layout's pieces as one int64 index of the whole dimension."""
    return torch.cat([torch.arange(s, s + n) for s, n in pieces])


def head_spec(cfg: ModelConfig, model: int, name: str, spec: tuple,
              cache: bool = False) -> tuple:
    """The spec of a run's S leaf ``name`` (a parameter, or with
    ``cache`` a cache; the run's layer axis first) as a rank of a
    ``model``-way model axis holds it: an ``IndexSpec`` of its
    ``ssm_block_layout`` pieces where the axis divides the heads and the
    reference's spec splits the leaf (a cache always: the rank computes
    its channels alone), whole where the axis does not divide the heads
    (whatever the spec says), else the spec itself (a parameter the
    spec leaves whole: the rank slices its heads at use)."""
    table = CACHE_LAYOUT if cache else PARAM_LAYOUT
    if model <= 1 or name not in table:
        return spec
    dim, key = table[name]
    dim += 1
    layouts = [ssm_block_layout(cfg, model, r) for r in range(model)]
    if layouts[0] is None:
        return (partitioning.IndexSpec(spec, dim, None)
                if spec[dim] is not None else spec)
    if spec[dim] is None and not cache:
        return spec
    return partitioning.IndexSpec(spec, dim, [layout_index(lay[key])
                                              for lay in layouts])


def _split_proj(cfg: ModelConfig, proj: torch.Tensor):
    din, n = cfg.ssm_d_inner, cfg.ssm_state
    return (proj[..., :din], proj[..., din:2 * din + 2 * n],
            proj[..., 2 * din + 2 * n:])


def _head_group(cfg: ModelConfig):
    """The active mesh's model group where its axis divides the heads
    (the block runs at a rank's heads), else None (the whole block)."""
    if ssm_block_layout(cfg, partitioning.axis_size("model"), 0) is None:
        return None
    return partitioning.model_group()


def _pieces(leaf: torch.Tensor, dim: int, pieces) -> torch.Tensor:
    out = [leaf.narrow(dim, s, n) for s, n in pieces]
    return out[0] if len(out) == 1 else torch.cat(out, dim)


def _rank_params(cfg: ModelConfig, p: dict, group) -> dict:
    """The rank's block of the layer's parameters, whatever it holds:
    "zx" (d, 2 din_r) and "dt" (d, H_r), its heads' ``in_proj`` columns;
    "bc" (d, 2n); "conv_w" / "conv_b" over [x_r | B | C]; its heads'
    ``a_log``, ``d_skip``, ``dt_bias``; its ``gate_norm`` and ``out_proj``
    rows.  A leaf held whole (the per-head vectors; ``in_proj`` and the
    conv where the spec leaves them so) enters through
    ``ModelGroup.enter`` before its heads' part is sliced, B and C's
    columns and channels excepted: their gradient is the whole one
    already (``_ssd_inputs``)."""
    din, n = cfg.ssm_d_inner, cfg.ssm_state
    lay = ssm_block_layout(cfg, group.size, group.rank)
    dr = lay["inner"][0][1]
    w = p["in_proj"]
    if w.shape[1] < 2 * din + 2 * n + cfg.ssm_heads:       # its block
        zx, bc, dt = w[:, :2 * dr], w[:, 2 * dr:2 * dr + 2 * n], \
            w[:, 2 * dr + 2 * n:]
    else:
        we = group.enter(w)
        zx = _pieces(we, 1, lay["in_proj"][:2])
        bc, dt = w[:, 2 * din:2 * din + 2 * n], \
            _pieces(we, 1, lay["in_proj"][3:])
    out = {"zx": zx, "bc": bc, "dt": dt}
    for name, dim in (("conv_w", 1), ("conv_b", 0)):
        leaf = p[name]
        if leaf.shape[dim] < din + 2 * n:
            out[name] = leaf
        else:
            out[name] = torch.cat([_pieces(group.enter(leaf), dim,
                                           lay["conv"][:1]),
                                   leaf.narrow(dim, din, 2 * n)], dim)
    for name in ("a_log", "d_skip", "dt_bias"):
        out[name] = _pieces(group.enter(p[name]), 0, lay["heads"])
    # din / M: the spec splits them wherever the axis divides the heads
    out["gate_norm"], out["out_proj"] = p["gate_norm"], p["out_proj"]
    return out


def _in_proj(cfg: ModelConfig, p: dict, x: torch.Tensor, group):
    """z, the raw conv input [x | B | C] and raw dt of ``x`` (..., d): the
    whole block's, or on ``group`` the rank's heads' (``p`` its
    ``_rank_params``), where ``x`` enters the heads' columns alone."""
    if group is None:
        return _split_proj(cfg, x @ p["in_proj"])
    xe = group.enter(x)
    zx = xe @ p["zx"]
    dr = zx.shape[-1] // 2
    return (zx[..., :dr], torch.cat([zx[..., dr:], x @ p["bc"]], -1),
            xe @ p["dt"])


def _gated_out(cfg: ModelConfig, p: dict, y: torch.Tensor,
               z: torch.Tensor, group=None) -> torch.Tensor:
    """Gated RMSNorm (in fp32) then the output projection; y, z: (...,
    din), or on ``group`` the rank's din_r: the mean square is over all of
    din (the ranks' sums of squares, all-reduced, with their gradient
    all-reduced too) and the projection a partial sum, all-reduced."""
    gf = (y * F.silu(z)).to(torch.float32)
    if group is None:
        ms = gf.square().mean(-1, keepdim=True)
    else:
        ms = group.enter(group.all_reduce(
            gf.square().sum(-1, keepdim=True))) / cfg.ssm_d_inner
    g = (gf * torch.rsqrt(ms + cfg.norm_eps)).to(y.dtype) * p["gate_norm"]
    out = g @ p["out_proj"]
    return out if group is None else group.all_reduce(out)


def _ssd_inputs(cfg: ModelConfig, p: dict, xbc: torch.Tensor,
                dt: torch.Tensor, group=None):
    """Conv output (..., din + 2n), or the rank's (..., din_r + 2n), and
    raw dt -> per-head x (..., H, P) and the b, c views of it, and
    softplus'd fp32 dt.  On ``group`` B and C enter the rank's heads
    through ``ModelGroup.enter``: each rank's scan gives its heads' share
    of their gradient."""
    n = cfg.ssm_state
    di = xbc.shape[-1] - 2 * n
    xs = xbc[..., :di].unflatten(-1, (di // cfg.ssm_head_dim,
                                      cfg.ssm_head_dim))
    bc = xbc[..., di:]
    if group is not None:
        bc = group.enter(bc)
    dt = F.softplus(dt.to(torch.float32) + p["dt_bias"])
    return xs, bc[..., :n], bc[..., n:], dt


def ssd_chunk(chunk: int, s: int) -> int:
    """The plain scan's chunk for S steps: min(chunk, S), halved until it
    divides S.  The CUDA kernel tiles S its own way and ignores it."""
    q = min(chunk, s)
    while s % q:
        q //= 2
    return q


def mamba2_forward(cfg: ModelConfig, p: dict, x: torch.Tensor):
    """Full-sequence path from a zero state; returns (y (B, S, d), the
    last K-1 raw conv inputs, h_final fp32): on a model axis that divides
    the heads the rank's channels [x_r | B | C] and heads of the last
    two."""
    bsz, s, _ = x.shape
    group = _head_group(cfg)
    if group is not None:
        p = _rank_params(cfg, p, group)
    z, xbc, dt = _in_proj(cfg, p, x, group)
    # depthwise causal conv over (x, B, C), zero-padded on the left
    k = cfg.ssm_conv
    xbc_pad = torch.cat([xbc.new_zeros((bsz, k - 1, xbc.shape[-1])), xbc], 1)
    conv = sum(xbc_pad[:, i:i + s] * p["conv_w"][i] for i in range(k))
    xs, b, c, dt = _ssd_inputs(cfg, p, F.silu(conv + p["conv_b"]), dt,
                               group)
    y, h_final = ops.ssd(xs, dt, p["a_log"], b, c, p["d_skip"],
                         chunk=ssd_chunk(cfg.ssm_chunk, s))
    out = _gated_out(cfg, p, y.reshape(bsz, s, -1), z, group)
    return out, xbc_pad[:, -(k - 1):], h_final


def mamba2_block(cfg: ModelConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    """Full-sequence SSD (forward and training): no state returned."""
    return mamba2_forward(cfg, p, x)[0]


def ssm_cache_axes() -> dict:
    return {"conv": ("batch", "conv", "ffn"),
            "state": ("batch", "ffn", None, "state")}


def init_ssm_cache(cfg: ModelConfig, batch: int, dtype, device,
                   layers_in_run: int, model: int = 1) -> dict:
    """Zeroed SSM caches of one run of layers: conv (layers, B, K-1,
    din + 2n) in ``dtype`` and state (layers, B, H, P, N) in fp32; on a
    ``model``-way model axis that divides the heads a rank's (din / M +
    2n channels, H / M heads: ``ssm_block_layout``)."""
    heads = cfg.ssm_heads
    if ssm_block_layout(cfg, model, 0) is not None:
        heads //= model
    conv_dim = heads * cfg.ssm_head_dim + 2 * cfg.ssm_state
    return {
        "conv": torch.zeros((layers_in_run, batch, cfg.ssm_conv - 1,
                             conv_dim), dtype=dtype, device=device),
        "state": torch.zeros((layers_in_run, batch, heads,
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
    group = _head_group(cfg)
    if group is not None:
        p = _rank_params(cfg, p, group)
    z, xbc_t, dt = _in_proj(cfg, p, x[:, 0], group)
    # conv window: the cached K-1 raw inputs and the current one
    window = torch.cat([cache["conv"],
                        xbc_t[:, None].to(cache["conv"].dtype)], 1)
    xbc = F.silu(torch.einsum("bkc,kc->bc", window, p["conv_w"])
                 + p["conv_b"])
    cache["conv"].copy_(window[:, 1:])
    x_t, b_t, c_t, dt_t = _ssd_inputs(cfg, p, xbc, dt, group)
    y_t, h_new = ops.ssd_step(cache["state"], x_t, dt_t, p["a_log"], b_t,
                              c_t, p["d_skip"])
    cache["state"].copy_(h_new)
    y = y_t.reshape(bsz, 1, -1)
    return _gated_out(cfg, p, y, z[:, None], group), cache
