"""Plain PyTorch versions of the port's kernels (counterpart of
``repro.kernels.ref``).

These are the CPU path of ``kernels.ops`` and what ``chip_smoke.py``
holds each CUDA kernel against on the card.  Each repeats its kernel's
arithmetic in fp32 with plain tensor ops; none is a yardstick of speed.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import berrut
from repro_torch.core.error_locator import gather_vote_values

NEG_INF = -1e30


def berrut_apply_ref(weights: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Coded encode/decode contraction: (O, I) @ (..., I, F) -> (..., O, F)
    with fp32 accumulation, output in x's dtype."""
    return torch.einsum("oi,...if->...of", weights.to(torch.float32),
                        x.to(torch.float32)).to(x.dtype)


def berrut_encode_dispatch_ref(weights: torch.Tensor,
                               x: torch.Tensor) -> torch.Tensor:
    """Encode into the worker-major stream layout: (O, I) @ (G, I, F) ->
    (O*G, F), row ``o*G + g``; ``berrut_apply_ref`` followed by the
    swap and reshape."""
    coded = berrut_apply_ref(weights, x)                  # (G, O, F)
    return coded.transpose(0, 1).reshape(-1, x.shape[-1])


def fused_group_decode_ref(grouped: torch.Tensor, masks: torch.Tensor,
                           alphas: torch.Tensor, betas: torch.Tensor, *,
                           c_vote: int = 0):
    """(G, N+1, V) coded block + masks -> (G, K, V) decoded logits via the
    survivor-weight Berrut decode matrix of each group's mask; with
    ``c_vote > 0`` also the (G, N+1, C) float32 vote-coordinate gather,
    read from the raw block before the upcast.

    masks: (N+1,) shared availability or (G, N+1) per-group masks.
    """
    if masks.dim() == 1:
        masks = masks.expand(grouped.shape[0], masks.shape[0])
    mats = torch.stack([
        berrut.basis_matrix(alphas, betas, berrut.survivor_weights(m),
                            mask=m) for m in masks])       # (G, K, N+1)
    decoded = (mats @ grouped.to(torch.float32)).to(grouped.dtype)
    if c_vote <= 0:
        return decoded
    return decoded, gather_vote_values(grouped, c_vote)


def _mask_bias(q_len: int, kv_len: int, *, causal: bool,
               window: Optional[int], prefix: int, q_offset: int,
               device) -> torch.Tensor:
    """(q_len, kv_len) boolean visibility of causal/SWA/prefix-LM rules."""
    qpos = torch.arange(q_len, device=device)[:, None] + q_offset
    kpos = torch.arange(kv_len, device=device)[None, :]
    allowed = torch.ones((q_len, kv_len), dtype=torch.bool, device=device)
    if causal:
        allowed = kpos <= qpos
        if prefix > 0:  # prefix-LM: bidirectional over the first ``prefix``
            allowed = allowed | (kpos < prefix)
    if window is not None:
        allowed = allowed & (kpos > qpos - window)
    return allowed


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: Optional[int] = None,
                  prefix: int = 0, softcap: float = 0.0,
                  q_offset: int = 0) -> torch.Tensor:
    """Full (prefill) attention with GQA.

    q: (B, S, H, D); k, v: (B, L, KV, D) with H % KV == 0; q-head h reads
    kv-head h // (H // KV).
    """
    b, s, h, d = q.shape
    kv = k.shape[2]
    rep = h // kv
    qf = q.to(torch.float32) / torch.sqrt(torch.tensor(float(d)))
    qg = qf.reshape(b, s, kv, rep, d)
    scores = torch.einsum("bsgrd,blgd->bgrsl", qg, k.to(torch.float32))
    if softcap > 0.0:
        scores = softcap * torch.tanh(scores / softcap)
    allowed = _mask_bias(s, k.shape[1], causal=causal, window=window,
                         prefix=prefix, q_offset=q_offset, device=q.device)
    scores = scores + torch.where(allowed, 0.0, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bgrsl,blgd->bsgrd", probs, v.to(torch.float32))
    return out.reshape(b, s, h, d).to(q.dtype)


def _scaled_scores(q: torch.Tensor, k: torch.Tensor, softcap: float):
    """(raw, c): fp32 (B, KV, rep, S, L) scores q k^T / sqrt(D), and the
    same softcapped (``c`` is ``raw`` without a softcap)."""
    b, s, h, d = q.shape
    kv = k.shape[2]
    qg = q.to(torch.float32).reshape(b, s, kv, h // kv, d)
    raw = torch.einsum("bsgrd,blgd->bgrsl", qg,
                       k.to(torch.float32)) * (1.0 / d ** 0.5)
    if softcap > 0.0:
        return raw, softcap * torch.tanh(raw / softcap)
    return raw, raw


def attention_lse_ref(q: torch.Tensor, k: torch.Tensor, *,
                      causal: bool = True, window: Optional[int] = None,
                      prefix: int = 0, softcap: float = 0.0,
                      q_offset: int = 0) -> torch.Tensor:
    """The rows' log-sum-exp that B3 writes for its backward: (B, H, S)
    fp32, natural log over the keys the rule lets each row see, in the
    scaled and softcapped score space; -inf for a row that sees no key."""
    b, s, h, _ = q.shape
    _, c = _scaled_scores(q, k, softcap)
    allowed = _mask_bias(s, k.shape[1], causal=causal, window=window,
                         prefix=prefix, q_offset=q_offset, device=q.device)
    c = torch.where(allowed, c, float("-inf"))
    return torch.logsumexp(c, dim=-1).reshape(b, h, s)


def attention_bwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                      *, causal: bool = True, window: Optional[int] = None,
                      prefix: int = 0, softcap: float = 0.0,
                      q_offset: int = 0):
    """The gradient B3's backward kernel computes, written out: (dq, dk,
    dv) in q's, k's and v's dtype from the forward's output ``o``, its
    log-sum-exp ``lse`` (B, H, S) and the output gradient ``do``.

    P = exp(c - lse) on the visible pairs (0 elsewhere), dP = dO v^T,
    Delta = rowsum(dO * o), dC = P (dP - Delta), dS = dC (1 - (c/cap)^2)
    with a softcap; dq = dS k / sqrt(D), dk = dS^T q / sqrt(D), dv = P^T
    dO.  A row that sees no key gets dq = 0 and adds nothing to dk or dv
    (B3's output for it is 0; ``attention_ref``'s is a uniform mean)."""
    b, s, h, d = q.shape
    kv = k.shape[2]
    rep = h // kv
    _, c = _scaled_scores(q, k, softcap)
    allowed = _mask_bias(s, k.shape[1], causal=causal, window=window,
                         prefix=prefix, q_offset=q_offset, device=q.device)
    lse_g = lse.to(torch.float32).reshape(b, kv, rep, s)[..., None]
    p = torch.where(allowed, torch.exp(c - lse_g), 0.0)
    dof = do.to(torch.float32).reshape(b, s, kv, rep, d)
    dp = torch.einsum("bsgrd,blgd->bgrsl", dof, v.to(torch.float32))
    delta = (dof * o.to(torch.float32).reshape(b, s, kv, rep, d)).sum(-1)
    ds = p * (dp - delta.permute(0, 2, 3, 1)[..., None])
    if softcap > 0.0:
        ds = ds * (1.0 - (c / softcap) ** 2)
    scale = 1.0 / d ** 0.5
    qg = q.to(torch.float32).reshape(b, s, kv, rep, d)
    dq = torch.einsum("bgrsl,blgd->bsgrd", ds, k.to(torch.float32)) * scale
    dk = torch.einsum("bgrsl,bsgrd->blgd", ds, qg) * scale
    dv = torch.einsum("bgrsl,bsgrd->blgd", p, dof)
    return (dq.reshape(b, s, h, d).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def decode_attention_ref(q: torch.Tensor, k_cache: torch.Tensor,
                         v_cache: torch.Tensor, kv_mask: torch.Tensor, *,
                         softcap: float = 0.0) -> torch.Tensor:
    """Single-token decode attention against a (ring-buffer) KV cache.

    q: (B, H, D); caches: (B, W, KV, D); kv_mask: (B, W) validity.
    """
    b, h, d = q.shape
    kv = k_cache.shape[2]
    rep = h // kv
    qf = q.to(torch.float32) / torch.sqrt(torch.tensor(float(d)))
    qg = qf.reshape(b, kv, rep, d)
    scores = torch.einsum("bgrd,bwgd->bgrw", qg, k_cache.to(torch.float32))
    if softcap > 0.0:
        scores = softcap * torch.tanh(scores / softcap)
    scores = torch.where(kv_mask.bool()[:, None, None, :], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bgrw,bwgd->bgrd", probs, v_cache.to(torch.float32))
    return out.reshape(b, h, d).to(q.dtype)


def pool_decode_attention_ref(q: torch.Tensor, k_cache: torch.Tensor,
                              v_cache: torch.Tensor, pos: torch.Tensor,
                              live: Optional[torch.Tensor] = None, *,
                              softcap: float = 0.0,
                              kv_scale: float = 0.0) -> torch.Tensor:
    """Slot-pool decode attention: per-stream ring positions instead of a
    (B, W) mask.

    Stream b sees the ring slots kvpos <= pos[b] (and < W), and none when
    ``live[b] == 0``; a stream that sees no key returns exact zeros, as
    the kernel does (the softmax normaliser stays 0 and the output is
    0 / max(0, 1e-30)).  ``kv_scale > 0`` dequantises int8 caches in fp32.

    q: (B, H, D); caches: (B, W, KV, D); pos: (B,) int; live: (B,).
    """
    b, h, d = q.shape
    w, kv = k_cache.shape[1], k_cache.shape[2]
    rep = h // kv
    kf, vf = k_cache.to(torch.float32), v_cache.to(torch.float32)
    if kv_scale > 0.0:
        kf, vf = kf / kv_scale, vf / kv_scale
    qg = q.to(torch.float32).reshape(b, kv, rep, d) * (1.0 / d ** 0.5)
    scores = torch.einsum("bgrd,bwgd->bgrw", qg, kf)
    if softcap > 0.0:
        scores = softcap * torch.tanh(scores / softcap)
    ok = torch.arange(w, device=q.device)[None, :] <= pos[:, None]
    if live is not None:
        ok = ok & (live > 0)[:, None]
    ok = ok[:, None, None, :]                                # (B,1,1,W)
    scores = torch.where(ok, scores, NEG_INF)
    m = scores.amax(-1, keepdim=True)
    m_safe = torch.where(m <= NEG_INF, 0.0, m)
    p = torch.where(ok, torch.exp(scores - m_safe), 0.0)
    out = torch.einsum("bgrw,bwgd->bgrd", p, vf)
    out = out / p.sum(-1, keepdim=True).clamp_min(1e-30)
    return out.reshape(b, h, d).to(q.dtype)


# ---------------------------------------------------------------- Mamba2 SSD

def ssd_scan_ref(x: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor,
                 b: torch.Tensor, c: torch.Tensor, d_skip: torch.Tensor,
                 h0: Optional[torch.Tensor] = None):
    """Sequential (exact) SSD recurrence, the oracle of the chunked form.

    x: (B, S, H, P) inputs per head; dt: (B, S, H) softplus'd step
    sizes; a_log: (H,) log of -A (A = -exp(a_log)); b, c: (B, S, N)
    input / output projections (one group, broadcast over heads);
    d_skip: (H,); h0: (B, H, P, N) initial state.  Returns
    (y (B, S, H, P) in x's dtype, h_final (B, H, P, N) fp32).
    """
    bsz, s, h, p = x.shape
    n = b.shape[-1]
    dtf = dt.to(torch.float32)
    decay = torch.exp(-torch.exp(a_log.to(torch.float32))[None, None, :]
                      * dtf)                               # (B, S, H)
    xbar = x.to(torch.float32) * dtf[..., None]
    bf, cf = b.to(torch.float32), c.to(torch.float32)
    state = (torch.zeros((bsz, h, p, n), dtype=torch.float32,
                         device=x.device) if h0 is None
             else h0.to(torch.float32))
    ys = []
    for t in range(s):
        state = state * decay[:, t, :, None, None] + torch.einsum(
            "bhp,bn->bhpn", xbar[:, t], bf[:, t])
        ys.append(torch.einsum("bhpn,bn->bhp", state, cf[:, t]))
    y = torch.stack(ys, 1) + x.to(torch.float32) \
        * d_skip.to(torch.float32)[None, None, :, None]
    return y.to(x.dtype), state


def ssd_chunked_ref(x: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor,
                    b: torch.Tensor, c: torch.Tensor, d_skip: torch.Tensor,
                    h0: Optional[torch.Tensor] = None, chunk: int = 128):
    """Chunked (matmul-form) SSD, the algorithm of ``ssd_chunked``; the
    plain version of the CUDA kernel.  Shapes as ``ssd_scan_ref``;
    ``min(chunk, S)`` must divide S.

    Per chunk of Q steps with L the in-chunk cumulative log decay:
    y_t = sum_{tau <= t} (c_t . b_tau) exp(L_t - L_tau) dt_tau x_tau
    + exp(L_t) c_t . h_in + D x_t, and h_out = exp(L_Q) h_in
    + sum_tau exp(L_Q - L_tau) dt_tau x_tau b_tau^T.  The upper triangle
    is masked to -1e30 before exp (its gaps are positive and overflow).
    """
    bsz, s, h, p = x.shape
    n = b.shape[-1]
    q = min(chunk, s)
    if s % q:
        raise ValueError(f"seq {s} not divisible by chunk {q}")
    nc = s // q
    dtf = dt.to(torch.float32)
    la = -torch.exp(a_log.to(torch.float32))[None, None, :] * dtf
    xbar = x.to(torch.float32) * dtf[..., None]

    la_c = la.reshape(bsz, nc, q, h)
    xb_c = xbar.reshape(bsz, nc, q, h, p)
    b_c = b.to(torch.float32).reshape(bsz, nc, q, n)
    c_c = c.to(torch.float32).reshape(bsz, nc, q, n)

    lcum = torch.cumsum(la_c, dim=2)                        # (B,NC,Q,H)
    ltot = lcum[:, :, -1]                                   # (B,NC,H)

    gap = lcum[:, :, :, None, :] - lcum[:, :, None, :, :]   # (B,NC,Q,Q,H)
    tri = torch.tril(torch.ones((q, q), dtype=torch.bool, device=x.device))
    att = torch.einsum("bcqn,bctn->bcqt", c_c, b_c)[..., None] * torch.exp(
        torch.where(tri[None, None, :, :, None], gap, NEG_INF))
    y_intra = torch.einsum("bcqth,bcthp->bcqhp", att, xb_c)

    decay_to_end = torch.exp(ltot[:, :, None, :] - lcum)    # (B,NC,Q,H)
    s_chunk = torch.einsum("bcqn,bcqh,bcqhp->bchpn", b_c, decay_to_end,
                           xb_c)
    state = (torch.zeros((bsz, h, p, n), dtype=torch.float32,
                         device=x.device) if h0 is None
             else h0.to(torch.float32))
    h_ins = []
    for ci in range(nc):
        h_ins.append(state)
        state = state * torch.exp(ltot[:, ci])[:, :, None, None] \
            + s_chunk[:, ci]
    h_in = torch.stack(h_ins, 1)                            # (B,NC,H,P,N)

    y_inter = torch.einsum("bcqn,bchpn->bcqhp", c_c, h_in) \
        * torch.exp(lcum)[..., None]
    y = (y_intra + y_inter).reshape(bsz, s, h, p) + x.to(torch.float32) \
        * d_skip.to(torch.float32)[None, None, :, None]
    return y.to(x.dtype), state


def ssd_chunked_bwd_ref(x: torch.Tensor, dt: torch.Tensor,
                        a_log: torch.Tensor, b: torch.Tensor,
                        c: torch.Tensor, d_skip: torch.Tensor,
                        dy: torch.Tensor, h0: Optional[torch.Tensor] = None,
                        dh_final: Optional[torch.Tensor] = None,
                        chunk: int = 128):
    """The gradient B7's backward kernel computes, written out: (dx, ddt,
    da_log, db, dc, dd, dh0) of ``ssd_chunked_ref`` given the output
    gradient ``dy`` (B, S, H, P) and an optional ``dh_final`` (B, H, P,
    N); each in its input's dtype, dh0 None without h0.  Shapes and
    ``chunk`` as ``ssd_chunked_ref``.

    Per chunk, with A[t, tau] = (c_t . b_tau) exp(L_t - L_tau) (tau <= t)
    and the state gradients dH_out walked over the chunks in reverse from
    dh_final: dH_in = exp(L_Q) dH_out + sum_t exp(L_t) dy_t c_t^T;
    d xbar_tau = sum_t A[t, tau] dy_t + exp(L_Q - L_tau) dH_out b_tau;
    dc_t and db_tau from dG[t, tau] = exp(L_t - L_tau) (dy_t . xbar_tau)
    summed over heads, plus exp(L_t) H_in^T dy_t and exp(L_Q - L_tau)
    dH_out^T xbar_tau; d la_t summed from the terms whose decay spans
    step t (the scores' pairs r >= t > c, the inter-chunk terms at and
    after t, the state's inputs before t and exp(L_Q) <dH_out, H_in>),
    then ddt += a d la, da_log = sum d la * la.
    """
    bsz, s, h, p = x.shape
    n = b.shape[-1]
    q = min(chunk, s)
    if s % q:
        raise ValueError(f"seq {s} not divisible by chunk {q}")
    nc = s // q
    f32 = torch.float32
    dtf = dt.to(f32)
    a = -torch.exp(a_log.to(f32))
    la = a[None, None, :] * dtf                             # (B,S,H)
    xf, dyf = x.to(f32), dy.to(f32)
    xb_c = (xf * dtf[..., None]).reshape(bsz, nc, q, h, p)
    dy_c = dyf.reshape(bsz, nc, q, h, p)
    b_c = b.to(f32).reshape(bsz, nc, q, n)
    c_c = c.to(f32).reshape(bsz, nc, q, n)

    lcum = torch.cumsum(la.reshape(bsz, nc, q, h), dim=2)   # (B,NC,Q,H)
    ltot = lcum[:, :, -1]                                   # (B,NC,H)
    e_t = torch.exp(lcum)                                   # exp(L_t)
    w_tau = torch.exp(ltot[:, :, None, :] - lcum)           # exp(L_Q - L_tau)
    tri = torch.tril(torch.ones((q, q), dtype=torch.bool, device=x.device))
    gap = lcum[:, :, :, None, :] - lcum[:, :, None, :, :]   # (B,NC,Q,Q,H)
    decay = torch.exp(torch.where(tri[None, None, :, :, None], gap,
                                  NEG_INF))                 # 0 for tau > t
    att = torch.einsum("bcqn,bctn->bcqt", c_c, b_c)[..., None] * decay

    # each chunk's entry state, then the state gradients in reverse
    s_chunk = torch.einsum("bcqn,bcqh,bcqhp->bchpn", b_c, w_tau, xb_c)
    state = (torch.zeros((bsz, h, p, n), dtype=f32, device=x.device)
             if h0 is None else h0.to(f32))
    h_ins = []
    for ci in range(nc):
        h_ins.append(state)
        state = state * torch.exp(ltot[:, ci])[:, :, None, None] \
            + s_chunk[:, ci]
    h_in = torch.stack(h_ins, 1)                            # (B,NC,H,P,N)
    k_c = torch.einsum("bcqh,bcqhp,bcqn->bchpn", e_t, dy_c, c_c)
    dstate = (torch.zeros((bsz, h, p, n), dtype=f32, device=x.device)
              if dh_final is None else dh_final.to(f32))
    dh_outs = [None] * nc
    for ci in reversed(range(nc)):
        dh_outs[ci] = dstate
        dstate = dstate * torch.exp(ltot[:, ci])[:, :, None, None] \
            + k_c[:, ci]
    dh_out = torch.stack(dh_outs, 1)                        # (B,NC,H,P,N)

    d_att = torch.einsum("bcqhp,bcthp->bcqth", dy_c, xb_c)  # dy_t . xbar_tau
    u = torch.einsum("bchpn,bctn->bcthp", dh_out, b_c)      # dH_out b_tau
    dxb = torch.einsum("bcqth,bcqhp->bcthp", att, dy_c) \
        + w_tau[..., None] * u
    dxb = dxb.reshape(bsz, s, h, p)
    dx = dxb * dtf[..., None] + dyf * d_skip.to(f32)[None, None, :, None]
    ddt = (xf * dxb).sum(-1)
    dd = (xf * dyf).sum((0, 1, 3))
    dg = (decay * d_att).sum(-1)                            # over heads
    dc = torch.einsum("bcqt,bctn->bcqn", dg, b_c) + torch.einsum(
        "bcqh,bchpn,bcqhp->bcqn", e_t, h_in, dy_c)
    db = torch.einsum("bcqt,bcqn->bctn", dg, c_c) + torch.einsum(
        "bcth,bchpn,bcthp->bctn", w_tau, dh_out, xb_c)

    # d la_t from the terms whose decay spans step t (exp(L_r - L_c)
    # depends on la_t when c < t <= r): the inter-chunk terms at and after
    # t, the state's, the state's inputs before t, and the scores' pairs
    # r >= t > c.  The reverse cumulative sum of dL would add each decay's
    # +/- pair apart, and under strong decay their cancellation loses the
    # small terms.
    inter = e_t * torch.einsum("bcqhp,bchpn,bcqn->bcqh", dy_c, h_in, c_c)
    st = w_tau * (xb_c * u).sum(-1)
    pm = att * d_att                                        # (B,NC,r,c,H)
    left = torch.cat([torch.zeros_like(pm[:, :, :, :1]),
                      torch.cumsum(pm, 3)[:, :, :, :-1]], 3)  # sum_{c < t}
    quad = (left * tri[None, None, :, :, None]).sum(2)      # sum_{r >= t}
    st_before = torch.cat([torch.zeros_like(st[:, :, :1]),
                           torch.cumsum(st, 2)[:, :, :-1]], 2)
    state = torch.exp(ltot) * (dh_out * h_in).sum((-1, -2))  # (B,NC,H)
    dla = (inter.flip(2).cumsum(2).flip(2) + st_before + quad
           + state[:, :, None]).reshape(bsz, s, h)
    ddt = ddt + a * dla
    da_log = (dla * la).sum((0, 1))
    return (dx.to(x.dtype), ddt.to(dt.dtype), da_log.to(a_log.dtype),
            db.reshape(bsz, s, n).to(b.dtype),
            dc.reshape(bsz, s, n).to(c.dtype), dd.to(d_skip.dtype),
            None if h0 is None else dstate.to(h0.dtype))


def ssd_bwd_head_sum_ref(parts: torch.Tensor, dtype: torch.dtype):
    """The plain version of the SSD backward's head sum: (2, B, H, S, N)
    fp32 per-head partials of db and dc -> (db, dc) in ``dtype``, the
    heads added in order."""
    total = parts[:, :, 0]
    for h in range(1, parts.shape[2]):
        total = total + parts[:, :, h]
    return total[0].to(dtype), total[1].to(dtype)


def ssd_chunk_scores_ref(b: torch.Tensor, c: torch.Tensor,
                         chunk: int) -> torch.Tensor:
    """C B^T within each chunk of ``chunk`` steps, shared by every head:
    b, c (B, S, N) -> (B, ceil(S / chunk), chunk, chunk) fp32, the steps
    past S zeros.  The plain version of the SSD scan's scores pass."""
    bsz, s, n = b.shape
    nc = -(-s // chunk)
    pad = nc * chunk - s
    bp = torch.nn.functional.pad(b.to(torch.float32), (0, 0, 0, pad))
    cp = torch.nn.functional.pad(c.to(torch.float32), (0, 0, 0, pad))
    return torch.einsum("bcqn,bctn->bcqt", cp.reshape(bsz, nc, chunk, n),
                        bp.reshape(bsz, nc, chunk, n))


def ssd_step_ref(h: torch.Tensor, x_t: torch.Tensor, dt_t: torch.Tensor,
                 a_log: torch.Tensor, b_t: torch.Tensor, c_t: torch.Tensor,
                 d_skip: torch.Tensor):
    """Single-token SSD decode step.

    h: (B, H, P, N) fp32, x_t: (B, H, P), dt_t: (B, H), b_t / c_t: (B, N).
    Returns (y_t (B, H, P) in x_t's dtype, h_new fp32).
    """
    dtf = dt_t.to(torch.float32)
    decay = torch.exp(-torch.exp(a_log.to(torch.float32))[None, :] * dtf)
    xb = x_t.to(torch.float32) * dtf[..., None]
    h_new = h * decay[:, :, None, None] + torch.einsum(
        "bhp,bn->bhpn", xb, b_t.to(torch.float32))
    y = torch.einsum("bhpn,bn->bhp", h_new, c_t.to(torch.float32)) \
        + x_t.to(torch.float32) * d_skip.to(torch.float32)[None, :, None]
    return y.to(x_t.dtype), h_new
