"""Port parity of the kernel modules' CPU path, and the kernel plumbing.

On a CPU tensor ``repro_torch.kernels.ops`` runs each kernel's plain
PyTorch version; here each is held against the JAX reference's XLA path
(``repro.kernels.ops`` under ``force_kernel("xla")``) on the same numpy
inputs.  fp32 agrees to float32 rounding of a different summation order
(rtol 1e-5, atol 1e-6); bf16 outputs to one bf16 rounding (rtol 1e-2).
The CUDA kernels themselves run only on the card: ``chip_smoke.py``
holds them against these plain versions there.
"""

import pytest

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
torch = pytest.importorskip("torch")
import _torch_threads  # noqa: E402,F401

from repro.core.berrut import CodingConfig  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import (berrut_decode, berrut_matmul,  # noqa: E402
                                 flash_attention, flash_decode)

TOL = {"float32": dict(rtol=1e-5, atol=1e-6),
       "bfloat16": dict(rtol=1e-2, atol=1e-2)}


@pytest.fixture(autouse=True)
def _xla_reference():
    with jops.force_kernel("xla"):
        yield


def _pair(a, dtype):
    """The same numpy values as a JAX array and a torch tensor of dtype."""
    return (jnp.asarray(a, jnp.float32).astype(getattr(jnp, dtype)),
            torch.tensor(a, dtype=torch.float32).to(getattr(torch, dtype)))


def _close(got: torch.Tensor, want, dtype):
    assert str(got.dtype).endswith(dtype)
    np.testing.assert_allclose(got.to(torch.float32).numpy(),
                               np.asarray(want, np.float32), **TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(3, 4, 640), (2, 3, 4, 1000), (1, 4, 7)])
def test_berrut_apply_plain_matches_reference(shape, dtype):
    rng = np.random.RandomState(len(shape))
    w = rng.randn(11, 4).astype(np.float32)
    jx, tx = _pair(rng.randn(*shape), dtype)
    got = ops.berrut_apply(torch.from_numpy(w), tx)
    assert got.shape == shape[:-2] + (11, shape[-1])
    _close(got, jops.berrut_apply(jnp.asarray(w), jx), dtype)


def _decode_case(cfg, masks, dtype, v=640, g=3, c_vote=0, seed=0):
    rng = np.random.RandomState(seed)
    jx, tx = _pair(rng.randn(g, cfg.num_workers, v), dtype)
    a = np.asarray(cfg.alphas, np.float32)
    b = np.asarray(cfg.betas, np.float32)
    want = jops.fused_group_decode(jx, jnp.asarray(masks), jnp.asarray(a),
                                   jnp.asarray(b), c_vote=c_vote)
    got = ops.fused_group_decode(tx, torch.from_numpy(masks),
                                 torch.from_numpy(a), torch.from_numpy(b),
                                 c_vote=c_vote)
    if c_vote:
        (got, got_votes), (want, want_votes) = got, want
        assert got_votes.dtype == torch.float32
        np.testing.assert_array_equal(got_votes.numpy(),
                                      np.asarray(want_votes))
    assert got.shape == (g, cfg.k, v)
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("v", [640, 1000, 10])
def test_fused_group_decode_plain_shared_mask(v, dtype):
    cfg = CodingConfig(k=4, s=2, e=0)
    mask = np.ones(cfg.num_workers, np.float32)
    mask[[1, 4]] = 0.0
    _decode_case(cfg, mask, dtype, v=v)


@pytest.mark.parametrize("c_vote", [0, 64])
def test_fused_group_decode_plain_per_group_masks_and_gather(c_vote):
    cfg = CodingConfig(k=4, s=1, e=1)
    masks = np.ones((3, cfg.num_workers), np.float32)
    masks[:, 2] = 0.0
    for i in range(3):
        masks[i, (5 + 3 * i) % cfg.num_workers] = 0.0
    _decode_case(cfg, masks, "float32", v=1000, c_vote=c_vote)


@pytest.mark.parametrize("masked", [(), (0,), (3,)])
def test_fused_group_decode_plain_systematic_node_hits(masked):
    cfg = CodingConfig(k=4, s=2, e=0, systematic=True)
    mask = np.ones(cfg.num_workers, np.float32)
    mask[list(masked)] = 0.0
    _decode_case(cfg, mask, "float32")


ATTN_CASES = {
    "causal": dict(),
    "non_causal": dict(causal=False),
    "window": dict(window=5),
    "prefix": dict(prefix=6),
    "softcap": dict(softcap=5.0),
    "q_offset": dict(q_offset=4),
}


def _attention_case(case, dtype, d):
    kw = ATTN_CASES[case]
    rng = np.random.RandomState(len(case))
    s = 12
    l = s + kw.get("q_offset", 0)
    jq, tq = _pair(rng.randn(2, s, 4, d), dtype)
    jk, tk = _pair(rng.randn(2, l, 2, d), dtype)
    jv, tv = _pair(rng.randn(2, l, 2, d), dtype)
    got = ops.attention(tq, tk, tv, **kw)
    _close(got, jops.attention(jq, jk, jv, **kw), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(ATTN_CASES))
def test_attention_plain_matches_reference(case, dtype):
    _attention_case(case, dtype, 64)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(ATTN_CASES))
def test_attention_plain_matches_reference_at_head_dim_80(case, dtype):
    """h2o-danube's head dim, which the CUDA kernel also takes."""
    _attention_case(case, dtype, 80)


def _decode_attention_case(variant, d):
    rng = np.random.RandomState(7)
    b, w, h, kv = 3, 20, 4, 2
    q = rng.randn(b, h, d).astype(np.float32)
    kc = rng.randn(b, w, kv, d).astype(np.float32)
    vc = rng.randn(b, w, kv, d).astype(np.float32)
    mask = rng.rand(b, w) < 0.7
    mask[:, 0] = True                     # no all-masked row
    kw = {}
    if variant == "softcap":
        kw["softcap"] = 4.0
    if variant == "int8":
        kc = np.clip(np.round(kc * 32), -127, 127).astype(np.int8)
        vc = np.clip(np.round(vc * 32), -127, 127).astype(np.int8)
        kw["kv_scale"] = 32.0
    want = jops.decode_attention(jnp.asarray(q), jnp.asarray(kc),
                                 jnp.asarray(vc), jnp.asarray(mask), **kw)
    got = ops.decode_attention(torch.from_numpy(q), torch.from_numpy(kc),
                               torch.from_numpy(vc), torch.from_numpy(mask),
                               **kw)
    _close(got, want, "float32")


@pytest.mark.parametrize("variant", ["plain", "softcap", "int8"])
def test_decode_attention_plain_matches_reference(variant):
    _decode_attention_case(variant, 64)


@pytest.mark.parametrize("variant", ["plain", "softcap", "int8"])
def test_decode_attention_plain_matches_reference_at_head_dim_80(variant):
    _decode_attention_case(variant, 80)


def test_kernel_wrappers_refuse_cpu_tensors():
    """The launching wrappers never run a plain path themselves."""
    x = torch.zeros(2, 4, 8)
    with pytest.raises(ValueError, match="CUDA"):
        berrut_matmul.berrut_apply(torch.zeros(5, 4), x)
    with pytest.raises(ValueError, match="CUDA"):
        berrut_decode.fused_group_decode(torch.zeros(1, 5, 8),
                                         torch.ones(5), torch.zeros(4),
                                         torch.zeros(5))
    q = torch.zeros(1, 4, 2, 64)
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention.flash_attention(q, q, q)
    with pytest.raises(ValueError, match="CUDA"):
        flash_decode.flash_decode(torch.zeros(1, 2, 64), q, q,
                                  torch.ones(1, 4, dtype=torch.bool))


def test_ops_refuses_other_devices():
    x = torch.zeros(2, 4, 8, device="meta")
    with pytest.raises(ValueError, match="no kernel or plain path"):
        ops.berrut_apply(torch.zeros(5, 4, device="meta"), x)


def test_launch_counts_cover_the_four_kernels():
    assert set(ops.launch_counts()) == {"berrut_apply",
                                        "berrut_encode_dispatch",
                                        "fused_group_decode",
                                        "flash_attention",
                                        "flash_attention_bwd",
                                        "flash_attention_bwd_delta",
                                        "flash_decode",
                                        "pool_flash_decode", "ssd_chunked",
                                        "ssd_chunk_scores",
                                        "ssd_chunked_bwd",
                                        "ssd_bwd_head_sum"}
    ops.reset_launch_counts()
    assert not any(ops.launch_counts().values())


def test_library_names_track_source_hashes(tmp_path, monkeypatch):
    monkeypatch.setattr(build, "CSRC_DIR", tmp_path)
    src = tmp_path / "k.cu"
    src.write_text("// one\n")
    first = build.library_path("k.cu")
    assert first.name.startswith("k-") and first.suffix == ".so"
    assert build.library_path("k.cu") == first
    src.write_text("// two\n")
    assert build.library_path("k.cu") != first
    assert sorted(p.name for p in build.CSRC_DIR.glob("*.cu")) == ["k.cu"]


def test_every_kernel_source_is_in_the_repository():
    sources = {k.source for k in ops.KERNELS.values()}
    assert sources == {p.name for p in build.CSRC_DIR.glob("*.cu")}


def test_failed_build_raises(tmp_path, monkeypatch):
    """Without nvcc (or with a failing one) a build raises: no fallback."""
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc"):
        build.build(["berrut_apply.cu"])
    fake = tmp_path / "bin" / "nvcc"
    fake.parent.mkdir()
    fake.write_text("#!/bin/sh\necho 'error: no card here' >&2\nexit 1\n")
    fake.chmod(0o755)
    with pytest.raises(RuntimeError, match="no card here"):
        build.build(["berrut_apply.cu"])


# ------------------------------------------------ 3xTF32, emulated on CPU
#
# The CUDA kernels of flash attention and the SSD scan compute fp32
# products on tensor cores as 3xTF32: x = hi + lo with hi and lo in tf32,
# and a b ~ lo_a hi_b + hi_a lo_b + hi_a hi_b with fp32 sums.  These tests
# emulate that arithmetic in torch, tf32 being the fp32 mantissa cut to
# 10 bits: rounded to nearest, or truncated as the kernels do (they clear
# hi's low 13 bits, and the tensor cores read lo's upper 19), and hold it
# to ``chip_smoke.py``'s fp32 tolerance of the plain versions: 2e-5 of
# max(1, max |plain|).  The card's run of the kernels is the real check.

TOL_F32 = 2e-5


def _tf32(x: torch.Tensor, rounding: str) -> torch.Tensor:
    """fp32 cut to tf32's 10 mantissa bits: to nearest (ties away) or
    truncated."""
    bits = x.contiguous().view(torch.int32)
    if rounding == "nearest":
        bits = bits + 0x1000
    return (bits & ~0x1FFF).view(torch.float32)


def _mm(a: torch.Tensor, b: torch.Tensor, terms: int,
        rounding: str) -> torch.Tensor:
    """a @ b in fp32 from tf32 products: 3 terms (3xTF32) or 1 (TF32)."""
    ah, bh = _tf32(a, rounding), _tf32(b, rounding)
    if terms == 1:
        return ah @ bh
    al, bl = _tf32(a - ah, rounding), _tf32(b - bh, rounding)
    return (al @ bh + ah @ bl) + ah @ bh


def _within_tol(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| over the fp32 tolerance (<= 1 passes)."""
    tol = TOL_F32 * max(1.0, want.abs().max().item())
    return (got - want).abs().max().item() / tol


def _attention_tf32(q, k, v, terms, rounding):
    """Causal GQA attention with both products as emulated TF32 terms."""
    b, s, h, d = q.shape
    rep = h // k.shape[2]
    kk = k.repeat_interleave(rep, 2).transpose(1, 2)         # (B, H, L, D)
    vv = v.repeat_interleave(rep, 2).transpose(1, 2)
    scores = _mm(q.transpose(1, 2), kk.transpose(-1, -2), terms,
                 rounding) / d ** 0.5
    keep = torch.ones(s, k.shape[1], dtype=torch.bool).tril()
    scores = scores.masked_fill(~keep, float("-inf"))
    p = torch.softmax(scores, -1)
    return _mm(p, vv, terms, rounding).transpose(1, 2)


@pytest.mark.parametrize("rounding", ["nearest", "truncate"])
def test_3xtf32_attention_holds_the_fp32_tolerance(rounding):
    """At head dim 128 (the main path's) and 80 (h2o-danube's)."""
    rng = np.random.RandomState(16)
    for d in (128, 80):
        q, k, v = (torch.from_numpy(rng.randn(*shape).astype(np.float32))
                   for shape in ((2, 100, 8, d), (2, 100, 2, d),
                                 (2, 100, 2, d)))
        want = ref.attention_ref(q, k, v)
        assert _within_tol(_attention_tf32(q, k, v, 3, rounding),
                           want) <= 1.0
        # one TF32 term alone would not: the split is what keeps fp32
        assert _within_tol(_attention_tf32(q, k, v, 1, rounding),
                           want) > 1.0


def _ssd_tf32(x, dt, a_log, b, c, d_skip, q, terms, rounding):
    """``ref.ssd_chunked_ref`` at chunk q with every product (C B^T, the
    decay-weighted scores on x, C H^T and the state update) as emulated
    TF32 terms."""
    bsz, s, h, p = x.shape
    n = b.shape[-1]
    nc = s // q
    la = -torch.exp(a_log)[None, None, :] * dt
    lcum = torch.cumsum(la.reshape(bsz, nc, q, h), 2)        # (B,NC,Q,H)
    ltot = lcum[:, :, -1]
    bc, cc = b.reshape(bsz, nc, q, n), c.reshape(bsz, nc, q, n)
    xc = x.reshape(bsz, nc, q, h, p)
    dtc = dt.reshape(bsz, nc, q, h)
    def mm(a, b):
        return _mm(a, b, terms, rounding)

    g = mm(cc, bc.transpose(-1, -2))                         # (B,NC,Q,Q)
    gap = lcum[:, :, :, None, :] - lcum[:, :, None, :, :]    # (B,NC,Q,Q,H)
    tri = torch.ones(q, q, dtype=torch.bool).tril()[None, None, :, :, None]
    att = g[..., None] * torch.exp(torch.where(tri, gap, -1e30))
    att = att.permute(0, 1, 4, 2, 3)                         # (B,NC,H,Q,Q)
    xb = (xc * dtc[..., None]).permute(0, 1, 3, 2, 4)        # (B,NC,H,Q,P)
    w = torch.exp(ltot[:, :, None, :] - lcum) * dtc          # (B,NC,Q,H)
    xw = (xc * w[..., None]).permute(0, 1, 3, 4, 2)          # (B,NC,H,P,Q)
    state = torch.zeros(bsz, h, p, n)
    ys = []
    for ci in range(nc):
        y_inter = mm(state, cc[:, ci, None].transpose(-1, -2))
        y_inter = y_inter * torch.exp(lcum[:, ci]).permute(0, 2, 1)[:, :,
                                                                   None]
        y = y_inter.transpose(-1, -2) + mm(att[:, ci], xb[:, ci])
        ys.append(y.permute(0, 2, 1, 3))                     # (B,Q,H,P)
        state = state * torch.exp(ltot[:, ci])[:, :, None, None] \
            + mm(xw[:, ci], bc[:, ci, None])
    y = torch.cat(ys, 1) + x * d_skip[None, None, :, None]
    return y, state


@pytest.mark.parametrize("rounding", ["nearest", "truncate"])
def test_3xtf32_ssd_chunk_products_hold_the_fp32_tolerance(rounding):
    rng = np.random.RandomState(17)
    bsz, s, h, p, n = 2, 64, 4, 64, 128
    x = torch.from_numpy(rng.randn(bsz, s, h, p).astype(np.float32))
    dt = torch.nn.functional.softplus(
        torch.from_numpy(rng.randn(bsz, s, h).astype(np.float32)))
    a_log = torch.log(torch.linspace(1.0, 16.0, h))
    b, c = (torch.nn.functional.silu(torch.from_numpy(
        rng.randn(bsz, s, n).astype(np.float32))) for _ in range(2))
    d_skip = torch.ones(h)
    y_ref, h_ref = ref.ssd_chunked_ref(x, dt, a_log, b, c, d_skip, chunk=8)
    y, hf = _ssd_tf32(x, dt, a_log, b, c, d_skip, 32, 3, rounding)
    assert _within_tol(y, y_ref) <= 1.0
    assert _within_tol(hf, h_ref) <= 1.0
    y1, h1 = _ssd_tf32(x, dt, a_log, b, c, d_skip, 32, 1, rounding)
    assert max(_within_tol(y1, y_ref), _within_tol(h1, h_ref)) > 1.0
