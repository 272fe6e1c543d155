"""The split-KV design of the decode kernels (``csrc/flash_decode.cu``),
checked on the CPU.

``plan_splits`` is the pure host function that picks how many key splits
each (stream, kv-head) gets.  ``_split_combine`` below repeats the
kernel's split and combine arithmetic in torch: split s of a row's n keys
is [s * n // S, (s + 1) * n // S) (n = W with a mask, min(pos, W-1) + 1
in the pool, 0 for a dead stream); each split keeps its fp32 running max
m (-1e30 with no key), sum l and unnormalised accumulator; the combine
merges them with the guarded rule (factor 0 for m = -1e30, denominator
at least 1e-30), so a row that sees no key is exactly 0.  int8 caches are
scored as integers against q * scale / kv_scale and the accumulator is
divided by kv_scale once, as the kernel does.  It is held against the
JAX reference's XLA path (``repro.kernels.ops`` under
``force_kernel("xla")``) on the rows that see a key, at the tolerance of
the other kernel tests (rtol 1e-5, atol 1e-6 in fp32); rows that see no
key must be exact zeros (the XLA path gives a uniform softmax there).
The kernel itself runs only on the card: ``chip_smoke.py`` holds it
against the plain versions at these features and at the serving shapes.
"""

import inspect

import pytest

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
torch = pytest.importorskip("torch")
import _torch_threads  # noqa: E402,F401

from repro.kernels import ops as jops  # noqa: E402
from repro_torch.kernels import flash_decode  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-6)
NEG_INF = -1e30


@pytest.fixture(autouse=True)
def _xla_reference():
    with jops.force_kernel("xla"):
        yield


# (batch, kv_heads, width, SMs) -> splits
PLANS = {
    "multihost_fills_the_card": ((72, 8, 145, 132), 1),
    "e1_batch_path": ((44, 8, 274, 132), 1),
    "e0_batch_path": ((20, 8, 274, 132), 2),
    "e0_wide_enough": ((25, 8, 274, 132), 1),
    "few_streams": ((8, 8, 274, 132), 4),
    "long_ring": ((2, 8, 4096, 132), 17),
    "long_ring_keys_cap": ((1, 1, 4096, 132), 64),
    "too_few_keys": ((2, 8, 100, 132), 1),
    "one_stream_short_ring": ((1, 1, 200, 132), 3),
    "larger_card": ((16, 8, 274, 264), 4),
}


@pytest.mark.parametrize("case", sorted(PLANS))
def test_plan_splits(case):
    (batch, kv_heads, width, sms), want = PLANS[case]
    splits = flash_decode.plan_splits(batch, kv_heads, width, sms)
    assert splits == want
    assert splits >= 1
    if 2 * batch * kv_heads >= 3 * sms:
        assert splits == 1                       # already fills the card
    if splits > 1:                               # never a split too short
        assert width // splits >= flash_decode.MIN_SPLIT_KEYS
    # shapes and the SM count are all it reads
    assert list(inspect.signature(flash_decode.plan_splits).parameters) == [
        "batch", "kv_heads", "width", "sm_count"]


def _split_combine(q, k, v, splits, *, mask=None, pos=None, live=None,
                   softcap=0.0, kv_scale=0.0):
    """The kernel's arithmetic over ``splits`` key splits (see the module
    docstring).  q (B, H, D) fp32, caches (B, W, KV, D); validity from
    ``mask`` (B, W) or from ``pos``/``live``."""
    b, h, d = q.shape
    w, kv = k.shape[1], k.shape[2]
    rep = h // kv
    qs = q.reshape(b, kv, rep, d) * (1.0 / d ** 0.5)
    if kv_scale > 0.0:
        qs = qs / kv_scale
    scores = torch.einsum("bgrd,bwgd->bgrw", qs, k.float())
    if softcap > 0.0:
        scores = softcap * torch.tanh(scores / softcap)
    key = torch.arange(w)[None, :]
    if mask is None:
        n = torch.clamp(pos, max=w - 1) + 1
        if live is not None:
            n = torch.where(live > 0, n, 0)
        valid = torch.ones(b, w, dtype=torch.bool)
    else:
        n = torch.full((b,), w)
        valid = mask.bool()
    parts = []
    for s in range(splits):
        lo, hi = s * n // splits, (s + 1) * n // splits
        ok = (valid & (key >= lo[:, None]) & (key < hi[:, None]))[:, None,
                                                                   None]
        sc = torch.where(ok, scores, NEG_INF)
        m = sc.amax(-1)
        m_safe = torch.where(m <= NEG_INF, 0.0, m)
        p = torch.where(ok, torch.exp(sc - m_safe[..., None]), 0.0)
        acc = torch.einsum("bgrw,bwgd->bgrd", p, v.float())
        if kv_scale > 0.0:
            acc = acc / kv_scale
        parts.append((m, p.sum(-1), acc))
    m_all = torch.stack([m for m, _, _ in parts]).amax(0)
    m_safe = torch.where(m_all <= NEG_INF, 0.0, m_all)
    l_all = torch.zeros_like(m_all)
    a_all = torch.zeros_like(parts[0][2])
    for m, l, acc in parts:
        f = torch.where(m > NEG_INF, torch.exp(m - m_safe), 0.0)
        l_all = l_all + l * f
        a_all = a_all + acc * f[..., None]
    out = a_all / torch.clamp(l_all, min=1e-30)[..., None]
    return out.reshape(b, h, d)


def _caches(rng, b, w, kv, d, int8):
    k = rng.randn(b, w, kv, d).astype(np.float32)
    v = rng.randn(b, w, kv, d).astype(np.float32)
    if int8:
        k = np.clip(np.round(k * 32), -127, 127).astype(np.int8)
        v = np.clip(np.round(v * 32), -127, 127).astype(np.int8)
    return k, v


@pytest.mark.parametrize("variant", ["plain", "int8_softcap"])
@pytest.mark.parametrize("splits", [1, 2, 3, 7])
def test_mask_split_combine_matches_reference(splits, variant):
    """B4: a random mask, a row that sees nothing (exact zeros), a row
    whose few valid keys leave most splits empty, and a full row."""
    rng = np.random.RandomState(splits)
    b, w, h, kv, d = 4, 37, 8, 2, 64
    q = rng.randn(b, h, d).astype(np.float32)
    kw = dict(softcap=4.0, kv_scale=32.0) if variant != "plain" else {}
    k, v = _caches(rng, b, w, kv, d, bool(kw))
    mask = rng.rand(b, w) < 0.6
    mask[1] = False
    mask[2] = False
    mask[2, 13:17] = True
    mask[3] = True
    got = _split_combine(torch.from_numpy(q), torch.from_numpy(k),
                         torch.from_numpy(v), splits,
                         mask=torch.from_numpy(mask), **kw)
    want = np.asarray(jops.decode_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(mask),
        **kw))
    seen = mask.any(1)
    np.testing.assert_allclose(got.numpy()[seen], want[seen], **TOL)
    assert torch.equal(got[~torch.from_numpy(seen)],
                       torch.zeros_like(got[~torch.from_numpy(seen)]))


@pytest.mark.parametrize("variant", ["plain", "int8_softcap"])
@pytest.mark.parametrize("splits", [1, 2, 3, 7])
def test_pool_split_combine_matches_reference(splits, variant):
    """B5: pos at 0 (one key), inside the first split, mid-ring, at the
    last slot and past W (ring wraps), and a dead stream (exact zeros)."""
    rng = np.random.RandomState(10 + splits)
    b, w, h, kv, d = 6, 37, 8, 2, 64
    q = rng.randn(b, h, d).astype(np.float32)
    kw = dict(softcap=4.0, kv_scale=32.0) if variant != "plain" else {}
    k, v = _caches(rng, b, w, kv, d, bool(kw))
    pos = np.asarray([0, 2, 20, 36, 40, 81], np.int32)
    live = np.asarray([1, 1, 0, 1, 1, 1], np.int32)
    got = _split_combine(torch.from_numpy(q), torch.from_numpy(k),
                         torch.from_numpy(v), splits,
                         pos=torch.from_numpy(pos),
                         live=torch.from_numpy(live), **kw)
    want = np.asarray(jops.pool_decode_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(pos),
        jnp.asarray(live), **kw))
    alive = live > 0
    np.testing.assert_allclose(got.numpy()[alive], want[alive], **TOL)
    assert torch.equal(got[~torch.from_numpy(alive)],
                       torch.zeros_like(got[~torch.from_numpy(alive)]))


def _cache_view(shape, dtype, offset):
    """A contiguous (B, W, KV, D) view ``offset`` elements into a fresh
    storage (the allocator aligns the storage itself to 64 bytes)."""
    n = int(np.prod(shape))
    flat = torch.zeros(n + 16, dtype=dtype)
    return flat[offset:offset + n].view(shape)


@pytest.mark.parametrize("which", ["k", "v", "both", "neither",
                                   "strided"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_wrappers_refuse_unaligned_caches(dtype, which):
    """The kernel copies caches in 16-byte chunks, so ``_check`` (which
    both wrappers call before launching) refuses a contiguous view whose
    data start off a 16-byte boundary, and hands back aligned contiguous
    caches otherwise (a strided view is copied, so it is aligned)."""
    cache_dtype = getattr(torch, dtype)
    q_dtype = torch.float32 if dtype == "int8" else cache_dtype
    kv_scale = 32.0 if dtype == "int8" else 0.0
    shape = (2, 8, 2, 64)
    q = torch.zeros(2, 4, 64, dtype=q_dtype)
    k = _cache_view(shape, cache_dtype, 1 if which in ("k", "both") else 0)
    v = _cache_view(shape, cache_dtype, 1 if which in ("v", "both") else 0)
    if which == "strided":
        k = _cache_view((2, 2, 8, 64), cache_dtype, 1).transpose(1, 2)
        assert not k.is_contiguous() and k.data_ptr() % 16
    for name in ("flash_decode", "pool_flash_decode"):
        if which in ("k", "v", "both"):
            with pytest.raises(ValueError, match="16-byte"):
                flash_decode._check(name, q, k, v, kv_scale)
            continue
        *_, kc, vc = flash_decode._check(name, q, k, v, kv_scale)
        assert kc.is_contiguous() and vc.is_contiguous()
        assert kc.data_ptr() % 16 == 0 and vc.data_ptr() % 16 == 0
        assert torch.equal(kc, k) and torch.equal(vc, v)
