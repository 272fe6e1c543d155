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
import torch  # noqa: E402

from repro.core.berrut import CodingConfig  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
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


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(ATTN_CASES))
def test_attention_plain_matches_reference(case, dtype):
    kw = ATTN_CASES[case]
    rng = np.random.RandomState(len(case))
    s = 12
    l = s + kw.get("q_offset", 0)
    jq, tq = _pair(rng.randn(2, s, 4, 64), dtype)
    jk, tk = _pair(rng.randn(2, l, 2, 64), dtype)
    jv, tv = _pair(rng.randn(2, l, 2, 64), dtype)
    got = ops.attention(tq, tk, tv, **kw)
    _close(got, jops.attention(jq, jk, jv, **kw), dtype)


@pytest.mark.parametrize("variant", ["plain", "softcap", "int8"])
def test_decode_attention_plain_matches_reference(variant):
    rng = np.random.RandomState(7)
    b, w, h, kv, d = 3, 20, 4, 2, 64
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
                                        "flash_attention", "flash_decode",
                                        "pool_flash_decode", "ssd_chunked"}
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
