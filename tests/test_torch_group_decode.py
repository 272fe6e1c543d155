"""B2's plumbing in the port, and the round tail around it, on the CPU.

``kernels.berrut_decode.plan_vector`` (how many columns a thread of the
kernel moves per access), the wrapper's refusals, the plain path on the
strided worker-major views the tails now hand to B2 without a copy (held
against the JAX ``fused_group_decode`` on the contiguous block, its
Pallas kernel in interpret mode: fp32 rtol 1e-5 atol 1e-6, another
summation order; bf16 rtol and atol 1e-2, one bf16 rounding, as in
``test_torch_kernels.py``), the node cache of ``core.berrut``, and that a
round's tail builds no tensor from host data after its first round, with
its results unchanged (equal to the JAX tail's at the fp32 tolerance,
located workers exactly).  The CUDA kernel itself runs only on the card:
``chip_smoke.py`` holds it against the plain version there.
"""

import pytest

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
torch = pytest.importorskip("torch")
import _torch_threads  # noqa: E402,F401

from repro.core.berrut import CodingConfig as JCoding  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.launch import worker_mesh as jwm  # noqa: E402
from repro.serving import coded_serving as jcs  # noqa: E402
from repro_torch.core import berrut  # noqa: E402
from repro_torch.core.berrut import CodingConfig  # noqa: E402
from repro_torch.kernels import berrut_decode, ops  # noqa: E402
from repro_torch.launch import worker_mesh as twm  # noqa: E402
from repro_torch.serving import coded_serving as tcs  # noqa: E402

TOL = {"float32": dict(rtol=1e-5, atol=1e-6),
       "bfloat16": dict(rtol=1e-2, atol=1e-2)}
V = 151936
ROW = (11 * V, V)                   # a contiguous (G, 11, V) block's strides


@pytest.mark.parametrize("v, strides, itemsize, ptrs, want", [
    (V, ROW, 4, (0, 4096), 4),                       # fp32: 16 bytes
    (V, ROW, 2, (0, 4096), 8),                       # bf16: 16 bytes
    (1000, (11000, 1000), 4, (256, 512), 4),
    (1000, (11000, 1000), 2, (256, 512), 8),
    (1001, (11011, 1001), 4, (256, 512), 1),         # ragged vocabulary
    (1001, (11011, 1001), 2, (256, 512), 1),
    (50280, (11 * 50280, 50280), 4, (0, 0), 4),      # mamba2's vocabulary
    (50280, (11 * 50280, 50280), 2, (0, 0), 8),
    (1000, (11011, 1001), 4, (256, 512), 1),         # an odd stride
    (1000, (4 * 1004, 1004), 2, (256, 512), 1),      # 4 bf16, not 8
    (1000, (4 * 1004, 1004), 4, (256, 512), 4),      # 4 fp32 is 16 bytes
    (1000, (0, 1000), 4, (256, 512), 4),             # a shared row
    (1000, (11000, 1000), 4, (260, 512), 1),         # unaligned offset
    (1000, (11000, 1000), 2, (258, 512), 1),
    (1000, (11000, 1000), 4, (264, 512), 1),         # 8, not 16 bytes
    (1000, (11000, 1000), 4, (256, 520), 1),         # the output's pointer
])
def test_plan_vector(v, strides, itemsize, ptrs, want):
    assert berrut_decode.plan_vector(v, strides, itemsize, ptrs) == want


def test_plan_vector_on_views():
    """The strides and pointers of real views: the worker-major tail's
    transposed block keeps 16-byte accesses; a view one element in does
    not."""
    block = torch.zeros(11, 4, 1008)
    for view, want in ((block.transpose(0, 1), 4),
                       (block.index_select(0, torch.tensor([0, 2, 5]))
                        .transpose(0, 1), 4),
                       (block.transpose(0, 1)[..., 1:1001], 1),
                       (block.transpose(0, 1)[..., :1001], 1)):
        got = berrut_decode.plan_vector(
            view.shape[-1], view.stride()[:2], view.element_size(),
            (view.data_ptr(),))
        assert got == want, view.stride()


def test_wrapper_refuses_cpu_tensors_and_a_strided_vocabulary():
    """A strided view whose vocabulary axis has unit stride is taken (and
    then refused only for lying on the CPU); one whose vocabulary axis is
    strided is refused before anything else."""
    a, b = torch.zeros(4), torch.zeros(5)
    for grouped in (torch.zeros(2, 5, 8), torch.zeros(5, 2, 8).transpose(0, 1)):
        with pytest.raises(ValueError, match="CUDA"):
            berrut_decode.fused_group_decode(grouped, torch.ones(5), a, b)
    with pytest.raises(ValueError, match="unit stride"):
        berrut_decode.fused_group_decode(torch.zeros(2, 5, 16)[..., ::2],
                                         torch.ones(5), a, b)
    with pytest.raises(ValueError, match="V <="):
        berrut_decode.fused_group_decode(
            torch.zeros(1, 5, 1).expand(1, 5, 2 ** 31), torch.ones(5), a, b)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("width", [None, 6])
def test_plain_on_worker_major_view_matches_reference(dtype, width):
    """ops.fused_group_decode on the tail's (G, N+1, V) view of a
    worker-major (N+1, G, V) block (transposed, or survivor-compacted by
    ``index_select`` first) equals the JAX kernel on the contiguous
    block."""
    coding = CodingConfig(k=4, s=1, e=1)
    n1, g, v = coding.num_workers, 3, 640
    rng = np.random.RandomState(7)
    block = rng.randn(n1, g, v).astype(np.float32)
    masks = np.ones((g, n1), np.float32)
    masks[:, 3] = 0.0
    masks[1, 7] = 0.0
    a = np.asarray(coding.alphas, np.float32)
    b = np.asarray(coding.betas, np.float32)
    tb = torch.from_numpy(block).to(getattr(torch, dtype))
    if width is None:
        view = tb.transpose(0, 1)
        contiguous = block.transpose(1, 0, 2)
    else:
        idx = np.flatnonzero(masks.min(0) > 0)[:width]
        view = tb.index_select(0, torch.from_numpy(idx)).transpose(0, 1)
        contiguous = block[idx].transpose(1, 0, 2)
        masks, b = masks[:, idx], b[idx]
    assert not view.is_contiguous()
    got = ops.fused_group_decode(view, torch.from_numpy(masks),
                                 torch.from_numpy(a), torch.from_numpy(b))
    with jops.force_kernel("interpret"):
        want = jops.fused_group_decode(
            jnp.asarray(np.ascontiguousarray(contiguous)).astype(
                getattr(jnp, dtype)),
            jnp.asarray(masks), jnp.asarray(a), jnp.asarray(b))
    assert str(got.dtype).endswith(dtype)
    np.testing.assert_allclose(got.to(torch.float32).numpy(),
                               np.asarray(want, np.float32), **TOL[dtype])


def test_node_cache_shares_one_tensor_per_config_and_device():
    cfg = CodingConfig(k=4, s=1, e=1)
    alphas, betas = berrut.nodes(cfg, torch.device("cpu"))
    same = berrut.nodes(CodingConfig(k=4, s=1, e=1))     # equal config
    assert same[0] is alphas and same[1] is betas
    assert berrut.nodes(cfg, "cpu")[0] is alphas
    assert alphas.dtype == betas.dtype == torch.float32
    np.testing.assert_array_equal(alphas.numpy(),
                                  np.asarray(cfg.alphas, np.float32))
    np.testing.assert_array_equal(betas.numpy(),
                                  np.asarray(cfg.betas, np.float32))
    other = berrut.nodes(CodingConfig(k=4, s=2, e=1))
    assert other[1] is not betas and other[1].shape == (12,)
    enc = berrut.encode_matrix(cfg)
    assert berrut.encode_matrix(CodingConfig(k=4, s=1, e=1)) is enc
    assert enc.dtype == torch.float32 and enc.shape == (11, 4)


def _tail_inputs(coding, g, v, seed):
    rng = np.random.RandomState(seed)
    coded = rng.randn(g * coding.num_workers, v).astype(np.float32)
    coded[2::coding.num_workers] += 40.0 * rng.randn(g, v)   # an attacker
    avail = np.ones(coding.num_workers, np.float32)
    avail[5] = 0.0                                          # a straggler
    return coded, avail


@pytest.mark.parametrize("tail", ["group-major", "survivor"])
def test_round_tail_builds_no_host_tensor_after_its_first_round(
        monkeypatch, tail):
    """``torch.tensor`` copies host data; on the card that copy blocks the
    host until the stream has drained.  The tail calls it in its first
    round (the node cache fills) and never again, and its results are the
    JAX tail's."""
    coding, jcoding = CodingConfig(k=4, s=1, e=1), JCoding(k=4, s=1, e=1)
    g, v = 3, 640
    coded, avail = _tail_inputs(coding, g, v, seed=11)
    tc, ta = torch.from_numpy(coded), torch.from_numpy(avail)
    wshard = twm.WorkerShardConfig()
    calls = []
    real = torch.tensor

    def counted(*args, **kw):
        calls.append(args[0] if args else kw)
        return real(*args, **kw)

    def run():
        if tail == "group-major":
            logits, (located, _) = tcs._finish_round(coding, tc, ta, True)
            return logits, located
        # worker-major streams (n*G + g): the same rows, reordered
        wm = tc.reshape(g, coding.num_workers, v).transpose(0, 1).reshape(
            -1, v)
        masks, located, _ = tcs.locate(coding, wm, ta, wshard=wshard)
        block = wm.reshape(coding.num_workers, g, v)
        return twm._decode_tail(coding, block, masks, ta, wshard, None,
                                None, None, None), located

    monkeypatch.setattr(torch, "tensor", counted)
    first = run()
    calls.clear()
    second = run()
    assert calls == []
    for a, b in zip(first, second):
        assert torch.equal(a, b)
    monkeypatch.undo()
    with jops.force_kernel("xla"):
        jl, (jloc, _) = jcs._finish_round(jcoding, jnp.asarray(coded),
                                          jnp.asarray(avail), True)
        if tail == "survivor":
            jmasks = jnp.asarray(avail)[None, :] * (1.0 - jloc)
            jblock = jnp.asarray(coded).reshape(g, -1, v).transpose(1, 0, 2)
            jl = jwm.survivor_decode_tail(jcoding, jblock, jmasks,
                                          jnp.asarray(avail),
                                          jwm.WorkerShardConfig())
    np.testing.assert_array_equal(second[1].numpy(), np.asarray(jloc))
    assert second[1][:, 2].all()
    np.testing.assert_allclose(second[0].numpy(), np.asarray(jl),
                               **TOL["float32"])
