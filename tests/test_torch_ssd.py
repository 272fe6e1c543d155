"""Port parity of the Mamba2 SSD scan: the plain versions in
``repro_torch.kernels.ref`` (``ssd_scan_ref``, ``ssd_chunked_ref``,
``ssd_step_ref``) and ``ops.ssd`` / ``ops.ssd_step`` on the CPU, against
the reference's ``repro.kernels.ref`` and its Pallas ``ssd_chunked`` in
interpret mode, on the same numpy inputs.

fp32 throughout: y and h_final agree within rtol 1e-5, atol 1e-4 (another
summation order in every contraction and in the cumulative log decay;
|y| reaches ~30 here).  The CUDA kernel itself runs only on the card
(``chip_smoke.py`` holds it against ``ssd_chunked_ref``).
"""

import pytest

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
torch = pytest.importorskip("torch")
import _torch_threads  # noqa: E402,F401

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels import ssd_scan as jssd  # noqa: E402
from repro_torch.kernels import ops, ref, ssd_scan  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-4)
# jitted: one compile per shape instead of one per primitive
J_SCAN = jax.jit(jref.ssd_scan_ref)
J_CHUNKED = jax.jit(jref.ssd_chunked_ref, static_argnames="chunk")


def _inputs(b=2, s=24, h=3, p=8, n=16, seed=0, strong=False, h0=False):
    """x, dt, a_log, b, c, d_skip (and h0) as float32 numpy arrays.
    ``strong``: a = -16 and dt ~ 5, so the log decay over a chunk of 32
    reaches ~ -2500 and exp(L) underflows to 0."""
    rng = np.random.RandomState(seed)
    x = rng.randn(b, s, h, p).astype(np.float32)
    dt = np.log1p(np.exp(rng.randn(b, s, h) + (5.0 if strong else 0.0))
                  ).astype(np.float32)
    a_log = (np.full(h, np.log(16.0)) if strong
             else np.log(np.linspace(1.0, 16.0, h))).astype(np.float32)
    bb = rng.randn(b, s, n).astype(np.float32)
    cc = rng.randn(b, s, n).astype(np.float32)
    d = rng.rand(h).astype(np.float32)
    out = [x, dt, a_log, bb, cc, d]
    if h0:
        out.append(rng.randn(b, h, p, n).astype(np.float32))
    return out


def _t(arrays):
    return [torch.from_numpy(a) for a in arrays]


def _j(arrays):
    return [jnp.asarray(a) for a in arrays]


def _close(got, want):
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


@pytest.mark.parametrize("with_h0", [False, True])
def test_scan_ref_matches_reference(with_h0):
    arrays = _inputs(h0=with_h0)
    _close(ref.ssd_scan_ref(*_t(arrays)), J_SCAN(*_j(arrays)))


@pytest.mark.parametrize("chunk,s", [(8, 24), (12, 24), (32, 64), (128, 128),
                                     (128, 12)])
@pytest.mark.parametrize("with_h0", [False, True])
def test_chunked_ref_matches_reference(chunk, s, with_h0):
    arrays = _inputs(s=s, h0=with_h0, seed=chunk + s)
    got = ref.ssd_chunked_ref(*_t(arrays), chunk=chunk)
    _close(got, J_CHUNKED(*_j(arrays), chunk=chunk))
    # the chunked form is exact algebra: the sequential oracle agrees
    _close(got, ref.ssd_scan_ref(*_t(arrays)))


@pytest.mark.parametrize("chunk,s,with_h0", [(8, 24, True), (12, 12, False),
                                             (32, 64, True)])
def test_chunked_ref_matches_pallas_interpret(chunk, s, with_h0):
    arrays = _inputs(s=s, h0=with_h0, seed=chunk + s)
    j = _j(arrays)
    _close(ref.ssd_chunked_ref(*_t(arrays), chunk=chunk),
           jssd.ssd_chunked(*j[:6], h0=j[6] if with_h0 else None,
                            chunk=chunk, interpret=True))


def test_chunked_ref_continues_from_h0():
    """Two halves, the second started from the first's state, equal one
    pass (what a prefill continued from a cache would rely on)."""
    x, dt, a_log, b, c, d = _t(_inputs(s=32, seed=3))
    y, h = ref.ssd_chunked_ref(x, dt, a_log, b, c, d, chunk=8)
    y1, h1 = ref.ssd_chunked_ref(x[:, :16], dt[:, :16], a_log, b[:, :16],
                                 c[:, :16], d, chunk=8)
    y2, h2 = ref.ssd_chunked_ref(x[:, 16:], dt[:, 16:], a_log, b[:, 16:],
                                 c[:, 16:], d, h0=h1, chunk=8)
    _close((torch.cat([y1, y2], 1), h2), (y, h))


def test_chunked_ref_strong_decay_stays_finite():
    arrays = _inputs(s=64, strong=True, seed=5)
    y, h = ref.ssd_chunked_ref(*_t(arrays), chunk=32)
    assert torch.isfinite(y).all() and torch.isfinite(h).all()
    _close((y, h), J_CHUNKED(*_j(arrays), chunk=32))
    _close((y, h), ref.ssd_scan_ref(*_t(arrays)))


def test_chunked_ref_refuses_a_chunk_that_does_not_divide():
    with pytest.raises(ValueError, match="divisible"):
        ref.ssd_chunked_ref(*_t(_inputs(s=24)), chunk=16)


def test_step_ref_matches_reference_and_one_scan_step():
    x, dt, a_log, b, c, d, h0 = _inputs(s=1, h0=True, seed=7)
    args = (x[:, 0], dt[:, 0], a_log, b[:, 0], c[:, 0], d)
    got = ref.ssd_step_ref(torch.from_numpy(h0), *_t(args))
    _close(got, jref.ssd_step_ref(jnp.asarray(h0), *_j(args)))
    y, h = ref.ssd_scan_ref(*_t([x, dt, a_log, b, c, d, h0]))
    _close(got, (y[:, 0], h))


def test_ops_dispatch_cpu_to_the_plain_versions():
    arrays = _inputs(s=24, h0=True, seed=9)
    t = _t(arrays)
    _close(ops.ssd(*t[:6], h0=t[6], chunk=12),
           ref.ssd_chunked_ref(*t[:6], h0=t[6], chunk=12))
    h0 = t[6]
    step = (t[0][:, 0], t[1][:, 0], t[2], t[3][:, 0], t[4][:, 0], t[5])
    _close(ops.ssd_step(h0, *step), ref.ssd_step_ref(h0, *step))


def test_kernel_wrapper_refuses_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA"):
        ssd_scan.ssd_chunked(*_t(_inputs()))
    assert "ssd_chunked" in ops.KERNELS
