"""Port parity: ``repro_torch.core.berrut`` against ``repro.core.berrut``.

Nodes and the static encode matrix are built in float64 numpy in both
packages, so they must agree exactly.  The runtime decode matrices are
float32 and agree to a few float32 ulps (rtol 1e-5, atol 1e-6), one-hot
node-hit rows exactly.
"""

import pytest

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
torch = pytest.importorskip("torch")
import _torch_threads  # noqa: E402,F401

from repro.core import berrut as jb  # noqa: E402
from repro_torch.core import berrut as tb  # noqa: E402

CODINGS = [(1, 0, 0, False), (2, 2, 0, False), (4, 1, 0, False),
           (4, 1, 1, False), (8, 2, 1, False), (4, 2, 0, True),
           (3, 1, 1, True)]


def _pair(k, s, e, systematic):
    return (jb.CodingConfig(k=k, s=s, e=e, systematic=systematic),
            tb.CodingConfig(k=k, s=s, e=e, systematic=systematic))


@pytest.mark.parametrize("k,s,e,systematic", CODINGS)
def test_coding_config_and_encode_matrix_match(k, s, e, systematic):
    ref, port = _pair(k, s, e, systematic)
    for name in ("n", "num_workers", "wait_for", "decode_quorum", "overhead"):
        assert getattr(port, name) == getattr(ref, name), name
    np.testing.assert_array_equal(port.alphas, ref.alphas)
    np.testing.assert_array_equal(port.betas, ref.betas)
    np.testing.assert_array_equal(tb.encode_matrix(port).numpy(),
                                  np.asarray(jb.encode_matrix(ref)))


def _masks(n1, seed):
    rng = np.random.RandomState(seed)
    out = [np.ones(n1, np.float32)]
    for drop in (1, 2):
        if n1 - drop >= 1:
            m = np.ones(n1, np.float32)
            m[rng.choice(n1, drop, replace=False)] = 0.0
            out.append(m)
    m = np.ones(n1, np.float32)
    m[0] = 0.0                                # rank -1 at the first node
    out.append(m)
    return out


@pytest.mark.parametrize("k,s,e,systematic", CODINGS)
def test_survivor_weights_and_decode_matrix_match(k, s, e, systematic):
    ref, port = _pair(k, s, e, systematic)
    for mask in _masks(ref.num_workers, seed=k * 7 + s):
        np.testing.assert_array_equal(
            tb.survivor_weights(torch.from_numpy(mask)).numpy(),
            np.asarray(jb.survivor_weights(jnp.asarray(mask))))
        got = tb.decode_matrix(port, torch.from_numpy(mask)).numpy()
        want = np.asarray(jb.decode_matrix(ref, jnp.asarray(mask)))
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
        # node-hit rows are exact one-hots in both
        np.testing.assert_array_equal(got == 1.0, want == 1.0)


def test_systematic_hit_on_masked_node_interpolates():
    """A node hit on an unavailable node must not produce a one-hot row."""
    ref, port = _pair(4, 2, 0, True)
    mask = np.ones(ref.num_workers, np.float32)
    mask[0] = 0.0                       # the first anchor's own node
    got = tb.decode_matrix(port, torch.from_numpy(mask)).numpy()
    want = np.asarray(jb.decode_matrix(ref, jnp.asarray(mask)))
    assert got[0, 0] == 0.0 and not np.any(got[0] == 1.0)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_basis_matrix_without_mask_matches():
    z = np.linspace(-0.9, 0.9, 5)
    x = np.cos(np.arange(7) * np.pi / 6)
    w = tb.berrut_weights(7)
    got = tb.basis_matrix(torch.tensor(z), torch.tensor(x),
                          torch.tensor(w)).numpy()
    want = np.asarray(jb.basis_matrix(z, x, w))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
