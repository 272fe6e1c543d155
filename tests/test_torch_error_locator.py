"""Port parity: ``repro_torch.core.error_locator`` against
``repro.core.error_locator``.

Continuous results (design matrices, |Q| magnitudes) agree within fp32
tolerances; the discrete verdicts (``located``, ``votes``) must agree
exactly on cases whose corruption is well separated (sigma >= 10).
"""

import pytest

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
torch = pytest.importorskip("torch")
import _torch_threads  # noqa: E402,F401

from repro.core import error_locator as jl  # noqa: E402
from repro.core.berrut import CodingConfig  # noqa: E402
from repro_torch.core import error_locator as tl  # noqa: E402


def _rational_block(cfg, g, c, seed):
    """(G, N+1, C) exact evaluations of random degree-(K-1, K-1) rational
    functions at the beta nodes, float32."""
    rng = np.random.RandomState(seed)
    betas = np.asarray(cfg.betas)
    t = np.asarray(jl.chebyshev_design(jnp.asarray(betas, jnp.float32),
                                       cfg.k - 1))
    p = rng.randn(g, c, cfg.k)
    q = rng.randn(g, c, cfg.k) * 0.1
    q[..., 0] = 1.0
    vals = (p @ t.T) / (q @ t.T)                          # (G, C, N+1)
    return np.swapaxes(vals, 1, 2).astype(np.float32)


_jit_locate_groups = jax.jit(jl.locate_groups, static_argnames=("k", "e"))


def _both_locate(cfg, vals, avail):
    betas = np.asarray(cfg.betas, np.float32)
    jloc, jvotes = _jit_locate_groups(jnp.asarray(betas), jnp.asarray(vals),
                                    jnp.asarray(avail), k=cfg.k, e=cfg.e)
    tloc, tvotes = tl.locate_groups(torch.from_numpy(betas),
                                    torch.from_numpy(vals),
                                    torch.from_numpy(avail), k=cfg.k,
                                    e=cfg.e)
    return (np.asarray(jloc), np.asarray(jvotes), tloc.numpy(),
            tvotes.numpy())


def test_chebyshev_design_and_rational_eval_match():
    x = np.linspace(-1, 1, 9).astype(np.float32)
    np.testing.assert_allclose(
        tl.chebyshev_design(torch.from_numpy(x), 6).numpy(),
        np.asarray(jl.chebyshev_design(jnp.asarray(x), 6)),
        rtol=1e-6, atol=1e-6)
    p = np.array([0.5, -1.0, 0.25], np.float32)
    q = np.array([1.0, 0.1, -0.05], np.float32)
    np.testing.assert_allclose(
        tl.rational_eval(torch.from_numpy(x), torch.from_numpy(p),
                         torch.from_numpy(q)).numpy(),
        np.asarray(jl.rational_eval(jnp.asarray(x), jnp.asarray(p),
                                    jnp.asarray(q))), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("k,e", [(4, 1), (8, 2)])
def test_q_magnitudes_match_and_locate_errors(k, e):
    cfg = CodingConfig(k=k, s=0, e=e)
    vals = _rational_block(cfg, 1, 1, seed=k + e)[0, :, 0]
    bad = np.linspace(3, cfg.num_workers - 4, e).round().astype(int)
    vals[bad] += 25.0
    betas = np.asarray(cfg.betas, np.float32)
    mask = np.ones(cfg.num_workers, np.float32)
    want = np.asarray(jax.jit(jl.q_magnitudes, static_argnums=(3, 4))(
        jnp.asarray(betas), jnp.asarray(vals), jnp.asarray(mask), k, e))
    got = tl.q_magnitudes(torch.from_numpy(betas), torch.from_numpy(vals),
                          torch.from_numpy(mask), k, e).numpy()
    # |Q| is the near-null direction of the ridge system: in fp32 two
    # evaluation orders of the reference alone (eager and jitted) differ
    # by ~5% on these inputs, so the magnitudes are not compared value by
    # value.  What the locator reads from them must agree: the E smallest,
    # each far below every clean node's.
    for q in (got, want):
        assert set(np.argsort(q)[:e]) == set(bad)
        assert q[bad].max() * 100 < np.delete(q, bad).min()
    # the ungated single-group Algorithm 2 flags exactly E workers
    block = _rational_block(cfg, 1, 16, seed=3)[0]
    block[bad] += 25.0 * np.random.RandomState(0).randn(e, 16)
    got = tl.locate_errors(torch.from_numpy(betas), torch.from_numpy(block),
                           torch.from_numpy(mask), k=k, e=e).numpy()
    want = np.asarray(jl.locate_errors(jnp.asarray(betas),
                                       jnp.asarray(block), jnp.asarray(mask),
                                       k=k, e=e))
    np.testing.assert_array_equal(got, want)
    assert set(np.flatnonzero(got)) == set(bad)


@pytest.mark.parametrize("k,s,e,sigma", [(4, 1, 1, 10.0), (4, 1, 1, 100.0),
                                         (8, 1, 1, 10.0), (8, 1, 2, 10.0)])
def test_locate_groups_verdicts_exact_under_attack(k, s, e, sigma):
    """Verdicts match exactly; with E = 1 so do the raw votes.  With
    E = 2 each coordinate's second pick can be a near-tie between clean
    workers, so only the pooled verdict is held exact there."""
    cfg = CodingConfig(k=k, s=s, e=e)
    g, c = 3, 32
    vals = _rational_block(cfg, g, c, seed=k * 31 + e)
    rng = np.random.RandomState(k + e)
    bad = rng.choice(np.arange(1, cfg.num_workers - 1), e, replace=False)
    vals[:, bad] += sigma * rng.randn(g, e, c).astype(np.float32)
    avail = np.ones(cfg.num_workers, np.float32)
    straggler = [i for i in range(cfg.num_workers) if i not in bad][0]
    avail[straggler] = 0.0
    jloc, jvotes, tloc, tvotes = _both_locate(cfg, vals, avail)
    if e == 1:
        np.testing.assert_array_equal(tvotes, jvotes)
    np.testing.assert_array_equal(tloc, jloc)
    assert set(np.flatnonzero(tloc.any(0))) == set(bad)


def test_locate_groups_per_group_masks_and_clean_rounds():
    """Per-group availability; a clean block locates nobody in either."""
    cfg = CodingConfig(k=4, s=1, e=1)
    g, c = 2, 24
    vals = _rational_block(cfg, g, c, seed=5)
    avail = np.ones((g, cfg.num_workers), np.float32)
    avail[0, 2] = avail[1, 7] = 0.0
    jloc, _, tloc, tvotes = _both_locate(cfg, vals, avail)
    np.testing.assert_array_equal(tloc, jloc)
    assert not tloc.any()
    assert tvotes[0, 2] == -1 and tvotes[1, 7] == -1
    vals[:, 5] += 10.0 * np.random.RandomState(1).randn(g, c)
    jloc, jvotes, tloc, tvotes = _both_locate(cfg, vals, avail)
    np.testing.assert_array_equal(tvotes, jvotes)
    np.testing.assert_array_equal(tloc, jloc)
    assert tloc[:, 5].all()


def test_e0_locates_nothing():
    cfg = CodingConfig(k=4, s=1, e=0)
    vals = _rational_block(cfg, 2, 8, seed=2)
    loc, votes = tl.locate_groups(torch.tensor(cfg.betas, dtype=torch.float32),
                                  torch.from_numpy(vals),
                                  torch.ones(cfg.num_workers), k=4, e=0)
    assert loc.shape == (2, cfg.num_workers) and not loc.any()
    assert votes.dtype == torch.int32 and not votes.any()


@pytest.mark.parametrize("v,c_vote", [(512, 64), (1000, 64), (10, 64),
                                      (151936, 64)])
def test_vote_layout_and_gather_match(v, c_vote):
    assert tl.vote_layout(v, c_vote) == jl.vote_layout(v, c_vote)
    block = np.random.RandomState(v).randn(2, 3, v).astype(np.float32)
    np.testing.assert_array_equal(
        tl.gather_vote_values(torch.from_numpy(block), c_vote).numpy(),
        np.asarray(jl.gather_vote_values(jnp.asarray(block), c_vote)))
