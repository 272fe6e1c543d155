"""Port parity of the redundancy schemes: ``repro_torch.core.scheme``
(uncoded, replication, parm), ``core.replication``, ``core.parity``,
``core.nercc``, ``core.invnet``, the locator helpers of
``core.error_locator`` and the scheme-generic path of
``repro_torch.launch.serve``.

The same numpy inputs go through the reference and the port: a small
MLP and a linear model (the ``tests/test_scheme.py`` workloads) for each
scheme's plan, encode, forward (the parity streams' ``parity_fn``
included), decode under full, straggler and per-group masks, and locate;
``serve.run(scheme=...)`` on reduced qwen3-0.6b with the reference's
weights for the whole path.  Continuous outputs are held to fp32
tolerances (``TOL``; the whole path to the logits' ``LOGIT_TOL``);
plans, masks, verdicts, votes, tokens and event traces must be equal.
NeRCC's encode matrix and Coded-InvNet's mixture coefficients and flow
weights are numpy float64 computations cast to float32 in both packages,
so they are held bitwise.
"""

import dataclasses
import itertools

import pytest

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
torch = pytest.importorskip("torch")
import _torch_threads  # noqa: E402,F401

from _torch_parity import share_noise  # noqa: E402
from repro.configs import qwen3_0_6b as jcfg  # noqa: E402
from repro.core import error_locator as jel  # noqa: E402
from repro.core import invnet as jinv  # noqa: E402
from repro.core import nercc as jnercc  # noqa: E402
from repro.core import parity as jpar  # noqa: E402
from repro.core import replication as jrep  # noqa: E402
from repro.core import scheme as jscheme  # noqa: E402
from repro.core.berrut import CodingConfig as JCoding  # noqa: E402
from repro.core.berrut import encode as j_berrut_encode  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.models import init_params as j_init_params  # noqa: E402
from repro.serving import controller as jctl  # noqa: E402
from repro.serving import latency as jlat  # noqa: E402
from repro.serving import scheduler as jsched  # noqa: E402
from repro_torch.core import error_locator as tel  # noqa: E402
from repro_torch.core import invnet as tinv  # noqa: E402
from repro_torch.core import nercc as tnercc  # noqa: E402
from repro_torch.core import parity as tpar  # noqa: E402
from repro_torch.core import replication as trep  # noqa: E402
from repro_torch.core import scheme as tscheme  # noqa: E402
from repro_torch.core.berrut import CodingConfig as TCoding  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.serving import controller as tctl  # noqa: E402
from repro_torch.serving import latency as tlat  # noqa: E402
from repro_torch.serving import scheduler as tsched  # noqa: E402

K = 4
# fp32: the two packages' matmuls, solves and flows round differently
TOL = dict(rtol=1e-5, atol=1e-5)
# the whole path's logits: 1e-4 of max(1, max |logits|), as the port's
# other whole-path checks hold them
LOGIT_TOL = 1e-4
SCHEMES = ("uncoded", "replication", "parm", "nercc", "invnet")


def _weights(seed=0, d_in=16, d_h=64, n_cls=10):
    rng = np.random.RandomState(seed)
    return ((rng.randn(d_in, d_h) / np.sqrt(d_in)).astype(np.float32),
            (rng.randn(d_h, n_cls) / np.sqrt(d_h)).astype(np.float32),
            (rng.randn(d_in, n_cls) / np.sqrt(d_in)).astype(np.float32))


W1, W2, WL = _weights()
MODELS = {
    "mlp": (jax.jit(lambda x: jnp.tanh(x @ W1) @ W2),
            lambda x: torch.tanh(x @ torch.from_numpy(W1))
            @ torch.from_numpy(W2)),
    "linear": (jax.jit(lambda x: x @ WL),
               lambda x: x @ torch.from_numpy(WL)),
}


def _queries(n=8, d=16, seed=3):
    return np.random.RandomState(seed).randn(n, d).astype(np.float32)


def _both(name, k=K, **kw):
    return (jscheme.get_scheme(name, k, **kw),
            tscheme.get_scheme(name, k, **kw))


def _masks(scheme, groups, seed):
    """Full availability, single drops of the first, a data-side and the
    last worker, and per-group (G, W) masks down to the decode quorum."""
    w = scheme.num_workers
    out = [np.ones(w, np.float32)]
    for drop in sorted({0, scheme.k - 1, w - 1}):
        m = np.ones(w, np.float32)
        m[drop] = 0.0
        out.append(m)
    rng = np.random.RandomState(seed)
    per = np.ones((groups, w), np.float32)
    for g in range(groups):
        per[g, rng.choice(w, w - scheme.decode_quorum, replace=False)] = 0.0
    out.append(per)
    return out


def _ill_posed(scheme, mask, groups):
    """Coded-InvNet masks whose least squares is overdetermined: some
    group misses fewer data streams than it has parity streams.  For a
    nonlinear model those equations disagree, and the 1e-8 ridge
    amplifies their disagreement's rounding by 1e8 in both packages, so
    no two implementations agree there (the linear fallback's equations
    agree, and it is held on every mask)."""
    m = np.broadcast_to(mask, (groups, scheme.num_workers))
    missing = (m[:, :scheme.k] < 0.5).sum(1)
    return bool(((missing > 0)
                 & (missing < (m[:, scheme.k:] > 0.5).sum(1))).any())


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **tol)


# ------------------------------------------------------------ registry

def test_registry_names_and_descriptions():
    assert tscheme.scheme_names() == jscheme.scheme_names()
    assert len(tscheme.scheme_names()) == 6
    assert tscheme.list_schemes() == jscheme.list_schemes()
    with pytest.raises(ValueError, match="unknown scheme"):
        tscheme.get_scheme("raptorq", K)


@pytest.mark.parametrize("name", sorted(jscheme.scheme_names()))
@pytest.mark.parametrize("k,s,e", [(4, 1, 0), (4, 2, 0), (4, 1, 1),
                                   (3, 0, 1), (2, 3, 2)])
def test_plan_geometry_and_validation(name, k, s, e):
    """Each scheme's geometry and locator flag, or the reference's
    refusal of the operating point with its message."""
    try:
        js = jscheme.get_scheme(name, k, s=s, e=e)
    except ValueError as err:
        with pytest.raises(ValueError) as got:
            tscheme.get_scheme(name, k, s=s, e=e)
        assert str(got.value) == str(err)
        return
    ts = tscheme.get_scheme(name, k, s=s, e=e)
    assert type(ts).__name__ == type(js).__name__
    assert dataclasses.asdict(ts.plan(3)) == dataclasses.asdict(js.plan(3))
    assert ts.has_locator == js.has_locator
    assert ts.overhead == js.overhead
    assert dataclasses.asdict(ts.config) == dataclasses.asdict(js.config)
    hash(ts.config)


def test_with_redundancy_keeps_each_schemes_knobs():
    """The base class re-plans through the registry; NeRCC keeps its
    regression knobs, InvNet its flow and parity model, berrut c_vote."""
    assert tscheme.get_scheme("replication", K).with_redundancy(
        e=1).num_workers == 3 * K
    re = tscheme.get_scheme("nercc", K, lambda_dec=1e-4, degree_dec=2,
                            c_vote=12).with_redundancy(s=2, e=1)
    assert isinstance(re, tnercc.NeRCCScheme)
    assert (re.s, re.e, re.config.lambda_dec, re.config.degree_dec,
            re.config.c_vote) == (2, 1, 1e-4, 2, 12)
    assert re.with_redundancy(s=2, e=1) is re
    flow = tinv.CouplingFlow(16, seed=3)
    fn = MODELS["mlp"][1]
    inv = tscheme.get_scheme("invnet", K, flow=flow, parity_fn=fn)
    wider = inv.with_redundancy(s=2)
    assert (wider.flow, wider.parity_fn, wider.num_workers) == (flow, fn,
                                                                K + 2)
    with pytest.raises(ValueError, match="Byzantine"):
        inv.with_redundancy(e=1)
    with pytest.raises(ValueError, match="S=1"):
        tscheme.get_scheme("parm", K).with_redundancy(s=2)


# ------------------------------------------------------- each scheme

CASES = [("uncoded", {}, "mlp"), ("replication", {}, "mlp"),
         ("replication", dict(s=2), "linear"),
         ("replication", dict(e=1), "mlp"), ("parm", {}, "linear"),
         ("parm", {}, "mlp"), ("parm", dict(parity_fn=True), "mlp"),
         ("nercc", {}, "mlp"), ("nercc", dict(s=2, lambda_dec=1e-3,
                                              degree_dec=2), "mlp"),
         ("invnet", {}, "mlp"), ("invnet", dict(s=2, flow=None), "linear"),
         ("invnet", dict(s=2, parity_fn=True), "mlp")]


@pytest.mark.parametrize("name,kw,model", CASES,
                         ids=[f"{n}-{'-'.join(map(str, kw.values())) or 'default'}-{m}"
                              for n, kw, m in CASES])
def test_encode_forward_decode_locate(name, kw, model):
    """The same queries through both packages: encode, forward (the
    parity streams through ``parity_fn`` where given: the linear model),
    decode under every single drop and a per-group mask, and the
    locator-free ``locate``."""
    jf, tf = MODELS[model]
    kw = dict(kw)
    extra = {}
    if kw.pop("parity_fn", False):
        extra = {"jax": dict(parity_fn=MODELS["linear"][0]),
                 "torch": dict(parity_fn=MODELS["linear"][1])}
    js = jscheme.get_scheme(name, K, **kw, **extra.get("jax", {}))
    ts = tscheme.get_scheme(name, K, **kw, **extra.get("torch", {}))
    q = _queries()
    grouped = q.reshape(-1, K, 16)
    jc = js.encode(jnp.asarray(grouped))
    tc = ts.encode(torch.from_numpy(grouped))
    _close(tc, jc)
    jo = js.forward(jf, jc)
    to = ts.forward(tf, tc)
    _close(to, jo)
    # decode the reference's worker outputs on both sides
    outs = np.asarray(jo)
    consistent = model == "linear" and (name != "invnet" or js.flow is None)
    for mask in _masks(js, outs.shape[0], seed=len(name)):
        if not consistent and name == "invnet" and _ill_posed(
                js, mask, outs.shape[0]):
            continue
        want = js.decode(jnp.asarray(outs), jnp.asarray(mask))
        got = ts.decode(torch.from_numpy(outs), torch.from_numpy(mask))
        assert got.shape == want.shape
        _close(got, want, dict(rtol=1e-5, atol=1e-4))
    full = np.ones(js.num_workers, np.float32)
    jd = js.locate(jnp.asarray(outs), jnp.asarray(full))
    td = ts.locate(torch.from_numpy(outs), torch.from_numpy(full))
    _close(td[0], jd[0])
    for got, want in zip(td[1:], jd[1:]):
        np.testing.assert_array_equal(got, np.asarray(want))
    assert not td[1].any() and not ts.has_locator


@pytest.mark.parametrize("k,s,e,degree,lam", [
    (4, 1, 0, -1, 0.0), (8, 1, 1, 3, 1e-3), (3, 0, 2, 1, 0.5)])
def test_nercc_matrices(k, s, e, degree, lam):
    """The encode matrix is the reference's bitwise; decode matrices for
    a shared and a per-group mask within fp32 tolerance."""
    np.testing.assert_array_equal(
        tnercc._encode_matrix_np(k, s, e, degree, lam),
        jnercc._encode_matrix_np(k, s, e, degree, lam))
    jc = jnercc.NeRCCConfig(k=k, s=s, e=e, degree_enc=degree,
                            lambda_enc=lam, lambda_dec=lam or 1e-6)
    tc = tnercc.NeRCCConfig(**dataclasses.asdict(jc))
    np.testing.assert_array_equal(tnercc.encode_matrix(tc).numpy(),
                                  np.asarray(jnercc.encode_matrix(jc)))
    # down to the decode quorum: below it the Gram matrix is held only by
    # the ridge, and its solve amplifies rounding alike in both packages
    rng = np.random.RandomState(k + s + e)
    masks = np.ones((3, jc.num_workers), np.float32)
    for m in masks:
        m[rng.choice(jc.num_workers, jc.num_workers - jc.decode_quorum,
                     replace=False)] = 0.0
    want = jax.vmap(lambda m: jnercc.decode_matrix(jc, m))(masks)
    _close(tnercc.decode_matrix(tc, torch.from_numpy(masks)), want,
           dict(rtol=1e-4, atol=1e-4))
    _close(tnercc.decode_matrix(tc, torch.from_numpy(masks[0])), want[0],
           dict(rtol=1e-4, atol=1e-4))


def _liar_outputs(scheme, f, liar=3, shift=50.0, seed=5, n=2 * K):
    q = _queries(n=n, seed=seed).reshape(-1, K, 16)
    outs = np.array(scheme.forward(f, scheme.encode(jnp.asarray(q))))
    if liar is not None:
        outs[:, liar] += shift
    return outs


@pytest.mark.parametrize("liar,mask_drop", [(3, 7), (None, None), (0, 5)])
def test_nercc_votes_and_locate_match_reference(liar, mask_drop):
    """``_group_votes`` and ``locate`` at E=1 on the MLP's coded outputs,
    a loud liar (or none) and an optional straggler: votes, verdicts and
    masks equal (the cases have a margin), decodes within tolerance."""
    js, ts = _both("nercc", s=1, e=1, c_vote=10)
    outs = _liar_outputs(js, MODELS["mlp"][0], liar=liar)
    mask = np.ones(js.num_workers, np.float32)
    if mask_drop is not None:
        mask[mask_drop] = 0.0
    g = outs.shape[0]
    vals = np.asarray(jel.gather_vote_values(jnp.asarray(outs), 10))
    avail2d = np.broadcast_to(mask, (g, js.num_workers)).copy()
    jv = jnercc._group_votes(js.config, jnp.asarray(vals),
                             jnp.asarray(avail2d))
    tv = tnercc._group_votes(ts.config, torch.from_numpy(vals),
                             torch.from_numpy(avail2d))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    jd = js.locate(jnp.asarray(outs), jnp.asarray(mask))
    td = ts.locate(torch.from_numpy(outs), torch.from_numpy(mask))
    _close(td[0], jd[0], dict(rtol=1e-5, atol=1e-4))
    for got, want in zip(td[1:], jd[1:]):
        np.testing.assert_array_equal(got, np.asarray(want))
    if liar is not None:
        assert td[1][:, liar].all() and td[1].sum() == g
    else:
        assert not td[1].any()
    # decode(locate=None) at E > 0 goes through the locator
    np.testing.assert_array_equal(
        ts.decode(torch.from_numpy(outs), torch.from_numpy(mask)).numpy(),
        td[0].numpy())


def test_nercc_locator_finds_a_liar_and_stays_silent():
    """``tests/test_nercc_invnet.py``'s locator checks on the port alone:
    a worker 50 off is located in every group and excluding it recovers
    the honest survivors' decode; a clean round locates nobody."""
    ts = tscheme.get_scheme("nercc", K, s=1, e=1, c_vote=10)
    tf = MODELS["mlp"][1]
    q = torch.from_numpy(_queries(n=2 * K, seed=5)).reshape(-1, K, 16)
    clean = ts.forward(tf, ts.encode(q))
    drop = torch.ones(ts.num_workers)
    drop[3] = 0.0
    ref = ts.decode(clean, drop, locate=False)
    outs = clean.clone()
    outs[:, 3] += 50.0
    decoded, located, _, masks = ts.locate(outs, torch.ones(ts.num_workers))
    assert located[:, 3].all() and located.sum() == located.shape[0]
    assert (masks[:, 3] == 0).all()
    _close(decoded, ref, dict(rtol=1e-4, atol=1e-4))
    q = torch.from_numpy(_queries(n=4 * K, seed=6)).reshape(-1, K, 16)
    decoded, located, _, masks = ts.locate(ts.forward(tf, ts.encode(q)),
                                           torch.ones(ts.num_workers))
    assert not located.any() and (masks == 1).all()


def test_invnet_coefficients_and_flow_bitwise():
    for k, s in ((4, 1), (4, 2), (5, 3), (1, 1)):
        np.testing.assert_array_equal(tinv._mixup_coeffs_np(k, s),
                                      jinv._mixup_coeffs_np(k, s))
    jflow = jinv.CouplingFlow(16, depth=3, hidden=8, seed=1)
    tflow = tinv.CouplingFlow(16, depth=3, hidden=8, seed=1)
    for jl, tl in zip(jflow.layers, tflow.layers):
        for ja, ta in zip(jl, tl):
            np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    x = np.random.RandomState(2).randn(5, 16).astype(np.float32)
    tx = torch.from_numpy(x)
    _close(tflow.forward(tx), jflow.forward(jnp.asarray(x)))
    _close(tflow.inverse(tflow.forward(tx)), x)
    assert (tflow.forward(tx) - tx).abs().max() > 0.01
    with pytest.raises(ValueError, match="dim >= 2"):
        tinv.CouplingFlow(1)


def test_invnet_recovers_any_two_failures_exactly():
    """S=2 parity streams recover any two failed data streams of a linear
    model (fallback mode), as the reference's do."""
    tf = MODELS["linear"][1]
    ts = tscheme.get_scheme("invnet", K, s=2, flow=None)
    q = torch.from_numpy(_queries(n=2 * K, seed=8))
    outs = ts.forward(tf, ts.encode(q.reshape(-1, K, 16)))
    for drops in itertools.combinations(range(K), 2):
        m = torch.ones(ts.num_workers)
        m[list(drops)] = 0.0
        _close(ts.decode(outs, m), tf(q), dict(rtol=1e-3, atol=1e-3))


# -------------------------------------------------- replication, parity

def test_recover_from_replicas_even_count():
    """E=1 over three replicas with one masked out: the median of the two
    left is their mean, as ``jnp.nanmedian`` takes it (torch's nanmedian
    would answer the lower one); all masked answers zeros; E=0 takes the
    first available replica."""
    rng = np.random.RandomState(0)
    preds = rng.randn(4, 3, 6).astype(np.float32)
    mask = np.array([[0, 1, 1], [1, 0, 1], [1, 1, 1], [0, 0, 0]],
                    np.float32)
    got = trep.recover_from_replicas(torch.from_numpy(preds),
                                     torch.from_numpy(mask), 1).numpy()
    want = np.asarray(jrep.recover_from_replicas(jnp.asarray(preds),
                                                 jnp.asarray(mask), 1))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(got[0], preds[0, 1:].mean(0), rtol=1e-6)
    np.testing.assert_allclose(got[1], preds[1, [0, 2]].mean(0), rtol=1e-6)
    assert not np.allclose(got[0], np.minimum(preds[0, 1], preds[0, 2]))
    np.testing.assert_array_equal(got[2], np.median(preds[2], 0))
    assert not got[3].any()
    for m in (mask, mask[2]):
        np.testing.assert_array_equal(
            trep.recover_from_replicas(torch.from_numpy(preds),
                                       torch.from_numpy(m), 0).numpy(),
            np.asarray(jrep.recover_from_replicas(jnp.asarray(preds),
                                                  jnp.asarray(m), 0)))


@pytest.mark.parametrize("s,e", [(2, 0), (0, 1)])
def test_replicated_inference_matches_reference(s, e):
    """The pipeline with a per-query mask and a corrupted replica, the
    reference's noise handed over by value."""
    jf, tf = MODELS["mlp"]
    q = _queries(n=6)
    r = (s + 1) if e == 0 else (2 * e + 1)
    mask = np.ones((6, r), np.float32)
    mask[np.arange(6), np.random.RandomState(1).randint(0, r, 6)] = 0.0
    byz = np.zeros(r, np.float32)
    byz[0] = 1.0
    key = jax.random.PRNGKey(4)
    want = jrep.replicated_inference(jf, jnp.asarray(q), s=s, e=e,
                                     straggler_mask=jnp.asarray(mask),
                                     byz_mask=jnp.asarray(byz), byz_rng=key,
                                     byz_sigma=100.0)
    noise = np.asarray(jax.random.normal(key, (6, r, 10), jnp.float32))
    got = trep.replicated_inference(tf, torch.from_numpy(q), s=s, e=e,
                                    straggler_mask=torch.from_numpy(mask),
                                    byz_mask=torch.from_numpy(byz),
                                    byz_noise=torch.from_numpy(noise),
                                    byz_sigma=100.0)
    _close(got, want, dict(rtol=1e-5, atol=1e-4))
    assert trep.replication_workers(K, s, e) == jrep.replication_workers(
        K, s, e)
    gen = trep.replicated_inference(
        tf, torch.from_numpy(q), s=s, e=e, byz_mask=torch.from_numpy(byz),
        byz_generator=torch.Generator().manual_seed(0), byz_sigma=100.0)
    assert gen.shape == (6, 10) and torch.isfinite(gen).all()


@pytest.mark.parametrize("straggler", [0, 2, 3])
def test_parity_pipeline_matches_reference(straggler):
    jf, tf = MODELS["mlp"]
    jl, tl = MODELS["linear"]
    q = _queries()
    g = q.reshape(-1, K, 16)
    _close(tpar.parity_query(torch.from_numpy(g)),
           jpar.parity_query(jnp.asarray(g)))
    preds = np.asarray(jf(jnp.asarray(q))).reshape(-1, K, 10)
    _close(tpar.parity_target(torch.from_numpy(preds)),
           jpar.parity_target(jnp.asarray(preds)))
    _close(tpar.parity_distillation_loss(
               lambda p, x: x @ p, torch.from_numpy(WL),
               torch.from_numpy(g), torch.from_numpy(preds)),
           jpar.parity_distillation_loss(
               lambda p, x: x @ p, jnp.asarray(WL), jnp.asarray(g),
               jnp.asarray(preds)))
    _close(tpar.parm_inference(tf, tl, torch.from_numpy(q), K,
                               straggler=straggler),
           jpar.parm_inference(jf, jl, jnp.asarray(q), K,
                               straggler=straggler))
    # a linear model is its own ideal parity model: exact reconstruction
    _close(tpar.parm_inference(tl, tl, torch.from_numpy(q), K,
                               straggler=straggler),
           tl(torch.from_numpy(q)), dict(rtol=1e-4, atol=1e-5))


# ------------------------------------------------------ locator helpers

def test_locator_helpers_match_reference():
    """``vote_coordinates`` and ``locate_errors_from_logits`` on Berrut-
    coded logits of the MLP with a liar, and on clean ones."""
    for c, v in ((10, 64), (151936, 64), (50, 7)):
        np.testing.assert_array_equal(
            tel.vote_coordinates(c, v).numpy(),
            np.asarray(jel.vote_coordinates(c, v)))
    jcod, tcod = JCoding(k=K, s=1, e=1, c_vote=8), TCoding(k=K, s=1, e=1,
                                                           c_vote=8)
    q = _queries(n=K, seed=9)
    coded = np.asarray(MODELS["mlp"][0](j_berrut_encode(jcod,
                                                        jnp.asarray(q))))
    mask = np.ones(jcod.num_workers, np.float32)
    for liar in (5, None):
        logits = coded.copy()
        if liar is not None:
            logits[liar] += 40.0
        want = np.asarray(jel.locate_errors_from_logits(
            jcod, jnp.asarray(jcod.betas, jnp.float32),
            jnp.asarray(logits), jnp.asarray(mask)))
        got = tel.locate_errors_from_logits(
            tcod, torch.as_tensor(tcod.betas, dtype=torch.float32),
            torch.from_numpy(logits), torch.from_numpy(mask)).numpy()
        np.testing.assert_array_equal(got, want)
        assert got.sum() == (liar is not None)


# ------------------------------------------------------------ controller

def _observe(ctl, rounds, straggle):
    for r in range(rounds):
        n = ctl.scheme.num_workers
        times = np.full(n, 1.0)
        times[:straggle(n)] = 100.0
        ctl.observe_round(float(r), times, trigger_ms=100.0)
    return ctl


@pytest.mark.parametrize("name", ["nercc", "invnet"])
def test_controller_replans_nercc_and_invnet(name):
    """``tests/test_nercc_invnet.py``'s controller checks: NeRCC re-plans
    across (S, E) keeping its knobs, InvNet within E = 0 (an E range
    above it fails at construction); decision logs equal the
    reference's."""
    if name == "nercc":
        kw, bounds = dict(lambda_dec=1e-4), dict(s_min=0, s_max=3, e_min=0,
                                                 e_max=2)
        straggle = (lambda n: 2 + n // 2)
    else:
        kw, bounds = {}, dict(s_min=1, s_max=3, e_min=0, e_max=0)
        straggle = (lambda n: n)
    logs = []
    for side, sch, ctl in (("jax", jscheme, jctl), ("torch", tscheme, tctl)):
        c = _observe(ctl.RedundancyController(
            sch.get_scheme(name, K, s=1, **kw),
            ctl.ControllerConfig(window_rounds=4, straggle_ms=10.0,
                                 grow_s_above=0.2, **bounds)), 8, straggle)
        logs.append(c.decision_log())
        assert c.scheme.num_workers > c.decisions[0].num_workers
        assert c.scheme.name == name and c.wait_for == c.scheme.decode_quorum
        if name == "nercc":
            assert c.scheme.config.lambda_dec == 1e-4
    assert logs[0] == logs[1]
    with pytest.raises(ValueError, match="Byzantine"):
        tctl.RedundancyController(
            tscheme.get_scheme("invnet", K, s=1),
            tctl.ControllerConfig(s_min=1, s_max=3, e_min=0, e_max=1))


# ------------------------------------------------ the scheduler faceoff

@pytest.mark.parametrize("name", sorted(tscheme.scheme_names()))
def test_scheme_serves_end_to_end(name, monkeypatch):
    """``TestSchedulerFaceoff.test_scheme_serves_end_to_end`` over the
    port's registry: every scheme serves the same trace through the same
    event loop, each batch decoding at exactly its quorum; the exact
    schemes agree with the clean model; the trace and outputs equal the
    reference's."""
    jf, tf = MODELS["mlp"]
    s = 1 if name != "uncoded" else 0
    rng = np.random.RandomState(7)
    n = 24
    payloads = [rng.randn(16).astype(np.float32) for _ in range(n)]
    arrivals = jsched.poisson_arrivals(n, 5000.0, seed=1)
    runs = []
    for side, sch, sched, lat, f in (
            ("jax", jscheme, jsched, jlat, jf),
            ("torch", tscheme, tsched, tlat, tf)):
        scheme = sch.get_scheme(name, K, s=s)
        kw = {} if side == "jax" else {"device": "cpu"}
        run = sched.CodedScheduler(
            sched.SchedulerConfig(scheme=scheme, groups_per_batch=2,
                                  flush_deadline_ms=2.0, seed=0),
            lat.LatencyModel(), sched.EngineExecutor(f, scheme, **kw))
        metrics = run.run(payloads, arrivals)
        runs.append(run)
    jrun, trun = runs
    assert metrics.count == n and sorted(trun.results) == list(range(n))
    for batch in trun.batches:
        assert batch.mask.shape == (trun.scheme.num_workers,)
        assert batch.mask.sum() == trun.scheme.decode_quorum
    assert trun.trace == jrun.trace
    for uid in range(n):
        _close(trun.results[uid], jrun.results[uid],
               dict(rtol=1e-5, atol=1e-4))
    clean = tf(torch.from_numpy(np.stack(payloads))).numpy()
    served = np.stack([trun.results[u] for u in range(n)])
    assert served.shape == clean.shape
    if name in ("uncoded", "replication"):
        assert (np.argmax(served, -1) == np.argmax(clean, -1)).all()


# ---------------------------------------------- serve --scheme, whole path

@pytest.fixture(scope="module")
def jparams():
    return j_init_params(jcfg.reduced(), jax.random.PRNGKey(0))


def _margin_rows(logits, tol):
    """Rows whose top-2 margin exceeds ``tol``: their argmax is fixed."""
    top2 = np.sort(logits, -1)[:, -2:]
    return (top2[:, 1] - top2[:, 0]) > tol


@pytest.mark.parametrize("name,e", [(n, 0) for n in SCHEMES]
                         + [("replication", 1), ("nercc", 1)])
def test_serve_scheme_matches_reference(name, e, jparams, monkeypatch):
    """``serve.run(scheme=...)`` at ``reduced=True`` on the CPU against
    the reference's ``serve.run`` on the same weights (the reference's,
    converted), prompts and latency seed, a persistent attacker at E=1
    with the reference's noise: event traces, stragglers and verdicts
    equal, served logits within the logits' tolerance and greedy tokens
    equal wherever the reference's top-2 margin is wider than it."""
    share_noise(monkeypatch)
    captured = []

    class Capture(jsched.CodedScheduler):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            captured.append(self)

    monkeypatch.setattr(jserve, "CodedScheduler", Capture)
    args = dict(requests=16, k=K, s=1, e=e, prompt_len=8, steps=2,
                byz_sigma=10.0)
    with jops.force_kernel("xla"):
        jtoks = jserve.run("qwen3-0.6b", True, scheme=name, **args)
    (jsch,) = captured
    tp = params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    monkeypatch.setattr(tserve, "init_params", lambda *a, **kw: tp)
    res = tserve.run("qwen3-0.6b", True, scheme=name, device="cpu", **args)
    assert res["trace"] == jsch.trace
    jlogits = np.stack([jsch.results[u] for u in range(16)])
    tol = LOGIT_TOL * max(1.0, np.abs(jlogits).max())
    np.testing.assert_allclose(res["logits"], jlogits, rtol=0, atol=tol)
    sure = _margin_rows(jlogits, 2 * tol)
    assert sure.sum() >= 12
    np.testing.assert_array_equal(res["tokens"][sure], jtoks[sure])
    assert res["tokens"].shape == (16, 1)
    for tb, jb in zip(res["batches"], jsch.batches):
        np.testing.assert_array_equal(tb.mask, jb.mask)
        if jb.round_reports[-1] is not None:
            np.testing.assert_array_equal(tb.round_reports[-1].located,
                                          jb.round_reports[-1].located)
    assert len(res["dispatch_ms"]) == len(res["batches"])
    assert res["forward_streams"]
    if name == "nercc" and e:
        assert res["precision"] == 1.0 and res["recall"] == 1.0


def test_serve_scheme_flags(capsys):
    """The reference's rules: ``--continuous`` serves berrut only;
    ``--quarantine`` without a locator is dropped with a warning; the
    adversary attacks the uncoded baseline at the CLI's E; ``--adaptive``
    re-plans a non-berrut scheme under the declared scheme."""
    with pytest.raises(ValueError, match="single-shot"):
        tserve.main(["--reduced", "--device", "cpu", "--scheme", "parm",
                     "--continuous"])
    res = tserve.main(["--reduced", "--device", "cpu", "--scheme",
                       "uncoded", "--e", "1", "--byz-sigma", "10",
                       "--quarantine", "--requests", "8"])
    out = capsys.readouterr().out
    assert "--quarantine is inactive for scheme 'uncoded'" in out
    assert len(res["attackers"]) == 1
    res = tserve.main(["--reduced", "--device", "cpu", "--scheme", "nercc",
                       "--e", "1", "--byz-sigma", "10", "--adaptive",
                       "--requests", "8"])
    assert res["decisions"][0] == (11, 1, 6, 0)
    assert "nercc: nested-regression" in capsys.readouterr().out
