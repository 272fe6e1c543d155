"""Port parity of the Mamba2 slice: ``repro_torch.models.mamba2``, the
"S" runs of the model and coded serving on mamba2-780m ``reduced()``
(2 layers, d_model 256, state 16, heads of 32, vocab 512) against the
JAX package on the plain CPU path, on the reference's own parameters
(``params_from_jax``) and the same numpy inputs.

Tolerances: block outputs, fp32 SSM states and conv windows within
rtol 1e-5, atol 1e-5; logits within rtol 1e-5, atol 1e-4 (another
summation order in every product); greedy tokens, ``located``, votes,
slot positions, the continuous scheduler's event trace, per-request
tokens and ``metrics.summary()`` exactly.  The Byzantine noise is the
reference's own draw handed to the port.  E=1 rounds wait for 2(K+E)
streams (ROADMAP queue C: at the bare K+2E quorum the locator has no
redundancy and fp32 rounding can decide a verdict).
"""

import dataclasses

import pytest

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
torch = pytest.importorskip("torch")
import _torch_threads  # noqa: E402,F401

from repro.configs import mamba2_780m as jcfg  # noqa: E402
from repro.core.berrut import CodingConfig as JCoding  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.models import decode_step as j_decode_step  # noqa: E402
from repro.models import init_caches as j_init_caches  # noqa: E402
from repro.models import init_params as j_init_params  # noqa: E402
from repro.models import mamba2 as jmamba2  # noqa: E402
from repro.models import prefill as j_prefill  # noqa: E402
from repro.serving import coded_serving as jcs  # noqa: E402
from repro.serving import continuous as jcont  # noqa: E402
from repro.serving import failures as jfail  # noqa: E402
from repro.serving import latency as jlat  # noqa: E402
from repro.serving import quarantine as jquar  # noqa: E402
from repro.serving import scheduler as jsched  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.configs import mamba2_780m as tcfg  # noqa: E402
from repro_torch.core.berrut import CodingConfig as TCoding  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import mamba2 as tmamba2  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.serving import coded_serving as tcs  # noqa: E402
from repro_torch.serving import continuous as tcont  # noqa: E402
from repro_torch.serving import failures as tfail  # noqa: E402
from repro_torch.serving import latency as tlat  # noqa: E402
from repro_torch.serving import quarantine as tquar  # noqa: E402

STATE_TOL = dict(rtol=1e-5, atol=1e-5)
LOGITS_TOL = dict(rtol=1e-5, atol=1e-4)
PROMPT, STEPS = 12, 3
MAX_LEN = PROMPT + STEPS + 2


@pytest.fixture(scope="module")
def model():
    jc, tc = jcfg.reduced(), tcfg.reduced()
    jp = j_init_params(jc, jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return jc, tc, jp, tp


def _signature(tree, path=""):
    """[(path, shape, dtype)] of every leaf of a dict/list tree."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in _signature(tree[k], f"{path}/{k}")]
    if isinstance(tree, list):
        return [x for i, v in enumerate(tree)
                for x in _signature(v, f"{path}/{i}")]
    return [(path, tuple(tree.shape), tree.dtype)]


def _assert_caches_close(tcaches, jcaches):
    for tr, jr in zip(tcaches, jcaches):
        assert sorted(tr) == sorted(jr) == ["conv", "state"]
        for name in tr:
            assert tr[name].dtype == getattr(torch, str(jr[name].dtype))
            np.testing.assert_allclose(tr[name].numpy(), np.asarray(jr[name]),
                                       **STATE_TOL)


# ------------------------------------------------------------- config

def test_config_copy_matches_reference():
    for jc, tc in ((jcfg.CONFIG, tcfg.CONFIG), (jcfg.reduced(),
                                                tcfg.reduced())):
        assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
        assert (tc.ssm_d_inner, tc.ssm_heads) == (jc.ssm_d_inner,
                                                  jc.ssm_heads)
    assert configs.get_config("mamba2-780m").layer_pattern == "S" * 48
    assert (tcfg.CONFIG.ssm_d_inner, tcfg.CONFIG.ssm_heads) == (3072, 48)


def test_check_ported_takes_ssm_and_still_refuses_moe_and_hybrid():
    """``check_ported`` takes the "S" model and, since the MoE and hybrid
    slice, "S" runs mixed with an "M" or a shared "G" block: each builds
    and its forward is finite (the audio and vlm refusals are held in
    ``tests/test_torch_archs.py``)."""
    transformer.check_ported(tcfg.CONFIG)
    for pattern in ("SSM", "SSG"):
        cfg = tcfg.reduced().with_updates(
            num_layers=3, layer_pattern=pattern, num_heads=4,
            num_kv_heads=4, d_ff=128, num_experts=4, experts_per_token=2,
            moe_d_ff=64, moe_group_size=8)
        transformer.check_ported(cfg)
        params = tmodel.init_params(cfg, torch.Generator().manual_seed(0),
                                    "cpu")
        logits, _ = tmodel.forward(
            cfg, params, {"tokens": torch.zeros(2, 5, dtype=torch.long)})
        assert torch.isfinite(logits).all()


# ------------------------------------------------------------- params

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_converted_params_have_the_port_structure(dtype):
    """The reference's tree converts leaf for leaf into the port's own
    ``init_params`` structure, shapes and dtypes; a_log, d_skip and
    dt_bias stay fp32 in a bf16 model."""
    jc = jcfg.reduced().with_updates(param_dtype=dtype)
    tc = tcfg.reduced().with_updates(param_dtype=dtype)
    conv = params_from_jax(
        jax.tree.map(np.asarray, j_init_params(jc, jax.random.PRNGKey(1))),
        device="cpu")
    own = tmodel.init_params(tc, torch.Generator("cpu").manual_seed(0),
                             "cpu")
    assert _signature(conv) == _signature(own)
    ssm = params_from_jax(jax.tree.map(
        np.asarray, j_init_params(jc, jax.random.PRNGKey(1))),
        device="cpu")["blocks"]["runs"][0]["ssm"]
    for name in ("a_log", "d_skip", "dt_bias"):
        assert ssm[name].dtype == torch.float32
    assert ssm["in_proj"].dtype == getattr(torch, dtype)


def test_port_init_matches_reference_scales(model):
    jc, tc, jp, _ = model
    own = tmodel.init_params(tc, torch.Generator("cpu").manual_seed(0),
                             "cpu")
    jssm = jax.tree.map(np.asarray, jp["blocks"]["runs"][0]["ssm"])
    for name, t in own["blocks"]["runs"][0]["ssm"].items():
        j = jssm[name]
        assert t.shape == j.shape
        np.testing.assert_allclose(t.std().item(), j.std(), rtol=0.1,
                                   atol=1e-6)
        np.testing.assert_allclose(t.abs().max().item(), np.abs(j).max(),
                                   rtol=0.1)


# ------------------------------------------------------------- blocks

def _layer(tree, i=0):
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


@pytest.mark.parametrize("ssm_chunk", [128, 8])
def test_block_prefill_and_decode_match_reference(model, ssm_chunk):
    """One "S" layer: prefill (chunk 12, or 8 halved to 4 for 12 steps),
    then decode steps, with the conv window and state written in place."""
    jc, tc, jp, tp = model
    jc = jc.with_updates(ssm_chunk=ssm_chunk)
    tc = tc.with_updates(ssm_chunk=ssm_chunk)
    jl = jax.tree.map(lambda a: a[0], jp["blocks"]["runs"][0])["ssm"]
    tl = _layer(tp["blocks"]["runs"][0])["ssm"]
    rng = np.random.RandomState(ssm_chunk)
    b = 3
    x = rng.randn(b, PROMPT, jc.d_model).astype(np.float32)
    jcache = jmamba2.init_ssm_cache(jc, b, jnp.float32)
    tcache = _layer(tmamba2.init_ssm_cache(tc, b, torch.float32, "cpu", 1))
    conv_buf, state_buf = tcache["conv"], tcache["state"]
    jprefill = jax.jit(lambda p, x, c: jmamba2.mamba2_prefill(jc, p, x, c))
    jdecode = jax.jit(lambda p, x, c: jmamba2.mamba2_decode(jc, p, x, c))
    with jops.force_kernel("xla"):
        jy, jcache = jprefill(jl, jnp.asarray(x), jcache)
        ty, tcache = tmamba2.mamba2_prefill(tc, tl, torch.from_numpy(x),
                                            tcache)
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **STATE_TOL)
        _assert_caches_close([tcache], [jcache])
        for _ in range(STEPS):
            xt = rng.randn(b, 1, jc.d_model).astype(np.float32)
            jy, jcache = jdecode(jl, jnp.asarray(xt), jcache)
            ty, tcache = tmamba2.mamba2_decode(tc, tl, torch.from_numpy(xt),
                                               tcache)
            np.testing.assert_allclose(ty.numpy(), np.asarray(jy),
                                       **STATE_TOL)
            _assert_caches_close([tcache], [jcache])
    # the caller's buffers hold the result (the run loops rely on it)
    assert tcache["conv"] is conv_buf and tcache["state"] is state_buf


def test_model_prefill_and_decode_match_reference(model):
    jc, tc, jp, tp = model
    b = 3
    tokens = np.random.RandomState(1).randint(0, jc.vocab_size, (b, PROMPT))
    jprefill = jax.jit(lambda p, i, c: j_prefill(jc, p, i, c))
    jdecode = jax.jit(lambda p, c, i, pos: j_decode_step(jc, p, c, i, pos))
    with jops.force_kernel("xla"):
        jl, jcache = jprefill(jp, {"tokens": jnp.asarray(tokens)},
                              j_init_caches(jc, b, MAX_LEN))
        tl, tcache = tmodel.prefill(
            tc, tp, {"tokens": torch.from_numpy(tokens)},
            tmodel.init_caches(tc, b, MAX_LEN, torch.float32, "cpu"))
        for step in range(STEPS + 1):
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                       **LOGITS_TOL)
            nxt = np.asarray(jnp.argmax(jl, -1))
            np.testing.assert_array_equal(tl.argmax(-1).numpy(), nxt)
            _assert_caches_close(tcache, jcache)
            if step == STEPS:
                break
            # per-stream positions and a live mask, as the slot pool
            # passes them: an "S" block ignores both
            pos = np.full(b, PROMPT + step, np.int32)
            jl, jcache = jdecode(jp, jcache,
                                 {"tokens": jnp.asarray(nxt)[:, None]},
                                 jnp.asarray(pos))
            tl, tcache = tmodel.decode_step(
                tc, tp, tcache, {"tokens": torch.tensor(nxt)[:, None]},
                torch.from_numpy(pos), live=torch.tensor([True, False, True]))


# ------------------------------------------------------------- coded rounds

def _jit_steps(jc, coding):
    prefill = jax.jit(
        lambda p, t, m, bm, br, lq: jcs.coded_prefill(
            jc, coding, p, {"tokens": t}, max_len=MAX_LEN, straggler_mask=m,
            byz_mask=bm, byz_rng=br, byz_sigma=10.0, with_report=True,
            locate_quorum=lq))
    decode = jax.jit(
        lambda p, st, t, m, bm, br, lq: jcs.coded_decode_step(
            jc, coding, p, st, t, straggler_mask=m, byz_mask=bm,
            byz_rng=br, byz_sigma=10.0, with_report=True, locate_quorum=lq))
    return prefill, decode


def _assert_round(tl, trep, jl, jrep):
    """Logits within tolerance; greedy tokens and ``located`` exactly.
    A worker's vote count may differ by one: each of the 64 vote
    coordinates picks its E suspects on its own, and a coordinate whose
    pick is a near tie in fp32 goes either way in another summation
    order (ROADMAP queue C); the verdict is the majority over them."""
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGITS_TOL)
    toks = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
    np.testing.assert_array_equal(tl.argmax(-1).numpy(), toks)
    (tloc, tvotes), (jloc, jvotes) = trep, jrep
    np.testing.assert_array_equal(tloc.numpy(), np.asarray(jloc))
    assert np.abs(tvotes.numpy() - np.asarray(jvotes)).max() <= 1
    return toks


@pytest.mark.parametrize("e", [0, 1])
def test_coded_rounds_match_reference(model, e):
    jc, tc, jp, tp = model
    k, g = 2, 2
    jcoding, tcoding = JCoding(k=k, s=1, e=e), TCoding(k=k, s=1, e=e)
    n1 = jcoding.num_workers
    rng = np.random.RandomState(30 + e)
    tokens = rng.randint(0, jc.vocab_size, (g * k, PROMPT))
    byz = np.zeros(n1, np.float32)
    if e:
        byz[4] = 1.0
    jprefill, jdecode = _jit_steps(jc, jcoding)
    key = jax.random.PRNGKey(11)
    lq = jcoding.decode_quorum
    jstate = tstate = nxt = None
    with jops.force_kernel("xla"):
        for r in range(1 + STEPS):
            m = np.ones(n1, np.float32)
            m[rng.choice([i for i in range(n1) if not byz[i]])] = 0.0
            key, sub = jax.random.split(key)
            noise = np.array(jax.random.normal(
                sub, (g, n1, jc.vocab_size), jnp.float32))
            targs = dict(straggler_mask=torch.from_numpy(m),
                         byz_mask=torch.from_numpy(byz),
                         byz_noise=torch.from_numpy(noise), byz_sigma=10.0,
                         with_report=True, locate_quorum=lq)
            jargs = (jnp.asarray(m), jnp.asarray(byz), sub,
                     jnp.asarray(lq, jnp.int32))
            if r == 0:
                jl, jstate, jrep = jprefill(jp, jnp.asarray(tokens), *jargs)
                tl, tstate, trep = tcs.coded_prefill(
                    tc, tcoding, tp, {"tokens": torch.from_numpy(tokens)},
                    MAX_LEN, **targs)
            else:
                jl, jstate, jrep = jdecode(jp, jstate, jnp.asarray(nxt)[:, None],
                                           *jargs)
                tl, tstate, trep = tcs.coded_decode_step(
                    tc, tcoding, tp, tstate, torch.tensor(nxt)[:, None],
                    **targs)
            nxt = _assert_round(tl, trep, jl, jrep)
            if e:
                assert trep[0].numpy()[:, 4].all()
    _assert_caches_close(tstate.caches, jstate.caches)


POOL, POOL_K = 2, 2
# per round: (admitted slots, active slots); slot 0 retires after round 2
# and is re-admitted while slot 1 decodes
POOL_ROUNDS = [((0,), ()), ((1,), (0,)), ((), (0, 1)), ((0,), (1,)),
               ((), (0, 1))]


@pytest.mark.parametrize("e", [0, 1])
def test_pool_steps_match_reference(model, e):
    """Free slots' SSM states step on don't-care tokens, as in the
    reference; their rows are masked and every logit stays finite."""
    jc, tc, jp, tp = model
    k = POOL_K
    jcoding, tcoding = JCoding(k=k, s=1, e=e), TCoding(k=k, s=1, e=e)
    n1 = jcoding.num_workers
    rng = np.random.RandomState(40 + e)
    byz = np.zeros(n1, np.float32)
    if e:
        byz[4] = 1.0
    jprefill = jax.jit(
        lambda p, st, t, a, m, bm, br: jcs.coded_pool_prefill(
            jc, jcoding, p, st, {"tokens": t}, MAX_LEN, a, straggler_mask=m,
            byz_mask=bm, byz_rng=br, byz_sigma=10.0, with_report=True))
    jdecode = jax.jit(
        lambda p, st, t, a, m, bm, br: jcs.coded_pool_decode_step(
            jc, jcoding, p, st, t, a, straggler_mask=m, byz_mask=bm,
            byz_rng=br, byz_sigma=10.0, with_report=True))
    jstate = jcs.init_pool_state(jc, jcoding, POOL, MAX_LEN)
    tstate = tcs.init_pool_state(tc, tcoding, POOL, MAX_LEN, "cpu")
    fresh = tcs.init_caches(tc, POOL * n1, MAX_LEN, torch.float32, "cpu")
    prompts = np.zeros((POOL * k, PROMPT), np.int32)
    nxt = np.zeros((POOL * k, 1), np.int32)
    key = jax.random.PRNGKey(13)
    with jops.force_kernel("xla"):
        for admitted, active in POOL_ROUNDS:
            m = np.ones(n1, np.float32)
            m[rng.choice([i for i in range(n1) if not byz[i]])] = 0.0
            key, sub = jax.random.split(key)
            noise = np.array(jax.random.normal(
                sub, (POOL, n1, jc.vocab_size), jnp.float32))
            targs = dict(straggler_mask=torch.from_numpy(m),
                         byz_mask=torch.from_numpy(byz),
                         byz_noise=torch.from_numpy(noise), byz_sigma=10.0,
                         with_report=True)
            jargs = (jnp.asarray(m), jnp.asarray(byz), sub)
            calls = []
            if admitted:
                a = np.zeros(POOL, np.float32)
                a[list(admitted)] = 1.0
                for s in admitted:
                    prompts[s * k:(s + 1) * k] = rng.randint(
                        0, jc.vocab_size, (k, PROMPT))
                jl, jstate, jrep = jprefill(jp, jstate, jnp.asarray(prompts),
                                            jnp.asarray(a), *jargs)
                tl, tstate, trep = tcs.coded_pool_prefill(
                    tc, tcoding, tp, tstate,
                    {"tokens": torch.from_numpy(prompts)}, a, fresh, **targs)
                calls.append((a, jl, jrep, tl, trep))
            if active:
                a = np.zeros(POOL, np.float32)
                a[list(active)] = 1.0
                jl, jstate, jrep = jdecode(jp, jstate, jnp.asarray(nxt),
                                           jnp.asarray(a), *jargs)
                tl, tstate, trep = tcs.coded_pool_decode_step(
                    tc, tcoding, tp, tstate, torch.from_numpy(nxt), a,
                    **targs)
                calls.append((a, jl, jrep, tl, trep))
            for a, jl, jrep, tl, trep in calls:
                assert torch.isfinite(tl).all()
                toks = _assert_round(tl, trep, jl, jrep)
                rows = np.repeat(a > 0, k)
                nxt[rows, 0] = toks[rows]
                if e:
                    assert trep[0].numpy()[a > 0, 4].all()
            np.testing.assert_array_equal(tstate.pos.numpy(),
                                          np.asarray(jstate.pos))
    _assert_caches_close(tstate.caches, jstate.caches)


# ------------------------------------------------------------- scheduler

N_REQUESTS, MAX_STEPS = 10, 5
ADVERSARY = dict(kind="persistent", sigma=10.0, seed=2)
QUARANTINE = dict(strikes=2, window=4, probation_ms=50.0)


def _serve(side, model, e):
    jc, tc, jp, tp = model
    cont, fail, lat, quar, coding_cls, cfg, params = {
        "jax": (jcont, jfail, jlat, jquar, JCoding, jc, jp),
        "torch": (tcont, tfail, tlat, tquar, TCoding, tc, tp)}[side]
    coding = coding_cls(k=POOL_K, s=1, e=e)
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, 512, (PROMPT,)).astype(np.int32)
               for _ in range(N_REQUESTS)]
    budgets = rng.randint(1, MAX_STEPS + 1, size=N_REQUESTS)
    arrivals = jsched.poisson_arrivals(N_REQUESTS, 2500.0, seed=1)
    executor = cont.ContinuousLLMExecutor(
        cfg, coding, params, pool_groups=POOL,
        max_len=PROMPT + MAX_STEPS + 2)
    sched = cont.ContinuousScheduler(
        cont.ContinuousConfig(
            coding=coding, pool_groups=POOL, flush_deadline_ms=4.0, seed=0,
            max_new_tokens=MAX_STEPS,
            wait_for=coding.wait_for if e else None,
            adversary=fail.AdversaryConfig(**ADVERSARY) if e else None,
            quarantine=quar.QuarantineConfig(**QUARANTINE) if e else None),
        lat.LatencyModel(), executor)
    metrics = sched.run(prompts, arrivals, max_new_tokens=budgets)
    return sched, metrics


@pytest.mark.parametrize("e", [0, 1])
def test_continuous_scheduler_matches_reference(model, monkeypatch, e):
    keys = []
    real_next = jfail.Adversary.next_round

    def record(self):
        attack = real_next(self)
        keys.append(attack.key)
        return attack

    monkeypatch.setattr(jfail.Adversary, "next_round", record)
    with jops.force_kernel("xla"):
        jsch, jm = _serve("jax", model, e)
    # the port's k-th attack draws the reference's k-th noise
    seeds = tfail.Adversary(TCoding(k=POOL_K, s=1, e=1),
                            tfail.AdversaryConfig(seed=ADVERSARY["seed"]))
    key_of = {seeds.next_round().seed: key for key in keys}

    def noise(self, groups, workers, vocab, device):
        shape = (groups, 1 if self.collude else workers, vocab)
        return torch.from_numpy(np.array(jax.random.normal(
            key_of[self.seed], shape, jnp.float32))).to(device)

    monkeypatch.setattr(tfail.RoundAttack, "noise", noise)
    tsch, tm = _serve("torch", model, e)
    assert tsch.trace == jsch.trace
    assert sorted(tsch.results) == sorted(jsch.results) == list(
        range(N_REQUESTS))
    for uid, toks in jsch.results.items():
        np.testing.assert_array_equal(tsch.results[uid], toks)
    assert tm.summary() == jm.summary()
    assert any(ev[0] == "round" and ev[3] and ev[4] for ev in tsch.trace)
    if e:
        assert tm.attacked_rounds > 0


def test_continuous_executor_starts_on_an_ssm_model(model):
    """The pool's prefill scratch takes the pool's cache dtype, not the
    dtype of an attention leaf: an SSM run has "conv" and "state"."""
    _, tc, _, tp = model
    coding = TCoding(k=POOL_K, s=1, e=1)
    ex = tcont.ContinuousLLMExecutor(tc, coding, tp, pool_groups=POOL,
                                     max_len=MAX_LEN)
    state = ex.init_state()
    for pool, fresh in zip(state.caches, ex._fresh):
        assert sorted(pool) == sorted(fresh) == ["conv", "state"]
        for name in pool:
            assert pool[name].shape == fresh[name].shape
            assert pool[name].dtype == fresh[name].dtype
    assert state.caches[0]["conv"].dtype == torch.float32
    assert state.caches[0]["state"].dtype == torch.float32


# ------------------------------------------------------------- launcher

@pytest.mark.parametrize("continuous", [False, True])
def test_serve_runs_mamba2_on_cpu(continuous):
    kw = (dict(continuous=True, pool_groups=2, quarantine=True, requests=12)
          if continuous else dict(requests=8))
    # the batch case holds the fixed-mask loop (one batch, one random
    # straggler a round), the inputs its recall-1 check was written for
    run = serve.run if continuous else serve.run_fixed_masks
    res = run("mamba2-780m", reduced=True, k=4, s=1, e=1,
              prompt_len=6, steps=4, byz_sigma=10.0, seed=1,
              device="cpu", **kw)
    if continuous:
        assert sorted(res["results"]) == list(range(12))
        for uid, toks in res["results"].items():
            assert len(toks) == res["budgets"][uid]
        summary = res["metrics"].summary()
        precision = summary["detection_precision"]
        recall = summary["detection_recall"]
    else:
        assert res["tokens"].shape == (8, 5)
        precision, recall = res["precision"], res["recall"]
    assert precision == recall == 1.0
