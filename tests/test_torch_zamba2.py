"""Port parity of zamba2-1.2b's hybrid slice: Mamba2 "S" runs with one
shared-weight attention block applied at every "G" position, each
position with a KV cache of its own, against ``repro.models`` on the
reference's XLA path, on the reference's own parameters
(``params_from_jax``) and the same numpy inputs.

``reduced()`` has one G position ("SG"), so the model-level tests also
run a 4-layer "SGSG" variant of it (the same widths: d_model 256, 4
heads of 64, state 16, SSM heads of 32), which reuses the shared weights
at two positions and keeps two G caches.

Tolerances: fp32 logits and losses within rtol 1e-5, atol 1e-4 (another
summation order in every product); KV caches, SSM states and conv
windows within rtol 1e-5, atol 1e-5; greedy tokens, ``located``, slot
positions, the continuous scheduler's event trace, per-request tokens
and ``metrics.summary()`` exactly; vote tallies within one pick
(ROADMAP C).
"""

import dataclasses

import pytest

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
torch = pytest.importorskip("torch")
import _torch_threads  # noqa: E402,F401

from repro import configs as jconfigs  # noqa: E402
from repro.core.berrut import CodingConfig as JCoding  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.models import decode_step as j_decode_step  # noqa: E402
from repro.models import forward as j_forward  # noqa: E402
from repro.models import init_caches as j_init_caches  # noqa: E402
from repro.models import init_params as j_init_params  # noqa: E402
from repro.models import lm_loss as j_lm_loss  # noqa: E402
from repro.models import predict_fn as j_predict_fn  # noqa: E402
from repro.models import prefill as j_prefill  # noqa: E402
from repro.models import transformer as jtransformer  # noqa: E402
from repro.serving import coded_serving as jcs  # noqa: E402
from repro.serving import failures as jfail  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.core.berrut import CodingConfig as TCoding  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.serving import coded_serving as tcs  # noqa: E402
from repro_torch.serving import failures as tfail  # noqa: E402
from test_torch_mamba2 import (ADVERSARY, N_REQUESTS, POOL_K,  # noqa: E402
                               _serve, _signature)

ARCH = "zamba2-1.2b"
STATE_TOL = dict(rtol=1e-5, atol=1e-5)
LOGITS_TOL = dict(rtol=1e-5, atol=1e-4)
PROMPT, STEPS = 10, 3
MAX_LEN = PROMPT + STEPS + 2
TWO_G = dict(num_layers=4, layer_pattern="SGSG")


@pytest.fixture(scope="module")
def models():
    """(reference config, port config, reference params, port params) of
    ``reduced()`` ("SG") and of its "SGSG" variant, built once."""
    cache = {}

    def get(pattern="SG"):
        if pattern not in cache:
            jc, tc = jconfigs.get_reduced(ARCH), configs.get_reduced(ARCH)
            if pattern != "SG":
                jc, tc = jc.with_updates(**TWO_G), tc.with_updates(**TWO_G)
            jp = j_init_params(jc, jax.random.PRNGKey(0))
            tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
            cache[pattern] = (jc, tc, jp, tp)
        return cache[pattern]

    return get


def _assert_caches_close(tcaches, jcaches, pattern):
    assert len(tcaches) == len(jcaches) == len(pattern)
    for kind, tr, jr in zip(pattern, tcaches, jcaches):
        assert sorted(tr) == sorted(jr) == (
            ["conv", "state"] if kind == "S" else ["k", "v"])
        for name in tr:
            assert tr[name].shape == jr[name].shape
            assert tr[name].shape[0] == 1           # one layer a run
            np.testing.assert_allclose(tr[name].numpy(), np.asarray(jr[name]),
                                       **STATE_TOL)


# ------------------------------------------------------------- config

def test_config_copy_and_param_count_match_reference():
    for jc, tc in ((jconfigs.get_config(ARCH), configs.get_config(ARCH)),
                   (jconfigs.get_reduced(ARCH), configs.get_reduced(ARCH)),
                   (jconfigs.get_reduced(ARCH).with_updates(**TWO_G),
                    configs.get_reduced(ARCH).with_updates(**TWO_G))):
        assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
        assert tc.param_count() == jc.param_count()
        assert tc.active_param_count() == jc.active_param_count()
    cfg = configs.get_config(ARCH)
    assert cfg.param_count() == 1_016_610_816
    assert (cfg.layer_pattern.count("G"), cfg.layer_pattern.count("S")) == (
        6, 32)
    assert (cfg.head_dim, cfg.num_kv_heads, cfg.ssm_state,
            cfg.ssm_heads) == (64, 32, 64, 64)
    assert transformer.pattern_runs(cfg.layer_pattern) == \
        jtransformer.pattern_runs(cfg.layer_pattern)
    transformer.check_ported(cfg)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_param_tree_has_empty_g_runs_and_shared_block(dtype, models):
    """``init_blocks`` returns the reference's tree: ``{}`` at each G
    run and one "A" parameter set under ``"shared"``; the reference's
    tree converts into it leaf for leaf (``params_from_jax``)."""
    jc, tc = (c.with_updates(param_dtype=dtype) for c in models("SGSG")[:2])
    conv = params_from_jax(
        jax.tree.map(np.asarray, j_init_params(jc, jax.random.PRNGKey(1))),
        device="cpu")
    own = tmodel.init_params(tc, torch.Generator().manual_seed(0), "cpu")
    assert _signature(conv) == _signature(own)
    for tree in (conv, own):
        runs = tree["blocks"]["runs"]
        assert len(runs) == 4 and runs[1] == {} and runs[3] == {}
        assert sorted(tree["blocks"]["shared"]) == ["attn", "mlp", "norm1",
                                                    "norm2"]
        # one block, no leading layer axis: (d_model, heads, head_dim)
        assert tuple(tree["blocks"]["shared"]["attn"]["wq"].shape) == (
            256, 4, 64)
        assert tree["blocks"]["shared"]["mlp"]["w_in"].dtype == getattr(
            torch, dtype)
    plain = tmodel.init_params(configs.get_config("qwen3-0.6b").with_updates(
        num_layers=1, d_model=64, num_heads=2, num_kv_heads=1, head_dim=32,
        d_ff=64, vocab_size=32), torch.Generator().manual_seed(0), "cpu")
    assert "shared" not in plain["blocks"]


# ------------------------------------------------------------- model

@pytest.mark.parametrize("pattern", ["SG", "SGSG"])
def test_prefill_decode_and_caches_match_reference(pattern, models):
    """Prefill then decode steps: logits and greedy tokens each step, and
    every run's cache at the end, each G position's KV cache held
    against the reference's; the two G positions' caches differ (one
    weight set, two caches)."""
    jc, tc, jp, tp = models(pattern)
    b = 3
    tokens = np.random.RandomState(1).randint(0, 512, (b, PROMPT))
    jprefill = jax.jit(lambda p, i, c: j_prefill(jc, p, i, c))
    jdecode = jax.jit(lambda p, c, i, pos: j_decode_step(jc, p, c, i, pos))
    with jops.force_kernel("xla"):
        jl, jcache = jprefill(jp, {"tokens": jnp.asarray(tokens)},
                              j_init_caches(jc, b, MAX_LEN))
        tl, tcache = tmodel.prefill(
            tc, tp, {"tokens": torch.from_numpy(tokens)},
            tmodel.init_caches(tc, b, MAX_LEN, torch.float32, "cpu"))
        _assert_caches_close(tcache, jcache, pattern)
        for step in range(STEPS + 1):
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                       **LOGITS_TOL)
            nxt = np.asarray(jnp.argmax(jl, -1))
            np.testing.assert_array_equal(tl.argmax(-1).numpy(), nxt)
            if step == STEPS:
                break
            jl, jcache = jdecode(jp, jcache,
                                 {"tokens": jnp.asarray(nxt)[:, None]},
                                 jnp.asarray(PROMPT + step, jnp.int32))
            tl, tcache = tmodel.decode_step(
                tc, tp, tcache, {"tokens": torch.tensor(nxt)[:, None]},
                PROMPT + step)
    _assert_caches_close(tcache, jcache, pattern)
    if pattern == "SGSG":
        assert not torch.allclose(tcache[1]["k"], tcache[3]["k"])


def test_shared_block_is_one_weight_set(models):
    """Both G positions read ``blocks["shared"]``: changing it changes
    the logits, and it is the only attention in the model."""
    _, tc, _, tp = models("SGSG")
    tokens = torch.from_numpy(np.random.RandomState(2).randint(0, 512,
                                                               (2, 8)))
    base, _ = tmodel.forward(tc, tp, {"tokens": tokens})
    shared = tp["blocks"]["shared"]["attn"]["wo"]
    saved = shared.clone()
    try:
        shared.mul_(2.0)
        moved, _ = tmodel.forward(tc, tp, {"tokens": tokens})
    finally:
        shared.copy_(saved)
    assert not torch.allclose(moved, base)
    assert [k for run in tp["blocks"]["runs"] for k in run] == [
        "norm", "ssm", "norm", "ssm"]


@pytest.mark.parametrize("pattern", ["SG", "SGSG"])
def test_prefill_decode_matches_forward(pattern, models):
    """The port's serving path against its own full forward: prefill T
    tokens, decode one more."""
    _, tc, _, tp = models(pattern)
    b, t = 2, 16
    tokens = torch.from_numpy(np.random.RandomState(3).randint(
        0, 512, (b, t + 1)))
    full, _ = tmodel.forward(tc, tp, {"tokens": tokens})
    caches = tmodel.init_caches(tc, b, 64, torch.float32, "cpu")
    pre, caches = tmodel.prefill(tc, tp, {"tokens": tokens[:, :t]}, caches)
    torch.testing.assert_close(pre, full[:, -2], rtol=1e-4, atol=1e-4)
    dec, _ = tmodel.decode_step(tc, tp, caches,
                                {"tokens": tokens[:, t:t + 1]}, t)
    torch.testing.assert_close(dec, full[:, -1], rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("pattern", ["SG", "SGSG"])
def test_forward_predict_and_loss_match_reference(pattern, models):
    """``forward`` (logits, zero aux), ``predict_fn`` on embeddings, and
    ``lm_loss`` without targets, with targets, and with a loss mask."""
    jc, tc, jp, tp = models(pattern)
    b, s, t = 2, 17, 6
    rng = np.random.RandomState(6)
    tokens = rng.randint(0, 512, (b, s))
    targets = rng.randint(0, 512, (b, t))
    mask = (rng.rand(b, t) < 0.6).astype(np.float32)
    emb = rng.randn(b, s, tc.d_model).astype(np.float32)
    batches = {"tokens": {"tokens": tokens},
               "targets": {"tokens": tokens, "targets": targets},
               "loss_mask": {"tokens": tokens, "targets": targets,
                             "loss_mask": mask}}
    with jops.force_kernel("xla"):
        jl, jaux = j_forward(jc, jp, {"tokens": jnp.asarray(tokens)})
        jpred = j_predict_fn(jc, jp)(jnp.asarray(emb))
        jloss = {k: j_lm_loss(jc, jp, jax.tree.map(jnp.asarray, v))
                 for k, v in batches.items()}
    tl, taux = tmodel.forward(tc, tp, {"tokens": torch.from_numpy(tokens)})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGITS_TOL)
    for key, val in taux.items():
        assert float(val) == float(jaux[key]) == 0.0
    np.testing.assert_allclose(
        tmodel.predict_fn(tc, tp)(torch.from_numpy(emb)).numpy(),
        np.asarray(jpred), **LOGITS_TOL)
    for key, batch in batches.items():
        total, metrics = tmodel.lm_loss(
            tc, tp, {k: torch.from_numpy(v) for k, v in batch.items()})
        jtotal, jmetrics = jloss[key]
        np.testing.assert_allclose(float(total), float(jtotal), rtol=1e-5)
        for name, val in metrics.items():
            np.testing.assert_allclose(float(val), float(jmetrics[name]),
                                       rtol=1e-5, atol=1e-7)


# ------------------------------------------------------------- coded rounds

def test_coded_rounds_match_reference(models):
    """One E=1 coded run on "SGSG" (K=2, 2 groups) against the
    reference's jitted steps: a straggler each round, a persistent
    attacker, the reference's noise; logits, greedy tokens and verdicts
    equal, each vote tally within one pick; every run's coded caches at
    the end, both G positions' included."""
    jc, tc, jp, tp = models("SGSG")
    k, g = 2, 2
    jcoding, tcoding = JCoding(k=k, s=1, e=1), TCoding(k=k, s=1, e=1)
    n1 = jcoding.num_workers
    rng = np.random.RandomState(31)
    tokens = rng.randint(0, jc.vocab_size, (g * k, PROMPT))
    byz = np.zeros(n1, np.float32)
    byz[4] = 1.0
    lq = jcoding.decode_quorum
    jprefill = jax.jit(
        lambda p, t, m, bm, br: jcs.coded_prefill(
            jc, jcoding, p, {"tokens": t}, max_len=MAX_LEN, straggler_mask=m,
            byz_mask=bm, byz_rng=br, byz_sigma=10.0, with_report=True,
            locate_quorum=lq))
    jdecode = jax.jit(
        lambda p, st, t, m, bm, br: jcs.coded_decode_step(
            jc, jcoding, p, st, t, straggler_mask=m, byz_mask=bm,
            byz_rng=br, byz_sigma=10.0, with_report=True, locate_quorum=lq))
    key = jax.random.PRNGKey(12)
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
            jargs = (jnp.asarray(m), jnp.asarray(byz), sub)
            if r == 0:
                jl, jstate, jrep = jprefill(jp, jnp.asarray(tokens), *jargs)
                tl, tstate, trep = tcs.coded_prefill(
                    tc, tcoding, tp, {"tokens": torch.from_numpy(tokens)},
                    MAX_LEN, **targs)
            else:
                jl, jstate, jrep = jdecode(jp, jstate,
                                           jnp.asarray(nxt)[:, None], *jargs)
                tl, tstate, trep = tcs.coded_decode_step(
                    tc, tcoding, tp, tstate, torch.tensor(nxt)[:, None],
                    **targs)
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                       **LOGITS_TOL)
            nxt = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
            np.testing.assert_array_equal(tl.argmax(-1).numpy(), nxt)
            (tloc, tvotes), (jloc, jvotes) = trep, jrep
            np.testing.assert_array_equal(tloc.numpy(), np.asarray(jloc))
            assert np.abs(tvotes.numpy() - np.asarray(jvotes)).max() <= 1
            assert tloc.numpy()[:, 4].all()
    _assert_caches_close(tstate.caches, jstate.caches, "SGSG")


def test_continuous_scheduler_matches_reference(models, monkeypatch):
    """A whole ``ContinuousScheduler`` run at E=1 with quarantine on
    "SGSG" (10 requests, budgets 1..5, 2 group slots, wait-for 2(K+E)):
    the trace, every request's tokens and the summary equal the
    reference's, with its noise handed over."""
    model = models("SGSG")
    keys = []
    real_next = jfail.Adversary.next_round

    def record(self):
        attack = real_next(self)
        keys.append(attack.key)
        return attack

    monkeypatch.setattr(jfail.Adversary, "next_round", record)
    with jops.force_kernel("xla"):
        jsch, jm = _serve("jax", model, 1)
    seeds = tfail.Adversary(TCoding(k=POOL_K, s=1, e=1),
                            tfail.AdversaryConfig(seed=ADVERSARY["seed"]))
    key_of = {seeds.next_round().seed: key for key in keys}

    def noise(self, groups, workers, vocab, device):
        shape = (groups, 1 if self.collude else workers, vocab)
        return torch.from_numpy(np.array(jax.random.normal(
            key_of[self.seed], shape, jnp.float32))).to(device)

    monkeypatch.setattr(tfail.RoundAttack, "noise", noise)
    tsch, tm = _serve("torch", model, 1)
    assert tsch.trace == jsch.trace
    assert sorted(tsch.results) == sorted(jsch.results) == list(
        range(N_REQUESTS))
    for uid, toks in jsch.results.items():
        np.testing.assert_array_equal(tsch.results[uid], toks)
    assert tm.summary() == jm.summary()
    assert any(ev[0] == "round" and ev[3] and ev[4] for ev in tsch.trace)
    assert tm.attacked_rounds > 0
