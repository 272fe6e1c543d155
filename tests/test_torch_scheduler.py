"""Port parity of the batch scheduler stack: ``CodedScheduler``,
``EngineExecutor`` and the LLM batch executor under the event loop.

Each case runs the reference's scheduler (XLA path) and the port's on
the same payloads, arrivals and seeds; an attacker's noise is the
reference's own draw handed to the port (``_torch_parity.share_noise``).

* ``EngineExecutor`` on a small MLP (the ``tests/test_scheduler.py``
  workloads): event traces and the summary equal, outputs within fp32
  tolerance, with deadline flushes, per-class deadlines, speculation and
  its corrections, and a persistent attacker under quarantine.
* The LLM scheduler on reduced qwen3-0.6b at E=1: at the paper's
  wait-for 2(K+E) traces, tokens, located verdicts and summaries equal;
  at the default wait-for, the locator quorum K+2E, equal except where
  the reference's verdict is off the exact (fp64) one or the verdict is a
  near tie, each shown by its exact tally (ROADMAP C).
* The worker-shard gather-bound refusals, and the quorum-hole scenario of
  ``tests/test_quorum_hole.py`` held against the reference's trace.
"""

import math

import pytest

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
torch = pytest.importorskip("torch")
import _torch_threads  # noqa: E402,F401

from _torch_parity import (assert_tokens_before_disputes,  # noqa: E402
                           capture_columns, locate_rounds, near_tie_walk,
                           share_noise)
from repro.configs import qwen3_0_6b as jcfg  # noqa: E402
from repro.core import engine as jengine  # noqa: E402
from repro.core import scheme as jscheme  # noqa: E402
from repro.core.berrut import CodingConfig as JCoding  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.launch.worker_mesh import WorkerShardConfig as JShard  # noqa: E402
from repro.models import init_params as j_init_params  # noqa: E402
from repro.serving import coded_serving as jcs  # noqa: E402
from repro.serving import continuous as jcont  # noqa: E402
from repro.serving import failures as jfail  # noqa: E402
from repro.serving import latency as jlat  # noqa: E402
from repro.serving import quarantine as jquar  # noqa: E402
from repro.serving import scheduler as jsched  # noqa: E402
from repro_torch.configs import qwen3_0_6b as tcfg  # noqa: E402
from repro_torch.core import engine as tengine  # noqa: E402
from repro_torch.core import scheme as tscheme  # noqa: E402
from repro_torch.core.berrut import CodingConfig as TCoding  # noqa: E402
from repro_torch.launch.worker_mesh import \
    WorkerShardConfig as TShard  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.serving import coded_serving as tcs  # noqa: E402
from repro_torch.serving import continuous as tcont  # noqa: E402
from repro_torch.serving import failures as tfail  # noqa: E402
from repro_torch.serving import latency as tlat  # noqa: E402
from repro_torch.serving import quarantine as tquar  # noqa: E402
from repro_torch.serving import scheduler as tsched  # noqa: E402
from repro_torch.serving.executor import CodedLLMExecutor  # noqa: E402

OUT_TOL = dict(rtol=1e-5, atol=1e-5)
SIDES = {"jax": (jsched, jfail, jlat, jquar, JCoding),
         "torch": (tsched, tfail, tlat, tquar, TCoding)}


def _mlp_weights(d_in=16, d_h=64, n_cls=10):
    rng = np.random.RandomState(0)
    return (
        (rng.randn(d_in, d_h) / np.sqrt(d_in)).astype(np.float32),
        (rng.randn(d_h, n_cls) / np.sqrt(d_h)).astype(np.float32))


W1, W2 = _mlp_weights()
_JMLP = jax.jit(lambda x: jax.nn.tanh(x @ jnp.asarray(W1)) @ jnp.asarray(W2))


def _tmlp(x):
    return torch.tanh(x @ torch.from_numpy(W1)) @ torch.from_numpy(W2)


def _engine(side, scheme):
    sched, *_ = SIDES[side]
    if side == "jax":
        return sched.EngineExecutor(_JMLP, scheme)
    return sched.EngineExecutor(_tmlp, scheme, device="cpu")


def _serve_mlp(side, coding, *, n, rate_rps, seed=0, tail_prob=0.05,
               adversary=None, quarantine=None, slo_classes=None, **cfg):
    """One ``tests/test_scheduler.py``-style run on one side."""
    sched_mod, fail, lat, quar, coding_cls = SIDES[side]
    coding = coding_cls(**coding)
    sched = sched_mod.CodedScheduler(
        sched_mod.SchedulerConfig(
            coding=coding, seed=seed,
            adversary=(fail.AdversaryConfig(**adversary)
                       if adversary else None),
            quarantine=(quar.QuarantineConfig(**quarantine)
                        if quarantine else None), **cfg),
        lat.LatencyModel(tail_prob=tail_prob), _engine(side, coding))
    rng = np.random.RandomState(seed + 7)
    payloads = [rng.randn(16).astype(np.float32) for _ in range(n)]
    arrivals = jsched.poisson_arrivals(n, rate_rps, seed=seed + 1)
    metrics = sched.run(payloads, arrivals, slo_classes=slo_classes)
    return sched, metrics


def _both(monkeypatch, serve, *args, **kw):
    """The reference's run, then the port's on the reference's noise."""
    share_noise(monkeypatch)
    with jops.force_kernel("xla"):
        jrun = serve("jax", *args, **kw)
    return jrun, serve("torch", *args, **kw)


def _same_summary(ts, js):
    assert ts.keys() == js.keys()
    for key, want in js.items():
        got = ts[key]
        assert got == want or (math.isnan(got) and math.isnan(want)), key


def _assert_same_run(jrun, trun, outputs=OUT_TOL):
    (jsch, jm), (tsch, tm) = jrun, trun
    assert len(tsch.trace) > 3
    assert tsch.trace == jsch.trace
    assert sorted(tsch.results) == sorted(jsch.results)
    for uid, want in jsch.results.items():
        if outputs is None:
            np.testing.assert_array_equal(tsch.results[uid], want)
        else:
            np.testing.assert_allclose(tsch.results[uid], want, **outputs)
    _same_summary(tm.summary(), jm.summary())


# ------------------------------------------------- EngineExecutor, MLP

@pytest.mark.parametrize("seed", [3, 5])
def test_golden_trace_matches_reference(monkeypatch, seed):
    """``TestGoldenTrace``: a seeded run's event trace, outputs and
    summary, at K=4 S=1 on Poisson arrivals."""
    jrun, trun = _both(monkeypatch, _serve_mlp, dict(k=4, s=1), n=80,
                       rate_rps=5000.0, seed=seed, groups_per_batch=2,
                       flush_deadline_ms=2.0)
    _assert_same_run(jrun, trun)
    assert [ev[0] for ev in trun[0].trace].count("dispatch") >= 10


def test_deadline_flush_matches_reference(monkeypatch):
    """``TestDeadlineFlush``: sparse arrivals flush partial batches."""
    jrun, trun = _both(monkeypatch, _serve_mlp, dict(k=8, s=1), n=60,
                       rate_rps=100.0, groups_per_batch=4,
                       flush_deadline_ms=3.0)
    _assert_same_run(jrun, trun)
    assert trun[1].deadline_flushes > 0
    assert any(b.deadline_flushed for b in trun[0].batches)


def test_class_deadlines_match_reference(monkeypatch):
    """Per-class flush deadlines: classes never mix in a batch."""
    n = 48
    classes = ["interactive" if i % 3 == 0 else "bulk" for i in range(n)]
    jrun, trun = _both(monkeypatch, _serve_mlp, dict(k=4, s=1), n=n,
                       rate_rps=1000.0, groups_per_batch=1,
                       flush_deadline_ms=5.0, slo_classes=classes,
                       class_deadlines={"interactive": 0.5, "bulk": 50.0})
    _assert_same_run(jrun, trun)
    for batch in trun[0].batches:
        assert len({r.slo_class for r in batch.plan.requests}) == 1
    assert trun[1].percentiles_by_class() == jrun[1].percentiles_by_class()


def test_speculation_and_corrections_match_reference(monkeypatch):
    """``TestSpeculativeDecode``: a heavy tail and an SLO, so straggling
    batches are served at the SLO from whoever landed and corrected by
    the full decode; the spec events, provisional outputs and correction
    counts agree."""
    jrun, trun = _both(monkeypatch, _serve_mlp, dict(k=4, s=2), n=160,
                       rate_rps=8000.0, slo_ms=14.0, groups_per_batch=1,
                       tail_prob=0.3)
    _assert_same_run(jrun, trun)
    (jsch, jm), (tsch, tm) = jrun, trun
    assert tm.speculative_decodes == jm.speculative_decodes > 0
    assert tm.corrections == jm.corrections > 0
    assert "spec" in {ev[0] for ev in tsch.trace}
    assert sorted(tsch.spec_results) == sorted(jsch.spec_results)
    for uid, want in jsch.spec_results.items():
        np.testing.assert_allclose(tsch.spec_results[uid], want, **OUT_TOL)


@pytest.mark.parametrize("kind", ["persistent", "colluding"])
def test_byzantine_engine_scheduler_matches_reference(monkeypatch, kind):
    """``tests/test_byzantine_serving.py``'s EngineExecutor workload at
    E=1 (E=2 colluding) with quarantine, waiting for 2(K+E): traces
    (quarantine holds included), verdict counts and outputs agree."""
    e = 2 if kind == "colluding" else 1
    coding = dict(k=4, s=1, e=e, c_vote=10)
    jrun, trun = _both(
        monkeypatch, _serve_mlp, coding, n=160, rate_rps=20_000.0, seed=2,
        groups_per_batch=2, flush_deadline_ms=2.0,
        wait_for=JCoding(**coding).wait_for,
        adversary=dict(kind=kind, num_adversaries=e, sigma=50.0, seed=11),
        quarantine=dict(strikes=2, window=4, probation_ms=20.0))
    _assert_same_run(jrun, trun)
    tm = trun[1]
    assert tm.attacked_rounds > 0 and tm.locate_rounds > 0
    assert tm.quarantine_events > 0


def test_engine_executor_decodes_like_coded_inference():
    """The port's ``EngineExecutor`` decodes bit-identically to the
    port's ``coded_inference`` with the scheduler's mask, at E=0 and
    with the locator at E=1."""
    for coding in (TCoding(k=4, s=1), TCoding(k=4, s=1, e=1, c_vote=10)):
        sched = tsched.CodedScheduler(
            tsched.SchedulerConfig(coding=coding, groups_per_batch=2,
                                   seed=1),
            tlat.LatencyModel(), tsched.EngineExecutor(_tmlp, coding,
                                                       device="cpu"))
        rng = np.random.RandomState(0)
        payloads = [rng.randn(16).astype(np.float32) for _ in range(40)]
        sched.run(payloads, rate_rps=5000.0)
        for batch in sched.batches:
            want = tengine.coded_inference(
                _tmlp, coding, torch.from_numpy(batch.queries),
                straggler_mask=torch.from_numpy(batch.mask))
            np.testing.assert_array_equal(batch.outputs, want.numpy())
            assert batch.mask.sum() == coding.decode_quorum


def test_scheme_protocol_matches_reference():
    """``plan``, ``encode``, ``forward``, ``decode`` and ``locate`` of the
    Berrut scheme against the reference's, and ``corrupt_coded_preds``
    on the reference's noise."""
    jsc = jscheme.get_scheme("berrut", 4, s=1, e=1, c_vote=10)
    tsc = tscheme.get_scheme("berrut", 4, s=1, e=1, c_vote=10)
    assert tsc.plan(3).__dict__ == jsc.plan(3).__dict__
    assert tsc.plan(3).overhead == jsc.plan(3).overhead
    x = np.random.RandomState(1).randn(3, 4, 16).astype(np.float32)
    jc = jsc.forward(_JMLP, jsc.encode(jnp.asarray(x)))
    tc = tsc.forward(_tmlp, tsc.encode(torch.from_numpy(x)))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), **OUT_TOL)
    attack = jfail.make_adversary(jsc.coding, jfail.AdversaryConfig(
        kind="persistent", sigma=50.0, seed=4)).next_round()
    jp = jfail.corrupt_coded_preds(jc, attack)
    tattack = tfail.RoundAttack(mask=attack.mask, sigma=attack.sigma)
    noise = torch.from_numpy(np.array(jax.random.normal(
        attack.key, jc.shape, jnp.float32)))
    tattack_noise = tfail.RoundAttack.noise
    try:
        tfail.RoundAttack.noise = lambda self, g, w, v, device: noise
        tp = tfail.corrupt_coded_preds(tc, tattack)
    finally:
        tfail.RoundAttack.noise = tattack_noise
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), **OUT_TOL)
    mask = np.ones(11, np.float32)
    mask[[2, 7]] = 0.0
    jd = jsc.locate(jp, jnp.asarray(mask))
    td = tsc.locate(tp, torch.from_numpy(mask))
    np.testing.assert_allclose(td[0].numpy(), np.asarray(jd[0]), **OUT_TOL)
    for got, want in zip(td[1:], jd[1:]):
        np.testing.assert_array_equal(got, np.asarray(want))
    assert td[1][:, np.flatnonzero(attack.mask)].all()
    np.testing.assert_allclose(
        tsc.decode(tp, torch.from_numpy(mask), locate=False).numpy(),
        np.asarray(jsc.decode(jp, jnp.asarray(mask), locate=False)),
        **OUT_TOL)
    parm = tscheme.get_scheme("parm", 4)
    assert isinstance(parm, tscheme.ParMScheme) and parm.num_workers == 5


# ------------------------------------------------ LLM scheduler, qwen3

@pytest.fixture(scope="module")
def model():
    jc, tc = jcfg.reduced(), tcfg.reduced()
    jp = j_init_params(jc, jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return jc, tc, jp, tp


LLM_PROMPT = 8


def _serve_llm(side, model, coding, *, n, steps, groups, quorum_wait,
               quarantine=True, seed=1):
    """Reduced qwen3 under the batch scheduler, a persistent attacker at
    sigma 100; full batches only, so every batch has one shape."""
    jc, tc, jp, tp = model
    sched_mod, fail, lat, quar, coding_cls = SIDES[side]
    coding = coding_cls(**coding)
    max_len = LLM_PROMPT + steps + 2
    if side == "jax":
        executor = jsched.CodedLLMExecutor(jc, coding, jp, steps=steps,
                                           max_len=max_len)
    else:
        executor = CodedLLMExecutor(tc, coding, tp, steps=steps,
                                    max_len=max_len)
    sched = sched_mod.CodedScheduler(
        sched_mod.SchedulerConfig(
            coding=coding, groups_per_batch=groups, flush_deadline_ms=None,
            seed=seed, wait_for=None if quorum_wait else coding.wait_for,
            adversary=fail.AdversaryConfig(kind="persistent", sigma=100.0,
                                           seed=2),
            quarantine=(quar.QuarantineConfig(strikes=2, window=4,
                                              probation_ms=30.0)
                        if quarantine else None)),
        lat.LatencyModel(), executor)
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, 512, (LLM_PROMPT,)).astype(np.int32)
               for _ in range(n)]
    metrics = sched.run(prompts, jsched.poisson_arrivals(n, 4000.0, seed=3))
    return sched, metrics


LLM_CASE = dict(coding=dict(k=4, s=1, e=1, c_vote=16), n=16, steps=2,
                groups=2)


def test_llm_scheduler_matches_reference_at_the_paper_wait_for(
        model, monkeypatch):
    """E=1 waiting for 2(K+E) = 10 of 11 workers, with quarantine: the
    trace, tokens, every round's located verdicts and the summary agree
    exactly; the attacker is located in every round it survived to."""
    jrun, trun = _both(monkeypatch, _serve_llm, model, quorum_wait=False,
                       **LLM_CASE)
    _assert_same_run(jrun, trun, outputs=None)
    (jsch, _), (tsch, tm) = jrun, trun
    attacker = np.flatnonzero(tsch.adversary.byz_mask)
    for jb, tb in zip(jsch.batches, tsch.batches):
        assert len(tb.round_reports) == 1 + LLM_CASE["steps"]
        for jr, tr, mask in zip(jb.round_reports, tb.round_reports,
                                tb.round_masks):
            # raw votes may differ by a near-tie pick (ROADMAP C)
            np.testing.assert_array_equal(tr.located, np.asarray(jr.located))
            if mask[attacker].all():
                assert tr.detected[attacker].all()
    assert tm.detection_precision() == tm.detection_recall() == 1.0


def _assert_same_but_near_ties(coding, jrun, trun, columns,
                               per_batch=False):
    """Vote columns agree wherever the inputs do, and verdicts except
    where the port's is the exact one or a near tie (``near_tie_walk``);
    the trace agrees up to the first round whose worker mask such a
    verdict changed (through quarantine)."""
    (jsch, jm), (tsch, tm) = jrun, trun
    diverged, ties = near_tie_walk(coding, locate_rounds(jsch),
                                   locate_rounds(tsch), *columns,
                                   per_batch=per_batch)
    first = next((n for n, (a, b) in enumerate(zip(jsch.trace, tsch.trace))
                  if a != b), None)
    if first is None:
        assert tsch.trace == jsch.trace and diverged is None
    else:
        assert ties and jsch.trace[first][0] == "round"
        assert jsch.trace[first][4] != tsch.trace[first][4]
    assert tm.locate_rounds > 0 and jm.locate_rounds > 0
    return diverged, ties, first


def test_llm_scheduler_at_the_locator_quorum(model, monkeypatch):
    """E=1 at the default wait-for K+2E = 6 of 11: vote columns agree
    with the reference's while the inputs do, and verdicts except where
    the port's is the exact (fp64) one or a near tie, each printed with
    its exact tally (``pytest -s``); the trace agrees up to the first
    round whose worker mask such a verdict changed (through quarantine),
    and each batch's tokens up to its first disputed round."""
    columns = capture_columns(monkeypatch, jcs, tcs)
    jrun, trun = _both(monkeypatch, _serve_llm, model, quorum_wait=True,
                       **LLM_CASE)
    diverged, ties, _ = _assert_same_but_near_ties(
        TCoding(**LLM_CASE["coding"]), jrun, trun, columns, per_batch=True)
    rounds = locate_rounds(trun[0])
    assert assert_tokens_before_disputes(jrun[0], trun[0], rounds, ties,
                                         diverged) > 0
    if diverged is None and not ties:
        for uid, want in jrun[0].results.items():
            np.testing.assert_array_equal(trun[0].results[uid], want)


def test_llm_scheduler_counts_rounds_and_masks(model):
    """``TestLLMExecutor``: every batch runs 1 + steps rounds, each mask
    holds exactly its wait-for, and a batch's service time is the sum of
    its rounds' triggers."""
    _, tc, _, tp = model
    coding = TCoding(k=2, s=1)
    executor = CodedLLMExecutor(tc, coding, tp, steps=2, max_len=16)
    sched = tsched.CodedScheduler(
        tsched.SchedulerConfig(coding=coding, groups_per_batch=2,
                               flush_deadline_ms=5.0, seed=1),
        tlat.LatencyModel(), executor)
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, 512, (8,)).astype(np.int32) for _ in range(8)]
    metrics = sched.run(prompts, tsched.poisson_arrivals(8, 4000.0, seed=3))
    assert metrics.count == 8
    for batch in sched.batches:
        assert len(batch.round_masks) == 3
        assert all(m.sum() == coding.wait_for for m in batch.round_masks)
        assert batch.service_ms == pytest.approx(sum(batch.round_waits))
    assert len(executor.round_ms) == 3 * len(sched.batches)
    for toks in sched.results.values():
        assert toks.shape == (3,) and np.issubdtype(toks.dtype, np.integer)


# ------------------------------------------------ refusals, quorum hole

def _refusal(side, fn):
    """The ValueError message ``fn`` raises on ``side``."""
    with pytest.raises(ValueError) as info:
        fn(side)
    return str(info.value)


def test_gather_bound_refusals_match_reference(model):
    """``check_gather_bound`` and the schedulers' construction-time
    bound refuse what the reference refuses, with its messages."""
    jc, tc, jp, tp = model
    mods = {"jax": (jsched, jcont, JShard, JCoding, jc, jp,
                    jsched.CodedLLMExecutor),
            "torch": (tsched, tcont, TShard, TCoding, tc, tp,
                      CodedLLMExecutor)}

    class Sharded:
        def __init__(self, shard, width, coding):
            self.wshard = shard(gather_width=width)
            self.coding = coding

    def check(side):
        sched, _, shard, coding_cls, *_ = mods[side]
        ex = Sharded(shard, 5, coding_cls(k=2, s=2, e=1))
        sched.check_gather_bound(ex, 5)
        sched.check_gather_bound(ex, 6)

    def coded(side, wait_for=6):
        sched, _, shard, coding_cls, cfg, params, llm = mods[side]
        coding = coding_cls(k=2, s=2, e=1)
        ex = llm(cfg, coding, params, steps=1, max_len=12,
                 wshard=shard(gather_width=5))
        sched.CodedScheduler(sched.SchedulerConfig(
            coding=coding, wait_for=wait_for), SIDES[side][2].LatencyModel(),
            ex)

    def continuous(side, wait_for=6):
        _, cont, shard, coding_cls, cfg, params, _ = mods[side]
        coding = coding_cls(k=2, s=2, e=1)
        ex = cont.ContinuousLLMExecutor(cfg, coding, params, pool_groups=2,
                                        max_len=12,
                                        wshard=shard(gather_width=5))
        cont.ContinuousScheduler(cont.ContinuousConfig(
            pool_groups=2, wait_for=wait_for), SIDES[side][2].LatencyModel(),
            ex)

    for fn in (check, coded, continuous):
        assert _refusal("torch", fn) == _refusal("jax", fn)
    # at the width (and at the quorum bound) both accept
    for side in ("jax", "torch"):
        coded(side, wait_for=5)
        continuous(side, wait_for=None)
    tsched.check_gather_bound(tsched.EngineExecutor(
        _tmlp, TCoding(k=2), device="cpu"), 99)


@pytest.mark.parametrize("outputs", [2, 64])
def test_quorum_hole_scenario_matches_reference(monkeypatch, outputs):
    """The scenario of ``tests/test_quorum_hole.py``: 6 honest workers
    held before the run leave 7 < K+2E = 8 active, against a persistent
    2-worker attack.  The port's trace (early readmissions, masks) is
    held against the reference's run of the same scenario, not against
    that test's assertions (ROADMAP C): the predictions (the vote
    columns) agree on every batch before its first disputed verdict,
    verdicts agree except where the port's is the exact one or a near
    tie, and the runs agree up to the first round whose mask such a
    verdict changed.  With the scenario's 2 outputs every E=2 verdict at
    the bare quorum is a near tie and the runs part at the first; with
    64 the exact tally decides most of them."""
    w_out = np.random.RandomState(0).randn(3, outputs)

    def serve(side):
        sched_mod, fail, lat, quar, _ = SIDES[side]
        scheme = (jscheme if side == "jax" else tscheme).get_scheme(
            "berrut", 4, s=1, e=2)
        if side == "jax":
            ex = sched_mod.EngineExecutor(lambda x: np.asarray(x) @ w_out,
                                          scheme)
        else:
            ex = sched_mod.EngineExecutor(
                lambda x: (x.double() @ torch.from_numpy(w_out)).float(),
                scheme, device="cpu")
        sched = sched_mod.CodedScheduler(
            sched_mod.SchedulerConfig(
                scheme=scheme, groups_per_batch=1, flush_deadline_ms=1.0,
                seed=0, adversary=fail.AdversaryConfig(
                    kind="persistent", num_adversaries=2, sigma=100.0,
                    seed=3),
                quarantine=quar.QuarantineConfig(
                    strikes=2, window=4, probation_ms=1e9,
                    max_quarantined=6)),
            lat.LatencyModel(tail_prob=0.1), ex)
        bad = set(sched.adversary.workers.tolist())
        victims = [w for w in range(13) if w not in bad][:6]
        det = np.zeros((13,), bool)
        det[victims] = True
        for t in (-2.0, -1.0):
            sched.reputation.observe(t, det, np.ones((13,), bool))
        payloads = [np.random.RandomState(i).randn(3) for i in range(48)]
        return sched, sched.run(payloads, rate_rps=2000.0)

    columns = capture_columns(monkeypatch, jengine, tengine)
    jrun, trun = _both(monkeypatch, serve)
    _, _, first = _assert_same_but_near_ties(TCoding(k=4, s=1, e=2), jrun,
                                             trun, columns, per_batch=True)
    assert trun[1].early_readmissions >= 1
    assert first is None or first > 0
