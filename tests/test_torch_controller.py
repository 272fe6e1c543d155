"""Port parity of adaptive redundancy: ``RedundancyController`` and the
schedulers that it retunes.

* The controller alone: the same telemetry stream gives the reference's
  decisions, field for field, under several policies
  (``tests/test_controller.py``'s rules).
* Adaptive serving runs, reference against port on the same seeds with
  the reference's attacker noise (``_torch_parity.share_noise``): the
  ``EngineExecutor`` run of ``tests/test_controller.py`` and the LLM
  batch and slot-pool runs of ``tests/test_adaptive_llm.py`` on reduced
  qwen3-0.6b.  Under a controller every round waits for the locator
  quorum K+2E, so verdicts agree except where the port's is the exact
  (fp64) one or a near tie (ROADMAP C); the event traces and decision
  logs agree up to the first round whose mask such a verdict changed.
* The retune-time gather-bound check, and the legacy executor call shape.
"""

import dataclasses

import pytest

jax = pytest.importorskip("jax")

import numpy as np  # noqa: E402
torch = pytest.importorskip("torch")
import _torch_threads  # noqa: E402,F401

from _torch_parity import (assert_tokens_before_disputes,  # noqa: E402
                           capture_columns, locate_rounds, near_tie_walk,
                           pool_call_rounds, record_pool_calls,
                           share_noise)
from repro.configs import qwen3_0_6b as jcfg  # noqa: E402
from repro.core import scheme as jscheme  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.launch.worker_mesh import WorkerShardConfig as JShard  # noqa: E402
from repro.models import init_params as j_init_params  # noqa: E402
from repro.serving import coded_serving as jcs  # noqa: E402
from repro.serving import continuous as jcont  # noqa: E402
from repro.serving import controller as jctl  # noqa: E402
from repro.serving import failures as jfail  # noqa: E402
from repro.serving import latency as jlat  # noqa: E402
from repro.serving import quarantine as jquar  # noqa: E402
from repro.serving import scheduler as jsched  # noqa: E402
from repro_torch.configs import qwen3_0_6b as tcfg  # noqa: E402
from repro_torch.core import scheme as tscheme  # noqa: E402
from repro_torch.launch.worker_mesh import \
    WorkerShardConfig as TShard  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.serving import coded_serving as tcs  # noqa: E402
from repro_torch.serving import continuous as tcont  # noqa: E402
from repro_torch.serving import controller as tctl  # noqa: E402
from repro_torch.serving import failures as tfail  # noqa: E402
from repro_torch.serving import latency as tlat  # noqa: E402
from repro_torch.serving import quarantine as tquar  # noqa: E402
from repro_torch.serving import scheduler as tsched  # noqa: E402
from repro_torch.serving.executor import CodedLLMExecutor  # noqa: E402

SIDES = {
    "jax": dict(sched=jsched, cont=jcont, ctl=jctl, fail=jfail, lat=jlat,
                quar=jquar, scheme=jscheme, shard=JShard),
    "torch": dict(sched=tsched, cont=tcont, ctl=tctl, fail=tfail, lat=tlat,
                  quar=tquar, scheme=tscheme, shard=TShard),
}


def _decision(d):
    return dataclasses.astuple(d)


# ----------------------------------------------------- the controller

@pytest.mark.parametrize("policy", [
    dict(window_rounds=4, s_max=3, e_max=2),
    dict(window_rounds=2, clean_windows_to_shrink=2, s_min=0, e_min=0),
    dict(window_rounds=3, target_p99_ms=25.0, straggle_ms=30.0),
    dict(window_rounds=2, s_max=3, e_max=2,
         allowed_points=((0, 0), (1, 1), (3, 2))),
], ids=["grow", "shrink", "p99", "points"])
def test_decisions_match_reference_on_the_same_telemetry(policy):
    """A seeded stream of round telemetry (completion times with held
    workers, trigger times, vote-gated detections in bursts, quarantine
    occupancy) fed to both controllers gives the same decisions."""
    ctls = {side: m["ctl"].RedundancyController(
        m["scheme"].get_scheme("berrut", 4, s=1, e=1),
        m["ctl"].ControllerConfig(**policy)) for side, m in SIDES.items()}
    rng = np.random.RandomState(7)
    for r in range(120):
        width = ctls["jax"].scheme.num_workers
        assert ctls["torch"].scheme.num_workers == width
        times = rng.exponential(12.0 if r < 60 else 3.0, width)
        times[rng.rand(width) < 0.05] = np.inf
        attacked = (r // 20) % 2 == 0 and rng.rand() < 0.6
        detected = np.zeros(width, bool)
        if attacked:
            detected[rng.randint(width)] = True
        report = type("Report", (), {"detected": detected})()
        kw = dict(times=times, trigger_ms=float(np.sort(times)[width // 2]),
                  report=report if rng.rand() < 0.9 else None,
                  quarantined=int(rng.randint(0, 3)))
        got = {side: c.observe_round(float(r), **kw)
               for side, c in ctls.items()}
        assert (got["torch"] is None) == (got["jax"] is None), r
    jd, td = ctls["jax"].decisions, ctls["torch"].decisions
    assert len(jd) > 2
    assert [_decision(d) for d in td] == [_decision(d) for d in jd]
    assert ctls["torch"].decision_log() == ctls["jax"].decision_log()


def test_operating_points_match_reference():
    """Pool view, maximum point, snapping and the configuration checks."""
    for policy in (dict(s_max=3, e_max=2), dict(s_min=1, s_max=2, e_max=1),
                   dict(allowed_points=((0, 1), (2, 0)), s_max=2, e_max=1)):
        j, t = (m["ctl"].RedundancyController(
            m["scheme"].get_scheme("berrut", 4, s=0, e=0),
            m["ctl"].ControllerConfig(**policy)) for m in SIDES.values())
        assert t.pool == tctl.PoolView(**dataclasses.asdict(j.pool))
        assert t.max_scheme.config.__dict__ == j.max_scheme.config.__dict__
        assert (t.scheme.s, t.scheme.e, t.wait_for) == \
            (j.scheme.s, j.scheme.e, j.wait_for)
        for s in range(4):
            for e in range(3):
                assert t._snap(s, e) == j._snap(s, e)
    for bad in (dict(window_rounds=0), dict(s_min=2, s_max=1),
                dict(e_min=-1), dict(allowed_points=((5, 0),))):
        with pytest.raises(ValueError):
            jctl.ControllerConfig(**bad)
        with pytest.raises(ValueError):
            tctl.ControllerConfig(**bad)


# ------------------------------------------- adaptive EngineExecutor run

W_OUT = np.random.RandomState(0).randn(3, 64)


def _predict(side):
    if side == "jax":
        return lambda x: np.asarray(x) @ W_OUT
    return lambda x: (x.double() @ torch.from_numpy(W_OUT)).float()


def _engine(side, scheme, **kw):
    if side == "jax":
        return jsched.EngineExecutor(_predict(side), scheme, **kw)
    return tsched.EngineExecutor(_predict(side), scheme, device="cpu", **kw)


def _adaptive_engine_run(side, seed=0, n=96):
    """``tests/test_controller.py``'s adaptive run (K=4 S=1 E=1 start,
    an intermittent 2-worker attacker, quarantine, diurnal arrivals),
    its predictor widened to 64 outputs so that the vote has 64
    coordinates."""
    m = SIDES[side]
    scheme = m["scheme"].get_scheme("berrut", 4, s=1, e=1)
    ctrl = m["ctl"].RedundancyController(scheme, m["ctl"].ControllerConfig(
        window_rounds=8, s_max=2, e_max=2, straggle_ms=30.0))
    sched = m["sched"].CodedScheduler(
        m["sched"].SchedulerConfig(
            scheme=scheme, groups_per_batch=1, flush_deadline_ms=1.0,
            seed=seed, controller=ctrl,
            adversary=m["fail"].AdversaryConfig(
                kind="intermittent", attack_rate=0.5, num_adversaries=2,
                sigma=80.0, seed=3),
            quarantine=m["quar"].QuarantineConfig()),
        m["lat"].LatencyModel(tail_prob=0.3), _engine(side, scheme))
    arr = m["lat"].trace_arrivals(n, m["lat"].TrafficModel(
        base_rate_rps=3000.0), seed=7)
    payloads = [np.random.RandomState(i).randn(3) for i in range(n)]
    return sched, sched.run(payloads, arrival_ms=arr)


def _both(monkeypatch, serve, *args, **kw):
    share_noise(monkeypatch)
    with jops.force_kernel("xla"):
        jrun = serve("jax", *args, **kw)
    return jrun, serve("torch", *args, **kw)


def _assert_adaptive_parity(jrun, trun, ties=(), call_rounds=None):
    """Without a disputed verdict (``ties``: the near-tie walk's call
    indices) traces and decision logs agree.  With one, they agree up to
    the round of the first: the trace through that round's event, and
    the decisions made before it was observed."""
    (jsch, _), (tsch, _) = jrun, trun
    jctrl, tctrl = jsch.controller, tsch.controller
    if not ties:
        assert tsch.trace == jsch.trace
        assert [_decision(d) for d in tctrl.decisions] == \
            [_decision(d) for d in jctrl.decisions]
        return
    r = ties[0] if call_rounds is None else call_rounds[ties[0]]
    upto = [n for n, ev in enumerate(jsch.trace) if ev[0] == "round"][r]
    assert tsch.trace[:upto + 1] == jsch.trace[:upto + 1]
    assert [_decision(d) for d in tctrl.decisions if d.round_idx <= r] == \
        [_decision(d) for d in jctrl.decisions if d.round_idx <= r]


def test_adaptive_engine_run_matches_reference(monkeypatch):
    """The run retunes (N, E) at least once; traces, decision logs and
    outputs agree."""
    jrun, trun = _both(monkeypatch, _adaptive_engine_run)
    (jsch, jm), (tsch, tm) = jrun, trun
    _assert_adaptive_parity(jrun, trun)
    assert len(tsch.controller.decisions) >= 2
    assert tm.control_decisions == jm.control_decisions
    for uid, want in jsch.results.items():
        np.testing.assert_allclose(tsch.results[uid], want, rtol=1e-5,
                                   atol=1e-4)
    assert len(tsch.controller.decisions) >= 2
    assert len({b.dispatch_plan.num_workers for b in tsch.batches}) >= 2
    assert tm.control_decisions == jm.control_decisions >= 1


# ------------------------------------------------ adaptive LLM serving

K, PROMPT_LEN, STEPS, MAX_STEPS = 2, 8, 3, 5
TAILS = dict(tail_prob=0.5)


@pytest.fixture(scope="module")
def model():
    jc, tc = jcfg.reduced(), tcfg.reduced()
    jp = j_init_params(jc, jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return {"jax": (jc, jp), "torch": (tc, tp)}


def _controller(side, s=0, e=1, s_max=2, e_max=1, window_rounds=4,
                allowed_points=None):
    m = SIDES[side]
    return m["ctl"].RedundancyController(
        m["scheme"].get_scheme("berrut", K, s=s, e=e),
        m["ctl"].ControllerConfig(
            window_rounds=window_rounds, s_min=0, s_max=s_max, e_min=0,
            e_max=e_max, straggle_ms=20.0, allowed_points=allowed_points))


def _prompts(n, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 512, (PROMPT_LEN,)).astype(np.int32)
            for _ in range(n)]


def _batch_executor(side, model, coding, **kw):
    cfg, params = model[side]
    if side == "jax":
        return jsched.CodedLLMExecutor(cfg, coding, params, steps=STEPS,
                                       max_len=PROMPT_LEN + STEPS + 2, **kw)
    return CodedLLMExecutor(cfg, coding, params, steps=STEPS,
                            max_len=PROMPT_LEN + STEPS + 2, **kw)


def _adaptive_batch(side, model, operating_points=None, n=16, seed=0):
    """``tests/test_adaptive_llm.py``'s ``_legacy_adaptive``: the batch
    scheduler over the LLM executor at the controller's maximum point (or
    with declared operating points), a persistent attacker with
    quarantine, full batches only."""
    m = SIDES[side]
    if operating_points is None:
        ctrl = _controller(side)
    else:
        pts = tuple(operating_points)
        ctrl = _controller(side, s=0, e=0, s_max=max(s for s, _ in pts),
                           e_max=max(e for _, e in pts),
                           allowed_points=pts)
    executor = _batch_executor(side, model, ctrl.max_scheme.coding,
                               operating_points=operating_points)
    adversary = (m["fail"].AdversaryConfig(kind="persistent", sigma=80.0,
                                           seed=3)
                 if ctrl.max_scheme.e > 0 else None)
    sched = m["sched"].CodedScheduler(
        m["sched"].SchedulerConfig(
            groups_per_batch=1, flush_deadline_ms=None, seed=seed,
            controller=ctrl, adversary=adversary,
            quarantine=m["quar"].QuarantineConfig() if adversary else None),
        m["lat"].LatencyModel(**TAILS), executor)
    metrics = sched.run(_prompts(n),
                        jsched.poisson_arrivals(n, 20.0, seed=seed + 1))
    return sched, metrics


def test_adaptive_llm_batch_matches_reference(model, monkeypatch):
    """The masked max-width batch path: retunes dispatch a prefix of the
    executor's streams.  Traces, decision logs and tokens agree, up to
    the first disputed verdict (exact or near tie) when there is one."""
    columns = capture_columns(monkeypatch, jcs, tcs)
    jrun, trun = _both(monkeypatch, _adaptive_batch, model)
    (jsch, _), (tsch, tm) = jrun, trun
    rounds = locate_rounds(tsch)
    _, ties = near_tie_walk(tsch.controller.max_scheme.coding,
                            locate_rounds(jsch), rounds, *columns)
    _assert_adaptive_parity(jrun, trun, ties)
    assert tm.control_decisions >= 1
    assert len({b.dispatch_plan.num_workers for b in tsch.batches}) >= 2
    if not ties:
        for uid, want in jsch.results.items():
            np.testing.assert_array_equal(tsch.results[uid], want)
    else:
        assert_tokens_before_disputes(jsch, tsch, rounds, ties, ties[0] + 1)


def test_adaptive_llm_operating_points_match_reference(model, monkeypatch):
    """Declared operating points: each runs at its own width (E=0, no
    locator); the points visited are the reference's compiled ones, and
    traces, decisions and tokens agree."""
    points = ((0, 0), (1, 0))
    jrun, trun = _both(monkeypatch, _adaptive_batch, model, points)
    (jsch, _), (tsch, tm) = jrun, trun
    _assert_adaptive_parity(jrun, trun)
    visited = set(tsch.executor.points_visited)
    assert visited == set(jsch.executor._programs) == set(points)
    for uid, want in jsch.results.items():
        np.testing.assert_array_equal(tsch.results[uid], want)
    with pytest.raises(ValueError, match="declared set"):
        tsch.executor.dispatch(np.zeros((K, PROMPT_LEN), np.int32),
                               scheme=tscheme.get_scheme("berrut", K, s=2))


def _adaptive_pool(side, model, n=15, seed=0):
    """``tests/test_adaptive_llm.py``'s ``_continuous_run``: the slot pool
    under a controller, with churn, a persistent attacker and
    quarantine."""
    m = SIDES[side]
    cfg, params = model[side]
    ctrl = _controller(side)
    rng = np.random.RandomState(seed)
    prompts = _prompts(n, seed=seed)
    budgets = rng.randint(1, MAX_STEPS + 1, size=n)
    executor = m["cont"].ContinuousLLMExecutor(
        cfg, ctrl.max_scheme.coding, params, pool_groups=2,
        max_len=PROMPT_LEN + MAX_STEPS + 2)
    sched = m["cont"].ContinuousScheduler(
        m["cont"].ContinuousConfig(
            pool_groups=2, flush_deadline_ms=4.0, seed=seed,
            max_new_tokens=MAX_STEPS, controller=ctrl,
            adversary=m["fail"].AdversaryConfig(kind="persistent",
                                                sigma=80.0, seed=3),
            quarantine=m["quar"].QuarantineConfig(),
            churn=m["lat"].ChurnModel(mean_up_ms=200.0, mean_down_ms=20.0,
                                      seed=5)),
        m["lat"].LatencyModel(**TAILS), executor)
    metrics = sched.run(prompts, jsched.poisson_arrivals(n, 2500.0,
                                                         seed=seed + 1),
                        max_new_tokens=budgets)
    return sched, metrics


def test_adaptive_llm_pool_matches_reference(model, monkeypatch):
    """The slot pool under a controller: traces (retunes included),
    decision logs, round widths and tokens agree, up to the first
    disputed verdict (exact or near tie) when there is one."""
    jcalls, tcalls = [], []
    record_pool_calls(monkeypatch, jcont.ContinuousLLMExecutor, jcalls)
    record_pool_calls(monkeypatch, tcont.ContinuousLLMExecutor, tcalls)
    columns = capture_columns(monkeypatch, jcs, tcs)
    jrun, trun = _both(monkeypatch, _adaptive_pool, model)
    (jsch, _), (tsch, tm) = jrun, trun
    _, ties = near_tie_walk(tsch.controller.max_scheme.coding, jcalls,
                            tcalls, *columns)
    rounds = pool_call_rounds(tsch.trace)
    _assert_adaptive_parity(jrun, trun, ties, rounds)
    r = rounds[ties[0]] if ties else len(tsch.round_widths)
    assert tsch.round_widths[:r + 1] == jsch.round_widths[:r + 1]
    assert len(set(tsch.round_widths)) >= 2
    assert tm.control_decisions >= 1 and tm.churn_leaves > 0
    if not ties:
        for uid, want in jsch.results.items():
            np.testing.assert_array_equal(tsch.results[uid], want)


# ------------------------------------------- retunes and call shapes

def _retune_refusal(side, model, pool):
    """A narrow gather width passes construction, then the first retune
    to an E=1 point (quorum 4 > 3) must raise, not clamp."""
    m = SIDES[side]
    ctrl = _controller(side, s=0, e=1, s_max=1, e_max=1, window_rounds=2)
    if pool:
        cfg, params = model[side]
        executor = m["cont"].ContinuousLLMExecutor(
            cfg, ctrl.max_scheme.coding, params, pool_groups=2,
            max_len=PROMPT_LEN + MAX_STEPS + 2)
        sched = m["cont"].ContinuousScheduler(
            m["cont"].ContinuousConfig(pool_groups=2, flush_deadline_ms=4.0,
                                       seed=0, max_new_tokens=MAX_STEPS,
                                       controller=ctrl),
            m["lat"].LatencyModel(**TAILS), executor)
        executor.wshard = m["shard"](gather_width=3)
        payloads = _prompts(8)
    else:
        executor = _engine(side, ctrl.max_scheme,
                           wshard=m["shard"](gather_width=3))
        sched = m["sched"].CodedScheduler(
            m["sched"].SchedulerConfig(groups_per_batch=1,
                                       flush_deadline_ms=None, seed=0,
                                       controller=ctrl),
            m["lat"].LatencyModel(**TAILS), executor)
        payloads = [np.random.RandomState(i).randn(3) for i in range(16)]
    with pytest.raises(ValueError) as info:
        sched.run(payloads, jsched.poisson_arrivals(len(payloads), 2500.0,
                                                    seed=1))
    return str(info.value), sched.trace


@pytest.mark.parametrize("pool", [False, True], ids=["batch", "pool"])
def test_retune_revalidates_the_gather_bound(model, pool):
    with jops.force_kernel("xla"):
        jmsg, jtrace = _retune_refusal("jax", model, pool)
    tmsg, ttrace = _retune_refusal("torch", model, pool)
    assert tmsg == jmsg and "gather width" in tmsg
    assert ttrace == jtrace


def test_static_executor_never_sees_replan_kwargs():
    """A third-party executor without ``supports_replan`` keeps the
    legacy call shape: no ``scheme=`` / ``locate_quorum=``."""
    scheme = tscheme.get_scheme("berrut", K, s=1, e=0)

    class LegacyExec(tsched.EngineExecutor):
        supports_replan = False

        def decode(self, handle, mask, attack=None):
            return tsched.EngineExecutor.decode(self, handle, mask, attack)

    sched = tsched.CodedScheduler(
        tsched.SchedulerConfig(scheme=scheme, groups_per_batch=1, seed=0),
        tlat.LatencyModel(), LegacyExec(_predict("torch"), scheme,
                                        device="cpu"))
    payloads = [np.random.RandomState(i).randn(3) for i in range(8)]
    assert sched.run(payloads, jsched.poisson_arrivals(
        8, 2000.0, seed=1)).count == 8
    with pytest.raises(ValueError, match="re-plans"):
        tsched.CodedScheduler(
            tsched.SchedulerConfig(controller=tctl.RedundancyController(
                scheme)), tlat.LatencyModel(),
            LegacyExec(_predict("torch"), scheme, device="cpu"))
    with pytest.raises(ValueError, match="controller-managed"):
        tsched.CodedScheduler(
            tsched.SchedulerConfig(scheme=scheme, wait_for=3,
                                   controller=tctl.RedundancyController(
                                       scheme)),
            tlat.LatencyModel(), _engine("torch", scheme))
