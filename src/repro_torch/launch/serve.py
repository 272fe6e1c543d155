"""Coded serving launcher (port of ``repro.launch.serve``).

Batch path (default): the event-driven scheduler (DESIGN.md §8).
Requests arrive on a Poisson clock at ``--rate``, the deadline-flushing
batcher (``--deadline-ms``) forms batches of ``--groups`` query groups of
K, each group is Berrut-encoded into N+1 coded streams, and every round
of a batch (the prefill, then one per decode step) is a coded dispatch
whose straggler mask derives from per-worker completion times of the
default latency model: the decode fires the moment the fastest
``wait_for`` streams land (K with E = 0, the locator quorum K+2E with
E > 0).  ``--slo-ms`` sets the goodput SLO.  Tokens are greedy, or with
``--top-k`` > 1 drawn from the ``--temperature``-scaled top-k logits.

``--continuous``: continuous batching over a fixed coded-KV slot pool
(DESIGN.md §10): ``--pool-groups`` group slots host groups that join at
prefill mid-flight and retire at per-request budgets drawn from
1..``--steps``.

With E > 0 an adversary (``--attack persistent|intermittent|colluding``,
``--attack-rate``) controls E compromised workers that corrupt their
coded logits with noise of scale ``--byz-sigma``, and the vote-gated
locator has to find them; ``--quarantine`` stops dispatching to repeat
offenders for ``--probation-ms``, ``--churn`` lets workers leave and
rejoin (``--churn-up-ms``, ``--churn-down-ms``), and ``--traffic
diurnal`` replaces the homogeneous Poisson arrivals with a diurnal and
bursty trace around ``--rate``.  ``--attack-placement worst_case`` puts
the compromised workers where the locator finds them hardest.
``--adaptive``: a ``RedundancyController`` (DESIGN.md §12) retunes (N, E,
wait_for) between batches (between pool rounds with ``--continuous``)
within one step of headroom above (S, E); the executor is built at the
controller's maximum point and narrower points are masked off.  Prompts
and budgets come from a numpy generator seeded by ``--seed``; weights
are random, drawn from a torch generator with the same seed.

  PYTHONPATH=src python -m repro_torch.launch.serve --reduced --device cpu \
      --requests 8 --k 4 --steps 4
  PYTHONPATH=src python -m repro_torch.launch.serve --reduced --device cpu \
      --requests 16 --k 4 --e 1 --byz-sigma 10 --adaptive --quarantine
  PYTHONPATH=src python -m repro_torch.launch.serve --reduced --device cpu \
      --continuous --requests 16 --k 4 --e 1 --pool-groups 2 --steps 6 \
      --byz-sigma 10 --quarantine
  PYTHONPATH=src python -m repro_torch.launch.serve --continuous \
      --requests 32 --k 4 --s 1 --e 1 --pool-groups 4 --prompt-len 256 \
      --steps 16 --byz-sigma 10 --quarantine

``run_fixed_masks`` serves all requests as one batch with one random
straggler a round instead of the event clock: the port's counterpart of
the reference's offline ``wait_for`` evaluation, which the CLI does not
reach.  ``run(..., wshard=WorkerShardConfig(...))`` serves either path
with the worker-major stream layout of ``launch.worker_mesh``; the CLI
of several ranks is ``launch.multihost --mode serve``.

``--scheme`` picks any registered redundancy scheme (``berrut``,
``uncoded``, ``replication``, ``parm``, ``nercc``, ``invnet``).  berrut,
the default, takes the coded LLM paths above; every other scheme serves
single-shot next-token prediction over the model's embeddings through
``EngineExecutor`` under the same batch scheduler: each request's prompt
is embedded once, the scheme encodes the groups' (prompt_len, d_model)
embeddings into its worker streams (ParM adds their sum, replication
copies them, NeRCC a Chebyshev regression over them, Coded-InvNet
flow-mixed parity streams), every stream runs ``predict_fn`` (the
model's last-position logits) and the scheme's decode recovers the
straggled slots.  The answer is each request's greedy next token.  ParM's
parity stream runs the hosted model on the summed embeddings, as no
parity model is trained here.  ``--continuous`` serves berrut only.

  PYTHONPATH=src python -m repro_torch.launch.serve --reduced --device cpu \
      --requests 16 --k 4 --scheme replication --e 1 --byz-sigma 10
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import configs, resolve_device
from repro_torch.core.berrut import CodingConfig
from repro_torch.core.scheme import BerrutScheme, get_scheme, scheme_names
from repro_torch.models.model import embed_inputs, init_params, predict_fn
from repro_torch.serving.continuous import (ContinuousConfig,
                                            ContinuousLLMExecutor,
                                            ContinuousScheduler)
from repro_torch.serving.controller import (ControllerConfig,
                                            RedundancyController)
from repro_torch.serving.executor import CodedLLMExecutor
from repro_torch.serving.failures import AdversaryConfig, make_adversary
from repro_torch.serving.latency import (ChurnModel, LatencyModel,
                                         TrafficModel, trace_arrivals)
from repro_torch.serving.quarantine import QuarantineConfig
from repro_torch.serving.sampling import SampleConfig
from repro_torch.serving.scheduler import (CodedScheduler, EngineExecutor,
                                           SchedulerConfig)

ATTACKS = ("persistent", "intermittent", "colluding")
PLACEMENTS = ("random", "worst_case")
TRAFFIC = ("poisson", "diurnal")


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


# what the audio and vlm frontends read instead of token prompts alone
FRONTEND_INPUTS = {"audio": "frames", "vlm": "patches"}


def refuse_frontends(cfg) -> None:
    """Raise for a model whose inputs are not token prompts alone.  The
    launchers build token prompts only, so the reference's ``serve.run``
    fails inside ``embed_inputs`` on such a model (a ``KeyError`` for
    ``'frames'`` or ``'patches'``); the port refuses it before it builds
    the weights."""
    if cfg.modality in FRONTEND_INPUTS:
        raise ValueError(
            f"{cfg.name}: the {cfg.modality} frontend takes "
            f"{FRONTEND_INPUTS[cfg.modality]!r} inputs, and serving builds "
            "token prompts only; drive its modality dicts through "
            "serving.coded_serving or an EngineExecutor instead")


def _setup(arch, reduced, requests, k, s, e, prompt_len, seed, device,
           attack, traffic, top_k, temperature):
    """(device, model config, coding, sample config, prompt rng, params,
    prompts) of a run: the prompts are the rng's first draws."""
    device = resolve_device(device)
    cfg = configs.get_reduced(arch) if reduced else configs.get_config(arch)
    refuse_frontends(cfg)
    coding = CodingConfig(k=k, s=s, e=e)
    if attack not in ATTACKS:
        raise ValueError(f"attack must be one of {ATTACKS}, got {attack!r}")
    if traffic not in TRAFFIC:
        raise ValueError(f"traffic must be one of {TRAFFIC}, got "
                         f"{traffic!r}")
    sample = SampleConfig(top_k=top_k, temperature=temperature)
    rng = np.random.RandomState(seed)
    params = init_params(cfg, torch.Generator(device).manual_seed(seed),
                         device)
    prompts = rng.randint(0, cfg.vocab_size, (requests, prompt_len))
    return device, cfg, coding, sample, rng, params, prompts


def _adversary(e, attack, attack_rate, byz_sigma, attack_placement, seed):
    return (AdversaryConfig(kind=attack, attack_rate=attack_rate,
                            sigma=byz_sigma, num_adversaries=e,
                            placement=attack_placement, seed=seed)
            if e else None)


def run(arch: str = "qwen3-0.6b", reduced: bool = False, requests: int = 16,
        k: int = 4, s: int = 1, e: int = 0, prompt_len: int = 16,
        steps: int = 8, byz_sigma: float = 50.0, seed: int = 0,
        device=None, attack: str = "persistent", attack_rate: float = 1.0,
        continuous: bool = False, pool_groups: int = 4,
        rate_rps: float = 2000.0, flush_deadline_ms: float = 5.0,
        quarantine: bool = False, churn: bool = False,
        wshard=None, top_k: int = 1, temperature: float = 1.0,
        attack_placement: str = "random", probation_ms: float = 200.0,
        churn_up_ms: float = 2000.0, churn_down_ms: float = 200.0,
        traffic: str = "poisson", groups_per_batch: int = 2,
        slo_ms: float | None = None, adaptive: bool = False,
        scheme: str = "berrut") -> dict:
    """Serve ``requests`` random prompts through the batch scheduler or
    (with ``continuous``) the slot pool, worker-major with ``wshard``;
    a ``scheme`` other than berrut through the scheme-generic path.
    Returns a dict of what the run measured; see ``_run_batch``,
    ``_run_continuous`` and ``_run_scheme``."""
    schm = get_scheme(scheme, k=k, s=s, e=e)
    if continuous and scheme != "berrut":
        raise ValueError("--continuous drives the berrut slot-pool path; "
                         f"scheme {scheme!r} serves single-shot")
    if wshard is not None and scheme != "berrut":
        raise ValueError("the worker-major layout serves the berrut LLM "
                         f"paths; scheme {scheme!r} serves single-shot")
    device, cfg, coding, sample, rng, params, prompts = _setup(
        arch, reduced, requests, k, s, e, prompt_len, seed, device, attack,
        traffic, top_k, temperature)
    # num_adversaries is the CLI's E, not the scheme's: a scheme that
    # tolerates no Byzantine worker (uncoded) is still attacked
    adversary = _adversary(e, attack, attack_rate, byz_sigma,
                           attack_placement, seed)
    controller = None
    if adaptive:
        # one step of headroom above the CLI operating point on each
        # axis (E at least 1, so that the locator can be grown in); the
        # LLM executors are built at the controller's maximum point
        controller = RedundancyController(
            schm, ControllerConfig(
                window_rounds=8, s_min=0, s_max=s + 1, e_min=0,
                e_max=max(e, 1)))
        print(f"adaptive redundancy: start (S={s}, E={e}), bounds "
              f"S<={s + 1} E<={max(e, 1)}, pool sized for "
              f"{controller.pool.num_workers} workers")
    # quarantine acts on locator verdicts: without a locator (replication's
    # median, uncoded, parm, invnet) it would run dead
    if quarantine and e and not schm.has_locator:
        print(f"warning: --quarantine is inactive for scheme "
              f"{schm.name!r} (no error locator feeds the reputation "
              f"policy); ignoring")
        quarantine = False
    kw = dict(seed=seed, rate_rps=rate_rps,
              flush_deadline_ms=flush_deadline_ms, slo_ms=slo_ms,
              quarantine=(QuarantineConfig(probation_ms=probation_ms)
                          if quarantine and e else None),
              churn=(ChurnModel(mean_up_ms=churn_up_ms,
                                mean_down_ms=churn_down_ms, seed=seed + 7)
                     if churn else None),
              traffic=traffic, controller=controller)
    if scheme != "berrut":
        return _run_scheme(cfg, schm, params, {"tokens": prompts},
                           adversary, device,
                           groups_per_batch=groups_per_batch, **kw)
    kw.update(sample=sample, wshard=wshard)
    if continuous:
        return _run_continuous(cfg, coding, params, prompts, rng, steps,
                               adversary, device, pool_groups=pool_groups,
                               **kw)
    return _run_batch(cfg, coding, params, prompts, steps, adversary,
                      device, groups_per_batch=groups_per_batch, **kw)


def _arrivals(traffic, requests, rate_rps, seed):
    """(arrival_ms, rate_rps) for ``Scheduler.run``: a diurnal trace whose
    mean rate is ``rate_rps``, or the scheduler's own Poisson clock."""
    if traffic == "diurnal":
        return trace_arrivals(requests, TrafficModel(
            base_rate_rps=rate_rps), seed=seed + 11), None
    return None, rate_rps


def _print_decisions(controller) -> None:
    if controller is None:
        return
    for d in controller.decisions:
        print(f"  retune @round {d.round_idx}: S={d.s} E={d.e} -> "
              f"{d.num_workers} workers, wait_for {d.wait_for} "
              f"({d.reason})")


def _nan_none(x: float):
    return None if np.isnan(x) else x


def _run_batch(cfg, coding, params, prompts, steps, adversary_cfg, device,
               *, seed, groups_per_batch, rate_rps, flush_deadline_ms,
               slo_ms, quarantine, churn, traffic, sample, wshard,
               controller) -> dict:
    """The (requests, steps + 1) token matrix by uid, each executor
    round's wall time (ms, ending in its copy of the tokens to the host),
    tokens/s over them, the stragglers and located workers of each batch's
    rounds (lists by batch id, then round), the locator's precision and
    recall against the adversary (None with E = 0 or before a detection),
    the scheduler's ``metrics`` (event clock), ``trace`` and ``batches``,
    the controller's decision log (None without ``controller``) and the
    attacker's workers."""
    requests = prompts.shape[0]
    exec_coding = (controller.max_scheme.coding if controller is not None
                   else coding)
    executor = CodedLLMExecutor(cfg, exec_coding, params, steps=steps,
                                max_len=prompts.shape[1] + steps + 2,
                                wshard=wshard, sample=sample,
                                sample_seed=seed)
    # under --adaptive the executor runs the controller's maximum point:
    # declare no scheme and let the executor's own win
    sched = CodedScheduler(
        SchedulerConfig(scheme=None if controller is not None
                        else BerrutScheme(coding),
                        groups_per_batch=groups_per_batch,
                        flush_deadline_ms=flush_deadline_ms, slo_ms=slo_ms,
                        seed=seed, adversary=adversary_cfg,
                        quarantine=quarantine, controller=controller,
                        churn=churn),
        LatencyModel(), executor)
    k, e = coding.k, coding.e
    print(f"serving {requests} requests of {prompts.shape[1]} tokens on "
          f"{device} ({cfg.name}) at {rate_rps:.0f} req/s ({traffic}): "
          f"batches of {groups_per_batch} groups of K={k} x "
          f"{exec_coding.num_workers} coded streams, S={coding.s} E={e}, "
          f"wait-for {coding.decode_quorum} of {coding.num_workers}"
          + (", worker-major" if wshard is not None else "")
          + (f", {adversary_cfg.kind} attacker on workers "
             f"{sched.adversary.workers.tolist()} at sigma "
             f"{adversary_cfg.sigma}" if adversary_cfg is not None else ""))
    arrival_ms, rate = _arrivals(traffic, requests, rate_rps, seed)
    metrics = sched.run([p.astype(np.int32) for p in prompts],
                        arrival_ms=arrival_ms, rate_rps=rate)
    _sync(device)
    tokens = np.stack([sched.results[u] for u in range(requests)])
    round_ms = list(executor.round_ms)
    total_ms = float(np.sum(round_ms))
    stragglers = [[np.flatnonzero(m < 0.5).tolist() for m in b.round_masks]
                  for b in sched.batches]
    located = [[[] if r is None else np.flatnonzero(r.detected).tolist()
                for r in b.round_reports] for b in sched.batches]
    result = {
        "tokens": tokens, "round_ms": round_ms, "total_ms": total_ms,
        "tokens_per_s": tokens.size / (total_ms / 1e3),
        "stragglers": stragglers, "located": located,
        "precision": (_nan_none(metrics.detection_precision())
                      if e else None),
        "recall": _nan_none(metrics.detection_recall()) if e else None,
        "metrics": metrics, "trace": sched.trace, "batches": sched.batches,
        "decisions": (controller.decision_log() if controller is not None
                      else None),
        "attackers": ([] if sched.adversary is None
                      else sched.adversary.workers.tolist()),
    }
    print(metrics.format_table())
    _print_decisions(controller)
    triggers = [w for b in sched.batches for w in b.round_waits]
    print(f"per-round decode trigger: p50 {np.percentile(triggers, 50):.1f}"
          f"ms  p99 {np.percentile(triggers, 99):.1f}ms ({len(triggers)} "
          f"coded rounds of {len(sched.batches)} batches)")
    print(f"{total_ms:.1f} ms over {len(round_ms)} rounds (wall clock), "
          f"{result['tokens_per_s']:.1f} tokens/s")
    if e:
        print(f"locator precision {result['precision']} "
              f"recall {result['recall']}")
    for i in range(min(4, requests)):
        print(f"  request {i}: {tokens[i].tolist()}")
    return result


# what each scheme's banner says beside the run's header line
_SCHEME_NOTES = {
    "parm": "parm: the parity stream runs the hosted model on the summed "
            "embeddings (no parity model is trained here: the retraining "
            "per hosted model that ApproxIFER removes)",
    "nercc": "nercc: nested-regression coding (arXiv 2402.04377), ridge "
             "Chebyshev encoder and decoder over Berrut's worker geometry",
    "invnet": "invnet: Coded-InvNet (arXiv 2106.06445), parity streams run "
              "the hosted model on flow-mixed queries; a single failed "
              "stream reconstructs exactly (trained-free fallback when no "
              "flow is fit)",
}


class _TimedEngineExecutor(EngineExecutor):
    """``EngineExecutor`` that keeps each dispatch's wall time (ms, ending
    in a device sync) and the streams of each ``predict_fn`` call."""

    def __init__(self, f, scheme, device):
        self.forward_streams = []
        self.dispatch_ms = []

        def counted(x):
            self.forward_streams.append(x.shape[0])
            return f(x)

        super().__init__(counted, scheme, device=device)

    def dispatch(self, queries, scheme=None):
        t0 = time.perf_counter()
        out = super().dispatch(queries, scheme)
        _sync(self.device)
        self.dispatch_ms.append((time.perf_counter() - t0) * 1e3)
        return out


def _run_scheme(cfg, scheme, params, inputs, adversary_cfg, device, *,
                seed, groups_per_batch, rate_rps, flush_deadline_ms,
                slo_ms, quarantine, churn, traffic, controller) -> dict:
    """The scheme-generic single-shot path: the requests' inputs (a
    modality dict of host arrays, one row a request: ``{"tokens":
    prompts}``, or an encoder's ``{"frames": ...}``) embedded once, each
    request's (length, d_model) embedding a payload, ``EngineExecutor``
    over ``predict_fn`` under the batch scheduler.  Returns each request's
    greedy next token (``tokens``, (requests, 1)) and served last-position
    logits (``logits``, (requests, V)) by uid, each dispatch's wall time
    (``dispatch_ms``), the streams of each ``predict_fn`` call, the
    stragglers and located workers of each batch (lists by batch id), the
    locator's precision and recall against the adversary (None without
    one or before a detection), the scheduler's ``metrics`` (event
    clock), ``trace`` and ``batches``, the controller's decision log
    (None without one) and the attacker's workers."""
    # host payloads, as the scheduler stacks them; fp32 as the reference's
    emb = embed_inputs(cfg, params, {
        key: torch.as_tensor(val, device=device)
        for key, val in inputs.items()})
    payloads = list(emb.float().cpu().numpy())
    requests, length = emb.shape[:2]
    executor = _TimedEngineExecutor(predict_fn(cfg, params), scheme, device)
    sched = CodedScheduler(
        SchedulerConfig(scheme=scheme, groups_per_batch=groups_per_batch,
                        flush_deadline_ms=flush_deadline_ms, slo_ms=slo_ms,
                        seed=seed, adversary=adversary_cfg,
                        quarantine=quarantine, controller=controller,
                        churn=churn),
        LatencyModel(), executor)
    k, s = scheme.k, scheme.s
    attacked = adversary_cfg is not None
    print(f"serving {requests} requests of {length} positions on "
          f"{device} ({cfg.name}) at {rate_rps:.0f} req/s ({traffic}): "
          f"batches of {groups_per_batch} groups of K={k} x "
          f"{scheme.num_workers} {scheme.name} worker streams (overhead "
          f"{scheme.overhead:.2f}x), S={s} E={scheme.e}, wait-for "
          f"{scheme.decode_quorum} of {scheme.num_workers}"
          + (f", {adversary_cfg.kind} attacker on workers "
             f"{sched.adversary.workers.tolist()} at sigma "
             f"{adversary_cfg.sigma}" if attacked else ""))
    if scheme.name in _SCHEME_NOTES:
        print(_SCHEME_NOTES[scheme.name]
              + (f"; E={scheme.e} runs the studentised-residual vote "
                 f"locator" if scheme.name == "nercc" and scheme.e else ""))
    arrival_ms, rate = _arrivals(traffic, requests, rate_rps, seed)
    metrics = sched.run(payloads, arrival_ms=arrival_ms, rate_rps=rate)
    _sync(device)
    logits = np.stack([sched.results[u] for u in range(requests)])
    tokens = np.argmax(logits, -1)[:, None]
    result = {
        "tokens": tokens, "logits": logits,
        "dispatch_ms": list(executor.dispatch_ms),
        "forward_streams": list(executor.forward_streams),
        "stragglers": [np.flatnonzero(b.mask < 0.5).tolist()
                       for b in sched.batches],
        "located": [[] if b.round_reports[-1] is None
                    else np.flatnonzero(b.round_reports[-1].detected).tolist()
                    for b in sched.batches],
        "precision": (_nan_none(metrics.detection_precision())
                      if attacked else None),
        "recall": (_nan_none(metrics.detection_recall())
                   if attacked else None),
        "metrics": metrics, "trace": sched.trace, "batches": sched.batches,
        "decisions": (controller.decision_log() if controller is not None
                      else None),
        "attackers": ([] if sched.adversary is None
                      else sched.adversary.workers.tolist()),
    }
    print(metrics.format_table())
    _print_decisions(controller)
    triggers = [w for b in sched.batches for w in b.round_waits]
    print(f"per-batch decode trigger: p50 {np.percentile(triggers, 50):.1f}"
          f"ms  p99 {np.percentile(triggers, 99):.1f}ms ({len(triggers)} "
          f"batches); dispatch {np.mean(executor.dispatch_ms):.2f} ms mean "
          f"(wall clock)")
    if attacked:
        print(f"locator precision {result['precision']} "
              f"recall {result['recall']}")
    for i in range(min(4, requests)):
        print(f"  request {i}: {tokens[i].tolist()}")
    return result


def run_fixed_masks(arch: str = "qwen3-0.6b", reduced: bool = False,
                    requests: int = 16, k: int = 4, s: int = 1, e: int = 0,
                    prompt_len: int = 16, steps: int = 8,
                    byz_sigma: float = 50.0, seed: int = 0, device=None,
                    attack: str = "persistent", attack_rate: float = 1.0,
                    wshard=None, top_k: int = 1, temperature: float = 1.0,
                    attack_placement: str = "random") -> dict:
    """Serve all ``requests`` as one batch of requests / K groups with
    fixed masks: every round takes S random workers out (drawn after the
    prompts from the same numpy generator) and waits for the rest, no
    event clock.  The counterpart of the reference's offline ``wait_for``
    evaluation; returns the (requests, steps + 1) token matrix, each
    round's wall time (ms, ending in a device sync), tokens/s, the
    stragglers and located workers of each round, and the locator's
    precision and recall against the adversary (None with E = 0)."""
    device, cfg, coding, sample, rng, params, prompts = _setup(
        arch, reduced, requests, k, s, e, prompt_len, seed, device, attack,
        "poisson", top_k, temperature)
    adversary_cfg = _adversary(e, attack, attack_rate, byz_sigma,
                               attack_placement, seed)
    n1 = coding.num_workers
    if requests % k:
        raise ValueError(f"the batch path serves whole groups: requests "
                         f"({requests}) must be a multiple of K ({k})")
    if s > n1:
        raise ValueError(f"cannot straggle {s} of {n1} workers")
    executor = CodedLLMExecutor(cfg, coding, params, steps=steps,
                                max_len=prompts.shape[1] + steps + 2,
                                wshard=wshard, sample=sample,
                                sample_seed=seed)
    adversary = make_adversary(coding, adversary_cfg)
    print(f"serving {requests} requests of {prompts.shape[1]} tokens on "
          f"{device} ({cfg.name}) with fixed masks: {requests // k} groups "
          f"of K={k} x {n1} coded streams, S={s} E={e}"
          + (", worker-major" if wshard is not None else "")
          + (f", {adversary_cfg.kind} attacker on workers "
             f"{adversary.workers.tolist()} at sigma {adversary_cfg.sigma}"
             if adversary is not None else ""))


    handle = executor.dispatch(prompts)
    round_ms, stragglers, located = [], [], []
    tp = fp = fn = 0
    for r in range(executor.rounds):
        mask = np.ones((n1,), np.float32)
        out = rng.choice(n1, s, replace=False)
        mask[out] = 0.0
        attack = adversary.next_round() if adversary is not None else None
        _sync(device)
        t0 = time.perf_counter()
        if r < executor.rounds - 1:
            handle, report = executor.step(handle, r, mask, attack)
        else:
            tokens, report = executor.decode(handle, mask, attack)
        _sync(device)
        round_ms.append((time.perf_counter() - t0) * 1e3)
        stragglers.append(sorted(out.tolist()))
        detected = (report.detected if report is not None
                    else np.zeros((n1,), bool))
        located.append(np.flatnonzero(detected).tolist())
        corrupt = ((attack.mask > 0) if attack is not None
                   else np.zeros((n1,), bool)) & (mask > 0)
        tp += int(np.sum(detected & corrupt))
        fp += int(np.sum(detected & ~corrupt))
        fn += int(np.sum(~detected & corrupt))
        kind = "prefill" if r == 0 else "decode"
        print(f"  round {r:2d} ({kind}): {round_ms[-1]:9.2f} ms, "
              f"stragglers {stragglers[-1]}"
              + (f" located {located[-1]}" if e else ""))
    total_ms = float(np.sum(round_ms))
    result = {
        "tokens": tokens, "round_ms": round_ms, "total_ms": total_ms,
        "tokens_per_s": tokens.size / (total_ms / 1e3),
        "stragglers": stragglers, "located": located,
        "precision": (tp / (tp + fp) if tp + fp else None) if e else None,
        "recall": (tp / (tp + fn) if tp + fn else None) if e else None,
    }
    print(f"{total_ms:.1f} ms over {executor.rounds} rounds, "
          f"{result['tokens_per_s']:.1f} tokens/s")
    if e:
        print(f"locator precision {result['precision']} "
              f"recall {result['recall']}")
    for i in range(min(4, requests)):
        print(f"  request {i}: {tokens[i].tolist()}")
    return result


def _run_continuous(cfg, coding, params, prompts, rng, steps, adversary_cfg,
                    device, *, seed, pool_groups, rate_rps,
                    flush_deadline_ms, slo_ms, quarantine, churn, traffic,
                    sample, wshard, controller) -> dict:
    """Per-uid generated tokens (``results``) and budgets, the scheduler's
    event ``trace`` and ``metrics`` (event clock), the number of pool
    rounds and of prefill / decode calls, each call's wall time (ms,
    ending in its host sync), tokens/s over the calls' wall time, and the
    controller's decision log (None without ``controller``)."""
    requests = prompts.shape[0]
    budgets = rng.randint(1, steps + 1, size=requests)
    pool_coding = (controller.max_scheme.coding if controller is not None
                   else coding)
    executor = ContinuousLLMExecutor(
        cfg, pool_coding, params, pool_groups=pool_groups,
        max_len=prompts.shape[1] + steps + 2,
        byz_collude=(adversary_cfg is not None
                     and adversary_cfg.kind == "colluding"), sample=sample,
        sample_seed=seed, wshard=wshard)
    e = coding.e
    sched = ContinuousScheduler(
        ContinuousConfig(
            coding=None if controller is not None else coding,
            pool_groups=pool_groups, flush_deadline_ms=flush_deadline_ms,
            slo_ms=slo_ms, seed=seed, adversary=adversary_cfg,
            quarantine=quarantine, churn=churn, controller=controller,
            max_new_tokens=steps),
        LatencyModel(), executor)
    print(f"continuous batching of {requests} requests of "
          f"{prompts.shape[1]} tokens on {device} ({cfg.name}) at "
          f"{rate_rps:.0f} req/s ({traffic}): {pool_groups} group slots of K="
          f"{coding.k} x {pool_coding.num_workers} coded streams "
          f"({pool_groups * pool_coding.num_workers} pooled), S={coding.s} "
          f"E={e}, per-request budgets 1..{steps}"
          + (", worker-major" if wshard is not None else "")
          + (f", {adversary_cfg.kind} attacker at sigma "
             f"{adversary_cfg.sigma}" if adversary_cfg is not None else ""))
    arrival_ms, rate = _arrivals(traffic, requests, rate_rps, seed)
    metrics = sched.run([p.astype(np.int32) for p in prompts],
                        arrival_ms=arrival_ms, rate_rps=rate,
                        max_new_tokens=budgets)
    _sync(device)
    prefill_ms = executor.call_ms["prefill"]
    decode_ms = executor.call_ms["decode"]
    wall_ms = float(np.sum(prefill_ms) + np.sum(decode_ms))
    generated = int(sum(len(v) for v in sched.results.values()))
    result = {
        "results": dict(sched.results), "budgets": budgets,
        "trace": sched.trace, "metrics": metrics,
        "rounds": sched.rounds_run,
        "prefill_calls": executor.prefill_calls,
        "decode_calls": executor.decode_calls,
        "prefill_ms": prefill_ms, "decode_ms": decode_ms,
        "wall_ms": wall_ms, "tokens_per_s": generated / (wall_ms / 1e3),
        "decisions": (controller.decision_log() if controller is not None
                      else None),
    }
    print(metrics.format_table())
    _print_decisions(controller)
    print(f"{sched.rounds_run} pool rounds: {executor.prefill_calls} "
          f"prefill calls, mean {np.mean(prefill_ms):.2f} ms; "
          f"{executor.decode_calls} decode calls, mean "
          f"{np.mean(decode_ms):.2f} ms (wall clock); {generated} tokens "
          f"in {wall_ms:.1f} ms, {result['tokens_per_s']:.1f} tokens/s")
    for uid in sorted(sched.results)[:4]:
        print(f"  request {uid}: {sched.results[uid].tolist()}")
    return result


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen3-0.6b",
                    choices=configs.list_archs())
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--k", type=int, default=4)
    ap.add_argument("--s", type=int, default=1)
    ap.add_argument("--e", type=int, default=0)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--steps", type=int, default=8,
                    help="decode steps (batch), or the largest "
                         "per-request budget (--continuous)")
    ap.add_argument("--top-k", type=int, default=1,
                    help="on-device sampling: 1 = greedy, > 1 samples "
                         "from the temperature-scaled top-k logits")
    ap.add_argument("--temperature", type=float, default=1.0,
                    help="softmax temperature for --top-k > 1")
    ap.add_argument("--byz-sigma", type=float, default=50.0)
    ap.add_argument("--attack", default="persistent", choices=ATTACKS,
                    help="adversary model (active when --e > 0)")
    ap.add_argument("--attack-rate", type=float, default=1.0,
                    help="per-dispatch corruption probability "
                         "(intermittent/colluding)")
    ap.add_argument("--attack-placement", default="random",
                    choices=PLACEMENTS,
                    help="compromised-worker placement")
    ap.add_argument("--groups", type=int, default=2,
                    help="query groups per dispatched batch")
    ap.add_argument("--slo-ms", type=float, default=None,
                    help="latency SLO for goodput accounting")
    ap.add_argument("--adaptive", action="store_true",
                    help="closed-loop (N, E, wait_for) retuning between "
                         "batches (between pool rounds with --continuous)")
    ap.add_argument("--continuous", action="store_true",
                    help="continuous batching over a fixed coded-KV slot "
                         "pool")
    ap.add_argument("--pool-groups", type=int, default=4,
                    help="group-slot capacity of the continuous pool")
    ap.add_argument("--rate", type=float, default=2000.0,
                    help="Poisson arrival rate, requests/second")
    ap.add_argument("--traffic", default="poisson", choices=TRAFFIC,
                    help="arrival process: homogeneous Poisson at --rate, "
                         "or a diurnal+bursty trace around --rate")
    ap.add_argument("--deadline-ms", type=float, default=5.0,
                    help="batcher flush deadline")
    ap.add_argument("--quarantine", action="store_true",
                    help="stop dispatching to repeatedly-located workers")
    ap.add_argument("--probation-ms", type=float, default=200.0,
                    help="quarantine duration before re-admission")
    ap.add_argument("--churn", action="store_true",
                    help="workers leave/rejoin on exponential clocks")
    ap.add_argument("--churn-up-ms", type=float, default=2000.0,
                    help="mean worker uptime between leaves")
    ap.add_argument("--churn-down-ms", type=float, default=200.0,
                    help="mean downtime before rejoin")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device; default cuda (cpu runs the plain "
                         "PyTorch path)")
    ap.add_argument("--scheme", default="berrut", choices=scheme_names(),
                    help="redundancy scheme served through the event loop "
                         "(berrut drives the autoregressive coded-LLM "
                         "paths; the others serve next-token prediction "
                         "over embeddings)")
    args = ap.parse_args(argv)
    return run(args.arch, args.reduced, args.requests, args.k, args.s,
               args.e, args.prompt_len, args.steps, args.byz_sigma,
               seed=args.seed, device=args.device, attack=args.attack,
               attack_rate=args.attack_rate, continuous=args.continuous,
               pool_groups=args.pool_groups, rate_rps=args.rate,
               flush_deadline_ms=args.deadline_ms,
               quarantine=args.quarantine, churn=args.churn,
               top_k=args.top_k, temperature=args.temperature,
               attack_placement=args.attack_placement,
               probation_ms=args.probation_ms,
               churn_up_ms=args.churn_up_ms,
               churn_down_ms=args.churn_down_ms, traffic=args.traffic,
               groups_per_batch=args.groups, slo_ms=args.slo_ms,
               adaptive=args.adaptive, scheme=args.scheme)


if __name__ == "__main__":
    main()
