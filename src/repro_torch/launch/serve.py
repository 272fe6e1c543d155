"""Coded serving launcher (port of the Berrut paths of
``repro.launch.serve``).

Batch path (default): all requests are served as one batch of
G = requests / K query groups, each Berrut-encoded into N+1 coded
streams: round 0 prefills the prompts, then every decode step is one
more coded round.  Each round's straggler mask takes S workers out at
random.  Tokens are greedy, or with ``--top-k`` > 1 drawn from the
``--temperature``-scaled top-k logits.

``--continuous``: continuous batching over a fixed coded-KV slot pool
(DESIGN.md §10).  Requests arrive on a Poisson clock at ``--rate``, the
deadline-flushing batcher forms groups of K, ``--pool-groups`` group
slots host groups that join at prefill mid-flight and retire at
per-request budgets drawn from 1..``--steps``, and every pool round's
straggler mask comes from per-worker completion times of the default
latency model.

With E > 0 an adversary (``--attack persistent|intermittent|colluding``,
``--attack-rate``) controls E compromised workers that corrupt their
coded logits with noise of scale ``--byz-sigma``, and the vote-gated
locator has to find them; ``--quarantine`` (continuous) stops
dispatching to repeat offenders for ``--probation-ms``, ``--churn``
(continuous) lets workers leave and rejoin (``--churn-up-ms``,
``--churn-down-ms``), and ``--traffic diurnal`` (continuous) replaces the
homogeneous Poisson arrivals with a diurnal and bursty trace around
``--rate``.  ``--attack-placement worst_case`` puts the compromised
workers where the locator finds them hardest.  Prompts, masks and budgets
come from a numpy generator seeded by ``--seed``; weights are random,
drawn from a torch generator with the same seed.

  PYTHONPATH=src python -m repro_torch.launch.serve --reduced --device cpu \
      --requests 8 --k 4 --steps 4
  PYTHONPATH=src python -m repro_torch.launch.serve --reduced --device cpu \
      --continuous --requests 16 --k 4 --e 1 --pool-groups 2 --steps 6 \
      --byz-sigma 10 --quarantine
  PYTHONPATH=src python -m repro_torch.launch.serve --continuous \
      --requests 32 --k 4 --s 1 --e 1 --pool-groups 4 --prompt-len 256 \
      --steps 16 --byz-sigma 10 --quarantine

``run(..., wshard=WorkerShardConfig(...))`` serves either path with the
worker-major stream layout of ``launch.worker_mesh`` (over the active
worker group, or on one rank); the CLI of several ranks is
``launch.multihost --mode serve``.  ``--adaptive`` and the other
redundancy schemes are not ported yet and are refused.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import configs, resolve_device
from repro_torch.core.berrut import CodingConfig
from repro_torch.models.model import init_params
from repro_torch.serving.continuous import (ContinuousConfig,
                                            ContinuousLLMExecutor,
                                            ContinuousScheduler)
from repro_torch.serving.executor import CodedLLMExecutor
from repro_torch.serving.failures import AdversaryConfig, make_adversary
from repro_torch.serving.latency import (ChurnModel, LatencyModel,
                                         TrafficModel, trace_arrivals)
from repro_torch.serving.quarantine import QuarantineConfig
from repro_torch.serving.sampling import SampleConfig

ATTACKS = ("persistent", "intermittent", "colluding")
PLACEMENTS = ("random", "worst_case")
TRAFFIC = ("poisson", "diurnal")


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


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
        traffic: str = "poisson") -> dict:
    """Serve ``requests`` random prompts, as one coded batch or (with
    ``continuous``) through the slot pool, worker-major with ``wshard``.
    Returns a dict of what the run measured; see ``_run_batch`` and
    ``_run_continuous``."""
    device = resolve_device(device)
    cfg = configs.get_reduced(arch) if reduced else configs.get_config(arch)
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
    adversary = (AdversaryConfig(kind=attack, attack_rate=attack_rate,
                                 sigma=byz_sigma, num_adversaries=e,
                                 placement=attack_placement, seed=seed)
                 if e else None)
    if continuous:
        return _run_continuous(cfg, coding, params, prompts, rng, steps,
                               adversary, device, seed=seed,
                               pool_groups=pool_groups, rate_rps=rate_rps,
                               flush_deadline_ms=flush_deadline_ms,
                               quarantine=(QuarantineConfig(
                                   probation_ms=probation_ms)
                                   if quarantine and e else None),
                               churn=(ChurnModel(mean_up_ms=churn_up_ms,
                                                 mean_down_ms=churn_down_ms,
                                                 seed=seed + 7)
                                      if churn else None),
                               traffic=traffic, sample=sample, wshard=wshard)
    if quarantine or churn or traffic != "poisson":
        raise ValueError("--quarantine, --churn and --traffic run on the "
                         "event clock of --continuous")
    return _run_batch(cfg, coding, params, prompts, rng, steps, adversary,
                      device, wshard, sample, seed)


def _run_batch(cfg, coding, params, prompts, rng, steps, adversary_cfg,
               device, wshard, sample, seed) -> dict:
    """The (requests, steps + 1) token matrix, per-round wall times (ms,
    each ending in a device sync), tokens/s, the stragglers and located
    workers of each round, and the locator's precision and recall
    against the adversary (None with E = 0)."""
    requests = prompts.shape[0]
    k, s, e, n1 = coding.k, coding.s, coding.e, coding.num_workers
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
          f"{device} ({cfg.name}): {requests // k} groups of K={k} x "
          f"{n1} coded streams, S={s} E={e}"
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
                    flush_deadline_ms, quarantine, churn, traffic, sample,
                    wshard) -> dict:
    """Per-uid generated tokens (``results``) and budgets, the scheduler's
    event ``trace`` and ``metrics`` (event clock), the number of pool
    rounds and of prefill / decode calls, each call's wall time (ms,
    ending in its host sync), and tokens/s over the calls' wall time."""
    requests = prompts.shape[0]
    budgets = rng.randint(1, steps + 1, size=requests)
    executor = ContinuousLLMExecutor(
        cfg, coding, params, pool_groups=pool_groups,
        max_len=prompts.shape[1] + steps + 2,
        byz_collude=(adversary_cfg is not None
                     and adversary_cfg.kind == "colluding"), sample=sample,
        sample_seed=seed, wshard=wshard)
    e = coding.e
    sched = ContinuousScheduler(
        ContinuousConfig(
            coding=coding, pool_groups=pool_groups,
            flush_deadline_ms=flush_deadline_ms, seed=seed,
            adversary=adversary_cfg,
            quarantine=quarantine, churn=churn,
            max_new_tokens=steps),
        LatencyModel(), executor)
    print(f"continuous batching of {requests} requests of "
          f"{prompts.shape[1]} tokens on {device} ({cfg.name}) at "
          f"{rate_rps:.0f} req/s ({traffic}): {pool_groups} group slots of K="
          f"{coding.k} x {coding.num_workers} coded streams "
          f"({pool_groups * coding.num_workers} pooled), S={coding.s} "
          f"E={e}, per-request budgets 1..{steps}"
          + (", worker-major" if wshard is not None else "")
          + (f", {adversary_cfg.kind} attacker at sigma "
             f"{adversary_cfg.sigma}" if adversary_cfg is not None else ""))
    # diurnal: a non-homogeneous Poisson trace whose mean rate is --rate
    arrival_ms = (trace_arrivals(requests, TrafficModel(
        base_rate_rps=rate_rps), seed=seed + 11)
        if traffic == "diurnal" else None)
    metrics = sched.run([p.astype(np.int32) for p in prompts],
                        arrival_ms=arrival_ms,
                        rate_rps=None if arrival_ms is not None else rate_rps,
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
    }
    print(metrics.format_table())
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
    ap.add_argument("--continuous", action="store_true",
                    help="continuous batching over a fixed coded-KV slot "
                         "pool")
    ap.add_argument("--pool-groups", type=int, default=4,
                    help="group-slot capacity of the continuous pool")
    ap.add_argument("--rate", type=float, default=2000.0,
                    help="Poisson arrival rate, requests/second "
                         "(--continuous)")
    ap.add_argument("--traffic", default="poisson", choices=TRAFFIC,
                    help="arrival process: homogeneous Poisson at --rate, "
                         "or a diurnal+bursty trace around --rate "
                         "(--continuous)")
    ap.add_argument("--deadline-ms", type=float, default=5.0,
                    help="batcher flush deadline (--continuous)")
    ap.add_argument("--quarantine", action="store_true",
                    help="stop dispatching to repeatedly-located workers "
                         "(--continuous)")
    ap.add_argument("--probation-ms", type=float, default=200.0,
                    help="quarantine duration before re-admission")
    ap.add_argument("--churn", action="store_true",
                    help="workers leave/rejoin on exponential clocks "
                         "(--continuous)")
    ap.add_argument("--churn-up-ms", type=float, default=2000.0,
                    help="mean worker uptime between leaves")
    ap.add_argument("--churn-down-ms", type=float, default=200.0,
                    help="mean downtime before rejoin")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device; default cuda (cpu runs the plain "
                         "PyTorch path)")
    # accepted so that they are refused with a reason, not as unknown
    ap.add_argument("--adaptive", action="store_true")
    ap.add_argument("--scheme", default="berrut")
    args = ap.parse_args(argv)
    if args.adaptive:
        ap.error("--adaptive (closed-loop redundancy control) is not "
                 "ported yet")
    if args.scheme != "berrut":
        ap.error(f"--scheme {args.scheme} is not ported yet (berrut only)")
    if (args.quarantine or args.churn or args.traffic != "poisson") and \
            not args.continuous:
        ap.error("--quarantine, --churn and --traffic diurnal need "
                 "--continuous")
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
               churn_down_ms=args.churn_down_ms, traffic=args.traffic)


if __name__ == "__main__":
    main()
