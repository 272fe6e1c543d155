"""Coded serving launcher, batch path (port of the Berrut batch path of
``repro.launch.serve``).

All requests are served as one batch of G = requests / K query groups,
each Berrut-encoded into N+1 coded streams: round 0 prefills the
prompts, then every decode step is one more coded round.  Each round's
straggler mask takes S workers out at random; with E > 0 a persistent
attacker (E compromised workers, fixed for the run) corrupts its coded
logits every round with noise of scale ``--byz-sigma``, and the
vote-gated locator has to find it.  Masks and the attacker come from a
numpy generator seeded by ``--seed``; weights are random, drawn from a
torch generator with the same seed.

  PYTHONPATH=src python -m repro_torch.launch.serve --reduced --device cpu \
      --requests 8 --k 4 --steps 4
  PYTHONPATH=src python -m repro_torch.launch.serve --requests 16 --k 4 \
      --s 1 --e 1 --prompt-len 256 --steps 16 --byz-sigma 10

The event-driven scheduler, ``--continuous``, ``--adaptive`` and the
other redundancy schemes are not ported yet and are refused.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import configs, resolve_device
from repro_torch.core.berrut import CodingConfig
from repro_torch.models.model import init_params
from repro_torch.serving.executor import CodedLLMExecutor, RoundAttack


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(arch: str = "qwen3-0.6b", reduced: bool = False, requests: int = 16,
        k: int = 4, s: int = 1, e: int = 0, prompt_len: int = 16,
        steps: int = 8, byz_sigma: float = 50.0, seed: int = 0,
        device=None) -> dict:
    """Serve ``requests`` random prompts as one coded batch.  Returns the
    (requests, steps + 1) token matrix, per-round wall times (ms, each
    ending in a device sync), tokens/s, the stragglers and located
    workers of each round, and the locator's precision and recall
    against the attacker (None with E = 0)."""
    device = resolve_device(device)
    cfg = configs.get_reduced(arch) if reduced else configs.get_config(arch)
    coding = CodingConfig(k=k, s=s, e=e)
    n1 = coding.num_workers
    if requests % k:
        raise ValueError(f"the batch path serves whole groups: requests "
                         f"({requests}) must be a multiple of K ({k})")
    if s > n1:
        raise ValueError(f"cannot straggle {s} of {n1} workers")
    rng = np.random.RandomState(seed)
    params = init_params(cfg, torch.Generator(device).manual_seed(seed),
                         device)
    executor = CodedLLMExecutor(cfg, coding, params, steps=steps,
                                max_len=prompt_len + steps + 2, seed=seed)
    prompts = rng.randint(0, cfg.vocab_size, (requests, prompt_len))
    byz = np.zeros((n1,), np.float32)
    if e:
        byz[rng.choice(n1, e, replace=False)] = 1.0
    print(f"serving {requests} requests of {prompt_len} tokens on "
          f"{device} ({cfg.name}): {requests // k} groups of K={k} x "
          f"{n1} coded streams, S={s} E={e}"
          + (f", persistent attacker on workers "
             f"{np.flatnonzero(byz).tolist()} at sigma {byz_sigma}"
             if e else ""))

    handle = executor.dispatch(prompts)
    round_ms, stragglers, located = [], [], []
    tp = fp = fn = 0
    for r in range(executor.rounds):
        mask = np.ones((n1,), np.float32)
        out = rng.choice(n1, s, replace=False)
        mask[out] = 0.0
        attack_r = RoundAttack(mask=byz, sigma=byz_sigma) if e else None
        _sync(device)
        t0 = time.perf_counter()
        if r < executor.rounds - 1:
            handle, report = executor.step(handle, r, mask, attack_r)
        else:
            tokens, report = executor.decode(handle, mask, attack_r)
        _sync(device)
        round_ms.append((time.perf_counter() - t0) * 1e3)
        stragglers.append(sorted(out.tolist()))
        detected = (report.detected if report is not None
                    else np.zeros((n1,), bool))
        located.append(np.flatnonzero(detected).tolist())
        corrupt = (byz > 0) & (mask > 0)
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
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--byz-sigma", type=float, default=50.0)
    ap.add_argument("--attack", default="persistent",
                    help="adversary model (active when --e > 0); only "
                         "persistent is ported")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device; default cuda (cpu runs the plain "
                         "PyTorch path)")
    # accepted so that they are refused with a reason, not as unknown
    ap.add_argument("--continuous", action="store_true")
    ap.add_argument("--adaptive", action="store_true")
    ap.add_argument("--scheme", default="berrut")
    args = ap.parse_args(argv)
    if args.continuous:
        ap.error("--continuous (slot-pool continuous batching) is not "
                 "ported yet")
    if args.adaptive:
        ap.error("--adaptive (closed-loop redundancy control) is not "
                 "ported yet")
    if args.scheme != "berrut":
        ap.error(f"--scheme {args.scheme} is not ported yet (berrut only)")
    if args.attack != "persistent":
        ap.error(f"--attack {args.attack} is not ported yet "
                 "(persistent only)")
    return run(args.arch, args.reduced, args.requests, args.k, args.s,
               args.e, args.prompt_len, args.steps, args.byz_sigma,
               seed=args.seed, device=args.device)


if __name__ == "__main__":
    main()
