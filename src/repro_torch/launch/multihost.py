"""Multi-process worker-sharded serving launch (port of the serving half
of ``repro.launch.multihost``).

One process per rank of the "worker" group: rank r of W owns the
contiguous block r of the worker-major coded streams (DESIGN.md §13),
serves the slot pool's rounds on them and keeps their caches; the decode
tail gathers only survivor shards (``launch.worker_mesh``).  W is the
process group's world size.  Every process runs the same program on the
same prompts and gets the same token ids back.

  # W processes, one per rank (NCCL on the card, one card each):
  python -m repro_torch.launch.multihost --mode serve \\
      --coordinator HOST:PORT --num-processes W --process-id R
  # on the CPU, gloo over a file store:
  PYTHONPATH=src python -m repro_torch.launch.multihost --mode serve \\
      --device cpu --reduced --coordinator file:///tmp/store \\
      --num-processes 2 --process-id 0 --steps 2

``--mode train`` and ``--multi-pod`` (the reference's training loop, and
its "pod" and "model" axes) are not ported yet and are refused.
"""

from __future__ import annotations

import argparse
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import configs, resolve_device


def initialize(coordinator: str, num_processes: int, process_id: int,
               device: torch.device) -> None:
    """Join the process group: NCCL for a CUDA device, gloo for the CPU.
    ``coordinator`` is ``host:port`` (a TCP store that rank 0 serves) or
    a ``file://`` store path."""
    if coordinator.startswith("file://"):
        init_method = coordinator
    else:
        init_method = f"tcp://{coordinator}"
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(
        backend="nccl" if device.type == "cuda" else "gloo",
        init_method=init_method, world_size=num_processes, rank=process_id)


def host_worker_ranks(group) -> list:
    """The worker-group ranks whose coded streams live in this process:
    its own rank (one rank per process), or the one-rank path's rank 0
    off any group."""
    return [0] if group is None else [group.rank]


def serve_main(args) -> dict:
    """Worker-sharded coded serving pool (``--mode serve``): prefill every
    slot, then ``--steps`` decode rounds, all workers answering.  Returns
    the (steps + 1, P*K) token ids and each call's wall time (ms, ending
    in the call's host sync)."""
    from repro_torch.core.berrut import CodingConfig
    from repro_torch.launch.mesh import make_worker_mesh
    from repro_torch.launch.serve import refuse_frontends
    from repro_torch.launch.worker_mesh import WorkerShardConfig
    from repro_torch.models import partitioning
    from repro_torch.models.model import init_params
    from repro_torch.serving.continuous import ContinuousLLMExecutor

    device = resolve_device(args.device)
    coding = CodingConfig(k=args.k, s=args.s, e=args.e)
    group = make_worker_mesh(dist.get_world_size())
    if coding.num_workers % group.size:
        raise ValueError(
            f"N+1={coding.num_workers} coded streams do not shard over "
            f"the {group.size}-way worker group (choose K, S, E so the "
            f"stream count is a multiple of {group.size})")
    cfg = (configs.get_reduced(args.arch) if args.reduced
           else configs.get_config(args.arch))
    refuse_frontends(cfg)
    cfg = cfg.with_updates(param_dtype="bfloat16",
                           activation_dtype="bfloat16")
    ranks = host_worker_ranks(group)
    print(f"process {group.rank}: worker ranks {ranks} (streams/rank "
          f"{coding.num_workers // group.size} of {coding.num_workers}) on "
          f"{device}", flush=True)
    with partitioning.worker_group_context(group):
        params = init_params(cfg, torch.Generator(device).manual_seed(0),
                             device)
        ex = ContinuousLLMExecutor(
            cfg, coding, params, pool_groups=args.pool_groups,
            max_len=args.max_len,
            wshard=WorkerShardConfig(gather_width=coding.num_workers))
        state = ex.init_state()
        g = args.pool_groups
        rng = np.random.RandomState(0)
        prompts = rng.randint(0, cfg.vocab_size,
                              (g * coding.k, args.max_len // 2))
        admit = np.ones((g,), np.float32)
        full = np.ones((coding.num_workers,), np.float32)
        tokens, state, _ = ex.prefill(state, prompts, admit, full)
        out = [tokens]
        for i in range(args.steps):
            tokens, state, _ = ex.decode(
                state, tokens.reshape(-1, 1), admit, full)
            out.append(tokens)
            if group.rank == 0 and i % 10 == 0:
                print(f"decode step {i}: tokens {tokens[:4]}...", flush=True)
    if group.rank == 0:
        print(f"prefill {ex.call_ms['prefill'][0]:.2f} ms; {args.steps} "
              f"decode calls, mean "
              f"{np.mean(ex.call_ms['decode']) if args.steps else 0:.2f} "
              f"ms (wall clock)", flush=True)
    return {"tokens": np.stack(out), "call_ms": ex.call_ms,
            "collective_bytes": group.collective_bytes()}


def main(argv: Optional[list] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--coordinator", required=True,
                    help="host:port, or file:///path of a file store")
    ap.add_argument("--num-processes", type=int, required=True)
    ap.add_argument("--process-id", type=int, required=True)
    ap.add_argument("--arch", default="qwen3-0.6b",
                    choices=configs.list_archs())
    ap.add_argument("--mode", choices=("train", "serve"), default="train")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    # serve-mode coding and pool knobs (the reference's defaults; K=7
    # S=2 E=0 is 9 coded streams)
    ap.add_argument("--k", type=int, default=7)
    ap.add_argument("--s", type=int, default=2)
    ap.add_argument("--e", type=int, default=0)
    ap.add_argument("--pool-groups", type=int, default=8)
    ap.add_argument("--max-len", type=int, default=256)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device; default cuda (cpu runs gloo and "
                         "the plain PyTorch path)")
    args = ap.parse_args(argv)
    if args.mode == "train":
        ap.error("--mode train is not ported yet: it trains on the "
                 "production mesh (ROADMAP A9's model and pod axes); one "
                 "device trains through repro_torch.launch.train")
    if args.multi_pod:
        ap.error("--multi-pod is not ported yet (the A9 model and pod "
                 "axes)")
    device = resolve_device(args.device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", args.process_id
                              % torch.cuda.device_count())
    args.device = str(device)
    initialize(args.coordinator, args.num_processes, args.process_id, device)
    try:
        return serve_main(args)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
