#!/usr/bin/env python3
"""Which ``torch.distributed`` collectives the gloo backend takes on CUDA
tensors, with every rank's process on the same card.

    python3 scripts/gloo_cuda_probe.py [--world 2]

NCCL refuses two ranks on one device, so a one-card machine can run a
multi-rank mesh only over gloo.  This starts ``--world`` processes on
``cuda:0`` over a file store, calls each collective the mesh uses
(all-reduce, all-gather into a tensor and into a list, reduce-scatter
into a tensor, broadcast) on fp32, bf16 and int32 CUDA tensors, checks
each result against the arithmetic and prints one JSON line per (op,
dtype): ``ok``, or the error it raised, and the ms of one call of 4 MB
(host clock, ending in a sync).  Ends with the card's name and power
limit.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

OPS = ("all_reduce", "all_gather_into_tensor", "all_gather",
       "reduce_scatter_tensor", "broadcast")
DTYPES = ("float32", "bfloat16", "int32")
NUMEL = 1 << 20


def _call(dist, torch, op: str, x, rank: int, world: int):
    """One collective on ``x`` (this rank's (NUMEL,) tensor, filled with
    rank + 1); returns the result the arithmetic fixes and the result."""
    if op == "all_reduce":
        out = x.clone()
        dist.all_reduce(out)
        want = torch.full_like(x, world * (world + 1) // 2)
    elif op == "all_gather_into_tensor":
        out = torch.empty((world * x.numel(),), dtype=x.dtype,
                          device=x.device)
        dist.all_gather_into_tensor(out, x)
        want = torch.cat([torch.full_like(x, r + 1) for r in range(world)])
    elif op == "all_gather":
        outs = [torch.empty_like(x) for _ in range(world)]
        dist.all_gather(outs, x)
        out = torch.cat(outs)
        want = torch.cat([torch.full_like(x, r + 1) for r in range(world)])
    elif op == "reduce_scatter_tensor":
        out = torch.empty((x.numel() // world,), dtype=x.dtype,
                          device=x.device)
        dist.reduce_scatter_tensor(out, x)
        want = torch.full_like(out, world * (world + 1) // 2)
    else:
        out = x.clone()
        dist.broadcast(out, src=0)
        want = torch.full_like(x, 1)
    return want, out


def rank_main(rank: int, world: int, store: str) -> None:
    import torch
    import torch.distributed as dist
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method="file://" + store,
                            world_size=world, rank=rank)
    try:
        for dtype in DTYPES:
            for op in OPS:
                x = torch.full((NUMEL,), rank + 1,
                               dtype=getattr(torch, dtype), device="cuda")
                res = {"op": op, "dtype": dtype, "world": world}
                try:
                    want, out = _call(dist, torch, op, x, rank, world)
                    torch.cuda.synchronize()
                    res["device"] = str(out.device)
                    res["ok"] = bool(torch.equal(want, out))
                    t0 = time.perf_counter()
                    _call(dist, torch, op, x, rank, world)
                    torch.cuda.synchronize()
                    res["ms"] = (time.perf_counter() - t0) * 1e3
                except (RuntimeError, ValueError, TypeError) as err:
                    res["ok"] = False
                    res["error"] = str(err).splitlines()[0][:200]
                dist.barrier()
                if rank == 0:
                    print(json.dumps(res), flush=True)
    finally:
        dist.destroy_process_group()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--world", type=int, default=2)
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--store", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.rank is not None:
        rank_main(args.rank, args.world, args.store)
        return 0
    import torch
    if not torch.cuda.is_available():
        print("gloo_cuda_probe.py: no CUDA device", file=sys.stderr)
        return 1
    print(f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        store = os.path.join(tmp, "store")
        procs = [subprocess.Popen(
            [sys.executable, __file__, "--world", str(args.world),
             "--rank", str(r), "--store", store])
            for r in range(args.world)]
        try:
            codes = [p.wait(timeout=300) for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip(), flush=True)
    return 0 if all(c == 0 for c in codes) else 1


if __name__ == "__main__":
    sys.exit(main())
