"""Multi-process training and coded serving over ``torch.distributed``
ranks (port of ``repro.launch.multihost``), one process a mesh rank.

``--mode train`` (the default, as in the reference) trains on the
training mesh ("data", "model"), or ("pod", "data", "model") with
``--multi-pod`` (a pod axis of 2): bf16 with remat, the reference's
``TrainConfig()``, FSDP over the batch axes and ``--model-par`` ranks of
tensor parallelism (``launch.train``'s step, ``training.train``).  The
data axis takes the rest of the processes.  Two departures from the
reference:
- Seeding.  Each rank draws its rows of the batch from a
  ``RandomState`` seeded by its batch-axes coordinate
  (``Mesh.fsdp_index``), not by its process id: ranks that share a data
  coordinate but differ on the model axis must see the same tokens,
  which the reference's one process a host gives for free.
- Batch and length.  ``--batch`` (global, default 256) and ``--seq``
  (default 4096) are the reference's constants, made flags: a card
  cannot hold 256 x 4096 tokens at full width (the logits alone would
  be hundreds of GB).

``--mode serve`` runs the coded serving pool on a (worker, model) mesh,
or with ``--multi-pod`` on ("pod", "worker", "model") with a pod axis of
2: the ranks along "worker" each own a contiguous block of the
worker-major coded streams (DESIGN.md §13), serve the slot pool's
rounds on them and keep their caches, and on a pod axis each of a
worker's two pod ranks keeps half of its block (the reference's "batch"
order, ``partitioning.batch_block``); the ranks along "model"
(``--model-par``) split each stream's heads, MLP and vocabulary (tensor
parallelism; Mamba2's SSM heads too, ``models.mamba2``), so one coded
worker spans several devices.  The decode
tail gathers only survivor shards (``launch.worker_mesh``).  The worker
axis is the world size over the pods and ``--model-par``.  Every
process runs the same program on the same prompts and gets the same
token ids back.  The reference fixes the mesh at 16 workers x 16-way
tensor parallel (``make_production_serving_mesh``); here it follows the
process count.

  # one process a rank (NCCL on the card, one card each):
  python -m repro_torch.launch.multihost --mode serve --model-par M \\
      --coordinator HOST:PORT --num-processes W*M --process-id R
  # on the CPU, gloo over a file store:
  PYTHONPATH=src python -m repro_torch.launch.multihost --mode train \\
      --device cpu --reduced --coordinator file:///tmp/store \\
      --num-processes 2 --process-id 0 --model-par 2 --steps 2 \\
      --batch 8 --seq 32

``--backend gloo`` runs the ranks over gloo on the card too, so that
several of them can share one card (NCCL refuses two ranks on a
device).
"""

from __future__ import annotations

import argparse
import time
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import configs, resolve_device
from repro_torch.models import partitioning


def initialize(coordinator: str, num_processes: int, process_id: int,
               device: torch.device, backend: Optional[str] = None) -> None:
    """Join the process group: ``backend``, by default NCCL for a CUDA
    device and gloo for the CPU.  ``coordinator`` is ``host:port`` (a
    TCP store that rank 0 serves) or a ``file://`` store path."""
    if coordinator.startswith("file://"):
        init_method = coordinator
    else:
        init_method = f"tcp://{coordinator}"
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(
        backend=backend or ("nccl" if device.type == "cuda" else "gloo"),
        init_method=init_method, world_size=num_processes, rank=process_id)


def _gather_rows(mesh, x, axes) -> torch.Tensor:
    """``x``'s leading axis all-gathered over ``axes`` (inner first, so
    the rows come in the mesh's row-major order)."""
    x = torch.as_tensor(x)
    for axis in reversed(axes):
        group = mesh.group(axis)
        if group is not None:
            x = group.all_gather(x, 0)
    return x


def global_batch_from_host_shard(mesh, host_batch: dict) -> dict:
    """The global batch from every process's rows: each array's leading
    axis all-gathered over the mesh's batch axes ("pod", "data"), in
    rank order.  With one process a batch comes back unchanged."""
    return {k: _gather_rows(mesh, v, ("pod", "data"))
            for k, v in host_batch.items()}


def host_worker_ranks(mesh) -> list:
    """The "worker"-axis ranks whose coded streams live in this process:
    its own coordinate (one rank per process), or 0 on a mesh without a
    worker axis (the whole pool)."""
    return [mesh.coord("worker")]


def global_pool_from_host_shard(mesh, host_pool: dict) -> dict:
    """The global pool arrays from every process's rows: each process
    holds its block of the rows (the flat coded-stream axis first), and
    the leading axis is all-gathered over the batch axes ("worker",
    "pod", "data") in the reference's block order, worker outermost
    (``partitioning.batch_block``).  Without them an array comes back
    unchanged."""
    return {k: _gather_rows(mesh, v, partitioning.DEFAULT_RULES["batch"])
            for k, v in host_pool.items()}


def serve_main(args) -> dict:
    """Coded serving pool on a ("pod",) "worker", "model" mesh (``--mode
    serve``): prefill every slot, then ``--steps`` decode rounds, all
    workers answering.  Returns the (steps + 1, P*K) token ids, each
    call's wall time (ms, ending in the call's host sync), and the
    collective bytes by op of the whole run and of each call by group
    ("model", "worker", "fsdp": the batch group, ...) and op."""
    from repro_torch.core.berrut import CodingConfig
    from repro_torch.launch import shardings
    from repro_torch.launch.mesh import make_worker_mesh
    from repro_torch.launch.serve import refuse_frontends
    from repro_torch.launch.worker_mesh import WorkerShardConfig
    from repro_torch.models.model import init_params
    from repro_torch.serving.coded_serving import pool_streams
    from repro_torch.serving.continuous import ContinuousLLMExecutor

    device = resolve_device(args.device)
    coding = CodingConfig(k=args.k, s=args.s, e=args.e)
    world = dist.get_world_size()
    pods = 2 if args.multi_pod else 1
    if world % (pods * args.model_par):
        raise ValueError(f"{world} processes do not split into {pods} pods "
                         f"x a {args.model_par}-way model axis")
    mesh = make_worker_mesh(world // (pods * args.model_par), args.model_par,
                            multi_pod=args.multi_pod)
    wsize = mesh.size("worker")
    if coding.num_workers % wsize:
        raise ValueError(
            f"N+1={coding.num_workers} coded streams do not shard over "
            f"the {wsize}-way worker axis (choose K, S, E so the "
            f"stream count is a multiple of {wsize})")
    cfg = (configs.get_reduced(args.arch) if args.reduced
           else configs.get_config(args.arch))
    refuse_frontends(cfg)
    cfg = cfg.with_updates(param_dtype=args.dtype,
                           activation_dtype=args.dtype)
    wshard = WorkerShardConfig(gather_width=coding.num_workers)
    with partitioning.mesh_context(mesh):
        # the pool's streams split over the pods unpadded, or raise
        held = pool_streams(coding, args.pool_groups, wshard)
    ranks = host_worker_ranks(mesh)
    print(f"process {mesh.rank}: worker ranks {ranks} (streams/rank "
          f"{coding.num_workers // wsize} of {coding.num_workers}), model "
          f"rank {mesh.coord('model')} of {mesh.size('model')} on {device}; "
          f"pod rank {mesh.coord('pod')} of {pods}, pool streams {held} of "
          f"{args.pool_groups * coding.num_workers}", flush=True)
    call_bytes = {"prefill": [], "decode": []}

    def count(kind):
        call_bytes[kind].append({name: group.collective_bytes()
                                 for name, group in mesh.groups.items()})
        mesh.reset_bytes()

    with partitioning.mesh_context(mesh):
        params = init_params(cfg, torch.Generator(device).manual_seed(0),
                             device)
        params = shardings.local_shard(
            params, shardings.serving_param_specs(mesh, cfg, params), mesh)
        ex = ContinuousLLMExecutor(
            cfg, coding, params, pool_groups=args.pool_groups,
            max_len=args.max_len, wshard=wshard)
        state = ex.init_state()
        g = args.pool_groups
        rng = np.random.RandomState(0)
        prompts = rng.randint(0, cfg.vocab_size,
                              (g * coding.k, args.max_len // 2))
        admit = np.ones((g,), np.float32)
        full = np.ones((coding.num_workers,), np.float32)
        mesh.reset_bytes()
        tokens, state, _ = ex.prefill(state, prompts, admit, full)
        count("prefill")
        out = [tokens]
        for i in range(args.steps):
            tokens, state, _ = ex.decode(
                state, tokens.reshape(-1, 1), admit, full)
            count("decode")
            out.append(tokens)
            if mesh.rank == 0 and i % 10 == 0:
                print(f"decode step {i}: tokens {tokens[:4]}...", flush=True)
    if mesh.rank == 0:
        print(f"prefill {ex.call_ms['prefill'][0]:.2f} ms; {args.steps} "
              f"decode calls, mean "
              f"{np.mean(ex.call_ms['decode']) if args.steps else 0:.2f} "
              f"ms (wall clock)", flush=True)
    total = {}
    for per_call in call_bytes["prefill"] + call_bytes["decode"]:
        for ops in per_call.values():
            for op, b in ops.items():
                total[op] = total.get(op, 0.0) + b
    return {"tokens": np.stack(out), "call_ms": ex.call_ms,
            "collective_bytes": total, "call_bytes": call_bytes}


def train_main(args) -> dict:
    """Training on the ("pod",) "data", "model" mesh (``--mode train``):
    ``--steps`` steps of the reference's ``TrainConfig()`` on a global
    batch of ``--batch`` x ``--seq`` synthetic tokens, each rank drawing
    its rows (the module docstring).  Returns each step's loss, wall ms
    (ending in a host sync) and collective bytes by group."""
    from repro_torch.data import SyntheticLMDataset
    from repro_torch.launch.mesh import make_train_mesh
    from repro_torch.launch.train import sharded_state
    from repro_torch.models.model import init_params
    from repro_torch.models.transformer import check_model_axis
    from repro_torch.training import TrainConfig, train_step

    device = resolve_device(args.device)
    cfg = (configs.get_reduced(args.arch) if args.reduced
           else configs.get_config(args.arch))
    cfg = cfg.with_updates(param_dtype=args.dtype,
                           activation_dtype=args.dtype, remat=True)
    world = dist.get_world_size()
    pods = 2 if args.multi_pod else 1
    if world % (pods * args.model_par):
        raise ValueError(f"{world} processes do not split into {pods} pods "
                         f"x a {args.model_par}-way model axis")
    data = world // (pods * args.model_par)
    check_model_axis(cfg, args.model_par)
    mesh = make_train_mesh(data, args.model_par, multi_pod=args.multi_pod)
    rows = mesh.fsdp_size()
    if args.batch % rows:
        raise ValueError(f"a batch of {args.batch} does not split over "
                         f"{rows} ranks of the batch axes")
    print(f"process {mesh.rank}: data rank {mesh.fsdp_index()} of {rows}, "
          f"model rank {mesh.coord('model')} of {mesh.size('model')} on "
          f"{device}", flush=True)
    tcfg = TrainConfig()
    out = {"losses": [], "step_ms": [], "step_bytes": []}
    with partitioning.mesh_context(mesh):
        params = init_params(cfg, torch.Generator(device).manual_seed(0),
                             device)
        params, opt, specs = sharded_state(cfg, params, mesh)
        ds = SyntheticLMDataset(cfg.vocab_size, seq_len=args.seq, seed=0)
        rng = np.random.RandomState(mesh.fsdp_index())
        for i in range(args.steps):
            local = ds.batch(args.batch // rows, rng)
            batch = {k: torch.from_numpy(v).to(device)
                     for k, v in local.items()}
            mesh.reset_bytes()
            t0 = time.perf_counter()
            params, opt, metrics = train_step(cfg, tcfg, params, opt, batch,
                                              specs)
            loss = float(metrics["loss"])              # syncs the device
            out["step_ms"].append(1e3 * (time.perf_counter() - t0))
            out["step_bytes"].append(mesh.axis_bytes())
            out["losses"].append(loss)
            if mesh.rank == 0 and i % 10 == 0:
                print(f"step {i}: loss {loss:.4f}", flush=True)
    return out


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
    # train-mode batch: the reference's constants, as flags
    ap.add_argument("--batch", type=int, default=256,
                    help="global batch of train mode (rows over every rank "
                         "of the batch axes)")
    ap.add_argument("--seq", type=int, default=4096,
                    help="tokens a row in train mode")
    # serve-mode coding and pool knobs (the reference's defaults; K=7
    # S=2 E=0 is 9 coded streams)
    ap.add_argument("--k", type=int, default=7)
    ap.add_argument("--s", type=int, default=2)
    ap.add_argument("--e", type=int, default=0)
    ap.add_argument("--pool-groups", type=int, default=8)
    ap.add_argument("--max-len", type=int, default=256)
    ap.add_argument("--model-par", type=int, default=1,
                    help="ranks of the model axis (tensor parallelism); "
                         "the worker axis (serve) or the data axis (train) "
                         "takes the rest of the processes")
    ap.add_argument("--dtype", default="bfloat16",
                    choices=("bfloat16", "float32"),
                    help="parameter and activation dtype")
    ap.add_argument("--backend", default=None, choices=("nccl", "gloo"),
                    help="default nccl on the card, gloo on the cpu; gloo "
                         "lets several ranks share one card")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device; default cuda (cpu runs gloo and "
                         "the plain PyTorch path)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", args.process_id
                              % torch.cuda.device_count())
    args.device = str(device)
    initialize(args.coordinator, args.num_processes, args.process_id, device,
               args.backend)
    try:
        return (train_main if args.mode == "train" else serve_main)(args)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
