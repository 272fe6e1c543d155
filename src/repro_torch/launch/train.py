"""Training driver: mesh setup, sharded parameter and optimizer init,
train loop, checkpoints (port of ``repro.launch.train``).

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \\
      --steps 100 --batch 8 --seq 128           # on the card
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
      --reduced --steps 20                      # the plain path
  # a (data 2, model 2) mesh: one process a rank, gloo over a file store
  for r in 0 1 2 3; do PYTHONPATH=src python -m repro_torch.launch.train \\
      --reduced --device cpu --data-par 2 --model-par 2 \\
      --coordinator file:///tmp/store --process-id $r & done; wait

The reference builds its (data, model) mesh over one process's devices;
the port runs one process a rank, so ``--data-par`` x ``--model-par``
above 1 needs as many processes in one process group (``run`` takes an
initialised one; the CLI joins one with ``--coordinator`` and
``--process-id``, ``--backend gloo`` letting ranks share a card).  The
parameters and moments are sharded as the reference shards them (the
model axis splits heads, MLP and vocabulary, and Mamba2's SSM heads in
a head-aligned layout beneath the reference's specs; the data axis each
weight's "fsdp" dimension), each rank stages its rows of the batch, and
the checkpoint is the one-rank file.  With ``--microbatches`` n > 1 a
step first all-gathers the batch over the batch axes, and each rank
keeps its block of each of the reference's n microbatches (rows i of
the whole batch, ``training.train``), so a mesh step is the reference's
microbatched step, masks and MoE dispatch groups included.  On the card
attention trains through B3's forward and backward kernels and Mamba2's
SSD scan through B7's (every family, mamba2-780m and zamba2-1.2b
included); on the CPU autograd differentiates the plain versions.
"""

from __future__ import annotations

import argparse
import contextlib
import time
from typing import Optional

import torch
import torch.distributed as dist

from repro_torch import configs, resolve_device
from repro_torch.checkpoint import save, step_path
from repro_torch.data import ShardedLoader, SyntheticLMDataset
from repro_torch.launch import shardings
from repro_torch.launch.mesh import make_train_mesh
from repro_torch.models import partitioning
from repro_torch.models.model import init_params
from repro_torch.models.transformer import check_batch_axes, check_model_axis
from repro_torch.optim import OptimizerConfig, init_opt_state
from repro_torch.training import TrainConfig, train_step


def sharded_state(cfg, params, mesh):
    """(params, opt_state, specs) of this rank on ``mesh`` from the whole
    parameters: the blocks under ``shardings.train_param_specs`` and
    fresh moments of those blocks (``train_opt_specs`` gives them the
    same specs)."""
    specs = shardings.train_param_specs(mesh, cfg, params)
    params = shardings.local_shard(params, specs, mesh)
    return params, init_opt_state(params), specs


def run(arch: str, reduced: bool, steps: int, batch: int, seq: int,
        data_par: int, model_par: int, lr: float, microbatches: int,
        ckpt_dir: Optional[str], log_every: int = 10, *, device=None,
        seed: int = 0, remat: bool = False,
        history: Optional[list] = None):
    """Train ``steps`` steps; returns (params, last loss): this rank's
    blocks on a mesh.

    Above one rank (``data_par`` x ``model_par``) the default process
    group must be initialised with that world size, one process a rank;
    the configuration is checked against the mesh first.  ``remat``
    checkpoints every block (``cfg.remat``).  When ``history`` is a
    list, each step appends {"step", "loss", "lr", "grad_norm",
    "seconds"}: its metrics and wall time, which end in a device sync."""
    cfg = configs.get_reduced(arch) if reduced else configs.get_config(arch)
    if remat:
        cfg = cfg.with_updates(remat=True)
    check_model_axis(cfg, model_par)
    check_batch_axes(cfg, data_par)
    mesh = None
    if data_par * model_par > 1:
        world = dist.get_world_size() if dist.is_initialized() else None
        if world != data_par * model_par:
            raise RuntimeError(
                f"--data-par {data_par} --model-par {model_par} trains on "
                f"{data_par * model_par} processes, one a rank; the process "
                f"group has {world or 'not been initialised'}")
        mesh = make_train_mesh(data_par, model_par)
    device = resolve_device(device)
    tcfg = TrainConfig(
        optimizer=OptimizerConfig(learning_rate=lr, warmup_steps=20,
                                  total_steps=steps),
        microbatches=microbatches)
    ds = SyntheticLMDataset(cfg.vocab_size, seq_len=seq, seed=0)
    loader = ShardedLoader(ds.stream(batch), device=device, mesh=mesh)

    params = init_params(cfg, torch.Generator(device).manual_seed(seed),
                         device)
    specs = None
    if mesh is not None:
        params, opt, specs = sharded_state(cfg, params, mesh)
    else:
        opt = init_opt_state(params)

    talk = mesh is None or mesh.rank == 0
    t0 = time.time()
    with (partitioning.mesh_context(mesh) if mesh is not None
          else contextlib.nullcontext()):
        for i in range(steps):
            t_step = time.perf_counter()
            batch_dev = next(loader)
            params, opt, metrics = train_step(cfg, tcfg, params, opt,
                                              batch_dev, specs)
            if history is not None:
                loss = float(metrics["loss"])         # syncs the device
                history.append({"step": i, "loss": loss,
                                "lr": float(metrics["lr"]),
                                "grad_norm": float(metrics["grad_norm"]),
                                "seconds": time.perf_counter() - t_step})
            if talk and (i % log_every == 0 or i == steps - 1):
                loss = float(metrics["loss"])
                print(f"step {i:5d}  loss {loss:7.4f}  "
                      f"lr {float(metrics['lr']):.2e}  "
                      f"grad_norm {float(metrics['grad_norm']):.3f}  "
                      f"({(time.time() - t0) / (i + 1):.2f}s/step)")
        if ckpt_dir:
            save(step_path(ckpt_dir, steps), params,
                 metadata={"arch": cfg.name, "steps": steps},
                 shardings=specs)
            if talk:
                print(f"saved checkpoint to {ckpt_dir}")
    return params, float(metrics["loss"])


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-0.6b",
                    choices=configs.list_archs())
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--data-par", type=int, default=1)
    ap.add_argument("--model-par", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default=None,
                    help="torch device; default cuda (cpu runs the plain "
                         "PyTorch path)")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the parameters' torch generator")
    ap.add_argument("--coordinator", default=None,
                    help="above one rank: host:port, or file:///path of a "
                         "file store")
    ap.add_argument("--process-id", type=int, default=None,
                    help="above one rank: this process's rank")
    ap.add_argument("--backend", default=None, choices=("nccl", "gloo"),
                    help="default nccl on the card, gloo on the cpu; gloo "
                         "lets several ranks share one card")
    args = ap.parse_args(argv)
    world = args.data_par * args.model_par
    if world > 1:
        from repro_torch.launch.multihost import initialize
        if args.coordinator is None or args.process_id is None:
            ap.error(f"--data-par {args.data_par} --model-par "
                     f"{args.model_par}: {world} processes, one a rank; "
                     f"give each --coordinator and --process-id")
        device = resolve_device(args.device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", args.process_id
                                  % torch.cuda.device_count())
        args.device = str(device)
        initialize(args.coordinator, world, args.process_id, device,
                   args.backend)
    try:
        run(args.arch, args.reduced, args.steps, args.batch, args.seq,
            args.data_par, args.model_par, args.lr, args.microbatches,
            args.ckpt_dir, device=args.device, seed=args.seed)
    finally:
        if world > 1:
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
