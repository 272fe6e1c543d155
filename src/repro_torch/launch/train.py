"""Training driver: parameter and optimizer init, train loop, checkpoints
(port of ``repro.launch.train``).

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \\
      --steps 100 --batch 8 --seq 128           # on the card
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
      --reduced --steps 20                      # the plain path

One device: ``--data-par`` / ``--model-par`` above 1 need the device mesh
of ROADMAP A9.  On the card attention trains through B3's forward and
backward kernels and Mamba2's SSD scan through B7's (every family,
mamba2-780m and zamba2-1.2b included); on the CPU autograd
differentiates the plain versions.
"""

from __future__ import annotations

import argparse
import time
from typing import Optional

import torch

from repro_torch import configs, resolve_device
from repro_torch.checkpoint import save, step_path
from repro_torch.data import ShardedLoader, SyntheticLMDataset
from repro_torch.models.model import init_params
from repro_torch.optim import OptimizerConfig, init_opt_state
from repro_torch.training import TrainConfig, train_step


def run(arch: str, reduced: bool, steps: int, batch: int, seq: int,
        data_par: int, model_par: int, lr: float, microbatches: int,
        ckpt_dir: Optional[str], log_every: int = 10, *, device=None,
        seed: int = 0, remat: bool = False,
        history: Optional[list] = None):
    """Train ``steps`` steps on one device; returns (params, last loss).

    ``remat`` checkpoints every block (``cfg.remat``).  When ``history`` is
    a list, each step appends {"step", "loss", "lr", "grad_norm",
    "seconds"}: its metrics and wall time, which end in a device sync."""
    if data_par > 1 or model_par > 1:
        raise NotImplementedError(
            f"--data-par {data_par} --model-par {model_par}: training over "
            f"a device mesh is not ported yet (ROADMAP A9)")
    device = resolve_device(device)
    cfg = configs.get_reduced(arch) if reduced else configs.get_config(arch)
    if remat:
        cfg = cfg.with_updates(remat=True)
    tcfg = TrainConfig(
        optimizer=OptimizerConfig(learning_rate=lr, warmup_steps=20,
                                  total_steps=steps),
        microbatches=microbatches)
    ds = SyntheticLMDataset(cfg.vocab_size, seq_len=seq, seed=0)
    loader = ShardedLoader(ds.stream(batch), device=device)

    params = init_params(cfg, torch.Generator(device).manual_seed(seed),
                         device)
    opt = init_opt_state(params)

    t0 = time.time()
    for i in range(steps):
        t_step = time.perf_counter()
        batch_dev = next(loader)
        params, opt, metrics = train_step(cfg, tcfg, params, opt, batch_dev)
        if history is not None:
            loss = float(metrics["loss"])             # syncs the device
            history.append({"step": i, "loss": loss,
                            "lr": float(metrics["lr"]),
                            "grad_norm": float(metrics["grad_norm"]),
                            "seconds": time.perf_counter() - t_step})
        if i % log_every == 0 or i == steps - 1:
            loss = float(metrics["loss"])
            print(f"step {i:5d}  loss {loss:7.4f}  "
                  f"lr {float(metrics['lr']):.2e}  "
                  f"grad_norm {float(metrics['grad_norm']):.3f}  "
                  f"({(time.time() - t0) / (i + 1):.2f}s/step)")
    if ckpt_dir:
        save(step_path(ckpt_dir, steps), params,
             metadata={"arch": cfg.name, "steps": steps})
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
    args = ap.parse_args(argv)
    run(args.arch, args.reduced, args.steps, args.batch, args.seq,
        args.data_par, args.model_par, args.lr, args.microbatches,
        args.ckpt_dir, device=args.device, seed=args.seed)


if __name__ == "__main__":
    main()
