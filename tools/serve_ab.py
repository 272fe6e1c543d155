#!/usr/bin/env python3
"""Time batch serving, or its prefill attention kernel, of two checkouts
on one card, in turns.

    python3 tools/serve_ab.py OLD_ROOT NEW_ROOT [--reps 3]
    python3 tools/serve_ab.py --prefill-kernel OLD_ROOT NEW_ROOT

``OLD_ROOT`` and ``NEW_ROOT`` are roots of checkouts of this repository
(for instance the parent commit unpacked with ``git archive`` into a
directory that ``.gitignore`` lists, and ``.``).  The script runs OLD,
NEW, NEW, OLD, each in a process of its own (two packages named
``repro_torch`` cannot share one), so that a drift of the card or of the
host during the call shows as a difference between the two runs of one
side.

Each run builds its checkout's kernels and serves the cells of ``CELLS``
through its own ``repro_torch.launch.serve.run_fixed_masks`` at
``chip_smoke.py``'s main-path settings (4 groups of K=4, S=1, prompts of
256 tokens, 16 decode rounds, full width and depth, seed 0): one run of
each cell to warm up, then ``--reps`` timed runs.  Every round ends in a
device sync, so a round's wall time includes the host's work.  It prints
each timed run as a JSON line, then a table of each side's prefill
round, mean decode round and tokens/s, and the card's name and power
limit.

``--prefill-kernel`` instead times B3 ``flash_attention``, the prefill's
attention kernel, with ``chip_smoke.py``'s own kernel phase
(``Smoke.prefill_kernel``: the check against the plain version at its
tolerance, CUDA events over 20 calls and a CUDA-graph replay of 20) at
the E=1 prefill shapes of ``PREFILL_ARCHS`` (head dims 128, 80, 64 and
256), fp32 and bf16, and prints each side's ms and graph ms.

It needs one CUDA card and exits 1 without one.
"""

from __future__ import annotations

import argparse
import gc
import json
import statistics
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
import chip_smoke  # noqa: E402  (imports no torch and no repro_torch)

# (architecture, E): the batch cells whose decode rounds are host-bound
CELLS = (("qwen3-0.6b", 0), ("qwen3-0.6b", chip_smoke.E),
         (chip_smoke.ZAMBA2, chip_smoke.E))
# --prefill-kernel: (architecture, prompt length) of each B3 shape
PREFILL_ARCHS = (("qwen3-0.6b", chip_smoke.PROMPT),
                 ("h2o-danube-1.8b", chip_smoke.PROMPT),
                 (chip_smoke.ZAMBA2, chip_smoke.PROMPT),
                 ("paligemma-3b", 512))


def child_prefill_kernel(root: Path) -> None:
    """One run: B3 of ``root`` at every shape of ``PREFILL_ARCHS``."""
    sys.path.insert(0, str(root / "src"))
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("serve_ab.py: no CUDA device")
    from repro_torch import configs
    from repro_torch.kernels import build
    build.build(["flash_attention.cu"])
    smoke = chip_smoke.Smoke(torch)
    for dtype in ("float32", "bfloat16"):
        for arch, prompt in PREFILL_ARCHS:
            smoke.prefill_kernel(dtype, configs.get_config(arch),
                                 table={}, prompt=prompt)


def child(root: Path, reps: int) -> None:
    """One run: every cell of ``CELLS`` through ``root``'s package."""
    sys.path.insert(0, str(root / "src"))
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("serve_ab.py: no CUDA device")
    from repro_torch.kernels import build
    from repro_torch.launch import serve
    build.build_all()
    k, s, groups = chip_smoke.K, chip_smoke.S, chip_smoke.GROUPS
    steps = chip_smoke.STEPS
    for arch, e in CELLS:
        for rep in range(reps + 1):
            res = serve.run_fixed_masks(
                arch, reduced=False, requests=groups * k, k=k, s=s, e=e,
                prompt_len=chip_smoke.PROMPT, steps=steps, byz_sigma=10.0,
                seed=0, device="cuda")
            toks = res["tokens"]
            if toks.shape != (groups * k, 1 + steps) or toks.min() < 0:
                raise AssertionError(f"{arch} E={e}: bad token matrix")
            if rep:                                   # run 0 warms up
                chip_smoke.emit({
                    "cell": f"{arch} E={e}", "rep": rep,
                    "prefill_ms": res["round_ms"][0],
                    "decode_round_ms_mean": sum(res["round_ms"][1:]) / steps,
                    "decode_round_ms_median": statistics.median(
                        res["round_ms"][1:]),
                    "tokens_per_s": res["tokens_per_s"]})
            del res
            gc.collect()
            torch.cuda.empty_cache()


def main(argv) -> int:
    parser = argparse.ArgumentParser(
        description=__doc__.splitlines()[0],
        formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("roots", nargs="*", metavar="ROOT",
                        help="OLD_ROOT NEW_ROOT")
    parser.add_argument("--reps", type=int, default=3)
    parser.add_argument("--prefill-kernel", action="store_true")
    parser.add_argument("--child", help=argparse.SUPPRESS)
    args = parser.parse_args(argv[1:])
    if args.child:
        if args.prefill_kernel:
            child_prefill_kernel(Path(args.child).resolve())
        else:
            child(Path(args.child).resolve(), args.reps)
        return 0
    if len(args.roots) != 2:
        parser.print_usage(sys.stderr)
        return 2
    old, new = (Path(a).resolve() for a in args.roots)
    for root in (old, new):
        if not (root / "src" / "repro_torch" / "launch" / "serve.py").is_file():
            print(f"serve_ab.py: {root} holds no repro_torch", file=sys.stderr)
            return 2
    rows = []
    for turn, (side, root) in enumerate((("old", old), ("new", new),
                                         ("new", new), ("old", old))):
        mode = ["--prefill-kernel"] if args.prefill_kernel else []
        proc = subprocess.run([sys.executable, __file__, *mode, "--reps",
                               str(args.reps), "--child", str(root)],
                              capture_output=True, text=True, timeout=1200)
        if proc.returncode != 0:
            print(proc.stdout + proc.stderr, file=sys.stderr)
            return 1
        for line in proc.stdout.splitlines():
            if line.startswith("{") and ('"cell"' in line
                                         or '"kernel"' in line):
                res = json.loads(line)
                res["side"], res["turn"] = side, turn
                rows.append(res)
                print(json.dumps(res), flush=True)
    if args.prefill_kernel:
        print(f"{'shape':34} {'dtype':9} {'side':4} {'turn':4} {'ms':>9} "
              f"{'graph_ms':>9} {'err/tol':>8}")
        for res in sorted(rows, key=lambda r: (str(r["shape"]), r["dtype"],
                                               r["turn"])):
            shape = "x".join(map(str, res["shape"][0]))
            print(f"{shape:34} {res['dtype']:9} {res['side']:4} "
                  f"{res['turn']:4} {res['ms']:9.5f} {res['graph_ms']:9.5f} "
                  f"{res['err_over_tol']:8.4f}")
        print(chip_smoke.gpu_line(), flush=True)
        return 0
    print(f"{'cell':18} {'side':4} {'turn':4} {'prefill_ms':>11} "
          f"{'decode_ms':>10} {'decode_p50':>10} {'tokens/s':>9}  "
          f"(medians over {args.reps} runs)")
    for cell in dict.fromkeys(r["cell"] for r in rows):
        for turn in range(4):
            mine = [r for r in rows if r["cell"] == cell and r["turn"] == turn]
            med = {key: statistics.median(r[key] for r in mine)
                   for key in ("prefill_ms", "decode_round_ms_mean",
                               "decode_round_ms_median", "tokens_per_s")}
            print(f"{cell:18} {mine[0]['side']:4} {turn:4} "
                  f"{med['prefill_ms']:11.3f} "
                  f"{med['decode_round_ms_mean']:10.3f} "
                  f"{med['decode_round_ms_median']:10.3f} "
                  f"{med['tokens_per_s']:9.2f}")
    print(chip_smoke.gpu_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
