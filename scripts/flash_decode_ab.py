#!/usr/bin/env python3
"""Time the port's memory-bound kernels on one card: two checkouts in
turns, or one checkout's decode kernels at every split count.

    python3 scripts/flash_decode_ab.py OLD_ROOT NEW_ROOT
    python3 scripts/flash_decode_ab.py --kernel fused_group_decode OLD_ROOT NEW_ROOT
    python3 scripts/flash_decode_ab.py --sweep

``OLD_ROOT`` and ``NEW_ROOT`` are roots of checkouts of this repository
(for instance the parent commit unpacked with ``git archive`` into a
directory that ``.gitignore`` lists, and ``.``).  The script runs OLD,
NEW, NEW, OLD, each in a process of its own (two packages named
``repro_torch`` cannot share one), so that a drift of the card's clocks
during the call shows as a difference between the two runs of one side.

Each run builds its checkout's source of the kernel and measures it in
fp32 and bf16 with ``chip_smoke.py``'s own kernel phase (of the
``chip_smoke.py`` beside this script): inputs from seed 0, the check
against the plain version at its tolerance, CUDA events over 20 calls
and a CUDA-graph replay of 20, with the operands in rotation over more
than twice the card's L2.  ``--kernel flash_decode`` (the default): B4
``flash_decode`` and B5 ``pool_flash_decode`` at the main path's E=1
shapes (``Smoke.decode_kernels``).  ``--kernel fused_group_decode``: B2
at the E=1, E=0 and mamba2 tails' shapes with its ``contraction_ms``
yardstick (``Smoke.group_decode_kernels``), then the host syncs of one
E=1 round's tail (``Smoke.tail_syncs``).  It prints every measurement as
a JSON line, then a table of each side's times, and the card's name and
power limit.  It needs one CUDA card and exits 1 without one.

``--sweep`` measures this checkout's decode kernels at the main path's
head layout (16 q-heads on 8 kv-heads of 128, a 274-slot ring at depth
271, the pool at ``Smoke.pool_positions``' depths) for each stream count
of ``SWEEP_STREAMS`` and each split count of ``SWEEP_SPLITS``, forced by
replacing ``plan_splits`` in this process, beside the split count that
``plan_splits`` picks: the evidence its rule rests on.  Two yardsticks go
with each shape: one read of both caches by ``torch.sum`` (what the
card's own reduction kernel takes for the bytes B4 reads), and the B5
call with every stream dead (the launches and the blocks' fixed cost).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
import chip_smoke  # noqa: E402  (imports no torch and no repro_torch)


# --kernel: (its source in csrc/, the Smoke method that times it)
KERNELS = {"flash_decode": ("flash_decode.cu", "decode_kernels"),
           "fused_group_decode": ("fused_group_decode.cu",
                                  "group_decode_kernels")}


def child(root: Path, kernel: str) -> None:
    """One run: ``kernel`` of ``root``, measured by this repository's
    chip_smoke.py."""
    sys.path.insert(0, str(root / "src"))
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("flash_decode_ab.py: no CUDA device")
    from repro_torch.kernels import build
    source, method = KERNELS[kernel]
    build.build([source])
    smoke = chip_smoke.Smoke(torch)
    # B4 and B5 are timed at a model's shapes: the main path's qwen3-0.6b
    extra = ()
    if kernel == "flash_decode":
        from repro_torch.configs import qwen3_0_6b
        extra = (qwen3_0_6b.CONFIG,)
    for dtype in ("float32", "bfloat16"):
        getattr(smoke, method)(dtype, *extra)
    if kernel == "fused_group_decode":
        smoke.tail_syncs()


SWEEP_STREAMS = (8, 16, 20, 24, 32, 44, 72, 96)
SWEEP_SPLITS = (1, 2, 3, 4)


def sweep() -> None:
    """Graph ms of B4 and B5 at every (streams, splits, dtype)."""
    sys.path.insert(0, str(REPO / "src"))
    import itertools
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("flash_decode_ab.py: no CUDA device")
    from repro_torch.kernels import flash_decode, ops, ref
    smoke = chip_smoke.Smoke(torch)
    planned = flash_decode.plan_splits
    sms = torch.cuda.get_device_properties(
        smoke.dev).multi_processor_count
    h, kvh, hd, width, depth = 16, 8, 128, 274, 271
    for dtype_name in ("float32", "bfloat16"):
        dtype = getattr(torch, dtype_name)
        for b in SWEEP_STREAMS:
            q = smoke.randn(b, h, hd, dtype=dtype)
            copies = smoke.cache_copies(b, width, kvh, hd, dtype)
            turn = itertools.cycle(copies).__next__
            mask = (torch.arange(width, device=smoke.dev) <= depth).to(
                torch.uint8)[None, :].expand(b, width)
            pos, live = smoke.pool_positions(b, width)
            calls = {
                "flash_decode": (
                    lambda: ops.decode_attention(q, *turn(), mask),
                    ref.decode_attention_ref(q, *copies[0], mask)),
                "pool_flash_decode": (
                    lambda: ops.pool_decode_attention(q, *turn(), pos, live),
                    ref.pool_decode_attention_ref(q, *copies[0], pos, live)),
            }
            for splits in SWEEP_SPLITS:
                flash_decode.plan_splits = lambda *shape, n=splits: n
                for name, (call, want) in calls.items():
                    while turn() is not copies[-1]:
                        pass                       # the next call: copy 0
                    check = smoke.check(name, call(), want, dtype_name)
                    chip_smoke.emit({
                        "sweep": name, "dtype": dtype_name, "streams": b,
                        "blocks": b * kvh, "splits": splits,
                        "planned": planned(b, kvh, width, sms),
                        "graph_ms": smoke.graph_ms(call),
                        "err_over_tol": check["err_over_tol"]})
            flash_decode.plan_splits = planned
            # yardsticks at this shape: one read of both caches by a torch
            # reduction, and the planned B5 call with every stream dead
            # (no key read: the launch, the blocks' start and the writes)
            dead = torch.zeros_like(live)
            chip_smoke.emit({
                "sweep": "yardsticks", "dtype": dtype_name, "streams": b,
                "read_ms": smoke.graph_ms(
                    lambda: [c.sum() for c in turn()]),
                "dead_ms": smoke.graph_ms(
                    lambda: ops.pool_decode_attention(q, *turn(), pos,
                                                      dead))})


def main(argv) -> int:
    parser = argparse.ArgumentParser(
        description=__doc__.splitlines()[0],
        formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("roots", nargs="*", metavar="ROOT",
                        help="OLD_ROOT NEW_ROOT")
    parser.add_argument("--kernel", choices=sorted(KERNELS),
                        default="flash_decode")
    parser.add_argument("--sweep", action="store_true")
    parser.add_argument("--child", help=argparse.SUPPRESS)
    args = parser.parse_args(argv[1:])
    if args.sweep and not args.roots:
        sweep()
        print(chip_smoke.gpu_line(), flush=True)
        return 0
    if args.child:
        child(Path(args.child).resolve(), args.kernel)
        return 0
    if len(args.roots) != 2 or args.sweep:
        parser.print_usage(sys.stderr)
        return 2
    old, new = (Path(a).resolve() for a in args.roots)
    source = KERNELS[args.kernel][0]
    for root in (old, new):
        if not (root / "src" / "repro_torch" / "csrc" / source).is_file():
            print(f"flash_decode_ab.py: {root} holds no "
                  f"src/repro_torch/csrc/{source}", file=sys.stderr)
            return 2
    rows = []
    for side, root in (("old", old), ("new", new), ("new", new),
                       ("old", old)):
        proc = subprocess.run([sys.executable, __file__, "--kernel",
                               args.kernel, "--child", str(root)],
                              capture_output=True, text=True, timeout=900)
        if proc.returncode != 0:
            print(proc.stdout + proc.stderr, file=sys.stderr)
            return 1
        for line in proc.stdout.splitlines():
            if line.startswith("{") and ('"kernel"' in line
                                         or '"tail_syncs"' in line):
                res = json.loads(line)
                res["side"], res["root"] = side, str(root)
                rows.append(res)
                print(json.dumps(res), flush=True)
    print(f"{'kernel':18} {'variant':22} {'dtype':9} {'side':4} {'ms':>9} "
          f"{'graph_ms':>9} {'bound_ms':>9} {'yardstick':>10} l2_copies")
    timed = [r for r in rows if "kernel" in r]
    for res in sorted(timed, key=lambda r: (r["kernel"], r.get("variant", ""),
                                            r["dtype"], r["side"])):
        # the library call's time, else the contraction's (B2)
        yard = res.get("library_ms")
        if yard is None:
            yard = res.get("contraction_graph_ms", float("nan"))
        print(f"{res['kernel']:18} {res.get('variant', ''):22} "
              f"{res['dtype']:9} {res['side']:4} {res['ms']:9.5f} "
              f"{res['graph_ms']:9.5f} {res['bound_ms']:9.5f} {yard:10.5f} "
              f"{res['l2_copies']}")
    for res in rows:
        if "tail_syncs" in res:
            print(f"tail syncs {res['side']}: {res['tail_syncs']}")
    print(chip_smoke.gpu_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
