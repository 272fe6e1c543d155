#!/usr/bin/env python3
"""Time the port's decode kernels on one card: two checkouts in turns,
or one checkout's kernels at every split count.

    python3 scripts/flash_decode_ab.py OLD_ROOT NEW_ROOT
    python3 scripts/flash_decode_ab.py --sweep

``OLD_ROOT`` and ``NEW_ROOT`` are roots of checkouts of this repository
(for instance the parent commit unpacked with ``git archive`` into a
directory that ``.gitignore`` lists, and ``.``).  The script runs OLD,
NEW, NEW, OLD, each in a process of its own (two packages named
``repro_torch`` cannot share one), so that a drift of the card's clocks
during the call shows as a difference between the two runs of one side.

Each run builds its checkout's ``csrc/flash_decode.cu`` and measures B4
``flash_decode`` and B5 ``pool_flash_decode`` in fp32 and bf16 with
``chip_smoke.py``'s own kernel phase (``Smoke.decode_kernels`` of the
``chip_smoke.py`` beside this script): the main path's E=1 shapes, inputs
from seed 0, the check against the plain version at its tolerance, CUDA
events over 20 calls and a CUDA-graph replay of 20, with the caches in
rotation over more than twice the card's L2.  It prints every
measurement as a JSON line, then a table of each side's times, and the
card's name and power limit.  It needs one CUDA card and exits 1 without
one.

``--sweep`` measures this checkout's kernels at the main path's head
layout (16 q-heads on 8 kv-heads of 128, a 274-slot ring at depth 271,
the pool at ``Smoke.pool_positions``' depths) for each stream count of
``SWEEP_STREAMS`` and each split count of ``SWEEP_SPLITS``, forced by
replacing ``plan_splits`` in this process, beside the split count that
``plan_splits`` picks: the evidence its rule rests on.  Two yardsticks go
with each shape: one read of both caches by ``torch.sum`` (what the
card's own reduction kernel takes for the bytes B4 reads), and the B5
call with every stream dead (the launches and the blocks' fixed cost).
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
import chip_smoke  # noqa: E402  (imports no torch and no repro_torch)


def child(root: Path) -> None:
    """One run: the kernels of ``root``, measured by this repository's
    chip_smoke.py."""
    sys.path.insert(0, str(root / "src"))
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("flash_decode_ab.py: no CUDA device")
    from repro_torch.kernels import build
    build.build(["flash_decode.cu"])
    smoke = chip_smoke.Smoke(torch)
    for dtype in ("float32", "bfloat16"):
        smoke.decode_kernels(dtype)


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
    if argv[1:] == ["--sweep"]:
        sweep()
        print(chip_smoke.gpu_line(), flush=True)
        return 0
    if len(argv) == 3 and argv[1] == "--child":
        child(Path(argv[2]).resolve())
        return 0
    if len(argv) != 3:
        print(__doc__, file=sys.stderr)
        return 2
    old, new = (Path(a).resolve() for a in argv[1:])
    for root in (old, new):
        if not (root / "src" / "repro_torch" / "csrc" /
                "flash_decode.cu").is_file():
            print(f"flash_decode_ab.py: {root} holds no "
                  "src/repro_torch/csrc/flash_decode.cu", file=sys.stderr)
            return 2
    rows = []
    for side, root in (("old", old), ("new", new), ("new", new),
                       ("old", old)):
        proc = subprocess.run([sys.executable, __file__, "--child",
                               str(root)], capture_output=True, text=True,
                              timeout=900)
        if proc.returncode != 0:
            print(proc.stdout + proc.stderr, file=sys.stderr)
            return 1
        for line in proc.stdout.splitlines():
            if line.startswith("{") and '"kernel"' in line:
                res = json.loads(line)
                res["side"], res["root"] = side, str(root)
                rows.append(res)
                print(json.dumps(res), flush=True)
    print(f"{'kernel':18} {'dtype':9} {'side':4} {'ms':>9} {'graph_ms':>9} "
          f"{'bound_ms':>9} {'library_ms':>10} l2_copies")
    for res in sorted(rows, key=lambda r: (r["kernel"], r["dtype"],
                                           r["side"])):
        print(f"{res['kernel']:18} {res['dtype']:9} {res['side']:4} "
              f"{res['ms']:9.5f} {res['graph_ms']:9.5f} "
              f"{res['bound_ms']:9.5f} {res['library_ms']:10.5f} "
              f"{res['l2_copies']}")
    print(chip_smoke.gpu_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
