#!/usr/bin/env python3
"""Time the port's kernels on one card: two checkouts in turns, or one
checkout's decode kernels at every split count.

    python3 scripts/flash_decode_ab.py OLD_ROOT NEW_ROOT
    python3 scripts/flash_decode_ab.py --kernel fused_group_decode OLD_ROOT NEW_ROOT
    python3 scripts/flash_decode_ab.py --kernel ssd_chunked_bwd OLD_ROOT NEW_ROOT
    python3 scripts/flash_decode_ab.py --kernel flash_attention_bwd OLD_ROOT NEW_ROOT
    python3 scripts/flash_decode_ab.py --train OLD_ROOT NEW_ROOT
    python3 scripts/flash_decode_ab.py --kernel flash_attention_bwd --train OLD_ROOT NEW_ROOT
    python3 scripts/flash_decode_ab.py --sweep
    python3 scripts/flash_decode_ab.py --mma-rate

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
E=1 round's tail (``Smoke.tail_syncs``).  ``--kernel ssd_chunked_bwd``:
B7's backward and its head sum at mamba2-780m's and zamba2-1.2b's 8 x 128
training shapes (``Smoke.b7_backward_ab``: no operand rotation, the
kernel's own scratches dwarf the L2).  ``--kernel flash_attention_bwd``:
B3's backward at qwen3-0.6b's 8 x 128 training shape and at 4 x 2048,
and at 2 x 512 under h2o-danube-1.8b's D = 80 (window 64) and
paligemma-3b's D = 256 (prefix-LM) (``Smoke.b3_backward_ab``, the
operands not rotated: at the small shapes they stay in the L2 in
training too).  It prints every measurement as
a JSON line, then a table of each side's times, and the card's name and
power limit.  It needs one CUDA card and exits 1 without one.

``--train`` instead runs each checkout's training of the models that go
through the ``--kernel`` named (``flash_attention_bwd``: qwen3-0.6b;
``ssd_chunked_bwd``: mamba2-780m and zamba2-1.2b; otherwise all three),
at full width and depth, without and with remat, through
``Smoke.train_full`` (its
``launch.train.run`` at 8 x 128 tokens, ``TRAIN_STEPS`` steps, the
launches held to ``train_launches``), after building all of the
checkout's kernels.  It prints each run's line, then a table of each
side's mean, median and least ms a step after the first, and peak GB.

``--sweep`` measures this checkout's decode kernels at the main path's
head layout (16 q-heads on 8 kv-heads of 128, a 274-slot ring at depth
271, the pool at ``Smoke.pool_positions``' depths) for each stream count
of ``SWEEP_STREAMS`` and each split count of ``SWEEP_SPLITS``, forced by
replacing ``plan_splits`` in this process, beside the split count that
``plan_splits`` picks: the evidence its rule rests on.  Two yardsticks go
with each shape: one read of both caches by ``torch.sum`` (what the
card's own reduction kernel takes for the bytes B4 reads), and the B5
call with every stream dead (the launches and the blocks' fixed cost).

``--mma-rate`` measures the yardstick of the port's tensor-core kernels
(B3, its backward, B7, its backward), which run on mma.sync m16n8k8 tf32
in fp32 and m16n8k16 bf16 in bf16: the rate each instruction sustains on
this card, from a loop of 1, 2, 4 or 8 independent accumulators a warp in
4, 8 or 16 warps a block, four blocks an SM (``MMA_RATE_SOURCE``, built
with the kernels' nvcc flags into ``build/kernels/``).
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
import chip_smoke  # noqa: E402  (imports no torch and no repro_torch)


# --kernel: (its source in csrc/, the Smoke method that times it)
KERNELS = {"flash_decode": ("flash_decode.cu", "decode_kernels"),
           "fused_group_decode": ("fused_group_decode.cu",
                                  "group_decode_kernels"),
           "ssd_chunked_bwd": ("ssd_scan_bwd.cu", "b7_backward_ab"),
           "flash_attention_bwd": ("flash_attention_bwd.cu",
                                   "b3_backward_ab")}
# --train: the models that train through each --kernel's kernel
TRAIN_MODELS = {"flash_attention_bwd": (chip_smoke.TRAIN_ARCH,),
                "ssd_chunked_bwd": chip_smoke.TRAIN_SSM}


def child(root: Path, kernel: str, train: bool) -> None:
    """One run: ``kernel`` of ``root``, or (``train``) its training runs,
    measured by this repository's chip_smoke.py."""
    sys.path.insert(0, str(root / "src"))
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("flash_decode_ab.py: no CUDA device")
    from repro_torch.kernels import build
    if train:
        build.build_all()
        smoke = chip_smoke.Smoke(torch)
        archs = TRAIN_MODELS.get(kernel, (chip_smoke.TRAIN_ARCH,)
                                 + chip_smoke.TRAIN_SSM)
        for arch in archs:
            for remat in (False, True):
                smoke.train_full(arch, remat)
        return
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


MMA_RATE_SOURCE = r"""
#include <cuda_runtime.h>
#include <cstdint>
// chains independent accumulators a warp, each through `iters` mma.sync
// in turn: m16n8k8 tf32 (kBf16 false) or m16n8k16 bf16
template <int kChains, bool kBf16>
__global__ void mma_loop(float* out, int iters) {
  float c[kChains][4] = {};
  const uint32_t a0 = threadIdx.x, a1 = a0 + 1, a2 = a0 + 2, a3 = a0 + 3;
  const uint32_t b0 = a0 * 3, b1 = a0 * 5;
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int j = 0; j < kChains; ++j) {
      if (kBf16) {
        asm volatile(
            "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
            "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
            : "+f"(c[j][0]), "+f"(c[j][1]), "+f"(c[j][2]), "+f"(c[j][3])
            : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
      } else {
        asm volatile(
            "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
            "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
            : "+f"(c[j][0]), "+f"(c[j][1]), "+f"(c[j][2]), "+f"(c[j][3])
            : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
      }
    }
  }
  float s = 0.f;
  for (int j = 0; j < kChains; ++j) s += c[j][0] + c[j][1] + c[j][2] + c[j][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
template <bool kBf16>
void launch(int chains, int warps, int blocks, float* out, int iters) {
  if (chains == 1) mma_loop<1, kBf16><<<blocks, warps * 32>>>(out, iters);
  if (chains == 2) mma_loop<2, kBf16><<<blocks, warps * 32>>>(out, iters);
  if (chains == 4) mma_loop<4, kBf16><<<blocks, warps * 32>>>(out, iters);
  if (chains == 8) mma_loop<8, kBf16><<<blocks, warps * 32>>>(out, iters);
}
// ms of one launch of `blocks` blocks of `warps` warps (after one warm-up),
// or -1 on a CUDA error; bf16 != 0 times m16n8k16 bf16
extern "C" float mma_rate_ms(int chains, int warps, int blocks, int iters,
                             int bf16) {
  float* out = nullptr;
  if (cudaMalloc(&out, sizeof(float) * blocks * warps * 32) != cudaSuccess) {
    return -1.f;
  }
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  float ms = -1.f;
  for (int rep = 0; rep < 2; ++rep) {
    cudaEventRecord(e0);
    if (bf16) {
      launch<true>(chains, warps, blocks, out, iters);
    } else {
      launch<false>(chains, warps, blocks, out, iters);
    }
    cudaEventRecord(e1);
    cudaEventSynchronize(e1);
    cudaEventElapsedTime(&ms, e0, e1);
  }
  const bool ok = cudaGetLastError() == cudaSuccess;
  cudaEventDestroy(e0);
  cudaEventDestroy(e1);
  cudaFree(out);
  return ok ? ms : -1.f;
}
"""


def mma_rate() -> None:
    """mma.sync m16n8k8 tf32 and m16n8k16 bf16 TFLOP/s on this card at
    each (chains, warps a block), four blocks an SM."""
    sys.path.insert(0, str(REPO / "src"))
    import ctypes
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("flash_decode_ab.py: no CUDA device")
    from repro_torch.kernels import build
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src = build.BUILD_DIR / "mma_rate.cu"
    lib = build.BUILD_DIR / "mma_rate.so"
    src.write_text(MMA_RATE_SOURCE)
    subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(lib),
                    str(src)], check=True, capture_output=True, text=True,
                   timeout=600)
    fn = ctypes.CDLL(str(lib)).mma_rate_ms
    fn.argtypes = [ctypes.c_int] * 5
    fn.restype = ctypes.c_float
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    blocks, iters = 4 * sms, 4096
    for bf16, name, depth in ((0, "m16n8k8 tf32", 8),
                              (1, "m16n8k16 bf16", 16)):
        for chains in (1, 2, 4, 8):
            for warps in (4, 8, 16):
                ms = fn(chains, warps, blocks, iters, bf16)
                if ms <= 0:
                    raise SystemExit("flash_decode_ab.py: mma_rate launch "
                                     "failed")
                mmas = blocks * warps * iters * chains
                chip_smoke.emit({
                    "mma_rate": name, "chains": chains,
                    "warps_a_block": warps, "blocks": blocks, "ms": ms,
                    "tflops": mmas * 2 * 16 * 8 * depth / (ms * 1e-3)
                    / 1e12})


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
    parser.add_argument("--mma-rate", action="store_true")
    parser.add_argument("--train", action="store_true")
    parser.add_argument("--child", help=argparse.SUPPRESS)
    args = parser.parse_args(argv[1:])
    if args.sweep and not args.roots:
        sweep()
        print(chip_smoke.gpu_line(), flush=True)
        return 0
    if args.mma_rate and not args.roots:
        mma_rate()
        print(chip_smoke.gpu_line(), flush=True)
        return 0
    if args.child:
        child(Path(args.child).resolve(), args.kernel, args.train)
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
                               args.kernel, "--child", str(root),
                               *(["--train"] if args.train else [])],
                              capture_output=True, text=True, timeout=900)
        if proc.returncode != 0:
            print(proc.stdout + proc.stderr, file=sys.stderr)
            return 1
        for line in proc.stdout.splitlines():
            if line.startswith("{") and ('"kernel"' in line
                                         or '"tail_syncs"' in line
                                         or '"train_run"' in line):
                res = json.loads(line)
                res["side"], res["root"] = side, str(root)
                rows.append(res)
                print(json.dumps(res), flush=True)
    if args.train:
        print(f"{'train_run':40} {'remat':5} {'side':4} {'mean_ms':>8} "
              f"{'median_ms':>9} {'min_ms':>8} {'peak_gb':>7}")
        for res in rows:
            print(f"{res['train_run'][:40]:40} {res['remat']!s:5} "
                  f"{res['side']:4} {res['ms_per_step']:8.2f} "
                  f"{statistics.median(res['steps_ms'][1:]):9.2f} "
                  f"{res['ms_per_step_min']:8.2f} {res['peak_gb']:7.3f}")
        print(chip_smoke.gpu_line(), flush=True)
        return 0
    print(f"{'kernel':18} {'variant':22} {'dtype':9} {'side':4} {'ms':>9} "
          f"{'graph_ms':>9} {'bound_ms':>9} {'yardstick':>10} l2_copies")
    timed = [r for r in rows if "kernel" in r]
    for res in timed:                       # B7's rows name the model
        res.setdefault("variant", res.get("arch", ""))
    for res in sorted(timed, key=lambda r: (r["kernel"], r["variant"],
                                            r["dtype"], r["side"])):
        # the library call's time, else the contraction's (B2)
        yard = res.get("library_ms")
        if yard is None:
            yard = res.get("contraction_graph_ms", float("nan"))
        print(f"{res['kernel']:18} {res.get('variant', ''):22} "
              f"{res['dtype']:9} {res['side']:4} {res['ms']:9.5f} "
              f"{res['graph_ms']:9.5f} {res['bound_ms']:9.5f} {yard:10.5f} "
              f"{res.get('l2_copies')}")
    for res in rows:
        if "tail_syncs" in res:
            print(f"tail syncs {res['side']}: {res['tail_syncs']}")
    print(chip_smoke.gpu_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
