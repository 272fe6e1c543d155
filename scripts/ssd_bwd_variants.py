#!/usr/bin/env python3
"""Time diagnostic variants of B7's backward (``csrc/ssd_scan_bwd.cu``)
against the kernel as it stands, on one card, in turns.

    python3 scripts/ssd_bwd_variants.py

Each variant is the checkout's source with a few lines replaced
(``VARIANTS``), built with the kernels' own nvcc flags into
``build/kernels/``, all builds started together.  They answer whether the
device-memory round trips hold the kernel back:

- ``states_in_smem``: the first walk computes every chunk's entry state
  but does not write it, and the reverse walk reads dy H_in's B operand
  from shared memory (16 bytes a lane, conflict-free) instead of the
  states scratch, with no prefetch: what staging H_in in shared memory
  could save at most, since the staging's cp.async and its P N fp32 of
  shared memory are left out.
- ``no_partials``: the db and dc partials are computed but not written
  (the head sum still reads the buffers).
- ``neither``: both.

A store is skipped behind a test of the stored values that is never true,
so that the products feeding it are still computed.  The variants' outputs
are wrong by design: only the kernel as it stands is checked against its
plain version (``Smoke.bwd_checks``).  Every variant is timed by a
CUDA-graph replay of 20 calls of ``ssd_scan.ssd_chunked_bwd`` (both
launches) at mamba2-780m's and zamba2-1.2b's 8 x 128 training shapes, fp32
and bf16, in the order base, variants, then again in reverse.  It prints
each time, each build's registers, spill bytes and blocks an SM, a table,
and the card's name and power limit.  It needs one CUDA card and exits 1
without one.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "src"))
import chip_smoke  # noqa: E402  (imports no torch and no repro_torch)

# never true of a finite sum: a store behind it is skipped, its operands
# still computed
NEVER = "== 1.5e-45f"
ST_SUM = "st[j][0] + st[j][1] + st[j][2] + st[j][3]"
ACC_SUM = ("acc[0][0] + acc[0][1] + acc[0][2] + acc[0][3] + acc[1][0] + "
           "acc[1][1] + acc[1][2] + acc[1][3]")
STATES = [
    ("        if (tile_pt(j) < pts) {\n          __stcg(stg",
     f"        if (tile_pt(j) < pts && {ST_SUM} {NEVER}) {{\n"
     "          __stcg(stg"),
    ('asm volatile("prefetch.global.L2 [%0];" ::"l"(hin_g + pt * kNM * 32));',
     "(void)hin_g;"),
    ("const float4 hv = __ldcg(hin_g + pt * kNM * 32);",
     "const float4 hv = reinterpret_cast<const float4*>(dh_s)"
     "[pt * 32 + lane];"),
]
PARTIALS = [
    (f"store_rows_n<kN>({dst}, acc, t0, tr, rows, n0, t4);",
     f"if ({ACC_SUM} {NEVER}) "
     f"store_rows_n<kN>({dst}, acc, t0, tr, rows, n0, t4);")
    for dst in ("dcg", "dbg")]
VARIANTS = {"base": [], "states_in_smem": STATES, "no_partials": PARTIALS,
            "neither": STATES + PARTIALS}


def patched(source: str, edits) -> str:
    for old, new in edits:
        if source.count(old) != 1:
            raise SystemExit(f"ssd_bwd_variants.py: {old!r} is not in "
                             "ssd_scan_bwd.cu exactly once")
        source = source.replace(old, new)
    return source


def build_variants(build) -> dict:
    """{variant: library}, built in parallel; raises on a failed build."""
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    text = (build.CSRC_DIR / "ssd_scan_bwd.cu").read_text()
    running = {}
    for name, edits in VARIANTS.items():
        src = build.BUILD_DIR / f"ssd_scan_bwd-variant-{name}.cu"
        lib = src.with_suffix(".so")
        src.write_text(patched(text, edits))
        running[name] = (lib, subprocess.Popen(
            [build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(lib), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, proc) in running.items():
        log, _ = proc.communicate(timeout=900)
        if proc.returncode != 0:
            raise SystemExit(f"ssd_bwd_variants.py: {name} build failed\n"
                             f"{log[-4000:]}")
        libs[name] = lib
    return libs


def bind(lib: Path, ssd_scan) -> None:
    """Route ``ssd_scan``'s backward launches and its info entry through
    ``lib``."""
    handle = ctypes.CDLL(str(lib))
    for kernel in (ssd_scan.BWD_KERNEL, ssd_scan.HEAD_SUM_KERNEL,
                   ssd_scan.BWD_INFO):
        fn = getattr(handle, kernel.symbol)
        fn.argtypes = kernel.argtypes
        fn.restype = ctypes.c_int
        kernel._lib, kernel._fn = handle, fn


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("ssd_bwd_variants.py: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch import configs
    from repro_torch.kernels import build, ref, ssd_scan
    from repro_torch.models.mamba2 import ssd_chunk
    libs = build_variants(build)
    smoke = chip_smoke.Smoke(torch)
    gen = torch.Generator(smoke.dev).manual_seed(12)
    cases = []
    for dtype_name in ("float32", "bfloat16"):
        dtype = getattr(torch, dtype_name)
        for arch in chip_smoke.TRAIN_SSM:
            cfg = configs.get_config(arch)
            b, s = chip_smoke.TRAIN_BATCH, chip_smoke.TRAIN_SEQ
            h, p, n = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
            args = smoke.ssd_inputs(b, s, h, p, n, dtype, gen=gen)
            dy = smoke.randn(b, s, h, p, dtype=dtype, gen=gen)
            cases.append((arch, dtype_name, args, dy,
                          ssd_chunk(cfg.ssm_chunk, s), (p, n, dtype)))
    bind(libs["base"], ssd_scan)
    for arch, dtype_name, args, dy, chunk, _ in cases:
        smoke.bwd_checks(f"ssd_chunked_bwd {arch}", dtype_name,
                         ssd_scan.ssd_chunked_bwd(*args, dy),
                         ref.ssd_chunked_bwd_ref(*args, dy, chunk=chunk), {})
    rows = []
    order = list(VARIANTS)
    for rnd, names in enumerate((order, order[::-1])):
        for name in names:
            bind(libs[name], ssd_scan)
            for arch, dtype_name, args, dy, _, shape in cases:
                row = {"variant": name, "round": rnd, "arch": arch,
                       "dtype": dtype_name,
                       "graph_ms": smoke.graph_ms(
                           lambda: ssd_scan.ssd_chunked_bwd(*args, dy)),
                       **ssd_scan.bwd_info(*shape, smoke.dev)}
                rows.append(row)
                chip_smoke.emit(row)
    print(f"{'variant':15} {'arch':12} {'dtype':9} {'graph_ms':>19} "
          f"{'regs':>4} {'spill':>5} {'blk/SM':>6}")
    for name in order:
        for arch, dtype_name, *_ in cases:
            got = [r for r in rows if (r["variant"], r["arch"], r["dtype"])
                   == (name, arch, dtype_name)]
            times = " ".join(f"{r['graph_ms']:.5f}" for r in got)
            print(f"{name:15} {arch:12} {dtype_name:9} {times:>19} "
                  f"{got[0]['registers']:4} {got[0]['local_bytes']:5} "
                  f"{got[0]['blocks_per_sm']:6}")
    print(chip_smoke.gpu_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
