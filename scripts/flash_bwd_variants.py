#!/usr/bin/env python3
"""Time diagnostic variants of B3's backward beside the kernel, on one card.

    python3 scripts/flash_bwd_variants.py [NAME ...]

Each variant is ``src/repro_torch/csrc/flash_attention_bwd.cu`` with a few
lines replaced (``VARIANTS``: what the kernel's design chose against),
built with the kernels' nvcc flags into ``build/kernels/variants/``, all in
parallel, and loaded in place of the kernel's library for its turn.  Each
is checked against ``ref.attention_bwd_ref`` at qwen3-0.6b's 8 x 128
training shape and at 4 x 2048 (GQA 16/8 of 128, causal), fp32 and bf16,
with ``chip_smoke.py``'s tolerances: a variant may miss them (``single_term``
does), and then its worst share of the tolerance is printed rather than
raised.  Each is timed by a CUDA-graph replay of 20 calls, in two rounds
(the variants in order, then reversed).  It prints each build's registers
and spill bytes a function (ptxas), every measurement as a JSON line, and
the card's name and power limit.  It needs one CUDA card (~3 min on an
NVIDIA H100 80GB HBM3).
"""

from __future__ import annotations

import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
import chip_smoke  # noqa: E402  (imports no torch and no repro_torch)

SOURCE = REPO / "src" / "repro_torch" / "csrc" / "flash_attention_bwd.cu"
OUT = REPO / "build" / "kernels" / "variants"

EXP2F = [("prob = ok ? ex2(softcap * kLog2e * u - lse2) : 0.f;",
          "prob = ok ? exp2f(softcap * kLog2e * u - lse2) : 0.f;"),
         ("prob = ok ? ex2(sc * scale2 - lse2) : 0.f;",
          "prob = ok ? exp2f(sc * scale2 - lse2) : 0.f;")]
SPLIT_LOOP = ("      for (int i = threadIdx.x; i < 2 * kTile * kQuads; "
              "i += C::kThreads) {")
# (old text, new text) pairs applied to the kernel's source
VARIANTS = {
    "base": [],
    # exp2f, not ex2.approx.ftz
    "exp2f": EXP2F,
    # bf16: P and dS as one bf16 term in the P Z products
    "single_term": [("        mma_bf16(acc[j], lo, bf[0], bf[1]);\n"
                     "        mma_bf16(acc[j + 1], lo, bf[2], bf[3]);\n",
                     "")],
    # fp32: three cp.async stages
    "fp32_three_stages": [
        ("static constexpr int kStages = kBf16 ? 3 : 2;",
         "static constexpr int kStages = 3;")],
    # fp32: the streamed tile left unsplit, every warp splitting what it
    # reads (the old kernel's way)
    "fp32_split_at_use": [
        ("const Split b00 = staged(ys0 + o, yl0 + o);",
         "const Split b00 = split(ys0[o]);"),
        ("const Split b01 = staged(ys0 + o + 4, yl0 + o + 4);",
         "const Split b01 = split(ys0[o + 4]);"),
        ("const Split b10 = staged(ys1 + o, yl1 + o);",
         "const Split b10 = split(ys1[o]);"),
        ("const Split b11 = staged(ys1 + o + 4, yl1 + o + 4);",
         "const Split b11 = split(ys1[o + 4]);"),
        ("mma_3xtf32(c, a[kk], staged(zs + o, zl + o),\n"
         "                   staged(zs + o + kLd, zl + o + kLd));",
         "mma_3xtf32(c, a[kk], split(zs[o]), split(zs[o + kLd]));"),
        ("    if constexpr (!C::kBf16) {\n      // split the tile",
         "    if constexpr (false) {\n      // split the tile"),
        ("static constexpr int kLo = kBf16 ? 0 : 2 * kTile * kLd * 4;",
         "static constexpr int kLo = 0;")],
    # bf16: a warp's Q (or K) read from shared memory at every tile
    "bf16_no_frags": [("constexpr bool kReg0 = C::kFrag;",
                       "constexpr bool kReg0 = false;")],
    # bf16: a dk/dv warp's K read from shared memory at every tile
    "bf16_no_k_frags": [("constexpr bool kReg0 = C::kFrag;",
                         "constexpr bool kReg0 = C::kFrag && !kDkv;")],
}


def build_all(names) -> list:
    """Build the variants in parallel; print each function's registers and
    spill bytes; return the names that built."""
    sys.path.insert(0, str(REPO / "src"))
    from repro_torch.kernels import build
    text = SOURCE.read_text()
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        src = text
        for old, new in VARIANTS[name]:
            if src.count(old) != 1:
                raise SystemExit(f"flash_bwd_variants.py: {name}: the kernel "
                                 f"source no longer holds {old!r}")
            src = src.replace(old, new)
        (OUT / f"{name}.cu").write_text(src)
        procs[name] = subprocess.Popen(
            [build.nvcc_path(), *build.NVCC_FLAGS, "-o",
             str(OUT / f"{name}.so"), str(OUT / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    built = []
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            print(log[-4000:], file=sys.stderr)
            raise SystemExit(f"flash_bwd_variants.py: {name} did not build")
        functions = re.findall(r"Compiling entry function '(\S+)'", log)
        regs = re.findall(r"Used (\d+) registers", log)
        spills = re.findall(r"(\d+) bytes spill stores", log)
        ptxas = {}
        for fn, r, sp in zip(functions, regs, spills):
            m = re.search(r"(delta_)?kernelI(f|13__nv_bfloat16)Li(\d+)", fn)
            if m:
                key = (f"{'delta ' if m.group(1) else ''}"
                       f"{'float32' if m.group(2) == 'f' else 'bfloat16'} "
                       f"D={m.group(3)}")
                ptxas[key] = {"registers": int(r), "spill_bytes": int(sp)}
        chip_smoke.emit({"variant": name, "ptxas": ptxas})
        built.append(name)
    return built


def main(argv) -> int:
    names = argv[1:] or list(VARIANTS)
    unknown = sorted(set(names) - set(VARIANTS))
    if unknown:
        print(f"flash_bwd_variants.py: no variant {unknown}; the variants: "
              f"{sorted(VARIANTS)}", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("flash_bwd_variants.py: no CUDA device", file=sys.stderr)
        return 1
    names = build_all(names)
    from repro_torch import configs
    from repro_torch.kernels import flash_attention as fa, ref
    smoke = chip_smoke.Smoke(torch)
    cfg = configs.get_config(chip_smoke.TRAIN_ARCH)
    h, kvh, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    gen = torch.Generator(smoke.dev).manual_seed(16)
    cases = []
    for dtype_name in ("float32", "bfloat16"):
        dtype = getattr(torch, dtype_name)
        for shape, (b, s) in (("train", (chip_smoke.TRAIN_BATCH,
                                         chip_smoke.TRAIN_SEQ)),
                              ("long", chip_smoke.LONG_SHAPE)):
            q = smoke.randn(b, s, h, hd, dtype=dtype, gen=gen)
            k = smoke.randn(b, s, kvh, hd, dtype=dtype, gen=gen)
            v = smoke.randn(b, s, kvh, hd, dtype=dtype, gen=gen)
            do = smoke.randn(b, s, h, hd, dtype=dtype, gen=gen)
            out, lse = fa.flash_attention(q, k, v, return_lse=True)
            want = ref.attention_bwd_ref(q, k, v, out, lse, do)
            cases.append((dtype_name, shape, (q, k, v, out, lse, do), want))
    for rnd, order in enumerate((names, names[::-1])):
        for name in order:
            lib = ctypes.CDLL(str(OUT / f"{name}.so"))
            for kernel in (fa.BWD_KERNEL, fa.DELTA_KERNEL):
                fn = getattr(lib, kernel.symbol)
                fn.argtypes = kernel.argtypes
                fn.restype = ctypes.c_int
                kernel._lib, kernel._fn = lib, fn
            for dtype_name, shape, args, want in cases:
                got = fa.flash_attention_bwd(*args)
                torch.cuda.synchronize()
                share = 0.0
                for g, w in zip(got, want):
                    try:
                        res = smoke.check(name, g, w, dtype_name)
                        share = max(share, res["err_over_tol"])
                    except AssertionError as err:
                        share = float(str(err).split(", ")[-1].split(" x ")[0])
                chip_smoke.emit({
                    "variant": name, "round": rnd, "dtype": dtype_name,
                    "shape": shape, "err_over_tol": share,
                    "graph_ms": smoke.graph_ms(
                        lambda: fa.flash_attention_bwd(*args))})
    print(chip_smoke.gpu_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
