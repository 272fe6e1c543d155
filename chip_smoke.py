#!/usr/bin/env python3
"""Run the PyTorch port's coded LLM serving and training paths on one
CUDA card.

    python3 chip_smoke.py        # from the root of a checkout, one card

Phases, each of which raises (and the script exits non-zero) on failure:

1. build every CUDA kernel of ``src/repro_torch/csrc`` (one nvcc each,
   all at once);
2. hold each kernel against its plain PyTorch version at the shapes the
   main paths give it (qwen3-0.6b, G=4 groups of K=4 queries, S=1, E=1:
   44 coded streams, 256-token prompts, 16 decode steps; the slot-pool
   decode at a mix of per-stream depths with dead streams), in fp32 and
   bf16, and time kernel, plain version and one PyTorch library call
   computing the same function; the memory-bound kernels (B1, B2, B4,
   B5, B6) with their operands in rotation over more than twice the L2,
   B2 also at the E=0, mamba2 and phi4-mini (V = 200064) tails' shapes
   beside ``torch.matmul`` of its decode matrices; then B3, B4 and B5
   the same way at h2o-danube-1.8b's E=1 shapes, head_dim 80 (32/8
   heads), B3/B4 checked (untimed) at phi4-mini's and stablelm's, and
   B1 and B2 checked (untimed) at every dense variant's encodes
   (d_model 2560, 3072, 2048) and at h2o-danube's and stablelm's tails
   (V = 32000, 100352) with per-group quorum masks;
3. the same comparison on the features the main paths do not use
   (window, softcap, prefix-LM, q_offset, int8 KV, ragged widths, node
   hits, the vote gather, rows that see no key, other head dims and GQA
   ratios; head_dim 80 in every one of B3, B4 and B5's variants, and
   B4/B5 at h2o-danube's heads at 1, 2 and 4 key splits), the decode
   kernels around their key splits (the E=0
   serving shapes' two splits, a 4096-slot ring at 2 streams, keys in
   one split, short streams, the multihost shape's one split), and B2
   on the worker-major tails' strided views, on views that take its
   one-column path, at the multihost shape and at K, N+1 near 64; then
   the host syncs of one E=1 round's tail (``set_sync_debug_mode``);
4. two batch serving runs with fixed masks through
   ``repro_torch.launch.serve.run_fixed_masks`` (all requests one batch,
   one random straggler a round) at full width and depth, K=4 S=1 E=0
   and K=4 S=1 E=1 with a persistent attacker at sigma 10, 16 requests
   each, counting every kernel's launches, the locator's precision and
   recall 1 at E=1; the same E=1 run, and for h2o-danube-1.8b also the
   continuous E=1 run of phase 5, for each dense variant (A3):
   h2o-danube-1.8b (24 layers, 32/8 heads of 80, SWA 4096),
   phi4-mini-3.8b (32 layers, 24/8 heads of 128, vocabulary 200064) and
   stablelm-1.6b (24 layers, MHA 32/32 of 64, LayerNorm), each model's
   memory given back before the next;
5. two continuous-batching runs (``serve --continuous``) at full width
   and depth: K=4 S=1 over 4 group slots, 32 requests of 256 tokens with
   budgets 1..16 on a Poisson clock, at E=0 and at E=1 with a persistent
   attacker at sigma 10 and quarantine; launches held against the
   executor's own prefill and decode calls, every request served its
   budget, the locator's precision and recall 1 at E=1;
6. the batch path and 7. the slot pool, at full width and 2 layers, on
   the card and on the CPU with the same weights, prompts, masks and
   noise: decoded logits within tolerance, greedy tokens and locator
   verdicts equal;
8. the same for mamba2-780m, the attention-free family: the chunked SSD
   scan (``ssd_chunked``) against its plain version at the prefill's
   shapes (44 coded streams x 256 steps x 48 heads of 64, state 128) and
   on its variants (an h0 continuation, S = 200, 12 and 1, strong decay,
   small H and B), the round tail at its ragged vocabulary (50280) with
   the vote gather, batch serving at E=0 and E=1 and continuous serving
   at E=1 with quarantine at full width and depth (48 layers, every
   logit finite, launches held against the table ``PATH_KERNELS``), and
   both whole-path checks at 2 layers;
9. one E=1 prefill round and one decode round of each model at full
   width and depth under ``torch.profiler``: the device time of the
   kernels, their share of the round's wall time, the largest of them,
   and the round's host syncs;
10. worker-sharded serving (DESIGN.md §13) on the one card, W = 1: the
   worker-major encode ``berrut_encode_dispatch`` against its plain
   version and bitwise against ``berrut_apply`` + the permutation (at
   the prefill and decode shapes, row slices of the encode matrix,
   ragged F, I up to 64, 1 and 64 groups, the multihost shape in bf16);
   worker-major batch E=1 (gather width N+1) and continuous E=1 with
   quarantine at full width and depth, launches held against the table
   (B6 once a call, B1 never); ``launch.multihost --mode serve`` at its
   defaults (qwen3-0.6b in bf16, K=7 S=2 E=0, 8 slots, 128-token
   prompts, 16 decode steps) through a one-rank NCCL group; the
   worker-major batch and pool paths at 2 layers against the CPU, E=0
   and E=1, with exactly the decode quorum surviving, and against the
   group-major path's tokens; and the round tail's collective branch
   (survivor and replicated) through a one-rank NCCL group on an E=1
   round's coded logits, equal to the one-rank path;
11. batch serving through the event-driven scheduler (``serve.run`` at
   the reference's defaults: batches of 2 groups on a 5 ms flush
   deadline at 2000 req/s, each round waiting for the decode quorum) at
   full width and depth, 16 requests of 256 tokens and 16 steps: qwen3
   E=0 and E=1, mamba2 E=1, qwen3 E=1 worker-major; launches held
   against 2 batches x 17 rounds, each batch's trace against dispatch,
   17 rounds and complete with exactly the quorum surviving, the
   attacker located in some round; precision, recall, the missed
   rounds, triggers, the event clock's p50/p99 and tokens/s printed (no
   recall asserted: ROADMAP C);
12. the scheduler's paths at full width and 2 layers, on the card and on
   the CPU with the same weights, prompts, latency seed and noise: the
   batch scheduler at E=1 and under the controller (``--adaptive``),
   ``EngineExecutor`` over the model's last-position logits with an SLO
   so that speculative decodes and corrections happen, and the slot pool
   under the controller with quarantine; traces, tokens and decision
   logs equal, the locator's vote columns equal within the logits'
   tolerance wherever the inputs are, verdicts equal except where each
   device's is explained by the exact tally of its own columns (its
   fp64 verdict, or a near tie; printed);
13. each dense variant at full width and 2 layers, on the card and on
   the CPU with the same weights: the batch whole path of phase 6, and
   the full-sequence entry points ``forward`` (B3's launches counted),
   ``predict_fn`` and ``lm_loss`` (with and without targets and a loss
   mask) within the same tolerance;
14. the other redundancy schemes (``serve.run(scheme=...)``: each
   prompt embedded once, ``predict_fn`` over the scheme's worker streams
   under the batch scheduler) on qwen3-0.6b at full width and depth, 16
   requests of 256 tokens at K=4: uncoded, replication, parm, nercc and
   invnet at S=1 E=0 (uncoded S=0), and replication, nercc and uncoded
   at S=1 E=1 with a persistent attacker at sigma 10; every request
   served with finite logits, B3 launched 28 times a ``predict_fn`` call
   and nothing else, uncoded (E=0) and replication (both) within 1e-4 x
   max(1, max |clean|) of the clean model's logits with equal greedy
   tokens past the margin; agreement, overhead, dispatch times, the
   event clock's p50/p99 and NeRCC's precision, recall and pooled
   tallies printed; B3 against its plain version at 2, 8, 16 and 24
   streams of 256 tokens, both dtypes, timed; and NeRCC / InvNet at E=0
   and NeRCC at E=1 on the 2-layer model, card against CPU: traces
   equal, verdicts equal on every batch whose tallies lie more than a
   vote from the majority, logits within the same tolerance;
15. the hybrid and MoE families (ROADMAP A10): B3, B4, B5 and B7 at
   zamba2-1.2b's E=1 shapes (MHA 32/32 heads of 64, one q-head a
   kv-head; the SSD scan at 64 heads of 64, state 64) and B3 / B5 at
   qwen3-moe-30b-a3b's multihost E=1 shapes (GQA 32/4 of 128, rep 8,
   144 streams of 128 tokens, a 256-slot ring), both dtypes, timed; B1,
   B2, B6 and the E=0 multihost shapes checked untimed; zamba2 (38
   layers: 32 "S", the shared attention block at 6 "G" positions, fp32)
   served with fixed masks at E=0 and E=1 and continuously at E=1 with
   quarantine, at full width and depth, launches held against
   ``PATH_KERNELS``, and its rounds profiled; qwen3-moe (48 layers of 128
   experts, 3.05e10 parameters, bf16) served through ``launch.multihost
   --mode serve`` at E=0 and E=1 at full width and depth after every
   earlier model's memory is given back, printing its peak memory, the
   depth run and the locator's verdicts; and both at full width and few
   layers (zamba2 "SGSG", two G positions; qwen3-moe "MM"), card against
   CPU in fp32: the batch and pool whole paths and the full-sequence
   entry points, with every MoE router call's expert routes held equal
   and its smallest top-k margin printed (a route that a near tie
   changes is printed, and nothing past it is compared);
16. the vlm and audio frontends (ROADMAP A10.3, fp32): every kernel of
   their paths at their E=1 shapes, both dtypes, timed (B3 under
   prefix-LM over 256 of 512 positions at paligemma-3b's MQA 8/1 heads
   of 256, and non-causal over hubert-xlarge's 500 frames at MHA 16/16
   of 80; B4 and B5 at D = 256 on one kv-head over a 530-slot ring; B1
   on both prefill encodes; B2 at V = 257216 and 504); paligemma (18
   layers) served with fixed masks at E=0 and E=1 through
   ``coded_prefill`` on 16 requests of 256 patch embeddings and 256 text
   tokens and 16 ``coded_decode_step``s, printing its peak memory;
   hubert (48 layers) through four ``coded_prefill`` calls on 500
   frames a request at E=0 and E=1, and through ``EngineExecutor`` over
   ``predict_fn`` under the batch scheduler at E=1 (``serve``'s scheme
   path on frame embeddings); launches held exactly, precision and
   recall 1 on the fixed-mask E=1 runs; then at full width and 2
   layers, card against CPU: paligemma's batch and pool whole paths
   (the pool's live caches too) and hubert's coded round and engine
   call, and both models' full-sequence entry points;
17. B3's backward kernel (``flash_attention_bwd``, training) and the
   forward's row log-sum-exp against their plain versions, and in fp32
   against autograd of the plain forward, at qwen3-0.6b's training
   shape (8 x 128 tokens, GQA 16/8 of 128, causal) and at 4 x 2048, both
   dtypes, timed beside the backward of autograd through SDPA; every
   rule, head dim and GQA ratio untimed (h2o-danube's window at D = 80,
   paligemma's prefix-LM at D = 256 rep 8, softcap, q_offset, rows that
   see no key); and a kernel without a backward (B4) refusing a q that
   requires grad;
18. training (ROADMAP A11) on qwen3-0.6b: one ``train_step`` at full
   width and 2 layers, card against CPU on the same weights and batch
   (loss, grad norm, every leaf's gradient, the updated parameters under
   Adam's sign-flip rule); ``launch.train.run`` at full width and depth
   (28 layers, fp32) at the reference's defaults for 8 steps, with and
   without remat: losses finite and equal between the two, ms a step,
   tokens/s, peak memory, and B3 / B3-backward launches held at 28 / 28
   a step (56 / 28 under remat); one step under torch.profiler;
19. B7's backward (ROADMAP A12: ``ssd_chunked_bwd`` and its head sum
   ``ssd_bwd_head_sum``, ``csrc/ssd_scan_bwd.cu``) against its plain
   version ``ref.ssd_chunked_bwd_ref``, fp32 and bf16, at mamba2-780m's
   and zamba2-1.2b's training shapes (8 x 128; 48 heads of 64, state
   128; 64 heads of 64, state 64), over ``BWD_DRAWS`` draws of each
   variant (h0, a gradient of h_final, both, S = 1, 31, 33 and 2048,
   strong decay) and at the domain's corners (``BWD_CORNERS``, and S = 0
   against dh_final), the worst share of ``BWD_TOL`` printed; in fp32
   also against autograd of the plain forward; two calls on the same inputs bitwise equal; the
   kernel's stages, registers, spills and blocks an SM at both shapes;
   timed at both shapes, with the device bytes each launch moves, the
   head sum beside ``torch.sum``;
20. training mamba2-780m and zamba2-1.2b on the card: one ``train_step``
   card against CPU at full width and 2 layers (zamba2: 6, "SSSSSG")
   under phase 18's rules; ``launch.train.run`` at full width and depth
   (48 and 38 layers, fp32) for 8 steps with and without remat, the
   launches held (each of B7's four launches 48 / 32 a step, the
   forward's twice under remat; zamba2's B3 and its backward 6); one
   step of each profiled, with its memory split (parameters and
   moments, the forward and backward's peak, the optimizer's);
21. one ``train_step`` card against CPU at full width and 2 layers for
   each family not trained on the card before: qwen3-moe-30b-a3b
   (router routes held, ``route_walk``), paligemma-3b (2 x 256 patches
   and 32 text tokens), hubert-xlarge (2 x 500 frames, frame targets)
   and h2o-danube-1.8b (head_dim 80), under phase 18's rules.

Each phase prints its wall time.

The line before the last is one JSON object with every kernel's numbers
(one entry a kernel, B7's scores pass its own; B3, B4 and B5's entries
also carry ``head_dim_80``: the fp32 check and times at h2o-danube's
E=1 shapes and the launches of the h2o run that carries each kernel;
B3, B4, B5 and B7's also ``zamba2-1.2b`` (fp32) and B3 and B5's
``qwen3-moe-30b-a3b`` (bf16), the same at those models' shapes;
B3's also ``scheme_streams``, its numbers at phase 14's stream counts,
and ``launches_scheme``, its launches in each phase-14 run; B1, B2, B3,
B4 and B5's also ``paligemma-3b`` and B1, B2 and B3's ``hubert-xlarge``,
their fp32 numbers at phase 16's shapes, B5's launches from paligemma's
2-layer pool whole path and B3's also ``launches_engine``; B3's also
``launches_train`` and ``launches_train_remat``, its launches in phase
18's two runs; B3's backward ``flash_attention_bwd`` its own entry, at
the training shape, with its launches in those runs and its numbers at
4 x 2048 under ``long``; B7's entries also ``launches_train``,
``launches_train_remat`` (mamba2's runs) and ``launches_train_zamba2``;
B7's backward and its head sum their own entries, at mamba2's training
shape, with their launches in phase 20's runs and their numbers at
zamba2's under ``zamba2-1.2b``);
the last is ``{"ok": true, "device": {...}}``.  Without a CUDA device, or
away from the repository's ``src/``, it exits 1 and prints no result.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory
# Dense peaks, no sparsity.  fp32: the least time for fp32-accurate
# products is set by 3xTF32 on the tensor cores (three TF32 products a
# product, 495 / 3 TFLOP/s), which B3 and B7 use, not by the 67 TFLOP/s
# of fp32 FMAs on the CUDA cores.
PEAK_OPS_PER_S = {"float32": 495e12 / 3, "bfloat16": 989e12}
# fp32: 2e-5 of max(1, max |plain|).  bf16, per element: two bf16 ulps of
# the element plus one ulp at the output's typical size (mean |plain|)
TOL_F32 = 2e-5
TOL_BF16_ULPS, BF16_ULP = 2.0, 2.0 ** -7

# main paths: 4 groups of K=4, S=1, E=1 -> 11 coded streams each
K, S, E, GROUPS = 4, 1, 1, 4
PROMPT, STEPS = 256, 16
POOL_GROUPS, POOL_REQUESTS = 4, 32
REPLACES = {
    "berrut_apply": "src/repro/kernels/berrut_matmul.py:58",
    "berrut_encode_dispatch": "src/repro/kernels/berrut_matmul.py:104",
    "fused_group_decode": "src/repro/kernels/berrut_decode.py:111",
    "flash_attention": "src/repro/kernels/flash_attention.py:101",
    "flash_decode": "src/repro/kernels/flash_decode.py:80",
    "pool_flash_decode": "src/repro/kernels/flash_decode.py:177",
    "ssd_chunked": "src/repro/kernels/ssd_scan.py:75",
    "ssd_chunk_scores": "src/repro/kernels/ssd_scan.py:75",
    # no Pallas backward: the gradient of the reference's plain attention
    "flash_attention_bwd": "src/repro/kernels/ref.py:112",
    # no Pallas backward: the gradient of the reference's chunked scan
    "ssd_chunked_bwd": "src/repro/kernels/ref.py:334",
    "ssd_bwd_head_sum": "src/repro/kernels/ref.py:334",
}
SOURCES = {name: f"src/repro_torch/csrc/{name}.cu" for name in REPLACES}
SOURCES["berrut_encode_dispatch"] = "src/repro_torch/csrc/berrut_apply.cu"
SOURCES["pool_flash_decode"] = "src/repro_torch/csrc/flash_decode.cu"
SOURCES["ssd_chunked"] = "src/repro_torch/csrc/ssd_scan.cu"
SOURCES["ssd_chunk_scores"] = "src/repro_torch/csrc/ssd_scan.cu"
SOURCES["ssd_chunked_bwd"] = "src/repro_torch/csrc/ssd_scan_bwd.cu"
SOURCES["ssd_bwd_head_sum"] = "src/repro_torch/csrc/ssd_scan_bwd.cu"
# The device function of each kernel in the built libraries, and the
# value of its last template argument where two kernels share one
# (berrut_apply_kernel's kWorkerMajor, flash_decode_kernel's kPool).
FUNCTIONS = {
    "berrut_apply": ("berrut_apply_kernel", "false"),
    "berrut_encode_dispatch": ("berrut_apply_kernel", "true"),
    "fused_group_decode": ("fused_group_decode_kernel", None),
    "flash_attention": ("flash_attention_kernel", None),
    "flash_decode": ("flash_decode_kernel", "false"),
    "pool_flash_decode": ("flash_decode_kernel", "true"),
    "ssd_chunked": ("ssd_chunked_kernel", None),
    "ssd_chunk_scores": ("ssd_scores_kernel", None),
    "flash_attention_bwd": ("flash_attention_bwd_kernel", None),
    "ssd_chunked_bwd": ("ssd_bwd_kernel", None),
    "ssd_bwd_head_sum": ("ssd_bwd_head_sum_kernel", None),
}
# Per architecture: the kernels one call of each model pass launches,
# by kernel (besides the round's one encode and one tail): B3 in every
# attention layer ("A", "M" and each shared "G" position) of a prefill,
# B4 / B5 in each of a batch / pool decode, B7's scan and scores pass in
# every Mamba2 "S" layer of a prefill.


def per_call(attention: int, ssm: int) -> dict:
    return {"prefill": {"flash_attention": attention, "ssd_chunked": ssm,
                        "ssd_chunk_scores": ssm},
            "decode": {"flash_decode": attention},
            "pool_decode": {"pool_flash_decode": attention}}


def pattern_kernels(cfg) -> dict:
    """``per_call`` of a config's layer pattern; an encoder-only config
    (``causal=False``) has no decode step."""
    calls = per_call(sum(cfg.layer_pattern.count(c) for c in "AMG"),
                     cfg.layer_pattern.count("S"))
    return calls if cfg.causal else {"prefill": calls["prefill"]}


PATH_KERNELS = {
    "qwen3-0.6b": per_call(28, 0),
    "mamba2-780m": per_call(0, 48),
    "h2o-danube-1.8b": per_call(24, 0),
    "phi4-mini-3.8b": per_call(32, 0),
    "stablelm-1.6b": per_call(24, 0),
    # 32 "S" layers, the shared block at 6 "G" positions
    "zamba2-1.2b": per_call(6, 32),
    "qwen3-moe-30b-a3b": per_call(48, 0),
    "paligemma-3b": per_call(18, 0),
    # encoder-only: a prefill (the coded round, or a ``predict_fn`` call)
    # and no decode step
    "hubert-xlarge": {"prefill": per_call(48, 0)["prefill"]},
}
# the architectures of the round profiles and the pool and worker-major
# whole paths; the dense variants (A3) get the batch whole path and the
# full-sequence check
CORE_ARCHS = ("qwen3-0.6b", "mamba2-780m")
DENSE_VARIANTS = ("h2o-danube-1.8b", "phi4-mini-3.8b", "stablelm-1.6b")
# A10: the hybrid zamba2 (fp32, full depth, batch and continuous) and the
# MoE qwen3-moe (bf16, through ``launch.multihost --mode serve``); both
# get the batch and pool whole paths and the full-sequence check at few
# layers, zamba2 with two "G" positions so that the shared weights are
# used twice and each position's cache is checked
ZAMBA2, QWEN3_MOE = "zamba2-1.2b", "qwen3-moe-30b-a3b"
HYBRID_MOE = (ZAMBA2, QWEN3_MOE)
SMALL = {ZAMBA2: dict(num_layers=4, layer_pattern="SGSG")}
# A10.3, the vlm and audio frontends (fp32, full width and depth):
# paligemma-3b (18 layers, MQA 8/1 of 256, prefix-LM over its 256 patch
# embeddings) served with fixed masks through the coded round functions
# on {"patches", "tokens"}; hubert-xlarge (48 layers, MHA 16/16 of 80,
# non-causal, no decode step) through ``coded_prefill`` on {"frames"}
# and through ``EngineExecutor`` over ``predict_fn`` (the scheme path).
# At full width and 2 layers, card against CPU, their whole paths take
# one group of K at E=1 (the CPU's share is the patches' and frames'
# positions), paligemma's text is FRONT_TEXT tokens and its pool path
# runs FRONT_POOL_ROUNDS.
PALIGEMMA, HUBERT = "paligemma-3b", "hubert-xlarge"
FRONTENDS = (PALIGEMMA, HUBERT)
FRAMES = 500            # 10 s of 16 kHz audio at HuBERT's 20 ms stride
AUDIO_CALLS = 4         # coded_prefill calls of each hubert coded run
FRONT_TEXT = 16
FRONT_POOL_ROUNDS = [((0,), ()), ((1,), (0,)), ((), (0, 1)), ((), (0, 1))]
# the key of paligemma's 2-layer pool whole path (card side) in the
# launch table: B5's launches at its shapes come from there
POOL_2_LAYERS = "whole pool path, 2 layers"
# Which serving runs carry each kernel in the ``kernels`` line: (arch,
# path, E=0 path).  ``launches`` come from the path's run at E=1,
# ``launches_e0`` from the E=0 path's run and ``launches_pool_e1`` from
# the path's continuous E=1 run.  The worker-major encode (B6) runs only
# on the worker-major paths: batch and continuous at E=1, and at E=0 the
# multihost serve run (K=7 S=2 E=0, bf16).
CARRIER = {
    "berrut_apply": ("qwen3-0.6b", "batch", "batch"),
    "berrut_encode_dispatch": ("qwen3-0.6b", "batch_wm", "multihost"),
    "fused_group_decode": ("qwen3-0.6b", "batch", "batch"),
    "flash_attention": ("qwen3-0.6b", "batch", "batch"),
    "flash_decode": ("qwen3-0.6b", "batch", "batch"),
    "pool_flash_decode": ("qwen3-0.6b", "continuous", "continuous"),
    "ssd_chunked": ("mamba2-780m", "batch", "batch"),
    "ssd_chunk_scores": ("mamba2-780m", "batch", "batch"),
}
# serving runs: (architecture, path, E); mamba2's pool runs at E=1 only;
# "_wm": the worker-major layout on one rank
RUNS = [("qwen3-0.6b", "batch", 0), ("qwen3-0.6b", "batch", E),
        ("qwen3-0.6b", "continuous", 0), ("qwen3-0.6b", "continuous", E),
        ("mamba2-780m", "batch", 0), ("mamba2-780m", "batch", E),
        ("mamba2-780m", "continuous", E),
        ("qwen3-0.6b", "batch_wm", E), ("qwen3-0.6b", "continuous_wm", E),
        ("h2o-danube-1.8b", "batch", E), ("h2o-danube-1.8b", "continuous", E),
        ("phi4-mini-3.8b", "batch", E), ("stablelm-1.6b", "batch", E),
        (ZAMBA2, "batch", 0), (ZAMBA2, "batch", E),
        (ZAMBA2, "continuous", E)]
# head_dim 80 (h2o-danube-1.8b): the key of B3, B4 and B5's entries in
# the kernels line that holds their timings at its E=1 shapes, and the
# h2o run whose launches each reports
HEAD_DIM_80 = "head_dim_80"
D80_ARCH = "h2o-danube-1.8b"
D80_CARRIER = {"flash_attention": "batch", "flash_decode": "batch",
               "pool_flash_decode": "continuous"}
# the multihost serve's defaults: K=7 S=2 over 8 group slots, prompts of
# half the 256-slot ring
MH_K, MH_S, MH_SLOTS, MH_WIDTH = 7, 2, 8, 256
MH_PROMPT = MH_WIDTH // 2
# per A10 model: the key of B3, B4, B5 and B7's entries in the kernels
# line that holds their timings at that model's shapes (zamba2's E=1
# serving shapes in fp32, qwen3-moe's multihost E=1 shapes in bf16), and
# the run whose launches each reports
MODEL_CARRIER = {
    ZAMBA2: {"flash_attention": "batch", "flash_decode": "batch",
             "pool_flash_decode": "continuous", "ssd_chunked": "batch",
             "ssd_chunk_scores": "batch"},
    QWEN3_MOE: {"flash_attention": "multihost",
                "pool_flash_decode": "multihost"},
    PALIGEMMA: {"berrut_apply": "batch", "fused_group_decode": "batch",
                "flash_attention": "batch", "flash_decode": "batch",
                "pool_flash_decode": POOL_2_LAYERS},
    HUBERT: {"berrut_apply": "coded", "fused_group_decode": "coded",
             "flash_attention": "coded"},
}
# batch serving through the event-driven scheduler at the serve defaults:
# (architecture, E, worker-major)
SCHEDULER_RUNS = [("qwen3-0.6b", 0, False), ("qwen3-0.6b", E, False),
                  ("mamba2-780m", E, False), ("qwen3-0.6b", E, True)]
# the other redundancy schemes through ``serve.run(scheme=...)``: (name,
# S, E), the straggler facet at E=0, then the Byzantine facet with a
# persistent attacker at sigma 10; uncoded at E=1 is the defenceless
# baseline.  Uncoded at E=0 and replication at both facets must give the
# clean model's logits (replication's median is exact when one of three
# replicas lies and all are present, its wait-for)
FACEOFF = [("uncoded", 0, 0), ("replication", S, 0), ("parm", S, 0),
           ("nercc", S, 0), ("invnet", S, 0), ("replication", S, E),
           ("nercc", S, E), ("uncoded", S, E)]
EXACT_SCHEMES = {("uncoded", 0), ("replication", 0), ("replication", E)}
# Training (A11): qwen3-0.6b through ``launch.train.run`` at the
# reference's defaults (8 sequences of 128 tokens, lr 3e-3, warmup 20),
# TRAIN_STEPS steps at full width and depth, with and without remat; B3's
# backward also timed at LONG_SHAPE (4 sequences of 2048 tokens).  B3's
# backward has no Pallas twin: the reference trains through XLA's
# autodiff of its plain attention, which the kernel computes.
TRAIN_ARCH = "qwen3-0.6b"
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS, TRAIN_LR = 8, 128, 8, 3e-3
LONG_SHAPE = (4, 2048)
# A12: mamba2-780m and zamba2-1.2b train on the card through B7's forward
# and its backward (``ssd_chunked_bwd``, then ``ssd_bwd_head_sum``), which
# the reference does not have either: it trains through XLA's autodiff of
# its plain chunked scan.  The backward is held against its plain version
# over BWD_DRAWS draws of every variant at both models' training shapes
# (TRAIN_BATCH x TRAIN_SEQ); each model trains one step card against CPU
# at full width and TRAIN_SMALL's depth, then through ``launch.train.run``
# at full width and depth like qwen3-0.6b.  TRAIN_FAMILIES, which had
# never trained on the card, each take the card-against-CPU step at full
# width and 2 layers (paligemma on TRAIN_VLM_TEXT text tokens after its
# patches, hubert on FRAMES frames with frame targets, TRAIN_FRONT_BATCH
# sequences each).
TRAIN_SSM = ("mamba2-780m", ZAMBA2)
TRAIN_SMALL = {"mamba2-780m": dict(num_layers=2),
               ZAMBA2: dict(num_layers=6, layer_pattern="SSSSSG")}
TRAIN_FAMILIES = (QWEN3_MOE, PALIGEMMA, HUBERT, "h2o-danube-1.8b")
TRAIN_FRONT_BATCH, TRAIN_VLM_TEXT = 2, 32
BWD_DRAWS = 5
# B7's backward at the corners of the domain it takes, untimed, with h0 and
# a gradient of h_final, BWD_DRAWS draws each: (P, N) with the most shared
# memory (128, 128), the least (8, 16), and a P that is not a power of two
# (40, 32); BWD_CORNER_SHAPE (B, S, H), S ending in a short chunk
BWD_CORNERS = ((128, 128), (8, 16), (40, 32))
BWD_CORNER_SHAPE = (2, 75, 3)
# B7's backward against its plain version: an fp32 output within
# BWD_TOL x max(1, max |plain|) (``sums``: d a_log and dD, each a sum over
# every (stream, step)), a bf16 one (dx, db, dc) under ``check``'s bf16
# rule.  Both sum the same fp32 terms in other orders, and the terms of
# ddt (x . d xbar + a d la, |a| up to 16) and of d a_log (d la la over
# every step) cancel, so their errors follow the terms' magnitudes, not
# the result's.  Measured (H100, 3 draws of each variant at both shapes):
# at most 6.1e-5 (ddt) and 1.4e-4 (d a_log) of max(1, max |plain|), the
# other outputs under 2e-5; the tolerances are over 3x that.
BWD_TOL = {"grads": 2e-4, "sums": 5e-4}
# B3 at the scheme path's stream counts (2 groups of W): ParM's parity
# call (2), uncoded and ParM's data call (8), replication at E=0 (16) and
# at E=1 (24)
SCHEME_STREAMS = (2, 8, 16, 24)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def main() -> int:
    if not (SRC / "repro_torch").is_dir():
        print("chip_smoke.py: no src/repro_torch beside this script; run it "
              "from the root of a checkout", file=sys.stderr)
        return 1
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(SRC))
    Smoke(torch).run()
    return 0


class Smoke:
    def __init__(self, torch):
        self.torch = torch
        self.dev = torch.device("cuda")
        self.gen = torch.Generator(self.dev).manual_seed(0)
        # the head_dim 80 and dense-variant checks draw from their own
        # generator, so that the inputs of every other check do not
        # depend on them
        self.extra_gen = torch.Generator(self.dev).manual_seed(1)
        self.kernels = {}                  # name -> JSON entry
        self.kernels_d80 = {}              # B3/B4/B5 at head_dim 80
        # B3 at the scheme path's stream counts: streams -> {name: entry},
        # from a generator of its own
        self.kernels_scheme = {}
        self.scheme_gen = torch.Generator(self.dev).manual_seed(2)
        # B3, B4, B5 and B7 at the A10 models' shapes ({model: {name:
        # entry}}), from a generator of their own; the few-layer models of
        # their whole paths, built once
        self.kernels_model = {arch: {} for arch in MODEL_CARRIER}
        self.model_gen = torch.Generator(self.dev).manual_seed(4)
        self.small_models = {}
        # the frontends' kernel checks (A10.3) draw from their own
        # generator too; hubert's full-depth weights, shared by its runs
        self.front_gen = torch.Generator(self.dev).manual_seed(6)
        self.audio_params = None
        # B3's backward at the training shapes ({"train", "long"}: fp32
        # entry), from a generator of its own
        self.kernels_train = {}
        self.train_gen = torch.Generator(self.dev).manual_seed(8)
        # B7's backward and its head sum at the SSM models' training shapes
        # ({(kernel, arch): fp32 entry}), from a generator of their own
        self.kernels_ssd_train = {}
        self.bwd_gen = torch.Generator(self.dev).manual_seed(10)

    # ------------------------------------------------------------ helpers

    def randn(self, *shape, dtype=None, gen=None):
        t = self.torch.randn(shape, generator=self.gen if gen is None
                             else gen, device=self.dev)
        return t if dtype is None else t.to(dtype)

    def time_ms(self, fn, iters=20) -> float:
        torch = self.torch
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / iters

    def graph_ms(self, fn, iters=20) -> float:
        """Device time of one call: ``iters`` calls captured in a CUDA
        graph and replayed, so no host launch overhead is in it."""
        torch = self.torch
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(3):
                fn()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(iters):
                fn()
        graph.replay()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / iters

    def check(self, what: str, got, want, dtype: str) -> dict:
        """max |got - want| against the tolerance of ``dtype``; raises if
        any element is over it or the output is not finite."""
        torch = self.torch
        torch.cuda.synchronize()
        got, want = got.float(), want.float()
        if got.shape != want.shape or not torch.isfinite(got).all():
            raise AssertionError(f"{what}: shape {tuple(got.shape)} vs "
                                 f"{tuple(want.shape)} or non-finite output")
        diff = (got - want).abs()
        if dtype == "bfloat16":
            mag = want.abs()
            tol = BF16_ULP * (TOL_BF16_ULPS * mag + mag.mean())
        else:
            tol = torch.full_like(want, TOL_F32 * max(
                1.0, want.abs().max().item()))
        ratio = (diff / tol.clamp_min(1e-30)).max().item()
        err = diff.max().item()
        if not ratio <= 1.0:
            raise AssertionError(f"{what} ({dtype}): max abs err {err}, "
                                 f"{ratio} x its tolerance")
        return {"max_abs_err": err, "err_over_tol": ratio,
                "max_tol": tol.max().item()}

    def bound(self, nbytes: float, ops: float, dtype: str):
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = ops / PEAK_OPS_PER_S[dtype] * 1e3
        return ((t_bytes, "bytes") if t_bytes >= t_ops
                else (t_ops, "operations"))

    def record(self, name, dtype, shape, got, want, kernel, plain,
               library, nbytes, ops, extra=None, table=None,
               keep="float32"):
        """Check, time and print one kernel at one shape; the numbers in
        ``keep`` (the model's dtype) go to ``table`` (the kernels line's
        entries when None)."""
        res = {"kernel": name, "dtype": dtype, "shape": shape, **(extra or {})}
        res.update(self.check(name, got, want, dtype))
        res["ms"] = self.time_ms(kernel)
        res["graph_ms"] = self.graph_ms(kernel)
        res["plain_ms"] = self.time_ms(plain)
        res["library_ms"] = None if library is None else self.time_ms(library)
        res["bound_ms"], res["bound_by"] = self.bound(nbytes, ops, dtype)
        emit(res)
        if dtype == keep:
            (self.kernels if table is None else table)[name] = res

    # ------------------------------------------------------------ phases

    def phase(self, name: str, fn, *args):
        """Run one phase and print its wall time; its failure raises."""
        t0 = time.perf_counter()
        out = fn(*args)
        emit({"phase": name, "seconds": time.perf_counter() - t0})
        return out

    def run(self):
        print(gpu_line(), flush=True)
        torch = self.torch
        print(f"torch {torch.__version__} cuda {torch.version.cuda} "
              f"{torch.cuda.get_device_name(0)}", flush=True)
        self.phase("build", self.build)
        for dtype in ("float32", "bfloat16"):
            self.phase(f"qwen3 kernels {dtype}", self.main_path_kernels,
                       dtype)
        for dtype in ("float32", "bfloat16"):
            self.phase(f"{D80_ARCH} head_dim 80 kernels {dtype}",
                       self.d80_kernels, dtype)
        self.phase("dense variant shapes", self.dense_variant_shapes)
        self.phase("dense variant encode and decode shapes",
                   self.dense_variant_coding)
        self.phase("qwen3 variants", self.variants)
        self.phase("flash_decode split variants", self.decode_split_variants)
        self.phase("scheduler batch shapes", self.scheduler_kernels)
        self.phase("berrut_encode_dispatch variants", self.b6_variants)
        self.phase("fused_group_decode variants", self.b2_variants)
        self.phase("round tail syncs", self.tail_syncs)
        for dtype in ("float32", "bfloat16"):
            self.phase(f"mamba2 kernels {dtype}", self.mamba2_kernels, dtype)
        self.phase("mamba2 variants", self.mamba2_variants)
        for dtype in ("float32", "bfloat16"):
            self.phase(f"zamba2 and qwen3-moe kernels {dtype}",
                       self.hybrid_moe_kernels, dtype)
        self.phase("zamba2 and qwen3-moe encode and decode shapes",
                   self.hybrid_moe_coding)
        for dtype in ("float32", "bfloat16"):
            self.phase(f"paligemma-3b and hubert-xlarge kernels {dtype}",
                       self.frontend_kernels, dtype)
        launches = {}
        for arch, path, e in RUNS:
            serve = (self.serve if path.startswith("batch")
                     else self.serve_continuous)
            launches[arch, path, e] = self.phase(
                f"{arch} {path} E={e}", serve, arch, e,
                path.endswith("_wm"))
            if arch in DENSE_VARIANTS + (ZAMBA2,):   # the next model gets
                self.free_memory()                   # the card
        for arch, e, wm in SCHEDULER_RUNS:
            path = "scheduler_wm" if wm else "scheduler"
            launches[arch, path, e] = self.phase(
                f"{arch} {path} E={e}", self.serve_scheduler, arch, e, wm)
        launches["qwen3-0.6b", "multihost", 0] = self.phase(
            "qwen3-0.6b multihost serve", self.multihost)
        for e in (0, E):
            launches[QWEN3_MOE, "multihost", e] = self.phase(
                f"{QWEN3_MOE} multihost serve E={e}", self.multihost_moe, e)
        self.phase(f"{QWEN3_MOE} multihost round profile",
                   self.profile_multihost)
        self.free_memory()
        for e in (0, E):
            launches[PALIGEMMA, "batch", e] = self.phase(
                f"{PALIGEMMA} batch E={e}", self.serve_vlm, e)
        self.free_memory()
        for e in (0, E):
            launches[HUBERT, "coded", e] = self.phase(
                f"{HUBERT} coded E={e}", self.serve_audio, e)
        launches[HUBERT, "engine", E] = self.phase(
            f"{HUBERT} EngineExecutor E={E}", self.serve_audio_engine)
        self.audio_params = None
        self.free_memory()
        for arch in CORE_ARCHS + (ZAMBA2,):
            self.phase(f"{arch} round profile", self.profile_rounds, arch)
        for arch in CORE_ARCHS:
            self.phase(f"{arch} whole path", self.whole_path, arch)
            self.phase(f"{arch} whole pool path", self.whole_pool_path, arch)
        for arch in DENSE_VARIANTS:
            self.phase(f"{arch} whole path", self.whole_path, arch)
            self.phase(f"{arch} full-sequence forward", self.full_sequence,
                       arch)
            self.free_memory()
        for arch in HYBRID_MOE:
            self.phase(f"{arch} whole path", self.whole_path, arch)
            self.phase(f"{arch} whole pool path", self.whole_pool_path, arch)
            self.phase(f"{arch} full-sequence forward", self.full_sequence,
                       arch)
            del self.small_models[arch]
            self.free_memory()
        self.phase(f"{PALIGEMMA} whole path", self.whole_path, PALIGEMMA)
        launches[PALIGEMMA, POOL_2_LAYERS, E] = self.phase(
            f"{PALIGEMMA} whole pool path", self.whole_pool_path, PALIGEMMA)
        self.phase(f"{HUBERT} whole coded and engine path",
                   self.whole_audio_path)
        for arch in FRONTENDS:
            self.phase(f"{arch} full-sequence forward", self.full_sequence,
                       arch)
            del self.small_models[arch]
            self.free_memory()
        self.phase("qwen3-0.6b whole worker-major path", self.whole_path,
                   "qwen3-0.6b", True)
        self.phase("qwen3-0.6b whole worker-major pool path",
                   self.whole_pool_path, "qwen3-0.6b", True)
        self.phase("worker tail over one-rank NCCL", self.nccl_tail)
        self.phase("qwen3-0.6b whole scheduler path",
                   self.whole_scheduler_path)
        self.phase("qwen3-0.6b whole EngineExecutor path",
                   self.whole_engine_path)
        self.phase("qwen3-0.6b whole pool path under the controller",
                   self.whole_pool_controller_path)
        scheme_launches = self.phase("qwen3-0.6b scheme faceoff path",
                                     self.scheme_faceoff)
        self.free_memory()
        for dtype in ("float32", "bfloat16"):
            self.phase(f"B3 backward {dtype}", self.b3_backward, dtype)
        self.phase("no backward, no grad", self.grad_guard)
        self.phase(f"{TRAIN_ARCH} training, 2 layers, card against CPU",
                   self.train_card_vs_cpu, TRAIN_ARCH)
        trained = {TRAIN_ARCH: self.phase(f"{TRAIN_ARCH} training",
                                          self.train_runs, TRAIN_ARCH)}
        self.phase(f"{TRAIN_ARCH} train step profile", self.train_profile,
                   TRAIN_ARCH)
        for dtype in ("float32", "bfloat16"):
            self.phase(f"B7 backward {dtype}", self.b7_backward, dtype)
        for arch in TRAIN_SSM:
            depth = TRAIN_SMALL[arch]["num_layers"]
            self.phase(f"{arch} training, {depth} layers, card against CPU",
                       self.train_card_vs_cpu, arch)
            trained[arch] = self.phase(f"{arch} training", self.train_runs,
                                       arch)
            self.phase(f"{arch} train step profile", self.train_profile,
                       arch)
        for arch in TRAIN_FAMILIES:
            self.phase(f"{arch} training, 2 layers, card against CPU",
                       self.train_card_vs_cpu, arch)
        entries = []
        for name, res in self.kernels.items():
            arch, path, path_e0 = CARRIER[name]
            pool = path.replace("batch", "continuous")
            scheduled = (launches[arch, path.replace("batch", "scheduler"),
                                  E] if path.startswith("batch") else {})
            entries.append({
                "name": name, "route": "cuda", "source": SOURCES[name],
                "replaces": REPLACES[name],
                "launches": launches[arch, path, E][name],
                "max_abs_err": res["max_abs_err"], "ms": res["ms"],
                "plain_ms": res["plain_ms"], "bound_ms": res["bound_ms"],
                "bound_by": res["bound_by"], "library_ms": res["library_ms"],
                "launches_e0": launches[arch, path_e0, 0][name],
                "launches_e0_run": f"{arch} {path_e0} E=0",
                "launches_pool_e1": launches[arch, pool, E][name],
                "launches_scheduler": scheduled.get(name),
                "graph_ms": res["graph_ms"],
                "tensor_cores": self.tensor_cores[name],
                **{key: res[key] for key in ("l2_copies", "contraction_ms")
                   if key in res},
                **({HEAD_DIM_80: self.d80_entry(name, launches)}
                   if name in D80_CARRIER else {}),
                **{arch: self.model_entry(arch, name, launches)
                   for arch in MODEL_CARRIER if name in MODEL_CARRIER[arch]},
                **(self.scheme_entry(scheme_launches)
                   if name == "flash_attention" else {}),
                **({"launches_train": trained[TRAIN_ARCH][False][name],
                    "launches_train_remat": trained[TRAIN_ARCH][True][name]}
                   if name == "flash_attention" else {}),
                **(self.ssd_train_launches(name, trained)
                   if name.startswith("ssd_") else {}),
            })
        entries.append(self.train_entry(trained[TRAIN_ARCH]))
        entries += [self.ssd_train_entry(name, trained)
                    for name in ("ssd_chunked_bwd", "ssd_bwd_head_sum")]
        if sorted(e["name"] for e in entries) != sorted(REPLACES) or \
                sorted(self.kernels_d80) != sorted(D80_CARRIER) or any(
                    sorted(self.kernels_model[arch])
                    != sorted(MODEL_CARRIER[arch]) for arch in MODEL_CARRIER):
            raise AssertionError(f"kernels measured: {sorted(self.kernels)}"
                                 f", at head_dim 80 "
                                 f"{sorted(self.kernels_d80)}, at the A10 "
                                 f"models' shapes {self.kernels_model}")
        emit({"kernels": entries})
        print(gpu_line(), flush=True)
        emit({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}})

    def d80_entry(self, name: str, launches: dict) -> dict:
        """The kernels line's ``head_dim_80`` numbers of ``name``: its
        fp32 check and times at h2o-danube's E=1 shapes, and its
        launches in the h2o run that carries it."""
        res = self.kernels_d80[name]
        path = D80_CARRIER[name]
        return {"shape": res["shape"],
                "launches": launches[D80_ARCH, path, E][name],
                "launches_run": f"{D80_ARCH} {path} E={E}",
                **{key: res[key] for key in (
                    "max_abs_err", "ms", "graph_ms", "plain_ms",
                    "bound_ms", "bound_by", "library_ms", "l2_copies")
                   if key in res}}

    def model_entry(self, arch: str, name: str, launches: dict) -> dict:
        """The kernels line's numbers of ``name`` under ``arch``: its check
        and times at that model's shapes (``hybrid_moe_kernels``), and its
        launches in the run of ``arch`` that carries it."""
        res = self.kernels_model[arch][name]
        path = MODEL_CARRIER[arch][name]
        extra = {}
        if (arch, name) == (HUBERT, "flash_attention"):   # its engine run
            extra = {"launches_engine": launches[arch, "engine", E][name],
                     "launches_engine_run": f"{arch} engine E={E}"}
        return {"dtype": res["dtype"], "shape": res["shape"],
                "launches": launches[arch, path, E][name],
                "launches_run": f"{arch} {path} E={E}", **extra,
                **{key: res[key] for key in (
                    "max_abs_err", "ms", "graph_ms", "plain_ms",
                    "bound_ms", "bound_by", "library_ms", "l2_copies")
                   if key in res}}

    def train_entry(self, launches: dict) -> dict:
        """The kernels line's entry of B3's backward: its fp32 check and
        times at the training shape, its launches in the full-depth run
        (and under remat), and the same numbers at ``LONG_SHAPE``."""
        name = "flash_attention_bwd"
        res = self.kernels_train["train"]
        keys = ("shape", "max_abs_err", "ms", "graph_ms", "plain_ms",
                "bound_ms", "bound_by", "library_ms")
        return {
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name],
            "replaces_note": "no Pallas backward: XLA's autodiff of the "
                             "reference's attention_ref",
            "launches": launches[False][name],
            "launches_run": f"{TRAIN_ARCH} launch.train.run, "
                            f"{TRAIN_STEPS} steps",
            "launches_remat": launches[True][name],
            "max_abs_err": res["max_abs_err"], "ms": res["ms"],
            "plain_ms": res["plain_ms"], "bound_ms": res["bound_ms"],
            "bound_by": res["bound_by"], "library_ms": res["library_ms"],
            "library": "backward of autograd through "
                       "scaled_dot_product_attention",
            "graph_ms": res["graph_ms"],
            "tensor_cores": self.tensor_cores[name],
            "long": {key: self.kernels_train["long"][key] for key in keys}}

    def ssd_train_launches(self, name: str, trained: dict) -> dict:
        """B7's launches of ``name`` in the SSM models' full-depth training
        runs: mamba2-780m's as ``launches_train`` (and under remat), and
        zamba2-1.2b's under ``launches_train_zamba2``."""
        mamba2, zamba2 = (trained[arch] for arch in TRAIN_SSM)
        return {"launches_train": mamba2[False][name],
                "launches_train_remat": mamba2[True][name],
                "launches_train_run": f"{TRAIN_SSM[0]} launch.train.run, "
                                      f"{TRAIN_STEPS} steps",
                "launches_train_zamba2": {"plain": zamba2[False][name],
                                          "remat": zamba2[True][name]}}

    def ssd_train_entry(self, name: str, trained: dict) -> dict:
        """The kernels line's entry of one of B7's backward launches: its
        fp32 check and times at mamba2-780m's training shape, its launches
        in mamba2's full-depth runs (and under remat), the worst share of
        its tolerance over every draw, and the same under
        ``zamba2-1.2b``."""
        keys = ("shape", "max_abs_err", "ms", "graph_ms", "plain_ms",
                "bound_ms", "bound_by", "library_ms")
        mamba2, zamba2 = TRAIN_SSM
        res = self.kernels_ssd_train[name, mamba2]
        return {
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name],
            "replaces_note": "no Pallas backward: XLA's autodiff of the "
                             "reference's ssd_chunked_ref",
            "launches": trained[mamba2][False][name],
            "launches_run": f"{mamba2} launch.train.run, {TRAIN_STEPS} "
                            f"steps",
            "launches_remat": trained[mamba2][True][name],
            **{key: res[key] for key in keys},
            "library": None if name == "ssd_chunked_bwd"
            else "torch.sum over the heads",
            "tensor_cores": self.tensor_cores[name],
            zamba2: {**{key: self.kernels_ssd_train[name, zamba2][key]
                        for key in keys},
                     "launches": trained[zamba2][False][name],
                     "launches_remat": trained[zamba2][True][name]}}

    def scheme_entry(self, scheme_launches: dict) -> dict:
        """The kernels line's ``scheme_streams`` (B3's fp32 check and times
        at each stream count of the scheme path) and ``launches_scheme``
        (its launches over the faceoff runs, by run)."""
        keys = ("shape", "max_abs_err", "ms", "graph_ms", "plain_ms",
                "bound_ms", "bound_by", "library_ms")
        return {"scheme_streams": {
                    str(n): {key: table["flash_attention"][key]
                             for key in keys}
                    for n, table in sorted(self.kernels_scheme.items())},
                "launches_scheme": scheme_launches}

    def free_memory(self) -> None:
        """Give the card's memory back between full-size models."""
        import gc
        gc.collect()
        self.torch.cuda.empty_cache()

    def build(self):
        from repro_torch.kernels import build
        t0 = time.perf_counter()
        libs = build.build_all()
        seconds = time.perf_counter() - t0
        report = {}
        for src, lib in libs.items():
            log = lib.with_suffix(".log")
            text = log.read_text() if log.exists() else ""
            regs = [int(w.split()[0]) for line in text.splitlines()
                    for w in line.split("Used ")[1:] if "registers" in w]
            spills, function = [], None
            for line in text.splitlines():
                if "Function properties for" in line:
                    function = line.split("Function properties for")[-1]
                elif "spill" in line and not line.strip().startswith(
                        "0 bytes stack frame, 0 bytes spill"):
                    spills.append(f"{(function or '').strip()}: {line.strip()}")
            report[src] = {"max_registers": max(regs, default=None),
                           "spill_lines": len(spills), "spills": spills}
        emit({"build_seconds": seconds, "libraries": report})
        self.tensor_cores = self.tensor_core_use(libs, build.nvcc_path())
        emit({"tensor_cores": self.tensor_cores})

    def tensor_core_use(self, libs: dict, nvcc: str) -> dict:
        """{kernel: {dtype: True when every instantiation of its device
        function for that dtype issues tensor-core instructions (HMMA or
        HGMMA in ``cuobjdump -sass`` of the built library)}}.  Read from
        the mangled names: ``<n><function>I`` then ``f`` (float) or
        ``13__nv_bfloat16``, and ``Lb0E`` / ``Lb1E`` for a bool template
        argument."""
        cuobjdump = Path(nvcc).parent / "cuobjdump"
        found, seen = {}, []
        for lib in libs.values():
            sass = subprocess.run([str(cuobjdump), "-sass", str(lib)],
                                  capture_output=True, text=True, check=True,
                                  timeout=300).stdout
            parts = re.split(r"^\s*Function : (\S+)\s*$", sass,
                             flags=re.M)
            for name, body in zip(parts[1::2], parts[2::2]):
                seen.append(name)
                for kernel, (fn, last) in FUNCTIONS.items():
                    m = re.search(rf"\d{fn}I(f|13__nv_bfloat16)", name)
                    flag = {"true": "Lb1E", "false": "Lb0E"}.get(last, "")
                    if m is None or flag not in name:
                        continue
                    dtype = "float32" if m.group(1) == "f" else "bfloat16"
                    found.setdefault(kernel, {}).setdefault(
                        dtype, []).append("HMMA" in body or "HGMMA" in body)
        if sorted(found) != sorted(FUNCTIONS):
            raise AssertionError(f"device functions found for "
                                 f"{sorted(found)}, not {sorted(FUNCTIONS)}"
                                 f" among {seen}")
        return {k: {dt: all(v) for dt, v in d.items()}
                for k, d in found.items()}

    def main_path_kernels(self, dtype_name: str):
        torch = self.torch
        from repro_torch.core.berrut import CodingConfig, encode_matrix
        from repro_torch.kernels import flash_decode, ops, ref
        from repro_torch.configs import qwen3_0_6b
        dtype = getattr(torch, dtype_name)
        size = dtype.itemsize
        cfg = qwen3_0_6b.CONFIG
        coding = CodingConfig(k=K, s=S, e=E)
        n1, b = coding.num_workers, GROUPS * coding.num_workers
        d, kvh = cfg.d_model, cfg.num_kv_heads

        # B1: the prefill encode (G, K, S*d) -> (G, N+1, S*d), the input
        # in rotation past the L2
        w = encode_matrix(coding, device=self.dev).to(dtype).float()
        xs = self.rotation(lambda: (
            self.randn(GROUPS, K, PROMPT * d, dtype=dtype),))
        x = xs[0][0]
        turn = itertools.cycle(xs).__next__
        f = x.shape[-1]
        l2 = {"l2_copies": len(xs)}
        self.record(
            "berrut_apply", dtype_name, [list(w.shape), list(x.shape)],
            ops.berrut_apply(w, x), ref.berrut_apply_ref(w, x),
            lambda: ops.berrut_apply(w, *turn()),
            lambda: ref.berrut_apply_ref(w, *turn()),
            lambda: torch.matmul(w.to(dtype), *turn()),
            w.numel() * 4 + (K + n1) * GROUPS * f * size,
            2 * n1 * K * f * GROUPS, extra=l2)

        # B6: the same encode written into the worker-major (N+1)*G rows
        # (two library calls: the product, then the layout copy)
        self.b6_check("berrut_encode_dispatch main shape", w, x, dtype_name)
        self.record(
            "berrut_encode_dispatch", dtype_name,
            [list(w.shape), list(x.shape)],
            ops.berrut_encode_dispatch(w, x),
            ref.berrut_encode_dispatch_ref(w, x),
            lambda: ops.berrut_encode_dispatch(w, *turn()),
            lambda: ref.berrut_encode_dispatch_ref(w, *turn()),
            lambda: torch.matmul(w.to(dtype), *turn()).transpose(
                0, 1).reshape(-1, f),
            w.numel() * 4 + (K + n1) * GROUPS * f * size,
            2 * n1 * K * f * GROUPS, extra=l2)
        self.b6_check("berrut_encode_dispatch decode shape", w,
                      self.randn(GROUPS, K, d, dtype=dtype), dtype_name,
                      timed=True)

        self.group_decode_kernels(dtype_name)
        self.prefill_kernel(dtype_name, cfg)
        self.decode_kernels(dtype_name, cfg)
        # key splits of the serving paths' decode calls: E=1 and E=0
        # (44 and 20 streams), the scheduler's E=1 and E=0 batches (22
        # and 10) and the multihost serve (72 streams, its 256-slot ring)
        sms = torch.cuda.get_device_properties(
            self.dev).multi_processor_count
        for streams, width in ((b, PROMPT + STEPS + 2),
                               (GROUPS * (K + S), PROMPT + STEPS + 2),
                               (2 * n1, PROMPT + STEPS + 2),
                               (2 * (K + S), PROMPT + STEPS + 2),
                               (72, 256)):
            emit({"variant": "flash_decode / pool_flash_decode plan",
                  "streams": streams, "width": width,
                  "blocks": streams * kvh, "splits": flash_decode.plan_splits(
                      streams, kvh, width, sms)})

    def prefill_kernel(self, dtype_name: str, cfg, table=None, gen=None,
                       streams=None, prompt=PROMPT, keep="float32"):
        """B3 at an E=1 batch prefill's shapes: 44 coded streams of 256
        positions (or ``streams`` of ``prompt``) under the config's rule
        and heads: causal with its window (qwen3: GQA 16/8 of 128;
        h2o-danube: 32/8 of 80, SWA 4096, wider than the prompt; zamba2:
        MHA 32/32 of 64; qwen3-moe: GQA 32/4 of 128), prefix-LM over the
        patches (paligemma: MQA 8/1 of 256) or non-causal (hubert: MHA
        16/16 of 80).  SDPA is the library call: ``is_causal`` for a
        causal rule, an explicit boolean mask for prefix-LM, neither for
        a non-causal one.  The bound counts the pairs the rule lets a
        head see (``visible_pairs``)."""
        torch = self.torch
        from repro_torch.core.berrut import CodingConfig
        from repro_torch.kernels import ops, ref
        dtype = getattr(torch, dtype_name)
        b = streams or GROUPS * CodingConfig(k=K, s=S, e=E).num_workers
        h, kvh, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        rule = dict(causal=cfg.causal, window=cfg.sliding_window,
                    prefix=cfg.num_patches if cfg.prefix_lm else 0)
        sdpa = torch.nn.functional.scaled_dot_product_attention
        q = self.randn(b, prompt, h, hd, dtype=dtype, gen=gen)
        k = self.randn(b, prompt, kvh, hd, dtype=dtype, gen=gen)
        vv = self.randn(b, prompt, kvh, hd, dtype=dtype, gen=gen)
        pairs = visible_pairs(prompt, **rule)
        library = dict(is_causal=cfg.causal)
        if rule["prefix"]:
            pos = torch.arange(prompt, device=self.dev)
            seen = (pos[None, :] <= pos[:, None]) | (
                pos[None, :] < rule["prefix"])
            if rule["window"] is not None:
                seen &= pos[None, :] > pos[:, None] - rule["window"]
            if int(seen.sum()) != pairs:
                raise AssertionError(f"prefix-LM pairs {pairs} against the "
                                     f"mask's {int(seen.sum())}")
            library = dict(attn_mask=seen)
        self.record(
            "flash_attention", dtype_name,
            [list(q.shape), list(k.shape)],
            ops.attention(q, k, vv, **rule),
            ref.attention_ref(q, k, vv, **rule),
            lambda: ops.attention(q, k, vv, **rule),
            lambda: ref.attention_ref(q, k, vv, **rule),
            lambda: sdpa(q.transpose(1, 2), k.transpose(1, 2),
                         vv.transpose(1, 2), enable_gqa=True, **library),
            (2 * q.numel() + 2 * k.numel()) * dtype.itemsize,
            4 * hd * pairs * b * h, extra={**rule, "pairs": pairs},
            table=table, keep=keep)

    def d80_kernels(self, dtype_name: str):
        """B3, B4 and B5 at h2o-danube-1.8b's E=1 serving shapes (head_dim
        80, GQA 32/8; the prefill's 44 x 256 tokens, the batch decode's
        274-slot ring at depth 271, the pool decode's depths with dead
        streams), checked and timed as at qwen3's: the kernels line
        reports the fp32 numbers under ``head_dim_80``."""
        from repro_torch import configs
        cfg = configs.get_config(D80_ARCH)
        if cfg.head_dim != 80 or PROMPT > cfg.sliding_window:
            raise AssertionError(f"{D80_ARCH}: head_dim {cfg.head_dim}, "
                                 f"window {cfg.sliding_window}")
        self.prefill_kernel(dtype_name, cfg, self.kernels_d80,
                            self.extra_gen)
        self.decode_kernels(dtype_name, cfg, self.kernels_d80,
                            self.extra_gen)

    def dense_variant_shapes(self):
        """B3 and B4 against their plain versions at the other dense
        variants' E=1 serving shapes, both dtypes: phi4-mini (24/8 heads
        of 128, rep 3: a kv-head's q-heads in two passes) and stablelm
        (MHA 32/32 of 64, rep 1), 44 streams of 256 tokens and the
        274-slot ring at depth 271 (h2o-danube's are in
        ``d80_kernels``)."""
        torch = self.torch
        from repro_torch import configs
        from repro_torch.kernels import ops, ref
        b = GROUPS * (2 * (K + E) + S)
        w = PROMPT + STEPS + 2
        last = (torch.arange(w, device=self.dev)
                <= PROMPT + STEPS - 1).to(torch.uint8)[None].expand(b, w)
        gen = self.extra_gen
        for dtype_name in ("float32", "bfloat16"):
            dtype = getattr(torch, dtype_name)
            for arch in ("phi4-mini-3.8b", "stablelm-1.6b"):
                cfg = configs.get_config(arch)
                h, kvh, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
                q = self.randn(b, PROMPT, h, hd, dtype=dtype, gen=gen)
                k = self.randn(b, PROMPT, kvh, hd, dtype=dtype, gen=gen)
                vv = self.randn(b, PROMPT, kvh, hd, dtype=dtype, gen=gen)
                qd = self.randn(b, h, hd, dtype=dtype, gen=gen)
                kc = self.randn(b, w, kvh, hd, dtype=dtype, gen=gen)
                vc = self.randn(b, w, kvh, hd, dtype=dtype, gen=gen)
                heads = f"H={h} KV={kvh} D={hd}"
                for what, got, want in (
                        (f"flash_attention {arch} B={b} S={PROMPT} {heads}",
                         ops.attention(q, k, vv),
                         ref.attention_ref(q, k, vv)),
                        (f"flash_decode {arch} B={b} W={w} {heads}",
                         ops.decode_attention(qd, kc, vc, last),
                         ref.decode_attention_ref(qd, kc, vc, last))):
                    out = {"variant": what, "dtype": dtype_name}
                    out.update(self.check(what, got, want, dtype_name))
                    emit(out)

    def dense_variant_coding(self):
        """B1 and B2 against their plain versions at the dense variants'
        E=1 batch serving shapes, both dtypes: B1 on the prefill encode
        (4, 4, 256 x d_model) and the decode encode (4, 4, d_model) at
        d_model 2560, 3072 and 2048; B2 on h2o-danube's (4, 11, 32000)
        and stablelm's (4, 11, 100352) tails, each group with its own
        decode quorum of survivors and one located worker among them
        (phi4-mini's (4, 11, 200064) is in ``group_decode_kernels``).
        Its inputs come from a generator of its own, so that no other
        check's inputs depend on them."""
        torch = self.torch
        from repro_torch import configs
        from repro_torch.core.berrut import CodingConfig, encode_matrix, \
            nodes
        from repro_torch.kernels import ops, ref
        gen = torch.Generator(self.dev).manual_seed(2)
        coding = CodingConfig(k=K, s=S, e=E)
        n1 = coding.num_workers
        w = encode_matrix(coding, device=self.dev).float()
        alphas, betas = nodes(coding, self.dev)
        masks = torch.zeros(GROUPS, n1, device=self.dev)
        for mask in masks:
            alive = torch.randperm(n1, generator=gen, device=self.dev)[
                :coding.decode_quorum]
            mask[alive] = 1.0
            mask[alive[0]] = 0.0                 # a located worker
        for dtype_name in ("float32", "bfloat16"):
            dtype = getattr(torch, dtype_name)
            res = []
            for arch in DENSE_VARIANTS:
                cfg = configs.get_config(arch)
                d = cfg.d_model
                for what, f in (("prefill", PROMPT * d), ("decode", d)):
                    x = self.randn(GROUPS, K, f, dtype=dtype, gen=gen)
                    res.append((f"berrut_apply {arch} {what} "
                                f"{list(x.shape)}", ops.berrut_apply(w, x),
                                ref.berrut_apply_ref(w, x)))
                if arch.startswith("phi4"):
                    continue
                v = cfg.vocab_size
                grouped = self.randn(GROUPS, n1, v, dtype=dtype, gen=gen)
                res.append((f"fused_group_decode {arch} E={E} "
                            f"({GROUPS}, {n1}, {v}) per-group quorum masks",
                            ops.fused_group_decode(grouped, masks, alphas,
                                                   betas),
                            ref.fused_group_decode_ref(grouped, masks, alphas,
                                                       betas)))
            for what, got, want in res:
                out = {"variant": what, "dtype": dtype_name}
                out.update(self.check(what, got, want, dtype_name))
                emit(out)

    def group_decode_kernels(self, dtype_name: str):
        """B2 at the serving tails' shapes, each timed with its operands
        (the (G, N+1, V) block and its masks) in rotation over more than
        twice the card's L2: the E=1 batch tail (4, 11, 151936) with
        per-group masks, the kernel's row; then the E=0 tail (4, 5,
        151936) with the shared mask, mamba2's E=1 tail (4, 11, 50280)
        without and with the vote gather (the serving tails gather their
        votes apart, the reference's one-pass variant in B2), and
        phi4-mini's E=1 tail (4, 11, 200064), the widest vocabulary the
        port serves.  Each shape also times ``torch.matmul`` of
        its (G, K, N+1) decode matrices, given, with the block:
        ``contraction_ms``, a yardstick for the contraction alone, since no
        one PyTorch call builds the matrices too (``library_ms`` is null).
        """
        torch = self.torch
        from repro_torch.configs import mamba2_780m, phi4_mini_3_8b, \
            qwen3_0_6b
        from repro_torch.core import berrut
        from repro_torch.core.berrut import CodingConfig
        from repro_torch.kernels import ops, ref
        dtype = getattr(torch, dtype_name)
        size = dtype.itemsize
        for what, e, v, c_vote in (
                ("E=1", E, qwen3_0_6b.CONFIG.vocab_size, 0),
                ("E=0", 0, qwen3_0_6b.CONFIG.vocab_size, 0),
                ("mamba2 E=1", E, mamba2_780m.CONFIG.vocab_size, 0),
                ("mamba2 E=1 c_vote=64", E, mamba2_780m.CONFIG.vocab_size,
                 64),
                ("phi4-mini E=1", E, phi4_mini_3_8b.CONFIG.vocab_size, 0)):
            gen = self.extra_gen if what.startswith("phi4") else self.gen
            coding = CodingConfig(k=K, s=S, e=e)
            n1 = coding.num_workers
            alphas = torch.tensor(coding.alphas, dtype=torch.float32,
                                  device=self.dev)
            betas = torch.tensor(coding.betas, dtype=torch.float32,
                                 device=self.dev)

            def operands():
                avail = torch.ones(n1, device=self.dev)
                avail[3] = 0.0                     # a straggler
                if not e:                          # E=0: the shared mask
                    return (self.randn(GROUPS, n1, v, dtype=dtype, gen=gen),
                            avail.expand(GROUPS, n1))
                masks = avail.repeat(GROUPS, 1)
                masks[:, 7] = 0.0                  # a located worker
                return self.randn(GROUPS, n1, v, dtype=dtype, gen=gen), masks

            copies = self.rotation(operands)
            turn = itertools.cycle(copies).__next__
            grouped, masks = copies[0]
            dec = torch.stack([berrut.basis_matrix(
                alphas, betas, berrut.survivor_weights(m), mask=m)
                for m in masks]).to(dtype)           # (G, K, N+1)
            c_count = min(v, c_vote)
            nbytes = ((n1 + K) * GROUPS * v * size + GROUPS * n1 * 4
                      + (K + n1) * 4 + GROUPS * n1 * c_count * 4)
            yardstick = {
                "variant": what, "l2_copies": len(copies),
                "contraction_ms": self.time_ms(
                    lambda: torch.matmul(dec, turn()[0])),
                "contraction_graph_ms": self.graph_ms(
                    lambda: torch.matmul(dec, turn()[0]))}
            got = ops.fused_group_decode(grouped, masks, alphas, betas,
                                         c_vote=c_vote)
            want = ref.fused_group_decode_ref(grouped, masks, alphas, betas,
                                              c_vote=c_vote)
            if c_vote:
                (got, got_votes), (want, want_votes) = got, want
                if not torch.equal(got_votes, want_votes):
                    raise AssertionError(f"fused_group_decode {what}: vote "
                                         "gather differs")
            if what == "E=1":
                self.record(
                    "fused_group_decode", dtype_name,
                    [list(grouped.shape), list(masks.shape)], got, want,
                    lambda: ops.fused_group_decode(*turn(), alphas, betas),
                    lambda: ref.fused_group_decode_ref(*turn(), alphas,
                                                       betas),
                    None, nbytes, 2 * K * n1 * v * GROUPS, extra=yardstick)
                continue
            res = {"kernel": "fused_group_decode", "dtype": dtype_name,
                   "shape": [list(grouped.shape), list(masks.shape)],
                   **yardstick}
            res.update(self.check(f"fused_group_decode {what}", got, want,
                                  dtype_name))
            res["ms"] = self.time_ms(lambda: ops.fused_group_decode(
                *turn(), alphas, betas, c_vote=c_vote))
            res["graph_ms"] = self.graph_ms(lambda: ops.fused_group_decode(
                *turn(), alphas, betas, c_vote=c_vote))
            res["bound_ms"], res["bound_by"] = self.bound(
                nbytes, 2 * K * n1 * v * GROUPS, dtype_name)
            emit(res)

    def b2_variants(self):
        """B2 off the main shapes, both dtypes, each against its plain
        version on the same operands: the worker-major tails' strided
        views (the survivor tail's ``index_select(...).transpose(0, 1)``
        at width N+1 and at the quorum, the replicated tail's
        ``transpose(0, 1)``), read in place; a ragged vocabulary (1001),
        a view at an unaligned offset and one with an odd stride, which
        take the one-column instantiation; the multihost shape (K=7,
        N+1=9, 8 slots); K and N+1 near the limit of 64, where K is walked
        in chunks, with the vote gather; and a view whose vocabulary axis
        is strided, which the wrapper refuses."""
        torch = self.torch
        from repro_torch.core.berrut import CodingConfig, nodes
        from repro_torch.kernels import berrut_decode, ops, ref
        from repro_torch.launch import worker_mesh as wm

        def vector(grouped):
            return berrut_decode.plan_vector(
                grouped.shape[-1], grouped.stride()[:2],
                grouped.element_size(), (grouped.data_ptr(),))

        for dtype_name in ("float32", "bfloat16"):
            dtype = getattr(torch, dtype_name)
            wide = 16 // dtype.itemsize
            res = []
            coding = CodingConfig(k=K, s=S, e=E)
            n1 = coding.num_workers
            alphas, betas = nodes(coding, self.dev)
            block = self.randn(n1, GROUPS, 151936, dtype=dtype)
            avail = torch.ones(n1, device=self.dev)
            avail[3] = 0.0
            located = torch.ones(GROUPS, n1, device=self.dev)
            located[1, 7] = located[2, 0] = 0.0
            mf = avail[None, :] * located
            for width in (n1, coding.decode_quorum):
                _, idx, valid = wm._survivor_slots(avail, width)
                grouped = block.index_select(0, idx).transpose(0, 1)
                if grouped.is_contiguous() or vector(grouped) != wide:
                    raise AssertionError("fused_group_decode: the worker-"
                                         "major view is contiguous or not "
                                         "read 16 bytes wide")
                masks = mf[:, idx] * valid[None, :]
                res.append((f"fused_group_decode worker-major survivor "
                            f"view width {width}",
                            ops.fused_group_decode(grouped, masks, alphas,
                                                   betas[idx]),
                            ref.fused_group_decode_ref(grouped, masks, alphas,
                                                       betas[idx])))
            grouped = block.transpose(0, 1)
            res.append(("fused_group_decode worker-major replicated view",
                        ops.fused_group_decode(grouped, mf, alphas, betas),
                        ref.fused_group_decode_ref(grouped, mf, alphas,
                                                   betas)))
            # one column a thread: ragged V, an unaligned offset, an odd
            # stride
            big = self.randn(GROUPS, n1, 1008, dtype=dtype)
            for what, grouped in (
                    ("V=1001", self.randn(GROUPS, n1, 1001, dtype=dtype)),
                    ("unaligned offset", big[..., 1:1001]),
                    ("odd stride", self.randn(GROUPS, n1, 1001,
                                              dtype=dtype)[..., :1000])):
                if vector(grouped) != 1:
                    raise AssertionError(f"fused_group_decode {what}: "
                                         "plan_vector chose "
                                         f"{vector(grouped)}, not 1")
                res.append((f"fused_group_decode {what} (one column a "
                            "thread)",
                            ops.fused_group_decode(grouped, mf, alphas,
                                                   betas),
                            ref.fused_group_decode_ref(grouped, mf, alphas,
                                                       betas)))
            # the multihost serve's tail: K=7 S=2 E=0, 8 slots
            mh = CodingConfig(k=7, s=2, e=0)
            a7, b9 = nodes(mh, self.dev)
            grouped = self.randn(8, mh.num_workers, 151936, dtype=dtype)
            m9 = torch.ones(mh.num_workers, device=self.dev)
            m9[[2, 6]] = 0.0
            res.append(("fused_group_decode multihost K=7 N+1=9 G=8",
                        ops.fused_group_decode(grouped, m9, a7, b9),
                        ref.fused_group_decode_ref(grouped, m9, a7, b9)))
            # K and N+1 near 64: K walked in chunks of the kernel's rows
            for big_k in (CodingConfig(k=60, s=4, e=0),
                          CodingConfig(k=30, s=1, e=1)):
                ak, bk = nodes(big_k, self.dev)
                nk = big_k.num_workers
                grouped = self.randn(3, nk, 1000, dtype=dtype)
                mk = torch.ones(3, nk, device=self.dev)
                mk[0, 5] = mk[1, nk - 1] = mk[2, 0] = 0.0
                (got, gv), (want, wv) = (
                    ops.fused_group_decode(grouped, mk, ak, bk, c_vote=64),
                    ref.fused_group_decode_ref(grouped, mk, ak, bk,
                                               c_vote=64))
                if not torch.equal(gv, wv):
                    raise AssertionError(f"fused_group_decode K={big_k.k}: "
                                         "vote gather differs")
                res.append((f"fused_group_decode K={big_k.k} N+1={nk} "
                            "c_vote=64", got, want))
            for what, got, want in res:
                out = {"variant": what, "dtype": dtype_name}
                out.update(self.check(what, got, want, dtype_name))
                emit(out)
        try:
            ops.fused_group_decode(self.randn(GROUPS, n1, 2000)[..., ::2],
                                   avail, alphas, betas)
        except ValueError:
            emit({"variant": "fused_group_decode strided vocabulary raises"})
        else:
            raise AssertionError("fused_group_decode took a block whose "
                                 "vocabulary axis is strided")

    def scheduler_kernels(self):
        """Every kernel of the batch scheduler's path at that path's own
        shapes, both dtypes, against its plain version: batches of 2
        groups (22 coded streams at E=1, 10 at E=0).  B1 on the prefill
        and decode encodes at E=1 and E=0, B6 on both at E=1; B2 on the
        E=1 tail (quorum survivors, 6 of 11, per-group masks with a
        located worker), the E=0 tail (4 of 5, the shared mask), mamba2's
        E=1 tail and the worker-major survivor view at the default gather
        width; B3 on the 22- and 10-stream prefills; B7 on mamba2's
        22-stream prefill.  (B4 at 22 and 10 streams is in the split
        variants.)"""
        torch = self.torch
        from repro_torch.configs import mamba2_780m, qwen3_0_6b
        from repro_torch.core.berrut import CodingConfig, encode_matrix, \
            nodes
        from repro_torch.kernels import ops, ref
        from repro_torch.launch import worker_mesh as wm
        from repro_torch.models.mamba2 import ssd_chunk
        cfg, mcfg = qwen3_0_6b.CONFIG, mamba2_780m.CONFIG
        d, h, kvh, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, \
            cfg.head_dim
        g = 2
        for dtype_name in ("float32", "bfloat16"):
            dtype = getattr(torch, dtype_name)
            res = []
            for e in (E, 0):
                coding = CodingConfig(k=K, s=S, e=e)
                n1 = coding.num_workers
                w = encode_matrix(coding, device=self.dev).float()
                for what, f in (("prefill", PROMPT * d), ("decode", d)):
                    x = self.randn(g, K, f, dtype=dtype)
                    res.append((f"berrut_apply scheduler E={e} {what} "
                                f"G={g}", ops.berrut_apply(w, x),
                                ref.berrut_apply_ref(w, x), dtype_name))
                    if e:
                        self.b6_check(f"berrut_encode_dispatch scheduler "
                                      f"E={e} {what} G={g}", w, x,
                                      dtype_name)
                alphas, betas = nodes(coding, self.dev)
                # the round's survivors: the decode quorum of N+1
                avail = torch.zeros(n1, device=self.dev)
                avail[torch.randperm(n1, generator=self.gen,
                                     device=self.dev)[
                                         :coding.decode_quorum]] = 1.0
                if e:
                    masks = avail.repeat(g, 1)
                    masks[:, int(avail.nonzero()[0])] = 0.0   # located
                else:
                    masks = avail.expand(g, n1)
                vocabs = ((cfg.vocab_size, mcfg.vocab_size) if e
                          else (cfg.vocab_size,))
                for v in vocabs:
                    grouped = self.randn(g, n1, v, dtype=dtype)
                    res.append((f"fused_group_decode scheduler E={e} "
                                f"({g}, {n1}, {v})",
                                ops.fused_group_decode(grouped, masks,
                                                       alphas, betas),
                                ref.fused_group_decode_ref(grouped, masks,
                                                           alphas, betas),
                                dtype_name))
                if e:
                    width = wm.WorkerShardConfig().resolved_width(coding)
                    block = self.randn(n1, g, cfg.vocab_size, dtype=dtype)
                    _, idx, valid = wm._survivor_slots(avail, width)
                    grouped = block.index_select(0, idx).transpose(0, 1)
                    mc = masks[:, idx] * valid[None, :]
                    res.append((f"fused_group_decode scheduler E={e} "
                                f"worker-major survivor view width {width}",
                                ops.fused_group_decode(grouped, mc, alphas,
                                                       betas[idx]),
                                ref.fused_group_decode_ref(
                                    grouped, mc, alphas, betas[idx]),
                                dtype_name))
                b = g * n1
                q = self.randn(b, PROMPT, h, hd, dtype=dtype)
                k = self.randn(b, PROMPT, kvh, hd, dtype=dtype)
                vv = self.randn(b, PROMPT, kvh, hd, dtype=dtype)
                res.append((f"flash_attention scheduler E={e} B={b} "
                            f"S={PROMPT}", ops.attention(q, k, vv),
                            ref.attention_ref(q, k, vv), dtype_name))
            b = g * CodingConfig(k=K, s=S, e=E).num_workers
            args = self.ssd_inputs(b, PROMPT, mcfg.ssm_heads,
                                   mcfg.ssm_head_dim, mcfg.ssm_state, dtype)
            chunk = ssd_chunk(mcfg.ssm_chunk, PROMPT)
            (y, hf), (yr, hr) = (ops.ssd(*args),
                                 ref.ssd_chunked_ref(*args, chunk=chunk))
            res += [(f"ssd_chunked scheduler E={E} B={b} y", y, yr,
                     dtype_name),
                    (f"ssd_chunked scheduler E={E} B={b} h_final", hf, hr,
                     "float32")]
            for what, got, want, tol_dtype in res:
                out = {"variant": what, "dtype": dtype_name}
                out.update(self.check(what, got, want, tol_dtype))
                emit(out)

    def count_syncs(self, fn) -> int:
        """Calls that synchronise the host with the card while ``fn`` runs
        (``torch.cuda.set_sync_debug_mode("warn")``: one warning each)."""
        import warnings
        torch = self.torch
        torch.cuda.synchronize()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                fn()
            finally:
                torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        return sum("called a synchronizing CUDA operation" in str(w.message)
                   for w in caught)

    def tail_syncs(self) -> None:
        """Synchronising calls in one E=1 round's tail, from the locator
        through B2, at the batch path's shape (44 coded streams, V =
        151936): the group-major tail ``_finish_round`` and the one-rank
        worker-major one ``_finish_round_wm`` (survivor gather at width
        N+1).  Each runs once before it is counted, as every round but a
        run's first does."""
        torch = self.torch
        from repro_torch.configs import qwen3_0_6b
        from repro_torch.core.berrut import CodingConfig
        from repro_torch.launch.worker_mesh import WorkerShardConfig
        from repro_torch.serving import coded_serving as cs
        coding = CodingConfig(k=K, s=S, e=E)
        n1 = coding.num_workers
        coded = self.randn(GROUPS * n1, qwen3_0_6b.CONFIG.vocab_size)
        avail = torch.ones(n1, device=self.dev)
        avail[3] = 0.0
        wshard = WorkerShardConfig(gather_width=n1)
        tails = {
            "group-major": lambda: cs._finish_round(coding, coded, avail,
                                                    True),
            "worker-major": lambda: cs._finish_round_wm(
                coding, coded, avail, True, wshard, None, None)}
        counts = {}
        for what, fn in tails.items():
            fn()
            counts[what] = self.count_syncs(fn)
        emit({"tail_syncs": counts, "rounds": "E=1 batch, K=4 S=1 G=4"})

    def decode_kernels(self, dtype_name: str, cfg, table=None, gen=None,
                       streams=None, prompt=PROMPT, width=None,
                       which=("flash_decode", "pool_flash_decode"),
                       keep="float32"):
        """B4 and B5 (or those in ``which``) at the E=1 batch path's
        shapes for ``cfg`` (44 streams, a 274-slot ring at depth 271;
        qwen3: GQA 16/8 of 128), or at ``streams`` over a ``width``-slot
        ring after a ``prompt``-token prompt, timed over enough copies of
        the caches in rotation that the card's L2 holds none of them from
        one call to the next (a bf16 copy is about the L2's size): the
        kernel, its plain version and the library call each read the next
        copy at every call."""
        torch = self.torch
        from repro_torch.core.berrut import CodingConfig
        from repro_torch.kernels import ops, ref
        dtype = getattr(torch, dtype_name)
        size = dtype.itemsize
        b = streams or GROUPS * CodingConfig(k=K, s=S, e=E).num_workers
        h, kvh, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        sdpa = torch.nn.functional.scaled_dot_product_attention

        # B4: decode at the last step over the (B, W, KV, D) ring cache
        width = width or prompt + STEPS + 2
        pos = prompt + STEPS - 1
        qd = self.randn(b, h, hd, dtype=dtype, gen=gen)
        copies = self.cache_copies(b, width, kvh, hd, dtype, gen)
        kc, vc = copies[0]
        turn = itertools.cycle(copies).__next__
        valid = (torch.arange(width, device=self.dev) <= pos).to(torch.uint8)
        mask = valid[None, :].expand(b, width)
        n_valid = pos + 1
        l2 = {"l2_copies": len(copies)}
        if "flash_decode" in which:
            self.record(
                "flash_decode", dtype_name, [list(qd.shape), list(kc.shape)],
                ops.decode_attention(qd, kc, vc, mask),
                ref.decode_attention_ref(qd, kc, vc, mask),
                lambda: ops.decode_attention(qd, *turn(), mask),
                lambda: ref.decode_attention_ref(qd, *turn(), mask),
                lambda: sdpa(qd[:, :, None], *(c.transpose(1, 2)
                                               for c in turn()),
                             attn_mask=mask.bool()[:, None, None, :],
                             enable_gqa=True),
                2 * qd.numel() * size + 2 * b * n_valid * kvh * hd * size
                + width,
                4 * hd * n_valid * b * h, extra=l2, table=table, keep=keep)
        if "pool_flash_decode" not in which:
            return

        # B5: the slot-pool decode over the same (B, W, KV, D) caches, at
        # per-stream depths and with dead streams (E=0's live mask)
        pos, live = self.pool_positions(b, width, gen, prompt)
        nkeys = (torch.clamp(pos, max=width - 1) + 1) * live
        n_read = int(nkeys.sum().item())             # keys the rows see
        got = ops.pool_decode_attention(qd, kc, vc, pos, live)
        self.dead_rows_zero("pool_flash_decode", got, live)
        for what, lv in (("live=None", None), ("dead streams", live)):
            out = {"variant": f"pool_flash_decode main shape {what}"}
            out.update(self.check(
                out["variant"], ops.pool_decode_attention(qd, kc, vc, pos, lv),
                ref.pool_decode_attention_ref(qd, kc, vc, pos, lv),
                dtype_name))
            emit(out)
        allowed = ((torch.arange(width, device=self.dev)[None, :]
                    <= pos[:, None]) & live.bool()[:, None])
        self.record(
            "pool_flash_decode", dtype_name,
            [list(qd.shape), list(kc.shape), pos.tolist()],
            got, ref.pool_decode_attention_ref(qd, kc, vc, pos, live),
            lambda: ops.pool_decode_attention(qd, *turn(), pos, live),
            lambda: ref.pool_decode_attention_ref(qd, *turn(), pos, live),
            lambda: sdpa(qd[:, :, None], *(c.transpose(1, 2)
                                           for c in turn()),
                         attn_mask=allowed[:, None, None, :],
                         enable_gqa=True),
            2 * qd.numel() * size + 2 * n_read * kvh * hd * size + 5 * b,
            4 * hd * n_read * h, extra=l2, table=table, keep=keep)

    def rotation(self, make) -> list:
        """[make(), ...]: as many sets of operands (tuples of tensors) as
        it takes for their bytes to exceed twice the card's L2, so that a
        timed call that takes the next set at every call finds none of its
        operands in L2 from one call to the next."""
        l2 = self.torch.cuda.get_device_properties(self.dev).L2_cache_size
        first = make()
        one = sum(t.numel() * t.element_size() for t in first)
        return [first] + [make() for _ in range(2 * l2 // one)]

    def cache_copies(self, b: int, width: int, kvh: int, hd: int, dtype,
                     gen=None):
        """[(k, v)] caches of (b, width, kvh, hd) in rotation."""
        return self.rotation(lambda: (
            self.randn(b, width, kvh, hd, dtype=dtype, gen=gen),
            self.randn(b, width, kvh, hd, dtype=dtype, gen=gen)))

    def b6_check(self, what: str, w, x, dtype_name: str,
                 timed: bool = False) -> None:
        """B6 on (w, x) against its plain version at the tolerance, and
        bitwise against B1 followed by the worker-major permutation (one
        kernel, the same fmaf chain); with ``timed`` also its times."""
        torch = self.torch
        from repro_torch.kernels import ops, ref
        got = ops.berrut_encode_dispatch(w, x)
        permuted = ops.berrut_apply(w, x).transpose(0, 1).reshape(
            -1, x.shape[-1])
        torch.cuda.synchronize()
        if not torch.equal(got, permuted):
            raise AssertionError(f"{what}: B6 differs from B1 + the "
                                 "permutation")
        out = {"variant": what, "dtype": dtype_name,
               "shape": [list(w.shape), list(x.shape)],
               "equals_b1_permuted": True}
        out.update(self.check(what, got, ref.berrut_encode_dispatch_ref(
            w, x), dtype_name))
        if timed:
            o, (g, i, f) = w.shape[0], x.shape
            size = x.element_size()
            out["ms"] = self.time_ms(lambda: ops.berrut_encode_dispatch(w, x))
            out["graph_ms"] = self.graph_ms(
                lambda: ops.berrut_encode_dispatch(w, x))
            out["bound_ms"], out["bound_by"] = self.bound(
                w.numel() * 4 + (i + o) * g * f * size, 2 * o * i * f * g,
                dtype_name)
        emit(out)

    def b6_variants(self):
        """B6 off the main shapes, both dtypes: ragged F, row slices of a
        16-row encode matrix (a rank's rows), I up to 64, 1 and 64
        groups; the multihost shape in bf16, timed; a grid too tall."""
        torch = self.torch
        from repro_torch.core.berrut import CodingConfig, encode_matrix
        from repro_torch.kernels import berrut_matmul, ops
        w11 = encode_matrix(CodingConfig(k=K, s=S, e=E),
                            device=self.dev).float()
        w16 = encode_matrix(CodingConfig(k=6, s=2, e=1),
                            device=self.dev).float()       # 16 x 6
        for dtype_name in ("float32", "bfloat16"):
            dtype = getattr(torch, dtype_name)
            for f in (1000, 50280):
                self.b6_check(f"berrut_encode_dispatch ragged F={f}", w11,
                              self.randn(GROUPS, K, f, dtype=dtype),
                              dtype_name)
            x = self.randn(3, 6, 1000, dtype=dtype)
            full = ops.berrut_encode_dispatch(w16, x)
            for rows in (1, 2, 4, 8):
                for r in range(16 // rows):
                    part = w16[r * rows:(r + 1) * rows]
                    got = ops.berrut_encode_dispatch(part, x)
                    if not torch.equal(got, full[r * rows * 3:
                                                 (r + 1) * rows * 3]):
                        raise AssertionError(
                            f"berrut_encode_dispatch rows {r * rows}.."
                            f"{(r + 1) * rows - 1}: not its slice of the "
                            "full output")
                self.b6_check(f"berrut_encode_dispatch O_local={rows} of "
                              "16 (last rank)", part, x, dtype_name)
            for i in (1, 7, 33, 64):
                self.b6_check(f"berrut_encode_dispatch I={i}",
                              self.randn(16, i), self.randn(
                                  3, i, 1000, dtype=dtype), dtype_name)
            for g in (1, 64):
                self.b6_check(f"berrut_encode_dispatch G={g}", w11,
                              self.randn(g, K, 1024, dtype=dtype),
                              dtype_name)
        # the multihost serve prefill: (9, 7) @ (8 slots, 7, 128 x 1024)
        w9 = encode_matrix(CodingConfig(k=7, s=2, e=0),
                           device=self.dev).float()
        self.b6_check("berrut_encode_dispatch multihost prefill", w9,
                      self.randn(8, 7, 128 * 1024, dtype=torch.bfloat16),
                      "bfloat16", timed=True)
        tall = torch.zeros(berrut_matmul.MAX_GROUPS + 1, 1, 1,
                           device=self.dev)
        try:
            ops.berrut_encode_dispatch(torch.ones(1, 1, device=self.dev),
                                       tall)
        except ValueError:
            emit({"variant": "berrut_encode_dispatch G > grid raises"})
        else:
            raise AssertionError("berrut_encode_dispatch took more groups "
                                 "than its grid holds")

    def pool_positions(self, b: int, width: int, gen=None, prompt=PROMPT):
        """(B,) int32 ring positions and (B,) uint8 live flags: most
        streams at the depths a ``prompt``-token prompt reaches in 16
        steps,
        plus depth 0, both sides of a 16-key step, mid-ring, the last
        slot, and ring wraps past W; every fifth stream dead."""
        torch = self.torch
        pos = prompt + torch.randint(
            0, STEPS + 1, (b,), generator=self.gen if gen is None else gen,
            device=self.dev)
        special = [0, 15, 16, 137, width - 1, width, 2 * width + 7]
        pos[:len(special)] = torch.tensor(special, device=self.dev)
        live = torch.ones(b, dtype=torch.uint8, device=self.dev)
        live[2::5] = 0
        return pos.to(torch.int32), live

    def dead_rows_zero(self, what: str, out, live) -> None:
        dead = out[live == 0].float()
        if not self.torch.equal(dead, self.torch.zeros_like(dead)):
            raise AssertionError(f"{what}: a dead stream's output is not "
                                 "exactly 0")

    def variants(self):
        """Features off the main path, at small shapes, both dtypes."""
        torch = self.torch
        from repro_torch.core.berrut import CodingConfig, encode_matrix
        from repro_torch.kernels import ops, ref
        for dtype_name in ("float32", "bfloat16"):
            dtype = getattr(torch, dtype_name)
            res = []
            w = encode_matrix(CodingConfig(k=3, s=2, e=1),
                              device=self.dev).float()
            x = self.randn(2, 3, 3, 1000, dtype=dtype)
            res.append(("berrut_apply ragged F=1000, lead dims",
                        ops.berrut_apply(w, x), ref.berrut_apply_ref(w, x)))
            for systematic, masked, v in ((False, (1, 4), 1000),
                                          (True, (0,), 640)):
                cfg = CodingConfig(k=4, s=2, e=0, systematic=systematic)
                m = torch.ones(cfg.num_workers, device=self.dev)
                m[list(masked)] = 0.0
                g = self.randn(3, cfg.num_workers, v, dtype=dtype)
                a = torch.tensor(cfg.alphas, device=self.dev).float()
                bt = torch.tensor(cfg.betas, device=self.dev).float()
                res.append((f"fused_group_decode V={v} shared mask "
                            f"systematic={systematic} masked={masked}",
                            ops.fused_group_decode(g, m, a, bt),
                            ref.fused_group_decode_ref(g, m, a, bt)))
            cfg = CodingConfig(k=4, s=1, e=1)
            g = self.randn(2, cfg.num_workers, 151936, dtype=dtype)
            m = torch.ones(2, cfg.num_workers, device=self.dev)
            m[0, 2] = m[1, 9] = 0.0
            a = torch.tensor(cfg.alphas, device=self.dev).float()
            bt = torch.tensor(cfg.betas, device=self.dev).float()
            (got, gv), (want, wv) = (
                ops.fused_group_decode(g, m, a, bt, c_vote=64),
                ref.fused_group_decode_ref(g, m, a, bt, c_vote=64))
            if not torch.equal(gv, wv):
                raise AssertionError("fused_group_decode vote gather differs")
            res.append(("fused_group_decode V=151936 c_vote=64 gather",
                        got, want))
            # S and L off the kernel's 64-row and 32/64-key tiles
            for hd in (64, 80, 128, 256):
                gen = self.extra_gen if hd == 80 else self.gen
                for kw in (dict(window=37), dict(softcap=20.0),
                           dict(prefix=40), dict(causal=False),
                           dict(q_offset=50)):
                    for s in (100, 77):
                        l_len = s + kw.get("q_offset", 0)
                        q = self.randn(2, s, 8, hd, dtype=dtype, gen=gen)
                        k = self.randn(2, l_len, 2, hd, dtype=dtype, gen=gen)
                        vv = self.randn(2, l_len, 2, hd, dtype=dtype, gen=gen)
                        res.append((f"flash_attention D={hd} S={s} {kw}",
                                    ops.attention(q, k, vv, **kw),
                                    ref.attention_ref(q, k, vv, **kw)))
                # rows before the first key see nothing: guarded zeros
                q = self.randn(1, 20, 4, hd, dtype=dtype, gen=gen)
                k = self.randn(1, 20, 4, hd, dtype=dtype, gen=gen)
                out = ops.attention(q, k, k, q_offset=-5)
                if not torch.equal(out[:, :5].float(),
                                   torch.zeros_like(out[:, :5].float())):
                    raise AssertionError("flash_attention: a row with no "
                                         "visible key is not exactly 0")
                res.append((f"flash_attention D={hd} q_offset=-5 seen rows",
                            out[:, 5:],
                            ref.attention_ref(q, k, k, q_offset=-5)[:, 5:]))
            # the main path's head layout at S = L = 200
            q = self.randn(3, 200, 16, 128, dtype=dtype)
            k = self.randn(3, 200, 8, 128, dtype=dtype)
            vv = self.randn(3, 200, 8, 128, dtype=dtype)
            res.append(("flash_attention D=128 GQA 16/8 S=L=200",
                        ops.attention(q, k, vv),
                        ref.attention_ref(q, k, vv)))
            # h2o-danube's head layout (32/8 heads of 80), causal and with
            # a window shorter than the keys; prefix-LM with softcap
            q = self.randn(3, 200, 32, 80, dtype=dtype, gen=self.extra_gen)
            k = self.randn(3, 200, 8, 80, dtype=dtype, gen=self.extra_gen)
            vv = self.randn(3, 200, 8, 80, dtype=dtype, gen=self.extra_gen)
            for kw in ({}, dict(window=64)):
                res.append((f"flash_attention D=80 GQA 32/8 S=L=200 {kw}",
                            ops.attention(q, k, vv, **kw),
                            ref.attention_ref(q, k, vv, **kw)))
            kw = dict(prefix=40, softcap=20.0)
            res.append((f"flash_attention D=80 GQA 32/8 S=L=200 {kw}",
                        ops.attention(q, k, vv, **kw),
                        ref.attention_ref(q, k, vv, **kw)))
            for hd in (64, 80, 128, 256):
                gen = self.extra_gen if hd == 80 else self.gen
                b, w_len, h, kvh = 3, 300, 8, 2
                q = self.randn(b, h, hd, dtype=dtype, gen=gen)
                kf = self.randn(b, w_len, kvh, hd, gen=gen)
                vf = self.randn(b, w_len, kvh, hd, gen=gen)
                k8 = torch.clamp(torch.round(kf * 32), -127, 127).to(
                    torch.int8)
                v8 = torch.clamp(torch.round(vf * 32), -127, 127).to(
                    torch.int8)
                mask = torch.rand(b, w_len, generator=gen,
                                  device=self.dev) < 0.6
                mask[2] = False               # a row that sees nothing
                got = ops.decode_attention(q, k8, v8, mask, softcap=15.0,
                                           kv_scale=32.0)
                if not torch.equal(got[2].float(),
                                   torch.zeros_like(got[2].float())):
                    raise AssertionError("flash_decode: an all-masked row "
                                         "is not exactly 0")
                # the plain path rounds dequantised caches to q's dtype
                # first; the kernel keeps them in fp32 registers
                want = ref.decode_attention_ref(
                    q, (k8.float() / 32.0).to(dtype),
                    (v8.float() / 32.0).to(dtype), mask, softcap=15.0)
                res.append((f"flash_decode D={hd} rep=4 int8+softcap",
                            got[:2], want[:2]))
                kc, vc = kf.to(dtype), vf.to(dtype)
                row = (torch.arange(w_len, device=self.dev) < 211).to(
                    torch.uint8)[None].expand(b, w_len)
                res.append((f"flash_decode D={hd} broadcast mask row",
                            ops.decode_attention(q, kc, vc, row),
                            ref.decode_attention_ref(q, kc, vc, row)))
                # B5 at other head dims and GQA ratios (MHA, rep 4, MQA),
                # with int8 KV and softcap, dead streams and ring wraps
                for h, kvh in ((8, 8), (8, 2), (8, 1)):
                    q = self.randn(b, h, hd, dtype=dtype, gen=gen)
                    kc = self.randn(b, w_len, kvh, hd, dtype=dtype, gen=gen)
                    vc = self.randn(b, w_len, kvh, hd, dtype=dtype, gen=gen)
                    pos = torch.tensor([0, 150, 2 * w_len + 3],
                                       dtype=torch.int32, device=self.dev)
                    live = torch.tensor([1, 1, 0], dtype=torch.uint8,
                                        device=self.dev)
                    got = ops.pool_decode_attention(q, kc, vc, pos, live)
                    self.dead_rows_zero("pool_flash_decode", got, live)
                    res.append((f"pool_flash_decode D={hd} H={h} KV={kvh}",
                                got, ref.pool_decode_attention_ref(
                                    q, kc, vc, pos, live)))
                    k8 = torch.clamp(torch.round(kc.float() * 32), -127,
                                     127).to(torch.int8)
                    v8 = torch.clamp(torch.round(vc.float() * 32), -127,
                                     127).to(torch.int8)
                    kw = dict(softcap=15.0, kv_scale=32.0)
                    res.append((f"pool_flash_decode D={hd} H={h} KV={kvh} "
                                "int8+softcap, live=None",
                                ops.pool_decode_attention(q, k8, v8, pos,
                                                          **kw),
                                ref.pool_decode_attention_ref(
                                    q, k8, v8, pos, **kw)))
            for what, got, want in res:
                out = {"variant": what}
                out.update(self.check(what, got, want, dtype_name))
                out["dtype"] = dtype_name
                emit(out)

    def decode_split_variants(self):
        """B4 and B5 around their key splits, both dtypes: the E=0 serving
        shapes (20 streams over the 274-slot ring, two splits and the
        combine), B4 at the batch scheduler's decode shapes (22 streams
        at E=1, two splits; 10 at E=0, four), a long ring (W = 4096 at
        B = 2: many splits, most of them empty for a short stream), B5
        with every stream's keys inside the first of the ring's shares, a
        B4 mask whose valid keys lie in one split, an all-masked B4 row
        and dead B5 streams (exact zeros), int8 + softcap and plain caches
        at D = 64, 80, 128 and 256, the multihost serve's 72 x 8 blocks at
        145 keys, which take one split, and head_dim 80 at h2o-danube's
        serving shapes around the splits (``d80_split_variants``)."""
        torch = self.torch
        from repro_torch.configs import qwen3_0_6b
        from repro_torch.core.berrut import CodingConfig
        from repro_torch.kernels import flash_decode, ops, ref
        sms = torch.cuda.get_device_properties(
            self.dev).multi_processor_count
        cfg = qwen3_0_6b.CONFIG
        workers = CodingConfig(k=K, s=S, e=0).num_workers
        e0 = (GROUPS * workers, PROMPT + STEPS + 2, cfg.num_heads,
              cfg.num_kv_heads, cfg.head_dim)
        if flash_decode.plan_splits(e0[0], e0[3], e0[1], sms) < 2:
            raise AssertionError("flash_decode split plan: the E=0 serving "
                                 "shape must take more than one split")
        # (what, streams, the splits the card's plan gives them)
        sched_shapes = [(f"scheduler E={e}", 2 * CodingConfig(
            k=K, s=S, e=e).num_workers) for e in (E, 0)]
        splits = [flash_decode.plan_splits(b, e0[3], e0[1], sms)
                  for _, b in sched_shapes]
        if splits != [2, 4]:
            raise AssertionError(f"flash_decode split plan: the scheduler's "
                                 f"22 and 10 streams take {splits} splits, "
                                 "not 2 and 4")
        for dtype_name in ("float32", "bfloat16"):
            dtype = getattr(torch, dtype_name)
            res = []

            def add(what, b, w, kvh, got, want, tol_rows=None):
                splits = flash_decode.plan_splits(b, kvh, w, sms)
                rows = slice(None) if tol_rows is None else tol_rows
                res.append((f"{what} (splits {splits})", got[rows],
                            want[rows]))

            # the E=0 batch and continuous paths' decode calls: B4 with the
            # batch path's broadcast mask at the last step and with a
            # per-stream mask whose last row sees nothing (exact zeros);
            # B5 with per-group-slot depths and the E=0 live mask (a free
            # slot's streams dead), tiled over each group's K + S workers
            # as the pool step tiles them
            b, w, h, kvh, hd = e0
            q = self.randn(b, h, hd, dtype=dtype)
            kc = self.randn(b, w, kvh, hd, dtype=dtype)
            vc = self.randn(b, w, kvh, hd, dtype=dtype)
            where = f"E=0 B={b} W={w} H={h} KV={kvh} D={hd}"
            last = (torch.arange(w, device=self.dev)
                    <= PROMPT + STEPS - 1).to(torch.uint8)
            mask = last[None, :].expand(b, w)
            add(f"flash_decode {where} broadcast mask", b, w, kvh,
                ops.decode_attention(q, kc, vc, mask),
                ref.decode_attention_ref(q, kc, vc, mask))
            rows = torch.rand(b, w, generator=self.gen,
                              device=self.dev) < 0.5
            rows[-1] = False
            got = ops.decode_attention(q, kc, vc, rows)
            if not torch.equal(got[-1].float(),
                               torch.zeros_like(got[-1].float())):
                raise AssertionError(f"flash_decode {where}: an "
                                     "all-masked row is not exactly 0")
            add(f"flash_decode {where} ragged mask", b, w, kvh, got,
                ref.decode_attention_ref(q, kc, vc, rows), slice(0, b - 1))
            gpos = PROMPT + torch.randint(0, STEPS + 1, (GROUPS,),
                                          generator=self.gen,
                                          device=self.dev)
            gpos[0], gpos[1] = 0, 137        # one key; a shorter prompt
            glive = torch.ones(GROUPS, dtype=torch.uint8, device=self.dev)
            glive[2] = 0
            pos = gpos.to(torch.int32).repeat_interleave(workers)
            live = glive.repeat_interleave(workers)
            for what, lv in (("live=None", None), ("E=0 live mask", live)):
                got = ops.pool_decode_attention(q, kc, vc, pos, lv)
                if lv is not None:
                    self.dead_rows_zero(f"pool_flash_decode {where}", got,
                                        lv)
                add(f"pool_flash_decode {where} {what}", b, w, kvh, got,
                    ref.pool_decode_attention_ref(q, kc, vc, pos, lv))

            # the scheduler's batch decode calls: 2 groups a batch, 22
            # streams at E=1 and 10 at E=0, over the same ring
            for what, b in sched_shapes:
                q = self.randn(b, h, hd, dtype=dtype)
                kc = self.randn(b, w, kvh, hd, dtype=dtype)
                vc = self.randn(b, w, kvh, hd, dtype=dtype)
                where = f"{what} B={b} W={w} H={h} KV={kvh} D={hd}"
                mask = last[None, :].expand(b, w)
                add(f"flash_decode {where} broadcast mask", b, w, kvh,
                    ops.decode_attention(q, kc, vc, mask),
                    ref.decode_attention_ref(q, kc, vc, mask))
                rows = torch.rand(b, w, generator=self.gen,
                                  device=self.dev) < 0.5
                rows[-1] = False
                got = ops.decode_attention(q, kc, vc, rows)
                if not torch.equal(got[-1].float(),
                                   torch.zeros_like(got[-1].float())):
                    raise AssertionError(f"flash_decode {where}: an "
                                         "all-masked row is not exactly 0")
                add(f"flash_decode {where} ragged mask", b, w, kvh, got,
                    ref.decode_attention_ref(q, kc, vc, rows),
                    slice(0, b - 1))

            # (B, W, H, KV, D): the long ring, and the multihost shape
            for b, w, h, kvh, hd in ((2, 4096, 16, 8, 128),
                                     (72, 145, 16, 8, 128)):
                q = self.randn(b, h, hd, dtype=dtype)
                kc = self.randn(b, w, kvh, hd, dtype=dtype)
                vc = self.randn(b, w, kvh, hd, dtype=dtype)
                where = f"B={b} W={w} H={h} KV={kvh} D={hd}"
                mask = torch.rand(b, w, generator=self.gen,
                                  device=self.dev) < 0.5
                mask[0] = torch.arange(w, device=self.dev) <= w - 7
                add(f"flash_decode {where} ring mask", b, w, kvh,
                    ops.decode_attention(q, kc, vc, mask),
                    ref.decode_attention_ref(q, kc, vc, mask))
                # valid keys inside one split's share of the ring; the
                # last stream sees nothing and must give exact zeros
                splits = flash_decode.plan_splits(b, kvh, w, sms)
                lo, hi = (splits // 2 * w // splits,
                          (splits // 2 + 1) * w // splits)
                one = torch.zeros(b, w, dtype=torch.bool, device=self.dev)
                one[:-1, lo + (hi - lo) // 4:lo + (hi - lo) // 2] = True
                got = ops.decode_attention(q, kc, vc, one)
                if not torch.equal(got[-1].float(),
                                   torch.zeros_like(got[-1].float())):
                    raise AssertionError(f"flash_decode {where}: an "
                                         "all-masked row is not exactly 0")
                add(f"flash_decode {where} keys in one split", b, w, kvh,
                    got, ref.decode_attention_ref(q, kc, vc, one),
                    slice(0, b - 1))
                pos = torch.randint(0, 3 * w, (b,), generator=self.gen,
                                    device=self.dev).to(torch.int32)
                pos[:2] = torch.tensor([w - 1, 2 * w + 7], device=self.dev)
                live = torch.ones(b, dtype=torch.uint8, device=self.dev)
                live[1::3] = 0
                got = ops.pool_decode_attention(q, kc, vc, pos, live)
                self.dead_rows_zero(f"pool_flash_decode {where}", got, live)
                add(f"pool_flash_decode {where} wraps and dead streams", b,
                    w, kvh, got,
                    ref.pool_decode_attention_ref(q, kc, vc, pos, live))
                # every stream's keys inside the first split's share of
                # the ring, so that most of its own splits are empty
                short = torch.randint(0, max(1, w // splits), (b,),
                                      generator=self.gen,
                                      device=self.dev).to(torch.int32)
                short[0] = 0
                add(f"pool_flash_decode {where} short streams", b, w, kvh,
                    ops.pool_decode_attention(q, kc, vc, short),
                    ref.pool_decode_attention_ref(q, kc, vc, short))
            # int8 + softcap and plain caches at each head dim, rep 4
            b, w, h, kvh = 2, 4096, 8, 2
            for hd in (64, 80, 128, 256):
                gen = self.extra_gen if hd == 80 else self.gen
                q = self.randn(b, h, hd, dtype=dtype, gen=gen)
                kf = self.randn(b, w, kvh, hd, gen=gen)
                vf = self.randn(b, w, kvh, hd, gen=gen)
                k8 = torch.clamp(torch.round(kf * 32), -127, 127).to(
                    torch.int8)
                v8 = torch.clamp(torch.round(vf * 32), -127, 127).to(
                    torch.int8)
                mask = torch.rand(b, w, generator=gen,
                                  device=self.dev) < 0.3
                pos = torch.tensor([3000, 2 * w + 1], dtype=torch.int32,
                                   device=self.dev)
                kw = dict(softcap=15.0, kv_scale=32.0)
                where = f"B={b} W={w} H={h} KV={kvh} D={hd}"
                # the plain path rounds dequantised caches to q's dtype
                add(f"flash_decode {where} int8+softcap", b, w, kvh,
                    ops.decode_attention(q, k8, v8, mask, **kw),
                    ref.decode_attention_ref(
                        q, (k8.float() / 32.0).to(dtype),
                        (v8.float() / 32.0).to(dtype), mask, softcap=15.0))
                add(f"pool_flash_decode {where} int8+softcap", b, w, kvh,
                    ops.pool_decode_attention(q, k8, v8, pos, **kw),
                    ref.pool_decode_attention_ref(q, k8, v8, pos, **kw))
                kc, vc = kf.to(dtype), vf.to(dtype)
                add(f"flash_decode {where}", b, w, kvh,
                    ops.decode_attention(q, kc, vc, mask),
                    ref.decode_attention_ref(q, kc, vc, mask))
                add(f"pool_flash_decode {where}", b, w, kvh,
                    ops.pool_decode_attention(q, kc, vc, pos),
                    ref.pool_decode_attention_ref(q, kc, vc, pos))
            for what, got, want in res:
                out = {"variant": what, "dtype": dtype_name}
                out.update(self.check(what, got, want, dtype_name))
                emit(out)
        if flash_decode.plan_splits(72, 8, 145, sms) != 1 or \
                flash_decode.plan_splits(2, 8, 4096, sms) < 2:
            raise AssertionError("flash_decode split plan: the multihost "
                                 "shape must take one split, the long ring "
                                 "several")
        self.d80_split_variants(sms)

    def d80_split_variants(self, sms: int):
        """B4 and B5 at head_dim 80, h2o-danube's 32/8 heads over the
        served 274-slot ring, both dtypes, at 1, 2 and 4 key splits (44
        streams at E=1, 20 at E=0, 10 in an E=0 scheduler batch): B4 with
        the broadcast mask at the last step and with a ragged mask whose
        last row sees nothing (exact zeros), B5 at per-stream depths with
        ring wraps and dead streams (exact zeros), and both with int8
        caches and softcap."""
        torch = self.torch
        from repro_torch import configs
        from repro_torch.kernels import flash_decode, ops, ref
        cfg = configs.get_config(D80_ARCH)
        h, kvh, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        w = PROMPT + STEPS + 2
        shapes = (GROUPS * (2 * (K + E) + S), GROUPS * (K + S), 2 * (K + S))
        splits = [flash_decode.plan_splits(b, kvh, w, sms) for b in shapes]
        if splits != [1, 2, 4]:
            raise AssertionError(f"flash_decode split plan at head_dim 80: "
                                 f"{shapes} streams take {splits} splits, "
                                 "not 1, 2 and 4")
        last = (torch.arange(w, device=self.dev)
                <= PROMPT + STEPS - 1).to(torch.uint8)
        for dtype_name in ("float32", "bfloat16"):
            dtype = getattr(torch, dtype_name)
            res = []
            for b, n_split in zip(shapes, splits):
                where = (f"D=80 B={b} W={w} H={h} KV={kvh} (splits "
                         f"{n_split})")
                q = self.randn(b, h, hd, dtype=dtype, gen=self.extra_gen)
                kf = self.randn(b, w, kvh, hd, gen=self.extra_gen)
                vf = self.randn(b, w, kvh, hd, gen=self.extra_gen)
                kc, vc = kf.to(dtype), vf.to(dtype)
                mask = last[None, :].expand(b, w)
                res.append((f"flash_decode {where} broadcast mask",
                            ops.decode_attention(q, kc, vc, mask),
                            ref.decode_attention_ref(q, kc, vc, mask)))
                rows = torch.rand(b, w, generator=self.extra_gen,
                                  device=self.dev) < 0.5
                rows[-1] = False
                got = ops.decode_attention(q, kc, vc, rows)
                if not torch.equal(got[-1].float(),
                                   torch.zeros_like(got[-1].float())):
                    raise AssertionError(f"flash_decode {where}: an "
                                         "all-masked row is not exactly 0")
                res.append((f"flash_decode {where} ragged mask", got[:-1],
                            ref.decode_attention_ref(q, kc, vc,
                                                     rows)[:-1]))
                pos, live = self.pool_positions(b, w, self.extra_gen)
                got = ops.pool_decode_attention(q, kc, vc, pos, live)
                self.dead_rows_zero(f"pool_flash_decode {where}", got, live)
                res.append((f"pool_flash_decode {where} wraps and dead "
                            "streams", got, ref.pool_decode_attention_ref(
                                q, kc, vc, pos, live)))
                k8 = torch.clamp(torch.round(kf * 32), -127, 127).to(
                    torch.int8)
                v8 = torch.clamp(torch.round(vf * 32), -127, 127).to(
                    torch.int8)
                kw = dict(softcap=15.0, kv_scale=32.0)
                # the plain path rounds dequantised caches to q's dtype
                res.append((f"flash_decode {where} int8+softcap",
                            ops.decode_attention(q, k8, v8, rows, **kw)[:-1],
                            ref.decode_attention_ref(
                                q, (k8.float() / 32.0).to(dtype),
                                (v8.float() / 32.0).to(dtype), rows,
                                softcap=15.0)[:-1]))
                res.append((f"pool_flash_decode {where} int8+softcap",
                            ops.pool_decode_attention(q, k8, v8, pos, live,
                                                      **kw),
                            ref.pool_decode_attention_ref(
                                q, k8, v8, pos, live, **kw)))
            for what, got, want in res:
                out = {"variant": what, "dtype": dtype_name}
                out.update(self.check(what, got, want, dtype_name))
                emit(out)

    def ssd_inputs(self, b: int, s: int, h: int, p: int, n: int, dtype,
                   strong: bool = False, gen=None):
        """The scan's inputs as the Mamba2 block hands them over: x, b and
        c strided views of one conv output, dt softplus'd fp32, the
        model's a_log and d_skip.  ``strong``: a = -16 and dt ~ 5, so the
        log decay over a chunk reaches ~ -10^4 and exp(L) underflows."""
        torch = self.torch
        fn = torch.nn.functional
        din = h * p
        xbc = fn.silu(self.randn(b, s, din + 2 * n, gen=gen)).to(dtype)
        dt = fn.softplus(self.randn(b, s, h, gen=gen)
                         + (5.0 if strong else 0.0))
        a_log = torch.log(torch.linspace(1.0, 16.0, h, device=self.dev))
        if strong:
            a_log = torch.full_like(a_log, math.log(16.0))
        return (xbc[..., :din].unflatten(-1, (h, p)), dt, a_log,
                xbc[..., din:din + n], xbc[..., din + n:],
                torch.ones(h, device=self.dev))

    def mamba2_kernels(self, dtype_name: str, cfg=None, table=None,
                       gen=None):
        """B7 at the mamba2 prefill's shapes: 44 coded streams (G=4, K=4,
        S=1, E=1) x 256 steps x 48 heads of 64, state 128; or at ``cfg``'s
        (zamba2: 64 heads of 64, state 64), its fp32 numbers in
        ``table``."""
        torch = self.torch
        from repro_torch.configs import mamba2_780m
        from repro_torch.core.berrut import CodingConfig
        from repro_torch.kernels import ops, ref, ssd_scan
        from repro_torch.models.mamba2 import ssd_chunk
        dtype = getattr(torch, dtype_name)
        size = dtype.itemsize
        cfg = cfg or mamba2_780m.CONFIG
        b = GROUPS * CodingConfig(k=K, s=S, e=E).num_workers
        h, p, n = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
        args = self.ssd_inputs(b, PROMPT, h, p, n, dtype, gen=gen)
        x, dt, a_log, bb, cc, d = args
        chunk = ssd_chunk(cfg.ssm_chunk, PROMPT)
        (y, hf), (yr, hr) = (ops.ssd(*args),
                             ref.ssd_chunked_ref(*args, chunk=chunk))
        out = {"variant": f"ssd_chunked {cfg.name} h_final ({dtype_name})"}
        out.update(self.check(out["variant"], hf, hr, "float32"))
        emit(out)
        # the scores pass alone: C B^T of each of the kernel's chunks (the
        # library call on contiguous copies of the chunked b and c)
        q = ssd_scan.CHUNK
        nc = -(-PROMPT // q)
        cb = cc.contiguous().view(b, nc, q, n)
        bt = bb.contiguous().view(b, nc, q, n).transpose(-1, -2)
        self.record(
            "ssd_chunk_scores", dtype_name, [list(bb.shape), [q, q]],
            ops.ssd_chunk_scores(bb, cc),
            ref.ssd_chunk_scores_ref(bb, cc, q),
            lambda: ops.ssd_chunk_scores(bb, cc),
            lambda: ref.ssd_chunk_scores_ref(bb, cc, q),
            lambda: torch.matmul(cb, bt),
            2 * bb.numel() * size + b * nc * q * q * 4,
            2 * b * nc * q * q * n, table=table)
        self.record(
            "ssd_chunked", dtype_name, [list(x.shape), list(bb.shape)],
            y, yr, lambda: ops.ssd(*args),
            lambda: ref.ssd_chunked_ref(*args, chunk=chunk), None,
            2 * x.numel() * size + hf.numel() * 4 + 2 * bb.numel() * size
            + dt.numel() * 4 + 2 * h * 4,
            ssd_ops(b, PROMPT, h, p, n), table=table)

    def mamba2_variants(self):
        """B7 off the main shape, and B2 at mamba2's vocabulary with the
        vote gather, both dtypes (B2 is timed there by
        ``group_decode_kernels``)."""
        torch = self.torch
        from repro_torch.core.berrut import CodingConfig
        from repro_torch.kernels import ops, ref
        from repro_torch.models.mamba2 import ssd_chunk
        h, p, n = 48, 64, 128
        for dtype_name in ("float32", "bfloat16"):
            dtype = getattr(torch, dtype_name)
            res = []
            # (what, (B, S, H, P, N), strong decay)
            for what, shape, strong in (
                    ("S=200 (plain chunk 8)", (3, 200, h, p, n), False),
                    ("S=12", (3, 12, h, p, n), False),
                    ("S=1", (3, 1, h, p, n), False),
                    ("strong decay", (3, 256, h, p, n), True),
                    ("B=1 H=1", (1, 64, 1, p, n), False),
                    ("B=3 H=5", (3, 96, 5, p, n), False),
                    ("P=32 N=16", (2, 40, 4, 32, 16), False)):
                args = self.ssd_inputs(*shape, dtype, strong=strong)
                chunk = ssd_chunk(128, shape[1])
                (y, hf), (yr, hr) = (ops.ssd(*args, chunk=chunk),
                                     ref.ssd_chunked_ref(*args, chunk=chunk))
                res.append((f"ssd_chunked {what} y", y, yr, dtype_name))
                res.append((f"ssd_chunked {what} h_final", hf, hr,
                            "float32"))
            # h0: the second half started from the first half's state
            args = self.ssd_inputs(4, PROMPT, h, p, n, dtype)
            y, hf = ops.ssd(*args)
            half = PROMPT // 2
            first = [a[:, :half] if a.dim() > 1 else a for a in args]
            second = [a[:, half:] if a.dim() > 1 else a for a in args]
            y1, h1 = ops.ssd(*first)
            y2, h2 = ops.ssd(*second, h0=h1)
            y2r, h2r = ref.ssd_chunked_ref(*second, h0=h1, chunk=half)
            res += [("ssd_chunked h0 second half y", y2, y2r, dtype_name),
                    ("ssd_chunked h0 second half h_final", h2, h2r,
                     "float32"),
                    ("ssd_chunked h0 halves = one pass y",
                     torch.cat([y1, y2], 1), y, dtype_name),
                    ("ssd_chunked h0 halves = one pass h_final", h2, hf,
                     "float32")]
            # B2 over mamba2's vocabulary (50280)
            cfg = CodingConfig(k=K, s=S, e=E)
            g = self.randn(GROUPS, cfg.num_workers, 50280, dtype=dtype)
            m = torch.ones(GROUPS, cfg.num_workers, device=self.dev)
            for gi, out in zip(range(GROUPS), (2, 9, 0, 10)):
                m[gi, out] = 0.0                  # one straggler a group
            a = torch.tensor(cfg.alphas, device=self.dev).float()
            bt = torch.tensor(cfg.betas, device=self.dev).float()
            (got, gv), (want, wv) = (
                ops.fused_group_decode(g, m, a, bt, c_vote=64),
                ref.fused_group_decode_ref(g, m, a, bt, c_vote=64))
            if not torch.equal(gv, wv):
                raise AssertionError("fused_group_decode V=50280 vote "
                                     "gather differs")
            res.append(("fused_group_decode V=50280 c_vote=64 per-group "
                        "masks", got, want, dtype_name))
            for what, got, want, tol_dtype in res:
                out = {"variant": what, "dtype": dtype_name}
                out.update(self.check(what, got, want, tol_dtype))
                emit(out)

    def hybrid_moe_kernels(self, dtype_name: str):
        """B3, B4, B5 and B7 at zamba2-1.2b's E=1 serving shapes (MHA
        32/32 heads of 64, one q-head a kv-head: the prefill's 44 x 256
        tokens, the batch decode's 274-slot ring at depth 271, the pool
        decode's depths with dead streams; the SSD scan and its scores
        pass at 64 heads of 64, state 64), and B3 / B5 at qwen3-moe-30b-
        a3b's multihost E=1 shapes (GQA 32/4 of 128, eight q-heads a
        kv-head: 8 slots x 18 streams of 128-token prompts, a 256-slot
        ring), checked and timed as the main path's, SDPA as the
        attention kernels' library call.  The kernels line reports
        zamba2's fp32 numbers and qwen3-moe's bf16 ones (the dtype it
        serves in) under each model's name."""
        from repro_torch import configs
        from repro_torch.core.berrut import CodingConfig
        zamba2, moe = (configs.get_config(a) for a in HYBRID_MOE)
        if (zamba2.head_dim, zamba2.num_heads // zamba2.num_kv_heads,
                zamba2.ssm_state, zamba2.ssm_heads) != (64, 1, 64, 64) or (
                moe.num_heads // moe.num_kv_heads, moe.head_dim) != (8, 128):
            raise AssertionError("zamba2 / qwen3-moe shapes changed")
        gen = self.model_gen
        table = self.kernels_model[ZAMBA2]
        self.prefill_kernel(dtype_name, zamba2, table, gen)
        self.decode_kernels(dtype_name, zamba2, table, gen)
        self.mamba2_kernels(dtype_name, zamba2, table, gen)
        table = self.kernels_model[QWEN3_MOE]
        streams = MH_SLOTS * CodingConfig(k=MH_K, s=MH_S, e=E).num_workers
        self.prefill_kernel(dtype_name, moe, table, gen, streams=streams,
                            prompt=MH_PROMPT, keep="bfloat16")
        self.decode_kernels(dtype_name, moe, table, gen, streams=streams,
                            prompt=MH_PROMPT, width=MH_WIDTH,
                            which=("pool_flash_decode",), keep="bfloat16")

    def hybrid_moe_coding(self):
        """The other kernels of the A10 paths against their plain
        versions, both dtypes, untimed: B1 on zamba2's prefill (4, 4,
        256 x 2048) and decode (4, 4, 2048) encodes and B2 on its tails
        (4, 5, 32000) at E=0 with one straggler and (4, 11, 32000) at E=1
        with each group's own decode quorum and a located worker; on the
        qwen3-moe multihost path at E=0 and E=1, B6 on the prefill (8, 7,
        128 x 2048) and decode (8, 7, 2048) encodes, B2 on the worker-
        major view of the (N+1, 8, 151936) tail with every worker
        answering, B3 at the prefill's streams of 128 tokens and B5 at
        the pool decode's.  The inputs come from a generator of their
        own."""
        torch = self.torch
        from repro_torch import configs
        from repro_torch.core.berrut import CodingConfig, encode_matrix, \
            nodes
        from repro_torch.kernels import ops, ref
        gen = torch.Generator(self.dev).manual_seed(5)
        zamba2, moe = (configs.get_config(a) for a in HYBRID_MOE)
        for dtype_name in ("float32", "bfloat16"):
            dtype = getattr(torch, dtype_name)
            res = []
            for e in (0, E):
                coding = CodingConfig(k=K, s=S, e=e)
                n1 = coding.num_workers
                w = encode_matrix(coding, device=self.dev).float()
                for what, f in (("prefill", PROMPT * zamba2.d_model),
                                ("decode", zamba2.d_model)):
                    x = self.randn(GROUPS, K, f, dtype=dtype, gen=gen)
                    res.append((f"berrut_apply {ZAMBA2} E={e} {what} "
                                f"{list(x.shape)}", ops.berrut_apply(w, x),
                                ref.berrut_apply_ref(w, x)))
                alphas, betas = nodes(coding, self.dev)
                masks = torch.zeros(GROUPS, n1, device=self.dev)
                for mask in masks:
                    alive = torch.randperm(n1, generator=gen,
                                           device=self.dev)
                    mask[alive[:coding.decode_quorum]] = 1.0
                    if e:
                        mask[alive[0]] = 0.0          # a located worker
                grouped = self.randn(GROUPS, n1, zamba2.vocab_size,
                                     dtype=dtype, gen=gen)
                res.append((f"fused_group_decode {ZAMBA2} E={e} "
                            f"({GROUPS}, {n1}, {zamba2.vocab_size})",
                            ops.fused_group_decode(grouped, masks, alphas,
                                                   betas),
                            ref.fused_group_decode_ref(grouped, masks, alphas,
                                                       betas)))
            h, kvh, hd = moe.num_heads, moe.num_kv_heads, moe.head_dim
            for e in (0, E):
                coding = CodingConfig(k=MH_K, s=MH_S, e=e)
                n1 = coding.num_workers
                w = encode_matrix(coding, device=self.dev).float()
                for what, f in (("prefill", MH_PROMPT * moe.d_model),
                                ("decode", moe.d_model)):
                    self.b6_check(
                        f"berrut_encode_dispatch {QWEN3_MOE} multihost E={e} "
                        f"{what}", w, self.randn(MH_SLOTS, MH_K, f,
                                                 dtype=dtype, gen=gen),
                        dtype_name)
                alphas, betas = nodes(coding, self.dev)
                block = self.randn(n1, MH_SLOTS, moe.vocab_size, dtype=dtype,
                                   gen=gen)
                every = torch.ones(n1, device=self.dev)
                res.append((f"fused_group_decode {QWEN3_MOE} multihost E={e} "
                            f"worker-major ({MH_SLOTS}, {n1}, "
                            f"{moe.vocab_size})",
                            ops.fused_group_decode(block.transpose(0, 1),
                                                   every, alphas, betas),
                            ref.fused_group_decode_ref(
                                block.transpose(0, 1), every, alphas,
                                betas)))
                b = MH_SLOTS * n1
                q = self.randn(b, MH_PROMPT, h, hd, dtype=dtype, gen=gen)
                k = self.randn(b, MH_PROMPT, kvh, hd, dtype=dtype, gen=gen)
                v = self.randn(b, MH_PROMPT, kvh, hd, dtype=dtype, gen=gen)
                res.append((f"flash_attention {QWEN3_MOE} multihost E={e} "
                            f"B={b} S={MH_PROMPT}", ops.attention(q, k, v),
                            ref.attention_ref(q, k, v)))
                del q, k, v
                qd = self.randn(b, h, hd, dtype=dtype, gen=gen)
                kc = self.randn(b, MH_WIDTH, kvh, hd, dtype=dtype, gen=gen)
                vc = self.randn(b, MH_WIDTH, kvh, hd, dtype=dtype, gen=gen)
                pos, live = self.pool_positions(b, MH_WIDTH, gen, MH_PROMPT)
                res.append((f"pool_flash_decode {QWEN3_MOE} multihost E={e} "
                            f"B={b} W={MH_WIDTH}",
                            ops.pool_decode_attention(qd, kc, vc, pos, live),
                            ref.pool_decode_attention_ref(qd, kc, vc, pos,
                                                          live)))
            for what, got, want in res:
                out = {"variant": what, "dtype": dtype_name}
                out.update(self.check(what, got, want, dtype_name))
                emit(out)

    def frontend_kernels(self, dtype_name: str):
        """Every kernel of the frontends' paths at their E=1 serving
        shapes (A10.3), checked and timed as the main path's: at
        paligemma-3b's, B3 over 44 streams of 512 positions (256 patches,
        then 256 text tokens) under prefix-LM at 256 with MQA 8/1 of 256,
        B4 over the 530-slot ring at depth 527 and B5 at per-stream
        depths with dead streams (one kv-head), B1 on the prefill encode
        (4, 4, 512 x 2048) and B2 on the (4, 11, 257216) tail; at
        hubert-xlarge's, B3 over 44 streams of 500 frames, non-causal,
        MHA 16/16 of 80 (the last 64-row tile partial), B1 on (4, 4, 500
        x 1280) and B2 on (4, 11, 504).  SDPA is the attention kernels'
        library call, ``torch.matmul`` B1's.  The kernels line reports
        the fp32 numbers under each model's name."""
        from repro_torch import configs
        pali, audio = (configs.get_config(a) for a in FRONTENDS)
        if (pali.num_heads, pali.num_kv_heads, pali.head_dim,
                pali.num_patches, pali.prefix_lm) != (8, 1, 256, 256, True) \
                or (audio.num_heads, audio.num_kv_heads, audio.head_dim,
                    audio.causal) != (16, 16, 80, False):
            raise AssertionError("paligemma / hubert shapes changed")
        gen = self.front_gen
        seq = pali.num_patches + PROMPT
        table = self.kernels_model[PALIGEMMA]
        self.prefill_kernel(dtype_name, pali, table, gen, prompt=seq)
        self.decode_kernels(dtype_name, pali, table, gen, prompt=seq)
        self.coding_kernels(dtype_name, pali, table, gen, seq)
        table = self.kernels_model[HUBERT]
        self.prefill_kernel(dtype_name, audio, table, gen, prompt=FRAMES)
        self.coding_kernels(dtype_name, audio, table, gen, FRAMES)

    def coding_kernels(self, dtype_name: str, cfg, table, gen, seq: int):
        """B1 and B2 at ``cfg``'s E=1 batch shapes, both timed with their
        operands in rotation past the L2 (as the main path's): B1 on the
        prefill encode (4, 4, seq x d_model), ``torch.matmul`` the library
        call; B2 on the (4, 11, V) tail, each group with a straggler and
        a located worker, beside ``torch.matmul`` of its decode matrices
        (``contraction_ms``; no one call builds them too).  A causal
        model's decode encode (4, 4, d_model) and the E=0 tail (4, 5, V)
        with the shared mask are checked untimed."""
        torch = self.torch
        from repro_torch.core import berrut
        from repro_torch.core.berrut import CodingConfig, encode_matrix, \
            nodes
        from repro_torch.kernels import ops, ref
        dtype = getattr(torch, dtype_name)
        size = dtype.itemsize
        d, v = cfg.d_model, cfg.vocab_size
        coding = CodingConfig(k=K, s=S, e=E)
        n1 = coding.num_workers
        w = encode_matrix(coding, device=self.dev).to(dtype).float()
        xs = self.rotation(lambda: (
            self.randn(GROUPS, K, seq * d, dtype=dtype, gen=gen),))
        turn = itertools.cycle(xs).__next__
        x = xs[0][0]
        f = x.shape[-1]
        self.record(
            "berrut_apply", dtype_name, [list(w.shape), list(x.shape)],
            ops.berrut_apply(w, x), ref.berrut_apply_ref(w, x),
            lambda: ops.berrut_apply(w, *turn()),
            lambda: ref.berrut_apply_ref(w, *turn()),
            lambda: torch.matmul(w.to(dtype), *turn()),
            w.numel() * 4 + (K + n1) * GROUPS * f * size,
            2 * n1 * K * f * GROUPS, extra={"l2_copies": len(xs)},
            table=table)
        del xs, x
        alphas, betas = nodes(coding, self.dev)
        masks = torch.ones(GROUPS, n1, device=self.dev)
        masks[:, 3] = 0.0                          # a straggler
        masks[:, 7] = 0.0                          # a located worker
        blocks = self.rotation(lambda: (
            self.randn(GROUPS, n1, v, dtype=dtype, gen=gen),))
        turn = itertools.cycle(blocks).__next__
        grouped = blocks[0][0]
        dec = torch.stack([berrut.basis_matrix(
            alphas, betas, berrut.survivor_weights(m), mask=m)
            for m in masks]).to(dtype)              # (G, K, N+1)
        self.record(
            "fused_group_decode", dtype_name,
            [list(grouped.shape), list(masks.shape)],
            ops.fused_group_decode(grouped, masks, alphas, betas),
            ref.fused_group_decode_ref(grouped, masks, alphas, betas),
            lambda: ops.fused_group_decode(*turn(), masks, alphas, betas),
            lambda: ref.fused_group_decode_ref(*turn(), masks, alphas,
                                               betas),
            None,
            (n1 + K) * GROUPS * v * size + GROUPS * n1 * 4 + (K + n1) * 4,
            2 * K * n1 * v * GROUPS,
            extra={"l2_copies": len(blocks),
                   "contraction_ms": self.time_ms(
                       lambda: torch.matmul(dec, turn()[0])),
                   "contraction_graph_ms": self.graph_ms(
                       lambda: torch.matmul(dec, turn()[0]))},
            table=table)
        del blocks, grouped
        res = []
        if cfg.causal:
            x = self.randn(GROUPS, K, d, dtype=dtype, gen=gen)
            res.append((f"berrut_apply {cfg.name} decode {list(x.shape)}",
                        ops.berrut_apply(w, x), ref.berrut_apply_ref(w, x)))
        e0 = CodingConfig(k=K, s=S, e=0)
        a0, b0 = nodes(e0, self.dev)
        avail = torch.ones(e0.num_workers, device=self.dev)
        avail[2] = 0.0
        grouped = self.randn(GROUPS, e0.num_workers, v, dtype=dtype, gen=gen)
        res.append((f"fused_group_decode {cfg.name} E=0 "
                    f"{list(grouped.shape)}",
                    ops.fused_group_decode(grouped, avail, a0, b0),
                    ref.fused_group_decode_ref(grouped, avail, a0, b0)))
        for what, got, want in res:
            out = {"variant": what, "dtype": dtype_name}
            out.update(self.check(what, got, want, dtype_name))
            emit(out)

    def expected_launches(self, arch: str, prefills: int, decodes: int,
                          pool: bool, worker_major: bool = False) -> dict:
        """Launches of every kernel over ``prefills`` prefill and
        ``decodes`` decode calls of ``arch``: one encode (B6 when worker-
        major, else B1) and one tail per call, and each call's kernels of
        ``PATH_KERNELS`` (which must agree with the config's pattern)."""
        from repro_torch import configs
        from repro_torch.kernels import ops
        table = PATH_KERNELS[arch]
        if table != pattern_kernels(configs.get_config(arch)):
            raise AssertionError(f"{arch}: PATH_KERNELS {table} is not its "
                                 "layer pattern's")
        out = {name: 0 for name in ops.KERNELS}
        encode = "berrut_encode_dispatch" if worker_major else "berrut_apply"
        out[encode] = out["fused_group_decode"] = prefills + decodes
        for name, count in table["prefill"].items():
            out[name] += count * prefills
        for name, count in table.get("pool_decode" if pool
                                     else "decode", {}).items():
            out[name] += count * decodes
        return out

    @contextlib.contextmanager
    def finite_logits(self, where: str):
        """Hold every round's coded logits (free slots' streams included)
        and decoded logits finite, read once after the run: a device-side
        flag per round, so the run gains no host sync.  The group-major
        tail is watched at ``_finish_round``, the worker-major one at
        ``_finish_round_wm`` (coded) and ``_decode_rows`` (decoded, before
        the sampling on the shard); the first worker-major round's coded
        logits and mask are kept for ``nccl_tail``."""
        torch = self.torch
        from repro_torch.launch import worker_mesh as wm
        from repro_torch.serving import coded_serving as cs
        flags, patched = [], []

        def watch(module, name, tensors):
            real = getattr(module, name)

            def checked(*args, **kw):
                out = real(*args, **kw)
                for t in tensors(args, out):
                    flags.append(torch.isfinite(t).all())
                return out

            patched.append((module, name, real))
            setattr(module, name, checked)

        def coded_wm(args, out):
            if not hasattr(self, "wm_round"):
                self.wm_round = (args[1].clone(), args[2].clone())
            return (args[1],)

        watch(cs, "_finish_round", lambda args, out: (args[1], out[0]))
        watch(cs, "_finish_round_wm", coded_wm)
        watch(wm, "_decode_rows", lambda args, out: (out,))
        try:
            yield
        finally:
            for module, name, real in patched:
                setattr(module, name, real)
        if not (flags and torch.stack(flags).all().item()):
            raise AssertionError(f"{where}: a round's logits are not finite")

    def serve(self, arch: str, e: int, worker_major: bool = False) -> dict:
        """Batch serving with fixed masks through ``serve.run_fixed_masks``
        (all requests one batch, one random straggler a round: the inputs
        its recall-1 check was written for); worker-major with a gather
        width of N+1 (every round's S=1 straggler leaves N survivors)."""
        from repro_torch import configs
        from repro_torch.core.berrut import CodingConfig
        from repro_torch.kernels import ops
        from repro_torch.launch import serve
        from repro_torch.launch.worker_mesh import WorkerShardConfig
        requests = GROUPS * K
        vocab = configs.get_config(arch).vocab_size
        where = (f"{arch} K={K} S={S} E={e}"
                 + (" worker-major" if worker_major else ""))
        wshard = (WorkerShardConfig(gather_width=CodingConfig(
            k=K, s=S, e=e).num_workers) if worker_major else None)
        ops.reset_launch_counts()
        with self.finite_logits(where):
            res = serve.run_fixed_masks(
                arch, reduced=False, requests=requests, k=K, s=S, e=e,
                prompt_len=PROMPT, steps=STEPS, byz_sigma=10.0, seed=0,
                device="cuda", wshard=wshard)
            self.torch.cuda.synchronize()
        launches = ops.launch_counts()
        expected = self.expected_launches(arch, 1, STEPS, pool=False,
                                          worker_major=worker_major)
        emit({"path": where, "launches": launches, "expected": expected})
        if launches != expected:
            raise AssertionError(f"launch counts {launches} != {expected}")
        toks = res["tokens"]
        if toks.shape != (requests, 1 + STEPS) or toks.min() < 0 or \
                toks.max() >= vocab:
            raise AssertionError(f"bad token matrix {toks.shape}")
        if e and not (res["precision"] == 1.0 and res["recall"] == 1.0):
            raise AssertionError(f"locator precision {res['precision']} "
                                 f"recall {res['recall']}")
        emit({"serve": where,
              "streams": GROUPS * (K + S if e == 0 else 2 * (K + e) + S),
              "prefill_ms": res["round_ms"][0],
              "decode_round_ms_mean": sum(res["round_ms"][1:]) / STEPS,
              "total_ms": res["total_ms"],
              "tokens_per_s": res["tokens_per_s"],
              "locator_precision_recall": (
                  [res["precision"], res["recall"]] if e else None)})
        return launches

    def serve_continuous(self, arch: str, e: int,
                         worker_major: bool = False) -> dict:
        """``serve --continuous`` at full width and depth (worker-major at
        the default gather width, the scheduler's K+2E wait-for); launches
        held against the executor's own prefill and decode calls."""
        from repro_torch import configs
        from repro_torch.kernels import ops
        from repro_torch.launch import serve
        from repro_torch.launch.worker_mesh import WorkerShardConfig
        vocab = configs.get_config(arch).vocab_size
        where = (f"{arch} continuous K={K} S={S} E={e}"
                 + (" worker-major" if worker_major else ""))
        ops.reset_launch_counts()
        with self.finite_logits(where):
            res = serve.run(arch, reduced=False, requests=POOL_REQUESTS,
                            k=K, s=S, e=e, prompt_len=PROMPT, steps=STEPS,
                            byz_sigma=10.0, seed=0, device="cuda",
                            continuous=True, pool_groups=POOL_GROUPS,
                            quarantine=e > 0,
                            wshard=(WorkerShardConfig() if worker_major
                                    else None))
            self.torch.cuda.synchronize()
        launches = ops.launch_counts()
        pf, dc = res["prefill_calls"], res["decode_calls"]
        expected = self.expected_launches(arch, pf, dc, pool=True,
                                          worker_major=worker_major)
        emit({"path": where, "launches": launches, "expected": expected})
        if launches != expected or not (pf and dc):
            raise AssertionError(f"{where}: launch counts {launches} != "
                                 f"{expected}")
        budgets = res["budgets"]
        if sorted(res["results"]) != list(range(POOL_REQUESTS)):
            raise AssertionError(f"{where}: requests served "
                                 f"{sorted(res['results'])}")
        for uid, toks in res["results"].items():
            if len(toks) != budgets[uid] or toks.min() < 0 or \
                    toks.max() >= vocab:
                raise AssertionError(f"{where}: request {uid} got "
                                     f"{toks.tolist()}, budget "
                                     f"{budgets[uid]}")
        summary = res["metrics"].summary()
        if e and not (summary["detection_precision"] == 1.0
                      and summary["detection_recall"] == 1.0):
            raise AssertionError(
                f"{where}: locator precision "
                f"{summary['detection_precision']} recall "
                f"{summary['detection_recall']}")
        mid = sum(1 for ev in res["trace"] if ev[0] == "round" and ev[3]
                  and ev[4])
        emit({"serve": where, "pool_groups": POOL_GROUPS,
              "streams": POOL_GROUPS * (K + S if e == 0
                                        else 2 * (K + e) + S),
              "requests": POOL_REQUESTS, "pool_rounds": res["rounds"],
              "rounds_admitting_mid_flight": mid,
              "prefill_calls": pf, "decode_calls": dc,
              "prefill_ms_mean": sum(res["prefill_ms"]) / pf,
              "decode_ms_mean": sum(res["decode_ms"]) / dc,
              "prefill_ms": res["prefill_ms"], "decode_ms": res["decode_ms"],
              "wall_ms": res["wall_ms"], "tokens_per_s": res["tokens_per_s"],
              "event_clock": {k: summary[k] for k in (
                  "p50_ms", "p99_ms", "p50_ttft_ms", "mean_itl_ms",
                  "tokens_per_s", "rounds")},
              "locator_precision_recall": (
                  [summary["detection_precision"],
                   summary["detection_recall"]] if e else None),
              "quarantine_events": summary.get("quarantine_events")})
        if not mid:
            raise AssertionError(f"{where}: no round admitted a group while "
                                 "another decoded")
        return launches

    def serve_scheduler(self, arch: str, e: int,
                        worker_major: bool = False) -> dict:
        """Batch serving through ``serve.run`` at the reference's
        defaults: the event-driven scheduler, batches of 2 groups on a
        5 ms flush deadline at 2000 req/s, every round waiting for the
        decode quorum (K, or K+2E at E=1), worker-major at the default
        gather width.  16 requests make 2 batches of 22 streams, 17
        rounds each.  Launches are held against 2 prefill and 32 decode
        calls, each batch's trace against dispatch, 17 rounds and
        complete; at E=1 the attacker must be located in some round.  The
        locator's precision and recall, the rounds that missed the
        attacker, each round's trigger, the event clock's p50/p99 and
        tokens/s are printed: no recall is asserted, as at the bare
        quorum the reference misses rounds too (ROADMAP C)."""
        from repro_torch import configs
        from repro_torch.core.berrut import CodingConfig
        from repro_torch.kernels import ops
        from repro_torch.launch import serve
        from repro_torch.launch.worker_mesh import WorkerShardConfig
        requests = GROUPS * K
        coding = CodingConfig(k=K, s=S, e=e)
        vocab = configs.get_config(arch).vocab_size
        where = (f"{arch} scheduler K={K} S={S} E={e}"
                 + (" worker-major" if worker_major else ""))
        ops.reset_launch_counts()
        with self.finite_logits(where):
            res = serve.run(arch, reduced=False, requests=requests, k=K,
                            s=S, e=e, prompt_len=PROMPT, steps=STEPS,
                            byz_sigma=10.0, seed=0, device="cuda",
                            wshard=(WorkerShardConfig() if worker_major
                                    else None))
            self.torch.cuda.synchronize()
        launches = ops.launch_counts()
        batches = res["batches"]
        expected = self.expected_launches(arch, len(batches),
                                          len(batches) * STEPS, pool=False,
                                          worker_major=worker_major)
        emit({"path": where, "launches": launches, "expected": expected})
        sizes = [len(b.plan.requests) for b in batches]
        if sizes != [2 * K] * (GROUPS // 2):
            raise AssertionError(f"{where}: batches of {sizes} requests, "
                                 f"not {GROUPS // 2} of {2 * K}")
        if launches != expected:
            raise AssertionError(f"{where}: launch counts {launches} != "
                                 f"{expected}")
        toks = res["tokens"]
        if toks.shape != (requests, 1 + STEPS) or toks.min() < 0 or \
                toks.max() >= vocab:
            raise AssertionError(f"{where}: bad token matrix {toks.shape}")
        metrics = res["metrics"]
        for b in batches:
            events = [ev for ev in res["trace"]
                      if ev[0] != "retune" and ev[1] == b.bid]
            kinds = [ev[0] for ev in events]
            if kinds != ["dispatch"] + ["round"] * (1 + STEPS) + \
                    ["complete"] or [ev[2] for ev in events[1:-1]] != \
                    list(range(1 + STEPS)):
                raise AssertionError(f"{where}: batch {b.bid} trace {kinds}")
            for ev, mask in zip(events[1:-1], b.round_masks):
                if not len(ev[4]) == int(mask.sum()) == coding.decode_quorum:
                    raise AssertionError(
                        f"{where}: batch {b.bid} round {ev[2]} waited for "
                        f"{len(ev[4])} workers, not {coding.decode_quorum}")
        if metrics.degraded_rounds:
            raise AssertionError(f"{where}: degraded rounds without holds")
        attackers = res["attackers"]
        missed = [[b.bid, r] for b in batches
                  for r, (mask, located) in enumerate(zip(
                      b.round_masks, res["located"][b.bid]))
                  if any(mask[w] > 0 and w not in located
                         for w in attackers)]
        if e and not any(w in located for rounds in res["located"]
                         for located in rounds for w in attackers):
            raise AssertionError(f"{where}: the attacker was never located")
        clock = metrics.percentiles()
        emit({"serve": where, "batches": len(batches),
              "streams_per_batch": 2 * coding.num_workers,
              "rounds": sum(len(b.round_masks) for b in batches),
              "wait_for": coding.decode_quorum,
              "locator_precision_recall": (
                  [res["precision"], res["recall"]] if e else None),
              "attacker": attackers, "missed_rounds": missed,
              "trigger_ms": [b.round_waits for b in batches],
              "event_clock": {"p50_ms": clock["p50_ms"],
                              "p99_ms": clock["p99_ms"]},
              # round_ms runs in execution order, the trace's round order
              "prefill_ms": [ms for ms, ev in zip(res["round_ms"], [
                  ev for ev in res["trace"] if ev[0] == "round"])
                  if ev[2] == 0],
              "round_ms_mean": res["total_ms"] / len(res["round_ms"]),
              "total_ms": res["total_ms"],
              "tokens_per_s": res["tokens_per_s"]})
        return launches

    def coded_rounds(self, where: str, cfg, coding, params, inputs: dict,
                     e: int, rounds: int, max_len: int, rng) -> dict:
        """``rounds`` coded rounds of ``cfg`` at full width and depth, as
        ``serve.run_fixed_masks`` runs a text model's, but through the
        round functions on a modality dict: the first round
        ``coded_prefill`` on ``inputs``; later ones ``coded_decode_step``
        on the greedy tokens when ``cfg`` decodes, else ``coded_prefill``
        again (an encoder's coded round).  Each round takes one random
        straggler (from ``rng``) and at E > 0 a persistent attacker at
        sigma 10 (``serve``'s adversary; its noise drawn before the
        round's clock starts).  Every round's logits are held finite
        (``finite_logits``) and the launches against ``PATH_KERNELS``.
        Returns the round times (ms, each ending in a sync), the greedy
        tokens (requests, rounds), the launches and the locator's
        precision and recall against the attacker (None at E=0)."""
        torch = self.torch
        from repro_torch.kernels import ops
        from repro_torch.launch import serve
        from repro_torch.serving import coded_serving as cs
        from repro_torch.serving.failures import make_adversary
        n1, groups = coding.num_workers, GROUPS
        adversary = make_adversary(coding, serve._adversary(
            e, "persistent", 1.0, 10.0, "random", 0))
        round_ms, tokens, verdicts = [], [], []
        ops.reset_launch_counts()
        with self.finite_logits(where):
            for r in range(rounds):
                mask = np.ones(n1, np.float32)
                mask[rng.choice(n1, S, replace=False)] = 0.0
                kw = dict(straggler_mask=torch.from_numpy(mask).to(self.dev),
                          with_report=True)
                attack = adversary.next_round() if adversary else None
                if attack is not None:
                    kw.update(byz_mask=torch.from_numpy(attack.mask).to(
                        self.dev), byz_sigma=attack.sigma,
                        byz_noise=attack.noise(groups, n1, cfg.vocab_size,
                                               self.dev))
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                if r == 0 or not cfg.causal:
                    # an encoder's caches are not read again: the last
                    # round's go before this round's are drawn
                    state = None
                    logits, state, report = cs.coded_prefill(
                        cfg, coding, params, inputs, max_len, **kw)
                else:
                    logits, state, report = cs.coded_decode_step(
                        cfg, coding, params, state, nxt, **kw)
                nxt = logits.argmax(-1)[:, None]
                torch.cuda.synchronize()
                round_ms.append((time.perf_counter() - t0) * 1e3)
                tokens.append(nxt[:, 0].cpu().numpy())
                corrupt = (attack.mask > 0 if attack is not None
                           else np.zeros(n1, bool)) & (mask > 0)
                verdicts.append((report[0].any(0).cpu().numpy(), corrupt))
            del state
        launches = ops.launch_counts()
        decodes = rounds - 1 if cfg.causal else 0
        expected = self.expected_launches(cfg.name, rounds - decodes,
                                          decodes, pool=False)
        emit({"path": where, "launches": launches, "expected": expected})
        if launches != expected:
            raise AssertionError(f"{where}: launch counts {launches} != "
                                 f"{expected}")
        tokens = np.stack(tokens, 1)
        if tokens.min() < 0 or tokens.max() >= cfg.vocab_size:
            raise AssertionError(f"{where}: tokens out of range")
        tp = sum(int((d & c).sum()) for d, c in verdicts)
        fp = sum(int((d & ~c).sum()) for d, c in verdicts)
        fn = sum(int((~d & c).sum()) for d, c in verdicts)
        pr = ([tp / (tp + fp) if tp + fp else None,
               tp / (tp + fn) if tp + fn else None] if e else None)
        if e and pr != [1.0, 1.0]:
            raise AssertionError(f"{where}: locator precision and recall "
                                 f"{pr}")
        return {"round_ms": round_ms, "tokens": tokens,
                "launches": launches, "precision_recall": pr,
                "located": [np.flatnonzero(d).tolist() for d, _ in verdicts]}

    def profile_coded(self, where: str, cfg, params, inputs: dict,
                      max_len: int, gen) -> None:
        """One E=1 coded round of ``cfg`` on ``inputs`` under
        torch.profiler (``profile_call``: its wall time, the profiler's
        host cost included, the device time of its kernels, their share
        of the wall time and the kernels that take most of it), after a
        warm-up, the attacker on worker 5 with noise from ``gen``: the
        prefill (an encoder's whole coded round) and, for a decoder, one
        decode step after it (the same step each call: caches of fixed
        shape).  Each round's host syncs are counted outside the
        profiler (the executors' one sync a round comes after it)."""
        torch = self.torch
        from repro_torch.core.berrut import CodingConfig
        from repro_torch.serving import coded_serving as cs
        coding = CodingConfig(k=K, s=S, e=E)
        n1 = coding.num_workers
        byz = torch.zeros(n1, device=self.dev)
        byz[5] = 1.0
        kw = dict(byz_mask=byz, byz_sigma=10.0, with_report=True,
                  byz_noise=self.randn(GROUPS, n1, cfg.vocab_size, gen=gen))
        box = {}

        def prefill():
            box["state"] = None          # the last call's caches go first
            box["logits"], box["state"], _ = cs.coded_prefill(
                cfg, coding, params, inputs, max_len, **kw)

        prefill()                                           # warm-up
        rounds = {"prefill": prefill}
        if cfg.causal:
            state, nxt = box["state"], box["logits"].argmax(-1)[:, None]
            rounds["decode"] = lambda: cs.coded_decode_step(
                cfg, coding, params, state, nxt, **kw)
            rounds["decode"]()                              # warm-up
        for kind, fn in rounds.items():
            self.profile_call(f"{where} {kind}", fn, self.count_syncs(fn))

    def serve_vlm(self, e: int) -> dict:
        """paligemma-3b at full width and depth (fp32, 18 layers, 2.5e9
        parameters), a fixed-mask coded batch at K=4 S=1 and ``e``: 16
        requests of 256 patch embeddings (1152 wide, numpy seed 0) and
        256 text tokens, ``coded_prefill`` over the 512 positions
        (prefix-LM over the patches) and 16 ``coded_decode_step``s from
        position 512 (``coded_rounds``).  Precision and recall 1 at E=1;
        printed: prefill ms, mean decode ms, tokens/s and the peak
        ``max_memory_allocated``; at E=1 its rounds are then profiled
        (``profile_coded``)."""
        torch = self.torch
        from repro_torch import configs
        from repro_torch.core.berrut import CodingConfig
        from repro_torch.models.model import init_params
        cfg = configs.get_config(PALIGEMMA)
        coding = CodingConfig(k=K, s=S, e=e)
        requests = GROUPS * K
        where = f"{PALIGEMMA} K={K} S={S} E={e}"
        self.free_memory()
        torch.cuda.reset_peak_memory_stats()
        params = init_params(cfg, torch.Generator(self.dev).manual_seed(0),
                             self.dev)
        rng = np.random.RandomState(0)
        inputs = {"patches": rng.randn(requests, cfg.num_patches,
                                       cfg.frontend_dim).astype(np.float32),
                  "tokens": rng.randint(0, cfg.vocab_size,
                                        (requests, PROMPT))}
        inputs = {k: torch.from_numpy(v).to(self.dev)
                  for k, v in inputs.items()}
        seq = cfg.num_patches + PROMPT
        res = self.coded_rounds(where, cfg, coding, params, inputs, e,
                                1 + STEPS, seq + STEPS + 2, rng)
        ms = res["round_ms"]
        emit({"serve": where, "depth": cfg.num_layers,
              "params": cfg.param_count(),
              "streams": GROUPS * coding.num_workers,
              "prefill_positions": seq, "prefill_ms": ms[0],
              "decode_round_ms_mean": sum(ms[1:]) / STEPS,
              "total_ms": sum(ms),
              "tokens_per_s": res["tokens"].size / sum(ms) * 1e3,
              "max_memory_allocated_gb": torch.cuda.max_memory_allocated()
              / 1e9,
              "locator_precision_recall": res["precision_recall"],
              "located": res["located"],
              "tokens": res["tokens"][:4].tolist()})
        if e:
            self.profile_coded(where, cfg, params, inputs, seq + STEPS + 2,
                               self.front_gen)
        return res["launches"]

    def hubert(self):
        """hubert-xlarge's full-depth weights (fp32, 48 layers, 9.5e8
        parameters), drawn on the card once for its runs."""
        from repro_torch import configs
        from repro_torch.models.model import init_params
        cfg = configs.get_config(HUBERT)
        if self.audio_params is None:
            self.free_memory()
            self.audio_params = init_params(
                cfg, self.torch.Generator(self.dev).manual_seed(0), self.dev)
        return cfg, self.audio_params

    def audio_frames(self, cfg) -> np.ndarray:
        """16 requests of 500 frame embeddings (numpy seed 0)."""
        return np.random.RandomState(0).randn(
            GROUPS * K, FRAMES, cfg.frontend_dim).astype(np.float32)

    def serve_audio(self, e: int) -> dict:
        """hubert-xlarge's coded round at full width and depth:
        ``coded_prefill`` on 16 requests of 500 frames at K=4 S=1 and
        ``e``, four calls (``coded_rounds``), each with its own straggler
        and at E=1 the attacker; each call launches B3 48 times (non-
        causal, head_dim 80) and B1 and B2 once.  Precision and recall 1
        at E=1; printed: each call's ms, requests/s, peak memory; at E=1
        a call is then profiled (``profile_coded``)."""
        torch = self.torch
        from repro_torch.core.berrut import CodingConfig
        cfg, params = self.hubert()
        coding = CodingConfig(k=K, s=S, e=e)
        where = f"{HUBERT} coded K={K} S={S} E={e}"
        torch.cuda.reset_peak_memory_stats()
        frames = torch.from_numpy(self.audio_frames(cfg)).to(self.dev)
        res = self.coded_rounds(where, cfg, coding, params,
                                {"frames": frames}, e, AUDIO_CALLS, FRAMES,
                                np.random.RandomState(1))
        ms = res["round_ms"]
        emit({"serve": where, "depth": cfg.num_layers,
              "params": cfg.param_count(),
              "streams": GROUPS * coding.num_workers, "frames": FRAMES,
              "call_ms": ms, "call_ms_mean": sum(ms) / len(ms),
              "requests_per_s": GROUPS * K * len(ms) / sum(ms) * 1e3,
              "max_memory_allocated_gb": torch.cuda.max_memory_allocated()
              / 1e9,
              "locator_precision_recall": res["precision_recall"],
              "located": res["located"]})
        if e:
            self.profile_coded(where, cfg, params, {"frames": frames},
                               FRAMES, self.front_gen)
        return res["launches"]

    def serve_audio_engine(self) -> dict:
        """hubert-xlarge served as the reference serves a black-box model:
        ``EngineExecutor`` over ``predict_fn`` with the Berrut scheme under
        the batch scheduler (``serve``'s scheme path at its rate, groups
        and deadline; K=4 S=1 E=1, a persistent attacker at sigma 10), on
        16 payloads that are the rows of ``embed_inputs`` on frames.  B3
        launched 48 times a ``predict_fn`` call and nothing else; every
        request served with finite logits.  Printed: precision and recall
        (not asserted: at the bare quorum the reference misses rounds
        too, ROADMAP C), dispatch ms, the event clock's p50/p99."""
        from repro_torch.core.scheme import get_scheme
        from repro_torch.kernels import ops
        from repro_torch.launch import serve
        cfg, params = self.hubert()
        where = f"{HUBERT} EngineExecutor K={K} S={S} E={E}"
        ops.reset_launch_counts()
        res = serve._run_scheme(
            cfg, get_scheme("berrut", K, s=S, e=E), params,
            {"frames": self.audio_frames(cfg)},
            serve._adversary(E, "persistent", 1.0, 10.0, "random", 0),
            self.dev, seed=0, groups_per_batch=2, rate_rps=2000.0,
            flush_deadline_ms=5.0, slo_ms=None, quarantine=None, churn=None,
            traffic="poisson", controller=None)
        self.torch.cuda.synchronize()
        launches = ops.launch_counts()
        expected = self.expected_launches(
            HUBERT, len(res["forward_streams"]), 0, pool=False)
        expected["berrut_apply"] = expected["fused_group_decode"] = 0
        emit({"path": where, "launches": launches, "expected": expected})
        if launches != expected:
            raise AssertionError(f"{where}: launch counts {launches} != "
                                 f"{expected}")
        logits = res["logits"]
        if logits.shape != (GROUPS * K, cfg.vocab_size) or \
                not np.isfinite(logits).all():
            raise AssertionError(f"{where}: logits {logits.shape} or "
                                 "non-finite")
        clock = res["metrics"].percentiles()
        emit({"serve": where, "depth": cfg.num_layers, "frames": FRAMES,
              "forward_streams": res["forward_streams"],
              "dispatch_ms": res["dispatch_ms"],
              "precision_recall": [res["precision"], res["recall"]],
              "attacker": res["attackers"], "located": res["located"],
              "event_clock": {"p50_ms": clock["p50_ms"],
                              "p99_ms": clock["p99_ms"]}})
        return launches

    # ------------------------------------------------ card against CPU

    @contextlib.contextmanager
    def host_noise(self):
        """Every attack's noise drawn by the CPU's generator and copied to
        the device: the same noise on both devices."""
        from repro_torch.serving import failures
        real = failures.RoundAttack.noise

        def noise(attack, groups, workers, vocab, device):
            return real(attack, groups, workers, vocab, "cpu").to(device)

        failures.RoundAttack.noise = noise
        try:
            yield
        finally:
            failures.RoundAttack.noise = real

    @contextlib.contextmanager
    def vote_columns(self, columns: list):
        """Record the vote columns of every locate call of the serving
        steps, on the host."""
        from repro_torch.serving import coded_serving as cs
        real = cs.locate_groups

        def locate(betas, vals, avail, **kw):
            columns.append((vals.float().cpu(), avail.float().cpu()))
            return real(betas, vals, avail, **kw)

        cs.locate_groups = locate
        try:
            yield
        finally:
            cs.locate_groups = real

    def verdict_walk(self, where: str, coding, calls: dict,
                     columns: dict, per_batch: bool = False) -> list:
        """Walk the two devices' locate calls in order.  ``calls[device]``:
        tuples whose last item is the (G, N+1) located verdicts (None
        where no locator ran) and whose first is the batch id with
        ``per_batch``; ``columns[device]``: the vote columns of its
        locate calls.  The calls' keys (round, masks) must agree, and so
        must the vote columns, within 1e-4 of max(1, max |cpu|) (the
        whole paths' logits tolerance), on every call whose inputs are
        still the same: before the first differing verdict, or with
        ``per_batch`` before the first of its batch.  A verdict that
        differs between the devices must be explained on each device by
        the exact reading of its own columns
        (``error_locator.exact_tally``): the fp64 verdict, or a near tie
        (ROADMAP C).  Each is printed.  Past a differing verdict the
        inputs differ: the walk stops there, or with ``per_batch`` skips
        that batch's later calls.  Returns (the indices of the calls with
        a differing verdict, {"calls": vote columns compared,
        "worst_err_over_tol": the worst of them})."""
        from repro_torch.core.error_locator import exact_tally
        cols = {dev: iter(c) for dev, c in columns.items()}
        disputes, tainted = [], set()
        compared = {"calls": 0, "worst_err_over_tol": 0.0}
        for i, (a, b) in enumerate(zip(calls["cpu"], calls["cuda"])):
            pair = ({dev: next(cols[dev]) for dev in ("cpu", "cuda")}
                    if a[-1] is not None else None)
            if per_batch and a[0] in tainted:
                continue
            if a[:-1] != b[:-1]:
                raise AssertionError(f"{where}: call {i} ran on {a[:-1]} "
                                     f"on the cpu, {b[:-1]} on the card")
            if a[-1] is None:
                continue
            (vc, ac), (vg, ag) = pair["cpu"], pair["cuda"]
            err = (vg - vc).abs().max().item()
            tol = 1e-4 * max(1.0, vc.abs().max().item())
            if not (self.torch.equal(ag, ac) and err <= tol):
                raise AssertionError(f"{where}: call {i}: vote columns "
                                     f"differ by {err} > {tol}, or their "
                                     "availability differs")
            compared["calls"] += 1
            compared["worst_err_over_tol"] = max(
                compared["worst_err_over_tol"], err / tol)
            disputed = np.flatnonzero((a[-1] != b[-1]).any(0))
            for w in disputed:
                why = {}
                for dev, ver in (("cpu", a[-1]), ("cuda", b[-1])):
                    reading = exact_tally(coding, *pair[dev])
                    located = bool(ver[:, w].any())
                    why[dev] = {"located": located,
                                "exact": int(w) in reading.located,
                                "tally": reading.tally[w],
                                "threshold": reading.threshold,
                                "fp32_moves": reading.moved,
                                "near_tie": reading.near_tie(w),
                                "explained": reading.explains(w, located)}
                emit({"disputed_verdict": where, "call": i,
                      "key": str(a[:-1]), "worker": int(w),
                      "columns_err": err, "columns_tol": tol, **why})
                if not all(r["explained"] for r in why.values()):
                    raise AssertionError(f"{where}: call {i} worker {w}: "
                                         "a verdict off its exact one and "
                                         f"off a near tie {why}")
            if disputed.size:
                disputes.append(i)
                if not per_batch:
                    break
                tainted.add(a[0])
        return disputes, compared

    def two_devices(self, arch: str = "qwen3-0.6b"):
        """(cfg, {device: params}, {device: torch device}) of ``arch`` at
        full width and few layers (``small_model``)."""
        torch = self.torch
        cpu = torch.device("cpu")
        cfg, params = self.small_model(arch, torch.Generator(cpu).manual_seed(3))
        return cfg, params, {"cpu": cpu, "cuda": self.dev}

    def small_model(self, arch: str, gen):
        """(cfg, {"cpu": params, "cuda": params}) of ``arch`` at full width
        and 2 layers (``SMALL``'s pattern for zamba2: "SGSG"), the card's
        weights the CPU's.  They are drawn from ``gen`` on the CPU, except
        for the A10 models': the CPU's truncated-normal draw would take
        minutes for qwen3-moe's 1.8e9 (or paligemma's 527M-entry table),
        so theirs are drawn once on the card (seed 0) and copied to the
        CPU, and shared by their whole paths and full-sequence check."""
        from repro_torch import configs
        from repro_torch.models.model import init_params
        torch = self.torch
        cpu = torch.device("cpu")
        cfg = configs.get_config(arch).with_updates(
            **SMALL.get(arch, dict(num_layers=2)))
        if arch not in HYBRID_MOE + FRONTENDS:
            params = {"cpu": init_params(cfg, gen, cpu)}
            params["cuda"] = _tree_to(params["cpu"], self.dev)
            return cfg, params
        if arch not in self.small_models:
            card = init_params(cfg, torch.Generator(self.dev).manual_seed(0),
                               self.dev)
            self.small_models[arch] = {"cpu": _tree_to(card, cpu),
                                       "cuda": card}
        return cfg, self.small_models[arch]

    @contextlib.contextmanager
    def routes(self, log: list, run: str):
        """Record every MoE router call on the host: (``run``, fp32 router
        logits, top-k expert indices)."""
        from repro_torch.models import moe
        real = moe.router_probs

        def probs(cfg, p, x):
            out = real(cfg, p, x)
            log.append((run, moe.router_logits(p, x).cpu(), out[1].cpu()))
            return out

        moe.router_probs = probs
        try:
            yield
        finally:
            moe.router_probs = real

    def route_walk(self, where: str, log: list, k: int):
        """Hold the card's MoE router calls in ``log`` (run "cuda")
        against the CPU's (run "cpu"), in order: router logits within 1e-4 x max(1, max |cpu|) (the whole
        paths' logits tolerance), and each token's set of top-k experts
        equal wherever its CPU top-k margin (the k-th minus the (k+1)-th
        router logit) is wider than twice that tolerance.  A token inside
        that margin may take another expert on the other device (routing
        is discrete; ROADMAP C): such a route is printed, and as its
        token's output and every later input then differ, the walk ends
        there and returns the call's index (None when every route is
        equal).  Prints the smallest margin seen.  Empties ``log``."""
        torch = self.torch
        calls = {dev: [r[1:] for r in log if r[0] == dev]
                 for dev in ("cpu", "cuda")}
        log.clear()
        if len(calls["cpu"]) != len(calls["cuda"]):
            raise AssertionError(f"{where}: {len(calls['cpu'])} router calls "
                                 f"on the cpu, {len(calls['cuda'])} on the "
                                 "card")
        least, worst = math.inf, 0.0
        for i, ((lc, ic), (lg, ig)) in enumerate(zip(calls["cpu"],
                                                     calls["cuda"])):
            tol = 1e-4 * max(1.0, lc.abs().max().item())
            err = (lg - lc).abs().max().item()
            top = lc.sort(-1, descending=True).values
            margin = (top[..., k - 1] - top[..., k] if lc.shape[-1] > k
                      else torch.full(lc.shape[:-1], math.inf))
            least = min(least, margin.min().item())
            worst = max(worst, err / tol)
            if not err <= tol:
                raise AssertionError(f"{where}: router call {i}: logits "
                                     f"differ by {err} > {tol}")
            differ = (ig.sort(-1).values != ic.sort(-1).values).any(-1)
            if differ.any():
                near = margin[differ]
                emit({"disputed_route": where, "call": i,
                      "tokens": int(differ.sum()), "tol": tol,
                      "margins": near.tolist()[:16],
                      "explained": bool((near <= 2 * tol).all())})
                if not (near <= 2 * tol).all():
                    raise AssertionError(f"{where}: router call {i}: a "
                                         "route differs off a near tie")
                return i
        emit({"routes": where, "router_calls": len(calls["cpu"]),
              "least_topk_margin": least, "err_over_tol": worst,
              "equal": True})
        return None

    def full_sequence(self, arch: str):
        """The full-sequence entry points of ``arch`` at full width and 2
        layers (zamba2: "SGSG"), on the card against the CPU's plain path
        with the same weights and inputs: ``forward``'s logits (its B3 and
        B7 launches counted) and aux (the MoE statistics summed over the
        layers, zero without "M" blocks), ``predict_fn`` on embeddings,
        and ``lm_loss`` without targets (paligemma: over the text after
        its patches; hubert, which has no next token: against per-frame
        targets) and with targets and a loss mask.  paligemma takes one
        request of its 256 patches and 32 tokens, hubert two of 32
        frames.
        Logits within 1e-4 x max(1, max |cpu|) (the whole paths'
        tolerance), greedy tokens equal, losses and aux within 1e-5
        relative (aux: plus 1e-6); with "M" blocks, routes equal
        (``route_walk``) and nothing compared from the first entry point
        whose routes a near tie changed."""
        torch = self.torch
        from repro_torch.kernels import ops
        from repro_torch.models import model
        cfg, params, devs = self.two_devices(arch)
        b = 1 if cfg.modality == "vlm" else 2
        s, t = 32, 8
        rng = np.random.RandomState(7)
        if cfg.modality == "audio":
            t = s                             # a cluster target a frame
            inputs = {"frames": torch.from_numpy(rng.randn(
                b, s, cfg.frontend_dim).astype(np.float32))}
        else:
            inputs = {"tokens": torch.from_numpy(
                rng.randint(0, cfg.vocab_size, (b, s)))}
        targets = torch.from_numpy(rng.randint(0, cfg.vocab_size, (b, t)))
        loss_mask = torch.from_numpy(rng.rand(b, t) < 0.6)
        if cfg.modality == "vlm":
            inputs["patches"] = torch.from_numpy(rng.randn(
                b, cfg.num_patches, cfg.frontend_dim).astype(np.float32))
        losses = {"lm_loss": (inputs if cfg.causal
                              else {**inputs, "targets": targets}),
                  "lm_loss targets, loss_mask": {
                      **inputs, "targets": targets, "loss_mask": loss_mask}}
        emb = model.embed_inputs(cfg, params["cpu"], inputs)
        names = ("forward", "predict_fn", *losses)
        out, log = {}, []
        for dev in ("cpu", "cuda"):
            p, d = params[dev], devs[dev]
            ops.reset_launch_counts()
            with self.routes(log, dev):
                logits, aux = model.forward(cfg, p, _tree_to(inputs, d))
                if dev == "cuda":
                    launched = ops.launch_counts()
                out[dev] = {
                    "forward": logits.float().cpu(),
                    "predict_fn": model.predict_fn(cfg, p)(emb.to(d)).cpu(),
                    **{name: model.lm_loss(cfg, p, _tree_to(batch, d))[0].cpu()
                       for name, batch in losses.items()},
                    "aux": {k: float(v) for k, v in aux.items()}}
        torch.cuda.synchronize()
        expected = {name: 0 for name in launched}
        expected.update(pattern_kernels(cfg)["prefill"])
        where = f"{arch} full sequence, full width, {cfg.layer_pattern}"
        if launched != expected:
            raise AssertionError(f"{where}: forward launched {launched}, "
                                 f"not {expected}")
        moe_layers = cfg.layer_pattern.count("M")
        compared = names
        if moe_layers:
            i = self.route_walk(where, log, cfg.experts_per_token)
            compared = names if i is None else names[:i // moe_layers]
        cpu, gpu = out["cpu"], out["cuda"]
        report = {"full_sequence": where, "tokens": [b, s],
                  "launches": launched, "compared": compared,
                  "aux": [cpu["aux"], gpu["aux"]]}
        if "forward" in compared:
            for key, lc in cpu["aux"].items():
                lg = gpu["aux"][key]
                if not (abs(lg - lc) <= 1e-5 * abs(lc) + 1e-6
                        and (moe_layers or lc == lg == 0.0)):
                    raise AssertionError(f"{where}: aux {key} {lg} on the "
                                         f"card, {lc} on the cpu")
        for name in ("forward", "predict_fn"):
            if name not in compared:
                continue
            lc, lg = cpu[name], gpu[name]
            err = (lg - lc).abs().max().item()
            tol = 1e-4 * max(1.0, lc.abs().max().item())
            if not (lg.shape == lc.shape and err <= tol):
                raise AssertionError(f"{where}: {name} differs by {err} > "
                                     f"{tol}")
            if not torch.equal(lg.argmax(-1), lc.argmax(-1)):
                raise AssertionError(f"{where}: {name} greedy tokens differ")
            report[name] = {"shape": list(lg.shape), "max_abs_err": err,
                            "tol": tol}
        for name in ("lm_loss", "lm_loss targets, loss_mask"):
            if name not in compared:
                continue
            lc, lg = float(cpu[name]), float(gpu[name])
            if not abs(lg - lc) <= 1e-5 * abs(lc):
                raise AssertionError(f"{where}: {name} {lg} on the card, "
                                     f"{lc} on the cpu")
            report[name] = [lc, lg]
        emit(report)

    def whole_scheduler_path(self):
        """The batch scheduler over the LLM executor at full width and 2
        layers, on the card and on the CPU with the same weights, prompts,
        latency seed and noise, at the serve defaults (wait-for K+2E):
        E=1 with a persistent attacker, then ``--adaptive`` (a controller
        with the serve bounds).  Traces equal (up to the round of the
        first disputed verdict under the controller, whose decisions read
        the verdicts), verdicts equal except where ``verdict_walk``
        explains them, decisions made before that round equal, and each
        batch's tokens equal in the columns before its first disputed
        round."""
        torch = self.torch
        from repro_torch.core.berrut import CodingConfig
        from repro_torch.core.scheme import BerrutScheme
        from repro_torch.serving.controller import (ControllerConfig,
                                                    RedundancyController)
        from repro_torch.serving.executor import CodedLLMExecutor
        from repro_torch.serving.failures import AdversaryConfig
        from repro_torch.serving.latency import LatencyModel
        from repro_torch.serving.scheduler import (CodedScheduler,
                                                   SchedulerConfig)
        cfg, params, _ = self.two_devices()
        prompt, steps = 64, 4
        coding = CodingConfig(k=K, s=S, e=E)
        for adaptive, n in ((False, 16), (True, 32)):
            prompts = np.random.RandomState(4).randint(
                0, cfg.vocab_size, (n, prompt)).astype(np.int32)
            runs, columns = {}, {}
            for dev in ("cpu", "cuda"):
                ctrl = (RedundancyController(
                    BerrutScheme(coding), ControllerConfig(
                        window_rounds=8, s_min=0, s_max=S + 1, e_min=0,
                        e_max=E)) if adaptive else None)
                executor = CodedLLMExecutor(
                    cfg, ctrl.max_scheme.coding if adaptive else coding,
                    params[dev], steps=steps, max_len=prompt + steps + 2)
                sched = CodedScheduler(SchedulerConfig(
                    scheme=None if adaptive else BerrutScheme(coding),
                    groups_per_batch=2, flush_deadline_ms=5.0, seed=0,
                    controller=ctrl, adversary=AdversaryConfig(
                        kind="persistent", sigma=10.0, seed=0)),
                    LatencyModel(), executor)
                columns[dev] = []
                with self.host_noise(), self.vote_columns(columns[dev]):
                    sched.run(list(prompts), rate_rps=2000.0)
                torch.cuda.synchronize()
                runs[dev] = sched
            where = ("qwen3-0.6b whole scheduler path"
                     + (" adaptive" if adaptive else ""))
            calls = {dev: scheduler_rounds(runs[dev]) for dev in runs}
            # without a controller the masks do not read the verdicts: a
            # dispute only changes its own batch's later rounds
            disputes, compared = self.verdict_walk(
                where, runs["cpu"].executor.coding, calls, columns,
                per_batch=not adaptive)
            cpu, gpu = runs["cpu"], runs["cuda"]
            if disputes and adaptive:
                upto = [j for j, ev in enumerate(cpu.trace)
                        if ev[0] == "round"][disputes[0]]
                same = gpu.trace[:upto + 1] == cpu.trace[:upto + 1]
            else:
                same = gpu.trace == cpu.trace
            if not same:
                raise AssertionError(f"{where}: traces differ")
            if adaptive:
                dec = [[(d.t_ms, d.round_idx, d.s, d.e, d.num_workers,
                         d.wait_for, d.reason)
                        for d in run.controller.decisions
                        if not disputes or d.round_idx <= disputes[0]]
                       for run in (cpu, gpu)]
                if dec[0] != dec[1]:
                    raise AssertionError(f"{where}: decision logs differ: "
                                         f"{dec}")
            # each batch's token columns before its first disputed round,
            # of the rounds walked (under the controller the walk stops at
            # the first dispute)
            limit = disputes[0] if adaptive and disputes else len(
                calls["cpu"])
            cut = {b.bid: 0 for b in cpu.batches}
            for bid, rnd, *_ in calls["cpu"][:limit]:
                cut[bid] = rnd + 1
            for i in disputes:
                bid, rnd = calls["cpu"][i][:2]
                cut[bid] = min(cut[bid], rnd)
            checked = 0
            for b_cpu, b_gpu in zip(cpu.batches, gpu.batches):
                c = cut[b_cpu.bid]
                for slot, req in enumerate(b_cpu.plan.requests):
                    if not b_cpu.plan.valid[slot]:
                        continue
                    if not np.array_equal(b_gpu.outputs[slot][:c],
                                          b_cpu.outputs[slot][:c]):
                        raise AssertionError(f"{where}: request {req.uid} "
                                             "tokens differ")
                    checked += c
            emit({"whole_scheduler_path": where, "requests": n,
                  "batches": len(cpu.batches), "rounds": len(calls["cpu"]),
                  "disputed_calls": disputes, "tokens_checked": checked,
                  "vote_columns": compared,
                  "decisions": (cpu.controller.decision_log() if adaptive
                                else None),
                  "locator_precision_recall": [
                      [run.metrics.detection_precision(),
                       run.metrics.detection_recall()] for run in (cpu, gpu)]})

    def whole_engine_path(self):
        """``EngineExecutor`` over the 2-layer model's last-position logits
        (the model-agnostic f on coded prompt embeddings; B3 on the card),
        K=4 S=2, on a heavy tail with an SLO so that straggling batches
        are early-decoded at the SLO and corrected: the card against the
        CPU on the same weights and payloads.  Traces equal, outputs
        within the fp32 tolerance, the speculative decodes and corrections
        counted alike."""
        torch = self.torch
        from repro_torch.core.berrut import CodingConfig
        from repro_torch.models.model import embed_inputs, init_caches, \
            prefill
        from repro_torch.serving.latency import LatencyModel
        from repro_torch.serving.scheduler import (CodedScheduler,
                                                   EngineExecutor,
                                                   SchedulerConfig,
                                                   poisson_arrivals)
        cfg, params, devs = self.two_devices()
        coding = CodingConfig(k=K, s=2)
        n, prompt = 24, 32
        tokens = torch.from_numpy(np.random.RandomState(5).randint(
            0, cfg.vocab_size, (n, prompt)))
        emb = embed_inputs(cfg, params["cpu"], {"tokens": tokens}).numpy()
        runs = {}
        for dev in ("cpu", "cuda"):
            def predict(x, _p=params[dev], _d=devs[dev]):
                caches = init_caches(cfg, x.shape[0], x.shape[1],
                                     torch.float32, _d)
                return prefill(cfg, _p, {"embeddings": x}, caches)[0]

            sched = CodedScheduler(
                SchedulerConfig(coding=coding, groups_per_batch=1,
                                flush_deadline_ms=2.0, slo_ms=14.0, seed=0),
                LatencyModel(tail_prob=0.3),
                EngineExecutor(predict, coding, device=devs[dev]))
            metrics = sched.run(list(emb), poisson_arrivals(n, 8000.0,
                                                            seed=1))
            torch.cuda.synchronize()
            runs[dev] = (sched, metrics)
        (cpu, mc), (gpu, mg) = runs["cpu"], runs["cuda"]
        where = "qwen3-0.6b whole EngineExecutor path"
        if gpu.trace != cpu.trace:
            raise AssertionError(f"{where}: traces differ")
        worst = 0.0
        for out in ("results", "spec_results"):
            a, b = getattr(cpu, out), getattr(gpu, out)
            if sorted(a) != sorted(b):
                raise AssertionError(f"{where}: {out} keys differ")
            for uid in a:
                err = float(np.abs(b[uid] - a[uid]).max())
                tol = 1e-4 * max(1.0, float(np.abs(a[uid]).max()))
                worst = max(worst, err / tol)
                if not err <= tol:
                    raise AssertionError(f"{where}: {out}[{uid}] differs by "
                                         f"{err} > {tol}")
        counts = [(m.speculative_decodes, m.corrections) for m in (mc, mg)]
        if counts[0] != counts[1] or not counts[0][0] or not counts[0][1]:
            raise AssertionError(f"{where}: speculative decodes and "
                                 f"corrections (cpu, cuda) {counts}")
        emit({"whole_engine_path": where, "requests": n,
              "batches": len(cpu.batches), "speculative_decodes":
              counts[0][0], "corrections": counts[0][1],
              "worst_err_over_tol": worst})

    def whole_pool_controller_path(self):
        """``serve --adaptive --continuous --quarantine`` at full width and
        2 layers: the slot pool under the serve's controller, a persistent
        attacker and quarantine, on the card and on the CPU with the same
        weights, prompts, budgets, latency seed and noise.  The same rules
        as ``whole_scheduler_path``: verdicts equal except where
        ``verdict_walk`` explains them; traces, decisions and round widths
        equal up to the round of the first disputed verdict; every
        request's tokens equal when there is none."""
        torch = self.torch
        from repro_torch.core.berrut import CodingConfig
        from repro_torch.core.scheme import BerrutScheme
        from repro_torch.serving.continuous import (ContinuousConfig,
                                                    ContinuousLLMExecutor,
                                                    ContinuousScheduler)
        from repro_torch.serving.controller import (ControllerConfig,
                                                    RedundancyController)
        from repro_torch.serving.failures import AdversaryConfig
        from repro_torch.serving.latency import LatencyModel
        from repro_torch.serving.quarantine import QuarantineConfig
        cfg, params, _ = self.two_devices()
        prompt, steps, n = 32, 8, 24
        coding = CodingConfig(k=K, s=S, e=E)
        rng = np.random.RandomState(6)
        prompts = rng.randint(0, cfg.vocab_size, (n, prompt)).astype(np.int32)
        budgets = rng.randint(1, steps + 1, size=n)
        runs, calls, columns = {}, {}, {}
        for dev in ("cpu", "cuda"):
            ctrl = RedundancyController(BerrutScheme(coding), ControllerConfig(
                window_rounds=8, s_min=0, s_max=S + 1, e_min=0, e_max=E))
            executor = ContinuousLLMExecutor(
                cfg, ctrl.max_scheme.coding, params[dev], pool_groups=2,
                max_len=prompt + steps + 2)
            sched = ContinuousScheduler(ContinuousConfig(
                pool_groups=2, flush_deadline_ms=5.0, seed=0,
                adversary=AdversaryConfig(kind="persistent", sigma=10.0,
                                          seed=0),
                quarantine=QuarantineConfig(probation_ms=200.0),
                controller=ctrl, max_new_tokens=steps), LatencyModel(),
                executor)
            calls[dev], columns[dev] = [], []
            with self.host_noise(), self.vote_columns(columns[dev]), \
                    self.pool_calls(executor, calls[dev]):
                sched.run(list(prompts), rate_rps=2000.0,
                          max_new_tokens=budgets)
            torch.cuda.synchronize()
            runs[dev] = sched
        where = "qwen3-0.6b whole pool path adaptive quarantine"
        disputes, compared = self.verdict_walk(
            where, ctrl.max_scheme.coding, calls, columns)
        first = disputes[0] if disputes else None
        cpu, gpu = runs["cpu"], runs["cuda"]
        rounds = [ev[1] for ev in cpu.trace if ev[0] == "round"
                  for _ in range(bool(ev[3]) + bool(ev[4]))]
        r = None if first is None else rounds[first]
        if r is None:
            same = gpu.trace == cpu.trace and gpu.round_widths == \
                cpu.round_widths and all(np.array_equal(
                    gpu.results[u], cpu.results[u]) for u in cpu.results)
        else:
            upto = [i for i, ev in enumerate(cpu.trace)
                    if ev[0] == "round"][r]
            same = (gpu.trace[:upto + 1] == cpu.trace[:upto + 1] and
                    gpu.round_widths[:r + 1] == cpu.round_widths[:r + 1])
        if not same:
            raise AssertionError(f"{where}: traces, round widths or tokens "
                                 "differ")
        dec = [[(d.t_ms, d.round_idx, d.s, d.e, d.num_workers, d.wait_for,
                 d.reason) for d in run.controller.decisions
                if r is None or d.round_idx <= r] for run in (cpu, gpu)]
        if dec[0] != dec[1]:
            raise AssertionError(f"{where}: decision logs differ: {dec}")
        m = cpu.metrics
        emit({"whole_pool_controller_path": where, "requests": n,
              "pool_rounds": cpu.rounds_run, "first_disputed_call": first,
              "vote_columns": compared,
              "round_widths": sorted(set(cpu.round_widths)),
              "decisions": cpu.controller.decision_log(),
              "quarantines": m.quarantine_events,
              "locator_precision_recall": [
                  [run.metrics.detection_precision(),
                   run.metrics.detection_recall()] for run in (cpu, gpu)]})

    def scheme_faceoff(self) -> dict:
        """The redundancy schemes other than Berrut (``FACEOFF``) through
        ``serve.run(scheme=...)`` at full width and depth: qwen3-0.6b, 16
        requests of 256 tokens, K=4, ``serve.run``'s rate, groups and
        deadline, each prompt embedded once and ``predict_fn`` (B3 in every
        layer) over each scheme's worker streams.  Held: every request
        served, every served logit finite, B3 launched exactly layers x
        ``predict_fn`` calls and no other kernel, and the exact schemes'
        logits within 1e-4 x max(1, max |clean|) of the clean model's (one
        ``predict_fn`` batch of the 16 embeddings on the card), their
        greedy tokens equal wherever the clean top-2 margin is wider.
        Printed: agreement with the clean tokens, overhead, dispatch wall
        times, the event clock's p50/p99, and NeRCC's precision, recall
        and pooled tallies.  Then B3 at the path's stream counts, and the
        2-layer model card against CPU.  Returns B3's launches by run."""
        torch = self.torch
        from repro_torch.kernels import ops
        from repro_torch.launch import serve
        from repro_torch.models.model import embed_inputs, predict_fn
        arch, requests = "qwen3-0.6b", GROUPS * K
        layers = PATH_KERNELS[arch]["prefill"]["flash_attention"]
        # the weights and prompts serve.run draws, served clean in one batch
        _, cfg, _, _, _, params, prompts = serve._setup(
            arch, False, requests, K, S, 0, PROMPT, 0, self.dev,
            "persistent", "poisson", 1, 1.0)
        emb = embed_inputs(cfg, params, {"tokens": torch.as_tensor(
            prompts, device=self.dev)})
        clean = predict_fn(cfg, params)(emb).cpu().numpy()
        del params, emb
        self.free_memory()
        tol = 1e-4 * max(1.0, float(np.abs(clean).max()))
        top2 = np.sort(clean, -1)[:, -2:]
        sure = top2[:, 1] - top2[:, 0] > tol
        clean_tokens = clean.argmax(-1)
        launches = {}
        for name, s, e in FACEOFF:
            where = f"{arch} scheme {name} S={s} E={e}"
            ops.reset_launch_counts()
            res = serve.run(arch, reduced=False, requests=requests, k=K,
                            s=s, e=e, prompt_len=PROMPT, steps=STEPS,
                            byz_sigma=10.0, seed=0, device="cuda",
                            scheme=name)
            torch.cuda.synchronize()
            counts = ops.launch_counts()
            expected = {kernel: 0 for kernel in ops.KERNELS}
            expected["flash_attention"] = layers * len(res["forward_streams"])
            if counts != expected:
                raise AssertionError(f"{where}: launch counts {counts} != "
                                     f"{expected}")
            logits, metrics = res["logits"], res["metrics"]
            if metrics.count != requests or logits.shape != clean.shape or \
                    not np.isfinite(logits).all():
                raise AssertionError(f"{where}: {metrics.count} requests "
                                     f"served, logits {logits.shape}, or "
                                     f"non-finite")
            err = float(np.abs(logits - clean).max())
            tokens = res["tokens"][:, 0]
            if (name, e) in EXACT_SCHEMES and (
                    not err <= tol
                    or (tokens[sure] != clean_tokens[sure]).any()):
                raise AssertionError(f"{where}: logits off the clean model "
                                     f"by {err} (tolerance {tol}) or greedy "
                                     f"tokens differ past the margin")
            batches = res["batches"]
            tallies = [None if b.round_reports[-1] is None
                       else {"pooled": b.round_reports[-1].votes[0].tolist(),
                             "half": b.dispatch_plan.groups * min(
                                 cfg.vocab_size, 64) / 2}
                       for b in batches]
            clock = metrics.percentiles()
            scheme = batches[0].scheme
            emit({"scheme_faceoff": where, "workers": scheme.num_workers,
                  "overhead": scheme.overhead,
                  "wait_for": scheme.decode_quorum,
                  "forward_streams": res["forward_streams"],
                  "dispatch_ms": res["dispatch_ms"],
                  "agreement": float(np.mean(tokens == clean_tokens)),
                  "max_abs_err_vs_clean": err, "tolerance": tol,
                  "stragglers": res["stragglers"],
                  "attacker": res["attackers"], "located": res["located"],
                  "precision_recall": ([res["precision"], res["recall"]]
                                       if e else None),
                  "pooled_tallies": tallies,
                  "event_clock": {"p50_ms": clock["p50_ms"],
                                  "p99_ms": clock["p99_ms"]},
                  "launches": counts["flash_attention"]})
            launches[f"{name} E={e}"] = counts["flash_attention"]
            del res
            self.free_memory()
        self.scheme_attention()
        self.scheme_two_devices()
        return launches

    def scheme_attention(self):
        """B3 against its plain version at the scheme path's stream counts
        (``SCHEME_STREAMS`` x 256 tokens, qwen3's 16/8 heads of 128), both
        dtypes, timed; the fp32 entries go to the kernels line."""
        from repro_torch.configs import qwen3_0_6b
        for dtype_name in ("float32", "bfloat16"):
            for streams in SCHEME_STREAMS:
                self.prefill_kernel(
                    dtype_name, qwen3_0_6b.CONFIG,
                    self.kernels_scheme.setdefault(streams, {}),
                    self.scheme_gen, streams=streams)

    def scheme_two_devices(self):
        """NeRCC and Coded-InvNet at E=0 and NeRCC at E=1 (a persistent
        attacker at sigma 10, the same noise on both devices) through the
        scheme path at full width and 2 layers, 16 requests of 32 tokens,
        on the card and on the CPU with the same weights and prompts:
        traces equal, located sets equal on every batch whose pooled
        tallies all lie more than one vote from half the coordinates
        (others printed), and the served logits of batches with equal
        verdicts within 1e-4 x max(1, max |cpu|)."""
        from repro_torch.core.scheme import get_scheme
        from repro_torch.launch import serve
        cfg, params, devs = self.two_devices()
        prompts = np.random.RandomState(6).randint(0, cfg.vocab_size,
                                                   (GROUPS * K, 32))
        for name, e in (("nercc", 0), ("invnet", 0), ("nercc", E)):
            where = f"qwen3-0.6b 2-layer scheme {name} E={e}"
            runs = {}
            for dev in ("cpu", "cuda"):
                with self.host_noise():
                    runs[dev] = serve._run_scheme(
                        cfg, get_scheme(name, K, s=S, e=e), params[dev],
                        {"tokens": prompts}, serve._adversary(
                            e, "persistent", 1.0, 10.0, "random", 0),
                        devs[dev],
                        seed=0, groups_per_batch=2, rate_rps=2000.0,
                        flush_deadline_ms=5.0, slo_ms=None, quarantine=None,
                        churn=None, traffic="poisson", controller=None)
            cpu, gpu = runs["cpu"], runs["cuda"]
            if gpu["trace"] != cpu["trace"]:
                raise AssertionError(f"{where}: traces differ")
            worst, disputed = 0.0, []
            for bc, bg in zip(cpu["batches"], gpu["batches"]):
                rc, rg = bc.round_reports[-1], bg.round_reports[-1]
                same = rc is None or np.array_equal(rc.located, rg.located)
                if rc is not None:
                    half = bc.dispatch_plan.groups * min(cfg.vocab_size,
                                                         64) / 2
                    clear = (np.abs(rc.votes[0] - half) > 1).all() and \
                        (np.abs(rg.votes[0] - half) > 1).all()
                    if not same and clear:
                        raise AssertionError(
                            f"{where}: batch {bc.bid} located "
                            f"{np.flatnonzero(rg.located[0]).tolist()} on "
                            f"the card, {np.flatnonzero(rc.located[0])}"
                            f" on the CPU, tallies {rg.votes[0].tolist()} / "
                            f"{rc.votes[0].tolist()} against {half}")
                    if not same:
                        disputed.append({"batch": bc.bid,
                                         "cuda": rg.votes[0].tolist(),
                                         "cpu": rc.votes[0].tolist(),
                                         "half": half})
                        continue
                for req in bc.plan.requests:
                    a, b = cpu["logits"][req.uid], gpu["logits"][req.uid]
                    t = 1e-4 * max(1.0, float(np.abs(a).max()))
                    err = float(np.abs(b - a).max())
                    worst = max(worst, err / t)
                    if not err <= t:
                        raise AssertionError(f"{where}: request {req.uid} "
                                             f"differs by {err} > {t}")
            emit({"scheme_two_devices": where,
                  "batches": len(cpu["batches"]),
                  "located": [cpu["located"], gpu["located"]],
                  "worst_err_over_tol": worst, "disputed": disputed})

    @contextlib.contextmanager
    def pool_calls(self, executor, log: list):
        """Log each slot-pool call's (kind, straggler mask, group mask,
        located) on ``executor``."""
        real = {kind: getattr(executor, kind) for kind in ("prefill",
                                                            "decode")}

        def wrap(kind):
            def call(state, tokens, group_mask, mask, *a, **kw):
                out = real[kind](state, tokens, group_mask, mask, *a, **kw)
                log.append((kind, np.asarray(mask).tolist(),
                            np.asarray(group_mask).tolist(),
                            None if out[2] is None
                            else np.asarray(out[2].located)))
                return out
            return call

        for kind in real:
            setattr(executor, kind, wrap(kind))
        try:
            yield
        finally:
            for kind in real:
                delattr(executor, kind)

    # ------------------------------------------------- training (A11)

    def b3_backward(self, dtype_name: str):
        """B3's backward kernel and the forward's row log-sum-exp against
        their plain versions (``ref.attention_bwd_ref``, given the
        kernel's own output and log-sum-exp, and ``ref.attention_lse_ref``;
        in fp32 also autograd of the plain forward ``ref.attention_ref``),
        at qwen3-0.6b's training shape (8 sequences of 128 tokens, GQA
        16/8 of 128, causal) and at 4 x 2048, timed: the kernel (``ms``,
        ``graph_ms``), its plain version, and, as a yardstick only, the
        backward of autograd through SDPA with the same causal mask
        (``library_ms``).  The bound counts 10 D flops a visible (row,
        key) pair (S, dP, dq, dk and dv: five products) against q, k, v,
        o, dO and the log-sum-exp read once and dq, dk, dv written once.
        Then, untimed, every rule at every head dim (64, 80, 128, 256) and
        GQA ratio 1, 2 and 8: h2o-danube's window at D = 80, paligemma's
        prefix-LM at D = 256 rep 8, softcap, q_offset, and rows that see
        no key (q_offset -5: their dq exactly 0, their log-sum-exp -inf,
        as the plain version's)."""
        torch = self.torch
        from repro_torch import configs
        from repro_torch.kernels import flash_attention as fa, ref
        dtype = getattr(torch, dtype_name)
        gen = self.train_gen
        cfg = configs.get_config(TRAIN_ARCH)
        h, kvh, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        sdpa = torch.nn.functional.scaled_dot_product_attention
        for key, (b, s) in (("train", (TRAIN_BATCH, TRAIN_SEQ)),
                            ("long", LONG_SHAPE)):
            q = self.randn(b, s, h, hd, dtype=dtype, gen=gen)
            k = self.randn(b, s, kvh, hd, dtype=dtype, gen=gen)
            v = self.randn(b, s, kvh, hd, dtype=dtype, gen=gen)
            do = self.randn(b, s, h, hd, dtype=dtype, gen=gen)
            where = f"flash_attention_bwd B={b} S={s} H={h} KV={kvh} D={hd}"
            res = {"kernel": "flash_attention_bwd", "dtype": dtype_name,
                   "shape": [list(q.shape), list(k.shape)], "causal": True}
            res.update(self.b3_backward_checks(where, dtype_name, q, k, v,
                                               do, {}))
            out, lse = fa.flash_attention(q, k, v, return_lse=True)
            res["ms"] = self.time_ms(
                lambda: fa.flash_attention_bwd(q, k, v, out, lse, do))
            res["graph_ms"] = self.graph_ms(
                lambda: fa.flash_attention_bwd(q, k, v, out, lse, do))
            res["plain_ms"] = self.time_ms(
                lambda: ref.attention_bwd_ref(q, k, v, out, lse, do))
            qs, ks, vs = (t.transpose(1, 2).detach().requires_grad_(True)
                          for t in (q, k, v))
            so = sdpa(qs, ks, vs, is_causal=True, enable_gqa=True)
            dos = do.transpose(1, 2)
            res["library_ms"] = self.time_ms(lambda: torch.autograd.grad(
                so, (qs, ks, vs), dos, retain_graph=True))
            pairs = visible_pairs(s, causal=True, window=None, prefix=0)
            res["bound_ms"], res["bound_by"] = self.bound(
                4 * (q.numel() + k.numel()) * dtype.itemsize
                + 4 * lse.numel(), 10 * hd * pairs * b * h, dtype_name)
            res["pairs"] = pairs
            emit(res)
            if dtype_name == "float32":
                self.kernels_train[key] = res
            del so, qs, ks, vs
        # every rule, head dim and GQA ratio, untimed
        cases = []
        for d in fa.HEAD_DIMS:
            for heads in ((8, 8), (8, 4), (8, 1)):
                for kw in (dict(window=37), dict(softcap=20.0),
                           dict(prefix=40), dict(causal=False),
                           dict(q_offset=50), dict(q_offset=-5),
                           dict(prefix=30, window=45, softcap=10.0)):
                    cases.append((2, 100, *heads, d, kw))
        h2o = configs.get_config("h2o-danube-1.8b")
        pali = configs.get_config("paligemma-3b")
        cases += [(2, 200, h2o.num_heads, h2o.num_kv_heads, h2o.head_dim,
                   dict(window=64)),
                  (1, 2 * pali.num_patches, pali.num_heads,
                   pali.num_kv_heads, pali.head_dim,
                   dict(prefix=pali.num_patches)),
                  (3, 77, h, kvh, hd, {})]
        for b, s, hh, kk, d, kw in cases:
            l_len = s + kw.get("q_offset", 0)
            q = self.randn(b, s, hh, d, dtype=dtype, gen=gen)
            k = self.randn(b, l_len, kk, d, dtype=dtype, gen=gen)
            v = self.randn(b, l_len, kk, d, dtype=dtype, gen=gen)
            do = self.randn(b, s, hh, d, dtype=dtype, gen=gen)
            where = f"flash_attention_bwd B={b} S={s} H={hh} KV={kk} D={d}"
            out = {"variant": f"{where} {kw}", "dtype": dtype_name}
            out.update(self.b3_backward_checks(where, dtype_name, q, k, v,
                                               do, kw))
            emit(out)

    def b3_backward_checks(self, where: str, dtype_name: str, q, k, v, do,
                           rule: dict) -> dict:
        """dq, dk, dv and the log-sum-exp of B3 against their plain
        versions under ``rule`` (and, in fp32 with every row seeing a key,
        against autograd of the plain forward), each with ``check``'s
        tolerance; a row that sees no key must have a -inf log-sum-exp and
        an exactly zero dq on the card.  Returns the worst error and its
        ratio to the tolerance."""
        torch = self.torch
        from repro_torch.kernels import flash_attention as fa, ref
        out, lse = fa.flash_attention(q, k, v, return_lse=True, **rule)
        want_lse = ref.attention_lse_ref(q, k, **rule)
        torch.cuda.synchronize()
        blind = torch.isneginf(want_lse)
        if not torch.equal(torch.isneginf(lse), blind):
            raise AssertionError(f"{where} {rule}: the log-sum-exp's -inf "
                                 f"rows differ from the plain version's")
        seen = ~blind
        results = [self.check(f"{where} lse {rule}", lse[seen],
                              want_lse[seen], "float32")]
        got = fa.flash_attention_bwd(q, k, v, out, lse, do, **rule)
        want = ref.attention_bwd_ref(q, k, v, out, lse, do, **rule)
        for name, g, w in zip(("dq", "dk", "dv"), got, want):
            results.append(self.check(f"{where} {name} {rule}", g, w,
                                      dtype_name))
        if blind.any():
            rows = blind.all(1)                       # (B, S): no key seen
            if got[0][rows].abs().max().item() != 0.0:
                raise AssertionError(f"{where} {rule}: dq of a row that "
                                     f"sees no key is not exactly 0")
        elif dtype_name == "float32":
            args = [t.detach().requires_grad_(True) for t in (q, k, v)]
            auto = torch.autograd.grad(ref.attention_ref(*args, **rule),
                                       args, do)
            for name, g, w in zip(("dq", "dk", "dv"), got, auto):
                results.append(self.check(
                    f"{where} {name} {rule} vs autograd", g, w, dtype_name))
        worst = max(results, key=lambda r: r["err_over_tol"])
        return {"max_abs_err": max(r["max_abs_err"] for r in results),
                "err_over_tol": worst["err_over_tol"]}

    def b7_backward(self, dtype_name: str):
        """B7's backward (``ssd_chunked_bwd``: the kernel and its head sum)
        against its plain version ``ref.ssd_chunked_bwd_ref`` at
        mamba2-780m's and zamba2-1.2b's training shapes (8 sequences of
        128 steps; 48 heads of 64, state 128, and 64 heads of 64, state
        64), the inputs as the Mamba2 block hands them over (x, b and c
        strided views of one conv output), over ``BWD_DRAWS`` draws of
        each variant: with and without h0 and a gradient of h_final, S of
        1, 31, 33 (short last chunks) and 2048 (2 sequences), and strong
        decay; in fp32 at the training shape also against autograd of the
        plain forward.  Each output under ``BWD_TOL`` (fp32) or ``check``'s
        bf16 rule; the worst share of its tolerance is printed.  Timed at
        each training shape: the kernel (both launches; ``ms``,
        ``graph_ms``), the plain version, and the head sum alone with its
        plain version and ``torch.sum`` over the heads (``library_ms``);
        no library call computes the scan's gradient."""
        torch = self.torch
        from repro_torch import configs
        from repro_torch.kernels import ref, ssd_scan
        from repro_torch.models.mamba2 import ssd_chunk
        dtype = getattr(torch, dtype_name)
        gen = self.bwd_gen
        worst = {}
        for arch in TRAIN_SSM:
            cfg = configs.get_config(arch)
            h, p, n = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
            b0, s0 = TRAIN_BATCH, TRAIN_SEQ
            # (what, B, S, h0, dh_final, strong decay)
            for what, b, s, with_h0, with_dh, strong in (
                    ("train", b0, s0, False, False, False),
                    ("h0", b0, s0, True, False, False),
                    ("dh_final", b0, s0, False, True, False),
                    ("h0 dh_final", b0, s0, True, True, False),
                    ("strong decay", b0, s0, True, True, True),
                    ("S=1", b0, 1, True, True, False),
                    ("S=31", b0, 31, True, True, False),
                    ("S=33", b0, 33, False, True, False),
                    ("S=2048", 2, 2048, True, True, False)):
                where = (f"ssd_chunked_bwd {arch} {what} B={b} S={s} H={h} "
                         f"P={p} N={n}")
                chunk = ssd_chunk(cfg.ssm_chunk, s)
                shares = []
                for _ in range(BWD_DRAWS):
                    args = self.ssd_inputs(b, s, h, p, n, dtype,
                                           strong=strong, gen=gen)
                    dy = self.randn(b, s, h, p, dtype=dtype, gen=gen)
                    h0 = self.randn(b, h, p, n, gen=gen) if with_h0 else None
                    dh = self.randn(b, h, p, n, gen=gen) if with_dh else None
                    got = ssd_scan.ssd_chunked_bwd(*args, dy, h0=h0,
                                                   dh_final=dh)
                    want = ref.ssd_chunked_bwd_ref(*args, dy, h0=h0,
                                                   dh_final=dh, chunk=chunk)
                    res = self.bwd_checks(where, dtype_name, got, want, worst)
                    if what == "train" and dtype_name == "float32":
                        leaves = [t.detach().requires_grad_(True)
                                  for t in args]
                        y, _ = ref.ssd_chunked_ref(*leaves, chunk=chunk)
                        auto = torch.autograd.grad(y, leaves, dy)
                        res = max(res, self.bwd_checks(
                            f"{where} vs autograd", dtype_name, got[:6],
                            auto, worst), key=lambda r: r["err_over_tol"])
                    shares.append(res["err_over_tol"])
                emit({"variant": where, "dtype": dtype_name,
                      "draws": BWD_DRAWS, "err_over_tol": max(shares),
                      "err_over_tol_draws": shares})
                if what == "train":
                    self.b7_backward_repeat(where, args, dy, got)
                    emit({"b7_backward_occupancy": arch,
                          "dtype": dtype_name, "P": p, "N": n,
                          **ssd_scan.bwd_info(p, n, dtype, self.dev)})
                    res = self.b7_backward_timing(arch, dtype_name, args,
                                                  dy, chunk, got, want)
                    self.b7_backward_bytes(arch, args, res)
        b, s, h = BWD_CORNER_SHAPE
        chunk = ssd_chunk(128, s)
        for p, n in BWD_CORNERS:
            where = (f"ssd_chunked_bwd corner B={b} S={s} H={h} P={p} "
                     f"N={n} h0 dh_final")
            shares = []
            for _ in range(BWD_DRAWS):
                args = self.ssd_inputs(b, s, h, p, n, dtype, gen=gen)
                dy = self.randn(b, s, h, p, dtype=dtype, gen=gen)
                h0 = self.randn(b, h, p, n, gen=gen)
                dh = self.randn(b, h, p, n, gen=gen)
                got = ssd_scan.ssd_chunked_bwd(*args, dy, h0=h0, dh_final=dh)
                want = ref.ssd_chunked_bwd_ref(*args, dy, h0=h0, dh_final=dh,
                                               chunk=chunk)
                shares.append(self.bwd_checks(where, dtype_name, got, want,
                                              worst)["err_over_tol"])
            emit({"variant": where, "dtype": dtype_name, "draws": BWD_DRAWS,
                  "err_over_tol": max(shares), "err_over_tol_draws": shares,
                  **ssd_scan.bwd_info(p, n, dtype, self.dev)})
        # S = 0 (no chunk): dh0 is dh_final as it came, the sums are zero
        args = self.ssd_inputs(b, 0, h, 64, 128, dtype, gen=gen)
        dh = self.randn(b, h, 64, 128, gen=gen)
        got = ssd_scan.ssd_chunked_bwd(
            *args, self.randn(b, 0, h, 64, dtype=dtype, gen=gen),
            h0=self.randn(b, h, 64, 128, gen=gen), dh_final=dh)
        torch.cuda.synchronize()
        if not (torch.equal(got[6], dh) and not got[2].any()
                and not got[5].any() and got[0].shape == (b, 0, h, 64)
                and got[3].shape == (b, 0, 128)):
            raise AssertionError("ssd_chunked_bwd at S = 0: dh0 is not "
                                 "dh_final or a sum is not zero")
        emit({"variant": f"ssd_chunked_bwd S=0 B={b} H={h} P=64 N=128",
              "dtype": dtype_name, "dh0_is_dh_final": True})
        emit({"b7_backward_worst": dtype_name, "draws": BWD_DRAWS,
              "tol": BWD_TOL, "err_over_tol": worst})

    def b7_backward_ab(self, dtype_name: str) -> None:
        """B7's backward at both training shapes, checked against its plain
        version and timed (``b7_backward_timing``), on inputs from a
        generator of its own: what ``scripts/flash_decode_ab.py --kernel
        ssd_chunked_bwd`` runs on each checkout."""
        from repro_torch import configs
        from repro_torch.kernels import ref, ssd_scan
        from repro_torch.models.mamba2 import ssd_chunk
        dtype = getattr(self.torch, dtype_name)
        gen = self.torch.Generator(self.dev).manual_seed(12)
        for arch in TRAIN_SSM:
            cfg = configs.get_config(arch)
            h, p, n = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
            b, s = TRAIN_BATCH, TRAIN_SEQ
            chunk = ssd_chunk(cfg.ssm_chunk, s)
            args = self.ssd_inputs(b, s, h, p, n, dtype, gen=gen)
            dy = self.randn(b, s, h, p, dtype=dtype, gen=gen)
            got = ssd_scan.ssd_chunked_bwd(*args, dy)
            want = ref.ssd_chunked_bwd_ref(*args, dy, chunk=chunk)
            self.bwd_checks(f"ssd_chunked_bwd {arch} train", dtype_name, got,
                            want, {})
            self.b7_backward_timing(arch, dtype_name, args, dy, chunk, got,
                                    want)

    def b7_backward_repeat(self, where: str, args, dy, got) -> None:
        """A second call of B7's backward on the inputs that gave ``got``
        (no h0, no gradient of h_final) gives every output bitwise as the
        first did (no atomics, one order of sums)."""
        from repro_torch.kernels import ssd_scan
        again = ssd_scan.ssd_chunked_bwd(*args, dy)
        names = ("dx", "ddt", "da_log", "db", "dc", "dd", "dh0")
        for name, g, w in zip(names, again, got):
            if g is not None and not self.torch.equal(g, w):
                raise AssertionError(f"{where} {name}: two calls on the "
                                     f"same inputs differ")
        emit({"b7_backward_repeat": where, "bitwise_equal": True})

    def bwd_checks(self, where: str, dtype_name: str, got, want,
                   worst: dict) -> dict:
        """B7's backward outputs ``got`` (dx, ddt, da_log, db, dc, dd[,
        dh0]) against ``want``: finite, the same dtype, an fp32 output
        within ``BWD_TOL`` x max(1, max |want|) and a bf16 one under
        ``check``'s bf16 rule.  Keeps each output's worst share of its
        tolerance in ``worst``; returns the worst of this call."""
        torch = self.torch
        torch.cuda.synchronize()
        out = {"err_over_tol": 0.0, "max_abs_err": 0.0}
        names = ("dx", "ddt", "da_log", "db", "dc", "dd", "dh0")
        for name, g, w in zip(names, got, want):
            if g is None and w is None:
                continue
            if g.dtype != w.dtype:
                raise AssertionError(f"{where} {name}: dtype {g.dtype}, "
                                     f"plain {w.dtype}")
            if g.dtype == torch.bfloat16:
                res = self.check(f"{where} {name}", g, w, "bfloat16")
            else:
                g, w = g.float(), w.float()
                if g.shape != w.shape or not torch.isfinite(g).all():
                    raise AssertionError(f"{where} {name}: shape "
                                         f"{tuple(g.shape)} or non-finite")
                kind = "sums" if name in ("da_log", "dd") else "grads"
                tol = BWD_TOL[kind] * max(1.0, w.abs().max().item())
                err = (g - w).abs().max().item()
                res = {"max_abs_err": err, "err_over_tol": err / tol}
                if not err <= tol:
                    raise AssertionError(f"{where} {name}: max abs err "
                                         f"{err} > {tol}")
            worst[name] = max(worst.get(name, 0.0), res["err_over_tol"])
            out["max_abs_err"] = max(out["max_abs_err"], res["max_abs_err"])
            out["err_over_tol"] = max(out["err_over_tol"],
                                      res["err_over_tol"])
        return out

    def b7_backward_timing(self, arch: str, dtype_name: str, args, dy,
                           chunk: int, got, want) -> None:
        """Time B7's backward at a training shape (no h0, no gradient of
        h_final, as in training) and its head sum alone; the fp32 numbers
        go to ``kernels_ssd_train``."""
        from repro_torch.kernels import ref, ssd_scan
        x, dt, a_log, bb, cc, d = args
        b, s, h, p = x.shape
        n = bb.shape[-1]
        size = x.dtype.itemsize
        res = {"kernel": "ssd_chunked_bwd", "arch": arch,
               "dtype": dtype_name,
               "shape": [list(x.shape), list(bb.shape)]}
        res["ms"] = self.time_ms(
            lambda: ssd_scan.ssd_chunked_bwd(*args, dy))
        res["graph_ms"] = self.graph_ms(
            lambda: ssd_scan.ssd_chunked_bwd(*args, dy))
        res["plain_ms"] = self.time_ms(
            lambda: ref.ssd_chunked_bwd_ref(*args, dy, chunk=chunk))
        res["library_ms"] = None
        # x, dy, b, c, dt, a_log, D read and dx, ddt, db, dc, d a_log, dD
        # written once
        nbytes = 3 * x.numel() * size + 4 * bb.numel() * size \
            + 2 * dt.numel() * 4 + 4 * h * 4
        res["bound_ms"], res["bound_by"] = self.bound(
            nbytes, ssd_bwd_ops(b, s, h, p, n), dtype_name)
        res["max_abs_err"] = max((g.float() - w.float()).abs().max().item()
                                 for g, w in zip(got, want) if g is not None)
        emit(res)
        parts = self.randn(2, b, h, s, n, gen=self.bwd_gen)
        hs = {"kernel": "ssd_bwd_head_sum", "arch": arch,
              "dtype": dtype_name, "shape": [list(parts.shape)]}
        pair = ssd_scan.ssd_bwd_head_sum(parts, x.dtype)
        want = ref.ssd_bwd_head_sum_ref(parts, x.dtype)
        hs.update(max(
            (self.check("ssd_bwd_head_sum", g, w, dtype_name)
             for g, w in zip(pair, want)),
            key=lambda r: r["err_over_tol"]))
        hs["ms"] = self.time_ms(
            lambda: ssd_scan.ssd_bwd_head_sum(parts, x.dtype))
        hs["graph_ms"] = self.graph_ms(
            lambda: ssd_scan.ssd_bwd_head_sum(parts, x.dtype))
        hs["plain_ms"] = self.time_ms(
            lambda: ref.ssd_bwd_head_sum_ref(parts, x.dtype))
        hs["library_ms"] = self.time_ms(lambda: parts.sum(2))
        hs["bound_ms"], hs["bound_by"] = self.bound(
            parts.numel() * 4 + 2 * b * s * n * size, parts.numel(),
            dtype_name)
        emit(hs)
        if dtype_name == "float32":
            self.kernels_ssd_train["ssd_chunked_bwd", arch] = res
            self.kernels_ssd_train["ssd_bwd_head_sum", arch] = hs
        return res

    def b7_backward_bytes(self, arch: str, args, res: dict) -> None:
        """The device-memory bytes of the backward's first launch at a
        training shape (no h0), the scratches included, against its graph
        time: x, dy, dt, b and c read once and dx and ddt written once; the
        states scratch written and read back once, every chunk's entry
        state but the first's (zero without h0); the db / dc partials
        written once (the head sum reads them)."""
        x, dt, _, bb, _, _ = args
        b, s, h, p = x.shape
        n = bb.shape[-1]
        size = x.dtype.itemsize
        chunks = -(-s // 32)
        io = 3 * x.numel() * size + 2 * bb.numel() * size \
            + 2 * dt.numel() * 4
        states = 2 * b * h * (chunks - 1) * p * n * 4
        partials = 2 * b * h * s * n * 4
        total = io + states + partials
        emit({"b7_backward_bytes": arch, "dtype": res["dtype"],
              "inputs_outputs": io, "states_scratch": states,
              "partials": partials, "total": total,
              "graph_ms": res["graph_ms"],
              "tb_per_s": total / (res["graph_ms"] * 1e-3) / 1e12,
              "at_hbm_ms": total / HBM_BYTES_PER_S * 1e3})

    def train_batch(self, cfg) -> dict:
        """The numpy batch of a card-against-CPU training step: TRAIN_BATCH
        sequences of TRAIN_SEQ tokens (``SyntheticLMDataset``); the vlm's
        TRAIN_FRONT_BATCH of its patch embeddings and TRAIN_VLM_TEXT text
        tokens, and the audio frontend's TRAIN_FRONT_BATCH of FRAMES
        frames with a target a frame (``synthetic_batch``, the reference's
        batch of each modality)."""
        from repro_torch.configs.shapes import ShapeConfig
        from repro_torch.data import SyntheticLMDataset, synthetic_batch
        rng = np.random.RandomState(1)
        if cfg.modality == "vlm":
            shape = ShapeConfig("t", cfg.num_patches + TRAIN_VLM_TEXT,
                                TRAIN_FRONT_BATCH, "train")
        elif cfg.modality == "audio":
            shape = ShapeConfig("t", FRAMES, TRAIN_FRONT_BATCH, "train")
        else:
            return SyntheticLMDataset(cfg.vocab_size, TRAIN_SEQ,
                                      seed=0).batch(TRAIN_BATCH, rng)
        return synthetic_batch(cfg, shape, rng)

    def train_card_vs_cpu(self, arch: str):
        """One ``train_step`` of ``arch`` at full width and 2 layers
        (``TRAIN_SMALL``'s depth for the SSM models: mamba2 2 "S", zamba2
        "SSSSSG"), card against CPU, on the same weights (drawn on the
        card and copied) and the same batch (``train_batch``) at the
        launcher's optimizer settings: loss, grad norm and lr within 1e-4
        relative; every leaf's clipped gradient (the first moment over
        1 - b1) within 1e-4 x the leaf's max |grad| (the whole paths'
        tolerance); updated parameters within 1e-5 |p| + 0.02 lr where
        the CPU's gradient clears 100 x that tolerance, else within Adam's
        sign-flip bound 2 lr (1 + wd |p|) (ROADMAP C); launches: one
        forward and one backward of each kernel a layer
        (``train_launches``).  An MoE model's router calls are held
        (``route_walk``); should a near tie change a route, it is
        printed and the step's outputs are not compared."""
        torch = self.torch
        from repro_torch import configs
        from repro_torch.kernels import ops
        from repro_torch.models.model import init_params
        from repro_torch.optim import init_opt_state
        from repro_torch.training import train_step
        from repro_torch.tree import flatten_with_path, keystr
        self.free_memory()
        cfg = configs.get_config(arch).with_updates(
            **TRAIN_SMALL.get(arch, dict(num_layers=2)))
        tcfg = self.train_config(TRAIN_STEPS)
        params = {"cuda": init_params(
            cfg, torch.Generator(self.dev).manual_seed(0), self.dev)}
        params["cpu"] = _tree_to(params["cuda"], torch.device("cpu"))
        batch = self.train_batch(cfg)
        where = (f"{arch} {cfg.layer_pattern}, full width, "
                 f"{ {k: list(v.shape) for k, v in batch.items()} }")
        out, log = {}, []
        devs = {"cpu": torch.device("cpu"), "cuda": self.dev}
        for dev in ("cpu", "cuda"):
            p = params[dev]
            ops.reset_launch_counts()
            with self.routes(log, dev):
                new_p, new_o, m = train_step(
                    cfg, tcfg, p, init_opt_state(p),
                    {k: torch.from_numpy(v).to(devs[dev])
                     for k, v in batch.items()})
            launched = ops.launch_counts()
            out[dev] = (new_p, new_o, {k: float(x) for k, x in m.items()})
        torch.cuda.synchronize()
        expected = {name: 0 for name in launched}
        expected.update(train_launches(cfg, 1, False))
        if launched != expected:
            raise AssertionError(f"{where} card train_step launched "
                                 f"{launched}, not {expected}")
        if "M" in cfg.layer_pattern and self.route_walk(
                f"{where} train_step", log, cfg.experts_per_token) is not None:
            emit({"train_step_card_vs_cpu": where, "compared": False,
                  "why": "a near tie changed an expert route"})
            return
        (cp, co, cm), (gp, go, gm) = out["cpu"], out["cuda"]
        for key in ("loss", "ce_loss", "grad_norm", "lr"):
            if not abs(gm[key] - cm[key]) <= 1e-4 * abs(cm[key]):
                raise AssertionError(f"{where} train_step {key}: card "
                                     f"{gm[key]}, cpu {cm[key]}")
        b1, lr = tcfg.optimizer.b1, cm["lr"]
        wd = tcfg.optimizer.weight_decay
        before = {keystr(k): t for k, t in flatten_with_path(params["cpu"])}
        gmu = {keystr(k): t.cpu() for k, t in flatten_with_path(go.mu)}
        gnew = {keystr(k): t.cpu() for k, t in flatten_with_path(gp)}
        worst_g = worst_p = 0.0
        strong = total = 0
        for (path, mu), (_, newp) in zip(flatten_with_path(co.mu),
                                         flatten_with_path(cp)):
            key = keystr(path)
            g_cpu, g_card = mu / (1 - b1), gmu[key] / (1 - b1)
            tol = 1e-4 * max(g_cpu.abs().max().item(), 1e-30)
            worst_g = max(worst_g, (g_card - g_cpu).abs().max().item() / tol)
            p0 = before[key].abs()
            diff = (gnew[key] - newp).abs()
            if not (diff <= 2 * lr * (1 + wd * p0) + 1e-6).all():
                raise AssertionError(f"{where} train_step {key}: an updated "
                                     f"parameter past 2 lr (1 + wd |p|)")
            sure = g_cpu.abs() > 100 * tol
            strict = 1e-5 * newp.abs() + 0.02 * lr
            if sure.any():
                worst_p = max(worst_p, (diff[sure] / strict[sure]).max()
                              .item())
            strong += int(sure.sum())
            total += sure.numel()
        if not (worst_g <= 1.0 and worst_p <= 1.0):
            raise AssertionError(f"{where} train_step card vs cpu: "
                                 f"gradients at {worst_g} and strict "
                                 f"parameters at {worst_p} of their "
                                 f"tolerances")
        emit({"train_step_card_vs_cpu": where, "compared": True,
              "loss": [cm["loss"], gm["loss"]],
              "grad_norm": [cm["grad_norm"], gm["grad_norm"]],
              "grads_err_over_tol": worst_g,
              "strict_params_err_over_tol": worst_p,
              "strict_share": strong / total, "launches": launched})
        del params, out
        self.free_memory()

    def train_config(self, steps: int):
        """The launcher's optimizer settings (``launch.train.run``): the
        reference's default lr 3e-3, warmup 20, cosine over ``steps``."""
        from repro_torch.optim import OptimizerConfig
        from repro_torch.training import TrainConfig
        return TrainConfig(optimizer=OptimizerConfig(
            learning_rate=TRAIN_LR, warmup_steps=20, total_steps=steps))

    def train_full(self, arch: str, remat: bool) -> dict:
        """``launch.train.run`` on ``arch`` at full width and depth (fp32;
        qwen3-0.6b 28 layers with its tied 151936-token table, mamba2-780m
        48 "S", zamba2-1.2b 32 "S" and the shared block at 6 "G"
        positions) at the reference's defaults (8 x 128 tokens, AdamW at
        lr 3e-3, warmup 20) for ``TRAIN_STEPS`` steps, with or without
        ``remat``: every loss finite, the ms a step after the first,
        tokens/s, peak ``max_memory_allocated``, and the launches held
        exactly (``train_launches``: each forward kernel once a layer a
        step, twice under remat, which launches each block's forward
        again; each backward kernel once; nothing else).  ``peak_gb`` is
        the whole run's ``max_memory_allocated``, set-up included;
        ``step_peaks_gb`` each step's apart, beside what the card held
        before the run.  Returns the launches and the losses."""
        torch = self.torch
        from repro_torch import configs
        from repro_torch.kernels import ops
        from repro_torch.launch import train as launch_train
        self.free_memory()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        history, step_peaks, before = [], [], [0]
        step = launch_train.train_step

        def peak_of(*args):
            """One step, its peak allocation apart; the peak before it
            (set-up, the steps before, what lies between) is kept in
            ``before`` for the run's."""
            before[0] = max(before[0], torch.cuda.max_memory_allocated())
            torch.cuda.reset_peak_memory_stats()
            out = step(*args)
            step_peaks.append(torch.cuda.max_memory_allocated() / 1e9)
            return out

        launch_train.train_step = peak_of
        try:
            launch_train.run(arch, False, TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ,
                             1, 1, TRAIN_LR, 1, None, log_every=TRAIN_STEPS,
                             device=self.dev, seed=0, remat=remat,
                             history=history)
        finally:
            launch_train.train_step = step
        torch.cuda.synchronize()
        launched = ops.launch_counts()
        peak = max(before[0], torch.cuda.max_memory_allocated())
        expected = {name: 0 for name in launched}
        expected.update(train_launches(configs.get_config(arch), TRAIN_STEPS,
                                       remat))
        if launched != expected:
            raise AssertionError(f"{arch} train run (remat {remat}) "
                                 f"launched {launched}, not {expected}")
        losses = [h["loss"] for h in history]
        if len(losses) != TRAIN_STEPS or not np.isfinite(losses).all():
            raise AssertionError(f"{arch} train run losses {losses}")
        steady = [h["seconds"] for h in history[1:]]
        ms = 1e3 * float(np.mean(steady))
        emit({"train_run": f"{arch} full width and depth, "
              f"{TRAIN_BATCH} x {TRAIN_SEQ} tokens, {TRAIN_STEPS} steps",
              "remat": remat, "losses": losses,
              "grad_norms": [h["grad_norm"] for h in history],
              "first_step_ms": 1e3 * history[0]["seconds"],
              "steps_ms": [1e3 * h["seconds"] for h in history],
              "ms_per_step": ms, "ms_per_step_min": 1e3 * min(steady),
              "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / (ms / 1e3),
              "peak_gb": peak / 1e9, "step_peaks_gb": step_peaks,
              "held_at_start_gb": held / 1e9,
              "launches_per_step": {name: n / TRAIN_STEPS
                                    for name, n in launched.items() if n},
              "launches": launched})
        return {"launches": launched, "losses": losses}

    def train_runs(self, arch: str):
        """The two full-depth runs of ``arch`` (``train_full``); the same
        weights and batches with and without remat give losses within
        1e-4 relative (remat recomputes the same kernels on the same
        inputs)."""
        runs = {remat: self.train_full(arch, remat) for remat in (False, True)}
        a, b = runs[False]["losses"], runs[True]["losses"]
        worst = max(abs(x - y) / abs(x) for x, y in zip(a, b))
        emit({"train_remat_loss_rel_diff": worst, "arch": arch})
        if not worst <= 1e-4:
            raise AssertionError(f"{arch} losses with remat {b}, without "
                                 f"{a}")
        return {remat: run["launches"] for remat, run in runs.items()}

    def train_profile(self, arch: str):
        """One full-depth training step of ``arch`` (after a warm-up step)
        under torch.profiler: device time by kernel, busy share, and the
        host syncs of a step (``count_syncs``, outside the profiler); then
        one step's two halves timed apart with CUDA events:
        ``loss_and_grads`` (forward and backward) and ``adamw_update``,
        with the memory held before them (parameters and moments) and
        each half's peak."""
        torch = self.torch
        from repro_torch import configs
        from repro_torch.data import ShardedLoader, SyntheticLMDataset
        from repro_torch.models.model import init_params
        from repro_torch.optim import adamw_update, init_opt_state
        from repro_torch.training import train_step
        from repro_torch.training.train import loss_and_grads
        self.free_memory()
        cfg = configs.get_config(arch)
        tcfg = self.train_config(TRAIN_STEPS)
        box = {"params": init_params(
            cfg, torch.Generator(self.dev).manual_seed(0), self.dev)}
        box["opt"] = init_opt_state(box["params"])
        loader = ShardedLoader(SyntheticLMDataset(
            cfg.vocab_size, TRAIN_SEQ, seed=0).stream(TRAIN_BATCH),
            device=self.dev)

        def step():
            box["params"], box["opt"], _ = train_step(
                cfg, tcfg, box["params"], box["opt"], next(loader))

        step()
        syncs = self.count_syncs(step)
        self.profile_call(f"{arch} train step, {TRAIN_BATCH} x "
                          f"{TRAIN_SEQ}", step, syncs)
        events = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        batch = next(loader)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        events[0].record()
        _, _, grads = loss_and_grads(cfg, tcfg, box["params"], batch)
        events[1].record()
        peak_grads = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        adamw_update(tcfg.optimizer, box["params"], grads, box["opt"])
        events[2].record()
        torch.cuda.synchronize()
        emit({"train_step_split": f"{arch}, {TRAIN_BATCH} x {TRAIN_SEQ}",
              "loss_and_grads_ms": events[0].elapsed_time(events[1]),
              "adamw_update_ms": events[1].elapsed_time(events[2]),
              "params_and_moments_gb": held / 1e9,
              "peak_loss_and_grads_gb": peak_grads / 1e9,
              "peak_adamw_update_gb":
                  torch.cuda.max_memory_allocated() / 1e9})
        del box, grads
        self.free_memory()

    def grad_guard(self):
        """On the card a kernel without a backward refuses an input that
        requires grad: B4 with such a q raises, naming its ROADMAP entry
        (queue B's serving kernels); the same call under ``no_grad``
        runs."""
        torch = self.torch
        from repro_torch.kernels import ops
        q = self.randn(4, 16, 128, gen=self.train_gen).requires_grad_(True)
        cache = self.randn(4, 32, 8, 128, gen=self.train_gen)
        mask = torch.ones(4, 32, dtype=torch.uint8, device=self.dev)
        try:
            ops.decode_attention(q, cache, cache, mask)
        except RuntimeError as err:
            if "flash_decode has no backward kernel" not in str(err):
                raise
            emit({"grad_guard": str(err)})
        else:
            raise AssertionError("flash_decode ran on a q that requires "
                                 "grad")
        with torch.no_grad():
            ops.decode_attention(q, cache, cache, mask)
        torch.cuda.synchronize()

    def profile_rounds(self, arch: str):
        """One E=1 prefill round and one decode round at full width and
        depth (G=4, K=4: 44 streams, 256-token prompts) under
        torch.profiler (``profile_coded``)."""
        torch = self.torch
        from repro_torch import configs
        from repro_torch.models.model import init_params
        cfg = configs.get_config(arch)
        params = init_params(cfg, torch.Generator(self.dev).manual_seed(0),
                             self.dev)
        tokens = torch.randint(0, cfg.vocab_size, (GROUPS * K, PROMPT),
                               generator=self.gen, device=self.dev)
        self.profile_coded(f"{arch} K={K} S={S} E={E}", cfg, params,
                           {"tokens": tokens}, PROMPT + 4, self.gen)

    def profile_call(self, where: str, fn, syncs: int) -> None:
        """``fn()`` once under torch.profiler: its wall time (the
        profiler's host cost included), the device time of its kernels,
        their share of the wall time, and the kernels that take most of
        it."""
        torch = self.torch
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        kernels = sorted(
            ((getattr(ev, "self_device_time_total", 0) / 1e3, ev.count,
              ev.key[:90]) for ev in prof.key_averages()
             if ev.device_type == DeviceType.CUDA), reverse=True)
        device_ms = sum(k[0] for k in kernels)
        emit({"profile": where, "syncs": syncs, "wall_ms": wall,
              "device_ms": device_ms if kernels else None,
              "busy_share": device_ms / wall if kernels else None,
              "top": [[name, count, ms] for ms, count, name
                      in kernels[:10]]})

    def profile_multihost(self):
        """One prefill call and one decode call of the multihost serve's
        slot pool on qwen3-moe-30b-a3b at E=1 (bf16, full width and depth,
        8 slots x 18 streams, 128-token prompts), through the executor on
        the one-rank path, each after a warm-up call, under torch.profiler
        (``profile_call``); ``syncs`` counts the call's own transfer of
        tokens and verdicts to the host."""
        torch = self.torch
        from repro_torch import configs
        from repro_torch.core.berrut import CodingConfig
        from repro_torch.launch.worker_mesh import WorkerShardConfig
        from repro_torch.models.model import init_params
        from repro_torch.serving.continuous import ContinuousLLMExecutor
        cfg = configs.get_config(QWEN3_MOE).with_updates(
            param_dtype="bfloat16", activation_dtype="bfloat16")
        coding = CodingConfig(k=MH_K, s=MH_S, e=E)
        n1 = coding.num_workers
        self.free_memory()
        params = init_params(cfg, torch.Generator(self.dev).manual_seed(0),
                             self.dev)
        ex = ContinuousLLMExecutor(
            cfg, coding, params, pool_groups=MH_SLOTS, max_len=MH_WIDTH,
            wshard=WorkerShardConfig(gather_width=n1))
        box = {"state": ex.init_state()}
        prompts = np.random.RandomState(0).randint(
            0, cfg.vocab_size, (MH_SLOTS * MH_K, MH_PROMPT))
        admit = np.ones((MH_SLOTS,), np.float32)
        every = np.ones((n1,), np.float32)

        def call(kind):
            def run():
                args = (prompts if kind == "prefill"
                        else box["tokens"].reshape(-1, 1), admit, every)
                box["tokens"], box["state"], _ = getattr(ex, kind)(
                    box["state"], *args)
            return run

        for kind in ("prefill", "decode"):
            call(kind)()                                    # warm-up
            self.profile_call(
                f"{QWEN3_MOE} multihost pool K={MH_K} S={MH_S} E={E} "
                f"bf16 {kind}", call(kind), self.count_syncs(call(kind)))
        del params, ex, box

    def survivors(self, n1: int, quorum: int, gen, keep=()):
        """(N+1,) mask with exactly ``quorum`` workers up, ``keep`` among
        them, the rest drawn from ``gen``."""
        torch = self.torch
        rest = [i for i in torch.randperm(n1, generator=gen).tolist()
                if i not in keep]
        m = torch.zeros(n1)
        m[list(keep) + rest[:quorum - len(keep)]] = 1.0
        return m

    def model_inputs(self, cfg, batch: int, length: int, gen) -> dict:
        """A 2-layer check's CPU inputs of ``batch`` requests: ``length``
        tokens drawn from ``gen``, then for the vlm its patch embeddings
        (the text after them); for the audio frontend ``length``
        frames."""
        torch = self.torch
        if cfg.modality == "audio":
            return {"frames": torch.randn(batch, length, cfg.frontend_dim,
                                          generator=gen)}
        inputs = {"tokens": torch.randint(0, cfg.vocab_size,
                                          (batch, length), generator=gen)}
        if cfg.modality == "vlm":
            inputs["patches"] = torch.randn(batch, cfg.num_patches,
                                            cfg.frontend_dim, generator=gen)
        return inputs

    def whole_path(self, arch: str, worker_major: bool = False):
        """Full width, 2 layers (zamba2: "SGSG"): the card against the CPU's
        plain path on the same weights, prompts, masks and noise; with "M"
        blocks also the expert routes (``route_walk``), comparing nothing
        past a route a near tie changed.  paligemma: one group of K on
        its 256 patches and FRONT_TEXT text tokens, decoding from
        position 272.  Worker-major: E=0 and
        E=1, exactly the decode quorum surviving each round, the card's
        tokens also held against its group-major path's.  At that bare
        K+2E quorum some survivor sets leave the locator no majority
        (ROADMAP C), so there the attacker must be located alike on both
        devices, not located at all."""
        torch = self.torch
        from repro_torch.core.berrut import CodingConfig
        from repro_torch.launch.worker_mesh import WorkerShardConfig
        from repro_torch.serving import coded_serving as cs
        prompt, steps, groups = 64, 4, GROUPS
        cpu = torch.device("cpu")
        gen = torch.Generator(cpu).manual_seed(1)
        cfg, params = self.small_model(arch, gen)
        if arch in FRONTENDS:
            prompt, groups = FRONT_TEXT, 1
        moe_k = cfg.experts_per_token if "M" in cfg.layer_pattern else 0
        inputs = self.model_inputs(cfg, groups * K, prompt, gen)
        seq = prompt + cfg.num_patches
        ws = WorkerShardConfig() if worker_major else None
        runs = [("cpu", cpu, ws), ("cuda", self.dev, ws)]
        if worker_major:
            runs.append(("group-major", self.dev, None))
        kind = " worker-major" if worker_major else ""
        worst = 0.0
        for e in ((0, E) if worker_major else (E,)):
            coding = CodingConfig(k=K, s=S, e=e)
            n1 = coding.num_workers
            byz = torch.zeros(n1)
            if e:
                byz[5] = 1.0
            stragglers = (1, 4, 7, 10, 2)           # never the attacker
            states, nxt = {}, None
            for r in range(1 + steps):
                if worker_major:
                    m = self.survivors(n1, coding.decode_quorum, gen,
                                       keep=(5,) if e else ())
                else:
                    m = torch.ones(n1)
                    m[stragglers[r]] = 0.0
                noise = torch.randn(groups, n1, cfg.vocab_size,
                                    generator=gen)
                outs, log = {}, []
                for name, dev, wshard in runs:
                    kw = dict(straggler_mask=m.to(dev), byz_mask=byz.to(dev),
                              byz_noise=noise.to(dev), byz_sigma=10.0,
                              with_report=True, wshard=wshard)
                    p = params[dev.type]
                    with self.routes(log, name):
                        if r == 0:
                            logits, states[name], rep = cs.coded_prefill(
                                cfg, coding, p, {key: x.to(dev) for key, x
                                                 in inputs.items()},
                                seq + steps + 2, **kw)
                        else:
                            logits, states[name], rep = \
                                cs.coded_decode_step(cfg, coding, p,
                                                     states[name],
                                                     nxt.to(dev), **kw)
                    outs[name] = (logits.float().cpu(), rep[0].cpu())
                (lc, loc_c), (lg, loc_g) = outs["cpu"], outs["cuda"]
                err = (lg - lc).abs().max().item()
                tol = 1e-4 * max(1.0, lc.abs().max().item())
                where = f"{arch}{kind} whole path E={e} round {r}"
                if moe_k and self.route_walk(where, log, moe_k) is not None:
                    break              # inputs differ from here on
                worst = max(worst, err / tol)
                if not err <= tol:
                    raise AssertionError(f"{where}: logits differ by {err} "
                                         f"> {tol}")
                if not torch.equal(lg.argmax(-1), lc.argmax(-1)):
                    raise AssertionError(f"{where}: greedy tokens differ "
                                         "between cuda and cpu")
                if not torch.equal(loc_g, loc_c) or (
                        e and not worker_major and not loc_c[:, 5].all()):
                    raise AssertionError(f"{where}: located workers differ "
                                         "or miss the attacker")
                if worker_major and not torch.equal(
                        outs["group-major"][0].argmax(-1), lg.argmax(-1)):
                    raise AssertionError(f"{where}: worker-major tokens "
                                         "differ from group-major ones")
                nxt = lc.argmax(-1)[:, None]
                emit({"whole_path_round": where, "logits_max_abs_diff": err,
                      "tol": tol, "survivors": m.nonzero()[:, 0].tolist(),
                      "attacker_located": (loc_c[:, 5].tolist() if e
                                           else None)})
        emit({"whole_path": f"{arch}{kind} full width, {cfg.layer_pattern}, "
              "cuda vs "
              "cpu", "rounds": 1 + steps, "worst_err_over_tol": worst})

    def whole_audio_path(self):
        """hubert-xlarge at full width and 2 layers, card against CPU on
        the same weights, frames (one group of K=4 requests of 500
        frames), masks and noise, E=1 with a straggler and an attacker:
        the coded round (``coded_prefill`` on {"frames"}: B3 twice,
        non-causal at head_dim 80, B1 and B2 once) and the engine call
        (``EngineExecutor`` over ``predict_fn`` on the rows of
        ``embed_inputs``: B3 twice, nothing else).  Decoded logits within
        1e-4 x max(1, max |cpu|), greedy tokens and verdicts equal, the
        attacker located."""
        torch = self.torch
        from repro_torch.core.berrut import CodingConfig
        from repro_torch.core.scheme import BerrutScheme
        from repro_torch.kernels import ops
        from repro_torch.launch import serve
        from repro_torch.models.model import embed_inputs, predict_fn
        from repro_torch.serving import coded_serving as cs
        from repro_torch.serving.failures import make_adversary
        from repro_torch.serving.scheduler import EngineExecutor
        cpu = torch.device("cpu")
        gen = torch.Generator(cpu).manual_seed(3)
        cfg, params = self.small_model(HUBERT, gen)
        coding = CodingConfig(k=K, s=S, e=E)
        n1 = coding.num_workers
        frames = self.model_inputs(cfg, K, FRAMES, gen)["frames"]
        mask = torch.ones(n1)
        mask[2] = 0.0                           # a straggler
        byz = torch.zeros(n1)
        byz[5] = 1.0                            # the attacker
        noise = torch.randn(1, n1, cfg.vocab_size, generator=gen)
        emb = embed_inputs(cfg, params["cpu"], {"frames": frames}).numpy()
        outs, launched = {}, {}
        for name, dev in (("cpu", cpu), ("cuda", self.dev)):
            p = params[name]
            ops.reset_launch_counts()
            logits, _, (located, _) = cs.coded_prefill(
                cfg, coding, p, {"frames": frames.to(dev)}, FRAMES,
                straggler_mask=mask.to(dev), byz_mask=byz.to(dev),
                byz_noise=noise.to(dev), byz_sigma=10.0, with_report=True)
            launched["coded"] = ops.launch_counts()
            ex = EngineExecutor(predict_fn(cfg, p), BerrutScheme(coding),
                                device=dev)
            attack = make_adversary(coding, serve._adversary(
                E, "persistent", 1.0, 10.0, "random", 0)).next_round()
            ops.reset_launch_counts()
            with self.host_noise():
                served, report = ex.decode(ex.dispatch(emb), mask.numpy(),
                                           attack)
            launched["engine"] = ops.launch_counts()
            outs[name] = {"coded": (logits.cpu(), located.cpu()),
                              "engine": (torch.from_numpy(served),
                                         torch.from_numpy(report.located)),
                              "attacker": attack.mask}
        torch.cuda.synchronize()
        engine = {name: 0 for name in ops.KERNELS}
        engine.update(pattern_kernels(cfg)["prefill"])
        expected = {"coded": dict(engine, berrut_apply=1,
                                  fused_group_decode=1), "engine": engine}
        emit({"path": f"{HUBERT} whole coded and engine path",
              "launches": launched, "expected": expected})
        if launched != expected:
            raise AssertionError(f"{HUBERT} whole path: launches {launched} "
                                 f"!= {expected}")
        report = {"whole_audio_path": f"{HUBERT} full width, "
                  f"{cfg.layer_pattern}, cuda vs cpu", "frames": FRAMES}
        for run in ("coded", "engine"):
            (lc, loc_c), (lg, loc_g) = outs["cpu"][run], outs["cuda"][run]
            err = (lg - lc).abs().max().item()
            tol = 1e-4 * max(1.0, lc.abs().max().item())
            attacker = np.flatnonzero(outs["cpu"]["attacker"]) if \
                run == "engine" else [5]
            where = f"{HUBERT} whole {run} path E={E}"
            if not (lg.shape == lc.shape and err <= tol):
                raise AssertionError(f"{where}: logits differ by {err} > "
                                     f"{tol}")
            if not torch.equal(lg.argmax(-1), lc.argmax(-1)):
                raise AssertionError(f"{where}: greedy tokens differ")
            if not (torch.equal(loc_g, loc_c)
                    and loc_c[:, attacker].all()):
                raise AssertionError(f"{where}: located workers differ or "
                                     "miss the attacker")
            report[run] = {"max_abs_err": err, "tol": tol,
                           "attacker": [int(w) for w in attacker]}
        emit(report)

    def whole_pool_path(self, arch: str, worker_major: bool = False):
        """The slot pool at full width and 2 layers (zamba2: "SGSG"): the
        card against the CPU's plain path on the same weights, prompts,
        masks and noise, over five pool rounds in which groups are
        admitted while others decode, at E=0 (the live mask reaches the
        kernel) and E=1; with "M" blocks also the expert routes of every
        stream, a free slot's included (``route_walk``), comparing nothing
        past a route a near tie changed.  paligemma (B5 at D = 256, rep
        8, one kv-head): E=1 over FRONT_POOL_ROUNDS, each admission its
        patches and FRONT_TEXT tokens, and the KV caches of the slots
        admitted so far held card against CPU after every call (a free
        slot's are garbage, ROADMAP C).
        Worker-major: exactly the decode quorum surviving each round, the
        card's tokens also held against its group-major path's, and the
        attacker located alike on both devices (see ``whole_path``).
        Returns the card's kernel launches over the run."""
        torch = self.torch
        from repro_torch.core.berrut import CodingConfig
        from repro_torch.kernels import ops
        from repro_torch.launch.worker_mesh import WorkerShardConfig
        from repro_torch.models.model import init_caches
        from repro_torch.serving import coded_serving as cs
        pool, prompt, max_len = 2, 64, 72
        # (admitted slots, active slots) per round
        rounds = [((0,), ()), ((1,), (0,)), ((), (0, 1)), ((0,), (1,)),
                  ((), (0, 1))]
        es = (0, E)
        cpu = torch.device("cpu")
        gen = torch.Generator(cpu).manual_seed(2)
        cfg, params = self.small_model(arch, gen)
        front = arch in FRONTENDS
        if front:
            prompt, rounds, es = FRONT_TEXT, FRONT_POOL_ROUNDS, (E,)
            max_len = cfg.num_patches + prompt + 8
        moe_k = cfg.experts_per_token if "M" in cfg.layer_pattern else 0
        ws = WorkerShardConfig() if worker_major else None
        runs = [("cpu", cpu, ws), ("cuda", self.dev, ws)]
        if worker_major:
            runs.append(("group-major", self.dev, None))
        kind = " worker-major" if worker_major else ""
        worst = worst_cache = 0.0
        ops.reset_launch_counts()
        for e in es:
            coding = CodingConfig(k=K, s=S, e=e)
            n1 = coding.num_workers
            byz = torch.zeros(n1)
            if e:
                byz[5] = 1.0
            states = {name: cs.init_pool_state(cfg, coding, pool, max_len,
                                               dev, wshard=wshard)
                      for name, dev, wshard in runs}
            fresh = {name: init_caches(
                cfg, cs.pool_streams(coding, pool, wshard), max_len,
                torch.float32, dev) for name, dev, wshard in runs}
            inputs = {"tokens": torch.zeros(pool * K, prompt,
                                            dtype=torch.int64)}
            if cfg.modality == "vlm":
                inputs["patches"] = torch.zeros(pool * K, cfg.num_patches,
                                                cfg.frontend_dim)
            nxt = torch.zeros(pool * K, 1, dtype=torch.int64)
            live = set()
            diverged = False
            for r, (admitted, active) in enumerate(rounds):
                if diverged:
                    break
                if worker_major:
                    m = self.survivors(n1, coding.decode_quorum, gen,
                                       keep=(5,) if e else ())
                else:
                    m = torch.ones(n1)
                    m[(1, 4, 7, 2, 3)[r] % n1] = 0.0   # never the attacker
                noise = torch.randn(pool, n1, cfg.vocab_size, generator=gen)
                calls = []
                if admitted:
                    for slot in admitted:
                        for key, x in self.model_inputs(cfg, K, prompt,
                                                        gen).items():
                            inputs[key][slot * K:(slot + 1) * K] = x
                    live.update(admitted)
                    calls.append(("prefill", admitted))
                if active:
                    calls.append(("decode", active))
                for call, slots in calls:
                    gm = torch.zeros(pool)
                    gm[list(slots)] = 1.0
                    outs, log = {}, []
                    for name, dev, wshard in runs:
                        kw = dict(straggler_mask=m.to(dev),
                                  byz_mask=byz.to(dev),
                                  byz_noise=noise.to(dev), byz_sigma=10.0,
                                  with_report=True, wshard=wshard)
                        p = params[dev.type]
                        with self.routes(log, name):
                            if call == "prefill":
                                logits, states[name], rep = \
                                    cs.coded_pool_prefill(
                                        cfg, coding, p, states[name],
                                        {key: x.to(dev) for key, x
                                         in inputs.items()},
                                        gm.numpy(), fresh=fresh[name], **kw)
                            else:
                                logits, states[name], rep = \
                                    cs.coded_pool_decode_step(
                                        cfg, coding, p, states[name],
                                        nxt.to(dev), gm.to(dev), **kw)
                        outs[name] = (logits.float().cpu(), rep[0].cpu(),
                                      states[name].pos.cpu())
                    (lc, loc_c, pos_c), (lg, loc_g, pos_g) = (outs["cpu"],
                                                              outs["cuda"])
                    rows = gm.repeat_interleave(K) > 0
                    err = (lg[rows] - lc[rows]).abs().max().item()
                    tol = 1e-4 * max(1.0, lc[rows].abs().max().item())
                    where = (f"{arch}{kind} pool whole path E={e} round {r} "
                             f"{call}")
                    # a free slot's streams enter the router too
                    if moe_k and self.route_walk(where, log,
                                                 moe_k) is not None:
                        diverged = True        # inputs differ from here on
                        break
                    worst = max(worst, err / tol)
                    if not err <= tol:
                        raise AssertionError(f"{where}: live logits differ "
                                             f"by {err} > {tol}")
                    if not torch.equal(lg[rows].argmax(-1),
                                       lc[rows].argmax(-1)):
                        raise AssertionError(f"{where}: greedy tokens differ")
                    if not torch.equal(loc_g, loc_c) or not torch.equal(
                            pos_g, pos_c):
                        raise AssertionError(f"{where}: located workers or "
                                             "slot positions differ")
                    if e and not worker_major and not loc_c[gm > 0, 5].all():
                        raise AssertionError(f"{where}: attacker not located")
                    if worker_major and not torch.equal(
                            outs["group-major"][0][rows].argmax(-1),
                            lg[rows].argmax(-1)):
                        raise AssertionError(f"{where}: worker-major tokens "
                                             "differ from group-major ones")
                    nxt[rows, 0] = lc[rows].argmax(-1)
                    if front:
                        worst_cache = max(worst_cache, self.live_caches(
                            where, states, sorted(live), n1))
                    emit({"whole_pool_path": where,
                          "logits_max_abs_diff": err, "tol": tol,
                          "attacker_located": (loc_c[gm > 0, 5].tolist()
                                               if e else None)})
        launched = ops.launch_counts()
        emit({"whole_pool_path": f"{arch}{kind} full width, "
              f"{cfg.layer_pattern}, cuda vs cpu", "rounds": len(rounds),
              "worst_err_over_tol": worst,
              "caches_worst_err_over_tol": worst_cache if front else None,
              "launches": launched})
        return launched

    def live_caches(self, where: str, states: dict, slots: list,
                    n1: int) -> float:
        """Hold the card's pool caches against the CPU's on the streams of
        ``slots`` (group-major: slot g owns streams g(N+1) .. g(N+1)+N),
        within 1e-4 x max(1, max |cpu|) a leaf; returns the worst error
        over its tolerance."""
        torch = self.torch
        idx = torch.tensor([g * n1 + i for g in slots for i in range(n1)])
        worst = 0.0
        for run_c, run_g in zip(states["cpu"].caches, states["cuda"].caches):
            for leaf, cc in run_c.items():
                cc = cc[:, idx].float()
                cg = run_g[leaf][:, idx.to(self.dev)].float().cpu()
                err = (cg - cc).abs().max().item()
                tol = 1e-4 * max(1.0, cc.abs().max().item())
                if not err <= tol:
                    raise AssertionError(f"{where}: cache {leaf} of the live "
                                         f"slots differs by {err} > {tol}")
                worst = max(worst, err / tol)
        return worst

    def multihost(self) -> dict:
        """``launch.multihost --mode serve`` at its defaults (qwen3-0.6b in
        bf16, K=7 S=2 E=0: 9 coded streams, 8 slots, 128-token prompts)
        for STEPS decode steps through its ``main``, on a one-rank NCCL
        group over a file store: W = 1, the one-rank path.  Launches held
        against its calls (B6 once a call, B1 never)."""
        torch = self.torch
        from repro_torch.kernels import ops
        from repro_torch.launch import multihost
        store = ROOT / "build" / "multihost-store"
        store.parent.mkdir(parents=True, exist_ok=True)
        store.unlink(missing_ok=True)
        ops.reset_launch_counts()
        with self.finite_logits("multihost serve"):
            res = multihost.main([
                "--mode", "serve", "--coordinator", f"file://{store}",
                "--num-processes", "1", "--process-id", "0",
                "--steps", str(STEPS)])
            torch.cuda.synchronize()
        store.unlink(missing_ok=True)
        launches = ops.launch_counts()
        expected = self.expected_launches("qwen3-0.6b", 1, STEPS, pool=True,
                                          worker_major=True)
        emit({"path": "multihost serve", "launches": launches,
              "expected": expected})
        if launches != expected:
            raise AssertionError(f"multihost serve: launch counts {launches} "
                                 f"!= {expected}")
        toks = res["tokens"]
        if toks.shape != (1 + STEPS, 8 * 7) or toks.min() < 0 or \
                toks.max() >= 151936:
            raise AssertionError(f"multihost serve: bad tokens {toks.shape}")
        ms = res["call_ms"]
        emit({"serve": "multihost serve qwen3-0.6b bf16 K=7 S=2 E=0 W=1",
              "streams": 8 * 9, "prefill_ms": ms["prefill"][0],
              "decode_ms_mean": sum(ms["decode"]) / STEPS,
              "decode_ms": ms["decode"],
              "tokens_per_s": toks.size / (sum(ms["prefill"])
                                           + sum(ms["decode"])) * 1e3})
        return launches

    def multihost_moe(self, e: int) -> dict:
        """``launch.multihost --mode serve --arch qwen3-moe-30b-a3b`` at
        its defaults (bf16, K=7 S=2, 8 slots, 128-token prompts) and
        ``--e e``, for STEPS decode steps through its ``main``, on a
        one-rank NCCL group: full width and depth (48 layers of 128
        experts, 3.05e10 parameters, 61 GB in bf16) after every earlier
        model's memory is given back.  Launches held against its calls
        (B6 once a call, B1 never), tokens in range and every round's
        logits finite; printed: the tokens, each call's wall time, the
        locator's verdicts (workers located a call, at E=1), the depth run
        and ``torch.cuda.max_memory_allocated()``."""
        torch = self.torch
        from repro_torch import configs
        from repro_torch.core.berrut import CodingConfig
        from repro_torch.kernels import ops
        from repro_torch.launch import multihost
        from repro_torch.serving.continuous import ContinuousLLMExecutor
        cfg = configs.get_config(QWEN3_MOE)
        coding = CodingConfig(k=MH_K, s=MH_S, e=e)
        self.free_memory()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        store = ROOT / "build" / "multihost-store"
        store.parent.mkdir(parents=True, exist_ok=True)
        store.unlink(missing_ok=True)
        verdicts = []
        real = {kind: getattr(ContinuousLLMExecutor, kind)
                for kind in ("prefill", "decode")}

        def recorded(kind):
            def call(executor, *args, **kw):
                out = real[kind](executor, *args, **kw)
                verdicts.append(None if out[2] is None else
                                np.flatnonzero(out[2].located.any(0))
                                .tolist())
                return out
            return call

        ops.reset_launch_counts()
        where = f"multihost serve {QWEN3_MOE} E={e}"
        try:
            for kind in real:
                setattr(ContinuousLLMExecutor, kind, recorded(kind))
            with self.finite_logits(where):
                res = multihost.main([
                    "--mode", "serve", "--arch", QWEN3_MOE, "--e", str(e),
                    "--coordinator", f"file://{store}", "--num-processes",
                    "1", "--process-id", "0", "--steps", str(STEPS)])
                torch.cuda.synchronize()
        finally:
            for kind, fn in real.items():
                setattr(ContinuousLLMExecutor, kind, fn)
            store.unlink(missing_ok=True)
        launches = ops.launch_counts()
        expected = self.expected_launches(QWEN3_MOE, 1, STEPS, pool=True,
                                          worker_major=True)
        emit({"path": where, "launches": launches, "expected": expected})
        if launches != expected:
            raise AssertionError(f"{where}: launch counts {launches} != "
                                 f"{expected}")
        toks = res["tokens"]
        if toks.shape != (1 + STEPS, MH_SLOTS * MH_K) or toks.min() < 0 or \
                toks.max() >= cfg.vocab_size:
            raise AssertionError(f"{where}: bad tokens {toks.shape}")
        ms = res["call_ms"]
        emit({"serve": f"{where} bf16 K={MH_K} S={MH_S} W=1",
              "depth": cfg.num_layers, "params": cfg.param_count(),
              "param_gb_bf16": cfg.param_count() * 2 / 1e9,
              "streams": MH_SLOTS * coding.num_workers,
              "max_memory_allocated_gb": torch.cuda.max_memory_allocated()
              / 1e9, "held_before_gb": held / 1e9,
              "prefill_ms": ms["prefill"][0],
              "decode_ms_mean": sum(ms["decode"]) / STEPS,
              "decode_ms": ms["decode"],
              "tokens_per_s": toks.size / (sum(ms["prefill"])
                                           + sum(ms["decode"])) * 1e3,
              "located_per_call": verdicts,
              "tokens": toks[:, :8].tolist()})
        return launches

    def nccl_tail(self):
        """The round tail's collective branch (survivor at the default
        width and at N+1, replicated; logits, greedy and top-k tokens)
        through a one-rank NCCL group, on the first worker-major E=1
        round's coded logits: equal to the one-rank path's."""
        torch = self.torch
        import torch.distributed as dist
        from repro_torch.core.berrut import CodingConfig
        from repro_torch.launch import worker_mesh as wm
        from repro_torch.models.partitioning import WorkerGroup
        from repro_torch.serving import coded_serving as cs
        from repro_torch.serving.sampling import SampleConfig
        coding = CodingConfig(k=K, s=S, e=E)
        n1 = coding.num_workers
        coded, avail = self.wm_round
        masks, _, _ = cs.locate(coding, coded, avail,
                                wshard=wm.WorkerShardConfig())
        block = coded.reshape(n1, GROUPS, -1)
        store = ROOT / "build" / "nccl-tail-store"
        store.parent.mkdir(parents=True, exist_ok=True)
        store.unlink(missing_ok=True)
        dist.init_process_group("nccl", init_method=f"file://{store}",
                                world_size=1, rank=0)
        try:
            group = WorkerGroup()
            total = group.all_reduce(block)
            if not torch.equal(total, block):
                raise AssertionError("one-rank NCCL all-reduce changed the "
                                     "block")
            for ws in (wm.WorkerShardConfig(),
                       wm.WorkerShardConfig(gather_width=n1),
                       wm.WorkerShardConfig(mode="replicated")):
                for sample in (None, SampleConfig(),
                               SampleConfig(top_k=3, temperature=0.7)):
                    outs = []
                    for g in (None, group):
                        gen = torch.Generator(self.dev).manual_seed(5)
                        outs.append(wm._decode_tail(
                            coding, block, masks, avail, ws, g, None,
                            sample, gen))
                    torch.cuda.synchronize()
                    what = (f"{ws.mode} width {ws.resolved_width(coding)} "
                            f"{'logits' if sample is None else sample}")
                    if not torch.equal(*outs):
                        raise AssertionError(f"NCCL tail {what}: differs "
                                             "from the one-rank path")
                    emit({"nccl_tail": what, "equal": True})
        finally:
            dist.destroy_process_group()
            store.unlink(missing_ok=True)


def visible_pairs(s: int, *, causal: bool, window, prefix: int) -> int:
    """(query, key) pairs one head sees over ``s`` positions: causal, row
    i sees keys 0..i; prefix-LM, rows i < P see the P prefix keys and
    rows i >= P keys 0..i; non-causal, every key; a window keeps the
    keys after i - window."""
    total = 0
    for i in range(s):
        hi = max(i + 1, min(prefix, s)) if causal else s
        lo = 0 if window is None else max(0, i - window + 1)
        total += max(0, hi - lo)
    return total


def ssd_ops(b: int, s: int, h: int, p: int, n: int) -> float:
    """Least operations of the chunked scan, at the power-of-two chunk Q
    dividing S that needs fewest: per (stream, head, chunk) the causal
    half of the decay-weighted scores applied to x (Q(Q+1)/2 x P
    multiply-adds), C h_in and the state update (Q N P each) and the
    decay of the state (P N); per (stream, chunk) the causal half of
    C B^T, shared by every head (Q(Q+1)/2 x N).  Per step that is
    (Q+1) P + 4 N P + N P / Q a head, least near Q = sqrt(N)."""
    def at(q: int) -> float:
        per_head = q * (q + 1) * p + 4 * q * n * p + p * n
        return b * (s // q) * (h * per_head + q * (q + 1) * n)
    return min(at(1 << i) for i in range(s.bit_length())
               if s % (1 << i) == 0)


def train_launches(cfg, steps: int, remat: bool) -> dict:
    """The launches of ``steps`` training steps of ``cfg``: B3 and its
    backward in every attention layer ("A", "M", "G"), B7's two forward
    launches and its two backward launches in every "S" layer; each
    forward twice under remat (the block is recomputed), each backward
    once."""
    attn = sum(cfg.layer_pattern.count(c) for c in "AMG")
    ssm = cfg.layer_pattern.count("S")
    fwd = steps * (2 if remat else 1)
    return {"flash_attention": attn * fwd,
            "flash_attention_bwd": attn * steps,
            "ssd_chunked": ssm * fwd, "ssd_chunk_scores": ssm * fwd,
            "ssd_chunked_bwd": ssm * steps, "ssd_bwd_head_sum": ssm * steps}


def ssd_bwd_ops(b: int, s: int, h: int, p: int, n: int) -> float:
    """Least operations of the chunked scan's gradient from its inputs and
    dy, at the power-of-two chunk Q dividing S that needs fewest: per
    (stream, head, chunk) the entry state recomputed (Q N P), dH b, dy
    H_in, xbar dH and the state gradient's update (Q N P each), the causal
    halves of dy . xbar and of A^T dy (Q(Q+1)/2 x P each), the per-step
    dots and the decays (Q N + Q P + 2 P N); per (stream, chunk) the causal
    halves of C B^T and of dG B and dG^T C, with dG summed over the heads
    first (Q(Q+1)/2 x N each).  Two operations a multiply-add."""
    def at(q: int) -> float:
        per_head = 5 * q * n * p + q * (q + 1) * p + q * n + q * p + 2 * p * n
        return 2 * b * (s // q) * (h * per_head + 3 * q * (q + 1) * n // 2)
    return min(at(1 << i) for i in range(s.bit_length())
               if s % (1 << i) == 0)


def scheduler_rounds(sched) -> list:
    """(batch, round, survivors, located or None) of every round a batch
    scheduler ran, in the order it ran them."""
    out = []
    for ev in sched.trace:
        if ev[0] == "round":
            report = sched.batches[ev[1]].round_reports[ev[2]]
            out.append((ev[1], ev[2], ev[4], None if report is None
                        else np.asarray(report.located)))
    return out


def _tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_to(v, device) for v in tree]
    return tree.to(device)


if __name__ == "__main__":
    sys.exit(main())
