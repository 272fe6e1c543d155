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
17. B3's backward kernel (``flash_attention_bwd``, training: its Delta
   launch ``flash_attention_bwd_delta``, then one launch of dk/dv and dq
   blocks) and the forward's row log-sum-exp against their plain
   versions, and in fp32 against autograd of the plain forward, at
   qwen3-0.6b's training shape (8 x 128 tokens, GQA 16/8 of 128, causal)
   and at 4 x 2048, both dtypes, timed beside the backward of autograd
   through SDPA (the Delta launch beside ``torch.linalg.vecdot``), two
   calls bitwise equal, each launch's device bytes beside its time;
   ``bwd_info`` at every head dim (two stages or more, no spills,
   asserted); every rule, head dim and GQA ratio untimed (h2o-danube's
   window at D = 80, paligemma's prefix-LM at D = 256 rep 8, softcap,
   q_offset, rows that see no key), the worst share of the tolerance
   printed; and a kernel without a backward (B4) refusing a q that
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
   each family not trained on the card before: qwen3-moe-30b-a3b (1
   layer; router routes held, ``route_walk``), paligemma-3b (2 x 256 patches
   and 32 text tokens), hubert-xlarge (2 x 500 frames, frame targets)
   and h2o-danube-1.8b (head_dim 80), under phase 18's rules;
22. the serving mesh (ROADMAP A9.1; these run after phase 10): B3 and
   B5 at phase 24's model-2 shapes (80 streams of 128 tokens, a 256-slot
   ring), fp32, at a rank's heads (GQA 8/4 of 128) and the whole
   model's (16/8), timed;
23. qwen3-0.6b at full width and depth, fp32, through the mesh code on
   one rank over NCCL: ``launch.multihost --mode serve`` at its defaults
   with ``--s 3`` (K=7 S=3 E=0, 8 slots of 128-token prompts, 3 decode
   calls) against the same pool with no mesh, and the batch E=1 round
   (2 groups of K=4 S=1, 128-token prompts, 3 decode steps on fixed
   next tokens, a straggler and a sigma-10 attacker) on a one-rank
   (data, model) mesh against no mesh: tokens, logits and verdicts
   bitwise equal.  A one-rank mesh has no group (an axis of size 1 gets
   none), so this phase runs no collective: it checks the stream padding
   and ``local_shard``'s pass-through, not the mesh's collectives;
24. the same multihost serve on (worker, model) = (1, 2) and (2, 1) at
   once, then (2, 2), as 2-4 processes sharing the card over gloo (NCCL refuses
   two ranks on a device; only the collectives pass through the host),
   and phase 23's batch round at model 2: every rank's tokens the same
   and held to phase 23's up to the first near tie, each rank's decoded
   logits of those calls (its vocabulary block at W = 2) and the batch
   round's logits within the CPU tests' fp32 tolerance (rtol 1e-5, atol
   1e-4), and the batch round's verdicts equal; per-rank launches held to the one-rank
   tables (B6/B1, B2 once a call, B3 28 a prefill, B5/B4 28 a decode, at
   the local heads) and printed with each call's collective bytes by op
   and its wall time (gloo over the host);
25. h2o-danube-1.8b at full width and 2 layers, fp32, at model 2 (two
   processes over gloo): the batch round and the slot pool against the
   one-rank card path with no mesh: phase 24's rules, and each rank's
   caches its block of the one-rank caches' kv-heads;
26. the cache-length split (ROADMAP A9.4): B4 and B5's block form
   (``return_lse``, B5's ``slot0``) at qwen3-0.6b's full-width shapes
   (GQA 16/8 of 128) on a 256-slot ring cut into 16 blocks of 16 slots,
   B4 at the batch round's 22 streams (blocks past its depth see no key),
   B5 at the multihost run's 18 streams at per-stream depths with dead
   streams, fp32 and bf16: each block's output and lse against the plain
   block form, the 16 blocks merged against the kernel over the whole
   ring (TOL_F32 / the bf16 rule), keyless rows (0, -inf), dead streams
   zero; the first block timed beside its bound, its plain version and
   SDPA on the same block;
27. qwen3-0.6b at full width and MP16_LAYERS (4) of its 28 layers, fp32,
   on a 16-way model axis (8 kv-heads: each rank holds 16 of the 256
   ring slots of every kv-head),
   16 gloo processes sharing the card: phase 23's batch E=1 round over a
   256-slot ring and ``launch.multihost --mode serve --model-par 16
   --pool-groups 2 --steps 2`` (K=7 S=2 E=0), each against the same with
   no mesh on the card under phase 24's rules; each rank's batch caches
   its ring block of the no-mesh caches; per-rank launches (B3 28 a
   prefill, B4/B5 28 a decode, B1/B6 and B2 once a call); collective
   bytes by op equal to the analytic count (``model_axis_bytes``); each
   call's wall time (gloo over the host) and the card's peak memory;
28. the training mesh (ROADMAP A9.2): B3 and its backward (the Delta
   launch, then dq, dk and dv) at a model-2 rank's training heads
   (qwen3-0.6b's 8/4 of 128, 8 x 128 tokens, fp32) against their plain
   versions, timed beside the bound, the plain version and SDPA (its
   backward); then qwen3-0.6b at full width and 8 of its 28 layers,
   fp32, 2 steps of ``launch.train.run`` at the launcher's 8 x 128 tokens
   on (data, model) = (1, 2), (2, 1) and (2, 2), gloo processes sharing
   the card (the three meshes at once),
   each held to one rank's 2 steps on the same batches: losses and grad
   norms within 1e-4 relative and equal on every rank; after the first
   step each rank's blocks of the gradient (the first moment) within
   1e-4 x the leaf's max |grad| and of the parameters under Adam's
   first-step rule; per-rank launches (B3, its backward and Delta 8 a
   step); each group's bytes a step equal to ``train_axis_bytes``; the
   second step's wall time (gloo over the host) and the card's peak
   memory;
29. ``launch.multihost --mode train --model-par 2`` (bf16, remat) at
   ``--batch 8 --seq 128 --steps 2`` and MH_TRAIN_LAYERS (8) of qwen3's 28
   layers as 2 gloo processes against one process of the same command:
   losses within MH_TRAIN_LOSS_TOL, B3 16 and its backward 8 a step a
   rank, bytes equal to ``train_axis_bytes``;
30. the pod and data axes in serving (ROADMAP A9.5), qwen3-0.6b at full
   width and BA_LAYERS (8) of its 28 layers, fp32, gloo processes sharing the card: (a)
   ``launch.multihost --mode serve --multi-pod`` at its defaults (K=7
   S=2 E=0, 8 slots: 72 streams, 2 decode calls) on (pod, worker, model)
   = (2, 1, 1) and (2, 3, 1), against the same pool with no mesh; (b)
   phase 23's batch E=1 round and the worker-major slot pool on (data 2,
   model 2); (c) the worker-major batch E=1 round at K=4 S=2 (24 streams)
   on (pod 2, worker 2); each against the same with no mesh under phase
   24's rules, each rank's caches its block of the no-mesh caches (its
   streams in the reference's "batch" order, worker outermost, and its
   kv-heads), per-rank launches held and printed, each call's bytes by
   group and op equal to ``batch_axes_bytes``, the card's peak memory;
31. the MoE layer on the serving mesh (ROADMAP A9.3's first part): B3 and
   B5 at qwen3-moe-30b-a3b's multihost shapes at a model-2 rank's heads
   (GQA 16/2 of 128, rep 8, bf16) and B3 at hubert-xlarge's coded
   prefill at a model-2 rank's (MHA 8/8 of 80, fp32), timed; then
   qwen3-moe at full width and MOE_MESH_LAYERS (2) of its 48 layers,
   fp32, gloo processes sharing the card, (a) and (b) at once, then (c): (a)
   ``launch.multihost --mode serve --model-par 2`` and (b) the same at
   (worker 3, model 1) (24 of the pool's 72 streams a worker, each MoE
   layer gathering the whole pool's routes) against the same pool with
   no mesh; (c) phase 23's batch E=1 round and the worker-major slot
   pool on (data 2, model 2) against no mesh; every MoE layer call's
   routes held to the no-mesh run's (``mesh_route_walk``) and the rest
   of each run as far as the routes agree, under phase 24's rules; each
   call's bytes by group and op equal to ``batch_axes_bytes`` plus
   ``moe_axis_bytes``; the card's peak memory;
32. the MoE layer training on the mesh: qwen3-moe at full width and
   MOE_TRAIN_LAYERS (1) layer, fp32, 2 steps of ``launch.train.run`` at
   the launcher's 8 x 128 tokens on (data, model) = (2, 1) and (1, 2),
   gloo processes sharing the card, against one rank on the card:
   losses, grad norms, the load-balance loss and the dropped fraction
   within 1e-4 relative, each rank's blocks of the first step's
   gradients (the embeddings' left out) within 1e-4 x the leaf's max,
   launches held, each group's bytes a step equal to
   ``train_axis_bytes``;
33. the frontends on a 2-way model axis, fp32, 2 gloo processes each:
   hubert-xlarge (4 of 48 layers) through one ``coded_prefill`` of 16
   requests of 500 frames at E=1, and paligemma-3b (2 layers) through
   the batch E=1 round on 256 patches and 16 text tokens with 3 decode
   steps, each against the same with no mesh: logits within MESH_TOL,
   verdicts equal, launches held, each call's bytes equal to
   ``model_axis_bytes``;
34. Mamba2's "S" blocks on the model axis (ROADMAP A9.3b): B7 and its
   scores pass at a model-2 rank's heads of mamba2-780m's multihost
   prefill (72 streams of 128 tokens, 24 heads of 64, state 128) and of
   zamba2-1.2b's batch prefill (22 streams, 32 heads of 64, state 64),
   B7's backward and head sum at both at 8 x 128, each against its plain
   version and timed; then at full width and depth, fp32, gloo processes
   sharing the card, every job at once: (a) mamba2-780m's ``multihost
   --mode serve --model-par 2`` at its defaults (K=7 S=2 E=0, 72
   streams) against the same pool with no mesh; (b) its batch E=1 round
   and worker-major slot pool on (data 2, model 2) and (c) zamba2-1.2b's
   batch E=1 round at model 2, each against the same with no mesh under
   phase 24's rules; each rank's caches its block of the no-mesh caches
   (its streams, SSM heads and conv channels [x_r | B | C], kv-heads; in
   (a) the last layer's),
   per-rank launches held and printed, each call's bytes by group and op
   equal to ``batch_axes_bytes`` plus ``ssm_axis_bytes``, the card's
   peak memory;
35. Mamba2's "S" blocks training on the model axis: mamba2-780m (8
   layers) at (data, model) = (1, 2) and (2, 2), zamba2-1.2b (12 layers:
   10 "S" and the shared block at 2 "G" positions) at (1, 2), fp32, 2
   steps of ``launch.train.run`` at 8 x 128 tokens against one rank on
   the card: losses and grad norms within 1e-4 relative and equal on
   every rank, each rank's blocks of the first step's gradients within
   1e-4 x the leaf's max (B and C's columns in every rank's block),
   launches held, each group's bytes a step equal to
   ``train_axis_bytes``;
36. microbatches on a split training batch (ROADMAP A9.6): qwen3-moe at
   full width and MOE_TRAIN_LAYERS (1) layer, fp32, 2 gloo processes
   sharing the card at (data, model) = (2, 1): (a) 2 steps of
   ``launch.train.run`` with 2 microbatches, (b) one ``train_step`` with
   2 microbatches on a batch with a ``loss_mask`` (about 60% ones, from
   A96_SEED), each against the same with no mesh in this process under
   phase 32's checks, each group's bytes a step ``train_axis_bytes``'
   with the batch's exchange counted; the card's peak memory;
37. the sliding-window variant (``configs.shape_config_for("qwen3-0.6b",
   "long_500k")``, window 4096) at full width and SWA_LAYERS (4) of its
   28 layers, fp32: the batch E=1 round of one group on a 4608-token
   prompt, then 8 decode calls on the 4096-slot ring, which wraps; every
   B3 call held to its plain version, and every B4 call, launches held,
   the cache length and the card's peak memory printed.

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
18's two runs; B3's backward ``flash_attention_bwd`` and its Delta launch
``flash_attention_bwd_delta`` their own entries, at the training shape,
with their launches in those runs and their numbers at 4 x 2048 under
``long``; B7's entries also ``launches_train``,
``launches_train_remat`` (mamba2's runs) and ``launches_train_zamba2``;
B7's backward and its head sum their own entries, at mamba2's training
shape, with their launches in phase 20's runs and their numbers at
zamba2's under ``zamba2-1.2b``); B1, B6, B2, B3, B4 and B5's entries
also ``model_par_2``: their launches on each rank of phase 24's (worker
1, model 2) multihost run and batch round, and B3 and B5's fp32 numbers
of phase 22 at a rank's heads and the whole model's; and
``model_par_16``: their launches on each rank of phase 27's runs, and B4
and B5's fp32 block-form numbers of phase 26 on one 16-slot block; and
``batch_axes``: their launches on each rank of every phase-30 run; and
``a9_3``: their launches on each rank of every run of phases 31-33, and
B3 and B5's numbers of phase 31 at a model-2 rank's heads; B3's,
its backward's and its Delta launch's also ``train_mesh``: their fp32
numbers of phase 28 at a model-2 rank's training heads and their
launches on each rank of phases 28 and 29's runs, and ``a9_3``);
B1, B6, B2, B3, B4 and B5's entries also ``a9_3b``, and B7's four
entries ``model_par_2``: their launches on each rank of every run of
phases 34-35, and for B7's their fp32 numbers at a model-2 rank's heads
of mamba2-780m and zamba2-1.2b (phase 34);
the last is ``{"ok": true, "device": {...}}``.  Without a CUDA device, or
away from the repository's ``src/``, it exits 1 and prints no result.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import math
import os
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
    "flash_attention_bwd_delta": "src/repro/kernels/ref.py:112",
    # no Pallas backward: the gradient of the reference's chunked scan
    "ssd_chunked_bwd": "src/repro/kernels/ref.py:334",
    "ssd_bwd_head_sum": "src/repro/kernels/ref.py:334",
}
SOURCES = {name: f"src/repro_torch/csrc/{name}.cu" for name in REPLACES}
SOURCES["berrut_encode_dispatch"] = "src/repro_torch/csrc/berrut_apply.cu"
SOURCES["pool_flash_decode"] = "src/repro_torch/csrc/flash_decode.cu"
SOURCES["ssd_chunked"] = "src/repro_torch/csrc/ssd_scan.cu"
SOURCES["ssd_chunk_scores"] = "src/repro_torch/csrc/ssd_scan.cu"
SOURCES["flash_attention_bwd_delta"] = \
    "src/repro_torch/csrc/flash_attention_bwd.cu"
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
    "flash_attention_bwd_delta": ("flash_attention_bwd_delta_kernel", None),
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
# The serving mesh (phases 22-25): qwen3-0.6b's batch E=1 round (2 groups
# of K=4, S=1, E=1: 22 streams of 128-token prompts, 3 decode steps on
# fixed next tokens, a straggler and a sigma-10 attacker) and
# ``multihost --mode serve`` at its defaults with --s 3 (K=7 S=3 E=0: 10
# streams x 8 slots) for 3 decode calls, fp32; the (worker, model) meshes
# of its gloo runs, 2-4 processes sharing the card
MESH_GROUPS, MESH_PROMPT, MESH_STEPS, MESH_S = 2, 128, 3, 3
MESH_SEED, MESH_STRAGGLER, MESH_ATTACKER = 12, 3, 5
MESH_RUNS = ((1, 2), (2, 1), (2, 2))
MESH_TOL = (1e-5, 1e-4)        # rtol, atol: the CPU tests' fp32 logits rule
MESH_TIMEOUT_S = 600
MP2_KERNELS = ("berrut_apply", "berrut_encode_dispatch", "fused_group_decode",
               "flash_attention", "flash_decode", "pool_flash_decode")
# B7's two forward launches, shown beside MP2_KERNELS on the Mamba2 model
# axis (phases 34-35)
SSD_KERNELS = ("ssd_chunked", "ssd_chunk_scores")
# The cache-length split (phases 26-27): qwen3-0.6b's 8 kv-heads on a
# 16-way model axis, each rank a gloo process on cuda:0 holding 16 of a
# MH_WIDTH-slot ring's slots.  Phase 23's batch E=1 round over a
# MH_WIDTH-slot ring (16 divides it; at its own max_len of 133 every rank
# would keep the whole ring), and the multihost serve at its defaults
# (K=7 S=2 E=0) over MP16_SLOTS group slots for MP16_STEPS decode calls
MP16, MP16_SLOTS, MP16_STEPS = 16, 2, 2
# phase 27 runs qwen3-0.6b at full width and MP16_LAYERS of its 28
# layers, to keep the whole run inside its limit
MP16_LAYERS = 4
# The batch axes in serving (phase 30): qwen3-0.6b at full width and
# depth, fp32, gloo processes sharing cuda:0.  (a) ``multihost --mode
# serve --multi-pod`` at its defaults (K=7 S=2 E=0 over MH_SLOTS slots:
# 72 streams) for BA_STEPS decode calls on each (pod, worker, model) of
# BA_MULTIHOST; (b) phase 23's batch E=1 round and the worker-major slot
# pool (``mesh_rounds(pool=True)``) on (data, model) = BA_DATA_MESH;
# (c) the worker-major batch E=1 round at BA_WM's (K, S, E) (12 streams a
# group, 24 in all) on (pod 2, worker BA_WM_WORKERS)
BA_MULTIHOST = ((2, 1, 1), (2, 3, 1))
BA_STEPS = 2
# phase 30 serves qwen3-0.6b at BA_LAYERS of its 28 layers, to keep the
# whole run inside its limit with phases 34-35 added
BA_LAYERS = 8
BA_DATA_MESH = (2, 2)
BA_WM, BA_WM_WORKERS = (4, 2, 1), 2
# A9.3's first part (phases 31-33), gloo processes sharing cuda:0, fp32.
# Phase 31: qwen3-moe at full width and MOE_MESH_LAYERS of its 48 layers
# (a mesh rank builds the whole tree before it slices it): ``multihost
# --mode serve`` (K=7 S=2 E=0 over MH_SLOTS slots, BA_STEPS decode calls)
# on each (worker, model) of MOE_MESH_MULTIHOST, and phase 23's batch E=1
# round and the worker-major pool on (data, model) = MOE_MESH_DATA.
# Phase 32: qwen3-moe at full width and MOE_TRAIN_LAYERS layers,
# TRAIN_MESH_STEPS steps of ``launch.train.run`` on each (data, model) of
# MOE_TRAIN_MESH.  Phase 33: hubert-xlarge and paligemma-3b at full
# width and FRONT_MESH_LAYERS layers on a 2-way model axis: one
# ``coded_prefill`` of FRONT_GROUPS groups of K requests of FRAMES frames
# (hubert), and the batch E=1 round of MESH_GROUPS groups on 256 patches
# and FRONT_TEXT text tokens (paligemma).
MOE_MESH_LAYERS = 2
MOE_MESH_MULTIHOST = ((1, 2), (3, 1))
MOE_MESH_DATA = (2, 2)
MOE_TRAIN_LAYERS = 1
MOE_TRAIN_MESH = ((2, 1), (1, 2))
FRONT_MESH_LAYERS = {HUBERT: 4, PALIGEMMA: 2}
FRONT_GROUPS = 4
# A9.3b (phases 34-35): Mamba2's "S" blocks on the model axis, gloo
# processes sharing cuda:0, fp32.  Phase 34: B7, its scores pass, its
# backward and head sum at a model-2 rank's heads, then at full width and
# depth, all jobs at once: (a) mamba2-780m's ``multihost --mode serve
# --model-par 2`` (K=7 S=2 E=0 over MH_SLOTS slots: 72 streams, BA_STEPS
# decode calls); (b) its batch E=1 round and worker-major slot pool on
# (data, model) = SSM_MESH_DATA; (c) zamba2-1.2b's batch E=1 round at
# model 2.  Phase 35: TRAIN_MESH_STEPS steps of ``launch.train.run`` on
# each (arch, (data, model)) of SSM_TRAIN_MESH at SSM_TRAIN_CUT's depth
# (zamba2: two of its "SSSSSG" periods, so that the shared block's
# gradient sums two positions).
SSM_MESH_DATA = (2, 2)
SSM_TRAIN_MESH = (("mamba2-780m", (1, 2)), ("mamba2-780m", (2, 2)),
                  (ZAMBA2, (1, 2)))
SSM_TRAIN_CUT = {"mamba2-780m": dict(num_layers=8),
                 ZAMBA2: dict(num_layers=12, layer_pattern="SSSSSG" * 2)}
# A9.6 (phase 36): qwen3-moe at MOE_TRAIN_LAYERS layers with A96_MICRO
# microbatches on (data, model) = A96_MESH; (b)'s loss_mask drawn from
# A96_SEED.  A11 (phase 37): qwen3-0.6b's long_500k sliding variant
# (window SWA_WINDOW) at SWA_LAYERS layers, one group's SWA_PROMPT-token
# prompt and SWA_STEPS decode calls.
A96_MICRO, A96_MESH, A96_SEED = 2, (2, 1), 36
SWA_LAYERS, SWA_WINDOW, SWA_PROMPT, SWA_STEPS = 4, 4096, 4608, 8
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
# The training mesh (phases 28-29): TRAIN_ARCH at full width (phase 28
# at TRAIN_MESH_LAYERS layers), fp32, TRAIN_MESH_STEPS steps of ``launch.train.run`` at the launcher's
# TRAIN_BATCH x TRAIN_SEQ on each (data, model) of TRAIN_MESH_RUNS, gloo
# processes sharing cuda:0, held to one rank's steps; then ``multihost
# --mode train --model-par 2`` (bf16, remat) at MH_TRAIN_ARGS against one
# process of the same command.  Its losses may differ by bf16 rounding:
# the model axis sums bf16 partial products that one rank's GEMMs sum in
# fp32 (on the CPU tests' reduced model, 4.8e-4 of a loss near 12.6)
TRAIN_MESH_RUNS = ((1, 2), (2, 1), (2, 2))
TRAIN_MESH_STEPS = 2
# phase 28 trains TRAIN_ARCH at TRAIN_MESH_LAYERS of its 28 layers, to
# keep the whole run inside its limit with phases 34-35 added
TRAIN_MESH_LAYERS = 8
# phase 29 trains TRAIN_ARCH at MH_TRAIN_LAYERS of its 28 layers, to keep
# the whole run inside its limit with phases 36-37 added
MH_TRAIN_LAYERS = 8
MH_TRAIN_ARGS = ["--mode", "train", "--batch", str(TRAIN_BATCH), "--seq",
                 str(TRAIN_SEQ), "--steps", str(TRAIN_MESH_STEPS),
                 "--backend", "gloo"]
MH_TRAIN_LOSS_TOL = 2e-2
# B3's backward in turns against a parent checkout (``b3_backward_ab``):
# besides the two timed shapes, h2o-danube-1.8b's D = 80 under a window of
# 64 and paligemma-3b's D = 256 under its prefix-LM, each at AB_SHAPE
# (2 sequences of 512 tokens)
AB_SHAPE = (2, 512)
# A12: mamba2-780m and zamba2-1.2b train on the card through B7's forward
# and its backward (``ssd_chunked_bwd``, then ``ssd_bwd_head_sum``), which
# the reference does not have either: it trains through XLA's autodiff of
# its plain chunked scan.  The backward is held against its plain version
# over BWD_DRAWS draws of every variant at both models' training shapes
# (TRAIN_BATCH x TRAIN_SEQ); each model trains one step card against CPU
# at full width and TRAIN_SMALL's depth, then through ``launch.train.run``
# at full width and depth like qwen3-0.6b.  TRAIN_FAMILIES, which had
# never trained on the card, each take the card-against-CPU step at full
# width and 2 layers (qwen3-moe 1, ``TRAIN_SMALL``; paligemma on TRAIN_VLM_TEXT text tokens after its
# patches, hubert on FRAMES frames with frame targets, TRAIN_FRONT_BATCH
# sequences each).
TRAIN_SSM = ("mamba2-780m", ZAMBA2)
TRAIN_SMALL = {QWEN3_MOE: dict(num_layers=1), PALIGEMMA: dict(num_layers=1),
               "h2o-danube-1.8b": dict(num_layers=1),
               "mamba2-780m": dict(num_layers=2),
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
    if sys.argv[1:2] == ["--mesh-rank"]:
        return mesh_child(int(sys.argv[2]), Path(sys.argv[3]))
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
        # (tag, job) -> ranks started ahead of their mesh_children call
        self.started = {}
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
        # B3 and B5 at phase (b)'s model-2 shapes: {"local" | "whole":
        # {name: fp32 entry}}
        self.kernels_mp2 = {}
        # B4 and B5's block form on one of 16 ring blocks (phase 26):
        # {name: fp32 entry}; the most device memory in use while a job of
        # ``mesh_children`` ran (bytes, every process on the card)
        self.kernels_mp16 = {}
        self.mesh_peak = 0
        # B3 and its backward at a model-2 rank's training heads (phase
        # 28): {name: fp32 entry}
        self.kernels_train_mesh = {}
        # B3 and B5 at a model-2 rank's heads of qwen3-moe (bf16) and B3
        # of hubert (fp32), phases 31 and 33: {arch: {name: entry}}
        self.kernels_a93 = {}
        # B7, its scores pass, its backward and head sum at a model-2
        # rank's heads of mamba2-780m and zamba2-1.2b (fp32), phase 34:
        # {arch: {name: entry}}
        self.kernels_a93b = {}

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
        try:
            out = fn(*args)
        finally:
            for procs in self.started.values():
                for *_, p in procs:
                    if p.poll() is None:
                        p.kill()
                        p.wait()
            self.started.clear()
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
        self.free_memory()
        self.phase("qwen3-0.6b model-axis kernels", self.model_axis_kernels)
        one_rank = self.phase("qwen3-0.6b serving mesh, one rank over NCCL",
                              self.mesh_one_rank)
        mesh_launches = self.phase(
            "qwen3-0.6b model axis, ranks sharing the card", self.mesh_ranks,
            one_rank)
        del one_rank
        self.phase(f"{D80_ARCH} model axis, 2 layers, card against one rank",
                   self.mesh_h2o)
        self.free_memory()
        self.phase("qwen3-0.6b block form over 16 ring blocks",
                   self.block_form_kernels)
        mp16_launches = self.phase(
            "qwen3-0.6b model axis 16, ring blocks, ranks sharing the card",
            self.mesh_ring16)
        self.free_memory()
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
            depth = TRAIN_SMALL.get(arch, dict(num_layers=2))["num_layers"]
            self.phase(f"{arch} training, {depth} layers, card against CPU",
                       self.train_card_vs_cpu, arch)
        self.phase(f"{TRAIN_ARCH} model-2 training heads kernels",
                   self.train_mesh_kernels)
        mesh_trained = self.phase(
            f"{TRAIN_ARCH} training mesh, ranks sharing the card",
            self.train_mesh)
        mesh_trained["multihost"] = self.phase(
            f"{TRAIN_ARCH} multihost --mode train --model-par 2",
            self.train_mesh_multihost)
        self.free_memory()
        batch_axes = self.phase(
            "qwen3-0.6b pod and data axes in serving, ranks sharing the card",
            self.batch_axes)
        self.free_memory()
        self.phase("qwen3-moe and hubert model-2 heads kernels",
                   self.moe_mesh_kernels)
        a93 = {"phase 31": self.phase(
            f"{QWEN3_MOE} serving on the mesh, ranks sharing the card",
            self.moe_mesh)}
        a93["phase 32"] = self.phase(
            f"{QWEN3_MOE} training on the mesh, ranks sharing the card",
            self.moe_train_mesh)
        a93["phase 33"] = self.phase(
            "paligemma-3b and hubert-xlarge on the model axis, ranks "
            "sharing the card", self.front_mesh)
        self.free_memory()
        self.phase("mamba2 and zamba2 model-2 heads kernels",
                   self.ssm_mesh_kernels)
        a93b = {"phase 34": self.phase(
            "mamba2-780m and zamba2-1.2b serving on the model axis, ranks "
            "sharing the card", self.ssm_mesh)}
        a93b["phase 35"] = self.phase(
            "mamba2-780m and zamba2-1.2b training on the model axis, ranks "
            "sharing the card", self.ssm_train_mesh)
        self.free_memory()
        a96 = self.phase(f"{QWEN3_MOE} microbatches on a split batch, ranks "
                         "sharing the card", self.micro_train_mesh)
        self.free_memory()
        swa_launches = self.phase("qwen3-0.6b long_500k sliding variant",
                                  self.sliding_variant)
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
                    "launches_train_remat": trained[TRAIN_ARCH][True][name],
                    "train_mesh": self.train_mesh_entry(name, mesh_trained)}
                   if name == "flash_attention" else {}),
                **(self.ssd_train_launches(name, trained)
                   if name.startswith("ssd_") else {}),
                **({"model_par_2": self.mp2_entry(name, mesh_launches),
                    "model_par_16": self.mp16_entry(name, mp16_launches),
                    "batch_axes": {run: [r[name] for r in ranks]
                                   for run, ranks in batch_axes.items()},
                    "a9_3": self.a93_entry(name, a93),
                    "a9_3b": self.a93b_entry(name, a93b)}
                   if name in MP2_KERNELS else {}),
                **({"model_par_2": self.a93b_entry(name, a93b)}
                   if name in SSD_KERNELS else {}),
            })
        entries += [dict(self.train_entry(name, trained[TRAIN_ARCH]),
                         train_mesh=self.train_mesh_entry(name, mesh_trained),
                         a9_3=self.a93_entry(name, a93))
                    for name in ("flash_attention_bwd",
                                 "flash_attention_bwd_delta")]
        entries += [dict(self.ssd_train_entry(name, trained),
                         model_par_2=self.a93b_entry(name, a93b))
                    for name in ("ssd_chunked_bwd", "ssd_bwd_head_sum")]
        for entry in entries:
            name = entry["name"]
            if any(r[name] for ranks in a96.values() for r in ranks):
                entry["a9_6"] = {run: [r[name] for r in ranks]
                                 for run, ranks in a96.items()}
            if swa_launches["launches"].get(name):
                entry["long_500k"] = dict(
                    launches=swa_launches["launches"][name],
                    **swa_launches["held"].get(name, {}))
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

    def train_entry(self, name: str, launches: dict) -> dict:
        """The kernels line's entry of one of B3's backward launches
        (``flash_attention_bwd``, or its Delta launch
        ``flash_attention_bwd_delta``): its fp32 check and times at the
        training shape, its launches in the full-depth run (and under
        remat), and the same numbers at ``LONG_SHAPE``."""
        at = "" if name == "flash_attention_bwd" else "delta_"
        res = self.kernels_train[at + "train"]
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
                       "scaled_dot_product_attention" if not at
                       else "torch.linalg.vecdot of o and dO",
            "graph_ms": res["graph_ms"],
            "tensor_cores": self.tensor_cores[name],
            "long": {key: self.kernels_train[at + "long"][key]
                     for key in keys}}

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
        # one cuobjdump a library, all started together
        procs = [subprocess.Popen([str(cuobjdump), "-sass", str(lib)],
                                  stdout=subprocess.PIPE, text=True)
                 for lib in libs.values()]
        for proc in procs:
            sass = proc.communicate(timeout=300)[0]
            if proc.returncode != 0:
                raise AssertionError(f"cuobjdump -sass failed: {proc.args}")
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
                       gen=None, streams=None, prompt=PROMPT):
        """B7 at the mamba2 prefill's shapes: 44 coded streams (G=4, K=4,
        S=1, E=1) x 256 steps x 48 heads of 64, state 128; or at ``cfg``'s
        (zamba2: 64 heads of 64, state 64), its fp32 numbers in
        ``table``; or at ``streams`` x ``prompt`` steps."""
        torch = self.torch
        from repro_torch.configs import mamba2_780m
        from repro_torch.core.berrut import CodingConfig
        from repro_torch.kernels import ops, ref, ssd_scan
        from repro_torch.models.mamba2 import ssd_chunk
        dtype = getattr(torch, dtype_name)
        size = dtype.itemsize
        cfg = cfg or mamba2_780m.CONFIG
        b = streams or GROUPS * CodingConfig(k=K, s=S, e=E).num_workers
        h, p, n = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
        args = self.ssd_inputs(b, prompt, h, p, n, dtype, gen=gen)
        x, dt, a_log, bb, cc, d = args
        chunk = ssd_chunk(cfg.ssm_chunk, prompt)
        (y, hf), (yr, hr) = (ops.ssd(*args),
                             ref.ssd_chunked_ref(*args, chunk=chunk))
        out = {"variant": f"ssd_chunked {cfg.name} h_final ({dtype_name})"}
        out.update(self.check(out["variant"], hf, hr, "float32"))
        emit(out)
        # the scores pass alone: C B^T of each of the kernel's chunks (the
        # library call on contiguous copies of the chunked b and c)
        q = ssd_scan.CHUNK
        nc = -(-prompt // q)
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
            ssd_ops(b, prompt, h, p, n), table=table)

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
                          pool: bool, worker_major: bool = False,
                          layers: int = 0) -> dict:
        """Launches of every kernel over ``prefills`` prefill and
        ``decodes`` decode calls of ``arch``: one encode (B6 when worker-
        major, else B1) and one tail per call, and each call's kernels of
        ``PATH_KERNELS`` (which must agree with the config's pattern), or
        of a dense decoder cut to ``layers``."""
        from repro_torch import configs
        from repro_torch.kernels import ops
        table = per_call(layers, 0) if layers else PATH_KERNELS[arch]
        if not layers and \
                table != pattern_kernels(configs.get_config(arch)):
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
        """B3's backward (``flash_attention_bwd``: the Delta launch, then
        the dk/dv and dq blocks in one launch) and the forward's row
        log-sum-exp against their plain versions (``ref.attention_bwd_ref``
        and ``ref.attention_delta_ref``, given the kernel's own output and
        log-sum-exp, and ``ref.attention_lse_ref``; in fp32 also autograd
        of the plain forward ``ref.attention_ref``), at qwen3-0.6b's
        training shape (8 sequences of 128 tokens, GQA 16/8 of 128, causal)
        and at 4 x 2048, timed: the kernel (``ms``, ``graph_ms``), its plain
        version, and, as a yardstick only, the backward of autograd through
        SDPA with the same causal mask (``library_ms``); the Delta launch
        alone beside its plain version and ``torch.linalg.vecdot``.  The
        bound counts 10 D flops a visible (row, key) pair (S, dP, dq, dk
        and dv: five products) against q, k, v, o, dO and the log-sum-exp
        read once and dq, dk, dv written once.  At both shapes two calls
        must agree bitwise (``b3_backward_repeat``), and each launch's
        device bytes are printed beside its time (``b3_backward_bytes``).
        First, every head dim's ``bwd_info`` (at least two cp.async stages
        and no spills, asserted).  Then, untimed, every rule at every head
        dim (64, 80, 128, 256) and GQA ratio 1, 2 and 8: h2o-danube's
        window at D = 80, paligemma's prefix-LM at D = 256 rep 8, softcap,
        q_offset, and rows that see no key (q_offset -5: their dq exactly
        0, their log-sum-exp -inf, as the plain version's)."""
        torch = self.torch
        from repro_torch import configs
        from repro_torch.kernels import flash_attention as fa, ref
        dtype = getattr(torch, dtype_name)
        gen = self.train_gen
        self.b3_backward_occupancy(dtype_name)
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
            self.b3_backward_repeat(where, dtype_name, q, k, v, out, lse, do)
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
            delta = self.b3_delta_timing(key, dtype_name, out, do)
            self.b3_backward_bytes(key, dtype_name, q, k, v, out, lse, do,
                                   res, delta)
            if dtype_name == "float32":
                self.kernels_train[key] = res
                self.kernels_train["delta_" + key] = delta
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
        worst = 0.0
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
            worst = max(worst, out["err_over_tol"])
            emit(out)
        emit({"b3_backward_worst": dtype_name, "variants": len(cases),
              "err_over_tol": worst})

    def b3_backward_occupancy(self, dtype_name: str) -> None:
        """``bwd_info`` of B3's backward at every head dim: at least two
        cp.async stages in the main launch and no spills in either launch,
        asserted."""
        from repro_torch.kernels import flash_attention as fa
        dtype = getattr(self.torch, dtype_name)
        for d in fa.HEAD_DIMS:
            info = fa.bwd_info(d, dtype, self.dev)
            emit({"b3_backward_occupancy": dtype_name, "D": d, **info})
            if info["main"]["stages"] < 2 or any(
                    launch["local_bytes"] for launch in info.values()):
                raise AssertionError(f"flash_attention_bwd D={d} "
                                     f"{dtype_name}: {info}: fewer than two "
                                     f"stages, or spills")

    def b3_backward_repeat(self, where: str, dtype_name: str, q, k, v, out,
                           lse, do) -> None:
        """Two calls of B3's backward on the same inputs give dq, dk and dv
        bitwise equal (no atomics; every element summed in one order)."""
        from repro_torch.kernels import flash_attention as fa
        first = fa.flash_attention_bwd(q, k, v, out, lse, do)
        again = fa.flash_attention_bwd(q, k, v, out, lse, do)
        for name, g, w in zip(("dq", "dk", "dv"), again, first):
            if not self.torch.equal(g, w):
                raise AssertionError(f"{where} {name} ({dtype_name}): two "
                                     f"calls on the same inputs differ")
        emit({"b3_backward_repeat": where, "dtype": dtype_name,
              "bitwise_equal": True})

    def b3_delta_timing(self, key: str, dtype_name: str, out, do) -> dict:
        """The backward's Delta launch alone at a timed shape: checked
        against ``ref.attention_delta_ref``, timed beside it and beside
        ``torch.linalg.vecdot`` of o and dO (its yardstick); bound by o and
        dO read and Delta written once."""
        torch = self.torch
        from repro_torch.kernels import flash_attention as fa, ref
        b, s, h, _ = out.shape
        res = {"kernel": "flash_attention_bwd_delta", "dtype": dtype_name,
               "shape": [list(out.shape)], "at": key}
        res.update(self.check("flash_attention_bwd_delta",
                              fa.flash_attention_bwd_delta(out, do),
                              ref.attention_delta_ref(out, do), "float32"))
        res["ms"] = self.time_ms(lambda: fa.flash_attention_bwd_delta(out, do))
        res["graph_ms"] = self.graph_ms(
            lambda: fa.flash_attention_bwd_delta(out, do))
        res["plain_ms"] = self.time_ms(lambda: ref.attention_delta_ref(out, do))
        res["library_ms"] = self.time_ms(lambda: torch.linalg.vecdot(out, do))
        res["bound_ms"], res["bound_by"] = self.bound(
            2 * out.numel() * out.dtype.itemsize + 4 * b * h * s,
            2 * out.numel(), dtype_name)
        emit(res)
        return res

    def b3_backward_bytes(self, key: str, dtype_name: str, q, k, v, out, lse,
                          do, res: dict, delta: dict) -> None:
        """Each launch of B3's backward at a timed shape, its device bytes
        against its graph time.  Delta: o and dO read, Delta written once.
        The main launch, timed alone on a Delta computed before: q, k, v,
        dO, lse and Delta read once, dq, dk and dv written once
        (``inputs_outputs``), and what its blocks copy into shared memory
        (``staged``: each block's own rows once and its streamed tiles,
        from ``b3_bwd_staged`` and ``bwd_info``'s tiles; mostly L2 hits)."""
        torch = self.torch
        from repro_torch.kernels import flash_attention as fa
        b, s, h, d = q.shape
        l, kvh = k.shape[1], k.shape[2]
        size = q.dtype.itemsize
        tiles = fa.bwd_info(d, q.dtype, self.dev)["main"]
        dl = fa.flash_attention_bwd_delta(out, do)
        dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
        code = 0 if q.dtype == torch.float32 else 1

        def main():
            fa.BWD_KERNEL.launch(
                self.dev, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                do.data_ptr(), lse.data_ptr(), dl.data_ptr(), dq.data_ptr(),
                dk.data_ptr(), dv.data_ptr(), b, s, l, h, kvh, d, 1, -1, 0,
                0.0, 0, 1.0 / d ** 0.5, code)

        main_ms = self.graph_ms(main)
        io = (2 * q.numel() + 2 * k.numel()) * size + 8 * b * h * s \
            + (q.numel() + 2 * k.numel()) * size
        staged = b3_bwd_staged(b, s, l, h, kvh, d, size, tiles["rows"],
                               tiles["tile"])
        delta_bytes = 2 * out.numel() * size + 4 * b * h * s
        emit({"b3_backward_bytes": key, "dtype": dtype_name,
              "delta": {"bytes": delta_bytes, "graph_ms": delta["graph_ms"],
                        "tb_per_s": delta_bytes / (delta["graph_ms"] * 1e-3)
                        / 1e12},
              "main": {"inputs_outputs": io, "staged": staged,
                       "graph_ms": main_ms,
                       "tb_per_s": io / (main_ms * 1e-3) / 1e12,
                       "staged_tb_per_s": sum(staged.values())
                       / (main_ms * 1e-3) / 1e12},
              "both_graph_ms": res["graph_ms"]})

    def b3_backward_ab(self, dtype_name: str) -> None:
        """B3's backward checked against its plain version and timed at the
        two timed shapes and, at AB_SHAPE, under h2o-danube-1.8b's D = 80
        (window 64) and paligemma-3b's D = 256 (prefix-LM), on inputs from
        a generator of its own: what ``scripts/flash_decode_ab.py --kernel
        flash_attention_bwd`` runs on each checkout.  It calls only what
        every checkout since B3's backward has (``flash_attention`` with
        its log-sum-exp, ``flash_attention_bwd``,
        ``ref.attention_bwd_ref``)."""
        torch = self.torch
        from repro_torch import configs
        from repro_torch.kernels import flash_attention as fa, ref
        dtype = getattr(torch, dtype_name)
        gen = torch.Generator(self.dev).manual_seed(14)
        qwen = configs.get_config(TRAIN_ARCH)
        h2o = configs.get_config(D80_ARCH)
        pali = configs.get_config(PALIGEMMA)
        sdpa = torch.nn.functional.scaled_dot_product_attention
        for variant, cfg, (b, s), rule in (
                ("train", qwen, (TRAIN_BATCH, TRAIN_SEQ), {}),
                ("long", qwen, LONG_SHAPE, {}),
                (f"{D80_ARCH} window", h2o, AB_SHAPE, dict(window=64)),
                (f"{PALIGEMMA} prefix", pali, AB_SHAPE,
                 dict(prefix=pali.num_patches))):
            h, kvh, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
            q = self.randn(b, s, h, hd, dtype=dtype, gen=gen)
            k = self.randn(b, s, kvh, hd, dtype=dtype, gen=gen)
            v = self.randn(b, s, kvh, hd, dtype=dtype, gen=gen)
            do = self.randn(b, s, h, hd, dtype=dtype, gen=gen)
            out, lse = fa.flash_attention(q, k, v, return_lse=True, **rule)
            got = fa.flash_attention_bwd(q, k, v, out, lse, do, **rule)
            want = ref.attention_bwd_ref(q, k, v, out, lse, do, **rule)
            where = f"flash_attention_bwd {variant} B={b} S={s} D={hd}"
            res = {"kernel": "flash_attention_bwd", "variant": variant,
                   "dtype": dtype_name,
                   "shape": [list(q.shape), list(k.shape)], "rule": rule}
            res.update(max((self.check(f"{where} {name}", g, w, dtype_name)
                            for name, g, w in zip(("dq", "dk", "dv"), got,
                                                  want)),
                           key=lambda r: r["err_over_tol"]))
            del got, want
            res["ms"] = self.time_ms(
                lambda: fa.flash_attention_bwd(q, k, v, out, lse, do, **rule))
            res["graph_ms"] = self.graph_ms(
                lambda: fa.flash_attention_bwd(q, k, v, out, lse, do, **rule))
            res["library_ms"] = None
            if not rule:
                qs, ks, vs = (t.transpose(1, 2).detach().requires_grad_(True)
                              for t in (q, k, v))
                so = sdpa(qs, ks, vs, is_causal=True, enable_gqa=True)
                dos = do.transpose(1, 2)
                res["library_ms"] = self.time_ms(lambda: torch.autograd.grad(
                    so, (qs, ks, vs), dos, retain_graph=True))
                del so, qs, ks, vs
            pairs = visible_pairs(s, causal=True, window=rule.get("window"),
                                  prefix=rule.get("prefix", 0))
            res["bound_ms"], res["bound_by"] = self.bound(
                4 * (q.numel() + k.numel()) * dtype.itemsize
                + 4 * lse.numel(), 10 * hd * pairs * b * h, dtype_name)
            emit(res)

    def b3_backward_checks(self, where: str, dtype_name: str, q, k, v, do,
                           rule: dict) -> dict:
        """dq, dk, dv, Delta and the log-sum-exp of B3 against their plain
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
                              want_lse[seen], "float32"),
                   self.check(f"{where} delta {rule}",
                              fa.flash_attention_bwd_delta(out, do),
                              ref.attention_delta_ref(out, do), "float32")]
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
                           chunk: int, got, want, table=None) -> None:
        """Time B7's backward at a training shape (no h0, no gradient of
        h_final, as in training) and its head sum alone; the fp32 numbers
        go to ``kernels_ssd_train``, or by name to ``table``."""
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
        if table is not None:
            table.update(ssd_chunked_bwd=res, ssd_bwd_head_sum=hs)
        elif dtype_name == "float32":
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
        "SSSSSG"; qwen3-moe, paligemma and h2o-danube 1), card against
        CPU, on the same weights (drawn on the
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
        # the comparison runs on the card, a leaf at a time: the same fp32
        # element-wise ops as on the host, without its passes over GBs
        before = {keystr(k): t for k, t in flatten_with_path(params["cpu"])}
        gmu = {keystr(k): t for k, t in flatten_with_path(go.mu)}
        gnew = {keystr(k): t for k, t in flatten_with_path(gp)}
        worst_g = worst_p = 0.0
        strong = total = 0
        for (path, mu), (_, newp) in zip(flatten_with_path(co.mu),
                                         flatten_with_path(cp)):
            key = keystr(path)
            mu, newp = mu.to(self.dev), newp.to(self.dev)
            g_cpu, g_card = mu / (1 - b1), gmu[key] / (1 - b1)
            tol = 1e-4 * max(g_cpu.abs().max().item(), 1e-30)
            worst_g = max(worst_g, (g_card - g_cpu).abs().max().item() / tol)
            p0 = before[key].to(self.dev).abs()
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
        # the kernels this checkout counts (``scripts/flash_decode_ab.py
        # --train`` runs older checkouts through this method too)
        expected = {name: 0 for name in launched}
        expected.update({name: n for name, n in train_launches(
            configs.get_config(arch), TRAIN_STEPS, remat).items()
            if name in launched})
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

    # ------------------------------------------------- the serving mesh

    def mesh_inputs(self, cfg, coding_args=(K, S, E)) -> dict:
        """The batch E=1 round's inputs on the card, drawn from
        ``MESH_SEED``: MESH_GROUPS groups of K prompts of MESH_PROMPT
        tokens, MESH_STEPS fixed next tokens, one straggler, a sigma-10
        attacker and its (G, N+1, V) noise, at ``coding_args`` (K, S,
        E)."""
        torch = self.torch
        from repro_torch.core.berrut import CodingConfig
        n1 = CodingConfig(*coding_args).num_workers
        gen = torch.Generator(self.dev).manual_seed(MESH_SEED)
        rows = MESH_GROUPS * coding_args[0]
        mask = torch.ones(n1, device=self.dev)
        mask[MESH_STRAGGLER] = 0.0
        byz = torch.zeros(n1, device=self.dev)
        byz[MESH_ATTACKER] = 1.0
        return {"tokens": torch.randint(0, cfg.vocab_size,
                                        (rows, MESH_PROMPT), generator=gen,
                                        device=self.dev),
                "steps": torch.randint(0, cfg.vocab_size,
                                       (MESH_STEPS, rows, 1), generator=gen,
                                       device=self.dev),
                "mask": mask, "byz": byz,
                "noise": torch.randn((MESH_GROUPS, n1, cfg.vocab_size),
                                     generator=gen, device=self.dev)}

    def mesh_children(self, jobs: list, tag: str,
                      together: bool = False) -> list:
        """Start one process per rank of every job in ``jobs`` (each a
        dict with "world"; the processes share cuda:0 over gloo), one job
        after another or with ``together`` all at once, each rank's
        output to its log beside its results, and a job's "env" added to
        its processes' environment.  A rank that fails, or a
        batch of jobs that outlives MESH_TIMEOUT_S, fails the phase at
        once (every rank of the batch is killed).  Returns each job's
        per-rank results."""
        out = []
        for batch in ([list(enumerate(jobs))] if together
                      else [[jj] for jj in enumerate(jobs)]):
            works, procs = [], []
            try:
                for j, job in batch:
                    work = ROOT / "build" / "mesh" / f"{tag}{j}"
                    started = self.started.pop((tag, j), None)
                    procs += started or self.spawn_ranks(j, work, job)
                    # the ranks wait for their job: written whole, then
                    # renamed
                    (work / "job.tmp").write_text(json.dumps(job))
                    os.replace(work / "job.tmp", work / "job.json")
                    works.append((j, work, job["world"]))
                deadline = time.monotonic() + MESH_TIMEOUT_S
                while any(p.poll() is None for *_, p in procs):
                    free, total = self.torch.cuda.mem_get_info(self.dev)
                    self.mesh_peak = max(self.mesh_peak, total - free)
                    failed = [(j, r, log) for j, r, log, p in procs
                              if p.poll() not in (None, 0)]
                    if failed or time.monotonic() > deadline:
                        j, r, log = failed[0] if failed else procs[0][:3]
                        raise AssertionError(
                            f"{tag} job {j} rank {r} "
                            f"{'failed' if failed else 'timed out'}:\n"
                            f"{log.read_text()[-4000:]}")
                    time.sleep(0.2)
            finally:
                for *_, p in procs:
                    if p.poll() is None:
                        p.kill()
                        p.wait()
            for j, r, log, p in procs:
                if p.returncode != 0:
                    raise AssertionError(f"{tag} job {j} rank {r} failed:\n"
                                         f"{log.read_text()[-4000:]}")
            out += [[self.torch.load(work / f"rank{r}.pt", weights_only=False)
                     for r in range(world)] for _, work, world in works]
        return out

    def spawn_ranks(self, j: int, work: Path, job: dict) -> list:
        """Empty ``work`` and start one process per rank of ``job`` there,
        each waiting for its job.json, with the job's "env"."""
        if work.exists():
            for old in work.iterdir():
                old.unlink()
        work.mkdir(parents=True, exist_ok=True)
        procs = []
        for r in range(job["world"]):
            with open(work / f"rank{r}.log", "w") as f:
                procs.append((j, r, work / f"rank{r}.log", subprocess.Popen(
                    [sys.executable, str(ROOT / "chip_smoke.py"),
                     "--mesh-rank", str(r), str(work)],
                    stdout=f, stderr=subprocess.STDOUT,
                    env=dict(os.environ, **job.get("env", {})))))
        return procs

    def start_ranks(self, jobs: list, tag: str) -> None:
        """Start the processes of ``mesh_children(jobs, tag, ...)`` now,
        while this one computes the phase's references: each imports
        torch and the port and takes cuda:0, then waits for the job.json
        that ``mesh_children`` writes.  Ranks no phase took are killed at
        the phase's end (``phase``)."""
        for j, job in enumerate(jobs):
            self.started[(tag, j)] = self.spawn_ranks(
                j, ROOT / "build" / "mesh" / f"{tag}{j}", job)

    def mesh_one_rank(self) -> dict:
        """Phase (a): qwen3-0.6b at full width and depth, fp32, through
        the mesh code on one rank over NCCL: ``multihost --mode serve`` at
        its defaults with ``--s 3`` (K=7 S=3 E=0, 8 slots of 128-token
        prompts, MESH_STEPS decode calls) against the same pool served
        with no mesh, and the batch E=1 round (``mesh_rounds``) on a
        one-rank (data, model) mesh against no mesh: tokens, logits and
        verdicts bitwise equal.  The one-rank mesh builds no group, so no
        collective runs here: the phase checks the padding and
        ``local_shard``'s pass-through.  Returns the no-mesh outputs (and
        each multihost call's decoded logits), which phase (b) is held
        to."""
        torch = self.torch
        import torch.distributed as dist
        from repro_torch import configs
        from repro_torch.launch import multihost, shardings
        from repro_torch.launch import worker_mesh as wm
        from repro_torch.launch.mesh import make_host_mesh
        from repro_torch.models import partitioning
        from repro_torch.models.model import init_params
        store = ROOT / "build" / "mesh-store"
        store.parent.mkdir(parents=True, exist_ok=True)
        store.unlink(missing_ok=True)
        decoded = []
        real = wm.sample_tokens

        def sample(dec, *args, **kw):
            decoded.append(dec.float().cpu())
            return real(dec, *args, **kw)

        wm.sample_tokens = sample
        try:
            res = multihost.main(mesh_multihost_argv(store, 1, 0, 1))
        finally:
            wm.sample_tokens = real
            store.unlink(missing_ok=True)
        pool_logits = decoded
        # the same pool with no mesh at all
        cfg = configs.get_config("qwen3-0.6b").with_updates(
            param_dtype="float32", activation_dtype="float32")
        plain, decoded = self.plain_pool(cfg, MESH_S, MH_SLOTS, MESH_STEPS)
        if not np.array_equal(plain, res["tokens"]) or any(
                not torch.equal(a, b) for a, b in zip(decoded, pool_logits)):
            raise AssertionError("one-rank multihost serve differs from the "
                                 "pool with no mesh")
        emit({"mesh_one_rank": "multihost serve qwen3-0.6b fp32 K=7 S=3 "
              "W=1 M=1 (NCCL)", "tokens_equal": True, "logits_equal": True,
              "calls": len(decoded), "prefill_ms": res["call_ms"]["prefill"],
              "decode_ms": res["call_ms"]["decode"]})
        # the batch E=1 round, with no mesh and on a one-rank mesh
        inputs = self.mesh_inputs(cfg)
        params = init_params(cfg, torch.Generator(self.dev).manual_seed(
            MESH_SEED), self.dev)
        plain = mesh_rounds(cfg, params, inputs)
        dist.init_process_group("nccl", init_method=f"file://{store}",
                                world_size=1, rank=0)
        try:
            mesh = make_host_mesh()
            with partitioning.mesh_context(mesh):
                local = shardings.local_shard(
                    params, shardings.serving_param_specs(mesh, cfg, params),
                    mesh)
                meshed = mesh_rounds(cfg, local, inputs)
        finally:
            dist.destroy_process_group()
            store.unlink(missing_ok=True)
        for i, ((lp, vp), (lm, vm)) in enumerate(zip(plain["batch"],
                                                     meshed["batch"])):
            if not (torch.equal(lp, lm) and torch.equal(vp, vm)):
                raise AssertionError(f"batch call {i}: the one-rank mesh "
                                     "differs from no mesh")
            if not vp[:, MESH_ATTACKER].all():
                raise AssertionError(f"batch call {i}: attacker not located")
        emit({"mesh_one_rank": "batch E=1 round qwen3-0.6b fp32 on a "
              "(data 1, model 1) mesh (NCCL)", "calls": len(plain["batch"]),
              "logits_equal": True, "verdicts_equal": True})
        del params, local
        self.free_memory()
        return {"tokens": res["tokens"], "pool_logits": pool_logits,
                "batch": plain["batch"], "inputs": inputs}

    def plain_pool(self, cfg, s: int, slots: int, steps: int):
        """The multihost serve's pool with no mesh: ``ContinuousLLMExecutor``
        on multihost's seed-0 weights and prompts (K=MH_K, S=``s``, E=0,
        ``slots`` group slots of MH_PROMPT-token prompts over a
        MH_WIDTH-slot ring, all admitted, all workers answering) for
        ``steps`` decode calls.  Returns (tokens (steps + 1, slots * K),
        each call's decoded logits on the host)."""
        torch = self.torch
        from repro_torch.core.berrut import CodingConfig
        from repro_torch.launch import worker_mesh as wm
        from repro_torch.launch.worker_mesh import WorkerShardConfig
        from repro_torch.models.model import init_params
        from repro_torch.serving.continuous import ContinuousLLMExecutor
        coding = CodingConfig(k=MH_K, s=s, e=0)
        params = init_params(cfg, torch.Generator(self.dev).manual_seed(0),
                             self.dev)
        ex = ContinuousLLMExecutor(
            cfg, coding, params, pool_groups=slots, max_len=MH_WIDTH,
            wshard=WorkerShardConfig(gather_width=coding.num_workers))
        state = ex.init_state()
        prompts = np.random.RandomState(0).randint(
            0, cfg.vocab_size, (slots * MH_K, MH_PROMPT))
        admit = np.ones((slots,), np.float32)
        full = np.ones((coding.num_workers,), np.float32)
        decoded = []
        real = wm.sample_tokens

        def sample(dec, *args, **kw):
            decoded.append(dec.float().cpu())
            return real(dec, *args, **kw)

        wm.sample_tokens = sample
        try:
            toks, state, _ = ex.prefill(state, prompts, admit, full)
            plain = [toks]
            for _ in range(steps):
                toks, state, _ = ex.decode(state, toks.reshape(-1, 1), admit,
                                           full)
                plain.append(toks)
        finally:
            wm.sample_tokens = real
        del ex, state, params
        self.free_memory()
        return np.stack(plain), decoded

    def mesh_ranks(self, one_rank: dict) -> dict:
        """Phase (b): ``multihost --mode serve`` (phase (a)'s settings) on
        each (worker, model) of MESH_RUNS, as 2-4 processes sharing cuda:0
        over gloo, and phase (a)'s batch E=1 round at model 2 after the
        (1, 2) run: every rank's tokens the same, held to phase (a)'s up
        to the first near tie (``near_tie_rows``), each rank's decoded
        logits of those calls (at W = 2 its worker's vocabulary block)
        within MESH_TOL of phase (a)'s, the batch round's logits within
        MESH_TOL and its verdicts equal;
        per-rank launches held to the one-rank tables and printed with
        each call's collective bytes by op and its wall time (gloo over
        the host).  Returns the (1, 2) run's per-rank launches."""
        torch = self.torch
        inputs_path = ROOT / "build" / "mesh" / "inputs.pt"
        inputs_path.parent.mkdir(parents=True, exist_ok=True)
        torch.save({k: v.cpu() for k, v in one_rank["inputs"].items()},
                   inputs_path)
        jobs = [{"kind": "multihost", "world": w * m, "model": m,
                 "batch": (w, m) == (1, 2), "inputs": str(inputs_path)}
                for w, m in MESH_RUNS]
        # (1, 2) and (2, 1) at once, then (2, 2)
        runs = (self.mesh_children(jobs[:2], "qwen3-", together=True)
                + self.mesh_children(jobs[2:], "qwen3-b"))
        want_pool = self.expected_launches("qwen3-0.6b", 1, MESH_STEPS,
                                           pool=True, worker_major=True)
        want_batch = self.expected_launches("qwen3-0.6b", 1, MESH_STEPS,
                                            pool=False)
        shown = ("berrut_apply", "berrut_encode_dispatch",
                 "fused_group_decode", "flash_attention", "flash_decode",
                 "pool_flash_decode")
        out = {}
        for (w, m), ranks in zip(MESH_RUNS, runs):
            where = f"multihost serve qwen3-0.6b fp32 W={w} M={m} (gloo)"
            for r, res in enumerate(ranks):
                if not np.array_equal(res["tokens"], ranks[0]["tokens"]):
                    raise AssertionError(f"{where}: rank {r}'s tokens differ")
                if res["launches"] != want_pool:
                    raise AssertionError(f"{where} rank {r}: launches "
                                         f"{res['launches']} != {want_pool}")
            held = near_tie_rows(where, ranks[0]["tokens"],
                                 one_rank["tokens"], one_rank["pool_logits"])
            want = one_rank["pool_logits"]
            vloc = want[0].shape[-1] // w
            pool_worst = 0.0
            for r, res in enumerate(ranks):
                if len(res["pool_logits"]) != len(want):
                    raise AssertionError(
                        f"{where} rank {r}: {len(res['pool_logits'])} "
                        f"decoded calls, one rank had {len(want)}")
                # rank r is worker r // m's; at W > 1 it decodes that
                # worker's block of the vocabulary.  A call's logits are
                # held while its inputs equal phase (a)'s: up to and
                # including the call of the first near tie
                block = slice((r // m) * vloc, (r // m + 1) * vloc)
                for i in range(min(held + 1, len(want))):
                    pool_worst = max(pool_worst, logits_share(
                        f"{where} rank {r} call {i}", res["pool_logits"][i],
                        want[i][:, block]))
            ms = ranks[0]["call_ms"]
            emit({"mesh_run": where, "ranks": w * m,
                  "tokens_held_calls": held,
                  "pool_logits_worst_err_over_tol": pool_worst,
                  "launches_per_rank": [{k: res["launches"][k]
                                         for k in shown} for res in ranks],
                  "collective_bytes_per_call": ranks[0]["call_bytes"],
                  "prefill_ms_gloo_over_host": ms["prefill"][0],
                  "decode_ms_gloo_over_host": ms["decode"]})
            out[w, m] = [res["launches"] for res in ranks]
            if (w, m) != (1, 2):
                continue
            where = "batch E=1 round qwen3-0.6b fp32 model 2 (gloo)"
            worst = 0.0
            for r, res in enumerate(ranks):
                if res["batch_launches"] != want_batch:
                    raise AssertionError(f"{where} rank {r}: launches "
                                         f"{res['batch_launches']} != "
                                         f"{want_batch}")
                worst = max(worst, hold_calls(
                    f"{where} rank {r}", res["batch"], one_rank["batch"]))
            emit({"mesh_run": where, "worst_err_over_tol": worst,
                  "launches_per_rank": [{k: res["batch_launches"][k]
                                         for k in shown} for res in ranks],
                  "collective_bytes_per_call": ranks[0]["batch_bytes"],
                  "call_ms_gloo_over_host": ranks[0]["batch_ms"]})
            out["batch"] = [res["batch_launches"] for res in ranks]
        return out

    def mesh_h2o(self):
        """Phase (c): h2o-danube-1.8b at full width and 2 layers, fp32,
        at model 2 (two processes sharing cuda:0 over gloo): the batch
        E=1 round and the slot pool (``mesh_rounds``) against the same on
        one rank on the card with no mesh: logits within MESH_TOL, tokens
        up to near ties, verdicts equal, each rank's caches its block of
        the one-rank caches' kv-heads (MESH_TOL), launches per rank."""
        torch = self.torch
        from repro_torch import configs
        from repro_torch.models.model import init_params
        cfg = mesh_h2o_config(configs)
        path = ROOT / "build" / "mesh" / "inputs-h2o.pt"
        jobs = [{"kind": "h2o", "world": 2, "model": 2, "inputs": str(path)}]
        self.start_ranks(jobs, "h2o-")
        inputs = self.mesh_inputs(cfg)
        params = init_params(cfg, torch.Generator(self.dev).manual_seed(
            MESH_SEED), self.dev)
        plain = mesh_rounds(cfg, params, inputs, pool=True)
        del params
        torch.save({k: v.cpu() for k, v in inputs.items()}, path)
        ranks = self.mesh_children(jobs, "h2o-")[0]
        where = f"{D80_ARCH} 2 layers model 2 (gloo)"
        worst = 0.0
        for r, res in enumerate(ranks):
            for kind in ("batch", "pool"):
                worst = max(worst, hold_calls(f"{where} {kind} rank {r}",
                                              res[kind], plain[kind]))
                for i, (mine, whole) in enumerate(zip(res[kind + "_caches"],
                                                      plain[kind
                                                            + "_caches"])):
                    for name, leaf in whole.items():
                        kv = leaf.shape[3] // 2
                        blk = leaf[:, :, :, r * kv:(r + 1) * kv]
                        if not torch.allclose(mine[name], blk,
                                              rtol=MESH_TOL[0],
                                              atol=MESH_TOL[1]):
                            raise AssertionError(
                                f"{where} {kind} rank {r}: run {i} cache "
                                f"{name} is not its kv-head block")
            want = {"flash_attention": cfg.num_layers,
                    "flash_decode": cfg.num_layers * MESH_STEPS,
                    "pool_flash_decode": cfg.num_layers * MESH_STEPS}
            got = {k: res["batch_launches"][k] + res["pool_launches"][k]
                   for k in want}
            want["flash_attention"] *= 2            # batch and pool prefill
            if got != want:
                raise AssertionError(f"{where} rank {r}: launches {got} != "
                                     f"{want}")
        emit({"mesh_run": where, "worst_err_over_tol": worst,
              "caches": "kv-head blocks", "launches_per_rank": [
                  {kind: res[kind + "_launches"] for kind in ("batch",
                                                              "pool")}
                  for res in ranks],
              "collective_bytes_per_call": ranks[0]["batch_bytes"]})

    def model_axis_kernels(self):
        """B3 and B5 at the shapes of phase (b)'s model-2 multihost run
        (80 streams of 128-token prompts; the pool decode over a 256-slot
        ring at per-stream depths with dead streams), fp32, at a rank's
        heads (GQA 8/4 of 128) and at the whole model's (16/8), checked
        and timed as at every other shape (``kernels_mp2``); the key
        splits ``plan_splits`` picks from a rank's kv-heads and the
        whole model's at phases 23-24's decode shapes (the batch round's
        22 streams over a 133-slot ring, the pool's 80 over 256)."""
        from repro_torch import configs
        from repro_torch.core.berrut import CodingConfig
        from repro_torch.kernels import flash_decode
        gen = self.torch.Generator(self.dev).manual_seed(14)
        whole = configs.get_config("qwen3-0.6b")
        streams = MH_SLOTS * (MH_K + MESH_S)
        sms = self.torch.cuda.get_device_properties(
            self.dev).multi_processor_count
        batch = MESH_GROUPS * CodingConfig(k=K, s=S, e=E).num_workers
        for b, width in ((batch, MESH_PROMPT + MESH_STEPS + 2),
                         (streams, MH_WIDTH)):
            for kvh in (whole.num_kv_heads // 2, whole.num_kv_heads):
                emit({"variant": "model axis decode plan", "streams": b,
                      "width": width, "kv_heads": kvh, "blocks": b * kvh,
                      "splits": flash_decode.plan_splits(b, kvh, width,
                                                         sms)})
        for key, cfg in (("local", whole.with_updates(
                num_heads=whole.num_heads // 2,
                num_kv_heads=whole.num_kv_heads // 2)),
                ("whole", whole)):
            table = self.kernels_mp2.setdefault(key, {})
            self.prefill_kernel("float32", cfg, table=table, gen=gen,
                                streams=streams, prompt=MH_PROMPT)
            self.decode_kernels("float32", cfg, table=table, gen=gen,
                                streams=streams, prompt=MH_PROMPT,
                                width=MH_WIDTH,
                                which=("pool_flash_decode",))

    def mp2_entry(self, name: str, mesh_launches: dict) -> dict:
        """The kernels line's ``model_par_2`` numbers of ``name``: its
        launches on each rank of phase (b)'s (worker 1, model 2) multihost
        run and batch round, and for B3 and B5 their fp32 check and times
        at that run's shapes, a rank's heads beside the whole model's."""
        keys = ("shape", "max_abs_err", "ms", "graph_ms", "plain_ms",
                "bound_ms", "bound_by", "library_ms")
        out = {"launches_multihost_per_rank": [
                   r[name] for r in mesh_launches[1, 2]],
               "launches_batch_per_rank": [r[name]
                                           for r in mesh_launches["batch"]]}
        for key, table in self.kernels_mp2.items():
            if name in table:
                out[key + "_heads"] = {k: table[name][k] for k in keys}
        return out

    # --------------------------------------- the cache-length split

    def check_lse(self, what: str, got, want) -> dict:
        """A block form's (B, H) lse against its plain version's: -inf at
        the same rows, the finite ones under the fp32 rule (both sum fp32
        terms of the same inputs)."""
        torch = self.torch
        torch.cuda.synchronize()
        if not torch.equal(torch.isneginf(got), torch.isneginf(want)):
            raise AssertionError(f"{what}: lse -inf at other rows")
        ok = torch.isfinite(want)
        if not ok.any():                 # a block no row sees a key of
            return {"max_abs_err": 0.0, "err_over_tol": 0.0}
        return self.check(what, got[ok], want[ok], "float32")

    def block_form_kernels(self):
        """Phase 26: B4 and B5's block form (``return_lse``, and B5's
        ``slot0``) at qwen3-0.6b's full-width shapes (GQA 16/8 of 128) on
        a MH_WIDTH-slot ring cut into MP16 blocks of 16 slots, and into 2
        blocks of 128, where ``plan_splits`` gives 2 or more key splits
        (the lse of the combine kernel): B4 at the batch round's 22
        streams at its last decode position (blocks past it see no key),
        B5 at the multihost run's 18 streams at per-stream depths with
        dead streams, fp32 and bf16.  Each block's output and lse against
        the plain block form; the blocks merged (``ref.merge_blocks_ref``)
        against the kernel over the whole ring (TOL_F32 / the bf16 rule);
        keyless rows (lse -inf, exact zeros) and dead streams (zeros
        after the merge); the first 16-slot block, where every live
        stream sees keys, timed beside its bound by bytes, its plain
        version and SDPA on the same block (``kernels_mp16``)."""
        torch = self.torch
        from repro_torch import configs
        from repro_torch.core.berrut import CodingConfig
        from repro_torch.kernels import flash_decode, ops, ref
        cfg = configs.get_config("qwen3-0.6b")
        h, kvh, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        n = MH_WIDTH // MP16
        gen = torch.Generator(self.dev).manual_seed(16)
        sdpa = torch.nn.functional.scaled_dot_product_attention
        sms = torch.cuda.get_device_properties(self.dev).multi_processor_count
        batch = MESH_GROUPS * CodingConfig(k=K, s=S, e=E).num_workers
        pool = MP16_SLOTS * CodingConfig(k=MH_K, s=MH_S, e=0).num_workers
        for b in (batch, pool):
            for blocks in (MP16, 2):
                splits = flash_decode.plan_splits(b, kvh, MH_WIDTH // blocks,
                                                  sms)
                emit({"variant": "block form decode plan", "streams": b,
                      "block": MH_WIDTH // blocks, "kv_heads": kvh,
                      "blocks": b * kvh, "splits": splits})
                if blocks == 2 and splits < 2:
                    raise AssertionError(
                        f"{b} streams over {MH_WIDTH // blocks}-slot blocks "
                        f"plan {splits} split: the combine kernel's lse goes "
                        "unchecked")
        for dtype_name in ("float32", "bfloat16"):
            dtype = getattr(torch, dtype_name)
            size = dtype.itemsize
            for name, b in (("flash_decode", batch),
                            ("pool_flash_decode", pool)):
                q = self.randn(b, h, hd, dtype=dtype, gen=gen)
                kc = self.randn(b, MH_WIDTH, kvh, hd, dtype=dtype, gen=gen)
                vc = self.randn(b, MH_WIDTH, kvh, hd, dtype=dtype, gen=gen)
                if name == "flash_decode":
                    pos = MESH_PROMPT + MESH_STEPS - 1
                    mask = (torch.arange(MH_WIDTH, device=self.dev)
                            <= pos).to(torch.uint8)[None].expand(b, MH_WIDTH)
                    live = torch.ones(b, dtype=torch.uint8, device=self.dev)
                    depth = torch.full((b,), pos + 1, device=self.dev)

                    def call(fn, qq, k, v, lo):
                        return fn(qq, k, v, mask[:, lo:lo + k.shape[1]],
                                  return_lse=True)

                    kernel, plain = ops.decode_attention, \
                        ref.decode_attention_ref
                    whole = ops.decode_attention(q, kc, vc, mask)
                    extra = n                      # the mask row
                else:
                    pos, live = self.pool_positions(b, MH_WIDTH, gen,
                                                    MH_PROMPT)
                    depth = pos + 1

                    def call(fn, qq, k, v, lo):
                        return fn(qq, k, v, pos, live, slot0=lo,
                                  return_lse=True)

                    kernel, plain = ops.pool_decode_attention, \
                        ref.pool_decode_attention_ref
                    whole = ops.pool_decode_attention(q, kc, vc, pos, live)
                    extra = 5 * b                  # pos and live
                for blocks in (MP16, 2):
                    width = MH_WIDTH // blocks
                    seen = [torch.clamp(depth - r * width, 0, width) * live
                            for r in range(blocks)]
                    outs, lses, worst = [], [], 0.0
                    for r in range(blocks):
                        lo = r * width
                        kb = kc[:, lo:lo + width].contiguous()
                        vb = vc[:, lo:lo + width].contiguous()
                        o, lse = call(kernel, q, kb, vb, lo)
                        po, plse = call(plain, q, kb, vb, lo)
                        where = f"{name} block {r} of {blocks} ({dtype_name})"
                        worst = max(worst, self.check(where, o, po, "float32")
                                    ["err_over_tol"])
                        worst = max(worst, self.check_lse(
                            where + " lse", lse, plse)["err_over_tol"])
                        keyless = seen[r] == 0
                        if not (torch.isneginf(lse[keyless]).all()
                                and torch.equal(o[keyless],
                                                torch.zeros_like(o[keyless]))):
                            raise AssertionError(f"{where}: a row that sees "
                                                 "no key is not (0, -inf)")
                        outs.append(o)
                        lses.append(lse)
                    merged = ref.merge_blocks_ref(torch.stack(outs),
                                                  torch.stack(lses))
                    self.dead_rows_zero(f"{name} merged blocks", merged, live)
                    res = self.check(f"{name} {blocks} blocks merged",
                                     merged, whole, dtype_name)
                    emit({"variant": f"{name} block form, {blocks} blocks of "
                          f"{width} slots merged against the whole ring",
                          "dtype": dtype_name, "streams": b,
                          "splits": flash_decode.plan_splits(b, kvh, width,
                                                             sms),
                          "keyless_blocks": sum(int((c == 0).all().item())
                                                for c in seen),
                          "keyless_rows": sum(int((c == 0).sum().item())
                                              for c in seen),
                          "blocks_worst_err_over_tol": worst, **res})
                # the first 16-slot block, in rotation past the L2
                copies = self.rotation(lambda: (
                    self.randn(b, n, kvh, hd, dtype=dtype, gen=gen),
                    self.randn(b, n, kvh, hd, dtype=dtype, gen=gen)))
                turn = itertools.cycle(copies).__next__
                kb, vb = copies[0]
                seen0 = torch.clamp(depth, 0, n) * live
                allowed = (torch.arange(n, device=self.dev)[None, :]
                           < seen0[:, None])[:, None, None, :]
                n_read = int(seen0.sum().item())
                self.record(
                    name, dtype_name, [list(q.shape), list(kb.shape)],
                    call(kernel, q, kb, vb, 0)[0], call(plain, q, kb, vb, 0)[0],
                    lambda: call(kernel, q, *turn(), 0),
                    lambda: call(plain, q, *turn(), 0),
                    lambda: sdpa(q[:, :, None], *(c.transpose(1, 2)
                                                  for c in turn()),
                                 attn_mask=allowed, enable_gqa=True),
                    q.numel() * size + 2 * n_read * kvh * hd * size + extra
                    + q.numel() * 4 + b * h * 4,
                    4 * hd * n_read * h,
                    extra={"l2_copies": len(copies), "block": n},
                    table=self.kernels_mp16)

    def mesh_ring16(self) -> dict:
        """Phase 27: qwen3-0.6b at full width and MP16_LAYERS layers, fp32,
        on a (worker, model) = (1, MP16) mesh, MP16 gloo processes sharing cuda:0, each
        holding 16 of the MH_WIDTH ring slots of every kv-head: the batch
        E=1 round (``mesh_rounds`` over a MH_WIDTH-slot ring) and
        ``multihost --mode serve --model-par 16`` (``mesh_multihost_argv``),
        each against the same with no mesh on the card under phase 24's
        rules: tokens up to the first near tie, logits within MESH_TOL,
        verdicts equal; each rank's batch caches its ring block of the
        no-mesh caches; per-rank launches held to the one-rank tables;
        collective bytes by op equal to ``model_axis_bytes``; each call's
        wall time (gloo over the host) and the card's peak memory printed.
        Returns the per-rank launches of both runs."""
        torch = self.torch
        from repro_torch import configs
        from repro_torch.core.berrut import CodingConfig
        from repro_torch.models.model import init_params
        cfg = configs.get_config("qwen3-0.6b").with_updates(
            param_dtype="float32", activation_dtype="float32",
            num_layers=MP16_LAYERS)
        tokens, pool_logits = self.plain_pool(cfg, MH_S, MP16_SLOTS,
                                              MP16_STEPS)
        inputs = self.mesh_inputs(cfg)
        params = init_params(cfg, torch.Generator(self.dev).manual_seed(
            MESH_SEED), self.dev)
        plain = mesh_rounds(cfg, params, inputs, max_len=MH_WIDTH,
                            caches=True)
        del params
        self.free_memory()
        path = ROOT / "build" / "mesh" / "inputs-ring16.pt"
        path.parent.mkdir(parents=True, exist_ok=True)
        torch.save({k: v.cpu() for k, v in inputs.items()}, path)
        self.mesh_peak = 0
        t0 = time.perf_counter()
        ranks = self.mesh_children([{
            "kind": "ring16", "world": MP16, "model": MP16, "batch": True,
            "max_len": MH_WIDTH, "layers": MP16_LAYERS,
            "inputs": str(path)}], "ring16-")[0]
        wall = time.perf_counter() - t0
        shown = MP2_KERNELS
        n = MH_WIDTH // MP16
        # the multihost serve
        where = (f"multihost serve qwen3-0.6b fp32 {MP16_LAYERS} layers W=1 "
                 f"M={MP16} (gloo)")
        want = self.expected_launches("qwen3-0.6b", 1, MP16_STEPS, pool=True,
                                      worker_major=True, layers=MP16_LAYERS)
        for r, res in enumerate(ranks):
            if not np.array_equal(res["tokens"], ranks[0]["tokens"]):
                raise AssertionError(f"{where}: rank {r}'s tokens differ")
            if res["launches"] != want:
                raise AssertionError(f"{where} rank {r}: launches "
                                     f"{res['launches']} != {want}")
        held = near_tie_rows(where, ranks[0]["tokens"], tokens, pool_logits)
        pool_worst = 0.0
        for r, res in enumerate(ranks):
            if len(res["pool_logits"]) != len(pool_logits):
                raise AssertionError(f"{where} rank {r}: "
                                     f"{len(res['pool_logits'])} decoded "
                                     f"calls, no mesh had {len(pool_logits)}")
            for i in range(min(held + 1, len(pool_logits))):
                pool_worst = max(pool_worst, logits_share(
                    f"{where} rank {r} call {i}", res["pool_logits"][i],
                    pool_logits[i]))
        coding = CodingConfig(k=MH_K, s=MH_S, e=0)
        streams = MP16_SLOTS * coding.num_workers
        for kind, calls in ranks[0]["call_bytes"].items():
            for i, got in enumerate(calls):
                groups_equal(f"{where} {kind} call {i}", got, {
                    "model": model_axis_bytes(
                        cfg, MP16, MP16_SLOTS * MH_K, streams,
                        MH_PROMPT if kind == "prefill" else 1,
                        kind == "decode")})
        ms = ranks[0]["call_ms"]
        emit({"mesh_run": where, "ranks": MP16,
              "tokens_held_calls": held,
              "pool_logits_worst_err_over_tol": pool_worst,
              "launches_per_rank": [{k: res["launches"][k] for k in shown}
                                    for res in ranks],
              "collective_bytes_per_call": ranks[0]["call_bytes"],
              "bytes_equal_analytic": True,
              "prefill_ms_gloo_over_host": ms["prefill"][0],
              "decode_ms_gloo_over_host": ms["decode"]})
        # the batch E=1 round
        where = (f"batch E=1 round qwen3-0.6b fp32 {MP16_LAYERS} layers "
                 f"model {MP16} (gloo)")
        want = self.expected_launches("qwen3-0.6b", 1, MESH_STEPS, pool=False,
                                      layers=MP16_LAYERS)
        worst, cache_worst = 0.0, 0.0
        for r, res in enumerate(ranks):
            if res["batch_launches"] != want:
                raise AssertionError(f"{where} rank {r}: launches "
                                     f"{res['batch_launches']} != {want}")
            worst = max(worst, hold_calls(f"{where} rank {r}", res["batch"],
                                          plain["batch"]))
            for i, (mine, whole) in enumerate(zip(res["batch_caches"],
                                                  plain["batch_caches"])):
                for name, leaf in whole.items():
                    blk = leaf[:, :, r * n:(r + 1) * n]
                    cache_worst = max(cache_worst, logits_share(
                        f"{where} rank {r} run {i} cache {name} (its ring "
                        f"block)", mine[name], blk))
        batch = MESH_GROUPS * CodingConfig(k=K, s=S, e=E).num_workers
        for i, got in enumerate(ranks[0]["batch_bytes"]):
            bytes_equal(f"{where} call {i}", got["model"], model_axis_bytes(
                cfg, MP16, MESH_GROUPS * K, batch,
                MESH_PROMPT if i == 0 else 1, i > 0))
        emit({"mesh_run": where, "worst_err_over_tol": worst,
              "caches": f"ring blocks of {n} slots",
              "caches_worst_err_over_tol": cache_worst,
              "launches_per_rank": [{k: res["batch_launches"][k]
                                     for k in shown} for res in ranks],
              "collective_bytes_per_call": [c["model"]
                                            for c in ranks[0]["batch_bytes"]],
              "bytes_equal_analytic": True,
              "call_ms_gloo_over_host": ranks[0]["batch_ms"]})
        emit({"mesh_ring16": f"{MP16} gloo ranks on one card",
              "children_wall_s": wall,
              "card_peak_memory_gb": self.mesh_peak / 1e9,
              "rank_max_reserved_gb": [res["max_reserved"] / 1e9
                                       for res in ranks]})
        return {"multihost": [res["launches"] for res in ranks],
                "batch": [res["batch_launches"] for res in ranks]}

    def batch_axes(self) -> dict:
        """Phase 30: the batch axes in serving (ROADMAP A9.5), qwen3-0.6b
        at full width and BA_LAYERS layers, fp32, gloo processes sharing
        cuda:0: (a) ``multihost --mode serve --multi-pod`` on
        each (pod, worker, model) of BA_MULTIHOST against the same pool
        with no mesh (``plain_pool``); (b) the batch E=1 round and the
        worker-major slot pool on (data, model) = BA_DATA_MESH and (c)
        the worker-major batch E=1 round at BA_WM on (pod 2, worker
        BA_WM_WORKERS), each against the same with no mesh on the card
        ((a)'s ranks together, then (b)'s and (c)'s).
        Phase 24's rules: every rank's tokens the same and held up to the
        first near tie, decoded logits within MESH_TOL, verdicts equal;
        each rank's caches its block of the no-mesh caches (its streams in
        the "batch" order, ``partitioning.batch_block``, and its
        kv-heads); per-rank launches held to the one-rank tables and
        printed; each call's collective bytes by group and op equal to
        ``batch_axes_bytes``; each call's wall time (gloo over the host)
        and the card's peak memory printed.  Returns the per-rank
        launches of every run."""
        torch = self.torch
        from repro_torch import configs
        from repro_torch.core.berrut import CodingConfig
        from repro_torch.models import partitioning
        from repro_torch.models.model import init_params
        cfg = configs.get_config("qwen3-0.6b").with_updates(
            param_dtype="float32", activation_dtype="float32",
            num_layers=BA_LAYERS)
        tokens, pool_logits = self.plain_pool(cfg, MH_S, MH_SLOTS, BA_STEPS)
        inputs = self.mesh_inputs(cfg)
        wm_inputs = self.mesh_inputs(cfg, BA_WM)
        params = init_params(cfg, torch.Generator(self.dev).manual_seed(
            MESH_SEED), self.dev)
        plain = mesh_rounds(cfg, params, inputs, pool=True, caches=True)
        plain_wm = mesh_rounds(cfg, params, wm_inputs, caches=True,
                               coding_args=BA_WM, worker_major=True)
        del params
        self.free_memory()
        paths = {}
        for name, inp in (("data", inputs), ("wm", wm_inputs)):
            paths[name] = ROOT / "build" / "mesh" / f"inputs-ba-{name}.pt"
            paths[name].parent.mkdir(parents=True, exist_ok=True)
            torch.save({k: v.cpu() for k, v in inp.items()}, paths[name])
        d, m = BA_DATA_MESH
        jobs = [{"kind": "multi_pod", "world": p * w * mm, "model": mm,
                 "layers": BA_LAYERS} for p, w, mm in BA_MULTIHOST]
        jobs += [{"kind": "data_pool", "world": d * m, "model": m,
                  "data": d, "batch": True, "pool": True, "caches": True,
                  "layers": BA_LAYERS, "inputs": str(paths["data"])},
                 {"kind": "pod_wm", "world": 2 * BA_WM_WORKERS, "model": 1,
                  "multi_pod": True, "workers": BA_WM_WORKERS,
                  "batch": True, "caches": True, "coding": list(BA_WM),
                  "worker_major": True, "layers": BA_LAYERS,
                  "inputs": str(paths["wm"])}]
        self.mesh_peak = 0
        t0 = time.perf_counter()
        # (a)'s ranks at once, then (b)'s and (c)'s: each half holds the
        # card's memory to about half of it
        cut = len(BA_MULTIHOST)
        runs = (self.mesh_children(jobs[:cut], "batch-axes-a", together=True)
                + self.mesh_children(jobs[cut:], "batch-axes-bc",
                                     together=True))
        wall = time.perf_counter() - t0
        shown = MP2_KERNELS
        out = {}
        # (a) the multihost serve on a pod axis
        want = self.expected_launches("qwen3-0.6b", 1, BA_STEPS, pool=True,
                                      worker_major=True, layers=BA_LAYERS)
        coding = CodingConfig(k=MH_K, s=MH_S, e=0)
        vocab = cfg.vocab_size
        for (p, w, mm), ranks in zip(BA_MULTIHOST, runs):
            where = (f"multihost serve --multi-pod qwen3-0.6b fp32 (pod, "
                     f"worker, model) = ({p}, {w}, {mm}) (gloo)")
            for r, res in enumerate(ranks):
                if not np.array_equal(res["tokens"], ranks[0]["tokens"]):
                    raise AssertionError(f"{where}: rank {r}'s tokens differ")
                if res["launches"] != want:
                    raise AssertionError(f"{where} rank {r}: launches "
                                         f"{res['launches']} != {want}")
            held = near_tie_rows(where, ranks[0]["tokens"], tokens,
                                 pool_logits)
            # the tail reduce-scatters the vocabulary where W divides it
            # (a rank then decodes its worker's block), else all-reduces
            vloc = vocab // w if vocab % w == 0 else vocab
            worst = 0.0
            for r, res in enumerate(ranks):
                if len(res["pool_logits"]) != len(pool_logits):
                    raise AssertionError(
                        f"{where} rank {r}: {len(res['pool_logits'])} "
                        f"decoded calls, no mesh had {len(pool_logits)}")
                wr = (r // mm) % w
                cols = slice(wr * vloc, (wr + 1) * vloc) if vloc < vocab \
                    else slice(None)
                for i in range(min(held + 1, len(pool_logits))):
                    worst = max(worst, logits_share(
                        f"{where} rank {r} call {i}", res["pool_logits"][i],
                        pool_logits[i][:, cols]))
                for kind, calls in res["call_bytes"].items():
                    for i, got in enumerate(calls):
                        groups_equal(f"{where} rank {r} {kind} call {i}",
                                     got, batch_axes_bytes(
                                         coding, MH_SLOTS, vocab, p, w, 1,
                                         True, sampled=True))
            ms = ranks[0]["call_ms"]
            emit({"mesh_run": where, "ranks": p * w * mm,
                  "tokens_held_calls": held,
                  "pool_logits_worst_err_over_tol": worst,
                  "launches_per_rank": [{k: res["launches"][k]
                                         for k in shown} for res in ranks],
                  "collective_bytes_per_call": ranks[0]["call_bytes"],
                  "bytes_equal_analytic": True,
                  "prefill_ms_gloo_over_host": ms["prefill"][0],
                  "decode_ms_gloo_over_host": ms["decode"]})
            out[f"multihost ({p}, {w}, {mm})"] = [res["launches"]
                                                  for res in ranks]
        # (b) the batch round and the slot pool on the data axis, and (c)
        # the worker-major batch round on (pod 2, worker 2)
        b_ranks, c_ranks = runs[len(BA_MULTIHOST):]
        names = {"b": (("data", "model"), BA_DATA_MESH),
                 "c": (("pod", "worker", "model"), (2, BA_WM_WORKERS, 1))}
        for part, ranks, want_runs, coding_args in (
                ("b", b_ranks, plain, (K, S, E)),
                ("c", c_ranks, plain_wm, BA_WM)):
            axes, shape = names[part]
            coding = CodingConfig(*coding_args)
            kinds = ("batch", "pool") if part == "b" else ("batch",)
            wm_batch = part == "c"
            where = (f"qwen3-0.6b fp32 K={coding.k} S={coding.s} "
                     f"E={coding.e} on {dict(zip(axes, shape))} (gloo)")
            worst = cache_worst = 0.0
            for r, res in enumerate(ranks):
                mesh = partitioning.Mesh(axes, shape, r)
                for kind in kinds:
                    wm_run = kind == "pool" or wm_batch
                    launches = self.expected_launches(
                        "qwen3-0.6b", 1, MESH_STEPS, pool=kind == "pool",
                        worker_major=wm_run, layers=BA_LAYERS)
                    if res[kind + "_launches"] != launches:
                        raise AssertionError(
                            f"{where} {kind} rank {r}: launches "
                            f"{res[kind + '_launches']} != {launches}")
                    worst = max(worst, hold_calls(
                        f"{where} {kind} rank {r}", res[kind],
                        want_runs[kind]))
                    for i, (mine, whole) in enumerate(zip(
                            res[kind + "_caches"],
                            want_runs[kind + "_caches"])):
                        for name, leaf in whole.items():
                            lo, n = partitioning.batch_block(leaf.shape[1],
                                                             mesh)
                            kv = leaf.shape[3] // mesh.size("model")
                            c0 = mesh.coord("model") * kv
                            cache_worst = max(cache_worst, logits_share(
                                f"{where} {kind} rank {r} run {i} cache "
                                f"{name} (its block)", mine[name],
                                leaf[:, lo:lo + n, :, c0:c0 + kv]))
                    for i, got in enumerate(res[kind + "_bytes"]):
                        groups_equal(
                            f"{where} {kind} rank {r} call {i}", got,
                            batch_axes_bytes(
                                coding, MESH_GROUPS, vocab,
                                mesh.size("pod") * mesh.size("data"),
                                mesh.size("worker"), mesh.size("model"),
                                wm_run, cfg=cfg,
                                seq=MESH_PROMPT if i == 0 else 1))
            emit({"mesh_run": where, "parts": kinds,
                  "worst_err_over_tol": worst,
                  "caches": "stream blocks in the batch order, kv-head "
                            "blocks", "caches_worst_err_over_tol": cache_worst,
                  "launches_per_rank": {kind: [{k: res[kind + "_launches"][k]
                                                for k in shown}
                                               for res in ranks]
                                        for kind in kinds},
                  "collective_bytes_per_call": {
                      kind: ranks[0][kind + "_bytes"] for kind in kinds},
                  "bytes_equal_analytic": True,
                  "call_ms_gloo_over_host": {kind: ranks[0][kind + "_ms"]
                                             for kind in kinds}})
            for kind in kinds:
                out[f"{kind} {dict(zip(axes, shape))}"] = [
                    res[kind + "_launches"] for res in ranks]
        emit({"batch_axes": "gloo ranks on one card, (a) at once, then (b) "
                             "and (c)",
              "ranks": sum(job["world"] for job in jobs),
              "children_wall_s": wall,
              "card_peak_memory_gb": self.mesh_peak / 1e9,
              "rank_max_reserved_gb": [res["max_reserved"] / 1e9
                                       for ranks in runs for res in ranks]})
        return out

    def mp16_entry(self, name: str, launches: dict) -> dict:
        """The kernels line's ``model_par_16`` numbers of ``name``: its
        launches on each rank of phase 27's multihost run and batch round,
        and for B4 and B5 their fp32 block form's check and times on one
        of the 16-slot ring blocks (phase 26)."""
        keys = ("shape", "max_abs_err", "ms", "graph_ms", "plain_ms",
                "bound_ms", "bound_by", "library_ms", "l2_copies")
        out = {"launches_multihost_per_rank": [r[name]
                                               for r in launches["multihost"]],
               "launches_batch_per_rank": [r[name]
                                           for r in launches["batch"]]}
        if name in self.kernels_mp16:
            out["block_of_16_slots"] = {k: self.kernels_mp16[name][k]
                                        for k in keys}
        return out


    # ------------------------------------------------ the training mesh

    def train_mesh_kernels(self):
        """Phase 28's kernels: B3 and its backward at a model-2 rank's
        training heads (TRAIN_ARCH's 16/8 heads halved: GQA 8/4 of 128,
        TRAIN_BATCH x TRAIN_SEQ causal), fp32: the forward against
        ``ref.attention_ref`` (SDPA its library call), the backward against
        ``ref.attention_bwd_ref`` and autograd of the plain forward
        (``b3_backward_checks``; SDPA's backward its library call), the
        Delta launch alone (``b3_delta_timing``), each timed beside its
        plain version and bound as phase 17 bounds them."""
        torch = self.torch
        from repro_torch import configs
        from repro_torch.kernels import flash_attention as fa, ops, ref
        cfg = configs.get_config(TRAIN_ARCH)
        b, s = TRAIN_BATCH, TRAIN_SEQ
        h, kvh, hd = cfg.num_heads // 2, cfg.num_kv_heads // 2, cfg.head_dim
        gen = torch.Generator(self.dev).manual_seed(16)
        q = self.randn(b, s, h, hd, gen=gen)
        k = self.randn(b, s, kvh, hd, gen=gen)
        v = self.randn(b, s, kvh, hd, gen=gen)
        do = self.randn(b, s, h, hd, gen=gen)
        sdpa = torch.nn.functional.scaled_dot_product_attention
        pairs = visible_pairs(s, causal=True, window=None, prefix=0)
        shape = [list(q.shape), list(k.shape)]
        self.record("flash_attention", "float32", shape,
                    ops.attention(q, k, v), ref.attention_ref(q, k, v),
                    lambda: ops.attention(q, k, v),
                    lambda: ref.attention_ref(q, k, v),
                    lambda: sdpa(q.transpose(1, 2), k.transpose(1, 2),
                                 v.transpose(1, 2), is_causal=True,
                                 enable_gqa=True),
                    (2 * q.numel() + 2 * k.numel()) * 4, 4 * hd * pairs * b * h,
                    extra={"at": "model-2 rank's training heads",
                           "pairs": pairs},
                    table=self.kernels_train_mesh)
        where = f"flash_attention_bwd B={b} S={s} H={h} KV={kvh} D={hd}"
        res = {"kernel": "flash_attention_bwd", "dtype": "float32",
               "shape": shape, "at": "model-2 rank's training heads"}
        res.update(self.b3_backward_checks(where, "float32", q, k, v, do, {}))
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
        res["bound_ms"], res["bound_by"] = self.bound(
            4 * (q.numel() + k.numel()) * 4 + 4 * lse.numel(),
            10 * hd * pairs * b * h, "float32")
        emit(res)
        self.kernels_train_mesh["flash_attention_bwd"] = res
        self.kernels_train_mesh["flash_attention_bwd_delta"] = \
            self.b3_delta_timing("train_mesh", "float32", out, do)
        del so, qs, ks, vs

    def train_mesh(self) -> dict:
        """Phase 28: TRAIN_ARCH at full width and TRAIN_MESH_LAYERS layers,
        fp32, TRAIN_MESH_STEPS steps of ``launch.train.run`` (the launcher's
        TRAIN_BATCH x TRAIN_SEQ, lr TRAIN_LR) with no mesh in this process,
        its first step's parameters and first moments written to
        ``build/mesh/train-ref.pt``; then the same run on each (data,
        model) of TRAIN_MESH_RUNS as gloo processes sharing the card,
        every mesh at once (``mesh_child``), each holding its blocks to
        that file after its first step (``hold_train_blocks``).  Here: every rank's losses and
        grad norms within 1e-4 relative of one rank's and equal to rank
        0's, its launches ``train_launches``' (B3, its backward and Delta
        one a layer a step), each group's bytes a step
        ``train_axis_bytes``'.  Returns each mesh's per-rank launches."""
        torch = self.torch
        from repro_torch import configs
        from repro_torch.kernels import ops
        from repro_torch.launch import train as launch_train
        from repro_torch.tree import flatten_with_path, keystr
        get_config = configs.get_config
        cfg = get_config(TRAIN_ARCH).with_updates(
            num_layers=TRAIN_MESH_LAYERS)
        b1 = self.train_config(TRAIN_MESH_STEPS).optimizer.b1
        self.free_memory()
        ref_path = ROOT / "build" / "mesh" / "train-ref.pt"
        ref_path.parent.mkdir(parents=True, exist_ok=True)
        jobs = [{"kind": "train", "world": d * m, "data": d, "model": m,
                 "ref": str(ref_path), "layers": TRAIN_MESH_LAYERS}
                for d, m in TRAIN_MESH_RUNS]
        self.start_ranks(jobs, "train-mesh-")
        step = launch_train.train_step
        first = {}

        def keep_first(*args, **kw):
            out = step(*args, **kw)
            if not first:
                first["params"] = {keystr(p): t.detach().cpu() for p, t in
                                   flatten_with_path(out[0])}
                first["mu"] = {keystr(p): t.detach().cpu() for p, t in
                               flatten_with_path(out[1].mu)}
            return out

        history = []
        ops.reset_launch_counts()
        launch_train.train_step = keep_first
        configs.get_config = lambda arch: get_config(arch).with_updates(
            num_layers=TRAIN_MESH_LAYERS)
        try:
            launch_train.run(TRAIN_ARCH, False, TRAIN_MESH_STEPS, TRAIN_BATCH,
                             TRAIN_SEQ, 1, 1, TRAIN_LR, 1, None,
                             log_every=TRAIN_MESH_STEPS, device=self.dev,
                             seed=0, history=history)
        finally:
            launch_train.train_step = step
            configs.get_config = get_config
        one_launches = ops.launch_counts()
        first["gmax"] = {key: (mu / (1 - b1)).abs().max().item()
                         for key, mu in first["mu"].items()}
        torch.save(first, ref_path)
        del first
        self.free_memory()
        want_launches = {name: 0 for name in one_launches}
        want_launches.update(train_launches(cfg, TRAIN_MESH_STEPS, False))
        if one_launches != want_launches:
            raise AssertionError(f"one-rank training launched {one_launches}"
                                 f", not {want_launches}")
        out = {}
        self.mesh_peak = 0
        t0 = time.perf_counter()
        runs = self.mesh_children(jobs, "train-mesh-", together=True)
        wall = time.perf_counter() - t0
        for (d, m), ranks in zip(TRAIN_MESH_RUNS, runs):
            where = (f"{TRAIN_ARCH} {TRAIN_MESH_LAYERS} layers training "
                     f"fp32 (data {d}, model {m}) (gloo)")
            for r, res in enumerate(ranks):
                for i, (got, want) in enumerate(zip(res["history"], history)):
                    for key in ("loss", "grad_norm", "lr"):
                        if got[key] != ranks[0]["history"][i][key] or not \
                                abs(got[key] - want[key]) <= \
                                1e-4 * abs(want[key]):
                            raise AssertionError(
                                f"{where} rank {r} step {i} {key}: "
                                f"{got[key]}, one rank {want[key]}")
                if res["launches"] != want_launches:
                    raise AssertionError(f"{where} rank {r}: launches "
                                         f"{res['launches']} != "
                                         f"{want_launches}")
                want_bytes = train_axis_bytes(cfg, d, m, TRAIN_BATCH,
                                              TRAIN_SEQ, 4, False)
                for i, got in enumerate(res["step_bytes"]):
                    bytes_equal(f"{where} rank {r} step {i}",
                                {k: v for k, v in got.items() if v},
                                want_bytes)
            held = max((res["held"] for res in ranks),
                       key=lambda h: max(h["grads_err_over_tol"],
                                         h["strict_params_err_over_tol"]))
            emit({"train_mesh_run": where, "ranks": d * m,
                  "steps": TRAIN_MESH_STEPS,
                  "losses": [h["loss"] for h in ranks[0]["history"]],
                  "losses_one_rank": [h["loss"] for h in history],
                  "grad_norms": [h["grad_norm"]
                                 for h in ranks[0]["history"]],
                  "grad_norms_one_rank": [h["grad_norm"] for h in history],
                  "worst_rank_after_step_0": held,
                  "bytes_per_step_per_rank": ranks[0]["step_bytes"][0],
                  "bytes_equal_analytic": True,
                  "launches_per_rank": [{k: v for k, v in res["launches"]
                                         .items() if v} for res in ranks],
                  "step_ms_gloo_over_host": [1e3 * h["seconds"] for h in
                                             ranks[0]["history"]],
                  "one_rank_step_ms": [1e3 * h["seconds"] for h in history],
                  "rank_peak_allocated_gb": [res["max_allocated"] / 1e9
                                             for res in ranks]})
            out[d, m] = [res["launches"] for res in ranks]
        emit({"train_mesh": "gloo ranks on one card, every mesh at once",
              "ranks": [d * m for d, m in TRAIN_MESH_RUNS],
              "children_wall_s": wall,
              "card_peak_gb": self.mesh_peak / 1e9})
        ref_path.unlink()
        return out

    def train_mesh_multihost(self) -> list:
        """Phase 29: ``multihost --mode train --model-par 2`` (bf16 with
        remat, MH_TRAIN_ARGS, TRAIN_ARCH at MH_TRAIN_LAYERS layers) as 2
        gloo processes sharing the card, against one process of the same
        command in this one: losses within
        MH_TRAIN_LOSS_TOL of its and equal on both ranks, launches
        ``train_launches``' under remat (B3 16 a step, its backward and
        Delta 8), each group's bytes a step ``train_axis_bytes``'.
        Returns the per-rank launches."""
        torch = self.torch
        from repro_torch import configs
        from repro_torch.kernels import ops
        from repro_torch.launch import multihost
        get_config = configs.get_config
        cfg = get_config(TRAIN_ARCH).with_updates(num_layers=MH_TRAIN_LAYERS)
        self.free_memory()
        jobs = [{"kind": "multihost_train", "world": 2, "model": 2}]
        self.start_ranks(jobs, "mh-train-")
        store = ROOT / "build" / "mesh" / "mh-train-store"
        store.parent.mkdir(parents=True, exist_ok=True)
        store.unlink(missing_ok=True)
        ops.reset_launch_counts()
        configs.get_config = lambda arch: get_config(arch).with_updates(
            num_layers=MH_TRAIN_LAYERS)
        try:
            one = multihost.main(MH_TRAIN_ARGS + [
                "--coordinator", f"file://{store}", "--num-processes", "1",
                "--process-id", "0"])
        finally:
            configs.get_config = get_config
        one_launches = ops.launch_counts()
        store.unlink(missing_ok=True)
        self.free_memory()
        want_launches = {name: 0 for name in one_launches}
        want_launches.update(train_launches(cfg, TRAIN_MESH_STEPS, True))
        self.mesh_peak = 0
        ranks = self.mesh_children(jobs, "mh-train-")[0]
        worst = 0.0
        for r, res in enumerate(ranks):
            if res["losses"] != ranks[0]["losses"]:
                raise AssertionError(f"multihost train rank {r}: losses "
                                     f"{res['losses']} != rank 0's")
            for got, want in zip(res["losses"], one["losses"]):
                worst = max(worst, abs(got - want))
            for launches in (res["launches"], one_launches):
                if launches != want_launches:
                    raise AssertionError(f"multihost train rank {r}: "
                                         f"launches {launches} != "
                                         f"{want_launches}")
            for i, got in enumerate(res["step_bytes"]):
                bytes_equal(f"multihost train rank {r} step {i}",
                            {k: v for k, v in got.items() if v},
                            train_axis_bytes(cfg, 1, 2, TRAIN_BATCH,
                                             TRAIN_SEQ, 2, True))
        if not worst <= MH_TRAIN_LOSS_TOL:
            raise AssertionError(f"multihost train model 2 losses "
                                 f"{ranks[0]['losses']}, one process "
                                 f"{one['losses']}")
        emit({"train_mesh_run": f"multihost --mode train {TRAIN_ARCH} "
              f"{MH_TRAIN_LAYERS} layers bf16 remat model 2 (gloo)",
              "args": MH_TRAIN_ARGS,
              "losses": ranks[0]["losses"], "losses_one_process":
              one["losses"], "worst_loss_diff": worst,
              "loss_tol": MH_TRAIN_LOSS_TOL,
              "bytes_per_step_per_rank": ranks[0]["step_bytes"][0],
              "launches_per_rank": [{k: v for k, v in res["launches"].items()
                                     if v} for res in ranks],
              "step_ms_gloo_over_host": ranks[0]["step_ms"],
              "one_process_step_ms": one["step_ms"],
              "rank_peak_allocated_gb": [res["max_allocated"] / 1e9
                                         for res in ranks],
              "card_peak_gb": self.mesh_peak / 1e9})
        return [res["launches"] for res in ranks]

    def train_mesh_entry(self, name: str, launches: dict) -> dict:
        """The kernels line's ``train_mesh`` of B3, its backward or its
        Delta launch: its fp32 numbers at a model-2 rank's training heads
        (phase 28) and its launches on each rank of phases 28 and 29's
        runs."""
        keys = ("shape", "max_abs_err", "ms", "graph_ms", "plain_ms",
                "bound_ms", "bound_by", "library_ms")
        res = self.kernels_train_mesh[name]
        return {**{key: res[key] for key in keys},
                "library": {"flash_attention": "scaled_dot_product_attention",
                            "flash_attention_bwd": "backward of autograd "
                            "through scaled_dot_product_attention",
                            "flash_attention_bwd_delta":
                            "torch.linalg.vecdot of o and dO"}[name],
                "launches_per_rank": {
                    f"data {d} model {m}, {TRAIN_MESH_STEPS} steps":
                    [r[name] for r in launches[d, m]]
                    for d, m in TRAIN_MESH_RUNS},
                "launches_per_rank_multihost_remat": [
                    r[name] for r in launches["multihost"]]}

    # ------------------------- the MoE layer and the frontends on the mesh

    def moe_mesh_kernels(self):
        """Phases 31 and 33's kernels at a model-2 rank's heads: B3 and B5
        at qwen3-moe-30b-a3b's multihost E=0 shapes (MH_SLOTS x 9 = 72
        streams of MH_PROMPT-token prompts; the pool decode over a
        MH_WIDTH-slot ring at per-stream depths with dead streams), GQA
        16/2 of 128 (rep 8), bf16, and B3 at hubert-xlarge's coded
        prefill (FRONT_GROUPS x 11 = 44 streams of FRAMES frames,
        non-causal), MHA 8/8 of 80, fp32: checked and timed as at every
        other shape, SDPA the library call (``kernels_a93``)."""
        from repro_torch import configs
        from repro_torch.core.berrut import CodingConfig
        gen = self.torch.Generator(self.dev).manual_seed(18)
        moe = configs.get_config(QWEN3_MOE)
        local = moe.with_updates(num_heads=moe.num_heads // 2,
                                 num_kv_heads=moe.num_kv_heads // 2)
        if (local.num_heads, local.num_kv_heads, local.head_dim) != \
                (16, 2, 128):
            raise AssertionError("qwen3-moe's model-2 heads changed")
        table = self.kernels_a93.setdefault(QWEN3_MOE, {})
        streams = MH_SLOTS * CodingConfig(k=MH_K, s=MH_S, e=0).num_workers
        self.prefill_kernel("bfloat16", local, table, gen, streams=streams,
                            prompt=MH_PROMPT, keep="bfloat16")
        self.decode_kernels("bfloat16", local, table, gen, streams=streams,
                            prompt=MH_PROMPT, width=MH_WIDTH,
                            which=("pool_flash_decode",), keep="bfloat16")
        audio = configs.get_config(HUBERT)
        local = audio.with_updates(num_heads=audio.num_heads // 2,
                                   num_kv_heads=audio.num_kv_heads // 2)
        table = self.kernels_a93.setdefault(HUBERT, {})
        self.prefill_kernel(
            "float32", local, table, gen,
            streams=FRONT_GROUPS * CodingConfig(k=K, s=S, e=E).num_workers,
            prompt=FRAMES)

    def moe_mesh(self) -> dict:
        """Phase 31: qwen3-moe-30b-a3b at full width and MOE_MESH_LAYERS
        layers, fp32, gloo processes sharing cuda:0, (a) and (b) at once,
        then (c): (a) and (b) ``multihost --mode serve`` (K=7 S=2 E=0,
        MH_SLOTS slots: 72 streams, BA_STEPS decode calls) on each
        (worker, model) of MOE_MESH_MULTIHOST against the same pool with
        no mesh (``plain_pool``): at (3, 1) each worker runs 24 streams
        and its MoE layers gather the whole pool's routes; (c) phase 23's
        batch E=1 round and the worker-major slot pool on (data, model) =
        MOE_MESH_DATA against no mesh.  Every MoE layer call's routes
        (``route_log``) are held to the no-mesh run's by
        ``mesh_route_walk``, and the rest of each run only as far as the
        routes are equal: every rank's tokens the same and held to the
        no-mesh tokens up to the first near tie, decoded logits within
        MESH_TOL, verdicts equal, each rank's caches its block of the
        no-mesh caches; per-rank launches held; each call's bytes by
        group and op equal to ``batch_axes_bytes`` plus
        ``moe_axis_bytes``; the card's peak memory printed.  Returns the
        per-rank launches of every run."""
        torch = self.torch
        from repro_torch import configs
        from repro_torch.core.berrut import CodingConfig
        from repro_torch.models import partitioning
        from repro_torch.models.model import init_params
        cfg = configs.get_config(QWEN3_MOE).with_updates(
            num_layers=MOE_MESH_LAYERS)
        k, layers, vocab = cfg.experts_per_token, cfg.num_layers, \
            cfg.vocab_size
        self.free_memory()
        log = []
        with route_log(log):
            tokens, pool_logits = self.plain_pool(cfg, MH_S, MH_SLOTS,
                                                  BA_STEPS)
        pool_routes = list(log)
        inputs = self.mesh_inputs(cfg)
        params = init_params(cfg, torch.Generator(self.dev).manual_seed(
            MESH_SEED), self.dev)
        log.clear()
        with route_log(log):
            plain = mesh_rounds(cfg, params, inputs, pool=True, caches=True)
        calls = (1 + MESH_STEPS) * layers
        plain_routes = {"batch": log[:calls], "pool": log[calls:]}
        del params, log
        self.free_memory()
        path = ROOT / "build" / "mesh" / "inputs-moe.pt"
        path.parent.mkdir(parents=True, exist_ok=True)
        torch.save({key: v.cpu() for key, v in inputs.items()}, path)
        d, m = MOE_MESH_DATA
        jobs = [{"kind": "moe_multihost", "world": w * mm, "model": mm,
                 "layers": layers} for w, mm in MOE_MESH_MULTIHOST]
        jobs.append({"kind": "moe_rounds", "world": d * m, "model": m,
                     "data": d, "batch": True, "pool": True, "caches": True,
                     "arch": QWEN3_MOE, "layers": layers, "in_turns": True,
                     "inputs": str(path)})
        self.mesh_peak = 0
        t0 = time.perf_counter()
        runs = (self.mesh_children(jobs[:2], "moe-mesh-", together=True)
                + self.mesh_children(jobs[2:], "moe-mesh-c"))
        wall = time.perf_counter() - t0
        out = {}
        # (a) and (b): the multihost serve
        coding = CodingConfig(k=MH_K, s=MH_S, e=0)
        streams = MH_SLOTS * coding.num_workers
        want = self.expected_launches(QWEN3_MOE, 1, BA_STEPS, pool=True,
                                      worker_major=True, layers=layers)
        for (w, mm), ranks in zip(MOE_MESH_MULTIHOST, runs):
            where = (f"multihost serve {QWEN3_MOE} {layers} layers fp32 "
                     f"(worker, model) = ({w}, {mm}) (gloo)")
            routed = min(mesh_route_walk(f"{where} rank {r}", res["routes"],
                                         pool_routes, k, layers)
                         for r, res in enumerate(ranks))
            for r, res in enumerate(ranks):
                if not np.array_equal(res["tokens"][:routed],
                                      ranks[0]["tokens"][:routed]):
                    raise AssertionError(f"{where}: rank {r}'s tokens differ")
                if res["launches"] != want:
                    raise AssertionError(f"{where} rank {r}: launches "
                                         f"{res['launches']} != {want}")
            held = near_tie_rows(where, ranks[0]["tokens"][:routed],
                                 tokens[:routed], pool_logits)
            vloc = vocab // w if vocab % w == 0 else vocab
            worst = 0.0
            for r, res in enumerate(ranks):
                wr = (r // mm) % w
                cols = slice(wr * vloc, (wr + 1) * vloc) if vloc < vocab \
                    else slice(None)
                for i in range(min(held + 1, routed, len(pool_logits))):
                    worst = max(worst, logits_share(
                        f"{where} rank {r} call {i}", res["pool_logits"][i],
                        pool_logits[i][:, cols]))
                for kind, calls_bytes in res["call_bytes"].items():
                    seq = MH_PROMPT if kind == "prefill" else 1
                    for i, got in enumerate(calls_bytes):
                        groups_equal(
                            f"{where} rank {r} {kind} call {i}", got,
                            add_bytes(batch_axes_bytes(
                                coding, MH_SLOTS, vocab, 1, w, mm, True,
                                sampled=True, cfg=cfg, seq=seq),
                                moe_axis_bytes(cfg, streams // w * seq, 1,
                                               w, mm)))
            ms = ranks[0]["call_ms"]
            emit({"mesh_run": where, "ranks": w * mm,
                  "calls_routes_equal": routed, "tokens_held_calls": held,
                  "pool_logits_worst_err_over_tol": worst,
                  "launches_per_rank": [{key: res["launches"][key]
                                         for key in MP2_KERNELS}
                                        for res in ranks],
                  "collective_bytes_per_call": ranks[0]["call_bytes"],
                  "bytes_equal_analytic": True,
                  "prefill_ms_gloo_over_host": ms["prefill"][0],
                  "decode_ms_gloo_over_host": ms["decode"]})
            out[f"multihost (worker {w}, model {mm})"] = [
                res["launches"] for res in ranks]
        # (c): the batch round and the slot pool on (data 2, model 2)
        ranks = runs[-1]
        axes, shape = ("data", "model"), MOE_MESH_DATA
        coding = CodingConfig(K, S, E)
        local = -(-MESH_GROUPS * coding.num_workers // d)
        where = (f"{QWEN3_MOE} {layers} layers fp32 K={K} S={S} E={E} on "
                 f"{dict(zip(axes, shape))} (gloo)")
        worst = cache_worst = 0.0
        routed = {}
        for r, res in enumerate(ranks):
            mesh = partitioning.Mesh(axes, shape, r)
            got_routes = {"batch": res["routes"][:calls],
                          "pool": res["routes"][calls:]}
            for kind in ("batch", "pool"):
                wm_run = kind == "pool"
                held = mesh_route_walk(f"{where} {kind} rank {r}",
                                       got_routes[kind], plain_routes[kind],
                                       k, layers)
                routed[kind] = min(routed.get(kind, held), held)
                launches = self.expected_launches(
                    QWEN3_MOE, 1, MESH_STEPS, pool=wm_run,
                    worker_major=wm_run, layers=layers)
                if res[kind + "_launches"] != launches:
                    raise AssertionError(
                        f"{where} {kind} rank {r}: launches "
                        f"{res[kind + '_launches']} != {launches}")
                worst = max(worst, hold_calls(
                    f"{where} {kind} rank {r}", res[kind][:held],
                    plain[kind][:held]))
                for i, got in enumerate(res[kind + "_bytes"]):
                    seq = MESH_PROMPT if i == 0 else 1
                    groups_equal(
                        f"{where} {kind} rank {r} call {i}", got,
                        add_bytes(batch_axes_bytes(
                            coding, MESH_GROUPS, vocab, d, 1, m, wm_run,
                            cfg=cfg, seq=seq),
                            moe_axis_bytes(cfg, local * seq, d, 1, m)))
                if held < 1 + MESH_STEPS:
                    continue              # the caches saw a disputed route
                for i, (mine, whole) in enumerate(zip(
                        res[kind + "_caches"], plain[kind + "_caches"])):
                    for name, leaf in whole.items():
                        lo, n = partitioning.batch_block(leaf.shape[1], mesh)
                        kv = leaf.shape[3] // m
                        c0 = mesh.coord("model") * kv
                        cache_worst = max(cache_worst, logits_share(
                            f"{where} {kind} rank {r} run {i} cache {name} "
                            f"(its block)", mine[name],
                            leaf[:, lo:lo + n, :, c0:c0 + kv]))
        emit({"mesh_run": where, "parts": ["batch", "pool"],
              "calls_routes_equal": routed,
              "worst_err_over_tol": worst,
              "caches_worst_err_over_tol": cache_worst,
              "launches_per_rank": {kind: [{key: res[kind + "_launches"][key]
                                            for key in MP2_KERNELS}
                                           for res in ranks]
                                    for kind in ("batch", "pool")},
              "collective_bytes_per_call": {
                  kind: ranks[0][kind + "_bytes"] for kind in ("batch",
                                                               "pool")},
              "bytes_equal_analytic": True,
              "call_ms_gloo_over_host": {kind: ranks[0][kind + "_ms"]
                                         for kind in ("batch", "pool")}})
        for kind in ("batch", "pool"):
            out[f"{kind} (data {d}, model {m})"] = [
                res[kind + "_launches"] for res in ranks]
        emit({"moe_mesh": "gloo ranks on one card, (a) and (b) at once, "
              "then (c)",
              "depth": layers, "ranks": [job["world"] for job in jobs],
              "children_wall_s": wall,
              "card_peak_memory_gb": self.mesh_peak / 1e9,
              "rank_max_reserved_gb": [res["max_reserved"] / 1e9
                                       for ranks in runs for res in ranks]})
        return out

    def moe_train_mesh(self) -> dict:
        """Phase 32: qwen3-moe-30b-a3b at full width and
        MOE_TRAIN_LAYERS layers, fp32, TRAIN_MESH_STEPS steps of
        ``launch.train.run`` (the launcher's TRAIN_BATCH x TRAIN_SEQ, lr
        TRAIN_LR) with no mesh in this process, the first step's first
        moments of its blocks written to ``build/mesh/moe-train-ref.pt``
        (the embeddings' are left out: the file stays near phase 28's
        size); then the same run on each (data, model) of MOE_TRAIN_MESH
        as gloo processes sharing the card (``mesh_train_child``), each
        holding its blocks' gradients to that file after its first step.
        Here: every rank's losses, grad norms and MoE statistics
        (load-balance loss, dropped fraction) within 1e-4 relative of one
        rank's and equal to rank 0's, its launches ``train_launches``',
        each group's bytes a step ``train_axis_bytes``'.  Returns each
        mesh's per-rank launches."""
        torch = self.torch
        from repro_torch import configs
        from repro_torch.kernels import ops
        from repro_torch.launch import train as launch_train
        from repro_torch.tree import flatten_with_path, keystr
        cfg = configs.get_config(QWEN3_MOE).with_updates(
            num_layers=MOE_TRAIN_LAYERS)
        b1 = self.train_config(TRAIN_MESH_STEPS).optimizer.b1
        self.free_memory()
        ref_path = ROOT / "build" / "mesh" / "moe-train-ref.pt"
        ref_path.parent.mkdir(parents=True, exist_ok=True)
        jobs = {(d, m): [{
            "kind": "train", "world": d * m, "data": d, "model": m,
            "ref": str(ref_path), "arch": QWEN3_MOE,
            "layers": MOE_TRAIN_LAYERS,
            # two ranks' 27 GB peaks on one card: segments that grow
            # keep the caching allocator's slack off the card
            "env": {"PYTORCH_CUDA_ALLOC_CONF": "expandable_segments:True"}}]
            for d, m in MOE_TRAIN_MESH}
        d, m = MOE_TRAIN_MESH[0]
        self.start_ranks(jobs[d, m], f"moe-train{d}{m}-")
        step, get_config = launch_train.train_step, configs.get_config
        first, metrics = {}, []

        def keep_first(*args, **kw):
            out = step(*args, **kw)
            metrics.append({key: float(v) for key, v in out[2].items()})
            if not first:
                first["mu"] = {keystr(p): t.detach().cpu() for p, t in
                               flatten_with_path(out[1].mu)
                               if "embeddings" not in keystr(p)}
            return out

        history = []
        ops.reset_launch_counts()
        launch_train.train_step = keep_first
        configs.get_config = lambda arch: get_config(arch).with_updates(
            num_layers=MOE_TRAIN_LAYERS)
        try:
            launch_train.run(QWEN3_MOE, False, TRAIN_MESH_STEPS,
                             TRAIN_BATCH, TRAIN_SEQ, 1, 1, TRAIN_LR, 1, None,
                             log_every=TRAIN_MESH_STEPS, device=self.dev,
                             seed=0, history=history)
        finally:
            launch_train.train_step = step
            configs.get_config = get_config
        one_launches = ops.launch_counts()
        first["gmax"] = {key: (mu / (1 - b1)).abs().max().item()
                         for key, mu in first["mu"].items()}
        torch.save(first, ref_path)
        del first
        self.free_memory()
        want_launches = {name: 0 for name in one_launches}
        want_launches.update(train_launches(cfg, TRAIN_MESH_STEPS, False))
        if one_launches != want_launches:
            raise AssertionError(f"one-rank MoE training launched "
                                 f"{one_launches}, not {want_launches}")
        if not metrics[0]["dropped_fraction"] > 0:
            raise AssertionError("the capacity drops nothing: the MoE "
                                 "training runs hold no capacity")
        out = {}
        for d, m in MOE_TRAIN_MESH:
            where = (f"{QWEN3_MOE} {MOE_TRAIN_LAYERS} layers training fp32 "
                     f"(data {d}, model {m}) (gloo)")
            self.mesh_peak = 0
            t0 = time.perf_counter()
            ranks = self.mesh_children(jobs[d, m], f"moe-train{d}{m}-")[0]
            wall = time.perf_counter() - t0
            want_bytes = train_axis_bytes(cfg, d, m, TRAIN_BATCH, TRAIN_SEQ,
                                          4, False)
            for r, res in enumerate(ranks):
                for i, (got, one) in enumerate(zip(res["history"], history)):
                    for key in ("loss", "grad_norm", "lr"):
                        if got[key] != ranks[0]["history"][i][key] or not \
                                abs(got[key] - one[key]) <= \
                                1e-4 * abs(one[key]):
                            raise AssertionError(
                                f"{where} rank {r} step {i} {key}: "
                                f"{got[key]}, one rank {one[key]}")
                for i, (got, one) in enumerate(zip(res["metrics"],
                                                   metrics)):
                    for key in ("ce_loss", "load_balance_loss",
                                "dropped_fraction"):
                        if not abs(got[key] - one[key]) <= \
                                1e-4 * abs(one[key]) + 1e-7:
                            raise AssertionError(
                                f"{where} rank {r} step {i} {key}: "
                                f"{got[key]}, one rank {one[key]}")
                if res["launches"] != want_launches:
                    raise AssertionError(f"{where} rank {r}: launches "
                                         f"{res['launches']} != "
                                         f"{want_launches}")
                for i, got in enumerate(res["step_bytes"]):
                    bytes_equal(f"{where} rank {r} step {i}",
                                {key: v for key, v in got.items() if v},
                                want_bytes)
            emit({"train_mesh_run": where, "ranks": d * m,
                  "steps": TRAIN_MESH_STEPS,
                  "losses": [h["loss"] for h in ranks[0]["history"]],
                  "losses_one_rank": [h["loss"] for h in history],
                  "moe_metrics": ranks[0]["metrics"],
                  "moe_metrics_one_rank": metrics,
                  "worst_rank_after_step_0": max(
                      (res["held"] for res in ranks),
                      key=lambda h: h["grads_err_over_tol"]),
                  "bytes_per_step_per_rank": ranks[0]["step_bytes"][0],
                  "bytes_equal_analytic": True,
                  "launches_per_rank": [{key: v for key, v in
                                         res["launches"].items() if v}
                                        for res in ranks],
                  "step_ms_gloo_over_host": [1e3 * h["seconds"] for h in
                                             ranks[0]["history"]],
                  "one_rank_step_ms": [1e3 * h["seconds"] for h in history],
                  "rank_peak_allocated_gb": [res["max_allocated"] / 1e9
                                             for res in ranks],
                  "rank_peak_reserved_gb": [res["max_reserved"] / 1e9
                                            for res in ranks],
                  "card_peak_gb": self.mesh_peak / 1e9,
                  "children_wall_s": wall})
            out[f"data {d} model {m}"] = [res["launches"] for res in ranks]
        ref_path.unlink()
        return out

    def micro_train_mesh(self) -> dict:
        """Phase 36: qwen3-moe-30b-a3b at full width and MOE_TRAIN_LAYERS
        layers, fp32, with A96_MICRO microbatches: (a) TRAIN_MESH_STEPS
        steps of ``launch.train.run`` and (b) one ``train_step`` on a
        TRAIN_BATCH x TRAIN_SEQ batch with a ``loss_mask`` (about 60% ones,
        numpy from A96_SEED) from the launcher's seed-0 parameters, each
        with no mesh in this process, its first step's first moments of
        the blocks written to a file under ``build/mesh``; then both as
        one job of gloo processes sharing the card at (data, model) =
        A96_MESH (``mesh_train_child``), each rank holding its blocks'
        gradients to those files.  Here, phase 32's checks: every rank's
        losses, grad norms and MoE statistics within 1e-4 relative of one
        rank's and equal to rank 0's, its launches ``train_launches``'
        with the microbatches, each group's bytes a step
        ``train_axis_bytes``' with the batch's exchange counted.  Returns
        each part's per-rank launches."""
        torch = self.torch
        from repro_torch import configs
        from repro_torch.data import SyntheticLMDataset
        from repro_torch.kernels import ops
        from repro_torch.launch import train as launch_train
        from repro_torch.models.model import init_params
        from repro_torch.optim import init_opt_state
        from repro_torch.tree import flatten_with_path, keystr
        get_config = configs.get_config
        cfg = get_config(QWEN3_MOE).with_updates(num_layers=MOE_TRAIN_LAYERS)
        tcfg = a96_train_config()
        b1 = tcfg.optimizer.b1
        work = ROOT / "build" / "mesh"
        work.mkdir(parents=True, exist_ok=True)
        paths = {part: work / f"a96-{part}-ref.pt" for part in "ab"}
        batch_path = work / "a96-masked-batch.pt"
        d, m = A96_MESH
        jobs = [{"kind": "train", "world": d * m, "data": d, "model": m,
                 "ref": str(paths["a"]), "arch": QWEN3_MOE,
                 "layers": MOE_TRAIN_LAYERS, "micro": A96_MICRO,
                 "masked": str(batch_path), "masked_ref": str(paths["b"]),
                 "env": {"PYTORCH_CUDA_ALLOC_CONF":
                         "expandable_segments:True"}}]
        self.start_ranks(jobs, "a96-")
        firsts = {"a": {}, "b": {}}
        metrics = {"a": [], "b": []}

        def blocks_mu(opt):
            return {keystr(p): t.detach().cpu() for p, t in
                    flatten_with_path(opt.mu) if "embeddings" not in keystr(p)}

        step = launch_train.train_step

        def keep_first(*args, **kw):
            out = step(*args, **kw)
            metrics["a"].append({k: float(v) for k, v in out[2].items()})
            if not firsts["a"]:
                firsts["a"]["mu"] = blocks_mu(out[1])
            return out

        history = []
        ops.reset_launch_counts()
        launch_train.train_step = keep_first
        configs.get_config = lambda arch: get_config(arch).with_updates(
            num_layers=MOE_TRAIN_LAYERS)
        try:
            launch_train.run(QWEN3_MOE, False, TRAIN_MESH_STEPS,
                             TRAIN_BATCH, TRAIN_SEQ, 1, 1, TRAIN_LR,
                             A96_MICRO, None, log_every=TRAIN_MESH_STEPS,
                             device=self.dev, seed=0, history=history)
        finally:
            launch_train.train_step = step
            configs.get_config = get_config
        one = {"a": ops.launch_counts()}
        self.free_memory()
        # (b): the masked batch, one step from the launcher's parameters
        rng = np.random.RandomState(A96_SEED)
        host = SyntheticLMDataset(cfg.vocab_size, seq_len=TRAIN_SEQ,
                                  seed=0).batch(TRAIN_BATCH, rng)
        host["loss_mask"] = (rng.rand(TRAIN_BATCH, TRAIN_SEQ - 1)
                             < 0.6).astype(np.float32)
        torch.save({k: torch.from_numpy(v) for k, v in host.items()},
                   batch_path)
        params = init_params(cfg, torch.Generator(self.dev).manual_seed(0),
                             self.dev)
        batch = {k: torch.from_numpy(v).to(self.dev)
                 for k, v in host.items()}
        ops.reset_launch_counts()
        _, opt, out = launch_train.train_step(cfg, tcfg, params,
                                              init_opt_state(params), batch)
        one["b"] = ops.launch_counts()
        metrics["b"].append({k: float(v) for k, v in out.items()})
        firsts["b"]["mu"] = blocks_mu(opt)
        del params, opt, out, batch
        for part, first in firsts.items():
            first["gmax"] = {key: (mu / (1 - b1)).abs().max().item()
                             for key, mu in first["mu"].items()}
            torch.save(first, paths[part])
        del firsts
        self.free_memory()
        steps = {"a": TRAIN_MESH_STEPS, "b": 1}
        want_launches = {}
        for part in "ab":
            want_launches[part] = {name: 0 for name in one[part]}
            want_launches[part].update(train_launches(cfg, steps[part], False,
                                                      A96_MICRO))
            if one[part] != want_launches[part]:
                raise AssertionError(f"one-rank {part} launched {one[part]}, "
                                     f"not {want_launches[part]}")
        if not metrics["a"][0]["dropped_fraction"] > 0:
            raise AssertionError("the capacity drops nothing: the MoE "
                                 "training runs hold no capacity")
        where = (f"{QWEN3_MOE} {MOE_TRAIN_LAYERS} layers training fp32 "
                 f"{A96_MICRO} microbatches (data {d}, model {m}) (gloo)")
        self.mesh_peak = 0
        t0 = time.perf_counter()
        ranks = self.mesh_children(jobs, "a96-")[0]
        wall = time.perf_counter() - t0
        exchange = {"a": TRAIN_BATCH * TRAIN_SEQ * 4,
                    "b": sum(v.nbytes for v in host.values())}
        for r, res in enumerate(ranks):
            parts = {"a": (res["step_bytes"], res["metrics"], res["history"],
                           res["launches"]),
                     "b": ([res["masked"]["bytes"]], [res["masked"]["metrics"]],
                           [res["masked"]["metrics"]],
                           res["masked"]["launches"])}
            for part, (step_bytes, got_metrics, got_history, launches) in \
                    parts.items():
                rank0 = (ranks[0]["metrics"] if part == "a"
                         else [ranks[0]["masked"]["metrics"]])
                for i, (got, want) in enumerate(zip(got_metrics,
                                                    metrics[part])):
                    for key in ("loss", "grad_norm", "lr", "ce_loss",
                                "load_balance_loss", "dropped_fraction"):
                        if got[key] != rank0[i][key] or not \
                                abs(got[key] - want[key]) <= \
                                1e-4 * abs(want[key]) + 1e-7:
                            raise AssertionError(
                                f"{where} ({part}) rank {r} step {i} {key}: "
                                f"{got[key]}, one rank {want[key]}")
                if len(got_metrics) != steps[part] or \
                        len(got_history) != steps[part]:
                    raise AssertionError(f"{where} ({part}) rank {r}: "
                                         f"{len(got_metrics)} steps")
                if launches != want_launches[part]:
                    raise AssertionError(f"{where} ({part}) rank {r}: "
                                         f"launches {launches} != "
                                         f"{want_launches[part]}")
                want_bytes = train_axis_bytes(cfg, d, m, TRAIN_BATCH,
                                              TRAIN_SEQ, 4, False, A96_MICRO,
                                              exchange[part], part == "b")
                for i, got in enumerate(step_bytes):
                    bytes_equal(f"{where} ({part}) rank {r} step {i}",
                                {key: v for key, v in got.items() if v},
                                want_bytes)
        emit({"a9_6_run": where, "ranks": d * m,
              "losses": [h["loss"] for h in ranks[0]["history"]],
              "losses_one_rank": [h["loss"] for h in history],
              "moe_metrics": ranks[0]["metrics"],
              "moe_metrics_one_rank": metrics["a"],
              "masked_metrics": ranks[0]["masked"]["metrics"],
              "masked_metrics_one_rank": metrics["b"][0],
              "worst_rank_after_step_0": max(
                  (res["held"] for res in ranks),
                  key=lambda h: h["grads_err_over_tol"]),
              "worst_rank_masked": max(
                  (res["masked"]["held"] for res in ranks),
                  key=lambda h: h["grads_err_over_tol"]),
              "bytes_per_step_per_rank": ranks[0]["step_bytes"][0],
              "masked_bytes_per_rank": ranks[0]["masked"]["bytes"],
              "exchange_bytes_per_rank": {
                  part: (d - 1) / d * b for part, b in exchange.items()},
              "bytes_equal_analytic": True,
              "launches_per_rank": [{key: v for key, v in
                                     res["launches"].items() if v}
                                    for res in ranks],
              "step_ms_gloo_over_host": [1e3 * h["seconds"] for h in
                                         ranks[0]["history"]],
              "one_rank_step_ms": [1e3 * h["seconds"] for h in history],
              "rank_peak_allocated_gb": [res["max_allocated"] / 1e9
                                         for res in ranks],
              "card_peak_gb": self.mesh_peak / 1e9,
              "children_wall_s": wall})
        for path in list(paths.values()) + [batch_path]:
            path.unlink()
        return {f"(a) data {d} model {m}": [res["launches"]
                                            for res in ranks],
                f"(b) data {d} model {m}": [res["masked"]["launches"]
                                            for res in ranks]}

    def sliding_variant(self) -> dict:
        """Phase 37: ``configs.shape_config_for("qwen3-0.6b",
        "long_500k")`` (window SWA_WINDOW) at full width and SWA_LAYERS
        layers, fp32: the batch E=1 round of one group of K through
        ``coded_prefill`` on a SWA_PROMPT-token prompt, past the window,
        then SWA_STEPS ``coded_decode_step`` calls on the SWA_WINDOW-slot
        ring, which wraps.  Every B3 call is held to its plain version
        stream by stream, and every B4 call to its plain version, under
        ``check``'s fp32 rule; the launches of the round are
        ``expected_launches``', the logits finite and the tokens in the
        vocabulary.  Returns the launches and the worst checks."""
        torch = self.torch
        from repro_torch import configs
        from repro_torch.core.berrut import CodingConfig
        from repro_torch.kernels import ops, ref
        from repro_torch.models.model import init_params
        from repro_torch.serving import coded_serving as cs
        cfg = configs.shape_config_for("qwen3-0.6b", "long_500k")
        if cfg.sliding_window != SWA_WINDOW:
            raise AssertionError(f"long_500k's window {cfg.sliding_window}")
        cfg = cfg.with_updates(num_layers=SWA_LAYERS)
        coding = CodingConfig(k=K, s=S, e=E)
        n1 = coding.num_workers
        gen = torch.Generator(self.dev).manual_seed(MESH_SEED)
        params = init_params(cfg, gen, self.dev)
        tokens = torch.randint(0, cfg.vocab_size, (K, SWA_PROMPT),
                               generator=gen, device=self.dev)
        held = {"flash_attention": [], "flash_decode": []}
        real_attention, real_decode = ops.attention, ops.decode_attention

        def attention(q, k, v, **kw):
            out = real_attention(q, k, v, **kw)
            if kw.get("window") != SWA_WINDOW:
                raise AssertionError(f"B3 called with {kw}")
            with torch.no_grad():
                want = torch.cat([ref.attention_ref(q[i:i + 1], k[i:i + 1],
                                                    v[i:i + 1], **kw)
                                  for i in range(q.shape[0])])
            held["flash_attention"].append(self.check(
                f"B3 window {SWA_WINDOW} {list(q.shape)}", out, want,
                "float32"))
            return out

        def decode_attention(q, k_cache, v_cache, kv_mask, *,
                             kv_scale=0.0, **kw):
            out = real_decode(q, k_cache, v_cache, kv_mask,
                              kv_scale=kv_scale, **kw)
            if kv_scale or kw.get("return_lse"):
                raise AssertionError(f"B4 called with {kw}, kv_scale "
                                     f"{kv_scale}")
            want = ref.decode_attention_ref(q, k_cache, v_cache, kv_mask,
                                            **kw)
            held["flash_decode"].append(self.check(
                f"B4 ring {k_cache.shape[1]} {list(q.shape)}", out, want,
                "float32"))
            return out

        mask = torch.ones(n1, device=self.dev)
        mask[MESH_STRAGGLER] = 0.0
        byz = torch.zeros(n1, device=self.dev)
        byz[MESH_ATTACKER] = 1.0
        kw = dict(straggler_mask=mask, byz_mask=byz, byz_sigma=10.0,
                  with_report=True)
        max_len = SWA_PROMPT + SWA_STEPS + 2
        torch.cuda.reset_peak_memory_stats(self.dev)
        ops.reset_launch_counts()
        ops.attention, ops.decode_attention = attention, decode_attention
        out_tokens, located = [], []
        try:
            with self.finite_logits("long_500k sliding variant"):
                logits, state, rep = cs.coded_prefill(
                    cfg, coding, params, {"tokens": tokens}, max_len,
                    byz_noise=torch.randn((1, n1, cfg.vocab_size),
                                          generator=gen, device=self.dev),
                    **kw)
                for _ in range(SWA_STEPS):
                    nxt = logits.argmax(-1)
                    out_tokens.append(nxt)
                    located.append(rep[0])
                    logits, state, rep = cs.coded_decode_step(
                        cfg, coding, params, state, nxt[:, None],
                        byz_noise=torch.randn((1, n1, cfg.vocab_size),
                                              generator=gen,
                                              device=self.dev), **kw)
                out_tokens.append(logits.argmax(-1))
                located.append(rep[0])
                torch.cuda.synchronize()
        finally:
            ops.attention, ops.decode_attention = real_attention, real_decode
        launches = ops.launch_counts()
        expected = self.expected_launches("qwen3-0.6b", 1, SWA_STEPS,
                                          pool=False, layers=SWA_LAYERS)
        width = state.caches[0]["k"].shape[2]
        toks = torch.stack(out_tokens, 1)
        emit({"path": "qwen3-0.6b long_500k sliding variant",
              "launches": launches, "expected": expected})
        if launches != expected:
            raise AssertionError(f"launch counts {launches} != {expected}")
        if width != SWA_WINDOW or state.pos != SWA_PROMPT + SWA_STEPS:
            raise AssertionError(f"cache width {width}, pos {state.pos}")
        if len(held["flash_attention"]) != SWA_LAYERS or \
                len(held["flash_decode"]) != SWA_LAYERS * SWA_STEPS:
            raise AssertionError(f"checked {len(held['flash_attention'])} B3"
                                 f" and {len(held['flash_decode'])} B4 calls")
        if toks.shape != (K, 1 + SWA_STEPS) or toks.min() < 0 or \
                toks.max() >= cfg.vocab_size:
            raise AssertionError(f"bad token matrix {tuple(toks.shape)}")
        worst = {name: max(checks, key=lambda c: c["err_over_tol"])
                 for name, checks in held.items()}
        emit({"long_500k": cfg.name, "window": cfg.sliding_window,
              "layers": SWA_LAYERS, "streams": n1, "prompt": SWA_PROMPT,
              "decode_calls": SWA_STEPS, "cache_length": width,
              "located_attacker_rounds": int(sum(
                  bool(loc[0, MESH_ATTACKER]) for loc in located)),
              "worst_b3": worst["flash_attention"],
              "worst_b4": worst["flash_decode"],
              "peak_allocated_gb":
                  torch.cuda.max_memory_allocated(self.dev) / 1e9})
        return {"launches": launches,
                "held": {name: {"checked_calls": len(held[name]),
                                "max_abs_err": c["max_abs_err"],
                                "err_over_tol": c["err_over_tol"]}
                         for name, c in worst.items()}}

    def front_inputs(self, cfg, groups: int) -> dict:
        """A frontend's batch E=1 round inputs on the card, drawn from
        ``MESH_SEED``: ``groups`` groups of K requests (hubert: FRAMES
        frames each; paligemma: its patches and FRONT_TEXT text tokens,
        and MESH_STEPS fixed next tokens), one straggler, a sigma-10
        attacker and its (G, N+1, V) noise."""
        torch = self.torch
        from repro_torch.core.berrut import CodingConfig
        n1 = CodingConfig(k=K, s=S, e=E).num_workers
        gen = torch.Generator(self.dev).manual_seed(MESH_SEED)
        rows = groups * K
        mask = torch.ones(n1, device=self.dev)
        mask[MESH_STRAGGLER] = 0.0
        byz = torch.zeros(n1, device=self.dev)
        byz[MESH_ATTACKER] = 1.0
        out = {"mask": mask, "byz": byz}
        if cfg.modality == "audio":
            out["frames"] = torch.randn((rows, FRAMES, cfg.frontend_dim),
                                        generator=gen, device=self.dev)
            out["steps"] = torch.zeros((0, rows, 1), dtype=torch.int64,
                                       device=self.dev)
        else:
            out["patches"] = torch.randn((rows, cfg.num_patches,
                                          cfg.frontend_dim), generator=gen,
                                         device=self.dev)
            out["tokens"] = torch.randint(0, cfg.vocab_size,
                                          (rows, FRONT_TEXT), generator=gen,
                                          device=self.dev)
            out["steps"] = torch.randint(0, cfg.vocab_size,
                                         (MESH_STEPS, rows, 1),
                                         generator=gen, device=self.dev)
        out["noise"] = torch.randn((groups, n1, cfg.vocab_size),
                                   generator=gen, device=self.dev)
        return out

    def front_mesh(self) -> dict:
        """Phase 33: the frontends on a 2-way model axis, fp32 at full
        width and FRONT_MESH_LAYERS layers, 2 gloo processes each sharing
        the card (both jobs at once): hubert-xlarge's ``coded_prefill`` of
        FRONT_GROUPS groups of K requests of FRAMES frames at E=1 (MHA
        8/8 heads of 80 a rank, non-causal; its 504 labels split in two),
        and paligemma-3b's batch E=1 round (MESH_GROUPS groups, 256
        patches and FRONT_TEXT tokens under prefix-LM, MESH_STEPS decode
        steps; its one kv-head whole, the ring split in two), each against
        the same with no mesh on the card: decoded logits within
        MESH_TOL, tokens up to near ties, verdicts equal; per-rank
        launches held; each call's bytes equal to ``model_axis_bytes``.
        Returns the per-rank launches of each run."""
        torch = self.torch
        from repro_torch import configs
        from repro_torch.core.berrut import CodingConfig
        from repro_torch.models.model import init_params
        self.free_memory()
        plain, jobs = {}, []
        for arch in FRONTENDS:
            cfg = configs.get_config(arch).with_updates(
                num_layers=FRONT_MESH_LAYERS[arch])
            inputs = self.front_inputs(
                cfg, FRONT_GROUPS if arch == HUBERT else MESH_GROUPS)
            seq = FRAMES if arch == HUBERT else cfg.num_patches + FRONT_TEXT
            max_len = seq + MESH_STEPS + 2
            max_len += max_len % 2               # a ring the axis splits
            params = init_params(cfg, torch.Generator(self.dev).manual_seed(
                MESH_SEED), self.dev)
            plain[arch] = (cfg, seq, mesh_rounds(cfg, params, inputs,
                                                 max_len=max_len))
            del params
            path = ROOT / "build" / "mesh" / f"inputs-front-{arch}.pt"
            path.parent.mkdir(parents=True, exist_ok=True)
            torch.save({key: v.cpu() for key, v in inputs.items()}, path)
            jobs.append({"kind": "front", "world": 2, "model": 2,
                         "batch": True, "arch": arch,
                         "layers": FRONT_MESH_LAYERS[arch],
                         "max_len": max_len, "inputs": str(path)})
            self.free_memory()
        self.mesh_peak = 0
        t0 = time.perf_counter()
        runs = self.mesh_children(jobs, "front-mesh-", together=True)
        wall = time.perf_counter() - t0
        coding = CodingConfig(k=K, s=S, e=E)
        out = {}
        for arch, ranks in zip(FRONTENDS, runs):
            cfg, seq, want = plain[arch]
            groups = FRONT_GROUPS if arch == HUBERT else MESH_GROUPS
            decodes = len(want["batch"]) - 1
            where = (f"{arch} {cfg.num_layers} layers fp32 K={K} S={S} "
                     f"E={E} at model 2 (gloo)")
            launches = self.expected_launches(arch, 1, decodes, pool=False,
                                              layers=cfg.num_layers)
            worst = 0.0
            for r, res in enumerate(ranks):
                if res["batch_launches"] != launches:
                    raise AssertionError(f"{where} rank {r}: launches "
                                         f"{res['batch_launches']} != "
                                         f"{launches}")
                worst = max(worst, hold_calls(f"{where} rank {r}",
                                              res["batch"], want["batch"]))
                for i, got in enumerate(res["batch_bytes"]):
                    step = seq if i == 0 else 1
                    embed = (0 if cfg.modality == "audio" else
                             FRONT_TEXT if i == 0 else 1)
                    groups_equal(f"{where} rank {r} call {i}", got, {
                        "model": model_axis_bytes(
                            cfg, 2, groups * K, groups * coding.num_workers,
                            step, i > 0, embed_seq=embed)})
            emit({"mesh_run": where, "calls": 1 + decodes,
                  "worst_err_over_tol": worst,
                  "launches_per_rank": [{key: res["batch_launches"][key]
                                         for key in MP2_KERNELS}
                                        for res in ranks],
                  "collective_bytes_per_call": ranks[0]["batch_bytes"],
                  "bytes_equal_analytic": True,
                  "call_ms_gloo_over_host": ranks[0]["batch_ms"]})
            out[arch] = [res["batch_launches"] for res in ranks]
        emit({"front_mesh": "gloo ranks on one card, both jobs at once",
              "children_wall_s": wall,
              "card_peak_memory_gb": self.mesh_peak / 1e9})
        return out

    def a93_entry(self, name: str, launches: dict) -> dict:
        """The kernels line's ``a9_3`` numbers of ``name``: its launches on
        each rank of every run of phases 31-33, and for B3 and B5 their
        numbers at a model-2 rank's heads (qwen3-moe's bf16, hubert's
        fp32, phase 31's kernel checks)."""
        keys = ("shape", "max_abs_err", "ms", "graph_ms", "plain_ms",
                "bound_ms", "bound_by", "library_ms")
        out = {"launches_per_rank": {
            f"{phase} {run}": [r[name] for r in ranks]
            for phase, runs in launches.items()
            for run, ranks in runs.items()}}
        for arch, table in self.kernels_a93.items():
            if name in table:
                out[f"{arch} model-2 heads"] = {
                    key: table[name][key] for key in keys}
        return out


    # --------------------------- Mamba2 and zamba2 on the model axis

    def ssm_mesh_kernels(self):
        """Phase 34's kernels at a model-2 rank's heads, fp32: B7 and its
        scores pass at mamba2-780m's multihost prefill (MH_SLOTS x 9 = 72
        streams of MH_PROMPT tokens, 24 heads of 64, state 128) and at
        zamba2-1.2b's batch E=1 prefill (MESH_GROUPS x 11 = 22 streams of
        MESH_PROMPT tokens, 32 heads of 64, state 64) (``mamba2_kernels``);
        B7's backward and its head sum at both at the launcher's
        TRAIN_BATCH x TRAIN_SEQ, held to ``ref.ssd_chunked_bwd_ref`` under
        BWD_TOL (``bwd_checks``) and timed (``b7_backward_timing``)."""
        from repro_torch import configs
        from repro_torch.core.berrut import CodingConfig
        from repro_torch.kernels import ref, ssd_scan
        from repro_torch.models.mamba2 import ssd_chunk
        gen = self.torch.Generator(self.dev).manual_seed(20)
        shapes = {"mamba2-780m": (MH_SLOTS * CodingConfig(
                      k=MH_K, s=MH_S, e=0).num_workers, MH_PROMPT),
                  ZAMBA2: (MESH_GROUPS * CodingConfig(K, S, E).num_workers,
                           MESH_PROMPT)}
        for arch, (streams, prompt) in shapes.items():
            cfg = configs.get_config(arch)
            local = cfg.with_updates(d_model=cfg.d_model // 2)
            if (local.ssm_heads, local.ssm_head_dim, local.ssm_state) != (
                    cfg.ssm_heads // 2, 64, cfg.ssm_state):
                raise AssertionError(f"{arch}'s model-2 heads changed")
            table = self.kernels_a93b.setdefault(arch, {})
            self.mamba2_kernels("float32", local, table, gen,
                                streams=streams, prompt=prompt)
            h, p, n = local.ssm_heads, local.ssm_head_dim, local.ssm_state
            b, s = TRAIN_BATCH, TRAIN_SEQ
            chunk = ssd_chunk(cfg.ssm_chunk, s)
            args = self.ssd_inputs(b, s, h, p, n, self.torch.float32,
                                   gen=gen)
            dy = self.randn(b, s, h, p, gen=gen)
            got = ssd_scan.ssd_chunked_bwd(*args, dy)
            want = ref.ssd_chunked_bwd_ref(*args, dy, chunk=chunk)
            where = (f"ssd_chunked_bwd {arch} model-2 heads B={b} S={s} "
                     f"H={h} P={p} N={n}")
            emit({"variant": where, "dtype": "float32",
                  **self.bwd_checks(where, "float32", got, want, {})})
            self.b7_backward_timing(arch, "float32", args, dy, chunk, got,
                                    want, table=table)

    def ssm_cache_share(self, where: str, cfg, mine: list, whole: list,
                        mesh) -> float:
        """Each run's caches of a mesh rank against its block of the
        no-mesh caches (``shardings.cache_shardings`` on ``mesh``: its
        streams, its kv-heads, its SSM heads and conv channels [x_r | B |
        C]), under MESH_TOL; returns the worst share of the tolerance."""
        from repro_torch.launch import shardings
        block = shardings.local_shard(
            whole, shardings.cache_shardings(mesh, cfg, whole), mesh)
        worst = 0.0
        for i, (got, want) in enumerate(zip(mine, block)):
            for name, leaf in want.items():
                worst = max(worst, logits_share(
                    f"{where} run {i} cache {name} (its block)", got[name],
                    leaf))
        return worst

    def ssm_mesh(self) -> dict:
        """Phase 34: Mamba2's "S" blocks on the model axis at full width
        and depth, fp32, gloo processes sharing cuda:0, every job at once:
        (a) mamba2-780m's ``multihost --mode serve --model-par 2`` at its
        defaults (K=7 S=2 E=0, MH_SLOTS slots: 72 streams, BA_STEPS decode
        calls) against the same pool with no mesh (``plain_pool``); (b)
        its batch E=1 round and worker-major slot pool on (data, model) =
        SSM_MESH_DATA and (c) zamba2-1.2b's batch E=1 round at model 2,
        each against the same with no mesh on the card.  Phase 24's
        rules: every rank's tokens the same and held up to the first near
        tie, decoded logits within MESH_TOL, verdicts equal; each rank's
        caches its block of the no-mesh caches (``ssm_cache_share``; in
        (a) the last layer's, ``last_pool_caches``);
        per-rank launches held and printed; each call's bytes by group
        and op equal to ``batch_axes_bytes`` plus ``ssm_axis_bytes``; the
        card's peak memory.  Returns the per-rank launches of every run."""
        torch = self.torch
        from repro_torch import configs
        from repro_torch.core.berrut import CodingConfig
        from repro_torch.models import partitioning
        from repro_torch.models.model import init_params
        mamba = configs.get_config("mamba2-780m").with_updates(
            param_dtype="float32", activation_dtype="float32")
        zamba = configs.get_config(ZAMBA2).with_updates(
            param_dtype="float32", activation_dtype="float32")
        self.free_memory()
        d, m = SSM_MESH_DATA
        rounds = (("mamba2-780m", mamba, {"world": d * m, "model": m,
                                          "data": d, "pool": True}),
                  (ZAMBA2, zamba, {"world": 2, "model": 2}))
        paths = {arch: ROOT / "build" / "mesh" / f"inputs-ssm-{arch}.pt"
                 for arch, _, _ in rounds}
        jobs = [{"kind": "ssm_multihost", "world": 2, "model": 2,
                 "arch": mamba.name}]
        jobs += [dict(job, kind="ssm_rounds", batch=True, caches=True,
                      arch=arch, inputs=str(paths[arch]))
                 for arch, _, job in rounds]
        self.start_ranks(jobs, "ssm-mesh-")
        pool_caches = {}
        with last_pool_caches(pool_caches):
            tokens, pool_logits = self.plain_pool(mamba, MH_S, MH_SLOTS,
                                                  BA_STEPS)
        plain = {}
        for arch, cfg, job in rounds:
            inputs = self.mesh_inputs(cfg)
            params = init_params(cfg, torch.Generator(self.dev).manual_seed(
                MESH_SEED), self.dev)
            plain[arch] = mesh_rounds(cfg, params, inputs,
                                      pool=job.get("pool", False),
                                      caches=True)
            del params
            self.free_memory()
            torch.save({key: v.cpu() for key, v in inputs.items()},
                       paths[arch])
        self.mesh_peak = 0
        t0 = time.perf_counter()
        runs = self.mesh_children(jobs, "ssm-mesh-", together=True)
        wall = time.perf_counter() - t0
        out = {}
        # (a) the multihost serve at model 2
        ranks, cfg = runs[0], mamba
        coding = CodingConfig(k=MH_K, s=MH_S, e=0)
        streams = MH_SLOTS * coding.num_workers
        where = f"multihost serve {cfg.name} fp32 model 2 (gloo)"
        want = self.expected_launches(cfg.name, 1, BA_STEPS, pool=True,
                                      worker_major=True)
        for r, res in enumerate(ranks):
            if not np.array_equal(res["tokens"], ranks[0]["tokens"]):
                raise AssertionError(f"{where}: rank {r}'s tokens differ")
            if res["launches"] != want:
                raise AssertionError(f"{where} rank {r}: launches "
                                     f"{res['launches']} != {want}")
        held = near_tie_rows(where, ranks[0]["tokens"], tokens, pool_logits)
        worst = cache_worst = 0.0
        for r, res in enumerate(ranks):
            for i in range(min(held + 1, len(pool_logits))):
                worst = max(worst, logits_share(
                    f"{where} rank {r} call {i}", res["pool_logits"][i],
                    pool_logits[i]))
            if held == len(pool_logits):        # the same tokens throughout
                cache_worst = max(cache_worst, self.ssm_cache_share(
                    f"{where} rank {r} last layer", cfg, res["caches"],
                    pool_caches["caches"],
                    partitioning.Mesh(("worker", "model"), (1, 2), r)))
            for kind, calls_bytes in res["call_bytes"].items():
                seq = MH_PROMPT if kind == "prefill" else 1
                for i, got in enumerate(calls_bytes):
                    groups_equal(
                        f"{where} rank {r} {kind} call {i}", got,
                        add_bytes(batch_axes_bytes(
                            coding, MH_SLOTS, cfg.vocab_size, 1, 1, 2, True,
                            sampled=True, cfg=cfg, seq=seq),
                            ssm_axis_bytes(cfg, 2, streams, seq)))
        ms = ranks[0]["call_ms"]
        emit({"mesh_run": where, "ranks": 2, "tokens_held_calls": held,
              "pool_logits_worst_err_over_tol": worst,
              "last_layer_caches_worst_err_over_tol": cache_worst,
              "launches_per_rank": [{key: res["launches"][key]
                                     for key in MP2_KERNELS + SSD_KERNELS}
                                    for res in ranks],
              "collective_bytes_per_call": ranks[0]["call_bytes"],
              "bytes_equal_analytic": True,
              "prefill_ms_gloo_over_host": ms["prefill"][0],
              "decode_ms_gloo_over_host": ms["decode"]})
        out["multihost (worker 1, model 2)"] = [res["launches"]
                                                for res in ranks]
        # (b) and (c): the batch round (and slot pool) against no mesh
        coding = CodingConfig(K, S, E)
        for (arch, cfg, axes, shape), ranks in zip(
                (("mamba2-780m", mamba, ("data", "model"), SSM_MESH_DATA),
                 (ZAMBA2, zamba, ("data", "model"), (1, 2))), runs[1:]):
            kinds = ("batch", "pool") if arch == "mamba2-780m" else \
                ("batch",)
            where = (f"{arch} fp32 K={K} S={S} E={E} on "
                     f"{dict(zip(axes, shape))} (gloo)")
            b, mm = shape
            local = -(-MESH_GROUPS * coding.num_workers // b)
            worst = cache_worst = 0.0
            for r, res in enumerate(ranks):
                mesh = partitioning.Mesh(axes, shape, r)
                for kind in kinds:
                    wm_run = kind == "pool"
                    launches = self.expected_launches(
                        arch, 1, MESH_STEPS, pool=wm_run,
                        worker_major=wm_run)
                    if res[kind + "_launches"] != launches:
                        raise AssertionError(
                            f"{where} {kind} rank {r}: launches "
                            f"{res[kind + '_launches']} != {launches}")
                    worst = max(worst, hold_calls(
                        f"{where} {kind} rank {r}", res[kind],
                        plain[arch][kind]))
                    cache_worst = max(cache_worst, self.ssm_cache_share(
                        f"{where} {kind} rank {r}", cfg,
                        res[kind + "_caches"], plain[arch][kind + "_caches"],
                        mesh))
                    for i, got in enumerate(res[kind + "_bytes"]):
                        seq = MESH_PROMPT if i == 0 else 1
                        groups_equal(
                            f"{where} {kind} rank {r} call {i}", got,
                            add_bytes(batch_axes_bytes(
                                coding, MESH_GROUPS, cfg.vocab_size, b, 1,
                                mm, wm_run, cfg=cfg, seq=seq),
                                ssm_axis_bytes(cfg, mm, local, seq)))
            emit({"mesh_run": where, "parts": kinds,
                  "worst_err_over_tol": worst,
                  "caches": "stream blocks, SSM heads and conv channels "
                            "[x_r | B | C], kv-head blocks",
                  "caches_worst_err_over_tol": cache_worst,
                  "launches_per_rank": {kind: [{key: res[kind + "_launches"]
                                                [key] for key in
                                                MP2_KERNELS + SSD_KERNELS}
                                               for res in ranks]
                                        for kind in kinds},
                  "collective_bytes_per_call": {
                      kind: ranks[0][kind + "_bytes"] for kind in kinds},
                  "bytes_equal_analytic": True,
                  "call_ms_gloo_over_host": {kind: ranks[0][kind + "_ms"]
                                             for kind in kinds}})
            for kind in kinds:
                out[f"{arch} {kind} {dict(zip(axes, shape))}"] = [
                    res[kind + "_launches"] for res in ranks]
        emit({"ssm_mesh": "gloo ranks on one card, every job at once",
              "ranks": [job["world"] for job in jobs],
              "children_wall_s": wall,
              "card_peak_memory_gb": self.mesh_peak / 1e9,
              "rank_max_reserved_gb": [res["max_reserved"] / 1e9
                                       for ranks in runs for res in ranks]})
        return out

    def ssm_train_mesh(self) -> dict:
        """Phase 35: Mamba2's "S" blocks training on the model axis, fp32,
        at full width and SSM_TRAIN_CUT's depth: TRAIN_MESH_STEPS steps of
        ``launch.train.run`` (the launcher's TRAIN_BATCH x TRAIN_SEQ, lr
        TRAIN_LR) with no mesh in this process for each arch, its first
        step's first moments (the embeddings' left out) written to
        ``build/mesh/ssm-train-<arch>.pt``; then the same run on each
        (arch, (data, model)) of SSM_TRAIN_MESH as gloo processes sharing
        the card, every job at once, each rank holding its blocks'
        gradients to that file after its first step
        (``hold_train_blocks``: B and C's columns in every rank's
        block).  Here: every rank's losses and grad norms within
        1e-4 relative of one rank's and equal to rank 0's, its launches
        ``train_launches``' (B7's backward and head sum one a layer a
        step), each group's bytes a step ``train_axis_bytes``'.  Returns
        each mesh's per-rank launches."""
        torch = self.torch
        from repro_torch import configs
        from repro_torch.kernels import ops
        from repro_torch.launch import train as launch_train
        from repro_torch.tree import flatten_with_path, keystr
        b1 = self.train_config(TRAIN_MESH_STEPS).optimizer.b1
        step, get_config = launch_train.train_step, configs.get_config
        self.free_memory()
        refs = {arch: ROOT / "build" / "mesh" / f"ssm-train-{arch}.pt"
                for arch in dict(SSM_TRAIN_MESH)}
        jobs = [{"kind": "train", "world": d * m, "data": d, "model": m,
                 "ref": str(refs[arch]), "arch": arch,
                 "layers": SSM_TRAIN_CUT[arch]["num_layers"],
                 "pattern": SSM_TRAIN_CUT[arch].get("layer_pattern")}
                for arch, (d, m) in SSM_TRAIN_MESH]
        self.start_ranks(jobs, "ssm-train-")
        one = {}
        for arch in dict(SSM_TRAIN_MESH):
            cut = SSM_TRAIN_CUT[arch]
            cfg = configs.get_config(arch).with_updates(**cut)
            ref_path = refs[arch]
            first = {}

            def keep_first(*args, **kw):
                res = step(*args, **kw)
                if not first:
                    first["mu"] = {keystr(p): t.detach().cpu() for p, t in
                                   flatten_with_path(res[1].mu)
                                   if "embeddings" not in keystr(p)}
                return res

            history = []
            ops.reset_launch_counts()
            launch_train.train_step = keep_first
            configs.get_config = lambda name, cut=cut: get_config(
                name).with_updates(**cut)
            try:
                launch_train.run(arch, False, TRAIN_MESH_STEPS, TRAIN_BATCH,
                                 TRAIN_SEQ, 1, 1, TRAIN_LR, 1, None,
                                 log_every=TRAIN_MESH_STEPS,
                                 device=self.dev, seed=0, history=history)
            finally:
                launch_train.train_step = step
                configs.get_config = get_config
            launches = ops.launch_counts()
            first["gmax"] = {key: (mu / (1 - b1)).abs().max().item()
                             for key, mu in first["mu"].items()}
            torch.save(first, ref_path)
            del first
            self.free_memory()
            want = {name: 0 for name in launches}
            want.update(train_launches(cfg, TRAIN_MESH_STEPS, False))
            if launches != want:
                raise AssertionError(f"one-rank {arch} training launched "
                                     f"{launches}, not {want}")
            one[arch] = (cfg, ref_path, history, want)
        out = {}
        self.mesh_peak = 0
        t0 = time.perf_counter()
        runs = self.mesh_children(jobs, "ssm-train-", together=True)
        wall = time.perf_counter() - t0
        for (arch, (d, m)), ranks in zip(SSM_TRAIN_MESH, runs):
            cfg, ref_path, history, want_launches = one[arch]
            where = (f"{arch} {cfg.num_layers} layers training fp32 (data "
                     f"{d}, model {m}) (gloo)")
            want_bytes = train_axis_bytes(cfg, d, m, TRAIN_BATCH, TRAIN_SEQ,
                                          4, False)
            for r, res in enumerate(ranks):
                for i, (got, ref1) in enumerate(zip(res["history"],
                                                    history)):
                    for key in ("loss", "grad_norm", "lr"):
                        if got[key] != ranks[0]["history"][i][key] or not \
                                abs(got[key] - ref1[key]) <= \
                                1e-4 * abs(ref1[key]):
                            raise AssertionError(
                                f"{where} rank {r} step {i} {key}: "
                                f"{got[key]}, one rank {ref1[key]}")
                if res["launches"] != want_launches:
                    raise AssertionError(f"{where} rank {r}: launches "
                                         f"{res['launches']} != "
                                         f"{want_launches}")
                for i, got in enumerate(res["step_bytes"]):
                    bytes_equal(f"{where} rank {r} step {i}",
                                {key: v for key, v in got.items() if v},
                                want_bytes)
            emit({"train_mesh_run": where, "ranks": d * m,
                  "steps": TRAIN_MESH_STEPS,
                  "losses": [h["loss"] for h in ranks[0]["history"]],
                  "losses_one_rank": [h["loss"] for h in history],
                  "grad_norms": [h["grad_norm"]
                                 for h in ranks[0]["history"]],
                  "grad_norms_one_rank": [h["grad_norm"] for h in history],
                  "worst_rank_after_step_0": max(
                      (res["held"] for res in ranks),
                      key=lambda h: h["grads_err_over_tol"]),
                  "bytes_per_step_per_rank": ranks[0]["step_bytes"][0],
                  "bytes_equal_analytic": True,
                  "launches_per_rank": [{key: v for key, v in
                                         res["launches"].items() if v}
                                        for res in ranks],
                  "step_ms_gloo_over_host": [1e3 * h["seconds"] for h in
                                             ranks[0]["history"]],
                  "one_rank_step_ms": [1e3 * h["seconds"] for h in history],
                  "rank_peak_allocated_gb": [res["max_allocated"] / 1e9
                                             for res in ranks]})
            out[f"{arch} data {d} model {m}"] = [res["launches"]
                                                 for res in ranks]
        emit({"ssm_train_mesh": "gloo ranks on one card, every job at once",
              "ranks": [d * m for _, (d, m) in SSM_TRAIN_MESH],
              "children_wall_s": wall,
              "card_peak_memory_gb": self.mesh_peak / 1e9})
        for _, ref_path, _, _ in one.values():
            ref_path.unlink()
        return out

    def a93b_entry(self, name: str, launches: dict) -> dict:
        """The kernels line's numbers of ``name`` on the Mamba2 model axis
        (phases 34-35): its launches on each rank of every run, and for
        B7's four kernels their fp32 numbers at a model-2 rank's heads of
        mamba2-780m and zamba2-1.2b (phase 34's kernel checks)."""
        keys = ("shape", "max_abs_err", "ms", "graph_ms", "plain_ms",
                "bound_ms", "bound_by", "library_ms")
        out = {"launches_per_rank": {
            f"{phase} {run}": [r[name] for r in ranks]
            for phase, runs in launches.items()
            for run, ranks in runs.items()}}
        for arch, table in self.kernels_a93b.items():
            if name in table:
                out[f"{arch} model-2 heads"] = {
                    key: table[name][key] for key in keys}
        return out


def mesh_multihost_argv(store, world: int, rank: int, model: int,
                        backend: str = "nccl", s: int = MESH_S,
                        steps: int = MESH_STEPS,
                        slots: int = MH_SLOTS) -> list:
    """``multihost --mode serve`` at its defaults with ``--s``, fp32,
    ``slots`` group slots and ``steps`` decode calls (phases 23-24: S=3,
    MESH_STEPS, MH_SLOTS), on ``world`` processes with a ``model``-way
    model axis."""
    return ["--mode", "serve", "--coordinator", f"file://{store}",
            "--num-processes", str(world), "--process-id", str(rank),
            "--s", str(s), "--dtype", "float32", "--steps", str(steps),
            "--pool-groups", str(slots), "--model-par", str(model),
            "--backend", backend]


def batch_axes_bytes(coding, groups: int, vocab: int, b: int, w: int,
                     m: int, worker_major: bool, sampled: bool = False,
                     cfg=None, seq: int = 1) -> dict:
    """Per-rank bytes by group and op of one serving call (fp32, the ring
    accounting of ``partitioning.WorkerGroup``) on a mesh of ``b`` ranks
    over the batch axes ("pod", "data"), ``w`` workers and ``m`` model
    ranks (the model dividing the kv-heads), ``groups`` groups:
    "fsdp" (the batch group) all-gathers the (streams, V) coded logits of
    the padded group-major streams, or worker-major of the worker's
    block; on a worker axis the survivor tail (gather width N+1)
    all-gathers the (N+1, G, C_vote) vote columns at E > 0, then where W
    divides V reduce-scatters the (N+1, G, V) survivor buffer over the
    vocabulary and all-gathers the (G K, V) decoded rows, or with
    ``sampled`` (greedy) each row's best value and index, else
    all-reduces the buffer; "model" (``cfg``, ``seq`` tokens a stream)
    ``model_axis_bytes`` of a rank's streams."""
    n1 = coding.num_workers
    rows = groups * n1 // w if worker_major else -(-groups * n1 // b) * b
    out = {}
    if b > 1:
        out["fsdp"] = {"all-gather": (b - 1) / b * 4 * rows * vocab}
    if w > 1:
        tail = {"all-gather": (w - 1) / w * 4 * n1 * groups * coding.c_vote
                if coding.e else 0.0}
        if vocab % w == 0:
            tail["reduce-scatter"] = (w - 1) * 4 * n1 * groups * vocab / w
            tail["all-gather"] += (w - 1) / w * 4 * groups * coding.k \
                * (2 if sampled else vocab)
        else:
            tail["all-reduce"] = 2 * (w - 1) / w * 4 * n1 * groups * vocab
        out["worker"] = tail
    if m > 1:
        streams = rows // b if worker_major else rows // (b * w)
        out["model"] = model_axis_bytes(cfg, m, groups * coding.k, streams,
                                        seq, False)
    for ops in out.values():
        ops["total"] = sum(v for k, v in ops.items() if k != "total")
    return out


def groups_equal(where: str, got: dict, want: dict) -> None:
    """A call's collective bytes by group and op equal to the analytic
    count: every group that moved bytes is counted, and each op holds."""
    moved = {g for g, ops in got.items() if ops.get("total", 0.0)}
    if moved != set(want):
        raise AssertionError(f"{where}: groups {sorted(moved)} moved bytes, "
                             f"the count has {sorted(want)}")
    for group, ops in want.items():
        bytes_equal(f"{where} {group}", got[group], ops)


def model_axis_bytes(cfg, m: int, rows: int, streams: int, seq: int,
                     decode: bool, embed_seq=None) -> dict:
    """Per-rank bytes of one serving call on an ``m``-way model axis that
    splits the q-heads, the dense MLPs and the vocabulary and, in a
    decode call, the ring of the caches (not the kv-heads), fp32, under
    the ring accounting of ``partitioning.WorkerGroup``: the token
    embeddings' all-reduce of (rows, ``embed_seq``, d) (``seq`` by
    default; 0 for an audio model, whose frames are projected by a whole
    leaf, the text alone for a vlm), an all-reduce of (streams, seq, d)
    for each attention layer ("A", "M" and each shared "G" position) and
    each dense MLP ("A" and "G": the MoE layer's own is
    ``moe_axis_bytes``', the Mamba2 layers' ``ssm_axis_bytes``'), and
    the logits' all-gather of (streams, V); in a decode call also per
    attention layer the q-heads' all-gather (streams, H, D), the lse's
    all-gather (m, streams, H) and the merge's reduce-scatter of
    (streams, H / m, D)."""
    frac = (m - 1) / m
    d, h, hd = cfg.d_model, cfg.num_heads, cfg.head_dim
    attention = sum(cfg.layer_pattern.count(c) for c in "AMG")
    dense = sum(cfg.layer_pattern.count(c) for c in "AG")
    embed_seq = seq if embed_seq is None else embed_seq
    out = {"all-reduce": 2 * frac * 4 * (rows * embed_seq * d
                                         + (attention + dense) * streams
                                         * seq * d),
           "all-gather": frac * 4 * streams * cfg.vocab_size}
    if decode:
        out["all-gather"] += attention * frac * 4 * (streams * h * hd
                                                     + m * streams * h)
        out["reduce-scatter"] = attention * (m - 1) * 4 * streams \
            * (h // m) * hd
    out["total"] = sum(out.values())
    return out


def ssm_axis_bytes(cfg, m: int, streams: int, seq: int,
                   size: int = 4) -> dict:
    """Per-rank bytes of the Mamba2 "S" layers of one serving call on an
    ``m``-way model axis that divides their heads, under the ring
    accounting of ``partitioning.WorkerGroup``: each layer all-reduces
    its (streams, seq, d) ``out_proj`` partial of ``size`` bytes an
    element and the gated norm's (streams, seq) fp32 sums of squares."""
    layers = cfg.layer_pattern.count("S")
    if m == 1 or not layers or cfg.ssm_heads % m:
        return {}
    ar = layers * 2 * (m - 1) / m * streams * seq * (cfg.d_model * size
                                                      + 4)
    return {"model": {"all-reduce": ar, "total": ar}}


def moe_axis_bytes(cfg, tokens: int, b: int, w: int, m: int,
                   size: int = 4) -> dict:
    """Per-rank bytes by group and op of the MoE layers of one call whose
    rank runs ``tokens`` tokens, under the ring accounting of
    ``partitioning.WorkerGroup``: each MoE layer all-gathers its tokens'
    (tokens, k) int64 top-k routes over the batch group ("fsdp", ``b``
    ranks of "pod" and "data"), then the batch group's over "worker"
    (``w``), and on an ``m``-way model axis that splits the experts (or
    their hidden units) all-reduces its (tokens, d) output of ``size``
    bytes an element."""
    layers = cfg.layer_pattern.count("M")
    routes = tokens * cfg.experts_per_token * 8
    out = {}
    if b > 1:
        out["fsdp"] = {"all-gather": layers * (b - 1) * routes}
    if w > 1:
        out["worker"] = {"all-gather": layers * (w - 1) * b * routes}
    if m > 1:
        out["model"] = {"all-reduce": layers * 2 * (m - 1) / m * tokens
                        * cfg.d_model * size}
    for ops in out.values():
        ops["total"] = sum(ops.values())
    return out


def add_bytes(*counts) -> dict:
    """Bytes by group and op summed over ``counts`` (each {group: {op:
    bytes, "total": ...}}), totals recounted."""
    out: dict = {}
    for count in counts:
        for group, ops in count.items():
            mine = out.setdefault(group, {})
            for op, b in ops.items():
                if op != "total":
                    mine[op] = mine.get(op, 0.0) + b
    for ops in out.values():
        ops["total"] = sum(ops.values())
    return out


@contextlib.contextmanager
def route_log(log: list):
    """Record every MoE layer call on the host, in order: (the router's
    fp32 logits of this rank's tokens, the whole batch's top-k routes
    after the routing gather, the index of this rank's first token in
    it)."""
    from repro_torch.models import moe
    real_probs, real_routes = moe.router_probs, moe.whole_routes
    seen = []

    def probs(cfg, p, x):
        seen.append(moe.router_logits(p, x).float().cpu())
        return real_probs(cfg, p, x)

    def routes(top_i):
        whole, start = real_routes(top_i)
        log.append((seen.pop(), whole.cpu(), start))
        return whole, start

    moe.router_probs, moe.whole_routes = probs, routes
    try:
        yield
    finally:
        moe.router_probs, moe.whole_routes = real_probs, real_routes


@contextlib.contextmanager
def last_pool_caches(kept: dict):
    """After every call of a ``ContinuousLLMExecutor``, keep its first
    run's last layer of caches on the host: ``kept["caches"]``, one run's
    {name: (1, streams, ...) fp32} in a list, the layout
    ``shardings.cache_shardings`` reads (the whole pool's state at full
    depth would be gigabytes)."""
    from repro_torch.serving.continuous import ContinuousLLMExecutor
    real = ContinuousLLMExecutor._to_host

    def to_host(self, kind, t0, toks, state, *args):
        kept["caches"] = [{name: leaf[-1:].float().cpu()
                           for name, leaf in state.caches[0].items()}]
        return real(self, kind, t0, toks, state, *args)

    ContinuousLLMExecutor._to_host = to_host
    try:
        yield
    finally:
        ContinuousLLMExecutor._to_host = real


def mesh_route_walk(where: str, got: list, want: list, k: int,
                    layers: int) -> int:
    """Hold a mesh rank's MoE layer calls (``route_log``) against the
    same calls with no mesh, in order: the rank's router logits within
    1e-4 x max(1, max |plain|) of its rows of the plain ones, and the
    whole batch's routes equal to the plain routes wherever the plain
    top-k margin (the k-th minus the (k+1)-th logit) is wider than twice
    that.  A route that differs inside the margin is printed and ends the
    walk (routing is discrete: its token's output, and every later input,
    may differ from there on).  Returns the model calls (``layers`` MoE
    calls each) whose routes were all equal."""
    import torch
    if len(got) != len(want):
        raise AssertionError(f"{where}: {len(got)} MoE layer calls, no mesh "
                             f"{len(want)}")
    least = math.inf
    for i, ((lg, rg, start), (lw, rw, _)) in enumerate(zip(got, want)):
        rows = lw[start:start + lg.shape[0]]
        tol = 1e-4 * max(1.0, lw.abs().max().item())
        err = (lg - rows).abs().max().item()
        if not err <= tol:
            raise AssertionError(f"{where}: MoE call {i}: router logits "
                                 f"differ by {err} > {tol}")
        top = lw.sort(-1, descending=True).values
        margin = top[:, k - 1] - top[:, k]
        least = min(least, margin.min().item())
        if rg.shape != rw.shape:
            raise AssertionError(f"{where}: MoE call {i}: routes "
                                 f"{tuple(rg.shape)} != {tuple(rw.shape)}")
        differ = (rg.sort(-1).values != rw.sort(-1).values).any(-1)
        if differ.any():
            near = margin[differ]
            emit({"disputed_route": where, "moe_call": i,
                  "tokens": int(differ.sum()), "tol": tol,
                  "margins": near.tolist()[:16],
                  "explained": bool((near <= 2 * tol).all())})
            if not (near <= 2 * tol).all():
                raise AssertionError(f"{where}: MoE call {i}: a route "
                                     "differs off a near tie")
            return i // layers
    emit({"routes": where, "moe_calls": len(got), "least_topk_margin": least,
          "equal": True})
    return len(got) // layers


def train_axis_bytes(cfg, d: int, m: int, rows: int, seq: int, size: int,
                     remat: bool, microbatches: int = 1,
                     batch_bytes: int = 0, masked: bool = False) -> dict:
    """Per-rank bytes of one training step of a decoder of "A", "M", "S"
    and shared "G" layers on a (data ``d``, model ``m``) mesh that
    divides its kv-heads and its SSM heads, parameters and activations
    of ``size`` bytes, under the ring accounting of
    ``partitioning.WorkerGroup``, by group.  "fsdp": each weight's
    model-local whole B gathered (B (d-1)/d), its gradient
    reduce-scattered (B / d (d-1): the same), every leaf the batch axes
    leave whole (the norms, a Mamba2 layer's conv, gate norm and fp32
    per-head vectors) all-reduced (2 B (d-1)/d), and the loss with 4
    metrics (fp32); each MoE layer's routing gather of its (tokens, k)
    int64 routes.  The shared "G" block's weights count once.  "model",
    a step's (rows / d) x seq tokens: the embedding's all-reduce, two an
    attention layer or "G" position (attention and MLP or MoE out), the
    logits' all-gather; in the backward two an attention layer (x into
    the heads and into the MLP or the experts), each MoE layer's
    (tokens, E) fp32 combine weights, q_norm's and k_norm's gradients a
    layer, and x into the vocabulary's product; a Mamba2 layer
    all-reduces its ``out_proj`` partial and its gated norm's (tokens,)
    fp32 sums of squares, and in the backward x into its heads, B and C
    (tokens, 2N), the sums of squares' gradient and its three (H,) fp32
    per-head vectors; under remat one more an attention layer, the
    attention's, as the block's forward is recomputed: torch's
    checkpoint stops recomputing once it has the tensors the backward
    saved, before the MLP's closing all-reduce.  "world": the squared
    gradient norm (fp32).  With ``microbatches`` > 1 "fsdp" also
    gathers the whole batch of ``batch_bytes`` once a step ((d-1)/d of
    them), so that each rank holds its block of every microbatch of the
    whole batch (``train._reference_micro_rows``); every other count is
    linear in the tokens and the same over any number of microbatches.
    A ``masked`` batch's loss all-reduces each microbatch's mask sum
    (fp32) over "fsdp"."""
    dm, h, kv, hd, ff = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                         cfg.head_dim, cfg.d_ff)
    pattern, vocab = cfg.layer_pattern, cfg.vocab_size
    attn = sum(pattern.count(c) for c in "AMG")
    moe, ssm = pattern.count("M"), pattern.count("S")
    # attention and dense MLP weight sets: the "G" positions share one
    sets = pattern.count("A") + moe + ("G" in pattern)
    dense = pattern.count("A") + ("G" in pattern)
    if (attn and kv % m) or set(pattern) - set("AMSG") or \
            (remat and (moe or ssm)) or (ssm and cfg.ssm_heads % m):
        raise ValueError("train_axis_bytes counts decoders whose kv-heads "
                         "and SSM heads the model axis divides (the MoE "
                         "and Mamba2 layers without remat)")
    e, f = cfg.num_experts, cfg.moe_d_ff
    din, n, hs = cfg.ssm_d_inner // m, cfg.ssm_state, cfg.ssm_heads
    # each weight's model-local whole: the router is whole on the axis,
    # B and C's in_proj columns too
    split = (vocab * dm * (1 if cfg.tie_embeddings else 2)
             + sets * (2 * dm * h * hd + 2 * dm * kv * hd)
             + dense * 3 * dm * ff + moe * 3 * e * dm * f) / m \
        + moe * dm * e + ssm * (dm * (2 * din + 2 * n + hs // m) + din * dm)
    norms = sets * (2 * dm + (2 * hd if cfg.qk_norm else 0)) + dm \
        + ssm * (dm + (cfg.ssm_conv + 1) * (din + 2 * n) + din)
    tokens = rows // d * seq
    out = {}
    if d > 1:
        out["fsdp"] = 2 * (d - 1) / d * ((split + norms) * size
                                         + (ssm * 3 * hs + 5) * 4) \
            + moe * (d - 1) * tokens * cfg.experts_per_token * 8
        if microbatches > 1:
            out["fsdp"] += (d - 1) / d * batch_bytes
        if masked:
            out["fsdp"] += microbatches * 2 * 4 * (d - 1) / d
    if m > 1:
        frac = (m - 1) / m
        act = tokens * dm * size
        ar = act * (2 + 4 * attn + 2 * ssm + (attn if remat else 0)) \
            + moe * tokens * e * 4 \
            + ssm * (tokens * 2 * n * size + 2 * tokens * 4 + 3 * hs * 4)
        if cfg.qk_norm:
            ar += 2 * attn * hd * size
        out["model"] = 2 * frac * ar + frac * tokens * vocab * size
    if d * m > 1:
        out["world"] = 2 * 4 * (d * m - 1) / (d * m)
    return out


def hold_train_blocks(where: str, params0, params1, mu1, specs, mesh, ref,
                      tcfg) -> dict:
    """This rank's blocks after a training step against one rank's whole
    leaves (``ref``: "params", "mu", "gmax" by key): the gradient (the
    first moment over 1 - b1) within 1e-4 x the leaf's max |grad|; the
    parameters under Adam's first-step rule, within 1e-5 |p| + 0.02 lr
    where one rank's gradient clears 100 x that tolerance, else within 2 lr
    (1 + wd |p|) (``params0``: this rank's blocks before the step).  Only
    the leaves in ``ref["mu"]``, and the parameters only where ``ref``
    has "params".  Returns the worst shares of the tolerances."""
    import torch
    from repro_torch.launch.shardings import local_shard
    from repro_torch.models.partitioning import spec_leaves
    from repro_torch.optim import learning_rate
    from repro_torch.tree import flatten_with_path, keystr, leaves
    opt = tcfg.optimizer
    lr = float(learning_rate(opt, torch.ones((), dtype=torch.int32)))
    worst_g = worst_p = 0.0
    strong = total = 0
    for (path, p1), p0, mu, spec in zip(
            flatten_with_path(params1), leaves(params0), leaves(mu1),
            spec_leaves(specs, params1)):
        key = keystr(path)
        if key not in ref["mu"]:
            continue
        dev = p1.device
        g_ref = local_shard(ref["mu"][key], spec, mesh).to(dev) / (1 - opt.b1)
        tol = 1e-4 * max(ref["gmax"][key], 1e-30)
        worst_g = max(worst_g, ((mu / (1 - opt.b1) - g_ref).abs().max()
                                / tol).item())
        if "params" not in ref:
            continue
        want_p = local_shard(ref["params"][key], spec, mesh).to(dev)
        diff = (p1 - want_p).abs()
        if not (diff <= 2 * lr * (1 + opt.weight_decay * p0.abs())
                + 1e-6).all():
            raise AssertionError(f"{where} {key}: an updated parameter past "
                                 f"2 lr (1 + wd |p|)")
        sure = g_ref.abs() > 100 * tol
        if sure.any():
            strict = 1e-5 * want_p.abs() + 0.02 * lr
            worst_p = max(worst_p, (diff[sure] / strict[sure]).max().item())
        strong += int(sure.sum())
        total += sure.numel()
    if not (worst_g <= 1.0 and worst_p <= 1.0):
        raise AssertionError(f"{where}: gradients at {worst_g} and strict "
                             f"parameters at {worst_p} of their tolerances")
    return {"grads_err_over_tol": worst_g,
            "strict_params_err_over_tol": worst_p,
            "strict_share": strong / max(total, 1)}


def mesh_h2o_config(configs):
    return configs.get_config(D80_ARCH).with_updates(
        num_layers=2, param_dtype="float32", activation_dtype="float32")


def mesh_rounds(cfg, params, inputs: dict, pool: bool = False,
                max_len: int = MESH_PROMPT + MESH_STEPS + 2,
                caches: bool = False, coding_args=(K, S, E),
                worker_major: bool = False) -> dict:
    """The batch E=1 round over a ``max_len`` ring at ``coding_args``
    (K, S, E): ``coded_prefill`` of ``inputs``' prompt ("tokens", or a
    frontend's "patches" and "tokens" or "frames") and a
    ``coded_decode_step`` on each of its fixed next tokens ("steps"),
    group-major or with ``worker_major`` worker-major (gather width N+1);
    with ``pool`` also the slot pool's worker-major prefill (every slot
    admitted) and a decode round on each of the same tokens, and both
    runs' caches (with ``caches``,
    the batch round's).  On the active mesh, if any.  Returns each call's
    (logits, located) on the host, each run's launches, and on a mesh
    each call's collective bytes by axis and op and its wall time (ms,
    ending in a sync)."""
    import torch
    from repro_torch.core.berrut import CodingConfig
    from repro_torch.kernels import ops
    from repro_torch.launch.worker_mesh import WorkerShardConfig
    from repro_torch.models import partitioning
    from repro_torch.serving import coded_serving as cs
    coding = CodingConfig(*coding_args)
    mesh = partitioning.active_mesh()
    dev = inputs["mask"].device
    ws = WorkerShardConfig(gather_width=coding.num_workers)
    kw = dict(straggler_mask=inputs["mask"], byz_mask=inputs["byz"],
              byz_noise=inputs["noise"], byz_sigma=10.0, with_report=True)
    bkw = dict(kw, wshard=ws if worker_major else None)
    out = {}
    prompt = {key: inputs[key] for key in ("tokens", "patches", "frames")
              if key in inputs}

    def run(kind, first, step):
        calls, nbytes, ms = [], [], []
        ops.reset_launch_counts()
        if mesh is not None:
            mesh.reset_bytes()
        state = None
        for i in range(1 + len(inputs["steps"])):
            t0 = time.perf_counter()
            logits, state, rep = (first() if i == 0 else
                                  step(state, inputs["steps"][i - 1]))
            calls.append((logits.float().cpu(), rep[0].cpu()))
            ms.append((time.perf_counter() - t0) * 1e3)
            if mesh is not None:
                nbytes.append({axis: group.collective_bytes() for axis, group
                               in mesh.groups.items()})
                mesh.reset_bytes()
        out[kind] = calls
        out[kind + "_launches"] = ops.launch_counts()
        out[kind + "_bytes"], out[kind + "_ms"] = nbytes, ms
        out[kind + "_caches"] = [{name: leaf.float().cpu()
                                  for name, leaf in cache.items()}
                                 for cache in state.caches] \
            if pool or caches else None

    run("batch", lambda: cs.coded_prefill(
        cfg, coding, params, prompt, max_len, **bkw),
        lambda st, t: cs.coded_decode_step(cfg, coding, params, st, t,
                                           **bkw))
    if pool:
        groups = next(iter(prompt.values())).shape[0] // coding.k
        state = cs.init_pool_state(cfg, coding, groups, max_len, dev,
                                   wshard=ws)
        fresh = cs.init_caches(cfg, cs.pool_streams(coding, groups, ws),
                               max_len, getattr(torch, cfg.param_dtype), dev)
        ones = np.ones((groups,), np.float32)
        pkw = dict(kw, wshard=ws)
        run("pool", lambda: cs.coded_pool_prefill(
            cfg, coding, params, state, prompt, ones,
            fresh, **pkw), lambda st, t: cs.coded_pool_decode_step(
                cfg, coding, params, st, t, ones, **pkw))
    return out


def hold_calls(where: str, got: list, want: list) -> float:
    """Each call's (logits, located) against ``want``'s: logits within
    MESH_TOL (rtol, atol: the CPU tests' fp32 rule), greedy tokens equal
    but for near ties, verdicts equal.  Returns the worst share of the
    tolerance."""
    import torch
    worst = 0.0
    for i, ((lg, vg), (lw, vw)) in enumerate(zip(got, want)):
        worst = max(worst, logits_share(f"{where} call {i}", lg, lw))
        near_tie_rows(f"{where} call {i}", lg.argmax(-1).numpy()[None],
                      lw.argmax(-1).numpy()[None], [lw])
        if not torch.equal(vg, vw):
            raise AssertionError(f"{where} call {i}: verdicts differ")
    return worst


def bytes_equal(where: str, got: dict, want: dict) -> None:
    """A call's collective bytes by op equal to the analytic count (to a
    millionth: the counts are sums of floats)."""
    ops = sorted(op for op in set(got) | set(want)
                 if got.get(op, 0.0) or want.get(op, 0.0))
    for op in ops:
        if not math.isclose(got.get(op, 0.0), want.get(op, 0.0),
                            rel_tol=1e-6):
            raise AssertionError(f"{where}: {op} bytes {got.get(op)} != "
                                 f"{want.get(op)} (analytic)")


def logits_share(where: str, got, want) -> float:
    """The worst share of MESH_TOL (rtol, atol: the CPU tests' fp32 rule)
    by which ``got``'s logits miss ``want``'s; raises above 1."""
    if got.shape != want.shape:
        raise AssertionError(f"{where}: logits {tuple(got.shape)} != "
                             f"{tuple(want.shape)}")
    tol = MESH_TOL[1] + MESH_TOL[0] * want.abs()
    share = ((got - want).abs() / tol).max().item()
    if not share <= 1.0:
        raise AssertionError(f"{where}: logits {share} x their tolerance")
    return share


def near_tie_rows(where: str, got, want, logits: list) -> int:
    """Compare token rows call by call (``got``, ``want``: (calls,
    rows)) up to the first call where any differs; there every row that
    differs must be a near tie of ``logits[call]`` (its top two within
    the tolerance of each other), and nothing later is compared (the
    inputs differ from then on).  Returns the calls held equal."""
    for i, (g, w) in enumerate(zip(got, want)):
        rows = np.flatnonzero(np.asarray(g) != np.asarray(w))
        if not rows.size:
            continue
        for row in rows:
            top = logits[i][row].topk(2).values
            gap = (top[0] - top[1]).item()
            tol = 2 * (MESH_TOL[1] + MESH_TOL[0] * top[0].abs().item())
            if not gap <= tol:
                raise AssertionError(f"{where}: call {i} row {row} token "
                                     f"differs, top-2 gap {gap} > {tol}")
            emit({"near_tie": where, "call": i, "row": int(row),
                  "gap": gap})
        return i
    return len(got)


def mesh_child(rank: int, work: Path) -> int:
    """One rank of a ``Smoke.mesh_children`` job on cuda:0 over gloo."""
    import torch
    import torch.distributed as dist
    from repro_torch import configs
    from repro_torch.kernels import ops
    from repro_torch.launch import multihost, shardings
    from repro_torch.launch import worker_mesh as wm
    from repro_torch.launch.mesh import make_host_mesh, make_worker_mesh
    from repro_torch.models import partitioning
    from repro_torch.models.model import init_params
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    torch.empty(1, device=dev)           # the context, before the job
    while not (work / "job.json").exists():
        time.sleep(0.05)
    job = json.loads((work / "job.json").read_text())
    world, model = job["world"], job["model"]
    out = {}
    if job["kind"] == "train":
        out.update(mesh_train_child(rank, work, job, dev))
    elif job["kind"] == "multihost_train":
        ops.reset_launch_counts()
        get_config = configs.get_config
        configs.get_config = lambda arch: get_config(arch).with_updates(
            num_layers=MH_TRAIN_LAYERS)
        try:
            res = multihost.main(MH_TRAIN_ARGS + [
                "--coordinator", f"file://{work}/store", "--num-processes",
                str(world), "--process-id", str(rank), "--model-par",
                str(model)])
        finally:
            configs.get_config = get_config
        out.update(res, launches=ops.launch_counts())
    elif job["kind"] in ("multihost", "ring16", "multi_pod",
                         "moe_multihost", "ssm_multihost"):
        # each call's decoded logits, as the decode tail leaves them to
        # its sampling: (rows, V), or at W > 1 the worker's (rows, V / W)
        decoded = []
        real = wm._decode_rows
        get_config = configs.get_config

        def decode_rows(*args, **kw):
            dec = real(*args, **kw)
            decoded.append(dec.float().cpu())
            return dec

        argv = {"multihost": lambda: mesh_multihost_argv(
                    work / "store", world, rank, model, backend="gloo"),
                "ring16": lambda: mesh_multihost_argv(
                    work / "store", world, rank, model, backend="gloo",
                    s=MH_S, steps=MP16_STEPS, slots=MP16_SLOTS),
                "multi_pod": lambda: mesh_multihost_argv(
                    work / "store", world, rank, model, backend="gloo",
                    s=MH_S, steps=BA_STEPS) + ["--multi-pod"],
                "moe_multihost": lambda: mesh_multihost_argv(
                    work / "store", world, rank, model, backend="gloo",
                    s=MH_S, steps=BA_STEPS) + ["--arch", QWEN3_MOE],
                "ssm_multihost": lambda: mesh_multihost_argv(
                    work / "store", world, rank, model, backend="gloo",
                    s=MH_S, steps=BA_STEPS) + ["--arch", job["arch"]]
                }[job["kind"]]()
        ops.reset_launch_counts()
        wm._decode_rows = decode_rows
        if job.get("layers"):            # the launcher's model, cut in depth
            configs.get_config = lambda arch: get_config(arch).with_updates(
                num_layers=job["layers"])
        routes, kept = [], {}
        try:
            with route_log(routes), (
                    last_pool_caches(kept) if job["kind"] == "ssm_multihost"
                    else contextlib.nullcontext()):
                res = multihost.main(argv)
        finally:
            wm._decode_rows = real
            configs.get_config = get_config
        out.update(tokens=res["tokens"], pool_logits=decoded,
                   call_ms=res["call_ms"],
                   call_bytes=res["call_bytes"],
                   launches=ops.launch_counts(), routes=routes,
                   caches=kept.get("caches"))
        torch.cuda.empty_cache()         # the whole weights, now freed
    if job["kind"] == "h2o":
        cfg = mesh_h2o_config(configs)
    else:
        cfg = configs.get_config(job.get("arch", "qwen3-0.6b")).with_updates(
            param_dtype="float32", activation_dtype="float32")
        if job.get("layers"):
            cfg = cfg.with_updates(num_layers=job["layers"])
    if job.get("batch") or job["kind"] == "h2o":
        inputs = {k: v.to(dev) for k, v in torch.load(job["inputs"]).items()}
        dist.init_process_group("gloo", init_method=f"file://{work}/store2",
                                world_size=world, rank=rank)
        try:
            mesh = (make_worker_mesh(job["workers"], model, multi_pod=True)
                    if job.get("multi_pod") else
                    make_host_mesh(data=job.get("data", 1), model=model))
            # each rank builds the whole tree, then keeps its blocks; with
            # ``in_turns`` the ranks do so one after another, so that the
            # card holds one whole tree at a time
            for turn in range(world if job.get("in_turns") else 1):
                if turn == rank or not job.get("in_turns"):
                    params = init_params(cfg, torch.Generator(dev)
                                         .manual_seed(MESH_SEED), dev)
                    params = shardings.local_shard(
                        params, shardings.serving_param_specs(mesh, cfg,
                                                              params), mesh)
                    torch.cuda.empty_cache()
                if job.get("in_turns"):
                    dist.barrier()
            routes = []
            with partitioning.mesh_context(mesh), route_log(routes):
                out["routes"] = routes
                out.update(mesh_rounds(
                    cfg, params, inputs,
                    pool=job["kind"] == "h2o" or job.get("pool", False),
                    max_len=job.get("max_len", MESH_PROMPT + MESH_STEPS + 2),
                    caches=job["kind"] == "ring16" or job.get("caches",
                                                              False),
                    coding_args=tuple(job.get("coding", (K, S, E))),
                    worker_major=job.get("worker_major", False)))
        finally:
            dist.destroy_process_group()
    out["max_reserved"] = torch.cuda.max_memory_reserved(dev)
    out["max_allocated"] = torch.cuda.max_memory_allocated(dev)
    torch.save(out, work / f"rank{rank}.pt")
    return 0


def mesh_train_child(rank: int, work: Path, job: dict, dev) -> dict:
    """One rank of phases 28, 32 and 35: ``launch.train.run`` of the job's
    arch (TRAIN_ARCH by default; ``layers`` cuts its depth, to the job's
    ``pattern`` where it has one) on the job's
    (data, model) mesh over gloo, TRAIN_MESH_STEPS
    steps; each step's collective bytes by group and metrics, and after
    the first this rank's blocks held to one rank's
    (``hold_train_blocks``).  Returns the history, the launches, the
    bytes, the metrics and the holding's worst shares."""
    import torch
    import torch.distributed as dist
    from repro_torch import configs
    from repro_torch.kernels import ops
    from repro_torch.launch import train as launch_train
    from repro_torch.models import partitioning
    ref = torch.load(job["ref"], mmap=True, weights_only=True)
    step = launch_train.train_step
    get_config = configs.get_config
    out = {"step_bytes": [], "metrics": []}

    def hold(cfg, tcfg, params, opt, batch, specs=None):
        mesh = partitioning.active_mesh()
        mesh.reset_bytes()
        new = step(cfg, tcfg, params, opt, batch, specs)
        out["step_bytes"].append(mesh.axis_bytes())
        out["metrics"].append({k: float(v) for k, v in new[2].items()})
        if "held" not in out:
            out["held"] = hold_train_blocks(
                f"training rank {rank}", params, new[0], new[1].mu, specs,
                mesh, ref, tcfg)
        return new

    dist.init_process_group("gloo", init_method=f"file://{work}/store",
                            world_size=job["world"], rank=rank)
    history = []
    try:
        ops.reset_launch_counts()
        launch_train.train_step = hold
        if job.get("layers"):            # the launcher's model, cut
            configs.get_config = lambda arch: get_config(arch).with_updates(
                num_layers=job["layers"], layer_pattern=job.get("pattern"))
        try:
            launch_train.run(job.get("arch", TRAIN_ARCH), False,
                             TRAIN_MESH_STEPS, TRAIN_BATCH, TRAIN_SEQ,
                             job["data"], job["model"], TRAIN_LR,
                             job.get("micro", 1), None,
                             log_every=TRAIN_MESH_STEPS, device=dev, seed=0,
                             history=history)
        finally:
            launch_train.train_step = step
            configs.get_config = get_config
        out.update(history=history, launches=ops.launch_counts())
        if job.get("masked"):
            out["masked"] = masked_train_child(rank, job, dev)
    finally:
        dist.destroy_process_group()
    return out


def a96_train_config():
    """Phase 36 (b)'s step: the launcher's optimizer settings for one step
    (``Smoke.train_config``) with A96_MICRO microbatches."""
    from repro_torch.optim import OptimizerConfig
    from repro_torch.training import TrainConfig
    return TrainConfig(optimizer=OptimizerConfig(
        learning_rate=TRAIN_LR, warmup_steps=20, total_steps=1),
        microbatches=A96_MICRO)


def masked_train_child(rank: int, job: dict, dev) -> dict:
    """Phase 36 (b) on one rank: one ``train_step`` with A96_MICRO
    microbatches on this rank's rows of the masked batch
    (``job["masked"]``), from the launcher's seed-0 parameters sharded on
    a new (data, model) mesh; the step's bytes by group, launches and
    metrics, and this rank's blocks held to one rank's
    (``job["masked_ref"]``, ``hold_train_blocks``)."""
    import torch
    from repro_torch import configs
    from repro_torch.kernels import ops
    from repro_torch.launch import train as launch_train
    from repro_torch.launch.mesh import make_train_mesh
    from repro_torch.models import partitioning
    from repro_torch.models.model import init_params
    host = torch.load(job["masked"], weights_only=True)
    ref = torch.load(job["masked_ref"], mmap=True, weights_only=True)
    cfg = configs.get_config(job["arch"]).with_updates(
        num_layers=job["layers"])
    tcfg = a96_train_config()
    mesh = make_train_mesh(job["data"], job["model"])
    with partitioning.mesh_context(mesh):
        params = init_params(cfg, torch.Generator(dev).manual_seed(0), dev)
        params, opt, specs = launch_train.sharded_state(cfg, params, mesh)
        torch.cuda.empty_cache()
        n = TRAIN_BATCH // mesh.fsdp_size()
        lo = mesh.fsdp_index() * n
        batch = {k: v[lo:lo + n].to(dev) for k, v in host.items()}
        ops.reset_launch_counts()
        mesh.reset_bytes()
        new = launch_train.train_step(cfg, tcfg, params, opt, batch, specs)
        out = {"bytes": mesh.axis_bytes(), "launches": ops.launch_counts(),
               "metrics": {k: float(v) for k, v in new[2].items()}}
        out["held"] = hold_train_blocks(
            f"masked step rank {rank}", params, new[0], new[1].mu, specs,
            mesh, ref, tcfg)
    return out


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


def b3_bwd_staged(b: int, s: int, l: int, h: int, kv: int, d: int,
                  size: int, rows: int, tile: int) -> dict:
    """Bytes the blocks of B3's backward main launch copy into shared
    memory under the causal rule (no window, prefix or offset), walked as
    the kernel walks: each block's own ``rows`` rows of two operands once
    (and, for a dq block, their lse and Delta), then its streamed tiles of
    ``tile`` rows of two operands (and, for a dk/dv block, their lse and
    Delta).  {"dkv": ..., "dq": ...}."""
    row = d * size
    dkv = dq = 0
    for k0 in range(0, l, rows):
        first_tile = min(k0, s) // tile
        n_t = -(-s // tile) - first_tile if s > k0 else 0
        dkv += 2 * rows * row + (h // kv) * n_t * (2 * tile * row
                                                   + 2 * tile * 4)
    for r0 in range(0, s, rows):
        seen = min(r0 + rows, s)
        dq += 2 * rows * row + 2 * rows * 4 \
            + min(-(-l // tile), -(-seen // tile)) * 2 * tile * row
    return {"dkv": dkv * b * kv, "dq": dq * b * h}


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


def train_launches(cfg, steps: int, remat: bool,
                   microbatches: int = 1) -> dict:
    """The launches of ``steps`` training steps of ``cfg``: B3 and its
    backward in every attention layer ("A", "M", "G"), B7's two forward
    launches and its two backward launches in every "S" layer; each
    forward twice under remat (the block is recomputed), each backward
    once (B3's backward is two launches: Delta, then dq, dk and dv); all
    of it once a microbatch."""
    attn = sum(cfg.layer_pattern.count(c) for c in "AMG")
    ssm = cfg.layer_pattern.count("S")
    steps *= microbatches
    fwd = steps * (2 if remat else 1)
    return {"flash_attention": attn * fwd,
            "flash_attention_bwd": attn * steps,
            "flash_attention_bwd_delta": attn * steps,
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
