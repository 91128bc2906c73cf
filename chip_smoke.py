"""Smoke run of the PyTorch/CUDA port (``paddle_tpu_torch``) on one card.

    python3 chip_smoke.py

Needs one CUDA card (an H100: the kernels are built for sm_90a) and nvcc;
exits non-zero without them.  Phases, each raising on failure:

1. device: the card's name and power limit, torch and CUDA versions;
2. build: every kernel under ``paddle_tpu_torch/ops/csrc/`` compiled with
   nvcc from the checkout, with the build seconds and ptxas's report (a
   wgmma kernel, or the f32 forward or backward at d 64 or 128, that
   spills fails);
3. parity: each kernel against its plain PyTorch version on the card, in
   f32 and bf16, at Llama-2-7B serving shapes and at the GQA attention of
   Llama-2-70B, with the kernel's, plain version's and library call's times
   and the least time the card could take for the same bytes and operations;
   the flash forward (B3) also at the training shapes (Llama-2-7B and
   GPT-3 1.3B at 4 x 2048), the ring's and the CP prefill's hop shapes
   (4096 and 1008 rows, causal and not), sq < sk, head_dim 64 and pads over
   whole 64-row tiles (exact zeros, lse -inf), each case launched twice with
   bit-equal out and lse, and timed beside SDPA at those shapes and over
   16384 tokens (``flash_fwd_times``); the decode kernel (B6) also by
   device time at ``generate_batch``'s shape;
4. end to end: Llama-2-7B at full width and depth, bf16 weights from a
   seeded generator, through ``Predictor.generate_batch`` on ragged prompts
   and ``generate`` on an unpadded batch; launch counts are reset before
   and read after each path and must match the kernels' share of the path;
   prefill and first-step logits agree with the same model run with the
   four kernel flags off (at full width and 2 layers within 2e-2; at full
   depth, no further from an f32 reference than the plain bf16 path is);
   tokens/s of prefill and decode; device time by kernel and the device's
   idle share from ``torch.profiler``; then, on the same model, the
   ``ServingEngine`` with bf16, int8 and fp8 KV pages in lockstep on 8
   ragged prompts (the gates are in ``phase_engine``), and B8/B9 run on
   the engines' own int8/fp8 pages; then the context-parallel prefill
   (``ServingEngine(cp=2)`` and ``cp=4``, bf16, int8 and fp8 pages) on one
   prompt of 4000 tokens against the chunked engine: at 2 layers the
   first-token logits within 2e-2, exact launches and no page outside the
   prompt's table written; at full depth exact launches, the logits'
   distance, both engines' tokens and the two prefill times
   (``phase_engine_cp``); then the engine's prefix cache, host-RAM offload
   tier and journal (``phase_engine_a1``): 8 prompts sharing a 496-token
   system prompt (7 hits, token-exact against an engine without a cache,
   TTFT of a miss and of a hit), 8 rows of 512-token prompts outgrowing
   their pages (at least two swap-outs and recalls, no stall or eviction,
   token-exact, the first victim's pages bit-equal after its recall; a
   tier too small for a victim stalls and stays token-exact; swap ms
   beside a plain pinned copy), and a crash after 10 steps recovered from
   the journal (every request replayed, token-exact, every sink token
   once); int8 and fp8 pages and ``cp=2`` with the cache at 2 layers;
   then generation's remainder (``phase_generation_a2``): beam search (4
   beams, 32 new tokens, eos 2) on 2 unpadded and 2 left-padded rows of
   512, K = 1 token-exact against greedy ``generate``, every returned
   score within 1e-3 of a teacher-forced rescoring of its ids, exact B3 and
   B6 launches, its time beside greedy ``generate`` on the same 8 rows and
   one cache reorder's device time; ``speculative_generate`` (prompt 512,
   64 new tokens, k 4) with the n-gram, 4-layer shallow-exit and oracle
   drafters, token-exact against ``generate`` at full depth in f32
   weights with the oracle accepting everything, and at 2 layers in bf16
   token-exact or parted only at a near-tie (the logits that chose the
   parting token on each path within 2e-2 of each other), exact launches
   (the drafter's B6 counted), tokens/s, acceptance and the verify
   forward's ms beside a serial step's; ``ServingEngine(speculative=4)``
   on ``phase_engine``'s 8 prompts with the n-gram and oracle drafters,
   held against the serial engine as the standalone loop is, every decode
   forward [8, 5], no leaked page; and ``nn.dynamic_decode`` of a
   ``BeamSearchDecoder`` over a ``GRUCell`` on the card against the same
   run on the CPU;
3b. quantized decode parity (run after 3): B8 (int8 cache) and B9 (e4m3
   cache) against their plain twins, q in f32 and bf16, at Llama-2-7B's
   4096 context (batch 8, pos 4000), Llama-2-70B's GQA and off sizes, the
   appended rows and scales bit-equal; their entry points' own decode
   loop, counted; times beside B6 on a bf16 cache of the same shape;
5. backward parity (run after 3): each backward kernel (RMSNorm, RoPE by
   -theta, flash dq and dk/dv) against its plain backward, in f32 and
   bf16, at the training shapes (x [8192, 4096]; q, k [4, 2048, 32, 128]
   and GPT-3 1.3B's [4, 2048, 16, 128]), at Llama-2-70B's GQA attention,
   at the ring's hop shapes ([1, 4096, 32, 128], causal and not) and at
   off-size attention shapes (d 64, 72, 160, 200, 256; at 256 also sq <
   sk and s 65), each flash case launched twice with bit-equal grads;
   timed as in 3 (the library call is the backward of ``F.rms_norm`` and
   of SDPA), flash dq and dk/dv also at GPT-3 1.3B's and the hop shapes; RMSNorm's also at off sizes (odd h,
   1 and 3 rows, rows of several segments), launched twice bit-equal;
5b. ring parity (run after 5): B10, the ring of context parallelism, with
   its members on the one card: the kernel ring (B3 and the merge kernel a
   hop forward, B3b/B3c backward) against the same ring over the plain
   twins and against one B3 (B3b/B3c) call over the whole sequence, in f32
   and bf16, causal and not, forward and the three grads, at Llama-2-7B's
   attention width over 16384 tokens (cp 4), Llama-2-70B's GQA over 8192
   (cp 2) and a batch of 2 (cp 2); each ring's launches exact; times of the
   ring forward and backward beside SDPA over the whole sequence, and of
   one merge;
6. fused parity (run after 5): B4 (SwiGLU fwd and bwd), B5 (AdamW) and
   B11/B11b (residual add + LayerNorm fwd and bwd) against their plain
   twins, in f32 and bf16, at the training shapes (Llama-2-7B's MLP and
   GPT-3 1.3B's hidden at 4 x 2048, bf16 x with f32 LayerNorm weights as
   AMP O2 gives them, B5 over the 8-layer Llama's parameters) and at off
   sizes (B11b also at 1 and 3 rows, rows of several segments and h 40000,
   launched twice bit-equal), timed as in 3 (the library call of B5 is
   ``torch._fused_adamw_``, of B11b ``native_layer_norm_backward``); then
   B1b's and B11b's device time a call by kernel from ``torch.profiler``
   beside their library calls' (``norm_bwd_times``);
7. Llama training (after 4, with the serving model freed): Llama-2-7B
   width, AMP O2 bf16, ``AdamW(1e-4)`` with ``ClipGradByGlobalNorm(1.0)``,
   ``use_fused_swiglu`` and ``use_fused_adamw`` on; at 2 layers the
   kernels' loss and grads agree with the plain path's (2e-2, unless the
   plain grad is the farther from an f32 reference); at 8 layers every
   kernel grad is no further from the f32 reference than 1.2x the plain
   bf16 grad; then ``TrainStep`` at 8 layers on one 4 x 2048 batch, 3
   warm-up and 10 counted steps: finite, falling losses, each kernel
   launched as often as the path needs, tokens/s, MFU, peak memory and a
   profile of one step; then the same steps with the two fused flags off;
8. GPT training: GPT-3 1.3B at full width and depth, as 7 with
   ``use_fused_layernorm`` and ``use_fused_adamw`` on (then off), the
   gates at 2 and 24 layers;
9. GPT generate: greedy ``generate`` on GPT-3 1.3B bf16, batch 8, prompt
   128, 8 new tokens, with its flash and decode launches counted;
10. the distributed process layer (``phase_dist``, after 9 with the card's
   cache emptied): ``python -m paddle_tpu_torch.distributed.launch
   --nproc_per_node 1`` runs a worker that takes NCCL at world size 1,
   runs every collective and P2P call on CUDA tensors under an armed
   ``CommWatchdog`` (which must not fire), and takes 3 ``TrainStep``s of
   7's Llama through ``DataParallel``: its launches a step equal 7's and
   its losses are within 2e-2 of 7's first three; then the bucket sync
   (one NCCL AVG all_reduce a 25 MB bucket) timed on those gradients and
   bit-equal after; a failed worker fails the phase with its log's tail on
   stderr.  Then the single-controller collectives on a ``dp=4`` mesh
   whose members share the card, on a 25 MB bf16 bucket a member, equal
   to the same calls on a CPU mesh, timed;
11. the model axis (``phase_tp``, after 10): (c) the mesh wrappers at
   Llama-2-7B's training attention [4, 2048, 32, 128] bf16, every member
   on the card, each bit-equal to one kernel call with exact launches
   (flash over model 2 and its three grads, Ulysses over model 2 x sep 2,
   RMSNorm over data 2 x sep 2 and its dx, rope over data 2 x sep 2 x
   model 2); (b) a 7B-width decoder layer of ``mp_layers`` with a
   column-parallel LM head and ``ParallelCrossEntropy``, tp 2, [1, 2048]
   tokens, sequence parallelism off and on, loss and grads within 2e-2 of
   the unsharded layer with ``F.cross_entropy``, SP on bit-equal to off,
   exact B1, B1b, B2, B2 bwd, B3, B3b, B3c, B4 launches; (a)
   ``ServingEngine(tp=2)`` on Llama-2-7B with ``phase_engine``'s prompts
   against ``tp=1``: in f32 weights at 32 layers token-exact on f32 pages
   and at 8 layers exact or certified near-ties on int8 and fp8 pages, in bf16 at 2
   layers logits within 2e-2 and exact or certified near-ties, exact B1
   and B2 launches on every run; then at full depth in bf16, beside
   ``tp=1``: the 512-token prefill, the decode step, pool bytes a token in
   all and a member, and peak memory;
12. the schedules (``phase_hybrid``, after 11): (a) ``fleet.init`` at dp 1
   x mp 2 x pp 2 x sharding 2 (8 members on the card) with amp O2 and the
   sharding stage in the strategy, ``LlamaForCausalLMHybrid`` at
   Llama-2-7B width through ``distributed_model``/``distributed_optimizer``
   and ``DistributedTrainStep`` at stages 1, 2 and 3: at 2 layers its loss
   and every grad within 2e-2 relative L2 of the plain model's with the
   same weights (through ``convert.py``); at 8 layers on 7's batch the
   first 3 losses within 2e-2 of 7's, exact launches a step
   (``hybrid_want``), step ms, tokens/s, MFU and peak memory; (b)
   ``OneFOneBLayers`` at pp 2, v 1 and 2, M 4, on 4 decoder layers at 7B
   width, recompute on and off, against the layers run in turn (f32 1e-5,
   bf16 2e-2), segments run against GPipe's, ms and peak memory, and
   ``PipelineParallel.train_batch`` against ``OneFOneBLayers.train_batch``;
   (c) the collective-matmul ring at mp 2 and 4 on [8192, 4096] x [4096,
   11008] and the row form against the fused form, f32 and bf16, timed.
   10's worker also runs ``fleet.init`` + ``DistributedTrainStep`` at ZeRO
   stage 2 over its process mesh (world size 1), losses and launches equal
   to 7's;
13. ZeRO offload (``phase_offload``, after 12): the host link from pinned
   memory (to the card, to the host, both at once); B5's host route over
   the 8-layer step's 75 tensors, f32 p, m and v in a pinned
   ``HostArena`` and the bf16 weight written on the card, bit-equal to B5
   on device states, within the f32 row of the plain twin, pageable
   states and a CPU gradient refused, timed beside the plain version
   across the link and the bound over the link; (a) fleet on the one card
   (stage 1, every degree 1) at 8 layers on 7's batch and
   ``DistributedTrainStep`` at stages 1-3 on 12's 8 members (2 layers),
   each with offload against resident states: losses, launches and final
   weights bit-equal, step ms, B5's device ms a step, peak, pinned bytes
   and seconds; (b) Llama-2-7B at full depth and width (32 layers, 4 x
   2048, 75.3 GiB pinned) with offload: finite, falling losses, 291 B5
   launches a step, step ms, peak, the host's memory;
14. ``auto_parallel`` (``phase_auto``): fleet at mp 2 x sharding 2 (4
   members on the card), ``shard_layer`` placing the projections as
   mp_layers does, ``shard_optimizer`` and ``Engine.fit`` over 7's batch
   (losses within 2e-2 of 7's, exact launches, each projection's spec in
   the step), ``evaluate`` and ``predict``; the Partial identities on the
   card bit-exact.
15. the training step's remainder: a ``telemetry.StepMeter`` wraps 7's
   and 8's counted steps (its MFU within 1% of the script's, the chip
   table's H100 row, its memory peak equal to ``max_memory_allocated``,
   its JSONL read back); ``phase_fused_ce`` (after 7): 7's 8-layer model
   with ``fused_ce_chunk=1024`` against 0 from the same weights (loss and
   grads within 2e-2, the steps' losses and launches, ms a step and peak
   memory of both) and ``F.fused_linear_cross_entropy`` alone against
   ``F.cross_entropy`` on the full logits at [8192, 4096] x [4096, 32000];
16. the ``nn.Layer`` tree (``phase_ernie``, after 9): ERNIE 3.0 base at
   its published width (12 layers, hidden 768, vocab 40000), eval, 16 x
   512 tokens, ``ErnieForSequenceClassification`` and ``ErnieForMaskedLM``
   in f32 and bf16, each with B3 (12 launches a forward) and on the plain
   path, logits against the f32 plain path, a padded batch through the
   masked composite with no launch, and where the f32 forward's device
   time goes by kernel; B3, B3b and B3c at its attention shape [16, 512,
   12, 64] in 3 and 5 (B3 also in f32, ``fwd_f32``), timed beside SDPA;
17. the f32 forward (``fwd_f32``) also at generate's varlen prefill [8,
   512, 32, 128] and Llama's training shape [4, 2048, 32, 128] causal
   (``flash_fwd_f32_times``, in 3), with parity cases at head_dim 8 (s
   77), 40 (sq < sk, GQA 4:1) and a batch row padded whole; ptxas's spill
   report fails the build for its d 64 and d 128 instances; B3, B3b, B3c
   in bf16 at head_dim 256 ([2, 2048, 16, 256] causal) beside SDPA in 3
   and 5;
18. the f32 backward (B3b/B3c on the tensor cores, three TF32 products an
   f32 product): its parity cases are 5's f32 ones; timed in 5 at 4 x
   2048 causal and ERNIE's shape beside SDPA's whole f32 backward (and the
   kernels SDPA runs, from ``torch.profiler``), with both bounds (f32
   operations at 67 TFLOP/s, three TF32 products at 494.7); ptxas's spill
   report fails the build for their d 64 and d 128 instances; then the
   default dtype's training step (``phase_train_f32``, after 7): Llama-2-7B
   width in f32, no ``amp.decorate``, AdamW with the clip through
   ``TrainStep`` on 7's batch: at 2 layers the kernels' loss and every
   grad within 1e-4 relative L2 of the plain path's, then 4 layers (cut
   for memory), 1 warm-up and 3 counted steps with exact launches (4 B3b,
   4 B3c a step), ms a step, peak memory and B3b's and B3c's device time
   in a profiled step;
19. the bf16 forward and dK/dV at 128 < head_dim <= 256 on wgmma
   (``fwd_wide``, ``bwd_dkv_wide``; dQ on wgmma in 20): their
   parity cases in 3 and 5 (d 160 with sq < sk and GQA 4:1, d 256 varlen
   with a batch row padded whole and one over a whole 128-row tile, d 256
   not causal on s 300, d 256 with GQA 8:1, d 200 not causal), times at
   [2, 2048, 16, 256] causal beside SDPA and the bound with the card's
   clocks; ptxas's spill report fails the build for them; then their path
   (``phase_train_d256``, after 18): Llama-2-7B width with 16 heads of 256
   (a config the reference accepts, not a published model) at 2 layers,
   AMP O2 bf16, AdamW with the clip through ``TrainStep`` on 7's batch:
   ``gate_shallow`` on that batch, 1 warm-up and 3 counted steps with exact
   launches (2 B3, 2 B3b, 2 B3c a step), ms a step, and B3's, B3b's and
   B3c's device time in a profiled step;
20. the bf16 dQ at 128 < head_dim <= 256 on wgmma (``bwd_dq_wg<256>``,
   the d <= 128 kernel's design at that width: one warpgroup, dQ's 64 x
   256 f32 tile in registers): its parity cases in 5 (d 256 causal with
   sq 136 < sk 264 and GQA 4:1, d 256 on s 65, d 160 GQA 8:1 not
   causal), dq and delta bit-equal across two launches, delta against the
   plain rowsum;
   ``phase_train_d256`` held to ``gate_shallow``'s rule, with the q_proj
   and k_proj grads' distances logged;
21. the image layers (``phase_resnet``, after 16): ResNet-50 at its
   published widths (bottlenecks [3, 4, 6, 3], 1000 classes, 25.56 M
   parameters), random weights from seed 0, the batch norms' running
   statistics set by one training forward at momentum 0, 224 x 224
   images; gates, each raising: f32 logits at batch 4 on the card against
   the same model on the CPU (relative L2 <= 1e-4), the NCHW and NHWC
   internal layouts within 1e-4 of each other, bf16 under AMP O2 within
   2e-2 of f32 or within 1.2 times the distance of an f32 run with bf16's
   roundings put in by hand (a random-weight ResNet-50 magnifies them;
   top-1 agreement printed), one case of each convolution,
   pool, norm, resampling and padding functional in f32 against the CPU,
   and LSTM and GRU (2 layers, bidirectional, hidden 512, batch 32, 128
   steps, ragged lengths) against the CPU within 1e-5; no hand kernel is
   launched; then images/s and ms a forward at batch 128 in bf16 and f32
   in both layouts, the layout ``"auto"`` picks, device time by operation
   and the idle share from ``torch.profiler``, launches and peak memory a
   forward, and the bound from the multiply-adds the forward counts;
22. ResNet-50 training, the optimizer and amp remainder and the vision zoo
   (``phase_resnet_train``, after 21): (a1) f32, two ``Momentum(0.01)``
   TrainSteps at batch 4 on the card, no farther from a CPU f64 run than
   three times a CPU f32 run is (a step through fifty batch norms at init
   magnifies f32 rounding); (a2) bf16 O2 memorising one batch of 32;
   (a) ladder row 1 as ``bench.py`` sets it up (``resnet50()``, batch 256
   at 224², Momentum, AMP O2, TrainStep; 2 warm-up and 12 counted steps):
   ms a step, images/s, MFU against 989 TFLOP/s by ``bench.py``'s 3 x
   4.089 GFLOP an image, peak, a profiled step by operation, (a3) no hand
   kernel launched, (a4) a velocity for each trainable tensor and an f32
   master for each bf16 one; (b) the eager O1 idiom (``auto_cast`` O1
   bf16, ``GradScaler``) on f32 weights: conv and head outputs bf16, the
   norms' weights f32, finite losses, every step moving the parameters,
   and one inf gradient skipping the update, halving the scale with one
   host synchronisation; (b4) ERNIE 3.0 base under O1 (its SDPA cast
   sends bf16 to B3: 12 launches, the ``ernie_o1`` path) within 2e-2 of
   f32; (c) one model a zoo family at its published widths, batch 8, f32
   against the CPU within 1e-4 and finite in bf16 O2, and one bf16 O2
   Momentum step each of LeNet, ShuffleNetV2 x1.0 and DenseNet-121;
23. dropout (``phase_ernie_ft``, after 22): ladder row 2, the ERNIE 3.0
   base fine-tune as ``bench.py`` sets it up (12 layers, hidden 768,
   vocab 40000, 2 classes, dropout 0.1, batch 256 x 128, bf16 O2,
   ``AdamW(2e-5)`` with ``ClipGradByGlobalNorm(1.0)``, ``TrainStep``),
   with ``use_fused_adamw`` off and on: (a) at 2 layers in f32 the card's
   loss and grads within 1e-4 of the CPU's with the masks the card drew
   fed through the seam, (b) bf16 O2 with the same masks: the loss within
   2e-2 of that f32 run, all gradients together within 2e-2 of it or 1.2x
   the same model's CPU bf16 run's distance from its f32 run, (c) the card's
   masks: keep share within binomial bounds,
   a seed replays them, the next forward draws others; at full depth 3
   warm-up and 10 counted steps: ms a step, samples/s, MFU by bench.py's
   6 N x 128 FLOP a sample, peak memory, device time by operation and the
   idle share of one profiled step, (d) no synchronising CUDA call in a
   step (``torch.cuda.set_sync_debug_mode``), (e) finite losses falling, (f)
   B5 once a step for each parameter tensor with a gradient with the
   flag, no other launch (the attention under dropout takes the
   composite, as the reference's);
   then ``phase_a9``: one bf16 O2 step each of the zoo's dropout families
   at batch 8, a GPT-3 1.3B block with dropout (bf16 against f32 with the
   same masks), ``FusedMultiHeadAttention`` + ``FusedFeedForward`` at
   ERNIE's width (one B3, B3b and B3c a step) and ``incubate``'s
   residual norms on B11/B11b and B1/B1b against their plain twins;
24. MoE Llama (``phase_moe``, after 23), at Mixtral-8x7B's widths (d 4096,
   h 14336, 8 experts, top-2, GQA 32:8): (a) one ``ExpertParallelMLP`` on
   512 tokens, f32 on the card against the CPU (the routing equal but for
   certified near-ties, the other tokens within 1e-4), bf16 within 2e-2
   of f32 over the tokens routed alike, the experts split over a 2-member
   mesh on cuda:0 bit-equal to one block; (b) 16 of its 32 layers in bf16
   (the 32 need 93.4 GB): ``generate_batch`` on 8 ragged prompts with the
   kernels (launches counted) and with their plain twins, token-exact up
   to certified near-ties, the assignments dropped by capacity logged;
   ``generate`` at 8 x 512 + 32 (prefill, decode, peak) with a decode step
   and a prefill profiled by MoE part; the ``ServingEngine`` on the same
   prompts against ``generate_batch``: token-exact, parted after a drop on
   either path (logged), or at a certified near-tie; (c) training: the
   f32 gate at 1 layer, 2 x 128, card against CPU within 1e-4 (loss and
   every gradient), the bf16 O2 rule at 2 layers, and 3 warm-up and 10
   counted ``TrainStep``s at 2 layers, 4 x 2048, AdamW + clip with B5:
   ms a step, tokens/s, MFU by the active parameters (the top-2 experts),
   peak (above 75 GiB the batch halves).

The last lines are the ``kernels`` JSON line, the card line, and
``{"ok": true, "device": {...}}``.  Nothing is caught: any failure exits
non-zero before the last line.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import gc
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
BF16_FLOPS = 989e12            # dense bf16 tensor-core peak
F32_FLOPS = 67e12              # f32 outside the tensor cores
TF32_FLOPS = 494.7e12          # dense TF32 tensor-core peak (3 TF32 products an f32 one)
INT8_OPS = 1979e12             # dense int8 (and fp8) tensor-core peak
F32_EPS = 2.0 ** -23
TOL = {"float32": dict(rtol=2e-5, atol=1e-6),       # tests/op_test.py f32 row
       "float32_attn": dict(rtol=1e-4, atol=1e-5),  # f32 row, loosened for
                                                    # the attention reductions
       # dK and dV sum over every query row of the head group (8 x 2048
       # terms at 70B GQA) in another order than the plain einsums
       "float32_attn_bwd": dict(rtol=1e-4, atol=1e-4),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}      # op_test.py bf16 row
LOGITS_REL_TOL = 2e-2          # bf16 relative L2 error, kernel vs plain logits
DEPTH_REL_MARGIN = 1.2         # kernel grad error to f32 <= 1.2x plain's (every depth)
PROMPT_LENS = (37, 100, 250, 511)
MAX_NEW = 32
BATCH = 8
TRAIN_BATCH, TRAIN_SEQ = 4, 2048   # the training step's batch (bench.py's)
TRAIN_LAYERS = 8                   # Llama-2-7B width; depth cut for memory
TRAIN_WARMUP, TRAIN_STEPS = 3, 10
GPT_GEN_PROMPT, GPT_GEN_NEW = 128, 8  # GPT-3 1.3B's short generate check
OFF_FLAGS = dict(use_fused_rms_norm=False, use_fused_rope=False,
                 use_flash_attention=False, use_decode_attention=False,
                 use_fused_swiglu=False, use_fused_adamw=False, use_fused_layernorm=False)
LLAMA_ON = dict(use_fused_swiglu=True, use_fused_adamw=True)   # and the default kernels
GPT_ON = dict(use_fused_layernorm=True, use_fused_adamw=True)


def log(msg: str) -> None:
    print(msg, flush=True)


def bound_ms(nbytes: float, ops: float, peak_ops: float):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / peak_ops
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def time_ms(torch, fn, iters: int = 20, repeats: int = 5, warmup: int = 3) -> float:
    """Median over ``repeats`` of the mean device time of ``iters`` calls
    between CUDA events, after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return sorted(times)[repeats // 2]


def device_ms(torch, fn, iters: int = 20, warmup: int = 3):
    """Device time per call of ``fn``: every CUDA kernel that ``iters``
    calls launch, from ``torch.profiler``, summed and divided by ``iters``
    (the host's share of a call left out), after ``warmup`` calls.  A
    trace with no device event (the profiler on the chip machine has
    returned one now and then) is taken once more before this raises.
    Returns (ms, {kernel: ms})."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    for _ in range(2):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        by = {e.key: e.self_device_time_total / 1e3 / iters for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA}
        if by:
            return sum(by.values()), by
        log("torch.profiler recorded no device time; profiling once more")
    raise AssertionError("torch.profiler recorded no device time")


def split_line(by) -> str:
    return "; ".join(f"{name[:56]} {ms:.4f}" for name, ms in
                     sorted(by.items(), key=lambda kv: -kv[1]))


def check_close(torch, name, got, want, tol) -> float:
    got, want = got.detach(), want.detach()
    err = (got.float() - want.float()).abs()
    err = float(err[torch.isfinite(err)].max()) if err.numel() else 0.0
    torch.testing.assert_close(got.float(), want.float(), **tol, msg=lambda m: f"{name}: {m}")
    return err


def check_sum_close(torch, name, got, want, abs_terms) -> float:
    """``got`` against ``want`` where each element is a sum whose terms'
    absolute values sum to ``abs_terms``: in f32 the order of a long sum
    moves it by up to a few f32 epsilons of ``abs_terms``, so the bound is
    the f32 row plus 8 eps times ``abs_terms``; in bf16 the bf16 row."""
    if got.dtype == torch.float32:
        tol = TOL["float32"]
        bound = tol["atol"] + tol["rtol"] * want.abs() + 8 * F32_EPS * abs_terms
        err = (got - want).abs()
        if not bool((err <= bound).all()):
            worst = int((err - bound).argmax())
            raise AssertionError(f"{name}: element {worst} differs by "
                                 f"{float(err.flatten()[worst]):.3g}, bound "
                                 f"{float(bound.flatten()[worst]):.3g}")
        return float(err.max())
    return check_close(torch, name, got, want, TOL["bfloat16"])


def gpu_clocks() -> str:
    """The card's SM clock, power draw and temperature now, as nvidia-smi
    prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,temperature.gpu",
         "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()


def phase_device(torch):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    log(f"card: {smi}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python "
        f"{sys.version.split()[0]}, device 0: {torch.cuda.get_device_name(0)}")
    return smi


def phase_build():
    from pathlib import Path

    from paddle_tpu_torch.ops import _build

    t0 = time.perf_counter()
    logs = _build.build()
    log(f"build: {time.perf_counter() - t0:.1f} s for {sorted(logs) or 'nothing (current)'}")
    # ptxas names each kernel by its mangled symbol; cu++filt, beside nvcc, reads it
    cu_filt = str(Path(_build._nvcc()).resolve().with_name("cu++filt"))
    for name, text in logs.items():
        entries = re.findall(r"Compiling entry function '(\w+)'", text)
        readable = subprocess.run([cu_filt, "-p", *entries], capture_output=True, text=True,
                                  check=True).stdout.splitlines() if entries else []
        kernels, kernel = iter(readable), "?"
        for line in text.splitlines():
            if "Compiling entry function" in line:
                kernel = next(kernels)
            elif "Performance Loss" in line:  # e.g. wgmma products serialized by ptxas
                log(f"  ptxas {name}: {line.strip()}")
            elif "registers" in line or "spill" in line:
                log(f"  ptxas {name} {kernel}: {line.strip()}")
                # the wgmma kernels keep their accumulators in registers (the
                # d 256 ones, fwd_wide and bwd_dkv_wide, 128 a thread), and
                # so do the f32 forward and backward at the models' head dims
                if ("_wg<" in kernel or "_wide<" in kernel or re.search(
                        r"(fwd_f32|bwd_dq_tf32|bwd_dkv_tf32)<(\(int\))?(64|128),", kernel)) \
                        and re.search(r"[1-9]\d* bytes spill", line):
                    raise AssertionError(f"ptxas: {kernel} spills: {line.strip()}")


def pad_lens_of_main_path():
    """generate_batch's left padding for PROMPT_LENS: one bucket of 512
    rows, filled up to BATCH with copies of the first row."""
    pads = [512 - n for n in PROMPT_LENS]
    return pads + [pads[0]] * (BATCH - len(pads))


FLASH_FWD_SHAPES = (  # B3 on the other main paths: label, b, s, heads, causal
    ("Llama train", TRAIN_BATCH, TRAIN_SEQ, 32, True),
    ("GPT-3 1.3B train", TRAIN_BATCH, TRAIN_SEQ, 16, True),
    ("ring hop diag", 1, 4096, 32, True), ("ring hop full", 1, 4096, 32, False),
    ("CP hop diag", 1, 1008, 32, True), ("CP hop full", 1, 1008, 32, False),
    ("whole sequence", 1, 16384, 32, True))


def flash_fwd_times(torch, gen):
    """B3 in bf16 (head_dim 128) at FLASH_FWD_SHAPES: {shape: kernel ms,
    bound, SDPA ms}, each printed."""
    from paddle_tpu_torch.ops.flash_attention import flash_attention_fwd

    sdpa = torch.nn.functional.scaled_dot_product_attention
    times = {}
    for label, b, s, h, causal in FLASH_FWD_SHAPES:
        q, k, v = (torch.randn(b, s, h, 128, generator=gen, device=gen.device)
                   .to(torch.bfloat16) for _ in range(3))
        pairs = b * h * (s * (s + 1) // 2 if causal else s * s)
        # q, k, v read, out written, lse; 2 products (Q K^T, P V) a pair
        b_ms, b_by = bound_ms(4 * q.numel() * 2 + b * h * s * 4, 4 * 128 * pairs, BF16_FLOPS)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        ms = time_ms(torch, lambda: flash_attention_fwd(q, k, v, causal), iters=10, repeats=3)
        lib = time_ms(torch, lambda: sdpa(qt, kt, vt, is_causal=causal), iters=10, repeats=3)
        shape = f"{[b, s, h, 128]} {'causal' if causal else 'full'}"
        times[shape] = dict(ms=ms, bound_ms=b_ms, bound_by=b_by, library_ms=lib)
        log(f"time flash_attention {label} {shape} bf16: kernel {ms:.4f} ms, SDPA {lib:.4f} ms, "
            f"bound {b_ms:.4f} ms ({b_by}), {ms / b_ms:.2f}x the bound")
        del q, k, v, qt, kt, vt
    return times


ERNIE_BATCH, ERNIE_SEQ = 16, 512         # phase_ernie: ERNIE 3.0 base inference
ERNIE_ATTN = (ERNIE_BATCH, ERNIE_SEQ, ERNIE_SEQ, 12, 12, 64)   # b, sq, sk, hq, hkv, d


def ernie_flash_times(torch, gen):
    """B3 at ERNIE 3.0 base's attention [16, 512, 12, 64], not causal, in
    f32 (``fwd_f32``) and bf16 (the wgmma forward at d 64): {shape:
    kernel ms, bound, SDPA ms in the same dtype}, each printed."""
    from paddle_tpu_torch.ops.flash_attention import flash_attention_fwd

    b, s, _, h, _, d = ERNIE_ATTN
    sdpa = torch.nn.functional.scaled_dot_product_attention
    times = {}
    for dtype, peak in ((torch.float32, F32_FLOPS), (torch.bfloat16, BF16_FLOPS)):
        q, k, v = (torch.randn(b, s, h, d, generator=gen, device=gen.device).to(dtype)
                   for _ in range(3))
        # q, k, v read, out written, lse; 2 products (Q K^T, P V) a pair
        b_ms, b_by = bound_ms(4 * q.numel() * q.element_size() + b * h * s * 4,
                              4 * d * b * h * s * s, peak)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        ms = time_ms(torch, lambda: flash_attention_fwd(q, k, v, False), iters=10, repeats=3)
        lib = time_ms(torch, lambda: sdpa(qt, kt, vt), iters=10, repeats=3)
        name = str(dtype).split(".")[1]
        shape = f"{[b, s, h, d]} full {name}"
        times[shape] = dict(ms=ms, bound_ms=b_ms, bound_by=b_by, library_ms=lib)
        log(f"time flash_attention ERNIE 3.0 base {shape}: kernel {ms:.4f} ms, SDPA "
            f"{lib:.4f} ms, bound {b_ms:.4f} ms ({b_by}), {ms / b_ms:.2f}x the bound; "
            f"clocks.sm, power.draw, temperature after: {gpu_clocks()}")
        del q, k, v, qt, kt, vt
    return times


F32_FLASH_SHAPES = (  # B3 in f32 (fwd_f32, d 128): label, b, s, heads, varlen
    ("generate f32 prefill", BATCH, 512, 32, True),          # main path's pads
    ("Llama train f32", TRAIN_BATCH, TRAIN_SEQ, 32, False))  # default-dtype training
D256_SHAPE = (2, 2048, 16, 256)   # b, s, heads, d: bf16 at 128 < d <= 256, causal


def flash_fwd_f32_times(torch, gen):
    """B3 in f32 (``fwd_f32`` at head_dim 128) at F32_FLASH_SHAPES, causal
    (the varlen one with the main path's pads, bound by its valid pairs),
    and B3 in bf16 at head_dim 256 (``fwd_wide``) at D256_SHAPE, causal,
    with the card's clocks and power after it:
    {shape: kernel ms, bound, plain ms, SDPA ms in the same dtype (the
    varlen one with the same boolean mask)}, each printed."""
    from paddle_tpu_torch.ops.flash_attention import flash_attention_fwd, flash_attention_plain

    sdpa = torch.nn.functional.scaled_dot_product_attention
    dev = gen.device
    cases = [(label, b, s, h, 128, varlen, torch.float32, F32_FLOPS)
             for label, b, s, h, varlen in F32_FLASH_SHAPES]
    cases.append(("d256 bf16", *D256_SHAPE[:3], D256_SHAPE[3], False, torch.bfloat16, BF16_FLOPS))
    times = {}
    for label, b, s, h, d, varlen, dtype, peak in cases:
        q, k, v = (torch.randn(b, s, h, d, generator=gen, device=dev).to(dtype)
                   for _ in range(3))
        pad_list = pad_lens_of_main_path() if varlen else [0] * b
        pairs = h * sum((s - p) * (s - p + 1) // 2 for p in pad_list)
        # q, k, v read, out written, lse; 2 products (Q K^T, P V) a pair
        b_ms, b_by = bound_ms(4 * q.numel() * q.element_size() + b * h * s * 4,
                              4 * d * pairs, peak)
        pads, keep = None, None
        if varlen:
            pads = torch.tensor(pad_list, dtype=torch.int32, device=dev)
            keep = (torch.ones(s, s, dtype=torch.bool, device=dev).tril()[None, None]
                    & (torch.arange(s, device=dev) >= pads[:, None, None, None]))
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        ms = time_ms(torch, lambda: flash_attention_fwd(q, k, v, True, pads), iters=10, repeats=3)
        lib = time_ms(torch, lambda: sdpa(qt, kt, vt, attn_mask=keep, is_causal=keep is None),
                      iters=10, repeats=3)
        plain = time_ms(torch, lambda: flash_attention_plain(q, k, v, True, pads), iters=2,
                        repeats=3, warmup=1)
        name = str(dtype).split(".")[1]
        shape = f"{[b, s, h, d]} {'varlen' if varlen else 'causal'} {name}"
        times[shape] = dict(ms=ms, bound_ms=b_ms, bound_by=b_by, library_ms=lib, plain_ms=plain)
        log(f"time flash_attention {label} {shape}: kernel {ms:.4f} ms, plain {plain:.4f} ms, "
            f"SDPA {lib:.4f} ms, bound {b_ms:.4f} ms ({b_by}), {ms / b_ms:.2f}x the bound; "
            f"clocks {gpu_clocks()}")
        del q, k, v, qt, kt, vt, keep
    torch.cuda.empty_cache()
    return times


_S_LOOP = "for (int c = 0; c < d; c += 4) {"
_PV_LOOP = "for (int kk = 0; kk < kBK; kk += 4) {"
_S_BY_KEY = """#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int i = 0; i < RT; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[i][j]"""
# fwd_f32's A/B (flash_f32_ab): each variant is flash_attention.cu with these
# texts replaced; "x_" variants compute wrong results on purpose (a phase
# removed, loads pointed at one address) and are timed only
F32_AB_VARIANTS = {
    "RT 8 (as built)": [],
    "RT 4, 64 rows, 3 blocks": [("launch_f32<64, 4, 8, 2>", "launch_f32<64, 4, 4, 3>")],
    "8 warps, RT 4": [("launch_f32<64, 4, 8, 2>", "launch_f32<64, 8, 4, 2>")],
    "8 warps, RT 8": [("launch_f32<64, 4, 8, 2>", "launch_f32<64, 8, 8, 1>")],
    "S column by column": [(_S_BY_KEY, """#pragma unroll
      for (int e = 0; e < 4; ++e)
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int i = 0; i < RT; ++i) s[i][j]""")],
    "x_no S": [(_S_LOOP, "for (int c = 0; c < 0; c += 4) {")],
    "x_no P V": [(_PV_LOOP, "for (int kk = 0; kk < 0; kk += 4) {")],
    "x_no S, no P V": [(_S_LOOP, "for (int c = 0; c < 0; c += 4) {"),
                       (_PV_LOOP, "for (int kk = 0; kk < 0; kk += 4) {")],
    "x_K/V loaded once": [
        ("if (it + 1 < n_tiles) {", "if (false) {"),
        ("      hw::load_f32_tile<kBK, DP, kThreads>(Vs, v + at,",
         "      if (it == 0) hw::load_f32_tile<kBK, DP, kThreads>(Vs, v + at,")],
    "x_no exp2": [("hw::exp2_approx(fmaf(s[i][j], sl2, -m_ok))", "fmaf(s[i][j], sl2, -m_ok)")],
    "x_no second barrier": [
        ("    __syncthreads();  // V tile it landed and P is written; every lane is done with K", "")],
    "x_no P stores": [("        Pr[4 * i * kF32LDP + kg + 8 * j] = p;", "")],
    "x_K loads on one address": [("const float* Kr = Ks + kg * kLD;", "const float* Kr = Ks;")],
    "x_Q loads on one address": [("const float* Qr = Qs + r0 * kLD;",
                                  "const float* Qr = Qs + warp * L::kRowsW * kLD;")],
}


def ab_build(source, variants, symbols, argtypes, report):
    """Copies of ``paddle_tpu_torch/ops/csrc`` with texts replaced, one a
    variant (``variants``: {name: [(old, new), ...]}, each old text replaced
    in ``source``.cu or else in the header that holds it), each
    ``source``.cu built by nvcc into build/ab/<source>/<n>/, all at once;
    logs ptxas's registers and spills of the kernels whose mangled names
    match ``report``.  Returns {name: {symbol: ctypes function}}."""
    import ctypes
    import shutil

    from paddle_tpu_torch.ops import _build

    root = _build.BUILD_DIR.parent / "ab" / source
    procs = {}
    for n, (name, reps) in enumerate(variants.items()):
        out = root / str(n)
        shutil.rmtree(out, ignore_errors=True)
        shutil.copytree(_build.CSRC, out)
        files = [out / f"{source}.cu", *sorted(out.glob("*.cuh"))]
        texts = {f: f.read_text() for f in files}
        for old, new in reps:
            where = next((f for f in files if old in texts[f]), None)
            if where is None:
                raise AssertionError(f"A/B {name}: {old[:60]!r} is in no source of {source}")
            texts[where] = texts[where].replace(old, new)
        for f, text in texts.items():
            f.write_text(text)
        procs[name] = (out, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out / "lib.so"),
             str(out / f"{source}.cu")], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    fns = {}
    for name, (out, proc) in procs.items():
        text = proc.communicate()[0]
        if proc.returncode:
            raise AssertionError(f"A/B {name}: nvcc failed:\n{text[-3000:]}")
        lines = text.splitlines()
        for i, line in enumerate(lines):
            if "Performance Loss" in line:
                log(f"A/B {name}: {line.strip()}")
            m = re.search(report, line)
            if m and "Compiling entry" in line:
                log(f"A/B {name}: {m.group(0)}: {lines[i + 2].strip()}; {lines[i + 3].strip()}")
        lib = ctypes.CDLL(str(out / "lib.so"))
        fns[name] = {}
        for symbol in symbols:
            fn = getattr(lib, symbol)
            fn.argtypes, fn.restype = [*argtypes, ctypes.c_void_p], ctypes.c_int
            fns[name][symbol] = fn
    return fns


def ab_times(torch, fns, cases, rounds):
    """{(variant, case): [ms, ...]}: each case ({label: fn(variant's
    functions)}) timed for every variant in turns (all variants, then all in
    reverse, ``rounds`` times), the clocks logged after each round; every
    time and the median logged."""
    times = {}
    for _ in range(rounds):
        for name in [*fns, *reversed(list(fns))]:
            for label, run in cases.items():
                times.setdefault((name, label), []).append(time_ms(
                    torch, lambda: run(fns[name]), iters=10, repeats=3))
        log(f"A/B clocks: {gpu_clocks()}")
    for (name, label), ts in times.items():
        log(f"A/B {name} {label}: {' '.join(f'{t:.4f}' for t in ts)} ms, median "
            f"{sorted(ts)[len(ts) // 2]:.4f}")
    return times


def flash_f32_ab(torch, variants=None, rounds=2):
    """Times ``fwd_f32`` variants (F32_AB_VARIANTS, built by ``ab_build``
    and called through ctypes) at ERNIE's [16, 512, 12, 64] and Llama's
    [4, 2048, 32, 128] causal in f32, in turns (``ab_times``); logs each
    variant's ptxas registers and spills for its d 64 and d 128 instances
    and its parity against the plain version (not for "x_" variants).
    Callable alone after ``phase_device`` (no ``phase_build`` needed)."""
    from paddle_tpu_torch.ops.flash_attention import _ARGTYPES, flash_attention_plain

    fns = ab_build("flash_attention", variants or F32_AB_VARIANTS,
                   ["ptt_flash_attention_fwd"], _ARGTYPES, r"fwd_f32ILi(64|128)E")

    def run(fn, q, k, v, causal):
        b, sq, hq, d = q.shape
        out, lse = torch.empty_like(q), torch.empty(b, hq, sq, device=q.device)
        rc = fn["ptt_flash_attention_fwd"](
            q.data_ptr(), k.data_ptr(), v.data_ptr(), None, out.data_ptr(), lse.data_ptr(),
            b, sq, k.shape[1], hq, k.shape[2], d, 1.0 / math.sqrt(d), int(causal), 0,
            torch.cuda.current_stream().cuda_stream)
        if rc:
            raise AssertionError(f"A/B launch: CUDA error {rc}")
        return out, lse

    gen = torch.Generator(device="cuda").manual_seed(5)
    for name, fn in fns.items():
        if name.startswith("x_"):
            continue
        for hd, causal in ((64, False), (128, True), (40, True)):
            q, k, v = (torch.randn(2, 300, 4, hd, generator=gen, device="cuda") for _ in range(3))
            check_close(torch, f"A/B {name} d{hd}", run(fn, q, k, v, causal)[0],
                        flash_attention_plain(q, k, v, causal)[0], TOL["float32_attn"])
    cases = {}
    for label, shape, causal in (("ERNIE [16, 512, 12, 64] full f32", (16, 512, 12, 64), False),
                                 ("[4, 2048, 32, 128] causal f32",
                                  (TRAIN_BATCH, TRAIN_SEQ, 32, 128), True)):
        q, k, v = (torch.randn(shape, generator=gen, device="cuda") for _ in range(3))
        cases[label] = lambda fn, q=q, k=k, v=v, causal=causal: run(fn, q, k, v, causal)
    return ab_times(torch, fns, cases, rounds)


# B3b/B3c f32's A/B (flash_bwd_tf32_ab): each variant is flash_attention_bwd.cu
# (or mma_tf32.cuh) with these texts replaced; "x_" variants compute wrong
# results on purpose and are timed only
BWD_AB_VARIANTS = {
    "as built": [],
    "lo rounded to nearest": [("lo = __float_as_uint(x - __uint_as_float(hi));",
                               "lo = tf32_rna(x - __uint_as_float(hi));")],
    "hi by cvt.rna.tf32.f32": [("return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;",
                                """uint32_t y;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(y) : "f"(x));
  return y;""")],
    "S, dP looped to d, not unrolled": [("""#pragma unroll
  for (int c = 0; c < LD - 4; c += 32) {  // LD - 4 = DP
    if (c >= d) break;""", "  for (int c = 0; c < d; c += 32) {")],
    "dq 128: 4 warps": [("launch_dq_tf32<128, 8, 32, 1>", "launch_dq_tf32<128, 4, 32, 1>")],
    "dq 128: 4 warps, 16-key tiles, 2 blocks": [("launch_dq_tf32<128, 8, 32, 1>",
                                                 "launch_dq_tf32<128, 4, 16, 2>")],
    "dkv 128: 4 warps": [("launch_dkv_tf32<128, 8, 32, 128, 1>",
                          "launch_dkv_tf32<128, 4, 32, 128, 1>")],
    "dkv 128: 8 warps, 16-row tiles": [("launch_dkv_tf32<128, 8, 32, 128, 1>",
                                        "launch_dkv_tf32<128, 8, 16, 128, 1>")],
    "dq 64: 32-key tiles": [("launch_dq_tf32<64, 4, 64, 2>", "launch_dq_tf32<64, 4, 32, 2>")],
    "dkv 64: 8 warps": [("launch_dkv_tf32<64, 4, 32, 64, 2>",
                         "launch_dkv_tf32<64, 8, 32, 64, 1>")],
    "one accumulator for the whole sum": [
        ("hw::mma_3xtf32(part[e], ah, al, bh, bl);",
         "hw::mma_3xtf32(acc[4 * v + e], ah, al, bh, bl);"),
        ("for (int x = 0; x < 4; ++x) acc[4 * v + e][x] += part[e][x];",
         "for (int x = 0; x < 4; ++x) part[e][x] = 0.f;")],
    "x_1xTF32": [("""  mma_tf32(d, a_lo, b_hi);
  mma_tf32(d, a_hi, b_lo);
  mma_tf32(d, a_hi, b_hi);""", "  mma_tf32(d, a_hi, b_hi);")],
    "x_3 products, no split": [("""  hi = tf32_rna(x);
  lo = __float_as_uint(x - __uint_as_float(hi));""", """  hi = __float_as_uint(x);
  lo = hi;""")],
}


def flash_bwd_tf32_ab(torch, variants=None, rounds=2):
    """Times B3b's and B3c's f32 variants (BWD_AB_VARIANTS, built by
    ``ab_build``) at ERNIE's [16, 512, 12, 64] full and Llama's [4, 2048,
    32, 128] causal, in turns (``ab_times``).  First each variant but the
    "x_" ones against the plain backward (d 64 full, d 128 causal, d 72 GQA
    causal with sq < sk, Llama-2-70B's GQA [1, 2048, 64 / 8, 128] causal):
    its largest errors and the elements outside the f32 backward tolerance
    are logged, and "as built" must have none.  Callable alone after
    ``phase_device``."""
    from paddle_tpu_torch.ops.flash_attention import (_BWD_ARGTYPES, flash_attention_bwd_plain,
                                                      flash_attention_plain)

    dq_sym, dkv_sym = "ptt_flash_attention_bwd_dq", "ptt_flash_attention_bwd_dkv"
    fns = ab_build("flash_attention_bwd", variants or BWD_AB_VARIANTS, [dq_sym, dkv_sym],
                   _BWD_ARGTYPES, r"bwd_d(q|kv)_tf32ILi(64|128)E")

    def call(fn, *ptrs_and_dims):
        rc = fn(*ptrs_and_dims, torch.cuda.current_stream().cuda_stream)
        if rc:
            raise AssertionError(f"A/B launch: CUDA error {rc}")

    def dims(q, k, causal):
        b, sq, hq, d = q.shape
        return (b, sq, k.shape[1], hq, k.shape[2], d, 1.0 / math.sqrt(d), int(causal), 0)

    def run_dq(f, q, k, v, out, lse, do, causal):
        dq, delta = torch.empty_like(q), torch.empty_like(lse)
        call(f[dq_sym], q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), do.data_ptr(),
             lse.data_ptr(), dq.data_ptr(), delta.data_ptr(), *dims(q, k, causal))
        return dq, delta

    def run_dkv(f, q, k, v, do, lse, delta, causal):
        dk, dv = torch.empty_like(k), torch.empty_like(v)
        call(f[dkv_sym], q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
             delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), *dims(q, k, causal))
        return dk, dv

    gen = torch.Generator(device="cuda").manual_seed(6)

    def inputs(b, sq, sk, hq, hkv, d, causal):
        q, do = (torch.randn(b, sq, hq, d, generator=gen, device="cuda") for _ in range(2))
        k, v = (torch.randn(b, sk, hkv, d, generator=gen, device="cuda") for _ in range(2))
        out, lse = flash_attention_plain(q, k, v, causal)
        return q, k, v, out.contiguous(), lse.contiguous(), do

    tol = TOL["float32_attn_bwd"]
    for shape in ((2, 300, 300, 4, 4, 64, False), (1, 256, 256, 4, 4, 128, True),
                  (2, 200, 260, 8, 2, 72, True), (1, 2048, 2048, 64, 8, 128, True)):
        q, k, v, out, lse, do = inputs(*shape)
        want = flash_attention_bwd_plain(q, k, v, out, lse, do, shape[-1])
        for name, f in fns.items():
            if name.startswith("x_"):
                continue
            dq, delta = run_dq(f, q, k, v, out, lse, do, shape[-1])
            got = (dq, *run_dkv(f, q, k, v, do, lse, delta, shape[-1]))
            errs = [(float((g_ - w_).abs().max()),
                     int(((g_ - w_).abs() > tol["atol"] + tol["rtol"] * w_.abs()).sum()))
                    for g_, w_ in zip(got, want)]
            log(f"A/B {name} {list(shape)}: max_abs_err dq dk dv "
                f"{' '.join(f'{e:.3g}' for e, _ in errs)}; outside the f32 tolerance "
                f"{' '.join(str(n) for _, n in errs)}")
            if name == "as built" and any(n for _, n in errs):
                raise AssertionError(f"A/B as built {shape}: outside the tolerance {errs}")
        del q, k, v, out, lse, do, want
    cases = {}
    for label, shape in (("ERNIE [16, 512, 12, 64] full f32", (16, 512, 512, 12, 12, 64, False)),
                         ("[4, 2048, 32, 128] causal f32",
                          (TRAIN_BATCH, TRAIN_SEQ, TRAIN_SEQ, 32, 32, 128, True))):
        q, k, v, out, lse, do = inputs(*shape)
        causal = shape[-1]
        delta = run_dq(fns["as built"] if "as built" in fns else next(iter(fns.values())),
                       q, k, v, out, lse, do, causal)[1]
        cases[f"dq {label}"] = (lambda f, a=(q, k, v, out, lse, do, causal): run_dq(f, *a))
        cases[f"dkv {label}"] = (lambda f, a=(q, k, v, do, lse, delta, causal): run_dkv(f, *a))
    return ab_times(torch, fns, cases, rounds)


# B3, B3b and B3c at 128 < d <= 256 (flash_d256_ab): each variant is
# flash_attention.cu or flash_attention_bwd.cu with these texts replaced;
# "x_" variants compute wrong results on purpose (a phase removed) and are
# timed only
# (the rejected designs, for B3 one warpgroup a block, 32-key tiles and a
# third stage, for B3c S^T recomputed by the dK warpgroup, for B3b two
# warpgroups handing p across or owning 64 rows each and dQ left in flight,
# are in PERF.md section 6 with their times, and in the kernels' source
# notes)
D256_FWD_AB_VARIANTS = {
    "2 warpgroups, 64-key tiles, 2 stages (as built)": [],
    "x_no S": [("      hw::wgmma_ss_m64n64(s, hw::desc_kmajor(Qw, 64, kk), "
                "hw::desc_kmajor(Kt, BK, kk), kk);", "      ;")],
    "x_no softmax": [("""    softmax_tile(s, m, l, alpha, t0, row0, quad, edge, pad, sk, causal, offset, sl2);
#pragma unroll
    for (int x = 0; x < DP / 2; ++x) o[x] *= alpha[(x >> 1) & 1];
    uint32_t a[BK / 16][4];""", "    uint32_t a[BK / 16][4];")],
    "x_no P V": [("      hw::wgmma_rs_tb<DP>(o, a[kk], hw::desc_mnmajor(Vt, BK, kk), 1);", "      ;")],
    "x_K/V loaded once": [("    if (it + kStages - 1 < n_tiles) load_kv(it + kStages - 1);", "")],
}
D256_BWD_AB_VARIANTS = {
    "as built (B3b one warpgroup; B3c P^T exchanged)": [],
    "x_B3b no S": [("      hw::wgmma_ss_m64n64(s, hw::desc_kmajor(Qs, kBQ, kk), "
                    "hw::desc_kmajor(Kt, kBK, kk), kk);", "      ;")],
    "x_B3b no dP": [("      hw::wgmma_ss_m64n64(dp, hw::desc_kmajor(dOs, kBQ, kk), "
                     "hw::desc_kmajor(Vt, kBK, kk), kk);", "      ;")],
    "x_B3b no dQ product": [
        ("      hw::wgmma_rs_tb<DP>(dq_acc, a[kk], hw::desc_mnmajor(Kt, kBK, kk), 1);", "      ;")],
    "x_B3b no p, ds arithmetic": [
        ("          s[x] = edge && 8 * j + 2 * quad + e >= lim ? 0.f : p;", "          s[x] = s[x];"),
        ("s[x] = s[x] * (dp[x] - delta_r[(x >> 1) & 1]) * scale;", "s[x] = dp[x];")],
    "x_B3b K/V loaded once": [("    if (it + kStages - 1 < n_tiles) load_kv(it + kStages - 1);",
                               "")],
    "x_no dK, dV products": [
        ("      hw::wgmma_rs_tb<DP>(acc, a[kk], hw::desc_mnmajor(Yt, kBQ, kk), 1);", "      ;")],
    "x_no p, ds arithmetic": [("            s[x] = edge && k0 + r_lo + 8 * i >= lim ? 0.f : p;",
                               "            s[x] = s[x];"),
                              ("          dp[x] = s[x] * (dp[x] - (x & 1 ? d2.y : d2.x)) * scale;",
                               "          dp[x] = s[x];")],
}


def flash_d256_ab(torch, fwd_variants=None, bwd_variants=None, rounds=2):
    """Times the bf16 kernels at 128 < d <= 256, ``fwd_wide`` (B3),
    ``bwd_dq_wg<256>`` (B3b) and ``bwd_dkv_wide`` (B3c), in their variants
    (D256_FWD_AB_VARIANTS, D256_BWD_AB_VARIANTS, built by ``ab_build``) at
    D256_SHAPE causal, in turns (``ab_times``).  First each variant but the
    "x_" ones against the plain version in bf16 (forward: d 256 GQA 4:1
    with sq < sk, d 256 varlen with a batch row padded whole, d 160 not
    causal on s 300; B3b: d 256 GQA 4:1 with sq 136 < sk 264, d 256 on s
    65, d 160 GQA 8:1 not causal; B3c: d 256 GQA 8:1 causal, d 200 not
    causal), launched twice for equal bits (B3b: dq and delta).  Callable
    alone after ``phase_device``."""
    from paddle_tpu_torch.ops.flash_attention import (_ARGTYPES, _BWD_ARGTYPES,
                                                      flash_attention_bwd_plain,
                                                      flash_attention_plain)

    fwd_fns = ab_build("flash_attention", fwd_variants or D256_FWD_AB_VARIANTS,
                       ["ptt_flash_attention_fwd"], _ARGTYPES,
                       r"fwd_wideILi256EE")
    dq_sym, dkv_sym = "ptt_flash_attention_bwd_dq", "ptt_flash_attention_bwd_dkv"
    bwd_fns = ab_build("flash_attention_bwd", bwd_variants or D256_BWD_AB_VARIANTS,
                       [dq_sym, dkv_sym], _BWD_ARGTYPES,
                       r"bwd_(dq_wg|dkv_wide)ILi256EE")
    stream = torch.cuda.current_stream().cuda_stream

    def call(fn, *args):
        rc = fn(*args, stream)
        if rc:
            raise AssertionError(f"A/B launch: CUDA error {rc}")

    def dims(q, k, causal):
        b, sq, hq, d = q.shape
        return (b, sq, k.shape[1], hq, k.shape[2], d, 1.0 / math.sqrt(d), int(causal), 1)

    def fwd(f, q, k, v, causal, pads=None):
        out, lse = torch.empty_like(q), torch.empty(q.shape[0], q.shape[2], q.shape[1],
                                                    device=q.device)
        call(f["ptt_flash_attention_fwd"], q.data_ptr(), k.data_ptr(), v.data_ptr(),
             None if pads is None else pads.data_ptr(), out.data_ptr(), lse.data_ptr(),
             *dims(q, k, causal))
        return out, lse

    def dq_delta(f, q, k, v, out, lse, do, causal):
        dq, delta = torch.empty_like(q), torch.empty_like(lse)
        call(f[dq_sym], q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), do.data_ptr(),
             lse.data_ptr(), dq.data_ptr(), delta.data_ptr(), *dims(q, k, causal))
        return dq, delta

    def dkv(f, q, k, v, out, lse, do, causal):
        _, delta = dq_delta(f, q, k, v, out, lse, do, causal)
        dk, dv = torch.empty_like(k), torch.empty_like(v)
        call(f[dkv_sym], q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
             delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), *dims(q, k, causal))
        return dk, dv

    gen = torch.Generator(device="cuda").manual_seed(7)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)

    tol = TOL["bfloat16"]
    for b, sq, sk, hq, hkv, d, causal, pads in (
            (2, 100, 230, 8, 2, 256, True, None), (3, 200, 200, 4, 2, 256, True, [0, 200, 37]),
            (2, 300, 300, 4, 2, 160, False, None)):
        q, k, v = randn(b, sq, hq, d), randn(b, sk, hkv, d), randn(b, sk, hkv, d)
        pl = None if pads is None else torch.tensor(pads, dtype=torch.int32, device="cuda")
        want = flash_attention_plain(q, k, v, causal, pl)
        for name, f in fwd_fns.items():
            if name.startswith("x_"):
                continue
            got, again = fwd(f, q, k, v, causal, pl), fwd(f, q, k, v, causal, pl)
            if not all(torch.equal(g, a) for g, a in zip(got, again)):
                raise AssertionError(f"A/B {name}: two launches differ")
            err = check_close(torch, f"A/B {name} d{d}", got[0], want[0], tol)
            check_close(torch, f"A/B {name} lse d{d}", got[1], want[1], TOL["float32_attn"])
            log(f"A/B {name} fwd {[b, sq, sk, hq, hkv, d]}: max_abs_err {err:.3g}, bit-equal")
    for b, sq, sk, hq, hkv, d, causal in ((2, 136, 264, 8, 2, 256, True),
                                          (2, 65, 65, 4, 2, 256, True),
                                          (2, 300, 300, 8, 1, 160, False)):
        q, do = randn(b, sq, hq, d), randn(b, sq, hq, d)
        k, v = randn(b, sk, hkv, d), randn(b, sk, hkv, d)
        out, lse = flash_attention_plain(q, k, v, causal)
        out, lse = out.contiguous(), lse.contiguous()
        want = (flash_attention_bwd_plain(q, k, v, out, lse, do, causal)[0],
                (do.float() * out.float()).sum(-1).transpose(1, 2))
        for name, f in bwd_fns.items():
            if name.startswith("x_"):
                continue
            got = dq_delta(f, q, k, v, out, lse, do, causal)
            again = dq_delta(f, q, k, v, out, lse, do, causal)
            if not all(torch.equal(g, a) for g, a in zip(got, again)):
                raise AssertionError(f"A/B {name}: two launches differ")
            errs = [check_close(torch, f"A/B {name} dq", got[0], want[0], tol),
                    check_close(torch, f"A/B {name} delta", got[1], want[1],
                                TOL["float32_attn"])]
            log(f"A/B {name} dq {[b, sq, sk, hq, hkv, d]}: max_abs_err dq {errs[0]:.3g} delta "
                f"{errs[1]:.3g}, bit-equal")
    for b, s, hq, hkv, d, causal in ((2, 300, 8, 1, 256, True), (2, 300, 4, 2, 200, False)):
        q, do = randn(b, s, hq, d), randn(b, s, hq, d)
        k, v = randn(b, s, hkv, d), randn(b, s, hkv, d)
        out, lse = flash_attention_plain(q, k, v, causal)
        out, lse = out.contiguous(), lse.contiguous()
        want = flash_attention_bwd_plain(q, k, v, out, lse, do, causal)[1:]
        for name, f in bwd_fns.items():
            if name.startswith("x_"):
                continue
            got, again = dkv(f, q, k, v, out, lse, do, causal), dkv(f, q, k, v, out, lse, do,
                                                                    causal)
            if not all(torch.equal(g, a) for g, a in zip(got, again)):
                raise AssertionError(f"A/B {name}: two launches differ")
            errs = [check_close(torch, f"A/B {name} {n}", g, w, tol)
                    for n, g, w in zip(("dk", "dv"), got, want)]
            log(f"A/B {name} bwd {[b, s, hq, hkv, d]}: max_abs_err dk {errs[0]:.3g} dv "
                f"{errs[1]:.3g}, bit-equal")
    b, s, h, d = D256_SHAPE
    q, k, v, do = (randn(b, s, h, d) for _ in range(4))
    out, lse = fwd(next(iter(fwd_fns.values())), q, k, v, True)
    delta = torch.empty_like(lse)
    call(next(iter(bwd_fns.values()))[dq_sym], q.data_ptr(), k.data_ptr(), v.data_ptr(),
         out.data_ptr(), do.data_ptr(), lse.data_ptr(), torch.empty_like(q).data_ptr(),
         delta.data_ptr(), *dims(q, k, True))
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    label = f"{[b, s, h, d]} causal bf16"
    fwd_times = ab_times(torch, fwd_fns, {f"fwd {label}": lambda f: fwd(f, q, k, v, True)},
                         rounds)
    dq, dq_delta_out = torch.empty_like(q), torch.empty_like(lse)
    bwd_times = ab_times(torch, bwd_fns, {
        f"dq {label}": lambda f: call(
            f[dq_sym], q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), do.data_ptr(),
            lse.data_ptr(), dq.data_ptr(), dq_delta_out.data_ptr(), *dims(q, k, True)),
        f"dkv {label}": lambda f: call(
            f[dkv_sym], q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), *dims(q, k, True))}, rounds)
    return {**fwd_times, **bwd_times}


def phase_parity(torch):
    from paddle_tpu_torch.models.llama import _rope_tables
    from paddle_tpu_torch.ops.decode_attention import (decode_attention,
                                                       decode_attention_plain)
    from paddle_tpu_torch.ops.flash_attention import (flash_attention_fwd,
                                                      flash_attention_plain)
    from paddle_tpu_torch.ops.fused_norm import fused_rms_norm, rms_norm_plain
    from paddle_tpu_torch.ops.rope import fused_rope, rope_plain

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def randn(*shape, dtype):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    pads = torch.tensor(pad_lens_of_main_path(), dtype=torch.int32, device=dev)
    s, h, d, hidden = 512, 32, 128, 4096
    rows = {}

    # B1 rms_norm at the prefill rows of the main path
    for dtype in (torch.float32, torch.bfloat16):
        x = randn(BATCH * s, hidden, dtype=dtype)
        w = (1 + 0.1 * randn(hidden, dtype=torch.float32)).to(dtype)
        (out, rstd), (pout, prstd) = fused_rms_norm(x, w, 1e-5), rms_norm_plain(x, w, 1e-5)
        tol = TOL[str(dtype).split(".")[1]]
        err = check_close(torch, "rms_norm", out, pout, tol)
        check_close(torch, "rms_norm rstd", rstd, prstd, TOL["float32"])
        log(f"parity rms_norm {dtype} x{list(x.shape)}: max_abs_err {err:.3g}")
    es = x.element_size()
    b_ms, b_by = bound_ms(2 * x.numel() * es + w.numel() * es + x.shape[0] * 4,
                          4 * x.numel(), F32_FLOPS)
    rows["rms_norm"] = dict(
        max_abs_err=err, ms=time_ms(torch, lambda: fused_rms_norm(x, w, 1e-5)),
        plain_ms=time_ms(torch, lambda: rms_norm_plain(x, w, 1e-5)),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=time_ms(torch, lambda: torch.nn.functional.rms_norm(
            x, (hidden,), w, 1e-5)))

    # B2 rope with the main path's per-row offsets
    cos, sin = (t.to(dev) for t in _rope_tables(d, 4096, 10000.0))
    pos_ids = (torch.arange(s, device=dev, dtype=torch.int32)[None, :]
               - pads[:, None]).contiguous()
    for dtype in (torch.float32, torch.bfloat16):
        q, k = randn(BATCH, s, h, d, dtype=dtype), randn(BATCH, s, h, d, dtype=dtype)
        (oq, ok), (pq, pk) = fused_rope(q, k, cos, sin, pos_ids), rope_plain(q, k, cos, sin, pos_ids)
        tol = TOL[str(dtype).split(".")[1]]
        err = max(check_close(torch, "rope q", oq, pq, tol),
                  check_close(torch, "rope k", ok, pk, tol))
        log(f"parity rope {dtype} q{list(q.shape)}: max_abs_err {err:.3g}")
    rows_used = int(pos_ids.clamp(min=0).unique().numel())
    b_ms, b_by = bound_ms(2 * (q.numel() + k.numel()) * q.element_size()
                          + pos_ids.numel() * 4 + 2 * rows_used * d * 4,
                          3 * (q.numel() + k.numel()), F32_FLOPS)
    rows["rope"] = dict(
        max_abs_err=err, ms=time_ms(torch, lambda: fused_rope(q, k, cos, sin, pos_ids)),
        plain_ms=time_ms(torch, lambda: rope_plain(q, k, cos, sin, pos_ids)),
        bound_ms=b_ms, bound_by=b_by, library_ms=None)

    # B3 flash attention: varlen (main path), unpadded causal, 70B GQA,
    # off sizes; then the shapes of the other main paths (training, the
    # ring's hops at cp 4 over 16384 tokens, the CP prefill's 1008-row hops),
    # sq < sk, head_dim 64 and pads over whole 64-row tiles.  Each case is
    # launched twice and must give the same bits; every row inside its pad
    # has exact zeros and lse -inf.
    cases = [  # label, b, sq, sk, hq, hkv, head_dim, causal, pad_lens
        ("varlen 7B", BATCH, s, s, h, h, d, True, pads),
        ("causal 7B", BATCH, s, s, h, h, d, True, None),
        ("varlen 70B GQA", 2, s, s, 64, 8, d, True, pads[:2]),
        ("causal 70B GQA", 2, s, s, 64, 8, d, True, None),
        # ragged query tiles and head_dims off the 16-column fragments
        ("varlen d72 s300", 2, 300, 300, 4, 2, 72, True, (pads[2:4] // 4).contiguous()),
        ("causal d256 s200", 1, 200, 200, 2, 1, 256, True, None),
        # the d 256 kernel (fwd_wide in bf16): a batch row padded whole and
        # one over a whole 128-row tile, d 160 with sq < sk and GQA 4:1, not
        # causal on ragged tiles
        ("varlen d256 s200 row padded whole", 3, 200, 200, 4, 2, 256, True,
         torch.tensor([0, 200, 137], dtype=torch.int32, device=dev)),
        ("causal d160 sq<sk GQA 4:1", 2, 100, 230, 8, 2, 160, True, None),
        ("full d256 s300", 2, 300, 300, 4, 2, 256, False, None),
        # phase_train_d256's attention: 16 heads of 256 over 4 x 2048
        ("causal d256 train", TRAIN_BATCH, TRAIN_SEQ, TRAIN_SEQ, 16, 16, 256, True, None),
        ("causal Llama train", TRAIN_BATCH, TRAIN_SEQ, TRAIN_SEQ, h, h, d, True, None),
        ("causal GPT-3 1.3B train", TRAIN_BATCH, TRAIN_SEQ, TRAIN_SEQ, 16, 16, d, True, None),
        ("ring hop diag", 1, 4096, 4096, h, h, d, True, None),
        ("ring hop full", 1, 4096, 4096, h, h, d, False, None),
        ("CP hop diag", 1, 1008, 1008, h, h, d, True, None),
        ("CP hop full", 1, 1008, 1008, h, h, d, False, None),
        ("causal sq<sk GQA", 2, 200, 520, 8, 2, d, True, None),
        ("causal d64 s1000 GQA", 2, 1000, 1000, 8, 2, 64, True, None),
        ("varlen d64 s384 GQA", 3, 384, 384, 8, 2, 64, True,
         torch.tensor([0, 130, 300], dtype=torch.int32, device=dev)),
        ("ERNIE 3.0 base full", *ERNIE_ATTN, False, None),
        # the smallest head_dim the wrapper takes on ragged tiles; d 40 with
        # sq < sk and GQA 4:1; a batch row padded entirely (every query row
        # of it sees no key)
        ("causal d8 s77 GQA", 2, 77, 77, 4, 2, 8, True, None),
        ("causal d40 sq<sk GQA 4:1", 2, 100, 230, 8, 2, 40, True, None),
        ("varlen d64 s200 row padded whole", 3, 200, 200, 4, 2, 64, True,
         torch.tensor([0, 200, 37], dtype=torch.int32, device=dev))]
    for label, b, sq, sk, hq, hkv, hd, causal, pl in cases:
        for dtype in (torch.float32, torch.bfloat16):
            q = randn(b, sq, hq, hd, dtype=dtype)
            k, v = randn(b, sk, hkv, hd, dtype=dtype), randn(b, sk, hkv, hd, dtype=dtype)
            (out, lse), (out2, lse2) = (flash_attention_fwd(q, k, v, causal, pl),
                                        flash_attention_fwd(q, k, v, causal, pl))
            if not (torch.equal(out, out2) and torch.equal(lse, lse2)):
                raise AssertionError(f"flash {label} {dtype}: two launches differ")
            pout, plse = flash_attention_plain(q, k, v, causal, pl)
            tol = TOL["float32_attn" if dtype == torch.float32 else "bfloat16"]
            err = check_close(torch, f"flash {label}", out, pout, tol)
            check_close(torch, f"flash lse {label}", lse, plse, TOL["float32_attn"])
            for r, n in enumerate([] if pl is None else pl.tolist()):
                if out[r, :n].any() or not bool(lse[r, :, :n].isneginf().all()) \
                        or not bool(lse[r, :, n:].isfinite().all()):
                    raise AssertionError(f"flash {label} {dtype}: batch row {r}'s {n} padded "
                                         f"rows are not exact zeros with lse -inf")
            log(f"parity flash {label} {dtype} q{list(q.shape)} k{list(k.shape)}"
                f"{'' if causal else ' full'}: max_abs_err {err:.3g}; two launches bit-equal")
            if label == "varlen 7B" and dtype == torch.bfloat16:
                main = (q, k, v, err)
            del q, k, v, out, lse, out2, lse2, pout, plse
        torch.cuda.empty_cache()
    q, k, v, err = main
    n_valid = s - pads.long()
    pairs = int((n_valid * (n_valid + 1) // 2).sum())
    b_ms, b_by = bound_ms(4 * q.numel() * q.element_size() + BATCH * h * s * 4,
                          4 * d * h * pairs, BF16_FLOPS)
    keep = (torch.ones(s, s, dtype=torch.bool, device=dev).tril()[None, None]
            & (torch.arange(s, device=dev) >= pads[:, None, None, None]))
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    rows["flash_attention"] = dict(
        max_abs_err=err, ms=time_ms(torch, lambda: flash_attention_fwd(q, k, v, True, pads)),
        plain_ms=time_ms(torch, lambda: flash_attention_plain(q, k, v, True, pads)),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=time_ms(torch, lambda: sdpa(qt, kt, vt, attn_mask=keep)),
        shapes={**flash_fwd_times(torch, gen), **ernie_flash_times(torch, gen),
                **flash_fwd_f32_times(torch, gen)})

    # B6 decode attention: main path mid-decode, pad >= pos rows, 70B GQA
    C = 544
    cases = [("7B", BATCH, h, h, 512 + MAX_NEW // 2, pads),
             ("7B pad>=pos", BATCH, h, h, 300, pads),
             ("70B GQA", BATCH, 64, 8, 512 + MAX_NEW // 2, pads)]
    for label, b, hq, hkv, pos, pl in cases:
        for dtype in (torch.float32, torch.bfloat16):
            q = randn(b, 1, hq, d, dtype=dtype)
            kn, vn = randn(b, 1, hkv, d, dtype=dtype), randn(b, 1, hkv, d, dtype=dtype)
            ck, cv = randn(b, C, hkv, d, dtype=dtype), randn(b, C, hkv, d, dtype=dtype)
            kk, kvv, pk, pv = ck.clone(), cv.clone(), ck.clone(), cv.clone()
            out = decode_attention(q, kn, vn, kk, kvv, pos, pl)[0]
            pout = decode_attention_plain(q, kn, vn, pk, pv, pos, pl)
            tol = TOL["float32_attn" if dtype == torch.float32 else "bfloat16"]
            err = check_close(torch, f"decode {label}", out, pout, tol)
            if not (torch.equal(kk, pk) and torch.equal(kvv, pv)
                    and torch.equal(kk[:, pos], kn[:, 0]) and torch.equal(kvv[:, pos], vn[:, 0])
                    and torch.equal(kk[:, :pos], ck[:, :pos]) and torch.equal(kk[:, pos + 1:], ck[:, pos + 1:])
                    and torch.equal(kvv[:, :pos], cv[:, :pos]) and torch.equal(kvv[:, pos + 1:], cv[:, pos + 1:])):
                raise AssertionError(f"decode {label} {dtype}: in-place append wrote "
                                     f"other than row {pos}, or the wrong values")
            log(f"parity decode {label} {dtype} q{list(q.shape)} cache{list(ck.shape)} "
                f"pos {pos}: max_abs_err {err:.3g}, append exact")
            if label == "7B" and dtype == torch.bfloat16:
                main = (q, kn, vn, kk, kvv, pos, err)
    q, kn, vn, kk, kvv, pos, err = main
    cols = int(((pos - pads.long()).clamp(min=0) + 1).sum())  # + the new token
    es = q.element_size()
    b_ms, b_by = bound_ms(2 * (cols - BATCH) * h * d * es + 2 * q.numel() * es
                          + 4 * kn.numel() * es, 4 * h * d * cols, BF16_FLOPS)
    keep = (torch.arange(pos + 1, device=dev) >= pads[:, None, None, None]) | \
        (torch.arange(pos + 1, device=dev) == pos)
    qt, kt, vt = q.transpose(1, 2), kk[:, :pos + 1].transpose(1, 2), kvv[:, :pos + 1].transpose(1, 2)
    rows["decode_attention"] = dict(
        max_abs_err=err,
        ms=time_ms(torch, lambda: decode_attention(q, kn, vn, kk, kvv, pos, pads)),
        plain_ms=time_ms(torch, lambda: decode_attention_plain(q, kn, vn, kk, kvv, pos, pads)),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=time_ms(torch, lambda: sdpa(qt, kt, vt, attn_mask=keep)))
    # the host's share of a call bounds the wrapper's time at this shape
    # (PERF.md section 7): the device's own time, from torch.profiler
    dev_ms, split = device_ms(torch, lambda: decode_attention(q, kn, vn, kk, kvv, pos, pads))
    rows["decode_attention"]["device_ms"] = dev_ms
    log(f"time decode_attention at generate_batch's shape: device {dev_ms:.4f} ms "
        f"({split_line(split)}), {b_ms / dev_ms:.3f} of the bound")
    for name, r in rows.items():
        log(f"time {name}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
            f"library {r['library_ms']}, bound {r['bound_ms']:.4f} ms ({r['bound_by']})")
    return rows


QUANT_B, QUANT_C, QUANT_POS, QUANT_STEPS = 8, 4096, 4000, 32  # B8/B9 main path
FP8_SCALE = 0.5                # B9's static scale in the parity cases


def quant_caches(torch, gen, b, C, kv, d, kv_scale):
    """Quantized caches from seeded f32 rows: int8 [b, C, kv, d] with f32
    scale planes [b, kv, C], and e4m3 [b, C, kv, d] under ``kv_scale``."""
    from paddle_tpu_torch.serving.kv_quant import quantize_kv, quantize_kv_fp8

    out = []
    for _ in range(2):
        x = torch.randn(b, C, kv, d, generator=gen, device=gen.device)
        qx, sx = quantize_kv(x)
        out.append((qx, sx.transpose(1, 2).contiguous(), quantize_kv_fp8(2 * x, kv_scale)))
        del x
    (ck, ks, fk), (cv, vs, fv) = out
    return ck, cv, ks, vs, fk, fv


def quant_case(torch, label, q, kn, vn, ck, cv, ks, vs, fk, fv, pos, pads, kv_scale):
    """B8 and B9 against their plain twins on copies of the same caches:
    ``out`` within the dtype's tolerance, the row written at ``pos`` (int8
    values and scales, e4m3 bytes) bit-equal to the twin's, and every other
    row and scale untouched.  Returns the worst out error."""
    from paddle_tpu_torch.ops.decode_attention import (
        decode_attention_fp8, decode_attention_fp8_plain, decode_attention_int8,
        decode_attention_int8_plain)

    tol = TOL["float32_attn" if q.dtype == torch.float32 else "bfloat16"]
    k8 = [t.clone() for t in (ck, cv, ks, vs)]
    p8 = [t.clone() for t in (ck, cv, ks, vs)]
    got = decode_attention_int8(q, kn, vn, *k8, pos, pads)
    want = decode_attention_int8_plain(q, kn, vn, *p8, pos, pads)
    err = check_close(torch, f"decode_int8 {label}", got[0], want[0], tol)
    k9 = [fk.clone(), fv.clone()]
    p9 = [fk.clone(), fv.clone()]
    got9 = decode_attention_fp8(q, kn, vn, *k9, pos, pads, kv_scale=kv_scale)
    want9 = decode_attention_fp8_plain(q, kn, vn, *p9, pos, pads, kv_scale=kv_scale)
    err = max(err, check_close(torch, f"decode_fp8 {label}", got9[0], want9[0], tol))
    for name, k, p, orig, col in (
            ("int8 k", k8[0], p8[0], ck, 1), ("int8 v", k8[1], p8[1], cv, 1),
            ("k scale", k8[2], p8[2], ks, 2), ("v scale", k8[3], p8[3], vs, 2),
            ("fp8 k", k9[0], p9[0], fk, 1), ("fp8 v", k9[1], p9[1], fv, 1)):
        kb, pb, ob = (t.view(torch.uint8) if t.dtype == torch.float8_e4m3fn else t
                      for t in (k, p, orig))
        rest = [i for i in range(orig.shape[col]) if i != pos]
        if not torch.equal(kb, pb) or not torch.equal(kb.index_select(col, torch.tensor(
                rest, device=kb.device)), ob.index_select(col, torch.tensor(rest, device=kb.device))):
            raise AssertionError(f"decode quantized {label} {q.dtype}: {name} differs from "
                                 f"the plain twin's at pos {pos}, or another entry changed")
    log(f"parity decode_int8/fp8 {label} {q.dtype} q{list(q.shape)} cache{list(ck.shape)} "
        f"pos {pos}: max_abs_err {err:.3g}, appended rows and scales bit-equal")
    return err


def phase_quant_parity(torch):
    """B8 and B9 against their plain twins on the card, q in f32 and bf16:
    (a) Llama-2-7B at its 4096 context, batch 8, pos 4000; (b) Llama-2-70B's
    GQA (64 heads, 8 kv heads); (c) off sizes: C = 1000, d = 64 and 256,
    pos = 0, ragged pad_lens with a row whose pad >= pos, a non-power-of-two
    fp8 scale and new tokens that saturate e4m3.  Then the entry points'
    own path: QUANT_STEPS decode steps of B8 and of B9 at shape (a),
    counted; then times at (a) in bf16 beside B6 on a bf16 cache of the
    same shape.  Returns (rows, launches)."""
    from paddle_tpu_torch.ops import LAUNCHES, reset_launch_counts
    from paddle_tpu_torch.ops.decode_attention import (
        decode_attention, decode_attention_fp8, decode_attention_fp8_plain,
        decode_attention_int8, decode_attention_int8_plain)

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(3)

    def randn(*shape, dtype):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    def pads_of(*p):
        return torch.tensor(p, dtype=torch.int32, device=dev)

    b, C, d = QUANT_B, QUANT_C, 128
    cases = [  # label, b, h, kv, d, C, pos, pads, kv_scale, new-token amplitude
        ("7B", b, 32, 32, d, C, QUANT_POS, None, FP8_SCALE, 1.0),
        ("70B GQA", b, 64, 8, d, C, QUANT_POS, pads_of(*range(0, 800, 100)), FP8_SCALE, 1.0),
        ("C1000 d64 g6", 4, 12, 2, 64, 1000, 700, pads_of(0, 5, 333, 800), 0.37, 300.0),
        ("C1000 d256", 3, 4, 4, 256, 1000, 999, pads_of(0, 17, 999), FP8_SCALE, 1.0),
        ("C1000 d64 pos0", 2, 8, 4, 64, 1000, 0, pads_of(0, 3), 0.37, 1.0)]
    for label, bb, h, kv, hd, cl, pos, pl, kvs, amp in cases:
        caches = quant_caches(torch, gen, bb, cl, kv, hd, kvs)
        for dtype in (torch.float32, torch.bfloat16):
            q = randn(bb, 1, h, hd, dtype=dtype)
            kn, vn = (amp * randn(bb, 1, kv, hd, dtype=torch.float32)).to(dtype), \
                randn(bb, 1, kv, hd, dtype=dtype)
            err = quant_case(torch, label, q, kn, vn, *caches, pos, pl, kvs)
            if label == "7B" and dtype == torch.bfloat16:
                main_err = err
        del caches

    # the entry points' own path: decode steps at (a), launches counted
    h = kv = 32
    ck, cv, ks, vs, fk, fv = quant_caches(torch, gen, b, C, kv, d, FP8_SCALE)
    steps = [(randn(b, 1, h, d, dtype=torch.bfloat16), randn(b, 1, kv, d, dtype=torch.bfloat16),
              randn(b, 1, kv, d, dtype=torch.bfloat16)) for _ in range(QUANT_STEPS)]
    torch.cuda.synchronize()
    reset_launch_counts()
    outs = []
    for i, (q, kn, vn) in enumerate(steps):
        outs.append(decode_attention_int8(q, kn, vn, ck, cv, ks, vs, QUANT_POS + i)[0])
        outs.append(decode_attention_fp8(q, kn, vn, fk, fv, QUANT_POS + i,
                                         kv_scale=FP8_SCALE)[0])
    torch.cuda.synchronize()
    launches = dict(LAUNCHES)
    want = dict.fromkeys(LAUNCHES, 0)
    want.update(decode_attention_int8=QUANT_STEPS, decode_attention_fp8=QUANT_STEPS)
    log(f"quantized decode path, {QUANT_STEPS} steps from pos {QUANT_POS}: launches {launches}")
    if launches != want or not all(bool(torch.isfinite(o).all()) for o in outs):
        raise AssertionError(f"quantized decode path: launches {launches} (want {want}) "
                             f"or non-finite outputs")

    q, kn, vn = steps[0]
    pos, es = QUANT_POS, q.element_size()
    io = 2 * q.numel() * es + 2 * kn.numel() * es   # q in, out; k_new, v_new in
    ops = 4 * b * h * d * (pos + 1)
    rows = {}
    ck16, cv16 = randn(b, C, kv, d, dtype=torch.bfloat16), randn(b, C, kv, d, dtype=torch.bfloat16)
    b6_ms = time_ms(torch, lambda: decode_attention(q, kn, vn, ck16, cv16, pos))
    del ck16, cv16
    for name, nbytes, fn, plain in (
            ("decode_attention_int8", io + 2 * b * kv * (pos * d + 4 * pos + d + 4),
             lambda: decode_attention_int8(q, kn, vn, ck, cv, ks, vs, pos),
             lambda: decode_attention_int8_plain(q, kn, vn, ck, cv, ks, vs, pos)),
            ("decode_attention_fp8", io + 2 * b * kv * (pos * d + d),
             lambda: decode_attention_fp8(q, kn, vn, fk, fv, pos, kv_scale=FP8_SCALE),
             lambda: decode_attention_fp8_plain(q, kn, vn, fk, fv, pos, kv_scale=FP8_SCALE))):
        b_ms, b_by = bound_ms(nbytes, ops, INT8_OPS)
        rows[name] = dict(max_abs_err=main_err, ms=time_ms(torch, fn),
                          plain_ms=time_ms(torch, plain, iters=5, repeats=3),
                          bound_ms=b_ms, bound_by=b_by, library_ms=None)
        dev_ms, split = device_ms(torch, fn)
        log(f"time {name}: kernel {rows[name]['ms']:.4f} ms, plain {rows[name]['plain_ms']:.4f} "
            f"ms, library None, bound {b_ms:.4f} ms ({b_by}); B6 on a bf16 cache of the same "
            f"shape {b6_ms:.4f} ms; device {dev_ms:.4f} ms ({split_line(split)}), "
            f"{b_ms / dev_ms:.3f} of the bound")
    return rows, launches


def library_ln_bwd(torch, s, w, b, mu, rstd, dy):
    """The library's LayerNorm backward: dx, dw and db in one call, without
    the residual's + dpre (one tensor fewer to read).  aten on the card
    takes no f32 weight with bf16 x ("expected scalar type BFloat16"), so
    w and b come in x's dtype."""
    return torch.ops.aten.native_layer_norm_backward(
        dy, s, [s.shape[-1]], mu, rstd, w, b, [True, True, True])


def norm_bwd_times(torch):
    """B1b at [8192, 4096] bf16 and B11b at [8192, 2048] (bf16 x, f32 w,
    dpre given) beside the library's one call on the same inputs
    (``F.rms_norm``'s backward; ``native_layer_norm_backward`` with bf16 w):
    device time a call from ``torch.profiler``, each kernel of the call
    named, and the wrapper's time by CUDA events; printed, and returned as
    {kernel: (device ms, event ms, library device ms)}.  Callable alone
    after ``phase_build``."""
    from paddle_tpu_torch.ops.fused_ln_swiglu import fused_add_layer_norm_bwd
    from paddle_tpu_torch.ops.fused_norm import fused_rms_norm_bwd

    gen = torch.Generator(device="cuda").manual_seed(4)
    n = TRAIN_BATCH * TRAIN_SEQ

    def randn(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    x, dy = randn(n, 4096), randn(n, 4096)
    w, rstd = 1 + 0.1 * randn(4096), randn(n, 1, dtype=torch.float32).abs()
    xr, wr = x.clone().requires_grad_(), w.clone().requires_grad_()
    lib_out = torch.nn.functional.rms_norm(xr, (4096,), wr, 1e-5)
    s, dy2, dpre = randn(n, 2048), randn(n, 2048), randn(n, 2048)
    w2, b2 = 1 + 0.1 * randn(2048, dtype=torch.float32), 0.1 * randn(2048, dtype=torch.float32)
    mu = randn(n, 1, dtype=torch.float32)
    wl, bl = w2.to(s.dtype), b2.to(s.dtype)
    times = {}
    for name, fn, lib_name, lib in (
            ("rms_norm_bwd", lambda: fused_rms_norm_bwd(x, w, rstd, dy), "F.rms_norm bwd",
             lambda: torch.autograd.grad(lib_out, (xr, wr), dy, retain_graph=True)),
            ("add_layer_norm_bwd", lambda: fused_add_layer_norm_bwd(s, w2, mu, rstd, dy2, dpre),
             "native_layer_norm_backward (bf16 w, no dpre)",
             lambda: library_ln_bwd(torch, s, wl, bl, mu, rstd, dy2))):
        dev, split = device_ms(torch, fn)
        lib_dev, lib_split = device_ms(torch, lib)
        times[name] = (dev, time_ms(torch, fn), lib_dev)
        log(f"device {name} bf16: kernel {dev:.4f} ms ({split_line(split)}), events "
            f"{times[name][1]:.4f} ms; {lib_name} {lib_dev:.4f} ms ({split_line(lib_split)})")
    return times


# B1b's cases: the Llama training rows, then h not a multiple of 8
# (single-element slots), fewer rows than the persistent grid, rows wider
# than one 8192-column segment
RMS_BWD_SHAPES = ((TRAIN_BATCH * TRAIN_SEQ, 4096), (64, 1000), (64, 1001), (1, 4096),
                  (3, 4096), (32, 12288), (16, 20001))
# B11/B11b's: GPT-3 1.3B's rows, then the same kinds of off size and h
# above the 29056 columns that a shared-memory row allowed
ADD_LN_SHAPES = ((TRAIN_BATCH * TRAIN_SEQ, 2048), (64, 1000), (64, 1001), (1, 2048),
                 (3, 2048), (32, 12289), (16, 40000))


def phase_rms_norm_bwd(torch):
    """B1b against its plain backward on the card, in f32 and bf16, at the
    Llama training rows (x [8192, 4096]) and at off sizes; each case
    launched twice must give the same bits.  Then its time beside the plain
    twin and ``F.rms_norm``'s backward, by CUDA events around the wrapper
    (``norm_bwd_times`` takes the device time)."""
    from paddle_tpu_torch.ops.fused_norm import (fused_rms_norm, fused_rms_norm_bwd,
                                                 rms_norm_bwd_plain)

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)

    def randn(*shape, dtype):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    b, s, hidden = TRAIN_BATCH, TRAIN_SEQ, 4096
    rows = {}
    for shape in RMS_BWD_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            x = randn(*shape, dtype=dtype)
            w = (1 + 0.1 * randn(shape[-1], dtype=torch.float32)).to(dtype)
            dy = randn(*shape, dtype=dtype)
            _, rstd = fused_rms_norm(x, w, 1e-5)
            (dx, dw), (pdx, pdw) = (fused_rms_norm_bwd(x, w, rstd, dy),
                                    rms_norm_bwd_plain(x, w, rstd, dy))
            again = fused_rms_norm_bwd(x, w, rstd, dy)
            if not (torch.equal(dx, again[0]) and torch.equal(dw, again[1])):
                raise AssertionError(f"rms_norm_bwd {dtype} {list(shape)}: two launches differ")
            tol = TOL[str(dtype).split(".")[1]]
            # dw sums dy * x^ over all rows: bounded by the sum of |terms|
            terms = (dy.float() * x.float() * rstd).abs().sum(0)
            err = max(check_close(torch, "rms_norm_bwd dx", dx, pdx, tol),
                      check_sum_close(torch, "rms_norm_bwd dw", dw, pdw, terms))
            log(f"parity rms_norm_bwd {dtype} x{list(x.shape)}: max_abs_err {err:.3g}; "
                f"two launches bit-equal")
            if shape[0] == b * s and dtype == torch.bfloat16:
                main = (x, w, rstd, dy, err)
            del x, w, rstd, dy, dx, dw, pdx, pdw, again
    x, w, rstd, dy, err = main
    es = x.element_size()
    b_ms, b_by = bound_ms(3 * x.numel() * es + 2 * w.numel() * es + x.shape[0] * 4,
                          8 * x.numel(), F32_FLOPS)
    xr, wr = x.clone().requires_grad_(), w.clone().requires_grad_()
    lib_out = torch.nn.functional.rms_norm(xr, (hidden,), wr, 1e-5)
    rows["rms_norm_bwd"] = dict(
        max_abs_err=err, ms=time_ms(torch, lambda: fused_rms_norm_bwd(x, w, rstd, dy)),
        plain_ms=time_ms(torch, lambda: rms_norm_bwd_plain(x, w, rstd, dy)),
        bound_ms=b_ms, bound_by=b_by, library_ms=time_ms(torch, lambda: torch.autograd.grad(
            lib_out, (xr, wr), dy, retain_graph=True), iters=5, repeats=3))
    return rows


def phase_bwd_parity(torch):
    """Each backward kernel against its plain backward on the card, in f32
    and bf16, at the training path's shapes (Llama-2-7B width, batch 4 x
    2048; GPT-3 1.3B's 16 heads), at Llama-2-70B's GQA attention, at the
    ring's hop shapes (4096 rows, causal and not) and at off-size attention
    shapes (d 64, 72, 160, 200, 256, with GQA 8:1 at 160 and 256, sq < sk
    and a last query tile of one row at 256); B3b/B3c launched twice must
    give the same bits, B3b's delta too at head_dim > 128.
    Then times in bf16 at the main shape, and B3b/B3c's at GPT-3 1.3B's
    shape and the hop shapes (the ``shapes`` entry of their rows), then in
    f32 at the training shape and ERNIE's and in bf16 at head_dim 256."""
    from paddle_tpu_torch.models.llama import _rope_tables
    from paddle_tpu_torch.ops.flash_attention import (
        flash_attention_bwd, flash_attention_bwd_dkv, flash_attention_bwd_dq,
        flash_attention_bwd_plain, flash_attention_fwd)
    from paddle_tpu_torch.ops.rope import fused_rope_bwd, rope_plain

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def randn(*shape, dtype):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    def backward_ms(outs, ins, grads):
        return time_ms(torch, lambda: torch.autograd.grad(outs, ins, grads,
                                                          retain_graph=True),
                       iters=5, repeats=3)

    b, s, h, d = TRAIN_BATCH, TRAIN_SEQ, 32, 128
    rows = phase_rms_norm_bwd(torch)

    # B2 backward: the rope kernel rotating by -theta
    cos, sin = (t.to(dev) for t in _rope_tables(d, 4096, 10000.0))
    pos_ids = torch.arange(s, device=dev, dtype=torch.int32)[None, :].expand(b, s).contiguous()
    for dtype in (torch.float32, torch.bfloat16):
        gq, gk = randn(b, s, h, d, dtype=dtype), randn(b, s, h, d, dtype=dtype)
        (oq, ok), (pq, pk) = (fused_rope_bwd(gq, gk, cos, sin, pos_ids),
                              rope_plain(gq, gk, cos, sin, pos_ids, sin_sign=-1.0))
        tol = TOL[str(dtype).split(".")[1]]
        err = max(check_close(torch, "rope_bwd dq", oq, pq, tol),
                  check_close(torch, "rope_bwd dk", ok, pk, tol))
        log(f"parity rope_bwd {dtype} q{list(gq.shape)}: max_abs_err {err:.3g}")
    b_ms, b_by = bound_ms(2 * (gq.numel() + gk.numel()) * gq.element_size()
                          + pos_ids.numel() * 4 + 2 * s * d * 4,
                          3 * (gq.numel() + gk.numel()), F32_FLOPS)
    rows["rope_bwd"] = dict(
        max_abs_err=err, ms=time_ms(torch, lambda: fused_rope_bwd(gq, gk, cos, sin, pos_ids)),
        plain_ms=time_ms(torch, lambda: rope_plain(gq, gk, cos, sin, pos_ids, sin_sign=-1.0)),
        bound_ms=b_ms, bound_by=b_by, library_ms=None)
    del gq, gk, oq, ok, pq, pk

    # B3b / B3c: the training shape, 70B GQA (B3c's group sum), off-size
    # shapes (d 72, 160, 200 and 256), GPT-3 1.3B's shape, the ring's two hop shapes
    # at cp 4 (a "diag" hop is causal, a "full" one is not) and a ragged d 64
    # GQA case; two launches of the kernels must agree bit for bit
    # (label, b, sq, sk, q heads, kv heads, head_dim, causal)
    cases = [("causal 7B", b, s, s, h, h, d, True), ("causal 70B GQA", 1, s, s, 64, 8, d, True),
             ("causal d72 s300", 2, 300, 300, 4, 2, 72, True),
             ("causal d256 s200", 1, 200, 200, 2, 1, 256, True),
             # bwd_dkv_wide's group sum over 8 q heads; d 200 not causal
             ("causal d256 GQA 8:1", 2, 300, 300, 8, 1, 256, True),
             ("full d200 s300", 2, 300, 300, 4, 2, 200, False),
             # B3b's edges at d 256: sq < sk, both ragged, with the causal
             # offset; one live row in the last query tile; d 160 GQA 8:1
             ("causal d256 sq136 sk264 GQA 4:1", 2, 136, 264, 8, 2, 256, True),
             ("causal d256 s65", 2, 65, 65, 4, 2, 256, True),
             ("full d160 s300 GQA 8:1", 2, 300, 300, 8, 1, 160, False),
             # phase_train_d256's attention: 16 heads of 256 over 4 x 2048
             ("causal d256 train", b, s, s, 16, 16, 256, True),
             ("causal GPT-3 1.3B", b, s, s, 16, 16, d, True),
             ("ring hop diag", 1, 4096, 4096, h, h, d, True),
             ("ring hop full", 1, 4096, 4096, h, h, d, False),
             ("causal d64 s1000 GQA", 2, 1000, 1000, 8, 2, 64, True),
             ("ERNIE 3.0 base full", ERNIE_BATCH, ERNIE_SEQ, ERNIE_SEQ, 12, 12, 64, False)]
    timed, timed32 = {}, {}  # bf16 and f32 inputs of the shapes timed below
    for label, bb, sq, sk, hq, hkv, hd, causal in cases:
        for dtype in (torch.float32, torch.bfloat16):
            q = randn(bb, sq, hq, hd, dtype=dtype)
            k, v = randn(bb, sk, hkv, hd, dtype=dtype), randn(bb, sk, hkv, hd, dtype=dtype)
            out, lse = flash_attention_fwd(q, k, v, causal)
            do = randn(bb, sq, hq, hd, dtype=dtype)
            got = flash_attention_bwd(q, k, v, out, lse, do, causal)
            again = flash_attention_bwd(q, k, v, out, lse, do, causal)
            if not all(torch.equal(g, a) for g, a in zip(got, again)):
                raise AssertionError(f"flash bwd {label} {dtype}: two launches differ")
            want = flash_attention_bwd_plain(q, k, v, out, lse, do, causal)
            tol = TOL["float32_attn_bwd" if dtype == torch.float32 else "bfloat16"]
            errs = [check_close(torch, f"flash bwd {label} {n}", g, w_, tol)
                    for n, g, w_ in zip(("dq", "dk", "dv"), got, want)]
            extra = ""
            if hd > 128:  # B3b's delta too: bit-equal across launches, and the plain rowsum
                deltas = [flash_attention_bwd_dq(q, k, v, out, lse, do, causal)[1]
                          for _ in range(2)]
                if not torch.equal(*deltas):
                    raise AssertionError(f"flash bwd {label} {dtype}: two deltas differ")
                err = check_close(torch, f"flash bwd {label} delta", deltas[0],
                                  (do.float() * out.float()).sum(-1).transpose(1, 2),
                                  TOL["float32_attn"])
                extra = f" delta {err:.3g}"
            log(f"parity flash bwd {label} {dtype} q{list(q.shape)} sk{sk} kv{hkv}"
                f"{'' if causal else ' full'}: max_abs_err dq {errs[0]:.3g} dk {errs[1]:.3g} "
                f"dv {errs[2]:.3g}{extra}; two launches bit-equal")
            if dtype == torch.bfloat16 and label in ("causal 7B", "causal GPT-3 1.3B",
                                                     "ring hop diag", "ring hop full",
                                                     "ERNIE 3.0 base full"):
                timed[label] = (q, k, v, out, lse, do, causal, errs)
            if dtype == torch.float32 and label in ("causal 7B", "ERNIE 3.0 base full"):
                timed32[label] = (q, k, v, out, lse, do, causal, errs)
            del q, k, v, out, lse, do, got, again, want
            torch.cuda.empty_cache()

    def bounds(q, causal):
        """(bound ms, bound by, floor ms) of B3b and of B3c on q's shape, at
        the peak of q's dtype (f32 outside the tensor cores, or bf16); the
        floor, in f32 only (else None), counts each f32 product as three
        TF32 products on the tensor cores, as the f32 kernels do them."""
        bb, sq, hq, hd = q.shape
        pairs = bb * hq * sq * (sq + 1) // 2 if causal else bb * hq * sq * sq
        io, lse_bytes = q.numel() * q.element_size(), bb * hq * sq * 4
        f32 = q.dtype == torch.float32
        out = []
        # B3b: q k v out dout in, dq out, lse in, delta out; 3 products a pair.
        # B3c: q k v dout lse delta in, dk dv out; 4 products a pair.
        for nbytes, products in ((5 * io + 2 * lse_bytes, 3), (6 * io + 2 * lse_bytes, 4)):
            ops = products * 2 * hd * pairs
            out.append((*bound_ms(nbytes, ops, F32_FLOPS if f32 else BF16_FLOPS),
                        bound_ms(nbytes, 3 * ops, TF32_FLOPS)[0] if f32 else None))
        return out

    def kernel_fns(q, k, v, out, lse, do, causal):
        _, delta = flash_attention_bwd_dq(q, k, v, out, lse, do, causal)
        return (lambda: flash_attention_bwd_dq(q, k, v, out, lse, do, causal),
                lambda: flash_attention_bwd_dkv(q, k, v, do, lse, delta, causal))

    names = ("flash_attention_bwd_dq", "flash_attention_bwd_dkv")
    q, k, v, out, lse, do, _, errs = timed.pop("causal 7B")
    plain = time_ms(torch, lambda: flash_attention_bwd_plain(q, k, v, out, lse, do, True),
                    iters=3, repeats=3)
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v))
    lib_out = sdpa(qt, kt, vt, is_causal=True)
    library = backward_ms(lib_out, (qt, kt, vt), do.transpose(1, 2))
    del lib_out, qt, kt, vt
    for name, (b_ms, b_by, _), err, fn in zip(names, bounds(q, True), (errs[0], max(errs[1:])),
                                               kernel_fns(q, k, v, out, lse, do, True)):
        rows[name] = dict(max_abs_err=err, ms=time_ms(torch, fn, iters=5, repeats=3),
                          plain_ms=plain, bound_ms=b_ms, bound_by=b_by, library_ms=library,
                          shapes={})
    # the same kernels at GPT-3 1.3B's training shape, the ring's hop shapes
    # and ERNIE 3.0 base's attention (there beside SDPA's whole backward)
    for label, (q, k, v, out, lse, do, causal, _) in timed.items():
        shape = f"{list(q.shape)} {'causal' if causal else 'full'}"
        library = None
        if label.startswith("ERNIE"):
            qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v))
            lib_out = sdpa(qt, kt, vt)
            library = backward_ms(lib_out, (qt, kt, vt), do.transpose(1, 2))
            del lib_out, qt, kt, vt
        for name, (b_ms, b_by, _), fn in zip(names, bounds(q, causal),
                                             kernel_fns(q, k, v, out, lse, do, causal)):
            ms = time_ms(torch, fn, iters=5, repeats=3)
            rows[name]["shapes"][shape] = dict(ms=ms, bound_ms=b_ms, bound_by=b_by,
                                               library_ms=library)
            log(f"time {name} {label} {shape} bf16: kernel {ms:.4f} ms, bound {b_ms:.4f} ms "
                f"({b_by}), SDPA's whole backward {library}")
    del timed, q, k, v, out, lse, do
    torch.cuda.empty_cache()
    # f32 inputs (the 3xTF32 kernels of the default dtype's training) at the
    # training shape and ERNIE's, and bf16 at head_dim 256 (bwd_dq_wg<256> and
    # bwd_dkv_wide, phase_train_d256's) at D256_SHAPE, causal; each beside
    # SDPA's whole backward in the same dtype, with the kernels that SDPA
    # runs, and the card's clocks
    bb, s256, h256, d256 = D256_SHAPE
    q = randn(bb, s256, h256, d256, dtype=torch.bfloat16)
    k, v, do = (randn(bb, s256, h256, d256, dtype=torch.bfloat16) for _ in range(3))
    out, lse = flash_attention_fwd(q, k, v, True)
    timed32["d256 bf16"] = (q, k, v, out, lse, do, True, None)
    for label, (q, k, v, out, lse, do, causal, _) in timed32.items():
        dtype = str(q.dtype).split(".")[1]
        shape = f"{list(q.shape)} {'causal' if causal else 'full'} {dtype}"
        qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v))
        lib_out = sdpa(qt, kt, vt, is_causal=causal)
        library = backward_ms(lib_out, (qt, kt, vt), do.transpose(1, 2))
        _, by = device_ms(torch, lambda: torch.autograd.grad(
            lib_out, (qt, kt, vt), do.transpose(1, 2), retain_graph=True), iters=2, warmup=1)
        log(f"time SDPA's whole backward {label} {shape}: {library:.4f} ms; device ms by "
            f"kernel: {split_line(by)}")
        del lib_out, qt, kt, vt
        plain = time_ms(torch, lambda: flash_attention_bwd_plain(q, k, v, out, lse, do, causal),
                        iters=2, repeats=3, warmup=1)
        log(f"time plain flash backward {label} {shape}: {plain:.4f} ms")
        pair = 0.0
        for name, (b_ms, b_by, floor), fn in zip(names, bounds(q, causal),
                                                 kernel_fns(q, k, v, out, lse, do, causal)):
            ms = time_ms(torch, fn, iters=5, repeats=3, warmup=2)
            pair += ms
            rows[name]["shapes"][shape] = dict(ms=ms, bound_ms=b_ms, bound_by=b_by,
                                               library_ms=library, plain_ms=plain)
            extra = ""
            if floor is not None:
                rows[name]["shapes"][shape]["tf32_floor_ms"] = floor
                extra = f", 3xTF32 floor {floor:.4f} ms ({ms / floor:.2f}x)"
            log(f"time {name} {label} {shape}: kernel {ms:.4f} ms, bound {b_ms:.4f} ms "
                f"({b_by}), {ms / b_ms:.2f}x the bound{extra}, SDPA's whole backward "
                f"{library:.4f}")
        log(f"time flash bwd pair {label} {shape}: {pair:.4f} ms against SDPA's whole "
            f"backward {library:.4f} ({pair / library:.2f}x); clocks {gpu_clocks()}")
        torch.cuda.empty_cache()
    del timed32, q, k, v, out, lse, do
    for name, r in rows.items():
        log(f"time {name}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
            f"library {r['library_ms']}, bound {r['bound_ms']:.4f} ms ({r['bound_by']})")
    return rows


RING_CASES = (  # label, b, s, q heads, kv heads, head_dim, ring members (cp)
    ("7B cp4", 1, 16384, 32, 32, 128, 4),       # Llama-2-7B attention width
    ("70B GQA cp2", 1, 8192, 64, 8, 128, 2),    # Llama-2-70B's GQA
    ("b2 cp2", 2, 2048, 32, 8, 128, 2),         # b = 2: strided chunks, copied
)


def ring_launches(n, causal, bwd=False):
    """Exact launches of one ring over ``n`` members: a flash kernel (and a
    merge) per hop that is not skipped."""
    hops = n * (n + 1) // 2 if causal else n * n
    if bwd:
        return dict(flash_attention_bwd_dq=hops, flash_attention_bwd_dkv=hops)
    return dict(flash_attention=hops, ring_merge=hops)


def ring_fwd(torch, q, k, v, mesh, causal):
    """The ring through its entry point, ``context_parallel.ring_attention``
    over ``mesh``'s sep ring, on leaf copies of q, k, v that want grads:
    (leaves, out, lse), the lse [b, hq, s] from the chunks the ring's
    autograd Function saved for its backward."""
    from paddle_tpu_torch.distributed.meta_parallel import ring_attention

    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    out = ring_attention(*leaves, mesh=mesh, causal=causal)
    n = mesh.shape["sep"]
    return leaves, out, torch.cat(out.grad_fn.saved_tensors[4 * n:], dim=2)


def phase_ring_parity(torch):
    """B10 on the card, its ``n`` ring members on the one card, through
    ``context_parallel.ring_attention`` and autograd as a user calls it: the
    kernel ring (B3 and the merge kernel per hop forward, B3b/B3c per hop
    backward) against the same ring over the plain twins, and against one
    call of B3 (B3b/B3c) over the whole sequence, in f32 and bf16, causal
    and not, forward and the three grads, at Llama-2-7B's attention width
    (cp 4), Llama-2-70B's GQA (cp 2) and a b = 2 case.  Each ring's launches
    and chunk copies are counted exactly.  Then times at the 7B cp 4 shape
    in bf16 (causal): the ring forward (no grad, as the CP prefill runs it)
    and backward against the plain ring, the bound and SDPA over the whole
    sequence, and one merge at the ring's chunk shape."""
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.distributed.meta_parallel import ring_attention
    from paddle_tpu_torch.distributed.topology import build_mesh
    from paddle_tpu_torch.ops import LAUNCHES, reset_launch_counts
    from paddle_tpu_torch.ops.flash_attention import flash_attention_bwd, flash_attention_fwd
    from paddle_tpu_torch.ops.ring_flash import COPIES, ring_merge, ring_merge_plain

    dev = torch.device("cuda", torch.cuda.current_device())
    gen = torch.Generator(device=dev).manual_seed(2)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    plain = dict(use_flash_attention=False)

    def randn(*shape, dtype):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    def counted(want, fn):
        torch.cuda.synchronize()
        reset_launch_counts()
        result = fn()
        torch.cuda.synchronize()
        got = {k: c for k, c in LAUNCHES.items() if c}
        if got != want:
            raise AssertionError(f"ring launches {got}, want {want}")
        return result

    def rel(a, b):
        return float((a.float() - b.float()).norm() / b.float().norm())

    for label, b, s, hq, hkv, d, n in RING_CASES:
        mesh = build_mesh(sep=n, devices=[dev] * n)
        for dtype in (torch.float32, torch.bfloat16):
            f32 = dtype == torch.float32
            for causal in (True, False):
                q = randn(b, s, hq, d, dtype=dtype)
                k, v = randn(b, s, hkv, d, dtype=dtype), randn(b, s, hkv, d, dtype=dtype)
                do = randn(b, s, hq, d, dtype=dtype)
                copies = dict(COPIES)
                leaves, out, lse = counted(ring_launches(n, causal),
                                           lambda: ring_fwd(torch, q, k, v, mesh, causal))
                grads = counted(ring_launches(n, causal, bwd=True),
                                lambda: torch.autograd.grad(out, leaves, do))
                # b > 1: q, k, v and the output gradient are split by copies
                want_copies = 4 * n if b > 1 else 0
                if COPIES["chunk"] - copies["chunk"] != want_copies or COPIES["peer"] != copies["peer"]:
                    raise AssertionError(f"ring {label}: {COPIES} after {copies}, want "
                                         f"{want_copies} chunk copies and no peer copy")
                with ptt.flag_guard(**plain):
                    p_leaves, p_out, p_lse = counted(
                        {}, lambda: ring_fwd(torch, q, k, v, mesh, causal))
                    p_grads = counted({}, lambda: torch.autograd.grad(p_out, p_leaves, do))
                del p_leaves
                tol = TOL["float32_attn" if f32 else "bfloat16"]
                btol = TOL["float32_attn_bwd" if f32 else "bfloat16"]
                err = check_close(torch, f"ring {label} out", out, p_out, tol)
                check_close(torch, f"ring {label} lse", lse, p_lse, TOL["float32_attn"])
                gerr = [check_close(torch, f"ring {label} d{x}", g, pg, btol)
                        for x, g, pg in zip("qkv", grads, p_grads)]
                del p_out, p_lse, p_grads
                # the ring against one flash call over the whole sequence
                w_out, w_lse = flash_attention_fwd(q, k, v, causal)
                w_grads = flash_attention_bwd(q, k, v, w_out, w_lse, do, causal)
                check_close(torch, f"ring {label} lse vs B3", lse, w_lse, TOL["float32_attn"])
                if f32:
                    check_close(torch, f"ring {label} vs B3", out, w_out, tol)
                    for x, g, wg in zip("qkv", grads, w_grads):
                        check_close(torch, f"ring {label} d{x} vs B3b/B3c", g, wg, btol)
                    whole = "f32 within the parity rows"
                else:
                    dists = [rel(out, w_out)] + [rel(g, wg) for g, wg in zip(grads, w_grads)]
                    if not max(dists) <= LOGITS_REL_TOL:
                        raise AssertionError(f"ring {label} bf16 vs whole-sequence kernels: "
                                             f"relative L2 out, dq, dk, dv {dists}")
                    whole = "relative L2 out/dq/dk/dv " + " ".join(f"{x:.3g}" for x in dists)
                log(f"parity ring {label} {dtype} {'causal' if causal else 'full'} "
                    f"q{list(q.shape)} kv{hkv}: max_abs_err vs plain ring out {err:.3g} dq "
                    f"{gerr[0]:.3g} dk {gerr[1]:.3g} dv {gerr[2]:.3g}; vs whole-sequence "
                    f"B3/B3b/B3c: {whole}")
                if label == "7B cp4" and dtype == torch.bfloat16 and causal:
                    main = (q, k, v, do, err, gerr)
                del q, k, v, do, leaves, out, lse, w_out, w_lse, w_grads, grads
                torch.cuda.empty_cache()

    # times at the 7B cp 4 shape, bf16, causal
    q, k, v, do, err, gerr = main
    b, s, hq, d = q.shape
    n = 4
    mesh = build_mesh(sep=n, devices=[dev] * n)

    def forward():
        with torch.no_grad():
            return ring_attention(q, k, v, mesh=mesh, causal=True)

    leaves, out, _ = ring_fwd(torch, q, k, v, mesh, True)
    pairs = b * hq * s * (s + 1) // 2
    io = q.numel() * q.element_size()
    rows = {}
    # forward: q, k, v read, out written, lse; 2 products (QK^T, PV) a pair
    b_ms, b_by = bound_ms(4 * io + b * hq * s * 4, 4 * d * pairs, BF16_FLOPS)
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v))
    with ptt.flag_guard(**plain):
        plain_fwd = time_ms(torch, forward, iters=2, repeats=3)
        p_leaves, p_out, _ = ring_fwd(torch, q, k, v, mesh, True)
        plain_bwd = time_ms(torch, lambda: torch.autograd.grad(p_out, p_leaves, do,
                                                               retain_graph=True),
                            iters=1, repeats=3)
        del p_leaves, p_out
    lib_out = sdpa(qt, kt, vt, is_causal=True)
    rows["ring_flash_attention"] = dict(
        max_abs_err=max(err, *gerr), ms=time_ms(torch, forward, iters=5, repeats=3),
        plain_ms=plain_fwd, bound_ms=b_ms, bound_by=b_by,
        library_ms=time_ms(torch, lambda: sdpa(qt, kt, vt, is_causal=True), iters=5, repeats=3),
        bwd_ms=time_ms(torch, lambda: torch.autograd.grad(out, leaves, do, retain_graph=True),
                       iters=2, repeats=3),
        bwd_plain_ms=plain_bwd,
        # backward: q, k, v, out, dout read, dq, dk, dv written, lse; 5
        # products a pair (S recomputed, dP, dV, dQ, dK)
        bwd_bound_ms=bound_ms(8 * io + b * hq * s * 4, 5 * 2 * d * pairs, BF16_FLOPS)[0],
        bwd_library_ms=time_ms(torch, lambda: torch.autograd.grad(
            lib_out, (qt, kt, vt), do.transpose(1, 2), retain_graph=True), iters=2, repeats=3))
    log(f"time ring_flash_attention {list(q.shape)} bf16 causal cp {n}: forward kernel ring "
        f"{rows['ring_flash_attention']['ms']:.4f} ms, plain ring {plain_fwd:.4f} ms, SDPA whole "
        f"sequence {rows['ring_flash_attention']['library_ms']:.4f} ms, bound {b_ms:.4f} ms "
        f"({b_by}); backward kernel ring {rows['ring_flash_attention']['bwd_ms']:.4f} ms, plain "
        f"ring {plain_bwd:.4f} ms, SDPA backward "
        f"{rows['ring_flash_attention']['bwd_library_ms']:.4f} ms, bound "
        f"{rows['ring_flash_attention']['bwd_bound_ms']:.4f} ms; whole-sequence B3 "
        f"{time_ms(torch, lambda: flash_attention_fwd(q, k, v, True), iters=5, repeats=3):.4f} ms")
    del lib_out, qt, kt, vt, leaves, out

    # one merge at the ring's chunk shape: running o f32, o_i bf16 as B3 gives it
    c = s // n
    o0 = randn(b, c, hq, d, dtype=torch.float32)
    l0 = randn(b, hq, c, dtype=torch.float32)
    o_i = randn(b, c, hq, d, dtype=torch.bfloat16)
    l_i = randn(b, hq, c, dtype=torch.float32)
    l0[0, 0, :7] = float("-inf")          # rows with no live key yet
    l_i[0, 1, :5] = float("-inf")
    l0[0, 2, :3] = l_i[0, 2, :3] = float("-inf")
    merrs = []
    for dtype in (torch.float32, torch.bfloat16):
        oi = o_i.to(dtype)
        got = ring_merge(o0.clone(), l0.clone(), oi, l_i)
        want = ring_merge_plain(o0.clone(), l0.clone(), oi, l_i)
        merrs.append(check_close(torch, "ring_merge o", got[0], want[0], TOL["float32"]))
        check_close(torch, "ring_merge lse", got[1], want[1], TOL["float32"])
        if not torch.equal(got[1].isneginf(), want[1].isneginf()):
            raise AssertionError("ring_merge: rows with lse -inf differ from the plain twin")
        log(f"parity ring_merge o_i {dtype} o{list(o0.shape)}: max_abs_err {merrs[-1]:.3g}")
    ob, lb = o0.clone(), l0.clone()
    nbytes = 2 * o0.numel() * 4 + o_i.numel() * 2 + 3 * l0.numel() * 4
    b_ms, b_by = bound_ms(nbytes, 6 * o0.numel(), F32_FLOPS)
    rows["ring_merge"] = dict(
        max_abs_err=max(merrs), ms=time_ms(torch, lambda: ring_merge(ob, lb, o_i, l_i)),
        plain_ms=time_ms(torch, lambda: ring_merge_plain(ob, lb, o_i, l_i)),
        bound_ms=b_ms, bound_by=b_by, library_ms=None)
    log(f"time ring_merge o{list(o0.shape)} o_i bf16: kernel {rows['ring_merge']['ms']:.4f} ms, "
        f"plain {rows['ring_merge']['plain_ms']:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
    return rows


def phase_add_layer_norm(torch):
    """B11 and B11b against their plain twins on the card: x in f32 and
    bf16, w in f32 (AMP O2's LayerNorm) and bf16, at GPT-3 1.3B's hidden at
    the training batch (x [8192, 2048]) and at off sizes; B11b with dpre
    and without, each case launched twice with the same bits.  Then times
    in the main path's dtypes (bf16 x, f32 w), B11b's beside
    ``native_layer_norm_backward`` (``norm_bwd_times`` takes the device
    time)."""
    from paddle_tpu_torch.ops.fused_ln_swiglu import (
        add_layer_norm_bwd_plain, add_layer_norm_plain, fused_add_layer_norm,
        fused_add_layer_norm_bwd)

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(3)
    f32, bf16 = torch.float32, torch.bfloat16

    def randn(*shape, dtype=f32):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    def tol(dtype):
        return TOL[str(dtype).split(".")[1]]

    rows = {}
    b, s, hidden = TRAIN_BATCH, TRAIN_SEQ, 2048
    for shape in ADD_LN_SHAPES:
        for dtype, wdtype in ((f32, f32), (bf16, bf16), (bf16, f32)):
            h = shape[-1]
            x, r = randn(*shape, dtype=dtype), randn(*shape, dtype=dtype)
            w, bias = (1 + 0.1 * randn(h)).to(wdtype), (0.1 * randn(h)).to(wdtype)
            got, want = fused_add_layer_norm(x, r, w, bias), add_layer_norm_plain(x, r, w, bias)
            err = max(check_close(torch, "add_layer_norm out", got[0], want[0], tol(dtype)),
                      check_close(torch, "add_layer_norm sum", got[1], want[1], tol(dtype)))
            for nm, k, p in zip(("mu", "rstd"), got[2:], want[2:]):
                check_close(torch, f"add_layer_norm {nm}", k.flatten(), p.flatten(),
                            TOL["float32"])
            sm, mu, rstd = got[1:]
            dy, dpre = randn(*shape, dtype=dtype), randn(*shape, dtype=dtype)
            kb = fused_add_layer_norm_bwd(sm, w, mu, rstd, dy, dpre)
            pb = add_layer_norm_bwd_plain(sm, w, mu, rstd, dy, dpre)
            again = fused_add_layer_norm_bwd(sm, w, mu, rstd, dy, dpre)
            if not all(torch.equal(k, a) for k, a in zip(kb, again)):
                raise AssertionError(f"add_layer_norm_bwd x {dtype} w {wdtype} {list(shape)}: "
                                     f"two launches differ")
            xhat = (sm.float() - mu) * rstd
            errb = max(check_close(torch, "add_layer_norm_bwd dx", kb[0], pb[0], tol(dtype)),
                       check_sum_close(torch, "add_layer_norm_bwd dw", kb[1], pb[1],
                                       (dy.float() * xhat).abs().sum(0)),
                       check_sum_close(torch, "add_layer_norm_bwd db", kb[2], pb[2],
                                       dy.float().abs().sum(0)))
            nodp = fused_add_layer_norm_bwd(sm, w, mu, rstd, dy, None)
            check_close(torch, "add_layer_norm_bwd dx, no dpre", nodp[0],
                        add_layer_norm_bwd_plain(sm, w, mu, rstd, dy, None)[0], tol(dtype))
            # dw and db do not read dpre: the same bits without it
            if not (torch.equal(nodp[1], kb[1]) and torch.equal(nodp[2], kb[2])):
                raise AssertionError(f"add_layer_norm_bwd {list(shape)}: dw, db move with dpre")
            log(f"parity add_layer_norm x {dtype} w {wdtype} {list(shape)}: max_abs_err "
                f"fwd {err:.3g} bwd {errb:.3g}; two launches bit-equal")
            if shape[0] == b * s and wdtype == f32 and dtype == bf16:
                main = (x, r, w, bias, sm, mu, rstd, dy, dpre, err, errb)
            del x, r, dy, dpre, got, want, kb, pb, nodp, xhat, again
    x, r, w, bias, sm, mu, rstd, dy, dpre, err, errb = main
    n, es, rws = x.numel(), x.element_size(), x.shape[0]
    wb = 2 * w.numel() * w.element_size()
    for name, nbytes, ops, e, fn, plain in (
            ("add_layer_norm", 4 * n * es + wb + 2 * rws * 4, 8 * n, err,
             lambda: fused_add_layer_norm(x, r, w, bias),
             lambda: add_layer_norm_plain(x, r, w, bias)),
            ("add_layer_norm_bwd", 4 * n * es + 3 * wb // 2 + 2 * rws * 4, 12 * n, errb,
             lambda: fused_add_layer_norm_bwd(sm, w, mu, rstd, dy, dpre),
             lambda: add_layer_norm_bwd_plain(sm, w, mu, rstd, dy, dpre))):
        b_ms, b_by = bound_ms(nbytes, ops, F32_FLOPS)
        rows[name] = dict(max_abs_err=e, ms=time_ms(torch, fn), plain_ms=time_ms(torch, plain),
                          bound_ms=b_ms, bound_by=b_by, library_ms=None)
    wl, bl = w.to(sm.dtype), bias.to(sm.dtype)
    rows["add_layer_norm_bwd"]["library_ms"] = time_ms(
        torch, lambda: library_ln_bwd(torch, sm, wl, bl, mu, rstd, dy))
    return rows


def phase_fused_parity(torch):
    """B4 (SwiGLU fwd and bwd), B5 (AdamW) and B11/B11b (residual add +
    LayerNorm fwd and bwd) against their plain twins on the card, in f32
    and bf16, at the training path's shapes (Llama-2-7B's MLP at 4 x 2048;
    GPT-3 1.3B's hidden at 4 x 2048, bf16 x with f32 w as AMP O2 gives it)
    and at off sizes (H = 1000 and 1001, a flat AdamW length not a
    multiple of 8); then times in the main path's dtypes.  B5 is timed as
    one optimizer sweep over every parameter of the 8-layer Llama-2-7B
    training model, one launch a tensor, as a step runs it.  B11/B11b run
    in ``phase_add_layer_norm``."""
    from paddle_tpu_torch.ops.fused_ln_swiglu import (
        adamw_plain, adamw_scalars, fused_adamw, fused_swiglu, fused_swiglu_bwd,
        swiglu_bwd_plain, swiglu_plain)

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(2)
    f32, bf16 = torch.float32, torch.bfloat16

    def randn(*shape, dtype=f32):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    def tol(dtype):
        return TOL[str(dtype).split(".")[1]]

    rows = {}
    b, s, inter, hidden = TRAIN_BATCH, TRAIN_SEQ, 11008, 2048

    # B4 SwiGLU: Llama-2-7B's MLP at the training batch, and off sizes
    for shape in ((b, s, inter), (37, 1000), (37, 1001)):
        for dtype in (f32, bf16):
            g, u, dy = randn(*shape, dtype=dtype), randn(*shape, dtype=dtype), randn(*shape, dtype=dtype)
            err = check_close(torch, "swiglu", fused_swiglu(g, u), swiglu_plain(g, u), tol(dtype))
            errb = max(check_close(torch, f"swiglu_bwd {n}", k, p, tol(dtype)) for n, k, p in
                       zip(("dg", "du"), fused_swiglu_bwd(g, u, dy), swiglu_bwd_plain(g, u, dy)))
            log(f"parity swiglu {dtype} {list(shape)}: max_abs_err fwd {err:.3g} bwd {errb:.3g}")
            if shape[-1] == inter and dtype == bf16:
                main = (g, u, dy, err, errb)
            del g, u, dy
    g, u, dy, err, errb = main
    n, es = g.numel(), g.element_size()
    for name, nbytes, ops, e, fn, plain in (
            ("swiglu", 3 * n * es, 6 * n, err, lambda: fused_swiglu(g, u),
             lambda: swiglu_plain(g, u)),
            ("swiglu_bwd", 5 * n * es, 12 * n, errb, lambda: fused_swiglu_bwd(g, u, dy),
             lambda: swiglu_bwd_plain(g, u, dy))):
        b_ms, b_by = bound_ms(nbytes, ops, F32_FLOPS)
        rows[name] = dict(max_abs_err=e, ms=time_ms(torch, fn), plain_ms=time_ms(torch, plain),
                          bound_ms=b_ms, bound_by=b_by, library_ms=None)
    del g, u, dy, main

    # B5 AdamW: a 7B MLP weight (f32 master, and bf16 p and g), an off-size
    # flat length, decay on and off, step 7
    args = (7, 0.9, 0.999, 1e-8, 0.1)
    sc = adamw_scalars(1e-3, 7, 0.9, 0.999)
    for shape, dtype, decay in (((hidden * 2, inter), f32, True), ((hidden * 2, inter), bf16, True),
                                ((1_000_003,), f32, False), ((1_000_003,), bf16, True)):
        p, g = randn(*shape, dtype=dtype), (0.1 * randn(*shape)).to(dtype)
        m, v = 0.01 * randn(*shape), (0.01 * randn(*shape)).abs()
        want = adamw_plain(p, g, m, v, sc[0], sc[1], sc[2], 0.9, 0.999, 1e-8, 0.1, decay)
        got = fused_adamw(p, g, m, v, 1e-3, *args, decay)
        err = max(check_close(torch, f"adamw {nm}", k, w, tol(k.dtype))
                  for nm, k, w in zip("pmv", got, want))
        log(f"parity adamw {dtype} {list(shape)} decay {decay}: max_abs_err {err:.3g}")
        if dtype == f32 and decay:
            main_err = err
        del p, g, m, v, want, got
    ps = [p.detach() for p in make_llama(TRAIN_LAYERS).parameters()]
    gs = [0.1 * randn(*p.shape) for p in ps]
    ms = [torch.zeros_like(p) for p in ps]
    vs = [torch.zeros_like(p) for p in ps]
    n = sum(p.numel() for p in ps)
    b_ms, b_by = bound_ms(28 * n, 16 * n, F32_FLOPS)
    steps = [torch.tensor(7.0, device=dev) for _ in ps]

    def sweep():
        for p, g, m, v in zip(ps, gs, ms, vs):
            fused_adamw(p, g, m, v, 1e-3, *args, True)

    def plain_sweep():
        for p, g, m, v in zip(ps, gs, ms, vs):
            adamw_plain(p, g, m, v, sc[0], sc[1], sc[2], 0.9, 0.999, 1e-8, 0.1, True)

    rows["adamw"] = dict(
        max_abs_err=main_err, ms=time_ms(torch, sweep, iters=3, repeats=3),
        plain_ms=time_ms(torch, plain_sweep, iters=1, repeats=3),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=time_ms(torch, lambda: torch._fused_adamw_(
            ps, gs, ms, vs, [], steps, lr=1e-3, beta1=0.9, beta2=0.999, weight_decay=0.1,
            eps=1e-8, amsgrad=False, maximize=False), iters=3, repeats=3))
    log(f"adamw sweep: {len(ps)} tensors, {n / 1e9:.3f} B f32 parameters")
    del ps, gs, ms, vs, steps
    torch.cuda.empty_cache()

    rows.update(phase_add_layer_norm(torch))
    for name, r_ in rows.items():
        log(f"time {name}: kernel {r_['ms']:.4f} ms, plain {r_['plain_ms']:.4f} ms, "
            f"library {r_['library_ms']}, bound {r_['bound_ms']:.4f} ms ({r_['bound_by']})")
    return rows


def phase_e2e(torch, card):
    import numpy as np

    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.inference import Predictor
    from paddle_tpu_torch.models import LlamaForCausalLM, llama2_7b
    from paddle_tpu_torch.ops import LAUNCHES, reset_launch_counts

    dev = torch.device("cuda")
    cfg = llama2_7b()
    L, T = cfg.num_hidden_layers, MAX_NEW
    t0 = time.perf_counter()
    model = LlamaForCausalLM(cfg, device=dev, dtype=torch.bfloat16, seed=0).eval()
    torch.cuda.synchronize()
    log(f"e2e: llama2_7b {model.num_params() / 1e9:.2f} B params bf16 on {card}, "
        f"made in {time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab_size, n).astype(np.int32) for n in PROMPT_LENS]
    ids_b = rng.integers(1, cfg.vocab_size, (BATCH, 512)).astype(np.int32)
    want = dict.fromkeys(LAUNCHES, 0)
    want.update(rms_norm=(2 * L + 1) * T, rope=L * T, flash_attention=L,
                decode_attention=L * (T - 1))
    pred = Predictor.from_model(model)

    def counted(label, fn):
        torch.cuda.synchronize()
        reset_launch_counts()
        t = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        took = time.perf_counter() - t
        counts = dict(LAUNCHES)
        log(f"e2e {label}: {took:.2f} s, launches {counts}")
        if counts != want:
            raise AssertionError(f"{label}: launches {counts}, one generate call "
                                 f"of {L} layers and {T} tokens launches {want}")
        return result, counts

    # (a) the serving entry point on ragged prompts (one bucket of 512)
    outs, launches = counted("generate_batch", lambda: pred.generate_batch(
        prompts, max_batch=BATCH, max_new_tokens=T))
    for (ids, scores), n in zip(outs, PROMPT_LENS):
        if ids.shape != (T,) or not np.isfinite(scores).all() or (scores > 0).any() \
                or ids.min() < 0 or ids.max() >= cfg.vocab_size:
            raise AssertionError(f"generate_batch prompt of {n}: bad output {ids} {scores}")
    # (b) generate on an unpadded batch
    (ids, scores), _ = counted("generate", lambda: model.generate(ids_b, max_new_tokens=T))
    if tuple(ids.shape) != (BATCH, T) or not torch.isfinite(scores).all():
        raise AssertionError("generate: bad output")

    # kernels against the plain versions end to end: prefill and first-step
    # logits with the four kernel flags off, and the greedy tokens
    off = dict(use_fused_rms_norm=False, use_fused_rope=False,
               use_flash_attention=False, use_decode_attention=False)
    pads = torch.tensor(pad_lens_of_main_path(), dtype=torch.int32, device=dev)
    rows_a = np.stack([np.concatenate([np.zeros(512 - len(p), np.int32), p])
                       for p in prompts + [prompts[0]] * (BATCH - len(prompts))])
    inputs = (("generate_batch", rows_a, pads), ("generate", ids_b, None))

    def first_logits(m, rows, pad_lens, tok=None, flags=None):
        rows = torch.as_tensor(rows, device=dev).long()
        caches = m.new_kv_cache(rows.shape[0], 512 + T)
        with torch.inference_mode(), ptt.flag_guard(**(flags or {})):
            logits, _ = m(rows, kv_cache=caches, position_offset=0, pad_lens=pad_lens)
            last = logits[:, -1].float()
            tok = last.argmax(-1) if tok is None else tok
            step, _ = m(tok[:, None], kv_cache=caches, position_offset=512,
                        pad_lens=pad_lens)
        return last, step[:, -1].float(), tok

    def rel(a, b):
        return float((a - b).norm() / b.norm())

    # (i) at full width and 2 layers, where bf16 rounding has not yet been
    # amplified by depth: kernels within LOGITS_REL_TOL of the plain path
    shallow = LlamaForCausalLM(llama2_7b(num_hidden_layers=2), device=dev,
                               dtype=torch.bfloat16, seed=0).eval()
    for label, rows, pl in inputs:
        on = first_logits(shallow, rows, pl)
        plain = first_logits(shallow, rows, pl, on[2], off)
        for what, i in (("prefill", 0), ("first step", 1)):
            r = rel(on[i], plain[i])
            log(f"e2e logits 2-layer {label} {what}: relative error kernels vs plain {r:.4g}")
            if not r <= LOGITS_REL_TOL:
                raise AssertionError(f"{label} {what} logits: relative error {r} "
                                     f"> {LOGITS_REL_TOL}")
    del shallow
    # (ii) at full depth, two bf16 paths drift apart as rounding differences
    # grow layer by layer; the kernel path must stay as close to an f32
    # reference (the same weights, plain path) as the plain bf16 path is
    ref = copy.deepcopy(model).float()
    for label, rows, pl in inputs:
        on = first_logits(model, rows, pl)
        plain = first_logits(model, rows, pl, on[2], off)
        f32 = first_logits(ref, rows, pl, on[2], off)
        for what, i in (("prefill", 0), ("first step", 1)):
            rk, rp, rkp = rel(on[i], f32[i]), rel(plain[i], f32[i]), rel(on[i], plain[i])
            log(f"e2e logits {L}-layer {label} {what}: relative error to f32 kernels "
                f"{rk:.4g}, plain {rp:.4g}; kernels vs plain {rkp:.4g}")
            if not rk <= DEPTH_REL_MARGIN * rp:
                raise AssertionError(f"{label} {what}: kernels {rk} from the f32 "
                                     f"reference, plain bf16 path {rp}")
    del ref
    torch.cuda.empty_cache()
    with ptt.flag_guard(**off):
        plain_outs = pred.generate_batch(prompts, max_batch=BATCH, max_new_tokens=T)
    same = np.mean([np.mean(a[0] == p[0]) for a, p in zip(outs, plain_outs)])
    log(f"e2e greedy tokens identical to the plain path: {same:.4f} of {len(prompts) * T}")

    # throughput of generate on the unpadded batch (warm)
    def timed(n):
        torch.cuda.synchronize()
        t = time.perf_counter()
        model.generate(ids_b, max_new_tokens=n)
        torch.cuda.synchronize()
        return time.perf_counter() - t

    t1 = min(timed(1) for _ in range(2))
    tn = min(timed(T) for _ in range(2))
    log(f"e2e throughput on {card}: prefill {BATCH * 512 / t1:.1f} tokens/s "
        f"({t1 * 1e3:.1f} ms for {BATCH}x512), decode {BATCH * (T - 1) / (tn - t1):.1f} "
        f"tokens/s ({(tn - t1) / (T - 1) * 1e3:.2f} ms a step at batch {BATCH})")
    phase_profile(torch, lambda n: model.generate(ids_b, max_new_tokens=n), T)
    del pred, outs, plain_outs
    torch.cuda.empty_cache()
    phase_engine(torch, card, model)
    torch.cuda.empty_cache()
    cp_path = phase_engine_cp(torch, card, model)
    torch.cuda.empty_cache()
    phase_engine_a1(torch, card, model)
    torch.cuda.empty_cache()
    phase_generation_a2(torch, card, model)
    del model
    return launches, cp_path


ENGINE_PROMPT_LENS = (37, 64, 100, 150, 250, 333, 420, 511)
ENGINE_KW = dict(max_batch=BATCH, page_tokens=16, max_pages_per_seq=64, num_pages=8 * 64 + 1)
QUANT_LOGITS_TOL = 0.08    # int8 vs bf16 decode logits at 2 layers, of max |logit|
ENGINE_PROFILE_STEP, ENGINE_SNAP_STEP = 8, 16
ENGINE_PREFILL_LEN = 512       # the prompt whose prefill is timed


def engine_lockstep(torch, engines, prompts, T, profile_at=None, on_step=None):
    """Serve ``prompts`` with ``T`` new tokens each on every engine of
    ``engines`` ({kv_dtype: engine}), one ``step()`` of each in turn, so
    that row i of every engine serves prompt i.  After each step, wherever
    a quantized engine's row decoded from the same stream as the bf16
    engine's row (every token so far equal), the two decode logits are
    compared: max |difference| over max(max |bf16 logit|, 1).  Returns the
    requests, the worst such ratio and the count of row-steps compared
    for each quantized kind, each engine's step seconds and launches."""
    import numpy as np

    from paddle_tpu_torch.ops import LAUNCHES, reset_launch_counts

    for e in engines.values():
        for p in prompts:
            e.submit(p, max_new_tokens=T)
    kinds = [k for k in engines if k != "bf16"]
    launches = {k: dict.fromkeys(LAUNCHES, 0) for k in engines}
    step_s = {k: [] for k in engines}
    worst, compared = dict.fromkeys(kinds, 0.0), dict.fromkeys(kinds, 0)
    reqs = rows = None
    n = 0
    while any(e._queue or e._active for e in engines.values()):
        n += 1
        for k, e in engines.items():
            torch.cuda.synchronize()
            reset_launch_counts()
            t = time.perf_counter()
            if n == profile_at:
                profile_step(torch, f"engine {k} decode step (batch {len(prompts)})", e.step)
            else:
                e.step()
            torch.cuda.synchronize()
            step_s[k].append(time.perf_counter() - t)
            for name, c in LAUNCHES.items():
                launches[k][name] += c
        if reqs is None:   # all admitted at the first step, one row each
            reqs = {k: sorted(e._active.values(), key=lambda r: r.rid)
                    for k, e in engines.items()}
            rows = {k: [r.row for r in rs] for k, rs in reqs.items()}
        ref = engines["bf16"].last_decode_logits
        for k in kinds:
            got = engines[k].last_decode_logits
            for i, (rb, rq) in enumerate(zip(reqs["bf16"], reqs[k])):
                # row i decoded at this step iff it produced its token n + 1
                if len(rq.generated) == n + 1 and rb.generated[:-1] == rq.generated[:-1]:
                    a, b = ref[rows["bf16"][i], 0], got[rows[k][i], 0]
                    worst[k] = max(worst[k], float(np.abs(a - b).max() / max(np.abs(a).max(), 1.0)))
                    compared[k] += 1
        if on_step is not None:
            on_step(n, reqs)
    return reqs, worst, compared, step_s, launches


def engine_gate_shallow(torch, model, prompts):
    """At ``model``'s width and 2 layers: the bf16 engine's prefill
    (first-token) logits against the first logits of ``generate``'s path
    for the same prompt, within LOGITS_REL_TOL; then the bf16, int8 and
    fp8 engines in lockstep, the int8 decode logits within
    QUANT_LOGITS_TOL of max |logit| of the bf16 engine's wherever the
    streams agree (the reference's harness tolerance, which it applies to
    int8 pages at 2 layers); fp8's distance is printed (the reference has
    no fp8 tolerance)."""
    import dataclasses

    from paddle_tpu_torch.models import LlamaForCausalLM
    from paddle_tpu_torch.serving import ServingEngine

    p0 = next(model.parameters())
    shallow = LlamaForCausalLM(dataclasses.replace(model.config, num_hidden_layers=2),
                               device=p0.device, dtype=p0.dtype, seed=0).eval()
    eng = ServingEngine(shallow, **ENGINE_KW)
    worst = 0.0
    for i, p in enumerate(prompts):
        eng.pool.alloc(i, eng.pool.pages_for(len(p) + 1))
        got = torch.from_numpy(eng._prefill_chunks(p, eng._padded_table(i)[None]))
        eng.pool.free(i)
        with torch.inference_mode():
            ids = torch.as_tensor(p[None], device=p0.device).long()
            want, _ = shallow(ids, kv_cache=shallow.new_kv_cache(1, len(p)), position_offset=0)
        worst = max(worst, rel_l2(got, want[0, -1].cpu()))
    log(f"engine 2-layer bf16 prefill logits vs generate's first logits, {len(prompts)} "
        f"prompts: worst relative L2 {worst:.4g}")
    if not worst <= LOGITS_REL_TOL:
        raise AssertionError(f"engine prefill logits: relative error {worst} > {LOGITS_REL_TOL}")
    del eng
    engines = {k: ServingEngine(shallow, kv_dtype=k, **ENGINE_KW) for k in ("bf16", "int8", "fp8")}
    _, qworst, compared, _, _ = engine_lockstep(torch, engines, prompts, MAX_NEW)
    log(f"engine 2-layer int8/fp8 decode logits vs bf16 where the streams agree: int8 "
        f"{qworst['int8']:.4g} ({compared['int8']} row-steps), fp8 {qworst['fp8']:.4g} "
        f"({compared['fp8']} row-steps) of max |logit|; int8 tol {QUANT_LOGITS_TOL}")
    if compared["int8"] == 0 or not qworst["int8"] < QUANT_LOGITS_TOL:
        raise AssertionError(f"2-layer int8 engine logits: worst {qworst['int8']} over "
                             f"{compared['int8']} row-steps")


def engine_layer0_pages(torch, engines, reqs):
    """Layer 0's keys and values depend only on each slot's token and
    position, not on the KV dtype: over the prompt and the generated tokens
    both streams share, the int8 and fp8 engines' layer-0 pages must be the
    bf16 engine's quantized, bit for bit (values and int8 scales).  Returns
    the number of token slots checked."""
    from paddle_tpu_torch.serving.kv_quant import quantize_kv, quantize_kv_fp8

    checked = 0
    for i, rb in enumerate(reqs["bf16"]):
        tb = engines["bf16"].pool.table(rb.rid)
        for k in ("int8", "fp8"):
            rq, e = reqs[k][i], engines[k]
            shared = next((j for j, (a, b) in enumerate(zip(rb.generated, rq.generated))
                           if a != b), len(rb.generated))
            # slot len(prompt) + j holds generated token j once it is decoded
            n_tok = len(rb.prompt) + min(shared, len(rb.generated) - 1)
            tq = e.pool.table(rq.rid)
            for key in ("k", "v"):
                ref = engines["bf16"]._arenas[key][0][tb].reshape(-1, *e._arena_shape[2:])[:n_tok]
                got = e._arenas[key][0][tq].reshape(-1, *e._arena_shape[2:])[:n_tok]
                if k == "int8":
                    want_q, want_s = quantize_kv(ref)
                    got_s = e._arenas[key + "s"][0][tq].reshape(-1, e._arena_shape[2])[:n_tok]
                    ok = torch.equal(got, want_q) and torch.equal(got_s, want_s)
                else:
                    ok = torch.equal(got.view(torch.uint8), quantize_kv_fp8(
                        ref, e._fp8_scale).view(torch.uint8))
                if not ok:
                    raise AssertionError(f"engine {k}: layer-0 {key} pages of request {i} are "
                                         f"not the bf16 engine's quantized")
            checked += n_tok
    return checked


def engine_arena_case(torch, engines, reqs, layer):
    """The quantized engines' own pages as B8/B9 caches: one request's
    pages of ``layer``, gathered into contiguous [1, C, kv, d] caches (int8
    scales transposed to [1, kv, C]); the new token is the row before
    ``pos`` dequantized, q is seeded."""
    from paddle_tpu_torch.serving.kv_quant import dequantize_kv

    r8, r9 = reqs["int8"], reqs["fp8"]
    t8 = engines["int8"].pool.table(r8.rid)
    t9 = engines["fp8"].pool.table(r9.rid)
    ar8, ar9 = engines["int8"]._arenas, engines["fp8"]._arenas
    N, P, kv, d = ar8["k"][layer].shape
    C = len(t8) * P
    pos = min(r8.pos, C - 1)
    dev = ar8["k"][layer].device

    def rows(arena, table):
        return arena[layer][torch.tensor(table, device=dev)].reshape(1, C, *arena[layer].shape[2:])

    ck, cv, fk, fv = rows(ar8["k"], t8), rows(ar8["v"], t8), rows(ar9["k"], t9), rows(ar9["v"], t9)
    ks, vs = (rows(ar8[n], t8).transpose(1, 2).contiguous() for n in ("ks", "vs"))
    kn = dequantize_kv(ck[:, pos - 1:pos], ks[:, :, pos - 1].unsqueeze(1)).to(torch.bfloat16)
    vn = dequantize_kv(cv[:, pos - 1:pos], vs[:, :, pos - 1].unsqueeze(1)).to(torch.bfloat16)
    h = engines["int8"].model.config.num_attention_heads
    q = torch.randn(1, 1, h, d, generator=torch.Generator(device=dev).manual_seed(5),
                    device=dev).to(torch.bfloat16)
    quant_case(torch, f"engine pages layer {layer}", q, kn, vn, ck, cv, ks, vs, fk, fv, pos,
               None, engines["fp8"]._fp8_scale)


def phase_engine(torch, card, model):
    """The port's ServingEngine on Llama-2-7B at full width and depth:
    bf16, int8 and fp8 pages, each engine serving the same 8 ragged prompts
    with MAX_NEW new tokens, stepped in lockstep.  Gates: at 2 layers (see
    ``engine_gate_shallow``) the prefill logits against generate's and the
    int8 decode logits against the bf16 engine's; at full depth, the int8
    and fp8 layer-0 pages bit-equal to the bf16 engine's quantized, finite
    logits (the engine raises otherwise), no leaked page after run(), int8
    and fp8 pages exactly half the bytes of bf16 pages, the RMSNorm and
    rope kernels launched 2L+1 and L times for every prefill chunk and
    decode step and no decode kernel (as in the reference, the paged
    attention is plain).  The full-depth int8/fp8 logit distances to bf16
    are printed, not gated: on random weights they grow with depth as the
    bf16 paths' own distances do (phase 4).  Then B8/B9 on the engines'
    own pages, and the prefill, decode and memory numbers."""
    import numpy as np

    from paddle_tpu_torch.ops import LAUNCHES
    from paddle_tpu_torch.serving import ServingEngine

    cfg = model.config
    L, T, P = cfg.num_hidden_layers, MAX_NEW, ENGINE_KW["page_tokens"]
    rng = np.random.default_rng(4)
    prompts = [rng.integers(1, cfg.vocab_size, n).astype(np.int32) for n in ENGINE_PROMPT_LENS]
    engine_gate_shallow(torch, model, prompts)
    torch.cuda.empty_cache()

    kinds = ("bf16", "int8", "fp8")
    torch.cuda.reset_peak_memory_stats()
    base_mem = torch.cuda.memory_allocated()
    engines = {k: ServingEngine(model, kv_dtype=k, **ENGINE_KW) for k in kinds}
    arena_mem = torch.cuda.memory_allocated() - base_mem
    layer0 = []

    def on_step(n, reqs):
        if n == ENGINE_SNAP_STEP:
            layer0.append(engine_layer0_pages(torch, engines, reqs))
            engine_arena_case(torch, engines, {k: reqs[k][-1] for k in kinds}, L - 1)

    reqs, worst, compared, step_s, launches = engine_lockstep(
        torch, engines, prompts, T, profile_at=ENGINE_PROFILE_STEP, on_step=on_step)
    peak = torch.cuda.max_memory_allocated()
    outs = {k: e.run() for k, e in engines.items()}   # drained: returns, leak-checked
    for k, e in engines.items():
        e.pool.check_leaks()
        for r in reqs[k]:
            o = outs[k][r.rid]
            if o.shape != (T,) or o.min() < 0 or o.max() >= cfg.vocab_size:
                raise AssertionError(f"engine {k}: bad output for rid {r.rid}: {o}")
    log(f"engine layer-0 int8/fp8 pages bit-equal to the bf16 engine's quantized: "
        f"{layer0[0]} token slots checked")
    log(f"engine {L}-layer int8/fp8 decode logits vs bf16 where the streams agree: int8 "
        f"{worst['int8']:.4g} ({compared['int8']} row-steps), fp8 {worst['fp8']:.4g} "
        f"({compared['fp8']} row-steps) of max |logit|")
    same = {k: float(np.mean([np.mean(outs[k][rq.rid] == outs["bf16"][rb.rid])
                              for rq, rb in zip(reqs[k], reqs["bf16"])])) for k in ("int8", "fp8")}
    log(f"engine greedy tokens identical to the bf16 engine's: int8 {same['int8']:.4f}, "
        f"fp8 {same['fp8']:.4f} of {BATCH * T}")

    bf_page = engines["bf16"].pool.bytes_per_page
    for k in ("int8", "fp8"):
        if engines[k].pool.bytes_per_page * 2 != bf_page:
            raise AssertionError(f"{k} page {engines[k].pool.bytes_per_page} B is not half "
                                 f"of bf16's {bf_page} B")
    chunks = sum(-(-n_ // P) for n_ in ENGINE_PROMPT_LENS)
    want = dict.fromkeys(LAUNCHES, 0)
    want.update(rms_norm=(2 * L + 1) * (chunks + T - 1), rope=L * (chunks + T - 1))
    for k in kinds:
        if launches[k] != want:
            raise AssertionError(f"engine {k}: launches {launches[k]}, {chunks} prefill chunks "
                                 f"and {T - 1} decode steps of {L} layers launch {want}")
    log(f"engine launches per run ({chunks} prefill chunks, {T - 1} decode steps), each "
        f"dtype: rms_norm {want['rms_norm']}, rope {want['rope']}, no decode kernel")

    p512 = rng.integers(1, cfg.vocab_size, ENGINE_PREFILL_LEN).astype(np.int32)
    for k, e in engines.items():
        e.pool.alloc("p512", e.pool.pages_for(ENGINE_PREFILL_LEN + 1))
        table = e._padded_table("p512")[None]
        ms = []
        for _ in range(2):
            torch.cuda.synchronize()
            t = time.perf_counter()
            e._prefill_chunks(p512, table)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t) * 1e3)
        e.pool.free("p512")
        decode = [x for i, x in enumerate(step_s[k][1:], 2) if i != ENGINE_PROFILE_STEP]
        log(f"engine {k} on {card}: prefill of a {ENGINE_PREFILL_LEN}-token prompt "
            f"{min(ms):.1f} ms ({ENGINE_PREFILL_LEN / min(ms) * 1e3:.1f} tokens/s); decode step "
            f"{np.mean(decode) * 1e3:.2f} ms at batch {BATCH}; {BATCH * T / sum(step_s[k]):.1f} "
            f"tokens/s over the run ({sum(step_s[k]):.2f} s, {len(step_s[k])} steps, the first "
            f"with the {BATCH} prefills {step_s[k][0] * 1e3:.1f} ms); pool "
            f"{e.pool.bytes_per_token():.0f} B a token ({e.pool.bytes_per_page} B a page + "
            f"{e.pool.scale_bytes_per_page} B of scales), arenas "
            f"{(e._arena_bytes + e._scale_bytes) / 2**30:.3f} GiB")
    log(f"engine memory: three engines' arenas {arena_mem / 2**30:.3f} GiB; peak "
        f"{peak / 2**30:.2f} GiB with the model during the run")
    del engines


CP_PROMPT_LEN, CP_NEW = 4000, 8      # one long prompt (max_position 4096)
CP_DEGREES = (2, 4)
CP_ENGINE_KW = dict(max_batch=1, page_tokens=16, max_pages_per_seq=256, num_pages=256 + 1)
CP_GATE_PAGES = (100, 2 * 256 + 1)   # 2-layer gate: pages taken first, pool size


def cp_launches(L, cp, steps=0):
    """Exact launches of one CP prefill of an L-layer Llama over ``cp`` ring
    members (B3 and a merge per hop that is not skipped) and of ``steps``
    decode steps after it (RMSNorm and rope only: the paged decode is plain)."""
    hops = cp * (cp + 1) // 2
    return dict(rms_norm=(2 * L + 1) * (1 + steps), rope=L * (1 + steps),
                flash_attention=L * hops, ring_merge=L * hops)


def counted_launches(torch, fn):
    from paddle_tpu_torch.ops import LAUNCHES, reset_launch_counts

    torch.cuda.synchronize()
    reset_launch_counts()
    result = fn()
    torch.cuda.synchronize()
    return result, {k: c for k, c in LAUNCHES.items() if c}


def engine_cp_gate_shallow(torch, model, prompt):
    """At ``model``'s width and 2 layers, for bf16, int8 and fp8 pages and
    cp 2 and 4: the CP prefill's first-token logits within LOGITS_REL_TOL
    (relative L2) of the chunked engine's on the same prompt, its launches
    exact, and every page outside the prompt's table and the trash page
    untouched (another request's pages are taken first, so untouched pages
    lie on both sides of the table)."""
    import dataclasses

    from paddle_tpu_torch.models import LlamaForCausalLM
    from paddle_tpu_torch.serving import TRASH_PAGE, ServingEngine

    p0 = next(model.parameters())
    shallow = LlamaForCausalLM(dataclasses.replace(model.config, num_hidden_layers=2),
                               device=p0.device, dtype=p0.dtype, seed=0).eval()
    kw = dict(CP_ENGINE_KW, num_pages=CP_GATE_PAGES[1])
    for kind in ("bf16", "int8", "fp8"):
        ref = ServingEngine(shallow, kv_dtype=kind, **kw)
        ref.pool.alloc("g", ref.pool.pages_for(len(prompt) + 1))
        want = torch.from_numpy(ref._prefill_chunks(prompt, ref._padded_table("g")[None]))
        del ref
        for cp in CP_DEGREES:
            e = ServingEngine(shallow, cp=cp, kv_dtype=kind, **kw)
            e.pool.alloc("other", CP_GATE_PAGES[0])
            table = e.pool.alloc("g", e.pool.pages_for(len(prompt) + 1))
            got, counts = counted_launches(torch, lambda: e._cp_prefill_run(prompt, table))
            if counts != cp_launches(2, cp):
                raise AssertionError(f"CP prefill {kind} cp {cp} at 2 layers: launches "
                                     f"{counts}, want {cp_launches(2, cp)}")
            r = rel_l2(torch.from_numpy(got), want)
            if not r <= LOGITS_REL_TOL:
                raise AssertionError(f"CP prefill {kind} cp {cp} at 2 layers: first-token "
                                     f"logits {r} from the chunked engine's")
            others = torch.ones(e.num_pages, dtype=torch.bool, device=p0.device)
            others[table + [TRASH_PAGE]] = False
            for key, arenas in e._arenas.items():
                for li, a in enumerate(arenas):
                    if a[others].view(torch.uint8).any():
                        raise AssertionError(f"CP prefill {kind} cp {cp}: {key}[{li}] wrote "
                                             f"a page outside the prompt's table")
            log(f"engine CP 2-layer {kind} cp {cp}: first-token logits vs chunked relative "
                f"L2 {r:.4g}; launches {counts}; {int(others.sum())} pages outside the "
                f"table untouched")
            del e
    del shallow
    torch.cuda.empty_cache()


def cp_instrument(torch, e):
    """Record (path, logits, ms) of each prefill ``e`` runs."""
    rec = []
    for name in ("_prefill_chunks", "_cp_prefill_run"):
        def timed(*a, _fn=getattr(e, name), _name=name):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = _fn(*a)
            torch.cuda.synchronize()
            rec.append((_name, out, (time.perf_counter() - t) * 1e3))
            return out
        setattr(e, name, timed)
    return rec


def phase_engine_cp(torch, card, model):
    """The context-parallel prefill (``ServingEngine(cp=n)``, B10 under the
    ring attention) on Llama-2-7B at full width and depth, the ring members
    on the one card: one prompt of CP_PROMPT_LEN tokens and CP_NEW new
    tokens, with bf16, int8 and fp8 pages, on the chunked engine (cp 1) and
    on cp 2 and cp 4.  Gates at 2 layers in ``engine_cp_gate_shallow``; at
    full depth each engine's launches are exact and its tokens in range,
    and the first-token logits' distance to the chunked engine's, both
    engines' tokens and the prefill times are printed, and one cp 4 bf16
    prefill is profiled.  Returns the launches of the cp 4 bf16 engine's
    run, the path's counted run."""
    import numpy as np

    from paddle_tpu_torch.serving import ServingEngine

    cfg = model.config
    L, P = cfg.num_hidden_layers, CP_ENGINE_KW["page_tokens"]
    prompt = np.random.default_rng(6).integers(1, cfg.vocab_size, CP_PROMPT_LEN).astype(np.int32)
    engine_cp_gate_shallow(torch, model, prompt)
    n_chunks = -(-CP_PROMPT_LEN // P)
    path = None
    for kind in ("bf16", "int8", "fp8"):
        res = {}
        for cp in (1, *CP_DEGREES):
            e = ServingEngine(model, cp=cp, kv_dtype=kind, **CP_ENGINE_KW)
            rec = cp_instrument(torch, e)
            rid = e.submit(prompt, max_new_tokens=CP_NEW)
            outs, counts = counted_launches(torch, e.run)
            want = cp_launches(L, cp, CP_NEW - 1) if cp > 1 else dict(
                rms_norm=(2 * L + 1) * (n_chunks + CP_NEW - 1), rope=L * (n_chunks + CP_NEW - 1))
            if counts != want:
                raise AssertionError(f"engine CP {kind} cp {cp}: launches {counts}, want {want}")
            toks = outs[rid]
            if toks.shape != (CP_NEW,) or toks.min() < 0 or toks.max() >= cfg.vocab_size:
                raise AssertionError(f"engine CP {kind} cp {cp}: bad output {toks}")
            if cp > 1:
                if e.cp_prefills != 1:
                    raise AssertionError(f"engine CP {kind} cp {cp}: the ring did not prefill")
                table = e.pool.alloc("again", e.pool.pages_for(CP_PROMPT_LEN + 1))
                e._cp_prefill_run(prompt, table)        # a second, warm prefill
                if kind == "bf16" and cp == max(CP_DEGREES):
                    path = counts
                    profile_step(torch, f"engine CP prefill {kind} cp {cp}, {CP_PROMPT_LEN} "
                                 f"tokens", lambda: e._cp_prefill_run(prompt, table))
                e.pool.free("again")
            res[cp] = (toks, rec[0][1], min(ms for _, _, ms in rec[:2]))
            del e
            torch.cuda.empty_cache()
        toks1, logits1, ms1 = res[1]
        for cp in CP_DEGREES:
            toks, logits, ms = res[cp]
            log(f"engine CP {L}-layer {kind} cp {cp} on {card}: prefill of a "
                f"{CP_PROMPT_LEN}-token prompt {ms:.1f} ms (best of 2), chunked {ms1:.1f} ms "
                f"({n_chunks} chunks of {P}), {ms1 / ms:.1f}x; first-token logits vs chunked "
                f"relative L2 {rel_l2(torch.from_numpy(logits), torch.from_numpy(logits1)):.4g}; "
                f"tokens {toks.tolist()} vs chunked {toks1.tolist()} "
                f"({int((toks == toks1).sum())} of {CP_NEW} equal)")
    return path


# -- the serving engine's remainder (A1): prefix cache, offload, journal ----------
A1_SYS_LEN, A1_TAILS, A1_PREFIX_NEW = 496, (16, 23, 30, 37, 44, 51, 58, 64), 16
A1_PROMPT_LEN, A1_OFFLOAD_NEW, A1_JOURNAL_NEW, A1_JOURNAL_STEPS = 512, 48, 32, 10
# 8 rows of 512-token prompts take 33 pages each.  With 7 pages to spare, the
# first pressure (each row's 34th page) preempts the youngest row, and its 33
# freed pages let it be recalled at once and swapped out again as it grows:
# at least two swap-outs.  With 0-6 to spare the other rows never give the
# freed pages back before they finish, and there is one swap-out.
A1_OFFLOAD_PAGES = BATCH * 33 + 1 + 7
A1_TIER_PAGES, A1_SMALL_TIER = 2 * 35, 16      # room for a victim; too small for one


def a1_prompts(vocab, seed=8):
    """The prefix run's 8 prompts (a 496-token system prompt and distinct
    tails) and the offload and journal runs' 8 prompts of 512 tokens."""
    import numpy as np

    rng = np.random.default_rng(seed)
    sys_prompt = rng.integers(1, vocab, A1_SYS_LEN)
    prefix = [np.concatenate([sys_prompt, rng.integers(1, vocab, n)]).astype(np.int32)
              for n in A1_TAILS]
    long = [rng.integers(1, vocab, A1_PROMPT_LEN).astype(np.int32) for _ in range(BATCH)]
    return prefix, long


def a1_serve(torch, e, phases, max_new):
    """Serve each list of prompts of ``phases`` to completion in turn,
    launches counted from zero; returns the outputs in prompt order, each
    phase's last TTFT (ms), the launches, and the forwards by kind."""
    fwd, n_fwd = e._forward, {"prefill chunks": 0, "decode steps": 0}

    def counted(tokens, *a, **k):
        n_fwd["decode steps" if tokens.shape[0] == e.max_batch else "prefill chunks"] += 1
        return fwd(tokens, *a, **k)

    def serve():
        outs, ttft = [], []
        for prompts in phases:
            rids = [e.submit(p, max_new_tokens=max_new) for p in prompts]
            res = e.run()
            outs += [res[r] for r in rids]
            ttft.append(e.meter._window[-1][1] * 1e3)
        return outs, ttft

    e._forward = counted
    (outs, ttft), counts = counted_launches(torch, serve)
    del e._forward       # the spy closes over the engine: break the cycle
    return outs, ttft, counts, n_fwd


def a1_check_launches(label, L, counts, n_fwd, chunks=None):
    """The A1 path runs B1 (2L + 1 a forward) and B2 (L a forward) and no
    other kernel; ``chunks``, where given, is the prefill chunks it needs."""
    n = sum(n_fwd.values())
    want = dict(rms_norm=(2 * L + 1) * n, rope=L * n)
    if counts != want or (chunks is not None and n_fwd["prefill chunks"] != chunks):
        raise AssertionError(f"{label}: launches {counts} over {n_fwd}, want {want} and "
                             f"{chunks} prefill chunks")


def a1_same(label, got, want, n=None):
    for i, (g, w) in enumerate(zip(got, want)):
        if list(g) != list(w[:n]):
            raise AssertionError(f"{label}: request {i} {list(g)} != {list(w[:n])}")


def a1_prefix(torch, model, kind, prompts, kw, full):
    """The prefix cache on ``prompts``: the first alone (a miss), then the
    second alone (a hit), then the other six; token-exact against an engine
    without a cache serving the same phases."""
    from paddle_tpu_torch.serving import ServingEngine

    L, P = model.config.num_hidden_layers, kw["page_tokens"]
    phases = [prompts[:1], prompts[1:2], prompts[2:]]
    e = ServingEngine(model, prefix_cache=True, kv_dtype=kind, **kw)
    got, ttft, counts, n_fwd = a1_serve(torch, e, phases, A1_PREFIX_NEW)
    cached = A1_SYS_LEN // P
    chunks = sum(-(-len(p) // P) for p in prompts) - cached * (len(prompts) - 1)
    a1_check_launches(f"A1 prefix {kind}", L, counts, n_fwd, chunks)
    s = e.prefix.summary()
    if s["hits"] != len(prompts) - 1 or s["tokens_saved"] < (len(prompts) - 1) * A1_SYS_LEN:
        raise AssertionError(f"A1 prefix {kind}: {s}")
    e.pool.check_leaks(allow_shared=True)
    e.prefix.clear()
    e.pool.check_leaks()
    del e
    ref = ServingEngine(model, kv_dtype=kind, **kw)
    want, ttft_ref, _, _ = a1_serve(torch, ref, phases, A1_PREFIX_NEW)
    del ref
    a1_same(f"A1 prefix {kind}", got, want)
    log(f"engine A1 prefix {L}-layer {kind}: hits {s['hits']}, misses {s['misses']}, tokens "
        f"saved {s['tokens_saved']}, {n_fwd['prefill chunks']} prefill chunks (without the "
        f"cache {chunks + cached * (len(prompts) - 1)}); token-exact against the engine "
        f"without a cache; launches {counts}"
        + (f"; TTFT of a miss {ttft[0]:.1f} ms, of a hit {ttft[1]:.1f} ms (alone; without "
           f"the cache {ttft_ref[1]:.1f} ms)" if full else ""))
    return ttft


def a1_offload_pages(torch, e, rid):
    """Device copies of ``rid``'s pages, every plane and layer."""
    idx = torch.as_tensor(e.pool.table(rid), device=e.device)
    return {key: [a.index_select(0, idx) for a in arrs] for key, arrs in e._arenas.items()}


def a1_offload(torch, model, kind, prompts, want, kw, full):
    """The offload tier: 8 rows of 512-token prompts in A1_OFFLOAD_PAGES
    pages grow to A1_OFFLOAD_NEW tokens, so preemption swaps pages to the
    host tier and back; token-exact against ``want`` (an engine with room
    for all), the first victim's pages bit-equal after its recall; then a
    tier too small for one victim: offload stalls, still token-exact.
    Returns the bytes of one swap-out, and the ms of each swap-out and each
    recall of the first run, in order."""
    from paddle_tpu_torch.serving import OffloadPool, ServingEngine

    L = model.config.num_hidden_layers
    okw = dict(kw, num_pages=A1_OFFLOAD_PAGES)
    e = ServingEngine(model, offload=OffloadPool(max_pages=A1_TIER_PAGES), kv_dtype=kind, **okw)
    watch, swaps = {}, []
    offload, recall, export, import_ = e._offload, e._recall, e._export_pages, e._import_pages

    def timed(fn, what):
        def run(*a):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*a)
            torch.cuda.synchronize()
            swaps.append((what, (time.perf_counter() - t) * 1e3))
            return out
        return run

    def _offload(victim):
        if not watch:
            watch["rid"], watch["before"] = victim.rid, a1_offload_pages(torch, e, victim.rid)
        offload(victim)

    def _recall(r, rows):
        out = recall(r, rows)
        if out == "recalled" and r.rid == watch.get("rid") and "after" not in watch:
            watch["after"] = a1_offload_pages(torch, e, r.rid)
        return out

    e._offload, e._recall = _offload, _recall
    e._export_pages, e._import_pages = timed(export, "out"), timed(import_, "in")
    got, _, counts, n_fwd = a1_serve(torch, e, [prompts], A1_OFFLOAD_NEW)
    a1_check_launches(f"A1 offload {kind}", L, counts, n_fwd)
    s = e.meter.summary()
    if s["kv_offloads"] < 2 or s["kv_recalls"] < 2 or s["kv_offload_stalls"] or s["evictions"]:
        raise AssertionError(f"A1 offload {kind}: {s}")
    a1_same(f"A1 offload {kind}", got, want)
    for key, arrs in watch["before"].items():
        for li, (a, b) in enumerate(zip(arrs, watch["after"][key])):
            if not torch.equal(a.view(torch.uint8), b.view(torch.uint8)):
                raise AssertionError(f"A1 offload {kind}: {key}[{li}] of the victim's pages "
                                     f"changed across its swap-out and recall")
    n_pages = watch["before"]["k"][0].shape[0]
    e.pool.check_leaks()
    per = s["kv_offload_bytes_out"] / s["kv_offloads"]
    times = {what: [ms for w, ms in swaps if w == what] for what in ("out", "in")}
    del e, watch
    log(f"engine A1 offload {L}-layer {kind}: {s['kv_offloads']} swap-outs, {s['kv_recalls']} "
        f"recalls, no stall, no eviction; token-exact against the engine with room for all; "
        f"the first victim's {n_pages} pages bit-equal after its recall; "
        f"{per / 2**20:.1f} MiB a swap-out; recall {s['kv_recall_bytes_per_token']:.0f} B a "
        f"new token; launches {counts}")
    e = ServingEngine(model, offload=OffloadPool(max_pages=A1_SMALL_TIER), kv_dtype=kind, **okw)
    got, _, counts, n_fwd = a1_serve(torch, e, [prompts], A1_OFFLOAD_NEW)
    a1_check_launches(f"A1 offload stall {kind}", L, counts, n_fwd)
    s2 = e.meter.summary()
    if s2["kv_offload_stalls"] < 1:
        raise AssertionError(f"A1 offload {kind}, {A1_SMALL_TIER}-page tier: no stall: {s2}")
    a1_same(f"A1 offload stall {kind}", got, want)
    e.pool.check_leaks()
    log(f"engine A1 offload {L}-layer {kind}, a {A1_SMALL_TIER}-page tier: "
        f"{s2['kv_offload_stalls']} stalls (re-prefills), {e.offload.pages_dropped} frames "
        f"dropped; token-exact")
    del e
    return per, times


def a1_pinned_copy(torch, nbytes):
    """The host link's yardstick: one plain copy of ``nbytes`` from the card
    to pinned host memory and back (ms each, best of three)."""
    dev = torch.empty(int(nbytes), dtype=torch.uint8, device="cuda")
    host = torch.empty(int(nbytes), dtype=torch.uint8, pin_memory=True)
    times = {}
    for what, dst, src in (("out", host, dev), ("in", dev, host)):
        ms = []
        for _ in range(3):
            torch.cuda.synchronize()
            t = time.perf_counter()
            dst.copy_(src)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t) * 1e3)
        times[what] = min(ms)
    return times


def a1_journal(torch, card, model, prompts, want, kw):
    """The journal: 8 prompts of 512 tokens with A1_JOURNAL_NEW new tokens,
    journaled with a TokenSink; after A1_JOURNAL_STEPS steps the engine is
    abandoned (its sink closed, its arenas filled with NaN and freed); a
    fresh engine recovers and runs.  Token-exact against ``want``, every
    token in the sink exactly once, no leaked page."""
    import os
    import tempfile

    from paddle_tpu_torch.serving import ServingEngine, TokenSink

    L = model.config.num_hidden_layers
    with tempfile.TemporaryDirectory() as tmp:
        jdir, spath = os.path.join(tmp, "journal"), os.path.join(tmp, "tokens.jsonl")
        sink = TokenSink(spath)
        e = ServingEngine(model, journal=jdir, on_token=sink, **kw)
        flush, flush_ms, step_ms = e.journal.flush, [], []

        def timed_flush():
            t = time.perf_counter()
            out = flush()
            flush_ms.append((time.perf_counter() - t) * 1e3)
            return out

        e.journal.flush = timed_flush
        rids = [e.submit(p, max_new_tokens=A1_JOURNAL_NEW) for p in prompts]
        for _ in range(A1_JOURNAL_STEPS):
            torch.cuda.synchronize()
            t = time.perf_counter()
            e.step()
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t) * 1e3)
        seen = sum(len(v) for v in TokenSink.collect(spath).values())
        if e._results or not seen:
            raise AssertionError(f"A1 journal: at the crash {len(e._results)} finished, "
                                 f"{seen} tokens delivered")
        sink.close()
        for arrs in e._arenas.values():     # the crashed engine's cache is gone
            for a in arrs:
                a.fill_(float("nan") if a.is_floating_point() and a.element_size() > 1 else 0)
        del e
        torch.cuda.empty_cache()
        sink = TokenSink(spath)
        e = ServingEngine(model, journal=jdir, on_token=sink, **kw)
        torch.cuda.synchronize()
        t = time.perf_counter()
        info = e.recover()
        t_rec = (time.perf_counter() - t) * 1e3
        outs = e.run()
        torch.cuda.synchronize()
        t_run = (time.perf_counter() - t) * 1e3 - t_rec
        sink.close()
        streams = TokenSink.collect(spath)   # raises on a duplicate or a gap
        if info["replayed"] != len(prompts):
            raise AssertionError(f"A1 journal: replayed {info}")
        a1_same("A1 journal", [outs[r] for r in rids], want, A1_JOURNAL_NEW)
        a1_same("A1 journal sink", [streams[r] for r in rids], want, A1_JOURNAL_NEW)
        e.pool.check_leaks()
    decode, fl = step_ms[1:], flush_ms[1:]      # the first step prefills all 8
    log(f"engine A1 journal {L}-layer bf16 on {card}: {seen} tokens delivered before the "
        f"crash, replayed {info['replayed']}; token-exact, every sink token exactly once; "
        f"flush {sum(fl) / len(fl):.3f} ms a decode step ({100 * sum(fl) / sum(decode):.2f}% "
        f"of its {sum(decode) / len(decode):.2f} ms); recover() {t_rec:.2f} ms, then run() "
        f"{t_run:.1f} ms to the end (8 re-prefills of {A1_PROMPT_LEN} tokens and "
        f"{A1_JOURNAL_NEW - 1} decode steps)")


def a1_cp_gate(torch, shallow, prompts, kw):
    """``ServingEngine(cp=2, prefix_cache=True)``: the first prompt
    prefills through the ring, the second (a hit) on the chunked path with
    reason ``prefix_cached``."""
    from paddle_tpu_torch.serving import ServingEngine

    e = ServingEngine(shallow, cp=2, prefix_cache=True, **kw)
    outs, _, counts, _ = a1_serve(torch, e, [prompts[:1], prompts[1:2]], A1_PREFIX_NEW)
    if e.cp_prefills != 1 or e.cp_fallbacks != {"prefix_cached": 1} \
            or e.prefix.summary()["hits"] != 1:
        raise AssertionError(f"A1 CP gate: {e.cp_prefills} ring prefills, fallbacks "
                             f"{e.cp_fallbacks}, {e.prefix.summary()}")
    if counts.get("ring_merge", 0) != 2 * 3 or any(
            o.shape != (A1_PREFIX_NEW,) or o.min() < 0 for o in outs):
        raise AssertionError(f"A1 CP gate: launches {counts}, outputs {outs}")
    e.prefix.clear()
    e.pool.check_leaks()
    log(f"engine A1 CP 2-layer cp 2 with the prefix cache: 1 ring prefill, the hit on the "
        f"chunked path (cp_fallbacks {e.cp_fallbacks}); launches {counts}")


def phase_engine_a1(torch, card, model):
    """The serving engine's remainder on Llama-2-7B (``model``, full width
    and depth, bf16, 16-token pages, ``max_batch`` 8): the prefix cache
    (``a1_prefix``: 7 hits, token-exact, TTFT of a miss and of a hit),
    the host-RAM offload tier (``a1_offload``: at least two swap-outs and
    recalls, no stall or eviction, token-exact, pages bit-equal after a
    recall; a tier too small for a victim stalls and stays token-exact;
    swap ms and GB/s beside a plain pinned copy of the same bytes), and the
    journal (``a1_journal``: a crash after 10 steps, a fresh engine
    recovers: replayed 8, token-exact, every sink token once; flush and
    replay ms).  At full width and 2 layers: int8 and fp8 pages through the
    prefix and offload runs, and the CP gate (``a1_cp_gate``).  Each run's
    launches are counted from zero: B1 and B2 once a layer every forward,
    nothing else (B10 under the CP gate)."""
    import dataclasses

    from paddle_tpu_torch.models import LlamaForCausalLM
    from paddle_tpu_torch.serving import ServingEngine

    cfg = model.config
    prefix, long = a1_prompts(cfg.vocab_size)
    p0 = next(model.parameters())
    shallow = LlamaForCausalLM(dataclasses.replace(cfg, num_hidden_layers=2),
                               device=p0.device, dtype=p0.dtype, seed=0).eval()
    for kind in ("int8", "fp8"):
        a1_prefix(torch, shallow, kind, prefix, ENGINE_KW, False)
        want, _, _, _ = a1_serve(torch, ServingEngine(shallow, kv_dtype=kind, **ENGINE_KW),
                                 [long], A1_OFFLOAD_NEW)
        a1_offload(torch, shallow, kind, long, want, ENGINE_KW, False)
        torch.cuda.empty_cache()
    a1_cp_gate(torch, shallow, prefix, ENGINE_KW)
    del shallow
    torch.cuda.empty_cache()

    a1_prefix(torch, model, "bf16", prefix, ENGINE_KW, True)
    torch.cuda.empty_cache()
    want, _, _, _ = a1_serve(torch, ServingEngine(model, **ENGINE_KW), [long], A1_OFFLOAD_NEW)
    torch.cuda.empty_cache()
    nbytes, times = a1_offload(torch, model, "bf16", long, want, ENGINE_KW, True)
    plain = a1_pinned_copy(torch, nbytes)

    def rate(ms):
        return f"{ms:.2f} ms ({nbytes / ms / 1e6:.2f} GB/s)"

    # the first swap-out also allocates the pinned buffer; later ones reuse it
    out1, outs = times["out"][0], sorted(times["out"][1:])
    ins = sorted(times["in"])
    log(f"engine A1 swap on {card}, one victim of {nbytes / 2**20:.1f} MiB: the first "
        f"swap-out {rate(out1)}, the median of the other {len(outs)} {rate(outs[len(outs) // 2])}; "
        f"recall, the first {rate(times['in'][0])}, the median of {len(ins)} "
        f"{rate(ins[len(ins) // 2])}; a plain pinned copy of the same bytes: to the host "
        f"{rate(plain['out'])}, to the card {rate(plain['in'])}")
    torch.cuda.empty_cache()
    a1_journal(torch, card, model, long, want, ENGINE_KW)
    torch.cuda.empty_cache()


A2_BEAMS, A2_NEW, A2_EOS, A2_LP = 4, 32, 2, 1.0
A2_BEAM_ROWS = (512, 512), (250, 511)       # unpadded; left-padded in 512
A2_RESCORE_RTOL = 1e-3
A2_SPEC_PROMPT, A2_SPEC_NEW, A2_SPEC_K, A2_SHALLOW_LAYERS = 512, 64, 4, 4
A2_DD = dict(embed=512, hidden=1024, vocab=32000, beam=4, batch=8, steps=32)


class StreamDrafter:
    """An oracle drafter: it knows the serial greedy stream of each prompt
    (``streams``: [(prompt, stream)]) and proposes its next tokens."""

    def __init__(self, streams):
        self.streams, self.probs, self._ctx = streams, None, []

    def begin(self, context):
        self._ctx = [int(t) for t in context]

    def observe(self, tokens):
        self._ctx.extend(int(t) for t in tokens)

    def propose(self, k, temperature=0.0, rng=None):
        for prompt, stream in self.streams:
            if self._ctx[:len(prompt)] == prompt:
                done = len(self._ctx) - len(prompt)
                return [int(t) for t in stream[done:done + k]]
        return []


def oracle_of(streams):
    streams = [([int(t) for t in p], [int(t) for t in s]) for p, s in streams]
    return lambda: StreamDrafter(streams)


def counted_forwards(torch, model, fn):
    """``fn()`` with launches counted from zero and ``model``'s forwards
    counted; returns (result, launches, forwards)."""
    n, fwd = [0], model.forward

    def counting(*a, **k):
        n[0] += 1
        return fwd(*a, **k)

    model.forward = counting
    try:
        result, counts = counted_launches(torch, fn)
    finally:
        del model.forward
    return result, counts, n[0]


def wall_s(torch, fn, repeats: int = 2) -> float:
    best = None
    for _ in range(repeats):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        best = min(best or 1e9, time.perf_counter() - t)
    return best


def a2_rescore(torch, model, ids, pad_lens, hyps, nrs, eos, lp):
    """Teacher-forced scores of the hypotheses ``hyps`` [b * nrs, T]: the
    same prefill at batch b, caches tiled ``nrs``-fold, then one cached
    step a token, summing each chosen token's log-prob up to its eos,
    over ``len ** lp``."""
    b, prompt = ids.shape
    T = hyps.shape[1]
    with torch.inference_mode():
        caches = model.new_kv_cache(b, -(-(prompt + T) // 8) * 8)
        logits, _ = model(ids, kv_cache=caches, position_offset=0, pad_lens=pad_lens)
        caches = [(k.repeat_interleave(nrs, 0), v.repeat_interleave(nrs, 0)) for k, v in caches]
        pl = None if pad_lens is None else pad_lens.repeat_interleave(nrs, 0)
        logp = torch.log_softmax(logits[:, -1].float(), -1).repeat_interleave(nrs, 0)
        total = torch.zeros(b * nrs, device=ids.device)
        n = torch.zeros(b * nrs, device=ids.device)
        alive = torch.ones(b * nrs, dtype=torch.bool, device=ids.device)
        for t in range(T):
            tok = hyps[:, t].long()
            total += torch.where(alive, logp.gather(1, tok[:, None])[:, 0], 0.0)
            n += alive.float()
            alive &= tok != eos
            if t < T - 1:
                logits, caches = model(tok[:, None], kv_cache=caches, position_offset=prompt + t,
                                       pad_lens=pl)
                logp = torch.log_softmax(logits[:, -1].float(), -1)
    return total / n.pow(lp)


def a2_beam(torch, card, model):
    """Beam search on ``model``: an unpadded and a left-padded batch of 2
    rows in 512, 4 beams, ``A2_NEW`` tokens, eos 2, every hypothesis
    returned.  Gates: K = 1 without eos token-exact against greedy
    ``generate`` on the same rows; each returned score within
    A2_RESCORE_RTOL of a teacher-forced rescoring of its ids (the same
    kernels at the same shapes, so only the order of the f32 sums differs;
    a hypothesis whose caches followed a wrong parent is off by O(1));
    launches exact: B3 L times for the prefill, B6 L times a beam step on
    b·K rows, B1 2L+1 and B2 L a forward.  Reports its time against greedy
    ``generate`` on the same b·K rows and the device time of one cache
    reorder."""
    import numpy as np

    cfg = model.config
    L, T, K = cfg.num_hidden_layers, A2_NEW, A2_BEAMS
    dev = next(model.parameters()).device
    rng = np.random.default_rng(10)
    for label, lens in zip(("unpadded", "left-padded"), A2_BEAM_ROWS):
        S = max(lens)
        ids = np.zeros((len(lens), S), np.int32)
        mask = np.zeros((len(lens), S), np.int32)
        for i, n in enumerate(lens):
            ids[i, S - n:] = rng.integers(3, cfg.vocab_size, n)
            mask[i, S - n:] = 1
        mask = None if mask.all() else mask
        ids_t = torch.as_tensor(ids, device=dev).long()
        pad_lens = None if mask is None else torch.as_tensor(
            S - mask.sum(1), dtype=torch.int32, device=dev)
        b = len(lens)
        greedy, _ = model.generate(ids, max_new_tokens=T, attention_mask=mask)
        with torch.inference_mode():
            k1, _ = model._generate_beam(ids_t, pad_lens, T, 1, -1, -1, 0, A2_LP, False)
        if not torch.equal(k1[:, 0], greedy):
            raise AssertionError(f"beam {label}: K = 1 differs from greedy generate: "
                                 f"{k1[:, 0].tolist()} != {greedy.tolist()}")
        kw = dict(max_new_tokens=T, num_beams=K, eos_token_id=A2_EOS, length_penalty=A2_LP,
                  num_return_sequences=K, attention_mask=mask)
        (hyps, scores), counts, n_fwd = counted_forwards(
            torch, model, lambda: model.generate(ids, **kw))
        want = dict(rms_norm=(2 * L + 1) * n_fwd, rope=L * n_fwd, flash_attention=L,
                    decode_attention=L * (n_fwd - 1))
        if counts != want or not 1 <= n_fwd <= T:
            raise AssertionError(f"beam {label}: launches {counts} over {n_fwd} forwards, "
                                 f"want {want}")
        if tuple(hyps.shape) != (b * K, T) or not torch.isfinite(scores).all() \
                or int(hyps.min()) < 0 or int(hyps.max()) >= cfg.vocab_size:
            raise AssertionError(f"beam {label}: bad output {hyps.shape} {scores.tolist()}")
        rescored = a2_rescore(torch, model, ids_t, pad_lens, hyps, K, A2_EOS, A2_LP)
        err = float(((rescored - scores).abs() / scores.abs()).max())
        log(f"beam {label} ({b} rows, K {K}, {T} new, eos {A2_EOS}): K = 1 equals greedy; "
            f"{n_fwd - 1} beam steps, launches {counts}; scores {scores.tolist()}; "
            f"rescored within {err:.3g} relative (tol {A2_RESCORE_RTOL}); eos in "
            f"{int((hyps == A2_EOS).any(1).sum())} of {b * K} hypotheses")
        if not err <= A2_RESCORE_RTOL:
            raise AssertionError(f"beam {label}: scores {scores.tolist()} vs teacher-forced "
                                 f"{rescored.tolist()}")
        mask_k = None if mask is None else np.repeat(mask, K, 0)
        t_beam = wall_s(torch, lambda: model.generate(ids, **kw))
        t_greedy = wall_s(torch, lambda: model.generate(np.repeat(ids, K, 0), max_new_tokens=T,
                                                       attention_mask=mask_k))
        log(f"beam {label} on {card}: {t_beam * 1e3:.1f} ms for {b} rows x {K} beams x {T} "
            f"tokens; greedy generate on the same {b * K} rows {t_greedy * 1e3:.1f} ms "
            f"(beam / greedy {t_beam / t_greedy:.3f})")
    rows = 2 * K
    caches = model.new_kv_cache(rows, -(-(max(A2_BEAM_ROWS[0]) + T) // 8) * 8)
    perm = torch.arange(rows, device=dev).flip(0)
    nbytes = 2 * sum(c.numel() * c.element_size() for kv in caches for c in kv)

    def reorder():
        return [(k.index_select(0, perm), v.index_select(0, perm)) for k, v in caches]

    ms, _ = device_ms(torch, reorder, iters=5)
    log(f"beam cache reorder on {card} ({L} layers, {rows} rows of "
        f"{caches[0][0].shape[1]} slots, bf16): {ms:.4f} ms device time, "
        f"{nbytes / ms / 1e6:.1f} GB/s of {nbytes / 2**30:.3f} GiB read and written "
        f"(bound {nbytes / HBM_BYTES_PER_S * 1e3:.4f} ms)")
    del caches


def first_diff(got, want):
    """Index of the first token where ``got`` and ``want`` differ, or None."""
    return next((i for i, (g, w) in enumerate(zip(got, want)) if int(g) != int(w)), None)


def record_logits(torch, model, fn, first):
    """``fn()`` with every batch-1 forward of ``model`` recording its f32
    logits by absolute position, from position ``first`` on (a later
    forward over a position replaces an earlier one's row: the last one is
    what chose the token).  Returns (result, {position: logits})."""
    rec, fwd = {}, model.forward

    def spy(ids, *a, **k):
        out = fwd(ids, *a, **k)
        pos, rows = k.get("position_offset", 0), out[0][0]
        for j in range(max(first - pos, 0), rows.shape[0]):
            rec[pos + j] = rows[j].float().cpu()
        return out

    model.forward = spy
    try:
        result = fn()
    finally:
        del model.forward
    return result, rec


def certify_divergence(torch, label, got, want, got_logits, want_logits, gate):
    """Two greedy streams that run different attention code (a verify
    window against a serial step) in bf16 may part at a near-tie.  Where
    they part, at token i, the logits that chose token i on each path
    (``*_logits[i]``) must each pick its own stream's token and, when
    ``gate``, agree within LOGITS_REL_TOL (the 2-layer tolerance between
    two bf16 paths): the two tokens were a near-tie there, not a fault.
    Returns (tokens that match, a line for the log)."""
    i = first_diff(got, want)
    if i is None:
        return len(want), "token-exact"
    s, v = want_logits[i], got_logits[i]
    w, g = int(want[i]), int(got[i])
    r = rel_l2(v, s)
    note = (f"part at token {i}: serial {w}, other {g}; serial path's logits of the two "
            f"{float(s[w]):.4f} / {float(s[g]):.4f}, other path's {float(v[w]):.4f} / "
            f"{float(v[g]):.4f}; the paths' logits there {r:.4g} relative L2 apart")
    if int(s.argmax()) != w or int(v.argmax()) != g:
        raise AssertionError(f"{label}: recorded logits do not choose the tokens; {note}")
    if gate and not r <= LOGITS_REL_TOL:
        raise AssertionError(f"{label}: {note} (tol {LOGITS_REL_TOL})")
    return i, note


def a2_spec_run(torch, model, prompt, drafter, layers=0, record=False):
    """``speculative_generate`` on one prompt, launches counted; a model
    drafter's single-token steps are counted; with ``record``, the
    logits that chose each token.  Returns (ids, stats, launches, drafter
    steps, seconds, logits by token)."""
    from paddle_tpu_torch.generation import ShallowExitDrafter, speculative_generate

    steps, made = [0], []
    if layers:
        cap = A2_SPEC_PROMPT + A2_SPEC_NEW + A2_SPEC_K

        def drafter():
            d = ShallowExitDrafter(model, cap, draft_layers=layers)
            step = d._step

            def counted(tok, pos):
                steps[0] += 1
                return step(tok, pos)

            d._step = counted
            made.append(d)
            return d

    def run():
        return counted_launches(torch, lambda: speculative_generate(
            model, prompt[None], max_new_tokens=A2_SPEC_NEW, drafter=drafter, k=A2_SPEC_K))

    torch.cuda.synchronize()
    t = time.perf_counter()
    if record:
        ((ids, stats), counts), rec = record_logits(torch, model, run, len(prompt) - 1)
    else:
        ((ids, stats), counts), rec = run(), {}
    secs = time.perf_counter() - t
    for d in made:       # the counting step closes over the drafter: break the cycle
        del d._step
    by_token = [rec.get(len(prompt) - 1 + i) for i in range(A2_SPEC_NEW)]
    return ids[0].cpu().numpy(), stats, counts, steps[0], secs, by_token


def a2_generate(torch, model, prompt):
    """Greedy ``generate`` on one prompt: its ids, the logits that chose
    each token, and its seconds."""
    torch.cuda.synchronize()
    t = time.perf_counter()
    (ids, _), rec = record_logits(torch, model, lambda: model.generate(
        prompt[None], max_new_tokens=A2_SPEC_NEW), len(prompt) - 1)
    secs = time.perf_counter() - t
    return (ids[0].cpu().numpy(), [rec[len(prompt) - 1 + i] for i in range(A2_SPEC_NEW)],
            secs)


def a2_spec_gate(torch, label, model, prompt, dl, exact):
    """The n-gram, shallow-exit (``dl`` layers) and oracle drafters against
    ``generate``: token-exact, the oracle accepting everything, when
    ``exact`` (f32); else (bf16) token-exact or parted at a certified
    near-tie (``certify_divergence``), the oracle accepting everything up
    to there.  Tokens/s of each run (one run each, logits recorded)."""
    want, want_logits, t_gen = a2_generate(torch, model, prompt)
    for name, dr, layers in (("ngram", "ngram", 0), (f"shallow-exit {dl}", None, dl),
                             ("oracle", oracle_of([(prompt, want)]), 0)):
        got, st, _, _, secs, got_logits = a2_spec_run(torch, model, prompt, dr, layers,
                                                      record=True)
        same, note = certify_divergence(torch, f"speculative {label} {name}", got, want,
                                        got_logits, want_logits, gate=True)
        if exact and same != len(want):
            raise AssertionError(f"speculative {label} {name}: {note}")
        if name == "oracle" and same == len(want) and st["acceptance_rate"] != 1.0:
            raise AssertionError(f"speculative {label} oracle: acceptance {st['acceptance_rate']}")
        log(f"speculative {label} {name}: {note} ({same} of {A2_SPEC_NEW} tokens equal "
            f"generate's), acceptance {st['acceptance_rate']}, "
            f"{st['effective_tokens_per_step']:.3f} tokens a step; {A2_SPEC_NEW / secs:.1f} "
            f"tokens/s against generate's {A2_SPEC_NEW / t_gen:.1f} (one run each)")


def a2_speculative(torch, card, model, shallow, ref32):
    """``speculative_generate`` at batch 1 (prompt 512, ``A2_SPEC_NEW`` new
    tokens, k 4) with the n-gram drafter, ``ShallowExitDrafter`` and an
    oracle drafter (the greedy stream).  Gates (``a2_spec_gate``): at full
    depth in f32 weights token-exact against ``generate`` and the oracle's
    acceptance 1.0; at 2 layers in bf16 the same, or parted at a certified
    near-tie.  At full depth in bf16: launches exact (B3 L for the
    prefill; B6 only in the drafter's steps, its layers a step; B1 and B2
    per forward of the target and of the drafter), and reports tokens/s
    against ``generate``, the acceptance, tokens a verify step, the verify
    forward's ms against a serial step's, and where the stream parts from
    ``generate``'s."""
    import numpy as np

    cfg = model.config
    L = cfg.num_hidden_layers
    prompt = np.random.default_rng(11).integers(3, cfg.vocab_size, A2_SPEC_PROMPT).astype(np.int32)
    a2_spec_gate(torch, "2-layer bf16", shallow, prompt, 1, exact=False)
    a2_spec_gate(torch, f"{L}-layer f32", ref32, prompt, A2_SHALLOW_LAYERS, exact=True)

    t_gen = wall_s(torch, lambda: model.generate(prompt[None], max_new_tokens=A2_SPEC_NEW))
    want, want_logits, _ = a2_generate(torch, model, prompt)
    log(f"speculative {L}-layer bf16 on {card}: generate {A2_SPEC_NEW / t_gen:.1f} tokens/s "
        f"({t_gen * 1e3:.1f} ms, batch 1, prompt {A2_SPEC_PROMPT})")
    dl = A2_SHALLOW_LAYERS
    for name, dr, layers in (("ngram", "ngram", 0), (f"shallow-exit {dl}", None, dl),
                             ("oracle", oracle_of([(prompt, want)]), 0)):
        got, _, _, _, _, got_logits = a2_spec_run(torch, model, prompt, dr, layers, record=True)
        _, note = certify_divergence(torch, f"speculative {L}-layer bf16 {name}", got, want,
                                     got_logits, want_logits, gate=False)
        _, st, counts, steps, secs, _ = a2_spec_run(torch, model, prompt, dr, layers)
        n_fwd = 1 + st["verify_steps"]
        want_counts = dict(rms_norm=(2 * L + 1) * n_fwd + (2 * layers + 1) * steps,
                           rope=L * n_fwd + layers * steps, flash_attention=L,
                           decode_attention=layers * steps)
        want_counts = {k: c for k, c in want_counts.items() if c}
        if counts != want_counts:
            raise AssertionError(f"speculative {name}: launches {counts}, {st['verify_steps']} "
                                 f"verify steps and {steps} drafter steps launch {want_counts}")
        log(f"speculative {L}-layer bf16 {name} on {card}: {A2_SPEC_NEW / secs:.1f} tokens/s "
            f"({secs * 1e3:.1f} ms; generate {t_gen * 1e3:.1f}), acceptance "
            f"{st['acceptance_rate']}, {st['effective_tokens_per_step']:.3f} tokens a step over "
            f"{st['verify_steps']} verify steps, {steps} drafter steps; launches {counts}; "
            f"against generate's stream: {note}")

    # one verify forward (1 + k tokens) against one serial step, at the
    # position the stream's middle reaches
    pos = A2_SPEC_PROMPT + A2_SPEC_NEW // 2
    caches = model.new_kv_cache(1, -(-(A2_SPEC_PROMPT + A2_SPEC_NEW + A2_SPEC_K) // 8) * 8)
    toks = {s: torch.as_tensor(prompt[None, :s], device=caches[0][0].device).long()
            for s in (1, 1 + A2_SPEC_K)}
    ms = {}
    with torch.inference_mode():
        for s, tk in toks.items():
            ms[s] = time_ms(torch, lambda: model(tk, kv_cache=caches, position_offset=pos),
                            iters=10, repeats=3)
    log(f"speculative {L}-layer bf16 on {card}: a verify forward of {1 + A2_SPEC_K} tokens "
        f"{ms[1 + A2_SPEC_K]:.3f} ms, a serial step {ms[1]:.3f} ms (ratio "
        f"{ms[1 + A2_SPEC_K] / ms[1]:.3f}) at position {pos}")
    del caches


def a2_serve(torch, model, prompts, spec):
    """Serve ``prompts`` (MAX_NEW tokens each) on a bf16-page engine with
    ``speculative=spec``; returns the outputs, the engine's summary, the
    decode forwards' widths and ms (synchronised), the f32 logits that
    chose each decoded token, by (prompt, token), and the run's seconds."""
    from paddle_tpu_torch.serving import ServingEngine

    e = ServingEngine(model, speculative=spec, **ENGINE_KW)
    widths, ms, rec = set(), [], {}
    fwd = e._forward
    rids = {}

    def spy(tokens, positions, tables, n_tok, **k):
        if tokens.shape[0] != e.max_batch:
            return fwd(tokens, positions, tables, n_tok, **k)
        widths.add(tuple(tokens.shape))
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fwd(tokens, positions, tables, n_tok, **k)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t) * 1e3)
        for row, r in e._active.items():
            i, p = rids[r.rid], len(r.prompt)
            for j in range(int(n_tok[row])):
                rec[(i, int(positions[row]) + j - p + 1)] = out[row, j].float().cpu()
        return out

    e._forward = spy
    for i, p in enumerate(prompts):
        rids[e.submit(p, max_new_tokens=MAX_NEW)] = i
    torch.cuda.synchronize()
    t = time.perf_counter()
    res = e.run()            # raises on a leaked page
    secs = time.perf_counter() - t
    del e._forward           # the spy closes over the engine: break the cycle
    e.pool.check_leaks()
    outs = [list(res[r]) for r in rids]
    summary = e.meter.summary()
    del e
    torch.cuda.empty_cache()
    return outs, summary, widths, ms, rec, secs


def a2_engine(torch, card, model, shallow, ref32):
    """``ServingEngine(speculative=4)`` on the 8 ragged prompts of
    ``phase_engine`` (bf16 pages, MAX_NEW tokens) with the n-gram and the
    oracle drafters.  Gates: every decode forward [8, 5] wide and no
    leaked page; at full depth in f32 weights token-exact against the
    serial engine and the oracle's acceptance 1.0; at 2 layers in bf16 the
    same, or each parted stream certified a near-tie
    (``certify_divergence``).  At full depth in bf16, reports the decode
    forward's ms at S = 5 against S = 1, tokens a step, the acceptance and
    the tokens that match the serial engine's."""
    import numpy as np

    from paddle_tpu_torch.generation import SpecConfig

    cfg = model.config
    rng = np.random.default_rng(4)
    prompts = [rng.integers(1, cfg.vocab_size, n).astype(np.int32) for n in ENGINE_PROMPT_LENS]
    width = {(BATCH, 1 + A2_SPEC_K)}
    L = cfg.num_hidden_layers
    for label, m, gate in (("2-layer bf16", shallow, "near-tie"), (f"{L}-layer f32", ref32, "exact"),
                           (f"{L}-layer bf16", model, None)):
        serial, _, w1, ms1, rec1, secs1 = a2_serve(torch, m, prompts, None)
        oracle = oracle_of(list(zip(prompts, serial)))
        for name, spec in (("ngram", A2_SPEC_K), ("oracle", SpecConfig(k=A2_SPEC_K, drafter=oracle))):
            outs, s, w, ms, rec, secs = a2_serve(torch, m, prompts, spec)
            same, notes = 0, []
            for i, (o, r) in enumerate(zip(outs, serial)):
                n, note = certify_divergence(
                    torch, f"engine speculative {label} {name} request {i}", o, r,
                    [rec.get((i, t)) for t in range(MAX_NEW)],
                    [rec1.get((i, t)) for t in range(MAX_NEW)], gate=gate == "near-tie")
                same += n
                if n < MAX_NEW:
                    notes.append(f"request {i}: {note}")
            log(f"engine speculative {label} {name}: {same} of {BATCH * MAX_NEW} tokens match "
                f"the serial engine's{'; ' if notes else ''}{'; '.join(notes)}; acceptance "
                f"{s['spec_acceptance']}, {s['effective_tokens_per_step']} tokens a row a step; "
                f"decode forwards {sorted(w)}: {len(ms)} at {np.median(ms):.2f} ms (median), "
                f"serial {sorted(w1)}: {len(ms1)} at {np.median(ms1):.2f} ms; the run "
                f"{secs:.2f} s, serial {secs1:.2f} s (with the prefills)")
            if w != width:
                raise AssertionError(f"engine speculative {label} {name}: decode widths {w}")
            if gate == "exact" and same != BATCH * MAX_NEW:
                raise AssertionError(f"engine speculative {label} {name}: streams differ from "
                                     f"the serial engine's")
            if gate and name == "oracle" and same == BATCH * MAX_NEW \
                    and s["spec_acceptance"] != 1.0:
                raise AssertionError(f"engine speculative {label} oracle: acceptance "
                                     f"{s['spec_acceptance']}")


def a2_dynamic_decode(torch, card, dev="cuda"):
    """``dynamic_decode`` of a ``BeamSearchDecoder`` over a ``GRUCell``
    (embed 512, hidden 1024, vocab 32000, beam 4, batch 8, 32 steps), on
    the card and on the CPU from the same seeded weights and states: the
    back-traced ids, lengths and finished flags equal, the final
    log-probs within the f32 row of tests/op_test.py."""
    from paddle_tpu_torch import nn

    c = A2_DD
    g = torch.Generator().manual_seed(0)
    embed = nn.Embedding(c["vocab"], c["embed"], std=0.5, generator=g, device="cpu")
    cell = nn.GRUCell(c["embed"], c["hidden"], generator=g)
    out = nn.Linear(c["hidden"], c["vocab"], std=0.1, generator=g, device="cpu")
    h0 = torch.randn(c["batch"], c["hidden"], generator=g)
    runs = {}
    for where in ("cpu", dev):
        mods = [mod.to(where) for mod in (embed, cell, out)]
        dec = nn.BeamSearchDecoder(mods[1], 0, 1, c["beam"], embedding_fn=mods[0],
                                   output_fn=mods[2])

        def run():
            with torch.inference_mode():
                return nn.dynamic_decode(dec, inits=h0.to(where), max_step_num=c["steps"] - 1,
                                         return_length=True)

        t = time.perf_counter()
        runs[where] = run()
        secs = time.perf_counter() - t
        if where == dev:
            torch.cuda.synchronize()
            secs = wall_s(torch, run)
        log(f"dynamic_decode on {where}: {secs * 1e3:.1f} ms")
    (ids_c, st_c, len_c), (ids_g, st_g, len_g) = runs["cpu"], runs[dev]
    if tuple(ids_g.shape) != (c["batch"], c["steps"], c["beam"]):
        raise AssertionError(f"dynamic_decode: shape {tuple(ids_g.shape)}")
    for name, a, b in (("ids", ids_g, ids_c), ("lengths", len_g, len_c),
                       ("finished", st_g.finished, st_c.finished)):
        if not torch.equal(a.cpu(), b):
            raise AssertionError(f"dynamic_decode: {name} on the card differ from the CPU's")
    err = check_close(torch, "dynamic_decode log_probs", st_g.log_probs.cpu(), st_c.log_probs,
                      TOL["float32"])
    log(f"dynamic_decode on {card} vs CPU ({c}): ids, lengths and finished equal, log_probs "
        f"within {err:.3g} (f32 row); {int(st_g.finished.sum())} of "
        f"{c['batch'] * c['beam']} beams finished")


def phase_generation_a2(torch, card, model):
    """Generation's remainder on Llama-2-7B (``model``, bf16, full width
    and depth): beam search (``a2_beam``), ``speculative_generate``
    (``a2_speculative``), ``ServingEngine(speculative=4)``
    (``a2_engine``) and ``nn.dynamic_decode`` (``a2_dynamic_decode``).
    The token-exact gates run at full depth in an f32 copy of the weights;
    in bf16, a verify window and a serial step (different attention code)
    may part at a near-tie even at 2 layers, so there a parting is
    certified (``certify_divergence``) and at full depth reported."""
    import dataclasses

    from paddle_tpu_torch.models import LlamaForCausalLM

    t0 = time.perf_counter()
    a2_beam(torch, card, model)
    torch.cuda.empty_cache()
    p0 = next(model.parameters())
    shallow = LlamaForCausalLM(dataclasses.replace(model.config, num_hidden_layers=2),
                               device=p0.device, dtype=p0.dtype, seed=0).eval()
    ref32 = copy.deepcopy(model).float()
    a2_speculative(torch, card, model, shallow, ref32)
    torch.cuda.empty_cache()
    a2_engine(torch, card, model, shallow, ref32)
    del shallow, ref32
    gc.collect()
    torch.cuda.empty_cache()
    a2_dynamic_decode(torch, card)
    log(f"generation A2 phase: {time.perf_counter() - t0:.1f} s")


def rel_l2(a, b) -> float:
    a, b = a.float(), b.float()
    return float((a - b).norm() / b.norm())


def loss_and_grads(torch, model, ids, labels, flags=None, grad_dtype=None):
    """One loss and backward; the loss and every parameter's gradient (a
    copy, in ``grad_dtype`` if given)."""
    import paddle_tpu_torch as ptt

    model.zero_grad(set_to_none=True)
    with ptt.flag_guard(**(flags or {})):
        loss = model(ids, labels=labels)[0].float()
        loss.backward()
    grads = {n: p.grad.to(grad_dtype or p.grad.dtype, copy=True)
             for n, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    return loss.detach(), grads


def phase_train(torch, card):
    """The training step at Llama-2-7B width: AMP O2 bf16, AdamW(1e-4) with
    ClipGradByGlobalNorm(1.0), through TrainStep, labels rolled as in
    bench.py, with ``use_fused_swiglu`` and ``use_fused_adamw`` on.  Gates:
    at 2 layers the kernels' loss and grads agree with the plain path's; at
    8 layers the kernels' grads are no further from an f32 reference than
    the plain bf16 path's; ten 8-layer steps at 4 x 2048 on one batch give
    finite, falling losses and launch each kernel as often as the path
    needs.  Then tokens/s, MFU, peak memory and a profile; then the same
    steps with the two fused flags off, timed for comparison.  Returns the
    flags-on run's (launches, losses, ms a step), which ``phase_dist``
    holds its DataParallel steps against."""
    ids, labels = train_batch(torch, 32000)
    gate_shallow(torch, make_llama, LLAMA_ON, ids[:1], labels[:1])
    gate_deep(torch, make_llama, TRAIN_LAYERS, LLAMA_ON, ids[:1], labels[:1])
    torch.cuda.empty_cache()
    on = train_steps(torch, card, make_llama, TRAIN_LAYERS, LLAMA_ON, ids, labels)
    torch.cuda.empty_cache()
    train_steps(torch, card, make_llama, TRAIN_LAYERS,
                dict(use_fused_swiglu=False, use_fused_adamw=False), ids, labels)
    return on


FUSED_CE_CHUNK = 1024              # phase_fused_ce: fused_ce_chunk of the chunked loss
FUSED_CE_WARMUP, FUSED_CE_STEPS = 2, 5


def fused_ce_run(torch, chunk, ids, labels, cfg=None, dev="cuda"):
    """FUSED_CE_WARMUP then FUSED_CE_STEPS TrainSteps of the 8-layer
    Llama-2-7B-width model (seed 0) under AMP O2 with LLAMA_ON and
    ``fused_ce_chunk=chunk``: (losses, ms a counted step, peak bytes of the
    counted steps, their launches)."""
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models import LlamaForCausalLM, llama2_7b
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    from paddle_tpu_torch.ops import LAUNCHES, reset_launch_counts
    from paddle_tpu_torch.optimizer import AdamW

    gc.collect()
    torch.cuda.empty_cache()
    cfg = cfg or llama2_7b(num_hidden_layers=TRAIN_LAYERS)
    model = LlamaForCausalLM(dataclasses.replace(cfg, fused_ce_chunk=chunk), device=dev, seed=0)
    opt = AdamW(1e-4, parameters=model.parameters(), grad_clip=ClipGradByGlobalNorm(1.0))
    model, opt = ptt.amp.decorate(model, opt, level="O2", dtype="bfloat16")
    step = TrainStep(model, lambda m, x, y: m(x, labels=y)[0], opt)
    with ptt.flag_guard(**LLAMA_ON):
        losses = [float(step(ids, labels)) for _ in range(FUSED_CE_WARMUP)]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        t0 = time.perf_counter()
        out = [step(ids, labels) for _ in range(FUSED_CE_STEPS)]
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / FUSED_CE_STEPS * 1e3
        launches, peak = dict(LAUNCHES), torch.cuda.max_memory_allocated()
    del model, opt, step
    return losses + [float(x) for x in out], ms, peak, launches


def fused_ce_alone(torch, dev="cuda", shape=(TRAIN_BATCH * TRAIN_SEQ, 4096, 32000)):
    """``F.fused_linear_cross_entropy`` (chunk FUSED_CE_CHUNK) against
    ``F.cross_entropy`` on the full logits of the same product, forward and
    backward, at the 4 x 2048-token batch's head: hidden [8192, 4096] and
    weight [4096, 32000] in bf16.  Each one's ms and the peak it adds
    above its inputs; the two losses and grads within the bf16 row."""
    from paddle_tpu_torch.nn import functional as F

    gen = torch.Generator(device=dev).manual_seed(4)
    n, d, vocab = shape
    h = torch.randn(n, d, generator=gen, device=dev).to(torch.bfloat16).requires_grad_()
    w = (torch.randn(d, vocab, generator=gen, device=dev) * 0.02).to(torch.bfloat16)
    w.requires_grad_()
    lab = torch.randint(0, vocab, (n,), generator=gen, device=dev)
    fns = {"fused": lambda: F.fused_linear_cross_entropy(h, w, lab, chunk_size=FUSED_CE_CHUNK),
           "full logits": lambda: F.cross_entropy(h @ w, lab)}
    out = {}
    for name, fn in fns.items():
        def fwd_bwd():
            return torch.autograd.grad(fn(), (h, w))
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        loss = fn()
        grads = torch.autograd.grad(loss, (h, w))
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        ms = time_ms(torch, fwd_bwd, iters=5, repeats=3)
        out[name] = dict(loss=float(loss.detach()), grads=grads, ms=ms, peak=peak)
        log(f"fused_ce alone {name} [{n}, {d}] x [{d}, {vocab}] bf16 forward and backward: "
            f"{ms:.3f} ms, peak {peak / 2**30:.3f} GiB above the inputs")
    a, b = out["fused"], out["full logits"]
    if abs(a["loss"] - b["loss"]) > LOGITS_REL_TOL * abs(b["loss"]) \
            or max(rel_l2(x, y) for x, y in zip(a["grads"], b["grads"])) > LOGITS_REL_TOL:
        raise AssertionError(f"fused_ce alone: loss {a['loss']} against {b['loss']}, grads "
                             f"{[rel_l2(x, y) for x, y in zip(a['grads'], b['grads'])]}")
    return {k: dict(ms=v["ms"], peak_gib=v["peak"] / 2**30) for k, v in out.items()}


def phase_fused_ce(torch, card, cfg=None, dev="cuda", batch=None, alone_shape=None):
    """The chunked fused linear + cross entropy (``fused_ce_chunk``) on the
    training path: Llama-2-7B width, 8 layers, one 4 x 2048 batch, AMP O2
    with the fused flags on, as ``phase_train``.  Gates: on one model, the
    chunked loss and every grad within LOGITS_REL_TOL (relative L2, the
    2-layer gate of ``phase_train``) of the loss over the full logits; the
    chunked steps' losses within it of the unchunked steps' from the same
    weights (the first two steps' relative to each loss, the later ones,
    once the batch is memorised, relative to the first loss), with the
    same launches a step.  Logs each run's ms a step and
    peak memory, and the fused loss alone against ``F.cross_entropy`` on
    the full logits (``fused_ce_alone``)."""
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.models import LlamaForCausalLM, llama2_7b

    t0 = time.perf_counter()
    cfg = cfg or llama2_7b(num_hidden_layers=TRAIN_LAYERS)
    ids, labels = batch or train_batch(torch, cfg.vocab_size)
    gc.collect()
    torch.cuda.empty_cache()
    chunked = dataclasses.replace(cfg, fused_ce_chunk=FUSED_CE_CHUNK)
    model = ptt.amp.decorate(LlamaForCausalLM(chunked, device=dev, seed=0),
                             level="O2", dtype="bfloat16")
    lf, gf = loss_and_grads(torch, model, ids, labels, LLAMA_ON)
    model.config.fused_ce_chunk = 0
    lu, gu = loss_and_grads(torch, model, ids, labels, LLAMA_ON)
    del model
    r_loss = abs(float(lf) - float(lu)) / abs(float(lu))
    rows = sorted(((rel_l2(gf[n], gu[n]), n) for n in gu), reverse=True)
    log(f"fused_ce {cfg.num_hidden_layers}-layer {list(ids.shape)}: loss chunked "
        f"{float(lf):.6f}, full logits {float(lu):.6f} (relative {r_loss:.3g}); grad relative "
        f"L2, worst three: " + "; ".join(f"{n} {r:.4g}" for r, n in rows[:3]))
    if r_loss > LOGITS_REL_TOL or rows[0][0] > LOGITS_REL_TOL:
        raise AssertionError(f"fused_ce gate: loss {r_loss}; grads {rows[:3]}")
    del gf, gu
    runs = {chunk: fused_ce_run(torch, chunk, ids, labels, cfg, dev)
            for chunk in (FUSED_CE_CHUNK, 0)}
    (lc, ms_c, peak_c, launch_c), (l0, ms_0, peak_0, launch_0) = runs[FUSED_CE_CHUNK], runs[0]
    log(f"fused_ce steps on {card}: chunk {FUSED_CE_CHUNK}: {ms_c:.1f} ms a step, peak "
        f"{peak_c / 2**30:.2f} GiB; chunk 0: {ms_0:.1f} ms a step, peak {peak_0 / 2**30:.2f} "
        f"GiB; the chunked loss takes {(ms_c / ms_0 - 1) * 100:+.2f}% time and "
        f"{(peak_c - peak_0) / 2**30:+.3f} GiB; losses chunked "
        f"{' '.join(f'{x:.4f}' for x in lc)}, full {' '.join(f'{x:.4f}' for x in l0)}")
    # both runs memorise the one batch: after two steps the losses fall below
    # 1% of the first, where two bf16 runs part by more than 2e-2 of their
    # own size, so each step's distance is taken against the first loss
    worst = max(abs(a - b) / (abs(b) if i < 2 else abs(l0[0]))
                for i, (a, b) in enumerate(zip(lc, l0)))
    if worst > LOGITS_REL_TOL or launch_c != launch_0 or not all(map(math.isfinite, lc)):
        raise AssertionError(f"fused_ce steps: losses part by {worst}; launches {launch_c} "
                             f"against {launch_0}")
    alone = fused_ce_alone(torch, dev, *([alone_shape] if alone_shape else []))
    log(f"fused_ce phase: {time.perf_counter() - t0:.1f} s")
    return dict(step_ms={FUSED_CE_CHUNK: ms_c, 0: ms_0},
                peak_gib={FUSED_CE_CHUNK: peak_c / 2**30, 0: peak_0 / 2**30}, alone=alone)


def phase_gpt_train(torch, card):
    """The training step of GPT-3 1.3B at full width and depth, as the
    Llama one, with ``use_fused_layernorm`` and ``use_fused_adamw`` on:
    the 2-layer and 24-layer gates, then 3 warm-up and 10 counted steps;
    then the same steps with the two fused flags off, timed for
    comparison."""
    from paddle_tpu_torch.models import gpt3_1p3b

    L = gpt3_1p3b().num_hidden_layers
    ids, labels = train_batch(torch, gpt3_1p3b().vocab_size)
    gate_shallow(torch, make_gpt, GPT_ON, ids[:1], labels[:1])
    gate_deep(torch, make_gpt, L, GPT_ON, ids[:1], labels[:1])
    torch.cuda.empty_cache()
    launches = train_steps(torch, card, make_gpt, L, GPT_ON, ids, labels)[0]
    torch.cuda.empty_cache()
    train_steps(torch, card, make_gpt, L, dict(use_fused_layernorm=False, use_fused_adamw=False),
                ids, labels)
    return launches


def phase_gpt_generate(torch, card):
    """Greedy ``generate`` on GPT-3 1.3B bf16 (batch 8, prompt 128, 8 new
    tokens): the prefill's flash and each decode step's B6 launches, a
    well-formed result, and the share of tokens the plain path agrees on."""
    import numpy as np

    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.models import GPTForCausalLM, gpt3_1p3b
    from paddle_tpu_torch.ops import LAUNCHES, reset_launch_counts

    cfg = gpt3_1p3b()
    L, T = cfg.num_hidden_layers, GPT_GEN_NEW
    model = GPTForCausalLM(cfg, device="cuda", dtype=torch.bfloat16, seed=0).eval()
    ids = np.random.default_rng(2).integers(0, cfg.vocab_size, (BATCH, GPT_GEN_PROMPT))
    torch.cuda.synchronize()
    reset_launch_counts()
    t = time.perf_counter()
    out, scores = model.generate(ids.astype(np.int32), max_new_tokens=T)
    torch.cuda.synchronize()
    took = time.perf_counter() - t
    launches = dict(LAUNCHES)
    want = dict.fromkeys(LAUNCHES, 0)
    want.update(flash_attention=L, decode_attention=L * (T - 1))
    log(f"gpt generate {BATCH}x{GPT_GEN_PROMPT} + {T} on {card}: {took:.2f} s, "
        f"launches {launches}")
    if launches != want:
        raise AssertionError(f"gpt generate launches {launches}, want {want}")
    if tuple(out.shape) != (BATCH, T) or not torch.isfinite(scores).all() \
            or int(out.min()) < 0 or int(out.max()) >= cfg.vocab_size:
        raise AssertionError(f"gpt generate: bad output {out} {scores}")
    with ptt.flag_guard(**OFF_FLAGS):
        plain, _ = model.generate(ids.astype(np.int32), max_new_tokens=T)
    log(f"gpt generate greedy tokens identical to the plain path: "
        f"{float((out == plain).float().mean()):.4f} of {BATCH * T}")
    del model


ERNIE_TIMED = 3                     # phase_ernie: forwards timed a configuration
ERNIE_MS = {}                       # phase_ernie's ms a forward: (model, dtype, path) -> ms


def ernie_forward(torch, model, ids, segments, mask=None):
    """One eval forward under no_grad, synchronised: (output, launches)."""
    from paddle_tpu_torch.ops import LAUNCHES, reset_launch_counts

    torch.cuda.synchronize()
    reset_launch_counts()
    with torch.no_grad():
        out = model(ids, segments, mask)
    torch.cuda.synchronize()
    return out, dict(LAUNCHES)


def phase_ernie(torch, card, cfg=None, dev="cuda", batch=(ERNIE_BATCH, ERNIE_SEQ)):
    """ERNIE 3.0 base inference at its published width (``ErnieConfig()``:
    12 layers, hidden 768, 12 heads, FFN 3072, vocab 40000), eval, batch 16
    x 512 tokens with segment ids, random weights from seed 0:
    ``ErnieForSequenceClassification`` and ``ErnieForMaskedLM`` in f32 and
    in bf16 (``Layer.to(dtype="bfloat16")``), each with the flash kernel
    (B3, 12 launches a forward and no other) and on the plain path (no
    launch).  Gates, against the f32 plain path's logits: f32 with the
    kernel within 1e-4 relative L2 (the f32 attention row); bf16 with the
    kernel within LOGITS_REL_TOL or no further than DEPTH_REL_MARGIN times
    the plain bf16 path.  A batch with a padding mask takes the masked
    composite: no launch, bit-equal to the flag-off run, finite.  Logs each
    forward's ms and tokens/s.  Returns one counted kernel forward's
    launches."""
    import numpy as np

    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.models import (ErnieConfig, ErnieForMaskedLM,
                                         ErnieForSequenceClassification)
    from paddle_tpu_torch.ops import LAUNCHES

    t_phase = time.perf_counter()
    cfg = cfg or ErnieConfig()
    b, s = batch
    rng = np.random.default_rng(12)
    ids = torch.as_tensor(rng.integers(0, cfg.vocab_size, (b, s)), device=dev)
    segments = torch.as_tensor(rng.integers(0, 2, (b, s)), device=dev)
    lengths = rng.integers(s // 4, s + 1, b)
    mask = torch.as_tensor(np.arange(s)[None, :] < lengths[:, None], device=dev).to(torch.int32)
    tokens = b * s
    want = dict.fromkeys(LAUNCHES, 0)
    counted = None
    for cls in (ErnieForSequenceClassification, ErnieForMaskedLM):
        gc.collect()
        torch.cuda.empty_cache()
        name = cls.__name__[len("ErnieFor"):]
        model = cls(cfg, device=dev, seed=0).eval()
        with ptt.flag_guard(**OFF_FLAGS):
            ref, _ = ernie_forward(torch, model, ids, segments)
        errors = {}
        for dtype in ("float32", "bfloat16"):
            model.to(dtype=dtype)
            for path, flags in (("kernel", {}), ("plain", OFF_FLAGS)):
                with ptt.flag_guard(**flags):
                    out, launches = ernie_forward(torch, model, ids, segments)
                    times = []
                    for _ in range(ERNIE_TIMED):
                        t = time.perf_counter()
                        ernie_forward(torch, model, ids, segments)
                        times.append(time.perf_counter() - t)
                    if dtype == "float32" and path == "kernel":
                        # where the f32 forward's device time goes, by kernel
                        dev_ms, split = device_ms(
                            torch, lambda: ernie_forward(torch, model, ids, segments),
                            iters=2, warmup=0)
                        top = dict(sorted(split.items(), key=lambda kv: -kv[1])[:6])
                        log(f"profile ernie {name} float32 kernel: device {dev_ms:.3f} ms a "
                            f"forward; {split_line(top)}")
                ms = sorted(times)[ERNIE_TIMED // 2] * 1e3
                ERNIE_MS[name, dtype, path] = ms
                expect = dict(want, flash_attention=cfg.num_hidden_layers if path == "kernel"
                              else 0)
                if launches != expect:
                    raise AssertionError(f"ernie {name} {dtype} {path}: launches {launches}, "
                                         f"want {expect}")
                if not bool(torch.isfinite(out).all()):
                    raise AssertionError(f"ernie {name} {dtype} {path}: non-finite logits")
                errors[dtype, path] = rel_l2(out, ref)
                log(f"ernie {name} {dtype} {path} {b}x{s} on {card}: "
                    f"forward {ms:.2f} ms, {tokens / ms * 1e3:.0f} tokens/s, logits "
                    f"{list(out.shape)} relative L2 to the f32 plain path "
                    f"{errors[dtype, path]:.3g}, launches {launches['flash_attention']} B3")
                if path == "kernel" and dtype == "bfloat16" and cls is ErnieForMaskedLM:
                    counted = launches
                del out
        k32, k16, p16 = (errors["float32", "kernel"], errors["bfloat16", "kernel"],
                         errors["bfloat16", "plain"])
        if k32 > TOL["float32_attn"]["rtol"] or not (
                k16 <= LOGITS_REL_TOL or k16 <= DEPTH_REL_MARGIN * p16):
            raise AssertionError(f"ernie {name}: f32 kernel {k32} (bound "
                                 f"{TOL['float32_attn']['rtol']}), bf16 kernel {k16} against "
                                 f"plain bf16 {p16}")
        # a padding mask takes the masked composite, as in the reference
        masked, launches = ernie_forward(torch, model, ids, segments, mask)
        with ptt.flag_guard(**OFF_FLAGS):
            plain_masked, _ = ernie_forward(torch, model, ids, segments, mask)
        if launches != want or not torch.equal(masked, plain_masked) \
                or not bool(torch.isfinite(masked).all()):
            raise AssertionError(f"ernie {name} masked: launches {launches}, equal to the "
                                 f"plain path {torch.equal(masked, plain_masked)}")
        log(f"ernie {name} bf16 with a padding mask (lengths {lengths.min()}-"
            f"{lengths.max()}): the masked composite, no launch, bit-equal to the plain path")
        del model, ref, masked, plain_masked
    log(f"ernie phase: {time.perf_counter() - t_phase:.1f} s")
    return counted


RESNET_BATCH = 128                  # phase_resnet: the timed batch
RESNET_GATE_BATCH = 4               # the f32 card-against-CPU gate
RESNET_CALIB_BATCH = 32             # the training forward that sets the BN statistics
RESNET_REL = 1e-4                   # f32 logits: card against CPU, NCHW against NHWC
IMAGE_CASE_REL = 1e-5               # f32 functionals, card against CPU (sums of up to 432 terms)
RNN_SHAPE = dict(batch=32, steps=128, input=256, hidden=512)


def resnet_calibrated(torch, dev, fmt):
    """ResNet-50 (1000 classes) on ``dev`` with weights from seed 0 and
    each batch norm's running statistics those of one seeded batch: a
    training forward under no_grad with momentum 0 (paddle's rule r = m·r +
    (1 − m)·batch), then eval mode."""
    from paddle_tpu_torch.nn.layer.norm import _BatchNormBase
    from paddle_tpu_torch.vision.models import resnet50

    model = resnet50(data_format=fmt, device=dev,
                     generator=torch.Generator(device=dev).manual_seed(0))
    norms = [m for m in model.modules() if isinstance(m, _BatchNormBase)]
    for m in norms:
        m._momentum = 0.0
    imgs = torch.randn(RESNET_CALIB_BATCH, 3, 224, 224, device=dev,
                       generator=torch.Generator(device=dev).manual_seed(21))
    with torch.no_grad():
        model.train()(imgs)
    for m in norms:
        m._momentum = 0.9
    return model.eval()


def resnet_macs(torch, model, x) -> int:
    """Multiply-adds of one forward of ``model`` on ``x``, counted from the
    convolutions' and the classifier's output shapes."""
    from paddle_tpu_torch.nn import Conv2D, Linear

    total = [0]

    def conv(m, _inp, out):
        total[0] += out.numel() * (m._in_channels // m._groups) * math.prod(m._kernel_size)

    def linear(m, _inp, out):
        total[0] += out.numel() * m.in_features

    hooks = [m.register_forward_post_hook(conv if isinstance(m, Conv2D) else linear)
             for m in model.modules() if isinstance(m, (Conv2D, Linear))]
    with torch.no_grad():
        model(x)
    for h in hooks:
        h.remove()
    return total[0]


def bf16_emulated(torch, model, x):
    """``model`` (f32) with bf16's roundings put in by hand: the images and
    the convolution and classifier weights rounded to bf16, and each
    convolution's, batch norm's and the classifier's output rounded to
    bf16, the arithmetic in f32.  A random-weight ResNet-50 magnifies a
    perturbation from block to block (rounding only the images to bf16
    moves its f32 logits by about 5%), so the bf16 path is held against
    this run's distance from f32, not against a fixed bound."""
    from paddle_tpu_torch.nn import Conv2D, Linear
    from paddle_tpu_torch.nn.layer.norm import _BatchNormBase

    emulated = copy.deepcopy(model)
    with torch.no_grad():
        for layer in emulated.modules():
            if isinstance(layer, (Conv2D, Linear)):
                layer.weight.copy_(layer.weight.bfloat16().float())
            if isinstance(layer, (Conv2D, _BatchNormBase, Linear)):
                layer.register_forward_post_hook(lambda _m, _i, out: out.bfloat16().float())
        return emulated(x.bfloat16().float())


def image_cases(torch):
    """One f32 case of each convolution, pool, norm, resampling and padding
    functional: (label, fn, CPU inputs)."""
    import paddle_tpu_torch.nn.functional as F

    g = torch.Generator().manual_seed(31)

    def r(*shape):
        return torch.randn(*shape, generator=g)

    x2 = r(8, 64, 57, 57)
    small = r(4, 16, 37, 41)
    cases = [
        ("conv1d SAME stride 2 groups 2", lambda x, w, b: F.conv1d(x, w, b, 2, "SAME", 1, 2),
         [r(8, 32, 500), r(64, 16, 5), r(64)]),
        ("conv3d", lambda x, w, b: F.conv3d(x, w, b, 1, 1), [r(2, 16, 8, 32, 32),
                                                             r(32, 16, 3, 3, 3), r(32)]),
        ("conv2d SAME stride 2", lambda x, w: F.conv2d(x, w, None, 2, "SAME"),
         [x2, r(128, 64, 3, 3)]),
        ("conv2d NHWC (1, 0) pads", lambda x, w: F.conv2d(x, w, None, 2, [(1, 0), (0, 1)],
                                                            data_format="NHWC"),
         [x2.permute(0, 2, 3, 1).contiguous(), r(128, 64, 3, 3)]),
        ("conv1d_transpose", lambda x, w, b: F.conv1d_transpose(x, w, b, 2, 1, 1),
         [r(8, 32, 100), r(32, 16, 4), r(16)]),
        ("conv2d_transpose", lambda x, w, b: F.conv2d_transpose(x, w, b, 2, [(1, 0), (0, 1)], 1,
                                                                2),
         [r(4, 64, 28, 28), r(64, 16, 3, 3), r(32)]),
        ("conv3d_transpose", lambda x, w: F.conv3d_transpose(x, w, None, 2, 1, 1),
         [r(2, 16, 4, 16, 16), r(16, 8, 3, 3, 3)]),
        ("max_pool2d ceil_mode", lambda x: F.max_pool2d(x, 3, 2, 1, ceil_mode=True), [x2]),
        ("avg_pool2d ceil_mode exclusive", lambda x: F.avg_pool2d(x, 3, 2, 1, ceil_mode=True),
         [x2]),
        ("avg_pool2d ceil_mode inclusive", lambda x: F.avg_pool2d(x, 3, 2, 1, ceil_mode=True,
                                                                  exclusive=False), [x2]),
        ("adaptive_avg_pool2d (5, 7)", lambda x: F.adaptive_avg_pool2d(x, (5, 7)), [x2]),
        ("adaptive_max_pool2d (5, 7)", lambda x: F.adaptive_max_pool2d(x, (5, 7)), [x2]),
        ("group_norm", lambda x, w, b: F.group_norm(x, 8, 1e-5, w, b), [x2, r(64), r(64)]),
        ("instance_norm", lambda x, w, b: F.instance_norm(x, weight=w, bias=b),
         [x2, r(64), r(64)]),
        ("local_response_norm", lambda x: F.local_response_norm(x, 5), [x2]),
        ("unfold", lambda x: F.unfold(x, 3, 2, 1), [r(4, 16, 28, 28)]),
        ("pixel_shuffle", lambda x: F.pixel_shuffle(x, 2), [r(4, 64, 28, 28)]),
    ]
    for mode, ac, am in (("nearest", False, 0), ("nearest", True, 0), ("bilinear", False, 0),
                         ("bilinear", True, 0), ("bilinear", False, 1), ("bicubic", False, 0),
                         ("area", False, 0)):
        for size in ((64, 50), (20, 23)):
            cases.append((f"interpolate {mode} align_corners={ac} align_mode={am} to {size}",
                          lambda x, mode=mode, ac=ac, am=am, size=size: F.interpolate(
                              x, size, mode=mode, align_corners=ac, align_mode=am), [small]))
    for mode in ("constant", "reflect", "replicate", "circular"):
        cases.append((f"pad {mode}", lambda x, mode=mode: F.pad(x, [2, 3, 1, 4], mode=mode,
                                                                 value=0.5), [small]))
    return cases


def rnn_gate(torch, dev):
    """LSTM and GRU (2 layers, bidirectional) on the card against the
    same layers on the CPU, ragged lengths: outputs and final states within
    1e-5 relative L2; returns {name: forward ms on the card}."""
    from paddle_tpu_torch import nn

    b, t, n_in, hid = (RNN_SHAPE[k] for k in ("batch", "steps", "input", "hidden"))
    g = torch.Generator().manual_seed(41)
    x = torch.randn(b, t, n_in, generator=g)
    lengths = torch.randint(1, t + 1, (b,), generator=g)
    lengths[0] = t
    times = {}
    for cls in (nn.LSTM, nn.GRU):
        layer = cls(n_in, hid, 2, "bidirect", device=dev,
                    generator=torch.Generator(device=dev).manual_seed(42))
        cpu = copy.deepcopy(layer).to("cpu")
        with torch.no_grad():
            got = layer(x.to(dev), None, lengths.to(dev))
            want = cpu(x, None, lengths)
            times[cls.__name__] = time_ms(torch, lambda: layer(x.to(dev), None, lengths.to(dev)),
                                          iters=2, repeats=3, warmup=1)
        errs = [rel_l2(a.cpu(), w) for a, w in zip(_leaves(got), _leaves(want))]
        if max(errs) > 1e-5:
            raise AssertionError(f"{cls.__name__} card against CPU: relative L2 {errs}")
        log(f"resnet phase: {cls.__name__} 2 layers bidirect hidden {hid} batch {b} x {t} "
            f"steps, ragged lengths {int(lengths.min())}-{t}: outputs and final states "
            f"within {max(errs):.3g} of the CPU; forward {times[cls.__name__]:.1f} ms")
    return times


def _leaves(value):
    if isinstance(value, (tuple, list)):
        return [t for v in value for t in _leaves(v)]
    return [value]


def resnet_profile(torch, model, x, n=3):
    """Device time by operation over ``n`` forwards, the idle share, and
    CUDA kernel launches a forward, from ``torch.profiler``."""
    with torch.no_grad():
        model(x)
        return ops_profile(torch, lambda: model(x), n)


def conv_kind(key):
    """The operation kind of a convolutional model's kernel ``key``
    (lower case)."""
    return ("layout copy" if any(w in key for w in ("nchwtonhwc", "nhwctonchw", "transpose",
                                                    "copy"))
            else "batch norm" if any(w in key for w in ("bn_", "batch_norm", "batchnorm"))
            else "pooling" if "pool" in key
            else "convolution" if any(w in key for w in ("conv", "xmma", "implicit",
                                                         "fprop", "cudnn", "cutlass"))
            else "gemm" if "gemm" in key
            else "elementwise" if "elementwise" in key
            else "other")


def transformer_kind(key):
    """The operation kind of a transformer training step's kernel ``key``
    (lower case)."""
    return ("adamw (B5)" if "adamw" in key
            else "gemm" if any(w in key for w in ("gemm", "cutlass", "xmma", "sm90_", "cublas",
                                                  "matmul", "nvjet"))
            else "mask draw" if any(w in key for w in ("distribution", "philox", "uniform",
                                                       "rand"))
            else "softmax" if "softmax" in key
            else "layer norm" if "layer_norm" in key or "layernorm" in key
            else "reduction" if "reduce" in key
            else "copy and cast" if "copy" in key or "cat" in key
            else "elementwise" if "elementwise" in key or "vectorized" in key
            else "other")


def ops_profile(torch, fn, n, kind_of=conv_kind):
    """Over ``n`` calls of ``fn`` (warm), from ``torch.profiler``: the wall
    ms a call (profiled), device busy ms a call, {operation kind (by
    ``kind_of``): device ms a call}, CUDA launches a call, and the top
    kernels, then the top of "other"."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3 / n
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    if not kernels:
        raise AssertionError("torch.profiler recorded no device time")
    groups, other = {}, []
    for e in kernels:
        key, ms = e.key.lower(), e.self_device_time_total / 1e3 / n
        kind = kind_of(key)
        groups[kind] = groups.get(kind, 0.0) + ms
        if kind == "other":
            other.append((ms, e.key))
    busy = sum(groups.values())
    launches = sum(e.count for e in kernels) / n
    top = sorted(((e.self_device_time_total / 1e3 / n, e.key) for e in kernels), reverse=True)[:5]
    return wall, busy, groups, launches, top + sorted(other, reverse=True)[:3]


def phase_resnet(torch, card, dev="cuda"):
    """ResNet-50 inference at its published widths (``resnet50()``: 1000
    classes, 25.56 M parameters) on 224 x 224 images, the port's image
    layers on the card.  Gates (each raising): f32 logits at batch 4
    against the same model and images on the CPU, and the NCHW and NHWC
    internal layouts against each other, within RESNET_REL relative L2;
    bf16 under AMP O2 with bf16 images no farther from f32 than
    LOGITS_REL_TOL, or than DEPTH_REL_MARGIN times ``bf16_emulated``'s
    distance (the top-1 agreement logged); ``image_cases`` in f32 against the CPU within
    the f32 attention row; ``rnn_gate``; no hand kernel launched on the
    path.  Then, each beside the card: images/s and ms a forward at batch
    128 in bf16 and f32 in both layouts (cuDNN's default algorithm choice),
    the layout the bf16 run finds faster (``"auto"``'s on the card),
    device time by operation, the idle share and CUDA launches a forward
    from ``torch.profiler``, peak memory, and the bound: the counted
    multiply-adds at the dtype's peak."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.incubate import autotune
    from paddle_tpu_torch.ops import LAUNCHES, reset_launch_counts
    from paddle_tpu_torch.vision.models import resnet50

    t_phase = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    reset_launch_counts()
    nchw = resnet_calibrated(torch, dev, "NCHW")
    nhwc = resnet_calibrated(torch, dev, "NHWC")
    n_params = sum(p.numel() for p in nchw.parameters())
    if n_params != 25_557_032 or len(nchw.state_dict()) != 267:
        raise AssertionError(f"resnet50: {n_params} parameters, {len(nchw.state_dict())} "
                             f"state entries")
    log(f"resnet50(data_format='auto') on {dev} builds "
        f"{resnet50(device=dev).data_format} (autotune.CARD_LAYOUT {autotune.CARD_LAYOUT})")
    g = torch.Generator(device=dev).manual_seed(22)
    images = torch.randn(RESNET_BATCH, 3, 224, 224, device=dev, generator=g)
    gate_images = images[:RESNET_GATE_BATCH]

    # (a) f32 on the card against the CPU, NCHW against NHWC, bf16 against f32
    cpu = copy.deepcopy(nchw).to("cpu")
    with torch.no_grad():
        f32 = nchw(gate_images)
        on_cpu = cpu(gate_images.cpu())
        f32_nhwc = nhwc(gate_images)
    del cpu
    err_cpu, err_layout = rel_l2(f32.cpu(), on_cpu), rel_l2(f32_nhwc, f32)
    if not bool(torch.isfinite(f32).all()) or err_cpu > RESNET_REL or err_layout > RESNET_REL:
        raise AssertionError(f"resnet50 f32 logits: card against CPU {err_cpu:.3g}, NHWC "
                             f"against NCHW {err_layout:.3g} (bound {RESNET_REL})")
    log(f"resnet50 f32 logits {list(f32.shape)} at batch {RESNET_GATE_BATCH}: card against "
        f"CPU {err_cpu:.3g}, NHWC against NCHW {err_layout:.3g} relative L2")
    bf16 = {fmt: amp.decorate(copy.deepcopy(m), level="O2", dtype="bfloat16")
            for fmt, m in (("NCHW", nchw), ("NHWC", nhwc))}
    with torch.no_grad():
        full32 = nchw(images)
        rounded = rel_l2(bf16_emulated(torch, nchw, images), full32)
        bound = max(LOGITS_REL_TOL, DEPTH_REL_MARGIN * rounded)
        for fmt, m in bf16.items():
            out = m(images.bfloat16())
            err = rel_l2(out, full32)
            agree = float((out.float().argmax(-1) == full32.argmax(-1)).float().mean())
            if out.dtype != torch.bfloat16 or not bool(torch.isfinite(out).all()) \
                    or err > bound:
                raise AssertionError(f"resnet50 bf16 {fmt}: {out.dtype}, relative L2 to f32 "
                                     f"{err:.3g} (bound {bound:.3g}: bf16's roundings in f32 "
                                     f"give {rounded:.3g})")
            log(f"resnet50 bf16 (AMP O2, batch norms f32) {fmt} at batch {RESNET_BATCH}: "
                f"relative L2 to f32 {err:.3g} (bf16's roundings emulated in f32: "
                f"{rounded:.3g}; bound {bound:.3g}), top-1 agreement {agree:.4f}")
    del full32, out

    # (b) the functionals and the recurrent layers against the CPU
    worst, cases = (0.0, None), image_cases(torch)
    for label, fn, inputs in cases:
        with torch.no_grad():
            got = fn(*[t.to(dev) for t in inputs])
            want = fn(*inputs)
        err = rel_l2(got.cpu(), want)
        if got.shape != want.shape or not bool(torch.isfinite(got).all()) \
                or err > IMAGE_CASE_REL:
            raise AssertionError(f"{label}: shape {list(got.shape)} against "
                                 f"{list(want.shape)}, relative L2 {err:.3g} (bound "
                                 f"{IMAGE_CASE_REL})")
        worst = max(worst, (err, label), key=lambda e: e[0])
    log(f"resnet phase: {len(cases)} convolution, pool, norm, resampling and "
        f"padding cases in f32 within {worst[0]:.3g} relative L2 of the CPU ({worst[1]})")
    rnn_ms = rnn_gate(torch, dev)
    if any(LAUNCHES.values()):
        raise AssertionError(f"the image path launched hand kernels: {dict(LAUNCHES)}")

    # (c) timings at batch 128
    macs = resnet_macs(torch, nchw, images)
    if abs(macs / RESNET_BATCH / 4.1e9 - 1) > 0.01:
        raise AssertionError(f"resnet50: {macs / RESNET_BATCH:.4g} multiply-adds an image")
    x16 = images.bfloat16()
    runs = {}
    for dtype, fmt, model, x in (("bf16", "NCHW", bf16["NCHW"], x16),
                                 ("bf16", "NHWC", bf16["NHWC"], x16),
                                 ("f32", "NCHW", nchw, images), ("f32", "NHWC", nhwc, images)):
        torch.cuda.reset_peak_memory_stats()
        with torch.no_grad():
            ms = time_ms(torch, lambda: model(x), iters=10, repeats=3, warmup=3)
        peak = torch.cuda.max_memory_allocated() / 2**30
        bound, by = bound_ms(0, 2 * macs, BF16_FLOPS if dtype == "bf16" else F32_FLOPS)
        runs[dtype, fmt] = ms
        log(f"resnet50 {dtype} {fmt} batch {RESNET_BATCH} on {card}: {ms:.2f} ms a forward, "
            f"{RESNET_BATCH / ms * 1e3:.0f} images/s, peak {peak:.2f} GiB, bound {bound:.3f} ms "
            f"({by}: {2 * macs / 1e12:.3f} TFLOP), {bound / ms:.3f} of the bound")
    # cuDNN's own algorithm search (off by default; the port leaves it so)
    torch.backends.cudnn.benchmark = True
    searched = {}
    for fmt in ("NCHW", "NHWC"):
        with torch.no_grad():
            searched[fmt] = time_ms(torch, lambda: bf16[fmt](x16), iters=10, repeats=3,
                                    warmup=3)
    torch.backends.cudnn.benchmark = False
    log(f"resnet50 bf16 batch {RESNET_BATCH} with cudnn.benchmark on: NCHW "
        f"{searched['NCHW']:.2f} ms, NHWC {searched['NHWC']:.2f} ms")
    faster = min(("NCHW", "NHWC"), key=lambda f: runs["bf16", f])
    log(f"resnet50 layout: bf16 NCHW {runs['bf16', 'NCHW']:.2f} ms, NHWC "
        f"{runs['bf16', 'NHWC']:.2f} ms; faster {faster}; autotune.CARD_LAYOUT "
        f"{autotune.CARD_LAYOUT} ({'agrees' if faster == autotune.CARD_LAYOUT else 'DIFFERS'})")
    for fmt in ("NCHW", "NHWC"):
        wall, busy, groups, launches, top = resnet_profile(torch, bf16[fmt], x16)
        log(f"profile resnet50 bf16 {fmt} batch {RESNET_BATCH}: wall {wall:.2f} ms a forward "
            f"(profiled), device busy {busy:.2f} ms, idle share {1 - busy / wall:.3f} "
            f"(against the unprofiled {runs['bf16', fmt]:.2f} ms: "
            f"{1 - busy / runs['bf16', fmt]:.3f}), {launches:.0f} CUDA launches a forward; "
            f"by operation (ms): "
            + "; ".join(f"{k} {v:.3f}" for k, v in sorted(groups.items(), key=lambda kv: -kv[1]))
            + "; top kernels, then the top of other: "
            + "; ".join(f"{name[:60]} {ms:.3f}" for ms, name in top))
    del bf16, nchw, nhwc, images, x16
    log(f"resnet phase: {time.perf_counter() - t_phase:.1f} s (RNN forwards {rnn_ms})")


RESNET_TRAIN_BATCH = 256            # phase_resnet_train: ladder row 1's batch (bench.py's)
RESNET_TRAIN_HW = 224               # its images' side
RESNET_TRAIN_WARMUP, RESNET_TRAIN_STEPS = 2, 12
RESNET_TRAIN_LR = 0.01              # Momentum's learning rate (bench.py's)
RESNET_FLOP_IMAGE = 3 * 4.089e9     # bench.py's count of a training step's work an image
RESNET_F32_BATCH = 4                # (a1): f32 on the card against the CPU, two steps
RESNET_MEMO_BATCH, RESNET_MEMO_STEPS = 32, 6     # (a2): memorising one batch
RESNET_O1_BATCH, RESNET_O1_STEPS = 32, 3         # (b): the eager O1 idiom with GradScaler
ZOO_BATCH = 8                       # (c): the zoo's eval forward
ZOO_TRAIN = ("lenet", "shufflenet_v2_x1_0", "densenet121")   # (c2): dropout-free training


def zoo_families():
    """(c): one constructor of each new family at its published widths and
    its input side; LeNet's input has one channel."""
    from paddle_tpu_torch.vision import models as M

    return [("lenet", M.LeNet, 28), ("alexnet", M.alexnet, 224), ("vgg16", M.vgg16, 224),
            ("squeezenet1_1", M.squeezenet1_1, 224), ("mobilenet_v1", M.mobilenet_v1, 224),
            ("mobilenet_v2", M.mobilenet_v2, 224),
            ("mobilenet_v3_large", M.mobilenet_v3_large, 224),
            ("shufflenet_v2_x1_0", M.shufflenet_v2_x1_0, 224),
            ("densenet121", M.densenet121, 224), ("googlenet", M.googlenet, 224),
            ("inception_v3", M.inception_v3, 299)]


def image_batch(torch, n, hw, seed, dev, channels=3, classes=1000):
    """``n`` seeded noise images [n, channels, hw, hw] and labels in
    [0, classes) on ``dev``."""
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(n, channels, hw, hw, device=dev, generator=g)
    y = torch.randint(0, classes, (n,), device=dev, generator=g)
    return x, y


def moved(torch, opt, params, before) -> int:
    """How many of ``params`` changed since ``before`` (their f32 values),
    read where the update runs: a bf16 parameter's f32 master (a step
    smaller than half a bf16 ulp leaves the bf16 copy as it was)."""
    return sum(not torch.equal(b, opt._master_weights.get(id(p), p).float())
               for b, p in zip(before, params))


def resnet_train_step(torch, model, opt):
    import paddle_tpu_torch.nn.functional as F
    from paddle_tpu_torch.jit import TrainStep

    return TrainStep(model, lambda m, x, y: F.cross_entropy(m(x), y).mean(), opt)


def count_syncs(torch, fn):
    """(result of ``fn()``, host reads of a tensor during it): calls of
    ``Tensor.item``, ``__bool__``, ``__float__``, ``__int__`` and ``tolist``,
    each a host synchronisation on a card tensor."""
    names = ("item", "__bool__", "__float__", "__int__", "tolist")
    saved = {n: torch.Tensor.__dict__.get(n) for n in names}
    count = [0]

    def spy(name):
        orig = getattr(torch.Tensor, name)

        def wrapper(self, *a, **k):
            count[0] += 1
            return orig(self, *a, **k)
        return wrapper

    for n in names:
        setattr(torch.Tensor, n, spy(n))
    try:
        out = fn()
    finally:
        for n, v in saved.items():
            if v is None:
                delattr(torch.Tensor, n)
            else:
                setattr(torch.Tensor, n, v)
    return out, count[0]


def resnet_f32_gate(torch, dev):
    """(a1) ResNet-50 in f32 (no ``decorate``) on ``dev``, a copy on the CPU
    and one in f64 on the CPU, two Momentum TrainSteps on one seeded batch.
    The first loss (a training forward) within the f32 gradient row of
    ``tests/op_test.py`` of the CPU's; then, as ``tests/test_torch_resnet.py``
    holds ResNet's training gradients: a training step through fifty batch
    norms at init magnifies f32 rounding (two f32 runs of the same step in
    two layouts part by up to 70% in the stem's weights), so the second loss,
    every parameter and every running statistic must lie no farther from the
    f64 run than three times the CPU f32 run's distance from it."""
    from paddle_tpu_torch.optimizer import Momentum
    from paddle_tpu_torch.vision.models import resnet50

    model = resnet50(device=dev, generator=torch.Generator(device=dev).manual_seed(0))
    cpu = copy.deepcopy(model).to("cpu")
    f64 = copy.deepcopy(cpu).double()
    x, y = image_batch(torch, RESNET_F32_BATCH, RESNET_TRAIN_HW, 61, dev)
    losses = {}
    for where, m, xx in (("card", model, x), ("cpu", cpu, x.cpu()),
                         ("f64", f64, x.cpu().double())):
        step = resnet_train_step(torch, m, Momentum(RESNET_TRAIN_LR,
                                                    parameters=m.parameters()))
        yy = y.to(xx.device)
        losses[where] = [float(step(xx, yy)) for _ in range(2)]
    card, cpu32, ref = losses["card"], losses["cpu"], losses["f64"]
    if abs(card[0] - cpu32[0]) > 1e-4 + 5e-3 * abs(cpu32[0]) or \
            abs(card[1] - ref[1]) > 3 * abs(cpu32[1] - ref[1]) + 1e-6:
        raise AssertionError(f"(a1) resnet50 f32 losses: card {card}, CPU {cpu32}, f64 {ref}")
    worst = (0.0, "")
    for (name, got), want, exact in zip(model.state_dict().items(), cpu.state_dict().values(),
                                        f64.state_dict().values()):
        if not got.is_floating_point():
            continue
        exact = exact.float()
        mine, spread = rel_l2(got.cpu(), exact), rel_l2(want, exact)
        if mine > 3 * spread + 1e-6:
            raise AssertionError(f"(a1) resnet50 f32 after 2 steps, {name}: card {mine:.3g} "
                                 f"from f64 against the CPU f32 run's {spread:.3g}")
        worst = max(worst, (mine / (spread + 1e-12), name))
    log(f"resnet train (a1) f32 Momentum({RESNET_TRAIN_LR}), batch {RESNET_F32_BATCH}, 2 steps: "
        f"losses card {card}, CPU {cpu32}, CPU f64 {ref}; every parameter and running "
        f"statistic within 3x the CPU f32 run's distance from f64, worst {worst[0]:.3f}x "
        f"({worst[1]})")
    del model, cpu, f64


def resnet_memorise(torch, dev):
    """(a2) bf16 O2 Momentum training on one fixed seeded batch: every loss
    finite and the last below the first."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.optimizer import Momentum
    from paddle_tpu_torch.vision.models import resnet50

    model = resnet50(device=dev, generator=torch.Generator(device=dev).manual_seed(1))
    opt = Momentum(RESNET_TRAIN_LR, parameters=model.parameters())
    model, opt = amp.decorate(model, opt, level="O2", dtype="bfloat16")
    step = resnet_train_step(torch, model, opt)
    x, y = image_batch(torch, RESNET_MEMO_BATCH, RESNET_TRAIN_HW, 62, dev)
    losses = [float(step(x, y)) for _ in range(RESNET_MEMO_STEPS)]
    if not all(math.isfinite(v) for v in losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"resnet50 bf16 memorising one batch of {RESNET_MEMO_BATCH}: "
                             f"losses {losses}")
    log(f"resnet train (a2) bf16 O2 on one batch of {RESNET_MEMO_BATCH}, "
        f"{RESNET_MEMO_STEPS} steps: losses {[round(v, 4) for v in losses]}")
    del model, opt, step


def resnet_ladder(torch, card, dev):
    """(a) ladder row 1 as ``bench.py`` sets it up: ``resnet50()``, batch
    RESNET_TRAIN_BATCH at 224², Momentum(0.01), AMP O2 bf16, TrainStep;
    RESNET_TRAIN_WARMUP + RESNET_TRAIN_STEPS steps, each on its own seeded
    batch.  Gates (a3) no hand kernel launched, (a4) Momentum's state."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.ops import LAUNCHES, reset_launch_counts
    from paddle_tpu_torch.optimizer import Momentum
    from paddle_tpu_torch.vision.models import resnet50

    model = resnet50(device=dev, generator=torch.Generator(device=dev).manual_seed(0))
    n_params = sum(p.numel() for p in model.parameters())
    trainable = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
    if n_params != 25_557_032 or len(trainable) != 161:
        raise AssertionError(f"resnet50: {n_params} parameters in {len(trainable)} tensors")
    opt = Momentum(RESNET_TRAIN_LR, parameters=model.parameters())
    model, opt = amp.decorate(model, opt, level="O2", dtype="bfloat16")
    step = resnet_train_step(torch, model, opt)
    n = RESNET_TRAIN_WARMUP + RESNET_TRAIN_STEPS
    batches = [image_batch(torch, RESNET_TRAIN_BATCH, RESNET_TRAIN_HW, 100 + i, dev)
               for i in range(n)]
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    losses = [step(*b) for b in batches[:RESNET_TRAIN_WARMUP]]
    torch.cuda.synchronize()
    t = time.perf_counter()
    losses += [step(*b) for b in batches[RESNET_TRAIN_WARMUP:]]
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t) * 1e3 / RESNET_TRAIN_STEPS
    peak = torch.cuda.max_memory_allocated() / 2**30
    if any(LAUNCHES.values()):
        raise AssertionError(f"(a3) resnet50 training launched hand kernels: {dict(LAUNCHES)}")
    losses = [float(v) for v in losses]
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"resnet50 training losses {losses}")
    flop = RESNET_FLOP_IMAGE * RESNET_TRAIN_BATCH
    log(f"resnet train (a) resnet50 bf16 O2 Momentum TrainStep batch {RESNET_TRAIN_BATCH} "
        f"at {RESNET_TRAIN_HW}² ({model.data_format} inside) on {card}: {ms:.2f} ms a step "
        f"over {RESNET_TRAIN_STEPS} counted steps, {RESNET_TRAIN_BATCH / ms * 1e3:.1f} "
        f"images/s, MFU {flop / (ms * 1e-3) / BF16_FLOPS:.4f} (bench.py's 3 x 4.089 GFLOP an "
        f"image against {BF16_FLOPS / 1e12:.0f} TFLOP/s; {2 * flop / (ms * 1e-3) / BF16_FLOPS:.4f} "
        f"at 2 FLOP a multiply-add), peak {peak:.2f} GiB, loss {losses[0]:.4f} first, "
        f"{losses[-1]:.4f} last; hand-kernel launches 0")
    # (a4) Momentum's state: a velocity for every trainable tensor, a master
    # for every bf16 one (the batch norms stay f32 and keep none), the bf16
    # parameter its master rounded
    sd = opt.state_dict()
    names = {id(p): opt._names[id(p)] for p in opt._parameter_list}
    masters = 0
    for _, p in trainable:
        key = names[id(p)]
        if f"{key}.velocity" not in sd:
            raise AssertionError(f"(a4) no velocity for {key}")
        if p.dtype == torch.bfloat16:
            mw = sd.get(f"{key}.master_weight")
            if mw is None or mw.dtype != torch.float32 or not torch.equal(mw.bfloat16(), p):
                raise AssertionError(f"(a4) {key}: master weight missing or not rounding to "
                                     f"the parameter")
            masters += 1
        elif f"{key}.master_weight" in sd:
            raise AssertionError(f"(a4) f32 parameter {key} has a master weight")
    log(f"resnet train (a4) state_dict: {len(trainable)} velocities, {masters} f32 master "
        f"weights (the bf16 tensors; the {len(trainable) - masters} f32 batch-norm tensors "
        f"keep none), each bf16 parameter equal to its master rounded")
    x, y = batches[-1]
    wall, busy, groups, launches, top = ops_profile(torch, lambda: step(x, y), 1)
    log(f"profile resnet50 train step batch {RESNET_TRAIN_BATCH}: wall {wall:.2f} ms "
        f"(profiled), device busy {busy:.2f} ms, idle share {1 - busy / wall:.3f} (against "
        f"the unprofiled {ms:.2f} ms: {1 - busy / ms:.3f}), {launches:.0f} CUDA launches; by "
        f"operation (ms): "
        + "; ".join(f"{k} {v:.3f}" for k, v in sorted(groups.items(), key=lambda kv: -kv[1]))
        + "; top kernels, then the top of other: "
        + "; ".join(f"{name[:60]} {v:.3f}" for v, name in top))
    del model, opt, step, batches, x, y
    return ms


def resnet_o1(torch, dev):
    """(b) the reference's eager O1 idiom on an f32 ResNet-50: ``auto_cast``
    O1 bf16 around the forward, ``GradScaler`` scale/step/update, Momentum.
    Gates: (b1) the convolutions' and the head's outputs bf16, the batch
    norms' parameters f32; (b2) finite losses, every step moves the
    parameters; (b3) one inf gradient: the update skipped (every parameter
    unchanged), the scale halved, one host synchronisation in the unscale."""
    import paddle_tpu_torch.nn.functional as F
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.optimizer import Momentum
    from paddle_tpu_torch.vision.models import resnet50

    model = resnet50(device=dev, generator=torch.Generator(device=dev).manual_seed(2))
    opt = Momentum(RESNET_TRAIN_LR, parameters=model.parameters())
    scaler = amp.GradScaler()
    seen = {}
    hooks = [layer.register_forward_post_hook(
        lambda m, _i, out, key=key: seen.__setitem__(key, (out.dtype, m.weight.dtype)))
        for key, layer in (("conv", model.conv1), ("norm", model.bn1), ("fc", model.fc))]
    x, y = image_batch(torch, RESNET_O1_BATCH, RESNET_TRAIN_HW, 63, dev)
    params = [p for p in model.parameters() if p.requires_grad]

    def backward():
        with amp.auto_cast(level="O1", dtype="bfloat16"):
            loss = F.cross_entropy(model(x), y).mean()
        scaler.scale(loss).backward()
        return loss

    losses = []
    for i in range(RESNET_O1_STEPS):
        before = [p.detach().clone() for p in params]
        losses.append(float(backward().detach()))
        scaler.step(opt)
        scaler.update()
        opt.clear_grad()
        n = moved(torch, opt, params, before)
        if not math.isfinite(losses[-1]) or n != len(params):
            raise AssertionError(f"(b2) O1 step {i}: loss {losses[-1]}, {n} of "
                                 f"{len(params)} parameters moved")
    for h in hooks:
        h.remove()
    bf16, f32 = torch.bfloat16, torch.float32
    if seen != {"conv": (bf16, f32), "norm": (bf16, f32), "fc": (bf16, f32)}:
        raise AssertionError(f"(b1) O1 dtypes (output, weight): {seen}")
    log(f"resnet train (b) O1 bf16 + GradScaler, f32 weights, batch {RESNET_O1_BATCH}: "
        f"losses {[round(v, 4) for v in losses]}, every parameter moved each step; "
        f"(output, weight) dtypes conv1 {seen['conv']}, bn1 {seen['norm']}, fc {seen['fc']}")
    backward()
    with torch.no_grad():
        params[0].grad.view(-1)[0] = float("inf")
    before = [p.detach().clone() for p in params]
    scale = scaler.get_loss_scaling()
    _, syncs = count_syncs(torch, lambda: scaler.step(opt))
    scaler.update()
    opt.clear_grad()
    unchanged = all(torch.equal(b, p) for b, p in zip(before, params))
    if not unchanged or scaler.get_loss_scaling() != scale / 2 or syncs != 1:
        raise AssertionError(f"(b3) an inf gradient: parameters unchanged {unchanged}, scale "
                             f"{scale} -> {scaler.get_loss_scaling()}, {syncs} host syncs")
    log(f"resnet train (b3) one inf gradient: the update skipped ({len(params)} parameters "
        f"unchanged), scale {scale:g} -> {scaler.get_loss_scaling():g}, {syncs} host "
        f"synchronisation in the unscale of {len(params)} gradients")
    del model, opt, params, before


def ernie_o1(torch, card, dev, cfg=None, batch=(ERNIE_BATCH, ERNIE_SEQ)):
    """(b4) ERNIE 3.0 base (``phase_ernie``'s classification model and
    inputs) with f32 weights under ``auto_cast`` O1 bf16: the SDPA cast
    sends bf16 q/k/v to B3 (one launch a layer), the logits within
    LOGITS_REL_TOL of the f32 forward; ms a forward beside phase_ernie's.
    Returns the counted O1 forward's launches."""
    import numpy as np

    from paddle_tpu_torch import amp
    from paddle_tpu_torch.models import ErnieConfig, ErnieForSequenceClassification

    cfg = cfg or ErnieConfig()
    b, s = batch
    rng = np.random.default_rng(12)
    ids = torch.as_tensor(rng.integers(0, cfg.vocab_size, (b, s)), device=dev)
    segments = torch.as_tensor(rng.integers(0, 2, (b, s)), device=dev)
    model = ErnieForSequenceClassification(cfg, device=dev, seed=0).eval()
    ref, _ = ernie_forward(torch, model, ids, segments)
    with amp.auto_cast(level="O1", dtype="bfloat16"):
        out, launches = ernie_forward(torch, model, ids, segments)
        times = []
        for _ in range(ERNIE_TIMED):
            t = time.perf_counter()
            ernie_forward(torch, model, ids, segments)
            times.append(time.perf_counter() - t)
    ms = sorted(times)[ERNIE_TIMED // 2] * 1e3
    err = rel_l2(out, ref)
    want = cfg.num_hidden_layers
    if launches.get("flash_attention") != want or any(
            v for k, v in launches.items() if k != "flash_attention") \
            or not bool(torch.isfinite(out).all()) or err > LOGITS_REL_TOL:
        raise AssertionError(f"(b4) ERNIE O1: launches {launches} (want {want} B3), relative "
                             f"L2 to f32 {err:.3g} (bound {LOGITS_REL_TOL}), {out.dtype}")
    others = ", ".join(f"{dtype} {path} {v:.2f} ms" for (name, dtype, path), v in
                       ERNIE_MS.items() if name == "SequenceClassification")
    log(f"resnet train (b4) ERNIE SequenceClassification {b}x{s} f32 weights under O1 bf16 "
        f"on {card}: {ms:.2f} ms a forward ({b * s / ms * 1e3:.0f} tokens/s), logits "
        f"{out.dtype} relative L2 to the f32 forward {err:.3g}, {launches['flash_attention']} "
        f"B3 launches; phase_ernie: {others or 'not run'}")
    del model, ref, out
    return launches


def zoo_eval(torch, card, dev):
    """(c1) each new family at its published widths, batch ZOO_BATCH, f32
    eval on ``dev`` against the same model and images on the CPU within
    RESNET_REL, and finite under bf16 O2; ms a forward in both dtypes,
    parameters and peak memory."""
    from paddle_tpu_torch import amp

    for name, ctor, hw in zoo_families():
        gc.collect()
        torch.cuda.empty_cache()
        model = ctor(device=dev, generator=torch.Generator(device=dev).manual_seed(3)).eval()
        x, _ = image_batch(torch, ZOO_BATCH, hw, 64, dev, channels=1 if name == "lenet" else 3)
        cpu = copy.deepcopy(model).to("cpu")
        torch.cuda.reset_peak_memory_stats()
        with torch.no_grad():
            got = _leaves(model(x))[0]
            want = _leaves(cpu(x.cpu()))[0]
            ms = time_ms(torch, lambda: model(x), iters=3, repeats=3, warmup=1)
            peak = torch.cuda.max_memory_allocated() / 2**30
            half = amp.decorate(copy.deepcopy(model), level="O2", dtype="bfloat16")
            out16 = _leaves(half(x))[0]
            ms16 = time_ms(torch, lambda: half(x), iters=3, repeats=3, warmup=1)
        err = rel_l2(got.cpu(), want)
        if not bool(torch.isfinite(got).all()) or err > RESNET_REL \
                or out16.dtype != torch.bfloat16 or not bool(torch.isfinite(out16).all()):
            raise AssertionError(f"(c1) {name}: card against CPU {err:.3g} (bound "
                                 f"{RESNET_REL}), bf16 {out16.dtype} finite "
                                 f"{bool(torch.isfinite(out16).all())}")
        n_params = sum(p.numel() for p in model.parameters())
        log(f"zoo (c1) {name} batch {ZOO_BATCH} at {hw}² ({getattr(model, 'data_format', 'NCHW')}"
            f" inside) on {card}: {n_params} parameters, f32 {ms:.2f} ms a forward, bf16 O2 "
            f"{ms16:.2f} ms, peak {peak:.2f} GiB, f32 logits {list(got.shape)} within "
            f"{err:.3g} of the CPU, bf16 finite")
        del model, cpu, half, got, want, out16


def zoo_train(torch, dev):
    """(c2) one bf16 O2 Momentum TrainStep each for the dropout-free
    models: a finite loss and every parameter moved."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.optimizer import Momentum

    ctors = {name: (ctor, hw) for name, ctor, hw in zoo_families()}
    for name in ZOO_TRAIN:
        ctor, hw = ctors[name]
        model = ctor(device=dev, generator=torch.Generator(device=dev).manual_seed(4))
        opt = Momentum(RESNET_TRAIN_LR, parameters=model.parameters())
        model, opt = amp.decorate(model, opt, level="O2", dtype="bfloat16")
        classes = 10 if name == "lenet" else 1000
        x, y = image_batch(torch, ZOO_BATCH, hw, 65, dev, channels=1 if name == "lenet" else 3,
                           classes=classes)
        params = [p for p in model.parameters() if p.requires_grad]
        before = [p.detach().float().clone() for p in params]
        loss = float(resnet_train_step(torch, model, opt)(x, y))
        n = moved(torch, opt, params, before)
        if not math.isfinite(loss) or n != len(params):
            raise AssertionError(f"(c2) {name}: loss {loss}, {n} of {len(params)} moved")
        log(f"zoo (c2) {name} bf16 O2 Momentum TrainStep batch {ZOO_BATCH}: loss {loss:.4f}, "
            f"all {len(params)} parameter tensors moved")
        del model, opt, params, before


def phase_resnet_train(torch, card, dev="cuda"):
    """Ladder row 1, ResNet-50 training on the card, with the optimizer and
    amp remainder and the rest of the vision zoo: (a1) f32 against the CPU,
    (a2) memorising a batch, (a) ``bench.py``'s step at batch 256 (ms,
    images/s, MFU, peak, a profiled step; (a3) no hand kernel, (a4)
    Momentum's state), (b) the eager O1 idiom with GradScaler ((b1)-(b3)),
    (b4) ERNIE under O1 through B3, (c) the zoo in eval and three models
    training.  Returns (b4)'s launches."""
    t_phase = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    resnet_f32_gate(torch, dev)
    gc.collect()
    torch.cuda.empty_cache()
    resnet_memorise(torch, dev)
    gc.collect()
    torch.cuda.empty_cache()
    resnet_ladder(torch, card, dev)
    gc.collect()
    torch.cuda.empty_cache()
    resnet_o1(torch, dev)
    gc.collect()
    torch.cuda.empty_cache()
    launches = ernie_o1(torch, card, dev)
    zoo_eval(torch, card, dev)
    zoo_train(torch, dev)
    log(f"resnet train phase: {time.perf_counter() - t_phase:.1f} s")
    return launches


ERNIE_FT_BATCH, ERNIE_FT_SEQ = 256, 128    # phase_ernie_ft: ladder row 2 (bench.py's)
ERNIE_FT_WARMUP, ERNIE_FT_STEPS = 3, 10
ERNIE_FT_LR = 2e-5                         # AdamW's learning rate (bench.py's)
ERNIE_FT_DROPOUT = 0.1                     # ErnieConfig's hidden_dropout_prob
ERNIE_FT_GATE = (2, 16)                    # gates (a)-(c): layers, rows of 128 tokens
ERNIE_FT_F32_REL = 1e-4                    # (a): card against CPU in f32, relative L2
# the key projection's bias moves no logit (softmax ignores a constant a
# row): its gradient is rounding, left out of the gradient gates and logged
ERNIE_FT_NOISE = re.compile(r"k_proj\.bias$")


class MaskTape:
    """Wraps the port's mask seam (``framework.random._keep_mask``):
    ``record`` draws through the seam and keeps each mask, ``replay``
    hands back the recorded masks in order (moved to the device asked
    for, the shapes checked), ``count`` keeps the number of draws, each
    mask's kept count (a card tensor, read after) and the host reads
    made inside the seam.  Install with :func:`mask_tape`."""

    def __init__(self, seam, mode, masks=None):
        self.seam, self.mode = seam, mode
        self.masks = [] if masks is None else list(masks)
        self.shapes, self.kept = [], []
        self.syncs = 0
        self._i = 0

    def __call__(self, shape, keep_prob, device, generator=None):
        shape = tuple(int(s) for s in shape)
        self.shapes.append(shape)
        if self.mode == "replay":
            m = self.masks[self._i]
            self._i += 1
            if tuple(m.shape) != shape:
                raise AssertionError(f"replayed mask {tuple(m.shape)} where {shape} is drawn")
            return m.to(device)
        m = self.seam(shape, keep_prob, device, generator)
        if self.mode == "record":
            self.masks.append(m)
        else:
            self.kept.append(m.sum())
        return m


@contextlib.contextmanager
def mask_tape(mode, masks=None):
    """The seam replaced by a :class:`MaskTape` inside, restored after."""
    from paddle_tpu_torch.framework import random as R

    seam = R._keep_mask
    tape = MaskTape(seam, mode, masks)
    R._keep_mask = tape
    try:
        yield tape
    finally:
        R._keep_mask = seam


def ernie_ft_model(torch, layers, dev, dtype=None):
    """``ErnieForSequenceClassification`` at ERNIE 3.0 base's width with
    ``layers`` layers, dropout 0.1, 2 classes, random weights from seed 0;
    bf16 O2 through ``amp.decorate`` when ``dtype`` is bf16."""
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.models import ErnieForSequenceClassification, ernie3_base

    model = ErnieForSequenceClassification(
        ernie3_base(num_hidden_layers=layers, hidden_dropout_prob=ERNIE_FT_DROPOUT),
        2, device=dev, seed=0)
    if dtype == "bfloat16":
        model = ptt.amp.decorate(model, level="O2", dtype="bfloat16")
    return model


def ernie_ft_batch(torch, rows, dev, vocab, seed=4):
    """``bench.py``'s batch: ids over the vocabulary and 0/1 labels from
    ``default_rng(seed)``."""
    import numpy as np

    rng = np.random.default_rng(seed)
    ids = rng.integers(0, vocab, (rows, ERNIE_FT_SEQ)).astype("int32")
    labels = rng.integers(0, 2, (rows,)).astype("int64")
    return torch.as_tensor(ids, device=dev), torch.as_tensor(labels, device=dev)


def ernie_ft_grads(torch, model, ids, labels, tape_mode, masks=None):
    """One training loss and backward with the seam taped: (loss, {name:
    f32 grad} of the parameters that get one (no segment ids: the segment
    embeddings get none), the tape)."""
    model.train()
    model.zero_grad(set_to_none=True)
    with mask_tape(tape_mode, masks) as tape:
        loss = model(ids, labels=labels)[0].float()
        loss.backward()
    grads = {n: p.grad.float().clone() for n, p in model.named_parameters()
             if p.grad is not None}
    model.zero_grad(set_to_none=True)
    return loss.detach(), grads, tape


def ernie_ft_gates(torch, card, dev="cuda"):
    """(a) f32 at ERNIE_FT_GATE's depth and rows, full width: the card's
    loss and every gradient within 1e-4 relative L2 of the same model on
    the CPU, fed the masks the card drew; (b) bf16 O2 with the same masks:
    the loss within LOGITS_REL_TOL of that f32 run, and all gradients
    together within LOGITS_REL_TOL of it or no farther from it than
    DEPTH_REL_MARGIN times the same bf16 model on the CPU is from the
    CPU's f32 run (the fine-tune's forward and backward launch no kernel,
    so its bf16 path is the plain one); one gradient's distance is logged,
    not gated: the classifier's lies in the span of the batch's 16 rows,
    and two bf16 runs' distances there part by 1.2x to 3.2x between mask
    draws; (c) the laws of the card's masks: the attention masks' keep
    share within binomial bounds, the same seed giving bit-equal masks,
    consecutive steps different ones."""
    import paddle_tpu_torch as ptt

    layers, rows = ERNIE_FT_GATE
    model = ernie_ft_model(torch, layers, dev)
    cfg, s = model.ernie.config, ERNIE_FT_SEQ
    ids, labels = ernie_ft_batch(torch, rows, dev, cfg.vocab_size)
    loss32, g32, tape = ernie_ft_grads(torch, model, ids, labels, "record")
    h = cfg.hidden_size
    want_shapes = [(rows, s, h)] + [
        (rows, cfg.num_attention_heads, s, s), (rows, s, h), (rows, s, cfg.intermediate_size),
        (rows, s, h)] * layers + [(rows, h)]
    if tape.shapes != want_shapes:
        raise AssertionError(f"(a) ERNIE fine-tune draws {tape.shapes}, want {want_shapes}")
    masks = tape.masks
    cpu = copy.deepcopy(model).to("cpu")
    lossc, gc_, _ = ernie_ft_grads(torch, cpu, ids.cpu(), labels.cpu(), "replay",
                                   [m.cpu() for m in masks])
    errs = {n: rel_l2(g32[n].cpu(), gc_[n]) for n in gc_}
    noise = {n: e for n, e in errs.items() if ERNIE_FT_NOISE.search(n)}
    worst = sorted(((e, n) for n, e in errs.items() if n not in noise), reverse=True)
    loss_err = abs(float(loss32) - float(lossc)) / abs(float(lossc))
    log(f"ernie ft (a) f32 {layers} layers {rows}x{ERNIE_FT_SEQ} on {card}: loss "
        f"{float(loss32):.6f} card, {float(lossc):.6f} CPU (relative {loss_err:.3g}); "
        f"{len(masks)} masks drawn on the card, fed to the CPU; grad relative L2 card "
        f"against CPU, worst three: " + "; ".join(f"{n} {e:.3g}" for e, n in worst[:3])
        + f"; the key biases (rounding only): "
        + ", ".join(f"{n} {e:.3g}" for n, e in noise.items()))
    if loss_err > ERNIE_FT_F32_REL or worst[0][0] > ERNIE_FT_F32_REL:
        raise AssertionError(f"(a) ERNIE fine-tune f32 card against CPU: loss {loss_err}, "
                             f"grads {worst[:3]}")
    del cpu
    half = ptt.amp.decorate(copy.deepcopy(model), level="O2", dtype="bfloat16")
    loss16, g16, _ = ernie_ft_grads(torch, half, ids, labels, "replay", masks)
    half_cpu = copy.deepcopy(half).to("cpu")
    _, g16c, _ = ernie_ft_grads(torch, half_cpu, ids.cpu(), labels.cpu(), "replay",
                                [m.cpu() for m in masks])
    every = [n for n in g32 if not ERNIE_FT_NOISE.search(n)]

    def cat(g):
        return torch.cat([g[n].reshape(-1) for n in every])

    rows16 = sorted(((rel_l2(g16[n], g32[n]), rel_l2(g16c[n], gc_[n]), n) for n in every),
                    reverse=True)
    whole = (rel_l2(cat(g16), cat(g32)), rel_l2(cat(g16c), cat(gc_)))
    loss_err16 = abs(float(loss16) - float(loss32)) / abs(float(loss32))
    log(f"ernie ft (b) bf16 O2 {layers} layers, the same masks: loss {float(loss16):.5f} "
        f"against f32 {float(loss32):.5f} (relative {loss_err16:.3g}); all gradients "
        f"{whole[0]:.4g} relative L2 to f32 (the CPU's bf16 to its f32 {whole[1]:.4g}); "
        f"one gradient's, worst three (the CPU's): "
        + "; ".join(f"{n} {e:.3g} ({ec:.3g})" for e, ec, n in rows16[:3])
        + f"; median {rows16[len(rows16) // 2][0]:.3g}")
    if loss_err16 > LOGITS_REL_TOL or (whole[0] > LOGITS_REL_TOL
                                       and whole[0] > DEPTH_REL_MARGIN * whole[1]):
        raise AssertionError(f"(b) ERNIE fine-tune bf16 against f32: loss {loss_err16}, "
                             f"all gradients {whole[0]} (the CPU's bf16 {whole[1]})")
    del half, half_cpu, g16, g16c, g32, gc_, masks
    # (c) the laws of the card's own draws
    attn = [i for i, s in enumerate(want_shapes) if len(s) == 4]
    with torch.no_grad():
        draws = []
        for seed in (77, 77, None):
            if seed is not None:
                ptt.seed(seed)
            with mask_tape("record") as t:
                model.train()(ids, labels=labels)
            draws.append(t.masks)
    same = all(torch.equal(a, b) for a, b in zip(draws[0], draws[1]))
    differ = all(not torch.equal(a, b) for a, b in zip(draws[1], draws[2]))
    n = sum(draws[0][i].numel() for i in attn)
    kept = int(sum(draws[0][i].sum() for i in attn))
    sigma = math.sqrt(n * (1 - ERNIE_FT_DROPOUT) * ERNIE_FT_DROPOUT)
    z = (kept - n * (1 - ERNIE_FT_DROPOUT)) / sigma
    log(f"ernie ft (c) the card's masks: attention keep share {kept / n:.6f} over {n} "
        f"draws ({z:+.2f} sigma from {1 - ERNIE_FT_DROPOUT}); seed 77 twice bit-equal "
        f"{same}; the next forward's masks all different {differ}")
    if abs(z) > 6 or not same or not differ:
        raise AssertionError(f"(c) ERNIE fine-tune masks: keep share z {z}, same seed equal "
                             f"{same}, consecutive draws different {differ}")
    del draws, model


DROPOUT_CODE = re.compile(r"framework/random\.py$|dropout|rrelu|attention|sdpa")


def device_syncs(torch, fn, dev="cuda"):
    """(result of ``fn()``, one entry a synchronising CUDA call during it):
    ``fn`` runs under ``torch.cuda.set_sync_debug_mode("warn")``, which
    warns at every call that waits for the card (a host read, a copy from
    pageable memory to the card, a stream synchronisation), and each
    warning is traced to its Python stack.  An entry is (the innermost
    frame of this repo as ``file:line function``, whether a frame of the
    stack lies in the dropout or attention code: ``framework/random.py``
    or a function named for dropout, RReLU or attention).  Checks first
    that the counter sees the sync of a card tensor made from a Python
    number (a host-to-device copy)."""
    import traceback
    import warnings

    root = os.path.dirname(os.path.abspath(__file__))

    def run(f):
        sites = []

        def show(message, category, filename, lineno, file=None, line=None):
            if "synchroniz" not in str(message):
                return other(message, category, filename, lineno, file, line)
            stack = [fr for fr in traceback.extract_stack()[:-1]
                     if os.path.abspath(fr.filename).startswith(root)]
            where = (f"{os.path.relpath(stack[-1].filename, root)}:{stack[-1].lineno} "
                     f"{stack[-1].name}" if stack else "outside the repo")
            hit = any(DROPOUT_CODE.search(fr.filename) or DROPOUT_CODE.search(fr.name)
                      for fr in stack if fr.filename != __file__)
            sites.append((where, hit))

        mode = torch.cuda.get_sync_debug_mode()
        with warnings.catch_warnings():
            warnings.simplefilter("always")
            other, warnings.showwarning = warnings.showwarning, show
            torch.cuda.set_sync_debug_mode("warn")
            try:
                out = f()
            finally:
                torch.cuda.set_sync_debug_mode(mode)
        return out, sites

    _, probe = run(lambda: torch.tensor(0.9, device=dev))
    if not probe:
        raise AssertionError("the sync counter missed a host-to-device copy")
    return run(fn)


def ernie_ft_run(torch, card, flags, dev="cuda"):
    """Ladder row 2 as ``bench.py`` sets it up, at full depth, with
    ``flags``: ERNIE_FT_WARMUP then ERNIE_FT_STEPS TrainSteps on one batch
    of ERNIE_FT_BATCH x ERNIE_FT_SEQ; gates (d) no synchronising CUDA call
    in a counted step (``device_syncs``), (e) finite losses falling over the
    counted steps, (f) exact launches (B5 once a step for each parameter
    tensor with a gradient, with ``use_fused_adamw``; no B3).  Returns (the counted steps'
    launches, ms a step)."""
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    from paddle_tpu_torch.ops import LAUNCHES, reset_launch_counts
    from paddle_tpu_torch.optimizer import AdamW

    gc.collect()
    torch.cuda.empty_cache()
    model = ernie_ft_model(torch, 12, dev)
    n_params = sum(p.numel() for p in model.parameters())
    n_tensors = len(list(model.parameters()))
    opt = AdamW(ERNIE_FT_LR, parameters=model.parameters(),
                grad_clip=ClipGradByGlobalNorm(1.0))
    model, opt = ptt.amp.decorate(model, opt, level="O2", dtype="bfloat16")
    step = TrainStep(model, lambda m, x, y: m(x, labels=y)[0], opt)
    ids, labels = ernie_ft_batch(torch, ERNIE_FT_BATCH, dev, model.ernie.config.vocab_size)
    flop = 6 * n_params * ERNIE_FT_SEQ * ERNIE_FT_BATCH     # bench.py's count
    label = "B5 on" if flags.get("use_fused_adamw") else "flags off"
    with ptt.flag_guard(**flags):
        losses = [step(ids, labels) for _ in range(ERNIE_FT_WARMUP)]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        t = time.perf_counter()
        losses += [step(ids, labels) for _ in range(ERNIE_FT_STEPS)]
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t) * 1e3 / ERNIE_FT_STEPS
        launches = dict(LAUNCHES)
        peak = torch.cuda.max_memory_allocated() / 2**30
        _, sites = device_syncs(torch, lambda: step(ids, labels), dev)
        wall, busy, groups, n_launches, top = ops_profile(
            torch, lambda: step(ids, labels), 1, transformer_kind)
    losses = [float(v) for v in losses]
    # every tensor with a gradient (the segment embeddings get none: no segment ids)
    updated = sum(p.grad is not None for p in model.parameters())
    want = dict.fromkeys(LAUNCHES, 0)
    if flags.get("use_fused_adamw"):
        want["adamw"] = updated * ERNIE_FT_STEPS
    counted = losses[ERNIE_FT_WARMUP:]
    falling = sum(counted[-3:]) < sum(counted[:3])
    log(f"ernie ft row 2 ({label}) ERNIE 3.0 base {n_params / 1e6:.3f} M parameters in "
        f"{n_tensors} tensors, bf16 O2 AdamW({ERNIE_FT_LR}) + clip TrainStep, dropout "
        f"{ERNIE_FT_DROPOUT}, batch {ERNIE_FT_BATCH}x{ERNIE_FT_SEQ} on {card}: {ms:.2f} ms a "
        f"step over {ERNIE_FT_STEPS} counted steps, {ERNIE_FT_BATCH / ms * 1e3:.1f} samples/s, "
        f"MFU {flop / (ms * 1e-3) / BF16_FLOPS:.4f} (bench.py's 6 N x {ERNIE_FT_SEQ} FLOP a "
        f"sample, {flop / 1e12:.2f} TFLOP a step, against {BF16_FLOPS / 1e12:.0f} TFLOP/s: "
        f"{flop / BF16_FLOPS * 1e3:.2f} ms at the peak), peak {peak:.2f} GiB; launches "
        f"{ {k: v for k, v in launches.items() if v} } ({launches['adamw'] / ERNIE_FT_STEPS:.0f}"
        f" B5 a step); synchronising CUDA calls in one step {len(sites)} (in dropout or "
        f"attention code {sum(h for _, h in sites)}; sites {sorted(set(w for w, _ in sites))});"
        f" losses " + " ".join(f"{v:.4f}" for v in losses))
    log(f"profile ernie ft step ({label}): wall {wall:.2f} ms (profiled), device busy "
        f"{busy:.2f} ms, idle share {1 - busy / wall:.3f} (against the unprofiled {ms:.2f} "
        f"ms: {1 - busy / ms:.3f}), {n_launches:.0f} CUDA launches; by operation (ms): "
        + "; ".join(f"{k} {v:.3f}" for k, v in sorted(groups.items(), key=lambda kv: -kv[1]))
        + "; top kernels, then the top of other: "
        + "; ".join(f"{name[:60]} {v:.3f}" for v, name in top))
    if sites:
        raise AssertionError(f"(d) {len(sites)} synchronising CUDA calls in one step: {sites}")
    if not all(math.isfinite(v) for v in losses) or not falling:
        raise AssertionError(f"(e) ERNIE fine-tune losses {losses}")
    if launches != want:
        raise AssertionError(f"(f) ERNIE fine-tune ({label}): launches {launches}, want {want}")
    del model, opt, step
    return launches, ms


def phase_ernie_ft(torch, card, dev="cuda"):
    """Ladder row 2, the ERNIE 3.0 base fine-tune with dropout: the gates
    (a)-(c) at 2 layers (``ernie_ft_gates``), then ``bench.py``'s steps at
    full depth with ``use_fused_adamw`` off (the reference's default) and
    on (``ernie_ft_run``: (d)-(f)).  Returns the flag-on run's launches."""
    t0 = time.perf_counter()
    ernie_ft_gates(torch, card, dev)
    gc.collect()
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    _, off_ms = ernie_ft_run(torch, card, {"use_fused_adamw": False}, dev)
    launches, on_ms = ernie_ft_run(torch, card, {"use_fused_adamw": True}, dev)
    gc.collect()
    torch.cuda.empty_cache()
    log(f"ernie ft: {off_ms:.2f} ms a step with the flags off, {on_ms:.2f} ms with B5; "
        f"phase {time.perf_counter() - t0:.1f} s (gates {t1 - t0:.1f} s)")
    return launches


A9_ZOO = (("alexnet", {}, 224), ("vgg16", {}, 224), ("squeezenet1_1", {}, 224),
          ("mobilenet_v2", {}, 224), ("mobilenet_v3_large", {}, 224), ("googlenet", {}, 224),
          ("inception_v3", {}, 299), ("densenet121", {"dropout": 0.2}, 224))
A9_GPT_SHAPE = (4, 2048)           # (b): a GPT-3 1.3B block's rows
A9_FUSED_SHAPE = (16, 512)         # (c): ERNIE's inference batch through the fused layers
A9_NORM_ROWS = 8192                # (d): the residual norms' rows at ERNIE's width


def a9_zoo(torch, dev):
    """(a) one bf16 O2 Momentum TrainStep each for the zoo's dropout
    families at their published widths, batch ZOO_BATCH, the loss summed
    over every head a model trains (GoogLeNet's two auxiliary heads too):
    a finite loss, the masks drawn, no master moved without a gradient and
    nine in ten of the others moved."""
    import paddle_tpu_torch.nn.functional as F
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.optimizer import Momentum
    from paddle_tpu_torch.vision import models as M

    def loss_fn(m, x, y):
        return sum(F.cross_entropy(out, y).mean() for out in _leaves(m(x)))

    for name, kw, hw in A9_ZOO:
        gc.collect()
        torch.cuda.empty_cache()
        model = getattr(M, name)(device=dev, generator=torch.Generator(device=dev)
                                 .manual_seed(5), **kw)
        opt = Momentum(RESNET_TRAIN_LR, parameters=model.parameters())
        model, opt = amp.decorate(model, opt, level="O2", dtype="bfloat16")
        x, y = image_batch(torch, ZOO_BATCH, hw, 66, dev)
        params = [p for p in model.parameters() if p.requires_grad]
        before = [p.detach().float().clone() for p in params]
        with mask_tape("count") as tape:
            loss = float(TrainStep(model, loss_fn, opt)(x, y))
        live = sum(p.grad is not None and bool(p.grad.any()) for p in params)
        n = moved(torch, opt, params, before)
        if not math.isfinite(loss) or not tape.shapes or n > live or n < 0.9 * live:
            raise AssertionError(f"a9 (a) {name}: loss {loss}, {len(tape.shapes)} masks, "
                                 f"{n} moved of {live} with a gradient")
        log(f"a9 (a) {name} bf16 O2 Momentum TrainStep batch {ZOO_BATCH} at {hw}² with "
            f"dropout: loss {loss:.4f}, {len(tape.shapes)} masks drawn, {n} of {live} "
            f"tensors with a gradient moved")
        del model, opt, params, before


def a9_gpt_block(torch, card, dev):
    """(b) one GPT-3 1.3B block (hidden 2048, 16 heads) with dropout 0.1
    on A9_GPT_SHAPE tokens, training forward and backward in bf16 with the
    masks recorded, then in f32 with them replayed: the composite causal
    attention (no B3 launch), 3 masks, the bf16 output and input gradient
    within LOGITS_REL_TOL of the f32 ones; ms of the bf16 step."""
    from paddle_tpu_torch.models.gpt import GPTBlock, gpt3_1p3b
    from paddle_tpu_torch.ops import LAUNCHES, reset_launch_counts

    cfg = gpt3_1p3b(dropout=0.1)
    b, s = A9_GPT_SHAPE
    block = GPTBlock(cfg, std=cfg.initializer_range, device=dev, dtype=torch.bfloat16,
                     generator=torch.Generator(device=dev).manual_seed(6)).train()
    g = torch.Generator(device=dev).manual_seed(7)
    x = torch.randn(b, s, cfg.hidden_size, device=dev, generator=g)
    cot = torch.randn(b, s, cfg.hidden_size, device=dev, generator=g)

    def step(blk, dtype):
        xi = x.detach().to(dtype, copy=True).requires_grad_()
        out = blk(xi)
        (out.float() * cot).sum().backward()
        return out.detach().float(), xi.grad.float()

    def run(blk, dtype, mode, masks=None):
        with mask_tape(mode, masks) as tape:
            return (*step(blk, dtype), tape)

    reset_launch_counts()
    out16, dx16, tape = run(block, torch.bfloat16, "record")
    torch.cuda.synchronize()
    launches = {k: v for k, v in LAUNCHES.items() if v}
    f32 = copy.deepcopy(block).float()
    out32, dx32, _ = run(f32, torch.float32, "replay", tape.masks)
    e_out, e_dx = rel_l2(out16, out32), rel_l2(dx16, dx32)
    ms = time_ms(torch, lambda: step(block, torch.bfloat16), iters=3, repeats=3, warmup=1)
    log(f"a9 (b) GPT-3 1.3B block, dropout 0.1, {b}x{s} on {card}: {len(tape.shapes)} masks "
        f"{tape.shapes[0]} first, launches {launches or 'none'}, bf16 against f32 with the "
        f"same masks: output {e_out:.3g}, input grad {e_dx:.3g}; {ms:.2f} ms a forward and "
        f"backward")
    if len(tape.shapes) != 3 or launches or e_out > LOGITS_REL_TOL or e_dx > LOGITS_REL_TOL:
        raise AssertionError(f"a9 (b) GPT block: masks {tape.shapes}, launches {launches}, "
                             f"errors {e_out}, {e_dx}")
    del block, f32


def a9_fused_layers(torch, card, dev):
    """(c) ``FusedMultiHeadAttention`` + ``FusedFeedForward`` at ERNIE's
    width (768, 12 heads, FFN 3072), ``attn_dropout_rate`` 0 and
    ``dropout_rate`` 0.1, on A9_FUSED_SHAPE tokens: two bf16 O2 AdamW
    TrainSteps, finite losses, 3 masks a step and exactly one B3, one B3b
    and one B3c launch a step.  Returns the counted step's launches."""
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.incubate.nn import FusedFeedForward, FusedMultiHeadAttention
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.nn.layer.layers import placement
    from paddle_tpu_torch.ops import LAUNCHES, reset_launch_counts
    from paddle_tpu_torch.optimizer import AdamW

    with placement(dev, torch.Generator(device=dev).manual_seed(8)):
        model = ptt.nn.Sequential(
            FusedMultiHeadAttention(768, 12, dropout_rate=0.1, attn_dropout_rate=0.0),
            FusedFeedForward(768, 3072, dropout_rate=0.1, activation="gelu"))
    opt = AdamW(1e-4, parameters=model.parameters())
    model, opt = ptt.amp.decorate(model, opt, level="O2", dtype="bfloat16")
    step = TrainStep(model, lambda m, a, t: ((m(a).float() - t) ** 2).mean(), opt)
    b, s = A9_FUSED_SHAPE
    g = torch.Generator(device=dev).manual_seed(9)
    x = torch.randn(b, s, 768, device=dev, generator=g).bfloat16()
    target = torch.randn(b, s, 768, device=dev, generator=g)
    step(x, target)
    torch.cuda.synchronize()
    reset_launch_counts()
    with mask_tape("count") as tape:
        loss = float(step(x, target))
    launches = {k: v for k, v in LAUNCHES.items() if v}
    want = {"flash_attention": 1, "flash_attention_bwd_dq": 1, "flash_attention_bwd_dkv": 1}
    ms = time_ms(torch, lambda: step(x, target), iters=3, repeats=3, warmup=1)
    log(f"a9 (c) FusedMultiHeadAttention + FusedFeedForward bf16 O2 TrainStep {b}x{s} at "
        f"ERNIE's width on {card}: loss {loss:.4f}, {len(tape.shapes)} masks, launches "
        f"{launches}, {ms:.2f} ms a step")
    if not math.isfinite(loss) or len(tape.shapes) != 3 or launches != want:
        raise AssertionError(f"a9 (c) fused layers: loss {loss}, masks {tape.shapes}, "
                             f"launches {launches}, want {want}")
    del model, opt, step
    return dict(LAUNCHES, **launches)


def a9_residual_norms(torch, card, dev):
    """(d) ``incubate`` ``fused_layer_norm(residual=...)`` (B11, B11b with
    ``use_fused_layernorm``; bf16 x with f32 weights, as GPT's under O2)
    and ``fused_rms_norm(residual=...)`` (B1, B1b; bf16 x and weight, as
    Llama's under O2) at [A9_NORM_ROWS, 768], forward and backward against
    their plain twins (the flags off) within the bf16 row; each kernel
    launched once a call.  Returns the launches."""
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.incubate.nn.functional import fused_layer_norm, fused_rms_norm
    from paddle_tpu_torch.ops import LAUNCHES, reset_launch_counts

    g = torch.Generator(device=dev).manual_seed(10)
    x = torch.randn(A9_NORM_ROWS, 768, device=dev, generator=g).bfloat16()
    r = torch.randn(A9_NORM_ROWS, 768, device=dev, generator=g).bfloat16()
    w = 1 + 0.1 * torch.randn(768, device=dev, generator=g)
    bias = 0.1 * torch.randn(768, device=dev, generator=g)
    cot = torch.randn(A9_NORM_ROWS, 768, device=dev, generator=g)
    counted = dict.fromkeys(LAUNCHES, 0)
    cases = (("fused_layer_norm", lambda *t: fused_layer_norm(t[0], t[2], t[3], 1e-5,
                                                              residual=t[1]),
              w, dict(use_fused_layernorm=True), dict(use_fused_layernorm=False),
              {"add_layer_norm": 1, "add_layer_norm_bwd": 1}),
             ("fused_rms_norm", lambda *t: fused_rms_norm(t[0], t[2], epsilon=1e-6,
                                                          residual=t[1]),
              w.bfloat16(), dict(use_fused_rms_norm=True), dict(use_fused_rms_norm=False),
              {"rms_norm": 1, "rms_norm_bwd": 1}))
    for name, fn, weight, on, off, want in cases:
        results = []
        for flags in (on, off):
            leaves = [t.clone().requires_grad_() for t in (x, r, weight, bias)]
            reset_launch_counts()
            with ptt.flag_guard(**flags):
                out, pre = fn(*leaves)
                ((out.float() * cot).sum() + (pre.float() * cot).sum()).backward()
            torch.cuda.synchronize()
            results.append(([out.detach(), pre.detach()] + [t.grad for t in leaves[:3]],
                            {k: v for k, v in LAUNCHES.items() if v}))
        (kern, launches), (plain, plain_launches) = results
        errs = [rel_l2(a, b) for a, b in zip(kern, plain)]
        log(f"a9 (d) {name}(residual=...) [{A9_NORM_ROWS}, 768] bf16 x, {weight.dtype} "
            f"weight on {card}: kernels against the plain twins, relative L2 out {errs[0]:.3g}, pre "
            f"{errs[1]:.3g}, dx {errs[2]:.3g}, dresidual {errs[3]:.3g}, dw {errs[4]:.3g}; "
            f"launches {launches}")
        if launches != want or plain_launches or max(errs) > TOL["bfloat16"]["rtol"]:
            raise AssertionError(f"a9 (d) {name}: launches {launches} (plain "
                                 f"{plain_launches}), errors {errs}")
        counted.update(launches)
    return counted


def phase_a9(torch, card, dev="cuda"):
    """The rest of A9's paths on the card: (a) the zoo's dropout families
    training, (b) a GPT-3 1.3B block with dropout, (c) the fused layers at
    ERNIE's width through B3/B3b/B3c, (d) the residual norms of
    ``incubate`` on B11/B11b and B1/B1b.  Returns the launches of (c) and
    (d)."""
    t0 = time.perf_counter()
    a9_zoo(torch, dev)
    gc.collect()
    torch.cuda.empty_cache()
    log(f"a9 (a): {time.perf_counter() - t0:.1f} s")
    a9_gpt_block(torch, card, dev)
    gc.collect()
    torch.cuda.empty_cache()
    launches = a9_fused_layers(torch, card, dev)
    norms = a9_residual_norms(torch, card, dev)
    launches.update({k: v for k, v in norms.items() if v})
    log(f"a9 phase: {time.perf_counter() - t0:.1f} s")
    return launches


def train_batch(torch, vocab):
    """One TRAIN_BATCH x TRAIN_SEQ batch from a seed, labels rolled by one."""
    import numpy as np

    ids_np = np.random.default_rng(0).integers(0, vocab, (TRAIN_BATCH, TRAIN_SEQ))
    ids_np = ids_np.astype(np.int32)
    return (torch.as_tensor(ids_np, device="cuda"),
            torch.as_tensor(np.roll(ids_np, -1, axis=1), device="cuda"))


def make_llama(layers: int, seed: int = 0):
    from paddle_tpu_torch.models import LlamaForCausalLM, llama2_7b

    return LlamaForCausalLM(llama2_7b(num_hidden_layers=layers), device="cuda", seed=seed)


def make_gpt(layers: int, seed: int = 0):
    from paddle_tpu_torch.models import GPTForCausalLM, gpt3_1p3b

    return GPTForCausalLM(gpt3_1p3b(num_hidden_layers=layers), device="cuda", seed=seed)


def grads_against_f32(torch, make, layers, on, gate_ids, gate_labels):
    """The kernels' (flags ``on``) and the plain path's loss and grads of
    one O2 bf16 model, and those of an f32 copy of its weights on the plain
    path."""
    import paddle_tpu_torch as ptt

    model = ptt.amp.decorate(make(layers), level="O2", dtype="bfloat16")
    kern = loss_and_grads(torch, model, gate_ids, gate_labels, on)
    plain = loss_and_grads(torch, model, gate_ids, gate_labels, OFF_FLAGS)
    ref = make(layers, seed=1)
    ref.load_state_dict(model.state_dict())
    del model
    f32 = loss_and_grads(torch, ref, gate_ids, gate_labels, OFF_FLAGS)
    return kern, plain, f32


def gate_shallow(torch, make, on, gate_ids, gate_labels):
    """At 2 layers, where bf16 rounding has not yet been amplified by
    depth: the kernels' loss within LOGITS_REL_TOL of the plain path's, and
    every grad too, unless the plain grad is the farther of the two from
    the f32 reference (both bf16 paths sit about 2-3e-2 from it at 7B
    width, so two correct paths can part by more than the bar).  Besides,
    no kernel grad may be further from the f32 reference than
    DEPTH_REL_MARGIN times the plain grad, whether within the bar or not."""
    (lk, gk), (lp, gp), (lf, gf) = grads_against_f32(torch, make, 2, on, gate_ids,
                                                     gate_labels)
    r_loss = abs(float(lk) - float(lp)) / abs(float(lp))
    rows = sorted(((rel_l2(gk[n], gp[n]), rel_l2(gk[n], gf[n]), rel_l2(gp[n], gf[n]), n)
                   for n in gf), reverse=True)
    log(f"train {make.__name__[5:]} 2-layer {gate_ids.shape[0]}x{gate_ids.shape[1]}: loss "
        f"kernels {float(lk):.5f} "
        f"plain {float(lp):.5f} f32 {float(lf):.5f} (kernels vs plain {r_loss:.3g}); grad "
        f"relative L2, worst three kernels vs plain (kernels to f32, plain to f32): "
        + "; ".join(f"{n} {kp:.4g} ({kf:.4g}, {pf:.4g})" for kp, kf, pf, n in rows[:3]))
    worst = max(rows, key=lambda r: r[1] / r[2])
    log(f"train {make.__name__[5:]} 2-layer: worst grad relative L2 to f32, kernels / plain, "
        f"{worst[1] / worst[2]:.3f} ({worst[3]}; at most {DEPTH_REL_MARGIN})")
    bad = [r for r in rows
           if (r[0] > LOGITS_REL_TOL and r[1] > r[2]) or r[1] > DEPTH_REL_MARGIN * r[2]]
    if r_loss > LOGITS_REL_TOL or bad:
        raise AssertionError(f"2-layer gate: loss {r_loss}; grads {bad}")
    return rows


def gate_deep(torch, make, layers, on, gate_ids, gate_labels):
    """At depth, two bf16 paths drift apart as rounding differences grow
    layer by layer: each kernel grad must be no further from an f32
    reference of the same weights (plain path) than DEPTH_REL_MARGIN times
    the plain bf16 grad."""
    (lk, gk), (lp, gp), (lf, gf) = grads_against_f32(torch, make, layers, on, gate_ids,
                                                     gate_labels)
    ratios = sorted(((rel_l2(gk[n], gf[n]) / rel_l2(gp[n], gf[n]), n) for n in gf),
                    reverse=True)
    log(f"train {make.__name__[5:]} {layers}-layer 1x{TRAIN_SEQ}: loss kernels "
        f"{float(lk):.5f} plain {float(lp):.5f} f32 {float(lf):.5f}; grad relative L2 to "
        f"f32, kernels / plain, worst three: "
        + "; ".join(f"{n} {r:.3f}" for r, n in ratios[:3]))
    if not ratios[0][0] <= DEPTH_REL_MARGIN:
        raise AssertionError(f"{layers}-layer gate: {ratios[0][1]} kernel grad is "
                             f"{ratios[0][0]:.3f}x the plain path's distance from f32")


def train_steps(torch, card, make, layers, flags, ids, labels):
    """TRAIN_WARMUP then TRAIN_STEPS TrainSteps of ``make(layers)`` under
    AMP O2 with ``flags`` on one batch; checks the launches of the counted
    steps against what the model's path needs.  Returns (the counted
    steps' launches, every step's loss, ms a counted step)."""
    import numpy as np

    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    from paddle_tpu_torch.ops import LAUNCHES, reset_launch_counts
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.telemetry import StepMeter

    gc.collect()  # an earlier phase's models in reference cycles would count in the peak
    model = make(layers)
    cfg, label = model.config, f"{make.__name__[5:]} {flags}"
    n_params, n_tensors = model.num_params(), len(list(model.parameters()))
    n_active = active_params(model)
    opt = AdamW(1e-4, parameters=model.parameters(), grad_clip=ClipGradByGlobalNorm(1.0))
    model, opt = ptt.amp.decorate(model, opt, level="O2", dtype="bfloat16")
    step = TrainStep(model, lambda m, x, y: m(x, labels=y)[0], opt)
    (rows, seq), L = ids.shape, layers
    tokens = rows * seq
    flops = 6 * n_active * tokens + L * 7 * rows * cfg.num_attention_heads \
        * seq ** 2 * cfg.head_dim
    with ptt.flag_guard(**flags):
        losses = [float(step(ids, labels)) for _ in range(TRAIN_WARMUP)]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        with tempfile.TemporaryDirectory() as telemetry_dir:
            os.environ["PADDLE_TPU_TELEMETRY_DIR"] = telemetry_dir
            try:
                meter = StepMeter(f"train_{make.__name__[5:]}", tokens_per_step=tokens,
                                  flops_per_step=flops)
            finally:
                del os.environ["PADDLE_TPU_TELEMETRY_DIR"]
            t0 = time.perf_counter()
            meter.begin()
            out = []
            for i in range(TRAIN_STEPS):
                out.append(step(ids, labels))
                if i == TRAIN_STEPS - 1:   # the meter's window ends where took's does
                    torch.cuda.synchronize()
                meter.step()
            took = time.perf_counter() - t0
            launches = dict(LAUNCHES)
            peak = torch.cuda.max_memory_allocated()
            losses += [float(x) for x in out]
            summary = meter_check(torch, meter, flops / (took / TRAIN_STEPS) / BF16_FLOPS,
                                  peak, label)
        log(f"train {label} losses: {' '.join(f'{x:.4f}' for x in losses)}")
        if not (all(np.isfinite(losses)) and losses[-1] < losses[0]):
            raise AssertionError(f"training {label}: losses not finite and falling: {losses}")
        want = {k: TRAIN_STEPS * v for k, v in step_launches(cfg, L, n_tensors).items()}
        log(f"train {label} launches in {TRAIN_STEPS} steps: {launches}")
        if launches != want:
            raise AssertionError(f"training {label}: launches {launches}, {TRAIN_STEPS} "
                                 f"steps of {L} layers launch {want}")
        step_s = took / TRAIN_STEPS
        log(f"train {label} throughput on {card}: {tokens / step_s:.1f} tokens/s, "
            f"{step_s * 1e3:.1f} ms a step ({n_params / 1e9:.3f} B params in {n_tensors} "
            f"tensors, {n_active / 1e9:.3f} B active a token, {L} layers, {rows}x{seq}), MFU "
            f"{flops / step_s / BF16_FLOPS:.4f} of {flops / 1e12:.2f} TFLOP a step at 989 "
            f"TFLOP/s; peak memory {peak / 2**30:.2f} GiB; StepMeter: {summary}")
        profile_step(torch, f"train step {label}", lambda: step(ids, labels))
    del model, opt, step
    return launches, losses, step_s * 1e3


def active_params(model) -> int:
    """The parameters one token passes through: all of them, less in each
    MoE layer the E - k experts its router does not choose."""
    cfg = model.config
    n = model.num_params()
    for layer in getattr(getattr(model, "llama", None), "layers", ()):
        if hasattr(layer.mlp, "w1"):
            experts = sum(p.numel() for p in (layer.mlp.w1, layer.mlp.w_gate, layer.mlp.w2))
            n -= experts * (cfg.moe_num_experts - cfg.moe_top_k) // cfg.moe_num_experts
    return n


def step_launches(cfg, L, n_tensors):
    """The kernel launches of one TrainStep of the model of config ``cfg``
    (a Llama or a GPT) at L layers (``n_tensors`` parameter tensors) under
    the flags now set."""
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.models import GPTConfig, LlamaConfig
    from paddle_tpu_torch.ops import LAUNCHES

    on = {k: bool(ptt.get_flags(k)[k])
          for k in ("use_fused_swiglu", "use_fused_adamw", "use_fused_layernorm")}
    per_step = dict.fromkeys(LAUNCHES, 0)
    per_step.update(flash_attention=L, flash_attention_bwd_dq=L, flash_attention_bwd_dkv=L,
                    adamw=n_tensors if on["use_fused_adamw"] else 0)
    if not isinstance(cfg, (LlamaConfig, GPTConfig)):
        raise TypeError(f"no launch count for a {type(cfg).__name__} model")
    if isinstance(cfg, LlamaConfig):
        # an MoE layer's expert SwiGLU is plain, as the reference's
        dense = sum(1 for i in range(L)
                    if not (cfg.moe_num_experts > 0 and i % cfg.moe_every == 0))
        per_step.update(rms_norm=2 * L + 1, rope=L, rms_norm_bwd=2 * L + 1, rope_bwd=L,
                        swiglu=dense if on["use_fused_swiglu"] else 0,
                        swiglu_bwd=dense if on["use_fused_swiglu"] else 0)
    else:
        per_step.update(add_layer_norm=L if on["use_fused_layernorm"] else 0,
                        add_layer_norm_bwd=L if on["use_fused_layernorm"] else 0)
    return per_step


TRAIN_F32_LAYERS = 4               # phase_train_f32: Llama-2-7B width in f32, depth cut for memory
TRAIN_F32_WARMUP, TRAIN_F32_STEPS = 1, 3
F32_GATE_REL = 1e-4                # f32 kernels against the plain f32 path, relative L2


def phase_train_f32(torch, card, make=None, batch=None):
    """The default dtype's training step, which launches B3b and B3c in f32:
    Llama-2-7B width left in f32 (no ``amp.decorate``), the default flags
    (flash attention on), AdamW(1e-4) with ClipGradByGlobalNorm(1.0)
    through TrainStep on ``train_batch``'s 4 x 2048.  Gate: at 2 layers the
    kernels' loss and every grad within F32_GATE_REL relative L2 of the
    plain path's (OFF_FLAGS) on the same weights.  Then TRAIN_F32_LAYERS
    layers, TRAIN_F32_WARMUP and TRAIN_F32_STEPS steps: finite, falling
    losses, each kernel launched as often as the path needs (L B3b and L
    B3c a step), ms a step, peak memory and a profile of one step with B3b's
    and B3c's device time.  Returns the counted steps' launches."""
    import numpy as np

    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    from paddle_tpu_torch.ops import LAUNCHES, reset_launch_counts
    from paddle_tpu_torch.optimizer import AdamW

    make = make or make_llama
    ids, labels = batch or train_batch(torch, 32000)
    gc.collect()
    model = make(2)
    (lk, gk), (lp, gp) = (loss_and_grads(torch, model, ids[:1], labels[:1], flags)
                          for flags in (None, OFF_FLAGS))
    del model
    r_loss = abs(float(lk) - float(lp)) / abs(float(lp))
    rows = sorted(((rel_l2(gk[n], gp[n]), n) for n in gp), reverse=True)
    log(f"train f32 2-layer 1x{ids.shape[1]}: loss kernels {float(lk):.7f} plain "
        f"{float(lp):.7f} (relative {r_loss:.3g}); grad relative L2 kernels vs plain, worst "
        f"three: " + "; ".join(f"{n} {r:.3g}" for r, n in rows[:3]))
    if r_loss > F32_GATE_REL or rows[0][0] > F32_GATE_REL:
        raise AssertionError(f"f32 2-layer gate: loss {r_loss}, worst grad {rows[0]}")
    del gk, gp
    torch.cuda.empty_cache()

    L = TRAIN_F32_LAYERS
    model = make(L)
    cfg, n_params, n_tensors = model.config, model.num_params(), len(list(model.parameters()))
    opt = AdamW(1e-4, parameters=model.parameters(), grad_clip=ClipGradByGlobalNorm(1.0))
    step = TrainStep(model, lambda m, x, y: m(x, labels=y)[0], opt)
    label = f"f32 {L} layers"
    losses = [float(step(ids, labels)) for _ in range(TRAIN_F32_WARMUP)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    out = [step(ids, labels) for _ in range(TRAIN_F32_STEPS)]
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / TRAIN_F32_STEPS * 1e3
    launches, peak = dict(LAUNCHES), torch.cuda.max_memory_allocated()
    losses += [float(x) for x in out]
    log(f"train {label} losses: {' '.join(f'{x:.4f}' for x in losses)}")
    if not (all(np.isfinite(losses)) and losses[-1] < losses[0]):
        raise AssertionError(f"training {label}: losses not finite and falling: {losses}")
    want = {k: TRAIN_F32_STEPS * v for k, v in step_launches(cfg, L, n_tensors).items()}
    log(f"train {label} launches in {TRAIN_F32_STEPS} steps: {launches}")
    if launches != want:
        raise AssertionError(f"training {label}: launches {launches}, {TRAIN_F32_STEPS} "
                             f"steps of {L} layers launch {want}")
    log(f"train {label} on {card}: {step_ms:.1f} ms a step ({n_params / 1e9:.3f} B params in "
        f"{n_tensors} tensors, {ids.shape[0]}x{ids.shape[1]}), peak memory "
        f"{peak / 2**30:.2f} GiB")
    busy = profile_step(torch, f"train step {label}", lambda: step(ids, labels))
    mine = {n: ms for n, ms in busy.items() if "bwd_dq_tf32" in n or "bwd_dkv_tf32" in n}
    log(f"profile train step {label}: B3b + B3c {sum(mine.values()):.3f} ms of "
        f"{sum(busy.values()):.3f} ms device time ({split_line(mine)})")
    del model, opt, step
    return launches


TRAIN_D256_LAYERS = 2              # phase_train_d256: 16 heads of 256 at 7B width
TRAIN_D256_WARMUP, TRAIN_D256_STEPS = 1, 3


def make_llama_d256(layers: int, seed: int = 0):
    """Llama-2-7B's width with 16 heads of 256 (head_dim = hidden / heads =
    256): a LlamaConfig the reference accepts, not a published model."""
    from paddle_tpu_torch.models import LlamaForCausalLM, llama2_7b

    return LlamaForCausalLM(llama2_7b(num_attention_heads=16, num_key_value_heads=16,
                                      num_hidden_layers=layers), device="cuda", seed=seed)


def phase_train_d256(torch, card, make=None, batch=None):
    """The path of the bf16 kernels at 128 < d <= 256 (``fwd_wide``,
    ``bwd_dq_wg<256>``, ``bwd_dkv_wide``): ``make_llama_d256`` at
    TRAIN_D256_LAYERS layers under AMP O2 bf16, AdamW(1e-4) with
    ClipGradByGlobalNorm(1.0) through TrainStep on ``train_batch``'s 4 x
    2048, LLAMA_ON's flags.  Gate (``gate_shallow`` at 2 layers on that
    batch): the kernels' loss within LOGITS_REL_TOL of the plain path's
    (OFF_FLAGS) on the same weights; every grad within LOGITS_REL_TOL of
    the plain grad unless the plain grad is the farther of the two from an
    f32 copy's (the kernels round dS to bf16 before dQ and dK, as the TPU
    kernel does, and the plain path rounds dP instead); and every grad no
    farther from the f32 copy than DEPTH_REL_MARGIN times the plain grad.
    The q_proj and k_proj grads, which flow through B3b's dQ, are logged
    with their three distances.  Then TRAIN_D256_WARMUP and
    TRAIN_D256_STEPS steps: finite, falling losses, each kernel launched as often as the path needs
    (L B3, L B3b and L B3c a step), ms a step, peak memory, a profile of
    one step, and B3's, B3b's and B3c's device time a step over
    TRAIN_D256_STEPS more.  Returns the counted steps' launches."""
    import numpy as np

    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    from paddle_tpu_torch.ops import LAUNCHES, reset_launch_counts
    from paddle_tpu_torch.optimizer import AdamW

    t_phase = time.perf_counter()
    make = make or make_llama_d256
    ids, labels = batch or train_batch(torch, 32000)
    L = TRAIN_D256_LAYERS
    gc.collect()
    rows = gate_shallow(torch, make, LLAMA_ON, ids, labels)
    # the grads that flow through B3b's dQ: kernels vs plain (kernels to
    # f32, plain to f32)
    log("train d256 2-layer q_proj, k_proj grads: " + "; ".join(
        f"{n} {kp:.4g} ({kf:.4g}, {pf:.4g})" for kp, kf, pf, n in sorted(rows, key=lambda r: r[3])
        if "q_proj" in n or "k_proj" in n))
    gc.collect()
    torch.cuda.empty_cache()
    model = make(L)
    cfg, n_params, n_tensors = model.config, model.num_params(), len(list(model.parameters()))
    head_dim = cfg.head_dim
    opt = AdamW(1e-4, parameters=model.parameters(), grad_clip=ClipGradByGlobalNorm(1.0))
    model, opt = ptt.amp.decorate(model, opt, level="O2", dtype="bfloat16")

    step = TrainStep(model, lambda m, x, y: m(x, labels=y)[0], opt)
    label = f"d{head_dim} {L} layers"
    with ptt.flag_guard(**LLAMA_ON):
        losses = [float(step(ids, labels)) for _ in range(TRAIN_D256_WARMUP)]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        t0 = time.perf_counter()
        out = [step(ids, labels) for _ in range(TRAIN_D256_STEPS)]
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) / TRAIN_D256_STEPS * 1e3
        launches, peak = dict(LAUNCHES), torch.cuda.max_memory_allocated()
        losses += [float(x) for x in out]
        log(f"train {label} losses: {' '.join(f'{x:.4f}' for x in losses)}")
        if not (all(np.isfinite(losses)) and losses[-1] < losses[0]):
            raise AssertionError(f"training {label}: losses not finite and falling: {losses}")
        want = {k: TRAIN_D256_STEPS * v for k, v in step_launches(cfg, L, n_tensors).items()}
        log(f"train {label} launches in {TRAIN_D256_STEPS} steps: {launches}")
        if launches != want:
            raise AssertionError(f"training {label}: launches {launches}, {TRAIN_D256_STEPS} "
                                 f"steps of {L} layers launch {want}")
        log(f"train {label} on {card}: {step_ms:.1f} ms a step ({n_params / 1e9:.3f} B params "
            f"in {n_tensors} tensors, {ids.shape[0]}x{ids.shape[1]}), peak memory "
            f"{peak / 2**30:.2f} GiB")
        profile_step(torch, f"train step {label}", lambda: step(ids, labels))
        # the split by kernel from several steps: one step's profile can
        # leave out some of its kernels' events
        busy_ms, busy = device_ms(torch, lambda: step(ids, labels), iters=TRAIN_D256_STEPS,
                                  warmup=0)
    mine = {n: ms for n, ms in busy.items()
            if any(k in n for k in ("fwd_wide", "bwd_dq_wg", "bwd_dkv_wide"))}
    log(f"device time a train step {label} over {TRAIN_D256_STEPS} steps: B3 + B3b + B3c "
        f"{sum(mine.values()):.3f} ms of {busy_ms:.3f} ms ({split_line(mine)})")
    del model, opt, step
    log(f"train_d256 phase: {time.perf_counter() - t_phase:.1f} s")
    return launches


def meter_check(torch, meter, mfu, peak, label):
    """The StepMeter around the counted steps against the script's own
    numbers: its MFU within 1% of ``mfu`` (the same FLOP count over the
    same window), the chip table's row for the card's name, its memory
    peak equal to ``torch.cuda.max_memory_allocated`` (``peak``), and its
    JSONL file, read back, one record a step.  Returns the summary."""
    from paddle_tpu_torch.telemetry import PEAK_HBM_GBPS, PEAK_TFLOPS, chip_lookup
    from paddle_tpu_torch.telemetry.memory import hbm_watermarks

    summary = meter.summary()
    name = torch.cuda.get_device_name(0)
    row = (chip_lookup(name, PEAK_TFLOPS), chip_lookup(name, PEAK_HBM_GBPS))
    log(f"StepMeter {label} on {name!r}: peaks {meter.peak_tflops} TFLOP/s and "
        f"{meter.peak_hbm_gbps} GB/s (table row {row}); MFU {summary['mfu']:.5f} against "
        f"the script's {mfu:.5f}")
    if (meter.peak_tflops, meter.peak_hbm_gbps) != row \
            or ("H100" in name and row[0] == PEAK_TFLOPS["cpu"]):
        raise AssertionError(f"StepMeter on {name!r}: peaks {meter.peak_tflops}, "
                             f"{meter.peak_hbm_gbps}; the table gives {row}")
    if abs(summary["mfu"] * meter.peak_tflops * 1e12 / BF16_FLOPS - mfu) > 0.01 * mfu:
        raise AssertionError(f"StepMeter MFU {summary['mfu']} (peak {meter.peak_tflops}) "
                             f"against {mfu} at {BF16_FLOPS / 1e12} TFLOP/s")
    wm = hbm_watermarks()
    if wm["peak_gb"] != round(peak / 1e9, 4) or summary["hbm_peak_gb"] != wm["peak_gb"]:
        raise AssertionError(f"StepMeter memory peak {wm['peak_gb']} GB, summary "
                             f"{summary['hbm_peak_gb']}, max_memory_allocated {peak}")
    with open(meter.jsonl_path) as f:
        records = [json.loads(line) for line in f]
    if [r["step"] for r in records] != list(range(1, TRAIN_STEPS + 1)) \
            or records[-1]["hbm_peak_gb"] != wm["peak_gb"]:
        raise AssertionError(f"StepMeter JSONL {meter.jsonl_path}: {records[-1:]}")
    return summary


def profile_step(torch, label, fn):
    """Device time by kernel and the device's idle share over one call of
    ``fn``, from ``torch.profiler`` (whose own host cost inflates the wall
    time and so the idle share); returns {kernel: device ms}."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3
    busy = {e.key: e.self_device_time_total / 1e3 for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA}
    total = sum(busy.values())
    top = sorted(busy.items(), key=lambda kv: -kv[1])[:8]
    log(f"profile {label}: wall {wall:.2f} ms (profiled), device busy {total:.2f} ms, "
        f"idle share {1 - total / wall:.3f}; top kernels (ms): "
        + "; ".join(f"{name[:48]} {ms:.3f}" for name, ms in top))
    return busy


def phase_profile(torch, generate, T):
    """Where the time goes: device time by kernel, and the device's idle
    share, for prefill (a 1-token generate) and per decode step (the
    difference to a T-token one), from ``torch.profiler`` on the card.  The
    profiler's own host cost inflates the wall times and so the idle share."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    runs = {}
    for n in (1, T):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            generate(n)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t) * 1e3
        kernels = {e.key: e.self_device_time_total / 1e3 for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA}
        runs[n] = (wall, kernels)
    (w1, k1), (wn, kn) = runs[1], runs[T]
    step = {name: (kn[name] - k1.get(name, 0.0)) / (T - 1) for name in kn}
    for label, wall, busy in (("prefill", w1, k1), ("decode step", (wn - w1) / (T - 1), step)):
        total = sum(busy.values())
        top = sorted(busy.items(), key=lambda kv: -kv[1])[:6]
        log(f"profile {label}: wall {wall:.2f} ms (profiled), device busy {total:.2f} ms, "
            f"idle share {1 - total / wall:.3f}; top kernels (ms): "
            + "; ".join(f"{name[:48]} {ms:.3f}" for name, ms in top))


DIST_STEPS = 3                  # DataParallel TrainSteps through the launcher
DIST_TIMEOUT_S = 480            # the launcher and its worker, kernels loaded
DIST_WATCH_S = 300.0            # CommWatchdog timeout: must not fire
DIST_BUCKET_MB = 25             # DataParallel's comm_buffer_size, and (b)'s bucket
DIST_MEMBERS = 4                # (b): single-controller members sharing cuda:0

# The launched worker of phase_dist, run as
# ``python -m paddle_tpu_torch.distributed.launch --nproc_per_node 1
# --log_dir <dir> payload.py args.json``.  It writes its results to
# ``args["out"]``.
DIST_PAYLOAD = '''
import gc, json, sys, time
import numpy as np
import torch
import torch.distributed as tdist

import paddle_tpu_torch as ptt
import paddle_tpu_torch.distributed as dist
from paddle_tpu_torch.distributed import communication as comm
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models import LlamaForCausalLM, llama2_7b, llama_tiny
from paddle_tpu_torch.nn import ClipGradByGlobalNorm
from paddle_tpu_torch.ops import LAUNCHES, reset_launch_counts
from paddle_tpu_torch.optimizer import AdamW

args = json.loads(open(sys.argv[1]).read())
dev = args["device"]
if dev == "cpu":
    ptt.set_device("cpu")
env = dist.init_parallel_env()
backend = tdist.get_backend()
if backend != ("nccl" if dev == "cuda" else "gloo") or env.world_size != 1 \\
        or env.rank != 0 or dist.get_world_size() != 1:
    raise AssertionError(f"init_parallel_env: {backend}, world {env.world_size}, "
                         f"rank {env.rank}")
sync = torch.cuda.synchronize if dev == "cuda" else (lambda: None)
fired = []
watchdog = dist.CommWatchdog(timeout=args["watch_s"], on_timeout=fired.append)


def same(what, got, want):
    if got.device.type != dev or not torch.equal(got, want):
        raise AssertionError(f"{what}: {got.device} {got.flatten()[:4]} != {want.flatten()[:4]}")


def collectives():
    """Every call of the collective API on this rank's rows, each against
    its value over one rank (the rows themselves)."""
    data = torch.as_tensor(np.random.default_rng(0).integers(-4, 5, (4, 1024)),
                           dtype=torch.float32)
    x, want = comm.scatter_stack(data), data.to(dev)
    for op in ("sum", "avg", "max", "min", "prod"):
        same(f"all_reduce {op}", comm.all_reduce(x.clone(), op=op), want)
        same(f"reduce_scatter {op}", comm.reduce_scatter(x, op=op), want)
    same("all_gather", comm.all_gather(x), want)
    same("all_gather list", comm.all_gather([], x)[0], want)
    same("all_to_all", comm.all_to_all(x), want)
    same("broadcast", comm.broadcast(x.clone(), src=0), want)
    same("reduce", comm.reduce(x.clone(), dst=0), want)
    same("scatter", comm.scatter(None, [data], src=0), want)
    same("ppermute", comm.ppermute(x, [(0, 0)]), want)
    buf = torch.zeros_like(x)
    comm.send(x, dst=0)
    comm.recv(buf, src=0)
    same("send/recv", buf, want)
    buf.zero_()
    comm.isend(x, dst=0)
    comm.irecv(buf, src=0).wait()
    same("isend/irecv", buf, want)
    buf.zero_()
    for task in comm.batch_isend_irecv([comm.P2POp(comm.isend, x, 0),
                                        comm.P2POp(comm.irecv, buf, 0)]):
        task.wait()
    same("batch_isend_irecv", buf, want)
    for got in comm.coalesced_reduce_scatter([x, x[:2]], bucket_bytes=1 << 20):
        same("coalesced_reduce_scatter", got, want[:got.shape[0]])
    same("stream.all_reduce", comm.stream.all_reduce(x.clone()), want)
    comm.barrier()
    comm.wait(x)


def timed(fn, reps):
    """ms a call of fn: CUDA events around ``reps`` calls on the card."""
    fn()
    sync()
    if dev != "cuda":
        t = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t) * 1e3 / reps
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


with watchdog.watch("collectives"):
    collectives()
    sync()

cfg = (llama2_7b if args["config"] == "llama2_7b" else llama_tiny)(
    num_hidden_layers=args["layers"])
model = LlamaForCausalLM(cfg, device=dev, seed=0)
opt = AdamW(1e-4, parameters=model.parameters(), grad_clip=ClipGradByGlobalNorm(1.0))
model, opt = ptt.amp.decorate(model, opt, level="O2", dtype="bfloat16")
dp = dist.DataParallel(model, comm_buffer_size=args["bucket_mb"])
step = TrainStep(dp, lambda m, x, y: m(x, labels=y)[0], opt)
ids = np.random.default_rng(0).integers(0, cfg.vocab_size, (args["batch"], args["seq"]))
ids = ids.astype(np.int32)
ids, labels = (torch.as_tensor(a, device=dev) for a in (ids, np.roll(ids, -1, axis=1)))
losses, step_ms = [], []
with ptt.flag_guard(**args["flags"]), watchdog.watch("train"):
    sync()
    reset_launch_counts()
    for _ in range(args["steps"]):
        t = time.perf_counter()
        losses.append(float(step(ids, labels)))
        sync()
        step_ms.append((time.perf_counter() - t) * 1e3)
    launches = dict(LAUNCHES)

# the bucket sync on the last step's gradients: apply_collective_grads
# past its one-process return, called directly
buckets = dp._grad_buckets()
grads = [p.grad for b in buckets for p in b]
nbytes = sum(g.numel() * g.element_size() for g in grads)
before = [g.clone() for g in grads]
with watchdog.watch("bucket sync"):
    sync_ms = timed(dp._sync_buckets, args["reps"])
    flat = torch.ones(args["bucket_mb"] << 19, dtype=torch.bfloat16, device=dev)
    lone_ms = timed(lambda: comm.all_reduce(flat, op="avg"), args["reps"])
unchanged = all(torch.equal(a, b) for a, b in zip(grads, before))

# fleet's hybrid path over the processes: fleet.init then DistributedTrainStep
# at ZeRO stage 2 (the sharding stage from the strategy), amp O2 by fleet
n_buckets, n_grads, grad_dtypes = len(buckets), len(grads), sorted({str(g.dtype) for g in grads})
lone_bytes = flat.numel() * flat.element_size()
del step, dp, model, opt, buckets, grads, before, flat
gc.collect()
if dev == "cuda":
    torch.cuda.empty_cache()
strategy = dist.fleet.DistributedStrategy()
strategy.amp, strategy.amp_configs = True, {"level": "O2", "dtype": "bfloat16"}
strategy.sharding, strategy.sharding_configs = True, {"stage": 2}
dist.fleet.init(is_collective=True, strategy=strategy)
hcg = dist.get_hybrid_communicate_group()
model = dist.fleet.distributed_model(LlamaForCausalLM(cfg, device=dev, seed=0))
opt = dist.fleet.distributed_optimizer(AdamW(1e-4, parameters=model.parameters(),
                                             grad_clip=ClipGradByGlobalNorm(1.0)))
zstep = dist.DistributedTrainStep(model, lambda m, x, y: m(x, labels=y)[0], opt, hcg)
if hcg.mesh.procs is None or zstep.sharding_stage != 2:
    raise AssertionError(f"fleet: {hcg.mesh}, stage {zstep.sharding_stage}")
with ptt.flag_guard(**args["flags"]), watchdog.watch("zero"):
    sync()
    reset_launch_counts()
    zero_losses = [float(zstep(ids, labels)) for _ in range(args["steps"])]
    sync()
    zero_launches = dict(LAUNCHES)
watchdog.stop()
if not unchanged:
    raise AssertionError("an AVG over one rank changed the gradients")
json.dump(dict(backend=backend, world_size=env.world_size, rank=env.rank,
               losses=losses, step_ms=step_ms, launches=launches,
               buckets=n_buckets, tensors=n_grads, bucket_bytes=nbytes,
               dtypes=grad_dtypes, sync_ms=sync_ms, lone_bytes=lone_bytes, lone_ms=lone_ms,
               watchdog_fired=len(fired), unchanged=unchanged, zero_losses=zero_losses,
               zero_launches=zero_launches, zero_procs=hcg.mesh.procs.tolist()),
          open(args["out"], "w"))
tdist.destroy_process_group()
print("dist payload done", flush=True)
'''


def dist_launch(torch, args: dict, workdir: str) -> dict:
    """Run DIST_PAYLOAD with ``args`` under the port's launcher, one
    process, its logs under ``workdir``; the payload's results.  A failed
    or hung worker fails the phase, with the tail of its log on stderr."""
    import os
    import signal

    payload = os.path.join(workdir, "payload.py")
    with open(payload, "w") as f:
        f.write(DIST_PAYLOAD)
    args = dict(args, out=os.path.join(workdir, "result.json"))
    with open(os.path.join(workdir, "args.json"), "w") as f:
        json.dump(args, f)
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=root + os.pathsep + os.environ.get("PYTHONPATH", ""))
    for k in ("PADDLE_TRAINER_ID", "PADDLE_TRAINERS_NUM", "PADDLE_MASTER",
              "PADDLE_LOCAL_RANK", "PADDLE_NPROC_PER_NODE"):
        env.pop(k, None)
    log_dir = os.path.join(workdir, "log")
    cmd = [sys.executable, "-m", "paddle_tpu_torch.distributed.launch", "--nproc_per_node",
           "1", "--log_dir", log_dir, payload, os.path.join(workdir, "args.json")]
    proc = subprocess.Popen(cmd, cwd=root, env=env, start_new_session=True,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        out = proc.communicate(timeout=DIST_TIMEOUT_S)[0]
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)   # the launcher and its worker
        out = proc.communicate()[0]
    rc = proc.returncode
    if rc != 0 or not os.path.exists(args["out"]):
        worker = os.path.join(log_dir, "workerlog.0")
        tail = open(worker).read()[-6000:] if os.path.exists(worker) else "(no workerlog.0)"
        print(f"launcher output:\n{out[-3000:]}\nworkerlog.0 tail:\n{tail}", file=sys.stderr,
              flush=True)
        raise AssertionError(f"launch --nproc_per_node 1: exit {rc}")
    with open(args["out"]) as f:
        return json.load(f)


def dist_single_controller(torch, dev="cuda"):
    """(b): every collective of a single-controller ``build_mesh(dp=4)``
    whose members share one device, on a stack of four 25 MB bf16 buckets
    of integer-valued data, against the same call on a CPU mesh: exact, and
    AVG within 1e-6 relative.  Returns {op: ms on the card}."""
    import numpy as np

    from paddle_tpu_torch.distributed import communication as comm
    from paddle_tpu_torch.distributed import topology

    n = DIST_MEMBERS
    rows, cols = 1024, (DIST_BUCKET_MB << 20) // 2 // 1024   # one member: 25 MB of bf16
    rng = np.random.default_rng(3)
    ints = torch.from_numpy(rng.integers(-4, 5, (n * rows, cols), dtype=np.int8))
    twos = torch.from_numpy(rng.choice(np.array([-2, -1, 1, 2], np.int8), (n * rows, cols)))
    groups = {where: topology.CommGroup(topology.build_mesh(dp=n, devices=[where] * n),
                                        ("data",)) for where in (dev, "cpu")}
    ring = [(i, (i + 1) % n) for i in range(n)]

    def send_recv(x, g):
        buf = torch.zeros_like(x)
        comm.send(x, dst=1, group=g)
        comm.recv(buf, src=n - 1, group=g)
        return buf

    cases = {
        "all_reduce sum": lambda x, g: comm.all_reduce(x.clone(), "sum", g),
        "all_reduce avg": lambda x, g: comm.all_reduce(x.clone(), "avg", g),
        "all_reduce max": lambda x, g: comm.all_reduce(x.clone(), "max", g),
        "all_reduce min": lambda x, g: comm.all_reduce(x.clone(), "min", g),
        "all_reduce prod": lambda x, g: comm.all_reduce(x.clone(), "prod", g),
        "all_gather": lambda x, g: comm.all_gather(x, group=g),
        "reduce_scatter": lambda x, g: comm.reduce_scatter(x, group=g),
        "all_to_all": lambda x, g: comm.all_to_all(x, group=g),
        "broadcast": lambda x, g: comm.broadcast(x.clone(), 1, g),
        "reduce": lambda x, g: comm.reduce(x.clone(), 0, group=g),
        "scatter": lambda x, g: comm.scatter(None, list(x.chunk(n)), 1, g),
        "ppermute ring": lambda x, g: comm.ppermute(x, ring, g),
        "send/recv": send_recv,
        "coalesced_reduce_scatter": lambda x, g: torch.cat(
            comm.coalesced_reduce_scatter([x, x], g, bucket_bytes=DIST_BUCKET_MB << 20)),
    }
    times = {}
    for name, fn in cases.items():
        data = twos if name.endswith("prod") else ints
        x = {w: comm.scatter_stack(data.to(torch.bfloat16), g) for w, g in groups.items()}
        got, want = fn(x[dev], groups[dev]), fn(x["cpu"], groups["cpu"])
        if got.device.type != dev or got.shape != want.shape:
            raise AssertionError(f"single controller {name}: {got.device} {tuple(got.shape)}")
        diff = float((got.cpu().float() - want.float()).abs().max())
        bound = 1e-6 * float(want.float().abs().max()) if name.endswith("avg") else 0.0
        if diff > bound:
            raise AssertionError(f"single controller {name}: card and CPU differ by {diff}")
        times[name] = time_ms(torch, lambda: fn(x[dev], groups[dev]), iters=5, repeats=3)
        comm.clear_pending_p2p()
        del x, got, want
    log(f"dist single controller, {n} members on {dev}, a {DIST_BUCKET_MB} MB bf16 bucket "
        f"each (stack [{n * rows}, {cols}]), equal to the CPU mesh; ms on the card: "
        + "; ".join(f"{k} {v:.4f}" for k, v in times.items()))
    return times


def phase_dist(torch, card, train):
    """The distributed process layer (ROADMAP A6a) on the card.  (a) The
    launcher: ``python -m paddle_tpu_torch.distributed.launch
    --nproc_per_node 1`` runs DIST_PAYLOAD, which takes NCCL at world size
    1, runs every collective on CUDA tensors, and takes DIST_STEPS
    ``TrainStep``s of Llama-2-7B width (TRAIN_LAYERS, LLAMA_ON, the
    TRAIN_BATCH x TRAIN_SEQ batch) through ``DataParallel``; its launches
    a step must equal ``phase_train``'s (``train``: launches, losses, ms a
    step) and its losses, finite and falling, each within LOGITS_REL_TOL
    of ``phase_train``'s at the same step with the same seeds; it times
    the bucket sync on the last gradients.  (b) The single-controller
    collectives (``dist_single_controller``).  (c) A ``CommWatchdog``
    armed around (a)'s collectives, training and sync must not fire."""
    import math
    import shutil
    import tempfile

    train_launches, train_losses, train_ms = train
    workdir = tempfile.mkdtemp(prefix="chip_smoke_dist_")
    try:
        t = time.perf_counter()
        res = dist_launch(torch, dict(
            device="cuda", config="llama2_7b", layers=TRAIN_LAYERS, batch=TRAIN_BATCH,
            seq=TRAIN_SEQ, steps=DIST_STEPS, flags=LLAMA_ON, bucket_mb=DIST_BUCKET_MB,
            watch_s=DIST_WATCH_S, reps=10), workdir)
        took = time.perf_counter() - t
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    losses = res["losses"]
    log(f"dist launch --nproc_per_node 1 on {card}: {took:.1f} s, backend {res['backend']}, "
        f"world {res['world_size']}, rank {res['rank']}; DataParallel losses "
        f"{' '.join(f'{x:.4f}' for x in losses)} (phase_train's first "
        f"{' '.join(f'{x:.4f}' for x in train_losses[:DIST_STEPS])}); ms a step "
        f"{' '.join(f'{x:.1f}' for x in res['step_ms'])} (phase_train's {train_ms:.1f}); "
        f"watchdog fired {res['watchdog_fired']}")
    if (res["backend"], res["world_size"], res["rank"], res["watchdog_fired"]) != \
            ("nccl", 1, 0, 0) or not res["unchanged"]:
        raise AssertionError(f"dist launch: {res}")
    per_step = {k: v * TRAIN_STEPS for k, v in res["launches"].items()}
    want = {k: v * DIST_STEPS for k, v in train_launches.items()}
    if per_step != want:
        raise AssertionError(f"dist launch: launches {res['launches']} in {DIST_STEPS} steps, "
                             f"phase_train's {train_launches} in {TRAIN_STEPS}")
    rel = [abs(a - b) / abs(b) for a, b in zip(losses, train_losses)]
    if not (all(math.isfinite(x) for x in losses) and losses[-1] < losses[0]
            and max(rel) <= LOGITS_REL_TOL):
        raise AssertionError(f"dist launch: losses {losses} against {train_losses}: {rel}")
    zero = res["zero_losses"]
    zrel = [abs(a - b) / abs(b) for a, b in zip(zero, train_losses)]
    log(f"dist fleet.init + DistributedTrainStep (ZeRO stage 2 from the strategy, amp O2) "
        f"over the process mesh {res['zero_procs']}: losses {' '.join(f'{x:.4f}' for x in zero)}"
        f" (relative to phase_train's {' '.join(f'{x:.2g}' for x in zrel)}); launches "
        f"{res['zero_launches']} in {DIST_STEPS} steps")
    if max(zrel) > LOGITS_REL_TOL or {k: v * TRAIN_STEPS for k, v in
                                      res["zero_launches"].items()} != want:
        raise AssertionError(f"dist fleet ZeRO: {zero} {res['zero_launches']}")
    ms_bucket = res["sync_ms"] / res["buckets"]
    log(f"dist bucket sync on {card}: {res['buckets']} buckets of {DIST_BUCKET_MB} MB over "
        f"{res['tensors']} gradients ({res['dtypes']}), {res['bucket_bytes'] / 1e9:.4f} GB; "
        f"{res['sync_ms']:.4f} ms a sync (pack, one NCCL AVG all_reduce a bucket, unpack), "
        f"{ms_bucket:.4f} ms a bucket, {res['bucket_bytes'] / res['sync_ms'] / 1e6:.2f} GB/s; "
        f"a lone {res['lone_bytes'] / 2**20:.0f} MiB NCCL AVG all_reduce {res['lone_ms']:.4f} "
        f"ms, {res['lone_bytes'] / res['lone_ms'] / 1e6:.2f} GB/s; AVG over one rank left "
        f"the gradients bit-equal")
    dist_single_controller(torch)


TP = 2                              # phase_tp: the model-axis members, all on cuda:0
TP_KINDS = ("bf16", "int8", "fp8")
TP_QUANT_F32_LAYERS = 8             # (a): f32 weights on int8/fp8 pages (time: PERF.md §4)
TP_LAYER_SEQ = 2048                 # (b): the decoder layer's [1, 2048] tokens
TP_WRAP_SHAPE = (TRAIN_BATCH, TRAIN_SEQ, 32, 128)   # (c): Llama-2-7B's training attention


def tp_mesh(torch, dev, **degrees):
    """A single-controller mesh whose members all sit on ``dev``."""
    import math

    from paddle_tpu_torch.distributed.topology import build_mesh

    return build_mesh(devices=[dev] * math.prod(degrees.values()), **degrees)


def tp_same(label, got, want):
    if got.shape != want.shape or not bool((got == want).all()):
        err = (got.float() - want.float()).abs().max()
        raise AssertionError(f"{label}: not bit-equal to one kernel call (max |diff| {err})")


def tp_mesh_wrappers(torch, dev="cuda"):
    """(c) The mesh wrappers at Llama-2-7B's training shape, bf16, each
    bit-equal to one kernel call on the whole tensor (rows and heads are
    independent), with exact launches: ``mesh_flash_attention`` over
    model 2 (forward and the three grads), ``mesh_ulysses_flash`` over
    model 2 x sep 2, ``mesh_rms_norm`` over data 2 x sep 2 (forward and
    dx; dw, the sum of the members' partial dw, within LOGITS_REL_TOL
    relative L2), ``mesh_rope`` over data 2 x sep 2 x model 2."""
    from paddle_tpu_torch.models.llama import _rope_tables
    from paddle_tpu_torch.ops.flash_attention import FlashAttentionFunction, flash_attention_fwd
    from paddle_tpu_torch.ops.fused_norm import RMSNormFunction, fused_rms_norm
    from paddle_tpu_torch.ops.rope import fused_rope
    from paddle_tpu_torch.ops.sharded import (mesh_flash_attention, mesh_rms_norm, mesh_rope,
                                              mesh_ulysses_flash)

    b, s, h, d = TP_WRAP_SHAPE
    g = torch.Generator(device=dev).manual_seed(12)
    q, k, v = (torch.randn(b, s, h, d, generator=g, device=dev).to(torch.bfloat16)
               for _ in range(3))
    lines = []

    def run(label, mesh, fn, want_fn, launches):
        got, n = counted_launches(torch, fn)
        if n != launches:
            raise AssertionError(f"{label}: launches {n}, want {launches}")
        want = want_fn()
        for i, (a, w) in enumerate(zip(got, want)):
            tp_same(f"{label} output {i}", a, w)
        lines.append(f"{label} on {dict((a, n_) for a, n_ in mesh.shape.items() if n_ > 1)}: "
                     f"bit-equal, launches {n}")

    m2 = tp_mesh(torch, dev, mp=2)
    run("mesh_flash_attention", m2,
        lambda: (mesh_flash_attention(q, k, v, m2, causal=True),),
        lambda: (flash_attention_fwd(q, k, v, causal=True)[0],), {"flash_attention": 2})

    def flash_grads(fn):
        qq, kk, vv = (t.detach().requires_grad_() for t in (q, k, v))
        out = fn(qq, kk, vv)
        out.backward(dout)
        return (out.detach(), qq.grad, kk.grad, vv.grad)

    dout = torch.randn(b, s, h, d, generator=g, device=dev).to(torch.bfloat16)
    run("mesh_flash_attention backward", m2,
        lambda: flash_grads(lambda a, b_, c: mesh_flash_attention(a, b_, c, m2, causal=True)),
        lambda: flash_grads(lambda a, b_, c: FlashAttentionFunction.apply(a, b_, c, True)),
        {"flash_attention": 2, "flash_attention_bwd_dq": 2, "flash_attention_bwd_dkv": 2})
    m4 = tp_mesh(torch, dev, mp=2, sep=2)
    run("mesh_ulysses_flash", m4, lambda: (mesh_ulysses_flash(q, k, v, m4, causal=True),),
        lambda: (flash_attention_fwd(q, k, v, causal=True)[0],), {"flash_attention": 4})
    x = torch.randn(b, s, h * d, generator=g, device=dev).to(torch.bfloat16)
    w = (1.0 + 0.1 * torch.randn(h * d, generator=g, device=dev)).to(torch.bfloat16)
    rows = tp_mesh(torch, dev, dp=2, sep=2)
    run("mesh_rms_norm", rows, lambda: (mesh_rms_norm(x, w, rows, 1e-5),),
        lambda: (fused_rms_norm(x, w, 1e-5)[0],), {"rms_norm": 4})
    dy = torch.randn(b, s, h * d, generator=g, device=dev).to(torch.bfloat16)

    def norm_grads(fn):
        xx, ww = x.detach().requires_grad_(), w.detach().requires_grad_()
        fn(xx, ww).backward(dy)
        return xx.grad, ww.grad

    (dx, dw), n = counted_launches(torch, lambda: norm_grads(
        lambda a, b_: mesh_rms_norm(a, b_, rows, 1e-5)))
    dx1, dw1 = norm_grads(lambda a, b_: RMSNormFunction.apply(a, b_, 1e-5))
    if n != {"rms_norm": 4, "rms_norm_bwd": 4}:
        raise AssertionError(f"mesh_rms_norm backward: launches {n}")
    tp_same("mesh_rms_norm dx", dx, dx1)
    err = rel_l2(dw, dw1)
    if not err <= LOGITS_REL_TOL:
        raise AssertionError(f"mesh_rms_norm dw: relative L2 {err} > {LOGITS_REL_TOL}")
    lines.append(f"mesh_rms_norm backward: dx bit-equal, dw (the sum of 4 members' bf16 "
                 f"partial dw) {err:.3g} relative L2 from one call's, launches {n}")
    cos, sin = (t.to(dev) for t in _rope_tables(d, s, 10000.0))
    pos = torch.arange(s, device=dev, dtype=torch.int32).expand(b, s).contiguous()
    m8 = tp_mesh(torch, dev, dp=2, sep=2, mp=2)
    run("mesh_rope", m8, lambda: mesh_rope(q, k, cos, sin, m8),
        lambda: fused_rope(q, k, cos, sin, pos), {"rope": 8})
    for line in lines:
        log(f"tp (c) {line}")


def tp_decoder_layer(torch, cfg, sp, dev, dtype):
    """A Llama decoder layer of ``mp_layers`` (column-parallel q/k/v/gate/up,
    row-parallel o/down; with ``sp`` their sequence-parallel forms and the
    activations scattered around the layer) and a column-parallel LM head,
    under the live model mesh."""
    from torch import nn

    from paddle_tpu_torch.distributed.meta_parallel import (
        ColumnParallelLinear, ColumnSequenceParallelLinear, GatherOp, RowParallelLinear,
        RowSequenceParallelLinear, ScatterOp)
    from paddle_tpu_torch.models.llama import apply_rotary_pos_emb
    from paddle_tpu_torch.nn import RMSNorm
    from paddle_tpu_torch.nn import functional as F

    col = ColumnSequenceParallelLinear if sp else ColumnParallelLinear
    row = RowSequenceParallelLinear if sp else RowParallelLinear
    hs, inter = cfg.hidden_size, cfg.intermediate_size
    H, KV, d = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
    init = dict(std=cfg.initializer_range, device=dev, dtype=dtype,
                generator=torch.Generator(device=dev).manual_seed(21))

    class Layer(nn.Module):
        def __init__(self):
            super().__init__()
            self.input_layernorm = RMSNorm(hs, cfg.rms_norm_eps, device=dev, dtype=dtype)
            self.q_proj = col(hs, H * d, has_bias=False, gather_output=False, **init)
            self.k_proj = col(hs, KV * d, has_bias=False, gather_output=False, **init)
            self.v_proj = col(hs, KV * d, has_bias=False, gather_output=False, **init)
            self.o_proj = row(H * d, hs, has_bias=False, input_is_parallel=True, **init)
            self.post_attention_layernorm = RMSNorm(hs, cfg.rms_norm_eps, device=dev,
                                                    dtype=dtype)
            self.gate_proj = col(hs, inter, has_bias=False, gather_output=False, **init)
            self.up_proj = col(hs, inter, has_bias=False, gather_output=False, **init)
            self.down_proj = row(inter, hs, has_bias=False, input_is_parallel=True, **init)
            self.lm_head = ColumnParallelLinear(hs, cfg.vocab_size, has_bias=False,
                                                gather_output=False, **init)

        def forward(self, x, cos, sin):
            b, s = x.shape[:2]
            if sp:
                x = ScatterOp.apply(x)
            hx = self.input_layernorm(x)
            q = self.q_proj(hx).view(b, s, H, d)
            k = self.k_proj(hx).view(b, s, KV, d)
            v = self.v_proj(hx).view(b, s, KV, d)
            q, k = apply_rotary_pos_emb(q, k, cos, sin)
            o = F.scaled_dot_product_attention(q, k, v, is_causal=True)
            x = x + self.o_proj(o.reshape(b, s, H * d))
            h2 = self.post_attention_layernorm(x)
            x = x + self.down_proj(F.swiglu(self.gate_proj(h2), self.up_proj(h2)))
            if sp:
                x = GatherOp.apply(x)
            return self.lm_head(x)

    return Layer()


def tp_layer(torch, cfg=None, dev="cuda", seq=TP_LAYER_SEQ, dtype=None):
    """(b) A Llama-2-7B-width decoder layer built from ``mp_layers`` under a
    ``model`` 2 mesh (both members on the card), sequence parallelism off
    and on, against the same weights in the port's ``LlamaDecoderLayer``
    with an unsharded LM head: [1, ``seq``] tokens, bf16, loss
    (``ParallelCrossEntropy`` over the 32000-wide logits, mean; the
    reference ``F.cross_entropy``) and every gradient within LOGITS_REL_TOL
    relative L2; SP on bit-equal to SP off (on one controller the SP ops
    are value identities); launches exact: B1, B1b 2 each, B2, B2 bwd,
    B3, B3b, B3c once a member, B4 and its backward once, with
    ``use_fused_swiglu`` on."""
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.distributed import topology
    from paddle_tpu_torch.distributed.meta_parallel import ParallelCrossEntropy
    from paddle_tpu_torch.models import llama2_7b
    from paddle_tpu_torch.models.llama import LlamaDecoderLayer, _rope_tables
    from paddle_tpu_torch.nn import functional as F

    cfg = cfg or llama2_7b(num_hidden_layers=1)
    dtype = dtype or torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(22)
    x = (torch.randn(1, seq, cfg.hidden_size, generator=g, device=dev)).to(dtype)
    labels = torch.randint(0, cfg.vocab_size, (1, seq), generator=g, device=dev)
    labels[0, :7] = -100
    cos, sin = (t.to(dev) for t in _rope_tables(cfg.head_dim, cfg.max_position_embeddings,
                                                   cfg.rope_theta))
    names = ("q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj", "down_proj")
    results = {}
    saved = topology.get_hybrid_communicate_group()
    topology.set_hybrid_communicate_group(
        topology.HybridCommunicateGroup(mesh=tp_mesh(torch, dev, mp=TP)))
    try:
        with ptt.flag_guard(use_fused_swiglu=True):
            for sp in (False, True):
                layer = tp_decoder_layer(torch, cfg, sp, dev, dtype)
                ce = ParallelCrossEntropy(ignore_index=-100)

                def step():
                    xx = x.detach().requires_grad_()
                    per = ce(layer(xx, cos, sin), labels)
                    loss = per.sum() / (labels != -100).sum()
                    loss.backward()
                    return loss.detach(), xx.grad

                (loss, dx), n = counted_launches(torch, step)
                grads = {nm: p.grad for nm, p in layer.named_parameters()}
                results[sp] = (loss, dx, grads, n)
    finally:
        topology.set_hybrid_communicate_group(saved)
    ref = LlamaDecoderLayer(cfg, std=cfg.initializer_range, device=dev, dtype=dtype,
                            generator=torch.Generator(device=dev).manual_seed(0))
    head = layer.lm_head.weight.detach()
    with torch.no_grad():
        ref.input_layernorm.weight.copy_(layer.input_layernorm.weight)
        ref.post_attention_layernorm.weight.copy_(layer.post_attention_layernorm.weight)
        for nm in names:
            sub = ref.self_attn if nm in names[:4] else ref.mlp
            getattr(sub, nm).weight.copy_(getattr(layer, nm).weight)
    with ptt.flag_guard(use_fused_swiglu=True):
        def ref_step():
            xx = x.detach().requires_grad_()
            hw = head.clone().requires_grad_()
            logits = F.linear(ref(xx, cos, sin), hw)
            loss = F.cross_entropy(logits.reshape(-1, cfg.vocab_size), labels.reshape(-1),
                                   ignore_index=-100)
            loss.backward()
            return loss.detach(), xx.grad, hw.grad

        (rloss, rdx, rhead), rn = counted_launches(torch, ref_step)
    ref_grads = {"input_layernorm.weight": ref.input_layernorm.weight.grad,
                 "post_attention_layernorm.weight": ref.post_attention_layernorm.weight.grad,
                 "lm_head.weight": rhead}
    for nm in names:
        sub = ref.self_attn if nm in names[:4] else ref.mlp
        ref_grads[f"{nm}.weight"] = getattr(sub, nm).weight.grad
    want = {"rms_norm": 2, "rms_norm_bwd": 2, "rope": TP, "rope_bwd": TP,
            "flash_attention": TP, "flash_attention_bwd_dq": TP,
            "flash_attention_bwd_dkv": TP, "swiglu": 1, "swiglu_bwd": 1}
    for sp, (loss, dx, grads, n) in results.items():
        if n != want:
            raise AssertionError(f"tp layer (sp {sp}): launches {n}, want {want}")
        rel = {"loss": abs(float(loss) - float(rloss)) / abs(float(rloss)), "dx": rel_l2(dx, rdx)}
        rel.update({nm: rel_l2(gr, ref_grads[nm]) for nm, gr in grads.items()})
        worst = max(rel, key=rel.get)
        log(f"tp (b) decoder layer of mp_layers, sequence_parallel {sp}, [1, {seq}] tokens, "
            f"tp {TP}: loss {float(loss):.5f} (unsharded {float(rloss):.5f}); worst relative "
            f"L2 to the unsharded layer {rel[worst]:.4g} ({worst}); launches {n} (unsharded "
            f"{rn})")
        if not rel[worst] <= LOGITS_REL_TOL:
            raise AssertionError(f"tp layer (sp {sp}): {worst} {rel[worst]} > {LOGITS_REL_TOL}")
    off, on = results[False], results[True]
    if not (torch.equal(off[0], on[0]) and torch.equal(off[1], on[1])
            and all(torch.equal(off[2][nm], on[2][nm]) for nm in off[2])):
        raise AssertionError("tp layer: sequence_parallel on differs from off")
    log("tp (b) sequence_parallel on: loss and every gradient bit-equal to off")


def tp_record(torch, e):
    """Spy on engine ``e``: the f32 logits that chose each token, by
    (rid, token index).  Returns (record, undo)."""
    rec, cur = {}, []
    fwd, pre = e._forward, e._prefill

    def prefill(r):
        cur[:] = [r]
        return pre(r)

    def spy(tokens, positions, tables, n_tok, take=None):
        out = fwd(tokens, positions, tables, n_tok, take=take)
        if take is not None:
            rec[(cur[0].rid, 0)] = out[0, 0].float().cpu()
        else:
            for row, r in e._active.items():
                rec[(r.rid, len(r.generated))] = out[row, 0].float().cpu()
        return out

    e._forward, e._prefill = spy, prefill

    def undo():
        del e._forward, e._prefill
    return rec, undo


def tp_serve(torch, model, tp, kind, prompts, T, record=False):
    """Serve ``prompts`` (T new tokens each) on ``ServingEngine(model,
    tp=tp)`` with ``kind`` pages; returns the streams, the launches, the
    recorded logits and the run's seconds."""
    from paddle_tpu_torch.serving import ServingEngine

    e = ServingEngine(model, tp=tp, kv_dtype=kind, **ENGINE_KW)
    rec, undo = tp_record(torch, e) if record else ({}, None)
    rids = [e.submit(p, max_new_tokens=T) for p in prompts]
    torch.cuda.synchronize()
    t = time.perf_counter()
    (outs, n) = counted_launches(torch, e.run)
    secs = time.perf_counter() - t
    if undo is not None:
        undo()
    e.pool.check_leaks()
    streams = [[int(t_) for t_ in outs[r]] for r in rids]
    logits = {(i, j): rec[(r, j)] for i, r in enumerate(rids) for j in range(T)
              if (r, j) in rec}
    del e
    return streams, n, logits, secs


def tp_streams(torch, label, got, want, got_logits, want_logits, T):
    """``got`` (tp=2) against ``want`` (tp=1), one stream a prompt, with the
    logits that chose each token: each pair token-exact or parted at a
    near-tie ``certify_divergence`` certifies, and every logit of the
    shared prefix within LOGITS_REL_TOL.  Returns (worst relative L2, exact
    streams, a note for each parting)."""
    worst, exact, notes = 0.0, 0, []
    for i, (a, b) in enumerate(zip(got, want)):
        stop = first_diff(a, b)
        for j in range(T if stop is None else stop):
            worst = max(worst, rel_l2(got_logits[(i, j)], want_logits[(i, j)]))
        same, note = certify_divergence(
            torch, f"{label} prompt {i}", a, b, {j: got_logits[(i, j)] for j in range(T)},
            {j: want_logits[(i, j)] for j in range(T)}, True)
        exact += same == T
        if stop is not None:
            notes.append(f"prompt {i}: " + note.replace("serial", "tp=1").replace(
                "other", f"tp={TP}"))
    if not worst <= LOGITS_REL_TOL:
        raise AssertionError(f"{label}: logits {worst} > {LOGITS_REL_TOL}")
    return worst, exact, notes


def tp_want(L, chunks, steps, tp):
    """Launches of an engine run: per forward (each prefill chunk and
    decode step) B1 2L + 1 times (the norms run once, on the model's
    card) and B2 tp x L times (each member rotates its heads)."""
    return {"rms_norm": (2 * L + 1) * (chunks + steps), "rope": tp * L * (chunks + steps)}


def tp_engine(torch, card, cfg, make):
    """(a) ``ServingEngine(tp=2)`` on Llama-2-7B (``cfg``; ``make(layers,
    dtype)`` builds it),
    both members on the card, phase_engine's 8 ragged prompts, MAX_NEW new
    tokens, bf16, int8 and fp8 pages.  Gates (``tp_streams``): f32 weights
    at full depth, every stream on f32 pages equal to ``tp=1``'s; f32
    weights at TP_QUANT_F32_LAYERS on int8 and fp8 pages, and bf16 at 2
    layers on every page type, every logit that chose a
    token both engines emit within LOGITS_REL_TOL of ``tp=1``'s and the
    streams equal or parted at a certified near-tie (on int8 and fp8 pages
    a k or v that differs from ``tp=1``'s by f32 rounding can round to
    another code, so exactness is not promised there); exact launches
    (``tp_want``) on every run; no leaked page.  Then, at full depth in
    bf16, ``tp=1`` and ``tp=2`` side by side: the prefill of a 512-token
    prompt, the decode step, pool bytes a token in all and a member, and
    peak memory."""
    import numpy as np

    from paddle_tpu_torch.serving import ServingEngine

    L, T, P = cfg.num_hidden_layers, MAX_NEW, ENGINE_KW["page_tokens"]
    rng = np.random.default_rng(4)
    prompts = [rng.integers(1, cfg.vocab_size, n).astype(np.int32)
               for n in ENGINE_PROMPT_LENS]
    chunks = sum(-(-len(p) // P) for p in prompts)

    def check(label, n, tp, layers):
        want = tp_want(layers, chunks, T - 1, tp)
        if n != want:
            raise AssertionError(f"{label}: launches {n}, want {want}")

    for kind in TP_KINDS:
        depth = L if kind == "bf16" else min(L, TP_QUANT_F32_LAYERS)
        if kind in TP_KINDS[:2]:   # full depth for bf16 pages, then the quantized depth
            model = None
            gc.collect()
            torch.cuda.empty_cache()
            model = make(depth, torch.float32)
        (s1, n1, lg1, t1), (s2, n2, lg2, t2) = (
            tp_serve(torch, model, tp, kind, prompts, T, record=True) for tp in (1, TP))
        check(f"tp 1 f32 {kind}", n1, 1, depth)
        check(f"tp {TP} f32 {kind}", n2, TP, depth)
        worst, exact, notes = tp_streams(torch, f"tp f32 {kind}", s2, s1, lg2, lg1, T)
        log(f"tp (a) f32 weights, {depth} layers, {kind} pages: {exact} of {len(prompts)} "
            f"tp={TP} streams token-exact against tp=1 ({T} tokens each); worst relative L2 "
            f"of the logits {worst:.4g}; runs {t1:.2f} s (tp=1) and {t2:.2f} s (tp={TP})"
            f"{'; ' if notes else ''}{'; '.join(notes)}")
        if kind == "bf16" and exact != len(prompts):
            raise AssertionError(f"tp f32 pages: {len(prompts) - exact} streams part from tp=1")
    del model
    gc.collect()
    torch.cuda.empty_cache()

    shallow = make(2, torch.bfloat16)
    for kind in TP_KINDS:
        (s1, n1, lg1, _), (s2, n2, lg2, _) = (
            tp_serve(torch, shallow, tp, kind, prompts, T, record=True) for tp in (1, TP))
        check(f"tp 1 2-layer {kind}", n1, 1, 2)
        check(f"tp {TP} 2-layer {kind}", n2, TP, 2)
        worst, exact, notes = tp_streams(torch, f"tp 2-layer {kind}", s2, s1, lg2, lg1, T)
        log(f"tp (a) bf16, 2 layers, {kind} pages: worst relative L2 of tp={TP}'s logits to "
            f"tp=1's {worst:.4g} (tol {LOGITS_REL_TOL}); {exact} of {len(prompts)} streams "
            f"token-exact{'; ' if notes else ''}{'; '.join(notes)}")
    del shallow
    gc.collect()
    torch.cuda.empty_cache()

    model = make(L, torch.bfloat16)
    p512 = rng.integers(1, cfg.vocab_size, ENGINE_PREFILL_LEN).astype(np.int32)
    for tp in (1, TP):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        engines = {k: ServingEngine(model, tp=tp, kv_dtype=k, **ENGINE_KW) for k in TP_KINDS}
        arenas = torch.cuda.memory_allocated() - base
        _, _, _, step_s, launches = engine_lockstep(torch, engines, prompts, T)
        peak = torch.cuda.max_memory_allocated()
        for k, e in engines.items():
            e.run()
            e.pool.check_leaks()
            check(f"tp {tp} bf16 {k}", {n: c for n, c in launches[k].items() if c}, tp, L)
        for k, e in engines.items():
            e.pool.alloc("p512", e.pool.pages_for(ENGINE_PREFILL_LEN + 1))
            table = e._padded_table("p512")[None]
            ms = []
            for _ in range(2):
                torch.cuda.synchronize()
                t = time.perf_counter()
                e._prefill_chunks(p512, table)
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t) * 1e3)
            e.pool.free("p512")
            decode = step_s[k][1:]
            log(f"tp (a) tp={tp} {k} pages, {L} layers bf16 on {card}: prefill of a "
                f"{ENGINE_PREFILL_LEN}-token prompt {min(ms):.1f} ms; decode step "
                f"{np.mean(decode) * 1e3:.2f} ms at batch {BATCH} (median "
                f"{np.median(decode) * 1e3:.2f}); pool {e.pool.bytes_per_token():.0f} B a token "
                f"in all, {e.pool.member_bytes_per_token():.0f} B a member")
        log(f"tp (a) tp={tp}: three engines' arenas {arenas / 2**30:.3f} GiB; peak "
            f"{peak / 2**30:.2f} GiB with the model during the lockstep run; launches a run "
            f"{tp_want(L, chunks, T - 1, tp)}")
        del engines
        gc.collect()
        torch.cuda.empty_cache()
    del model
    gc.collect()
    torch.cuda.empty_cache()


def tp_make(layers, dtype):
    """Llama-2-7B at ``layers`` layers in ``dtype`` on the card, seeded."""
    from paddle_tpu_torch.models import LlamaForCausalLM, llama2_7b

    return LlamaForCausalLM(llama2_7b(num_hidden_layers=layers), device="cuda",
                            dtype=dtype, seed=0).eval()


def phase_tp(torch, card):
    """The model axis (ROADMAP A6b) on the card, every member on cuda:0:
    (c) the mesh wrappers (``tp_mesh_wrappers``), (b) a decoder layer of
    ``mp_layers`` with sequence parallelism off and on (``tp_layer``), (a)
    ``ServingEngine(tp=2)`` on Llama-2-7B (``tp_engine``)."""
    t = time.perf_counter()
    tp_mesh_wrappers(torch)
    torch.cuda.empty_cache()
    tp_layer(torch)
    gc.collect()
    torch.cuda.empty_cache()
    from paddle_tpu_torch.models import llama2_7b

    tp_engine(torch, card, llama2_7b(), tp_make)
    log(f"tp phase: {time.perf_counter() - t:.1f} s")


HYBRID = dict(dp_degree=1, mp_degree=2, pp_degree=2, sharding_degree=2)   # 8 members
HYBRID_STEPS, HYBRID_GATED = 5, 3   # steps a stage; the first 3 gated on phase_train's
PIPE_LAYERS, PIPE_M = 4, 4          # (b): 7B-width decoder layers, micro-batches
RING_DEGREES = (2, 4)               # (c): the model degrees of the ring


def hybrid_want(L, tensors, degrees=HYBRID):
    """Launches of one hybrid step at ``degrees`` on TRAIN_BATCH x
    TRAIN_SEQ: the mesh wrappers split the batch over data x sharding (2
    blocks at HYBRID's) and, for rope and flash, the heads over model (2 x
    2 blocks); SwiGLU runs on the global tensors; B5 runs on each state's
    sharding blocks."""
    blocks = degrees["sharding_degree"] * degrees["dp_degree"]
    heads = blocks * degrees["mp_degree"]
    return {"rms_norm": blocks * (2 * L + 1), "rms_norm_bwd": blocks * (2 * L + 1),
            "rope": heads * L, "rope_bwd": heads * L, "flash_attention": heads * L,
            "flash_attention_bwd_dq": heads * L, "flash_attention_bwd_dkv": heads * L,
            "swiglu": L, "swiglu_bwd": L, "adamw": blocks * tensors}


def hybrid_fleet(dev, stage, degrees=HYBRID, offload=False):
    """fleet.init at ``degrees``, every member on ``dev``, with amp O2 bf16
    and the sharding stage (and ``offload``, when set) in the strategy."""
    import paddle_tpu_torch.distributed as dist

    s = dist.fleet.DistributedStrategy()
    s.hybrid_configs = dict(degrees, sep_degree=1)
    s.amp, s.amp_configs = True, {"level": "O2", "dtype": "bfloat16"}
    s.sharding, s.sharding_configs = True, {"stage": stage}
    if offload:
        s.sharding_configs["offload"] = True
    n = 1
    for v in degrees.values():
        n *= v
    dist.fleet.init(is_collective=True, strategy=s, devices=[dev] * n)
    return dist.get_hybrid_communicate_group()


def hybrid_step(torch, cfg, weights, dev, stage, offload=False):
    """LlamaForCausalLMHybrid(cfg) with ``weights`` (a plain Llama's, numpy)
    through convert.py, fleet's distributed_model / distributed_optimizer
    (AdamW(1e-4) + ClipGradByGlobalNorm(1.0)), and DistributedTrainStep at
    ``stage`` (from the optimizer's tag; ``offload`` too)."""
    import paddle_tpu_torch.distributed as dist
    from paddle_tpu_torch.convert import load_numpy_state_dict
    from paddle_tpu_torch.models.llama_parallel import (LlamaForCausalLMHybrid,
                                                        stack_llama_state_dict)
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    from paddle_tpu_torch.optimizer import AdamW

    hcg = hybrid_fleet(dev, stage, offload=offload)
    model = LlamaForCausalLMHybrid(cfg, hcg, device=dev, dtype=torch.bfloat16)
    load_numpy_state_dict(model, stack_llama_state_dict(weights))
    model = dist.fleet.distributed_model(model)
    opt = dist.fleet.distributed_optimizer(AdamW(
        1e-4, parameters=model.parameters(), grad_clip=ClipGradByGlobalNorm(1.0)))
    step = dist.DistributedTrainStep(model, lambda m, x, y: m(x, labels=y)[0], opt, hcg)
    if (step.sharding_stage, step.offload) != (stage, offload):
        raise AssertionError(f"hybrid: stage {step.sharding_stage}, offload {step.offload}; "
                             f"asked {stage}, {offload}")
    return model, opt, step


def host_weights(torch, layers):
    """The seeded plain Llama-2-7B-width model's f32 weights (phase_train's),
    as numpy."""
    plain = make_llama(layers)
    weights = {k: v.detach().cpu().numpy().copy() for k, v in plain.state_dict().items()}
    del plain
    return weights


def hybrid_gate_shallow(torch, cfg, dev, ids, labels):
    """(a) at 2 layers, bf16: the hybrid model's loss and every grad within
    LOGITS_REL_TOL relative L2 of the plain LlamaForCausalLM's with the
    same weights (TrainStep's path), at each stage."""
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.models import LlamaForCausalLM
    from paddle_tpu_torch.models.llama_parallel import stack_llama_state_dict

    weights = host_weights(torch, 2)
    plain = LlamaForCausalLM(cfg, device=dev, seed=1)
    plain.load_state_dict({k: torch.from_numpy(v) for k, v in weights.items()})
    plain = ptt.amp.decorate(plain, level="O2", dtype="bfloat16")
    ploss, pgrads = loss_and_grads(torch, plain, ids, labels, LLAMA_ON, torch.float32)
    del plain
    want = stack_llama_state_dict({k: g.cpu().numpy() for k, g in pgrads.items()})
    for stage in (1, 2, 3):
        model, opt, step = hybrid_step(torch, cfg, weights, dev, stage)
        with ptt.flag_guard(**LLAMA_ON):
            loss, grads = step._loss_and_grads(step._batch((ids, labels)))
        names = {id(p): n for n, p in model.named_parameters()}
        rel = {names[id(p)]: rel_l2(g, torch.from_numpy(want[names[id(p)]]).to(g.device))
               for p, g in grads}
        rel["loss"] = abs(float(loss) - float(ploss)) / abs(float(ploss))
        worst = max(rel, key=rel.get)
        log(f"hybrid (a) 2-layer stage {stage}: loss {float(loss):.5f} (plain "
            f"{float(ploss):.5f}); worst relative L2 to the plain model's {rel[worst]:.4g} "
            f"({worst}) over {len(grads)} grads")
        if not rel[worst] <= LOGITS_REL_TOL:
            raise AssertionError(f"hybrid 2-layer stage {stage}: {worst} {rel[worst]}")
        del model, opt, step, grads
        gc.collect()


def hybrid_steps(torch, card, cfg, weights, dev, ids, labels, train_losses):
    """(a) at TRAIN_LAYERS: HYBRID_STEPS DistributedTrainSteps a stage; the
    first HYBRID_GATED losses within LOGITS_REL_TOL of phase_train's; the
    steps after the first counted: exact launches (hybrid_want), step ms
    (median), tokens/s, MFU, peak memory.  Returns the counted launches of
    all three stages."""
    import statistics

    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.ops import LAUNCHES, reset_launch_counts

    total = {}
    L = cfg.num_hidden_layers
    for stage in (1, 2, 3):
        gc.collect()
        torch.cuda.empty_cache()
        model, opt, step = hybrid_step(torch, cfg, weights, dev, stage)
        n_params = sum(p.numel() for p in step._params)
        with ptt.flag_guard(**LLAMA_ON):
            losses, ms = [float(step(ids, labels))], []
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_launch_counts()
            for _ in range(HYBRID_STEPS - 1):
                t = time.perf_counter()
                losses.append(float(step(ids, labels)))
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t) * 1e3)
            launches = {k: c for k, c in LAUNCHES.items() if c}
        peak = torch.cuda.max_memory_allocated()
        counted = HYBRID_STEPS - 1
        want = {k: counted * v for k, v in hybrid_want(L, len(step._params)).items()}
        rel = [abs(a - b) / abs(b) for a, b in zip(losses, train_losses)]
        med = statistics.median(ms)
        tokens = TRAIN_BATCH * TRAIN_SEQ
        flops = 6 * n_params * tokens + L * 7 * TRAIN_BATCH * cfg.num_attention_heads \
            * TRAIN_SEQ ** 2 * cfg.head_dim
        log(f"hybrid (a) stage {stage}, {L} layers, {TRAIN_BATCH}x{TRAIN_SEQ}, {HYBRID} on "
            f"{card}: losses {' '.join(f'{x:.4f}' for x in losses)} (phase_train's "
            f"{' '.join(f'{x:.4f}' for x in train_losses[:HYBRID_STEPS])}; relative "
            f"{' '.join(f'{x:.2g}' for x in rel)}); step ms {' '.join(f'{x:.1f}' for x in ms)} "
            f"(median {med:.1f}), {tokens / med * 1e3:.1f} tokens/s, MFU "
            f"{flops / (med / 1e3) / BF16_FLOPS:.4f} of {flops / 1e12:.2f} TFLOP a step; peak "
            f"{peak / 2**30:.2f} GiB; launches in {counted} steps {launches}")
        if max(rel[:HYBRID_GATED]) > LOGITS_REL_TOL or not all(map(math.isfinite, losses)):
            raise AssertionError(f"hybrid stage {stage}: losses {losses} against "
                                 f"{train_losses[:HYBRID_STEPS]}")
        if launches != want:
            raise AssertionError(f"hybrid stage {stage}: launches {launches}, want {want}")
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        if stage == 1:
            with ptt.flag_guard(**LLAMA_ON):
                profile_step(torch, f"hybrid step stage {stage}", lambda: step(ids, labels))
        del model, opt, step
    return total


def pipe_blocks(torch, cfg, n, dev, dtype, seed=5):
    """``n`` seeded Llama decoder layers, each taking one input (the rope
    tables its buffers), as the pipeline engines call a block."""
    from torch import nn

    from paddle_tpu_torch.models.llama import LlamaDecoderLayer, _rope_tables

    cos, sin = _rope_tables(cfg.head_dim, cfg.max_position_embeddings, cfg.rope_theta)

    class Block(nn.Module):
        def __init__(self, layer):
            super().__init__()
            self.layer = layer
            self.register_buffer("cos", cos.to(dev), persistent=False)
            self.register_buffer("sin", sin.to(dev), persistent=False)

        def forward(self, x):
            return self.layer(x, self.cos, self.sin)

    g = torch.Generator(device=dev).manual_seed(seed)
    return [Block(LlamaDecoderLayer(cfg, std=cfg.initializer_range, device=dev, dtype=dtype,
                                    generator=g)) for _ in range(n)]


def pipe_loss(out, y):
    return (out.float() - y.float()).square().mean()


def pipe_sequential(torch, blocks, x, y, m):
    """Loss and every block's grads of ``blocks`` run on each micro-batch in
    turn (each loss / m), the reference the engines are held to."""
    params = [p for b in blocks for p in b.parameters()]
    grads = [torch.zeros_like(p) for p in params]
    total = 0.0
    for mx, my in zip(x.chunk(m), y.chunk(m)):
        h = mx
        for b in blocks:
            h = b(h)
        loss = pipe_loss(h, my) / m
        for acc, d in zip(grads, torch.autograd.grad(loss, params)):
            acc += d
        total += float(loss.detach())
    per = len(params) // len(blocks)
    return total, [grads[i * per:(i + 1) * per] for i in range(len(blocks))]


def hybrid_pipeline(torch, card, cfg, dev, seq, tol32=1e-5):
    """(b) OneFOneBLayers at pp 2 (both stages on ``dev``), v 1 and 2, M 4,
    on PIPE_LAYERS decoder layers, [TRAIN_BATCH, seq] tokens, recompute
    True and False: loss and grads against the layers run in turn, f32
    within ``tol32`` and bf16 within LOGITS_REL_TOL relative L2; segments
    run P·M·v against GPipe's P·(M+P-1); ms and peak memory of each policy;
    PipelineParallel.train_batch on a PipelineLayer of the same blocks
    against OneFOneBLayers.train_batch, f32 losses within ``tol32``."""
    from paddle_tpu_torch.distributed import GPipeLayers, OneFOneBLayers
    from paddle_tpu_torch.distributed.meta_parallel import PipelineLayer, PipelineParallel
    from paddle_tpu_torch.optimizer import AdamW

    mesh = tp_mesh(torch, dev, pp=2)
    g = torch.Generator(device=dev).manual_seed(31)
    x32 = torch.randn(TRAIN_BATCH, seq, cfg.hidden_size, generator=g, device=dev)
    y32 = torch.randn(TRAIN_BATCH, seq, cfg.hidden_size, generator=g, device=dev)
    for dtype, tol in ((torch.float32, tol32), (torch.bfloat16, LOGITS_REL_TOL)):
        x, y = x32.to(dtype), y32.to(dtype)
        blocks = pipe_blocks(torch, cfg, PIPE_LAYERS, dev, dtype)
        torch.cuda.synchronize()
        t = time.perf_counter()
        want_loss, want_grads = pipe_sequential(torch, blocks, x, y, PIPE_M)
        torch.cuda.synchronize()
        log(f"hybrid (b) sequential {str(dtype)[6:]}: {PIPE_LAYERS} layers on {PIPE_M} "
            f"micro-batches in turn, forward and backward "
            f"{(time.perf_counter() - t) * 1e3:.1f} ms on {card}")
        names = [n for n, _ in blocks[0].named_parameters()]
        for v in (1, 2):
            for recompute in (True, False):
                eng = OneFOneBLayers(blocks, mesh, PIPE_M, pipe_loss, num_virtual_stages=v,
                                     recompute=recompute)
                gc.collect()
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                base = torch.cuda.memory_allocated()
                t = time.perf_counter()
                loss, grads = eng.loss_and_grads(x, y)
                torch.cuda.synchronize()
                took = (time.perf_counter() - t) * 1e3
                peak = torch.cuda.max_memory_allocated() - base
                rel = {"loss": abs(float(loss) - want_loss) / abs(want_loss)}
                for k, name in enumerate(names):
                    ref = torch.stack([want_grads[i][k] for i in eng._row_order.tolist()])
                    rel[name] = rel_l2(grads[k], ref)
                worst = max(rel, key=rel.get)
                segs = (eng.segments_run, eng.segments_recomputed)
                log(f"hybrid (b) 1F1B {str(dtype)[6:]} v {v} recompute {recompute}: loss "
                    f"{float(loss):.6f} (sequential {want_loss:.6f}); worst relative L2 "
                    f"{rel[worst]:.3g} ({worst}); segments run {segs[0]} (P·M·v "
                    f"{2 * PIPE_M * v}), recomputed {segs[1]}; {took:.1f} ms, peak "
                    f"{peak / 2**30:.2f} GiB above the weights on {card}")
                if rel[worst] > tol or segs[0] != 2 * PIPE_M * v or \
                        segs[1] != (2 * PIPE_M * v if recompute else 0):
                    raise AssertionError(f"1F1B {dtype} v {v} recompute {recompute}: {rel}, "
                                         f"segments {segs}")
                del eng, grads
        if dtype == torch.bfloat16:
            gp = GPipeLayers(blocks, mesh, PIPE_M)
            t = time.perf_counter()
            pipe_loss(gp(x), y).backward()
            torch.cuda.synchronize()
            log(f"hybrid (b) GPipe bf16: segments run {gp.segments_run} (P·(M+P-1) "
                f"{2 * (PIPE_M + 1)}) against 1F1B's {2 * PIPE_M}; forward and backward "
                f"{(time.perf_counter() - t) * 1e3:.1f} ms")
            if gp.segments_run != 2 * (PIPE_M + 1):
                raise AssertionError(f"GPipe segments {gp.segments_run}")
            del gp
        else:
            eng = OneFOneBLayers(pipe_blocks(torch, cfg, PIPE_LAYERS, dev, dtype), mesh,
                                 PIPE_M, pipe_loss)
            fresh = pipe_blocks(torch, cfg, PIPE_LAYERS, dev, dtype)
            host = PipelineParallel(PipelineLayer(fresh, num_stages=2, loss_fn=pipe_loss),
                                    accumulate_steps=PIPE_M)
            eopt = AdamW(1e-4, parameters=list(eng.parameters()))
            hopt = AdamW(1e-4, parameters=[p for b in fresh for p in b.parameters()])
            got = [float(eng.train_batch((x, y), eopt)) for _ in range(2)]
            want = [float(host.train_batch((x, y), hopt)) for _ in range(2)]
            rel = max(abs(a - b) / abs(b) for a, b in zip(got, want))
            log(f"hybrid (b) PipelineParallel.train_batch f32 losses "
                f"{' '.join(f'{v:.6f}' for v in want)}, OneFOneBLayers.train_batch "
                f"{' '.join(f'{v:.6f}' for v in got)} (relative {rel:.3g})")
            if rel > tol32:
                raise AssertionError(f"PipelineParallel against 1F1B: {rel}")
            del eng, host, fresh, eopt, hopt
        del blocks, want_grads
        gc.collect()
        torch.cuda.empty_cache()


def ring_close(torch, label, got, want, abs_terms, dtype):
    """The ring against the fused form.  f32: within the reference's rtol
    and atol 1e-5 plus 8 f32 epsilons of the sum of the terms' absolute
    values (the sums run in another order).  bf16: within LOGITS_REL_TOL
    relative L2; the reference's elementwise 5e-2 fits its unit-scale
    [16, 12] operands, and a 7B-width dW (8192 rows a sum) rounds each of
    the ring's p partial sums to bf16, an absolute error near 2^-9 of its
    scale.  Returns the f32 max |diff| or the bf16 relative L2."""
    if dtype == torch.float32:
        bound = 1e-5 + 1e-5 * want.abs() + 8 * F32_EPS * abs_terms
        err = (got - want).abs()
        if not bool((err <= bound).all()):
            raise AssertionError(f"{label}: max |diff| {float(err.max()):.3g}")
        return float(err.max())
    rel = rel_l2(got, want)
    if not rel <= LOGITS_REL_TOL:
        raise AssertionError(f"{label}: relative L2 {rel:.3g} > {LOGITS_REL_TOL}")
    return rel


def hybrid_ring(torch, card, dev, rows, hidden, inter):
    """(c) the collective-matmul ring at model degree 2 and 4, every member
    on ``dev``: all_gather_matmul on [rows, hidden] x [hidden, inter] and
    matmul_reduce_scatter on [rows, inter] x [inter, hidden], forward and
    both grads against the fused form (each member's product, joined or
    summed as the TP layers' fused form does), f32 and bf16; then the times
    of one column and one row layer's forward and backward, ring and fused,
    in bf16."""
    from paddle_tpu_torch.distributed import overlap
    from paddle_tpu_torch.distributed.meta_parallel.mp_layers import member_sum

    g = torch.Generator(device=dev).manual_seed(41)
    for p in RING_DEGREES:
        mesh = tp_mesh(torch, dev, mp=p)
        forms = {
            "column": (lambda x, w: overlap.all_gather_matmul(x, w, mesh),
                       lambda x, w: torch.cat([x @ wj for wj in w.chunk(p, 1)], -1),
                       (rows, hidden), (hidden, inter)),
            "row": (lambda x, w: overlap.matmul_reduce_scatter(x, w, mesh),
                    lambda x, w: member_sum([xj @ wj for xj, wj in
                                             zip(x.chunk(p, -1), w.chunk(p, 0))], x.device),
                    (rows, inter), (inter, hidden))}
        for form, (ring, fused, xs, ws) in forms.items():
            x32 = torch.randn(*xs, generator=g, device=dev)
            w32 = torch.randn(*ws, generator=g, device=dev) / math.sqrt(xs[1])
            dy32 = torch.randn(xs[0], ws[1], generator=g, device=dev)
            errs, times = {}, {}
            for dtype in (torch.float32, torch.bfloat16):
                x, w, dy = (t.to(dtype) for t in (x32, w32, dy32))

                def run(fn):
                    xx, ww = x.detach().requires_grad_(), w.detach().requires_grad_()
                    out = fn(xx, ww)
                    out.backward(dy)
                    return out.detach(), xx.grad, ww.grad

                got, want = run(ring), run(fused)
                ax, aw, ady = x.float().abs(), w.float().abs(), dy.float().abs()
                terms = (ax @ aw, ady @ aw.T, ax.T @ ady)
                errs[str(dtype)[6:]] = [ring_close(torch, f"ring mp {p} {form} {n}", a, b, t,
                                                   dtype)
                                        for n, a, b, t in zip(("out", "dx", "dw"), got, want,
                                                              terms)]
                del got, want, terms, ax, aw, ady
                if dtype == torch.bfloat16:
                    for name, fn in (("ring", ring), ("fused", fused)):
                        times[name] = time_ms(torch, lambda: run(fn), iters=5, repeats=3)
            log(f"hybrid (c) ring mp {p} {form} [{xs[0]}, {xs[1]}] x [{ws[0]}, {ws[1]}] on "
                f"{card}: (out, dx, dw) f32 max |ring - fused| "
                f"{', '.join(f'{e:.3g}' for e in errs['float32'])}, bf16 relative L2 "
                f"{', '.join(f'{e:.3g}' for e in errs['bfloat16'])}; forward + backward bf16 "
                f"ring {times['ring']:.3f} ms, fused {times['fused']:.3f} ms "
                f"({times['ring'] / times['fused']:.2f}x)")
            del x32, w32, dy32
        torch.cuda.empty_cache()


def phase_hybrid(torch, card, train=None, cfg=None, dev="cuda", batch=None):
    """The schedules (ROADMAP A6c) on the card, every member on ``dev``:
    (a) fleet's hybrid step at Llama-2-7B width (``hybrid_gate_shallow``,
    ``hybrid_steps``), (b) the pipeline engines (``hybrid_pipeline``), (c)
    the collective-matmul ring (``hybrid_ring``).  ``train``: phase_train's
    (launches, losses, ms), run here (the flags-on steps) when not given;
    ``batch``: (ids, labels), by default phase_train's.  Returns (a)'s
    counted launches."""
    import dataclasses

    from paddle_tpu_torch.distributed import topology
    from paddle_tpu_torch.models import llama2_7b

    t0 = time.perf_counter()
    cfg = cfg or llama2_7b(num_hidden_layers=TRAIN_LAYERS)
    ids, labels = batch or train_batch(torch, cfg.vocab_size)
    if train is None:
        train = train_steps(torch, card, make_llama, cfg.num_hidden_layers, LLAMA_ON, ids,
                            labels)
    try:
        gc.collect()
        torch.cuda.empty_cache()
        hybrid_gate_shallow(torch, dataclasses.replace(cfg, num_hidden_layers=2), dev,
                            ids[:2], labels[:2])
        gc.collect()
        torch.cuda.empty_cache()
        weights = host_weights(torch, cfg.num_hidden_layers)
        launches = hybrid_steps(torch, card, cfg, weights, dev, ids, labels, train[1])
        del weights
    finally:
        topology.set_hybrid_communicate_group(None)
    gc.collect()
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    hybrid_pipeline(torch, card, cfg, dev, ids.shape[1])
    t2 = time.perf_counter()
    hybrid_ring(torch, card, dev, ids.shape[0] * ids.shape[1], cfg.hidden_size,
                cfg.intermediate_size)
    log(f"hybrid phase: {time.perf_counter() - t0:.1f} s ((a) {t1 - t0:.1f}, (b) "
        f"{t2 - t1:.1f}, (c) {time.perf_counter() - t2:.1f})")
    return launches


OFFLOAD_STEPS = 3                   # (a), (b): steps a run; the last one profiled
OFFLOAD_HYBRID_LAYERS = 2           # (a): the hybrid stages' depth (time: PERF.md §4)
FULL_LAYERS = 32                    # (b): Llama-2-7B at full depth
FULL_ROWS = 4                       # (b): 2048-token rows a step (PERF.md §4)
LINK_BYTES = 1 << 30                # the host link's yardstick copies
ONE_CARD = dict(dp_degree=1, mp_degree=1, pp_degree=1, sharding_degree=1)


def host_memory() -> dict:
    """The host's MemTotal and MemAvailable, GiB."""
    got = {}
    with open("/proc/meminfo") as f:
        for line in f:
            key, val = line.split(":", 1)
            if key in ("MemTotal", "MemAvailable"):
                got[key] = int(val.split()[0]) / 2**20
    return got


def available_gib() -> float:
    return host_memory()["MemAvailable"]


def meminfo() -> str:
    return " ".join(f"{k} {v:.2f} GiB" for k, v in host_memory().items())


def host_link(torch, nbytes=LINK_BYTES):
    """The host link from pinned host memory (a ``HostArena``, as the
    offloaded states use): GB/s to the card, to the host, and each way with
    both copies at once on two streams (best of three)."""
    from paddle_tpu_torch.device import HostArena

    arena = HostArena(2 * nbytes, pin=True)
    h_in, h_out = (arena.take((nbytes,), torch.uint8) for _ in range(2))
    d_in, d_out = (torch.empty(nbytes, dtype=torch.uint8, device="cuda") for _ in range(2))
    streams = (torch.cuda.Stream(), torch.cuda.Stream())

    def best_s(pairs):
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t = time.perf_counter()
            for st, (dst, src) in zip(streams, pairs):
                with torch.cuda.stream(st):
                    dst.copy_(src, non_blocking=True)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t)
        return min(times)

    rates = {k: nbytes / best_s(pairs) / 1e9 for k, pairs in (
        ("to card", [(d_in, h_in)]), ("to host", [(h_out, d_out)]),
        ("both", [(d_in, h_in), (h_out, d_out)]))}
    del h_in, h_out, d_in, d_out
    arena.release()
    log(f"offload link: pinned host memory, {nbytes / 2**30:.0f} GiB copies: to the card "
        f"{rates['to card']:.2f} GB/s, to the host {rates['to host']:.2f} GB/s, both at "
        f"once {rates['both']:.2f} GB/s each way")
    return rates


def offload_b5_host(torch, link):
    """B5's host route at the 8-layer step's 75 tensors: f32 p, m and v in
    a pinned ``HostArena``, g on the card, the parameter's bf16 copy written
    on the card (``out``); each tensor bit-equal to B5 on the same states in
    device memory and within the f32 row of the plain twin; pageable host
    states and a CPU gradient with card states refused.  Timed as a sweep
    (ms and device ms) beside the plain version across the link (the
    states copied to the card, ``adamw_plain``, copied back) and the bound:
    12 bytes a parameter each way over the link at ``link``'s rate with
    both directions busy.  Returns the ``kernels`` row."""
    from paddle_tpu_torch.device import HostArena
    from paddle_tpu_torch.ops.fused_ln_swiglu import adamw_plain, adamw_scalars, fused_adamw

    f32, bf16 = torch.float32, torch.bfloat16
    shapes = [tuple(p.shape) for p in make_llama(TRAIN_LAYERS).parameters()]
    gc.collect()
    torch.cuda.empty_cache()
    n = sum(math.prod(sh) for sh in shapes)
    gen = torch.Generator(device="cuda").manual_seed(3)
    arena = HostArena(3 * HostArena.span(shapes, f32), pin=True)
    args = (7, 0.9, 0.999, 1e-8, 0.1)
    sc = adamw_scalars(1e-3, 7, 0.9, 0.999)
    rows, err = [], 0.0
    for sh in shapes:
        p = torch.randn(sh, generator=gen, device="cuda")
        g = 0.1 * torch.randn(sh, generator=gen, device="cuda")
        m = 0.01 * torch.randn(sh, generator=gen, device="cuda")
        v = (0.01 * torch.randn(sh, generator=gen, device="cuda")).abs()
        hp, hm, hv = (arena.take(sh, f32).copy_(t) for t in (p, m, v))
        out = torch.empty(sh, dtype=bf16, device="cuda")
        want = adamw_plain(p, g, m, v, sc[0], sc[1], sc[2], 0.9, 0.999, 1e-8, 0.1, True)
        fused_adamw(p, g, m, v, 1e-3, *args, True)
        fused_adamw(hp, g, hm, hv, 1e-3, *args, True, out=out)
        for name, h, d in (("p", hp, p), ("m", hm, m), ("v", hv, v)):
            if not torch.equal(h.to("cuda"), d):
                raise AssertionError(f"adamw host route {sh} {name}: not bit-equal to B5 on "
                                     f"device states")
        if not torch.equal(out, p.to(bf16)):
            raise AssertionError(f"adamw host route {sh}: out is not the new p in bf16")
        err = max(err, *(check_close(torch, f"adamw host {nm}", h.to("cuda"), w, TOL["float32"])
                         for nm, h, w in zip("pmv", (hp, hm, hv), want)))
        del want, p, m, v
        rows.append((hp, g, hm, hv, out))
    small = torch.randn(4096, device="cuda")
    for bad, what in (((small.cpu(), small, small.cpu(), small.cpu()), "pageable"),
                      ((small, small.cpu(), small, small), "CPU gradient")):
        try:
            fused_adamw(*bad, 1e-3, *args, True)
        except ValueError:
            continue
        raise AssertionError(f"adamw: a {what} call was not refused")

    def sweep():
        for hp, g, hm, hv, out in rows:
            fused_adamw(hp, g, hm, hv, 1e-3, *args, True, out=out)

    def plain_sweep():
        for hp, g, hm, hv, out in rows:
            dp, dm, dv = (t.to("cuda", non_blocking=True) for t in (hp, hm, hv))
            new = adamw_plain(dp, g, dm, dv, sc[0], sc[1], sc[2], 0.9, 0.999, 1e-8, 0.1, True)
            for dst, src in zip((hp, hm, hv, out), (*new, new[0])):
                dst.copy_(src, non_blocking=True)

    ms = time_ms(torch, sweep, iters=1, repeats=2, warmup=1)
    # one profiled sweep has reported half of its event-timed device time:
    # two are profiled, after a warm-up one
    dev_ms, by = device_ms(torch, sweep, iters=2, warmup=1)
    plain_ms = time_ms(torch, plain_sweep, iters=1, repeats=1, warmup=1)
    link_ms = 12 * n / (link["both"] * 1e9) * 1e3
    hbm_ms, _ = bound_ms(6 * n, 16 * n, F32_FLOPS)     # g read, out written on the card
    log(f"offload B5 host route: {len(shapes)} tensors, {n / 1e9:.3f} B f32 parameters, "
        f"bit-equal to B5 on device states, max_abs_err to the plain twin {err:.3g}; sweep "
        f"{ms:.2f} ms, device {dev_ms:.2f} ms ({split_line(by)}), plain across the link "
        f"{plain_ms:.2f} ms; bound {link_ms:.2f} ms (12 B a parameter each way at "
        f"{link['both']:.2f} GB/s; the card's own bytes {hbm_ms:.3f} ms): "
        f"{link_ms / dev_ms:.3f} of the bound by device time")
    del rows
    arena.release()
    return dict(max_abs_err=err, ms=ms, device_ms=dev_ms, plain_ms=plain_ms,
                bound_ms=max(link_ms, hbm_ms), bound_by="bytes", library_ms=None)


def b5_device_ms(torch, fn):
    """Device ms of B5's kernels over one call of ``fn`` (torch.profiler)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total / 1e3 for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and "adamw_kernel" in e.key)


def offload_run(torch, label, build, ids, labels, steps=OFFLOAD_STEPS, keep=True):
    """``steps`` DistributedTrainSteps of ``build()``'s (model, opt, step)
    under LLAMA_ON, the last one profiled for B5's device time.  Returns
    (losses, ms of the timed steps after the first, peak bytes, launches,
    B5 device ms of the profiled step, the final parameters on the host
    when ``keep``, (pinned bytes, pin seconds))."""
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.ops import LAUNCHES, reset_launch_counts

    gc.collect()
    torch.cuda.empty_cache()
    model, opt, step = build()
    arena = opt._host_arena
    pinned = (arena.nbytes, arena.pin_s) if arena is not None else (0, 0.0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    losses, ms = [], []
    with ptt.flag_guard(**LLAMA_ON):
        for _ in range(steps - 1):
            t = time.perf_counter()
            losses.append(float(step(ids, labels)))
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t) * 1e3)
        b5 = b5_device_ms(torch, lambda: losses.append(float(step(ids, labels))))
    launches = {k: c for k, c in LAUNCHES.items() if c}
    peak = torch.cuda.max_memory_allocated()
    final = [p.detach().to("cpu", copy=True) for p in model.parameters()] if keep else None
    del model, opt, step, arena
    gc.collect()
    torch.cuda.empty_cache()
    log(f"offload {label}: losses {' '.join(f'{x:.4f}' for x in losses)}; step ms "
        f"{' '.join(f'{x:.1f}' for x in ms)}; B5 device {b5:.2f} ms a step; peak "
        f"{peak / 2**30:.2f} GiB; pinned {pinned[0] / 2**30:.2f} GiB in {pinned[1]:.2f} s; "
        f"launches in {steps} steps {launches}")
    if not all(map(math.isfinite, losses)):
        raise AssertionError(f"offload {label}: losses {losses}")
    return losses, ms[1:], peak, launches, b5, final, pinned


def offload_same(torch, label, got, want):
    """(a)'s gate: losses, launches and final parameters bit-equal."""
    if got[0] != want[0] or got[3] != want[3]:
        raise AssertionError(f"offload {label}: losses {got[0]} / {want[0]}, launches "
                             f"{got[3]} / {want[3]}")
    for i, (a, b) in enumerate(zip(got[5], want[5])):
        if not torch.equal(a, b):
            raise AssertionError(f"offload {label}: parameter {i} not bit-equal")


def offload_fleet(torch, cfg, offload, ids, labels, keep=True, dev="cuda"):
    """Fleet on the one card (every degree 1) with amp O2 and sharding
    stage 1 (+ offload): phase_train's model and optimizer."""
    import paddle_tpu_torch.distributed as dist
    from paddle_tpu_torch.models import LlamaForCausalLM
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    from paddle_tpu_torch.optimizer import AdamW

    def build():
        hcg = hybrid_fleet(dev, 1, ONE_CARD, offload)
        model = dist.fleet.distributed_model(LlamaForCausalLM(cfg, device=dev, seed=0))
        opt = dist.fleet.distributed_optimizer(AdamW(
            1e-4, parameters=model.parameters(), grad_clip=ClipGradByGlobalNorm(1.0)))
        step = dist.DistributedTrainStep(model, lambda m, x, y: m(x, labels=y)[0], opt, hcg)
        if step.offload != offload or step.sharding_stage != 1:
            raise AssertionError(f"offload fleet: offload {step.offload}, asked {offload}")
        return model, opt, step

    L = cfg.num_hidden_layers
    return offload_run(torch, f"fleet {L} layers {tuple(ids.shape)} offload {offload}", build,
                       ids, labels, keep=keep)


def median(xs):
    return sorted(xs)[len(xs) // 2]


def offload_compare(torch, card, train=None, cfg=None, dev="cuda", batch=None):
    """(a): at 8 layers on phase_train's batch, fleet on the one card with
    offload against resident states, then DistributedTrainStep at stages
    1-3 on HYBRID's 8 members (OFFLOAD_HYBRID_LAYERS deep) with offload
    against resident: losses, launches and final parameters bit-equal.
    Returns the offload runs' launches."""
    import dataclasses

    from paddle_tpu_torch.distributed import topology
    from paddle_tpu_torch.models import llama2_7b

    cfg = cfg or llama2_7b(num_hidden_layers=TRAIN_LAYERS)
    ids, labels = batch or train_batch(torch, cfg.vocab_size)
    total = {}
    try:
        res = offload_fleet(torch, cfg, False, ids, labels, dev=dev)
        off = offload_fleet(torch, cfg, True, ids, labels, dev=dev)
        offload_same(torch, "fleet", off, res)
        n_tensors = 2 + 9 * cfg.num_hidden_layers + 1
        if off[3].get("adamw") != n_tensors * OFFLOAD_STEPS:
            raise AssertionError(f"offload fleet: B5 launches {off[3].get('adamw')}, want "
                                 f"{n_tensors} a step")
        log(f"offload (a) fleet {cfg.num_hidden_layers} layers {tuple(ids.shape)} on {card}: "
            f"losses and parameters bit-equal to resident states; step {median(off[1]):.1f} "
            f"ms against {median(res[1]):.1f} resident"
            + (f" and phase_train's {train[2]:.1f}" if train else "")
            + f"; B5 {off[4]:.2f} ms a step against {res[4]:.2f}; peak {off[2] / 2**30:.2f} "
            f"GiB against {res[2] / 2**30:.2f} ({(res[2] - off[2]) / 2**30:.2f} GiB less); "
            f"{off[6][0] / 2**30:.2f} GiB pinned in {off[6][1]:.2f} s")
        for k, v in off[3].items():
            total[k] = total.get(k, 0) + v
        del res, off
        shallow = dataclasses.replace(cfg, num_hidden_layers=OFFLOAD_HYBRID_LAYERS)
        weights = host_weights(torch, shallow.num_hidden_layers)
        for stage in (1, 2, 3):
            runs = [offload_run(torch, f"hybrid stage {stage} offload {o}",
                                lambda o=o: hybrid_step(torch, shallow, weights, dev, stage, o),
                                ids, labels) for o in (False, True)]
            offload_same(torch, f"hybrid stage {stage}", runs[1], runs[0])
            log(f"offload (a) hybrid stage {stage} {HYBRID}, {shallow.num_hidden_layers} layers: "
                f"bit-equal to resident states; "
                f"step {median(runs[1][1]):.1f} ms against {median(runs[0][1]):.1f}; peak "
                f"{runs[1][2] / 2**30:.2f} GiB against {runs[0][2] / 2**30:.2f}")
            for k, v in runs[1][3].items():
                total[k] = total.get(k, 0) + v
            del runs
        del weights
    finally:
        topology.set_hybrid_communicate_group(None)
    return total


def offload_full(torch, card, rows=FULL_ROWS):
    """(b): Llama-2-7B at full depth and width, amp O2, AdamW + clip,
    through fleet on the one card with offload, ``rows`` rows of 2048
    tokens: OFFLOAD_STEPS steps with finite, falling losses and exactly one
    B5 launch a parameter tensor a step (2 + 9·32 + 1 = 291); the host's
    memory before and after, the pinned bytes and seconds, the device
    peak.  Returns the launches."""
    from paddle_tpu_torch.distributed import topology
    from paddle_tpu_torch.models import llama2_7b

    cfg = llama2_7b(num_hidden_layers=FULL_LAYERS)
    ids, labels = train_batch(torch, cfg.vocab_size)
    ids, labels = ids[:rows], labels[:rows]
    gc.collect()
    log(f"offload (b) host memory before: {meminfo()}")
    try:
        losses, ms, peak, launches, b5, _, pinned = offload_fleet(torch, cfg, True, ids, labels,
                                                                  keep=False)
    finally:
        topology.set_hybrid_communicate_group(None)
    n_tensors = 2 + 9 * FULL_LAYERS + 1
    log(f"offload (b) {FULL_LAYERS} layers {rows}x{TRAIN_SEQ} on {card}: losses "
        f"{' '.join(f'{x:.4f}' for x in losses)}; step ms {' '.join(f'{x:.1f}' for x in ms)}; "
        f"B5 {b5:.2f} ms a step; device peak {peak / 2**30:.2f} GiB; {pinned[0] / 2**30:.2f} "
        f"GiB pinned in {pinned[1]:.2f} s; the arena released, host memory {meminfo()}")
    # the unpinned pages come back to the host a few seconds after the release
    t = time.perf_counter()
    while available_gib() < pinned[0] / 2**30 and time.perf_counter() - t < 20:
        time.sleep(1)
    log(f"offload (b) host memory {time.perf_counter() - t:.1f} s later: {meminfo()}")
    if launches.get("adamw") != n_tensors * OFFLOAD_STEPS or not losses[-1] < losses[0]:
        raise AssertionError(f"offload (b): losses {losses}, B5 launches "
                             f"{launches.get('adamw')}, want {n_tensors} a step")
    return launches


def phase_offload(torch, card, train=None):
    """ZeRO offload (ROADMAP A6c2): the host link, B5's host route
    (``offload_b5_host``), (a) offload against resident states at 8
    layers (``offload_compare``), (b) full depth (``offload_full``).
    Returns (the host route's kernels row, the offload path's launches)."""
    t0 = time.perf_counter()
    log(f"offload: host memory {meminfo()}")
    link = host_link(torch)
    row = offload_b5_host(torch, link)
    gc.collect()
    torch.cuda.empty_cache()
    launches = offload_compare(torch, card, train)
    t1 = time.perf_counter()
    for k, v in offload_full(torch, card).items():
        launches[k] = launches.get(k, 0) + v
    log(f"offload phase: {time.perf_counter() - t0:.1f} s ((b) {time.perf_counter() - t1:.1f})")
    return row, launches


AUTO = dict(dp_degree=1, mp_degree=2, pp_degree=1, sharding_degree=2)   # (c): 4 members
AUTO_COLUMN = ("q_proj", "k_proj", "v_proj", "gate_proj", "up_proj")     # Shard(1) on model
AUTO_ROW = ("o_proj", "down_proj")                                       # Shard(0) on model


def auto_partials(torch, pm, dev):
    """The Partial value identities on the card, bit-exact: sum → Replicate
    and → Shard(0) give the value, avg the value over the model degree,
    sum → avg → sum back the value."""
    from paddle_tpu_torch.distributed import auto_parallel as ap

    x = torch.randn(64, 4096, device=dev).to(torch.bfloat16)
    n = len(pm.dim_names)
    at = pm.dim_names.index("model")

    def on_model(p):
        return [p if i == at else ap.Replicate() for i in range(n)]

    rep = [ap.Replicate()] * n
    t = ap.shard_tensor(x, pm, on_model(ap.Partial()))
    avg = ap.shard_tensor(x, pm, on_model(ap.Partial("avg")))
    back = ap.reshard(ap.reshard(t, pm, on_model(ap.Partial("avg"))), pm, on_model(ap.Partial()))
    for label, got, want in (
            ("sum to Replicate", ap.reshard(t, pm, rep), x),
            ("sum to Shard(0)", ap.reshard(t, pm, on_model(ap.Shard(0))), x),
            ("avg to Replicate", ap.reshard(avg, pm, rep), x / pm.get_dim_size("model")),
            ("sum to avg to sum", ap.reshard(back, pm, rep), x)):
        if got.device != x.device or not torch.equal(got, want):
            raise AssertionError(f"auto (c) Partial {label}: not bit-exact on {dev}")


def phase_auto(torch, card, train=None, cfg=None, dev="cuda", batch=None):
    """auto_parallel (ROADMAP A6c2) at Llama-2-7B width, 8 layers: fleet at
    AUTO's degrees with every member on ``dev``, amp O2 and ZeRO stage 1;
    ``shard_layer`` places the projections as mp_layers does (column
    Shard(1), row Shard(0) over ``model``), ``shard_optimizer``, and
    ``Engine(model, loss, AdamW + clip, strategy)``: ``fit`` over
    HYBRID_GATED epochs of phase_train's batch (losses within
    LOGITS_REL_TOL of phase_train's, exact launches, every projection's
    spec in the step), then ``evaluate`` and ``predict``; the Partial
    identities on the card.  Returns fit's launches."""
    import numpy as np

    import paddle_tpu_torch as ptt
    import paddle_tpu_torch.distributed as dist
    import paddle_tpu_torch.nn.functional as F
    from paddle_tpu_torch.distributed import auto_parallel as ap
    from paddle_tpu_torch.distributed import topology
    from paddle_tpu_torch.models import llama2_7b
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    from paddle_tpu_torch.ops import LAUNCHES, reset_launch_counts
    from paddle_tpu_torch.optimizer import AdamW

    t0 = time.perf_counter()
    cfg = cfg or llama2_7b(num_hidden_layers=TRAIN_LAYERS)
    ids, labels = batch or train_batch(torch, cfg.vocab_size)
    if train is None:
        train = train_steps(torch, card, make_llama, cfg.num_hidden_layers, LLAMA_ON, ids,
                            labels)
    gc.collect()
    torch.cuda.empty_cache()
    V, L = cfg.vocab_size, cfg.num_hidden_layers
    try:
        hcg = hybrid_fleet(dev, 1, AUTO)
        strategy = dist.fleet.fleet.strategy
        pm = ap.ProcessMesh(hcg.mesh)
        auto_partials(torch, pm, dev)

        def shard_fn(name, sublayer, mesh):
            leaf = name.rsplit(".", 1)[-1]
            if leaf in AUTO_COLUMN + AUTO_ROW:
                pl = [ap.Shard(1 if leaf in AUTO_COLUMN else 0) if a == "model"
                      else ap.Replicate() for a in mesh.dim_names]
                sublayer._parameters["weight"] = ap.shard_tensor(
                    sublayer._parameters["weight"], mesh, pl)

        model = dist.fleet.distributed_model(make_llama(L) if dev == "cuda" else
                                             make_llama(L).to(dev))
        ap.shard_layer(model, pm, shard_fn)
        opt = ap.shard_optimizer(dist.fleet.distributed_optimizer(AdamW(
            1e-4, parameters=model.parameters(), grad_clip=ClipGradByGlobalNorm(1.0))))
        engine = ap.Engine(model, lambda logits, y: F.cross_entropy(
            logits.reshape(-1, V), y.reshape(-1)), opt, strategy=strategy)
        engine.prepare()
        step = engine._train_step
        placed = [n for n, p, s in zip([n for n, p in model.named_parameters()], step._params,
                                       step._param_shardings)
                  if n.rsplit(".", 2)[-2] in AUTO_COLUMN + AUTO_ROW and "model" in str(s)]
        if len(placed) != len(AUTO_COLUMN + AUTO_ROW) * L:
            raise AssertionError(f"auto (c): {len(placed)} projections keep their layout")
        reset_launch_counts()
        with ptt.flag_guard(**LLAMA_ON):
            t = time.perf_counter()
            hist = engine.fit([(ids, labels)], epochs=HYBRID_GATED, verbose=0)
            torch.cuda.synchronize()
            fit_s = time.perf_counter() - t
            launches = {k: c for k, c in LAUNCHES.items() if c}
            logs = engine.evaluate([(ids, labels)], verbose=0)
            out = engine.predict([(ids, labels)], steps=1)
        losses = hist["loss"]
        want = {k: HYBRID_GATED * v for k, v in hybrid_want(L, len(step._params), AUTO).items()}
        rel = [abs(a - b) / abs(b) for a, b in zip(losses, train[1])]
        log(f"auto (c) Engine {AUTO} on {card}: {len(placed)} projections placed by "
            f"shard_layer; fit losses {' '.join(f'{x:.4f}' for x in losses)} (phase_train's "
            f"{' '.join(f'{x:.4f}' for x in train[1][:HYBRID_GATED])}; relative "
            f"{' '.join(f'{x:.2g}' for x in rel)}); {fit_s / HYBRID_GATED * 1e3:.1f} ms a step; "
            f"evaluate loss {logs['loss']:.4f}; predict {out[0].shape} finite "
            f"{bool(np.isfinite(out[0]).all())}; launches in fit {launches}")
        if max(rel) > LOGITS_REL_TOL or launches != want:
            raise AssertionError(f"auto (c): losses {losses} against {train[1][:3]}; "
                                 f"launches {launches}, want {want}")
        if not (math.isfinite(logs["loss"]) and out[0].shape == (*ids.shape, V)
                and np.isfinite(out[0]).all()):
            raise AssertionError(f"auto (c): evaluate {logs}, predict {out[0].shape}")
        del model, opt, engine, step, out
    finally:
        topology.set_hybrid_communicate_group(None)
    gc.collect()
    torch.cuda.empty_cache()
    log(f"auto phase: {time.perf_counter() - t0:.1f} s")
    return launches


CORE_LAYERS = 2                     # phase_core: Llama-2-7B width, depth cut for time
CORE_STEPS = 3                      # (a): eager steps, against as many TrainSteps
CORE_RMS_SHAPE = (TRAIN_BATCH * TRAIN_SEQ, 4096)   # (b): B1/B1b's training rows
GUMBEL_SAMPLES = 200000             # (d): gumbel_softmax(hard=True) draws
CORE_KERNELS = frozenset({"rms_norm", "rms_norm_bwd", "rope", "rope_bwd", "flash_attention",
                          "flash_attention_bwd_dq", "flash_attention_bwd_dkv", "swiglu",
                          "swiglu_bwd", "adamw"})


def core_build(torch, make, clip):
    """``make(CORE_LAYERS)`` after ``paddle.seed(0)``, with AdamW(1e-4) and
    ``clip``, under AMP O2 bf16."""
    import paddle_tpu_torch as paddle

    paddle.seed(0)
    model = make(CORE_LAYERS)
    opt = paddle.optimizer.AdamW(1e-4, parameters=model.parameters(), grad_clip=clip)
    return paddle.amp.decorate(model, opt, level="O2", dtype="bfloat16")


def core_timed(torch, fn, n):
    """``n`` calls of ``fn`` (each synchronised): their results, their
    launch counts (one dict a call) and the ms of each call."""
    from paddle_tpu_torch.ops import LAUNCHES, reset_launch_counts

    outs, launches, ms = [], [], []
    for _ in range(n):
        reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs.append(fn())
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        launches.append(dict(LAUNCHES))
    return outs, launches, ms


def core_eager(torch, card, make=None, batch=None, dev="cuda"):
    """(a) The reference's eager idiom at Llama-2-7B width (2 layers, AMP
    O2, AdamW, ClipGradByGlobalNorm(1.0), LLAMA_ON): ``paddle.to_tensor``
    batch, then ``loss = model(ids, labels=labels)[0]; loss.backward();
    opt.step(); opt.clear_grad()`` CORE_STEPS times, then a forward under
    ``paddle.no_grad()``; held bit-equal (losses and every kernel's
    launches, step by step) to TrainStep on the same weights and batch.
    Returns the eager run's launches (all its steps and the evaluation)."""
    import numpy as np

    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.ops import LAUNCHES, reset_launch_counts

    make = make or make_llama
    ids, labels = batch or train_batch(torch, 32000)
    ids_np, labels_np = ids[:1].cpu().numpy(), labels[:1].cpu().numpy()
    with paddle.flag_guard(**LLAMA_ON):
        model, opt = core_build(torch, make, paddle.nn.ClipGradByGlobalNorm(1.0))
        step = TrainStep(model, lambda m, x, y: m(x, labels=y)[0], opt)
        x, y = torch.as_tensor(ids_np, device=dev), torch.as_tensor(labels_np, device=dev)
        want, want_launches, want_ms = core_timed(torch, lambda: float(step(x, y)), CORE_STEPS)
        del model, opt, step
        gc.collect()

        model, opt = core_build(torch, make, paddle.nn.ClipGradByGlobalNorm(1.0))
        place = paddle.CUDAPlace(0) if dev == "cuda" else paddle.CPUPlace()
        x = paddle.to_tensor(ids_np, place=place)
        y = paddle.to_tensor(labels_np, place=place)

        def eager_step():
            loss = model(x, labels=y)[0]
            loss.backward()
            opt.step()
            opt.clear_grad()
            return float(loss.detach())

        got, got_launches, got_ms = core_timed(torch, eager_step, CORE_STEPS)
        total = {k: sum(d[k] for d in got_launches) for k in got_launches[0]}
        reset_launch_counts()
        with paddle.no_grad():
            eval_loss = model(x, labels=y)[0]
        eval_launches = dict(LAUNCHES)
        for k, v in eval_launches.items():
            total[k] += v
        del model, opt
        gc.collect()
    log(f"core eager loop {CORE_LAYERS}-layer 1x{TRAIN_SEQ} on {card}: losses "
        f"{' '.join(repr(v) for v in got)}; TrainStep {' '.join(repr(v) for v in want)}; "
        f"eval under no_grad {float(eval_loss)!r}")
    if got != want or got_launches != want_launches:
        raise AssertionError(f"core eager loop: losses {got} launches {got_launches}; "
                             f"TrainStep {want} {want_launches}")
    if not (np.isfinite(float(eval_loss)) and float(eval_loss) < got[0]):
        raise AssertionError(f"core eager loop: evaluation loss {float(eval_loss)} after "
                             f"losses {got}")
    log(f"core eager loop launches a step (= TrainStep's): {got_launches[0]}; evaluation "
        f"forward: {eval_launches}")
    log(f"core eager loop ms a step (steps 2..{CORE_STEPS}, synchronised): eager "
        f"{np.mean(got_ms[1:]):.2f} ({' '.join(f'{v:.2f}' for v in got_ms)}), TrainStep "
        f"{np.mean(want_ms[1:]):.2f} ({' '.join(f'{v:.2f}' for v in want_ms)})")
    return total


def core_clips(torch, make=None, batch=None, dev="cuda"):
    """(a) One eager step with ClipGradByNorm and one with ClipGradByValue:
    finite losses, and the clipped gradients the optimizer received equal
    to the formula on the gradients it passed in."""
    import paddle_tpu_torch as paddle

    make = make or make_llama
    ids, labels = batch or train_batch(torch, 32000)
    x, y = ids[:1].to(dev), labels[:1].to(dev)

    class Recorder:
        def __init__(self, clip):
            self.clip, self.seen = clip, None

        def __call__(self, params_grads):
            out = self.clip(params_grads)
            self.seen = ([g.clone() for _, g in params_grads], [g for _, g in out])
            return out

    norm_bound, value_bound = 0.5, 1e-3
    formulas = {
        "ClipGradByNorm": (paddle.nn.ClipGradByNorm(norm_bound), lambda g: g * torch.clamp(
            norm_bound / torch.clamp(g.float().norm(), min=1e-12), max=1.0)),
        "ClipGradByValue": (paddle.nn.ClipGradByValue(value_bound),
                            lambda g: g.clamp(-value_bound, value_bound))}
    with paddle.flag_guard(**LLAMA_ON):
        for label, (clip, formula) in formulas.items():
            rec = Recorder(clip)
            model, opt = core_build(torch, make, rec)
            loss = model(x, labels=y)[0]
            loss.backward()
            opt.step()
            opt.clear_grad()
            with paddle.no_grad():
                after = model(x, labels=y)[0]
            ins, outs = rec.seen
            err = max(check_close(torch, f"core {label}", o, formula(i), TOL["float32"])
                      for i, o in zip(ins, outs))
            clipped = sum(bool((o != i).any()) for i, o in zip(ins, outs))
            loss, after = float(loss.detach()), float(after)
            log(f"core {label}: loss {loss:.5f} then {after:.5f}; {clipped} of {len(ins)} "
                f"gradients clipped; worst |clip - formula| {err:.3g}")
            if not (math.isfinite(loss) and math.isfinite(after) and clipped):
                raise AssertionError(f"core {label}: losses {loss} {after}, {clipped} clipped")
            del model, opt, rec
            gc.collect()


def core_pylayer(torch, shape=CORE_RMS_SHAPE, dev="cuda"):
    """(b) A PyLayer whose forward is B1 (``fused_rms_norm``) and whose
    backward is B1b, in f32 and bf16 at ``shape``: the output and its
    ``paddle.grad`` grads against torch autograd through
    ``rms_norm_plain``, within the op_test rows (dw, a sum over the rows,
    by ``check_sum_close``)."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.ops.fused_norm import (fused_rms_norm, fused_rms_norm_bwd,
                                                 rms_norm_plain)

    class RMSNorm(paddle.autograd.PyLayer):
        @staticmethod
        def forward(ctx, x, w, eps):
            out, rstd = fused_rms_norm(x, w, eps)
            ctx.save_for_backward(x, w, rstd)
            return out

        @staticmethod
        def backward(ctx, dy):
            x, w, rstd = ctx.saved_tensor()
            return fused_rms_norm_bwd(x, w, rstd, dy.contiguous())

    gen = torch.Generator(device=dev).manual_seed(3)
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.randn(shape, generator=gen, device=dev).to(dtype)
        w = (1 + 0.1 * torch.randn(shape[-1], generator=gen, device=dev)).to(dtype)
        dy = torch.randn(shape, generator=gen, device=dev).to(dtype)
        xk, wk = paddle.to_tensor(x, stop_gradient=False), paddle.to_tensor(w, stop_gradient=False)
        xp, wp = x.clone().requires_grad_(), w.clone().requires_grad_()
        out = RMSNorm.apply(xk, wk, 1e-6)
        dx, dw = paddle.grad(out, [xk, wk], dy)
        want = rms_norm_plain(xp, wp, 1e-6)[0]
        pdx, pdw = torch.autograd.grad(want, (xp, wp), dy)
        if xk.grad is not None or wk.grad is not None:
            raise AssertionError("paddle.grad wrote .grad")
        tol = TOL[str(dtype).split(".")[1]]
        rstd = torch.rsqrt(x.float().square().mean(-1, keepdim=True) + 1e-6)
        terms = (dy.float() * x.float() * rstd).abs().sum(0)
        err = max(check_close(torch, "PyLayer B1 out", out, want, tol),
                  check_close(torch, "PyLayer B1b dx", dx, pdx, tol),
                  check_sum_close(torch, "PyLayer B1b dw", dw, pdw, terms))
        log(f"core PyLayer over B1/B1b {dtype} x{list(shape)}: max_abs_err {err:.3g} against "
            "torch autograd through rms_norm_plain")
        del x, w, dy, xk, wk, xp, wp, out, dx, dw, want, pdx, pdw


def core_higher_order(torch, dev="cuda"):
    """(b) ``paddle.grad(create_graph=True)`` twice (a double backward), and
    ``jacobian``/``hessian``/``vjp``/``jvp`` of small functions, on the card
    against the CPU, within the f32 row."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.autograd import hessian, jacobian, jvp, vjp

    g = torch.Generator().manual_seed(5)
    x0, w0 = torch.randn(6, 5, generator=g), torch.randn(5, 4, generator=g)

    def f(x):
        return (paddle.tanh(paddle.matmul(x, w)) ** 3).sum()

    results = {}
    for where in ("cpu", dev):
        w = w0.to(where)
        x = paddle.to_tensor(x0, place=where, stop_gradient=False)
        (gx,) = paddle.grad(f(x), x, create_graph=True)
        (ggx,) = paddle.grad((gx * gx).sum(), x)
        results[where] = dict(
            grad=gx.detach(), double=ggx,
            jacobian=jacobian(lambda v: paddle.sin(v) * v, x.detach()[0]),
            jacobian_fwd=jacobian(lambda v: paddle.sin(v) * v, x.detach()[0], mode="fwd"),
            jacobian_batched=jacobian(lambda v: v ** 3, x.detach(), batch_axis=0),
            hessian=hessian(lambda v: f(v.reshape(6, 5)), x.detach().reshape(-1)),
            vjp=vjp(lambda v: paddle.exp(v), x.detach(), paddle.ones_like(x.detach()))[1],
            jvp=jvp(lambda v: paddle.exp(v), x.detach(), paddle.ones_like(x.detach()))[1])
    worst = max(check_close(torch, f"core {k}", results[dev][k].cpu(), v, TOL["float32"])
                for k, v in results["cpu"].items())
    log(f"core double backward, jacobian (rev, fwd, batched), hessian [30, 30], vjp, jvp on "
        f"the card against the CPU: max_abs_err {worst:.3g}")


def core_cases(torch):
    """Small cases of the tensor functions (creation, math, manipulation,
    logic and search, linalg, einsum) and the nn.functional names this slice
    adds: (family, label, fn, CPU inputs, whether bf16 is run too)."""
    import paddle_tpu_torch as paddle
    import paddle_tpu_torch.nn.functional as F

    g = torch.Generator().manual_seed(21)

    def r(*shape, lo=-1.0, hi=1.0):
        return lo + (hi - lo) * torch.rand(*shape, generator=g)

    a, b, p = r(4, 8), r(4, 8), r(4, 8, lo=0.3, hi=2.0)
    spd = (lambda m: m @ m.T + 4 * torch.eye(4))(r(4, 4))
    idx = torch.tensor([0, 2, 3])
    mask = torch.arange(32).reshape(4, 8) % 3 == 0
    cat = [
        ("creation", "zeros ones full", lambda: paddle.concat(
            [paddle.zeros([2, 3]), paddle.ones([2, 3]), paddle.full([2, 3], 7.5)]), [], False),
        ("creation", "arange linspace logspace", lambda: paddle.concat(
            [paddle.arange(1, 10, 2, dtype="float32"), paddle.linspace(0, 1, 5),
             paddle.logspace(0, 2, 3)]), [], False),
        ("creation", "eye tril_indices", lambda: (paddle.eye(3, 4), paddle.tril_indices(4, 4)),
         [], False),
        ("creation", "*_like", lambda x: paddle.concat([paddle.zeros_like(x), paddle.ones_like(x),
                                                        paddle.full_like(x, 2.0)]), [a], True),
        ("creation", "diag diagflat diag_embed", lambda v, m: (
            paddle.diag(v, 1, 3.0), paddle.diagflat(v), paddle.diag_embed(m), paddle.diag(m)),
         [r(5), r(3, 3)], True),
        ("creation", "tril triu meshgrid", lambda m, v: (
            paddle.tril(m), paddle.triu(m, 1), *paddle.meshgrid(v, v)), [r(4, 4), r(3)], True),
        ("creation", "to_tensor one_hot complex", lambda v: (
            paddle.to_tensor([[1.0, 2.0]], dtype=v.dtype, place=v.device) * v[:1, :2],
            paddle.one_hot(paddle.to_tensor([0, 3, 1], place=v.device), 4),
            paddle.as_real(paddle.complex(v, v * 2))), [a], False),
        ("math", "unary", lambda x, q: (
            paddle.exp(x), paddle.log(q), paddle.sqrt(q), paddle.rsqrt(q), paddle.tanh(x),
            paddle.erf(x), paddle.erfinv(x * 0.9), paddle.lgamma(q), paddle.digamma(q),
            paddle.logit(x.abs() * 0.8 + 0.1), paddle.stanh(x), paddle.frac(x * 3)), [a, p], True),
        ("math", "binary", lambda x, y, q: (
            x + y, x * y, x / q, paddle.pow(q, y), paddle.mod(q, q.flip(0)), paddle.atan2(x, q),
            paddle.maximum(x, y), paddle.fmin(x, y), paddle.logaddexp(x, y),
            paddle.hypot(x, y), paddle.lerp(x, y, 0.3), paddle.scale(x, 2.0, 1.0),
            paddle.clip(x, -0.5, 0.5), x + 2.0), [a, b, p], True),
        ("math", "reductions", lambda x, q: (
            paddle.sum(x, axis=-1), paddle.mean(x, axis=[0, 1]), paddle.prod(q, axis=-1),
            paddle.max(x, axis=[0, 1]), paddle.amin(x, axis=0), paddle.logsumexp(x, axis=-1),
            paddle.std(x, axis=-1), paddle.var(x, axis=0), paddle.median(x, axis=-1),
            paddle.quantile(x, 0.3, axis=-1), paddle.nansum(x), paddle.count_nonzero(x > 0)),
         [a, p], True),
        ("math", "cumulative trace", lambda x, q: (
            paddle.cumsum(x, axis=-1), paddle.cumprod(q, dim=-1), paddle.cummax(x, axis=-1)[0],
            paddle.cummin(x, axis=0)[1], paddle.trace(x[:, :4]), paddle.diagonal(x)), [a, p],
         True),
        ("math", "products", lambda x, y: (
            paddle.matmul(x, y, transpose_y=True), paddle.bmm(x[None], y.T[None]),
            paddle.dot(x, y), paddle.outer(x[0], y[0]), paddle.kron(x[:2, :2], y[:2, :2]),
            paddle.addmm(x[:, :4], x, y.T), paddle.inner(x, y),
            paddle.einsum("ij,kj->ik", x, y)), [a, b], True),
        ("manipulation", "shape", lambda x: (
            paddle.reshape(x, [8, 4]), paddle.flatten(x[None]), paddle.transpose(x, [1, 0]),
            paddle.squeeze(x[:, None], axis=1), paddle.unsqueeze(x, [0, 2]),
            paddle.moveaxis(x[None], 0, 2), paddle.swapaxes(x[None], 0, 2),
            paddle.reshape_(x.clone(), [2, 16])), [a], True),
        ("manipulation", "join split", lambda x, y: (
            paddle.concat([x, y], axis=1), paddle.stack([x, y], axis=0),
            *paddle.split(x, [3, -1], axis=1), *paddle.chunk(x, 2, axis=0),
            *paddle.unbind(x[:2], axis=0)), [a, b], True),
        ("manipulation", "tile expand flip", lambda x: (
            paddle.tile(x, [2, 1]), paddle.expand(x[:1], [4, 8]), paddle.broadcast_to(x[:1],
                                                                                     [3, 8]),
            paddle.flip(x, axis=1), paddle.rot90(x), paddle.roll(x, 2, axis=1),
            paddle.repeat_interleave(x, 2, axis=1), paddle.pad(x, [1, 2]),
            paddle.pad(x[None], [1, 1, 2, 2], mode="reflect"),
            paddle.crop(x, [2, 3], [1, 2])), [a], True),
        ("manipulation", "gather scatter", lambda x, y, i: (
            paddle.gather(x, i, axis=0), paddle.index_select(x, i, axis=1),
            paddle.take_along_axis(x, paddle.argsort(y, axis=1), axis=1),
            paddle.put_along_axis(x, paddle.argsort(y, axis=1)[:, :2], 0.5, axis=1),
            paddle.scatter(x, i[:2], y[:2]), paddle.scatter_nd_add(x, i[:2, None], y[:2]),
            paddle.gather_nd(x, paddle.stack([i, i], 1)), paddle.index_add(x, i, 0, y[:3]),
            paddle.strided_slice(x, [1], [7], [1], [-2]), paddle.masked_fill(x, x > 0, 0.25)),
         [a, b, idx], True),
        ("logic/search", "compare", lambda x, y: (
            paddle.greater_than(x, y), paddle.less_equal(x, y), paddle.equal(x, x),
            paddle.logical_and(x > 0, y > 0), paddle.logical_not(x > 0), paddle.isfinite(x),
            paddle.isclose(x, y), paddle.allclose(x, x), paddle.equal_all(x, x)), [a, b], True),
        ("logic/search", "sort search", lambda x, y, m: (
            paddle.argmax(x, axis=-1), paddle.argmin(x), paddle.argsort(x, axis=-1),
            paddle.sort(x, axis=-1, descending=True), *paddle.topk(x, 3),
            *paddle.kthvalue(x, 2), paddle.where(m, x, y), paddle.nonzero(m),
            paddle.masked_select(x, m), paddle.index_fill(x, paddle.to_tensor(
                [1, 2], place=x.device), 1, 0.5), paddle.isin(x, x[0]),
            paddle.searchsorted(paddle.sort(x[0]), x), paddle.bucketize(x, paddle.sort(y[0])),
            paddle.masked_scatter(x, m, y)), [a, b, mask], True),
        ("linalg", "decompositions", lambda s, y: (
            paddle.linalg.inv(s), paddle.linalg.solve(s, y[:, :2]), paddle.linalg.det(s),
            paddle.linalg.cholesky(s), paddle.linalg.slogdet(s), paddle.linalg.eigvalsh(s),
            paddle.linalg.svdvals(s), paddle.linalg.matrix_power(s, 3),
            paddle.linalg.pinv(y), paddle.linalg.cholesky_solve(y[:, :2], paddle.linalg.cholesky(s)),
            paddle.linalg.triangular_solve(paddle.triu(s), y[:, :2])), [spd, b[:, :4]], False),
        ("linalg", "norms stats", lambda x: (
            paddle.linalg.norm(x), paddle.linalg.norm(x, p=1, axis=-1),
            paddle.linalg.norm(x, p=float("inf"), axis=[0, 1]), paddle.linalg.vector_norm(x,
                                                                                         axis=0),
            paddle.linalg.matrix_norm(x), paddle.linalg.cov(x), paddle.linalg.corrcoef(x),
            paddle.linalg.multi_dot([x, x.T, x])), [a], False),
        ("functional", "one_hot label_smooth sequence_mask", lambda x: (
            F.one_hot(paddle.to_tensor([0, 3, 5], place=x.device), 6),
            F.label_smooth(F.softmax(x)), F.sequence_mask(paddle.to_tensor([1, 3, 4],
                                                                            place=x.device), 5)),
         [a], True),
        ("functional", "affine_grid grid_sample temporal_shift", lambda t, im, v: (
            F.affine_grid(t, [2, 3, 5, 6]), F.grid_sample(im, F.affine_grid(t, [2, 3, 5, 6])),
            F.grid_sample(im, F.affine_grid(t, [2, 3, 5, 6], False), "nearest", "border",
                          False), F.temporal_shift(v, 2, 0.25)),
         [r(2, 2, 3) * 0.8, r(2, 3, 7, 9), r(4, 8, 3, 3)], False),
        ("functional", "losses", lambda x, y, q: (
            F.square_error_cost(x, y), F.log_loss(q.clamp(0.1, 0.9) * 0.5, (x > 0).to(x.dtype)),
            F.dice_loss(F.softmax(x), paddle.to_tensor([[1], [3], [0], [7]], place=x.device)),
            F.npair_loss(x, y, paddle.to_tensor([0, 1, 0, 2], place=x.device)),
            F.sigmoid_focal_loss(x, (y > 0).to(x.dtype)),
            F.softmax_with_cross_entropy(x, paddle.to_tensor([[1], [3], [0], [7]],
                                                             place=x.device))), [a, b, p], True),
        ("functional", "in-place activations", lambda x: (
            F.relu_(x.clone()), F.elu_(x.clone()), F.leaky_relu_(x.clone()),
            F.hardtanh_(x.clone() * 2), F.thresholded_relu_(x.clone() * 2),
            F.softmax_(x.clone()), F.tanh_(x.clone())), [a], True),
    ]
    return cat


def core_run_case(torch, fn, inputs, dev, dtype):
    import paddle_tpu_torch as paddle

    with paddle.DeviceGuard(dev):
        out = fn(*[t.to(dev, dtype) if t.is_floating_point() else t.to(dev) for t in inputs])
    return [o.detach() for o in (out if isinstance(out, (tuple, list)) else (out,))]


def core_tensor_api(torch, dev="cuda"):
    """(c) Every case of ``core_cases`` on the card against the CPU: f32
    within the f32 row, bf16 (where the reference takes it) against the
    CPU's bf16 within the bf16 row, integer and bool results equal.  One
    log line per family with the worst relative L2 error."""
    worst = {}
    n = 0
    for family, label, fn, inputs, bf16 in core_cases(torch):
        for dtype in (torch.float32, torch.bfloat16) if bf16 else (torch.float32,):
            want = core_run_case(torch, fn, inputs, "cpu", dtype)
            got = core_run_case(torch, fn, inputs, dev, dtype)
            if len(got) != len(want):
                raise AssertionError(f"core {label}: {len(got)} results on {dev}, "
                                     f"{len(want)} on the CPU")
            for i, (gv, wv) in enumerate(zip(got, want)):
                gv = gv.cpu()
                if gv.shape != wv.shape or gv.dtype != wv.dtype:
                    raise AssertionError(f"core {label} [{i}] {dtype}: {gv.dtype} "
                                         f"{tuple(gv.shape)}, CPU {wv.dtype} {tuple(wv.shape)}")
                if not (wv.is_floating_point() or wv.is_complex()):
                    if not torch.equal(gv, wv):
                        raise AssertionError(f"core {label} [{i}] {dtype}: not equal")
                    continue
                check_close(torch, f"core {label} [{i}] {dtype}", gv, wv,
                            TOL[str(dtype).split(".")[1]])
                rel = float((gv.float() - wv.float()).norm() / wv.float().norm().clamp(
                    min=1e-30))
                key = (family, str(dtype).split(".")[1])
                worst[key] = max(worst.get(key, (0.0, ""))[0], rel), label
                n += 1
    for (family, dt), (rel, label) in sorted(worst.items()):
        log(f"core tensor API {family} {dt}: worst relative L2 {rel:.3g} ({label})")
    log(f"core tensor API: {n} results on the card within the op_test rows of the CPU")


def core_generators(torch, dev="cuda"):
    """(d) ``paddle.seed(42)`` twice replays every draw on the card; a
    Generator's ``get_state``/``set_state`` and ``get_rng_state``/
    ``set_rng_state`` replay theirs; ``gumbel_softmax(hard=True)``'s one-hot
    frequencies lie within 4 standard errors of the softmax."""
    import paddle_tpu_torch as paddle
    import paddle_tpu_torch.nn.functional as F

    def draws():
        with paddle.DeviceGuard(dev):
            p = paddle.rand([64])
            return [paddle.rand([1000]), paddle.randn([1000]), paddle.randint(0, 10, [1000]),
                    paddle.randperm(1000), paddle.multinomial(p / p.sum(), 8),
                    paddle.bernoulli(p), paddle.uniform([100], min=-2.0, max=3.0),
                    paddle.normal(0.0, 2.0, [100]), F.gumbel_softmax(p[None], hard=True)]

    def same(label, x, y):
        if not all(torch.equal(u, v) for u, v in zip(x, y)):
            raise AssertionError(f"core generators: {label} does not replay")

    paddle.seed(42)
    first = draws()
    paddle.seed(42)
    same("paddle.seed(42)", first, draws())
    gen = paddle.Generator(7)
    state = gen.get_state()
    a = torch.rand(100, generator=gen.generator(dev), device=dev)
    gen.set_state(state)
    same("Generator.set_state", [a], [torch.rand(100, generator=gen.generator(dev), device=dev)])
    state = paddle.get_rng_state()
    x = draws()
    paddle.set_rng_state(state)
    same("set_rng_state", x, draws())
    with paddle.framework.key_scope(11):
        k1 = draws()
    with paddle.framework.key_scope(11):
        same("key_scope(11)", k1, draws())
    logits = torch.linspace(-1.0, 1.5, 8, device=dev)
    probs = torch.softmax(logits, 0)
    with paddle.DeviceGuard(dev):
        hard = F.gumbel_softmax(logits.expand(GUMBEL_SAMPLES, 8), hard=True)
    freq = (hard > 0.5).float().mean(0)
    se = torch.sqrt(probs * (1 - probs) / GUMBEL_SAMPLES)
    z = float(((freq - probs).abs() / se).max())
    log(f"core generators on the card: paddle.seed, Generator and rng states and key_scope "
        f"replay their draws; gumbel_softmax(hard=True) over {GUMBEL_SAMPLES} draws: worst "
        f"|frequency - softmax| {z:.2f} standard errors (at most 4)")
    if not (z <= 4.0 and bool(((hard > 0.5).sum(-1) == 1).all())):
        raise AssertionError(f"core generators: gumbel_softmax frequencies {freq} vs {probs}")


def phase_core(torch, card):
    """The core's remainder on the card (ROADMAP A3c): (a) the reference's
    eager training idiom at Llama-2-7B width against TrainStep, and one step
    with each per-tensor clip; (b) a PyLayer over B1/B1b, a double backward
    and jacobian/hessian; (c) the tensor API against the CPU; (d) the
    generators.  Returns (a)'s launches (the ``core`` path)."""
    t0 = time.perf_counter()
    launches = core_eager(torch, card)
    torch.cuda.empty_cache()
    core_clips(torch)
    torch.cuda.empty_cache()
    core_pylayer(torch)
    core_higher_order(torch)
    core_tensor_api(torch)
    core_generators(torch)
    torch.cuda.empty_cache()
    log(f"phase_core: {time.perf_counter() - t0:.1f} s")
    return launches


MOE_SERVE_LAYERS = 16      # phase_moe (b): 23.48 B parameters, 46.96 GB in bf16 (32 need 93.4)
MOE_TRAIN_LAYERS = 2       # (c): 3.17 B parameters under O2 AdamW (about 51 GB of states)
MOE_LAYER_TOKENS = 512     # (a): the layer's tokens
MOE_NEAR_TIE = 1e-5        # a routing may part where the k-th and (k+1)-th probabilities are closer
MOE_F32_REL = 1e-4         # (a), (c): f32 card against the CPU, relative L2
MOE_TRAIN_GATE = (1, 2, 128)   # (c): the f32 gate's layers, rows and tokens a row
MOE_PEAK_GIB = 75.0        # (c): a peak above it halves the batch
MOE_DEPTH_REL = 0.1        # (b): two bf16 paths' logits at 16 layers (PR 1-15: 0.05 apart at 32)
MOE_KERNELS = frozenset({"rms_norm", "rms_norm_bwd", "rope", "rope_bwd", "flash_attention",
                         "flash_attention_bwd_dq", "flash_attention_bwd_dkv", "adamw",
                         "decode_attention"})
MOE_PARTS = ("_router_logits", "_route", "_dispatch", "_combine")


def make_mixtral(layers: int, seed: int = 0):
    from paddle_tpu_torch.models import LlamaForCausalLM, mixtral_8x7b

    return LlamaForCausalLM(mixtral_8x7b(num_hidden_layers=layers), device="cuda", seed=seed)


@contextlib.contextmanager
def moe_routings(torch, tag=None):
    """Every routing of the port's MoE layers inside, recorded on the host
    into the yielded list, in call order: (a copy of ``tag``, the caller's
    context at that call; the router logits in f32; the Routing)."""
    from paddle_tpu_torch.incubate.distributed.models import moe

    seen, real = [], moe._route

    def spy(logits, k, capacity, *a):
        r = real(logits, k, capacity, *a)
        seen.append((dict(tag or {}), logits.detach().float().cpu(), moe.Routing(*(
            t.detach().cpu() if isinstance(t, torch.Tensor) else t for t in r))))
        return r

    moe._route = spy
    try:
        yield seen
    finally:
        moe._route = real


def dropped(r):
    """A Routing's dropped assignments and the tokens that lost one."""
    return int((~r.keep).sum()), (~r.keep).any(0).nonzero().flatten().tolist()


def moe_gap(torch, logits, k):
    """Each token's smallest gap between neighbours among its k + 1 largest
    router probabilities: under it, rounding may swap two choices (their
    order too, which sets the priority round) or a choice and the next."""
    top = torch.softmax(logits.float(), dim=-1).sort(dim=-1, descending=True).values
    return (top[:, :k] - top[:, 1:k + 1]).min(dim=-1).values


def moe_route_diff(torch, label, a, b):
    """Two routings of the same tokens ((logits, Routing) pairs): every
    token whose experts differ must be a near-tie (gap under MOE_NEAR_TIE
    on both sides); returns the tokens whose expert, slot or keep differ
    (the parting tokens and those their claims moved), logged."""
    (la, ra), (lb, rb) = a, b
    k = ra.expert.shape[0]
    moved = (ra.expert != rb.expert).any(0)
    gaps = torch.minimum(moe_gap(torch, la, k), moe_gap(torch, lb, k))
    if bool((gaps[moved] >= MOE_NEAR_TIE).any()):
        raise AssertionError(f"{label}: tokens {moved.nonzero().flatten().tolist()} route "
                             f"differently at probability gaps {gaps[moved].tolist()}")
    differ = moved | (ra.slot != rb.slot).any(0) | (ra.keep != rb.keep).any(0)
    log(f"moe {label}: {int(moved.sum())} of {moved.numel()} tokens route to other experts "
        f"(certified near-ties, gaps {[f'{g:.2e}' for g in gaps[moved].tolist()]}); "
        f"{int(differ.sum())} tokens' slots differ; {int((~ra.keep).sum())} / "
        f"{int((~rb.keep).sum())} assignments dropped")
    return differ


@contextlib.contextmanager
def moe_ranges(torch):
    """The MoE layer's parts (router, routing, dispatch, experts, combine),
    each inside a ``torch.profiler`` range ``moe.<part>``."""
    from paddle_tpu_torch.incubate.distributed.models import moe

    saved = {n: getattr(moe, n) for n in MOE_PARTS}
    experts = moe.ExpertParallelMLP._experts

    def ranged(name, fn):
        def inner(*a, **kw):
            with torch.profiler.record_function(f"moe.{name.strip('_')}"):
                return fn(*a, **kw)
        return inner

    for n, f in saved.items():
        setattr(moe, n, ranged(n, f))
    moe.ExpertParallelMLP._experts = ranged("experts", experts)
    try:
        yield
    finally:
        for n, f in saved.items():
            setattr(moe, n, f)
        moe.ExpertParallelMLP._experts = experts


def moe_profile(torch, label, fn, n=3):
    """Over ``n`` warm calls of ``fn``, from ``torch.profiler``'s events:
    the device's busy time (the union of the kernels' intervals: cuBLAS's
    kernels on this card may overlap their neighbours, so their durations
    summed exceed the wall) and idle share, the kernels' time by MoE part
    (the kernels launched inside each range; the ranges' own device-side
    spans are left out, as they count the gaps between kernels), the
    attention kernels (B3, B6), the rest, and the top kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with moe_ranges(torch), profile(activities=[ProfilerActivity.CPU,
                                                ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3 / n
    events = prof.events()
    kernels = [e for e in events if e.device_type == DeviceType.CUDA
               and not e.name.startswith("moe.")]
    if not kernels:
        raise AssertionError("torch.profiler recorded no device time")
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    busy, end = 0.0, -math.inf
    for a, b in spans:
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
    busy /= 1e3 * n
    summed = sum(e.device_time_total for e in kernels) / 1e3 / n
    parts = {}
    for e in events:
        if e.device_type == DeviceType.CPU and e.name.startswith("moe."):
            parts[e.name[4:]] = parts.get(e.name[4:], 0.0) + e.device_time_total / 1e3 / n
    attn = sum(e.device_time_total for e in kernels
               if "attention" in e.name.lower() or "flash" in e.name.lower()) / 1e3 / n
    top = {}
    for e in kernels:
        top[e.name] = top.get(e.name, 0.0) + e.device_time_total / 1e3 / n
    log(f"profile moe {label}: wall {wall:.2f} ms (profiled), device busy {busy:.2f} ms "
        f"(kernels summed {summed:.2f}), idle share {1 - busy / wall:.3f}; kernel ms by part: "
        + "; ".join(f"{k} {v:.3f}" for k, v in parts.items())
        + f"; attention {attn:.3f}; the rest {summed - sum(parts.values()) - attn:.3f}; "
        f"launches a call {len(kernels) / n:.0f}; top: "
        + "; ".join(f"{k[:40]} {v:.3f}" for k, v in sorted(top.items(), key=lambda kv: -kv[1])[:5]))
    return parts


def moe_layer(torch, card, dev="cuda"):
    """(a) ``ExpertParallelMLP`` at Mixtral's widths on 512 tokens: f32 on
    the card against the CPU (the routing equal but for certified
    near-ties; the other tokens' outputs within MOE_F32_REL), bf16 within
    LOGITS_REL_TOL of the card's f32 over the tokens routed alike, the
    experts split over a 2-member mesh on cuda:0 bit-equal to one block;
    ms a call and device time by part."""
    from paddle_tpu_torch.distributed import topology
    from paddle_tpu_torch.incubate.distributed.models import moe
    from paddle_tpu_torch.models import mixtral_8x7b

    cfg = mixtral_8x7b()
    d, h, E, k = cfg.hidden_size, cfg.intermediate_size, cfg.moe_num_experts, cfg.moe_top_k
    gen = torch.Generator(device=dev).manual_seed(7)
    layer = moe.ExpertParallelMLP(d, h, E, top_k=k, capacity_factor=cfg.moe_capacity_factor,
                                  device=dev, generator=gen)
    x = torch.randn(MOE_LAYER_TOKENS, d, device=dev, generator=gen)
    cpu = copy.deepcopy(layer).to("cpu")
    cap = moe._capacity(MOE_LAYER_TOKENS, E, k, cfg.moe_capacity_factor)

    def route(m, t):
        lg = moe._router_logits(t, m.gate_weight)
        r = moe._route(lg, k, cap)
        return lg.cpu(), moe.Routing(*(v.cpu() if isinstance(v, torch.Tensor) else v
                                       for v in r))

    with torch.no_grad():
        out, r_card = layer(x), route(layer, x)
        t = time.perf_counter()
        out_cpu, r_cpu = cpu(x.cpu()), route(cpu, x.cpu())
        cpu_s = time.perf_counter() - t
        differ = moe_route_diff(torch, "(a) f32 card vs CPU", r_card, r_cpu)
        same = ~differ
        rel = rel_l2(out.cpu()[same], out_cpu[same])
        log(f"moe (a) layer d {d}, h {h}, E {E}, top-{k}, {MOE_LAYER_TOKENS} tokens, capacity "
            f"{cap}: f32 card vs CPU relative L2 {rel:.3g} over {int(same.sum())} tokens "
            f"(bound {MOE_F32_REL}; the CPU's call {cpu_s:.1f} s)")
        if not rel <= MOE_F32_REL:
            raise AssertionError(f"moe (a): f32 card against the CPU {rel} > {MOE_F32_REL}")
        del cpu, out_cpu
        lb = copy.deepcopy(layer).bfloat16()
        xb = x.bfloat16()
        out_b, r_b = lb(xb), route(lb, xb)
        moved = (r_b[1].expert != r_card[1].expert).any(0) | \
            (r_b[1].keep != r_card[1].keep).any(0)
        rel_b = rel_l2(out_b.float().cpu()[~moved], out.cpu()[~moved])
        log(f"moe (a) bf16 vs the card's f32: relative L2 {rel_b:.4g} over {int((~moved).sum())} "
            f"tokens routed alike ({int(moved.sum())} route otherwise in bf16: gaps "
            f"{[f'{g:.2e}' for g in moe_gap(torch, r_card[0], k)[moved].tolist()][:8]})")
        if not rel_b <= LOGITS_REL_TOL:
            raise AssertionError(f"moe (a): bf16 {rel_b} from f32 > {LOGITS_REL_TOL}")
        ms32 = time_ms(torch, lambda: layer(x), iters=3, repeats=3, warmup=1)
        ms16 = time_ms(torch, lambda: lb(xb), iters=3, repeats=3, warmup=1)
        log(f"moe (a) layer on {card}: f32 {ms32:.3f} ms, bf16 {ms16:.3f} ms a call")
        moe_profile(torch, f"(a) bf16 layer, {MOE_LAYER_TOKENS} tokens", lambda: lb(xb))
        del lb, out_b
        mesh = topology.build_mesh(dp=2, devices=[torch.device(dev, 0)] * 2)
        topology.set_hybrid_communicate_group(topology.HybridCommunicateGroup(mesh=mesh))
        layer.expert_axes = ("data",)
        try:
            if layer._expert_mesh() is not mesh:
                raise AssertionError("moe (a): the experts do not split over the mesh")
            split = layer(x)
        finally:
            topology.set_hybrid_communicate_group(None)
        if not torch.equal(split, out):
            raise AssertionError("moe (a): the 2-member expert split is not bit-equal "
                                 "to one block")
        log("moe (a) experts split over a 2-member mesh on cuda:0: bit-equal to one block")


def moe_record(torch, model, fn):
    """``fn()`` with the last position's f32 logits of every forward of
    ``model`` and the ids of every ``generate`` call kept on the host:
    returns (result, [logits [b, V] per forward], [ids per generate])."""
    import numpy as np

    logits, rows = [], []
    fwd, gen = model.forward, model.generate

    def spy_fwd(*a, **k):
        out = fwd(*a, **k)
        logits.append((out[0] if isinstance(out, tuple) else out)[:, -1].float().cpu())
        return out

    def spy_gen(ids, *a, **k):
        rows.append(np.asarray(ids.cpu() if hasattr(ids, "cpu") else ids))
        return gen(ids, *a, **k)

    model.forward, model.generate = spy_fwd, spy_gen
    try:
        result = fn()
    finally:
        del model.forward, model.generate
    return result, logits, rows


def moe_rows_of(prompts, rows):
    """The batch row of each prompt in the left-padded ``rows`` [b, s]."""
    out = []
    for p in prompts:
        hits = [r for r in range(rows.shape[0]) if (rows[r, -len(p):] == p).all()
                and not rows[r, :-len(p)].any()]
        if not hits:
            raise AssertionError(f"prompt of {len(p)} tokens not in the batch")
        out.append(hits[0])
    return out


def moe_certify(torch, label, got, want, got_logits, want_logits):
    """Where two greedy bf16 streams part (token i), a near-tie: each
    path's logits there choose its own token, by a margin over the other
    token no larger than the largest difference between the two paths'
    logits, and the paths lie within MOE_DEPTH_REL of each other.
    Returns the index (len if none) and a note."""
    i = first_diff(got, want)
    if i is None:
        return len(want), "token-exact"
    g, w = int(got[i]), int(want[i])
    a, b = got_logits[i].float(), want_logits[i].float()
    r, gap = rel_l2(a, b), float((a - b).abs().max())
    margin = max(float(a[g] - a[w]), float(b[w] - b[g]))
    note = (f"part at token {i}: {g} / {w}, margins {float(a[g] - a[w]):.4f} / "
            f"{float(b[w] - b[g]):.4f} within the paths' largest logit difference {gap:.4f}, "
            f"{r:.4g} relative L2 apart")
    if int(a.argmax()) != g or int(b.argmax()) != w or margin > gap or not r <= MOE_DEPTH_REL:
        raise AssertionError(f"moe {label}: not a near-tie: {note}")
    return i, note


def moe_serve(torch, card, dev="cuda"):
    """(b) Mixtral-8x7B at MOE_SERVE_LAYERS layers in bf16: generate_batch
    on 8 ragged prompts with the kernels (launches counted) and with their
    plain twins (flags off), token-exact up to certified near-ties;
    generate at 8 x 512 timed, a decode step and a prefill profiled by
    part; the ServingEngine on the same prompts against generate_batch:
    token-exact, or parted after an assignment of the request dropped by
    capacity on either path (logged), or at a certified near-tie.  Returns
    generate_batch's launches."""
    import numpy as np

    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.inference import Predictor
    from paddle_tpu_torch.models import LlamaForCausalLM, mixtral_8x7b
    from paddle_tpu_torch.serving import ServingEngine

    cfg = mixtral_8x7b(num_hidden_layers=MOE_SERVE_LAYERS)
    L, T, V, P = cfg.num_hidden_layers, MAX_NEW, cfg.vocab_size, ENGINE_KW["page_tokens"]
    t0 = time.perf_counter()
    model = LlamaForCausalLM(cfg, device=dev, dtype=torch.bfloat16, seed=0).eval()
    torch.cuda.synchronize()
    log(f"moe (b) mixtral_8x7b at {L} layers: {model.num_params() / 1e9:.2f} B params "
        f"({active_params(model) / 1e9:.2f} B active a token) bf16 on {card}, made in "
        f"{time.perf_counter() - t0:.1f} s, {torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    rng = np.random.default_rng(4)
    prompts = [rng.integers(1, V, n).astype(np.int32) for n in ENGINE_PROMPT_LENS]
    pred = Predictor.from_model(model)
    want = {"rms_norm": (2 * L + 1) * T, "rope": L * T, "flash_attention": L,
            "decode_attention": L * (T - 1)}

    def batch(flags):
        with ptt.flag_guard(**flags), moe_routings(torch) as seen:
            result = moe_record(torch, model, lambda: counted_launches(
                torch, lambda: pred.generate_batch(prompts, max_batch=BATCH,
                                                   max_new_tokens=T)))
        return result, seen

    t = time.perf_counter()
    ((outs, launches), klog, krows), kdrops = batch({})
    log(f"moe (b) generate_batch: {time.perf_counter() - t:.1f} s with the recorders, "
        f"launches {launches}")
    if launches != want or len(krows) != 1 or len(klog) != T or len(kdrops) != L * T:
        raise AssertionError(f"moe (b) generate_batch: launches {launches} (want {want}), "
                             f"{len(krows)} batches, {len(klog)} forwards, {len(kdrops)} "
                             f"routings")
    ((plain, _), plog, prows), _ = batch(OFF_FLAGS)
    krow, prow = moe_rows_of(prompts, krows[0]), moe_rows_of(prompts, prows[0])
    klog_of = {i: [lg[krow[i]] for lg in klog] for i in range(len(prompts))}
    notes = []
    for i, p in enumerate(prompts):
        ids = outs[i][0]
        if ids.shape != (T,) or ids.min() < 0 or ids.max() >= V:
            raise AssertionError(f"moe (b): bad output for the prompt of {len(p)}: {ids}")
        notes.append(moe_certify(torch, f"(b) kernels vs plain, prompt {i}", ids,
                                 plain[i][0], klog_of[i], [lg[prow[i]] for lg in plog])[1])
    log(f"moe (b) {L}-layer generate_batch, kernels vs plain twins: " + "; ".join(
        f"{len(p)}: {n}" for p, n in zip(prompts, notes)))
    del plog, plain
    # generate_batch's dropped assignments of real tokens, by prompt: the
    # forward that makes token f is routings f*L .. f*L + L - 1
    s_pad = krows[0].shape[1]
    pad_of = {krow[i]: s_pad - len(p) for i, p in enumerate(prompts)}
    batch_drops = {i: [] for i in range(len(prompts))}
    for c, (_, lg, r) in enumerate(kdrops):
        n = lg.shape[0]
        for tok in dropped(r)[1]:
            row, pos = (tok // s_pad, tok % s_pad) if n == BATCH * s_pad else (tok, s_pad)
            if pos >= pad_of[row]:
                batch_drops[krow.index(row)].append(c // L)
    by_layer = [dropped(r)[0] for _, _, r in kdrops[:L]]
    log(f"moe (b) generate_batch prefill ({BATCH}x{s_pad} tokens, capacity "
        f"{kdrops[0][2].capacity}): {sum(by_layer)} assignments dropped over {L} layers, by "
        f"layer {by_layer}; decode (capacity {kdrops[-1][2].capacity}): "
        f"{sum(dropped(r)[0] for _, _, r in kdrops[L:])} dropped; prompts with a real "
        f"token's assignment "
        f"dropped: {sorted(i for i, d in batch_drops.items() if d)}")

    # generate on the unpadded batch: prefill and decode times, peak, profiles
    ids_b = torch.as_tensor(rng.integers(1, V, (BATCH, 512)), device=dev)

    def timed(n):
        torch.cuda.synchronize()
        t = time.perf_counter()
        model.generate(ids_b, max_new_tokens=n)
        torch.cuda.synchronize()
        return time.perf_counter() - t

    torch.cuda.reset_peak_memory_stats()
    t1, tn = timed(1), timed(T)
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"moe (b) generate {BATCH}x512+{T} on {card}: prefill {t1 * 1e3:.1f} ms "
        f"({BATCH * 512 / t1:.1f} tokens/s), decode {(tn - t1) / (T - 1) * 1e3:.2f} ms a step "
        f"({BATCH * (T - 1) / (tn - t1):.1f} tokens/s), peak {peak:.2f} GiB")
    with torch.inference_mode():
        caches = model.new_kv_cache(BATCH, 512 + T)
        logits, _ = model(ids_b, kv_cache=caches, position_offset=0)
        tok = logits[:, -1].argmax(-1)[:, None]
        del logits
        moe_profile(torch, f"(b) generate decode step, batch {BATCH}",
                    lambda: model(tok, kv_cache=caches, position_offset=512))
        moe_profile(torch, f"(b) generate prefill {BATCH}x512", lambda: model(
            ids_b, kv_cache=caches, position_offset=0), n=1)
        del caches

    # the engine on the same prompts, stepped; its logits and drops by request
    eng = ServingEngine(model, **ENGINE_KW)
    rids = [eng.submit(p, max_new_tokens=T) for p in prompts]
    length = dict(zip(rids, ENGINE_PROMPT_LENS))
    by_rid = {rid: [] for rid in rids}
    tag = {"rid": None, "rows": None, "step": 0}
    chunks_fn, prefill_fn, forward_fn = eng._prefill_chunks, eng._prefill, eng._forward

    def spy_chunks(*a, **k):
        lg = chunks_fn(*a, **k)
        by_rid[tag["rid"]].append(torch.from_numpy(lg))
        return lg

    def spy_prefill(r):
        tag["rid"] = r.rid
        try:
            return prefill_fn(r)
        finally:
            tag["rid"] = None

    def spy_forward(tokens, positions, tables, n_tok, take=None):
        if take is not None:
            return forward_fn(tokens, positions, tables, n_tok, take)
        rows = {row: r for row, r in eng._active.items() if int(n_tok[row]) > 0}
        tag["rows"] = {row: r.rid for row, r in rows.items()}
        tag["step"] = {r.rid: len(r.generated) for r in rows.values()}
        try:
            out = forward_fn(tokens, positions, tables, n_tok)
        finally:
            tag["rows"] = None
        for row, r in rows.items():
            by_rid[r.rid].append(out[row, 0].float().cpu())
        return out

    eng._prefill_chunks, eng._prefill, eng._forward = spy_chunks, spy_prefill, spy_forward
    step_s, n_launch = [], {}
    with moe_routings(torch, tag) as edrops:
        while eng._queue or eng._active:
            t = time.perf_counter()
            _, counts = counted_launches(torch, eng.step)
            step_s.append(time.perf_counter() - t)
            for key, c in counts.items():
                n_launch[key] = n_launch.get(key, 0) + c
    outs_e = eng.run()
    del eng._prefill_chunks, eng._prefill, eng._forward
    eng.pool.check_leaks()
    chunks = sum(-(-n // P) for n in ENGINE_PROMPT_LENS)
    want_e = {"rms_norm": (2 * L + 1) * (chunks + T - 1), "rope": L * (chunks + T - 1)}
    if n_launch != want_e:
        raise AssertionError(f"moe (b) engine: launches {n_launch}, want {want_e}")
    # the engine's dropped assignments of real tokens, by request and token
    eng_drops = {rid: [] for rid in rids}
    seen_chunks = {rid: 0 for rid in rids}
    for ctx, _, r in edrops:
        toks = dropped(r)[1]
        if ctx["rid"] is not None:          # a prefill chunk: token 0 of the request
            c = seen_chunks[ctx["rid"]] // L
            seen_chunks[ctx["rid"]] += 1
            if any(tok < length[ctx["rid"]] - c * P for tok in toks):
                eng_drops[ctx["rid"]].append(0)
        else:                               # a decode step: one token a live row
            for tok in toks:
                rid = ctx["rows"].get(tok)
                if rid is not None:
                    eng_drops[rid].append(ctx["step"][rid])
    chunk_drops = sum(dropped(r)[0] for ctx, _, r in edrops if ctx["rid"] is not None)
    log(f"moe (b) engine on {card}: first step (the {len(prompts)} prefills, {chunks} chunks) "
        f"{step_s[0] * 1e3:.1f} ms, decode {np.mean(step_s[1:]) * 1e3:.2f} ms a step at batch "
        f"{BATCH} (recorders on), {BATCH * T / sum(step_s):.1f} tokens/s over the run; "
        f"{chunk_drops} assignments dropped in the prefill chunks (capacity 8 of {P} "
        f"tokens), {sum(dropped(r)[0] for ctx, _, r in edrops if ctx['rid'] is None)} in "
        f"decode; launches "
        f"{n_launch}")
    lines = []
    for i, (rid, p) in enumerate(zip(rids, prompts)):
        got, ref = outs_e[rid], outs[i][0]
        j = first_diff(got, ref)
        drops = [s for s in batch_drops[i] + eng_drops[rid] if j is not None and s <= j]
        if j is None:
            lines.append(f"{len(p)}: token-exact")
        elif drops:
            lines.append(f"{len(p)}: part at token {j} after {len(drops)} dropped assignments "
                         f"of the request (generate_batch at tokens {sorted(set(batch_drops[i]))[:6]}, "
                         f"engine at {sorted(set(eng_drops[rid]))[:6]}): the drops explain it")
        else:
            lines.append(f"{len(p)}: " + moe_certify(
                torch, f"(b) engine vs generate_batch, prompt {i}", got, ref, by_rid[rid],
                klog_of[i])[1])
    log("moe (b) engine vs generate_batch: " + "; ".join(lines))
    del eng, pred, model, klog, klog_of
    return launches


def moe_train(torch, card, dev="cuda"):
    """(c) Mixtral-8x7B training: the f32 gate (MOE_TRAIN_GATE: one layer,
    2 x 128 tokens) card against the CPU within MOE_F32_REL for the loss
    and every gradient, the routing equal but for certified near-ties;
    the bf16 O2 rule at 2 layers on 1 x 2048 (``grads_against_f32``: the
    loss and all gradients together within LOGITS_REL_TOL of the plain
    path or no farther from f32, and at most DEPTH_REL_MARGIN times the
    plain path's distance); then ``train_steps`` at MOE_TRAIN_LAYERS and
    4 x 2048 (halved if the peak passes MOE_PEAK_GIB).  Returns the counted
    steps' launches."""
    import numpy as np

    layers, rows, seq = MOE_TRAIN_GATE
    model = make_mixtral(layers)
    vocab = model.config.vocab_size
    ids = torch.as_tensor(np.random.default_rng(9).integers(0, vocab, (rows, seq)), device=dev)
    labels = torch.roll(ids, -1, dims=1)
    cpu = copy.deepcopy(model).to("cpu")
    with moe_routings(torch) as card_routes:
        card_loss, card_grads = loss_and_grads(torch, model, ids, labels)
    t = time.perf_counter()
    with moe_routings(torch) as cpu_routes:
        cpu_loss, cpu_grads = loss_and_grads(torch, cpu, ids.cpu(), labels.cpu())
    cpu_s = time.perf_counter() - t
    del model, cpu
    differ = moe_route_diff(torch, "(c) f32 gate, card vs CPU", card_routes[0][1:],
                            cpu_routes[0][1:])
    r_loss = abs(float(card_loss) - float(cpu_loss)) / abs(float(cpu_loss))
    worst = sorted(((rel_l2(card_grads[n].cpu(), g), n) for n, g in cpu_grads.items()),
                   reverse=True)
    log(f"moe (c) f32 gate, {layers} layer, {rows}x{seq}: loss card {float(card_loss):.6f} CPU "
        f"{float(cpu_loss):.6f} ({r_loss:.3g}); grads relative L2, worst three: "
        + "; ".join(f"{n} {r:.3g}" for r, n in worst[:3]) + f" (bound {MOE_F32_REL}; the "
        f"CPU's step {cpu_s:.1f} s)")
    # a certified near-tie moves a token's claim between rounds: with no
    # drop on either side each token still sums the same expert rows, and
    # only the aux loss's top-1 share (the routers' gradients) sees it
    drops = bool(dropped(card_routes[0][2])[0] or dropped(cpu_routes[0][2])[0])
    if bool(differ.any()) and drops:
        log(f"moe (c) f32 gate: {int(differ.sum())} tokens routed otherwise at certified "
            f"near-ties beside dropped assignments; the gradients are not compared")
        worst = []
    elif bool(differ.any()):
        worst = [w for w in worst if not w[1].endswith("mlp.gate_weight")]
        log(f"moe (c) f32 gate: {int(differ.sum())} tokens routed otherwise at certified "
            f"near-ties, none dropped: the routers' gradients are not compared")
    if r_loss > MOE_F32_REL or (worst and worst[0][0] > MOE_F32_REL):
        raise AssertionError(f"moe (c) f32 gate: loss {r_loss}, {worst[:3]}")
    del card_grads, cpu_grads
    gc.collect()
    torch.cuda.empty_cache()

    ids, labels = train_batch(torch, vocab)
    (lk, gk), (lp, gp), (lf, gf) = grads_against_f32(torch, make_mixtral, MOE_TRAIN_LAYERS,
                                                     LLAMA_ON, ids[:1], labels[:1])

    def together(a, b):
        num = sum(float((a[n].float() - b[n].float()).norm()) ** 2 for n in gf)
        return math.sqrt(num) / math.sqrt(sum(float(b[n].float().norm()) ** 2 for n in gf))

    r_kp = abs(float(lk) - float(lp)) / abs(float(lp))
    kp, kf, pf = together(gk, gp), together(gk, gf), together(gp, gf)
    per = sorted(((rel_l2(gk[n], gp[n]), n) for n in gf), reverse=True)
    log(f"moe (c) bf16 O2 {MOE_TRAIN_LAYERS} layers 1x{TRAIN_SEQ}: loss kernels {float(lk):.5f} "
        f"plain {float(lp):.5f} f32 {float(lf):.5f} ({r_kp:.3g}); all grads together kernels "
        f"vs plain {kp:.4g}, to f32 kernels {kf:.4g}, plain {pf:.4g}; worst three kernels vs "
        f"plain: " + "; ".join(f"{n} {r:.4g}" for r, n in per[:3]))
    if r_kp > LOGITS_REL_TOL or (kp > LOGITS_REL_TOL and kf > pf) or kf > DEPTH_REL_MARGIN * pf:
        raise AssertionError(f"moe (c) bf16 rule: loss {r_kp}, grads {kp} ({kf} / {pf})")
    del gk, gp, gf
    gc.collect()
    torch.cuda.empty_cache()
    launches, losses, step_ms = train_steps(torch, card, make_mixtral, MOE_TRAIN_LAYERS,
                                            LLAMA_ON, ids, labels)
    peak = torch.cuda.max_memory_allocated() / 2**30
    if peak > MOE_PEAK_GIB:
        log(f"moe (c): peak {peak:.2f} GiB > {MOE_PEAK_GIB}: the batch halves to "
            f"{TRAIN_BATCH // 2}x{TRAIN_SEQ}")
        gc.collect()
        torch.cuda.empty_cache()
        launches, losses, step_ms = train_steps(torch, card, make_mixtral, MOE_TRAIN_LAYERS,
                                                LLAMA_ON, ids[:TRAIN_BATCH // 2],
                                                labels[:TRAIN_BATCH // 2])
    log(f"moe (c) the MFU above counts 6 N_active tokens + 7 L b h s^2 d FLOP a step, "
        f"N_active with the top-k experts of each layer's E (active_params)")
    return launches


def phase_moe(torch, card):
    """MoE Llama at Mixtral-8x7B's widths (ROADMAP A9): (a) the layer, (b)
    serving at MOE_SERVE_LAYERS layers, (c) training at MOE_TRAIN_LAYERS.
    Returns the launches of (b)'s generate_batch and (c)'s counted steps
    (the ``moe`` path)."""
    t0 = time.perf_counter()
    moe_layer(torch, card)
    gc.collect()
    torch.cuda.empty_cache()
    log(f"moe (a): {time.perf_counter() - t0:.1f} s")
    launches = dict(moe_serve(torch, card))
    gc.collect()
    torch.cuda.empty_cache()
    log(f"moe (b): {time.perf_counter() - t0:.1f} s")
    for key, n in moe_train(torch, card).items():
        launches[key] = launches.get(key, 0) + n
    gc.collect()
    torch.cuda.empty_cache()
    log(f"moe phase: {time.perf_counter() - t0:.1f} s")
    return launches


EXPORT_ERNIE_BATCHES = ((16, 512), (8, 128))   # phase_export (a): batches through one program
EXPORT_LLAMA = (2, 8, 512)          # (b): Llama-2-7B width: layers, rows, tokens a row
EXPORT_TIMED = 3                    # runs timed a configuration (the median is kept)
EXPORT_KERNELS = frozenset({"rms_norm", "rope", "flash_attention"})
CKPT_BATCH = 32                     # phase_ckpt: rows of ERNIE_FT_SEQ tokens a step
CKPT_SEED = 1234                    # the card generator's seed before a run's first step


def median_ms(torch, fn, n=EXPORT_TIMED):
    """The median wall ms of ``n`` synchronised calls."""
    times = []
    for _ in range(n):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
    return sorted(times)[n // 2]


def counted(torch, fn):
    """(fn(), the kernel launches it made), synchronised."""
    from paddle_tpu_torch.ops import LAUNCHES, reset_launch_counts

    torch.cuda.synchronize()
    reset_launch_counts()
    out = fn()
    torch.cuda.synchronize()
    return out, {k: v for k, v in LAUNCHES.items() if v}


def file_bytes(path) -> int:
    return os.path.getsize(path) if os.path.exists(path) else 0


def export_serve(torch, card, label, model, specs, batches, want, workdir, gate):
    """``jit.save`` ``model`` with ``specs``, ``create_predictor(Config(path))``,
    and run each of ``batches`` (tuples of host int64 arrays) through the one
    program by the handles: the launches of each run must be ``want``, the
    outputs pass ``gate(i, predicted, eager)`` against the eager forward on
    the card.  Logs export, save and load s, the files' bytes, run ms
    against eager ms and the handles' copy ms.  Returns the first run's
    launches."""
    import numpy as np

    from paddle_tpu_torch import inference, jit

    path = os.path.join(workdir, label)
    t0 = time.perf_counter()
    jit.save(model, path, input_spec=specs)
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    pred = inference.create_predictor(inference.Config(path + ".pdmodel"))
    load_s = time.perf_counter() - t0
    names = pred.get_input_names()
    if len(names) != len(specs):
        raise AssertionError(f"export {label}: input names {names} for {len(specs)} specs")
    first = None
    for i, arrays in enumerate(batches):
        def run():
            for n, a in zip(names, arrays):
                pred.get_input_handle(n).copy_from_cpu(a)
            pred.run()
            return pred.get_output_handle(pred.get_output_names()[0]).copy_to_cpu()

        got, launches = counted(torch, run)
        if launches != want:
            raise AssertionError(f"export {label} {arrays[0].shape}: launches {launches}, "
                                 f"want {want}")
        first = first or launches
        dev = next(iter(model.parameters())).device
        dev_args = [torch.as_tensor(a, device=dev) for a in arrays]
        with torch.no_grad():
            eager = model(*dev_args)
        eager = eager[0] if isinstance(eager, tuple) else eager
        if not np.isfinite(got).all() or list(got.shape) != list(eager.shape):
            raise AssertionError(f"export {label}: output {got.shape} finite "
                                 f"{np.isfinite(got).all()}, eager {list(eager.shape)}")
        got_t = torch.as_tensor(got, device=dev)
        diff = float((got_t - eager.float()).abs().max())
        detail = gate(i, got_t, eager)
        run_ms = median_ms(torch, run)
        copy_in_ms = median_ms(torch, lambda: [pred.get_input_handle(n).copy_from_cpu(a)
                                               for n, a in zip(names, arrays)])
        program_ms = median_ms(torch, lambda: pred._layer(*dev_args))
        with torch.no_grad():
            eager_ms = median_ms(torch, lambda: model(*dev_args))
        log(f"export {label} {'x'.join(map(str, arrays[0].shape))} on {card}: predictor run "
            f"{run_ms:.2f} ms (the program alone on card tensors {program_ms:.2f} ms, the "
            f"eager forward {eager_ms:.2f} ms; the handles' copies and transfers "
            f"{run_ms - program_ms:.2f} ms, copy_from_cpu {copy_in_ms:.3f} ms), launches "
            f"{launches}, largest |predicted - eager| {diff:.4g} (bit-equal "
            f"{diff == 0.0}); {detail}")
        del got_t, eager, dev_args
    log(f"export {label}: jit.save {save_s:.2f} s (export and both files), .pdmodel "
        f"{file_bytes(path + '.pdmodel') / 2**20:.1f} MiB, .pdiparams "
        f"{file_bytes(path + '.pdiparams') / 2**20:.1f} MiB; create_predictor (jit.load) "
        f"{load_s:.2f} s")
    del pred
    for suffix in (".pdmodel", ".pdiparams"):
        if os.path.exists(path + suffix):
            os.remove(path + suffix)
    return first


def export_ernie(torch, card, workdir, cfg=None, dev="cuda", batches=EXPORT_ERNIE_BATCHES):
    """(a) ERNIE 3.0 base at its published widths and depth, bf16, eval,
    saved with a dynamic batch and sequence (``input_ids``,
    ``token_type_ids``) and served at each of ``batches`` through one
    program; the logits under the ERNIE phase's bf16 rule (within
    LOGITS_REL_TOL of the f32 plain path, or no further than
    DEPTH_REL_MARGIN times the plain bf16 path); 12 B3 a run.  Then
    ``jit.to_static`` of the same model: bit-equal to eager with the same
    launches.  Returns the first run's launches."""
    import numpy as np

    import paddle_tpu_torch as ptt
    from paddle_tpu_torch import jit
    from paddle_tpu_torch.models import ErnieConfig, ErnieForSequenceClassification

    cfg = cfg or ErnieConfig()
    model = ErnieForSequenceClassification(cfg, device=dev, seed=0).eval()
    rng = np.random.default_rng(25)
    arrays = [(rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int64),
               rng.integers(0, 2, (b, s)).astype(np.int64)) for b, s in batches]
    refs, plains = [], []
    for ids, seg in arrays:
        args = [torch.as_tensor(a, device=dev) for a in (ids, seg)]
        with torch.no_grad(), ptt.flag_guard(**OFF_FLAGS):
            refs.append(model(*args).float())
    model.to(dtype="bfloat16")
    for ids, seg in arrays:
        args = [torch.as_tensor(a, device=dev) for a in (ids, seg)]
        with torch.no_grad(), ptt.flag_guard(**OFF_FLAGS):
            plains.append(model(*args).float())

    def gate(i, got, eager):
        err, plain = rel_l2(got, refs[i]), rel_l2(plains[i], refs[i])
        if not (err <= LOGITS_REL_TOL or err <= DEPTH_REL_MARGIN * plain):
            raise AssertionError(f"export ernie: predicted logits {err} from the f32 plain "
                                 f"path, plain bf16 {plain}")
        return (f"relative L2 to the f32 plain path {err:.3g} (plain bf16 {plain:.3g}, "
                f"eager bf16 kernel {rel_l2(eager, refs[i]):.3g})")

    specs = [jit.InputSpec([None, "seq"], "int64", "input_ids"),
             jit.InputSpec([None, "seq"], "int64", "token_type_ids")]
    want = {"flash_attention": cfg.num_hidden_layers}
    launches = export_serve(torch, card, "ernie", model, specs, arrays, want, workdir, gate)
    # to_static runs eagerly: bit-equal, the same launches
    args = [torch.as_tensor(a, device=dev) for a in arrays[0]]
    with torch.no_grad():
        eager, eager_launches = counted(torch, lambda: model(*args))
        jit.to_static(model)
        static, static_launches = counted(torch, lambda: model(*args))
    if not torch.equal(static, eager) or static_launches != eager_launches:
        raise AssertionError(f"to_static: equal {torch.equal(static, eager)}, launches "
                             f"{static_launches} against {eager_launches}")
    log(f"export ernie: to_static bit-equal to eager, launches {static_launches}")
    del model, refs, plains, eager, static
    return launches


def export_llama(torch, card, workdir, make=None, shape=EXPORT_LLAMA, vocab=None):
    """(b) Llama-2-7B width at ``shape[0]`` layers, bf16, saved with a
    dynamic batch and sequence and served at ``shape[1]`` x ``shape[2]``:
    within LOGITS_REL_TOL of the eager forward on the card, B1 2L+1, B2 L and
    B3 L launches a run.  Returns the run's launches."""
    import numpy as np

    from paddle_tpu_torch import jit

    from paddle_tpu_torch.models import LlamaForCausalLM, llama2_7b

    layers, rows, seq = shape
    model = (make(layers) if make else LlamaForCausalLM(
        llama2_7b(num_hidden_layers=layers), device="cuda", dtype=torch.bfloat16,
        seed=0)).eval()
    vocab = vocab or model.config.vocab_size
    ids = np.random.default_rng(26).integers(0, vocab, (rows, seq)).astype(np.int64)

    def gate(i, got, eager):
        err = rel_l2(got, eager)
        if err > LOGITS_REL_TOL:
            raise AssertionError(f"export llama: predicted logits {err} from eager")
        return f"relative L2 to eager {err:.3g}"

    want = {"rms_norm": 2 * layers + 1, "rope": layers, "flash_attention": layers}
    launches = export_serve(torch, card, "llama", model,
                            [jit.InputSpec([None, None], "int64", "input_ids")], [(ids,)],
                            want, workdir, gate)
    del model
    return launches


def phase_export(torch, card):
    """The saved program (ROADMAP A3d): ``jit.save`` with an ``InputSpec``,
    ``create_predictor(Config(path))`` and the handles, (a) ERNIE 3.0 base,
    (b) Llama-2-7B width at 2 layers; B1, B2 and B3 run from inside the
    loaded program.  Returns the counted runs' launches (the ``export``
    path)."""
    t0 = time.perf_counter()
    workdir = tempfile.mkdtemp(prefix="ptt_export_")
    try:
        launches = dict(export_ernie(torch, card, workdir))
        gc.collect()
        torch.cuda.empty_cache()
        for k, v in export_llama(torch, card, workdir).items():
            launches[k] = launches.get(k, 0) + v
    finally:
        import shutil

        shutil.rmtree(workdir, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    log(f"export phase: {time.perf_counter() - t0:.1f} s")
    return launches


def ckpt_trainer(torch, dev, make=None, snapshotter=None):
    """Ladder row 2's trainer (bf16 O2, AdamW(ERNIE_FT_LR) + clip, dropout
    0.1): (model, optimizer, TrainStep); B5 runs where the caller turns
    ``use_fused_adamw`` on."""
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    from paddle_tpu_torch.optimizer import AdamW

    model = (make or (lambda: ernie_ft_model(torch, 12, dev)))()
    opt = AdamW(ERNIE_FT_LR, parameters=model.parameters(), grad_clip=ClipGradByGlobalNorm(1.0))
    model, opt = ptt.amp.decorate(model, opt, level="O2", dtype="bfloat16")
    step = TrainStep(model, lambda m, x, y: m(x, labels=y)[0], opt, snapshotter=snapshotter)
    return model, opt, step


def ckpt_state(torch, model, opt, dev="cuda"):
    """What a resume needs: the model's and optimizer's state dicts and the
    card generator's state (the dropout masks)."""
    rng = torch.cuda.get_rng_state() if dev == "cuda" else torch.get_rng_state()
    return {"model": model.state_dict(), "opt": opt.state_dict(), "rng": rng}


def ckpt_restore(torch, model, opt, state, dev="cuda"):
    """Put a loaded ``ckpt_state`` into effect."""
    opt.set_state_dict(state["opt"])
    if dev == "cuda":
        torch.cuda.set_rng_state(state["rng"])
    else:
        torch.set_rng_state(state["rng"])


def ckpt_seed(torch, dev):
    if dev == "cuda":
        torch.cuda.manual_seed(CKPT_SEED)
    else:
        torch.manual_seed(CKPT_SEED)


def ckpt_losses(torch, step, batch, n, times=None):
    """``n`` steps' losses; each step's synchronised ms appended to
    ``times`` when given (``float`` of the loss synchronises)."""
    out = []
    for _ in range(n):
        t = time.perf_counter()
        out.append(float(step(*batch)))
        if times is not None:
            times.append((time.perf_counter() - t) * 1e3)
    return out


def state_bytes(torch, state) -> int:
    from paddle_tpu_torch.distributed.checkpoint.utils import flatten_state_dict

    flat, _ = flatten_state_dict(state)
    return sum(v.numel() * v.element_size() for v in flat.values()
               if isinstance(v, torch.Tensor))


def phase_ckpt(torch, card, dev="cuda", make=None, batch=None):
    """The distributed checkpoint and the in-memory snapshots (ROADMAP A7a)
    on ladder row 2's model at CKPT_BATCH x ERNIE_FT_SEQ: 4 steps straight;
    2 steps, ``save_state_dict`` (model, optimizer, card generator), a fresh
    trainer ``load_state_dict``-ed, 2 more steps, bit-equal to the straight
    steps 3-4; the same with ``async_save=True`` and a step at once after
    the save (the checkpoint holds the values from before it); a
    ``Snapshotter`` every 2 steps through ``TrainStep(snapshotter=)``, its
    capture ms against the steps without one, and ``resume`` from memory
    bit-equal (the state, then the next loss).  Logs the state's GiB, save s
    and GB/s, load s, capture ms and the peak."""
    import shutil

    import paddle_tpu_torch as ptt

    t0 = time.perf_counter()
    workdir = tempfile.mkdtemp(prefix="ptt_ckpt_")
    if dev == "cuda":
        torch.cuda.reset_peak_memory_stats()
    try:
        with ptt.flag_guard(use_fused_adamw=True):
            ckpt_runs(torch, card, dev, make, batch, workdir, t0)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    gc.collect()
    if dev == "cuda":
        torch.cuda.empty_cache()


def ckpt_runs(torch, card, dev, make, batch, workdir, t0):
    """``phase_ckpt``'s runs, in ``workdir``."""
    from paddle_tpu_torch.distributed.checkpoint import (Snapshotter, load_state_dict,
                                                         resume, save_state_dict)
    from paddle_tpu_torch.distributed.checkpoint.save_state_dict import _wait_pending

    def fresh(snapshotter=None):
        gc.collect()
        if dev == "cuda":
            torch.cuda.empty_cache()
        return ckpt_trainer(torch, dev, make, snapshotter)

    model, opt, step = fresh()
    if batch is None:
        batch = ernie_ft_batch(torch, CKPT_BATCH, dev, model.ernie.config.vocab_size)
    ckpt_seed(torch, dev)
    plain_ms = []
    straight = ckpt_losses(torch, step, batch, 4, plain_ms)
    del model, opt, step

    results = {}
    for mode in ("sync", "async"):
        model, opt, step = fresh()
        ckpt_seed(torch, dev)
        first = ckpt_losses(torch, step, batch, 2)
        state = ckpt_state(torch, model, opt, dev)
        nbytes = state_bytes(torch, state)
        path = os.path.join(workdir, mode)
        if dev == "cuda":
            torch.cuda.synchronize()
        t = time.perf_counter()
        save_state_dict(state, path, async_save=mode == "async")
        save_s = time.perf_counter() - t
        after = ckpt_losses(torch, step, batch, 1) if mode == "async" else []
        t = time.perf_counter()
        _wait_pending()
        drain_s = time.perf_counter() - t
        del model, opt, step, state
        model, opt, step = fresh()
        target = ckpt_state(torch, model, opt, dev)
        t = time.perf_counter()
        load_state_dict(target, path)
        ckpt_restore(torch, model, opt, target, dev)
        if dev == "cuda":
            torch.cuda.synchronize()
        load_s = time.perf_counter() - t
        resumed = ckpt_losses(torch, step, batch, 2)
        if first != straight[:2] or resumed != straight[2:] or \
                (after and after != straight[2:3]):
            raise AssertionError(f"ckpt {mode}: straight {straight}, first {first}, "
                                 f"resumed {resumed}, the step after the save {after}")
        results[mode] = (nbytes, save_s, drain_s, load_s)
        del model, opt, step, target
    nbytes, save_s, _, load_s = results["sync"]
    _, async_s, drain_s, async_load_s = results["async"]
    log(f"ckpt on {card}: ERNIE 3.0 base row 2 state {nbytes / 2**30:.3f} GiB (bf16 "
        f"parameters, f32 masters and moments, the generator); save_state_dict "
        f"{save_s:.2f} s ({nbytes / save_s / 1e9:.2f} GB/s), load_state_dict {load_s:.2f} s "
        f"({async_load_s:.2f} s of the async one); "
        f"async_save returned in {async_s:.2f} s (the host copy) and drained "
        f"{drain_s:.2f} s later, behind a step; resumed losses bit-equal to the straight "
        f"run's steps 3-4 (sync and async): " + " ".join(f"{v:.6f}" for v in straight))

    snap = Snapshotter(lambda: ckpt_state(torch, model, opt, dev), every=2,
                       transport=None, rank=0, world_size=1)
    model, opt, step = fresh(snap)
    ckpt_seed(torch, dev)
    snap_ms = []
    snapped = ckpt_losses(torch, step, batch, 4, snap_ms)
    if snapped != straight or snap.captures != 2 or snap.latest_step() != 4:
        raise AssertionError(f"snapshot run: losses {snapped} against {straight}, "
                             f"captures {snap.captures}, latest {snap.latest_step()}")
    capture_ms = snap.capture_seconds_total / snap.captures * 1e3
    want_state = {k: v.clone() for k, v in model.state_dict().items()}
    want_next = ckpt_losses(torch, step, batch, 1)
    model2, opt2, step2 = fresh()
    target = ckpt_state(torch, model2, opt2, dev)
    info = resume(target, snapshotter=snap, transport=None, rank=0, world_size=1)
    ckpt_restore(torch, model2, opt2, target, dev)
    same = all(torch.equal(v, want_state[k]) for k, v in model2.state_dict().items())
    got_next = ckpt_losses(torch, step2, batch, 1)
    if info.source != "memory" or info.step != 4 or not same or got_next != want_next:
        raise AssertionError(f"resume: {info}, state equal {same}, next loss {got_next} "
                             f"against {want_next}")
    peak = torch.cuda.max_memory_allocated() / 2**30 if dev == "cuda" else 0.0
    log(f"ckpt snapshots every 2 steps: capture {capture_ms:.1f} ms a snapshot "
        f"({capture_ms / 2:.1f} ms a step); steps 2-4 " + " ".join(
            f"{v:.2f}" for v in snap_ms[1:]) + " ms with the snapshotter (captures at 2 "
        "and 4) against " + " ".join(f"{v:.2f}" for v in plain_ms[1:]) + " ms without "
        f"(the first step {snap_ms[0]:.2f}, {plain_ms[0]:.2f}); resume from {info.source} at step "
        f"{info.step}, state bit-equal, next loss bit-equal ({got_next[0]:.6f}); peak "
        f"{peak:.2f} GiB; phase {time.perf_counter() - t0:.1f} s")
    del model, opt, step, model2, opt2, step2, snap, target


SOURCES = {  # kernel: (source, the TPU kernel it replaces, the path it is counted on)
    "rms_norm": ("paddle_tpu_torch/ops/csrc/rms_norm.cu",
                 "paddle_tpu/ops/pallas/fused_norm.py:88", "serve"),
    "rope": ("paddle_tpu_torch/ops/csrc/rope.cu", "paddle_tpu/ops/pallas/rope.py:47", "serve"),
    "flash_attention": ("paddle_tpu_torch/ops/csrc/flash_attention.cu",
                        "paddle_tpu/ops/pallas/flash_attention.py:181", "serve"),
    "decode_attention": ("paddle_tpu_torch/ops/csrc/decode_attention.cu",
                         "paddle_tpu/ops/pallas/decode_attention.py:172", "serve"),
    "rms_norm_bwd": ("paddle_tpu_torch/ops/csrc/rms_norm.cu",
                     "paddle_tpu/ops/pallas/fused_norm.py:112", "train"),
    "rope_bwd": ("paddle_tpu_torch/ops/csrc/rope.cu", "paddle_tpu/ops/pallas/rope.py:81", "train"),
    "flash_attention_bwd_dq": ("paddle_tpu_torch/ops/csrc/flash_attention_bwd.cu",
                               "paddle_tpu/ops/pallas/flash_attention.py:315", "train"),
    "flash_attention_bwd_dkv": ("paddle_tpu_torch/ops/csrc/flash_attention_bwd.cu",
                                "paddle_tpu/ops/pallas/flash_attention.py:350", "train"),
    "swiglu": ("paddle_tpu_torch/ops/csrc/fused_ln_swiglu.cu",
               "paddle_tpu/ops/pallas/fused_ln_swiglu.py:193", "train"),
    "swiglu_bwd": ("paddle_tpu_torch/ops/csrc/fused_ln_swiglu.cu",
                   "paddle_tpu/ops/pallas/fused_ln_swiglu.py:193", "train"),
    "adamw": ("paddle_tpu_torch/ops/csrc/fused_ln_swiglu.cu",
              "paddle_tpu/ops/pallas/fused_ln_swiglu.py:280", "train"),
    "add_layer_norm": ("paddle_tpu_torch/ops/csrc/fused_ln_swiglu.cu",
                       "paddle_tpu/ops/pallas/fused_ln_swiglu.py:92", "gpt_train"),
    "add_layer_norm_bwd": ("paddle_tpu_torch/ops/csrc/fused_ln_swiglu.cu",
                           "paddle_tpu/ops/pallas/fused_ln_swiglu.py:124", "gpt_train"),
    "decode_attention_int8": ("paddle_tpu_torch/ops/csrc/decode_attention.cu",
                              "paddle_tpu/ops/pallas/decode_attention.py:399", "quant"),
    "decode_attention_fp8": ("paddle_tpu_torch/ops/csrc/decode_attention.cu",
                             "paddle_tpu/ops/pallas/decode_attention.py:627", "quant"),
    "ring_flash_attention": ("paddle_tpu_torch/ops/csrc/ring_flash.cu",
                             "paddle_tpu/ops/pallas/ring_flash.py:159", "cp"),
    "ring_merge": ("paddle_tpu_torch/ops/csrc/ring_flash.cu",
                   "paddle_tpu/ops/pallas/ring_flash.py:159", "cp"),
    "adamw_host": ("paddle_tpu_torch/ops/csrc/fused_ln_swiglu.cu",
                   "paddle_tpu/ops/pallas/fused_ln_swiglu.py:280", "offload"),
}

# the count a row reads: B10 has no kernel of its own, its launches are the
# B3 launches of its hops on the CP path (every B3 launch there is a ring
# hop, each followed by one merge; ``cp_launches`` holds the two counts
# equal); B5's host route is B5 launched on the offload path's pinned states
COUNTED_AS = {"ring_flash_attention": "flash_attention", "adamw_host": "adamw"}

# the kernels of fleet's hybrid step, of auto_parallel's Engine step, of ERNIE's
# inference (also under O1 autocast, phase_resnet_train), of the f32 Llama
# step, of the head_dim 256 step, of the eager idiom's loop (phase_core), of
# the ERNIE fine-tune (B5), of phase_a9's fused layers and residual norms and
# of phase_moe's MoE Llama (generate_batch and training) and of phase_export's
# saved programs (B1, B2, B3 run from inside a loaded program): their launches
# add those paths
EXTRA_PATHS = {"hybrid": frozenset(hybrid_want(1, 1)), "auto": frozenset(hybrid_want(1, 1)),
               "ernie": frozenset({"flash_attention"}),
               "train_f32": frozenset({"flash_attention", "flash_attention_bwd_dq",
                                       "flash_attention_bwd_dkv"}),
               "train_d256": frozenset({"flash_attention", "flash_attention_bwd_dq",
                                        "flash_attention_bwd_dkv"}),
               "core": CORE_KERNELS, "ernie_o1": frozenset({"flash_attention"}),
               "ernie_ft": frozenset({"adamw"}),
               "a9": frozenset({"flash_attention", "flash_attention_bwd_dq",
                                "flash_attention_bwd_dkv", "rms_norm", "rms_norm_bwd",
                                "add_layer_norm", "add_layer_norm_bwd"}),
               "moe": MOE_KERNELS, "export": EXPORT_KERNELS}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card only",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = phase_device(torch)
    phase_build()
    rows = phase_parity(torch)
    quant_rows, quant_launches = phase_quant_parity(torch)
    rows.update(quant_rows)
    torch.cuda.empty_cache()
    rows.update(phase_bwd_parity(torch))
    torch.cuda.empty_cache()
    rows.update(phase_ring_parity(torch))
    torch.cuda.empty_cache()
    rows.update(phase_fused_parity(torch))
    norm_bwd_times(torch)
    torch.cuda.empty_cache()
    serve, cp = phase_e2e(torch, card)
    launches = {"serve": serve, "quant": quant_launches, "cp": cp}
    gc.collect()         # the serving phases' engines and models, before training
    torch.cuda.empty_cache()
    log(f"after the serving phases: {torch.cuda.memory_allocated() / 2**30:.3f} GiB "
        f"allocated, {torch.cuda.memory_reserved() / 2**30:.3f} GiB reserved")
    train = phase_train(torch, card)
    launches["train"] = train[0]
    torch.cuda.empty_cache()
    launches["core"] = phase_core(torch, card)
    gc.collect()
    torch.cuda.empty_cache()
    launches["train_f32"] = phase_train_f32(torch, card)
    gc.collect()
    torch.cuda.empty_cache()
    launches["train_d256"] = phase_train_d256(torch, card)
    gc.collect()
    torch.cuda.empty_cache()
    phase_fused_ce(torch, card)
    gc.collect()
    torch.cuda.empty_cache()
    launches["gpt_train"] = phase_gpt_train(torch, card)
    torch.cuda.empty_cache()
    phase_gpt_generate(torch, card)
    gc.collect()
    torch.cuda.empty_cache()
    launches["ernie"] = phase_ernie(torch, card)
    gc.collect()
    torch.cuda.empty_cache()
    phase_resnet(torch, card)
    gc.collect()
    torch.cuda.empty_cache()
    launches["ernie_o1"] = phase_resnet_train(torch, card)
    gc.collect()
    torch.cuda.empty_cache()
    launches["ernie_ft"] = phase_ernie_ft(torch, card)
    gc.collect()
    torch.cuda.empty_cache()
    launches["a9"] = phase_a9(torch, card)
    gc.collect()
    torch.cuda.empty_cache()
    launches["moe"] = phase_moe(torch, card)
    gc.collect()
    torch.cuda.empty_cache()
    launches["export"] = phase_export(torch, card)
    phase_ckpt(torch, card)
    gc.collect()         # the launcher's worker needs the memory this process cached
    torch.cuda.empty_cache()
    phase_dist(torch, card, train)
    gc.collect()
    torch.cuda.empty_cache()
    phase_tp(torch, card)
    gc.collect()
    torch.cuda.empty_cache()
    launches["hybrid"] = phase_hybrid(torch, card, train)
    gc.collect()
    torch.cuda.empty_cache()
    rows["adamw_host"], launches["offload"] = phase_offload(torch, card, train)
    launches["auto"] = phase_auto(torch, card, train)
    kernels = []
    for name, (src, replaces, path) in SOURCES.items():
        paths = {path: launches[path].get(COUNTED_AS.get(name, name), 0)}
        for extra, names in EXTRA_PATHS.items():
            if name in names:
                paths[extra] = launches[extra].get(name, 0)
        for where, n in paths.items():
            if n == 0:
                raise AssertionError(f"{name}: never launched on the {where} path")
        kernels.append(dict(name=name, route="cuda", source=src, replaces=replaces,
                            launches=sum(paths.values()), paths=paths, **rows[name]))
    print(json.dumps({"kernels": kernels}))
    print(f"card (name, power limit): {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
