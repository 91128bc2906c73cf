"""Smoke run of the PyTorch/CUDA port (``paddle_tpu_torch``) on one card.

    python3 chip_smoke.py

Needs one CUDA card (an H100: the kernels are built for sm_90a) and nvcc;
exits non-zero without them.  Phases, each raising on failure:

1. device: the card's name and power limit, torch and CUDA versions;
2. build: every kernel under ``paddle_tpu_torch/ops/csrc/`` compiled with
   nvcc from the checkout, with the build seconds and ptxas's report (a
   wgmma kernel that spills fails);
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
   off-size attention shapes (d 64, 72, 256), each flash case launched
   twice with bit-equal grads; timed as in 3 (the library call is the
   backward of ``F.rms_norm`` and of SDPA), flash dq and dk/dv also at
   GPT-3 1.3B's and the hop shapes; RMSNorm's also at off sizes (odd h,
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
   and exact or certified near-ties on int8 and fp8 pages, in bf16 at 2
   layers logits within 2e-2 and exact or certified near-ties, exact B1
   and B2 launches on every run; then at full depth in bf16, beside
   ``tp=1``: the 512-token prefill, the decode step, pool bytes a token in
   all and a member, and peak memory.

The last lines are the ``kernels`` JSON line, the card line, and
``{"ok": true, "device": {...}}``.  Nothing is caught: any failure exits
non-zero before the last line.
"""

from __future__ import annotations

import copy
import gc
import json
import re
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
BF16_FLOPS = 989e12            # dense bf16 tensor-core peak
F32_FLOPS = 67e12              # f32 outside the tensor cores
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
DEPTH_REL_MARGIN = 1.2         # full depth: kernel error to f32 <= 1.2x plain's
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


def time_ms(torch, fn, iters: int = 20, repeats: int = 5) -> float:
    """Median over ``repeats`` of the mean device time of ``iters`` calls
    between CUDA events, after a warm-up."""
    for _ in range(3):
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


def device_ms(torch, fn, iters: int = 20):
    """Device time per call of ``fn``: every CUDA kernel that ``iters``
    calls launch, from ``torch.profiler``, summed and divided by ``iters``
    (the host's share of a call left out).  Returns (ms, {kernel: ms})."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    by = {e.key: e.self_device_time_total / 1e3 / iters for e in prof.key_averages()
          if e.device_type == DeviceType.CUDA}
    if not by:
        raise AssertionError("torch.profiler recorded no device time")
    return sum(by.values()), by


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
            elif "registers" in line or "spill" in line:
                log(f"  ptxas {name} {kernel}: {line.strip()}")
                # the wgmma kernels keep their accumulators in registers
                if "_wg<" in kernel and re.search(r"[1-9]\d* bytes spill", line):
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
        ("causal Llama train", TRAIN_BATCH, TRAIN_SEQ, TRAIN_SEQ, h, h, d, True, None),
        ("causal GPT-3 1.3B train", TRAIN_BATCH, TRAIN_SEQ, TRAIN_SEQ, 16, 16, d, True, None),
        ("ring hop diag", 1, 4096, 4096, h, h, d, True, None),
        ("ring hop full", 1, 4096, 4096, h, h, d, False, None),
        ("CP hop diag", 1, 1008, 1008, h, h, d, True, None),
        ("CP hop full", 1, 1008, 1008, h, h, d, False, None),
        ("causal sq<sk GQA", 2, 200, 520, 8, 2, d, True, None),
        ("causal d64 s1000 GQA", 2, 1000, 1000, 8, 2, 64, True, None),
        ("varlen d64 s384 GQA", 3, 384, 384, 8, 2, 64, True,
         torch.tensor([0, 130, 300], dtype=torch.int32, device=dev))]
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
        shapes=flash_fwd_times(torch, gen))

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
    shapes (d 64, 72, 256); B3b/B3c launched twice must give the same bits.
    Then times in bf16 at the main shape, and B3b/B3c's at GPT-3 1.3B's
    shape and the hop shapes (the ``shapes`` entry of their rows)."""
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
    # shapes (d 72 and 256), GPT-3 1.3B's shape, the ring's two hop shapes
    # at cp 4 (a "diag" hop is causal, a "full" one is not) and a ragged d 64
    # GQA case; two launches of the kernels must agree bit for bit
    cases = [("causal 7B", b, s, h, h, d, True), ("causal 70B GQA", 1, s, 64, 8, d, True),
             ("causal d72 s300", 2, 300, 4, 2, 72, True),
             ("causal d256 s200", 1, 200, 2, 1, 256, True),
             ("causal GPT-3 1.3B", b, s, 16, 16, d, True),
             ("ring hop diag", 1, 4096, h, h, d, True),
             ("ring hop full", 1, 4096, h, h, d, False),
             ("causal d64 s1000 GQA", 2, 1000, 8, 2, 64, True)]
    timed = {}  # bf16 inputs of the shapes timed below
    for label, bb, sq, hq, hkv, hd, causal in cases:
        for dtype in (torch.float32, torch.bfloat16):
            q = randn(bb, sq, hq, hd, dtype=dtype)
            k, v = randn(bb, sq, hkv, hd, dtype=dtype), randn(bb, sq, hkv, hd, dtype=dtype)
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
            log(f"parity flash bwd {label} {dtype} q{list(q.shape)} kv{hkv}"
                f"{'' if causal else ' full'}: max_abs_err dq {errs[0]:.3g} dk {errs[1]:.3g} "
                f"dv {errs[2]:.3g}; two launches bit-equal")
            if dtype == torch.bfloat16 and label in ("causal 7B", "causal GPT-3 1.3B",
                                                     "ring hop diag", "ring hop full"):
                timed[label] = (q, k, v, out, lse, do, causal, errs)
            del q, k, v, out, lse, do, got, again, want
            torch.cuda.empty_cache()

    def bounds(q, causal):
        """(bound ms, bound by) of B3b and of B3c on q's shape."""
        bb, sq, hq, hd = q.shape
        pairs = bb * hq * sq * (sq + 1) // 2 if causal else bb * hq * sq * sq
        io, lse_bytes = q.numel() * q.element_size(), bb * hq * sq * 4
        # B3b: q k v out dout in, dq out, lse in, delta out; 3 products a pair.
        # B3c: q k v dout lse delta in, dk dv out; 4 products a pair.
        return [bound_ms(nbytes, products * 2 * hd * pairs, BF16_FLOPS)
                for nbytes, products in ((5 * io + 2 * lse_bytes, 3),
                                         (6 * io + 2 * lse_bytes, 4))]

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
    for name, (b_ms, b_by), err, fn in zip(names, bounds(q, True), (errs[0], max(errs[1:])),
                                            kernel_fns(q, k, v, out, lse, do, True)):
        rows[name] = dict(max_abs_err=err, ms=time_ms(torch, fn, iters=5, repeats=3),
                          plain_ms=plain, bound_ms=b_ms, bound_by=b_by, library_ms=library,
                          shapes={})
    # the same kernels at GPT-3 1.3B's training shape and the ring's hop shapes
    for label, (q, k, v, out, lse, do, causal, _) in timed.items():
        shape = f"{list(q.shape)} {'causal' if causal else 'full'}"
        for name, (b_ms, b_by), fn in zip(names, bounds(q, causal),
                                          kernel_fns(q, k, v, out, lse, do, causal)):
            ms = time_ms(torch, fn, iters=5, repeats=3)
            rows[name]["shapes"][shape] = dict(ms=ms, bound_ms=b_ms, bound_by=b_by)
            log(f"time {name} {label} {shape} bf16: kernel {ms:.4f} ms, bound {b_ms:.4f} ms "
                f"({b_by})")
    del timed, q, k, v, out, lse, do
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
    width, so two correct paths can part by more than the bar)."""
    (lk, gk), (lp, gp), (lf, gf) = grads_against_f32(torch, make, 2, on, gate_ids,
                                                     gate_labels)
    r_loss = abs(float(lk) - float(lp)) / abs(float(lp))
    rows = sorted(((rel_l2(gk[n], gp[n]), rel_l2(gk[n], gf[n]), rel_l2(gp[n], gf[n]), n)
                   for n in gf), reverse=True)
    log(f"train {make.__name__[5:]} 2-layer 1x{TRAIN_SEQ}: loss kernels {float(lk):.5f} "
        f"plain {float(lp):.5f} f32 {float(lf):.5f} (kernels vs plain {r_loss:.3g}); grad "
        f"relative L2, worst three kernels vs plain (kernels to f32, plain to f32): "
        + "; ".join(f"{n} {kp:.4g} ({kf:.4g}, {pf:.4g})" for kp, kf, pf, n in rows[:3]))
    bad = [r for r in rows if r[0] > LOGITS_REL_TOL and r[1] > r[2]]
    if r_loss > LOGITS_REL_TOL or bad:
        raise AssertionError(f"2-layer gate: loss {r_loss}; grads {bad}")


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

    gc.collect()  # an earlier phase's models in reference cycles would count in the peak
    model = make(layers)
    cfg, label = model.config, f"{make.__name__[5:]} {flags}"
    n_params, n_tensors = model.num_params(), len(list(model.parameters()))
    opt = AdamW(1e-4, parameters=model.parameters(), grad_clip=ClipGradByGlobalNorm(1.0))
    model, opt = ptt.amp.decorate(model, opt, level="O2", dtype="bfloat16")
    step = TrainStep(model, lambda m, x, y: m(x, labels=y)[0], opt)
    with ptt.flag_guard(**flags):
        losses = [float(step(ids, labels)) for _ in range(TRAIN_WARMUP)]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        t0 = time.perf_counter()
        out = [step(ids, labels) for _ in range(TRAIN_STEPS)]
        torch.cuda.synchronize()
        took = time.perf_counter() - t0
        launches = dict(LAUNCHES)
        peak = torch.cuda.max_memory_allocated()
        losses += [float(x) for x in out]
        log(f"train {label} losses: {' '.join(f'{x:.4f}' for x in losses)}")
        if not (all(np.isfinite(losses)) and losses[-1] < losses[0]):
            raise AssertionError(f"training {label}: losses not finite and falling: {losses}")
        L = layers
        on = {k: bool(ptt.get_flags(k)[k])
              for k in ("use_fused_swiglu", "use_fused_adamw", "use_fused_layernorm")}
        per_step = dict.fromkeys(LAUNCHES, 0)
        per_step.update(flash_attention=L, flash_attention_bwd_dq=L, flash_attention_bwd_dkv=L,
                        adamw=n_tensors if on["use_fused_adamw"] else 0)
        if make is make_llama:
            per_step.update(rms_norm=2 * L + 1, rope=L, rms_norm_bwd=2 * L + 1, rope_bwd=L,
                            swiglu=L if on["use_fused_swiglu"] else 0,
                            swiglu_bwd=L if on["use_fused_swiglu"] else 0)
        else:
            per_step.update(add_layer_norm=L if on["use_fused_layernorm"] else 0,
                            add_layer_norm_bwd=L if on["use_fused_layernorm"] else 0)
        want = {k: TRAIN_STEPS * v for k, v in per_step.items()}
        log(f"train {label} launches in {TRAIN_STEPS} steps: {launches}")
        if launches != want:
            raise AssertionError(f"training {label}: launches {launches}, {TRAIN_STEPS} "
                                 f"steps of {L} layers launch {want}")
        tokens = TRAIN_BATCH * TRAIN_SEQ
        flops = 6 * n_params * tokens + L * 7 * TRAIN_BATCH * cfg.num_attention_heads \
            * TRAIN_SEQ ** 2 * cfg.head_dim
        step_s = took / TRAIN_STEPS
        log(f"train {label} throughput on {card}: {tokens / step_s:.1f} tokens/s, "
            f"{step_s * 1e3:.1f} ms a step ({n_params / 1e9:.3f} B params in {n_tensors} "
            f"tensors, {L} layers, {TRAIN_BATCH}x{TRAIN_SEQ}), MFU "
            f"{flops / step_s / BF16_FLOPS:.4f} of {flops / 1e12:.2f} TFLOP a step at 989 "
            f"TFLOP/s; peak memory {peak / 2**30:.2f} GiB")
        profile_step(torch, f"train step {label}", lambda: step(ids, labels))
    del model, opt, step
    return launches, losses, step_s * 1e3


def profile_step(torch, label, fn):
    """Device time by kernel and the device's idle share over one call of
    ``fn``, from ``torch.profiler`` (whose own host cost inflates the wall
    time and so the idle share)."""
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
import json, sys, time
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
watchdog.stop()
if not unchanged:
    raise AssertionError("an AVG over one rank changed the gradients")
json.dump(dict(backend=backend, world_size=env.world_size, rank=env.rank,
               losses=losses, step_ms=step_ms, launches=launches,
               buckets=len(buckets), tensors=len(grads), bucket_bytes=nbytes,
               dtypes=sorted({str(g.dtype) for g in grads}), sync_ms=sync_ms,
               lone_bytes=flat.numel() * flat.element_size(), lone_ms=lone_ms,
               watchdog_fired=len(fired), unchanged=unchanged),
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
    at full depth, every stream on f32 pages equal to ``tp=1``'s; there
    and in bf16 at 2 layers on every page type, every logit that chose a
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

    model = make(L, torch.float32)
    for kind in TP_KINDS:
        (s1, n1, lg1, t1), (s2, n2, lg2, t2) = (
            tp_serve(torch, model, tp, kind, prompts, T, record=True) for tp in (1, TP))
        check(f"tp 1 f32 {kind}", n1, 1, L)
        check(f"tp {TP} f32 {kind}", n2, TP, L)
        worst, exact, notes = tp_streams(torch, f"tp f32 {kind}", s2, s1, lg2, lg1, T)
        log(f"tp (a) f32 weights, {L} layers, {kind} pages: {exact} of {len(prompts)} tp={TP} "
            f"streams token-exact against tp=1 ({T} tokens each); worst relative L2 of the "
            f"logits {worst:.4g}; runs {t1:.2f} s (tp=1) and {t2:.2f} s (tp={TP})"
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
}

# B10 has no kernel of its own: its launches are the B3 launches of its hops
# on the CP path (every B3 launch there is a ring hop, each followed by one
# merge; ``cp_launches`` holds the two counts equal)
HOPS_OF = {"ring_flash_attention": "flash_attention"}


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
    launches["gpt_train"] = phase_gpt_train(torch, card)
    torch.cuda.empty_cache()
    phase_gpt_generate(torch, card)
    gc.collect()         # the launcher's worker needs the memory this process cached
    torch.cuda.empty_cache()
    phase_dist(torch, card, train)
    gc.collect()
    torch.cuda.empty_cache()
    phase_tp(torch, card)
    kernels = []
    for name, (src, replaces, path) in SOURCES.items():
        n = launches[path][HOPS_OF.get(name, name)]
        if n == 0:
            raise AssertionError(f"{name}: never launched on the {path} path")
        kernels.append(dict(name=name, route="cuda", source=src, replaces=replaces,
                            launches=n, **rows[name]))
    print(json.dumps({"kernels": kernels}))
    print(f"card (name, power limit): {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
