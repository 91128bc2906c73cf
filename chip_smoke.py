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
   16384 tokens (``flash_fwd_times``);
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
   (``phase_engine_cp``);
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
   128, 8 new tokens, with its flash and decode launches counted.

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
    steps with the two fused flags off, timed for comparison."""
    ids, labels = train_batch(torch, 32000)
    gate_shallow(torch, make_llama, LLAMA_ON, ids[:1], labels[:1])
    gate_deep(torch, make_llama, TRAIN_LAYERS, LLAMA_ON, ids[:1], labels[:1])
    torch.cuda.empty_cache()
    launches = train_steps(torch, card, make_llama, TRAIN_LAYERS, LLAMA_ON, ids, labels)
    torch.cuda.empty_cache()
    train_steps(torch, card, make_llama, TRAIN_LAYERS,
                dict(use_fused_swiglu=False, use_fused_adamw=False), ids, labels)
    return launches


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
    launches = train_steps(torch, card, make_gpt, L, GPT_ON, ids, labels)
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
    steps against what the model's path needs and returns them."""
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
    return launches


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
    torch.cuda.empty_cache()
    launches["train"] = phase_train(torch, card)
    torch.cuda.empty_cache()
    launches["gpt_train"] = phase_gpt_train(torch, card)
    torch.cuda.empty_cache()
    phase_gpt_generate(torch, card)
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
