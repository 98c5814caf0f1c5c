#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (tokenhawk_tpu_torch) once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its own lines; any failure raises and exits non-zero:
  1. versions, the card's name and power limit, the kernel build (one nvcc
     per source, all started together);
  2. each CUDA kernel against its plain PyTorch version at LLaMA-7B shapes
     (max error against the stated tolerance, median CUDA-event times, the
     bound from the bytes and operations of the call, and the time of one
     PyTorch call computing the same function where there is one); the
     paged kernels in both pool layouts;
  3. slice check: a 2-layer LLaMA-7B-width Q4_0 model, prefill of 16
     tokens + 8 decode steps on the GPU (kernels) and on the CPU (plain
     versions, same parameters), logits compared at every step, over a
     bf16 cache and over an int8 one; then the paged forward against the
     dense one on the GPU, 8 decode steps across a page boundary, bf16
     pages against the bf16 cache and int8 pages against the int8 cache;
  4. serve: the full 32-layer 7B Q4_0 model, Engine.generate on 3 prompts,
     and the launch count of every kernel over that run;
  4b. paged serve: the same model under PagedScheduler (max_batch 8, n_ctx
     2048, 128-token pages, prefix cache, prefill chunks of 512), 12 mixed
     greedy/sampled requests, 4 sharing a 384-token prefix and one of 1500
     tokens; launch counts of every kernel, page accounting, decode tok/s,
     and the device's idle share under the profiler;
  4c. HTTP: serve() over that scheduler, 4 concurrent SSE streams and one
     /v1/completions, then `python -m tokenhawk_tpu_torch.serving`, dense,
     --paged and --paged --kv int8, on the 2-layer file of phase 5
     answering one request;
  4i. int8 KV, on the 7B's first 8 layers (its widths): Engine(cache_dtype=
     "auto") at n_ctx 2048 (it picks int8),
     prompts of 5, 300 and 1500 tokens, 64 new tokens each, decode tok/s;
     kernels 8 and 9 launched, 3 and 4 not; then profiled decode windows
     at 1500 live tokens, int8 against bf16 K/V in turns (idle share);
  4bi. phase 4b's requests on int8 pages (the bf16 pool freed first):
     kernels 10-12 launched, kernels 3 and 5-7 not;
  5. CLI: a 2-layer 7B-width ggjt Q4_0 file through tokenhawk_tpu_torch.cli,
     bf16 KV and --kv auto at n_ctx 2048 (kernel 8 instead of kernel 3);
  6. GGUF weight kinds: a Llama-3-8B-width model (16 of its 32 layers
     since phase 11 was added) in llama.cpp's
     Q4_K_M mix (random codes from a seed), Engine.generate at n_ctx 2048
     (prompts of 5, 300, 1500 tokens), then phase 4b's requests through
     the PagedScheduler; kernels 13 and 2 launched, kernel 1 not;
  6q. the 32-layer LLaMA-7B model in Q8_0 through Engine.generate;
  7. a 2-layer Llama-3-8B-width Q4_K_M GGUF file with a byte-level BPE
     vocab of 128256 tokens: load_model, the CLI (--kv auto; since phase
     10 was added the CLI's bf16 run is phase 5's alone, a load of this
     file taking 35-50 s), and `python -m tokenhawk_tpu_torch.serving --paged` (SSE, one chat
     request through the file's template, a request that stops on
     <|eot_id|>);
  8. dense weights: the 32-layer LLaMA-7B in bf16 (TokenHawk's f16
     config) through Engine at n_ctx 512, prompts of 5 and 300 tokens:
     kernel 14 (decode attention without append, behind an index copy)
     and kernel 4 launched, kernels 1, 2 and 3 not; tok/s against the
     weight-bytes roofline, the idle share of a profiled request;
  9. speculation: 9a SpeculativeEngine, the 7B Q4_0 target (its first 8
     layers since phase 11 was added) with a 22-layer TinyLlama-width bf16
     draft (kernel 14 at 4 KV heads of 64, 8 queries each), gamma 4, each
     stream held against the Engine's greedy stream; 9b a 2-layer
     self-draft (acceptance >= 90%); 9c the PagedScheduler with the draft
     (12 requests, half sampled); 9d the CLI and `serving --paged` with
     --draft-model as subprocesses (a TinyLlama-width F16 GGUF draft).
     Phases 8 and 9 run after phase 5.
  10. the reference's fused decode-layer kernels, off by default
     (THAWK_FUSED_OWO, THAWK_FUSED_ATTN) and set here on the built model:
     10a the LLaMA-7B Q4_0 Engine (its first 16 layers since phase 11 was
     added, 8 since phase 12) with neither, OWO (kernel 15),
     ATTN (kernel 16) and both, in turns: exact launches per decode token
     (kernel 3 and Wo's kernel-1 launches gone under ATTN, kernel 2 under
     OWO alone), tok/s and the idle share of each, each fused greedy
     stream held to the unfused one up to near-ties and in float32; 10b
     phase 4b's paged server with OWO (kernel 15 at 8 rows); 10c a
     TinyLlama-width Q4_0 model (22 layers, head dim 64) under the
     PagedScheduler on bf16 and int8 pages (kernels 5-7 and 10-12 at Dh
     64), then `serving --paged` (bf16, int8 pages) on phase 9d's F16 GGUF
     file.  Phase 10 runs after phase 9.
  11. the Q4_K super-block forms (THAWK_Q4K_SB=1), after phase 7: 11a
     phase 6's model (at 16 layers since phase 12, as phase 6's), drawn in
     them, through Engine (kernel 17 and
     kernel 2 with an sb w13 launched, kernel 13 only for the Q6_K weights
     and the flat w2), B=1 decode windows against the flat form of the same
     codes in turns, and phase 4b's requests through the PagedScheduler;
     11b phase 7's file loaded with the flag at float32 sides, its greedy
     stream held against the flat form's, the CLI and `serving --paged`
     with the flag; 11c runtime/eval.py's perplexity of that file, sb
     against flat, at float32 and bfloat16 sides.
  12. context parallelism (parallel/): 12a, after phase 2, kernels 18
     (decode partials) and 19 (ring-attention step) against their plain
     versions at the 7B's heads, kernel 19 at T=512 on one shard and over
     2 and 4 cyclic shards (every query shard against every KV shard,
     merged), kernel 18 at B=1 over 512, 2048 and 3 live tokens on one
     shard and on 4 cyclic shards (strided views of the cache; at 3 tokens
     one shard is empty), each merged result held against kernel 4 or 14
     on the unsplit cache; then kernel 18 cut into 1, 4, 8 and 16 splits
     at TinyLlama's heads beside kernel 14 (B=1 at 2048, B=8 ragged);
     12b, after phase 10, the 32-layer 7B Q4_0 model through
     Engine(parallel="cp") over a world-1 NCCL group at n_ctx 2048
     (prompts of 5, 300 and 1500 tokens, 32 greedy tokens each): kernels
     1, 18 and 19 launched, 2, 3, 4 and 14 not; each stream held against
     the dense Engine's up to near-ties; tok/s beside the dense Engine's,
     the idle share of a profiled request.  One H100 runs CP at one
     rank only; the shard merges of 12a stand in for more.
  13. the bench and the last three kernels, after phase 11 (every earlier
     model freed): 13a kernel 20 (the HBM stream probe) against its plain
     version on a 2 GiB array, timed beside torch.sum, the probe's GB/s
     before and after (each at most 105% of the card's spec); 13b the
     bench on the 32-layer LLaMA-7B Q4_0 (its own synthetic weights, each
     layer its own buffers): decode (B=1, ctx 512, 128 tokens) and serve
     (B=8, 16 requests, 64 tokens) in this process, ttft as `python -m
     tokenhawk_tpu_torch.bench`; each JSON line checked, its probe
     readings and roofline shares at most 105%, kernel 20's 336 launches
     in the decode run; 13c kernel 21 (experiments/dequant_exp.py's three
     dequant variants) against its plain versions and timed over 8 weight
     sets, then the script; kernel 22 (experiments/sm90_probe.py) through
     the script (all seven probes ok), each probe against its plain
     version, and the int8 tensor-core product on random codes.
The entry points a phase runs as subprocesses (CLI, servers) run side by
side, as their loads are host work.
Phase 2 also holds kernel 17 (Q4_K super-blocks) beside kernel 13 over the
flat form of the same codes, kernel 2 with an sb w13, kernel 13
(group-code matmul) and kernel 2 over the
GGUF kinds at those models' shapes, kernels 3-12 at Llama-3-8B's 8 KV
heads of 4 queries each, kernel 14 at the 7B's and TinyLlama's heads,
kernels 3-12 at TinyLlama's head dim 64 (8 queries a KV head), and
kernels 15 and 16 at the 7B's widths in Q4_0 and Q8_0, each beside the
unfused port kernels it replaces; phase 3 also runs a 2-layer Q4_K_M
slice.  Each phase's header line ends with the seconds since the start.
The next-to-last line is {"kernels": [...]}, the last {"ok": true, ...}.
It needs one CUDA device and the rest of the repository beside it.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import socket
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

import numpy as np

SEED = 1234
S_CTX = 512
# bfloat16 outputs: the kernels and their plain versions both accumulate in
# f32 and round once, so they differ by about one bfloat16 rounding
# (at most 2^-8 of an element); the tolerance is 2^-7 of the largest |reference|.
KERNEL_TOL = 2.0**-7
# Logits of the slice after 2 layers of bfloat16 activations, kernels vs
# plain: rounding flips of intermediate bfloat16 values propagate; 5% of
# the largest |logit| bounds them while a wrong kernel is off by O(1).
SLICE_TOL = 5e-2
# The speculative verify (kernel 4 over gamma+1 rows) against the Engine's
# decode (kernel 3 at one row) with float32 activations and cache: one
# function summed in other orders, about 1e-6 of the largest |logit|
# through 32 layers; 1e-4 leaves a margin and sits far below the bfloat16
# spread (a few %).
F32_FORMS_TOL = 1e-4
# Logits after 32 layers of bfloat16 activations from two correct forms of
# one function, the fused decode-layer kernels against the unfused path:
# the roundings they do not share (x' and the context kept in f32, the
# query's scale rounded to bf16 as the reference's wrapper rounds it) move
# them 4-6% of the largest |logit| apart (on an H100: 4.398% with kernel
# 15, 5.196% with kernel 16; phase 9a's two forms 3.971%), while a wrong
# kernel is off by O(1).  Phase 10a's float32 witness holds the same
# forms within F32_FORMS_TOL, which is the decisive check.
DEEP_BF16_TOL = 0.1
# Softmax partials (kernels 18, 19) against their plain versions, and
# merged shards against the unsplit float32 kernel: f32 sums in other
# orders, 1e-4 of the largest |value| (tests/test_torch_cuda.py's rule).
PARTIALS_TOL = 1e-4
# The card's peaks (NVIDIA H100 SXM data sheet, 700 W): HBM bytes/s and
# dense bf16 tensor-core FLOP/s.  A kernel's bound is the larger of its
# bytes (each input read once, each output written once) over the first
# and its operations over the second.
HBM_BPS = 3.35e12
PEAK_FLOPS = 989e12
# Paged-kernel shapes of phase 2: LLaMA-7B heads, 128-token pages, a
# serve batch of 8 with ragged lengths up to n_ctx 2048.
PAGED_LENGTHS = [1, 37, 128, 129, 300, 700, 1500, 2048]
PAGED_PS, PAGED_POOL = 128, 140
# Context of the int8 phases: the CLI's default --n-ctx, where --kv auto
# picks the int8 cache.  Phases 4i and 4bi run the 7B's first 8 layers
# (its widths, kernels 8-12 at the same shapes) to keep the script's run
# inside its time after phases 8 and 9 were added.
INT8_CTX = 2048
INT8_LAYERS = 8
# Phase 9 runs the 7B target's first 8 layers (its widths; 16 from phase
# 10's addition, 8 since phase 11's), and phase 10a the 7B's first 8 (32
# before phase 11, 16 before phase 12), to keep the script's run inside
# its time.
SPEC_LAYERS = 8
FUSED_LAYERS = 8
# Phases 6 and 11a run 16 of the Q4_K_M model's 32 layers (11a all 32
# before phase 12), its flat form included in 11a's decode windows.
Q4KM_LAYERS = 16
# Kernel 2's launch counts by weight-form pairing (ops/cuda/ffn.py): Q4_0
# over Q4_0; Q4_K (G 32 with mins) over Q6_K (G 16) and over Q4_K, the
# two of a Q4_K_M file; Q8_0 (G 32) over Q8_0.
FFN_Q4_0 = "ffn[q4_0/q4_0]"
FFN_Q4_K_M = ["ffn[g32m/g16]", "ffn[g32m/g32m]"]
FFN_Q8_0 = "ffn[g32/g32]"
# The same two with a Q4_K super-block w13 (THAWK_Q4K_SB=1's forms).
FFN_SB = ["ffn[sb/g16]", "ffn[sb/g32m]"]


_T0 = time.perf_counter()


def log(msg: str = "") -> None:
    """Print a line; a phase's header line gets the seconds since start."""
    if msg.startswith("== "):
        msg += f" [{time.perf_counter() - _T0:.0f} s]"
    print(msg, flush=True)


def cuda_ms(fns, calls: int = 32, trials: int = 5, sleep_ms: float = 0.0) -> float:
    """Median over trials of the mean time of one call, from CUDA events
    around `calls` back-to-back calls cycling through `fns`.  Each entry of
    `fns` reads its own copy of the weights or cache (see `copies`), so a
    call finds its operands cold in L2, as a layer of the model does.

    With sleep_ms > 0 the stream first spins that long on the device, so
    the host has queued every call before the first event fires and the
    events measure device time alone (kernels plus the gaps between them);
    without it they measure one call as the host issues it."""
    import torch

    for f in fns:
        f()
    torch.cuda.synchronize()
    cycles = int(sleep_ms * 2.0e6)  # H100 SM clock <= 1.98 GHz: >= sleep_ms
    times = []
    for _ in range(trials):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        if cycles:
            torch.cuda._sleep(cycles)
        a.record()
        for i in range(calls):
            fns[i % len(fns)]()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / calls)
    return float(np.median(times))


def timed(fns, calls: int = 32) -> dict:
    """ms: device time of one call (sleep-fronted events); call_ms: the
    time of one call as the host issues it back to back."""
    call = cuda_ms(fns, calls)
    # The host issues a call in well under 0.5 ms; spin twice that per call.
    return {"ms": cuda_ms(fns, calls, sleep_ms=2 * calls * min(call, 0.5) + 2),
            "call_ms": call}


def copies(tensors, nbytes: int) -> list:
    """Enough clones of `tensors` to span 3x the 50 MB L2 cache."""
    n = min(16, max(1, -(-150_000_000 // nbytes)))
    return [tensors] + [[x.clone() for x in tensors] for _ in range(n - 1)]


def max_err(out, ref, frac: float = KERNEL_TOL) -> tuple:
    d = (out.float() - ref.float()).abs().max().item()
    return d, frac * ref.float().abs().max().item()


def bound(nbytes: float, flops: float, layout_nbytes: float | None = None,
          peak: float = PEAK_FLOPS) -> dict:
    """The least time the card could take for a call (see HBM_BPS), its
    operations at `peak` per second.  For weights whose GGML blocks the
    port stores wider, nbytes counts the blocks and layout_nbytes the
    port's layout (layout_bound_ms)."""
    t_bytes, t_ops = nbytes / HBM_BPS * 1e3, flops / peak * 1e3
    out = {"bound_ms": max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
    if layout_nbytes is not None:
        out["layout_bound_ms"] = max(layout_nbytes / HBM_BPS * 1e3, t_ops)
    return out


def _ggml_bytes(kind: str, k: int, n: int) -> int:
    """Bytes of a [k, n] weight of GGML kind `kind` ("q4_k", "q6_k",
    "q8_0") in a GGUF file's blocks."""
    from tokenhawk_tpu_torch.ggml.format import GGMLType
    from tokenhawk_tpu_torch.ggml.gguf import gguf_tensor_nbytes

    return gguf_tensor_nbytes(GGMLType[kind.upper()], k * n)


def phase_env() -> None:
    import torch

    from tokenhawk_tpu_torch.ops.cuda import build

    log("== phase 1: environment and build")
    log(f"python {sys.version.split()[0]}  torch {torch.__version__}  cuda {torch.version.cuda}")
    nv = subprocess.run([build.nvcc(), "--version"], capture_output=True, text=True, check=True)
    log("nvcc: " + nv.stdout.strip().splitlines()[-1])
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True)
    log(smi.stdout.strip().splitlines()[0])
    t0 = time.perf_counter()
    build.library()
    log(f"kernels built and loaded in {time.perf_counter() - t0:.1f} s: {build.library_path().name}")
    text = (build.BUILD_DIR / "build.log").read_text()
    regs = [int(w.split()[0]) for w in text.split("Used ")[1:]]
    spills = [ln.strip() for ln in text.splitlines()
              if "spill" in ln and not ln.strip().startswith("0 bytes stack frame, 0 bytes spill")]
    log(f"ptxas: {len(regs)} kernels, {min(regs)}-{max(regs)} registers, "
        f"spills: {spills or 'none'}")


def phase_kernels() -> list:
    import torch
    import torch.nn.functional as tf

    from tokenhawk_tpu_torch.ops.cuda import (
        ffn,
        flash_attention,
        flash_decode,
        paged_decode,
        qmatmul,
    )
    from tokenhawk_tpu_torch.ops.qweight import QWeight

    log("== phase 2: kernels against their plain versions (7B shapes, bfloat16)")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(SEED)

    def randn(*shape, scale=1.0, dtype=torch.bfloat16):
        return (torch.randn(shape, generator=g, device=dev) * scale).to(dtype)

    def qweight(k, n):
        return QWeight.quantize(randn(k, n, scale=0.02, dtype=torch.float32))

    def case(cases, label, shape, rows, out, ref, kernel_fns=None, plain_fns=None,
             frac=KERNEL_TOL, calls=32):
        """Check one shape against the tolerance, time both versions
        (given no functions to time, only check)."""
        err, tol = max_err(out, ref, frac)
        if kernel_fns is None:
            log(f"{label}: max_abs_err {err:.3e} (tol {tol:.3e})")
            if not err <= tol:
                raise AssertionError(f"{label}: {err} > {tol}")
            cases.append(dict(shape=shape, rows=rows, max_abs_err=err, tol=tol))
            return
        kt, pt = timed(kernel_fns, calls), timed(plain_fns, calls)
        log(f"{label}: max_abs_err {err:.3e} (tol {tol:.3e})  kernel {kt['ms']:.4f} ms "
            f"[per call {kt['call_ms']:.4f}]  plain {pt['ms']:.4f} ms [per call {pt['call_ms']:.4f}]")
        if not err <= tol:
            raise AssertionError(f"{label}: {err} > {tol}")
        cases.append(dict(shape=shape, rows=rows, max_abs_err=err, tol=tol, ms=kt["ms"],
                          plain_ms=pt["ms"], call_ms=kt["call_ms"],
                          plain_call_ms=pt["call_ms"]))

    def library(label, fns) -> float:
        ms = timed(fns)["ms"]
        log(f"  library call {label}: {ms:.4f} ms")
        return ms

    records = []
    bf = 2  # bytes of a bfloat16 value

    # -- kernel 1: every projection of the path, decode and prefill rows --
    cases = []
    shapes = [("wqkv", 4096, 12288, True), ("wo", 4096, 4096, False),
              ("w13", 4096, 22016, True), ("w2", 11008, 4096, False),
              ("output", 4096, 32000, True)]
    for name, K, N, norm in shapes:
        w = qweight(K, N)
        ws = [QWeight(*c) for c in copies([w.qs, w.scales], w.nbytes)]
        gain = 1.0 + randn(K, scale=0.1) if norm else None
        for rows in (1, 64, 512):
            x = randn(rows, K)
            case(cases, f"q4_matmul {name} K={K} N={N} rows={rows} norm={norm}", name, rows,
                 qmatmul.quant_matmul(x, w, gain), qmatmul.quant_matmul_plain(x, w, gain),
                 [lambda w=w: qmatmul.quant_matmul(x, w, gain) for w in ws],
                 [lambda w=w: qmatmul.quant_matmul_plain(x, w, gain) for w in ws])
            if name == "wqkv" and rows == 1:
                lib = library("dequantize (f32 torch ops, then bf16) + torch.matmul, no norm "
                              "(2+ calls)", [lambda w=w: x @ w.dequantize(torch.bfloat16)
                                             for w in ws])
        del w, ws
    # The timed case: wqkv, one row, norm fused.  A ggjt Q4_0 block holds 32
    # weights in 20 bytes (f32 scale), as the port's layout does: 0.625 B each.
    K, N = 4096, 12288
    records.append(_record("q4_matmul", "tokenhawk_tpu_torch/csrc/qmatmul.cu",
                           "tokenhawk_tpu/ops/pallas/qmatmul.py:807 (q4_matmul); "
                           "qmatmul.py:874 (q4_matmul_i4)", cases, ("wqkv", 1),
                           bound(K * N * 0.625 + 2 * K * bf + N * bf, 2 * K * N), lib))

    # -- kernel 2: the decode FFN --
    cases = []
    D, F = 4096, 11008
    w13, w2 = qweight(D, 2 * F), qweight(F, D)
    sets = [(QWeight(a, b), QWeight(c, d)) for a, b, c, d in
            copies([w13.qs, w13.scales, w2.qs, w2.scales], w13.nbytes + w2.nbytes)]
    gain = 1.0 + randn(D, scale=0.1)
    for rows in (1, 8):
        x = randn(rows, D)
        case(cases, f"fused_ffn D={D} F={F} rows={rows}", "ffn", rows,
             ffn.fused_ffn(x, w13, w2, gain), ffn.fused_ffn_plain(x, w13, w2, gain),
             [lambda s=s: ffn.fused_ffn(x, *s, gain) for s in sets],
             [lambda s=s: ffn.fused_ffn_plain(x, *s, gain) for s in sets])
        if rows == 1:
            lib = library("rms_norm + dequantize w13 and w2 + 2 torch.matmul + silu, bf16 "
                          "(10+ calls)", [lambda s=s: _ffn_library(x, *s, gain) for s in sets])
    del w13, w2, sets
    records.append(_record("fused_ffn", "tokenhawk_tpu_torch/csrc/ffn.cu",
                           "tokenhawk_tpu/ops/pallas/ffn.py:270 (_fused_ffn via fused_ffn)",
                           cases, ("ffn", 1),
                           bound(3 * D * F * 0.625 + 3 * D * bf, 6 * D * F), lib))

    # -- kernel 3: decode append + attend; lengths in one batch, then timed at B=1 --
    cases = []
    Hkv, Dh = 32, 128
    for lens in ([1, 37, 300, 512], [37], [512]):
        B = len(lens)
        q = randn(B, Hkv, 1, Dh, scale=Dh**-0.5)
        kn, vn = randn(B, Hkv, Dh), randn(B, Hkv, Dh)
        kc, vc = randn(B, Hkv, S_CTX, Dh), randn(B, Hkv, S_CTX, Dh)
        kp, vp = kc.clone(), vc.clone()
        lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
        out = flash_decode.flash_decode_append(q, kn, vn, kc, vc, lengths)
        ref = flash_decode.flash_decode_append_plain(q, kn, vn, kp, vp, lengths)
        if not (torch.equal(kc, kp) and torch.equal(vc, vp)):
            raise AssertionError(f"flash_decode_append {lens}: caches differ from the plain's")
        caches = copies([kc, vc], 2 * kc.nbytes)
        case(cases, f"flash_decode_append B={B} lengths={lens} S={S_CTX} (caches identical)",
             f"B={B} L={lens[-1]}", B, out, ref,
             [lambda c=c: flash_decode.flash_decode_append(q, kn, vn, *c, lengths)
              for c in caches],
             [lambda c=c: flash_decode.flash_decode_append_plain(q, kn, vn, *c, lengths)
              for c in caches])
    # The timed case is the last (B=1, 512 live tokens); the library call
    # attends over the same live rows (without the append).
    L = S_CTX
    lib = library("scaled_dot_product_attention, B=1, 512 keys",
                  [lambda c=c: tf.scaled_dot_product_attention(
                      q, c[0][:, :, :L], c[1][:, :, :L], scale=1.0)
                   for c in caches])
    records.append(_record("flash_decode_append", "tokenhawk_tpu_torch/csrc/flash_decode.cu",
                           "tokenhawk_tpu/ops/pallas/flash_decode_dma.py:1112 "
                           "(flash_decode_append_walk); flash_decode_dma.py:1218 "
                           "(flash_decode_append)", cases, ("B=1 L=512", 1),
                           bound((2 * L + 6) * Hkv * Dh * bf, 4 * L * Hkv * Dh), lib))

    # -- kernel 4: prefill attention --
    cases = []
    kc, vc = randn(1, Hkv, S_CTX, Dh), randn(1, Hkv, S_CTX, Dh)
    caches = copies([kc, vc], 2 * kc.nbytes)
    for T, off in ((64, 0), (16, 200), (512, 0)):
        q = randn(1, Hkv, 1, T, Dh, scale=Dh**-0.5)
        offsets = torch.tensor([off], dtype=torch.int32, device=dev)
        case(cases, f"flash_attention T={T} offset={off} S={S_CTX}", f"T={T} off={off}", T,
             flash_attention.flash_attention(q, kc, vc, offsets),
             flash_attention.flash_attention_plain(q, kc, vc, offsets),
             [lambda c=c: flash_attention.flash_attention(q, *c, offsets) for c in caches],
             [lambda c=c: flash_attention.flash_attention_plain(q, *c, offsets)
              for c in caches])
    T = 512
    lib = library("scaled_dot_product_attention, causal, T=512",
                  [lambda c=c: tf.scaled_dot_product_attention(q[:, :, 0], c[0], c[1],
                                                               is_causal=True, scale=1.0)
                   for c in caches])
    records.append(_record("flash_attention", "tokenhawk_tpu_torch/csrc/flash_attention.cu",
                           "tokenhawk_tpu/ops/pallas/flash_attention.py:139 "
                           "(flash_attention via attend_prefill)", cases, ("T=512 off=0", 512),
                           bound(4 * T * Hkv * Dh * bf, 4 * Hkv * Dh * T * (T + 1) / 2), lib))
    records += _paged_kernel_records(randn, case, library, g)
    records += _int8_kernel_records(randn, case, library)
    records += _paged_int8_kernel_records(randn, case, library, g)
    records.append(_decode_attend_record(randn, case))
    gqa = _gqa_cases(randn, case, g)
    dh64 = _head_dim_64_cases(randn, case)
    paged64 = _paged_head_dim_64_cases(randn, case, g)
    for rec in records:
        rec["cases"] += (gqa.get(rec["name"], []) + dh64.get(rec["name"], [])
                         + paged64.get(rec["name"], []))
        rec["max_abs_err"] = max(c["max_abs_err"] for c in rec["cases"])
    records += _group_code_kernel_records(randn, case, library, g)
    records += _sb_kernel_records(randn, case, library, g)
    records += _fused_layer_records(randn, case, library, g)
    records += _cp_kernel_records(randn, case)
    return records


def _partials_err(label: str, got, want) -> float:
    """Largest error of partials (o, m, l) against the plain version's, each
    within PARTIALS_TOL of its own largest |value|; infinite entries (the
    merge identity's m) must match exactly."""
    import torch

    worst = 0.0
    for name, a, b in zip("oml", got, want):
        inf = torch.isinf(b)
        if not (torch.equal(torch.isinf(a), inf) and torch.equal(a[inf], b[inf])):
            raise AssertionError(f"{label}: {name} differs at the infinite entries")
        if bool(inf.all()):  # an empty shard's m: nothing finite to compare
            continue
        err, tol = max_err(a[~inf], b[~inf], PARTIALS_TOL)
        if not err <= tol:
            raise AssertionError(f"{label}: {name} off by {err} > {tol}")
        worst = max(worst, err)
    return worst


def _merge_partials(o, m, l):
    """Normalised attention from partials stacked on dim 0 (o [n, ..., Dh],
    m, l of o's leading shape, or flattened past n as kernel 18 gives them),
    as decode_attend_cp merges its shards: the max, each
    partial weighted by exp(m - max) (0 for an empty one), the sums."""
    import torch

    m, l = m.reshape(o.shape[:-1]), l.reshape(o.shape[:-1])
    m_g = m.amax(dim=0)
    alpha = torch.where(torch.isinf(m) & (m < 0), 0.0, torch.exp(m - m_g))
    return (o * alpha[..., None]).sum(0) / (l * alpha).sum(0)[..., None]


def _cp_kernel_records(randn, case) -> list:
    """Phase 12a: kernels 18 and 19, context parallelism's softmax partials,
    at the 7B's heads (32 KV heads of 128), each against its plain version
    and, merged over 1, 2 or 4 cyclic shards, against the unsplit kernel
    (4 or 14); then kernel 18 in 1, 4, 8 and 16 splits at TinyLlama's heads
    beside kernel 14.  Each timed case has its bound, and the library call
    that gives the same partials: memory-efficient attention with its
    log-sum-exp (o = out * l, log l = lse - m)."""
    import torch

    from tokenhawk_tpu_torch.ops.cuda import flash_attention as fa
    from tokenhawk_tpu_torch.ops.cuda import flash_decode as fd
    from tokenhawk_tpu_torch.parallel.cp import _shard_count

    log("== phase 12a: kernels 18 and 19 (context parallelism's partials), 7B heads")
    dev = torch.device("cuda")
    eff = torch.ops.aten._scaled_dot_product_efficient_attention
    bf, f4 = 2, 4
    Hkv, Dh = 32, 128

    def i32(*xs):
        return torch.tensor(xs, dtype=torch.int32, device=dev)

    # -- kernel 19: one shard (stride 1), then 2 and 4 cyclic shards --
    cases = []
    T = 512
    q = randn(1, Hkv, 1, T, Dh, scale=Dh**-0.5, dtype=torch.float32)
    kc, vc = randn(1, Hkv, T, Dh), randn(1, Hkv, T, Dh)
    zero = i32(0)
    got = fa.flash_attention_stats(q, kc, vc, zero, zero, 1)
    _partials_err("flash_attention_stats T=512", got,
                  fa.flash_attention_stats_plain(q, kc, vc, zero, zero, 1))
    caches = copies([kc, vc], 2 * kc.nbytes)
    case(cases, f"flash_attention_stats (kernel 19) one shard T={T} Hkv={Hkv} Dh={Dh}, q f32, "
                f"K/V bf16", f"T={T} shards=1", T, got[0],
         fa.flash_attention_stats_plain(q, kc, vc, zero, zero, 1)[0],
         [lambda c=c: fa.flash_attention_stats(q, *c, zero, zero, 1) for c in caches],
         [lambda c=c: fa.flash_attention_stats_plain(q, *c, zero, zero, 1) for c in caches],
         frac=PARTIALS_TOL)
    b19 = bound(2 * f4 * T * Hkv * Dh + 2 * bf * T * Hkv * Dh + 2 * f4 * T * Hkv + 8,
                4 * Hkv * Dh * T * (T + 1) / 2)
    kf, vf = kc.float(), vc.float()
    lib_out = eff(q[:, :, 0], kf, vf, None, True, is_causal=True, scale=1.0)
    err = (lib_out[0] - got[0][:, :, 0] / got[2][:, :, 0, :, None]).abs().max().item()
    lib19 = timed([lambda c=c: eff(q[:, :, 0], c[0], c[1], None, True, is_causal=True, scale=1.0)
                   for c in copies([kf, vf], 2 * kf.nbytes)])["ms"]
    log(f"  bound {b19['bound_ms']:.4f} ms ({b19['bound_by']}); library call "
        f"_scaled_dot_product_efficient_attention(compute_log_sumexp, causal), f32 K/V: "
        f"{lib19:.4f} ms (its output against o / l: {err:.3e})")
    full = fa.flash_attention(q, kc, vc, zero)  # kernel 4 at an f32 q: f32 out
    for n in (2, 4):
        merged = torch.empty_like(full)
        worst = 0.0
        for i in range(n):
            qi = q[:, :, :, i::n].contiguous()
            parts = []
            for j in range(n):
                kj, vj = kc[:, :, j::n].contiguous(), vc[:, :, j::n].contiguous()
                part = fa.flash_attention_stats(qi, kj, vj, i32(i), i32(j), n)
                worst = max(worst, _partials_err(
                    f"flash_attention_stats query shard {i}, KV shard {j} of {n}", part,
                    fa.flash_attention_stats_plain(qi, kj, vj, i32(i), i32(j), n)))
                parts.append(part)
            merged[:, :, :, i::n] = _merge_partials(*(torch.stack(x) for x in zip(*parts)))
        case(cases, f"flash_attention_stats {n} cyclic shards x {n} KV shards, merged, against "
                    f"kernel 4 on the unsplit block (f32 q)", f"T={T} shards={n}", T, merged,
             full, frac=PARTIALS_TOL)
        log(f"  partials of the {n * n} shard pairs against the plain version: max_abs_err "
            f"{worst:.3e}")
    records = [_record("flash_attention_stats", "tokenhawk_tpu_torch/csrc/flash_attention.cu",
                       "tokenhawk_tpu/ops/pallas/flash_attention.py:298 (flash_attention_stats, "
                       "_kernel_stats)", cases, (f"T={T} shards=1", T), b19, lib19)]
    del kc, vc, kf, vf, caches

    # -- kernel 18: B=1 at 512, 2048 and 3 live tokens, one shard and 4 cyclic --
    cases = []
    S = 2048
    q = randn(1, Hkv, 1, Dh, scale=Dh**-0.5)
    kc, vc = randn(1, Hkv, S, Dh), randn(1, Hkv, S, Dh)
    caches = copies([kc, vc], 2 * kc.nbytes)
    lib18 = b18 = None
    for L in (512, 2048, 3):
        lengths = i32(L)
        ref = fd.flash_decode(q, kc, vc, lengths)  # kernel 14
        got = fd.flash_decode_stats(q, kc, vc, lengths)
        _partials_err(f"flash_decode_stats L={L}", got,
                      fd.flash_decode_stats_plain(q, kc, vc, lengths))
        one = _merge_partials(*got).reshape(ref.shape)
        if L == S:
            case(cases, f"flash_decode_stats (kernel 18) B=1 L={L} S={S} Hkv={Hkv} Dh={Dh}, one "
                        f"shard, o / l against kernel 14", f"B=1 L={L} shards=1", 1, one, ref,
                 [lambda c=c: fd.flash_decode_stats(q, *c, lengths) for c in caches],
                 [lambda c=c: fd.flash_decode_stats_plain(q, *c, lengths) for c in caches])
            b18 = bound(2 * L * Hkv * Dh * bf + Hkv * Dh * bf + Hkv * Dh * f4 + 2 * Hkv * f4 + 4,
                        4 * L * Hkv * Dh)
            qe = q.reshape(1, Hkv, 1, Dh)
            lib18 = timed([lambda c=c: eff(qe, c[0][:, :, :L], c[1][:, :, :L], None, True,
                                           scale=1.0) for c in caches])["ms"]
            log(f"  bound {b18['bound_ms']:.4f} ms ({b18['bound_by']}); library call "
                f"_scaled_dot_product_efficient_attention(compute_log_sumexp) over the live "
                f"rows: {lib18:.4f} ms")
        else:
            case(cases, f"flash_decode_stats B=1 L={L} one shard, o / l against kernel 14",
                 f"B=1 L={L} shards=1", 1, one, ref)
        parts = []
        for i in range(4):
            sl = _shard_count(lengths, i, 4).to(torch.int32)
            kv = (kc[:, :, i::4], vc[:, :, i::4])  # strided views
            part = fd.flash_decode_stats(q, *kv, sl)
            _partials_err(f"flash_decode_stats shard {i} of 4 (L={int(sl[0])})", part,
                          fd.flash_decode_stats_plain(q, *kv, sl))
            parts.append([x[0] for x in part])
        merged = _merge_partials(*(torch.stack(x) for x in zip(*parts))).reshape(ref.shape)
        case(cases, f"flash_decode_stats B=1 L={L} over 4 cyclic shards (lengths "
                    f"{[int(_shard_count(lengths, i, 4)[0]) for i in range(4)]}), merged, "
                    f"against kernel 14", f"B=1 L={L} shards=4", 1, merged, ref)
    del kc, vc, caches
    cases += _split_decode_cases(randn, case)
    records.append(_record("flash_decode_stats", "tokenhawk_tpu_torch/csrc/flash_decode.cu",
                           "tokenhawk_tpu/ops/pallas/flash_decode_dma.py:761 (flash_decode_stats, "
                           "_kernel_vec_stats)", cases, (f"B=1 L={S} shards=1", 1), b18, lib18))
    return records


def _split_decode_cases(randn, case) -> list:
    """Kernel 18 cut into 1, 4, 8 and 16 splits of S, merged in torch, at
    TinyLlama's heads (4 KV heads of 64, 8 queries each: the draft's) over
    2048 slots, B=1 at 2048 live and B=8 ragged, each held against kernel
    14 and timed beside it (ROADMAP.md Queue 3 open fault 2)."""
    import torch

    from tokenhawk_tpu_torch.ops.cuda import flash_decode as fd

    log("-- kernel 18 in splits of S (+ the merge) against kernel 14, 4 KV heads of 64 x 8")
    dev = torch.device("cuda")
    Hkv, rep, Dh, S = 4, 8, 64, 2048
    cases = []
    for lens in ([S], PAGED_LENGTHS):
        B = len(lens)
        q = randn(B, Hkv, rep, Dh, scale=Dh**-0.5)
        kc, vc = randn(B, Hkv, S, Dh), randn(B, Hkv, S, Dh)
        lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
        caches = copies([kc, vc], 2 * kc.nbytes)
        ref = fd.flash_decode(q, kc, vc, lengths)
        k14 = timed([lambda c=c: fd.flash_decode(q, *c, lengths) for c in caches])["ms"]
        live = sum(lens)
        b = bound(2 * live * Hkv * Dh * 2 + 2 * B * Hkv * rep * Dh * 2 + 4 * B,
                  4 * live * Hkv * rep * Dh)
        log(f"  kernel 14 B={B} lengths={lens}: {k14:.4f} ms (bound {b['bound_ms']:.4f} ms)")
        for splits in (1, 4, 8, 16):
            def run(c, splits=splits):
                return _merge_partials(*fd.flash_decode_stats(q, *c, lengths, splits))

            def plain(c, splits=splits):
                return _merge_partials(*fd.flash_decode_stats_plain(q, *c, lengths, splits))

            case(cases, f"flash_decode_stats splits={splits} + merge, B={B} lengths={lens}, "
                        f"against kernel 14 ({k14:.4f} ms)", f"dh64 B={B} splits={splits}", B,
                 run(caches[0]).to(ref.dtype), ref, [lambda c=c: run(c) for c in caches],
                 [lambda c=c: plain(c) for c in caches])
            cases[-1].update(kernel14_ms=k14, **b)
        del kc, vc, caches
    return cases


def _qweights(parts, ws) -> list:
    """QWeights like ws (a list) over the flat tensor list `parts` (each
    weight's QWeight.tensors()), as copies() makes them."""
    out, i = [], 0
    for w in ws:
        names = [f for f in ("qs", "scales", "mins", "scmn") if getattr(w, f) is not None]
        out.append(dataclasses.replace(w, **dict(zip(names, parts[i:i + len(names)]))))
        i += len(names)
    return out


def _weight_sets(ws) -> list:
    """copies() of a list of QWeights, each a list of QWeights."""
    parts = [t for w in ws for t in w.tensors()]
    return [_qweights(c, ws) for c in copies(parts, sum(w.nbytes for w in ws))]


def _fused_layer_records(randn, case, library, g) -> list:
    """Kernels 15 and 16 (the reference's env-gated fused decode-layer
    kernels) at LLaMA-7B's widths, Q4_0 and Q8_0, against their plain
    versions; each timed beside the unfused port kernels it replaces on the
    model's path (kernel 1's Wo + add + kernel 2; the q scale + kernel 3 +
    kernel 1's Wo + add) and the PyTorch calls that compute the same."""
    import torch
    import torch.nn.functional as tf

    from tokenhawk_tpu_torch.ops.cuda import ffn, flash_decode, qmatmul
    from tokenhawk_tpu_torch.ops.qweight import QWeight

    log("-- kernels 15 and 16: the fused decode-layer kernels (7B widths)")
    dev = torch.device("cuda")
    bf = 2
    D, F, H, Dh = 4096, 11008, 32, 128

    def weight(quant, k, n):
        if quant == "q4_0":
            return QWeight.quantize(randn(k, n, scale=0.02, dtype=torch.float32))
        return QWeight.random(k, n, "q8_0", g, dev)

    def unfused_ms(fns) -> float:
        ms = timed(fns)["ms"]
        log(f"  unfused port kernels: {ms:.4f} ms")
        return ms

    # -- kernel 15 --
    cases, extra = [], {}
    for quant in ("q4_0", "q8_0"):
        ws = [weight(quant, D, D), weight(quant, D, 2 * F), weight(quant, F, D)]
        sets = _weight_sets(ws)
        gain = 1.0 + randn(D, scale=0.1)
        for rows in (1, 8):
            ctx, x = randn(rows, D), randn(rows, D)
            case(cases, f"fused_owo_ffn {quant} Dq=D={D} F={F} rows={rows}", quant, rows,
                 ffn.fused_owo_ffn(ctx, x, *ws, gain), ffn.fused_owo_ffn_plain(ctx, x, *ws, gain),
                 [lambda s=s: ffn.fused_owo_ffn(ctx, x, *s, gain) for s in sets],
                 [lambda s=s: ffn.fused_owo_ffn_plain(ctx, x, *s, gain) for s in sets])
            if quant == "q4_0" and rows == 1:
                extra["owo_unfused"] = unfused_ms(
                    [lambda s=s: ffn.fused_ffn(x + qmatmul.quant_matmul(ctx, s[0]), s[1], s[2],
                                               gain) for s in sets])
                extra["owo_lib"] = library(
                    "dequantize Wo + matmul + add, then rms_norm + dequantize w13 and w2 + 2 "
                    "matmul + silu, bf16 (14+ calls)",
                    [lambda s=s: _ffn_library(x + ctx @ s[0].dequantize(torch.bfloat16), s[1],
                                              s[2], gain) for s in sets])
        del ws, sets
    owo = _record("fused_owo_ffn", "tokenhawk_tpu_torch/csrc/ffn.cu",
                  "tokenhawk_tpu/ops/pallas/ffn.py:431 (_fused_owo_ffn via fused_owo_ffn)",
                  cases, ("q4_0", 1),
                  bound((D * D + 3 * D * F) * 0.625 + 4 * D * bf, 2 * (D * D + 3 * D * F)),
                  extra["owo_lib"])
    owo["unfused_ms"] = extra["owo_unfused"]

    # -- kernel 16: B=1, one query per kv head, n_ctx 512 --
    cases = []
    S = S_CTX
    scale = 1.0 / Dh**0.5
    for quant in ("q4_0", "q8_0"):
        wo = weight(quant, D, D)
        for L in ((1, 37, S) if quant == "q4_0" else (S,)):
            q, kn, vn = (randn(1, 1, H, Dh) for _ in range(3))
            x = randn(1, 1, D)
            kc, vc = randn(1, H, S, Dh), randn(1, H, S, Dh)
            kp, vp = kc.clone(), vc.clone()
            lengths = torch.tensor([L], dtype=torch.int32, device=dev)
            out = flash_decode.fused_attn_out(x, q, kn, vn, kc, vc, lengths, wo)
            ref = flash_decode.fused_attn_out_plain(x, q, kn, vn, kp, vp, lengths, wo)
            if not (torch.equal(kc, kp) and torch.equal(vc, vp)):
                raise AssertionError(f"fused_attn_out L={L}: caches differ from the plain's")
            sets = [[c[0], c[1], *_qweights(c[2:], [wo])] for c in
                    copies([kc, vc, wo.qs, wo.scales], 2 * kc.nbytes + wo.nbytes)]
            case(cases, f"fused_attn_out {quant} H={H} Dh={Dh} L={L} S={S} (caches identical)",
                 f"{quant} L={L}", 1, out, ref,
                 [lambda c=c: flash_decode.fused_attn_out(x, q, kn, vn, *c[:2], lengths, c[2])
                  for c in sets],
                 [lambda c=c: flash_decode.fused_attn_out_plain(x, q, kn, vn, *c[:2], lengths,
                                                                c[2]) for c in sets])
            if quant == "q4_0" and L == S:
                extra["attn_unfused"] = unfused_ms([lambda c=c: x + qmatmul.quant_matmul(
                    flash_decode.flash_decode_append(
                        (q[:, 0] * scale).reshape(1, H, 1, Dh), kn[:, 0], vn[:, 0], *c[:2],
                        lengths).reshape(1, 1, D), c[2]) for c in sets])
                extra["attn_lib"] = library(
                    "scaled_dot_product_attention over the live rows (no append) + dequantize "
                    "Wo + matmul + add (4+ calls)",
                    [lambda c=c: x + tf.scaled_dot_product_attention(
                        q.transpose(1, 2), c[0][:, :, :L], c[1][:, :, :L]).reshape(1, 1, D)
                     @ c[2].dequantize(torch.bfloat16) for c in sets])
            del kc, vc, kp, vp, sets
        del wo
    attn = _record("fused_attn_out", "tokenhawk_tpu_torch/csrc/flash_decode.cu",
                   "tokenhawk_tpu/ops/pallas/attn_block.py:303 (_attn_wo via fused_attn_out)",
                   cases, (f"q4_0 L={S}", 1),
                   bound(D * D * 0.625 + (2 * S + 5) * H * Dh * bf + 2 * D * bf,
                         2 * D * D + 4 * S * H * Dh), extra["attn_lib"])
    attn["unfused_ms"] = extra["attn_unfused"]
    return [owo, attn]


def _paged_head_dim_64_cases(randn, case, g) -> dict:
    """Kernels 5-7 and 10-12 at TinyLlama's heads (4 KV heads of 64, 8
    queries each) over phase 2's paged shapes (B=8, PAGED_LENGTHS, a 140-page
    pool, shuffled table, two appends on the trash page), bf16 and int8
    pages, both layouts, checked: appends and gathers exactly.  Returns
    kernel name -> cases."""
    import torch

    from tokenhawk_tpu_torch.ops.cuda import paged_decode as pd
    from tokenhawk_tpu_torch.ops.cuda import paged_int8 as pi
    from tokenhawk_tpu_torch.ops.kvquant import quantize_kv_block

    log("-- kernels 5-7 and 10-12 at 4 KV heads of 64 x 8 queries (TinyLlama), checked")
    dev = torch.device("cuda")
    Hkv, rep, Dh, ps, n_pool = 4, 8, 64, PAGED_PS, PAGED_POOL
    B, mp = len(PAGED_LENGTHS), max(PAGED_LENGTHS) // ps
    lengths = torch.tensor(PAGED_LENGTHS, dtype=torch.int32, device=dev)
    perm = torch.randperm(n_pool, generator=g, device=dev)
    table = perm[:B * mp].reshape(B, mp).to(torch.int32).contiguous()
    trash = int(perm[-1])
    pos = lengths.long() - 1
    page = table.gather(1, (pos // ps)[:, None])[:, 0].clone()
    slot = (pos % ps).to(torch.int32)
    page[-2:], slot[-2:] = trash, 5
    keep = torch.arange(n_pool, device=dev) != trash
    out = {}

    def check(name, label, got, want, frac=KERNEL_TOL):
        case(out.setdefault(name, []), f"{name} Dh 64 rep 8 {label}", f"dh64 {label}", B, got,
             want, frac=frac)

    for layout in ("contig", "head"):
        shape = (n_pool, Hkv, ps, Dh) if layout == "contig" else (Hkv, n_pool, ps, Dh)

        def kept(xs):
            return torch.cat([(x[keep] if layout == "contig" else x[:, keep]).float().flatten()
                              for x in xs])

        q = randn(B, Hkv, rep, Dh, scale=Dh**-0.5)
        kn, vn = randn(B, Hkv, Dh), randn(B, Hkv, Dh)
        pool = [randn(*shape), randn(*shape)]
        check("paged_decode", f"{layout} lengths={PAGED_LENGTHS}",
              pd.paged_decode(q, *pool, table, lengths, layout),
              pd.paged_decode_plain(q, *pool, table, lengths, layout))
        pa, pb = [x.clone() for x in pool], [x.clone() for x in pool]
        pd.paged_append(*pa, kn, vn, page, slot, layout)
        pd.paged_append_plain(*pb, kn, vn, page, slot, layout)
        check("paged_append", f"{layout} (outside the trash page, exact)", kept(pa), kept(pb),
              0.0)
        got, want = pd.gather_pages(*pool, table, layout), pd.gather_pages_plain(*pool, table,
                                                                                 layout)
        check("gather_pages", f"{layout} (K and V, exact)", torch.cat(got), torch.cat(want), 0.0)

        ipool = []
        for _ in range(2):
            codes, scales = quantize_kv_block(randn(*shape, dtype=torch.float32))
            ipool += [codes, scales.float()]
        check("paged_decode_int8", f"{layout} lengths={PAGED_LENGTHS}",
              pi.paged_decode_int8(q, *ipool, table, lengths, layout),
              pi.paged_decode_int8_plain(q, *ipool, table, lengths, layout))
        pa, pb = [x.clone() for x in ipool], [x.clone() for x in ipool]
        pi.paged_append_int8(*pa, kn, vn, page, slot, layout)
        pi.paged_append_int8_plain(*pb, kn, vn, page, slot, layout)
        check("paged_append_int8", f"{layout} (codes and scales outside the trash page, exact)",
              kept(pa), kept(pb), 0.0)
        got = pi.gather_pages_int8(*ipool, table, layout, torch.bfloat16)
        want = pi.gather_pages_int8_plain(*ipool, table, layout, torch.bfloat16)
        check("gather_pages_int8", f"{layout} -> bf16 (K and V, exact)", torch.cat(got),
              torch.cat(want), 0.0)
        del pool, ipool, pa, pb, got, want
    return out


def _weight_copies(w) -> list:
    """copies() of a QWeight, each a QWeight."""
    return [ws[0] for ws in _weight_sets([w])]


def _group_code_kernel_records(randn, case, library, g) -> list:
    """Kernel 13 at every projection shape of phases 6 and 6q (Llama-3-8B
    in Q4_K_M: Q4_K, with Q6_K for the output and for w2 on some layers;
    LLaMA-7B in Q8_0) at 1, 8 and 512 rows, with and without the fused
    norm; kernel 2 over those models' FFN pairings at 1 and 8 rows.  Each
    shape is timed in the form the path runs it (norm fused into wqkv and
    the output), the other form only checked; each timed case gets its
    bound and the time of the same function from PyTorch calls
    (dequantize, then torch.matmul).  A record per model and per pairing,
    timed at one row."""
    import torch

    from tokenhawk_tpu_torch.ops.cuda import ffn, qmatmul
    from tokenhawk_tpu_torch.ops.qweight import QWeight

    dev = torch.device("cuda")
    bf = 2
    src13, src2 = "tokenhawk_tpu_torch/csrc/qmatmul.cu", "tokenhawk_tpu_torch/csrc/ffn.cu"
    rep13 = ("tokenhawk_tpu/ops/pallas/qmatmul.py:742 (q8_matmul); "
             "qmatmul.py:477 (qk_matmul)")
    records = []
    models = [
        ("q4_k_m", "Llama-3-8B Q4_K_M", [("wqkv", 4096, 6144, "q4_k", True),
                                         ("wo", 4096, 4096, "q4_k", False),
                                         ("w2 q6_k", 14336, 4096, "q6_k", False),
                                         ("w2 q4_k", 14336, 4096, "q4_k", False),
                                         ("output", 4096, 128256, "q6_k", True)]),
        ("q8_0", "LLaMA-7B Q8_0", [("wqkv", 4096, 12288, "q8_0", True),
                                   ("wo", 4096, 4096, "q8_0", False),
                                   ("output", 4096, 32000, "q8_0", True)])]
    for tag, model, shapes in models:
        cases = []
        for name, K, N, form, norm in shapes:
            w = QWeight.random(K, N, form, g, dev)
            ws = _weight_copies(w)
            gain = 1.0 + randn(K, scale=0.1)
            for rows in (1, 8, 512):
                x = randn(rows, K)
                for ng in (gain, None):
                    label = (f"qk_matmul {model} {name} ({form}) K={K} N={N} rows={rows} "
                             f"norm={ng is not None}")
                    out = qmatmul.quant_matmul(x, w, ng)
                    ref = qmatmul.quant_matmul_plain(x, w, ng)
                    if (ng is not None) != norm:
                        case(cases, label, f"{name} norm={ng is not None}", rows, out, ref)
                        continue
                    calls = 32 if rows < 512 else 4
                    case(cases, label, name, rows, out, ref,
                         [lambda w=w: qmatmul.quant_matmul(x, w, ng) for w in ws],
                         [lambda w=w: qmatmul.quant_matmul_plain(x, w, ng) for w in ws],
                         calls=calls)
                    # x, the gain and y once each, beside the weight's GGUF
                    # blocks (its bytes in the port's layout as layout_bound_ms).
                    io = (rows * (K + N) + K * norm) * bf
                    b = bound(_ggml_bytes(form, K, N) + io, 2 * rows * K * N, w.nbytes + io)
                    lib_ms = timed([lambda w=w: x @ w.dequantize(torch.bfloat16) for w in ws],
                                   calls)["ms"]
                    cases[-1].update(b, library_ms=lib_ms)
                    log(f"  bound {b['bound_ms']:.4f} ms ({b['bound_by']}; in the port's layout "
                        f"{b['layout_bound_ms']:.4f}); dequantize (f32 "
                        f"torch ops, then bf16) + torch.matmul, no norm (2+ calls): "
                        f"{lib_ms:.4f} ms")
                    if name == "wqkv" and rows == 1:
                        at, lib = b, lib_ms
            del w, ws
        records.append(_record(f"qk_matmul[{tag}]", src13, rep13, cases, ("wqkv", 1), at, lib))

    pairs = [("q4_k/q6_k", 14336, "q4_k", "q6_k"), ("q4_k/q4_k", 14336, "q4_k", "q4_k"),
             ("q8_0/q8_0", 11008, "q8_0", "q8_0")]
    D = 4096
    for tag, F, f13, f2 in pairs:
        w13, w2 = QWeight.random(D, 2 * F, f13, g, dev), QWeight.random(F, D, f2, g, dev)
        sets = list(zip(_weight_copies(w13), _weight_copies(w2)))
        gain = 1.0 + randn(D, scale=0.1)
        cases = []
        for rows in (1, 8):
            x = randn(rows, D)
            case(cases, f"fused_ffn {tag} D={D} F={F} rows={rows}", "ffn", rows,
                 ffn.fused_ffn(x, w13, w2, gain), ffn.fused_ffn_plain(x, w13, w2, gain),
                 [lambda s=s: ffn.fused_ffn(x, *s, gain) for s in sets],
                 [lambda s=s: ffn.fused_ffn_plain(x, *s, gain) for s in sets])
            io = (2 * rows + 1) * D * bf
            b = bound(_ggml_bytes(f13, D, 2 * F) + _ggml_bytes(f2, F, D) + io, 6 * rows * D * F,
                      w13.nbytes + w2.nbytes + io)
            lib_ms = library("rms_norm + dequantize w13 and w2 + 2 torch.matmul + silu, bf16 "
                             "(10+ calls)", [lambda s=s: _ffn_library(x, *s, gain) for s in sets])
            cases[-1].update(b, library_ms=lib_ms)
            log(f"  bound {b['bound_ms']:.4f} ms ({b['bound_by']}; in the port's layout "
                f"{b['layout_bound_ms']:.4f})")
            if rows == 1:
                at, lib = b, lib_ms
        records.append(_record(f"fused_ffn[{tag}]", src2, "tokenhawk_tpu/ops/pallas/ffn.py:270 "
                               "(_fused_ffn via fused_ffn)", cases, ("ffn", 1), at, lib))
        del w13, w2, sets
    return records


def _sb_kernel_records(randn, case, library, g) -> list:
    """Kernel 17 (Q4_K super-blocks, the forms of THAWK_Q4K_SB=1) at phase
    11a's projection shapes (Llama-3-8B: wqkv and w13 with the norm fused,
    wo without; the other norm form only checked) at 1, 8 and 512 rows,
    each timed with its bound at the GGUF blocks' 0.5625 B a weight and at
    the layout's bytes, dequantize + torch.matmul, and kernel 13 over the
    flat form of the same codes (flat_ms); then kernel 2 with an sb w13 over
    a Q6_K and a flat Q4_K w2 at one row, beside kernel 2 over the flat w13."""
    import torch

    from tokenhawk_tpu_torch.ops.cuda import ffn, qmatmul
    from tokenhawk_tpu_torch.ops.qweight import QWeight

    dev = torch.device("cuda")
    bf = 2
    cases = []
    shapes = [("wqkv", 4096, 6144, True), ("wo", 4096, 4096, False), ("w13", 4096, 28672, True)]
    for name, K, N, norm in shapes:
        w = QWeight.random(K, N, "q4k_sb", g, dev)
        ws = _weight_copies(w)
        flats = [v.flat() for v in ws]
        gain = 1.0 + randn(K, scale=0.1)
        for rows in (1, 8, 512):
            x = randn(rows, K)
            for ng in (gain, None):
                label = (f"qk_sb_matmul Llama-3-8B {name} K={K} N={N} rows={rows} "
                         f"norm={ng is not None}")
                out = qmatmul.quant_matmul(x, w, ng)
                ref = qmatmul.quant_matmul_plain(x, w, ng)
                if (ng is not None) != norm:
                    case(cases, label, f"{name} norm={ng is not None}", rows, out, ref)
                    continue
                calls = 32 if rows < 512 else 4
                case(cases, label, name, rows, out, ref,
                     [lambda w=w: qmatmul.quant_matmul(x, w, ng) for w in ws],
                     [lambda w=w: qmatmul.quant_matmul_plain(x, w, ng) for w in ws],
                     calls=calls)
                io = (rows * (K + N) + K * norm) * bf
                b = bound(_ggml_bytes("q4_k", K, N) + io, 2 * rows * K * N, w.nbytes + io)
                lib_ms = timed([lambda w=w: x @ w.dequantize(torch.bfloat16) for w in ws],
                               calls)["ms"]
                flat_ms = timed([lambda f=f: qmatmul.quant_matmul(x, f, ng) for f in flats],
                                calls)["ms"]
                cases[-1].update(b, library_ms=lib_ms, flat_ms=flat_ms)
                log(f"  bound {b['bound_ms']:.4f} ms ({b['bound_by']}; in the port's layout "
                    f"{b['layout_bound_ms']:.4f}); dequantize (f32 torch ops, then bf16) + "
                    f"torch.matmul, no norm (2+ calls): {lib_ms:.4f} ms; kernel 13 over the "
                    f"flat form of the same codes ({flats[0].nbytes / 1e6:.1f} MB against "
                    f"{w.nbytes / 1e6:.1f}): {flat_ms:.4f} ms")
                if name == "wqkv" and rows == 1:
                    at, lib, flat_at = b, lib_ms, flat_ms
        del w, ws, flats
    records = [_record("qk_sb_matmul", "tokenhawk_tpu_torch/csrc/qmatmul.cu",
                       "tokenhawk_tpu/ops/pallas/qmatmul.py:637 (qk_sb_matmul)", cases,
                       ("wqkv", 1), at, lib) | {"flat_ms": flat_at}]

    D, F = 4096, 14336
    for tag, f2 in (("q4k_sb/q6_k", "q6_k"), ("q4k_sb/q4_k", "q4_k")):
        w13, w2 = QWeight.random(D, 2 * F, "q4k_sb", g, dev), QWeight.random(F, D, f2, g, dev)
        sets = list(zip(_weight_copies(w13), _weight_copies(w2)))
        flat_sets = [(a.flat(), b) for a, b in sets]
        gain = 1.0 + randn(D, scale=0.1)
        x = randn(1, D)
        cases = []
        case(cases, f"fused_ffn {tag} D={D} F={F} rows=1", "ffn", 1,
             ffn.fused_ffn(x, w13, w2, gain), ffn.fused_ffn_plain(x, w13, w2, gain),
             [lambda s=s: ffn.fused_ffn(x, *s, gain) for s in sets],
             [lambda s=s: ffn.fused_ffn_plain(x, *s, gain) for s in sets])
        io = 3 * D * bf
        b = bound(_ggml_bytes("q4_k", D, 2 * F) + _ggml_bytes(f2, F, D) + io, 6 * D * F,
                  w13.nbytes + w2.nbytes + io)
        lib_ms = library("rms_norm + dequantize w13 and w2 + 2 torch.matmul + silu, bf16 "
                         "(10+ calls)", [lambda s=s: _ffn_library(x, *s, gain) for s in sets])
        flat_ms = timed([lambda s=s: ffn.fused_ffn(x, *s, gain) for s in flat_sets])["ms"]
        cases[-1].update(b, library_ms=lib_ms, flat_ms=flat_ms)
        log(f"  bound {b['bound_ms']:.4f} ms ({b['bound_by']}; in the port's layout "
            f"{b['layout_bound_ms']:.4f}); kernel 2 over the flat w13 of the same codes: "
            f"{flat_ms:.4f} ms")
        records.append(_record(f"fused_ffn[{tag}]", "tokenhawk_tpu_torch/csrc/ffn.cu",
                               "tokenhawk_tpu/ops/pallas/ffn.py:270 (_fused_ffn via fused_ffn, "
                               "sb w13: ffn.py:195-197)", cases, ("ffn", 1), b, lib_ms)
                       | {"flat_ms": flat_ms})
        del w13, w2, sets, flat_sets
    return records


def _ffn_library(x, w13, w2, gain, eps: float = 1e-6):
    """Kernel 2's function from PyTorch calls in bfloat16 (the yardstick)."""
    import torch

    xn = torch.nn.functional.rms_norm(x, (x.shape[-1],), gain, eps)
    gu = xn @ w13.dequantize(torch.bfloat16)
    F = gu.shape[-1] // 2
    return x + (torch.nn.functional.silu(gu[..., :F]) * gu[..., F:]) @ w2.dequantize(torch.bfloat16)


def _gqa_cases(randn, case, g) -> dict:
    """Kernels 3-12 at Llama-3-8B's heads (8 KV heads, 4 queries each, head
    dim 128) against their plain versions, checked and not timed: the
    lengths and pools of the cases above.  Returns kernel name -> cases."""
    import torch

    from tokenhawk_tpu_torch.ops.cuda import flash_attention as fa
    from tokenhawk_tpu_torch.ops.cuda import flash_decode as fd
    from tokenhawk_tpu_torch.ops.cuda import kv_int8 as ki
    from tokenhawk_tpu_torch.ops.cuda import paged_decode as pd
    from tokenhawk_tpu_torch.ops.cuda import paged_int8 as pi
    from tokenhawk_tpu_torch.ops.kvquant import quantize_kv_block

    log("-- kernels 3-12 at 8 KV heads x 4 queries (Llama-3-8B), checked against the plain")
    dev = torch.device("cuda")
    Hkv, rep, Dh, S = 8, 4, 128, INT8_CTX
    out = {}

    def check(name, label, got, want, frac=KERNEL_TOL):
        case(out.setdefault(name, []), f"{name} GQA rep 4 {label}", f"rep4 {label}", rep, got,
             want, frac=frac)

    def same(name, a, b):
        if not all(torch.equal(x, y) for x, y in zip(a, b)):
            raise AssertionError(f"{name} at GQA rep 4: the caches differ from the plain's")

    def q8(*shape):
        k, ks = quantize_kv_block(randn(*shape, dtype=torch.float32))
        return [k, ks]

    lens = [1, 37, 300, S]
    B = len(lens)
    lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
    q = randn(B, Hkv, rep, Dh, scale=Dh**-0.5)
    kn, vn = randn(B, Hkv, Dh), randn(B, Hkv, Dh)
    c = [randn(B, Hkv, S, Dh), randn(B, Hkv, S, Dh)]
    p = [x.clone() for x in c]
    got = fd.flash_decode_append(q, kn, vn, *c, lengths)
    want = fd.flash_decode_append_plain(q, kn, vn, *p, lengths)
    same("flash_decode_append", c, p)
    check("flash_decode_append", f"B={B} lengths={lens} S={S}", got, want)
    c = q8(B, Hkv, S, Dh) + q8(B, Hkv, S, Dh)
    p = [x.clone() for x in c]
    got = ki.flash_decode_int8(q, kn, vn, *c, lengths)
    want = ki.flash_decode_int8_plain(q, kn, vn, *p, lengths)
    same("flash_decode_int8", c, p)
    check("flash_decode_int8", f"B={B} lengths={lens} S={S}", got, want)

    kc, vc = randn(1, Hkv, S, Dh), randn(1, Hkv, S, Dh)
    ic = q8(1, Hkv, S, Dh) + q8(1, Hkv, S, Dh)
    for T, off in ((512, 0), (16, 200), (1500, 0)):
        qp = randn(1, Hkv, rep, T, Dh, scale=Dh**-0.5)
        offsets = torch.tensor([off], dtype=torch.int32, device=dev)
        check("flash_attention", f"T={T} offset={off}", fa.flash_attention(qp, kc, vc, offsets),
              fa.flash_attention_plain(qp, kc, vc, offsets))
        check("flash_attention_int8", f"T={T} offset={off}",
              ki.flash_attention_int8(qp, *ic, offsets), ki.flash_attention_int8_plain(qp, *ic, offsets))
    del kc, vc, ic

    ps, n_pool = PAGED_PS, PAGED_POOL
    B, mp = len(PAGED_LENGTHS), max(PAGED_LENGTHS) // ps
    lengths = torch.tensor(PAGED_LENGTHS, dtype=torch.int32, device=dev)
    perm = torch.randperm(n_pool, generator=g, device=dev)
    table = perm[:B * mp].reshape(B, mp).to(torch.int32).contiguous()
    pos = lengths.long() - 1
    page = table.gather(1, (pos // ps)[:, None])[:, 0].to(torch.int32).contiguous()
    slot = (pos % ps).to(torch.int32)
    q = randn(B, Hkv, rep, Dh, scale=Dh**-0.5)
    kn, vn = randn(B, Hkv, Dh), randn(B, Hkv, Dh)
    shape = (n_pool, Hkv, ps, Dh)
    pool = [randn(*shape), randn(*shape)]
    check("paged_decode", f"contig B={B} lengths={PAGED_LENGTHS}",
          pd.paged_decode(q, *pool, table, lengths, "contig"),
          pd.paged_decode_plain(q, *pool, table, lengths, "contig"))
    a, b = [x.clone() for x in pool], [x.clone() for x in pool]
    pd.paged_append(*a, kn, vn, page, slot, "contig")
    pd.paged_append_plain(*b, kn, vn, page, slot, "contig")
    check("paged_append", f"contig B={B}", torch.stack(a), torch.stack(b), frac=0.0)
    check("gather_pages", f"contig B={B} max_pages={mp}",
          torch.stack(pd.gather_pages(*pool, table, "contig")),
          torch.stack(pd.gather_pages_plain(*pool, table, "contig")), frac=0.0)
    del pool, a, b
    ipool = []
    for _ in range(2):
        codes, scales = quantize_kv_block(randn(*shape, dtype=torch.float32))
        ipool += [codes, scales.float()]
    check("paged_decode_int8", f"contig B={B} lengths={PAGED_LENGTHS}",
          pi.paged_decode_int8(q, *ipool, table, lengths, "contig"),
          pi.paged_decode_int8_plain(q, *ipool, table, lengths, "contig"))
    a, b = [x.clone() for x in ipool], [x.clone() for x in ipool]
    pi.paged_append_int8(*a, kn, vn, page, slot, "contig")
    pi.paged_append_int8_plain(*b, kn, vn, page, slot, "contig")
    check("paged_append_int8", f"contig B={B}", torch.cat([x.float().flatten() for x in a]),
          torch.cat([x.float().flatten() for x in b]), frac=0.0)
    check("gather_pages_int8", f"contig B={B} max_pages={mp}",
          torch.stack(pi.gather_pages_int8(*ipool, table, "contig", torch.bfloat16)),
          torch.stack(pi.gather_pages_int8_plain(*ipool, table, "contig", torch.bfloat16)),
          frac=0.0)
    return out


def _sdpa_ms(q, caches, lens) -> float:
    """scaled_dot_product_attention of q [B, Hkv, rep, Dh] (the rep query
    heads of a KV head as its query rows) over each cache's live rows:
    the live prefix when the lengths are equal, else a length mask."""
    import torch
    import torch.nn.functional as tf

    S = caches[0][0].shape[2]
    if len(set(lens)) == 1:
        L = min(lens[0], S)
        fns = [lambda c=c: tf.scaled_dot_product_attention(q, c[0][:, :, :L], c[1][:, :, :L],
                                                           scale=1.0) for c in caches]
    else:
        n = torch.tensor(lens, device=q.device)
        mask = (torch.arange(S, device=q.device)[None, :] < n[:, None])[:, None, None]
        fns = [lambda c=c: tf.scaled_dot_product_attention(q, c[0], c[1], attn_mask=mask,
                                                           scale=1.0) for c in caches]
    return timed(fns)["ms"]


def _decode_attend_record(randn, case) -> dict:
    """Kernel 14 (decode attention, no append) at its paths' shapes:
    LLaMA-7B's heads (32 KV heads of 128, one query each) over a 512-token
    cache at B=1, as phase 8's dense 7B decodes, and TinyLlama's (4 KV
    heads of 64, 8 queries each) over 2048 at B=1 and at B=8 with ragged
    lengths, as phase 9's draft decodes.  Each case is timed, with its
    bound and SDPA over the same live rows."""
    import torch

    from tokenhawk_tpu_torch.ops.cuda import flash_decode as fd

    dev = torch.device("cuda")
    bf = 2
    cases = []
    for label, Hkv, rep, Dh, S, lens in (("7B B=1 L=512", 32, 1, 128, S_CTX, [S_CTX]),
                                         ("TinyLlama B=1 L=2048", 4, 8, 64, 2048, [2048]),
                                         ("TinyLlama B=8 ragged", 4, 8, 64, 2048, PAGED_LENGTHS)):
        B = len(lens)
        q = randn(B, Hkv, rep, Dh, scale=Dh**-0.5)
        kc, vc = randn(B, Hkv, S, Dh), randn(B, Hkv, S, Dh)
        lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
        caches = copies([kc, vc], 2 * kc.nbytes)
        case(cases, f"flash_decode (kernel 14) {label} Hkv={Hkv} rep={rep} Dh={Dh} S={S} "
                    f"lengths={lens}", label, B, fd.flash_decode(q, kc, vc, lengths),
             fd.flash_decode_plain(q, kc, vc, lengths),
             [lambda c=c: fd.flash_decode(q, *c, lengths) for c in caches],
             [lambda c=c: fd.flash_decode_plain(q, *c, lengths) for c in caches])
        live = sum(min(n, S) for n in lens)
        # K and V rows of the live tokens, q and out, the lengths.
        b = bound(2 * live * Hkv * Dh * bf + 2 * B * Hkv * rep * Dh * bf + 4 * B,
                  4 * live * Hkv * rep * Dh)
        lib = _sdpa_ms(q, caches, lens)
        cases[-1].update(b, library_ms=lib)
        log(f"  bound {b['bound_ms']:.4f} ms ({b['bound_by']}); library call "
            f"scaled_dot_product_attention over the live rows: {lib:.4f} ms")
        del kc, vc, caches
    main = cases[0]
    return _record("flash_decode_attend", "tokenhawk_tpu_torch/csrc/flash_decode.cu",
                   "tokenhawk_tpu/ops/pallas/flash_decode_dma.py:1396 (flash_decode_dma); "
                   "flash_decode_dma.py:1328 (flash_decode_loop); "
                   "tokenhawk_tpu/ops/pallas/flash_decode.py:121 (flash_decode via "
                   "attend_decode)", cases, ("7B B=1 L=512", 1),
                   {k: main[k] for k in ("bound_ms", "bound_by")}, main["library_ms"])


def _head_dim_64_cases(randn, case) -> dict:
    """Kernels 3, 4, 8 and 9 at TinyLlama's heads (4 KV heads of 64, 8
    queries each: the draft's dense cache) against their plain versions,
    checked: ragged decode lengths up to 2048, and prefills from offsets 0
    and 200.  Returns kernel name -> cases."""
    import torch

    from tokenhawk_tpu_torch.ops.cuda import flash_attention as fa
    from tokenhawk_tpu_torch.ops.cuda import flash_decode as fd
    from tokenhawk_tpu_torch.ops.cuda import kv_int8 as ki
    from tokenhawk_tpu_torch.ops.kvquant import quantize_kv_block

    log("-- kernels 3, 4, 8, 9 at 4 KV heads of 64 x 8 queries (TinyLlama), checked")
    dev = torch.device("cuda")
    Hkv, rep, Dh, S = 4, 8, 64, 2048
    out = {}

    def check(name, label, got, want):
        case(out.setdefault(name, []), f"{name} Dh 64 rep 8 {label}", f"dh64 {label}", rep, got,
             want)

    def q8(*shape):
        return list(quantize_kv_block(randn(*shape, dtype=torch.float32)))

    lens = PAGED_LENGTHS
    B = len(lens)
    lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
    q = randn(B, Hkv, rep, Dh, scale=Dh**-0.5)
    kn, vn = randn(B, Hkv, Dh), randn(B, Hkv, Dh)
    for name, c, run, plain in (
            ("flash_decode_append", [randn(B, Hkv, S, Dh), randn(B, Hkv, S, Dh)],
             fd.flash_decode_append, fd.flash_decode_append_plain),
            ("flash_decode_int8", q8(B, Hkv, S, Dh) + q8(B, Hkv, S, Dh), ki.flash_decode_int8,
             ki.flash_decode_int8_plain)):
        p = [x.clone() for x in c]
        got, want = run(q, kn, vn, *c, lengths), plain(q, kn, vn, *p, lengths)
        if not all(torch.equal(x, y) for x, y in zip(c, p)):
            raise AssertionError(f"{name} at Dh 64: the caches differ from the plain's")
        check(name, f"B={B} lengths={lens} S={S} (caches identical)", got, want)
    kc, vc = randn(1, Hkv, S, Dh), randn(1, Hkv, S, Dh)
    ic = q8(1, Hkv, S, Dh) + q8(1, Hkv, S, Dh)
    for T, off in ((300, 0), (5, 200)):
        qp = randn(1, Hkv, rep, T, Dh, scale=Dh**-0.5)
        offsets = torch.tensor([off], dtype=torch.int32, device=dev)
        check("flash_attention", f"T={T} offset={off}", fa.flash_attention(qp, kc, vc, offsets),
              fa.flash_attention_plain(qp, kc, vc, offsets))
        check("flash_attention_int8", f"T={T} offset={off}",
              ki.flash_attention_int8(qp, *ic, offsets), ki.flash_attention_int8_plain(qp, *ic, offsets))
    return out


def _deq(codes, scales):
    """An int8 cache or pool's values in bfloat16, as the library calls use them."""
    import torch

    return codes.to(torch.bfloat16) * scales[..., None].to(torch.bfloat16)


def _int8_kernel_records(randn, case, library) -> list:
    """Kernels 8 and 9 over a dense int8 cache of n_ctx 2048 (the int8 Engine
    of phase 4i): decode at ragged lengths, timed at B=1 with 2048 live
    tokens; prefill timed at T=512 from offset 0."""
    import torch
    import torch.nn.functional as tf

    from tokenhawk_tpu_torch.ops.cuda import kv_int8 as ki
    from tokenhawk_tpu_torch.ops.kvquant import quantize_kv_block

    dev = torch.device("cuda")
    Hkv, Dh, S, bf = 32, 128, INT8_CTX, 2

    def cache(B):
        k, ks = quantize_kv_block(randn(B, Hkv, S, Dh, dtype=torch.float32))
        v, vs = quantize_kv_block(randn(B, Hkv, S, Dh, dtype=torch.float32))
        return [k, ks, v, vs]

    def nbytes(c):
        return sum(x.nbytes for x in c)

    cases = []
    for lens in ([1, 37, 300, S, 0], [300], [S]):
        B = len(lens)
        q = randn(B, Hkv, 1, Dh, scale=Dh**-0.5)
        kn, vn = randn(B, Hkv, Dh), randn(B, Hkv, Dh)
        c = cache(B)
        p = [x.clone() for x in c]
        lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
        out = ki.flash_decode_int8(q, kn, vn, *c, lengths)
        ref = ki.flash_decode_int8_plain(q, kn, vn, *p, lengths)
        if not all(torch.equal(a, b) for a, b in zip(c, p)):
            raise AssertionError(f"flash_decode_int8 {lens}: appended rows differ from the plain's")
        caches = copies(c, nbytes(c))
        case(cases, f"flash_decode_int8 B={B} lengths={lens} S={S} (appended codes and scales "
                    f"identical)", f"B={B} L={lens[-1]}", B, out, ref,
             [lambda c=c: ki.flash_decode_int8(q, kn, vn, *c, lengths) for c in caches],
             [lambda c=c: ki.flash_decode_int8_plain(q, kn, vn, *c, lengths) for c in caches])
    L = S
    # Kernel 3 on a bf16 cache of the same length: what --kv auto trades.
    from tokenhawk_tpu_torch.ops.cuda import flash_decode as fd

    bc = copies([randn(1, Hkv, S, Dh), randn(1, Hkv, S, Dh)], 2 * Hkv * S * Dh * bf)
    k3 = timed([lambda c=c: fd.flash_decode_append(q, kn, vn, *c, lengths) for c in bc])["ms"]
    log(f"  for comparison, kernel 3 over a bf16 cache, B=1 L={L} S={S}: {k3:.4f} ms")
    del bc
    lib8 = library("dequantize K and V + scaled_dot_product_attention, B=1, 2048 keys (3+ calls)",
                   [lambda c=c: tf.scaled_dot_product_attention(q, _deq(c[0], c[1]),
                                                                _deq(c[2], c[3]), scale=1.0)
                    for c in caches])
    rec8 = _record("flash_decode_int8", "tokenhawk_tpu_torch/csrc/kv_int8.cu",
                   "tokenhawk_tpu/ops/pallas/flash_decode_int8.py:254 (flash_decode_int8)",
                   cases, (f"B=1 L={L}", 1),
                   bound(2 * L * Hkv * Dh + 2 * L * Hkv * bf + 4 * Hkv * Dh * bf,
                         4 * L * Hkv * Dh), lib8)

    cases = []
    c = cache(1)
    caches = copies(c, nbytes(c))
    for T, off in ((64, 0), (16, 200), (13, 5), (512, 0), (S, 0)):
        q = randn(1, Hkv, 1, T, Dh, scale=Dh**-0.5)
        offsets = torch.tensor([off], dtype=torch.int32, device=dev)
        case(cases, f"flash_attention_int8 T={T} offset={off} S={S}", f"T={T} off={off}", T,
             ki.flash_attention_int8(q, *c, offsets), ki.flash_attention_int8_plain(q, *c, offsets),
             [lambda c=c: ki.flash_attention_int8(q, *c, offsets) for c in caches],
             [lambda c=c: ki.flash_attention_int8_plain(q, *c, offsets) for c in caches])
        if T == 512:
            q512 = q
    T = 512
    lib9 = library("dequantize K and V + scaled_dot_product_attention, causal, T=512 (3+ calls)",
                   [lambda c=c: tf.scaled_dot_product_attention(
                       q512[:, :, 0], _deq(c[0][:, :, :T], c[1][:, :, :T]),
                       _deq(c[2][:, :, :T], c[3][:, :, :T]), is_causal=True, scale=1.0)
                    for c in caches])
    rec9 = _record("flash_attention_int8", "tokenhawk_tpu_torch/csrc/kv_int8.cu",
                   "tokenhawk_tpu/ops/pallas/flash_attention_int8.py:138 "
                   "(flash_attention_int8 via attend_prefill_int8)", cases, ("T=512 off=0", 512),
                   bound(2 * T * Hkv * Dh * bf + 2 * T * Hkv * (Dh + bf),
                         4 * Hkv * Dh * T * (T + 1) / 2), lib9)
    return [rec8, rec9]


def _paged_int8_kernel_records(randn, case, library, g) -> list:
    """Kernels 10-12 at phase 2's paged shapes (B=8, PAGED_LENGTHS, a
    140-page pool, shuffled table, two appends on the trash page), on int8
    pages in both layouts; timed in the default (contig) layout."""
    import torch
    import torch.nn.functional as tf

    from tokenhawk_tpu_torch.ops.cuda import paged_int8 as pi
    from tokenhawk_tpu_torch.ops.kvquant import quantize_kv_block

    dev = torch.device("cuda")
    Hkv, Dh, ps, n_pool, bf = 32, 128, PAGED_PS, PAGED_POOL, 2
    B, mp, live = len(PAGED_LENGTHS), max(PAGED_LENGTHS) // ps, sum(PAGED_LENGTHS)
    lengths = torch.tensor(PAGED_LENGTHS, dtype=torch.int32, device=dev)
    perm = torch.randperm(n_pool, generator=g, device=dev)
    table = perm[:B * mp].reshape(B, mp).to(torch.int32).contiguous()
    tl_ = table.long()
    trash = int(perm[-1])
    pos = lengths.long() - 1
    page = table.gather(1, (pos // ps)[:, None])[:, 0].clone()
    slot = (pos % ps).to(torch.int32)
    page[-2:], slot[-2:] = trash, 5
    keep = torch.arange(n_pool, device=dev) != trash
    mask = (torch.arange(mp * ps, device=dev)[None, :] < lengths[:, None])[:, None, None, :]
    dec, app, gat, lib = [], [], [], {}
    for layout in ("contig", "head"):
        shape = (n_pool, Hkv, ps, Dh) if layout == "contig" else (Hkv, n_pool, ps, Dh)
        pool = []
        for _ in range(2):
            codes, scales = quantize_kv_block(randn(*shape, dtype=torch.float32))
            pool += [codes, scales.float()]
        q = randn(B, Hkv, 1, Dh, scale=Dh**-0.5)
        case(dec, f"paged_decode_int8 {layout} B={B} lengths={PAGED_LENGTHS} ps={ps}", layout, B,
             pi.paged_decode_int8(q, *pool, table, lengths, layout),
             pi.paged_decode_int8_plain(q, *pool, table, lengths, layout),
             [lambda: pi.paged_decode_int8(q, *pool, table, lengths, layout)],
             [lambda: pi.paged_decode_int8_plain(q, *pool, table, lengths, layout)])

        kn, vn = randn(B, Hkv, Dh), randn(B, Hkv, Dh)
        pa, pb = [x.clone() for x in pool], [x.clone() for x in pool]
        pi.paged_append_int8(*pa, kn, vn, page, slot, layout)
        pi.paged_append_int8_plain(*pb, kn, vn, page, slot, layout)

        def kept(xs):
            return torch.cat([(x[keep] if layout == "contig" else x[:, keep]).float().flatten()
                              for x in xs])

        case(app, f"paged_append_int8 {layout} B={B} (2 rows on the trash page; codes and scales "
                  f"outside it identical)", layout, B, kept(pa), kept(pb),
             [lambda: pi.paged_append_int8(*pa, kn, vn, page, slot, layout)],
             [lambda: pi.paged_append_int8_plain(*pb, kn, vn, page, slot, layout)], frac=0.0)

        gk, gv = pi.gather_pages_int8(*pool, table, layout, torch.bfloat16)
        pk, pv = pi.gather_pages_int8_plain(*pool, table, layout, torch.bfloat16)
        if not torch.equal(gv, pv):
            raise AssertionError(f"gather_pages_int8 {layout}: V differs from the plain version's")
        case(gat, f"gather_pages_int8 {layout} B={B} max_pages={mp} -> bf16 (K and V identical)",
             layout, B, gk, pk,
             [lambda: pi.gather_pages_int8(*pool, table, layout, torch.bfloat16)],
             [lambda: pi.gather_pages_int8_plain(*pool, table, layout, torch.bfloat16)], frac=0.0)
        del gk, gv, pk, pv
        if layout == "contig":
            kp, ksp, vp, vsp = pool

            def dense(c, s):
                return _deq(c[tl_], s[tl_]).transpose(1, 2).reshape(B, Hkv, mp * ps, Dh)

            lib["decode"] = library(
                "gather + dequantize K and V + scaled_dot_product_attention with a length mask "
                "(8+ calls)", [lambda: tf.scaled_dot_product_attention(
                    q, dense(kp, ksp), dense(vp, vsp), attn_mask=mask, scale=1.0)])
            pl_, sl_ = page.long(), slot.long()
            qk, sk = quantize_kv_block(kn)
            qv, sv = quantize_kv_block(vn)
            lib["append"] = library("index_put_ of the quantized K and V codes and scales "
                                    "(4 calls, quantization not included)", [
                lambda: (pa[0].__setitem__((pl_, slice(None), sl_), qk),
                         pa[1].__setitem__((pl_, slice(None), sl_), sk.float()),
                         pa[2].__setitem__((pl_, slice(None), sl_), qv),
                         pa[3].__setitem__((pl_, slice(None), sl_), sv.float()))])
            lib["gather"] = library("pages[table] and scales[table], the multiply and the "
                                    "permute, K and V", [lambda: (dense(kp, ksp), dense(vp, vsp))])
        del pool, pa, pb
    src = "tokenhawk_tpu_torch/csrc/paged_int8.cu"
    row = Hkv * Dh  # bytes of one token's int8 codes across the kv heads
    return [
        _record("paged_decode_int8", src, "tokenhawk_tpu/ops/pallas/paged_decode_int8.py:450 "
                "(paged_flash_decode_int8_walk); paged_decode_int8.py:216 "
                "(paged_flash_decode_int8)", dec, ("contig", B),
                bound(2 * live * (row + Hkv * 4) + 2 * B * row * bf + B * (mp + 1) * 4,
                      4 * live * Hkv * Dh), lib["decode"]),
        _record("paged_append_int8", src, "tokenhawk_tpu/ops/pallas/paged_decode.py:205 "
                "(paged_append_rows, int8 payload); paged_decode.py:286 (paged_append_scales)",
                app, ("contig", B),
                bound(2 * B * row * bf + 2 * B * (row + Hkv * 4) + 2 * B * 4, 0), lib["append"]),
        _record("gather_pages_int8", src, "tokenhawk_tpu/ops/pallas/paged_decode.py:456 "
                "(gather_pages_dense_int8)", gat, ("contig", B),
                bound(2 * B * mp * ps * (row + Hkv * 4) + 2 * B * mp * ps * row * bf + B * mp * 4,
                      0), lib["gather"]),
    ]


def _paged_kernel_records(randn, case, library, g) -> list:
    """Kernels 5-7 at a serve batch of 8 (PAGED_LENGTHS) over a 140-page
    pool with a shuffled table, in both layouts; timed in the default
    (contig) layout."""
    import torch
    import torch.nn.functional as tf

    from tokenhawk_tpu_torch.ops.cuda import paged_decode as pd

    dev = torch.device("cuda")
    Hkv, Dh, ps, n_pool, bf = 32, 128, PAGED_PS, PAGED_POOL, 2
    B, mp, live = len(PAGED_LENGTHS), max(PAGED_LENGTHS) // ps, sum(PAGED_LENGTHS)
    lengths = torch.tensor(PAGED_LENGTHS, dtype=torch.int32, device=dev)
    perm = torch.randperm(n_pool, generator=g, device=dev)
    table = perm[:B * mp].reshape(B, mp).to(torch.int32).contiguous()
    tl = table.long()
    trash = int(perm[-1])
    # Each sequence appends its newest token; the last two are done slots
    # parked on the trash page, at the same row.
    pos = lengths.long() - 1
    page = table.gather(1, (pos // ps)[:, None])[:, 0].clone()
    slot = (pos % ps).to(torch.int32)
    page[-2:], slot[-2:] = trash, 5
    pl, sl = page.long(), slot.long()
    keep = torch.arange(n_pool, device=dev) != trash
    dec, app, gat, lib = [], [], [], {}
    for layout in ("contig", "head"):
        shape = (n_pool, Hkv, ps, Dh) if layout == "contig" else (Hkv, n_pool, ps, Dh)
        kp, vp = randn(*shape), randn(*shape)
        q = randn(B, Hkv, 1, Dh, scale=Dh**-0.5)
        case(dec, f"paged_decode {layout} B={B} lengths={PAGED_LENGTHS} ps={ps}", layout, B,
             pd.paged_decode(q, kp, vp, table, lengths, layout),
             pd.paged_decode_plain(q, kp, vp, table, lengths, layout),
             [lambda: pd.paged_decode(q, kp, vp, table, lengths, layout)],
             [lambda: pd.paged_decode_plain(q, kp, vp, table, lengths, layout)])

        kn, vn = randn(B, Hkv, Dh), randn(B, Hkv, Dh)
        ka, va, kb, vb = kp.clone(), vp.clone(), kp.clone(), vp.clone()
        pd.paged_append(ka, va, kn, vn, page, slot, layout)
        pd.paged_append_plain(kb, vb, kn, vn, page, slot, layout)

        def kept(x):
            return x[keep] if layout == "contig" else x[:, keep]

        case(app, f"paged_append {layout} B={B} (2 rows on the trash page; pools outside it "
                  f"identical)", layout, B, torch.stack([kept(ka), kept(va)]),
             torch.stack([kept(kb), kept(vb)]),
             [lambda: pd.paged_append(ka, va, kn, vn, page, slot, layout)],
             [lambda: pd.paged_append_plain(kb, vb, kn, vn, page, slot, layout)], frac=0.0)

        gk, gv = pd.gather_pages(kp, vp, table, layout)
        pk, pv = pd.gather_pages_plain(kp, vp, table, layout)
        if not torch.equal(gv, pv):
            raise AssertionError(f"gather_pages {layout}: V differs from the plain version's")
        case(gat, f"gather_pages {layout} B={B} max_pages={mp} (K and V identical)", layout, B,
             gk, pk, [lambda: pd.gather_pages(kp, vp, table, layout)],
             [lambda: pd.gather_pages_plain(kp, vp, table, layout)], frac=0.0)
        del gk, gv, pk, pv
        if layout == "contig":
            mask = (torch.arange(mp * ps, device=dev)[None, :] < lengths[:, None])[:, None, None]

            def dense(x):
                return x[tl].transpose(1, 2).reshape(B, Hkv, mp * ps, Dh)

            lib["decode"] = library(
                "gather K and V + scaled_dot_product_attention with a length mask (6+ calls)",
                [lambda: tf.scaled_dot_product_attention(q, dense(kp), dense(vp), attn_mask=mask,
                                                         scale=1.0)])
            lib["append"] = library("index_put_ of the new K and V rows (2 calls)", [
                lambda: (ka.__setitem__((pl, slice(None), sl), kn),
                         va.__setitem__((pl, slice(None), sl), vn))])
            lib["gather"] = library("pages[table] with its permute, K and V (2 x 2 calls)", [
                lambda: [dense(x) for x in (kp, vp)]])
        del kp, vp, ka, va, kb, vb
    src = "tokenhawk_tpu_torch/csrc/paged_decode.cu"
    row = Hkv * Dh * bf
    return [
        _record("paged_decode", src, "tokenhawk_tpu/ops/pallas/paged_decode.py:683 "
                "(paged_flash_decode_walk); paged_decode.py:497 (paged_flash_decode)",
                dec, ("contig", B), bound(2 * live * row + 2 * B * row + B * (mp + 1) * 4,
                                          4 * live * Hkv * Dh), lib["decode"]),
        _record("paged_append", src, "tokenhawk_tpu/ops/pallas/paged_decode.py:205 "
                "(paged_append_rows)", app, ("contig", B),
                bound(4 * B * row + 2 * B * 4, 0), lib["append"]),
        _record("gather_pages", src, "tokenhawk_tpu/ops/pallas/paged_decode.py:384 "
                "(gather_pages_dense)", gat, ("contig", B),
                bound(4 * B * mp * ps * row + B * mp * 4, 0), lib["gather"]),
    ]


def _record(name, source, replaces, cases, main_case, bound_at, library_ms) -> dict:
    """One kernel's JSON entry: worst error over its cases, times at the
    shape the main path runs most (main_case = (shape, rows)), its bound
    there and the library call's time (None where no one PyTorch call
    computes the same function)."""
    main = next(c for c in cases if (c["shape"], c["rows"]) == main_case)
    log(f"{name}: {main['ms']:.4f} ms against a bound of {bound_at['bound_ms']:.4f} ms "
        f"({bound_at['bound_by']}) at {main['shape']} rows={main['rows']}")
    return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": 0, "max_abs_err": max(c["max_abs_err"] for c in cases),
            "ms": main["ms"], "plain_ms": main["plain_ms"], **bound_at,
            "library_ms": library_ms,
            "timed_at": f"{main['shape']} rows={main['rows']}", "cases": cases}


def _seven_b(n_layer: int):
    from tokenhawk_tpu_torch.config import LlamaConfig

    return LlamaConfig(n_embd=4096, n_head=32, n_layer=n_layer, n_ctx=S_CTX)


def _llama3_8b(n_layer: int, n_ctx: int = S_CTX):
    """Meta-Llama-3-8B's widths (its published config.json): 32 heads over
    8 KV heads, n_ff 14336, vocab 128256, rope base 500000, eps 1e-5."""
    from tokenhawk_tpu_torch.config import LlamaConfig

    return LlamaConfig(n_vocab=128256, n_embd=4096, n_head=32, n_kv_head=8, n_layer=n_layer,
                       n_ff=14336, n_ctx=n_ctx, rope_theta=500000.0, rms_norm_eps=1e-5)


def _params(cfg, device, quant: str = "q4_0", sb: bool = False):
    """Random fused parameters from SEED: Q4_0, Q8_0 or the Q4_K_M mix
    (with sb, in THAWK_Q4K_SB=1's forms)."""
    import torch

    from tokenhawk_tpu_torch.models.llama import fuse_params, init_params

    g = torch.Generator(device=device)
    g.manual_seed(SEED)
    return fuse_params(init_params(cfg, g, dtype=torch.bfloat16, device=device, quant=quant,
                                   sb=sb))


# The GGML kind each group-code form holds in the models of phases 6 and
# 6q.  Q4_0 weights come from ggjt files, whose 20-byte blocks of 32 (f32
# scale) take the port's layout byte for byte.
_FORM_KIND = {(32, True): "q4_k", (16, False): "q6_k", (32, False): "q8_0"}


def _weight_gb(params) -> tuple:
    """GB of the quantized projections and the head: in the port's layout,
    and in the GGML blocks of their kinds."""
    ws = [params.output] + [w for lp in params.layers for w in (
        lp.wqkv, lp.wq, lp.wk, lp.wv, lp.wo, lp.w13, lp.w1, lp.w3, lp.w2) if w is not None]
    blocks = sum(w.nbytes if w.kind == "q4_0" else _ggml_bytes(
        "q4_k" if w.kind == "q4k_sb" else _FORM_KIND[w.group, w.mins is not None], *w.shape)
        for w in ws)
    return sum(w.nbytes for w in ws) / 1e9, blocks / 1e9


def phase_slice() -> None:
    import torch

    from tokenhawk_tpu_torch.runtime.engine import make_prefill_fn

    log("== phase 3: slice check, 2-layer 7B-width Q4_0, GPU kernels vs CPU plain")
    cfg = _seven_b(2)
    p_gpu = _params(cfg, torch.device("cuda"))
    p_cpu = p_gpu.to("cpu")
    rng = np.random.default_rng(SEED)
    ids = rng.integers(3, cfg.n_vocab, size=16 + 8)
    prefill = make_prefill_fn(cfg)
    for kv in ("bf16", "int8"):
        _dense_slice(cfg, p_gpu, p_cpu, ids, prefill, kv)
    for kv in ("bf16", "int8"):
        _paged_slice(cfg, p_gpu, kv)
    del p_gpu, p_cpu
    _kquant_slice()


def _kquant_slice() -> None:
    """The 2-layer slice at Llama-3-8B widths in the Q4_K_M mix: layer 1
    holds Q6_K wv and w2, so its wq | wk | wv stay three projections and
    its FFN pairs Q4_K with Q6_K; kernels 13 and 2 launch, kernel 1 not."""
    import torch

    from tokenhawk_tpu_torch.ops.cuda import ffn, qmatmul
    from tokenhawk_tpu_torch.runtime.engine import make_prefill_fn

    log("-- 2-layer Llama-3-8B-width Q4_K_M slice, GPU kernels vs CPU plain")
    cfg = _llama3_8b(2)
    p_gpu = _params(cfg, torch.device("cuda"), "q4_k_m")
    if not (p_gpu.layers[0].wqkv is not None and p_gpu.layers[1].wqkv is None
            and p_gpu.layers[1].w2.group == 16 and p_gpu.output.group == 16):
        raise AssertionError("the Q4_K_M mix did not give layer 1 Q6_K wv / w2 and a Q6_K head")
    p_cpu = p_gpu.to("cpu")
    ids = np.random.default_rng(SEED + 6).integers(3, cfg.n_vocab, size=16 + 8)
    _reset_counts([qmatmul, ffn])
    _dense_slice(cfg, p_gpu, p_cpu, ids, make_prefill_fn(cfg), "bf16")
    counts = _read_counts([qmatmul, ffn])
    log(f"Q4_K_M slice kernel launches on the GPU: {counts}")
    _check_path(counts, ["qk_matmul", *FFN_Q4_K_M], ["q4_matmul"])


def _dense_slice(cfg, p_gpu, p_cpu, ids, prefill, kv) -> None:
    """Prefill of 16 tokens + 8 decode steps on the GPU and on the CPU,
    over a bf16 cache (kernels 3, 4) or an int8 one (kernels 8, 9)."""
    import torch

    from tokenhawk_tpu_torch.models.llama import (
        KVCache,
        QuantKVCache,
        forward,
        logits_from_hidden,
    )

    def run(params, dev):
        cache = (QuantKVCache.create(cfg, 1, S_CTX, dev) if kv == "int8"
                 else KVCache.create(cfg, 1, S_CTX, torch.bfloat16, dev))
        t = torch.from_numpy(ids).to(dev)
        cache, logits = prefill(params, cache, t[None, :16],
                                torch.tensor([16], dtype=torch.int32, device=dev),
                                torch.tensor([0], dtype=torch.int32, device=dev))
        steps = [logits]
        with torch.inference_mode():
            for i in range(8):
                off = torch.tensor([16 + i], dtype=torch.int32, device=dev)
                h, cache = forward(cfg, params, t[None, 16 + i:17 + i], cache, off)
                steps.append(logits_from_hidden(cfg, params, h[:, 0]))
        return [s.float().cpu() for s in steps]

    t0 = time.perf_counter()
    got = run(p_gpu, torch.device("cuda"))
    t1 = time.perf_counter()
    want = run(p_cpu, torch.device("cpu"))
    t2 = time.perf_counter()
    log(f"{kv} cache: gpu {t1 - t0:.2f} s, cpu {t2 - t1:.2f} s")
    for i, (a, b) in enumerate(zip(got, want)):
        if not bool(torch.isfinite(a).all()):
            raise AssertionError(f"{kv} step {i}: non-finite logits on the GPU")
        err = (a - b).abs().max().item()
        tol = SLICE_TOL * b.abs().max().item()
        same = int(a.argmax()) == int(b.argmax())
        log(f"{kv} step {i} ({'prefill' if i == 0 else 'decode'}): max |logit diff| {err:.3e} "
            f"(tol {tol:.3e}), argmax equal {same}")
        if not err <= tol:
            raise AssertionError(f"{kv} slice step {i}: {err} > {tol}")


def _paged_slice(cfg, params, kv) -> None:
    """forward_paged_prefill / forward_paged_decode against the dense
    forward, both on the GPU, bf16 pages against the bf16 cache or int8
    pages against the int8 cache: a 124-token prompt, then 8 decode steps
    across the first page boundary, pages 3 and 1 of a 6-page pool."""
    import torch

    from tokenhawk_tpu_torch.models.llama import (
        KVCache,
        QuantKVCache,
        forward,
        forward_paged_decode,
        forward_paged_prefill,
        logits_from_hidden,
    )
    from tokenhawk_tpu_torch.runtime.paged import PagedKVCache

    kernels = "kernels 10-12" if kv == "int8" else "kernels 5-7"
    log(f"paged slice, {kv}: forward_paged_* ({kernels}) vs the dense forward, both on the GPU")
    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED + 3)
    n = 124
    ids = torch.from_numpy(rng.integers(3, cfg.n_vocab, size=n + 8)).to(dev)[None]
    if kv == "int8":
        cache = QuantKVCache.create(cfg, 1, S_CTX, dev)
        pool = PagedKVCache.create(cfg, 6, PAGED_PS, "int8", dev)
    else:
        cache = KVCache.create(cfg, 1, S_CTX, torch.bfloat16, dev)
        pool = PagedKVCache.create(cfg, 6, PAGED_PS, torch.bfloat16, dev)
    table = torch.tensor([[3, 1]], dtype=torch.int32, device=dev)
    with torch.inference_mode():
        h_d, _ = forward(cfg, params, ids[:, :n], cache, torch.zeros(1, dtype=torch.int32,
                                                                     device=dev))
        h_p, _ = forward_paged_prefill(cfg, params, ids[:, :n], pool, table)
        pairs = [(h_p[:, -1], h_d[:, -1])]
        for i in range(n, n + 8):
            pos = torch.tensor([i], dtype=torch.int32, device=dev)
            h_d, _ = forward(cfg, params, ids[:, i:i + 1], cache, pos)
            h_p, _ = forward_paged_decode(cfg, params, ids[:, i:i + 1], pool, table, pos)
            pairs.append((h_p[:, 0], h_d[:, 0]))
        for i, (hp, hd) in enumerate(pairs):
            a = logits_from_hidden(cfg, params, hp).float().cpu()
            b = logits_from_hidden(cfg, params, hd).float().cpu()
            err, tol = (a - b).abs().max().item(), SLICE_TOL * b.abs().max().item()
            log(f"paged {kv} step {i} ({'prefill' if i == 0 else f'decode at {n + i - 1}'}): "
                f"max |logit diff| {err:.3e} (tol {tol:.3e}), "
                f"argmax equal {int(a.argmax()) == int(b.argmax())}")
            if not (bool(torch.isfinite(a).all()) and err <= tol):
                raise AssertionError(f"paged {kv} slice step {i}: {err} > {tol}")


def phase_serve(kernel_mods) -> tuple:
    import torch

    from tokenhawk_tpu_torch.config import SamplingConfig
    from tokenhawk_tpu_torch.runtime.engine import Engine
    from tokenhawk_tpu_torch.tokenizer import byte_fallback_vocab

    log("== phase 4: serve, LLaMA-7B Q4_0, 32 layers, bf16 KV, n_ctx 512")
    cfg = _seven_b(32)
    t0 = time.perf_counter()
    params = _params(cfg, torch.device("cuda"))
    torch.cuda.synchronize()
    log(f"weights built in {time.perf_counter() - t0:.1f} s: Q4_0 projections "
        f"{_weight_gb(params)[0]:.3f} GB, allocated {torch.cuda.memory_allocated() / 1e9:.3f} GB")
    tok = byte_fallback_vocab()
    greedy = SamplingConfig(temperature=0.0)
    sampled = SamplingConfig(temperature=0.8, top_k=40, top_p=0.95)
    rng = np.random.default_rng(SEED + 1)
    # Random weights: EOS is disabled (eos_id=-1) so every request decodes
    # its whole budget.
    requests = [(greedy, 5), (sampled, 100), (greedy, 300)]
    engines = {id(s): Engine(cfg, params, tok, sampling=s, max_seq=S_CTX, eos_id=-1)
               for s in (greedy, sampled)}
    _reset_counts(kernel_mods)
    results = []
    for sc, n_prompt in requests:
        prompt = [1] + rng.integers(3, cfg.n_vocab, size=n_prompt - 1).tolist()
        r = engines[id(sc)].generate(prompt, max_new_tokens=64)
        kind = "greedy" if sc.greedy else "T=0.8 k=40 p=0.95"
        log(f"request prompt={n_prompt} tok ({kind}): {len(r.tokens)} generated, "
            f"prefill {r.prefill_seconds:.3f} s, decode {r.decode_tokens_per_second:.1f} tok/s")
        if len(r.tokens) < 64 or not all(0 <= t < cfg.n_vocab for t in r.tokens):
            raise AssertionError(f"request produced {len(r.tokens)} tokens out of range or short")
        results.append(r)
    counts = _read_counts(kernel_mods)
    log(f"kernel launches in the serve run: {counts}")
    log(f"peak device memory {torch.cuda.max_memory_allocated() / 1e9:.3f} GB")
    _check_path(counts, ["q4_matmul", FFN_Q4_0, "flash_decode", "flash_attention"],
                ["qk_matmul", "flash_decode_attend"])
    _profile_request(engines[id(greedy)], [1] + rng.integers(3, cfg.n_vocab, size=4).tolist())
    return counts, params


def phase_int8_serve(cfg, params, kernel_mods, on_path, off_path) -> dict:
    """Engine(cache_dtype="auto") at n_ctx 2048, which picks the int8 cache:
    3 greedy requests (prompts of 5, 300 and 1500 tokens, 64 new tokens
    each), then profiled decode windows at 1500 live tokens against a bf16
    cache.  Returns the launch counts of the 3 requests."""
    import torch

    from tokenhawk_tpu_torch.config import SamplingConfig
    from tokenhawk_tpu_torch.runtime.engine import Engine
    from tokenhawk_tpu_torch.tokenizer import byte_fallback_vocab

    log(f"== phase 4i: Engine, LLaMA-7B Q4_0 widths, {cfg.n_layer} layers, cache_dtype auto at "
        f"n_ctx {cfg.n_ctx}")
    eng = Engine(cfg, params, byte_fallback_vocab(), sampling=SamplingConfig(temperature=0.0),
                 cache_dtype="auto", eos_id=-1)
    if eng.cache_dtype != "int8":
        raise AssertionError(f"cache_dtype auto at n_ctx {INT8_CTX} chose {eng.cache_dtype}")
    nbytes = sum(x.nbytes for lc in eng.new_cache(1).layers() for x in lc)
    log(f"auto chose {eng.cache_dtype}: cache {nbytes / 1e9:.3f} GB for one sequence of "
        f"{INT8_CTX}")
    rng = np.random.default_rng(SEED + 5)
    _reset_counts(kernel_mods)
    decode_s = n_dec = 0
    for n_prompt in (5, 300, 1500):
        prompt = [1] + rng.integers(3, cfg.n_vocab, size=n_prompt - 1).tolist()
        r = eng.generate(prompt, max_new_tokens=64)
        log(f"int8 request prompt={n_prompt} tok (greedy): {len(r.tokens)} generated, prefill "
            f"{r.prefill_seconds:.3f} s, decode {r.decode_tokens_per_second:.1f} tok/s")
        if len(r.tokens) != 64 or not all(0 <= t < cfg.n_vocab for t in r.tokens):
            raise AssertionError(f"request produced {len(r.tokens)} tokens out of range or short")
        decode_s += r.decode_seconds
        n_dec += len(r.tokens)
    counts = _read_counts(kernel_mods)
    log(f"3 int8 requests: decode {n_dec / decode_s:.1f} tok/s over {n_dec} tokens; kernel "
        f"launches {counts}; peak device memory {torch.cuda.max_memory_allocated() / 1e9:.3f} GB")
    _check_path(counts, on_path, off_path)
    # Decode at 1500 live tokens, int8 against bf16 K/V, in turns.
    bf16 = Engine(cfg, params, byte_fallback_vocab(), sampling=SamplingConfig(temperature=0.0),
                  cache_dtype=torch.bfloat16, eos_id=-1)
    prompt = [1] + rng.integers(3, cfg.n_vocab, size=1499).tolist()
    for e in (eng, bf16, bf16, eng):
        _decode_window(e, prompt)
    return counts


def _decode_window(engine, prompt, chunks: int = 4, kernel_mods=(),
                   profiled: bool = True) -> dict:
    """Device busy time against wall time over `chunks` greedy decode
    chunks after the prompt's prefill (outside the window), the host
    reading each chunk's ids as Engine.generate does.  Returns the
    window's tok/s, tokens and the launches of kernel_mods' kernels in it,
    and, profiled, its idle share and device ms per token.  Unprofiled,
    the wall time carries no profiler cost per launch."""
    import contextlib

    import torch
    from torch.profiler import ProfilerActivity, profile

    dev = engine.device
    cache, logits, _ = engine.prefill(engine.new_cache(1), [prompt])
    tok = logits.argmax(-1)
    offsets = torch.tensor([len(prompt)], dtype=torch.int32, device=dev)
    last_n = torch.full((1, max(engine.sampling.repeat_last_n, 1)), -1, dtype=torch.int64,
                        device=dev)
    done = torch.zeros(1, dtype=torch.bool, device=dev)
    torch.cuda.synchronize()
    _reset_counts(kernel_mods)
    with (profile(activities=[ProfilerActivity.CUDA]) if profiled
          else contextlib.nullcontext()) as prof:
        t0 = time.perf_counter()
        for _ in range(chunks):
            cache, toks, offsets, last_n, done = engine._decode(
                engine.params, cache, tok, offsets, last_n, done, engine.generator)
            tok = toks[:, -1]
            toks.tolist()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    counts = _read_counts(kernel_mods)
    n = chunks * engine.decode_chunk
    if not profiled:
        return {"tok_s": n / wall, "tokens": n, "counts": counts}
    avgs = sorted(prof.key_averages(), key=lambda e: -e.self_device_time_total)
    busy = sum(e.self_device_time_total for e in avgs) / 1e6
    attn = [e for e in avgs if "decode_int8_kernel" in e.key or "decode_append_kernel" in e.key]
    log(f"decode window, {engine.cache_dtype} cache, {len(prompt)}+ live tokens, {n} tokens "
        f"(profiler on): wall {wall * 1e3:.1f} ms ({n / wall:.1f} tok/s), device busy "
        f"{busy * 1e3:.1f} ms ({n / busy:.1f} tok/s), idle share {1 - busy / wall:.1%}; "
        + ", ".join(f"{_kernel_name(e.key)} {e.self_device_time_total / max(e.count, 1):.2f} us "
                    f"x {e.count}" for e in attn))
    return {"tok_s": n / wall, "idle": 1 - busy / wall, "tokens": n, "counts": counts,
            "device_ms": busy * 1e3 / n}


def _profile_request(engine, prompt) -> None:
    """Where a request's time goes: wall clock against the device's busy
    time (kernels summed by the profiler), and the largest kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        r = engine.generate(prompt, max_new_tokens=32)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    avgs = sorted(prof.key_averages(), key=lambda e: -e.self_device_time_total)
    busy = sum(e.self_device_time_total for e in avgs) / 1e6
    log(f"profiled request ({len(prompt)}-token prompt, {len(r.tokens)} tokens, under the "
        f"profiler): wall {wall * 1e3:.1f} ms, device busy {busy * 1e3:.1f} ms, "
        f"idle share {1 - busy / wall:.1%}")
    for e in avgs[:8]:
        log(f"  {e.self_device_time_total / 1e3:9.3f} ms  {e.count:6d}x  {_kernel_name(e.key)}")


def _kernel_name(key: str) -> str:
    """A profiler key without its argument list (kernels in an anonymous
    namespace keep their name)."""
    return key.replace("(anonymous namespace)::", "").split("(")[0].replace("void ", "")[:90]


def _padded_vocab(V: int):
    """Byte-fallback tokens padded with unused pieces to V: (tokens, scores)."""
    from tokenhawk_tpu_torch.tokenizer import byte_fallback_vocab

    vocab = byte_fallback_vocab()
    return (vocab.id_to_token + [f"<unused{i}>".encode() for i in range(V - vocab.n_vocab)],
            vocab.scores + [-1e9] * (V - vocab.n_vocab))


def write_two_layer_file(path: str) -> None:
    """A random 2-layer LLaMA-7B-width ggjt Q4_0 file (phases 4c and 5)."""
    import torch

    from tokenhawk_tpu_torch.ggml.format import GGMLType
    from tokenhawk_tpu_torch.ggml.quants import QuantizedTensor
    from tokenhawk_tpu_torch.ggml.writer import write_ggml
    from tokenhawk_tpu_torch.ops.qweight import QWeight

    cfg = _seven_b(2)
    D, F, V = cfg.n_embd, cfg.n_ff, cfg.n_vocab
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(SEED + 2)

    def q4(out_dim, in_dim):  # random [out, in] GGML tensor, quantized on the GPU
        w = QWeight.quantize(torch.randn(in_dim, out_dim, generator=g, device=dev) * 0.02)
        codes = w.codes().cpu().numpy().astype(np.int16)
        return QuantizedTensor(GGMLType.Q4_0, (out_dim, in_dim),
                               (codes - 8).astype(np.int8), w.scales.cpu().numpy())

    def gain():
        return (1.0 + 0.1 * torch.randn(D, generator=g, device=dev)).cpu().numpy()

    tensors = {"tok_embeddings.weight": q4(V, D), "norm.weight": gain(), "output.weight": q4(V, D)}
    for i in range(cfg.n_layer):
        p = f"layers.{i}."
        tensors.update({
            p + "attention.wq.weight": q4(D, D), p + "attention.wk.weight": q4(D, D),
            p + "attention.wv.weight": q4(D, D), p + "attention.wo.weight": q4(D, D),
            p + "feed_forward.w1.weight": q4(F, D), p + "feed_forward.w2.weight": q4(D, F),
            p + "feed_forward.w3.weight": q4(F, D),
            p + "attention_norm.weight": gain(), p + "ffn_norm.weight": gain()})
    tokens, scores = _padded_vocab(V)
    hp = dict(n_vocab=V, n_embd=D, n_mult=cfg.n_mult, n_head=cfg.n_head,
              n_layer=cfg.n_layer, n_rot=cfg.head_dim, ftype=2)
    write_ggml(path, hp, tokens, scores, tensors)
    log(f"wrote {path} ({os.path.getsize(path) / 1e6:.1f} MB)")


def phase_cli(path: str) -> None:
    from tokenhawk_tpu_torch import cli
    from tokenhawk_tpu_torch.ops.cuda import flash_decode, kv_int8

    log("== phase 5: CLI on a 2-layer 7B-width ggjt Q4_0 file, bf16 KV, then --kv auto")
    for extra in (["--n-ctx", "512"], ["--kv", "auto", "--n-ctx", str(INT8_CTX)]):
        _reset_counts([flash_decode, kv_int8])
        rc = cli.main(["-m", path, "Hello", "--greedy", "--max-tokens", "16", *extra])
        sys.stderr.flush()
        counts = _read_counts([flash_decode, kv_int8])
        if rc != 0:
            raise AssertionError(f"cli {extra} returned {rc}")
        int8 = "--kv" in extra
        _check_path(counts, ["flash_decode_int8"] if int8 else ["flash_decode"],
                    ["flash_decode"] if int8 else ["flash_decode_int8"])
        log(f"cli {' '.join(extra)}: exit 0, decode kernel launches {counts}")


def _reset_counts(mods) -> None:
    for m in mods:
        m.launches.update(dict.fromkeys(m.launches, 0))


def _read_counts(mods) -> dict:
    """The kernels of `mods` that launched, with their counts."""
    return {k: v for m in mods for k, v in m.launches.items() if v}


def _check_path(counts: dict, on_path, off_path) -> None:
    """Every kernel of a path launched in its run, and none of another's."""
    missed = [k for k in on_path if counts.get(k, 0) <= 0]
    strays = [k for k in off_path if counts.get(k, 0) != 0]
    if missed or strays:
        raise AssertionError(f"kernels never launched: {missed}; kernels of another path "
                             f"launched: {strays} ({counts})")


def phase_paged_serve(params, cfg, kernel_mods, kv: str, on_path, off_path, title: str):
    """The paged server's main path at full width (cfg at n_ctx 2048), on
    bf16 pages (phases 4b and 6) or int8 pages (phase 4bi).  Returns
    (launch counts of the run, the scheduler)."""
    import torch

    from tokenhawk_tpu_torch.config import SamplingConfig
    from tokenhawk_tpu_torch.runtime.paged_scheduler import PagedScheduler
    from tokenhawk_tpu_torch.runtime.scheduler import Request

    log(f"== {title}: {kv} pages of 128, max_batch 8, n_ctx 2048, prefix cache, "
        f"prefill chunk 512")
    greedy = SamplingConfig(temperature=0.0)
    sampled = SamplingConfig(temperature=0.8, top_k=40, top_p=0.95, seed=SEED)
    sched = PagedScheduler(cfg, params, sampling=greedy, max_batch=8, max_seq=2048,
                           page_size=PAGED_PS, prefix_cache=True, prefill_chunk=512, eos_id=-1,
                           cache_dtype="int8" if kv == "int8" else torch.bfloat16)
    log(f"pool: {sched.n_pages} pages of {PAGED_PS} tokens, layout {sched.layout}, {kv}, "
        f"{sched.cache.nbytes / 1e9:.3f} GB")
    rng = np.random.default_rng(SEED + 4)
    V = cfg.n_vocab
    shared = [1] + rng.integers(3, V, 383).tolist()  # 3 full pages
    prompts = [shared + rng.integers(3, V, 20 + 10 * i).tolist() for i in range(4)]
    prompts += [[1] + rng.integers(3, V, n - 1).tolist()
                for n in (1500, 5, 100, 300, 37, 700, 64, 200)]
    reqs = [Request(prompt=p, max_new_tokens=64, sampling=sampled if i % 2 else None)
            for i, p in enumerate(prompts)]
    decode = {"s": 0.0, "chunks": 0}
    run_decode = sched._decode

    def timed_decode(*args):
        t = time.perf_counter()
        out = run_decode(*args)
        torch.cuda.synchronize()  # the step reads the ids right after anyway
        decode["s"] += time.perf_counter() - t
        decode["chunks"] += 1
        return out

    sched._decode = timed_decode
    _reset_counts(kernel_mods)
    t0 = time.perf_counter()
    for r in reqs:
        sched.submit(r)
    sched.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _read_counts(kernel_mods)
    sched._decode = run_decode
    n_out = sum(len(r.output) for r in reqs)
    log(f"{kv} pages: 12 requests ({sum(len(p) for p in prompts)} prompt tokens, {n_out} "
        f"generated) in {wall:.2f} s: {n_out / wall:.1f} tok/s overall; decode "
        f"{decode['chunks']} chunks, "
        f"{decode['s']:.2f} s, {(n_out - len(reqs)) / decode['s']:.1f} tok/s")
    for r in reqs:
        log(f"  prompt {len(r.prompt):5d} tok, {'sampled' if r.sampling else 'greedy '}: "
            f"{len(r.output)} tokens, {r.finish_reason}, ttft {r.ttft_seconds:.3f} s")
    log(f"prefix cache hits {sched.prefix_hits} pages; kernel launches in the run: {counts}")
    bad = [(len(r.output), r.finish_reason) for r in reqs
           if r.finish_reason != "length" or len(r.output) != 64
           or not all(0 <= t < V for t in r.output)]
    if bad:
        raise AssertionError(f"requests that did not finish cleanly: {bad}")
    if sched.prefix_hits <= 0:
        raise AssertionError("the shared prefix was never reused")
    _check_path(counts, on_path, off_path)
    parked = set(sched._pc.values())
    if (sched.alloc.n_free + len(parked) != sched.n_pages - 1
            or any(sched.page_refs.get(p, 0) for p in parked)):
        raise AssertionError(f"page leak: {sched.alloc.n_free} free + {len(parked)} cached "
                             f"of {sched.n_pages}")
    log(f"pages: {sched.alloc.n_free} free + {len(parked)} cached at refcount 0 + 1 trash "
        f"= {sched.n_pages}; peak device memory {torch.cuda.max_memory_allocated() / 1e9:.3f} GB")
    _profile_paged(sched, rng, V)
    return counts, sched


def _profile_paged(sched, rng, V) -> None:
    """Device busy time against wall time over the decode of 8 concurrent
    greedy requests (100-token prompts, 32 tokens each): the admission
    step runs first, outside the profiler; the window holds the three
    decode chunks that follow."""
    import re

    import torch
    from torch.profiler import ProfilerActivity, profile

    from tokenhawk_tpu_torch.runtime.scheduler import Request

    reqs = [Request(prompt=[1] + rng.integers(3, V, 99).tolist(), max_new_tokens=32)
            for _ in range(8)]
    for r in reqs:
        sched.submit(r)
    sched.step()  # admissions (prefill) and the first decode chunk
    torch.cuda.synchronize()
    before = sum(len(r.output) for r in reqs)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        steps = 0
        while sched.has_work:
            sched.step()
            steps += 1
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    avgs = sorted(prof.key_averages(), key=lambda e: -e.self_device_time_total)
    busy = sum(e.self_device_time_total for e in avgs) / 1e6
    n_tok = sum(len(r.output) for r in reqs) - before
    log(f"profiled paged decode (8 slots, {steps} chunks, {n_tok} tokens, profiler on): wall "
        f"{wall * 1e3:.1f} ms, device busy {busy * 1e3:.1f} ms, idle share {1 - busy / wall:.1%}")
    for e in avgs[:8]:
        log(f"  {e.self_device_time_total / 1e3:9.3f} ms  {e.count:6d}x  {_kernel_name(e.key)}")
    for e in avgs:
        m = re.search(r"paged_decode(_int8)?_kernel|paged_append(_int8)?_kernel|"
                      r"gather_pages(_int8)?_kernel", e.key)
        if m:
            log(f"  {m.group(0)}: {e.self_device_time_total / 1e3:.3f} ms over {e.count} "
                f"launches, {e.self_device_time_total / max(e.count, 1):.2f} us each")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _post(url: str, payload: dict, timeout: float = 600) -> str:
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.read().decode()


def _get_json(url: str, timeout: float = 30) -> dict:
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return json.loads(r.read())


def _sse_finish(body: str) -> tuple:
    """(finish_reason, number of token frames) of a /generate SSE body."""
    frames = [f for f in body.split("\n\n") if f.strip()]
    if not frames or not frames[-1].startswith("event: done"):
        raise AssertionError(f"stream did not end with event: done: {body[-300:]!r}")
    return (json.loads(frames[-1].split("data: ", 1)[1])["finish_reason"],
            sum(f.startswith("data: ") for f in frames))


def phase_http(sched, tokenizer, model_path: str, tmp: str) -> None:
    from tokenhawk_tpu_torch.serving.server import serve

    log("== phase 4c: HTTP, serve() over the paged scheduler, then the entry point, "
        "dense and paged")
    httpd = serve(sched, tokenizer, host="127.0.0.1", port=0,
                  model_info={"model": "llama-7b-q4_0-random"})
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        bodies = [None] * 4

        def stream(i):
            bodies[i] = _post(base + "/generate", {"prompt": f"Request {i}: tell me a story",
                                                   "max_tokens": 32})

        t0 = time.perf_counter()
        threads = [threading.Thread(target=stream, args=(i,)) for i in range(4)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=600)
        ends = [_sse_finish(b) if b else ("no response", 0) for b in bodies]
        comp = json.loads(_post(base + "/v1/completions", {"prompt": "Hello", "max_tokens": 16}))
        health = _get_json(base + "/health")
        log(f"4 concurrent /generate streams in {time.perf_counter() - t0:.2f} s: "
            f"(finish, token frames) {ends}; /v1/completions finish "
            f"{comp['choices'][0]['finish_reason']}, {comp['usage']}; /health steps "
            f"{health['steps']}, step_errors {health['step_errors']}")
        if health["step_errors"] != 0:
            raise AssertionError(f"the serving loop swallowed step errors: {health['last_error']}")
        if any(r not in ("length", "stop") for r, _ in ends) or \
                comp["choices"][0]["finish_reason"] not in ("length", "stop"):
            raise AssertionError(f"a request did not finish cleanly: {ends}, {comp}")
    finally:
        httpd.shutdown()
        httpd.serving_loop.stop()

    root = os.path.dirname(os.path.abspath(__file__))
    _concurrently(*(lambda e=extra: _serve_subprocess(root, model_path, tmp, e) for extra in
                    ([], ["--paged", "--prefill-chunk", "128"], ["--paged", "--kv", "int8"])))


def _concurrently(*calls) -> list:
    """Run the zero-argument calls in threads and return their results,
    raising the first error.  Subprocesses that load a model (the entry
    points) spend most of their time on host work, so they overlap."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(len(calls)) as ex:
        futures = [ex.submit(c) for c in calls]
        return [f.result() for f in futures]


def _cli_subprocess(root: str, args: list, marker: str, env=None) -> None:
    """`python -m tokenhawk_tpu_torch.cli ARGS` (with `env` added to its
    environment): exit 0 and a stats line holding `marker` on stderr."""
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-m", "tokenhawk_tpu_torch.cli", *args], cwd=root,
                         capture_output=True, text=True, timeout=600,
                         env=dict(os.environ, PYTHONPATH=root, **(env or {})))
    line = [ln for ln in out.stderr.splitlines() if marker in ln]
    label = " ".join(f"{k}={v}" for k, v in (env or {}).items())
    log(f"{label} cli {' '.join(a for a in args if a.startswith('--'))}: exit "
        f"{out.returncode} in {time.perf_counter() - t0:.1f} s; "
        f"{line[-1] if line else out.stderr[-2000:]}")
    if out.returncode != 0 or not line:
        raise AssertionError(f"the CLI failed: {out.stderr[-3000:]}")


def _serve_subprocess(root: str, model_path: str, tmp: str, extra: list, env=None,
                      finishes=("length", "stop")) -> None:
    """`python -m tokenhawk_tpu_torch.serving` on the 2-layer file (with
    `env` added to its environment): wait for /health, stream one request
    to one of `finishes`, stop the process."""
    port = _free_port()
    kind = "PagedScheduler" if "--paged" in extra else "dense Scheduler"
    log_path = os.path.join(tmp, f"serving_{port}.log")
    cmd = [sys.executable, "-m", "tokenhawk_tpu_torch.serving", "-m", model_path,
           "--port", str(port), "--n-ctx", "512", "--max-batch", "2", "--greedy", *extra]
    base = f"http://127.0.0.1:{port}"
    t0 = time.perf_counter()
    with open(log_path, "w") as out:
        proc = subprocess.Popen(cmd, cwd=root, stdout=out, stderr=subprocess.STDOUT,
                                env=dict(os.environ, PYTHONPATH=root, **(env or {})))
        try:
            while True:
                try:
                    _get_json(base + "/health", timeout=5)
                    break
                except OSError:
                    if proc.poll() is not None or time.perf_counter() - t0 > 300:
                        raise AssertionError("the server did not come up:\n"
                                             + open(log_path).read()[-3000:])
                    time.sleep(0.5)
            up = time.perf_counter() - t0
            reason, n = _sse_finish(_post(base + "/generate", {"prompt": "Hello",
                                                               "max_tokens": 16}))
            health = _get_json(base + "/health")
            log(f"{' '.join(['python -m tokenhawk_tpu_torch.serving', *extra])} ({kind}, "
                f"2-layer file): up in {up:.1f} s, /generate finish {reason} with {n} token "
                f"frames, step_errors {health['step_errors']}")
            if (reason not in finishes or health["step_errors"] != 0
                    or health.get("speculative") != ("--draft-model" in extra)):
                raise AssertionError(open(log_path).read()[-3000:])
        finally:
            proc.terminate()
            try:
                proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()


def _engine_requests(cfg, params, kernel_mods, prompts, on_path, off_path) -> dict:
    """Greedy Engine.generate at cfg.n_ctx over bf16 KV, 64 new tokens for
    each prompt length, then a profiled request (the idle share).  Returns
    the launch counts of the requests."""
    import torch

    from tokenhawk_tpu_torch.config import SamplingConfig
    from tokenhawk_tpu_torch.runtime.engine import Engine
    from tokenhawk_tpu_torch.tokenizer import byte_fallback_vocab

    eng = Engine(cfg, params, byte_fallback_vocab(), sampling=SamplingConfig(temperature=0.0),
                 max_seq=cfg.n_ctx, eos_id=-1)
    rng = np.random.default_rng(SEED + 7)
    _reset_counts(kernel_mods)
    decode_s = n_dec = 0
    for n_prompt in prompts:
        prompt = [1] + rng.integers(3, cfg.n_vocab, size=n_prompt - 1).tolist()
        r = eng.generate(prompt, max_new_tokens=64)
        log(f"request prompt={n_prompt} tok (greedy): {len(r.tokens)} generated, prefill "
            f"{r.prefill_seconds:.3f} s, decode {r.decode_tokens_per_second:.1f} tok/s")
        if len(r.tokens) != 64 or not all(0 <= t < cfg.n_vocab for t in r.tokens):
            raise AssertionError(f"request produced {len(r.tokens)} tokens out of range or short")
        decode_s += r.decode_seconds
        n_dec += len(r.tokens)
    counts = _read_counts(kernel_mods)
    log(f"{len(prompts)} requests: decode {n_dec / decode_s:.1f} tok/s over {n_dec} tokens; "
        f"kernel launches {counts}; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB")
    _check_path(counts, on_path, off_path)
    _profile_request(eng, [1] + rng.integers(3, cfg.n_vocab, size=4).tolist())
    return counts


def _model(cfg, quant: str, label: str, sb: bool = False):
    import torch

    t0 = time.perf_counter()
    params = _params(cfg, torch.device("cuda"), quant, sb)
    torch.cuda.synchronize()
    split = sum(lp.wqkv is None for lp in params.layers)
    gb, file_gb = _weight_gb(params)
    log(f"{label}: built in {time.perf_counter() - t0:.1f} s, projections and head "
        f"{gb:.3f} GB in the port's layout, {file_gb:.3f} GB in GGML blocks (a decode step "
        f"must read them once: {file_gb * 1e12 / HBM_BPS:.3f} ms at the HBM rate; "
        f"{gb * 1e12 / HBM_BPS:.3f} ms in the port's layout), allocated "
        f"{torch.cuda.memory_allocated() / 1e9:.3f} GB; "
        f"{split} of {cfg.n_layer} layers keep wq | wk | wv apart")
    return params, split


def phase_q4_k_m(kernel_mods, engine_path, paged_path) -> tuple:
    """Phase 6: the Llama-3-8B-width model in the Q4_K_M mix (Q4KM_LAYERS)
    through Engine (prompts of 5, 300 and 1500 tokens) and the
    PagedScheduler (phase 4b's requests).  Returns both runs' counts."""
    import torch

    from tokenhawk_tpu_torch.models.llama import q4_k_m_more_bits

    log(f"== phase 6: Llama-3-8B widths in llama.cpp's Q4_K_M mix, {Q4KM_LAYERS} layers, Engine "
        f"at n_ctx {INT8_CTX}, bf16 KV")
    cfg = _llama3_8b(Q4KM_LAYERS, INT8_CTX)
    params, split = _model(cfg, "q4_k_m", "Q4_K_M model")
    if split != sum(q4_k_m_more_bits(i, cfg.n_layer) for i in range(cfg.n_layer)):
        raise AssertionError(f"{split} layers unfused, not the recipe's Q6_K-wv layers")
    counts = _engine_requests(cfg, params, kernel_mods, (5, 300, 1500), *engine_path)
    paged, sched = phase_paged_serve(params, cfg, kernel_mods, "bf16", *paged_path,
                                     "phase 6 (paged): the Q4_K_M model under PagedScheduler")
    sched.cache = None
    del sched, params
    torch.cuda.empty_cache()
    return counts, paged


def phase_q8_0(kernel_mods, engine_path) -> dict:
    """Phase 6q: the 32-layer LLaMA-7B model in Q8_0 through Engine."""
    import torch

    log(f"== phase 6q: LLaMA-7B in Q8_0, 32 layers, Engine at n_ctx {INT8_CTX}, bf16 KV")
    cfg = dataclasses.replace(_seven_b(32), n_ctx=INT8_CTX)
    params, _ = _model(cfg, "q8_0", "Q8_0 model")
    counts = _engine_requests(cfg, params, kernel_mods, (5, 300), *engine_path)
    del params
    torch.cuda.empty_cache()
    return counts


# Phase 7's server: the flags of the served model; the stop check replays
# them in process to find the tokens the server will produce.
SERVE_GGUF_ARGS = ["--paged", "--greedy", "--n-ctx", str(S_CTX), "--max-batch", "2"]
STOP_PROMPT = "Once upon a time, in a land far away,"
EOT_ID = 128009


def phase_gguf(tmp: str, kernel_mods) -> str:
    """Phase 7: a 2-layer Llama-3-8B-width Q4_K_M GGUF through load_model,
    the CLI and the paged server; a request stops on <|eot_id|>.  Returns
    the file's path (phase 11 loads it again)."""
    import torch

    from tokenhawk_tpu_torch import cli
    from tokenhawk_tpu_torch.config import SamplingConfig
    from tokenhawk_tpu_torch.ggml import synth
    from tokenhawk_tpu_torch.runtime.loader import load_model
    from tokenhawk_tpu_torch.runtime.paged_scheduler import PagedScheduler
    from tokenhawk_tpu_torch.serving.__main__ import build_parser
    from tokenhawk_tpu_torch.tokenizer_bpe import BpeTokenizer

    log("== phase 7: a 2-layer Llama-3-8B-width Q4_K_M GGUF file, byte-level BPE vocab of 128256")
    cfg = _llama3_8b(2)
    path = os.path.join(tmp, "llama3-8b-2layer-q4_k_m.gguf")
    t0 = time.perf_counter()
    md = synth.bpe_vocab_metadata(cfg.n_vocab, np.random.default_rng(SEED + 8))
    synth.write_random_llama(path, cfg, "q4_k_m", md, seed=SEED + 9)
    log(f"wrote {path} ({os.path.getsize(path) / 1e6:.1f} MB) in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    lcfg, params, tok = load_model(path, n_ctx=S_CTX)
    torch.cuda.synchronize()
    log(f"load_model in {time.perf_counter() - t0:.1f} s: {type(tok).__name__} ({tok.pre}), "
        f"bos {tok.bos_id}, eog {sorted(tok.eog_ids)}; n_kv_head {lcfg.n_kv_head}, rope base "
        f"{lcfg.rope_theta}, eps {lcfg.rms_norm_eps}, n_ff {lcfg.n_ff}")
    # GGUF stores the eps as float32.
    want = (cfg.n_kv_head, cfg.rope_theta, float(np.float32(cfg.rms_norm_eps)), cfg.n_ff,
            cfg.n_vocab)
    got = (lcfg.n_kv_head, lcfg.rope_theta, lcfg.rms_norm_eps, lcfg.n_ff, lcfg.n_vocab)
    if got != want or not isinstance(tok, BpeTokenizer) or tok.bos_id != 128000 \
            or not {128001, EOT_ID} <= tok.eog_ids:
        raise AssertionError(f"GGUF metadata read as {got}, tokenizer {type(tok).__name__} "
                             f"bos {tok.bos_id} eog {tok.eog_ids}")
    if not (params.layers[0].wqkv is not None and params.layers[1].wqkv is None
            and params.output.group == 16 and params.output.mins is None):
        raise AssertionError("the file's Q4_K / Q6_K mix did not load as in the reference")
    # The server's first three greedy tokens for STOP_PROMPT, replayed here.
    args = build_parser().parse_args(["-m", path, *SERVE_GGUF_ARGS])
    sampling = SamplingConfig(temperature=0.0, top_k=args.top_k, top_p=args.top_p,
                              repeat_penalty=args.repeat_penalty, seed=args.seed)
    sched = PagedScheduler(lcfg, params, sampling=sampling, max_batch=args.max_batch,
                           max_seq=args.n_ctx, decode_chunk=args.decode_chunk,
                           page_size=args.page_size, cache_dtype=torch.bfloat16,
                           prefill_chunk=args.prefill_chunk, prefix_cache=args.prefix_cache,
                           eos_id=-1)
    head = sched.generate_many([tok.encode_prompt(STOP_PROMPT)], max_new_tokens=3)[0].output
    if len(set(head)) != 3 or set(head) & tok.eog_ids:
        raise AssertionError(f"greedy head {head} cannot carry the stop check")
    sched.cache = None
    del sched, params
    torch.cuda.empty_cache()

    # The CLI with --kv auto (int8 at n_ctx 2048); its bf16 run on a file
    # is phase 5's, and each load of this file takes 35-50 s of host time.
    # The server loads its copy of the file meanwhile.
    def run_cli():
        extra = ["--kv", "auto", "--n-ctx", str(INT8_CTX)]
        _reset_counts(kernel_mods)
        rc = cli.main(["-m", path, "Hello, my name is", "--greedy", "--max-tokens", "16",
                       *extra])
        sys.stderr.flush()
        counts = _read_counts(kernel_mods)
        if rc != 0:
            raise AssertionError(f"cli {extra} returned {rc}")
        _check_path(counts, ["qk_matmul", *FFN_Q4_K_M, "flash_decode_int8"],
                    ["q4_matmul", "flash_decode", "qk_sb_matmul", *FFN_SB])
        log(f"cli on the GGUF {' '.join(extra)}: exit 0, kernel launches {counts}")

    # The server's copy swaps the head rows of the third token and
    # <|eot_id|>: its third greedy token for STOP_PROMPT becomes <|eot_id|>.
    served = os.path.join(tmp, "llama3-8b-2layer-q4_k_m-eot.gguf")
    shutil.copyfile(path, served)
    synth.swap_output_rows(served, head[2], EOT_ID)
    _concurrently(run_cli, lambda: _serve_gguf(served, tmp, tok, md["tokenizer.chat_template"]))
    os.remove(served)
    return path


def _serve_gguf(path: str, tmp: str, tok, template: str) -> None:
    """`python -m tokenhawk_tpu_torch.serving --paged` on phase 7's file:
    STOP_PROMPT ends on <|eot_id|> after two tokens, a plain request
    streams, a chat request renders the file's template, 0 step errors."""
    from tokenhawk_tpu_torch.serving.server import _render_chat_template

    root = os.path.dirname(os.path.abspath(__file__))
    port = _free_port()
    log_path = os.path.join(tmp, "serving_gguf.log")
    cmd = [sys.executable, "-m", "tokenhawk_tpu_torch.serving", "-m", path, "--port", str(port),
           *SERVE_GGUF_ARGS]
    base = f"http://127.0.0.1:{port}"
    t0 = time.perf_counter()
    with open(log_path, "w") as out:
        proc = subprocess.Popen(cmd, cwd=root, stdout=out, stderr=subprocess.STDOUT,
                                env=dict(os.environ, PYTHONPATH=root))
        try:
            while True:
                try:
                    _get_json(base + "/health", timeout=5)
                    break
                except OSError:
                    if proc.poll() is not None or time.perf_counter() - t0 > 300:
                        raise AssertionError("the server did not come up:\n"
                                             + open(log_path).read()[-3000:])
                    time.sleep(0.5)
            up = time.perf_counter() - t0
            stop, n_stop = _sse_finish(_post(base + "/generate", {"prompt": STOP_PROMPT,
                                                                  "max_tokens": 8}))
            plain, n_plain = _sse_finish(_post(base + "/generate", {"prompt": "Hello",
                                                                    "max_tokens": 16}))
            messages = [{"role": "user", "content": "Hi there"}]
            chat = json.loads(_post(base + "/v1/chat/completions",
                                    {"messages": messages, "max_tokens": 8}))
            n_chat = len(tok.encode_prompt(_render_chat_template(template, messages)))
            health = _get_json(base + "/health")
            log(f"serving --paged on the GGUF: up in {up:.1f} s; stop prompt finish {stop} after "
                f"{n_stop} token frames; plain finish {plain} with {n_plain}; chat finish "
                f"{chat['choices'][0]['finish_reason']}, prompt tokens "
                f"{chat['usage']['prompt_tokens']} (template: {n_chat}); step_errors "
                f"{health['step_errors']}")
            if stop != "eos" or n_stop != 2:
                raise AssertionError(f"the stop prompt did not end on <|eot_id|> after 2 tokens: "
                                     f"{stop}, {n_stop}")
            if plain not in ("length", "eos", "stop") or chat["usage"]["prompt_tokens"] != n_chat \
                    or health["step_errors"] != 0:
                raise AssertionError(open(log_path).read()[-3000:])
        finally:
            proc.terminate()
            try:
                proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()


def _flat(params):
    """params with every q4k_sb weight in the flat qk form of its codes
    (QWeight.flat: what a load without THAWK_Q4K_SB gives at float32 sides)."""
    from tokenhawk_tpu_torch.ops.qweight import QWeight

    return _map_weights(params, lambda w: w.flat() if isinstance(w, QWeight)
                        and w.kind == "q4k_sb" else w)


def _sides_as(params, dtype):
    """params with every quantized weight's scales and mins rounded to
    dtype, as load_model's scale_dtype rounds them: d / dmin of a q4k_sb
    weight, s and the bias of a flat one."""
    from tokenhawk_tpu_torch.ops.qweight import QWeight

    def rounded(w):
        if not isinstance(w, QWeight):
            return w
        return dataclasses.replace(w, scales=w.scales.to(dtype).float(),
                                   mins=None if w.mins is None else w.mins.to(dtype).float())

    return _map_weights(params, rounded)


def _kernel13_weights(run) -> set:
    """The (group, mins, K) of every weight that went to kernel 13 (the qk
    forms) through the model's projections while run() ran."""
    from tokenhawk_tpu_torch.ops import linear

    seen, plain = set(), linear.quant_matmul

    def spy(x, w, *args, **kwargs):
        if w.kind == "qk":
            seen.add((w.group, w.mins is not None, w.shape[0]))
        return plain(x, w, *args, **kwargs)

    linear.quant_matmul = spy
    try:
        run()
    finally:
        linear.quant_matmul = plain
    return seen


def phase_q4k_sb(kernel_mods, engine_path, paged_path) -> tuple:
    """Phase 11a: the Llama-3-8B-width Q4_K_M model of phase 6 (Q4KM_LAYERS) with the
    forms THAWK_Q4K_SB=1 gives (init_params(sb=True): q4k_sb for every Q4_K
    weight but w2) through Engine (prompts of 5, 300 and 1500 tokens) and
    the PagedScheduler (phase 4b's requests); kernel 13 may take only the
    Q6_K weights and the flat w2.  Between them, decode windows at B=1 on
    these weights and on the flat form of the same codes, in turns (device
    ms a token, idle share).  Returns both runs' counts."""
    import torch

    from tokenhawk_tpu_torch.config import SamplingConfig
    from tokenhawk_tpu_torch.runtime.engine import Engine
    from tokenhawk_tpu_torch.tokenizer import byte_fallback_vocab

    log(f"== phase 11a: Llama-3-8B widths in Q4_K_M, super-block forms (THAWK_Q4K_SB=1's), "
        f"{Q4KM_LAYERS} layers, Engine at n_ctx {INT8_CTX}, bf16 KV")
    cfg = _llama3_8b(Q4KM_LAYERS, INT8_CTX)
    params, _ = _model(cfg, "q4_k_m", "Q4_K_M model in super-block forms", sb=True)
    kinds = {}
    for lp in params.layers:
        for name in ("wqkv", "wq", "wk", "wv", "wo", "w13", "w2"):
            w = getattr(lp, name)
            if w is not None:
                kinds.setdefault(name, set()).add(
                    w.kind if w.kind == "q4k_sb" else f"qk G{w.group}")
    log(f"weight kinds by projection: { {k: sorted(v) for k, v in kinds.items()} }; head "
        f"qk G{params.output.group}")
    if (kinds["wo"] != {"q4k_sb"} or kinds["w13"] != {"q4k_sb"} or "q4k_sb" in kinds["w2"]
            or kinds["wv"] != {"qk G16"} or kinds["wqkv"] != {"q4k_sb"}):
        raise AssertionError(f"the super-block forms are not where the reference's gate "
                             f"puts them: {kinds}")
    counts = {}
    seen = _kernel13_weights(lambda: counts.update(
        _engine_requests(cfg, params, kernel_mods, (5, 300, 1500), *engine_path)))
    log(f"kernel 13 took (group, mins, K): {sorted(seen)}")
    if not seen or not all(g == 16 or (g, k) == (32, cfg.n_ff) for g, _, k in seen):
        raise AssertionError(f"kernel 13 took weights other than Q6_K and the flat w2: {seen}")
    flat = _flat(params)
    greedy = SamplingConfig(temperature=0.0)
    engines = {form: Engine(cfg, p, byte_fallback_vocab(), sampling=greedy, max_seq=cfg.n_ctx,
                            eos_id=-1) for form, p in (("sb", params), ("flat", flat))}
    prompt = [1] + np.random.default_rng(SEED + 11).integers(3, cfg.n_vocab, 299).tolist()
    windows = {"sb": [], "flat": []}
    for form in ("sb", "flat", "flat", "sb"):
        w = _decode_window(engines[form], prompt, chunks=4, kernel_mods=kernel_mods)
        windows[form].append(w)
        log(f"  {form}: {w['device_ms']:.4f} device ms a token, idle {w['idle']:.1%}, "
            f"{w['tok_s']:.1f} tok/s (profiled)")
    sb_counts, flat_counts = windows["sb"][0]["counts"], windows["flat"][0]["counts"]
    if not sb_counts.get("qk_sb_matmul") or flat_counts.get("qk_sb_matmul"):
        raise AssertionError(f"decode windows: sb {sb_counts}, flat {flat_counts}")
    log("device ms a token at B=1, 300+ live, sb against the flat form of the same codes: "
        + ", ".join(f"{f} {[round(w['device_ms'], 4) for w in ws]}"
                    for f, ws in windows.items()))
    del engines, flat
    torch.cuda.empty_cache()
    paged, sched = phase_paged_serve(params, cfg, kernel_mods, "bf16", *paged_path,
                                     "phase 11a (paged): the super-block model under "
                                     "PagedScheduler")
    sched.cache = None
    del sched, params
    torch.cuda.empty_cache()
    return counts, paged


def phase_gguf_sb(path: str, tmp: str) -> None:
    """Phases 11b and 11c on phase 7's 2-layer Llama-3-8B-width Q4_K_M GGUF
    file.  11b: load_model with THAWK_Q4K_SB=1 at float32 sides (sb kinds
    where the reference's gate puts them); its greedy stream over 32 tokens
    against the flat form of the same weights (what a load without the flag
    gives), equal up to near-ties, as phase 9's rule has it; then the CLI and
    `serving --paged` with THAWK_Q4K_SB=1 in their environment.  11c:
    runtime/eval.perplexity over a seeded stream of 4 windows of 512 tokens,
    sb against flat, at float32 sides and at bfloat16 sides (the loader's
    default; there the two forms round different sides)."""
    import torch

    from tokenhawk_tpu_torch.config import SamplingConfig
    from tokenhawk_tpu_torch.runtime import eval as th_eval
    from tokenhawk_tpu_torch.runtime.engine import Engine
    from tokenhawk_tpu_torch.runtime.loader import load_model

    log("== phase 11b: phase 7's GGUF file loaded with THAWK_Q4K_SB=1, float32 sides; the CLI "
        "and `serving --paged` with the flag load it meanwhile")
    sb_env = {"THAWK_Q4K_SB": "1"}
    root = os.path.dirname(os.path.abspath(__file__))

    def load():
        t0 = time.perf_counter()
        os.environ.update(sb_env)
        try:
            loaded = load_model(path, n_ctx=S_CTX, scale_dtype=torch.float32)
        finally:
            del os.environ["THAWK_Q4K_SB"]
        torch.cuda.synchronize()
        log(f"load_model in {time.perf_counter() - t0:.1f} s")
        return loaded

    # A random model may meet <|eot_id|>: a request may end there.
    (cfg, params, tok), _, _ = _concurrently(
        load,
        lambda: _cli_subprocess(root, ["-m", path, "Hello, my name is", "--greedy",
                                       "--max-tokens", "16", "--n-ctx", str(S_CTX)], "tok/s",
                                sb_env),
        lambda: _serve_subprocess(root, path, tmp, ["--paged"], env=sb_env,
                                  finishes=("length", "stop", "eos")))
    l0, l1 = params.layers
    got = [w.kind for w in (l0.wqkv, l0.wo, l0.w13, l1.wq, l1.wk, l1.wo, l1.w13)]
    log(f"layer 0 wqkv, wo, w13 and layer 1 wq, wk, wo, w13: {got}; w2 {l0.w2.kind} "
        f"G{l0.w2.group}, {l1.w2.kind} G{l1.w2.group}; layer 1 wv {l1.wv.kind} G{l1.wv.group}; "
        f"projections and head {_weight_gb(params)[0]:.3f} GB (flat form: "
        f"{_weight_gb(_flat(params))[0]:.3f})")
    if got != ["q4k_sb"] * 7 or "q4k_sb" in (l0.w2.kind, l1.w2.kind, l1.wv.kind):
        raise AssertionError("the file did not load in the reference's super-block forms")
    flat = _flat(params)
    greedy = SamplingConfig(temperature=0.0)
    engines = [Engine(cfg, p, tok, sampling=greedy, max_seq=S_CTX, eos_id=-1)
               for p in (flat, params)]
    prompt = tok.encode_prompt(STOP_PROMPT)
    stream = engines[1].generate(prompt, max_new_tokens=32).tokens
    forms = _stream_forms(engines[0].device, [_engine_form(e, prompt) for e in engines],
                          prompt, len(stream))
    _check_greedy_identity("11b sb stream against the flat form's", stream, forms)

    log("== phase 11c: runtime/eval.perplexity, sb against flat, 4 windows of 512 tokens")
    toks = np.random.default_rng(SEED + 12).integers(0, cfg.n_vocab, 4 * 512).tolist()

    def nll(p, label):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        v = th_eval.mean_nll(cfg, p, toks, window=512)
        torch.cuda.synchronize()
        log(f"  {label}: perplexity {np.exp(v):.4f} (mean nll {v:.6f}), "
            f"{(time.perf_counter() - t0) / 4:.3f} s a window")
        return v

    for sides in ("float32", "bfloat16"):
        got = {form: nll(_sides_as(p, getattr(torch, sides)), f"{form}, {sides} sides")
               for form, p in (("sb", params), ("flat", flat))}
        log(f"  {sides} sides, bfloat16 activations: log(ppl_sb / ppl_flat) = "
            f"{got['sb'] - got['flat']:.3e}")
        if not all(np.isfinite(v) for v in got.values()):
            raise AssertionError(f"perplexity not finite: {got}")
    # float32 sides and activations: the two forms hold the same weights, so
    # their scores differ by summation order alone.
    ratio = (nll(_float32(params), "sb, float32 sides and activations")
             - nll(_float32(flat), "flat, float32 sides and activations"))
    log(f"  float32 sides and activations: log(ppl_sb / ppl_flat) = {ratio:.3e} (tolerance "
        f"{F32_FORMS_TOL:g})")
    if not abs(ratio) < F32_FORMS_TOL:
        raise AssertionError(f"sb and flat perplexities apart by {ratio} in log")
    del engines, params, flat
    torch.cuda.empty_cache()


# TinyLlama-1.1B's published widths (TinyLlama/TinyLlama-1.1B-Chat-v1.0,
# config.json): 32 heads over 4 KV heads of 64, n_ff 5632, LLaMA's vocab.
def _tinyllama(n_layer: int = 22, n_ctx: int = S_CTX):
    from tokenhawk_tpu_torch.config import LlamaConfig

    return LlamaConfig(n_vocab=32000, n_embd=2048, n_head=32, n_kv_head=4, n_layer=n_layer,
                       n_ff=5632, n_ctx=n_ctx, rope_theta=10000.0, rms_norm_eps=1e-5)


def _dense_gb(params) -> float:
    """GB a decode step reads of dense weights: every projection, the head,
    the norm gains (the embedding row is negligible)."""
    ws = [params.output, params.norm] + [w for lp in params.layers for w in (
        lp.wqkv, lp.wq, lp.wk, lp.wv, lp.wo, lp.w13, lp.w1, lp.w3, lp.w2, lp.attn_norm,
        lp.ffn_norm) if w is not None]
    return sum(w.nbytes for w in ws) / 1e9


def phase_dense_7b(kernel_mods) -> dict:
    """Phase 8: LLaMA-7B with dense weights (TokenHawk's f16 config: the
    loader casts f16 to bf16; here random bf16 weights drawn on the card)
    through Engine, bf16 KV, n_ctx 512: the reference's dense-weight
    decode route, an index copy then kernel 14; kernel 4 prefills; kernels
    1, 2 and 3 stay off.  Returns the launch counts of the requests."""
    import torch

    from tokenhawk_tpu_torch.ops.cuda import ffn

    log(f"== phase 8: LLaMA-7B with dense bf16 weights, 32 layers, Engine, bf16 KV, n_ctx {S_CTX}")
    cfg = _seven_b(32)
    t0 = time.perf_counter()
    params = _params(cfg, torch.device("cuda"), None)
    torch.cuda.synchronize()
    gb = _dense_gb(params)
    log(f"dense weights built in {time.perf_counter() - t0:.1f} s: {gb:.3f} GB read per decode "
        f"step, {gb * 1e12 / HBM_BPS:.3f} ms at the HBM rate ({HBM_BPS / (gb * 1e9):.1f} tok/s "
        f"roofline); allocated {torch.cuda.memory_allocated() / 1e9:.3f} GB")
    counts = _engine_requests(cfg, params, kernel_mods, (5, 300),
                              ["flash_decode_attend", "flash_attention"],
                              ["q4_matmul", "qk_matmul", "flash_decode", *ffn.launches])
    del params
    torch.cuda.empty_cache()
    return counts


def _decode_and_verify_forms(engine, prompt, n: int, gamma: int) -> tuple:
    """The Engine's greedy stream for `prompt` (its prefill, then one
    decode forward per token, as its chunks run them: kernel 3) and, at
    every step, the logits the speculative verify computes for the same
    history when it accepts no draft: row 0 of a (gamma+1)-row block over
    a cache the blocks wrote (kernel 4, the projections at gamma+1 rows).
    Rows past 0 cannot reach row 0 (causal mask), so filler tokens stand
    in for the drafts.  Returns, per step: the Engine's token, the
    verify form's argmax, the Engine logits' top-two gap and the two
    forms' largest logit difference, both over the largest |logit|."""
    import torch

    from tokenhawk_tpu_torch.models.llama import forward, logits_from_hidden

    cfg, params, dev = engine.cfg, engine.params, engine.device
    (c_dec, lg, _), (c_ver, _, _) = (engine.prefill(engine.new_cache(1), [prompt])
                                     for _ in range(2))
    lg_d = lg_v = lg[0].float()
    toks, vtoks, gaps, diffs = [], [], [], []
    with torch.inference_mode():
        for i in range(n):
            top = torch.topk(lg_d, 2).values
            big = lg_d.abs().max()
            gaps.append(float((top[0] - top[1]) / big))
            diffs.append(float((lg_d - lg_v).abs().max() / big))
            toks.append(int(lg_d.argmax()))
            vtoks.append(int(lg_v.argmax()))
            pos = torch.tensor([len(prompt) + i], dtype=torch.int32, device=dev)
            h, _ = forward(cfg, params, torch.tensor([[toks[-1]]], device=dev), c_dec, pos)
            lg_d = logits_from_hidden(cfg, params, h[:, 0])[0].float()
            block = torch.tensor([[toks[-1]] * (gamma + 1)], device=dev)
            h, _ = forward(cfg, params, block, c_ver, pos)
            lg_v = logits_from_hidden(cfg, params, h[:, 0])[0].float()
    return toks, vtoks, gaps, diffs


def _check_greedy_identity(label: str, spec_toks, forms, band_tol: float = SLICE_TOL) -> None:
    """A stream (speculative, or fused) against the Engine's greedy
    stream: equal, or first apart at a step where the other form's own
    arithmetic chose the stream's token (that form's argmax: the verify's,
    or the fused forward's) at a near-tie: the top two Engine logits closer
    than the two forms' logits differ (a flip needs gap <= 2 x that
    difference).  The difference itself must stay under band_tol of the
    largest |logit|: bfloat16 rounding under SLICE_TOL, as the slices; in
    float32 under F32_FORMS_TOL, which shows the bfloat16 spread is
    rounding and not a fault of the other form."""
    want, vtoks, gaps, diffs = forms
    band = max(diffs[:len(spec_toks)])
    i = next((j for j, (a, b) in enumerate(zip(spec_toks, want)) if a != b), None)
    if not band < band_tol:
        raise AssertionError(f"{label}: the forms' logits differ by {band:.3e}, "
                             f"over {band_tol:g}")
    if i is None:
        log(f"{label}: stream = Engine's greedy stream ({len(want)} tokens); the two forms' "
            f"logits differ by at most {band:.3e} of the largest |logit| "
            f"(tolerance {band_tol:g}); smallest top-two gap {min(gaps):.3e}")
        return
    log(f"{label}: first differs from the Engine's greedy stream at step {i}, where its top-two "
        f"logit gap is {gaps[i]:.3%} of the largest |logit| (within 1%: {gaps[i] <= 0.01}); "
        f"there the other form's logits differ from the decode's by {diffs[i]:.3%} (at most "
        f"{band:.3%} over the steps), and that form picks the stream's token: "
        f"{vtoks[i] == spec_toks[i]}")
    if spec_toks[i] != vtoks[i] or not gaps[i] <= 2 * diffs[i]:
        raise AssertionError(f"{label}: stream diverges at step {i}: gap {gaps[i]}, "
                             f"difference {diffs[i]}, the other form's token {vtoks[i]}, "
                             f"the stream's {spec_toks[i]}")


def _profiled(run) -> tuple:
    """(wall s, device busy s) of run() under the profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return wall, sum(e.self_device_time_total for e in prof.key_averages()) / 1e6


def _map_weights(params, fn):
    """params with fn applied to each of its tensors and QWeights."""
    layers = [dataclasses.replace(lp, **{f.name: fn(getattr(lp, f.name))
                                         for f in dataclasses.fields(lp)})
              for lp in params.layers]
    return dataclasses.replace(params, tok_embd=fn(params.tok_embd), layers=layers,
                               norm=fn(params.norm), output=fn(params.output))


def _dequantized(params):
    """A dense float32 copy of a quantized model's parameters."""
    import torch

    from tokenhawk_tpu_torch.ops.qweight import QWeight

    return _map_weights(params, lambda w: w.dequantize(torch.float32)
                        if isinstance(w, QWeight) else w)


def _float32(params):
    """params with every dense tensor in float32, so the activations are
    float32 too; quantized weights are shared."""
    import torch

    return _map_weights(params, lambda w: w.float() if isinstance(w, torch.Tensor) else w)


def _f32_identity_witness(params, draft, cfg, prompts) -> None:
    """9a in float32: the same Q4_0 target with float32 activations and
    cache, drafted by the draft's first 2 layers in float32 (a draft sets
    only the speed).  The speculative stream and the verify form must match
    the Engine's greedy decode within F32_FORMS_TOL at every step."""
    import torch

    from tokenhawk_tpu_torch.config import SamplingConfig
    from tokenhawk_tpu_torch.runtime.engine import Engine
    from tokenhawk_tpu_torch.runtime.speculative import SpeculativeEngine

    log("== phase 9a, float32 witness: the 9a target with float32 activations and cache, the "
        "draft's first 2 layers in float32, gamma 4")
    target = _float32(params)
    spec = SpeculativeEngine(cfg, target, _tinyllama(2),
                             _float32(dataclasses.replace(draft, layers=draft.layers[:2])),
                             gamma=4, max_seq=S_CTX, cache_dtype=torch.float32, eos_id=-1)
    engine = Engine(cfg, target, sampling=SamplingConfig(temperature=0.0), max_seq=S_CTX,
                    cache_dtype=torch.float32, eos_id=-1)
    for p in prompts:
        toks, _, _ = _spec_engine_run(spec, p, "9a f32")
        _check_greedy_identity(f"9a f32 prompt={len(p)}", toks,
                               _decode_and_verify_forms(engine, p, len(toks), spec.gamma),
                               F32_FORMS_TOL)


def _spec_engine_run(spec, prompt, label, n_new: int = 64) -> tuple:
    """One SpeculativeEngine.generate of n_new tokens: logs and returns
    (tokens, stats, decode tok/s)."""
    toks, stats = spec.generate(prompt, max_new_tokens=n_new)
    tps = (len(toks) - 1) / stats["decode_seconds"]
    log(f"{label} prompt={len(prompt)} tok: {len(toks)} tokens in {stats['rounds']} rounds, "
        f"acceptance {stats['acceptance_rate']:.1%}, {stats['tokens_per_round']:.2f} tokens per "
        f"round, prefill {stats['prefill_seconds']:.3f} s, decode {tps:.1f} tok/s")
    return toks, stats, tps


def phase_speculation(params, kernel_mods, model_path: str, tmp: str) -> dict:
    """Phase 9: speculative decoding.  9a: SpeculativeEngine, the LLaMA-7B
    Q4_0 target (its first SPEC_LAYERS layers) with a 22-layer
    TinyLlama-width bf16 draft, gamma
    4, prompts of 5 and 300 tokens, 64 new tokens, each stream held
    against the Engine's greedy stream, then again with float32
    activations and cache; 9b: a 2-layer 7B-width Q4_0 target drafted by
    its own weights dequantized to float32 (the first round accepts all
    drafts; over 64 tokens acceptance >= 15%, >= 1.6 tokens per round; the
    stream is the Engine's); 9c: PagedScheduler with the draft, 8 slots, 12 requests, half
    sampled; 9d: the CLI and `serving --paged` with --draft-model, as
    subprocesses, on phase 5's 2-layer ggjt file and a 2-layer
    TinyLlama-width F16 GGUF draft.  Returns 9a's launch counts."""
    import torch

    from tokenhawk_tpu_torch.config import SamplingConfig
    from tokenhawk_tpu_torch.models.llama import fuse_params, init_params
    from tokenhawk_tpu_torch.runtime.engine import Engine
    from tokenhawk_tpu_torch.runtime.speculative import SpeculativeEngine

    dev = torch.device("cuda")
    cfg = _seven_b(SPEC_LAYERS)
    params = dataclasses.replace(params, layers=params.layers[:SPEC_LAYERS])
    dcfg = _tinyllama(22)
    log(f"== phase 9a: SpeculativeEngine, LLaMA-7B Q4_0 target ({SPEC_LAYERS} layers), "
        f"TinyLlama-width draft "
        f"({dcfg.n_layer} layers, dense bf16, {dcfg.n_kv_head} KV heads of {dcfg.head_dim}), "
        f"gamma 4, n_ctx {S_CTX}")
    t0 = time.perf_counter()
    draft = _params(dcfg, dev, None)
    torch.cuda.synchronize()
    log(f"draft built in {time.perf_counter() - t0:.1f} s: {_dense_gb(draft):.3f} GB")
    spec = SpeculativeEngine(cfg, params, dcfg, draft, gamma=4, max_seq=S_CTX, eos_id=-1)
    engine = Engine(cfg, params, sampling=SamplingConfig(temperature=0.0), max_seq=S_CTX,
                    eos_id=-1)
    rng = np.random.default_rng(SEED + 11)
    prompts = [[1] + rng.integers(3, cfg.n_vocab, n - 1).tolist() for n in (5, 300)]
    _reset_counts(kernel_mods)
    runs = [_spec_engine_run(spec, p, "9a") for p in prompts]
    counts = _read_counts(kernel_mods)
    log(f"9a kernel launches: {counts}")
    _check_path(counts, ["q4_matmul", FFN_Q4_0, "flash_attention", "flash_decode_attend"],
                ["flash_decode", "qk_matmul", "flash_decode_int8", "flash_attention_int8",
                 "paged_decode", "paged_append", "gather_pages"])
    for p, (toks, _, _) in zip(prompts, runs):
        _check_greedy_identity(f"9a prompt={len(p)}", toks,
                               _decode_and_verify_forms(engine, p, len(toks), spec.gamma))
    wall, busy = _profiled(lambda: spec.generate(prompts[0], max_new_tokens=16))
    log(f"9a profiled request (5-token prompt, 16 tokens, profiler on): wall {wall * 1e3:.1f} ms, "
        f"device busy {busy * 1e3:.1f} ms, idle share {1 - busy / wall:.1%}")
    _f32_identity_witness(params, draft, cfg, prompts)

    log("== phase 9b: self-draft, a 2-layer 7B-width Q4_0 target and its weights dequantized to "
        "float32 as the draft, f32 activations and cache, gamma 4")
    cfg2 = _seven_b(2)
    g = torch.Generator(device=dev)
    g.manual_seed(SEED + 12)
    target2 = fuse_params(init_params(cfg2, g, dtype=torch.float32, device=dev, quant="q4_0"))
    self_spec = SpeculativeEngine(cfg2, target2, cfg2, _dequantized(target2), gamma=4,
                                  max_seq=S_CTX, cache_dtype=torch.float32, eos_id=-1)
    # The first round drafts over a cache the prefill filled whole: it
    # accepts all 4 drafts.  Later rounds miss the row of the last draft of
    # each round that accepted all (as the reference's rounds do), so the
    # acceptance over 64 tokens is lower.
    _, first = self_spec.generate(prompts[1], max_new_tokens=6)
    toks, stats, _ = _spec_engine_run(self_spec, prompts[1], "9b")
    log(f"9b first round: {first['accepted_drafts']} of 4 drafts accepted")
    if (first["rounds"], first["accepted_drafts"]) != (1, 4) or stats["acceptance_rate"] < 0.15 \
            or stats["tokens_per_round"] < 1.6:
        raise AssertionError(f"self-draft acceptance: first round {first}, 64 tokens {stats}")
    engine2 = Engine(cfg2, target2, sampling=SamplingConfig(temperature=0.0), max_seq=S_CTX,
                     cache_dtype=torch.float32, eos_id=-1)
    _check_greedy_identity(f"9b prompt={len(prompts[1])}", toks,
                           _decode_and_verify_forms(engine2, prompts[1], len(toks), 4),
                           F32_FORMS_TOL)
    wall, busy = _profiled(lambda: self_spec.generate(prompts[0], max_new_tokens=32))
    log(f"9b profiled request (5-token prompt, 32 tokens): wall {wall * 1e3:.1f} ms, device busy "
        f"{busy * 1e3:.1f} ms, idle share {1 - busy / wall:.1%}")
    del self_spec, engine2, target2

    _paged_speculation(params, draft, cfg, dcfg, kernel_mods)
    del draft, spec
    torch.cuda.empty_cache()
    _speculation_subprocesses(model_path, tmp)
    return counts


def _paged_speculation(params, draft, cfg, dcfg, kernel_mods) -> None:
    """Phase 9c: PagedScheduler with the TinyLlama-width draft over the
    7B Q4_0 target at n_ctx 2048 (pages of 128, prefix cache, prefill
    chunks of 512): phase 4b's 12 prompts, half sampled, 32 tokens each;
    every request ends at its length, no page leaks."""
    import torch

    from tokenhawk_tpu_torch.config import SamplingConfig
    from tokenhawk_tpu_torch.runtime.paged_scheduler import PagedScheduler
    from tokenhawk_tpu_torch.runtime.scheduler import Request

    log("== phase 9c: PagedScheduler with the draft, 8 slots, n_ctx 2048, pages of 128, prefix "
        "cache, prefill chunks of 512, gamma 4")
    cfg = dataclasses.replace(cfg, n_ctx=2048)
    dcfg = dataclasses.replace(dcfg, n_ctx=2048)
    sampled = SamplingConfig(temperature=0.8, top_k=40, top_p=0.95, seed=SEED)
    sched = PagedScheduler(cfg, params, sampling=SamplingConfig(temperature=0.0), max_batch=8,
                           max_seq=2048, page_size=PAGED_PS, prefix_cache=True,
                           prefill_chunk=512, eos_id=-1, draft_cfg=dcfg, draft_params=draft,
                           gamma=4)
    stats = {"rounds": 0, "slot_rounds": 0, "committed": 0}

    def counted(fn):
        def run(*args):
            out = fn(*args)
            stats["rounds"] += 1
            stats["slot_rounds"] += int((~args[7]).sum())  # live slots of the round
            stats["committed"] += int(out[3].sum())
            return out
        return run

    sched._spec_step = counted(sched._spec_step)
    sched._spec_step_sampled = counted(sched._spec_step_sampled)
    rng = np.random.default_rng(SEED + 4)
    V = cfg.n_vocab
    shared = [1] + rng.integers(3, V, 383).tolist()
    prompts = [shared + rng.integers(3, V, 20 + 10 * i).tolist() for i in range(4)]
    prompts += [[1] + rng.integers(3, V, n - 1).tolist()
                for n in (1500, 5, 100, 300, 37, 700, 64, 200)]
    reqs = [Request(prompt=p, max_new_tokens=32, sampling=sampled if i % 2 else None)
            for i, p in enumerate(prompts)]
    _reset_counts(kernel_mods)
    t0 = time.perf_counter()
    for r in reqs:
        sched.submit(r)
    sched.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _read_counts(kernel_mods)
    n_out = sum(len(r.output) for r in reqs)
    per = stats["committed"] / max(stats["slot_rounds"], 1)
    log(f"9c: 12 requests, {n_out} tokens in {wall:.2f} s ({n_out / wall:.1f} tok/s overall), "
        f"{stats['rounds']} rounds, {per:.2f} tokens per slot-round, acceptance "
        f"{(per - 1) / 4:.1%}, prefix cache hits {sched.prefix_hits}; kernel launches {counts}")
    bad = [(len(r.output), r.finish_reason) for r in reqs
           if r.finish_reason != "length" or len(r.output) != 32
           or not all(0 <= t < V for t in r.output)]
    if bad:
        raise AssertionError(f"requests that did not finish cleanly: {bad}")
    _check_path(counts, ["q4_matmul", "flash_attention", "flash_decode_attend", "paged_append",
                         "gather_pages"],
                ["paged_decode", "flash_decode", "qk_matmul", "flash_decode_int8",
                 "paged_decode_int8", "paged_append_int8", "gather_pages_int8"])
    parked = set(sched._pc.values())
    if (sched.alloc.n_free + len(parked) != sched.n_pages - 1
            or any(sched.page_refs.get(p, 0) for p in parked)):
        raise AssertionError(f"page leak: {sched.alloc.n_free} free + {len(parked)} cached "
                             f"of {sched.n_pages}")
    log(f"pages: {sched.alloc.n_free} free + {len(parked)} cached + 1 trash = {sched.n_pages}")
    _profile_paged(sched, rng, V)
    sched.cache = sched.draft_cache = None


def _spm_metadata(n_vocab: int) -> dict:
    """GGUF tokenizer metadata of a SentencePiece vocab of n_vocab pieces."""
    tokens = ["<unk>", "<s>", "</s>"] + [f"<0x{b:02X}>" for b in range(256)]
    tokens += [f"▁w{i}" for i in range(n_vocab - len(tokens))]
    return {"tokenizer.ggml.model": "llama", "tokenizer.ggml.tokens": tokens,
            "tokenizer.ggml.scores": [0.0] * 259 + [-1.0 - i for i in range(n_vocab - 259)],
            "tokenizer.ggml.token_type": [2, 3, 3] + [6] * 256 + [1] * (n_vocab - 259),
            "tokenizer.ggml.bos_token_id": 1, "tokenizer.ggml.eos_token_id": 2}


def write_tinyllama_gguf(path: str) -> None:
    """A random 2-layer TinyLlama-width GGUF in F16 (4 KV heads, which a
    ggjt header cannot carry) with a 32000-piece SentencePiece vocab."""
    import torch

    from tokenhawk_tpu_torch.ggml.gguf import write_gguf
    from tokenhawk_tpu_torch.ggml.synth import llama_metadata

    cfg = _tinyllama(2)
    D, F, V, Dkv = cfg.n_embd, cfg.n_ff, cfg.n_vocab, cfg.n_embd_kv
    g = torch.Generator(device="cuda")
    g.manual_seed(SEED + 13)

    def w(*shape, scale=0.02):
        return (torch.randn(shape, generator=g, device="cuda") * scale).half().cpu().numpy()

    def gain():
        return (1.0 + w(D, scale=0.1).astype(np.float32))

    tensors = {"token_embd.weight": w(V, D), "output_norm.weight": gain(), "output.weight": w(V, D)}
    for i in range(cfg.n_layer):
        p = f"blk.{i}."
        tensors.update({
            p + "attn_norm.weight": gain(), p + "attn_q.weight": w(D, D),
            p + "attn_k.weight": w(Dkv, D), p + "attn_v.weight": w(Dkv, D),
            p + "attn_output.weight": w(D, D), p + "ffn_norm.weight": gain(),
            p + "ffn_gate.weight": w(F, D), p + "ffn_down.weight": w(D, F),
            p + "ffn_up.weight": w(F, D)})
    # general.file_type 1: llama.cpp's LLAMA_FTYPE_MOSTLY_F16
    write_gguf(path, {**llama_metadata(cfg, 1), **_spm_metadata(V)}, tensors)
    log(f"wrote {path} ({os.path.getsize(path) / 1e6:.1f} MB)")


def _speculation_subprocesses(model_path: str, tmp: str) -> None:
    """Phase 9d: `python -m tokenhawk_tpu_torch.cli --draft-model` and
    `python -m tokenhawk_tpu_torch.serving --paged --draft-model`, the
    target phase 5's 2-layer 7B-width Q4_0 ggjt file, the draft a 2-layer
    TinyLlama-width F16 GGUF file."""
    log("== phase 9d: the CLI and `serving --paged` with --draft-model (subprocesses; their "
        "idle share not measured)")
    draft_path = os.path.join(tmp, "tinyllama-2layer-f16.gguf")
    write_tinyllama_gguf(draft_path)
    root = os.path.dirname(os.path.abspath(__file__))
    _concurrently(
        lambda: _cli_subprocess(root, ["-m", model_path, "Hello", "--greedy", "--max-tokens",
                                       "32", "--n-ctx", str(S_CTX), "--draft-model", draft_path,
                                       "--gamma", "4"], "tok/round"),
        lambda: _serve_subprocess(root, model_path, tmp, ["--paged", "--draft-model",
                                                          draft_path, "--gamma", "4"]))


# Kernel 15's and kernel 16's launch keys (ops/cuda/ffn.py, flash_decode.py).
OWO_Q4_0 = "owo_ffn[q4_0/q4_0]"
ATTN_WO = "attn_wo"


def _stream_forms(dev, forms, prompt, n: int) -> tuple:
    """Two forms of one model, each a (prefill, step) pair: prefill() ->
    (cache, logits [1, V]) for `prompt`, step(tok [1, 1], cache, pos) ->
    logits [1, V].  The first form's greedy stream (its prefill, then one
    step a token) and, at every step on the same history, the second
    form's logits over a cache of its own.  Returns per step: the stream's
    token, the second form's argmax, the first logits' top-two gap and the
    two forms' largest logit difference, both over the largest |logit|."""
    import torch

    caches, lgs = [], []
    for prefill, _ in forms:
        c, lg = prefill()
        caches.append(c)
        lgs.append(lg[0].float())
    toks, otoks, gaps, diffs = [], [], [], []
    with torch.inference_mode():
        for i in range(n):
            la, lb = lgs
            top = torch.topk(la, 2).values
            big = la.abs().max()
            gaps.append(float((top[0] - top[1]) / big))
            diffs.append(float((la - lb).abs().max() / big))
            toks.append(int(la.argmax()))
            otoks.append(int(lb.argmax()))
            pos = torch.tensor([len(prompt) + i], dtype=torch.int32, device=dev)
            tok = torch.tensor([[toks[-1]]], device=dev)
            for j, (_, step) in enumerate(forms):
                lgs[j] = step(tok, caches[j], pos)[0].float()
    return toks, otoks, gaps, diffs


def _engine_form(engine, prompt):
    """An Engine's (prefill, step) pair for _stream_forms."""
    from tokenhawk_tpu_torch.models.llama import forward, logits_from_hidden

    cfg, params = engine.cfg, engine.params

    def step(tok, cache, pos):
        h, _ = forward(cfg, params, tok, cache, pos)
        return logits_from_hidden(cfg, params, h[:, 0])

    return (lambda: engine.prefill(engine.new_cache(1), [prompt])[:2]), step


def _fused_forms(engine, prompt, n: int, fusions) -> tuple:
    """_stream_forms for the fused decode-layer kernels: the unfused form's
    stream against the form with `fusions`, both on engine's params."""
    from tokenhawk_tpu_torch.models.llama import Fusions

    params = engine.params
    prefill, step = _engine_form(engine, prompt)

    def with_fusions(f, run):
        def call(*args):
            params.fusions = f
            try:
                return run(*args)
            finally:
                params.fusions = Fusions()
        return call

    return _stream_forms(engine.device, [(with_fusions(f, prefill), with_fusions(f, step))
                                         for f in (Fusions(), fusions)], prompt, n)


def phase_fused_engine(params, kernel_mods) -> dict:
    """Phase 10a: the reference's fused decode-layer kernels on the LLaMA-7B
    Q4_0 Engine (phase 4's params, their first FUSED_LAYERS layers, n_ctx
    512): with neither, OWO
    (kernel 15), ATTN (kernel 16) and both, in turns, two rounds, the
    second in reverse order.  At each first turn, greedy requests of 5 and
    300 prompt tokens, 64 new tokens each (their launches); at every turn
    two decode windows after the 300-token prompt, one unprofiled (64
    tokens: tok/s) and one under the profiler (32 tokens: idle share,
    device ms a token), whose launches per token must be exactly the
    form's: kernel 3 and Wo's kernel-1 launches gone under ATTN, kernel 2
    gone under OWO alone.  Each fused stream is held to the unfused one up
    to near-ties, as phase 9a holds its streams, and in float32 (at B=1
    "both" decodes as ATTN does, kernel 16 then kernel 2, so a "both"
    stream equal to ATTN's needs no second check).  Returns each form's
    request launches."""
    from tokenhawk_tpu_torch.config import SamplingConfig
    from tokenhawk_tpu_torch.models.llama import Fusions
    from tokenhawk_tpu_torch.runtime.engine import Engine
    from tokenhawk_tpu_torch.tokenizer import byte_fallback_vocab

    log(f"== phase 10a: fused decode-layer kernels, LLaMA-7B Q4_0, {FUSED_LAYERS} layers, "
        f"Engine, bf16 KV, n_ctx {S_CTX}: neither, OWO (kernel 15), ATTN (kernel 16), both, "
        f"in turns")
    cfg = _seven_b(FUSED_LAYERS)
    params = dataclasses.replace(params, layers=params.layers[:FUSED_LAYERS])
    L = cfg.n_layer
    eng = Engine(cfg, params, byte_fallback_vocab(), sampling=SamplingConfig(temperature=0.0),
                 max_seq=S_CTX, eos_id=-1)
    rng = np.random.default_rng(SEED + 21)
    prompts = [[1] + rng.integers(3, cfg.n_vocab, n - 1).tolist() for n in (5, 300)]
    forms = {"neither": Fusions(), "owo": Fusions(owo=True), "attn": Fusions(attn=True),
             "both": Fusions(owo=True, attn=True)}
    # Launches per decode token: wqkv and the head are kernel 1 in every form.
    per_token = {"neither": {"q4_matmul": 2 * L + 1, "flash_decode": L, FFN_Q4_0: L},
                 "owo": {"q4_matmul": L + 1, "flash_decode": L, OWO_Q4_0: L},
                 "attn": {"q4_matmul": L + 1, ATTN_WO: L, FFN_Q4_0: L},
                 "both": {"q4_matmul": L + 1, ATTN_WO: L, FFN_Q4_0: L}}
    streams, requests, windows = {}, {}, {k: [] for k in forms}
    order = ["neither", "owo", "attn", "both"]
    try:
        for name in order + order[::-1]:
            params.fusions = forms[name]
            if name not in streams:
                _reset_counts(kernel_mods)
                runs = [eng.generate(p, max_new_tokens=64) for p in prompts]
                requests[name] = _read_counts(kernel_mods)
                streams[name] = [r.tokens for r in runs]
                log(f"10a {name}: requests of {[len(p) for p in prompts]} prompt tokens decode "
                    f"{', '.join(f'{r.decode_tokens_per_second:.1f}' for r in runs)} tok/s; "
                    f"launches {requests[name]}")
                if any(len(r.tokens) != 64 for r in runs):
                    raise AssertionError(f"10a {name}: a request ended short")
            t = _decode_window(eng, prompts[1], 8, kernel_mods, profiled=False)
            w = _decode_window(eng, prompts[1], kernel_mods=kernel_mods)
            for x in (t, w):
                want = {k: v * x["tokens"] for k, v in per_token[name].items()}
                if x["counts"] != want:
                    raise AssertionError(f"10a {name}: decode launches {x['counts']}, want {want}")
            windows[name].append((t["tok_s"], w["idle"], w["device_ms"]))
    finally:
        params.fusions = Fusions()
    for name in ("owo", "attn", "both"):
        for i, (p, got, want) in enumerate(zip(prompts, streams[name], streams["neither"])):
            label = f"10a {name} prompt={len(p)}"
            if got == want:
                log(f"{label}: stream = the unfused greedy stream ({len(want)} tokens)")
            elif name == "both" and got == streams["attn"][i]:
                log(f"{label}: stream = ATTN's stream ({len(want)} tokens), checked above")
            else:
                _check_greedy_identity(label, got, _fused_forms(eng, p, len(want), forms[name]),
                                       DEEP_BF16_TOL)
    _fused_f32_witness(params, prompts[0], {k: forms[k] for k in ("owo", "attn")},
                       kernel_mods)
    log("10a A/B, decode windows at 300+ live tokens, per form in turns: tok/s unprofiled "
        "(median) | idle share and device ms a token under the profiler:")
    for k, v in windows.items():
        log(f"  {k:7s} " + ", ".join(f"{x[0]:.1f}" for x in v)
            + f" ({float(np.median([x[0] for x in v])):.1f}) | "
            + ", ".join(f"{x[1]:.1%} {x[2]:.3f}" for x in v))
    return requests


def _fused_f32_witness(params, prompt, forms, kernel_mods) -> None:
    """10a in float32: the same Q4_0 model with float32 activations and
    cache; each fused greedy stream (32 tokens, its fused kernel launched)
    and, step by step, the fused forward's logits against the unfused ones
    within F32_FORMS_TOL."""
    import torch

    from tokenhawk_tpu_torch.config import SamplingConfig
    from tokenhawk_tpu_torch.models.llama import Fusions
    from tokenhawk_tpu_torch.runtime.engine import Engine

    log("== phase 10a, float32 witness: the 10a model with float32 activations and cache")
    target = _float32(params)
    eng = Engine(_seven_b(len(params.layers)), target, sampling=SamplingConfig(temperature=0.0),
                 max_seq=S_CTX, cache_dtype=torch.float32, eos_id=-1)
    for name, fusions in forms.items():
        target.fusions = fusions
        _reset_counts(kernel_mods)
        try:
            toks = eng.generate(prompt, max_new_tokens=32).tokens
        finally:
            target.fusions = Fusions()
        _check_path(_read_counts(kernel_mods), [OWO_Q4_0 if fusions.owo else ATTN_WO], [])
        _check_greedy_identity(f"10a f32 {name} prompt={len(prompt)}", toks,
                               _fused_forms(eng, prompt, len(toks), fusions), F32_FORMS_TOL)


def phase_fused_paged(params, kernel_mods, bf16_paged, off_path) -> dict:
    """Phase 10b: phase 4b's paged server (LLaMA-7B Q4_0, 8 slots) with OWO
    on: kernel 15 at up to 8 decode rows, kernel 2 never.  Returns the
    run's launches."""
    from tokenhawk_tpu_torch.models.llama import Fusions

    cfg = dataclasses.replace(_seven_b(32), n_ctx=2048)
    params.fusions = Fusions(owo=True)
    try:
        counts, sched = phase_paged_serve(
            params, cfg, kernel_mods, "bf16", ["q4_matmul", OWO_Q4_0, "flash_attention"]
            + bf16_paged, [FFN_Q4_0, ATTN_WO, "flash_decode"] + off_path,
            "phase 10b: paged serve with OWO (kernel 15), LLaMA-7B Q4_0, 32 layers")
    finally:
        params.fusions = Fusions()
    sched.cache = None
    return counts


def phase_tinyllama_paged(kernel_mods, bf16_paged, int8_paged, dense_off, tmp: str) -> dict:
    """Phase 10c: a TinyLlama-width Q4_0 model (22 layers, 32 heads over 4
    KV heads of 64) as the PagedScheduler's model, phase 4b's requests on
    bf16 then int8 pages: kernels 5-7, then 10-12, at head dim 64; then
    `python -m tokenhawk_tpu_torch.serving --paged` (bf16 and int8 pages)
    on phase 9d's 2-layer TinyLlama-width F16 GGUF file.  Returns the bf16
    and int8 runs' launches."""
    import torch

    cfg = _tinyllama(22, n_ctx=2048)
    params, _ = _model(cfg, "q4_0", "phase 10c: TinyLlama widths, Q4_0, 22 layers")
    base_off = ["qk_matmul", "flash_decode", OWO_Q4_0, ATTN_WO] + dense_off
    counts = {}
    for kv, on, off in (("bf16", bf16_paged, int8_paged), ("int8", int8_paged, bf16_paged)):
        counts[kv], sched = phase_paged_serve(
            params, cfg, kernel_mods, kv, ["q4_matmul", FFN_Q4_0, "flash_attention"] + on,
            base_off + off, f"phase 10c: paged serve, TinyLlama widths (head dim 64), Q4_0, "
                            f"{cfg.n_layer} layers")
        sched.cache = None
        del sched
        torch.cuda.empty_cache()
    del params
    torch.cuda.empty_cache()
    root = os.path.dirname(os.path.abspath(__file__))
    gguf = os.path.join(tmp, "tinyllama-2layer-f16.gguf")
    _concurrently(*(lambda e=extra: _serve_subprocess(root, gguf, tmp, e)
                    for extra in (["--paged"], ["--paged", "--kv", "int8"])))
    return counts


def _cp_forms(dense, cp, prompt, n: int) -> tuple:
    """The dense Engine's greedy stream for `prompt` (kernel 4, then kernel
    3 a token) and, at every step, the CP Engine's logits for the same
    history (kernel 19, then kernel 18 a token): per step, the dense
    token, the CP form's argmax, the dense logits' top-two gap and the two
    forms' largest logit difference, both over the largest |logit|."""
    import torch

    from tokenhawk_tpu_torch.models.llama import forward, logits_from_hidden
    from tokenhawk_tpu_torch.parallel.cp import forward_cp_decode

    cfg, params, dev = dense.cfg, dense.params, dense.device
    c_d, lg_d, _ = dense.prefill(dense.new_cache(1), [prompt])
    c_c, lg_c, _ = cp.prefill(cp.new_cache(1), [prompt])
    lg_d, lg_c = lg_d[0].float(), lg_c[0].float()
    toks, ctoks, gaps, diffs = [], [], [], []
    with torch.inference_mode():
        for i in range(n):
            top = torch.topk(lg_d, 2).values
            big = lg_d.abs().max()
            gaps.append(float((top[0] - top[1]) / big))
            diffs.append(float((lg_d - lg_c).abs().max() / big))
            toks.append(int(lg_d.argmax()))
            ctoks.append(int(lg_c.argmax()))
            pos = torch.tensor([len(prompt) + i], dtype=torch.int32, device=dev)
            tok = torch.tensor([[toks[-1]]], device=dev)
            h, _ = forward(cfg, params, tok, c_d, pos)
            lg_d = logits_from_hidden(cfg, params, h[:, 0])[0].float()
            h, _ = forward_cp_decode(cfg, cp.mesh, params, tok, c_c, pos)
            lg_c = logits_from_hidden(cfg, params, h[:, 0])[0].float()
    return toks, ctoks, gaps, diffs


def phase_cp_engine(params, kernel_mods, tmp: str) -> dict:
    """Phase 12b: the 32-layer 7B Q4_0 model through Engine(parallel="cp")
    at n_ctx 2048 over a NCCL group of one rank (one H100): prompts of 5,
    300 and 1500 tokens, 32 greedy tokens each.  Kernels 1, 18 and 19
    launch; kernels 2, 3, 4 and 14 do not.  Each stream is held against
    the dense Engine's (near-ties apart: kernel 19 takes the scaled q in
    f32 where kernel 4 takes it in bf16); decode tok/s beside the dense
    Engine's; a profiled request's idle share.  The group is destroyed
    before the phase returns.  Returns the CP run's launches."""
    import torch
    import torch.distributed as dist

    from tokenhawk_tpu_torch.config import SamplingConfig
    from tokenhawk_tpu_torch.parallel.mesh import make_cp_mesh
    from tokenhawk_tpu_torch.runtime.engine import Engine
    from tokenhawk_tpu_torch.tokenizer import byte_fallback_vocab

    log("== phase 12b: Engine(parallel='cp'), NCCL group of 1 rank, LLaMA-7B Q4_0, 32 layers, "
        "bf16 KV, n_ctx 2048")
    cfg = dataclasses.replace(_seven_b(32), n_ctx=2048)
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"file://{tmp}/nccl_store", rank=0,
                            world_size=1)
    try:
        mesh = make_cp_mesh()
        log(f"ctx group: backend {dist.get_backend(mesh.group)}, {mesh.ncp} rank")
        tok, greedy = byte_fallback_vocab(), SamplingConfig(temperature=0.0)
        cp = Engine(cfg, params, tok, sampling=greedy, eos_id=-1, mesh=mesh, parallel="cp")
        dense = Engine(cfg, params, tok, sampling=greedy, eos_id=-1)
        rng = np.random.default_rng(SEED + 12)
        prompts = [[1] + rng.integers(3, cfg.n_vocab, size=n - 1).tolist() for n in (5, 300, 1500)]
        _reset_counts(kernel_mods)
        runs = [cp.generate(p, max_new_tokens=32) for p in prompts]
        torch.cuda.synchronize()
        counts = _read_counts(kernel_mods)
        log(f"CP kernel launches over the 3 requests: {counts}")
        _check_path(counts, ["q4_matmul", "flash_decode_stats", "flash_attention_stats"],
                    [FFN_Q4_0, "flash_decode", "flash_attention", "flash_decode_attend"])
        rates = {"cp": [], "dense": []}
        for p, r in zip(prompts, runs):
            d = dense.generate(p, max_new_tokens=32)
            if len(r.tokens) != 32 or not all(0 <= t < cfg.n_vocab for t in r.tokens):
                raise AssertionError(f"CP request produced {len(r.tokens)} tokens")
            rates["cp"].append(r.decode_tokens_per_second)
            rates["dense"].append(d.decode_tokens_per_second)
            log(f"prompt {len(p)}: prefill CP {r.prefill_seconds:.3f} s, dense "
                f"{d.prefill_seconds:.3f} s; decode CP {r.decode_tokens_per_second:.1f} tok/s, "
                f"dense {d.decode_tokens_per_second:.1f} tok/s")
            _check_greedy_identity(f"CP stream, prompt {len(p)}", r.tokens,
                                   _cp_forms(dense, cp, p, 32), band_tol=DEEP_BF16_TOL)
        log(f"decode tok/s over the 3 requests: CP {np.mean(rates['cp']):.1f}, dense "
            f"{np.mean(rates['dense']):.1f}")
        _profile_request(cp, prompts[0])
    finally:
        dist.destroy_process_group()
    return counts


# -- phase 13: the bench entry point and kernels 20-22 ------------------------

# Bounds of kernels 20-22 at their operations' own peaks (NVIDIA H100 SXM
# data sheet): f32 adds on the CUDA cores, int8 products on the tensor cores.
F32_FLOPS = 67e12
INT8_OPS = 1979e12
# A probe reading above the card's spec by more than this is not HBM: the
# array, or a model's weights, would be served from cache.
SOL_SLACK = 1.05


def _check_probe(gbps: float, label: str) -> None:
    spec = HBM_BPS / 1e9
    log(f"{label}: {gbps:.1f} GB/s ({gbps / spec * 100:.1f}% of the spec)")
    if not 0 < gbps <= SOL_SLACK * spec:
        raise AssertionError(f"{label}: {gbps} GB/s outside (0, {SOL_SLACK * spec}]")


def phase_stream_kernel() -> dict:
    """13a: kernel 20 against its plain version on a 2 GiB random array,
    within 1e-5 of sum(|x|), its time beside torch.sum's and the bound;
    the probe's reading before and after."""
    import torch

    from tokenhawk_tpu_torch.ops.cuda import stream
    from tokenhawk_tpu_torch.utils import benchlib

    log("== phase 13a: kernel 20, the HBM stream probe")
    _check_probe(benchlib.hbm_stream_gbps(), "hbm_stream_gbps() before")
    g = torch.Generator(device="cuda").manual_seed(SEED)
    x = torch.randn((1 << 20, 1024), generator=g, device="cuda", dtype=torch.bfloat16)
    seed = torch.full((1, 1), 1.5, device="cuda")
    got, want = stream.stream_sum(x, seed), benchlib.stream_sum_plain(x, seed)
    err = abs(got.item() - want.item())
    tol = 1e-5 * x.float().abs().sum().item()
    kt = timed([lambda: stream.stream_sum(x, seed)], calls=16)
    pt = timed([lambda: benchlib.stream_sum_plain(x, seed)], calls=4)
    lib = timed([lambda: torch.sum(x, dtype=torch.float32)], calls=16)["ms"]
    b = bound(x.numel() * 2 + 8, x.numel(), peak=F32_FLOPS)
    log(f"stream_sum bf16 [1048576, 1024] (2 GiB): max_abs_err {err:.3e} (tol {tol:.3e})  "
        f"kernel {kt['ms']:.4f} ms [per call {kt['call_ms']:.4f}]  plain {pt['ms']:.4f} ms  "
        f"torch.sum {lib:.4f} ms  bound {b['bound_ms']:.4f} ms ({b['bound_by']}): "
        f"{x.numel() * 2 / kt['ms'] / 1e6:.1f} GB/s")
    if not err <= tol:
        raise AssertionError(f"stream_sum: {err} > {tol}")
    del x
    torch.cuda.empty_cache()
    _check_probe(benchlib.hbm_stream_gbps(), "hbm_stream_gbps() after")
    return {"name": "stream_sum", "route": "cuda",
            "source": "tokenhawk_tpu_torch/csrc/stream.cu",
            "replaces": "tokenhawk_tpu/utils/benchlib.py:108 (hbm_stream_gbps, "
                        "_stream_sum_kernel)", "launches": 0, "max_abs_err": err,
            "ms": kt["ms"], "plain_ms": pt["ms"], **b, "library_ms": lib,
            "timed_at": "bf16 [1048576, 1024] (2 GiB)",
            "cases": [dict(shape="bf16 [1048576, 1024]", rows=1 << 20, max_abs_err=err,
                           tol=tol, ms=kt["ms"], call_ms=kt["call_ms"], plain_ms=pt["ms"])]}


def _check_bench_line(rec: dict, metric: str) -> None:
    """A bench JSON line: its metric, a finite positive value, the card
    and both probe readings in it, and no share of a roofline above
    SOL_SLACK."""
    import torch

    if rec["metric"] != metric or not (0 < rec["value"] < float("inf")):
        raise AssertionError(f"bench line {rec}")
    if torch.cuda.get_device_name(0) not in rec["device"]:
        raise AssertionError(f"bench line names another device: {rec['device']}")
    for k in ("measured_hbm_gbps", "measured_hbm_gbps_after"):
        _check_probe(rec[k], f"  {metric} {k}")
    for k in ("pct_of_spec_sol", "pct_of_measured_sol", "pct_of_mxu_roofline"):
        if k in rec and not 0 < rec[k] <= SOL_SLACK * 100:
            raise AssertionError(f"{metric}: {k} = {rec[k]} outside (0, {SOL_SLACK * 100}]")


def phase_bench(kernel_mods) -> int:
    """13b: the bench on the full 32-layer LLaMA-7B Q4_0: decode (B=1, ctx
    512, 128 tokens) and serve (B=8, 16 requests, 64 tokens) in this
    process, ttft as `python -m tokenhawk_tpu_torch.bench`.  Returns
    kernel 20's launches in the decode run."""
    import torch

    from tokenhawk_tpu_torch import bench
    from tokenhawk_tpu_torch.ops.cuda import stream

    log("== phase 13b: the bench, LLaMA-7B Q4_0, 32 layers")
    mods = [stream, *kernel_mods]
    runs = {}
    for mode, argv, metric, on_path in (
            ("decode", ["--tokens", "128"], "llama7b_q4_0_decode_tokens_per_sec",
             ["q4_matmul", FFN_Q4_0, "flash_decode", "flash_attention"]),
            ("serve", ["--batch", "8", "--requests", "16", "--tokens", "64"],
             "llama7b_q4_0_serve_agg_tokens_per_sec_b8",
             ["q4_matmul", FFN_Q4_0, "flash_attention", "paged_decode", "paged_append"])):
        args = bench.parse_args(["--mode", mode, *argv])
        _reset_counts(mods)
        t0 = time.perf_counter()
        rec = bench.run(bench.model_config(args), args)
        counts = _read_counts(mods)
        log(f"bench --mode {mode} {' '.join(argv)}: {time.perf_counter() - t0:.1f} s; "
            f"launches {counts}")
        _check_path(counts, ["stream_sum", *on_path], [])
        _check_bench_line(rec, metric)
        runs[mode] = counts["stream_sum"]
        torch.cuda.empty_cache()
    # Two probes of (4 + 24) passes of warm-up and 5 trials of (4 + 24).
    if runs["decode"] != 2 * (4 + 24 + 5 * 28):
        raise AssertionError(f"kernel 20 launched {runs['decode']} times in a bench run")
    root = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-m", "tokenhawk_tpu_torch.bench", "--mode", "ttft"],
                         cwd=root, capture_output=True, text=True, timeout=600,
                         env=dict(os.environ, PYTHONPATH=root))
    log(f"python -m tokenhawk_tpu_torch.bench --mode ttft: exit {out.returncode} in "
        f"{time.perf_counter() - t0:.1f} s; " + " | ".join(out.stderr.splitlines()[-3:]))
    if out.returncode != 0:
        raise AssertionError(f"the bench failed: {out.stderr[-3000:]}")
    lines = out.stdout.strip().splitlines()
    if len(lines) != 1:
        raise AssertionError(f"the bench printed {len(lines)} lines: {out.stdout[-2000:]}")
    log(lines[0])
    _check_bench_line(json.loads(lines[0]), "llama7b_q4_0_ttft_p50_ms_prompt64")
    return runs["decode"]


def phase_experiments() -> tuple:
    """13c: kernel 21's three variants against their plain versions at the
    experiment's shapes, timed over its 8 weight sets, then the script;
    kernel 22's seven probes through the script (all ok), against their
    plain versions, and the int8 tensor-core product on random codes.
    Returns both records with the scripts' launches."""
    import torch

    from tokenhawk_tpu_torch.experiments import dequant_exp as dx
    from tokenhawk_tpu_torch.experiments import sm90_probe as sp

    log("== phase 13c: the experiment kernels 21 (dequant_exp) and 22 (sm90_probe)")
    K, N, B = dx.K, dx.N, dx.B
    g = torch.Generator(device="cuda").manual_seed(SEED)
    x = torch.randn((B, K), generator=g, device="cuda").to(torch.bfloat16)
    sets = [(torch.randint(0, 256, (K // 2, N), generator=g, device="cuda", dtype=torch.uint8),
             (0.01 * (0.5 + torch.rand((K // 64, N), generator=g, device="cuda")))
             .to(torch.bfloat16)) for _ in range(dx.NW)]

    def dequantized(qs, s):
        sf = s.float().repeat_interleave(32, dim=0)
        return torch.cat([((qs & 0x0F).float() - 8.0) * sf,
                          ((qs >> 4).float() - 8.0) * sf]).to(torch.bfloat16)

    lib = timed([lambda qs=qs, s=s: torch.matmul(x, dequantized(qs, s)) for qs, s in sets],
                calls=16)["ms"]
    nbytes = B * K * 2 + K // 2 * N + K // 64 * N * 2 + B * N * 2
    b = bound(nbytes, 2 * B * K * N)
    cases = []
    for v in dx.VARIANTS:
        qs, s = sets[0]
        got, want = dx.dequant_matmul(x, qs, s, v), dx.dequant_matmul_plain(x, qs, s, v)
        err = (got.float() - want.float()).abs().max().item()
        tol = 2.0 ** (np.floor(np.log2(want.float().abs().max().item())) - 7)
        kt = timed([lambda qs=qs, s=s: dx.dequant_matmul(x, qs, s, v) for qs, s in sets])
        pt = timed([lambda qs=qs, s=s: dx.dequant_matmul_plain(x, qs, s, v) for qs, s in sets],
                   calls=8)
        log(f"dequant_exp {v} x [8, {K}] codes [{K // 2}, {N}]: max_abs_err {err:.3e} "
            f"(tol {tol:.3e})  kernel {kt['ms']:.4f} ms [per call {kt['call_ms']:.4f}]  "
            f"plain {pt['ms']:.4f} ms  {nbytes / kt['ms'] / 1e6:.1f} GB/s")
        if not err <= tol:
            raise AssertionError(f"dequant_exp {v}: {err} > {tol}")
        cases.append(dict(shape=f"x [8, {K}], codes [{K // 2}, {N}]", rows=v, max_abs_err=err,
                          tol=tol, ms=kt["ms"], call_ms=kt["call_ms"], plain_ms=pt["ms"]))
    log(f"  bound {b['bound_ms']:.4f} ms ({b['bound_by']}); library call dequantize + "
        f"torch.matmul: {lib:.4f} ms")
    del x, sets
    _reset_counts([dx, sp])
    if dx.main() != 0:
        raise AssertionError("experiments/dequant_exp.py failed")
    if sp.main() != 0:
        raise AssertionError("experiments/sm90_probe.py reported a FAIL")
    counts = _read_counts([dx, sp])
    log(f"the scripts' launches: {counts}")
    _check_path(counts, ["dequant_exp", "sm90_probe"], [])
    dq = _record("dequant_exp", "tokenhawk_tpu_torch/csrc/dequant_exp.cu",
                 "experiments/dequant_exp.py:50 (build, make_kernel)", cases,
                 (cases[0]["shape"], "int32"), b, lib)
    dq["launches"] = counts["dequant_exp"]

    ins = sp.inputs("cuda")
    pcases = []
    for i, name in enumerate(sp.PROBES):
        got, want = sp.probe(i, ins), sp.probe_plain(i, ins)
        if not torch.equal(got, want):
            raise AssertionError(f"sm90_probe {name}: differs from the plain version")
        src = ins["i8sq"] if i == 5 else ins["u8"]
        library = {0: lambda: ins["i8"].float(), 1: lambda: (ins["u8"].to(torch.int16) & 0xF)
                   .float(), 2: lambda: (ins["u8"] & 0xF).int().float(),
                   3: lambda: ins["i4"].float(), 4: lambda: ins["u8"].view(torch.int8).float(),
                   5: lambda: torch._int_mm(ins["i8sq"], ins["i8sq"]),
                   6: lambda: torch.addcmul(torch.ones_like(ins["s"]), ins["u8"].float(),
                                            ins["s"])}[i]
        kt = timed([lambda i=i: sp.probe(i, ins)])
        pt = timed([lambda i=i: sp.probe_plain(i, ins)])
        lt = timed([library])["ms"]
        pb = (bound(2 * 128 * 128 + 128 * 128 * 4, 2 * 128**3, peak=INT8_OPS) if i == 5
              else bound(src.numel() * src.element_size() + got.numel() * 4, 0))
        log(f"sm90_probe {name}: equal  kernel {kt['ms']:.4f} ms [per call "
            f"{kt['call_ms']:.4f}]  plain {pt['ms']:.4f} ms  torch op {lt:.4f} ms  "
            f"bound {pb['bound_ms']:.6f} ms ({pb['bound_by']})")
        pcases.append(dict(shape=name, rows=list(got.shape)[0], max_abs_err=0.0, tol=0.0,
                           ms=kt["ms"], call_ms=kt["call_ms"], plain_ms=pt["ms"],
                           library_ms=lt, **pb))
    for m, k, n in [(128, 128, 128), (256, 4096, 256)]:
        a = torch.randint(-128, 128, (m, k), generator=g, device="cuda", dtype=torch.int8)
        w = torch.randint(-128, 128, (k, n), generator=g, device="cuda", dtype=torch.int8)
        if not torch.equal(sp.int8_matmul(a, w), (a.double() @ w.double()).to(torch.int32)):
            raise AssertionError(f"int8_matmul [{m}, {k}] x [{k}, {n}] differs")
        log(f"int8_matmul (mma.sync s8) [{m}, {k}] x [{k}, {n}] on random codes: exact")
    main = pcases[5]
    pr = _record("sm90_probe", "tokenhawk_tpu_torch/csrc/sm90_probe.cu",
                 "experiments/mosaic_probe.py:25 (run_kernel), :51 (_i4_kernel_input)",
                 pcases, (main["shape"], main["rows"]),
                 {k: main[k] for k in ("bound_ms", "bound_by")}, main["library_ms"])
    pr["launches"] = counts["sm90_probe"]
    return dq, pr


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing run", file=sys.stderr)
        return 1
    from tokenhawk_tpu_torch.ops.cuda import (
        ffn,
        flash_attention,
        flash_decode,
        kv_int8,
        paged_decode,
        paged_int8,
        qmatmul,
    )
    from tokenhawk_tpu_torch.tokenizer import Tokenizer

    t0 = time.perf_counter()
    phase_env()
    records = phase_kernels()
    phase_slice()
    mods = [qmatmul, ffn, flash_decode, flash_attention]
    every = mods + [paged_decode, kv_int8, paged_int8]
    counts, params = phase_serve(mods)
    bf16_paged = ["paged_decode", "paged_append", "gather_pages"]
    int8_dense = ["flash_decode_int8", "flash_attention_int8"]
    int8_paged = ["paged_decode_int8", "paged_append_int8", "gather_pages_int8"]
    cfg_2k = dataclasses.replace(_seven_b(32), n_ctx=2048)
    paged_counts, sched = phase_paged_serve(
        params, cfg_2k, every, "bf16", ["q4_matmul", FFN_Q4_0, "flash_attention"] + bf16_paged,
        ["qk_matmul", "flash_decode"] + int8_dense + int8_paged,
        "phase 4b: paged serve, LLaMA-7B Q4_0, 32 layers")
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "llama7b-2layer-q4_0.bin")
        write_two_layer_file(path)
        phase_http(sched, Tokenizer(*_padded_vocab(cfg_2k.n_vocab)), path, tmp)
        sched.cache = None  # the bf16 pool goes before the int8 phases
        del sched
        torch.cuda.empty_cache()
        cfg_i8 = dataclasses.replace(cfg_2k, n_layer=INT8_LAYERS)
        params_i8 = dataclasses.replace(params, layers=params.layers[:INT8_LAYERS])
        int8_counts = phase_int8_serve(cfg_i8, params_i8, every,
                                       ["q4_matmul", FFN_Q4_0] + int8_dense,
                                       ["qk_matmul", "flash_decode", "flash_attention"]
                                       + bf16_paged + int8_paged)
        int8_paged_counts, sched = phase_paged_serve(
            params_i8, cfg_i8, every, "int8",
            ["q4_matmul", FFN_Q4_0, "flash_attention"] + int8_paged,
            ["qk_matmul", "flash_decode"] + bf16_paged + int8_dense,
            f"phase 4bi: paged serve, LLaMA-7B Q4_0 widths, {INT8_LAYERS} layers")
        phase_cli(path)
        sched.cache = None
        del sched
        torch.cuda.empty_cache()
        # Phase 8: dense weights decode through kernel 14; phase 9: speculation
        # over the Q4_0 model, its draft's decode through kernel 14 at Dh 64.
        dense_counts = phase_dense_7b(every)
        phase_speculation(params, every, path, tmp)
        # Phase 10: the fused decode-layer kernels (10a Engine, 10b paged),
        # then a head-dim-64 model under the paged server (10c).
        fused_counts = phase_fused_engine(params, every)
        phase_fused_paged(params, every, bf16_paged, int8_dense + int8_paged)
        torch.cuda.empty_cache()
        phase_tinyllama_paged(every, bf16_paged, int8_paged, int8_dense, tmp)
        torch.cuda.empty_cache()
        # Phase 12b: context parallelism over a one-rank NCCL group.
        cp_counts = phase_cp_engine(params, every, tmp)
        del params  # the Q4_0 model goes before the GGUF kinds' phases
        torch.cuda.empty_cache()
        # Phases 6 and 6q: group-code projections (kernel 13) and the FFN over
        # them (kernel 2); kernel 1 (Q4_0) stays off.
        def engine_path(on, off):
            return (["qk_matmul", *on, "flash_decode", "flash_attention"],
                    ["q4_matmul", FFN_Q4_0, "flash_decode_attend", *off] + bf16_paged
                    + int8_dense + int8_paged)

        def paged_path(on, off):
            return (["qk_matmul", *on, "flash_attention"] + bf16_paged,
                    ["q4_matmul", FFN_Q4_0, "flash_decode", *off] + int8_dense + int8_paged)

        # Without THAWK_Q4K_SB the super-block kernels stay off.
        flat_off = ["qk_sb_matmul", *FFN_SB]
        q4km_counts, _ = phase_q4_k_m(every, engine_path(FFN_Q4_K_M, flat_off),
                                      paged_path(FFN_Q4_K_M, flat_off))
        q8_counts = phase_q8_0(every, engine_path([FFN_Q8_0], flat_off))
        gguf_path = phase_gguf(tmp, every)
        # Phase 11: the Q4_K super-block forms (kernel 17, kernel 2 with an
        # sb w13); 11a on phase 6's model, 11b and 11c on phase 7's file.
        sb_on = ["qk_sb_matmul", *FFN_SB]
        sb_counts, _ = phase_q4k_sb(every, engine_path(sb_on, FFN_Q4_K_M),
                                    paged_path(sb_on, FFN_Q4_K_M))
        phase_gguf_sb(gguf_path, tmp)
    # Phase 13: the bench (kernel 20 on its path) and the experiment kernels
    # 21 and 22, after every earlier phase's model is gone.
    torch.cuda.empty_cache()
    stream_rec = phase_stream_kernel()
    stream_rec["launches"] = phase_bench(every)
    bench_records = [stream_rec, *phase_experiments()]
    # Each kernel's launches on the path of the slice that added it: the
    # Q4_0 Engine run for kernels 1-4, the paged server's run for kernels
    # 5-7, the int8 Engine's for kernels 8-9, the int8 paged server's for
    # kernels 10-12, and the Engine runs of phases 6 (Q4_K_M) and 6q (Q8_0)
    # for kernel 13 and kernel 2 over those kinds, each pairing its own;
    # phase 11a's (Q4_K_M in super-block forms) for kernel 17 and kernel 2
    # with an sb w13;
    # the dense 7B Engine's of phase 8 for kernel 14; phase 10a's requests
    # with OWO for kernel 15 and with ATTN for kernel 16; phase 12b's CP
    # Engine for kernels 18 and 19.
    launches = {"q4_matmul": counts["q4_matmul"], "fused_ffn": counts[FFN_Q4_0],
                "flash_decode_append": counts["flash_decode"],
                "flash_attention": counts["flash_attention"],
                "qk_matmul[q4_k_m]": q4km_counts["qk_matmul"],
                "qk_matmul[q8_0]": q8_counts["qk_matmul"],
                "fused_ffn[q4_k/q6_k]": q4km_counts[FFN_Q4_K_M[0]],
                "fused_ffn[q4_k/q4_k]": q4km_counts[FFN_Q4_K_M[1]],
                "fused_ffn[q8_0/q8_0]": q8_counts[FFN_Q8_0],
                "qk_sb_matmul": sb_counts["qk_sb_matmul"],
                "fused_ffn[q4k_sb/q6_k]": sb_counts[FFN_SB[0]],
                "fused_ffn[q4k_sb/q4_k]": sb_counts[FFN_SB[1]],
                **{k: paged_counts[k] for k in bf16_paged},
                **{k: int8_counts[k] for k in int8_dense},
                **{k: int8_paged_counts[k] for k in int8_paged},
                "flash_decode_attend": dense_counts["flash_decode_attend"],
                "fused_owo_ffn": fused_counts["owo"][OWO_Q4_0],
                "fused_attn_out": fused_counts["attn"][ATTN_WO],
                "flash_decode_stats": cp_counts["flash_decode_stats"],
                "flash_attention_stats": cp_counts["flash_attention_stats"]}
    for rec in records:
        rec["launches"] = launches[rec["name"]]
    records += bench_records  # kernels 20-22, launches on their own paths
    log(f"all phases passed in {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
