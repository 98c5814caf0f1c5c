#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (tokenhawk_tpu_torch) once on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --prefill   # phase 1, then phase 2's kernels 4 and 9 alone

Phases, each printing its own lines; any failure raises and exits non-zero:
  1. versions, the card's name and power limit, the kernel build (one nvcc
     per source, all started together);
  2. each CUDA kernel against its plain PyTorch version at LLaMA-7B shapes
     (max error against the stated tolerance, median CUDA-event times, the
     bound from the bytes and operations of the call, and the time of one
     PyTorch call computing the same function where there is one); the
     paged kernels in both pool layouts (kernel 5 also at B=1 over 512 and
     2048 live rows and in 1, 2, 4 and 8 splits at 8 slots, ragged and all
     at 2048); kernels 1 and 13 at 1, 8, 16, 40
     and 512 rows and kernel 17 at 1, 8, 9, 16, 40 and 512, each on its
     path (at most 8 rows kernel 13's decode-row walk, kernels 1 and 17's
     GEMV; the tensor-core GEMM above: a record each), kernels 13 and 2 at
     1 and 8 rows also on float32 x; kernels 3 (B=4 ragged, B=1 at 37, 300, 512 and 2048 live rows,
     B=8 ragged) and 14 as the model launches them (split-S in thread-block
     clusters where the (sequence, KV head) pairs leave SMs idle, else one
     block a pair: a record each) beside their one-block launch and SDPA,
     and sweeps of their split counts; then kernel 16's and the GEMV's
     outputs held bit for bit to the parent tree's and kernels 2, 3, 5, 8,
     10, 13, 15 and 18's to their redesigns' (PARENT_DIGESTS);
  3. slice check: a 2-layer LLaMA-7B-width Q4_0 model, prefill of 16
     tokens + 8 decode steps on the GPU (kernels) and on the CPU (plain
     versions, same parameters), logits compared at every step, over a
     bf16 cache and over an int8 one; then the paged forward against the
     dense one on the GPU, 8 decode steps across a page boundary, bf16
     pages against the bf16 cache and int8 pages against the int8 cache;
  4. serve: the full 32-layer 7B Q4_0 model, Engine.generate on 3 prompts,
     and the launch count of every kernel over that run; then the logit
     spread of the tensor-core path's bf16 roundings against the GEMV's
     f32 at 2 and 32 layers (a 512-token prefill);
  4b. paged serve: the same model under PagedScheduler (max_batch 8, n_ctx
     2048, 128-token pages, prefix cache, prefill chunks of 512), 12 mixed
     greedy/sampled requests, 4 sharing a 384-token prefix and one of 1500
     tokens; launch counts of every kernel (kernel 5 on its split form),
     page accounting, decode tok/s, and the device's idle share under the
     profiler;
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
     layers since phase 11 was added) with an 11-layer TinyLlama-width bf16
     draft (kernel 14 at 4 KV heads of 64, 8 queries each, every launch on
     its split form), gamma 4, each stream held against the Engine's greedy
     stream, then decode tok/s with kernel 14 held to one block a pair
     and on the split form in turns; 9b a 2-layer
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
     OWO alone; three walk launches a kernel-15 call, a tile-walk and a
     walk launch a kernel-16 call), tok/s and the idle share of each,
     each fused greedy stream held to the unfused one up to near-ties and
     in float32; 10b phase 4b's paged server with OWO (kernel 15 at 8
     rows, three walk launches a call); 10c a
     TinyLlama-width Q4_0 model (22 layers, head dim 64) under the
     PagedScheduler on bf16 and int8 pages (kernels 5-7 and 10-12 at Dh
     64), then `serving --paged` (bf16, int8 pages) on phase 9d's F16 GGUF
     file.  Phase 10 runs after phase 9.
  11. the Q4_K super-block forms (THAWK_Q4K_SB=1), after phase 7: 11a
     phase 6's model (at 16 layers since phase 12, as phase 6's), drawn in
     them, through Engine (kernel 17 and
     kernel 2 with an sb w13 launched, kernel 17's prompts on the
     tensor-core GEMM, kernel 13 only for the Q6_K weights and the flat
     w2), B=1 decode windows and a 1500-token prefill against the flat
     form of the same codes in turns, and phase 4b's requests through the
     PagedScheduler;
     11b phase 7's file loaded with the flag at float32 sides, its greedy
     stream held against the flat form's, the CLI and `serving --paged`
     with the flag; 11c runtime/eval.py's perplexity of that file, sb
     against flat, at float32 and bfloat16 sides.
  12. context parallelism (parallel/): 12a, after phase 2, kernels 18
     (decode partials) and 19 (ring-attention step) against their plain
     versions at the 7B's heads, kernel 19 at T=512 on one shard (its
     tensor-core walk on bf16 K/V and its CUDA-core walk on f32 K/V, each
     timed) and over 2 and 4 cyclic shards (every query shard against every
     KV shard, merged), kernel 18 at B=1 over 512, 2048 and 3 live tokens on one
     shard and on 4 cyclic shards (strided views of the cache; at 3 tokens
     one shard is empty), as CP decode calls it (a cluster a (sequence, KV
     head), merged on chip) and at one block a pair, each merged result
     held against kernel 4 or 14 on the unsplit cache, one strided shard's
     call timed, 4 empty shards giving (0, -inf, 0) exactly; then kernel 18
     cut into 1, 4, 8 and 16 splits at TinyLlama's heads beside kernel 14
     (B=1 at 2048, B=8 ragged);
     12b, after phase 10, the 7B Q4_0 model's first 8 layers through
     Engine(parallel="cp") over a world-1 NCCL group at n_ctx 2048
     (prompts of 5, 300 and 1500 tokens, 32 greedy tokens each): kernels
     1, 18 (its cluster form) and 19 (its tensor-core walk) launched, 2, 3,
     4, 14 and kernel 19's CUDA-core walk not; each stream held against
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
kernels 15 and 16 at the 7B's widths in Q4_0 and Q8_0, each timed back
to back and alone beside the unfused port kernels it replaces, timed the
same two ways; phase 3 also runs a 2-layer Q4_K_M
slice.  Each phase's header line ends with the seconds since the start.
Every path check also holds each quantized projection the model made to
its path (a spy on ops.linear's quant_matmul): bf16 x above 8 rows over
any weight form on the tensor-core GEMM, the group codes at 1-8 rows on
the decode-row walk, every other call on the GEMV.
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
# f32 and round the output once, so they differ by about one bfloat16
# rounding (at most 2^-8 of an element).  The tensor-core prefill walk
# (kernels 4 and 9 on bf16 q) also rounds the probabilities P to bfloat16
# before P.V, as tensor-core flash attention does, and the tensor-core path
# of kernels 1 and 13 (bf16 x above 8 rows) rounds xn and each code * s to
# bfloat16, as the reference's `_qdot` does: each term moves by at most
# 2^-9 of itself, in no common direction, which adds less than one output
# rounding.  The tolerance is 2^-7 of the largest |reference|.
KERNEL_TOL = 2.0**-7
# The rows phase 2 times kernels 1 and 13 at: decode (1) and kernel 2's
# most (8) on the decode-row walk; 16,
# the 8-slot verify's 40 (phase 9c) and a 512-token prefill on the
# tensor-core path.
QMATMUL_ROWS = (1, 8, 16, 40, 512)
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
# Float32 results of one function summed in other orders, kernel against
# plain version (kernels 4 and 9 with float32 q, case g below): 1e-4 of the
# largest |value| (tests/test_torch_cuda.py's rule).
F32_KERNEL_TOL = 1e-4
# Kernels 4 and 9 (causal prefill attention): the cases phase 2 checks and
# times, (tag, Hkv, rep, Dh, B, T, offsets, S).  a: LLaMA-7B's heads at
# T=512 from offset 0 (kernel 4's main case; kernel 9's, a9, over the int8
# phases' n_ctx 2048); b: short prompts and, for kernel 9, a whole 2048;
# c: a 512-token chunk of phase 4b's 1500-token prompt; d: the paged
# verify after its gather (9c: 8 slots of gamma + 1 = 5 rows); e:
# Llama-3-8B's heads (8 KV heads x 4 queries); f: TinyLlama's (4 KV heads
# of 64 x 8 queries).  Case g, float32 q (the CUDA-core walk), runs at the
# first case's shape.
VERIFY_OFFSETS = [0, 37, 300, 700, 1024, 1500, 1800, 2043]
PREFILL_CASES = {
    "flash_attention": [
        ("a", 32, 1, 128, 1, 512, [0], 512),
        ("b", 32, 1, 128, 1, 64, [0], 512),
        ("b", 32, 1, 128, 1, 16, [200], 512),
        ("c", 32, 1, 128, 1, 512, [1024], 2048),
        ("d", 32, 1, 128, 8, 5, VERIFY_OFFSETS, 2048),
        ("e", 8, 4, 128, 1, 512, [0], 2048),
        ("f", 4, 8, 64, 1, 512, [0], 2048)],
    "flash_attention_int8": [
        ("a9", 32, 1, 128, 1, 512, [0], 2048),
        ("b", 32, 1, 128, 1, 64, [0], 2048),
        ("b", 32, 1, 128, 1, 16, [200], 2048),
        ("b", 32, 1, 128, 1, 13, [5], 2048),
        ("b", 32, 1, 128, 1, 2048, [0], 2048),
        ("c", 32, 1, 128, 1, 512, [1024], 2048),
        ("d", 32, 1, 128, 8, 5, VERIFY_OFFSETS, 2048),
        ("e", 8, 4, 128, 1, 512, [0], 2048)],
}
# Kernel 4's and kernel 9's launch counters, one a walk
# (ops/cuda/flash_attention.py, kv_int8.py): bf16 q (and, for kernel 4, a
# bf16 cache) runs the tensor-core walk, float32 the CUDA-core one.  The
# bf16 phases' launch checks ask for the first and forbid the second; the
# float32 witnesses the reverse.
K4, K9 = "flash_attention_tc", "flash_attention_int8_tc"
CUDA_CORE_PREFILL = ["flash_attention", "flash_attention_int8"]
# Kernels 1's and 13's launch counters, one a path (ops/cuda/qmatmul.py):
# the decode-row walk (gemv_stream.cuh) at decode rows, the tensor-core
# GEMM for bf16 x above 8 rows.  A path run with prompts or verifies above
# 8 tokens asks for both.  Their GEMV (Q4_GEMV, QK_GEMV) takes only f32 x
# above 8 rows: the bf16 paths forbid it.
Q4_PATHS = ["q4_matmul_stream", "q4_matmul_tc"]
Q4_GEMV = "q4_matmul"
QK_PATHS = ["qk_matmul_stream", "qk_matmul_tc"]
QK_GEMV = "qk_matmul"
# Kernel 17's two (THAWK_Q4K_SB=1's super-block forms), by the same rule.
SB_PATHS = ["qk_sb_matmul_stream", "qk_sb_matmul_tc"]
SB_GEMV = "qk_sb_matmul"
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
# Phase 12b runs the 7B's first 8 layers (32 before kernel 15's and 16's
# walk instances lengthened the build), to keep the script's run inside
# its time on a slow host.
CP_LAYERS = 8
# Phase 9's draft takes 11 of TinyLlama's 22 layers (its widths: kernel 14
# at 4 KV heads of 64, 8 queries each), for the same reason.
DRAFT_LAYERS = 11
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
# Kernel 2's source: the decode-row walk that its C entry (csrc/ffn.cu
# th_ffn) launches twice.
SRC2 = "tokenhawk_tpu_torch/csrc/gemv_stream.cuh"


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


def timed(fns, calls: int = 32, call_trials: int = 5) -> dict:
    """ms: device time of one call (sleep-fronted events); call_ms: the
    time of one call as the host issues it back to back, the median of
    call_trials trials (1 where only ms is wanted: it sizes the spin)."""
    call = cuda_ms(fns, calls, trials=call_trials)
    # The host issues a call in well under 0.5 ms; spin twice that per call.
    return {"ms": cuda_ms(fns, calls, sleep_ms=2 * calls * min(call, 0.5) + 2),
            "call_ms": call}


def isolated_ms(fns, trials: int = 21) -> float:
    """Median device ms of one call that finds the device idle, as in an
    eager decode step whose host is slower than its kernels: each call
    between two events, queued behind a device spin of about 1 ms that
    follows the last call's end (so the host's launch cost, a multi-launch
    call's wrappers included, stays outside the events), cycling through
    fns."""
    import torch

    for f in fns:
        f()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    times = []
    for i in range(trials):
        torch.cuda._sleep(2_000_000)
        a.record()
        fns[i % len(fns)]()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


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


def _peak(rows: int) -> float:
    """The peak of the quantized matmul's operations at `rows` rows of bf16
    x: f32 FMAs on the CUDA cores at decode rows (the GEMV and the
    decode-row walk, as the reference's `_qdot` keeps f32 there), the bf16
    tensor cores above 8."""
    return F32_FLOPS if rows <= 8 else PEAK_FLOPS


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


def _case_tools(seed: int = SEED) -> tuple:
    """Phase 2's helpers on the card: randn (bf16 by default, from a
    generator seeded with `seed`), case (check one shape against its
    tolerance and time both versions) and library (time PyTorch calls)."""
    import torch

    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(seed)

    def randn(*shape, scale=1.0, dtype=torch.bfloat16):
        return (torch.randn(shape, generator=g, device=dev) * scale).to(dtype)

    def case(cases, label, shape, rows, out, ref, kernel_fns=None, plain_fns=None,
             frac=KERNEL_TOL, calls=32, alone=False):
        """Check one shape against the tolerance, time both versions
        (given no functions to time, only check); with `alone`, also the
        kernel's call alone (isolated_ms)."""
        err, tol = max_err(out, ref, frac)
        if kernel_fns is None:
            log(f"{label}: max_abs_err {err:.3e} (tol {tol:.3e})")
            if not err <= tol:
                raise AssertionError(f"{label}: {err} > {tol}")
            cases.append(dict(shape=shape, rows=rows, max_abs_err=err, tol=tol))
            return
        kt, pt = timed(kernel_fns, calls), timed(plain_fns, calls, call_trials=1)
        alone_ms = isolated_ms(kernel_fns) if alone else None
        log(f"{label}: max_abs_err {err:.3e} (tol {tol:.3e})  kernel {kt['ms']:.4f} ms "
            f"[per call {kt['call_ms']:.4f}"
            + (f", alone {alone_ms:.4f}" if alone else "")
            + f"]  plain {pt['ms']:.4f} ms [per call {pt['call_ms']:.4f}]")
        if not err <= tol:
            raise AssertionError(f"{label}: {err} > {tol}")
        cases.append(dict(shape=shape, rows=rows, max_abs_err=err, tol=tol, ms=kt["ms"],
                          plain_ms=pt["ms"], call_ms=kt["call_ms"],
                          plain_call_ms=pt["call_ms"], isolated_ms=alone_ms))

    def library(label, fns) -> float:
        ms = timed(fns, call_trials=1)["ms"]
        log(f"  library call {label}: {ms:.4f} ms")
        return ms

    return g, randn, case, library


def phase_kernels() -> list:
    import torch

    from tokenhawk_tpu_torch.ops.cuda import (
        ffn,
        paged_decode,
        qmatmul,
    )
    from tokenhawk_tpu_torch.ops.qweight import QWeight

    log("== phase 2: kernels against their plain versions (7B shapes, bfloat16)")
    dev = torch.device("cuda")
    g, randn, case, library = _case_tools()

    def qweight(k, n):
        return QWeight.quantize(randn(k, n, scale=0.02, dtype=torch.float32))

    records = []
    bf = 2  # bytes of a bfloat16 value

    # -- kernel 1: every projection of the path at decode rows (the walk),
    # the verify's and prefill rows (the tensor-core path above 8) --
    cases = []
    shapes = [("wqkv", 4096, 12288, True), ("wo", 4096, 4096, False),
              ("w13", 4096, 22016, True), ("w2", 11008, 4096, False),
              ("output", 4096, 32000, True)]
    for name, K, N, norm in shapes:
        w = qweight(K, N)
        ws = [QWeight(*c) for c in copies([w.qs, w.scales], w.nbytes)]
        gain = 1.0 + randn(K, scale=0.1) if norm else None
        for rows in QMATMUL_ROWS:
            x = randn(rows, K)
            calls = 32 if rows < 512 else 4
            case(cases, f"q4_matmul {name} K={K} N={N} rows={rows} norm={norm}", name, rows,
                 qmatmul.quant_matmul(x, w, gain), qmatmul.quant_matmul_plain(x, w, gain),
                 [lambda w=w: qmatmul.quant_matmul(x, w, gain) for w in ws],
                 [lambda w=w: qmatmul.quant_matmul_plain(x, w, gain) for w in ws], calls=calls,
                 alone=rows <= 8)
            # A ggjt Q4_0 block holds 32 weights in 20 bytes (f32 scale), as the
            # port's layout does: 0.625 B each; x, the gain and y once each.
            b = bound(K * N * 0.625 + (rows * (K + N) + K * norm) * bf, 2 * rows * K * N,
                      peak=_peak(rows))
            lib = timed([lambda w=w: x @ w.dequantize(torch.bfloat16) for w in ws], calls)["ms"]
            cases[-1].update(b, library_ms=lib)
            log(f"  bound {b['bound_ms']:.4f} ms ({b['bound_by']}); dequantize (f32 torch ops, "
                f"then bf16) + torch.matmul, no norm (2+ calls): {lib:.4f} ms")
        del w, ws
    records += _path_records("q4_matmul", "", "tokenhawk_tpu/ops/pallas/qmatmul.py:807 "
                             "(q4_matmul); qmatmul.py:874 (q4_matmul_i4)", cases, "wqkv",
                             stream=True)

    # -- kernel 2: the decode FFN --
    cases = []
    D, F = 4096, 11008
    w13, w2 = qweight(D, 2 * F), qweight(F, D)
    sets = [(QWeight(a, b), QWeight(c, d)) for a, b, c, d in
            copies([w13.qs, w13.scales, w2.qs, w2.scales], w13.nbytes + w2.nbytes)]
    gain = 1.0 + randn(D, scale=0.1)
    for rows in (1, 8):
        x = randn(rows, D)
        case(cases, f"fused_ffn D={D} F={F} rows={rows} f32", "ffn f32", rows,
             ffn.fused_ffn(x.float(), w13, w2, gain.float()),
             ffn.fused_ffn_plain(x.float(), w13, w2, gain.float()), frac=F32_KERNEL_TOL)
        case(cases, f"fused_ffn D={D} F={F} rows={rows}", "ffn", rows,
             ffn.fused_ffn(x, w13, w2, gain), ffn.fused_ffn_plain(x, w13, w2, gain),
             [lambda s=s: ffn.fused_ffn(x, *s, gain) for s in sets],
             [lambda s=s: ffn.fused_ffn_plain(x, *s, gain) for s in sets], alone=True)
        lib = library("rms_norm + dequantize w13 and w2 + 2 torch.matmul + silu, bf16 "
                      "(10+ calls)", [lambda s=s: _ffn_library(x, *s, gain) for s in sets])
        b = bound(3 * D * F * 0.625 + (2 * rows + 1) * D * bf, 6 * rows * D * F, peak=F32_FLOPS)
        cases[-1].update(b, library_ms=lib)
        log(f"  bound {b['bound_ms']:.4f} ms ({b['bound_by']})")
        if rows == 1:
            at, lib1 = b, lib
    del w13, w2, sets
    records.append(_record("fused_ffn", SRC2,
                           "tokenhawk_tpu/ops/pallas/ffn.py:270 (_fused_ffn via fused_ffn)",
                           cases, ("ffn", 1), at, lib1))

    # -- kernel 3: decode append + attend at the 7B's heads, both forms --
    records += _decode_append_records(randn, case)

    # -- kernels 4 and 9: causal prefill attention, bf16 and int8 caches --
    rec4, rec9 = _prefill_records(randn, case, library)
    records.append(rec4)
    records += _paged_kernel_records(randn, case, library, g)
    records += _int8_kernel_records(randn, case, library)
    records.append(rec9)
    records += _paged_int8_kernel_records(randn, case, library, g)
    records += _decode_attend_records(randn, case)
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
    _check_parent_digests()
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

    from tokenhawk_tpu_torch.ops.cuda import build
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

    def one_walk(kv, walk):
        """Kernel 19 on kv, checked to have launched `walk` alone."""
        before = dict(fa.launches)
        got = fa.flash_attention_stats(q, *kv, zero, zero, 1)
        if fa.launches != {**before, walk: before[walk] + 1}:
            raise AssertionError(f"kernel 19 on {kv[0].dtype} K/V did not run {walk} alone")
        _partials_err(f"flash_attention_stats T=512 {walk}", got,
                      fa.flash_attention_stats_plain(q, *kv, zero, zero, 1))
        return got

    got = one_walk((kc, vc), "flash_attention_stats_tc")
    caches = copies([kc, vc], 2 * kc.nbytes)
    case(cases, f"flash_attention_stats (kernel 19) one shard T={T} Hkv={Hkv} Dh={Dh}, q f32, "
                f"K/V bf16 (the tensor-core walk, q and P in 3 bf16 parts)", f"T={T} shards=1",
         T, got[0], fa.flash_attention_stats_plain(q, kc, vc, zero, zero, 1)[0],
         [lambda c=c: fa.flash_attention_stats(q, *c, zero, zero, 1) for c in caches],
         [lambda c=c: fa.flash_attention_stats_plain(q, *c, zero, zero, 1) for c in caches],
         frac=PARTIALS_TOL)
    b19 = bound(2 * f4 * T * Hkv * Dh + 2 * bf * T * Hkv * Dh + 2 * f4 * T * Hkv + 8,
                4 * Hkv * Dh * T * (T + 1) / 2)
    cases[-1].update(b19)
    kf, vf = kc.float(), vc.float()
    # The CUDA-core walk, which f32 K/V blocks keep, on the same values.
    got32 = one_walk((kf, vf), "flash_attention_stats")
    fcaches = copies([kf, vf], 2 * kf.nbytes)
    case(cases, f"flash_attention_stats (kernel 19) one shard T={T}, q f32, K/V f32 (the "
                f"CUDA-core walk)", f"T={T} shards=1 K/V f32", T, got32[0],
         fa.flash_attention_stats_plain(q, kf, vf, zero, zero, 1)[0],
         [lambda c=c: fa.flash_attention_stats(q, *c, zero, zero, 1) for c in fcaches],
         [lambda c=c: fa.flash_attention_stats_plain(q, *c, zero, zero, 1) for c in fcaches],
         frac=PARTIALS_TOL)
    cases[-1].update(bound(4 * f4 * T * Hkv * Dh + 2 * f4 * T * Hkv + 8,
                           4 * Hkv * Dh * T * (T + 1) / 2))
    del fcaches
    lib_out = eff(q[:, :, 0], kf, vf, None, True, is_causal=True, scale=1.0)
    err = (lib_out[0] - got[0][:, :, 0] / got[2][:, :, 0, :, None]).abs().max().item()
    lib19 = timed([lambda c=c: eff(q[:, :, 0], c[0], c[1], None, True, is_causal=True, scale=1.0)
                   for c in copies([kf, vf], 2 * kf.nbytes)])["ms"]
    cases[0]["library_ms"] = lib19
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
    records = [_record("flash_attention_stats", "tokenhawk_tpu_torch/csrc/prefill_tc.cuh",
                       "tokenhawk_tpu/ops/pallas/flash_attention.py:298 (flash_attention_stats, "
                       "_kernel_stats)", cases, (f"T={T} shards=1", T), b19, lib19)]
    del kc, vc, kf, vf, caches

    # -- kernel 18: B=1 at 512, 2048 and 3 live tokens, one shard and 4 cyclic --
    # As CP decode calls it (splits 1): its 32 (sequence, KV head) pairs
    # leave SMs idle, so the one range of each runs over a cluster, merged
    # on chip into one partial; its one-block launch checked and timed beside.
    cases = []
    S = 2048
    q = randn(1, Hkv, 1, Dh, scale=Dh**-0.5)
    kc, vc = randn(1, Hkv, S, Dh), randn(1, Hkv, S, Dh)
    caches = copies([kc, vc], 2 * kc.nbytes)
    cluster = fd.decode_splits(1, Hkv, S, build.sm_count(dev), fd.APPEND_MIN_TILES)
    lib18 = b18 = None

    def b18_at(L):  # the live K/V rows, q, o, m and l, the length
        return bound(2 * L * Hkv * Dh * bf + Hkv * Dh * bf + Hkv * Dh * f4 + 2 * Hkv * f4 + 4,
                     4 * L * Hkv * Dh)

    def stats(kv, lengths, label):
        """Kernel 18 as the wrapper launches it (checked to take the
        cluster), and at one block a pair, each against the plain version."""
        before = fd.launches["flash_decode_stats_split"]
        got = fd.flash_decode_stats(q, *kv, lengths)
        if fd.launches["flash_decode_stats_split"] - before != (cluster > 1):
            raise AssertionError(f"kernel 18 at {label}: the split counter disagrees with a "
                                 f"cluster of {cluster}")
        plain = fd.flash_decode_stats_plain(q, *kv, lengths)
        _partials_err(f"flash_decode_stats {label}, a cluster of {cluster}", got, plain)
        _partials_err(f"flash_decode_stats {label}, one block a pair",
                      fd.flash_decode_stats_at(q, *kv, lengths, 1, 1), plain)
        return got

    for L in (512, 2048, 3):
        lengths = i32(L)
        ref = fd.flash_decode(q, kc, vc, lengths)  # kernel 14
        one = _merge_partials(*stats((kc, vc), lengths, f"L={L}")).reshape(ref.shape)
        label = (f"flash_decode_stats (kernel 18) B=1 L={L} S={S} Hkv={Hkv} Dh={Dh}, one shard, "
                 f"a cluster of {cluster}, o / l against kernel 14")
        if L == 3:
            case(cases, label, f"B=1 L={L} shards=1", 1, one, ref)
        else:
            case(cases, label, f"B=1 L={L} shards=1", 1, one, ref,
                 [lambda c=c: fd.flash_decode_stats(q, *c, lengths) for c in caches],
                 [lambda c=c: fd.flash_decode_stats_plain(q, *c, lengths) for c in caches])
            b = b18_at(L)
            qe = q.reshape(1, Hkv, 1, Dh)
            lib = timed([lambda c=c: eff(qe, c[0][:, :, :L], c[1][:, :, :L], None, True,
                                         scale=1.0) for c in caches])["ms"]
            one_ms = timed([lambda c=c: fd.flash_decode_stats_at(q, *c, lengths, 1, 1)
                            for c in caches])["ms"]
            cases[-1].update(b, library_ms=lib, cluster=cluster, one_block_ms=one_ms)
            log(f"  bound {b['bound_ms']:.4f} ms ({b['bound_by']}); one block a pair: "
                f"{one_ms:.4f} ms; library call _scaled_dot_product_efficient_attention("
                f"compute_log_sumexp) over the live rows: {lib:.4f} ms")
            if L == S:
                b18, lib18 = b, lib
        parts = []
        for i in range(4):
            sl = _shard_count(lengths, i, 4).to(torch.int32)
            kv = (kc[:, :, i::4], vc[:, :, i::4])  # strided views
            parts.append([x[0] for x in stats(kv, sl, f"shard {i} of 4 (L={int(sl[0])})")])
        merged = _merge_partials(*(torch.stack(x) for x in zip(*parts))).reshape(ref.shape)
        case(cases, f"flash_decode_stats B=1 L={L} over 4 cyclic shards (lengths "
                    f"{[int(_shard_count(lengths, i, 4)[0]) for i in range(4)]}), merged, "
                    f"against kernel 14", f"B=1 L={L} shards=4", 1, merged, ref)
        if L == S:  # one shard's call, as a 4-rank CP decode makes it
            sl = _shard_count(lengths, 1, 4).to(torch.int32)
            views = [[x[:, :, 1::4] for x in c] for c in caches]
            case(cases, f"flash_decode_stats B=1 shard 1 of 4 (a strided view, L={int(sl[0])})",
                 f"B=1 L={int(sl[0])} shard 1 of 4", 1, parts[1][0], fd.flash_decode_stats_plain(
                     q, *views[0], sl)[0][0], [lambda c=c: fd.flash_decode_stats(q, *c, sl)
                                               for c in views],
                 [lambda c=c: fd.flash_decode_stats_plain(q, *c, sl) for c in views],
                 frac=PARTIALS_TOL)
            cases[-1].update(b18_at(int(sl[0])))
    # A shard that holds no row yet: every length 0, the merge identity exactly.
    for i in range(4):
        o, m, l = fd.flash_decode_stats(q, kc[:, :, i::4], vc[:, :, i::4], i32(0))
        if not (bool((o == 0).all()) and bool((m == -torch.inf).all()) and bool((l == 0).all())):
            raise AssertionError(f"kernel 18 on an empty shard {i} of 4: not (0, -inf, 0)")
    log("flash_decode_stats on 4 empty shards (lengths 0): (0, -inf, 0) exactly")
    del kc, vc, caches
    cases += _split_decode_cases(randn, case)
    records.append(_record("flash_decode_stats", "tokenhawk_tpu_torch/csrc/decode_stats.cu",
                           "tokenhawk_tpu/ops/pallas/flash_decode_dma.py:761 (flash_decode_stats, "
                           "_kernel_vec_stats)", cases, (f"B=1 L={S} shards=1", 1), b18, lib18))
    return records


def _split_decode_cases(randn, case) -> list:
    """Kernel 18 cut into 1, 4, 8 and 16 splits of S, merged in torch, at
    TinyLlama's heads (4 KV heads of 64, 8 queries each: the draft's) over
    2048 slots, B=1 at 2048 live and B=8 ragged, each held against kernel
    14 and timed beside it (kernel 14's split form merges the same ranges
    on chip)."""
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
    versions; each timed back to back and alone (isolated_ms) beside the
    unfused port kernels it replaces on the model's path, timed both ways
    at the same shapes (kernel 1's Wo + add + kernel 2 at 1 and 8 rows; the
    q scale + kernel 3 + kernel 1's Wo + add at 1, 37 and 512 live rows),
    and the PyTorch calls that compute the same at every case."""
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

    def unfused(fns) -> dict:
        out = {"ms": timed(fns)["ms"], "isolated_ms": isolated_ms(fns)}
        log(f"  unfused port kernels: {out['ms']:.4f} ms, alone {out['isolated_ms']:.4f}")
        return out

    # -- kernel 15 --
    cases, lib = [], {}
    for quant in ("q4_0", "q8_0"):
        ws = [weight(quant, D, D), weight(quant, D, 2 * F), weight(quant, F, D)]
        sets = _weight_sets(ws)
        gain = 1.0 + randn(D, scale=0.1)
        for rows in (1, 8):
            ctx, x = randn(rows, D), randn(rows, D)
            case(cases, f"fused_owo_ffn {quant} Dq=D={D} F={F} rows={rows}", quant, rows,
                 ffn.fused_owo_ffn(ctx, x, *ws, gain), ffn.fused_owo_ffn_plain(ctx, x, *ws, gain),
                 [lambda s=s: ffn.fused_owo_ffn(ctx, x, *s, gain) for s in sets],
                 [lambda s=s: ffn.fused_owo_ffn_plain(ctx, x, *s, gain) for s in sets],
                 alone=True)
            if quant == "q4_0":
                cases[-1]["unfused"] = unfused(
                    [lambda s=s: ffn.fused_ffn(x + qmatmul.quant_matmul(ctx, s[0]), s[1], s[2],
                                               gain) for s in sets])
            cases[-1]["library_ms"] = library(
                "dequantize Wo + matmul + add, then rms_norm + dequantize w13 and w2 + 2 "
                "matmul + silu, bf16 (14+ calls)",
                [lambda s=s: _ffn_library(x + ctx @ s[0].dequantize(torch.bfloat16), s[1],
                                          s[2], gain) for s in sets])
            if quant == "q4_0" and rows == 1:
                lib["owo"] = cases[-1]["library_ms"]
        del ws, sets
    owo = _record("fused_owo_ffn", SRC2,
                  "tokenhawk_tpu/ops/pallas/ffn.py:431 (_fused_owo_ffn via fused_owo_ffn)",
                  cases, ("q4_0", 1),
                  bound((D * D + 3 * D * F) * 0.625 + 4 * D * bf, 2 * (D * D + 3 * D * F)),
                  lib["owo"])
    owo["unfused_ms"] = cases[0]["unfused"]["ms"]

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
                                                                c[2]) for c in sets],
                 alone=True)
            if quant == "q4_0":
                cases[-1]["unfused"] = unfused([lambda c=c: x + qmatmul.quant_matmul(
                    flash_decode.flash_decode_append(
                        (q[:, 0] * scale).reshape(1, H, 1, Dh), kn[:, 0], vn[:, 0], *c[:2],
                        lengths).reshape(1, 1, D), c[2]) for c in sets])
            cases[-1]["library_ms"] = library(
                "scaled_dot_product_attention over the live rows (no append) + dequantize "
                "Wo + matmul + add (4+ calls)",
                [lambda c=c: x + tf.scaled_dot_product_attention(
                    q.transpose(1, 2), c[0][:, :, :L], c[1][:, :, :L]).reshape(1, 1, D)
                 @ c[2].dequantize(torch.bfloat16) for c in sets])
            if quant == "q4_0" and L == S:
                lib["attn"] = cases[-1]["library_ms"]
            del kc, vc, kp, vp, sets
        del wo
    attn = _record("fused_attn_out", "tokenhawk_tpu_torch/csrc/attn_wo.cu",
                   "tokenhawk_tpu/ops/pallas/attn_block.py:303 (_attn_wo via fused_attn_out)",
                   cases, (f"q4_0 L={S}", 1),
                   bound(D * D * 0.625 + (2 * S + 5) * H * Dh * bf + 2 * D * bf,
                         2 * D * D + 4 * S * H * Dh), lib["attn"])
    attn["unfused_ms"] = cases[2]["unfused"]["ms"]
    log("kernels 15 and 16 against the unfused port kernels (ms back to back / alone):")
    for rec in (owo, attn):
        for c in rec["cases"]:
            if "unfused" in c:
                u = c["unfused"]
                faster = c["ms"] < u["ms"] and c["isolated_ms"] < u["isolated_ms"]
                log(f"  {rec['name']} {c['shape']} rows={c['rows']}: {c['ms']:.4f} / "
                    f"{c['isolated_ms']:.4f} against {u['ms']:.4f} / {u['isolated_ms']:.4f} "
                    f"({'faster' if faster else 'NOT faster'} both ways)")
    return [owo, attn]


def _paged_head_dim_64_cases(randn, case, g) -> dict:
    """Kernels 5-7 and 10-12 at TinyLlama's heads (4 KV heads of 64, 8
    queries each) over phase 2's paged shapes (B=8, PAGED_LENGTHS, a 140-page
    pool, shuffled table, two appends on the trash page), bf16 and int8
    pages, both layouts, checked: appends and gathers exactly; kernels 5
    and 10 with their appends folded in (_fold_cases).  Returns kernel
    name -> cases."""
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
        _fold_cases(False, q, pool, kn, vn, table, lengths, layout, trash, case,
                    out.setdefault("paged_decode_append", []), f"dh64 {layout}")

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
        _fold_cases(True, q, ipool, kn, vn, table, lengths, layout, trash, case,
                    out.setdefault("paged_decode_int8_append", []), f"dh64 {layout}")
        del pool, ipool, pa, pb, got, want
    return out


def _weight_copies(w) -> list:
    """copies() of a QWeight, each a QWeight."""
    return [ws[0] for ws in _weight_sets([w])]


def _group_code_kernel_records(randn, case, library, g) -> list:
    """Kernel 13 at every projection shape of phases 6 and 6q (Llama-3-8B
    in Q4_K_M: Q4_K, with Q6_K for the output and for w2 on some layers;
    LLaMA-7B in Q8_0) at QMATMUL_ROWS, with and without the fused norm;
    kernel 2 over those models' FFN pairings at 1 and 8 rows.  Each shape
    is timed in the form the path runs it (norm fused into wqkv and the
    output), the other form only checked; each timed case gets its bound
    and the time of the same function from PyTorch calls (dequantize, then
    torch.matmul); at 1 and 8 rows float32 x is checked too.  Two records
    per model, the decode-row walk's timed at one row and the tensor-core
    path's at 512, and one per pairing, timed at one row."""
    import torch

    from tokenhawk_tpu_torch.ops.cuda import ffn, qmatmul
    from tokenhawk_tpu_torch.ops.qweight import QWeight

    dev = torch.device("cuda")
    bf = 2
    src2 = SRC2
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
            for rows in QMATMUL_ROWS:
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
                    if rows <= 8:  # the decode-row walk on f32 x too
                        xf, gf = x.float(), None if ng is None else ng.float()
                        case(cases, label + " f32", f"{name} f32", rows,
                             qmatmul.quant_matmul(xf, w, gf), qmatmul.quant_matmul_plain(xf, w, gf),
                             frac=F32_KERNEL_TOL)
                    case(cases, label, name, rows, out, ref,
                         [lambda w=w: qmatmul.quant_matmul(x, w, ng) for w in ws],
                         [lambda w=w: qmatmul.quant_matmul_plain(x, w, ng) for w in ws],
                         calls=calls, alone=rows <= 8)
                    # x, the gain and y once each, beside the weight's GGUF
                    # blocks (its bytes in the port's layout as layout_bound_ms).
                    io = (rows * (K + N) + K * norm) * bf
                    b = bound(_ggml_bytes(form, K, N) + io, 2 * rows * K * N, w.nbytes + io,
                              peak=_peak(rows))
                    lib_ms = timed([lambda w=w: x @ w.dequantize(torch.bfloat16) for w in ws],
                                   calls)["ms"]
                    cases[-1].update(b, library_ms=lib_ms)
                    log(f"  bound {b['bound_ms']:.4f} ms ({b['bound_by']}; in the port's layout "
                        f"{b['layout_bound_ms']:.4f}); dequantize (f32 "
                        f"torch ops, then bf16) + torch.matmul, no norm (2+ calls): "
                        f"{lib_ms:.4f} ms")
            del w, ws
        records += _path_records("qk_matmul", f"[{tag}]", rep13, cases, "wqkv", stream=True)

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
            xf, gf = x.float(), gain.float()
            case(cases, f"fused_ffn {tag} D={D} F={F} rows={rows} f32", "ffn f32", rows,
                 ffn.fused_ffn(xf, w13, w2, gf), ffn.fused_ffn_plain(xf, w13, w2, gf),
                 frac=F32_KERNEL_TOL)
            case(cases, f"fused_ffn {tag} D={D} F={F} rows={rows}", "ffn", rows,
                 ffn.fused_ffn(x, w13, w2, gain), ffn.fused_ffn_plain(x, w13, w2, gain),
                 [lambda s=s: ffn.fused_ffn(x, *s, gain) for s in sets],
                 [lambda s=s: ffn.fused_ffn_plain(x, *s, gain) for s in sets], alone=True)
            io = (2 * rows + 1) * D * bf
            b = bound(_ggml_bytes(f13, D, 2 * F) + _ggml_bytes(f2, F, D) + io, 6 * rows * D * F,
                      w13.nbytes + w2.nbytes + io, peak=F32_FLOPS)
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


# Kernel 17's rows in phase 2: decode (1) and kernel 2's most (8) on the
# GEMV; 9, 16, the 8-slot verify's 40 and a 512-token prefill on the
# tensor-core GEMM.
SB_ROWS = (1, 8, 9, 16, 40, 512)


def _sb_kernel_records(randn, case, library, g) -> list:
    """Kernel 17 (Q4_K super-blocks, the forms of THAWK_Q4K_SB=1) at phase
    11a's projection shapes (Llama-3-8B: wqkv and w13 with the norm fused,
    wo without; the other norm form only checked) at SB_ROWS, each timed
    with its bound at the GGUF blocks' 0.5625 B a weight and at the
    layout's bytes, dequantize + torch.matmul, and kernel 13 over the flat
    form of the same codes (flat_ms: its GEMV at 8 rows and below, its
    tensor-core path above); two records, the GEMV's (timed at wqkv, one
    row) and the tensor-core path's (wqkv, 512 rows).  Then kernel 2 with
    an sb w13 over a Q6_K and a flat Q4_K w2 at one row, beside kernel 2
    over the flat w13."""
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
        for rows in SB_ROWS:
            x = randn(rows, K)
            for ng in (gain, None):
                path = "_tc" if qmatmul.tensor_core_path(x.dtype, rows) else ""
                label = (f"qk_sb_matmul{path} Llama-3-8B {name} K={K} N={N} rows={rows} "
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
                     calls=calls, alone=rows <= 8)
                io = (rows * (K + N) + K * norm) * bf
                b = bound(_ggml_bytes("q4_k", K, N) + io, 2 * rows * K * N, w.nbytes + io,
                          peak=_peak(rows))
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
        del w, ws, flats
    records = _path_records("qk_sb_matmul", "", "tokenhawk_tpu/ops/pallas/qmatmul.py:637 "
                            "(qk_sb_matmul)", cases, "wqkv", stream=True)
    for rec in records:
        rec["flat_ms"] = next(c["flat_ms"] for c in rec["cases"]
                              if c["shape"] == "wqkv" and c.get("flat_ms") is not None
                              and rec["timed_at"] == f"wqkv rows={c['rows']}")

    D, F = 4096, 14336
    for tag, f2 in (("q4k_sb/q6_k", "q6_k"), ("q4k_sb/q4_k", "q4_k")):
        w13, w2 = QWeight.random(D, 2 * F, "q4k_sb", g, dev), QWeight.random(F, D, f2, g, dev)
        sets = list(zip(_weight_copies(w13), _weight_copies(w2)))
        flat_sets = [(a.flat(), b) for a, b in sets]
        gain = 1.0 + randn(D, scale=0.1)
        cases = []
        for rows in (1, 8):
            x = randn(rows, D)
            case(cases, f"fused_ffn {tag} D={D} F={F} rows={rows}", "ffn", rows,
                 ffn.fused_ffn(x, w13, w2, gain), ffn.fused_ffn_plain(x, w13, w2, gain),
                 [lambda s=s: ffn.fused_ffn(x, *s, gain) for s in sets],
                 [lambda s=s: ffn.fused_ffn_plain(x, *s, gain) for s in sets], alone=True)
            io = (2 * rows + 1) * D * bf
            b = bound(_ggml_bytes("q4_k", D, 2 * F) + _ggml_bytes(f2, F, D) + io,
                      6 * rows * D * F, w13.nbytes + w2.nbytes + io, peak=F32_FLOPS)
            lib_ms = library("rms_norm + dequantize w13 and w2 + 2 torch.matmul + silu, bf16 "
                             "(10+ calls)", [lambda s=s: _ffn_library(x, *s, gain) for s in sets])
            flat_ms = timed([lambda s=s: ffn.fused_ffn(x, *s, gain) for s in flat_sets])["ms"]
            cases[-1].update(b, library_ms=lib_ms, flat_ms=flat_ms)
            log(f"  bound {b['bound_ms']:.4f} ms ({b['bound_by']}; in the port's layout "
                f"{b['layout_bound_ms']:.4f}); kernel 2 over the flat w13 of the same codes: "
                f"{flat_ms:.4f} ms")
            if rows == 1:
                at, lib1, flat1 = b, lib_ms, flat_ms
        records.append(_record(f"fused_ffn[{tag}]", SRC2,
                               "tokenhawk_tpu/ops/pallas/ffn.py:270 (_fused_ffn via fused_ffn, "
                               "sb w13: ffn.py:195-197)", cases, ("ffn", 1), at, lib1)
                       | {"flat_ms": flat1})
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
    lengths and pools of the cases above (kernels 5 and 10 also with their
    appends folded in, _fold_cases).  Returns kernel name -> cases."""
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
    trash = int(perm[-1])
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
    _fold_cases(False, q, pool, kn, vn, table, lengths, "contig", trash, case,
                out.setdefault("paged_decode_append", []), "rep4 contig")
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
    _fold_cases(True, q, ipool, kn, vn, table, lengths, "contig", trash, case,
                out.setdefault("paged_decode_int8_append", []), "rep4 contig")
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


# Kernel 14's cases, (label, Hkv, rep, Dh, S, lengths): LLaMA-7B's heads
# (32 KV heads of 128, one query each) at B=1 over 512, as phase 8's dense
# 7B decodes; TinyLlama's (4 KV heads of 64, 8 queries each) over 2048 at
# B=1 and at B=8 with ragged lengths, as phase 9's draft decodes; the 7B's
# heads at B=8 (256 pairs fill the card: one block a pair, splits = 1);
# short and mid live lengths at the draft's B=1 (a draft round's lengths:
# most ranges empty, the rest at least MIN_SPLIT_TILES tiles).
DECODE_CASES = [("7B B=1 L=512", 32, 1, 128, S_CTX, [S_CTX]),
                ("TinyLlama B=1 L=2048", 4, 8, 64, 2048, [2048]),
                ("TinyLlama B=8 ragged", 4, 8, 64, 2048, PAGED_LENGTHS),
                ("7B B=8 ragged", 32, 1, 128, 2048, PAGED_LENGTHS),
                ("TinyLlama B=1 L=37", 4, 8, 64, 2048, [37]),
                ("TinyLlama B=1 L=300", 4, 8, 64, 2048, [300])]
# The split counts swept at the first three cases and the last (ranges of
# the live rows from 64 tiles down to 1, no floor), which set
# flash_decode.MIN_SPLIT_TILES.
SWEPT = ("7B B=1 L=512", "TinyLlama B=1 L=2048", "TinyLlama B=8 ragged", "TinyLlama B=1 L=300")
SPLIT_SWEEP = (1, 2, 4, 8, 16)


def _decode_attend_records(randn, case) -> list:
    """Kernel 14 (decode attention, no append) at DECODE_CASES, each
    against its plain version, timed as the wrapper launches it (the split
    form where decode_splits gives more than 1) beside its one-block launch
    (splits = 1, the launch before the split form), its bound and SDPA
    over the same live rows; the split counts of SPLIT_SWEEP at SWEPT.
    Two records: kernel 14 as the model calls it, timed at the 7B's
    B=1 (phase 8's shape), and its split form alone (the cases with splits
    > 1), timed at the draft's B=1."""
    import torch

    from tokenhawk_tpu_torch.ops.cuda import build
    from tokenhawk_tpu_torch.ops.cuda import flash_decode as fd

    log("-- kernel 14: split-S in thread-block clusters where the (sequence, KV head) pairs "
        "leave SMs idle")
    dev = torch.device("cuda")
    sms = build.sm_count(dev)
    bf = 2
    cases = []
    for label, Hkv, rep, Dh, S, lens in DECODE_CASES:
        B = len(lens)
        splits = fd.decode_splits(B, Hkv, S, sms)
        if label == "7B B=8 ragged" and splits != 1:
            raise AssertionError(f"kernel 14 at {label} takes {splits} splits, not one block a pair")
        q = randn(B, Hkv, rep, Dh, scale=Dh**-0.5)
        kc, vc = randn(B, Hkv, S, Dh), randn(B, Hkv, S, Dh)
        lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
        caches = copies([kc, vc], 2 * kc.nbytes)
        before = fd.launches["flash_decode_split"]
        out = fd.flash_decode(q, kc, vc, lengths)
        if fd.launches["flash_decode_split"] - before != (splits > 1):
            raise AssertionError(f"kernel 14 at {label}: the split counter disagrees with "
                                 f"{splits} splits")
        ref = fd.flash_decode_plain(q, kc, vc, lengths)
        case(cases, f"flash_decode (kernel 14) {label} Hkv={Hkv} rep={rep} Dh={Dh} S={S} "
                    f"lengths={lens}, {splits} splits", label, B, out, ref,
             [lambda c=c: fd.flash_decode(q, *c, lengths) for c in caches],
             [lambda c=c: fd.flash_decode_plain(q, *c, lengths) for c in caches])
        live = sum(min(n, S) for n in lens)
        # K and V rows of the live tokens, q and out, the lengths.
        b = bound(2 * live * Hkv * Dh * bf + 2 * B * Hkv * rep * Dh * bf + 4 * B,
                  4 * live * Hkv * rep * Dh)
        lib = _sdpa_ms(q, caches, lens)
        one = timed([lambda c=c: fd.flash_decode_at(q, *c, lengths, 1) for c in caches])["ms"]
        cases[-1].update(b, library_ms=lib, splits=splits, one_block_ms=one)
        log(f"  bound {b['bound_ms']:.4f} ms ({b['bound_by']}); one block a pair (splits 1): "
            f"{one:.4f} ms; library call scaled_dot_product_attention over the live rows: "
            f"{lib:.4f} ms")
        if label in SWEPT:
            sweep = {}
            for n in SPLIT_SWEEP:
                err, tol = max_err(fd.flash_decode_at(q, kc, vc, lengths, n, 1), ref)
                if not err <= tol:
                    raise AssertionError(f"kernel 14 at {label}, {n} splits: {err} > {tol}")
                sweep[n] = timed([lambda c=c, n=n: fd.flash_decode_at(q, *c, lengths, n, 1)
                                  for c in caches])["ms"]
            cases[-1]["sweep_ms"] = sweep
            tiles = (max(lens) + 31) // 32
            log(f"  sweep (splits: ms, live tiles a range): " + ", ".join(
                f"{n}: {ms:.4f} ({-(-tiles // n)})" for n, ms in sweep.items()))
        del kc, vc, caches
    src = "tokenhawk_tpu_torch/csrc/flash_decode.cu"
    rep14 = ("tokenhawk_tpu/ops/pallas/flash_decode_dma.py:1396 (flash_decode_dma); "
             "flash_decode_dma.py:1328 (flash_decode_loop); "
             "tokenhawk_tpu/ops/pallas/flash_decode.py:121 (flash_decode via attend_decode)")

    def at(label):
        c = next(c for c in cases if c["shape"] == label)
        return (label, 1), {k: c[k] for k in ("bound_ms", "bound_by")}, c["library_ms"]

    return [_record("flash_decode_attend", src, rep14, cases, *at("7B B=1 L=512")),
            _record("flash_decode_attend_split", src, rep14 + ", where the (sequence, KV "
                    "head) pairs leave SMs idle: split-S in clusters, merged on chip",
                    [c for c in cases if c["splits"] > 1], *at("TinyLlama B=1 L=2048"))]


# Kernel 3's cases at the 7B's heads (32 KV heads of 128, one query each),
# (label, lengths, S): B=4 ragged; B=1 at 37, 300 and 512 live rows of 512
# (phase 4's Engine decodes there: the split form) and 2048 of 2048; B=8
# ragged over 2048 (the dense Scheduler's 8 slots: 256 pairs fill the card,
# one block a pair).
APPEND_CASES = [("B=4 ragged", [1, 37, 300, S_CTX], S_CTX),
                ("B=1 L=37", [37], S_CTX),
                ("B=1 L=300", [300], S_CTX),
                ("B=1 L=512", [S_CTX], S_CTX),
                ("B=1 L=2048", [2048], 2048),
                ("B=8 ragged", PAGED_LENGTHS, 2048)]
# The split counts swept at these (ranges of the live rows, no floor).
APPEND_SWEPT = ("B=1 L=300", "B=1 L=512", "B=1 L=2048")


def _decode_append_records(randn, case) -> list:
    """Kernel 3 (decode append + attend) at APPEND_CASES, each against its
    plain version with the caches written bit for bit as the plain's, timed
    as the wrapper launches it (the split form where decode_splits gives
    more than 1) beside its one-block launch (splits = 1, also checked and
    its caches compared), its bound and SDPA over the same live rows (no
    append).  Two records: kernel 3 as the model calls it, timed at B=1 over
    512 (phase 4's shape), and its split form alone, timed at B=1 over
    2048."""
    import torch

    from tokenhawk_tpu_torch.ops.cuda import build
    from tokenhawk_tpu_torch.ops.cuda import flash_decode as fd

    log("-- kernel 3: decode append + attend, its tile walk in clusters where the (sequence, "
        "KV head) pairs leave SMs idle, else one block a pair")
    dev = torch.device("cuda")
    sms = build.sm_count(dev)
    Hkv, Dh, bf = 32, 128, 2
    cases = []
    for label, lens, S in APPEND_CASES:
        B = len(lens)
        splits = fd.decode_splits(B, Hkv, S, sms, fd.APPEND_MIN_TILES)
        if (B * Hkv < sms) != (splits > 1):
            raise AssertionError(f"kernel 3 at {label}: {splits} splits for {B * Hkv} pairs")
        q = randn(B, Hkv, 1, Dh, scale=Dh**-0.5)
        kn, vn = randn(B, Hkv, Dh), randn(B, Hkv, Dh)
        kc, vc = randn(B, Hkv, S, Dh), randn(B, Hkv, S, Dh)
        lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
        kp, vp = kc.clone(), vc.clone()
        ref = fd.flash_decode_append_plain(q, kn, vn, kp, vp, lengths)
        forms = {}
        for n in sorted({splits, 1}, reverse=True):  # as the wrapper picks, then one block
            k1, v1 = kc.clone(), vc.clone()
            before = fd.launches["flash_decode_append_split"]
            forms[n] = (fd.flash_decode_append(q, kn, vn, k1, v1, lengths) if n == splits
                        else fd.flash_decode_append_at(q, kn, vn, k1, v1, lengths, n))
            if fd.launches["flash_decode_append_split"] - before != (n > 1):
                raise AssertionError(f"kernel 3 at {label}: the split counter disagrees with "
                                     f"{n} splits")
            if not (torch.equal(k1, kp) and torch.equal(v1, vp)):
                raise AssertionError(f"kernel 3 at {label}, {n} splits: caches differ from the "
                                     f"plain's")
        err1, tol1 = max_err(forms[1], ref)
        if not err1 <= tol1:
            raise AssertionError(f"kernel 3 at {label}, one block a pair: {err1} > {tol1}")
        caches = copies([kc, vc], 2 * kc.nbytes)
        case(cases, f"flash_decode_append (kernel 3) {label} Hkv={Hkv} Dh={Dh} S={S} "
                    f"lengths={lens}, {splits} splits (caches identical)", label, B,
             forms[splits], ref,
             [lambda c=c: fd.flash_decode_append(q, kn, vn, *c, lengths) for c in caches],
             [lambda c=c: fd.flash_decode_append_plain(q, kn, vn, *c, lengths) for c in caches])
        live = sum(min(n, S) for n in lens)
        # K and V rows of the live tokens, q, k_new, v_new and out, the two
        # rows written, the lengths.
        b = bound((2 * live + 6 * B) * Hkv * Dh * bf + 4 * B, 4 * live * Hkv * Dh)
        lib = _sdpa_ms(q, caches, lens)
        one = timed([lambda c=c: fd.flash_decode_append_at(q, kn, vn, *c, lengths, 1)
                     for c in caches])["ms"]
        cases[-1].update(b, library_ms=lib, splits=splits, one_block_ms=one,
                         one_block_max_abs_err=err1)
        log(f"  bound {b['bound_ms']:.4f} ms ({b['bound_by']}); one block a pair (splits 1): "
            f"{one:.4f} ms (max_abs_err {err1:.3e}); library call scaled_dot_product_attention "
            f"over the live rows (no append): {lib:.4f} ms")
        if label in APPEND_SWEPT:
            sweep = {}
            for n in SPLIT_SWEEP:
                err, tol = max_err(fd.flash_decode_append_at(q, kn, vn, kc.clone(), vc.clone(),
                                                             lengths, n, 1), ref)
                if not err <= tol:
                    raise AssertionError(f"kernel 3 at {label}, {n} splits: {err} > {tol}")
                sweep[n] = timed([lambda c=c, n=n: fd.flash_decode_append_at(
                    q, kn, vn, *c, lengths, n, 1) for c in caches])["ms"]
            cases[-1]["sweep_ms"] = sweep
            tiles = (max(lens) + 31) // 32
            log(f"  sweep (splits: ms, live tiles a range): " + ", ".join(
                f"{n}: {ms:.4f} ({-(-tiles // n)})" for n, ms in sweep.items()))
        del kc, vc, kp, vp, caches
    src = "tokenhawk_tpu_torch/csrc/decode_append.cu"
    rep3 = ("tokenhawk_tpu/ops/pallas/flash_decode_dma.py:1112 (flash_decode_append_walk); "
            "flash_decode_dma.py:1218 (flash_decode_append)")

    def at(label):
        c = next(c for c in cases if c["shape"] == label)
        return (label, len(next(x[1] for x in APPEND_CASES if x[0] == label))), \
            {k: c[k] for k in ("bound_ms", "bound_by")}, c["library_ms"]

    return [_record("flash_decode_append", src, rep3, cases, *at("B=1 L=512")),
            _record("flash_decode_append_split", src, rep3 + ", where the (sequence, KV "
                    "head) pairs leave SMs idle: split-S in clusters, merged on chip",
                    [c for c in cases if c["splits"] > 1], *at("B=1 L=2048"))]


# sha256 of outputs of the kernels whose launches this tree keeps as its
# parent had them (kernel 16 and the GEMV of kernels 1, 13 and 17 at 1 and
# 8 rows of bfloat16 x and at 40 rows of float32 x), on _output_digests'
# inputs, as the tree before kernel 14's split form and kernel 17's
# tensor-core path computed them on an NVIDIA H100 80GB HBM3: they must not
# move by a bit.  Kernel 3 was then redesigned (its tile walk and split
# form sum in another order): its two entries are that tree's outputs, its
# written caches as before; moving its walk into decode_tiles.cuh moved
# none of them.  Kernels 18 and 5 then took that walk (another summation
# order; kernel 18's splits=1 a cluster's merge): their entries are that
# tree's.  Kernel 13's group codes at 1 and 8 rows of bfloat16 x (the g32m
# and g16 entries) and kernel 2 then took the decode-row walk
# (gemv_stream.cuh: the group sums of a slot as before, the slots summed
# over the lanes of a warp, K's segments in order): those entries, and
# kernel 2's at one row, were that tree's.  Kernels 1 and 17 (the q4_0 and
# sb entries at 1 and 8 rows) then took the walk too, and the walk split
# each column pair's K over two warps where the pairs leave a last wave
# (N 6144 here; kernel 2's F 11008): the parts' sums add in order after
# each part's butterfly.  So the q4_0 entries at 1 and 8 rows, sb at 8 and
# the g32m at 8 and g16 at 1 and 8 moved and are this tree's; g32m and sb
# at one row and kernel 2's q4_0 pair kept their bfloat16 outputs bit for
# bit (a change of a few f32 ulps seldom moves a bfloat16 rounding).  The
# float32 40-row entries stay on the GEMV, bit for bit.  Kernels 8 and 10
# then took the tile walk over int8 rows (codes and scales copied together,
# code x scale widened in f32 where used, kernel 3's summation order and
# split forms): their entries (the output, and kernel 8's written cache)
# are that tree's, at their split rules (kernel 8 at one block an SM,
# kernel 10 in 2 where the pairs fill the SMs).  Kernels 15 and 16 then
# took the walks (kernel 16's attention the tile walk at kernel 3's split
# rule, its Wo and kernel 15's three launches the decode-row walk at the
# rule's plans): kernel 15's entries are that tree's; kernel 16's output
# and written caches came out bit for bit as before.
PARENT_DIGESTS = {
    'kernel 3 7B':
        '0b730923adc93bb96be8a17ca537594d8a6b6dcfbc80b92751aafae0e157b96d',
    'kernel 18 7B splits=1':
        '780d66d8ff7f301502128a0400bc56f1c747e507a3abe3c53acb852cc516a47a',
    'kernel 18 7B splits=8':
        '789c7e304a807b05b31b885c2ede6b8da965d06a1c449a52c500c405558e50af',
    'kernel 18 7B shard 1 of 4':
        'b849ae0e3ca99ec681204146256c0b0385978b360068d69631f725e6cae1acbd',
    'kernel 3 dh64':
        '7f8e4039744d8a97e2ce2cd32e429d679cda7ffe83821d0114994174cd133991',
    'kernel 18 dh64 splits=1':
        '0c6c35d96420b476ebeda935745408602024796e5716d658e0a252601d8bf9a7',
    'kernel 18 dh64 splits=8':
        '6ea5ab6b0132539c6dfff1e4f377f1d33f262834ecce4cfc5a5c288f72710062',
    'kernel 18 dh64 shard 1 of 4':
        '7077e624eb17b3fc6d42321bee5c4c6ce1795f6fff0064030f284be9c76b8c90',
    'kernel 16 7B Q4_0 Wo':
        '2f9cee5a3964fb3b917e1e4ef2732076a86aaf40dc5f917f2a55ba895cbb740a',
    'GEMV q4_0 rows=1 torch.bfloat16':
        '4935f01b3b8210d2742abb875aabc7a3c876de1fb0a1c1a4fff68d2a2ff6460b',
    'GEMV q4_0 rows=8 torch.bfloat16':
        'ee1d7aa3492448d4fd9932211249ed61efe2ccec0020e6293975267b88bdfe45',
    'GEMV q4_0 rows=40 torch.float32':
        '24fb65013e95744abda9bd8dfd3a4e018e4a11936843b180f2d79029b564edb0',
    'GEMV g32m rows=1 torch.bfloat16':
        '644613dd645a9aa1bebe480575bcfa0bd542aad4c5a30623fc8a7a13a3be6b8f',
    'GEMV g32m rows=8 torch.bfloat16':
        'e1b3da538edd2766a27f84821049e9461c0eeb1cca9213ce879a5a0cc8eb77e3',
    'GEMV g32m rows=40 torch.float32':
        '5ce9435a216b8092b21da0f25943e24ad1740923928b471290df27f244ae3512',
    'GEMV g16 rows=1 torch.bfloat16':
        'a76f33223b786ca5129f43d481fda1f6e32bac0022895f85f3f2f31328ac5fa3',
    'GEMV g16 rows=8 torch.bfloat16':
        'a4aef11de6bfa16e49227fd4fdb3d2c69e164638c3d22dfad22fbd5dfd71497e',
    'GEMV g16 rows=40 torch.float32':
        'f33717e3edae3e607dfcd841d59aef746b7fb01e9c70b2424dc2f936d2d55cc4',
    'GEMV sb rows=1 torch.bfloat16':
        '0ea3a0bdbca9234858c017051e14f5527cbf64e3eced5da869b401b807f1f2f8',
    'GEMV sb rows=8 torch.bfloat16':
        '07b1e61e561f0c71bdc10c3782276df60d0641cb9ce207f5281e31a479101c9d',
    'GEMV sb rows=40 torch.float32':
        'f2f78be5b3088ebc7e25e434ea5a654c3507508dffd5d745fbb368ea2f180ada',
    'kernel 5 7B':
        '1e68e3aa11881b5c68ea5328a16e7236c178fa89b6daa7448b7e2d055e411c4a',
    'kernel 5 dh64':
        '95b7197dc3f0f2eac4a898b3f14ce1c42fdb746bf6843a5037a36ec5cbad7333',
    'kernel 2 q4_0/q4_0 rows=1 torch.bfloat16':
        '7cd4e6ba24952cb765f6dd5a11ac806401f6bff3d0e23ee1a6a98fbde447c795',
    'kernel 2 g32m/g16 rows=1 torch.bfloat16':
        'a7605c204fe76c61ea9a959755b11349adbe0a65cf9cefe66195b9e916a94b29',
    'kernel 8 7B':
        '72f84c842ac59cda39e5c9e6757ca7737694cd235f47ac6c89b4d03665d953c7',
    'kernel 8 dh64':
        '8f73e15ccf5466f9abe8fc291d4cffefdd3e188e957e13013703dcd9ffda66e2',
    'kernel 10 7B':
        '031e62ea20ec7c4d22589ca3d58107ef7683ba42f7bb2c3323812879bac98168',
    'kernel 10 dh64':
        '1c6d4aa3ca0b7cbc44bf2b3a7792764cec1e16dd9920add9be486afa4e375318',
    'kernel 15 q4_0/q4_0 rows=1 torch.bfloat16':
        'b934ad1c859d6acdf8f01c1affac55b9ae4ec9adde4cbc609602aa63e568517b',
    'kernel 15 q4_0/q4_0 rows=8 torch.bfloat16':
        '0741a0d6e95321098f1bd34f442bb7e0007feee31aaff07913f1795da91f5526',
}


def _output_digests() -> dict:
    """name -> sha256 of the outputs (and written caches) of the calls
    PARENT_DIGESTS pins, on inputs from numpy's generator (so the digest
    depends on the kernels alone), at phase 2's shapes."""
    import hashlib

    import torch

    from tokenhawk_tpu_torch.ops.cuda import ffn
    from tokenhawk_tpu_torch.ops.cuda import flash_decode as fd
    from tokenhawk_tpu_torch.ops.cuda import kv_int8 as ki
    from tokenhawk_tpu_torch.ops.cuda import paged_decode as pd
    from tokenhawk_tpu_torch.ops.cuda import paged_int8 as pi
    from tokenhawk_tpu_torch.ops.cuda import qmatmul
    from tokenhawk_tpu_torch.ops.kvquant import quantize_kv_block
    from tokenhawk_tpu_torch.ops.qweight import QWeight

    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED + 99)

    def arr(*shape, scale=1.0, dtype=torch.bfloat16):
        a = (rng.standard_normal(shape) * scale).astype(np.float32)
        return torch.from_numpy(a).to(dev).to(dtype)

    def ints(lo, hi, shape, dtype):
        return torch.from_numpy(rng.integers(lo, hi, shape).astype(np.int64)).to(dev).to(dtype)

    def digest(*ts):
        h = hashlib.sha256()
        for x in ts:
            h.update(x.detach().contiguous().view(torch.uint8).cpu().numpy().tobytes())
        return h.hexdigest()

    out = {}
    for tag, Hkv, rep, Dh, S, lens in (("7B", 32, 1, 128, S_CTX, [1, 37, 300, S_CTX]),
                                       ("dh64", 4, 8, 64, 2048, PAGED_LENGTHS)):
        B = len(lens)
        q = arr(B, Hkv, rep, Dh, scale=Dh**-0.5)
        kn, vn = arr(B, Hkv, Dh), arr(B, Hkv, Dh)
        kc, vc = arr(B, Hkv, S, Dh), arr(B, Hkv, S, Dh)
        lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
        o = fd.flash_decode_append(q, kn, vn, kc, vc, lengths)
        out[f"kernel 3 {tag}"] = digest(o, kc, vc)
        for splits in (1, 8):
            out[f"kernel 18 {tag} splits={splits}"] = digest(
                *fd.flash_decode_stats(q, kc, vc, lengths, splits))
        shard = (kc[:, :, 1::4], vc[:, :, 1::4])  # a strided shard of the cache
        out[f"kernel 18 {tag} shard 1 of 4"] = digest(*fd.flash_decode_stats(
            q, *shard, torch.div(lengths + 2, 4, rounding_mode="floor").to(torch.int32)))
    H, Dh, S, D = 32, 128, S_CTX, 4096
    wo = QWeight.from_codes(ints(0, 16, (D, H * Dh), torch.uint8),
                            arr(D, H * Dh // 32, scale=1e-3, dtype=torch.float32).abs(), dev)
    x, q, kn, vn = arr(1, 1, D), arr(1, 1, H, Dh), arr(1, 1, H, Dh), arr(1, 1, H, Dh)
    kc, vc = arr(1, H, S, Dh), arr(1, H, S, Dh)
    y = fd.fused_attn_out(x, q, kn, vn, kc, vc, torch.tensor([300], dtype=torch.int32,
                                                              device=dev), wo)
    out["kernel 16 7B Q4_0 Wo"] = digest(y, kc, vc)
    K, N = 4096, 6144
    weights = {
        "q4_0": QWeight.from_codes(ints(0, 16, (N, K), torch.uint8),
                                   arr(N, K // 32, scale=1e-3, dtype=torch.float32).abs(), dev),
        "g32m": QWeight.from_group_codes(ints(0, 16, (N, K), torch.int8),
                                         arr(N, K // 32, scale=1e-3, dtype=torch.float32).abs(),
                                         arr(N, K // 32, scale=1e-2, dtype=torch.float32), 32,
                                         dev),
        "g16": QWeight.from_group_codes(ints(-32, 32, (N, K), torch.int8),
                                        arr(N, K // 16, scale=1e-3, dtype=torch.float32).abs(),
                                        None, 16, dev),
        "sb": QWeight.from_super_blocks(ints(0, 16, (N, K), torch.uint8),
                                        ints(0, 64, (N, K // 32), torch.uint8),
                                        ints(0, 64, (N, K // 32), torch.uint8),
                                        arr(N, K // 256, scale=1e-4, dtype=torch.float32).abs(),
                                        arr(N, K // 256, scale=1e-4, dtype=torch.float32).abs(),
                                        dev)}
    gain = 1.0 + arr(K, scale=0.1)
    for form, w in weights.items():
        for rows, dtype in ((1, torch.bfloat16), (8, torch.bfloat16), (40, torch.float32)):
            x = arr(rows, K, dtype=dtype)
            out[f"GEMV {form} rows={rows} {dtype}"] = digest(
                qmatmul.quant_matmul(x, w, gain.to(dtype)), qmatmul.quant_matmul(x, w))
    # Kernel 5 on its own generator, so the pins above keep their inputs.
    rng = np.random.default_rng(SEED + 105)
    for tag, Hkv, rep, Dh, lens in (("7B", 32, 1, 128, [1, 37, 300, S_CTX]),
                                    ("dh64", 4, 8, 64, PAGED_LENGTHS)):
        B, mp = len(lens), max(lens) // PAGED_PS
        q = arr(B, Hkv, rep, Dh, scale=Dh**-0.5)
        kp, vp = arr(B * mp + 1, Hkv, PAGED_PS, Dh), arr(B * mp + 1, Hkv, PAGED_PS, Dh)
        table = torch.from_numpy(rng.permutation(B * mp + 1)[:B * mp].reshape(B, mp)
                                 .astype(np.int32)).to(dev)
        lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
        out[f"kernel 5 {tag}"] = digest(pd.paged_decode(q, kp, vp, table, lengths, "contig"))
    # Kernel 2 at one row, the 7B's Q4_0 pair and Llama-3-8B's Q4_K / Q6_K
    # forms (G 32 with mins over G 16), on a generator of its own.
    rng = np.random.default_rng(SEED + 110)

    def codes(lo, hi, n, k, dtype):
        return torch.from_numpy(rng.integers(lo, hi, (n, k), dtype=np.int16)).to(dev).to(dtype)

    D = 4096
    for tag, F, forms in (("q4_0/q4_0", 11008, ("q4_0", "q4_0")),
                          ("g32m/g16", 14336, ("g32m", "g16"))):
        ws = []
        for form, (k, n) in zip(forms, ((D, 2 * F), (F, D))):
            if form == "q4_0":
                ws.append(QWeight.from_codes(codes(0, 16, n, k, torch.uint8),
                                             arr(n, k // 32, scale=1e-3, dtype=torch.float32)
                                             .abs(), dev))
            else:
                G = 32 if form == "g32m" else 16
                ws.append(QWeight.from_group_codes(
                    codes(-32, 32, n, k, torch.int8),
                    arr(n, k // G, scale=1e-3, dtype=torch.float32).abs(),
                    arr(n, k // G, scale=1e-2, dtype=torch.float32) if form == "g32m" else None,
                    G, dev))
        x, g = arr(1, D), 1.0 + arr(D, scale=0.1)
        out[f"kernel 2 {tag} rows=1 torch.bfloat16"] = digest(ffn.fused_ffn(x, *ws, g))
    # Kernels 8 and 10 on a generator of their own, in their split forms:
    # the 7B's heads at B=2 (64 pairs: 2 splits for kernel 8, 4 for kernel
    # 10) and TinyLlama's at B=9, a length of 0 among them (36 pairs: 3 and
    # 7 splits).
    rng = np.random.default_rng(SEED + 115)

    def int8_rows(*shape, pool=False):
        codes, scales = quantize_kv_block(arr(*shape, dtype=torch.float32))
        return [codes, scales.float() if pool else scales]

    for tag, Hkv, rep, Dh, S, lens in (("7B", 32, 1, 128, S_CTX, [37, S_CTX]),
                                       ("dh64", 4, 8, 64, 2048, PAGED_LENGTHS + [0])):
        B, mp = len(lens), max(lens) // PAGED_PS
        q = arr(B, Hkv, rep, Dh, scale=Dh**-0.5)
        kn, vn = arr(B, Hkv, Dh), arr(B, Hkv, Dh)
        lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
        cache = int8_rows(B, Hkv, S, Dh) + int8_rows(B, Hkv, S, Dh)
        o = ki.flash_decode_int8(q, kn, vn, *cache, lengths)
        out[f"kernel 8 {tag}"] = digest(o, *cache)
        n_pages = B * mp + 1
        pool = (int8_rows(n_pages, Hkv, PAGED_PS, Dh, pool=True)
                + int8_rows(n_pages, Hkv, PAGED_PS, Dh, pool=True))
        table = torch.from_numpy(rng.permutation(n_pages)[:B * mp].reshape(B, mp)
                                 .astype(np.int32)).to(dev)
        out[f"kernel 10 {tag}"] = digest(pi.paged_decode_int8(q, *pool, table, lengths,
                                                              "contig"))
    # Kernel 15 at 1 and 8 rows of the 7B's Q4_0 widths, on a generator of
    # its own.
    rng = np.random.default_rng(SEED + 120)
    D, F = 4096, 11008
    wo, w13, w2 = (QWeight.from_codes(codes(0, 16, n, k, torch.uint8),
                                      arr(n, k // 32, scale=1e-3, dtype=torch.float32).abs(), dev)
                   for k, n in ((D, D), (D, 2 * F), (F, D)))
    g = 1.0 + arr(D, scale=0.1)
    for rows in (1, 8):
        ctx, x = arr(rows, D), arr(rows, D)
        out[f"kernel 15 q4_0/q4_0 rows={rows} torch.bfloat16"] = digest(
            ffn.fused_owo_ffn(ctx, x, wo, w13, w2, g))
    return out


def _check_parent_digests() -> None:
    """The pinned calls' outputs against PARENT_DIGESTS, bit for bit."""
    got = _output_digests()
    differ = [k for k in PARENT_DIGESTS if got.get(k) != PARENT_DIGESTS[k]]
    log(f"kernels 2, 3, 5, 8, 10, 15, 16, 18 and the GEMV at 1, 8 bf16 and 40 f32 rows: "
        f"{len(got) - len(differ)} of {len(got)} outputs bit for bit the parent tree's")
    if differ or set(got) != set(PARENT_DIGESTS):
        raise AssertionError("outputs that moved from the parent tree's: "
                             + ", ".join(f"{k!r}: {got.get(k)!r}" for k in differ or got))


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


def _prefill_label(name, tag, Hkv, rep, Dh, B, T, offs, S) -> str:
    at = offs if B > 1 else offs[0]
    return f"{name} {tag} Hkv={Hkv} rep={rep} Dh={Dh} B={B} T={T} offset={at} S={S}"


def _prefill_bound(Hkv, rep, Dh, T, offs, S, q_bytes, int8) -> dict:
    """Kernel 4's or 9's bound: q and out once, the K and V rows (and int8
    scales) of the keys some row sees, the offsets; 4 * Dh operations a
    visible (query head, key) pair."""
    live = sum(min(o + T, S) for o in offs)
    pairs = sum(min(o + t + 1, S) for o in offs for t in range(T))
    row = Dh + 2 if int8 else 2 * Dh  # bytes of one key's K (or V) row
    nbytes = 2 * len(offs) * Hkv * rep * T * Dh * q_bytes + 2 * live * Hkv * row + 4 * len(offs)
    return bound(nbytes, 4 * Dh * Hkv * rep * pairs)


def _prefill_library(q, offs, S, int8):
    """One PyTorch call computing kernel 4's (or, after dequantizing K and V,
    kernel 9's) function on a cache: scaled_dot_product_attention with the
    rep query heads of a KV head as GQA heads, over the keys some row sees,
    causal from the top left (offset 0), from the bottom right (one
    offset), else under a boolean mask.  Returns a function of the cache."""
    import torch
    import torch.nn.functional as tf
    from torch.nn.attention.bias import causal_lower_right

    B, Hkv, rep, T, Dh = q.shape
    L = min(max(offs) + T, S)
    qh = q.reshape(B, Hkv * rep, T, Dh)
    kw = dict(scale=1.0, enable_gqa=rep > 1)
    if B == 1 and offs[0] == 0:
        kw["is_causal"] = True
    elif B == 1:
        kw["attn_mask"] = causal_lower_right(T, L)
    else:
        pos = torch.tensor(offs, device=q.device)[:, None] + torch.arange(T, device=q.device)
        kw["attn_mask"] = (torch.arange(L, device=q.device) <= pos[..., None])[:, None]

    def run(c):
        if int8:
            k, v = _deq(c[0][:, :, :L], c[1][:, :, :L]), _deq(c[2][:, :, :L], c[3][:, :, :L])
        else:
            k, v = c[0][:, :, :L], c[1][:, :, :L]
        return tf.scaled_dot_product_attention(qh, k, v, **kw)

    return run


def _prefill_records(randn, case, library) -> tuple:
    """Kernels 4 (bf16 cache) and 9 (int8 cache) at PREFILL_CASES against
    their plain versions, bf16 q (the tensor-core walk), then case g, float32
    q (the CUDA-core walk), at the first case's shape.  Each case is timed
    with its plain version, its bound and one PyTorch call's time (SDPA;
    dequantize + SDPA for int8; none for g).  Returns the two records."""
    import torch

    from tokenhawk_tpu_torch.ops.cuda import flash_attention as fa
    from tokenhawk_tpu_torch.ops.cuda import kv_int8 as ki
    from tokenhawk_tpu_torch.ops.kvquant import quantize_kv_block

    dev = torch.device("cuda")
    records = []
    for name, kernel, plain, source, replaces in (
            ("flash_attention", fa.flash_attention, fa.flash_attention_plain,
             "tokenhawk_tpu_torch/csrc/prefill_tc.cuh",
             "tokenhawk_tpu/ops/pallas/flash_attention.py:139 (flash_attention via "
             "attend_prefill)"),
            ("flash_attention_int8", ki.flash_attention_int8, ki.flash_attention_int8_plain,
             "tokenhawk_tpu_torch/csrc/prefill_tc.cuh",
             "tokenhawk_tpu/ops/pallas/flash_attention_int8.py:138 (flash_attention_int8 via "
             "attend_prefill_int8)")):
        int8 = name.endswith("int8")
        log(f"-- {name} (kernel {9 if int8 else 4}): causal prefill over "
            f"{'int8' if int8 else 'bf16'} caches")
        cases = []
        first = PREFILL_CASES[name][0]
        for tag, Hkv, rep, Dh, B, T, offs, S in PREFILL_CASES[name] + [("g",) + first[1:]]:
            f32 = tag == "g"
            if int8:
                c = [*quantize_kv_block(randn(B, Hkv, S, Dh, dtype=torch.float32)),
                     *quantize_kv_block(randn(B, Hkv, S, Dh, dtype=torch.float32))]
            else:
                c = [randn(B, Hkv, S, Dh), randn(B, Hkv, S, Dh)]
            q = randn(B, Hkv, rep, T, Dh, scale=Dh**-0.5,
                      dtype=torch.float32 if f32 else torch.bfloat16)
            offsets = torch.tensor(offs, dtype=torch.int32, device=dev)
            label = _prefill_label(name, tag, Hkv, rep, Dh, B, T, offs, S) + (", q f32" if f32
                                                                                else "")
            shape = label[len(name) + 1:]
            frac = F32_KERNEL_TOL if f32 else KERNEL_TOL
            out, ref = kernel(q, *c, offsets), plain(q, *c, offsets)
            caches = copies(c, sum(x.nbytes for x in c))
            case(cases, label, shape, B * T, out, ref,
                 [lambda c=c: kernel(q, *c, offsets) for c in caches],
                 [lambda c=c: plain(q, *c, offsets) for c in caches], frac=frac)
            b = _prefill_bound(Hkv, rep, Dh, T, offs, S, 4 if f32 else 2, int8)
            lib = None
            if not f32:
                run = _prefill_library(q, offs, S, int8)
                lib = timed([lambda c=c: run(c) for c in caches])["ms"]
            cases[-1].update(b, library_ms=lib)
            log(f"  bound {b['bound_ms']:.4f} ms ({b['bound_by']}); library "
                f"{'dequantize K and V + ' if int8 else ''}scaled_dot_product_attention: "
                f"{'none' if lib is None else f'{lib:.4f} ms'}")
            del caches
        main = cases[0]
        records.append(_record(name, source, replaces, cases, (main["shape"], main["rows"]),
                               {k: main[k] for k in ("bound_ms", "bound_by")},
                               main["library_ms"]))
    return tuple(records)


# Kernel 8's cases, each over a dense int8 cache of INT8_CTX rows at the
# 7B's heads: B=5 ragged with a length of 0 (160 pairs: one block a pair),
# then B=1 (32 pairs: the split form) at 37, 300 and 2048 live rows, the
# last phase 4i's decode at its longest (experiments/decode_rows.py
# sweeps their split counts).
INT8_CASES = [[1, 37, 300, INT8_CTX, 0], [37], [300], [INT8_CTX]]


def _int8_kernel_records(randn, case, library) -> list:
    """Kernel 8 over a dense int8 cache of n_ctx 2048 (the int8 Engine of
    phase 4i) at INT8_CASES, each against its plain version with the
    appended codes and scales equal to the plain's, timed as the wrapper
    launches it (the split form where decode_int8_splits gives more than 1),
    back to back and alone, beside kernel 3 over a bf16 cache of the same
    shape (back to back and alone), its bound and, at B=1, dequantize +
    SDPA over the live rows.  The record is timed at B=1 over
    2048 live rows.  Kernel 9 (prefill) is timed with kernel 4
    (_prefill_records)."""
    import torch
    import torch.nn.functional as tf

    from tokenhawk_tpu_torch.ops.cuda import build
    from tokenhawk_tpu_torch.ops.cuda import flash_decode as fd
    from tokenhawk_tpu_torch.ops.cuda import kv_int8 as ki
    from tokenhawk_tpu_torch.ops.kvquant import quantize_kv_block

    log("-- kernel 8: int8 decode + quantizing append on kernel 3's tile walk, in clusters "
        "where the (sequence, KV head) pairs leave SMs idle; kernel 3 on bf16 beside it")
    dev = torch.device("cuda")
    sms = build.sm_count(dev)
    Hkv, Dh, S, bf = 32, 128, INT8_CTX, 2

    def cache(B):
        k, ks = quantize_kv_block(randn(B, Hkv, S, Dh, dtype=torch.float32))
        v, vs = quantize_kv_block(randn(B, Hkv, S, Dh, dtype=torch.float32))
        return [k, ks, v, vs]

    cases, main = [], None
    for lens in INT8_CASES:
        B = len(lens)
        splits = ki.decode_int8_splits(B, Hkv, S, sms)
        q = randn(B, Hkv, 1, Dh, scale=Dh**-0.5)
        kn, vn = randn(B, Hkv, Dh), randn(B, Hkv, Dh)
        c = cache(B)
        p = [x.clone() for x in c]
        lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
        before = ki.launches["flash_decode_int8_split"]
        out = ki.flash_decode_int8(q, kn, vn, *c, lengths)
        if ki.launches["flash_decode_int8_split"] - before != (splits > 1):
            raise AssertionError(f"kernel 8 at {lens}: the split counter disagrees with {splits} "
                                 f"splits")
        ref = ki.flash_decode_int8_plain(q, kn, vn, *p, lengths)
        if not all(torch.equal(a, b) for a, b in zip(c, p)):
            raise AssertionError(f"flash_decode_int8 {lens}: appended rows differ from the plain's")
        caches = copies(c, sum(x.nbytes for x in c))
        case(cases, f"flash_decode_int8 (kernel 8) B={B} lengths={lens} S={S}, {splits} splits "
                    f"(appended codes and scales identical)", f"B={B} L={lens[-1]}", B, out, ref,
             [lambda c=c: ki.flash_decode_int8(q, kn, vn, *c, lengths) for c in caches],
             [lambda c=c: ki.flash_decode_int8_plain(q, kn, vn, *c, lengths) for c in caches],
             alone=True)
        live = sum(min(n, S) for n in lens if n > 0)
        # The live codes and bf16 scales of K and V, q, k_new, v_new and out,
        # the two rows written, the lengths.
        b = bound(2 * live * Hkv * (Dh + bf) + 4 * B * Hkv * Dh * bf + 2 * B * Hkv * (Dh + bf)
                  + 4 * B, 4 * live * Hkv * Dh)
        lib = None
        if B == 1:
            L = lens[0]
            lib = timed([lambda c=c: tf.scaled_dot_product_attention(
                q, _deq(c[0][:, :, :L], c[1][:, :, :L]), _deq(c[2][:, :, :L], c[3][:, :, :L]),
                scale=1.0) for c in caches])["ms"]
        bc = copies([randn(B, Hkv, S, Dh), randn(B, Hkv, S, Dh)], 2 * B * Hkv * S * Dh * bf)
        k3 = [lambda c=c: fd.flash_decode_append(q, kn, vn, *c, lengths) for c in bc]
        k3_ms, k3_alone = timed(k3)["ms"], isolated_ms(k3)
        cases[-1].update(b, library_ms=lib, splits=splits, kernel3_ms=k3_ms,
                         kernel3_isolated_ms=k3_alone)
        log(f"  bound {b['bound_ms']:.4f} ms ({b['bound_by']}); kernel 3 on a bf16 cache of the "
            f"same shape {k3_ms:.4f} ms (alone {k3_alone:.4f})"
            + (f"; library call dequantize + scaled_dot_product_attention over the live rows "
               f"(3+ calls): {lib:.4f} ms" if lib is not None else ""))
        del bc, k3
        if lens == [S]:
            main = (b, lib)
        del c, p, caches
    rec8 = _record("flash_decode_int8", "tokenhawk_tpu_torch/csrc/decode_tiles.cuh",
                   "tokenhawk_tpu/ops/pallas/flash_decode_int8.py:254 (flash_decode_int8)",
                   cases, (f"B=1 L={S}", 1), *main)
    return [rec8]


def _fold_cases(int8, q, pool, kn, vn, table, lengths, layout, trash, case, cases, shape,
                timing: bool = False) -> dict:
    """Kernel 5 (int8: 10) with its append folded in (`paged_decode_append`,
    `paged_decode_int8_append`) at a paged shape: each sequence stores
    lengths - 1 tokens and appends its newest at row lengths - 1, all live;
    then again with the third-last at its table's capacity (nothing
    appended) and the last two parked on the trash page (their table rows
    all of it, both appending at its slot 5).  Each against the parent's
    two launches (kernel 6 then 5, or 11 then 10: the appends of the rows
    the table has, then the attention over one row more, at the same split
    count): outputs of the sequences not parked and pools outside the trash
    page bit for bit; against the plain version within the kernel tolerance
    (pools exactly).  With `timing`, the all-live case times the folded
    call back to back and alone beside the two launches, and the decode
    layer's op (runtime/paged.py append_attend_paged_layer[_int8]) beside
    the two layer ops it replaces.  Returns those times."""
    import torch

    from tokenhawk_tpu_torch.ops.cuda import paged_decode as pd
    from tokenhawk_tpu_torch.ops.cuda import paged_int8 as pi
    from tokenhawk_tpu_torch.runtime import paged as tp

    mod, name = (pi, "paged_decode_int8_append") if int8 else (pd, "paged_decode_append")
    n_pool, Hkv, ps, Dh = pd.pool_dims(pool[0], layout)
    B, rep = q.shape[0], q.shape[2]
    keep = torch.arange(n_pool, device=q.device) != trash

    def kept(xs):
        return [x[keep] if layout == "contig" else x[:, keep] for x in xs]

    def calls(tab, stored):
        """(folded, two launches, plain), each on the pools it is given."""
        page, slot, fits = pd.append_rows(tab, stored, ps)
        kf, vf, pf, sf = kn[fits], vn[fits], page[fits], slot[fits]
        longer = stored + 1
        if int8:
            return (lambda p: pi.paged_decode_int8_append(q, *p, kn, vn, tab, stored, layout),
                    lambda p: (pi.paged_append_int8(*p, kf, vf, pf, sf, layout),
                               pi.paged_decode_int8(q, *p, tab, longer, layout))[1],
                    lambda p: pi.paged_decode_int8_append_plain(q, *p, kn, vn, tab, stored,
                                                                 layout))
        return (lambda p: pd.paged_decode_append(q, *p, kn, vn, tab, stored, layout),
                lambda p: (pd.paged_append(*p, kf, vf, pf, sf, layout),
                           pd.paged_decode(q, *p, tab, longer, layout))[1],
                lambda p: pd.paged_decode_append_plain(q, *p, kn, vn, tab, stored, layout))

    stored = lengths - 1
    edge_tab, edge_st = table.clone(), stored.clone()
    edge_st[-3] = table.shape[1] * ps
    edge_tab[-2:], edge_st[-2:] = trash, 5
    live = torch.arange(B, device=q.device) < B - 2
    times = {}
    for tag, tab, st, rows in (("all live", table, stored, slice(None)),
                               ("a full table, 2 parked on the trash page", edge_tab, edge_st,
                                live)):
        fold, two, plain = calls(tab, st)
        pools = [[x.clone() for x in pool] for _ in range(3)]
        before = mod.launches[name]
        got = fold(pools[0])
        if mod.launches[name] != before + 1:
            raise AssertionError(f"{name}: {mod.launches[name] - before} launches counted")
        ref2, ref = two(pools[1]), plain(pools[2])
        if not (torch.equal(got[rows], ref2[rows])
                and all(map(torch.equal, kept(pools[0]), kept(pools[1])))
                and all(map(torch.equal, kept(pools[0]), kept(pools[2])))):
            raise AssertionError(f"{name} {layout} {tag}: the output or the pools differ from "
                                 f"the parent's two launches' or the plain version's")
        label = (f"{name} {layout} Hkv={Hkv} rep={rep} Dh={Dh} B={B} lengths={PAGED_LENGTHS} "
                 f"ps={ps}, {tag} (bit for bit the two launches')")
        if not (timing and tag == "all live"):
            case(cases, label, shape, B, got[rows], ref[rows])
            continue
        case(cases, label, shape, B, got, ref, [lambda: fold(pools[0])],
             [lambda: plain(pools[2])], alone=True)
        two_fns = [lambda: two(pools[1])]
        q4 = q.reshape(B, 1, Hkv * rep, Dh) * Dh**0.5  # the layer ops scale it back
        args = (kn, vn, tab, st, layout)
        if int8:
            layer = [lambda: tp.append_attend_paged_layer_int8(q4, *pools[0], *args)]
            parent = [lambda: (tp.append_token_layer_int8(*pools[1], kn, vn, tab, st, layout),
                               tp.attend_paged_layer_int8(q4, *pools[1], tab, st + 1, layout))]
        else:
            layer = [lambda: tp.append_attend_paged_layer(q4, *pools[0], *args)]
            parent = [lambda: (tp.append_token_layer(*pools[1], kn, vn, tab, st, layout),
                               tp.attend_paged_layer(q4, *pools[1], tab, st + 1, layout))]
        if not torch.equal(layer[0](), parent[0]()[1]):
            raise AssertionError(f"{name}: the decode layer's op differs from the two it replaces")
        times = {"two_launch_ms": timed(two_fns)["ms"],
                 "two_launch_isolated_ms": isolated_ms(two_fns),
                 "layer_ms": timed(layer)["ms"], "layer_isolated_ms": isolated_ms(layer),
                 "parent_layer_ms": timed(parent)["ms"],
                 "parent_layer_isolated_ms": isolated_ms(parent)}
        cases[-1].update(times)
        log(f"  the parent's two launches {times['two_launch_ms']:.4f} ms (alone "
            f"{times['two_launch_isolated_ms']:.4f}); the decode layer's op "
            f"{times['layer_ms']:.4f} (alone {times['layer_isolated_ms']:.4f}) against the two "
            f"it replaces {times['parent_layer_ms']:.4f} (alone "
            f"{times['parent_layer_isolated_ms']:.4f})")
    return times


def _paged_int8_kernel_records(randn, case, library, g) -> list:
    """Kernels 10-12 at phase 2's paged shapes (B=8, PAGED_LENGTHS, a
    140-page pool, shuffled table, two appends on the trash page), on int8
    pages in both layouts; timed in the default (contig) layout, kernel 10
    back to back and alone, beside kernel 5 on bf16 pages of the same
    shape (back to back and alone); kernel 10 with kernel 11 folded in
    (_fold_cases), timed beside the two launches it replaces."""
    import torch
    import torch.nn.functional as tf

    from tokenhawk_tpu_torch.ops.cuda import build
    from tokenhawk_tpu_torch.ops.cuda import paged_decode as pd
    from tokenhawk_tpu_torch.ops.cuda import paged_int8 as pi
    from tokenhawk_tpu_torch.ops.kvquant import quantize_kv_block

    log("-- kernels 10-12: int8 pages; kernel 10 on kernel 5's tile walk, kernel 5 on bf16 "
        "pages beside it")
    dev = torch.device("cuda")
    sms = build.sm_count(dev)
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
    dec, app, gat, fold, lib, fold_times = [], [], [], [], {}, {}
    for layout in ("contig", "head"):
        shape = (n_pool, Hkv, ps, Dh) if layout == "contig" else (Hkv, n_pool, ps, Dh)
        pool = []
        for _ in range(2):
            codes, scales = quantize_kv_block(randn(*shape, dtype=torch.float32))
            pool += [codes, scales.float()]
        q = randn(B, Hkv, 1, Dh, scale=Dh**-0.5)
        splits = pi.paged_int8_splits(B, Hkv, mp * ps, sms)
        before = pi.launches["paged_decode_int8_split"]
        out = pi.paged_decode_int8(q, *pool, table, lengths, layout)
        if pi.launches["paged_decode_int8_split"] - before != (splits > 1):
            raise AssertionError(f"kernel 10 {layout}: the split counter disagrees with {splits} "
                                 f"splits")
        case(dec, f"paged_decode_int8 (kernel 10) {layout} B={B} lengths={PAGED_LENGTHS} ps={ps}, "
                  f"{splits} splits", layout, B, out,
             pi.paged_decode_int8_plain(q, *pool, table, lengths, layout),
             [lambda: pi.paged_decode_int8(q, *pool, table, lengths, layout)],
             [lambda: pi.paged_decode_int8_plain(q, *pool, table, lengths, layout)],
             alone=layout == "contig")
        if layout == "contig":
            kb, vb = randn(*shape), randn(*shape)
            k5 = [lambda: pd.paged_decode(q, kb, vb, table, lengths, layout)]
            k5_ms, k5_alone = timed(k5)["ms"], isolated_ms(k5)
            del kb, vb, k5
            dec[-1].update(splits=splits, kernel5_ms=k5_ms, kernel5_isolated_ms=k5_alone)
            log(f"  kernel 5 on bf16 pages of the same shape {k5_ms:.4f} ms (alone "
                f"{k5_alone:.4f})")

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
        fold_times = _fold_cases(True, q, pool, kn, vn, table, lengths, layout, trash, case,
                                 fold, layout, timing=layout == "contig") or fold_times

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
            fp, fs, _ = pd.append_rows(table, lengths - 1, ps)
            fp, fs = fp.long(), fs.long()
            lib["fold"] = library(
                "index_put_ of the quantized K and V codes and scales (quantization not "
                "included), then gather + dequantize K and V + scaled_dot_product_attention "
                "with a length mask (12+ calls)", [
                    lambda: (pa[0].__setitem__((fp, slice(None), fs), qk),
                             pa[1].__setitem__((fp, slice(None), fs), sk.float()),
                             pa[2].__setitem__((fp, slice(None), fs), qv),
                             pa[3].__setitem__((fp, slice(None), fs), sv.float()),
                             tf.scaled_dot_product_attention(
                                 q, dense(pa[0], pa[1]), dense(pa[2], pa[3]), attn_mask=mask,
                                 scale=1.0))])
            lib["gather"] = library("pages[table] and scales[table], the multiply and the "
                                    "permute, K and V", [lambda: (dense(kp, ksp), dense(vp, vsp))])
        del pool, pa, pb
    src = "tokenhawk_tpu_torch/csrc/paged_int8.cu"
    row = Hkv * Dh  # bytes of one token's int8 codes across the kv heads
    return [
        _record("paged_decode_int8", "tokenhawk_tpu_torch/csrc/decode_tiles.cuh",
                "tokenhawk_tpu/ops/pallas/paged_decode_int8.py:450 "
                "(paged_flash_decode_int8_walk); paged_decode_int8.py:216 "
                "(paged_flash_decode_int8)", dec, ("contig", B),
                bound(2 * live * (row + Hkv * 4) + 2 * B * row * bf + B * (mp + 1) * 4,
                      4 * live * Hkv * Dh), lib["decode"]),
        _record("paged_append_int8", src, "tokenhawk_tpu/ops/pallas/paged_decode.py:205 "
                "(paged_append_rows, int8 payload); paged_decode.py:286 (paged_append_scales)",
                app, ("contig", B),
                bound(2 * B * row * bf + 2 * B * (row + Hkv * 4) + 2 * B * 4, 0), lib["append"]),
        # Kernel 10's bytes and k_new, v_new.
        {**_record("paged_decode_int8_append", "tokenhawk_tpu_torch/csrc/decode_tiles.cuh",
                   "tokenhawk_tpu/ops/pallas/paged_decode_int8.py:450 "
                   "(paged_flash_decode_int8_walk) with paged_decode.py:205 (paged_append_rows, "
                   "int8 payload) and paged_decode.py:286 (paged_append_scales) folded in",
                   fold, ("contig", B),
                   bound(2 * live * (row + Hkv * 4) + 4 * B * row * bf + B * (mp + 1) * 4,
                         4 * live * Hkv * Dh), lib["fold"]), **fold_times},
        _record("gather_pages_int8", src, "tokenhawk_tpu/ops/pallas/paged_decode.py:456 "
                "(gather_pages_dense_int8)", gat, ("contig", B),
                bound(2 * B * mp * ps * (row + Hkv * 4) + 2 * B * mp * ps * row * bf + B * mp * 4,
                      0), lib["gather"]),
    ]


# Kernel 5's split counts, swept in the contig layout where the (sequence,
# kv head) pairs fill the SMs (paged_decode.FULL_SPLITS' range, 132-264 of
# LLaMA-7B's pairs): at 8 slots (256 pairs) and at 5 (160, the range's low
# end), each at ragged lengths (the longest pair sets the time) and all at
# 2048 rows.
PAGED_SWEEP = (1, 2, 4, 8)
PAGED_SWEEP_SLOTS = (8, 5)


def _paged_sweep(pd, q, kp, vp, table, layout, rows) -> dict:
    """Kernel 5 at each of PAGED_SWEEP's split counts on the first n of
    PAGED_SWEEP_SLOTS slots, at the last n of PAGED_LENGTHS and all at
    `rows`: each count checked against the plain version (and the split
    counter) and timed."""
    import torch

    out = {}
    for n in PAGED_SWEEP_SLOTS:
        for lens in (PAGED_LENGTHS[-n:], [rows] * n):
            lengths = torch.tensor(lens, dtype=torch.int32, device=q.device)
            qn, tab = q[:n], table[:n]
            ref = pd.paged_decode_plain(qn, kp, vp, tab, lengths, layout)
            sweep = {}
            for splits in PAGED_SWEEP:
                before = pd.launches["paged_decode_split"]
                err, tol = max_err(pd.paged_decode_at(qn, kp, vp, tab, lengths, layout, splits),
                                   ref)
                if not err <= tol or pd.launches["paged_decode_split"] - before != (splits > 1):
                    raise AssertionError(f"kernel 5 at {n} slots {lens}, {splits} splits: {err} "
                                         f"> {tol}, or the split counter disagrees")
                sweep[splits] = timed([lambda s=splits: pd.paged_decode_at(
                    qn, kp, vp, tab, lengths, layout, s)])["ms"]
            key = f"{n} slots " + ("ragged" if lens == PAGED_LENGTHS[-n:] else f"x {rows}")
            out[key] = sweep
            log(f"  sweep at {n} slots, lengths {lens} (splits: ms): "
                + ", ".join(f"{k}: {ms:.4f}" for k, ms in sweep.items()))
    return out


def _paged_kernel_records(randn, case, library, g) -> list:
    """Kernels 5-7 at a serve batch of 8 (PAGED_LENGTHS) over a 140-page
    pool with a shuffled table, in both layouts, timed in the default
    (contig) layout; kernel 5 also at PAGED_SWEEP's split counts there
    (8 and 5 slots, ragged and all at 2048 rows), and
    at B=1 over 512 and 2048 live rows (its split form: 32 pairs), each
    with its bound and the library call; kernel 5 with kernel 6 folded in
    (_fold_cases), timed in the contig layout beside the two launches it
    replaces."""
    import torch
    import torch.nn.functional as tf

    from tokenhawk_tpu_torch.ops.cuda import build
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
    row = Hkv * Dh * bf
    sms = build.sm_count(dev)
    fold_times = {}

    def b5(n, tokens):  # the live K/V rows, q and out, the table rows and lengths
        return bound(2 * tokens * row + 2 * n * row + n * (mp + 1) * 4, 4 * tokens * Hkv * Dh)

    def gathered_sdpa(q, kp, vp, tab, lens):
        """The library call: the table's pages, then SDPA with a length mask."""
        n, tabl = tab.shape[0], tab.long()
        mask = (torch.arange(mp * ps, device=dev)[None, :] < lens[:, None])[:, None, None]

        def dense(x):
            return x[tabl].transpose(1, 2).reshape(n, Hkv, mp * ps, Dh)

        return [lambda: tf.scaled_dot_product_attention(q, dense(kp), dense(vp), attn_mask=mask,
                                                        scale=1.0)]

    dec, app, gat, fold, lib = [], [], [], [], {}
    for layout in ("contig", "head"):
        shape = (n_pool, Hkv, ps, Dh) if layout == "contig" else (Hkv, n_pool, ps, Dh)
        kp, vp = randn(*shape), randn(*shape)
        q = randn(B, Hkv, 1, Dh, scale=Dh**-0.5)
        splits = pd.paged_splits(B, Hkv, mp * ps, sms)
        label = f"paged_decode {layout} B={B} lengths={PAGED_LENGTHS} ps={ps}, {splits} splits"
        out, ref = (pd.paged_decode(q, kp, vp, table, lengths, layout),
                    pd.paged_decode_plain(q, kp, vp, table, lengths, layout))
        if layout == "contig":
            case(dec, label, layout, B, out, ref,
                 [lambda: pd.paged_decode(q, kp, vp, table, lengths, layout)],
                 [lambda: pd.paged_decode_plain(q, kp, vp, table, lengths, layout)])
            dec[-1].update(b5(B, live), splits=splits,
                           sweep_ms=_paged_sweep(pd, q, kp, vp, table, layout, mp * ps))
        else:
            case(dec, label, layout, B, out, ref)
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
        fold_times = _fold_cases(False, q, [kp, vp], kn, vn, table, lengths, layout, trash, case,
                                 fold, layout, timing=layout == "contig") or fold_times

        gk, gv = pd.gather_pages(kp, vp, table, layout)
        pk, pv = pd.gather_pages_plain(kp, vp, table, layout)
        if not torch.equal(gv, pv):
            raise AssertionError(f"gather_pages {layout}: V differs from the plain version's")
        case(gat, f"gather_pages {layout} B={B} max_pages={mp} (K and V identical)", layout, B,
             gk, pk, [lambda: pd.gather_pages(kp, vp, table, layout)],
             [lambda: pd.gather_pages_plain(kp, vp, table, layout)], frac=0.0)
        del gk, gv, pk, pv
        if layout == "contig":
            lib["decode"] = library(
                "gather K and V + scaled_dot_product_attention with a length mask (6+ calls)",
                gathered_sdpa(q, kp, vp, table, lengths))
            dec[0]["library_ms"] = lib["decode"]
            # A paged server with one live request: 32 pairs, the split form.
            for L in (512, 2048):
                tab1, len1 = table[-1:], torch.tensor([L], dtype=torch.int32, device=dev)
                q1 = randn(1, Hkv, 1, Dh, scale=Dh**-0.5)
                n1 = pd.paged_splits(1, Hkv, mp * ps, sms)
                before = pd.launches["paged_decode_split"]
                out1 = pd.paged_decode(q1, kp, vp, tab1, len1, layout)
                if pd.launches["paged_decode_split"] - before != (n1 > 1):
                    raise AssertionError(f"kernel 5 at B=1 L={L}: the split counter disagrees "
                                         f"with {n1} splits")
                case(dec, f"paged_decode {layout} B=1 L={L} ps={ps}, {n1} splits",
                     f"{layout} B=1 L={L}", 1, out1,
                     pd.paged_decode_plain(q1, kp, vp, tab1, len1, layout),
                     [lambda: pd.paged_decode(q1, kp, vp, tab1, len1, layout)],
                     [lambda: pd.paged_decode_plain(q1, kp, vp, tab1, len1, layout)])
                one = timed([lambda: pd.paged_decode_at(q1, kp, vp, tab1, len1, layout, 1)])["ms"]
                lib1 = timed(gathered_sdpa(q1, kp, vp, tab1, len1))["ms"]
                dec[-1].update(b5(1, L), splits=n1, one_block_ms=one, library_ms=lib1)
                log(f"  bound {dec[-1]['bound_ms']:.4f} ms; one block a pair {one:.4f} ms; "
                    f"library call (gather + SDPA) {lib1:.4f} ms")
            lib["append"] = library("index_put_ of the new K and V rows (2 calls)", [
                lambda: (ka.__setitem__((pl, slice(None), sl), kn),
                         va.__setitem__((pl, slice(None), sl), vn))])
            fp, fs, _ = pd.append_rows(table, lengths - 1, ps)
            fp, fs = fp.long(), fs.long()
            sdpa = gathered_sdpa(q, ka, va, table, lengths)[0]
            lib["fold"] = library(
                "index_put_ of the new K and V rows, then gather K and V + "
                "scaled_dot_product_attention with a length mask (8+ calls)", [
                    lambda: (ka.__setitem__((fp, slice(None), fs), kn),
                             va.__setitem__((fp, slice(None), fs), vn), sdpa())])
            lib["gather"] = library("pages[table] with its permute, K and V (2 x 2 calls)", [
                lambda: [x[tl].transpose(1, 2).reshape(B, Hkv, mp * ps, Dh) for x in (kp, vp)]])
        del kp, vp, ka, va, kb, vb
    src = "tokenhawk_tpu_torch/csrc/paged_decode.cu"
    return [
        _record("paged_decode", src, "tokenhawk_tpu/ops/pallas/paged_decode.py:683 "
                "(paged_flash_decode_walk); paged_decode.py:497 (paged_flash_decode)",
                dec, ("contig", B), b5(B, live), lib["decode"]),
        _record("paged_append", src, "tokenhawk_tpu/ops/pallas/paged_decode.py:205 "
                "(paged_append_rows)", app, ("contig", B),
                bound(4 * B * row + 2 * B * 4, 0), lib["append"]),
        # The live rows (the appended one written, the rest read), q, out,
        # k_new and v_new, the table rows and lengths.
        {**_record("paged_decode_append", "tokenhawk_tpu_torch/csrc/decode_tiles.cuh",
                   "tokenhawk_tpu/ops/pallas/paged_decode.py:683 (paged_flash_decode_walk) "
                   "with paged_decode.py:205 (paged_append_rows) folded in", fold,
                   ("contig", B), bound(2 * live * row + 4 * B * row + B * (mp + 1) * 4,
                                        4 * live * Hkv * Dh), lib["fold"]), **fold_times},
        _record("gather_pages", src, "tokenhawk_tpu/ops/pallas/paged_decode.py:384 "
                "(gather_pages_dense)", gat, ("contig", B),
                bound(4 * B * mp * ps * row + B * mp * 4, 0), lib["gather"]),
    ]


def _path_records(name, tag, replaces, cases, shape, stream: bool = False) -> list:
    """Kernel 1's, 13's or 17's two records from its timed cases (each with
    its bound and library time): the decode rows' (at most 8 rows), timed
    at `shape` and one row, on the GEMV (csrc/qmatmul.cu, gemv.cuh) or,
    with `stream`, on the decode-row walk (csrc/gemv_stream.cuh, named
    name_stream), and the tensor-core path's (more than 8 rows;
    csrc/qgemm_tc.cuh, the reference kernel's bf16 dot of `_qdot`), timed
    at `shape` and 512 rows, named name_tc."""
    out = []
    for tc in (False, True):
        part = [c for c in cases if (c["rows"] > 8) == tc]
        main = next(c for c in part if (c["shape"], c["rows"]) == (shape, 512 if tc else 1))
        src = ("qgemm_tc.cuh" if tc else "gemv_stream.cuh" if stream else "qmatmul.cu")
        out.append(_record(
            f"{name}{'_tc' if tc else '_stream' if stream else ''}{tag}",
            f"tokenhawk_tpu_torch/csrc/{src}",
            replaces + (" at more than 8 rows (qmatmul.py:97 _qdot's bf16 dot)" if tc else ""),
            part, (shape, main["rows"]), {k: main[k] for k in ("bound_ms", "bound_by")},
            main["library_ms"]))
    return out


def _record(name, source, replaces, cases, main_case, bound_at, library_ms) -> dict:
    """One kernel's JSON entry: worst error over its cases, times at the
    shape the main path runs most (main_case = (shape, rows)), its bound
    there and the library call's time (None where no one PyTorch call
    computes the same function).  isolated_ms: the kernel's call alone
    there, where the case timed one (the decode-row walk)."""
    main = next(c for c in cases if (c["shape"], c["rows"]) == main_case)
    alone = main.get("isolated_ms")
    log(f"{name}: {main['ms']:.4f} ms"
        + (f" ({alone:.4f} alone)" if alone is not None else "")
        + f" against a bound of {bound_at['bound_ms']:.4f} ms "
        f"({bound_at['bound_by']}) at {main['shape']} rows={main['rows']}")
    return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": 0, "max_abs_err": max(c["max_abs_err"] for c in cases),
            "ms": main["ms"], "plain_ms": main["plain_ms"], **bound_at,
            "library_ms": library_ms, "isolated_ms": alone,
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
    _check_path(counts, [*QK_PATHS, *FFN_Q4_K_M], [*Q4_PATHS, Q4_GEMV, QK_GEMV])


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
    _check_path(counts, [*Q4_PATHS, FFN_Q4_0, "flash_decode", "flash_decode_append_split", K4],
                [*QK_PATHS, QK_GEMV, Q4_GEMV, "flash_decode_attend", *CUDA_CORE_PREFILL])
    _profile_request(engines[id(greedy)], [1] + rng.integers(3, cfg.n_vocab, size=4).tolist())
    _path_spread(cfg, params)
    return counts, params


def _path_spread(cfg, params) -> None:
    """The logit spread of the tensor-core path's roundings (bf16 xn and
    code * s, as the reference's `_qdot` at more than 8 rows): a 512-token
    prefill's last logits at 2 and at all of the model's layers, with
    kernels 1 and 13 on their paths, then with every call held to the GEMV
    (f32 xn and code * s; `tensor_core_path` patched here, for this
    measurement only)."""
    import torch

    from tokenhawk_tpu_torch.models.llama import KVCache
    from tokenhawk_tpu_torch.ops.cuda import qmatmul
    from tokenhawk_tpu_torch.runtime.engine import make_prefill_fn

    dev = torch.device("cuda")
    ids = torch.from_numpy(np.random.default_rng(SEED + 30).integers(3, cfg.n_vocab, S_CTX))
    ids = ids.to(dev)[None]
    one = torch.tensor([S_CTX], dtype=torch.int32, device=dev)
    zero = torch.tensor([0], dtype=torch.int32, device=dev)
    for n in (2, cfg.n_layer):
        c = dataclasses.replace(cfg, n_layer=n)
        p = dataclasses.replace(params, layers=params.layers[:n])
        prefill = make_prefill_fn(c)

        def last_logits():
            return prefill(p, KVCache.create(c, 1, S_CTX, torch.bfloat16, dev), ids, one,
                           zero)[1].float()

        tc = last_logits()
        route = qmatmul.tensor_core_path
        qmatmul.tensor_core_path = lambda *args: False
        try:
            gemv = last_logits()
        finally:
            qmatmul.tensor_core_path = route
        spread = (tc - gemv).abs().max().item() / gemv.abs().max().item()
        log(f"  {n} layers, a {S_CTX}-token prefill: last logits on the tensor-core path against "
            f"the GEMV's f32 xn and code * s: max |diff| {spread:.3%} of the largest |logit|, "
            f"argmax equal {int(tc.argmax()) == int(gemv.argmax())}")
        if not spread < DEEP_BF16_TOL:
            raise AssertionError(f"{n} layers: the two paths' logits {spread:.3%} apart")
    _ROUTES.clear()  # the GEMV-held calls break the route rule on purpose


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


def _busy_seconds(prof) -> float:
    """The device's busy time in a profile: the union of its kernel and
    copy intervals.  A programmatic dependent launch's blocks may start,
    and wait, while the launch before still runs, so the kernels' summed
    times count that overlap twice."""
    import torch

    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy / 1e6


def _decode_window(engine, prompt, chunks: int = 4, kernel_mods=(),
                   profiled: bool = True) -> dict:
    """Device busy time against wall time over `chunks` greedy decode
    chunks after the prompt's prefill (outside the window), the host
    reading each chunk's ids as Engine.generate does.  Returns the
    window's tok/s, tokens and the launches of kernel_mods' kernels in it,
    and, profiled, its idle share and device ms per token (the busy time:
    the union of the kernels' intervals, _busy_seconds).  Unprofiled, the
    wall time carries no profiler cost per launch."""
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
    summed = sum(e.self_device_time_total for e in avgs) / 1e6
    busy = _busy_seconds(prof)
    attn = [e for e in avgs if "decode_int8_tiles" in e.key or "decode_append_tiles" in e.key]
    log(f"decode window, {engine.cache_dtype} cache, {len(prompt)}+ live tokens, {n} tokens "
        f"(profiler on): wall {wall * 1e3:.1f} ms ({n / wall:.1f} tok/s), device busy "
        f"{busy * 1e3:.1f} ms ({n / busy:.1f} tok/s; kernels summed {summed * 1e3:.1f} ms), "
        f"idle share {1 - busy / wall:.1%}; "
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


# Every quantized projection the model makes (through ops.linear, whose
# quant_matmul _install_route_spy wraps) since the last _reset_counts:
# (rows, dtype, on the card, weight form, the launch counters it ticked).
# _check_path holds each to the rule of kernels 1, 13 and 17: bf16 x above 8
# rows over any weight form ticks the tensor-core path's counter (name_tc),
# every other call on the card (decode rows, float32 x) the GEMV's, a call
# on the CPU none.
_ROUTES = []


def _install_route_spy() -> None:
    from tokenhawk_tpu_torch.ops import linear
    from tokenhawk_tpu_torch.ops.cuda import qmatmul

    plain = linear.quant_matmul

    def spy(x, w, *args, **kwargs):
        before = dict(qmatmul.launches)
        y = plain(x, w, *args, **kwargs)
        ticked = [k for k, v in qmatmul.launches.items() if v != before[k]]
        _ROUTES.append((x.numel() // x.shape[-1], x.dtype, x.is_cuda, qmatmul.form_code(w),
                        ticked))
        return y

    linear.quant_matmul = spy


def _check_routes() -> str:
    """Each recorded projection on the path the rule gives it (see
    _ROUTES); a summary of the rows each path took."""
    import torch

    from tokenhawk_tpu_torch.ops.cuda import qmatmul

    rows = {"GEMV": [], "decode-row walk": [], "tensor-core path": []}
    for n, dtype, cuda, form, ticked in _ROUTES:
        tc = cuda and qmatmul.tensor_core_path(dtype, n)
        stream = cuda and not tc and qmatmul.stream_path(form, n)
        name = {0: "q4_matmul", qmatmul.SB: "qk_sb_matmul"}.get(form, "qk_matmul")
        want = [name + ("_tc" if tc else "_stream" if stream else "")] if cuda else []
        if ticked != want:
            raise AssertionError(f"a projection of {n} rows ({dtype}, form "
                                 f"{qmatmul.FORM_NAMES[form]}) ticked {ticked}, not {want}")
        if cuda:
            rows["tensor-core path" if tc else "decode-row walk" if stream else "GEMV"].append(n)
    return "; ".join(f"{len(v)} on the {k} (rows {min(v)}-{max(v)})"
                     for k, v in rows.items() if v)


def _reset_counts(mods) -> None:
    for m in mods:
        m.launches.update(dict.fromkeys(m.launches, 0))
    _ROUTES.clear()


def _read_counts(mods) -> dict:
    """The kernels of `mods` that launched, with their counts."""
    return {k: v for m in mods for k, v in m.launches.items() if v}


def _check_path(counts: dict, on_path, off_path) -> None:
    """Every kernel of a path launched in its run, and none of another's;
    every projection of the run on the path its rows and type give it."""
    missed = [k for k in on_path if counts.get(k, 0) <= 0]
    strays = [k for k in off_path if counts.get(k, 0) != 0]
    if missed or strays:
        raise AssertionError(f"kernels never launched: {missed}; kernels of another path "
                             f"launched: {strays} ({counts})")
    routes = _check_routes()
    if routes:
        log(f"  projections: {routes}")


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
        m = re.search(r"paged_decode(_int8)?(_tiles)?_kernel|paged_append(_int8)?_kernel|"
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
        _check_path(counts, ["qk_matmul_stream", *FFN_Q4_K_M, "flash_decode_int8"],
                    [*Q4_PATHS, Q4_GEMV, QK_GEMV, "flash_decode", *SB_PATHS, SB_GEMV,
                     *FFN_SB])
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
    ms a token, idle share), and a 1500-token prefill on each in turns.
    Returns both runs' counts."""
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
    if (not sb_counts.get("qk_sb_matmul_stream") or flat_counts.get("qk_sb_matmul_stream")
            or sb_counts.get(SB_GEMV)):
        raise AssertionError(f"decode windows: sb {sb_counts}, flat {flat_counts}")
    log("device ms a token at B=1, 300+ live, sb against the flat form of the same codes: "
        + ", ".join(f"{f} {[round(w['device_ms'], 4) for w in ws]}"
                    for f, ws in windows.items()))
    # A 1500-token prefill (every projection on the tensor-core path, kernel
    # 17's sb forms against kernel 13 on the flat form of the same codes).
    long_prompt = [1] + np.random.default_rng(SEED + 13).integers(3, cfg.n_vocab, 1499).tolist()
    prefill = {"sb": [], "flat": []}
    for form in ("sb", "flat", "flat", "sb"):
        eng = engines[form]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.prefill(eng.new_cache(1), [long_prompt])
        torch.cuda.synchronize()
        prefill[form].append(time.perf_counter() - t0)
    log(f"1500-token prefill, {cfg.n_layer} layers, seconds (host clock, synchronised): "
        + ", ".join(f"{f} {[round(v, 4) for v in vs]}" for f, vs in prefill.items())
        + f"; sb / flat {min(prefill['sb']) / min(prefill['flat']):.2f}x")
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
    from tokenhawk_tpu_torch.ops.cuda import qmatmul
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

    # A window's 512 rows of bfloat16 activations take the tensor-core path,
    # kernel 13's (the flat forms and the Q6_K head) and kernel 17's (the
    # super-block forms); float32 activations the GEMV alone.
    _reset_counts([qmatmul])
    for sides in ("float32", "bfloat16"):
        got = {form: nll(_sides_as(p, getattr(torch, sides)), f"{form}, {sides} sides")
               for form, p in (("sb", params), ("flat", flat))}
        log(f"  {sides} sides, bfloat16 activations: log(ppl_sb / ppl_flat) = "
            f"{got['sb'] - got['flat']:.3e}")
        if not all(np.isfinite(v) for v in got.values()):
            raise AssertionError(f"perplexity not finite: {got}")
    _check_path(_read_counts([qmatmul]), ["qk_matmul_tc", "qk_sb_matmul_tc"],
                [*Q4_PATHS, Q4_GEMV, QK_GEMV, "qk_matmul_stream", "qk_sb_matmul_stream",
                 SB_GEMV])
    # float32 sides and activations: the two forms hold the same weights, so
    # their scores differ by summation order alone.
    _reset_counts([qmatmul])
    ratio = (nll(_float32(params), "sb, float32 sides and activations")
             - nll(_float32(flat), "flat, float32 sides and activations"))
    _check_path(_read_counts([qmatmul]), ["qk_sb_matmul", "qk_matmul"],
                [*Q4_PATHS, "qk_matmul_tc", "qk_sb_matmul_tc"])
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
                              ["flash_decode_attend", K4],
                              [*Q4_PATHS, Q4_GEMV, *QK_PATHS, QK_GEMV, "flash_decode",
                               *ffn.launches,
                               *CUDA_CORE_PREFILL])
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


def _f32_identity_witness(params, draft, cfg, prompts, kernel_mods) -> None:
    """9a in float32: the same Q4_0 target with float32 activations and
    cache, drafted by the draft's first 2 layers in float32 (a draft sets
    only the speed).  The speculative stream and the verify form must match
    the Engine's greedy decode within F32_FORMS_TOL at every step; the
    verify and the prefills run kernel 4's CUDA-core walk, never its
    tensor-core one."""
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
        _reset_counts(kernel_mods)
        toks, _, _ = _spec_engine_run(spec, p, "9a f32")
        _check_path(_read_counts(kernel_mods), ["flash_attention"], [K4])
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


def _check_draft_splits(label: str, counts: dict) -> None:
    """Every kernel-14 launch of a speculative run is the draft's (the
    target's dense-cache decode is kernel 3, its verify kernel 4), and at
    the draft's 4 KV heads each takes the split form."""
    n, split = counts.get("flash_decode_attend", 0), counts.get("flash_decode_split", 0)
    log(f"  {label}: {split} of the draft's {n} kernel-14 launches took the split form")
    if not 0 < split == n:
        raise AssertionError(f"{label}: {split} of {n} kernel-14 launches split")


def _split_ab(spec, prompt) -> None:
    """9a's request again, 16 new tokens a turn (the host sets their tok/s;
    the profiled round gives kernel 14's device time), with kernel 14 held
    to one block a (sequence, KV head) (splits 1: the launch before the
    split form) and on the split form, in turns (split, one, one, split):
    decode tok/s of each, and the device time of a profiled round's
    kernel-14 launches."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from tokenhawk_tpu_torch.ops.cuda import flash_decode as fd

    log("-- 9a: kernel 14 on the split form against one block a pair, in turns")
    auto = fd.decode_splits
    tps = {"split": [], "one block": []}
    try:
        for form in ("split", "one block", "one block", "split"):
            fd.decode_splits = auto if form == "split" else (lambda *shape: 1)
            _, _, t = _spec_engine_run(spec, prompt, f"9a kernel 14 {form}", n_new=16)
            tps[form].append(t)
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                spec.generate(prompt, max_new_tokens=8)
                torch.cuda.synchronize()
            k14 = [e for e in prof.key_averages() if "decode_split_kernel" in e.key
                   or "decode_attend_kernel" in e.key]
            us = sum(e.self_device_time_total for e in k14) / max(sum(e.count for e in k14), 1)
            log(f"  {form}: kernel 14 {us:.2f} us a launch on the device (profiler, "
                f"{sum(e.count for e in k14)} launches)")
    finally:
        fd.decode_splits = auto
    log("9a decode tok/s, kernel 14 split against one block a pair: "
        + ", ".join(f"{f} {[round(v, 1) for v in vs]}" for f, vs in tps.items()))


def phase_speculation(params, kernel_mods, model_path: str, tmp: str) -> dict:
    """Phase 9: speculative decoding.  9a: SpeculativeEngine, the LLaMA-7B
    Q4_0 target (its first SPEC_LAYERS layers) with a DRAFT_LAYERS-layer
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
    dcfg = _tinyllama(DRAFT_LAYERS)
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
    _check_path(counts, [*Q4_PATHS, FFN_Q4_0, K4, "flash_decode_attend"],
                ["flash_decode", Q4_GEMV, *QK_PATHS, QK_GEMV, "flash_decode_int8", K9,
                 "paged_decode", "paged_decode_append", "paged_append", "gather_pages",
                 *CUDA_CORE_PREFILL])
    _check_draft_splits("9a", counts)
    for p, (toks, _, _) in zip(prompts, runs):
        _check_greedy_identity(f"9a prompt={len(p)}", toks,
                               _decode_and_verify_forms(engine, p, len(toks), spec.gamma))
    wall, busy = _profiled(lambda: spec.generate(prompts[0], max_new_tokens=16))
    log(f"9a profiled request (5-token prompt, 16 tokens, profiler on): wall {wall * 1e3:.1f} ms, "
        f"device busy {busy * 1e3:.1f} ms, idle share {1 - busy / wall:.1%}")
    _f32_identity_witness(params, draft, cfg, prompts, kernel_mods)
    _split_ab(spec, prompts[1])

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
    _reset_counts(kernel_mods)
    toks, stats, _ = _spec_engine_run(self_spec, prompts[1], "9b")
    _check_path(_read_counts(kernel_mods), ["flash_attention"], [K4])  # float32: CUDA cores
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

    paged_counts = _paged_speculation(params, draft, cfg, dcfg, kernel_mods)
    del draft, spec
    torch.cuda.empty_cache()
    _speculation_subprocesses(model_path, tmp)
    return counts, paged_counts


def _paged_speculation(params, draft, cfg, dcfg, kernel_mods) -> dict:
    """Phase 9c: PagedScheduler with the TinyLlama-width draft over the
    7B Q4_0 target at n_ctx 2048 (pages of 128, prefix cache, prefill
    chunks of 512): phase 4b's 12 prompts, half sampled, 32 tokens each;
    every request ends at its length, no page leaks.  Returns the run's
    launches."""
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
    # Every step a verify: kernel 6 writes its B*T rows, no decode step runs.
    _check_path(counts, [*Q4_PATHS, K4, "flash_decode_attend", "paged_append", "gather_pages"],
                ["paged_decode", "paged_decode_append", "flash_decode", Q4_GEMV, *QK_PATHS,
                 QK_GEMV, "flash_decode_int8", "paged_decode_int8", "paged_decode_int8_append",
                 "paged_append_int8", "gather_pages_int8", *CUDA_CORE_PREFILL])
    _check_draft_splits("9c", counts)
    parked = set(sched._pc.values())
    if (sched.alloc.n_free + len(parked) != sched.n_pages - 1
            or any(sched.page_refs.get(p, 0) for p in parked)):
        raise AssertionError(f"page leak: {sched.alloc.n_free} free + {len(parked)} cached "
                             f"of {sched.n_pages}")
    log(f"pages: {sched.alloc.n_free} free + {len(parked)} cached + 1 trash = {sched.n_pages}")
    _profile_paged(sched, rng, V)
    sched.cache = sched.draft_cache = None
    return counts


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


# Kernel 15's and kernel 16's launch keys (ops/cuda/ffn.py, flash_decode.py):
# their calls, kernel 15's walk launches (three a call), and kernel 16's
# tile-walk launches in a cluster and its Wo walk launches (one each a call
# at the 7B's B=1).
OWO_Q4_0 = "owo_ffn[q4_0/q4_0]"
OWO_STREAM = "owo_ffn_stream"
ATTN_WO = "attn_wo"
ATTN_SPLIT = "attn_wo_split"
ATTN_STREAM = "attn_wo_stream"


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
    gone under OWO alone; three walk launches a kernel-15 call, one
    tile-walk launch (a cluster a head) and one walk launch a kernel-16
    call.  Each fused stream is held to the unfused one up
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
    # Launches per decode token: wqkv and the head are kernel 1 in every form;
    # kernel 3 at B=1 over the 7B's 32 KV heads takes its split form.
    k3 = {"flash_decode": L, "flash_decode_append_split": L}
    k1 = Q4_PATHS[0]
    owo = {OWO_Q4_0: L, OWO_STREAM: 3 * L}
    attn = {ATTN_WO: L, ATTN_SPLIT: L, ATTN_STREAM: L}
    per_token = {"neither": {k1: 2 * L + 1, **k3, FFN_Q4_0: L},
                 "owo": {k1: L + 1, **k3, **owo},
                 "attn": {k1: L + 1, **attn, FFN_Q4_0: L},
                 "both": {k1: L + 1, **attn, FFN_Q4_0: L}}
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
                _check_path(requests[name], [K4], CUDA_CORE_PREFILL)
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
        _check_path(_read_counts(kernel_mods),
                    [OWO_Q4_0 if fusions.owo else ATTN_WO, "flash_attention"], [K4])
        _check_greedy_identity(f"10a f32 {name} prompt={len(prompt)}", toks,
                               _fused_forms(eng, prompt, len(toks), fusions), F32_FORMS_TOL)


def phase_fused_paged(params, kernel_mods, bf16_paged, off_path) -> dict:
    """Phase 10b: phase 4b's paged server (LLaMA-7B Q4_0, 8 slots) with OWO
    on: kernel 15 at up to 8 decode rows (three walk launches a call),
    kernel 2 never.  Returns the run's launches."""
    from tokenhawk_tpu_torch.models.llama import Fusions

    cfg = dataclasses.replace(_seven_b(32), n_ctx=2048)
    params.fusions = Fusions(owo=True)
    try:
        counts, sched = phase_paged_serve(
            params, cfg, kernel_mods, "bf16", [*Q4_PATHS, OWO_Q4_0, K4] + bf16_paged,
            [FFN_Q4_0, ATTN_WO, "flash_decode", Q4_GEMV, *CUDA_CORE_PREFILL] + off_path,
            "phase 10b: paged serve with OWO (kernel 15), LLaMA-7B Q4_0, 32 layers")
    finally:
        params.fusions = Fusions()
    sched.cache = None
    if counts.get(OWO_STREAM) != 3 * counts[OWO_Q4_0]:
        raise AssertionError(f"10b: {counts.get(OWO_STREAM)} walk launches for "
                             f"{counts[OWO_Q4_0]} kernel-15 calls, not three a call")
    log(f"10b: {counts[OWO_Q4_0]} kernel-15 calls, {counts[OWO_STREAM]} walk launches")
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
    base_off = ([Q4_GEMV, *QK_PATHS, QK_GEMV, "flash_decode", OWO_Q4_0, ATTN_WO,
                 *CUDA_CORE_PREFILL]
                + dense_off)
    counts = {}
    for kv, on, off in (("bf16", bf16_paged, int8_paged), ("int8", int8_paged, bf16_paged)):
        counts[kv], sched = phase_paged_serve(
            params, cfg, kernel_mods, kv, [*Q4_PATHS, FFN_Q4_0, K4] + on,
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
    """Phase 12b: the 7B Q4_0 model (its first CP_LAYERS layers) through
    Engine(parallel="cp") at n_ctx 2048 over a NCCL group of one rank (one
    H100): prompts of 5,
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

    log(f"== phase 12b: Engine(parallel='cp'), NCCL group of 1 rank, LLaMA-7B Q4_0, "
        f"{CP_LAYERS} layers, bf16 KV, n_ctx 2048")
    cfg = dataclasses.replace(_seven_b(CP_LAYERS), n_ctx=2048)
    params = dataclasses.replace(params, layers=params.layers[:CP_LAYERS])
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
        _check_path(counts, [*Q4_PATHS, "flash_decode_stats", "flash_decode_stats_split",
                             "flash_attention_stats_tc"],
                    [FFN_Q4_0, Q4_GEMV, "flash_decode", K4, "flash_attention",
                     "flash_decode_attend", "flash_attention_stats"])
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
             [Q4_PATHS[0], FFN_Q4_0, "flash_decode", K4]),
            ("serve", ["--batch", "8", "--requests", "16", "--tokens", "64"],
             "llama7b_q4_0_serve_agg_tokens_per_sec_b8",
             [Q4_PATHS[0], FFN_Q4_0, K4, "paged_decode_append"])):
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
    _install_route_spy()
    phase_slice()
    mods = [qmatmul, ffn, flash_decode, flash_attention]
    every = mods + [paged_decode, kv_int8, paged_int8]
    counts, params = phase_serve(mods)
    # A paged decode layer appends and attends in one launch (kernel 5 with
    # kernel 6 folded in; on int8 pages kernel 10 with kernel 11): kernels
    # 5, 6, 10 and 11 launched apart (`unfolded`) stay off every decode
    # path; kernel 6 serves the paged verify alone (phase 9c).
    bf16_paged = ["paged_decode_append", "gather_pages"]
    int8_dense = ["flash_decode_int8", K9]
    int8_paged = ["paged_decode_int8_append", "gather_pages_int8"]
    unfolded = ["paged_decode", "paged_append", "paged_decode_int8", "paged_append_int8"]
    cfg_2k = dataclasses.replace(_seven_b(32), n_ctx=2048)
    paged_counts, sched = phase_paged_serve(
        params, cfg_2k, every, "bf16",
        [*Q4_PATHS, FFN_Q4_0, K4, "paged_decode_append_split"] + bf16_paged,
        [Q4_GEMV, *QK_PATHS, QK_GEMV, "flash_decode", *CUDA_CORE_PREFILL] + int8_dense
        + int8_paged + unfolded,
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
                                       [*Q4_PATHS, FFN_Q4_0, "flash_decode_int8_split"]
                                       + int8_dense,
                                       [Q4_GEMV, *QK_PATHS, QK_GEMV, "flash_decode", K4,
                                        *CUDA_CORE_PREFILL]
                                       + bf16_paged + int8_paged + unfolded)
        int8_paged_counts, sched = phase_paged_serve(
            params_i8, cfg_i8, every, "int8",
            [*Q4_PATHS, FFN_Q4_0, K4, "paged_decode_int8_append_split"] + int8_paged,
            [Q4_GEMV, *QK_PATHS, QK_GEMV, "flash_decode", *CUDA_CORE_PREFILL] + bf16_paged
            + int8_dense + unfolded,
            f"phase 4bi: paged serve, LLaMA-7B Q4_0 widths, {INT8_LAYERS} layers")
        phase_cli(path)
        sched.cache = None
        del sched
        torch.cuda.empty_cache()
        # Phase 8: dense weights decode through kernel 14; phase 9: speculation
        # over the Q4_0 model, its draft's decode through kernel 14 at Dh 64.
        dense_counts = phase_dense_7b(every)
        spec_counts, spec_paged_counts = phase_speculation(params, every, path, tmp)
        # Phase 10: the fused decode-layer kernels (10a Engine, 10b paged),
        # then a head-dim-64 model under the paged server (10c).
        fused_counts = phase_fused_engine(params, every)
        phase_fused_paged(params, every, bf16_paged, int8_dense + int8_paged + unfolded)
        torch.cuda.empty_cache()
        phase_tinyllama_paged(every, bf16_paged, int8_paged, int8_dense + unfolded, tmp)
        torch.cuda.empty_cache()
        # Phase 12b: context parallelism over a one-rank NCCL group.
        cp_counts = phase_cp_engine(params, every, tmp)
        del params  # the Q4_0 model goes before the GGUF kinds' phases
        torch.cuda.empty_cache()
        # Phases 6 and 6q: group-code projections (kernel 13) and the FFN over
        # them (kernel 2); kernel 1 (Q4_0) stays off.
        def engine_path(on, off):
            return ([*QK_PATHS, *on, "flash_decode", K4],
                    [*Q4_PATHS, Q4_GEMV, QK_GEMV, FFN_Q4_0, "flash_decode_attend", *off,
                     *CUDA_CORE_PREFILL] + bf16_paged + int8_dense + int8_paged + unfolded)

        def paged_path(on, off):
            return ([*QK_PATHS, *on, K4] + bf16_paged,
                    [*Q4_PATHS, Q4_GEMV, QK_GEMV, FFN_Q4_0, "flash_decode", *off,
                     *CUDA_CORE_PREFILL]
                    + int8_dense + int8_paged + unfolded)

        # Without THAWK_Q4K_SB the super-block kernels stay off.
        flat_off = [*SB_PATHS, SB_GEMV, *FFN_SB]
        q4km_counts, _ = phase_q4_k_m(every, engine_path(FFN_Q4_K_M, flat_off),
                                      paged_path(FFN_Q4_K_M, flat_off))
        q8_counts = phase_q8_0(every, engine_path([FFN_Q8_0], flat_off))
        gguf_path = phase_gguf(tmp, every)
        # Phase 11: the Q4_K super-block forms (kernel 17, kernel 2 with an
        # sb w13); 11a on phase 6's model, 11b and 11c on phase 7's file.
        sb_on = [*SB_PATHS, *FFN_SB]
        sb_counts, _ = phase_q4k_sb(every, engine_path(sb_on, [*FFN_Q4_K_M, SB_GEMV]),
                                    paged_path(sb_on, [*FFN_Q4_K_M, SB_GEMV]))
        phase_gguf_sb(gguf_path, tmp)
    # Phase 13: the bench (kernel 20 on its path) and the experiment kernels
    # 21 and 22, after every earlier phase's model is gone.
    torch.cuda.empty_cache()
    stream_rec = phase_stream_kernel()
    stream_rec["launches"] = phase_bench(every)
    bench_records = [stream_rec, *phase_experiments()]
    # Each kernel's launches on the path of the slice that added it: the
    # Q4_0 Engine run for kernels 1-4, the paged server's run for kernels
    # 5 (its kernel's launches as the folded form; none attend-only) and 7
    # and the folded form, phase 9c's paged verify for kernel 6, the int8
    # Engine's for kernels 8-9, the int8 paged server's for kernels 10
    # (likewise) and 12 and its folded form, none for kernel 11 (since its
    # append runs folded into kernel 10, on no path), and the Engine runs
    # of phases 6 (Q4_K_M) and 6q (Q8_0)
    # for kernel 13 and kernel 2 over those kinds, each pairing its own;
    # phase 11a's (Q4_K_M in super-block forms) for kernel 17 and kernel 2
    # with an sb w13;
    # the dense 7B Engine's of phase 8 for kernel 14; phase 10a's requests
    # with OWO for kernel 15 and with ATTN for kernel 16; phase 12b's CP
    # Engine for kernels 18 and 19 (kernel 19's tensor-core walk: its bf16
    # K/V).
    launches = {"q4_matmul_stream": counts["q4_matmul_stream"],
                "q4_matmul_tc": counts["q4_matmul_tc"],
                "fused_ffn": counts[FFN_Q4_0],
                "flash_decode_append": counts["flash_decode"],
                "flash_decode_append_split": counts["flash_decode_append_split"],
                "flash_attention": counts[K4],
                "qk_matmul_stream[q4_k_m]": q4km_counts["qk_matmul_stream"],
                "qk_matmul_tc[q4_k_m]": q4km_counts["qk_matmul_tc"],
                "qk_matmul_stream[q8_0]": q8_counts["qk_matmul_stream"],
                "qk_matmul_tc[q8_0]": q8_counts["qk_matmul_tc"],
                "fused_ffn[q4_k/q6_k]": q4km_counts[FFN_Q4_K_M[0]],
                "fused_ffn[q4_k/q4_k]": q4km_counts[FFN_Q4_K_M[1]],
                "fused_ffn[q8_0/q8_0]": q8_counts[FFN_Q8_0],
                "qk_sb_matmul_stream": sb_counts["qk_sb_matmul_stream"],
                "qk_sb_matmul_tc": sb_counts["qk_sb_matmul_tc"],
                "fused_ffn[q4k_sb/q6_k]": sb_counts[FFN_SB[0]],
                "fused_ffn[q4k_sb/q4_k]": sb_counts[FFN_SB[1]],
                **{k: paged_counts[k] for k in bf16_paged},
                "paged_decode": (paged_counts.get("paged_decode", 0)
                                 + paged_counts["paged_decode_append"]),
                "paged_append": spec_paged_counts["paged_append"],
                "flash_decode_int8": int8_counts["flash_decode_int8"],
                "flash_attention_int8": int8_counts[K9],
                **{k: int8_paged_counts[k] for k in int8_paged},
                "paged_decode_int8": (int8_paged_counts.get("paged_decode_int8", 0)
                                      + int8_paged_counts["paged_decode_int8_append"]),
                "paged_append_int8": int8_paged_counts.get("paged_append_int8", 0),
                "flash_decode_attend": dense_counts["flash_decode_attend"],
                "flash_decode_attend_split": spec_counts["flash_decode_split"],
                "fused_owo_ffn": fused_counts["owo"][OWO_Q4_0],
                "fused_attn_out": fused_counts["attn"][ATTN_WO],
                "flash_decode_stats": cp_counts["flash_decode_stats"],
                "flash_attention_stats": cp_counts["flash_attention_stats_tc"]}
    for rec in records:
        rec["launches"] = launches[rec["name"]]
    records += bench_records  # kernels 20-22, launches on their own paths
    log(f"all phases passed in {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


def prefill_main() -> int:
    """`python3 chip_smoke.py --prefill`: phase 1, then phase 2's kernels 4
    and 9 (_prefill_records) alone.  The last line is {"prefill": [...]},
    their two records."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing run", file=sys.stderr)
        return 1
    phase_env()
    log("== kernels 4 and 9 alone")
    _, randn, case, library = _case_tools()
    print(json.dumps({"prefill": _prefill_records(randn, case, library)}))
    return 0


if __name__ == "__main__":
    sys.exit(prefill_main() if "--prefill" in sys.argv[1:] else main())
