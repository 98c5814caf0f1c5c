#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (tokenhawk_tpu_torch) once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its own lines; any failure raises and exits non-zero:
  1. versions, the card's name and power limit, the kernel build;
  2. each CUDA kernel against its plain PyTorch version at LLaMA-7B shapes
     (max error against the stated tolerance, median CUDA-event times);
  3. slice check: a 2-layer LLaMA-7B-width Q4_0 model, prefill of 16
     tokens + 8 decode steps on the GPU (kernels) and on the CPU (plain
     versions, same parameters), logits compared at every step;
  4. serve: the full 32-layer 7B Q4_0 model, Engine.generate on 3 prompts,
     and the launch count of every kernel over that run;
  5. CLI: a 2-layer 7B-width ggjt Q4_0 file through tokenhawk_tpu_torch.cli.
The next-to-last line is {"kernels": [...]}, the last {"ok": true, ...}.
It needs one CUDA device and the rest of the repository beside it.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

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


def log(msg: str = "") -> None:
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


def max_err(out, ref) -> tuple:
    d = (out.float() - ref.float()).abs().max().item()
    return d, KERNEL_TOL * ref.float().abs().max().item()


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

    from tokenhawk_tpu_torch.ops.cuda import ffn, flash_attention, flash_decode, qmatmul
    from tokenhawk_tpu_torch.ops.qweight import QWeight

    log("== phase 2: kernels against their plain versions (7B shapes, bfloat16)")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(SEED)

    def randn(*shape, scale=1.0, dtype=torch.bfloat16):
        return (torch.randn(shape, generator=g, device=dev) * scale).to(dtype)

    def qweight(k, n):
        return QWeight.quantize(randn(k, n, scale=0.02, dtype=torch.float32))

    def case(cases, label, shape, rows, out, ref, kernel_fns, plain_fns):
        """Check one shape against the tolerance, time both versions."""
        err, tol = max_err(out, ref)
        kt, pt = timed(kernel_fns), timed(plain_fns)
        log(f"{label}: max_abs_err {err:.3e} (tol {tol:.3e})  kernel {kt['ms']:.4f} ms "
            f"[per call {kt['call_ms']:.4f}]  plain {pt['ms']:.4f} ms [per call {pt['call_ms']:.4f}]")
        if not err <= tol:
            raise AssertionError(f"{label}: {err} > {tol}")
        cases.append(dict(shape=shape, rows=rows, max_abs_err=err, tol=tol, ms=kt["ms"],
                          plain_ms=pt["ms"], call_ms=kt["call_ms"],
                          plain_call_ms=pt["call_ms"]))

    records = []

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
                 qmatmul.q4_matmul(x, w, gain), qmatmul.q4_matmul_plain(x, w, gain),
                 [lambda w=w: qmatmul.q4_matmul(x, w, gain) for w in ws],
                 [lambda w=w: qmatmul.q4_matmul_plain(x, w, gain) for w in ws])
        del w, ws
    records.append(_record("q4_matmul", "tokenhawk_tpu_torch/csrc/qmatmul.cu",
                           "tokenhawk_tpu/ops/pallas/qmatmul.py:807 (q4_matmul); "
                           "qmatmul.py:874 (q4_matmul_i4)", cases, ("wqkv", 1)))

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
    del w13, w2, sets
    records.append(_record("fused_ffn", "tokenhawk_tpu_torch/csrc/ffn.cu",
                           "tokenhawk_tpu/ops/pallas/ffn.py:270 (_fused_ffn via fused_ffn)",
                           cases, ("ffn", 1)))

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
    records.append(_record("flash_decode_append", "tokenhawk_tpu_torch/csrc/flash_decode.cu",
                           "tokenhawk_tpu/ops/pallas/flash_decode_dma.py:1112 "
                           "(flash_decode_append_walk); flash_decode_dma.py:1218 "
                           "(flash_decode_append)", cases, ("B=1 L=512", 1)))

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
    records.append(_record("flash_attention", "tokenhawk_tpu_torch/csrc/flash_attention.cu",
                           "tokenhawk_tpu/ops/pallas/flash_attention.py:139 "
                           "(flash_attention via attend_prefill)", cases, ("T=512 off=0", 512)))
    return records


def _record(name, source, replaces, cases, main_case) -> dict:
    """One kernel's JSON entry: worst error over its cases, times at the
    shape the main path runs most (main_case = (shape, rows))."""
    main = next(c for c in cases if (c["shape"], c["rows"]) == main_case)
    return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": 0, "max_abs_err": max(c["max_abs_err"] for c in cases),
            "ms": main["ms"], "plain_ms": main["plain_ms"],
            "timed_at": f"{main['shape']} rows={main['rows']}", "cases": cases}


def _seven_b(n_layer: int):
    from tokenhawk_tpu_torch.config import LlamaConfig

    return LlamaConfig(n_embd=4096, n_head=32, n_layer=n_layer, n_ctx=S_CTX)


def _q4_params(cfg, device):
    import torch

    from tokenhawk_tpu_torch.models.llama import fuse_params, init_params

    g = torch.Generator(device=device)
    g.manual_seed(SEED)
    return fuse_params(init_params(cfg, g, dtype=torch.bfloat16, device=device, quant="q4_0"))


def phase_slice() -> None:
    import torch

    from tokenhawk_tpu_torch.models.llama import KVCache, forward, logits_from_hidden
    from tokenhawk_tpu_torch.runtime.engine import make_prefill_fn

    log("== phase 3: slice check, 2-layer 7B-width Q4_0, GPU kernels vs CPU plain")
    cfg = _seven_b(2)
    p_gpu = _q4_params(cfg, torch.device("cuda"))
    p_cpu = p_gpu.to("cpu")
    rng = np.random.default_rng(SEED)
    ids = rng.integers(3, cfg.n_vocab, size=16 + 8)
    prefill = make_prefill_fn(cfg)

    def run(params, dev):
        cache = KVCache.create(cfg, 1, S_CTX, torch.bfloat16, dev)
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
    log(f"gpu {t1 - t0:.2f} s, cpu {t2 - t1:.2f} s")
    for i, (a, b) in enumerate(zip(got, want)):
        if not bool(torch.isfinite(a).all()):
            raise AssertionError(f"step {i}: non-finite logits on the GPU")
        err = (a - b).abs().max().item()
        tol = SLICE_TOL * b.abs().max().item()
        same = int(a.argmax()) == int(b.argmax())
        log(f"step {i} ({'prefill' if i == 0 else 'decode'}): max |logit diff| {err:.3e} "
            f"(tol {tol:.3e}), argmax equal {same}")
        if not err <= tol:
            raise AssertionError(f"slice step {i}: {err} > {tol}")


def phase_serve(kernel_mods) -> dict:
    import torch

    from tokenhawk_tpu_torch.config import SamplingConfig
    from tokenhawk_tpu_torch.runtime.engine import Engine
    from tokenhawk_tpu_torch.tokenizer import byte_fallback_vocab

    log("== phase 4: serve, LLaMA-7B Q4_0, 32 layers, bf16 KV, n_ctx 512")
    cfg = _seven_b(32)
    t0 = time.perf_counter()
    params = _q4_params(cfg, torch.device("cuda"))
    torch.cuda.synchronize()
    wbytes = sum(lp.wqkv.nbytes + lp.wo.nbytes + lp.w13.nbytes + lp.w2.nbytes
                 for lp in params.layers) + params.output.nbytes
    log(f"weights built in {time.perf_counter() - t0:.1f} s: Q4_0 projections {wbytes / 1e9:.3f} GB, "
        f"allocated {torch.cuda.memory_allocated() / 1e9:.3f} GB")
    tok = byte_fallback_vocab()
    greedy = SamplingConfig(temperature=0.0)
    sampled = SamplingConfig(temperature=0.8, top_k=40, top_p=0.95)
    rng = np.random.default_rng(SEED + 1)
    # Random weights: EOS is disabled (eos_id=-1) so every request decodes
    # its whole budget.
    requests = [(greedy, 5), (sampled, 100), (greedy, 300)]
    engines = {id(s): Engine(cfg, params, tok, sampling=s, max_seq=S_CTX, eos_id=-1)
               for s in (greedy, sampled)}
    for m in kernel_mods:
        m.launches = 0
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
    counts = {m.__name__.rsplit(".", 1)[-1]: m.launches for m in kernel_mods}
    log(f"kernel launches in the serve run: {counts}")
    log(f"peak device memory {torch.cuda.max_memory_allocated() / 1e9:.3f} GB")
    if min(counts.values()) <= 0:
        raise AssertionError(f"a kernel of the path was never launched: {counts}")
    _profile_request(engines[id(greedy)], [1] + rng.integers(3, cfg.n_vocab, size=4).tolist())
    return counts


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
        name = e.key.split("(")[0].replace("void ", "")[:90]
        log(f"  {e.self_device_time_total / 1e3:9.3f} ms  {e.count:6d}x  {name}")


def phase_cli() -> None:
    import torch

    from tokenhawk_tpu_torch import cli
    from tokenhawk_tpu_torch.ggml.format import GGMLType
    from tokenhawk_tpu_torch.ggml.quants import QuantizedTensor
    from tokenhawk_tpu_torch.ggml.writer import write_ggml
    from tokenhawk_tpu_torch.ops.qweight import QWeight
    from tokenhawk_tpu_torch.tokenizer import byte_fallback_vocab

    log("== phase 5: CLI on a 2-layer 7B-width ggjt Q4_0 file")
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
    vocab = byte_fallback_vocab()
    tokens = vocab.id_to_token + [f"<unused{i}>".encode() for i in range(V - vocab.n_vocab)]
    scores = vocab.scores + [-1e9] * (V - vocab.n_vocab)
    hp = dict(n_vocab=V, n_embd=D, n_mult=cfg.n_mult, n_head=cfg.n_head,
              n_layer=cfg.n_layer, n_rot=cfg.head_dim, ftype=2)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "llama7b-2layer-q4_0.bin")
        write_ggml(path, hp, tokens, scores, tensors)
        log(f"wrote {path} ({os.path.getsize(path) / 1e6:.1f} MB)")
        rc = cli.main(["-m", path, "Hello", "--greedy", "--max-tokens", "16", "--n-ctx", "512"])
    sys.stderr.flush()
    if rc != 0:
        raise AssertionError(f"cli returned {rc}")
    log("cli exit 0")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing run", file=sys.stderr)
        return 1
    from tokenhawk_tpu_torch.ops.cuda import ffn, flash_attention, flash_decode, qmatmul

    t0 = time.perf_counter()
    phase_env()
    records = phase_kernels()
    phase_slice()
    mods = [qmatmul, ffn, flash_decode, flash_attention]
    counts = phase_serve(mods)
    for rec, m in zip(records, mods):
        rec["launches"] = counts[m.__name__.rsplit(".", 1)[-1]]
    phase_cli()
    log(f"all phases passed in {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
