"""Time kernels 1, 13 and 17 (the quantized matmul) and kernel 2 (the fused
FFN) at decode rows, on the decode-row walk.

    python -m tokenhawk_tpu_torch.experiments.gemv_rows [--sweep] [--case TEXT]
        [--rows 1,8] [--ramp]

For each case, at the shapes of the model paths that run them (kernel 13
over Llama-3-8B in Q4_K_M: wqkv, wo, the Q6_K w2 and head, and LLaMA-7B in
Q8_0: wqkv and head; kernel 1 over the 7B's Q4_0 wqkv, wo and output;
kernel 17 over Llama-3-8B's super-block wqkv and wo; kernel 2 over the
7B's Q4_0 and Q8_0 pairs and Llama-3-8B's Q4_K / Q6_K, Q4_K / Q4_K and
super-block w13 pairs), at 1 and 8 rows of bfloat16 x with the norm as
the model fuses it: the error against the plain version (2^-7 of the
largest |reference|), the device ms of one call back to back (`ms`: CUDA
events behind a device spin, weight copies spanning 3x the 50 MB L2) and
alone (`isolated_ms`: the device idle before it, as in an eager decode
step whose host is slower than its kernels), the launch counter it
ticked, and the bound (the weights' GGUF bytes, and the port's layout bytes, at 3.35 TB/s;
the operations at the card's 67 TFLOP/s of f32 FMAs, the arithmetic at
these rows).  With --sweep, in a tree whose wrappers force the decode-row
walk's plan (`quant_matmul_at`, `fused_ffn_at`), each case also at every
plan of 1-4 K segments and 2-6 ring stages that fits (kernel 2: each
launch's plan swept with the other at the rule's).  The weights and inputs
come from a seed, so two trees of the port give the same calls: copy the
script into a `git archive` of another tree and run it there, in turns
with this one, to put the two beside each other.  With --ramp, the
one-row time of one launch at K 4096 over N = 264 * 2^i outputs (i = 0..7;
from N 4224 on every warp of 132 SMs x 16 takes the same number of column
pairs) for Q4_0, Q4_K and its super-block form, back to back and alone,
and a least-squares line through the full-wave points of each: its slope
the stream's rate, its intercept the fixed cost of a launch (the ramp,
and back to back the gap between launches).  The last line is one JSON
object with every timing.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from tokenhawk_tpu_torch.ggml.format import GGMLType
from tokenhawk_tpu_torch.ggml.gguf import gguf_tensor_nbytes
from tokenhawk_tpu_torch.ops.cuda import ffn, qmatmul
from tokenhawk_tpu_torch.ops.qweight import QWeight

SEED = 1234
HBM_BPS, F32_FLOPS = 3.35e12, 67e12
TOL = 2.0**-7
# Kernel 13 (and kernel 1): (name, K, N, kind, norm).
MATMULS = [("Llama-3-8B Q4_K wqkv", 4096, 6144, "q4_k", True),
           ("Llama-3-8B Q4_K wo", 4096, 4096, "q4_k", False),
           ("Llama-3-8B Q6_K w2", 14336, 4096, "q6_k", False),
           ("Llama-3-8B Q6_K head", 4096, 128256, "q6_k", True),
           ("7B Q8_0 wqkv", 4096, 12288, "q8_0", True),
           ("7B Q8_0 head", 4096, 32000, "q8_0", True),
           ("7B Q4_0 wqkv (kernel 1)", 4096, 12288, "q4_0", True),
           ("7B Q4_0 wo (kernel 1)", 4096, 4096, "q4_0", False),
           ("7B Q4_0 output (kernel 1)", 4096, 32000, "q4_0", True),
           ("Llama-3-8B sb wqkv (kernel 17)", 4096, 6144, "q4k_sb", True),
           ("Llama-3-8B sb wo (kernel 17)", 4096, 4096, "q4k_sb", False)]
# The ramp sweep: K, the outputs N = RAMP_N0 * 2^i, the forms.
RAMP_K, RAMP_N0, RAMP_STEPS = 4096, 264, 8
RAMP_KINDS = ("q4_0", "q4_k", "q4k_sb")
# Kernel 2: (name, D, F, w13 kind, w2 kind).
FFNS = [("7B Q4_0/Q4_0", 4096, 11008, "q4_0", "q4_0"),
        ("Llama-3-8B Q4_K/Q6_K", 4096, 14336, "q4_k", "q6_k"),
        ("Llama-3-8B Q4_K/Q4_K", 4096, 14336, "q4_k", "q4_k"),
        ("7B Q8_0/Q8_0", 4096, 11008, "q8_0", "q8_0"),
        ("Llama-3-8B Q4_K sb/Q6_K", 4096, 14336, "q4k_sb", "q6_k"),
        ("Llama-3-8B Q4_K sb/Q4_K", 4096, 14336, "q4k_sb", "q4_k")]


def device_ms(fns, calls: int = 32) -> float:
    """Median of 5 trials of the mean device time of one call: `calls`
    back-to-back calls cycling through fns, queued behind a device spin so
    that the events time the device alone."""
    for f in fns:
        f()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for i in range(calls):
        fns[i % len(fns)]()
    b.record()
    b.synchronize()
    spin = int((2 * calls * min(a.elapsed_time(b) / calls, 0.5) + 2) * 2.0e6)
    times = []
    for _ in range(5):
        torch.cuda._sleep(spin)
        a.record()
        for i in range(calls):
            fns[i % len(fns)]()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / calls)
    return float(np.median(times))


def isolated_ms(fns, trials: int = 21) -> float:
    """Median device ms of one call that finds the device idle: each call
    between two events, queued behind a device spin of about 1 ms (so the
    host's launch cost, a multi-launch call's wrappers included, stays
    outside the events) that follows the last call's end, cycling through
    fns."""
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


def weight(K, N, kind, g, dev) -> QWeight:
    if kind == "q4_0":
        return QWeight.quantize(torch.randn(K, N, generator=g, device=dev) * 0.02)
    return QWeight.random(K, N, kind, g, dev)


def gguf_bytes(kind: str, K: int, N: int) -> int:
    return gguf_tensor_nbytes(GGMLType["Q4_K" if kind == "q4k_sb" else kind.upper()], K * N)


def copies(ws) -> list:
    """ws (a tuple of weights) and clones enough to span 3x the L2."""
    nbytes = sum(w.nbytes for w in ws)
    n = min(16, max(1, -(-150_000_000 // nbytes)))
    return [ws] + [tuple(QWeight(*(t.clone() if isinstance(t, torch.Tensor) else t for t in (
        w.qs, w.scales, w.mins, w.kind, w.group, w.scmn))) for w in ws) for _ in range(n - 1)]


def bound(gguf: int, layout: int, io: int, flops: float) -> dict:
    t_ops = flops / F32_FLOPS * 1e3
    t_bytes = (gguf + io) / HBM_BPS * 1e3
    return {"bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else
            "operations", "layout_bound_ms": max((layout + io) / HBM_BPS * 1e3, t_ops)}


def counted(run):
    """run() and the launch counters it ticked."""
    before = {**qmatmul.launches, **ffn.launches}
    out = run()
    after = {**qmatmul.launches, **ffn.launches}
    return out, [k for k, v in after.items() if v != before.get(k, 0)]


def check(name, out, ref) -> float:
    err = (out.float() - ref.float()).abs().max().item()
    tol = TOL * ref.float().abs().max().item()
    if not err <= tol:
        raise AssertionError(f"{name}: {err} > {tol}")
    return err


def plans(form, rows, K, N, sms, swiglu=False) -> list:
    """Every (splits, stages) of the decode-row walk with 1-4 K segments
    that fits at this shape."""
    blocks = qmatmul.stream_blocks(N, sms, swiglu)
    return [(n, r) for n in range(1, 5) for r in range(2, qmatmul.STREAM_MAX_STAGES + 1)
            if qmatmul.stream_fits(form, rows, K, N, n, r, blocks, swiglu)]


def ramp(g, dev) -> list:
    """One-row times over N at K RAMP_K, norm on, for each of RAMP_KINDS,
    and each form's line through its full-wave points (N >= 16 * RAMP_N0)."""
    out = []
    K = RAMP_K
    for kind in RAMP_KINDS:
        points = []
        for i in range(RAMP_STEPS):
            N = RAMP_N0 * 2**i
            w = weight(K, N, kind, g, dev)
            sets = copies((w,))
            gain = (1.0 + 0.1 * torch.randn(K, generator=g, device=dev)).to(torch.bfloat16)
            x = torch.randn(1, K, generator=g, device=dev).to(torch.bfloat16)
            y, path = counted(lambda: qmatmul.quant_matmul(x, w, gain))
            check(f"ramp {kind} N={N}", y, qmatmul.quant_matmul_plain(x, w, gain))
            fns = [lambda s=s: qmatmul.quant_matmul(x, s[0], gain) for s in sets]
            points.append(dict(N=N, bytes=w.nbytes, ms=device_ms(fns),
                               isolated_ms=isolated_ms(fns), path=path))
            print(json.dumps(dict(ramp=kind, **points[-1])), flush=True)
            del w, sets
            torch.cuda.empty_cache()
        full = [p for p in points if p["N"] >= 16 * RAMP_N0]
        rec = dict(ramp=kind, K=K, points=points, fit_points=len(full))
        for key, tag in (("ms", ""), ("isolated_ms", "isolated_")):
            slope, icpt = np.polyfit([p["bytes"] for p in full], [p[key] for p in full], 1)
            rec[tag + "intercept_ms"] = float(icpt)
            rec[tag + "stream_tbps"] = float(1e-9 / slope)
        print(json.dumps(rec), flush=True)
        out.append(rec)
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--sweep", action="store_true", help="time every plan that fits")
    ap.add_argument("--case", default="", help="only the cases whose name holds this text")
    ap.add_argument("--rows", default="1,8", help="row counts, comma-separated")
    ap.add_argument("--ramp", action="store_true", help="the N sweep at one row alone")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("gemv_rows: needs a CUDA device")
    sweep = args.sweep and hasattr(ffn, "fused_ffn_at") and hasattr(qmatmul, "quant_matmul_at")
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rows_list = [int(r) for r in args.rows.split(",")]
    g = torch.Generator(device=dev)
    g.manual_seed(SEED)
    if args.ramp:
        print(json.dumps({"gemv_ramp": ramp(g, dev), "device": torch.cuda.get_device_name(0)}))
        return 0
    out = []
    for name, K, N, kind, norm in MATMULS:
        if args.case not in name:
            continue
        w = weight(K, N, kind, g, dev)
        sets = copies((w,))
        gain = (1.0 + 0.1 * torch.randn(K, generator=g, device=dev)).to(torch.bfloat16)
        ng = gain if norm else None
        for rows in rows_list:
            x = torch.randn(rows, K, generator=g, device=dev).to(torch.bfloat16)
            y, path = counted(lambda: qmatmul.quant_matmul(x, w, ng))
            err = check(name, y, qmatmul.quant_matmul_plain(x, w, ng))
            fns = [lambda s=s: qmatmul.quant_matmul(x, s[0], ng) for s in sets]
            io = 2 * rows * (K + N) + 2 * K * norm
            rec = dict(case=name, rows=rows, path=path, max_abs_err=err, ms=device_ms(fns),
                       isolated_ms=isolated_ms(fns),
                       **bound(gguf_bytes(kind, K, N), w.nbytes, io, 2 * rows * K * N))
            if sweep and qmatmul.stream_path(qmatmul.form_code(w), rows):
                form = qmatmul.form_code(w)
                rec["rule"] = qmatmul.stream_plan(rows, K, N, form, sms)[:2]
                rec["sweep"] = {
                    f"{n},{r}": device_ms([lambda v=v, n=n, r=r: qmatmul.quant_matmul_at(
                        x, v[0], ng, splits=n, stages=r) for v in sets])
                    for n, r in plans(form, rows, K, N, sms)}
            out.append(rec)
            print(json.dumps(rec), flush=True)
        del w, sets
        torch.cuda.empty_cache()
    for name, D, F, k13, k2 in FFNS:
        if args.case not in name:
            continue
        w13, w2 = weight(D, 2 * F, k13, g, dev), weight(F, D, k2, g, dev)
        sets = copies((w13, w2))
        gain = (1.0 + 0.1 * torch.randn(D, generator=g, device=dev)).to(torch.bfloat16)
        for rows in rows_list:
            x = torch.randn(rows, D, generator=g, device=dev).to(torch.bfloat16)
            y, path = counted(lambda: ffn.fused_ffn(x, w13, w2, gain))
            err = check(name, y, ffn.fused_ffn_plain(x, w13, w2, gain))
            fns = [lambda s=s: ffn.fused_ffn(x, *s, gain) for s in sets]
            io = 2 * (2 * rows + 1) * D
            rec = dict(case=name, rows=rows, path=path, max_abs_err=err, ms=device_ms(fns),
                       isolated_ms=isolated_ms(fns),
                       **bound(gguf_bytes(k13, D, 2 * F) + gguf_bytes(k2, F, D),
                               w13.nbytes + w2.nbytes, io, 6 * rows * D * F))
            if sweep:
                pa, pb = ffn.ffn_plans(rows, w13, w2, sms)
                f13, f2 = qmatmul.form_code(w13), qmatmul.form_code(w2)
                rec["rule"] = [pa[:2], pb[:2]]
                rec["sweep_gate_up"] = {
                    f"{n},{r}": device_ms([lambda v=v, p=(n, r): ffn.fused_ffn_at(
                        x, *v, gain, plans=(p, None)) for v in sets])
                    for n, r in plans(f13, rows, D, 2 * F, sms, swiglu=True)}
                rec["sweep_down"] = {
                    f"{n},{r}": device_ms([lambda v=v, p=(n, r): ffn.fused_ffn_at(
                        x, *v, gain, plans=(None, p)) for v in sets])
                    for n, r in plans(f2, rows, F, D, sms)}
            out.append(rec)
            print(json.dumps(rec), flush=True)
        del w13, w2, sets
        torch.cuda.empty_cache()
    print(json.dumps({"gemv_rows": out, "device": torch.cuda.get_device_name(0)}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
