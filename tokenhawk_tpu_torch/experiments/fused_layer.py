"""Time kernels 15 and 16 (the fused decode-layer kernels) beside the unfused
port kernels they replace on the model's path.

    python -m tokenhawk_tpu_torch.experiments.fused_layer [--sweep] [--case TEXT]

At LLaMA-7B's widths (D 4096, F 11008, 32 heads of 128, n_ctx 512), Q4_0
and, where named, Q8_0: kernel 15 (`ffn.fused_owo_ffn`) at 1 and 8 rows
of bfloat16 x beside the path the model takes without it (kernel 1's Wo,
the add, kernel 2); kernel 16 (`flash_decode.fused_attn_out`) at B=1 over
1, 37 and 512 live rows beside its unfused path (q scaled, kernel 3,
kernel 1's Wo, the add).  For each: the error against the plain version
(2^-7 of the largest |reference|; kernel 16's written caches equal to the
plain version's), the device ms of one call back to back (`ms`) and alone
(`isolated_ms`), as `gemv_rows` times them (weights and caches copied to
span 3x the 50 MB L2), the unfused path's two the same way, the launch
counters the call ticked and the bound (GGUF bytes at 3.35 TB/s, the
operations at the card's 67 TFLOP/s of f32 FMAs).  With --sweep, in a tree
whose wrappers force them (`fused_owo_ffn_at`, `fused_attn_out_at`),
kernel 15 with each launch's plan at every plan of 1-4 K segments and 2-6
ring stages that fits (the other two at the rule's) and kernel 16 at 1,
2, 4, 8 and 16 splits and at Wo plans of 2, 3 and 4 stages.  Inputs come
from a seed, so two trees give the same calls: copy the script into a
`git archive` of another tree and run it there, in turns with this one.
The last line is one JSON object with every timing.
"""

from __future__ import annotations

import argparse
import json

import torch

from tokenhawk_tpu_torch.experiments.gemv_rows import (
    HBM_BPS,
    F32_FLOPS,
    check,
    copies,
    device_ms,
    gguf_bytes,
    isolated_ms,
    plans,
    weight,
)
from tokenhawk_tpu_torch.ops.cuda import ffn, qmatmul
from tokenhawk_tpu_torch.ops.cuda import flash_decode as fd

SEED = 1234
D, F, H, DH, S = 4096, 11008, 32, 128, 512
OWO = [("q4_0", 1), ("q4_0", 8), ("q8_0", 1)]
ATTN = [("q4_0", 1), ("q4_0", 37), ("q4_0", S), ("q8_0", S)]


def counted(run):
    """run() and the launch counters of kernels 1, 2, 3, 15 and 16 it ticked."""
    mods = (qmatmul, ffn, fd)
    before = [dict(m.launches) for m in mods]
    out = run()
    return out, {k: v - b.get(k, 0) for m, b in zip(mods, before)
                 for k, v in m.launches.items() if v != b.get(k, 0)}


def timings(fns, unfused) -> dict:
    return {"ms": device_ms(fns), "isolated_ms": isolated_ms(fns),
            "unfused_ms": device_ms(unfused), "unfused_isolated_ms": isolated_ms(unfused)}


def bound(nbytes: float, flops: float) -> dict:
    t_bytes, t_ops = nbytes / HBM_BPS * 1e3, flops / F32_FLOPS * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def owo_case(kind, rows, g, dev, sms, sweep) -> dict:
    shapes = ((D, D), (D, 2 * F), (F, D))
    ws = tuple(weight(k, n, kind, g, dev) for k, n in shapes)
    sets = copies(ws)
    gain = (1.0 + 0.1 * torch.randn(D, generator=g, device=dev)).to(torch.bfloat16)
    ctx, x = (torch.randn(rows, D, generator=g, device=dev).to(torch.bfloat16) for _ in range(2))
    name = f"kernel 15 {kind} rows={rows}"
    y, path = counted(lambda: ffn.fused_owo_ffn(ctx, x, *ws, gain))
    rec = dict(case=name, path=path,
               max_abs_err=check(name, y, ffn.fused_owo_ffn_plain(ctx, x, *ws, gain)),
               **timings([lambda s=s: ffn.fused_owo_ffn(ctx, x, *s, gain) for s in sets],
                         [lambda s=s: ffn.fused_ffn(x + qmatmul.quant_matmul(ctx, s[0]), s[1],
                                                    s[2], gain) for s in sets]),
               **bound(sum(gguf_bytes(kind, k, n) for k, n in shapes) + 2 * (3 * rows + 1) * D,
                       2 * rows * sum(k * n for k, n in shapes)))
    if sweep:
        form = qmatmul.form_code(ws[0])
        rec["rule"] = [p[:2] for p in ffn.owo_plans(rows, *ws, sms)]
        rec["sweep"] = {}
        for i, (K, N, swiglu) in enumerate(((D, D, False), (D, 2 * F, True), (F, D, False))):
            for p in plans(form, rows, K, N, sms, swiglu):
                forced = [None, None, None]
                forced[i] = p
                rec["sweep"][f"{'abc'[i]} {p[0]},{p[1]}"] = device_ms(
                    [lambda s=s, f=forced: ffn.fused_owo_ffn_at(ctx, x, *s, gain, plans=f)
                     for s in sets])
    return rec


def attn_case(kind, L, g, dev, sweep) -> dict:
    wo = weight(D, D, kind, g, dev)
    q, kn, vn = (torch.randn(1, 1, H, DH, generator=g, device=dev).to(torch.bfloat16)
                 for _ in range(3))
    x = torch.randn(1, 1, D, generator=g, device=dev).to(torch.bfloat16)
    kc, vc = (torch.randn(1, H, S, DH, generator=g, device=dev).to(torch.bfloat16)
              for _ in range(2))
    kp, vp = kc.clone(), vc.clone()
    lengths = torch.tensor([L], dtype=torch.int32, device=dev)
    name = f"kernel 16 {kind} L={L}"
    y, path = counted(lambda: fd.fused_attn_out(x, q, kn, vn, kc, vc, lengths, wo))
    err = check(name, y, fd.fused_attn_out_plain(x, q, kn, vn, kp, vp, lengths, wo))
    if not (torch.equal(kc, kp) and torch.equal(vc, vp)):
        raise AssertionError(f"{name}: the appended rows differ from the plain version's")
    sets = [(kc, vc, wo)] + [(kc.clone(), vc.clone(), w) for (w,) in copies((wo,))[1:]]
    qs = (q[:, 0] * DH**-0.5).reshape(1, H, 1, DH)
    rec = dict(case=name, path=path, max_abs_err=err,
               **timings([lambda s=s: fd.fused_attn_out(x, q, kn, vn, s[0], s[1], lengths, s[2])
                          for s in sets],
                         [lambda s=s: x + qmatmul.quant_matmul(fd.flash_decode_append(
                             (q[:, 0] * DH**-0.5).reshape(1, H, 1, DH), kn[:, 0], vn[:, 0],
                             s[0], s[1], lengths).reshape(1, 1, D), s[2]) for s in sets]),
               kernel_3_ms=device_ms([lambda s=s: fd.flash_decode_append(
                   qs, kn[:, 0], vn[:, 0], s[0], s[1], lengths) for s in sets]),
               kernel_1_wo_ms=device_ms([lambda s=s: qmatmul.quant_matmul(x[0], s[2])
                                         for s in sets]),
               **bound(gguf_bytes(kind, D, D) + 2 * (L + 1) * H * DH * 2 + 6 * D * 2,
                       2 * D * D + 4 * L * H * DH))
    if sweep:
        rec["sweep_splits"] = {sp: device_ms(
            [lambda s=s, sp=sp: fd.fused_attn_out_at(x, q, kn, vn, s[0], s[1], lengths, s[2], sp)
             for s in sets]) for sp in (1, 2, 4, 8, 16)}
        rule = fd.decode_splits(1, H, S, torch.cuda.get_device_properties(dev)
                                .multi_processor_count, fd.APPEND_MIN_TILES)
        rec["sweep_wo_stages"] = {st: device_ms(
            [lambda s=s, st=st: fd.fused_attn_out_at(x, q, kn, vn, s[0], s[1], lengths, s[2],
                                                     rule, plan=(1, st)) for s in sets])
            for st in (2, 3, 4)}
    return rec


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--sweep", action="store_true", help="time plans and split counts")
    ap.add_argument("--case", default="", help="only the cases whose name holds this text")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("fused_layer: needs a CUDA device")
    sweep = args.sweep and hasattr(ffn, "fused_owo_ffn_at") and hasattr(fd, "fused_attn_out_at")
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    g = torch.Generator(device=dev)
    g.manual_seed(SEED)
    out = []
    for kind, rows in OWO:
        if args.case in f"kernel 15 {kind} rows={rows}":
            out.append(owo_case(kind, rows, g, dev, sms, sweep))
            print(json.dumps(out[-1]), flush=True)
            torch.cuda.empty_cache()
    for kind, L in ATTN:
        if args.case in f"kernel 16 {kind} L={L}":
            out.append(attn_case(kind, L, g, dev, sweep))
            print(json.dumps(out[-1]), flush=True)
            torch.cuda.empty_cache()
    print(json.dumps({"fused_layer": out, "device": torch.cuda.get_device_name(0)}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
