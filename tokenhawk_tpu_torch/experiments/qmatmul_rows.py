"""Time the quantized matmul (kernels 1, 13 and 17) from decode to prefill rows.

    python -m tokenhawk_tpu_torch.experiments.qmatmul_rows [--save FILE | --compare FILE]
        [--case TEXT]

For each case (LLaMA-7B's Q4_0 and Q8_0 wqkv 4096->12288 and Llama-3-8B's
Q4_K wqkv 4096->6144 and Q6_K head 4096->128256, the norm fused, as the
model calls them; the 7B's Q4_0 w2 11008->4096 without; Llama-3-8B's wqkv
in Q4_K super-blocks (kernel 17, THAWK_Q4K_SB=1's form) and in the flat
form of the same codes (kernel 13)) at 1, 8, 16, 40, 64 and 512 rows of
bfloat16 x: the device ms of one call (CUDA events
behind a device spin, weight copies spanning 3x the 50 MB L2), the launch
counter it ticked, the ms of dequantize + torch.matmul, and the bound
(the port's layout bytes at 3.35 TB/s, the operations at 989 TFLOP/s).
The weights and inputs come from a seed, so two trees of the port give
the same calls: run the script in each, in one process each, to put one
path's times beside the other's.  --save FILE writes the outputs of the
calls the GEMV keeps in either tree (1 and 8 rows of bfloat16 x, 40 rows
of float32 x) and --compare FILE holds them bit for bit against another
tree's.  --case TEXT keeps the cases whose name holds TEXT.  The last
line is one JSON object with every timing.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from tokenhawk_tpu_torch.ops.cuda import qmatmul
from tokenhawk_tpu_torch.ops.qweight import QWeight

SEED = 1234
ROWS = (1, 8, 16, 40, 64, 512)
# (name, K, N, form, norm): form "q4_0" or a QWeight.random form.
CASES = [("7B Q4_0 wqkv", 4096, 12288, "q4_0", True),
         ("7B Q8_0 wqkv", 4096, 12288, "q8_0", True),
         ("Llama-3-8B Q4_K wqkv", 4096, 6144, "q4_k", True),
         ("Llama-3-8B Q6_K head", 4096, 128256, "q6_k", True),
         ("7B Q4_0 w2", 11008, 4096, "q4_0", False),
         ("Llama-3-8B Q4_K sb wqkv", 4096, 6144, "q4k_sb", True),
         ("Llama-3-8B Q4_K sb wqkv, flat form", 4096, 6144, "q4k_sb flat", True)]
HBM_BPS, PEAK_FLOPS = 3.35e12, 989e12


def device_ms(fns, calls: int) -> float:
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


def weight(K, N, form, g, dev) -> QWeight:
    if form == "q4_0":
        return QWeight.quantize(torch.randn(K, N, generator=g, device=dev) * 0.02)
    if form.startswith("q4k_sb"):  # both super-block cases draw the same codes
        w = QWeight.random(K, N, "q4k_sb", torch.Generator(device=dev).manual_seed(SEED), dev)
        return w.flat() if form.endswith("flat") else w
    return QWeight.random(K, N, form, g, dev)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--save", help="write the GEMV-kept calls' outputs to this file")
    ap.add_argument("--compare", help="hold the GEMV-kept calls' outputs to this file's")
    ap.add_argument("--case", default="", help="only the cases whose name holds this text")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("qmatmul_rows: needs a CUDA device")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(SEED)
    saved, rows_out = {}, []
    for name, K, N, form, norm in CASES:
        if args.case not in name:
            continue
        w = weight(K, N, form, g, dev)
        n_copies = min(16, max(1, -(-150_000_000 // w.nbytes)))
        ws = [w] + [QWeight(*(t.clone() if isinstance(t, torch.Tensor) else t for t in (
            w.qs, w.scales, w.mins, w.kind, w.group, w.scmn))) for _ in range(n_copies - 1)]
        gain = (1.0 + 0.1 * torch.randn(K, generator=g, device=dev)).to(torch.bfloat16)
        ng = gain if norm else None
        for rows in ROWS:
            x = torch.randn(rows, K, generator=g, device=dev).to(torch.bfloat16)
            before = dict(qmatmul.launches)
            y = qmatmul.quant_matmul(x, w, ng)
            path = [k for k, v in qmatmul.launches.items() if v != before.get(k, 0)]
            if rows <= 8:
                saved[f"{name} rows={rows}"] = y.cpu()
            if rows == 40:
                saved[f"{name} rows=40 f32"] = qmatmul.quant_matmul(x.float(), w, ng).cpu()
            calls = 4 if rows * N >= 512 * 100_000 else 16 if rows >= 512 else 32
            ms = device_ms([lambda v=v: qmatmul.quant_matmul(x, v, ng) for v in ws], calls)
            lib = device_ms([lambda v=v: x @ v.dequantize(torch.bfloat16) for v in ws], calls)
            t_bytes = (w.nbytes + 2 * rows * (K + N)) / HBM_BPS * 1e3
            t_ops = 2 * rows * K * N / PEAK_FLOPS * 1e3
            rec = dict(case=name, rows=rows, path=path, ms=ms, library_ms=lib,
                       bound_ms=max(t_bytes, t_ops),
                       bound_by="bytes" if t_bytes >= t_ops else "operations")
            rows_out.append(rec)
            print(f"{name} rows={rows}: {ms:.4f} ms via {path}; dequantize + matmul "
                  f"{lib:.4f} ms; bound {rec['bound_ms']:.4f} ms ({rec['bound_by']})",
                  flush=True)
        del w, ws
        torch.cuda.empty_cache()
    if args.save:
        torch.save(saved, args.save)
    if args.compare:
        other = torch.load(args.compare)
        differ = [k for k in saved if not torch.equal(saved[k], other[k])]
        print(f"GEMV-kept outputs against {args.compare}: {len(saved) - len(differ)} of "
              f"{len(saved)} bit for bit; differ: {differ}")
        if differ:
            return 1
    print(json.dumps({"qmatmul_rows": rows_out}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
