"""Time kernels 8 and 10 (decode attention over int8 K/V: the dense cache
with its quantizing append, and the paged pool) beside kernels 3 and 5
(the same over bfloat16 K/V) at the same shapes.

    python -m tokenhawk_tpu_torch.experiments.decode_rows [--sweep] [--case TEXT]

Each case runs at LLaMA-7B's heads (32 KV heads of 128, one query each)
unless it names TinyLlama's (4 KV heads of 64, 8 queries each): kernel 8
over a dense int8 cache of 2048 rows (the int8 Engine's n_ctx) at B=1 and
37, 300, 512 and 2048 live rows, and B=5 at lengths 1, 37, 300, 2048 and
0; kernel 10 over a 140-page pool of 128-row pages (contig, and head where
named) at the paged server's 8 slots, lengths 1-2048 or all 2048, and at
B=1.  For each: the error against the plain version (2^-7 of the largest
|reference|; the appended codes and scales equal to the plain version's),
the device ms of one call back to back (`ms`: CUDA events behind a device
spin, caches or pools copied to span 3x the 50 MB L2) and alone
(`isolated_ms`: the device idle before it, as in an eager decode step
whose host is slower than its kernels), the launch counters it ticked, its
bound (the live codes and scales, q, the new rows and the output at 3.35
TB/s), and kernel 3 or 5 on bfloat16 K/V of the same shape, timed the same
way (kernel 3 takes a length of 0 as 1); and back to back the plain
version (`plain_ms`) and one PyTorch computation of the same attention
(`library_ms`, as chip_smoke.py times it: dequantize the live rows +
scaled_dot_product_attention at B=1 for kernel 8; gather the table's pages,
dequantize, scaled_dot_product_attention under a length mask for kernel
10; None for kernel 8 above one sequence).  With --sweep, in a tree whose
wrappers force the split count (`flash_decode_int8_at`,
`paged_decode_int8_at`), each case also at 1, 2, 4, 8 and 16 splits with
ranges of at least 1 tile, and at the rule's count with floors of 1, 2
and 4 tiles.  Inputs come from a seed, so two trees give the same calls:
copy the script into a `git archive` of another tree and run it there, in
turns with this one.  The last line is one JSON object with every timing.
"""

from __future__ import annotations

import argparse
import json

import torch
import torch.nn.functional as tf

from tokenhawk_tpu_torch.experiments.gemv_rows import check, device_ms, isolated_ms
from tokenhawk_tpu_torch.ops.cuda import build, kv_int8, paged_decode, paged_int8
from tokenhawk_tpu_torch.ops.cuda import flash_decode as fd
from tokenhawk_tpu_torch.ops.kvquant import quantize_kv_block

SEED = 1234
HBM_BPS = 3.35e12
S_INT8, PS, POOL = 2048, 128, 140
SLOTS = [1, 37, 128, 129, 300, 700, 1500, 2048]
# Kernel 8: (name, Hkv, rep, Dh, lengths); kernel 10: (name, Hkv, rep, Dh,
# lengths, layout).
DENSE = [("7B B=1 L=37", 32, 1, 128, [37]),
         ("7B B=1 L=300", 32, 1, 128, [300]),
         ("7B B=1 L=512", 32, 1, 128, [512]),
         ("7B B=1 L=2048", 32, 1, 128, [2048]),
         ("7B B=5 ragged", 32, 1, 128, [1, 37, 300, 2048, 0]),
         ("TinyLlama B=1 L=2048", 4, 8, 64, [2048])]
PAGED = [("7B 8 slots ragged contig", 32, 1, 128, SLOTS, "contig"),
         ("7B 8 slots ragged head", 32, 1, 128, SLOTS, "head"),
         ("7B 8 slots x 2048 contig", 32, 1, 128, [2048] * 8, "contig"),
         ("7B B=1 L=512 contig", 32, 1, 128, [512], "contig"),
         ("7B B=1 L=2048 contig", 32, 1, 128, [2048], "contig"),
         ("TinyLlama 8 slots ragged contig", 4, 8, 64, SLOTS, "contig")]
SWEEP = (1, 2, 4, 8, 16)
FLOORS = (1, 2, 4)


def copies(tensors) -> list:
    """tensors and clones enough to span 3x the L2."""
    nbytes = sum(x.nbytes for x in tensors)
    n = min(16, max(1, -(-150_000_000 // nbytes)))
    return [list(tensors)] + [[x.clone() for x in tensors] for _ in range(n - 1)]


def counted(mod, run):
    """run() and the launch counters of `mod` it ticked."""
    before = dict(mod.launches)
    out = run()
    return out, [k for k, v in mod.launches.items() if v != before.get(k, 0)]


def timings(fns) -> dict:
    return {"ms": device_ms(fns), "isolated_ms": isolated_ms(fns)}


def bound_ms(nbytes: float) -> float:
    return nbytes / HBM_BPS * 1e3


def deq(codes, scales):
    """int8 codes times their row scales, in bfloat16 (the library calls')."""
    return codes.to(torch.bfloat16) * scales[..., None].to(torch.bfloat16)


def dense_case(name, Hkv, rep, Dh, lens, g, dev, sweep) -> dict:
    B = len(lens)
    lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
    q = (torch.randn(B, Hkv, rep, Dh, generator=g, device=dev) / Dh**0.5).bfloat16()
    kn = torch.randn(B, Hkv, Dh, generator=g, device=dev).bfloat16()
    vn = torch.randn(B, Hkv, Dh, generator=g, device=dev).bfloat16()
    kf = torch.randn(B, Hkv, S_INT8, Dh, generator=g, device=dev)
    vf = torch.randn(B, Hkv, S_INT8, Dh, generator=g, device=dev)
    cache = [*quantize_kv_block(kf), *quantize_kv_block(vf)]
    plain = [x.clone() for x in cache]
    out, path = counted(kv_int8, lambda: kv_int8.flash_decode_int8(q, kn, vn, *cache, lengths))
    ref = kv_int8.flash_decode_int8_plain(q, kn, vn, *plain, lengths)
    if not all(torch.equal(a, b) for a, b in zip(cache, plain)):
        raise AssertionError(f"{name}: the appended rows differ from the plain version's")
    live = sum(min(n, S_INT8) for n in lens if n > 0)
    io = B * Hkv * (2 * rep * Dh * 2 + 2 * Dh * 2 + 2 * (Dh + 2)) + 4 * B
    sets = copies(cache)
    rec = dict(case=name, kernel=8, path=path, max_abs_err=check(name, out, ref),
               **timings([lambda c=c: kv_int8.flash_decode_int8(q, kn, vn, *c, lengths)
                          for c in sets]),
               bound_ms=bound_ms(2 * live * Hkv * (Dh + 2) + io),
               plain_ms=device_ms([lambda c=c: kv_int8.flash_decode_int8_plain(
                   q, kn, vn, *c, lengths) for c in sets]), library_ms=None)
    if B == 1:
        L = lens[0]
        rec["library_ms"] = device_ms([lambda c=c: tf.scaled_dot_product_attention(
            q, deq(c[0][:, :, :L], c[1][:, :, :L]), deq(c[2][:, :, :L], c[3][:, :, :L]),
            scale=1.0) for c in sets])
    if sweep:
        splits = kv_int8.decode_int8_splits(B, Hkv, S_INT8, build.sm_count(dev))
        rec["rule"] = splits
        rec["sweep"] = {n: device_ms([lambda c=c, n=n: kv_int8.flash_decode_int8_at(
            q, kn, vn, *c, lengths, n, 1) for c in sets]) for n in SWEEP}
        rec["floors"] = {m: device_ms([lambda c=c, m=m: kv_int8.flash_decode_int8_at(
            q, kn, vn, *c, lengths, splits, m) for c in sets]) for m in FLOORS}
    del sets
    bf = copies([kf.bfloat16(), vf.bfloat16()])
    rec["kernel_3"] = timings([lambda c=c: fd.flash_decode_append(q, kn, vn, *c, lengths)
                               for c in bf])
    rec["kernel_3"]["bound_ms"] = bound_ms(2 * live * Hkv * Dh * 2 + io)
    return rec


def paged_case(name, Hkv, rep, Dh, lens, layout, g, dev, sweep) -> dict:
    B, mp = len(lens), 2048 // PS
    lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
    perm = torch.randperm(POOL, generator=g, device=dev)
    table = perm[:B * mp].reshape(B, mp).to(torch.int32).contiguous()
    shape = (POOL, Hkv, PS, Dh) if layout == "contig" else (Hkv, POOL, PS, Dh)
    kf = torch.randn(shape, generator=g, device=dev)
    vf = torch.randn(shape, generator=g, device=dev)
    pool = []
    for x in (kf, vf):
        codes, scales = quantize_kv_block(x)
        pool += [codes, scales.float()]
    q = (torch.randn(B, Hkv, rep, Dh, generator=g, device=dev) / Dh**0.5).bfloat16()
    out, path = counted(paged_int8, lambda: paged_int8.paged_decode_int8(
        q, *pool, table, lengths, layout))
    ref = paged_int8.paged_decode_int8_plain(q, *pool, table, lengths, layout)
    live = sum(lens)
    io = 2 * B * Hkv * rep * Dh * 2 + B * (mp + 1) * 4
    rec = dict(case=name, kernel=10, path=path, max_abs_err=check(name, out, ref),
               **timings([lambda: paged_int8.paged_decode_int8(q, *pool, table, lengths,
                                                               layout)]),
               bound_ms=bound_ms(2 * live * Hkv * (Dh + 4) + io),
               plain_ms=device_ms([lambda: paged_int8.paged_decode_int8_plain(
                   q, *pool, table, lengths, layout)]))
    tl_ = table.long()
    mask = (torch.arange(mp * PS, device=dev)[None, :] < lengths[:, None])[:, None, None, :]

    def dense(c, s):
        x = deq(c[tl_], s[tl_]) if layout == "contig" else deq(c[:, tl_], s[:, tl_])
        x = x.transpose(1, 2) if layout == "contig" else x.permute(1, 0, 2, 3, 4)
        return x.reshape(B, Hkv, mp * PS, Dh)

    kp, ksp, vp, vsp = pool
    rec["library_ms"] = device_ms([lambda: tf.scaled_dot_product_attention(
        q, dense(kp, ksp), dense(vp, vsp), attn_mask=mask, scale=1.0)])
    kb, vb = kf.bfloat16(), vf.bfloat16()
    rec["kernel_5"] = timings([lambda: paged_decode.paged_decode(q, kb, vb, table, lengths,
                                                                 layout)])
    rec["kernel_5"]["bound_ms"] = bound_ms(2 * live * Hkv * Dh * 2 + io)
    if sweep:
        splits = paged_int8.paged_int8_splits(B, Hkv, mp * PS, build.sm_count(dev))
        rec["rule"] = splits
        rec["sweep"] = {n: device_ms([lambda n=n: paged_int8.paged_decode_int8_at(
            q, *pool, table, lengths, layout, n, 1)]) for n in SWEEP}
        rec["floors"] = {m: device_ms([lambda m=m: paged_int8.paged_decode_int8_at(
            q, *pool, table, lengths, layout, splits, m)]) for m in FLOORS}
    return rec


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--sweep", action="store_true", help="time split counts and floors")
    ap.add_argument("--case", default="", help="only the cases whose name holds this text")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("decode_rows: needs a CUDA device")
    sweep = (args.sweep and hasattr(kv_int8, "flash_decode_int8_at")
             and hasattr(paged_int8, "paged_decode_int8_at"))
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(SEED)
    out = []
    for name, *shape in DENSE:
        if args.case in name:
            out.append(dense_case(name, *shape, g, dev, sweep))
            print(json.dumps(out[-1]), flush=True)
            torch.cuda.empty_cache()
    for name, *shape in PAGED:
        if args.case in name:
            out.append(paged_case(name, *shape, g, dev, sweep))
            print(json.dumps(out[-1]), flush=True)
            torch.cuda.empty_cache()
    print(json.dumps({"decode_rows": out, "device": torch.cuda.get_device_name(0)}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
