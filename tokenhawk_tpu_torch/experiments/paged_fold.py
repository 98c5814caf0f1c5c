"""Time a paged decode layer's append and attention: kernel 5 with kernel
6 folded in, and kernel 10 with kernel 11, beside the two launches each
replaces; with --serve, the paged server's decode on them.

    python -m tokenhawk_tpu_torch.experiments.paged_fold [--serve]

Kernel cases, at LLaMA-7B's heads (32 KV heads of 128, one query each) and
TinyLlama's (4 of 64, 8 queries each), over a 140-page pool of 128-row
pages (contig) at the paged server's 8 slots, lengths 1-2048, each
sequence appending its newest row at lengths - 1 as a decode step does:
bf16 pages and int8 pages.  For each, the device ms of a call back to back
(`ms`: CUDA events behind a device spin, the pool copied to span 3x the
50 MB L2) and alone (`isolated_ms`: the device idle before it, as in an
eager decode step whose host is slower than its kernels) of:
  - `fold`: the folded call (paged_decode_append, paged_decode_int8_append),
    where the tree has it;
  - `two`: the two launches (kernel 6 then kernel 5 over lengths rows, or
    kernel 11 then kernel 10), the parent tree's decode layer's kernels;
  - `layer` / `parent_layer`: the decode layer's op as the model calls it
    (runtime/paged.py append_attend_paged_layer[_int8], where the tree has
    it) and the two it replaces (append_token_layer[_int8] then
    attend_paged_layer[_int8] over lengths + 1), host work included;
with the folded call's output and pools checked bit for bit against the
two launches'.  With --serve, chip_smoke.py's phases 4b (bf16 pages, 32
layers) and 4bi (int8 pages, its first 8 layers) on LLaMA-7B Q4_0 widths,
run through the tree's own chip_smoke.py: decode tok/s and the idle share
of the profiled decode window, read from their log lines.  Inputs come
from a seed: copy the script into a `git archive` of another tree and run
it there, in turns with this one.  The last line is one JSON object.
"""

from __future__ import annotations

import argparse
import json
import re
import sys
from pathlib import Path

import torch

from tokenhawk_tpu_torch.experiments.gemv_rows import device_ms, isolated_ms
from tokenhawk_tpu_torch.ops.cuda import paged_decode, paged_int8
from tokenhawk_tpu_torch.ops.kvquant import quantize_kv_block
from tokenhawk_tpu_torch.runtime import paged

SEED = 1234
PS, POOL = 128, 140
SLOTS = [1, 37, 128, 129, 300, 700, 1500, 2048]
CASES = [("7B 8 slots ragged", 32, 1, 128), ("TinyLlama 8 slots ragged", 4, 8, 64)]


def timings(fns) -> dict:
    return {"ms": device_ms(fns), "isolated_ms": isolated_ms(fns)}


def pools(shape, int8: bool, g, dev) -> list:
    """One layer's K and V pools (int8: codes and scales of each)."""
    if not int8:
        return [torch.randn(shape, generator=g, device=dev).bfloat16() for _ in range(2)]
    out = []
    for _ in range(2):
        codes, scales = quantize_kv_block(torch.randn(shape, generator=g, device=dev))
        out += [codes, scales.float()]
    return out


def case(name, Hkv, rep, Dh, int8: bool, g, dev) -> dict:
    B, mp = len(SLOTS), max(SLOTS) // PS
    lengths = torch.tensor(SLOTS, dtype=torch.int32, device=dev)
    stored = lengths - 1
    table = torch.randperm(POOL, generator=g, device=dev)[:B * mp].reshape(B, mp).int()
    q = (torch.randn(B, Hkv, rep, Dh, generator=g, device=dev) / Dh**0.5).bfloat16()
    kn, vn = (torch.randn(B, Hkv, Dh, generator=g, device=dev).bfloat16() for _ in range(2))
    base = pools((POOL, Hkv, PS, Dh), int8, g, dev)
    nbytes = sum(x.nbytes for x in base)
    sets = [base] + [[x.clone() for x in base]
                     for _ in range(min(16, max(1, -(-150_000_000 // nbytes))) - 1)]
    pos = stored.long()
    page = table.gather(1, (pos // PS)[:, None])[:, 0].contiguous()
    slot = (pos % PS).int()
    q4 = q.reshape(B, 1, Hkv * rep, Dh) * Dh**0.5  # the layer ops scale it back
    if int8:
        def two(p):
            paged_int8.paged_append_int8(*p, kn, vn, page, slot, "contig")
            return paged_int8.paged_decode_int8(q, *p, table, lengths, "contig")

        def parent_layer(p):
            paged.append_token_layer_int8(*p, kn, vn, table, stored, "contig")
            return paged.attend_paged_layer_int8(q4, *p, table, stored + 1, "contig")

        fold = getattr(paged_int8, "paged_decode_int8_append", None)
        layer = getattr(paged, "append_attend_paged_layer_int8", None)
    else:
        def two(p):
            paged_decode.paged_append(*p, kn, vn, page, slot, "contig")
            return paged_decode.paged_decode(q, *p, table, lengths, "contig")

        def parent_layer(p):
            paged.append_token_layer(*p, kn, vn, table, stored, "contig")
            return paged.attend_paged_layer(q4, *p, table, stored + 1, "contig")

        fold = getattr(paged_decode, "paged_decode_append", None)
        layer = getattr(paged, "append_attend_paged_layer", None)
    rec = {"name": f"{name} {'int8' if int8 else 'bf16'} pages", "Hkv": Hkv, "rep": rep,
           "Dh": Dh, "lengths": SLOTS,
           "two": timings([lambda p=p: two(p) for p in sets]),
           "parent_layer": timings([lambda p=p: parent_layer(p) for p in sets])}
    if fold is not None:
        a, b = [x.clone() for x in base], [x.clone() for x in base]
        got, want = fold(q, *a, kn, vn, table, stored, "contig"), two(b)
        if not (torch.equal(got, want) and all(map(torch.equal, a, b))):
            raise AssertionError(f"{rec['name']}: the folded call is not the two launches'")
        rec["fold"] = timings([lambda p=p: fold(q, *p, kn, vn, table, stored, "contig")
                               for p in sets])
        rec["layer"] = timings([lambda p=p: layer(q4, *p, kn, vn, table, stored, "contig")
                                for p in sets])
    return rec


def serve() -> dict:
    """Phases 4b and 4bi through the tree's chip_smoke.py: decode tok/s and
    the profiled window's idle share of each, from their log lines."""
    import dataclasses

    root = Path(__file__).resolve().parents[2]
    sys.path.insert(0, str(root))
    import chip_smoke as cs

    lines = []
    log = cs.log

    def keep(msg: str = "") -> None:
        lines.append(msg)
        log(msg)

    cs.log = keep
    cs.phase_env()
    dev = torch.device("cuda")
    cfg = dataclasses.replace(cs._seven_b(32), n_ctx=2048)
    params = cs._params(cfg, dev)
    mods = [paged_decode, paged_int8]
    out = {}
    for key, kv, n_layer in (("4b", "bf16", cfg.n_layer), ("4bi", "int8", cs.INT8_LAYERS)):
        c = dataclasses.replace(cfg, n_layer=n_layer)
        p = dataclasses.replace(params, layers=params.layers[:n_layer])
        start = len(lines)
        counts, sched = cs.phase_paged_serve(p, c, mods, kv, [], [], f"phase {key}: {kv} pages")
        text = "\n".join(lines[start:])
        out[key] = {
            "decode_tok_s": float(re.search(r"decode \d+ chunks, [\d.]+ s, ([\d.]+) tok/s",
                                            text).group(1)),
            "idle_share": float(re.search(r"idle share ([\d.]+)%", text).group(1)) / 100,
            "launches": {k: v for k, v in counts.items() if "paged" in k},
        }
        sched.cache = None
        del sched
        torch.cuda.empty_cache()
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--serve", action="store_true", help="also run phases 4b and 4bi")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("paged_fold: needs a CUDA device")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(SEED)
    out = []
    for int8 in (False, True):
        for name, *heads in CASES:
            out.append(case(name, *heads, int8, g, dev))
            print(json.dumps(out[-1]), flush=True)
            torch.cuda.empty_cache()
    rec = {"paged_fold": out, "device": torch.cuda.get_device_name(0)}
    if args.serve:
        rec["serve"] = serve()
    print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
