"""Where a tensor-parallel decode token's host time goes at one rank, beside
the dense Engine's.

    python -m tokenhawk_tpu_torch.experiments.tp_decode_trace [--layers 8] [--tokens 32]

LLaMA-7B's widths in Q4_0 (random weights from a seed), its first --layers
layers at n_ctx 2048, bf16 KV, greedy, over a NCCL group of one rank on
cuda:0.  One 5-token request decoded in four forms, each form's decode
tok/s (Engine.generate's) over --repeats requests, in turns:

  dense          the dense Engine (kernel 2, the fused FFN, on its path);
  dense_unfused  the dense Engine with kernel 2 refused, so its FFN runs as
                 the TP path runs it (kernel 1's w13, SiLU * up, kernel
                 1's w2);
  tp_local       Engine(parallel="tp") over a mesh whose collectives are
                 the identity (exact at one rank): the TP graph without
                 NCCL;
  tp             Engine(parallel="tp").

So dense_unfused - dense is the unfused FFN's cost, tp_local -
dense_unfused the rest of the TP graph's (the embedding's vocabulary
mask, the logits' gather path, the local-head bookkeeping), and tp -
tp_local the collectives'.  Then each form under torch.profiler (CPU and
CUDA activities), a request of 1 new token and one of 1 + --tokens: their
difference over --tokens is one decode token's host ops (count and self
CPU us by name) and kernels.  The last line is one JSON object with every
number.  `--device cpu` runs a 2-layer, 256-wide model over gloo (a check
of the script, no measurement).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

from tokenhawk_tpu_torch.config import LlamaConfig, SamplingConfig
from tokenhawk_tpu_torch.models import llama
from tokenhawk_tpu_torch.models.llama import fuse_params, init_params
from tokenhawk_tpu_torch.parallel.mesh import TpMesh, make_mesh
from tokenhawk_tpu_torch.parallel.tp import shard_params_tp
from tokenhawk_tpu_torch.runtime.engine import Engine
from tokenhawk_tpu_torch.tokenizer import byte_fallback_vocab

SEED = 1234
FORMS = ("dense", "dense_unfused", "tp_local", "tp")


@dataclasses.dataclass(frozen=True)
class LocalMesh(TpMesh):
    """A one-rank model axis whose collectives are the identity."""

    def all_reduce(self, x):
        return x

    def all_gather_last(self, x):
        return x


class _FfnUnfused:
    """Within: models/llama.py refuses kernel 2, as it does under TP."""

    def __enter__(self):
        self.saved = llama.can_fuse_ffn
        llama.can_fuse_ffn = lambda *a, **k: False

    def __exit__(self, *exc):
        llama.can_fuse_ffn = self.saved


class _Nothing:
    def __enter__(self):
        pass

    def __exit__(self, *exc):
        pass


def _engines(cfg, device):
    g = torch.Generator(device=device)
    g.manual_seed(SEED)
    params = fuse_params(init_params(cfg, g, dtype=torch.bfloat16, device=device,
                                     quant="q4_0"))
    mesh = make_mesh()
    local = shard_params_tp(cfg, params, mesh)
    tok, greedy = byte_fallback_vocab(), SamplingConfig(temperature=0.0)
    kw = dict(sampling=greedy, eos_id=-1)
    dense = Engine(cfg, params, tok, **kw)
    return {"dense": (dense, _Nothing), "dense_unfused": (dense, _FfnUnfused),
            "tp_local": (Engine(cfg, local, tok, mesh=LocalMesh(mesh.group, 0, 1),
                                parallel="tp", **kw), _Nothing),
            "tp": (Engine(cfg, local, tok, mesh=mesh, parallel="tp", **kw), _Nothing)}


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize()


def _profiled(engine, within, prompt, n_new, device):
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
    _sync(device)
    with within(), profile(activities=acts) as prof:
        t0 = time.perf_counter()
        engine.generate(prompt, max_new_tokens=n_new)
        _sync(device)
        wall = time.perf_counter() - t0
    ops, kernels = {}, {}
    for e in prof.key_averages():
        dev_us = getattr(e, "self_device_time_total", 0.0)
        if e.self_cpu_time_total == 0 and dev_us > 0:
            kernels[e.key[:90]] = (e.count, dev_us)
        else:
            ops[e.key] = (e.count, e.self_cpu_time_total)
    return wall, ops, kernels


def _per_token(long, short, n):
    """{name: [count, us]} of one decode token: (long - short) / n."""
    out = {}
    for name in set(long) | set(short):
        c1, t1 = long.get(name, (0, 0.0))
        c0, t0 = short.get(name, (0, 0.0))
        out[name] = [(c1 - c0) / n, (t1 - t0) / n]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--layers", type=int, default=8)
    ap.add_argument("--tokens", type=int, default=32)
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("no CUDA device (pass --device cpu for a check of the script)")
        torch.cuda.set_device(0)
        cfg = LlamaConfig(n_embd=4096, n_head=32, n_layer=args.layers, n_ctx=2048)
        backend = "nccl"
    else:
        cfg = LlamaConfig(n_vocab=512, n_embd=256, n_head=4, n_layer=2, n_ctx=256, n_ff=512)
        backend = "gloo"
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group(backend, init_method=f"file://{os.path.join(tmp, 'store')}",
                                rank=0, world_size=1)
        try:
            result = _run(cfg, device, args)
        finally:
            dist.destroy_process_group()
    print(json.dumps(result))
    return 0


def _run(cfg, device, args) -> dict:
    engines = _engines(cfg, device)
    rng = np.random.default_rng(SEED)
    prompt = [1] + rng.integers(3, cfg.n_vocab, size=4).tolist()
    streams = {}
    for name in FORMS:  # warm every form (and check the streams agree)
        eng, within = engines[name]
        with within():
            streams[name] = eng.generate(prompt, max_new_tokens=args.tokens).tokens
    rates = {name: [] for name in FORMS}
    for _ in range(args.repeats):
        for name in FORMS:
            eng, within = engines[name]
            with within():
                r = eng.generate(prompt, max_new_tokens=args.tokens)
            rates[name].append(r.decode_tokens_per_second)
    ms = {name: 1e3 / float(np.median(v)) for name, v in rates.items()}
    print(f"decode ms a token (median of {args.repeats}): "
          + ", ".join(f"{n} {ms[n]:.3f}" for n in FORMS))
    print(f"  unfused FFN {ms['dense_unfused'] - ms['dense']:+.3f}, rest of the TP graph "
          f"{ms['tp_local'] - ms['dense_unfused']:+.3f}, collectives "
          f"{ms['tp'] - ms['tp_local']:+.3f}")
    traces = {}
    for name in FORMS:
        eng, within = engines[name]
        w1, ops1, k1 = _profiled(eng, within, prompt, 1, device)
        w2, ops2, k2 = _profiled(eng, within, prompt, 1 + args.tokens, device)
        ops, kernels = (_per_token(ops2, ops1, args.tokens), _per_token(k2, k1, args.tokens))
        traces[name] = {"profiled_ms_a_token": (w2 - w1) * 1e3 / args.tokens,
                        "host_ops": ops, "kernels": kernels,
                        "launches_a_token": sum(c for c, _ in kernels.values())}
        top = sorted(ops.items(), key=lambda kv: -kv[1][1])[:12]
        print(f"{name}: {traces[name]['profiled_ms_a_token']:.3f} ms a token under the profiler, "
              f"{traces[name]['launches_a_token']:.1f} kernels a token; top host ops "
              "(count, self CPU us a token):")
        for op, (c, us) in top:
            print(f"  {us:9.1f} us {c:7.1f}x  {op[:80]}")
    diff = {}
    for op in set(traces["tp"]["host_ops"]) | set(traces["dense"]["host_ops"]):
        c1, t1 = traces["tp"]["host_ops"].get(op, (0, 0.0))
        c0, t0 = traces["dense"]["host_ops"].get(op, (0, 0.0))
        diff[op] = [c1 - c0, t1 - t0]
    print("host ops a token, tp - dense (count, self CPU us), the largest:")
    for op, (c, us) in sorted(diff.items(), key=lambda kv: -abs(kv[1][1]))[:20]:
        print(f"  {us:+9.1f} us {c:+7.1f}x  {op[:80]}")
    return {"config": {"n_layer": cfg.n_layer, "n_embd": cfg.n_embd, "tokens": args.tokens,
                       "repeats": args.repeats, "device": str(device)},
            "streams_equal": {n: streams[n] == streams["dense"] for n in FORMS},
            "decode_tok_s": rates, "decode_ms_a_token": ms,
            "tp_minus_dense_host_ops": diff, "traces": traces}


if __name__ == "__main__":
    raise SystemExit(main())
