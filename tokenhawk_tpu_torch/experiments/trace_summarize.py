"""Summarize a torch.profiler chrome trace: CUDA kernel time per token by family.

    python -m tokenhawk_tpu_torch.experiments.trace_summarize <trace_dir> [tokens_in_trace]

Counterpart of experiments/trace_summarize.py, which reads jax.profiler's
traces.  trace_dir is the directory given to utils/profiling.trace()
(`bench --trace DIR`); the script reads its trace.json.  Families: each
of the port's kernels by its function name in csrc/ (template arguments
dropped), and "cublas" (GEMM / GEMV kernels of cuBLAS and CUTLASS),
"elementwise" (PyTorch's elementwise, reduction, index and copy
kernels), "nccl" and "memcpy/memset"; anything else by its own name.
Below the table: the kernels' summed time, and the device's busy time
(the union of its kernel and copy intervals) against the window the
trace spans.  Raw traces are not committed; commit the printed table.
"""

from __future__ import annotations

import collections
import json
import re
import sys
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def port_kernels(csrc: Path = CSRC) -> set:
    """Names of the __global__ functions under csrc/."""
    names = set()
    for p in sorted(csrc.glob("*.cu*")):
        text = re.sub(r"__launch_bounds__\s*\([^)]*\)", "", p.read_text())
        names.update(re.findall(r"__global__\s+(?:static\s+)?void\s+(\w+)\s*[<(]", text))
    return names


def base_name(name: str) -> str:
    """A kernel's function name without return type, namespace, template
    arguments or parameters."""
    head = re.split(r"[<(]", re.sub(r"^void\s+", "", name).replace("(anonymous namespace)::", ""))[0]
    return head.split("::")[-1].strip()


def family(name: str, ours: set) -> str:
    base = base_name(name)
    low = name.lower()
    if base in ours:
        return base
    if "nccl" in low:
        return "nccl"
    if any(w in low for w in ("gemm", "gemv", "cublas", "cutlass", "xmma")):
        return "cublas"
    if any(w in low for w in ("elementwise", "reduce", "index", "copy", "fill", "scatter",
                              "gather", "cat", "softmax", "arange")):
        return "elementwise"
    return base or name[:64]


def summarize(events: list, tokens: int = 1, ours: set | None = None) -> dict:
    """ms per token by family, launches per family, the busy and window
    ms, from a chrome trace's traceEvents."""
    ours = port_kernels() if ours is None else ours
    fam = collections.defaultdict(float)
    cnt = collections.Counter()
    spans = []
    t_lo, t_hi = float("inf"), float("-inf")
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        t0, dur = float(e["ts"]), float(e["dur"])
        t_lo, t_hi = min(t_lo, t0), max(t_hi, t0 + dur)
        cat = e.get("cat", "")
        if cat not in DEVICE_CATS:
            continue
        spans.append((t0, t0 + dur))
        name = "memcpy/memset" if cat != "kernel" else family(e.get("name", ""), ours)
        fam[name] += dur
        cnt[name] += 1
    busy, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            busy += b - max(a, end)
            end = b
    window = max(t_hi - t_lo, 0.0)
    return {"ms_per_tok": {k: v / 1e3 / tokens for k, v in fam.items()},
            "launches": dict(cnt), "busy_ms": busy / 1e3, "window_ms": window / 1e3}


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    d = Path(argv[0])
    tok = int(argv[1]) if len(argv) > 1 else 1
    paths = sorted(d.glob("*.json"))
    if not paths:
        print(f"no trace under {d}", file=sys.stderr)
        return 1
    s = summarize(json.loads(paths[0].read_text())["traceEvents"], tok)
    total = sum(s["ms_per_tok"].values())
    print(f"device kernel time: {total:.3f} ms/tok ({tok} tokens)")
    agg = 0.0
    for n, ms in sorted(s["ms_per_tok"].items(), key=lambda kv: -kv[1]):
        if ms < 0.0005:
            continue
        agg += ms
        print(f"{ms:9.4f} ms/tok  x{s['launches'][n] // max(tok, 1):5d}/tok  {n[:64]}")
    print(f"---- op sum {agg:.3f} ms/tok")
    idle = 1 - s["busy_ms"] / s["window_ms"] if s["window_ms"] else 0.0
    print(f"---- busy {s['busy_ms']:.3f} ms of a {s['window_ms']:.3f} ms window "
          f"(idle {idle * 100:.1f}%)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
