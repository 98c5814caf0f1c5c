# Copy of tokenhawk_tpu/utils/timing.py (imports rewritten, upstream citations as bare
# file:line): importing tokenhawk_tpu imports jax, which the GPU machine lacks.
# tests/test_torch_host.py holds the copy equal to its original.
"""Latency instrumentation.

Feature parity with the reference's per-token timing harness
(`print_descriptive_stats` th.cpp:45-87 and the
50-token reporting cadence th-llama.cpp:709-717):
mean / median / mode / stddev / p99 / p95 / p5 / p1 over per-token
latencies, plus a `jax.profiler` hook for real traces.
"""

from __future__ import annotations

import sys
import time
from collections import Counter
from typing import Dict, List, Optional


def descriptive_stats(samples_ms: List[float]) -> Dict[str, float]:
    import numpy as np

    a = np.asarray(samples_ms, dtype=np.float64)
    if a.size == 0:
        return {}
    # Mode over 0.1 ms bins (the reference modes over exact doubles, which
    # is ill-defined for wall-clock floats; binning is the usable variant).
    binned = Counter(np.round(a, 1))
    mode = float(binned.most_common(1)[0][0])
    return {
        "count": int(a.size),
        "mean_ms": float(a.mean()),
        "median_ms": float(np.median(a)),
        "mode_ms": mode,
        "stddev_ms": float(a.std()),
        "p99_ms": float(np.percentile(a, 99)),
        "p95_ms": float(np.percentile(a, 95)),
        "p5_ms": float(np.percentile(a, 5)),
        "p1_ms": float(np.percentile(a, 1)),
    }


class TokenTimer:
    """Collects inter-token latencies; reports every `report_every` ticks."""

    def __init__(self, report_every: int = 50, auto_print: bool = False):
        self.report_every = report_every
        self.auto_print = auto_print
        self.samples_ms: List[float] = []
        self._last: Optional[float] = None

    def tick(self):
        now = time.perf_counter()
        if self._last is not None:
            self.samples_ms.append((now - self._last) * 1e3)
            if self.auto_print and len(self.samples_ms) % self.report_every == 0:
                self.print_stats()
        self._last = now

    def stats(self) -> Dict[str, float]:
        return descriptive_stats(self.samples_ms)

    def print_stats(self, file=None):
        s = self.stats()
        if not s:
            return
        file = file or sys.stderr
        print(
            "per-token latency: "
            f"mean {s['mean_ms']:.2f} ms | median {s['median_ms']:.2f} | "
            f"mode {s['mode_ms']:.1f} | sd {s['stddev_ms']:.2f} | "
            f"p99 {s['p99_ms']:.2f} | p95 {s['p95_ms']:.2f} | "
            f"p5 {s['p5_ms']:.2f} | p1 {s['p1_ms']:.2f} "
            f"(n={s['count']})",
            file=file,
        )
