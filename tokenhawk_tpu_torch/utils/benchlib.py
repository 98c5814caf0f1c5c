"""Device timing by differencing, and the HBM read-stream probe.

Counterpart of tokenhawk_tpu/utils/benchlib.py.  `measure_iter_seconds`
forces a host readback of a scalar derived from the result (`.item()`, in
place of block_until_ready) and cancels the fixed launch and transfer
overhead by differencing two iteration counts:

    T(n) = fixed_overhead + n * per_iter  =>  per_iter = (T(n2)-T(n1))/(n2-n1)

`hbm_stream_gbps` streams a bfloat16 array through kernel 20
(ops/cuda/stream.py), the reference's Pallas probe (_stream_sum_kernel),
whose plain version is `stream_sum_plain` here.
"""

from __future__ import annotations

import time
from typing import Callable

import torch


def stream_sum_plain(x: torch.Tensor, seed: torch.Tensor) -> torch.Tensor:
    """Kernel 20's function in plain PyTorch: seed + sum(x) in f32."""
    return seed + x.float().sum()


def _time_call(fn, args) -> float:
    t0 = time.perf_counter()
    # A scalar readback cannot complete before the work that produces it.
    fn(*args).float().sum().item()
    return time.perf_counter() - t0


def measure_iter_seconds(
    make_fn: Callable[[int], Callable],
    args,
    n_small: int = 16,
    n_large: int = 64,
    trials: int = 3,
    reduce: str = "min",
) -> float:
    """make_fn(n) returns a callable running n iterations and returning a
    tensor.

    reduce: "min" picks the cleanest trial (right for long-running model
    chunks where noise only adds time); "median" resists noise that makes
    t_large - t_small too small, which "min" would turn into an
    impossibly fast reading."""
    f_small = make_fn(n_small)
    f_large = make_fn(n_large)
    _time_call(f_small, args)  # warm up both
    _time_call(f_large, args)
    per_iters = []
    for _ in range(trials):
        t_small = _time_call(f_small, args)
        t_large = _time_call(f_large, args)
        per_iters.append((t_large - t_small) / (n_large - n_small))
    if reduce == "median":
        est = sorted(per_iters)[len(per_iters) // 2]
    else:
        est = min(per_iters)
    return max(est, 1e-9)


def hbm_stream_gbps(
    nbytes: int = 1 << 31,
    block_rows: int = 1024,
    trials: int = 5,
    device="cuda",
) -> float:
    """Independent HBM speed-of-light probe: read-stream bandwidth in GB/s.

    A roofline claim ("X% of HBM SoL") needs a yardstick that is not the
    model itself.  This reads `nbytes` of bfloat16 (rows of 1024, rounded
    down to a multiple of `block_rows` rows, the reference's array) once
    per pass through kernel 20, passes chained by their seed, n passes in
    a Python loop, and differences 4 and 24 passes with the median of
    `trials`, as the reference does.  The default 2 GiB is 40x the H100's
    50 MB L2, so every pass is paid in HBM.  On a CPU device it times the
    plain version: a host figure, never a device one.
    """
    from tokenhawk_tpu_torch.ops.cuda.stream import stream_sum

    cols = 1024
    rows = max(block_rows, int(nbytes) // (2 * cols) // block_rows * block_rows)
    x = torch.ones((rows, cols), dtype=torch.bfloat16, device=device)
    actual_bytes = rows * cols * 2

    def make_fn(n):
        def f(x):
            acc = torch.zeros((1, 1), dtype=torch.float32, device=x.device)
            for _ in range(n):
                acc = stream_sum(x, acc)
            return acc

        return f

    per_iter = measure_iter_seconds(make_fn, (x,), n_small=4, n_large=24, trials=trials,
                                    reduce="median")
    return actual_bytes / per_iter / 1e9
