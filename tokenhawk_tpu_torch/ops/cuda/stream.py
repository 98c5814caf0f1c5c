"""Kernel 20: the HBM read-stream probe (csrc/stream.cu).

Replaces tokenhawk_tpu/utils/benchlib.py `hbm_stream_gbps`
(_stream_sum_kernel): seed + the f32 sum of a bfloat16 array, one
sequential read of it.  The seed chains calls (each takes the previous
output), as the reference's fori_loop does, so no call can be skipped.
Two launches a call, counted once as `launches["stream_sum"]`: block
partials, then one block adding them to the seed.  The plain version is
utils/benchlib.py `stream_sum_plain`.

Tolerance against the plain version: f32 sums in another order, about
1e-7 of sum(|x|).
"""

from __future__ import annotations

import torch

from tokenhawk_tpu_torch.ops.cuda import build
from tokenhawk_tpu_torch.utils import benchlib

launches = {"stream_sum": 0}
THREADS = 256
BLOCKS_PER_SM = 8

# x, n, seed, partials, blocks, out, stream.
_ARGS = [build.P, build.LL, build.P, build.P, build.I, build.P, build.P]


def stream_sum(x: torch.Tensor, seed: torch.Tensor) -> torch.Tensor:
    """x bfloat16 (any shape, contiguous), seed a one-element f32 tensor ->
    seed + sum(x) in f32, shaped as seed."""
    if not x.is_cuda:
        return benchlib.stream_sum_plain(x, seed)
    build.require(x.dtype == torch.bfloat16, f"x must be bfloat16, got {x.dtype}")
    build.require(seed.dtype == torch.float32 and seed.numel() == 1,
                  "seed must be one float32 value")
    build.require_cuda(x, seed)
    n16 = x.numel() // 8
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    blocks = max(1, min(sms * BLOCKS_PER_SM, -(-n16 // THREADS)))
    partials = torch.empty(blocks, dtype=torch.float32, device=x.device)
    out = torch.empty_like(seed)
    fn = build.function("th_stream_sum", _ARGS)
    rc = fn(x.data_ptr(), x.numel(), seed.data_ptr(), partials.data_ptr(), blocks,
            out.data_ptr(), build.stream_of(x))
    build.check(rc, "stream_sum")
    launches["stream_sum"] += 1
    return out
