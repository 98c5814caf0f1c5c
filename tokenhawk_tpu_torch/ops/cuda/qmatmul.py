"""Kernel 1: Q4_0 dequant-matmul with fused RMSNorm (csrc/qmatmul.cu).

Replaces tokenhawk_tpu/ops/pallas/qmatmul.py `q4_matmul` (_q4_kernel)
and `q4_matmul_i4` (_q4i4_kernel).  On the H100 the decode rows (B <= 8)
are bound by the weight bytes (0.5 B per weight + 4 B of scale per 32)
and the prefill rows by f32 FMA issue.  The kernel reads each weight
group with one 16-byte load and decodes its 32 codes once for every row
of a row tile (q4.cuh); the row statistics of the norm come from a small
pre-pass, so the norm is fused for every K, 11008 included.

Tolerance against the plain version: both accumulate in f32 and round
once to the output dtype; they differ by summation order (~1e-6 relative
in f32) plus that one rounding (2^-8 relative for bfloat16).
"""

from __future__ import annotations

import torch

from tokenhawk_tpu_torch.ops.cuda import build
from tokenhawk_tpu_torch.ops.qweight import QWeight

launches = 0

_ARGS = [build.P] * 6 + [build.I] * 3 + [build.F, build.I, build.P]


def require_q4(*ws: QWeight) -> None:
    """The kernels read uint8 codes and float32 scales (ops/qweight.py)."""
    for w in ws:
        build.require(w.qs.dtype == torch.uint8 and w.scales.dtype == torch.float32,
                      "QWeight must hold uint8 codes and float32 scales")


def q4_matmul_plain(x: torch.Tensor, w: QWeight, norm_gain=None, eps: float = 1e-6):
    """The same function in plain PyTorch: f32 throughout, one rounding."""
    xf = x.float()
    if norm_gain is not None:
        xf = xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps) * norm_gain.float()
    return (xf @ w.dequantize(torch.float32)).to(x.dtype)


def q4_matmul(x: torch.Tensor, w: QWeight, norm_gain=None, eps: float = 1e-6):
    """x [..., K] @ W [K, N] -> [..., N] in x.dtype; rms_norm(x)*gain first
    when `norm_gain` is given."""
    global launches
    if not x.is_cuda:
        return q4_matmul_plain(x, w, norm_gain, eps)
    K, N = w.shape
    build.require(x.shape[-1] == K, f"x {tuple(x.shape)} does not match W {w.shape}")
    lead = x.shape[:-1]
    xb = x.reshape(-1, K).contiguous()
    B = xb.shape[0]
    build.require(B >= 1, "empty input")
    code = build.dtype_code(xb.dtype)
    tensors = [xb, w.qs, w.scales]
    gain = None
    if norm_gain is not None:
        gain = norm_gain.to(xb.dtype).contiguous()
        build.require(gain.shape == (K,), f"gain {tuple(gain.shape)} != ({K},)")
        tensors.append(gain)
    build.require_cuda(*tensors)
    require_q4(w)
    y = torch.empty((B, N), dtype=xb.dtype, device=xb.device)
    inv = torch.empty((B,), dtype=torch.float32, device=xb.device)
    fn = build.function("th_q4_matmul", _ARGS)
    rc = fn(xb.data_ptr(), w.qs.data_ptr(), w.scales.data_ptr(),
            gain.data_ptr() if gain is not None else None, y.data_ptr(), inv.data_ptr(),
            B, K, N, eps, code, build.stream_of(xb))
    build.check(rc, "q4_matmul")
    launches += 1
    return y.reshape(*lead, N)
