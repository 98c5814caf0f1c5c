"""Kernel 2: fused SwiGLU FFN with residual, decode rows (csrc/ffn.cu).

Replaces tokenhawk_tpu/ops/pallas/ffn.py `fused_ffn` (_ffn_kernel):
y = x + (silu(xn @ W1) * (xn @ W3)) @ W2 with xn = rmsnorm(x) * g, for
B <= 8 rows over quantized w13 [D, 2F] and w2 [F, D], each Q4_0 or a
group-code form (G 16 / 32, with or without mins; ops/qweight.py), in any
pairing: the reference's gate lets "w13 and w2 differ in kind".  Bound by
the weight bytes on the H100.  The TPU kernel carries the W2 sums across a
sequential grid; GPU blocks cannot, so the kernel runs two phases (the
gate/up GEMV with a SiLU epilogue into an f32 scratch of B*F*4 bytes that
stays in L2, then the down GEMV with the residual in its epilogue).  The
[B, F] intermediate stays f32.

Tolerance against the plain version: f32 arithmetic in both, one final
rounding to x.dtype (2^-8 relative for bfloat16) plus summation order.
"""

from __future__ import annotations

import torch

from tokenhawk_tpu_torch.ops.cuda import build
from tokenhawk_tpu_torch.ops.cuda.qmatmul import FORM_NAMES, form_code, weight_args
from tokenhawk_tpu_torch.ops.qweight import QWeight

# Launches per (w13 form, w2 form) pairing, e.g. "ffn[g32m/g16]" for a
# Q4_K w13 (G 32, mins) over a Q6_K w2 (G 16, no mins).
launches = {f"ffn[{a}/{b}]": 0 for a in FORM_NAMES for b in FORM_NAMES}
MAX_ROWS = 8

# x; (qs, scales, mins, form) of w13 and of w2; gain, h, inv, y; B, D, F;
# eps; dtype; stream.
_ARGS = [build.P] + ([build.P] * 3 + [build.I]) * 2 + [build.P] * 4 + [build.I] * 3 + [
    build.F, build.I, build.P]


def fused_ffn_plain(x, w13: QWeight, w2: QWeight, norm_gain, eps: float = 1e-6):
    """The same function in plain PyTorch, f32 throughout."""
    xf = x.float()
    xn = xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps) * norm_gain.float()
    gu = xn @ w13.dequantize(torch.float32)
    F = gu.shape[-1] // 2
    h = torch.nn.functional.silu(gu[..., :F]) * gu[..., F:]
    return (xf + h @ w2.dequantize(torch.float32)).to(x.dtype)


def fused_ffn(x, w13: QWeight, w2: QWeight, norm_gain, eps: float = 1e-6):
    """x [..., D] -> x + SwiGLU-MLP(rms_norm(x) * gain); at most 8 rows."""
    if not x.is_cuda:
        return fused_ffn_plain(x, w13, w2, norm_gain, eps)
    D, F2 = w13.shape
    F, D2 = w2.shape
    build.require(x.shape[-1] == D and D2 == D and F2 == 2 * F,
                  f"x {tuple(x.shape)}, w13 {w13.shape}, w2 {w2.shape} do not chain")
    lead = x.shape[:-1]
    xb = x.reshape(-1, D).contiguous()
    B = xb.shape[0]
    build.require(1 <= B <= MAX_ROWS, f"fused_ffn takes 1..{MAX_ROWS} rows, got {B}")
    gain = norm_gain.to(xb.dtype).contiguous()
    build.require(gain.shape == (D,), f"gain {tuple(gain.shape)} != ({D},)")
    build.require_cuda(xb, gain)
    f13, f2 = form_code(w13), form_code(w2)
    code = build.dtype_code(xb.dtype)
    h = torch.empty((B, F), dtype=torch.float32, device=xb.device)
    inv = torch.empty((B,), dtype=torch.float32, device=xb.device)
    y = torch.empty_like(xb)
    fn = build.function("th_ffn", _ARGS)
    rc = fn(xb.data_ptr(), *weight_args(w13, xb), f13, *weight_args(w2, xb), f2, gain.data_ptr(),
            h.data_ptr(), inv.data_ptr(), y.data_ptr(), B, D, F, eps, code,
            build.stream_of(xb))
    build.check(rc, "fused_ffn")
    launches[f"ffn[{FORM_NAMES[f13]}/{FORM_NAMES[f2]}]"] += 1
    return y.reshape(*lead, D)
