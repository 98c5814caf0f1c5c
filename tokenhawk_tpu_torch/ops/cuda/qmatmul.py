"""Kernels 1, 13 and 17: dequant-matmul with fused RMSNorm (csrc/qmatmul.cu).

One entry point takes every weight form (ops/qweight.py).  Over Q4_0 it
is kernel 1, which replaces tokenhawk_tpu/ops/pallas/qmatmul.py
`q4_matmul` (_q4_kernel) and `q4_matmul_i4` (_q4i4_kernel); over the
group-code kind (Q8_0, Q5_0, Q4_1, Q5_1, Q2_K..Q6_K) it is kernel 13,
which replaces `q8_matmul` (_q8_kernel) and `qk_matmul` (_qk_kernel);
over the Q4_K super-block kind (q4k_sb, THAWK_Q4K_SB=1) it is kernel 17,
which replaces `qk_sb_matmul` (_qk_sb_kernel): kernel 13's loop over
codes two a byte, the group's scale and bias expanded from sc / mn and
the super-block's d / dmin in registers.  Launches are counted per
kernel: `launches["q4_matmul"]`, `launches["qk_matmul"]` and
`launches["qk_sb_matmul"]`.  On the H100 the decode rows (B <= 8) are bound
by the weight bytes and the prefill rows by f32 FMA issue.  The kernel
reads a column's codes with 16-byte loads and converts them once for
every row of a row tile (gemv.cuh); the row statistics of the norm come
from a small pre-pass, so the norm is fused for every K.

Tolerance against the plain version: both accumulate in f32 and round
once to the output dtype; they differ by summation order (~1e-6 relative
in f32, of the terms, which for affine kinds includes the m * sum(x)
term) plus that one rounding (2^-8 relative for bfloat16).  Kernel 17
forms each group's s and b with the plain version's roundings.
"""

from __future__ import annotations

import torch

from tokenhawk_tpu_torch.ops.cuda import build
from tokenhawk_tpu_torch.ops.qweight import QWeight

launches = {"q4_matmul": 0, "qk_matmul": 0, "qk_sb_matmul": 0}

_ARGS = [build.P] * 8 + [build.I] * 4 + [build.F, build.I, build.P]

# Weight forms at the C boundary (csrc/gemv.cuh enum Form), by code.
FORM_NAMES = ("q4_0", "g32", "g32m", "g16", "g16m", "sb")
SB = FORM_NAMES.index("sb")
_FORMS = {("q4_0", 32, False): 0, ("qk", 32, False): 1, ("qk", 32, True): 2,
          ("qk", 16, False): 3, ("qk", 16, True): 4, ("q4k_sb", 32, True): SB}
# The launch counter of each form's kernel (the group codes': qk_matmul).
_KERNEL = {0: "q4_matmul", SB: "qk_sb_matmul"}


def form_code(w: QWeight, sb: bool = True) -> int:
    """The kernels' code for w's (kind, group, mins); checks the dtypes.
    With sb=False (kernels 15, 16 and kernel 2's w2, whose gates refuse
    it) the super-block form raises."""
    form = _FORMS.get((w.kind, w.group, w.mins is not None))
    build.require(form is not None, f"no kernel form for {w.kind} G {w.group} "
                                    f"{'with' if w.mins is not None else 'without'} mins")
    build.require(sb or form != SB, "this kernel takes no q4k_sb weight")
    code_dtype = torch.int8 if w.kind == "qk" else torch.uint8
    build.require(w.qs.dtype == code_dtype and w.scales.dtype == torch.float32
                  and (w.mins is None or w.mins.dtype == torch.float32)
                  and (form != SB or (w.scmn is not None and w.scmn.dtype == torch.uint8)),
                  f"QWeight {w.kind} must hold {code_dtype} codes and float32 sides")
    build.require(w.shape[0] % (256 if form == SB else 32) == 0,
                  f"K {w.shape[0]} must be a multiple of {256 if form == SB else 32}")
    return form


def weight_args(w: QWeight, x: torch.Tensor) -> list:
    """(qs, scales, mins, scmn) pointers of a weight checked to lie on x's GPU."""
    build.require_cuda(x, *w.tensors())
    return [w.qs.data_ptr(), w.scales.data_ptr(),
            *(t.data_ptr() if t is not None else None for t in (w.mins, w.scmn))]


def quant_matmul_plain(x: torch.Tensor, w: QWeight, norm_gain=None, eps: float = 1e-6):
    """The same function in plain PyTorch: f32 throughout, one rounding."""
    xf = x.float()
    if norm_gain is not None:
        xf = xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps) * norm_gain.float()
    return (xf @ w.dequantize(torch.float32)).to(x.dtype)


def quant_matmul(x: torch.Tensor, w: QWeight, norm_gain=None, eps: float = 1e-6):
    """x [..., K] @ W [K, N] -> [..., N] in x.dtype for a quantized W;
    rms_norm(x)*gain first when `norm_gain` is given."""
    if not x.is_cuda:
        return quant_matmul_plain(x, w, norm_gain, eps)
    form = form_code(w)
    K, N = w.shape
    build.require(x.shape[-1] == K, f"x {tuple(x.shape)} does not match W {w.shape}")
    xb = x.reshape(-1, K).contiguous()
    build.require(xb.shape[0] >= 1, "empty input")
    gain = None
    if norm_gain is not None:
        gain = norm_gain.to(xb.dtype).contiguous()
        build.require(gain.shape == (K,), f"gain {tuple(gain.shape)} != ({K},)")
    build.require_cuda(xb, *([] if gain is None else [gain]))
    y = torch.empty((xb.shape[0], N), dtype=xb.dtype, device=xb.device)
    inv = torch.empty((xb.shape[0],), dtype=torch.float32, device=xb.device)
    fn = build.function("th_quant_matmul", _ARGS)
    rc = fn(xb.data_ptr(), *weight_args(w, xb), gain.data_ptr() if gain is not None else None,
            y.data_ptr(), inv.data_ptr(), xb.shape[0], K, N, form, eps,
            build.dtype_code(xb.dtype), build.stream_of(xb))
    build.check(rc, "quant_matmul")
    launches[_KERNEL.get(form, "qk_matmul")] += 1
    return y.reshape(*x.shape[:-1], N)
