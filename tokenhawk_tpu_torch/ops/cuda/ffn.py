"""Kernel 2: fused SwiGLU FFN with residual, decode rows (csrc/ffn.cu).

Replaces tokenhawk_tpu/ops/pallas/ffn.py `fused_ffn` (_ffn_kernel):
y = x + (silu(xn @ W1) * (xn @ W3)) @ W2 with xn = rmsnorm(x) * g, for
B <= 8 rows over quantized w13 [D, 2F] and w2 [F, D], each Q4_0 or a
group-code form (G 16 / 32, with or without mins; ops/qweight.py), in any
pairing: the reference's gate lets "w13 and w2 differ in kind".  w13 may
also be a Q4_K super-block weight (q4k_sb, kernel 17's reader), w2 not,
as the reference's `can_fuse_ffn` has it (`can_fuse_ffn` here).  Bound by
the weight bytes on the H100.  The TPU kernel carries the W2 sums across a
sequential grid; GPU blocks cannot, so the kernel runs two launches of the
decode-row walk that kernels 1, 13 and 17 share (csrc/gemv_stream.cuh:
persistent blocks, each warp's weight stream kept in flight through a
ring of shared-memory stages, x staged once a block, on
`qmatmul.stream_plan`'s plan): the gate/up launch, with the norm's row
statistics summed inside it and a SiLU epilogue into an f32 scratch of
B*F*4 bytes that stays in L2, then the down launch with the residual in
its epilogue, launched as a programmatic dependent of the gate/up launch
(its copies of w2 start while the gate/up launch's last blocks run).  The
[B, F] intermediate stays f32.  Counted per (w13 form, w2 form) pairing,
each count one call of two launches; `fused_ffn_at` forces the two plans.

Kernel 15, `fused_owo_ffn`, replaces tokenhawk_tpu/ops/pallas/ffn.py
`fused_owo_ffn` (_fused_owo_ffn): the whole post-attention half of a
decode layer, x' = x + ctx @ Wo kept in f32, then x' + SwiGLU-MLP(
rms_norm(x') * g), rounded once.  It runs three launches of the decode-row
walk (csrc/ffn.cu th_owo_ffn), each on `qmatmul.stream_plan`'s plan for
its shape (`owo_plans`): Wo with x in its epilogue into an f32 x' scratch
(an ordinary launch), then kernel 2's gate/up over x' with the norm inside
it and its down launch with x' in its epilogue, each a programmatic
dependent of the launch before it.  Wo and w13 take one form without mins
(the gate's); a Wo or w13 with mins raises.  It is off by default, as in
the reference: the model takes it where `can_fuse_owo_ffn` passes and the
model's fusions ask for it (models/llama.py Fusions, THAWK_FUSED_OWO=1).
Calls are counted per (w13 form, w2 form) pairing as
`launches["owo_ffn[q4_0/q4_0]"]` and so on (on the model's path Wo has
w13's form), their walk launches in `launches["owo_ffn_stream"]` (three a
call); `fused_owo_ffn_at` forces the three plans.

Tolerance against the plain versions: f32 arithmetic in both, one final
rounding to x.dtype (2^-8 relative for bfloat16) plus summation order.
"""

from __future__ import annotations

import torch

from tokenhawk_tpu_torch.ops.cuda import build
from tokenhawk_tpu_torch.ops.cuda.qmatmul import (
    FORM_NAMES,
    forced_plan,
    form_code,
    stream_plan,
    weight_args,
)
from tokenhawk_tpu_torch.ops.qweight import QWeight

# Launches per (w13 form, w2 form) pairing, e.g. "ffn[g32m/g16]" for a
# Q4_K w13 (G 32, mins) over a Q6_K w2 (G 16, no mins).
launches = {f"{k}[{a}/{b}]": 0 for k in ("ffn", "owo_ffn") for a in FORM_NAMES
            for b in FORM_NAMES} | {"owo_ffn_stream": 0}
# Kernel 15's launches of the decode-row walk a call: Wo, gate/up, down.
OWO_LAUNCHES = 3
MAX_ROWS = 8
# The reference's tiles, which its gate for kernel 15 requires: the FFN
# walks F in tiles of 256, the Wo phase D in tiles of 512.  The port's
# kernels take any multiple of 32; the gate keeps the reference's
# conditions so that both packages fuse the same layers.
BLOCK_F, BLOCK_NW = 256, 512

# x; (qs, scales, mins, scmn, form) of w13 and of w2; gain, h, y; B, D, F;
# eps; dtype, the two launches' plans (splits, stages, blocks, parts); stream.
_ARGS = [build.P] + ([build.P] * 4 + [build.I]) * 2 + [build.P] * 3 + [build.I] * 3 + [
    build.F] + [build.I] * 9 + [build.P]
# ctx, x; (qs, scales, mins, scmn, form) of wo, w13 and w2; gain, xp, h, y;
# B, Dq, D, F; eps; dtype; the three launches' plans; stream.
_OWO_ARGS = [build.P] * 2 + ([build.P] * 4 + [build.I]) * 3 + [build.P] * 4 + [build.I] * 4 + [
    build.F] + [build.I] * 13 + [build.P]


def can_fuse_ffn(w13, w2, rows: int) -> bool:
    """Whether kernel 2 takes the layer: quantized w13 and w2 at most 8
    rows, and the reference's conditions on the super-block form
    (ffn.py can_fuse_ffn): a q4k_sb w13 with D % 1024 == 0, never a
    q4k_sb w2.  The port's GEMV takes any other width."""
    if not (isinstance(w13, QWeight) and isinstance(w2, QWeight)) or rows > MAX_ROWS:
        return False
    return w2.kind != "q4k_sb" and (w13.kind != "q4k_sb" or w13.shape[0] % 1024 == 0)


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
    return fused_ffn_at(x, w13, w2, norm_gain, eps)


def ffn_plans(rows: int, w13: QWeight, w2: QWeight, sms: int, forced=None) -> tuple:
    """The plans (splits, stages, blocks, parts) of kernel 2's two launches
    (`qmatmul.stream_plan`): the gate/up launch over w13 [D, 2F], the down
    launch over w2 [F, D].  `forced` gives a (splits, stages) or (splits,
    stages, parts) tuple for each, None or a None entry for the rule's."""
    (D, F2), (F, _) = w13.shape, w2.shape
    fa, fb = forced or (None, None)
    return (stream_plan(rows, D, F2, form_code(w13), sms, swiglu=True, **forced_plan(fa)),
            stream_plan(rows, F, D, form_code(w2, sb=False), sms, **forced_plan(fb)))


def fused_ffn_at(x, w13: QWeight, w2: QWeight, norm_gain, eps: float = 1e-6, plans=None):
    """fused_ffn with the two launches' (splits, stages) forced by `plans`
    (tests and sweeps; None: `ffn_plans`'s).  A CPU tensor runs the plain
    version whatever the plans."""
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
    f13, f2 = form_code(w13), form_code(w2, sb=False)
    pa, pb = ffn_plans(B, w13, w2, build.sm_count(xb.device), plans)
    code = build.dtype_code(xb.dtype)
    h = torch.empty((B, F), dtype=torch.float32, device=xb.device)
    y = torch.empty_like(xb)
    fn = build.function("th_ffn", _ARGS)
    rc = fn(xb.data_ptr(), *weight_args(w13, xb), f13, *weight_args(w2, xb), f2, gain.data_ptr(),
            h.data_ptr(), y.data_ptr(), B, D, F, eps, code, *pa, *pb, build.stream_of(xb))
    build.check(rc, "fused_ffn")
    launches[f"ffn[{FORM_NAMES[f13]}/{FORM_NAMES[f2]}]"] += 1
    return y.reshape(*lead, D)


# -- kernel 15: Wo + residual + RMSNorm + SwiGLU FFN + residual ---------------


def can_fuse_owo_ffn(wo, w13, w2, rows: int) -> bool:
    """The reference's gate for kernel 15 (ffn.py can_fuse_owo_ffn, without
    its environment switch, which the model's Fusions hold): kernel 2's
    (quantized w13 and w2, at most 8 rows) with the reference's FFN tiling,
    then Wo quantized in w13's form without mins, D % 512 == 0, Dq % 256 ==
    0 and Wo's output width w13's input width."""
    if not can_fuse_ffn(w13, w2, rows) or not isinstance(wo, QWeight):
        return False
    D, F2 = w13.shape
    F, D2 = w2.shape
    if D != D2 or F2 != 2 * F:
        return False
    if not (F % BLOCK_F == 0 and BLOCK_F % (8 * w2.group) == 0
            and D % (8 * w13.group) == 0 and D % 256 == 0):
        return False
    if wo.mins is not None or w13.mins is not None or (wo.kind, wo.group) != (w13.kind,
                                                                              w13.group):
        return False
    Dq, Dw = wo.shape
    return Dw % BLOCK_NW == 0 and Dq % 256 == 0 and Dw == D


def fused_owo_ffn_plain(ctx, x, wo: QWeight, w13: QWeight, w2: QWeight, norm_gain,
                        eps: float = 1e-6):
    """Kernel 15's function in plain PyTorch, f32 throughout, one rounding."""
    xp = x.float() + ctx.float() @ wo.dequantize(torch.float32)
    return fused_ffn_plain(xp, w13, w2, norm_gain, eps).to(x.dtype)


def fused_owo_ffn(ctx, x, wo: QWeight, w13: QWeight, w2: QWeight, norm_gain,
                  eps: float = 1e-6):
    """ctx [..., Dq], x [..., D] -> x' + SwiGLU-MLP(rms_norm(x') * gain),
    x' = x + ctx @ Wo (f32); at most 8 rows, y in x.dtype."""
    return fused_owo_ffn_at(ctx, x, wo, w13, w2, norm_gain, eps)


def owo_plans(rows: int, wo: QWeight, w13: QWeight, w2: QWeight, sms: int,
              forced=None) -> tuple:
    """The plans (splits, stages, blocks, parts) of kernel 15's three
    launches: Wo over [Dq, D], then kernel 2's two (`ffn_plans`).  `forced`
    gives a (splits, stages) or (splits, stages, parts) tuple for each, None
    or a None entry for the rule's."""
    fo, *fb = forced or (None, None, None)
    Dq, D = wo.shape
    return (stream_plan(rows, Dq, D, form_code(wo, sb=False), sms, **forced_plan(fo)),
            *ffn_plans(rows, w13, w2, sms, fb))


def fused_owo_ffn_at(ctx, x, wo: QWeight, w13: QWeight, w2: QWeight, norm_gain,
                     eps: float = 1e-6, plans=None):
    """fused_owo_ffn with the three launches' plans forced by `plans`
    (tests and sweeps; None: `owo_plans`'s).  A CPU tensor runs the plain
    version whatever the plans."""
    if not x.is_cuda:
        return fused_owo_ffn_plain(ctx, x, wo, w13, w2, norm_gain, eps)
    Dq, Dw = wo.shape
    D, F2 = w13.shape
    F, D2 = w2.shape
    build.require(x.shape[-1] == D and Dw == D and D2 == D and F2 == 2 * F
                  and ctx.shape[-1] == Dq and ctx.shape[:-1] == x.shape[:-1],
                  f"ctx {tuple(ctx.shape)}, x {tuple(x.shape)}, wo {wo.shape}, w13 {w13.shape}, "
                  f"w2 {w2.shape} do not chain")
    build.require(wo.mins is None and w13.mins is None,
                  "fused_owo_ffn takes Wo and w13 in a form without mins")
    lead = x.shape[:-1]
    xb = x.reshape(-1, D).contiguous()
    cb = ctx.reshape(-1, Dq).to(xb.dtype).contiguous()
    B = xb.shape[0]
    build.require(1 <= B <= MAX_ROWS, f"fused_owo_ffn takes 1..{MAX_ROWS} rows, got {B}")
    gain = norm_gain.to(xb.dtype).contiguous()
    build.require(gain.shape == (D,), f"gain {tuple(gain.shape)} != ({D},)")
    build.require_cuda(xb, cb, gain)
    fo, f13, f2 = (form_code(w, sb=False) for w in (wo, w13, w2))
    pa, pb, pc = owo_plans(B, wo, w13, w2, build.sm_count(xb.device), plans)
    xp = torch.empty((B, D), dtype=torch.float32, device=xb.device)
    h = torch.empty((B, F), dtype=torch.float32, device=xb.device)
    y = torch.empty_like(xb)
    fn = build.function("th_owo_ffn", _OWO_ARGS)
    rc = fn(cb.data_ptr(), xb.data_ptr(), *weight_args(wo, xb), fo, *weight_args(w13, xb), f13,
            *weight_args(w2, xb), f2, gain.data_ptr(), xp.data_ptr(), h.data_ptr(),
            y.data_ptr(), B, Dq, D, F, eps, build.dtype_code(xb.dtype), *pa, *pb, *pc,
            build.stream_of(xb))
    build.check(rc, "fused_owo_ffn")
    launches[f"owo_ffn[{FORM_NAMES[f13]}/{FORM_NAMES[f2]}]"] += 1
    launches["owo_ffn_stream"] += OWO_LAUNCHES
    return y.reshape(*lead, D)
