"""Kernels 1, 13 and 17: dequant-matmul with fused RMSNorm (csrc/qmatmul.cu).

One wrapper takes every weight form (ops/qweight.py).  Over Q4_0 it
is kernel 1, which replaces tokenhawk_tpu/ops/pallas/qmatmul.py
`q4_matmul` (_q4_kernel) and `q4_matmul_i4` (_q4i4_kernel); over the
group-code kind (Q8_0, Q5_0, Q4_1, Q5_1, Q2_K..Q6_K) it is kernel 13,
which replaces `q8_matmul` (_q8_kernel) and `qk_matmul` (_qk_kernel);
over the Q4_K super-block kind (q4k_sb, THAWK_Q4K_SB=1) it is kernel 17,
which replaces `qk_sb_matmul` (_qk_sb_kernel): kernel 13's loop over
codes two a byte, the group's scale and bias expanded from sc / mn and
the super-block's d / dmin in registers.

Three paths, picked here (`stream_path`, `tensor_core_path`) and counted
apart.  Every form at 1 to 8 rows (f32 or bf16 x) runs the decode-row
walk (gemv_stream.cuh), which kernel 2 shares: on the H100 those rows are
bound by the weight bytes, so persistent blocks (one an SM) give each warp
a run of column pairs (or of one part of a pair's K, where the pairs leave
a last wave) whose codes, scales and mins it keeps in flight through a
ring of shared-memory stages filled by bulk copies, x is staged once a
block and read once, and the norm's row statistics are summed inside the
launch (`stream_plan`: the blocks, K's segments, the ring's depth and the
parts from the rows, K, N, the form and the SM count).  Counted in
`launches["q4_matmul_stream"]`, `launches["qk_matmul_stream"]` and
`launches["qk_sb_matmul_stream"]`.  The GEMV
(gemv.cuh) takes f32 x above 8 rows: it reads a column's codes with
16-byte loads and converts them once for every row of a row tile, and a
small pre-pass gives the norm's row statistics.  Counted in
`launches["q4_matmul"]`, `launches["qk_matmul"]` and
`launches["qk_sb_matmul"]`.  Above 8 rows of bf16 x every form goes to the
tensor-core GEMM (qgemm_tc.cuh: mma.sync over 128-column tiles of codes
brought in by cp.async and widened to bf16 in shared memory; where its
tiles would leave SMs idle, K splits across blocks and a last pass adds
the splits' f32 sums in order), where the work is bound by operations:
counted in `launches["q4_matmul_tc"]`, `launches["qk_matmul_tc"]` and
`launches["qk_sb_matmul_tc"]`.  Its roundings are the reference's at
those rows (`_qdot`'s bf16 dot): xn and each code * s rounded to bf16,
f32 sums, the mins as an f32 dot of xn's group sums; kernel 17's s and
its bias m = 8s - dmin*mn are expanded per group in the walk with the
GEMV's f32 roundings (`_sb_expand`'s), m riding the mins path.  No path
falls back to another.

Tolerance against the plain version: both accumulate in f32 and round
once to the output dtype; they differ by summation order (~1e-6 relative
in f32, of the terms, which for affine kinds includes the m * sum(x)
term) plus that one rounding (2^-8 relative for bfloat16).  Kernel 17
forms each group's s and b with the plain version's roundings.  The
tensor-core path also rounds xn and code * s to bf16 (at most 2^-9 of
each, in no common direction), which moves an output by about 2^-9 of
the root of its summed squared terms, below one output rounding of the
largest outputs.
"""

from __future__ import annotations

import torch

from tokenhawk_tpu_torch.ops.cuda import build
from tokenhawk_tpu_torch.ops.qweight import QWeight

launches = {"q4_matmul": 0, "qk_matmul": 0, "qk_sb_matmul": 0, "q4_matmul_tc": 0,
            "qk_matmul_tc": 0, "qk_sb_matmul_tc": 0, "q4_matmul_stream": 0,
            "qk_matmul_stream": 0, "qk_sb_matmul_stream": 0}

_ARGS = [build.P] * 8 + [build.I] * 4 + [build.F, build.I, build.P]
# x, qs, scales, mins, scmn, gain, y, xn, xsum and part scratch; B, K, N,
# form, splits; eps; stream.
_TC_ARGS = [build.P] * 10 + [build.I] * 5 + [build.F, build.P]
# x, qs, scales, mins, scmn, gain, y; B, K, N, form, splits, stages, blocks,
# parts; eps; dtype; stream.
_STREAM_ARGS = [build.P] * 7 + [build.I] * 8 + [build.F, build.I, build.P]
# The fewest rows the tensor-core path takes: the reference's `_qdot` takes
# its bf16 dot above 8 rows (DOT_F32 "auto").
TC_MIN_ROWS = 9

# Weight forms at the C boundary (csrc/gemv.cuh enum Form), by code.
FORM_NAMES = ("q4_0", "g32", "g32m", "g16", "g16m", "sb")
SB = FORM_NAMES.index("sb")
_FORMS = {("q4_0", 32, False): 0, ("qk", 32, False): 1, ("qk", 32, True): 2,
          ("qk", 16, False): 3, ("qk", 16, True): 4, ("q4k_sb", 32, True): SB}
# The launch counter of each form's kernel (the group codes': qk_matmul).
_KERNEL = {0: "q4_matmul", SB: "qk_sb_matmul"}

# -- the decode-row walk (csrc/gemv_stream.cuh) -------------------------------
# The most rows it takes (kernel 2's MAX_ROWS; the reference's `_qdot` keeps
# f32 up to 8 rows), the forms kernels 1, 13 and 17 run on it (all six).
STREAM_MAX_ROWS = 8
STREAM_FORMS = tuple(range(len(FORM_NAMES)))
# Its constants (gemv_stream.cuh): warps a block, floats of a staged slot,
# slots a segment is a multiple of, the deepest ring, shared memory a block
# may use, the norm's bytes (then the parts' exchange), the mbarriers'.
STREAM_WARPS, STREAM_SLOT_FLOATS, STREAM_ALIGN, STREAM_MAX_STAGES = 16, 36, 8, 6
STREAM_MAX_SMEM, STREAM_RED = 232448, 2048
STREAM_BARS = STREAM_WARPS * STREAM_MAX_STAGES * 8  # the stages' mbarriers
# By form code: the bytes of one column's stage (kBytes of Q4Stream,
# QkStream<G, MINS>, SbStream: 64 slots of codes and sides for the 4-bit
# forms, so that their codes go by 1 KB bulk copies; 32 for the group codes).
STREAM_STAGE_BYTES = {0: 1280, 1: 1152, 2: 1280, 3: 1280, 4: 1536, SB: 1216}
# The ring's depth the rule takes at most, by row tile: 3 stages ran within
# 2.4% of the best of 2 to 6 at each one-row shape swept (PERF.md);
# at eight rows x's segment wants the room.
STREAM_STAGES = {1: 3, 2: 3, 4: 3, 8: 2}
# The counts of warps a column pair's K may be split over, and the tail the
# rule allows: the most tasks a warp takes over the mean.
STREAM_PARTS, STREAM_TAIL = (1, 2, 4), 1.1


def stream_path(form: int, rows: int) -> bool:
    """Whether kernels 1, 13 and 17 take the decode-row walk: any form at 1
    to 8 rows (f32 or bf16 x; bf16 above 8 rows is the tensor-core path)."""
    return form in STREAM_FORMS and 1 <= rows <= STREAM_MAX_ROWS


def stream_rows(rows: int) -> int:
    """The walk's row tile for `rows` rows: 1, 2, 4 or 8."""
    return next(r for r in (1, 2, 4, 8) if rows <= r)


def stream_tasks(N: int, swiglu: bool = False) -> int:
    """Column pairs of a launch over N outputs (gate/up pairs, N = 2F, for
    kernel 2's first launch)."""
    return N // 2 if swiglu else -(-N // 2)


def stream_blocks(N: int, sms: int, swiglu: bool = False, parts: int = 1) -> int:
    """Persistent blocks of a launch: one an SM, fewer where the tasks (a
    column pair's K in `parts` parts) leave a block's 16 warps without one
    each."""
    return min(sms, -(-stream_tasks(N, swiglu) * parts // STREAM_WARPS))


def stream_tail(N: int, sms: int, swiglu: bool = False, parts: int = 1) -> float:
    """The most tasks a warp takes over the mean, each column pair's K in
    `parts` parts: the launch's last wave."""
    tasks = stream_tasks(N, swiglu) * parts
    warps = stream_blocks(N, sms, swiglu, parts) * STREAM_WARPS
    return -(-tasks // warps) / (tasks / warps)


def stream_segment(K: int, splits: int) -> int:
    """Slots (32 inputs) of each of K's `splits` segments (or of one
    segment's parts): ceil(K/32 / splits) rounded up to a multiple of 8."""
    per = -(-(K // 32) // splits)
    return -(-per // STREAM_ALIGN) * STREAM_ALIGN


def stream_smem(form: int, rows: int, K: int, N: int, splits: int, stages: int, blocks: int,
                swiglu: bool = False) -> int:
    """Dynamic shared memory of one block (gemv_stream.cuh smem_bytes): one
    segment of x's row tile in f32, the warps' rings, the norm's sums (then
    the parts' exchange) and, over more than one segment, the warps'
    running sums."""
    tile = stream_rows(rows)
    tasks = -(-stream_tasks(N, swiglu) // (blocks * STREAM_WARPS))
    return (tile * stream_segment(K, splits) * STREAM_SLOT_FLOATS * 4
            + STREAM_WARPS * stages * 2 * STREAM_STAGE_BYTES[form] + STREAM_RED + STREAM_BARS
            + (STREAM_WARPS * tasks * 2 * tile * 4 if splits > 1 else 0))


def stream_fits(form: int, rows: int, K: int, N: int, splits: int, stages: int, blocks: int,
                swiglu: bool = False, parts: int = 1) -> bool:
    """Whether the walk takes the plan: no empty segment or part, 2 to 6
    stages, parts 1, 2 or 4 (more than one in one segment only), and the
    shared memory of a block within the card's."""
    return (splits >= 1 and (splits - 1) * stream_segment(K, splits) < K // 32
            and 2 <= stages <= STREAM_MAX_STAGES and blocks >= 1
            and parts in STREAM_PARTS and (parts == 1 or splits == 1)
            and (parts - 1) * stream_segment(K, parts) < K // 32
            and stream_smem(form, rows, K, N, splits, stages, blocks, swiglu) <= STREAM_MAX_SMEM)


def stream_parts(K: int, N: int, sms: int, swiglu: bool = False, splits: int = 1) -> int:
    """The tail rule: the fewest parts of STREAM_PARTS whose last wave is
    within STREAM_TAIL of the mean (the least tail where none is), in one
    K segment; 1 over more."""
    fit = [p for p in STREAM_PARTS
           if p == 1 or (splits == 1 and (p - 1) * stream_segment(K, p) < K // 32)]
    ok = [p for p in fit if stream_tail(N, sms, swiglu, p) <= STREAM_TAIL]
    return ok[0] if ok else min(fit, key=lambda p: stream_tail(N, sms, swiglu, p))


def stream_plan(rows: int, K: int, N: int, form: int, sms: int, swiglu: bool = False,
                splits: int | None = None, stages: int | None = None,
                parts: int | None = None) -> tuple:
    """The walk's plan (splits, stages, blocks, parts) at `rows` rows, K
    inputs and N outputs (2F for kernel 2's gate/up launch, swiglu=True) of
    weight form `form` on a card of `sms` SMs: K in the fewest segments
    that fit, the deepest ring up to STREAM_STAGES that fits beside them,
    the tail rule's parts (`stream_parts`) and `stream_blocks` persistent
    blocks.  `splits`, `stages` or `parts` force a value (tests and sweeps);
    a plan that does not fit raises.  Swept on an NVIDIA H100 80GB HBM3 at
    700 W by `experiments/gemv_rows.py --sweep` at kernels 13's and 2's
    shapes of the model paths (PERF.md): one segment ran within 1% of the
    fastest plan and 3 stages within 2.4% of the best depth at every
    one-row shape; the block count was not swept (one 16-warp block an
    SM)."""
    cap = STREAM_STAGES[stream_rows(rows)] if stages is None else stages
    for n in ([splits] if splits is not None else range(1, K // 32 // STREAM_ALIGN + 2)):
        p = stream_parts(K, N, sms, swiglu, n) if parts is None else parts
        blocks = stream_blocks(N, sms, swiglu, p)
        for r in ([stages] if stages is not None else range(cap, 1, -1)):
            if stream_fits(form, rows, K, N, n, r, blocks, swiglu, p):
                return n, r, blocks, p
    raise ValueError(f"the decode-row walk takes no plan of {splits} splits, {stages} stages, "
                     f"{parts} parts at K {K}, N {N}, {rows} rows")


def forced_plan(plan) -> dict:
    """stream_plan's keyword arguments for a forced (splits, stages) or
    (splits, stages, parts) tuple; none for None (the rule's plan)."""
    return {} if plan is None else dict(zip(("splits", "stages", "parts"), plan))


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


def tensor_core_path(dtype: torch.dtype, rows: int) -> bool:
    """Whether a call runs the tensor-core GEMM: bf16 x at TC_MIN_ROWS or
    more rows, over every weight form."""
    return dtype == torch.bfloat16 and rows >= TC_MIN_ROWS


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
    return quant_matmul_at(x, w, norm_gain, eps)


def quant_matmul_at(x: torch.Tensor, w: QWeight, norm_gain=None, eps: float = 1e-6,
                    splits: int | None = None, stages: int | None = None,
                    parts: int | None = None):
    """quant_matmul with the decode-row walk's K segments, ring depth or
    parts forced (tests and sweeps; None: `stream_plan`'s).  A CPU tensor
    runs the plain version whatever the plan."""
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
    rows = xb.shape[0]
    y = torch.empty((rows, N), dtype=xb.dtype, device=xb.device)
    gp = gain.data_ptr() if gain is not None else None
    stream = not tensor_core_path(xb.dtype, rows) and stream_path(form, rows)
    build.require((splits is None and stages is None and parts is None) or stream,
                  "a plan is forced only on the decode-row walk (1-8 rows)")
    if tensor_core_path(xb.dtype, rows):
        splits = build.function("th_quant_matmul_tc_splits", [build.I] * 4)(
            rows, K, N, build.sm_count(xb.device))
        xn = torch.empty_like(xb) if gain is not None else None
        xsum = (torch.empty((rows, K // w.group), dtype=torch.float32, device=xb.device)
                if w.mins is not None else None)
        part = (torch.empty((splits, rows, N), dtype=torch.float32, device=xb.device)
                if splits > 1 else None)
        fn = build.function("th_quant_matmul_tc", _TC_ARGS)
        rc = fn(xb.data_ptr(), *weight_args(w, xb), gp, y.data_ptr(),
                *(t.data_ptr() if t is not None else None for t in (xn, xsum, part)), rows, K,
                N, form, splits, eps, build.stream_of(xb))
        name = _KERNEL.get(form, "qk_matmul") + "_tc"
    elif stream:
        plan = stream_plan(rows, K, N, form, build.sm_count(xb.device), splits=splits,
                           stages=stages, parts=parts)
        fn = build.function("th_quant_matmul_stream", _STREAM_ARGS)
        rc = fn(xb.data_ptr(), *weight_args(w, xb), gp, y.data_ptr(), rows, K, N, form, *plan,
                eps, build.dtype_code(xb.dtype), build.stream_of(xb))
        name = _KERNEL.get(form, "qk_matmul") + "_stream"
    else:
        inv = torch.empty((rows,), dtype=torch.float32, device=xb.device)
        fn = build.function("th_quant_matmul", _ARGS)
        rc = fn(xb.data_ptr(), *weight_args(w, xb), gp, y.data_ptr(), inv.data_ptr(), rows, K, N,
                form, eps, build.dtype_code(xb.dtype), build.stream_of(xb))
        name = _KERNEL.get(form, "qk_matmul")
    build.check(rc, name)
    launches[name] += 1
    return y.reshape(*x.shape[:-1], N)
