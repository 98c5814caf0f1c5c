"""The decode-row walk of kernels 1, 2, 13 and 17 (csrc/gemv_stream.cuh), on the CPU.

A CUDA kernel cannot run here, so this file repeats the walk's order of
arithmetic in torch (`walk`), f32 throughout, and holds it to the JAX
package:
  - the host's rule (`qmatmul.stream_plan`: blocks, K segments, ring
    depth, parts) and its segments as host integers, its tail rule (each
    column pair's K split over 1, 2 or 4 warps so that the most tasks a
    warp takes is within 1.1x the mean) at the model paths' shapes, and
    its constants against the CUDA source's;
  - the walk's order: K in the plan's segments (slots of 32 inputs, a
    multiple of 8 each), or one segment in the plan's parts, each run's
    groups' dots of the codes scaled once, the mins as m times the group's
    input sum, the runs' sums added in order; the norm from the whole
    row's sum of squares, x normalised as (x * inv) * gain: against the
    reference's `matmul` under the pallas_interpret backend (its Pallas
    q4_matmul / q8_matmul / qk_matmul in interpret mode) over Q4_0, Q8_0,
    Q4_K, Q5_K, Q6_K and Q2_K, and its Pallas qk_sb_matmul in interpret
    mode over the Q4_K super-blocks, at rows 1, 3 and 8, with and without
    the norm, at every segment count and every part count the walk takes
    at K 2048; and kernel 2's two launches (gate/up with the norm and
    SwiGLU into f32 h, down with the residual) against the reference's
    fused FFN in interpret mode over group-code pairings and `_ffn_block`
    over Q4_0, at every pair of segment counts; and kernel 15's three
    launches (Wo with x's residual into an f32 x', then kernel 2's two over
    x', y rounded once) against the reference's fused_owo_ffn in interpret
    mode over Q4_0 and Q8_0 at 1, 2 and 8 rows, and against a float64 numpy
    oracle over the forms the reference's kernel 15 misreads (Wo and w13 of
    G 16, a w2 with mins), at every triple of the launches' segment and
    part counts.  f32 on both sides, so summation order only: atol 1e-5
    and rtol 1e-4;
  - a CPU tensor runs the plain versions, whatever the split, and counts
    nothing.
"""

import functools
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tokenhawk_tpu.config import LlamaConfig
from tokenhawk_tpu.ggml.format import GGMLType as JType
from tokenhawk_tpu.ggml.quants import quantize as j_quantize
from tokenhawk_tpu.models.llama import LayerParams, _ffn_block
from tokenhawk_tpu.ops import dispatch
from tokenhawk_tpu.ops import qweight as j_qw
from tokenhawk_tpu.ops.linear import matmul as j_matmul
from tokenhawk_tpu.ops.pallas.ffn import fused_ffn as j_fused_ffn
from tokenhawk_tpu.ops.pallas.ffn import fused_owo_ffn as j_fused_owo_ffn
from tokenhawk_tpu.ops.pallas.qmatmul import quant_matmul as j_quant_matmul
from tokenhawk_tpu_torch.ggml.format import GGMLType as TType
from tokenhawk_tpu_torch.ggml.quants import QuantizedTensor as TQuantizedTensor
from tokenhawk_tpu_torch.ggml.synth import random_kquant
from tokenhawk_tpu_torch.ops.cuda import ffn, qmatmul
from tokenhawk_tpu_torch.ops.qweight import QWeight

from torch_helpers import jax_q4, t

K, N = 2048, 128
KINDS = ["Q4_0", "Q8_0", "Q4_K", "Q5_K", "Q6_K", "Q2_K", "Q4_K sb"]
EPS = 1e-6
H100_SMS = 132


def _splits(K):
    """Every count of K segments the walk takes at K, up to 8 (none empty)."""
    return [n for n in range(1, 9) if (n - 1) * qmatmul.stream_segment(K, n) < K // 32]


def _ranges(K, splits):
    """The segments' (or one segment's parts') slot ranges [lo, hi), in
    order (gemv_stream.cuh)."""
    slots, per = K // 32, qmatmul.stream_segment(K, splits)
    return [(min(slots, r * per), min(slots, r * per + per)) for r in range(splits)]


def _parts(K):
    """Every count of parts the walk takes at K in one segment."""
    return [p for p in qmatmul.STREAM_PARTS if (p - 1) * qmatmul.stream_segment(K, p) < K // 32]


def _sides(w: QWeight):
    """Code values [N, K] (q - 8 for the 4-bit forms), each group's scale
    and its m (None without), as the walk reads them: the super-blocks' s
    and m = 8s - dmin * mn rounded once each (SbReader's order)."""
    c = w.codes().float()
    if w.kind == "qk":
        return c, w.group, w.scales, w.mins
    if w.kind == "q4_0":
        return c - 8.0, 32, w.scales, None
    g = c.shape[1] // 32
    s = w.scales.repeat_interleave(8, dim=1) * w.scmn[:, :g].float()
    m = w.mins.repeat_interleave(8, dim=1) * w.scmn[:, g:].float()
    return c - 8.0, 32, s, 8.0 * s - m


def walk(x, w: QWeight, splits, gain=None, eps=EPS, residual=None, swiglu=False, parts=1):
    """The walk's arithmetic in torch, f32: x [B, K] over w [K, N] in
    `splits` K segments, or in one segment split over `parts` warps; with a
    gain x normalised as (x * inv) * gain from the whole row's sum of
    squares; each segment's (or part's) groups' dots scaled once (and the
    mins on the group sums), their sums added in order (part 0's, then
    1's, ...); then the epilogue (SwiGLU into f32, or the residual added)."""
    assert parts == 1 or splits == 1
    x = x.float()
    Kw = x.shape[1]
    ranges = _ranges(Kw, max(splits, parts))
    if gain is not None:
        x = (x * torch.rsqrt((x * x).sum(-1) / Kw + eps)[:, None]) * gain.float()
    q, G, s, m = _sides(w)
    acc = torch.zeros(x.shape[0], q.shape[0])
    for lo, hi in ranges:
        if hi <= lo:
            continue
        a, b = lo * 32 // G, hi * 32 // G  # the range's groups
        xg = x[:, lo * 32:hi * 32].reshape(x.shape[0], b - a, G)
        qg = q[:, lo * 32:hi * 32].reshape(q.shape[0], b - a, G)
        part = torch.einsum("bgk,ngk->bng", xg, qg) * s[None, :, a:b]
        if m is not None:
            part = part + xg.sum(-1)[:, None, :] * m[None, :, a:b]
        acc = acc + part.sum(-1)
    if swiglu:
        F = acc.shape[1] // 2
        return torch.nn.functional.silu(acc[:, :F]) * acc[:, F:]
    return acc if residual is None else residual.float() + acc


def kernel2(x, w13, w2, gain, plans):
    """Kernel 2's two launches: gate/up (norm, SwiGLU into f32 h), then down
    with x's residual, each at its (splits, parts)."""
    (sa, pa), (sb, pb) = plans
    h = walk(x, w13, sa, gain=gain, swiglu=True, parts=pa)
    return walk(h, w2, sb, residual=x, parts=pb)


# -- the rule as host integers ------------------------------------------------


def test_stream_constants_are_the_sources():
    """The host's mirror of gemv_stream.cuh: its layout constants and each
    form's stage (64 slots of the 4-bit forms, 32 of the group codes) and
    kBytes (codes, then scales and mins; sb: sc, mn, d, dmin)."""
    src = (Path(qmatmul.__file__).parents[2] / "csrc" / "gemv_stream.cuh").read_text()
    consts = {k: int(v) for k, v in re.findall(r"constexpr int (k\w+) = (\d+);", src)}
    assert (consts["kWarps"], consts["kSlots"], consts["kSlotFloats"], consts["kAlign"],
            consts["kMaxStages"], consts["kRedBytes"], consts["kMaxSmem"]) == (
        qmatmul.STREAM_WARPS, 32, qmatmul.STREAM_SLOT_FLOATS, qmatmul.STREAM_ALIGN,
        qmatmul.STREAM_MAX_STAGES, qmatmul.STREAM_RED, qmatmul.STREAM_MAX_SMEM)
    assert consts["kNibbleStage"] == 64
    assert src.count("static constexpr int kStage = kNibbleStage;") == 2  # Q4Stream, SbStream
    assert "static constexpr int kStage = kSlots;" in src  # QkStream
    assert "kBytes = kStage * 16 + kStage * 4;" in src  # Q4Stream
    assert "kBytes = kStage * 16 + 2 * kStage + 2 * (kStage / 8) * 4;" in src  # SbStream
    assert "kBytes = kStage * 32 + kStage * kSub * 4 * (MINS ? 2 : 1);" in src  # QkStream
    assert qmatmul.STREAM_STAGE_BYTES == {0: 64 * 16 + 64 * 4, 1: 32 * 32 + 32 * 4,
                                          2: 32 * 32 + 2 * 32 * 4, 3: 32 * 32 + 32 * 2 * 4,
                                          4: 32 * 32 + 2 * 32 * 2 * 4,
                                          qmatmul.SB: 64 * 16 + 2 * 64 + 2 * 8 * 4}


@pytest.mark.parametrize("K_", [800, 2048, 4096, 11008, 14336])
def test_ranges_cover_k_once_in_multiples_of_8(K_):
    slots = K_ // 32
    for s in _splits(K_):
        ranges = _ranges(K_, s)
        assert ranges[0][0] == 0 and ranges[-1][1] == slots
        assert all(hi > lo and lo % 8 == 0 for lo, hi in ranges)  # no empty range
        assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    assert 5 not in _splits(800)  # 25 slots: ranges of 8 give 4 blocks, not 5


# (rows, K, N, form, swiglu) -> the plan (splits, stages, blocks, parts) on
# an H100's 132 SMs, at the shapes of the model paths: kernel 13 over
# Llama-3-8B's Q4_K wqkv, wo, Q6_K w2 and head and the 7B's Q8_0 wqkv;
# kernel 1 over the 7B's Q4_0 wqkv, wo and output; kernel 17 over
# Llama-3-8B's super-block wqkv and wo; kernel 2's gate/up (N = 2F) and
# down launches over the 7B's Q4_0 and Llama-3-8B's Q4_K / Q6_K.  Their
# 6144 columns (3072 pairs over 2112 warps) and the 7B's F 11008 take two
# parts a pair.
PLANS = {(1, 4096, 6144, "g32m", False): (1, 3, 132, 2),
         (1, 4096, 4096, "g32m", False): (1, 3, 128, 1),
         (1, 14336, 4096, "g16", False): (1, 3, 128, 1),
         (1, 4096, 128256, "g16", False): (1, 3, 132, 1),
         (1, 4096, 12288, "g32", False): (1, 3, 132, 1),
         (1, 4096, 12288, "q4_0", False): (1, 3, 132, 1),
         (1, 4096, 4096, "q4_0", False): (1, 3, 128, 1),
         (1, 4096, 32000, "q4_0", False): (1, 3, 132, 1),
         (1, 4096, 6144, "sb", False): (1, 3, 132, 2),
         (1, 4096, 4096, "sb", False): (1, 3, 128, 1),
         (1, 4096, 2 * 11008, "q4_0", True): (1, 3, 132, 2),
         (1, 11008, 4096, "q4_0", False): (1, 3, 128, 1),
         (1, 4096, 2 * 14336, "g32m", True): (1, 3, 132, 1),
         (8, 4096, 6144, "g32m", False): (1, 2, 132, 2),
         (8, 4096, 12288, "q4_0", False): (1, 2, 132, 1),
         (8, 4096, 4096, "q4_0", False): (1, 2, 128, 1),
         (8, 4096, 32000, "q4_0", False): (1, 2, 132, 1),
         (8, 4096, 6144, "sb", False): (1, 2, 132, 2),
         (8, 4096, 4096, "sb", False): (1, 2, 128, 1),
         (8, 4096, 2 * 11008, "q4_0", True): (1, 2, 132, 2),
         (8, 11008, 4096, "q4_0", False): (3, 2, 128, 1),
         (8, 14336, 4096, "g16", False): (4, 2, 128, 1)}


@pytest.mark.parametrize("case", sorted(PLANS))
def test_plan_at_the_paths_shapes(case):
    rows, K_, N_, form, swiglu = case
    f = qmatmul.FORM_NAMES.index(form)
    plan = qmatmul.stream_plan(rows, K_, N_, f, H100_SMS, swiglu)
    assert plan == PLANS[case]
    splits, stages, blocks, parts = plan
    assert blocks == qmatmul.stream_blocks(N_, H100_SMS, swiglu, parts)
    assert blocks * qmatmul.STREAM_WARPS <= max(qmatmul.stream_tasks(N_, swiglu) * parts,
                                                H100_SMS * qmatmul.STREAM_WARPS)
    assert qmatmul.stream_fits(f, rows, K_, N_, splits, stages, blocks, swiglu, parts)
    # No fewer segments fit, and no deeper ring up to the cap beside them.
    cap = qmatmul.STREAM_STAGES[qmatmul.stream_rows(rows)]
    assert not any(qmatmul.stream_fits(f, rows, K_, N_, n, r, blocks, swiglu)
                   for n in range(1, splits) for r in range(2, cap + 1))
    assert not any(qmatmul.stream_fits(f, rows, K_, N_, splits, r, blocks, swiglu, parts)
                   for r in range(stages + 1, cap + 1))
    # The tail rule: within 1.1x of the mean, and no fewer parts are.
    assert qmatmul.stream_tail(N_, H100_SMS, swiglu, parts) <= qmatmul.STREAM_TAIL
    assert all(qmatmul.stream_tail(N_, H100_SMS, swiglu, p) > qmatmul.STREAM_TAIL
               for p in qmatmul.STREAM_PARTS if p < parts)


# (N, swiglu) at the model paths' widths -> (parts, the most tasks a warp
# takes, tasks, warps) over 132 SMs x 16 warps: the 7B's wqkv, wo and
# output and its FFN (F 11008); Llama-3-8B's wqkv, Q6_K head and FFN (F
# 14336); TinyLlama's wqkv, output and FFN (F 5632), the draft's and the
# 22-layer Q4_0 target's.
TAILS = {(12288, False): (1, 3, 6144, 2112), (4096, False): (1, 1, 2048, 2048),
         (32000, False): (1, 8, 16000, 2112), (22016, True): (2, 11, 22016, 2112),
         (6144, False): (2, 3, 6144, 2112), (128256, False): (1, 31, 64128, 2112),
         (28672, True): (1, 7, 14336, 2112), (2560, False): (1, 1, 1280, 1280),
         (11264, True): (4, 11, 22528, 2112)}


@pytest.mark.parametrize("case", sorted(TAILS))
def test_tail_rule_splits_the_pairs_as_host_integers(case):
    N_, swiglu = case
    parts, most, tasks, warps = TAILS[case]
    assert qmatmul.stream_parts(4096, N_, H100_SMS, swiglu) == parts
    assert qmatmul.stream_tasks(N_, swiglu) * parts == tasks
    assert qmatmul.stream_blocks(N_, H100_SMS, swiglu, parts) * qmatmul.STREAM_WARPS == warps
    assert -(-tasks // warps) == most
    assert most / (tasks / warps) <= qmatmul.STREAM_TAIL
    # Over more than one segment a pair is never split.
    assert qmatmul.stream_parts(4096, N_, H100_SMS, swiglu, splits=2) == 1


def test_stream_path_takes_all_six_forms_at_decode_rows():
    """Kernels 1 (q4_0), 13 (the group codes) and 17 (sb) all take the walk
    at 1 to 8 rows; above that the tensor-core path or the GEMV."""
    assert qmatmul.STREAM_FORMS == tuple(range(len(qmatmul.FORM_NAMES))) == (0, 1, 2, 3, 4, 5)
    for f in range(6):
        assert all(qmatmul.stream_path(f, r) for r in range(1, 9))
        assert not qmatmul.stream_path(f, 0) and not qmatmul.stream_path(f, 9)
    assert not qmatmul.stream_path(6, 1)


def test_plan_refuses_what_does_not_fit():
    g32m = qmatmul.FORM_NAMES.index("g32m")
    for kw in ({"splits": 0}, {"stages": 1}, {"stages": 7}, {"splits": 5, "stages": 2},
               {"parts": 3}, {"splits": 2, "parts": 2}):
        with pytest.raises(ValueError):
            qmatmul.stream_plan(1, 800 if "splits" in kw else 4096, 64, g32m, H100_SMS, **kw)
    # Six stages of the widest form's stage beside 14336 inputs of one row
    # exceed a block's shared memory; four segments of eight rows fit.
    g16m = qmatmul.FORM_NAMES.index("g16m")
    with pytest.raises(ValueError):
        qmatmul.stream_plan(1, 14336, 4096, g16m, H100_SMS, splits=1, stages=6)
    assert qmatmul.stream_plan(8, 14336, 4096, g16m, H100_SMS, splits=4) == (4, 2, 128, 1)
    # Few columns: fewer blocks than SMs, each warp a pair.
    assert qmatmul.stream_blocks(100, H100_SMS) == 4 and qmatmul.stream_blocks(
        200, H100_SMS, swiglu=True) == 7


# -- kernel 13 ------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _weights(kind):
    """The reference's QWeight and the port's, logical [K, N], from one GGML
    tensor (float32 sides; use_i4=False, the forms the port keeps, but for
    the super-blocks, which the reference builds with use_i4 under
    THAWK_Q4K_SB=1)."""
    rng = np.random.default_rng(KINDS.index(kind) + 40)
    if kind == "Q4_0":
        return jax_q4((rng.standard_normal((K, N)) * 0.05).astype(np.float32))
    if kind == "Q4_K sb":
        raw = random_kquant(TType.Q4_K, (N, K), rng).raw
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("THAWK_Q4K_SB", "1")
            jw = j_qw.from_kquant_raw(JType.Q4_K, raw, (N, K), scale_dtype=jnp.float32,
                                      use_i4=True, sb_ok=True)
        pw = QWeight.from_kquant_raw(TType.Q4_K, raw, (N, K), sb=True, sb_ok=True)
        assert jw.kind == pw.kind == "q4k_sb"
        return jw, pw
    if kind == "Q8_0":
        qt = j_quantize((rng.standard_normal((N, K)) * 0.05).astype(np.float32), JType.Q8_0)
        return (j_qw.from_quantized_tensor(qt, scale_dtype=jnp.float32),
                QWeight.from_quantized_tensor(TQuantizedTensor(TType.Q8_0, qt.shape, qt.qs,
                                                               qt.scales, qt.mins)))
    raw = random_kquant(TType[kind], (N, K), rng).raw
    return (j_qw.from_kquant_raw(JType[kind], raw, (N, K), scale_dtype=jnp.float32,
                                 use_i4=False),
            QWeight.from_kquant_raw(TType[kind], raw, (N, K)))


def _interpret(fn):
    old = dispatch.get_backend()
    dispatch.set_backend("pallas_interpret")
    try:
        return np.asarray(fn())
    finally:
        dispatch.set_backend(old)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("rows", [1, 3, 8])
@pytest.mark.parametrize("norm", [False, True])
def test_walk_matches_the_pallas_matmul_at_every_split(kind, rows, norm):
    """Every form at every segment count and every part count (one segment)."""
    rng = np.random.default_rng(rows * 10 + norm)
    x = rng.standard_normal((rows, K)).astype(np.float32)
    g = (1.0 + 0.1 * rng.standard_normal(K)).astype(np.float32) if norm else None
    jw, pw = _weights(kind)
    jg = None if g is None else jnp.asarray(g)
    if kind == "Q4_K sb":  # the reference's XLA path cannot run the sb kind
        want = np.asarray(j_quant_matmul(jnp.asarray(x), jw, jg, interpret=True))
    else:
        want = _interpret(lambda: j_matmul(jnp.asarray(x), jw, jg))
    plans = [(s, 1) for s in _splits(K)] + [(1, p) for p in _parts(K) if p > 1]
    for s, p in plans:
        got = walk(t(x), pw, s, None if g is None else t(g), parts=p).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5,
                                   err_msg=f"splits {s}, parts {p}")


# -- kernel 2 -------------------------------------------------------------------

# Weights of std 0.02 (LLaMA's), so kernel 2's outputs stay of order 1 and
# atol 1e-5 measures f32 summation order: at 0.05 and these widths they
# reach ~100 and the plain version itself sits 1e-4 from the reference.
D, F, STD = 1024, 2048, 0.02
CFG = LlamaConfig.tiny(n_embd=D, n_ff=F)


def _group_code(kind, out_dim, in_dim, rng):
    if kind == "Q8_0":
        qt = j_quantize((rng.standard_normal((out_dim, in_dim)) * STD).astype(np.float32),
                        JType.Q8_0)
        return (j_qw.from_quantized_tensor(qt, scale_dtype=jnp.float32),
                QWeight.from_quantized_tensor(TQuantizedTensor(TType.Q8_0, qt.shape, qt.qs,
                                                               qt.scales, qt.mins)))
    raw = random_kquant(TType[kind], (out_dim, in_dim), rng, std=STD).raw
    return (j_qw.from_kquant_raw(JType[kind], raw, (out_dim, in_dim), scale_dtype=jnp.float32,
                                 use_i4=False),
            QWeight.from_kquant_raw(TType[kind], raw, (out_dim, in_dim)))


def _every_split_pair():
    """Every pair of the two launches' (splits, parts) the walk takes."""
    def plans(k):
        return [(s, 1) for s in _splits(k)] + [(1, p) for p in _parts(k) if p > 1]

    return [(a, b) for a in plans(D) for b in plans(F)]


@pytest.mark.parametrize("kinds", [("Q8_0", "Q8_0"), ("Q4_K", "Q6_K"), ("Q4_K", "Q4_K")])
@pytest.mark.parametrize("rows", [1, 3, 8])
def test_kernel2_walk_matches_the_pallas_fused_ffn(kinds, rows):
    rng = np.random.default_rng(rows + 5)
    x = rng.standard_normal((rows, D)).astype(np.float32)
    gain = (1.0 + 0.1 * rng.standard_normal(D)).astype(np.float32)
    j13, p13 = _group_code(kinds[0], 2 * F, D, rng)
    j2, p2 = _group_code(kinds[1], D, F, rng)
    want = np.asarray(j_fused_ffn(jnp.asarray(x), j13, j2, jnp.asarray(gain),
                                  eps=CFG.rms_norm_eps, interpret=True))
    for splits in _every_split_pair():
        got = kernel2(t(x), p13, p2, t(gain), splits).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5, err_msg=f"plans {splits}")


@pytest.mark.parametrize("rows", [1, 3, 8])
def test_kernel2_walk_matches_the_ffn_block_over_q4_0(rows):
    rng = np.random.default_rng(rows + 9)
    x = rng.standard_normal((rows, D)).astype(np.float32)
    q13, p13 = jax_q4((rng.standard_normal((D, 2 * F)) * STD).astype(np.float32))
    q2, p2 = jax_q4((rng.standard_normal((F, D)) * STD).astype(np.float32))
    gain = (1.0 + 0.1 * rng.standard_normal(D)).astype(np.float32)
    lp = LayerParams(wq=None, wk=None, wv=None, wo=None, w1=None, w2=q2, w3=None,
                     attn_norm=None, ffn_norm=jnp.asarray(gain), w13=q13)
    want = _interpret(lambda: _ffn_block(CFG, jnp.asarray(x), lp))
    for splits in _every_split_pair():
        got = kernel2(t(x), p13, p2, t(gain), splits).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5, err_msg=f"plans {splits}")


def test_kernel2_walk_over_super_blocks_is_the_plain_versions():
    """An sb w13 (SbReader's s and m): the walk against the plain version
    (the reference's sb dequantization, tests/test_torch_q4k_sb.py)."""
    g = torch.Generator().manual_seed(4)
    w13, w2 = QWeight.random(D, 2 * F, "q4k_sb", g), QWeight.random(F, D, "q4_k", g)
    x = torch.randn(3, D, generator=g)
    gain = 1.0 + 0.1 * torch.randn(D, generator=g)
    want = ffn.fused_ffn_plain(x, w13, w2, gain)
    for splits in _every_split_pair():
        torch.testing.assert_close(kernel2(x, w13, w2, gain, splits), want, rtol=1e-4,
                                   atol=1e-5)


# -- kernel 15 ------------------------------------------------------------------

# The widths of the reference's kernel 15 tiles (D in 512, F in 256): Dq = D
# = F = 512, 16 slots, which the walk takes in 1 or 2 segments or 2 parts.
DO, FO = 512, 512


def kernel15(ctx, x, wo, w13, w2, gain, plans):
    """Kernel 15's three launches, each at its (splits, parts): Wo with x's
    residual into an f32 x', then kernel 2's gate/up (the norm from x''s
    f32 rows, SwiGLU into f32 h) and down with x' as the residual; y
    rounded once to x's type."""
    (so, po), *rest = plans
    xp = walk(ctx, wo, so, residual=x, parts=po)
    return kernel2(xp, w13, w2, gain, rest).to(x.dtype)


def _owo_plans():
    """Every triple of the three launches' (splits, parts) the walk takes."""
    def plans(k):
        return [(s, 1) for s in _splits(k)] + [(1, p) for p in _parts(k) if p > 1]

    return [(a, b, c) for a in plans(DO) for b in plans(DO) for c in plans(FO)]


def _owo_weight(kind, k, n, rng):
    """(the reference's QWeight, the port's) of a [k, n] weight: Q4_0 (the
    reference's i4 form, which its kernel 15 takes), Q8_0 or a k-quant."""
    if kind == "Q4_0":
        jw, pw = jax_q4((rng.standard_normal((k, n)) * STD).astype(np.float32))
        return j_qw.q4_packed_to_i4(jw), pw
    return _group_code(kind, n, k, rng)


@pytest.mark.parametrize("kind", ["Q4_0", "Q8_0"])
@pytest.mark.parametrize("rows", [1, 2, 8])
def test_kernel15_walks_match_the_pallas_owo_ffn(kind, rows):
    rng = np.random.default_rng(rows + 20)
    (jwo, pwo), (j13, p13), (j2, p2) = (_owo_weight(kind, k, n, rng)
                                        for k, n in ((DO, DO), (DO, 2 * FO), (FO, DO)))
    ctx, x = (rng.standard_normal((rows, DO)).astype(np.float32) for _ in range(2))
    gain = (1.0 + 0.1 * rng.standard_normal(DO)).astype(np.float32)
    want = np.asarray(j_fused_owo_ffn(jnp.asarray(ctx), jnp.asarray(x), jwo, j13, j2,
                                      jnp.asarray(gain), eps=EPS, interpret=True))
    for plans in _owo_plans():
        got = kernel15(t(ctx), t(x), pwo, p13, p2, t(gain), plans).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5, err_msg=f"plans {plans}")


@pytest.mark.parametrize("kinds", [("Q6_K", "Q6_K", "Q6_K"), ("Q8_0", "Q8_0", "Q4_K")],
                         ids=["g16-wo-w13", "w2-with-mins"])
def test_kernel15_walks_match_the_oracle_where_the_reference_misreads(kinds):
    """Forms the reference's kernel 15 misreads (it reads every scale as
    one of a G 32 block and drops w2's mins): the walks against kernel 15's
    function in float64 numpy over the port's dequantized weights."""
    rng = np.random.default_rng(len(kinds[0]) + 30)
    ws = [_owo_weight(k, kk, n, rng)[1] for k, (kk, n) in
          zip(kinds, ((DO, DO), (DO, 2 * FO), (FO, DO)))]
    wo, w13, w2 = (w.dequantize(torch.float32).double().numpy() for w in ws)
    ctx, x = (rng.standard_normal((2, DO)) for _ in range(2))
    gain = 1.0 + 0.1 * rng.standard_normal(DO)
    xp = x + ctx @ wo
    gu = xp / np.sqrt((xp * xp).mean(-1, keepdims=True) + EPS) * gain @ w13
    g, u = gu[:, :FO], gu[:, FO:]
    want = xp + (g / (1 + np.exp(-g)) * u) @ w2
    args = [t(a.astype(np.float32)) for a in (ctx, x)]
    for plans in _owo_plans():
        got = kernel15(*args, *ws, t(gain.astype(np.float32)), plans).double().numpy()
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5, err_msg=f"plans {plans}")


# -- CPU tensors -----------------------------------------------------------------


def test_cpu_tensors_run_the_plain_versions_and_count_nothing():
    _, w = _weights("Q4_K")
    g = torch.Generator().manual_seed(1)
    x = torch.randn(3, K, generator=g)
    gain = 1.0 + 0.1 * torch.randn(K, generator=g)
    w13, w2 = QWeight.random(D, 2 * F, "q4_k", g), QWeight.random(F, D, "q6_k", g)
    xf = torch.randn(2, D, generator=g)
    gf = 1.0 + 0.1 * torch.randn(D, generator=g)
    before = (dict(qmatmul.launches), dict(ffn.launches))
    for s in (None, 1, 3):
        assert torch.equal(qmatmul.quant_matmul_at(x, w, gain, splits=s, stages=s),
                           qmatmul.quant_matmul_plain(x, w, gain))
        plans = None if s is None else ((s, 2), (s, 3))
        assert torch.equal(ffn.fused_ffn_at(xf, w13, w2, gf, plans=plans),
                           ffn.fused_ffn_plain(xf, w13, w2, gf))
    assert (qmatmul.launches, ffn.launches) == before
