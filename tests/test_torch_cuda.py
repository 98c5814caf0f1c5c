"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU and skips without one (a CUDA kernel
has no CPU mode).  The file imports nothing of jax, so it also runs on
the GPU machine, where jax is absent and tests/conftest.py (which imports
jax) cannot load:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

Tolerances: bfloat16 results differ from the plain versions by about one
output rounding (both accumulate in f32): 2^-7 of the largest |value|;
float32 results by summation order: 1e-4 of it.  Written cache rows are
compared exactly, and so are the int8 kernels' quantized rows and
dequantized gathers (the codec is bit for bit; a code times a bfloat16
scale is exact in f32).
"""

import numpy as np
import pytest
import torch

from tokenhawk_tpu_torch.config import LlamaConfig
from tokenhawk_tpu_torch.ggml.quants import quantize_q4_0
from tokenhawk_tpu_torch.ggml.writer import write_ggml
from tokenhawk_tpu_torch.models import llama as tl
from tokenhawk_tpu_torch.ops.cuda import (
    ffn,
    flash_attention,
    flash_decode,
    kv_int8,
    paged_decode,
    paged_int8,
    qmatmul,
)
from tokenhawk_tpu_torch.ops.kvquant import quantize_kv_block
from tokenhawk_tpu_torch.ops.qweight import QWeight
from tokenhawk_tpu_torch.runtime.engine import make_prefill_fn
from tokenhawk_tpu_torch.runtime.loader import load_model

from torch_helpers import cuda_device, padded_vocab

pytestmark = pytest.mark.cuda
Dh = 128
# The dense-cache attention kernels (3, 4, 8, 9, 14) take both: 128 for
# LLaMA-7B, 64 for a TinyLlama-width draft.
HEAD_DIMS = [128, 64]


def _tol(ref, dtype):
    return (2.0**-7 if dtype == torch.bfloat16 else 1e-4) * ref.float().abs().max().item()


def _err(a, b):
    return (a.float() - b.float()).abs().max().item()


@pytest.mark.parametrize("K,N", [(4096, 4096), (11008, 512), (704, 256)])
@pytest.mark.parametrize("rows", [1, 3, 8, 64])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_q4_matmul_kernel_matches_plain(K, N, rows, dtype):
    dev = cuda_device()
    g = torch.Generator(device=dev).manual_seed(K + rows)
    w = QWeight.quantize(torch.randn(K, N, generator=g, device=dev) * 0.02)
    x = torch.randn(rows, K, generator=g, device=dev).to(dtype)
    gain = (1 + 0.1 * torch.randn(K, generator=g, device=dev)).to(dtype)
    for ng in (None, gain):
        before = qmatmul.launches["q4_matmul"]
        got = qmatmul.quant_matmul(x, w, ng)
        assert qmatmul.launches["q4_matmul"] == before + 1
        want = qmatmul.quant_matmul_plain(x, w, ng)
        assert _err(got, want) <= _tol(want, dtype)


@pytest.mark.parametrize("rows", [1, 2, 5, 8])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_fused_ffn_kernel_matches_plain(rows, dtype):
    dev = cuda_device()
    g = torch.Generator(device=dev).manual_seed(rows)
    D, F = 4096, 11008
    w13 = QWeight.quantize(torch.randn(D, 2 * F, generator=g, device=dev) * 0.02)
    w2 = QWeight.quantize(torch.randn(F, D, generator=g, device=dev) * 0.02)
    x = torch.randn(rows, D, generator=g, device=dev).to(dtype)
    gain = (1 + 0.1 * torch.randn(D, generator=g, device=dev)).to(dtype)
    got = ffn.fused_ffn(x, w13, w2, gain)
    want = ffn.fused_ffn_plain(x, w13, w2, gain)
    assert _err(got, want) <= _tol(want, dtype)


# The group-code forms (G, with mins) and a GGML kind of each: Q8_0
# (32, no mins), Q4_K (32, mins), Q6_K (16, no mins), Q2_K (16, mins).
QK_FORMS = [(32, False), (32, True), (16, False), (16, True)]


def _weight(form, K, N, g, dev):
    """A random [K, N] QWeight of `form`: "q4_0" or a (G, mins) pair."""
    if form == "q4_0":
        return QWeight.quantize(torch.randn(K, N, generator=g, device=dev) * 0.02)
    group, mins = form
    codes = torch.randint(-32, 32, (N, K), generator=g, device=dev, dtype=torch.int8)
    s = (0.5 + torch.rand(N, K // group, generator=g, device=dev)) * 1e-3
    m = -16 * s * torch.rand(N, K // group, generator=g, device=dev) if mins else None
    return QWeight.from_group_codes(codes, s, m, group)


@pytest.mark.parametrize("K,N", [(4096, 1024), (14336, 256), (800, 100)])  # 800: 25 slots
@pytest.mark.parametrize("form", QK_FORMS)
@pytest.mark.parametrize("rows", [1, 8, 33])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_qk_matmul_kernel_matches_plain(K, N, form, rows, dtype):
    dev = cuda_device()
    g = torch.Generator(device=dev).manual_seed(K + rows)
    w = _weight(form, K, N, g, dev)
    x = torch.randn(rows, K, generator=g, device=dev).to(dtype)
    gain = (1 + 0.1 * torch.randn(K, generator=g, device=dev)).to(dtype)
    for ng in (None, gain):
        before = qmatmul.launches["qk_matmul"]
        got = qmatmul.quant_matmul(x, w, ng)
        assert qmatmul.launches["qk_matmul"] == before + 1
        want = qmatmul.quant_matmul_plain(x, w, ng)
        assert got.shape == (rows, N) and got.dtype == dtype
        assert _err(got, want) <= _tol(want, dtype)


# w13 / w2 pairings: Q4_K_M's two, Q8_0's, and mixed ones with Q4_0.
FFN_PAIRS = [((32, True), (16, False)), ((32, True), (32, True)), ((32, False), (32, False)),
             ((16, True), "q4_0"), ("q4_0", (16, True))]


@pytest.mark.parametrize("pair", FFN_PAIRS)
@pytest.mark.parametrize("rows", [1, 5, 8])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_fused_ffn_kernel_matches_plain_over_every_form(pair, rows, dtype):
    dev = cuda_device()
    g = torch.Generator(device=dev).manual_seed(rows)
    D, F = 4096, 14336
    w13, w2 = _weight(pair[0], D, 2 * F, g, dev), _weight(pair[1], F, D, g, dev)
    x = torch.randn(rows, D, generator=g, device=dev).to(dtype)
    gain = (1 + 0.1 * torch.randn(D, generator=g, device=dev)).to(dtype)
    key = "ffn[{}/{}]".format(*(qmatmul.FORM_NAMES[qmatmul.form_code(w)] for w in (w13, w2)))
    before = dict(ffn.launches)
    got = ffn.fused_ffn(x, w13, w2, gain)
    assert ffn.launches == {**before, key: before[key] + 1}
    want = ffn.fused_ffn_plain(x, w13, w2, gain)
    assert _err(got, want) <= _tol(want, dtype)


@pytest.mark.parametrize("K,N", [(1024, 768), (4096, 1024)])
@pytest.mark.parametrize("rows", [1, 8, 64])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_qk_sb_matmul_kernel_matches_plain(K, N, rows, dtype):
    """Kernel 17 over Q4_K super-blocks, with and without the norm; kernel
    13 over the flat form of the same codes computes the same function."""
    dev = cuda_device()
    g = torch.Generator(device=dev).manual_seed(K + rows)
    w = QWeight.random(K, N, "q4k_sb", g, dev)
    x = torch.randn(rows, K, generator=g, device=dev).to(dtype)
    gain = (1 + 0.1 * torch.randn(K, generator=g, device=dev)).to(dtype)
    for ng in (None, gain):
        before = dict(qmatmul.launches)
        got = qmatmul.quant_matmul(x, w, ng)
        assert qmatmul.launches == {**before, "qk_sb_matmul": before["qk_sb_matmul"] + 1}
        want = qmatmul.quant_matmul_plain(x, w, ng)
        assert got.shape == (rows, N) and got.dtype == dtype
        assert _err(got, want) <= _tol(want, dtype)
        assert _err(qmatmul.quant_matmul(x, w.flat(), ng), want) <= _tol(want, dtype)


@pytest.mark.parametrize("w2_form", [(16, False), (32, True)])  # Q6_K, flat Q4_K
@pytest.mark.parametrize("rows", [1, 8])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_fused_ffn_kernel_takes_an_sb_w13(w2_form, rows, dtype):
    """Kernel 2 with a super-block w13 (Llama-3-8B widths); an sb w2 is
    refused, as the reference's gate refuses it."""
    dev = cuda_device()
    g = torch.Generator(device=dev).manual_seed(rows)
    D, F = 4096, 14336
    w13, w2 = QWeight.random(D, 2 * F, "q4k_sb", g, dev), _weight(w2_form, F, D, g, dev)
    x = torch.randn(rows, D, generator=g, device=dev).to(dtype)
    gain = (1 + 0.1 * torch.randn(D, generator=g, device=dev)).to(dtype)
    assert ffn.can_fuse_ffn(w13, w2, rows)
    key = f"ffn[sb/{qmatmul.FORM_NAMES[qmatmul.form_code(w2)]}]"
    before = dict(ffn.launches)
    got = ffn.fused_ffn(x, w13, w2, gain)
    assert ffn.launches == {**before, key: before[key] + 1}
    want = ffn.fused_ffn_plain(x, w13, w2, gain)
    assert _err(got, want) <= _tol(want, dtype)
    sb2 = QWeight.random(F, D, "q4k_sb", g, dev)
    assert not ffn.can_fuse_ffn(w13, sb2, rows)
    with pytest.raises(ValueError):
        ffn.fused_ffn(x, w13, sb2, gain)


@pytest.mark.parametrize("form", ["q4_0", (32, False)])  # Q4_0 and Q8_0
@pytest.mark.parametrize("rows", [1, 8])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_owo_ffn_kernel_matches_plain(form, rows, dtype):
    """Kernel 15 at LLaMA-7B's widths, Wo, w13 and w2 in one form."""
    dev = cuda_device()
    g = torch.Generator(device=dev).manual_seed(rows)
    D, F = 4096, 11008
    wo, w13, w2 = (_weight(form, k, n, g, dev) for k, n in ((D, D), (D, 2 * F), (F, D)))
    ctx = torch.randn(rows, D, generator=g, device=dev).to(dtype)
    x = torch.randn(rows, D, generator=g, device=dev).to(dtype)
    gain = (1 + 0.1 * torch.randn(D, generator=g, device=dev)).to(dtype)
    assert ffn.can_fuse_owo_ffn(wo, w13, w2, rows)
    name = qmatmul.FORM_NAMES[qmatmul.form_code(w13)]
    key = f"owo_ffn[{name}/{name}]"
    before = dict(ffn.launches)
    got = ffn.fused_owo_ffn(ctx, x, wo, w13, w2, gain)
    assert ffn.launches == {**before, key: before[key] + 1}
    want = ffn.fused_owo_ffn_plain(ctx, x, wo, w13, w2, gain)
    assert got.shape == (rows, D) and got.dtype == dtype
    assert _err(got, want) <= _tol(want, dtype)


@pytest.mark.parametrize("pair", FFN_PAIRS)
def test_owo_ffn_kernel_matches_plain_over_every_form(pair):
    """Kernel 15 over every weight form (Wo in w13's form), 5 rows."""
    dev = cuda_device()
    g = torch.Generator(device=dev).manual_seed(5)
    D, F = 1024, 2048
    wo, w13 = _weight(pair[0], D, D, g, dev), _weight(pair[0], D, 2 * F, g, dev)
    w2 = _weight(pair[1], F, D, g, dev)
    ctx, x = (torch.randn(5, D, generator=g, device=dev).bfloat16() for _ in range(2))
    gain = (1 + 0.1 * torch.randn(D, generator=g, device=dev)).bfloat16()
    got = ffn.fused_owo_ffn(ctx, x, wo, w13, w2, gain)
    want = ffn.fused_owo_ffn_plain(ctx, x, wo, w13, w2, gain)
    assert _err(got, want) <= _tol(want, torch.bfloat16)


@pytest.mark.parametrize("Dh", HEAD_DIMS)
@pytest.mark.parametrize("form", ["q4_0", (32, False)])  # Q4_0 and Q8_0
@pytest.mark.parametrize("length", [1, 37, 512])
@pytest.mark.parametrize("cache_dtype", [torch.bfloat16, torch.float32])
def test_attn_wo_kernel_matches_plain(form, length, cache_dtype, Dh):
    """Kernel 16 at LLaMA-7B's widths (32 heads of 128; also 64 heads of
    64), n_ctx 512: the appended rows exactly, x' within tolerance."""
    dev = cuda_device()
    g = torch.Generator(device=dev).manual_seed(length + Dh)
    D, S = 4096, 512
    H = D // Dh
    wo = _weight(form, D, D, g, dev)
    q, kn, vn = (torch.randn(1, 1, H, Dh, generator=g, device=dev).bfloat16()
                 for _ in range(3))
    x = torch.randn(1, 1, D, generator=g, device=dev).bfloat16()
    kc, vc = (torch.randn(1, H, S, Dh, generator=g, device=dev).to(cache_dtype)
              for _ in range(2))
    kp, vp = kc.clone(), vc.clone()
    lengths = torch.tensor([length], dtype=torch.int32, device=dev)
    before = flash_decode.launches["attn_wo"]
    got = flash_decode.fused_attn_out(x, q, kn, vn, kc, vc, lengths, wo)
    assert flash_decode.launches["attn_wo"] == before + 1
    want = flash_decode.fused_attn_out_plain(x, q, kn, vn, kp, vp, lengths, wo)
    assert torch.equal(kc, kp) and torch.equal(vc, vp)
    assert got.shape == (1, 1, D) and got.dtype == torch.bfloat16
    assert _err(got, want) <= _tol(want, torch.bfloat16)


@pytest.mark.parametrize("Dh", HEAD_DIMS)
@pytest.mark.parametrize("rep", [1, 2, 4, 8])
@pytest.mark.parametrize("cache_dtype", [torch.bfloat16, torch.float32])
def test_append_attend_kernel_matches_plain(rep, cache_dtype, Dh):
    dev = cuda_device()
    g = torch.Generator(device=dev).manual_seed(rep)
    B, Hkv, S = 4, 4, 512
    lengths = torch.tensor([1, 33, 300, S + 5], dtype=torch.int32, device=dev)  # last clamps
    q = (torch.randn(B, Hkv, rep, Dh, generator=g, device=dev) / Dh**0.5).bfloat16()
    kn = torch.randn(B, Hkv, Dh, generator=g, device=dev).bfloat16()
    vn = torch.randn(B, Hkv, Dh, generator=g, device=dev).bfloat16()
    kc = torch.randn(B, Hkv, S, Dh, generator=g, device=dev).to(cache_dtype)
    vc = torch.randn(B, Hkv, S, Dh, generator=g, device=dev).to(cache_dtype)
    kp, vp = kc.clone(), vc.clone()
    got = flash_decode.flash_decode_append(q, kn, vn, kc, vc, lengths)
    want = flash_decode.flash_decode_append_plain(q, kn, vn, kp, vp, lengths)
    assert torch.equal(kc, kp) and torch.equal(vc, vp)
    assert _err(got, want) <= _tol(want, torch.bfloat16)


@pytest.mark.parametrize("Dh", HEAD_DIMS)
@pytest.mark.parametrize("rep", [1, 4, 8])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_decode_attend_kernel_matches_plain(rep, dtype, Dh):
    """Kernel 14 (no append): lengths 1 .. S and one past S (clamped),
    q and cache in `dtype`; the cache is left untouched."""
    dev = cuda_device()
    g = torch.Generator(device=dev).manual_seed(rep + Dh)
    B, Hkv, S = 6, 4, 512
    lengths = torch.tensor([1, 2, 31, 33, 300, S + 5], dtype=torch.int32, device=dev)
    q = (torch.randn(B, Hkv, rep, Dh, generator=g, device=dev) / Dh**0.5).to(dtype)
    kc = torch.randn(B, Hkv, S, Dh, generator=g, device=dev).to(dtype)
    vc = torch.randn(B, Hkv, S, Dh, generator=g, device=dev).to(dtype)
    kp, vp = kc.clone(), vc.clone()
    before = dict(flash_decode.launches)
    got = flash_decode.flash_decode(q, kc, vc, lengths)
    assert flash_decode.launches == {**before, "flash_decode_attend":
                                     before["flash_decode_attend"] + 1}
    want = flash_decode.flash_decode_plain(q, kc, vc, lengths)
    assert torch.equal(kc, kp) and torch.equal(vc, vp)
    assert got.shape == q.shape and got.dtype == dtype
    assert _err(got, want) <= _tol(want, dtype)


@pytest.mark.parametrize("Dh", HEAD_DIMS)
@pytest.mark.parametrize("T,offset", [(64, 0), (16, 200), (13, 5), (512, 0)])
@pytest.mark.parametrize("rep", [1, 4])
def test_prefill_attention_kernel_matches_plain(T, offset, rep, Dh):
    dev = cuda_device()
    g = torch.Generator(device=dev).manual_seed(T + offset)
    B, Hkv, S = 2, 4, 512
    q = (torch.randn(B, Hkv, rep, T, Dh, generator=g, device=dev) / Dh**0.5).bfloat16()
    kc = torch.randn(B, Hkv, S, Dh, generator=g, device=dev).bfloat16()
    vc = torch.randn(B, Hkv, S, Dh, generator=g, device=dev).bfloat16()
    offsets = torch.tensor([offset, 0], dtype=torch.int32, device=dev)
    got = flash_attention.flash_attention(q, kc, vc, offsets)
    want = flash_attention.flash_attention_plain(q, kc, vc, offsets)
    assert _err(got, want) <= _tol(want, torch.bfloat16)


def _close_f32(got, want):
    """Partials in f32 from one function summed in other orders: within 1e-4
    of the largest |value|; infinities (the merge identity's m) equal."""
    inf = torch.isinf(want)
    assert torch.equal(torch.isinf(got), inf) and torch.equal(got[inf], want[inf])
    assert _err(got[~inf], want[~inf]) <= 1e-4 * want[~inf].abs().max().item()


@pytest.mark.parametrize("Dh", HEAD_DIMS)
@pytest.mark.parametrize("stride,q_start,k_start", [(1, [0, 64], [0, 16]), (4, [3, 1], [2, 9])])
@pytest.mark.parametrize("cache_dtype", [torch.bfloat16, torch.float32])
def test_attention_stats_kernel_matches_plain(stride, q_start, k_start, cache_dtype, Dh):
    """Kernel 19 (ring-attention step): rows that see no key of the block
    give (0, _MASK, 0) in both."""
    dev = cuda_device()
    g = torch.Generator(device=dev).manual_seed(stride + Dh)
    B, Hkv, rep, T, S = 2, 4, 2, 77, 100
    q = torch.randn(B, Hkv, rep, T, Dh, generator=g, device=dev) / Dh**0.5
    kc = torch.randn(B, Hkv, S, Dh, generator=g, device=dev).to(cache_dtype)
    vc = torch.randn(B, Hkv, S, Dh, generator=g, device=dev).to(cache_dtype)
    qs, ks = (torch.tensor(x, dtype=torch.int32, device=dev) for x in (q_start, k_start))
    before = flash_attention.launches["flash_attention_stats"]
    got = flash_attention.flash_attention_stats(q, kc, vc, qs, ks, stride)
    assert flash_attention.launches["flash_attention_stats"] == before + 1
    want = flash_attention.flash_attention_stats_plain(q, kc, vc, qs, ks, stride)
    for a, b in zip(got, want):
        assert a.shape == b.shape and a.dtype == torch.float32
        _close_f32(a, b)


@pytest.mark.parametrize("splits", [1, 5])
@pytest.mark.parametrize("Dh", HEAD_DIMS)
@pytest.mark.parametrize("rep", [1, 2, 4, 8])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_decode_stats_kernel_matches_plain(rep, dtype, Dh, splits):
    """Kernel 18 over a strided view (every other row of a larger cache),
    lengths 0 .. S and one past S; empty ranges give (0, -inf, 0) exactly."""
    dev = cuda_device()
    g = torch.Generator(device=dev).manual_seed(rep + Dh + splits)
    B, Hkv, S = 6, 4, 512
    lengths = torch.tensor([0, 1, 31, 33, 300, S + 5], dtype=torch.int32, device=dev)
    q = (torch.randn(B, Hkv, rep, Dh, generator=g, device=dev) / Dh**0.5).to(dtype)
    big = [torch.randn(B, Hkv, 2 * S, Dh, generator=g, device=dev).to(dtype) for _ in range(2)]
    kc, vc = (c[:, :, 1::2] for c in big)
    before = flash_decode.launches["flash_decode_stats"]
    got = flash_decode.flash_decode_stats(q, kc, vc, lengths, splits)
    assert flash_decode.launches["flash_decode_stats"] == before + 1
    want = flash_decode.flash_decode_stats_plain(q, kc, vc, lengths, splits)
    assert torch.all(got[0][:, 0] == 0) and torch.all(got[1][:, 0] == -torch.inf)
    for a, b in zip(got, want):
        assert a.shape == b.shape and a.dtype == torch.float32
        _close_f32(a, b)


def test_stats_kernels_refuse_bad_input():
    dev = cuda_device()
    one = torch.ones(1, dtype=torch.int32, device=dev)
    c = torch.zeros(1, 2, 128, 128, device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError):  # kernel 19 takes an f32 q
        flash_attention.flash_attention_stats(torch.zeros(1, 2, 1, 4, 128, device=dev,
                                                          dtype=torch.bfloat16), c, c, one, one)
    with pytest.raises(ValueError):  # kernel 18 takes q in the cache's type
        flash_decode.flash_decode_stats(torch.zeros(1, 2, 1, 128, device=dev), c, c, one)
    wide = torch.zeros(1, 2, 256, 128, device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError):  # k and v with other strides
        flash_decode.flash_decode_stats(torch.zeros(1, 2, 1, 128, device=dev,
                                                    dtype=torch.bfloat16), c, wide[:, :, ::2], one)


def test_kernel_refuses_bad_input():
    """A wrapper raises on what its kernel does not take; no fallback."""
    dev = cuda_device()
    w = QWeight.quantize(torch.randn(256, 128, device=dev))
    with pytest.raises(ValueError):
        qmatmul.quant_matmul(torch.randn(2, 128, device=dev), w)  # K mismatch
    with pytest.raises(ValueError):  # weights left on the CPU
        qmatmul.quant_matmul(torch.randn(2, 256, device=dev), w.to("cpu"))
    with pytest.raises(ValueError):  # no kernel form for group 64
        qmatmul.quant_matmul(torch.randn(2, 256, device=dev), QWeight(
            torch.zeros(8, 256, dtype=torch.int8, device=dev), torch.ones(8, 4, device=dev),
            kind="qk", group=64))
    with pytest.raises(ValueError):  # K not a multiple of 32
        qmatmul.quant_matmul(torch.randn(2, 48, device=dev), QWeight(
            torch.zeros(8, 48, dtype=torch.int8, device=dev), torch.ones(8, 3, device=dev),
            kind="qk", group=16))
    q = torch.randn(1, 2, 1, 96, device=dev)  # head dim 96 is not a kernel shape
    c = torch.zeros(1, 2, 128, 96, device=dev)
    one = torch.ones(1, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):
        flash_decode.flash_decode_append(q, q[:, :, 0], q[:, :, 0], c, c.clone(), one)
    with pytest.raises(ValueError):
        flash_decode.flash_decode(q, c, c.clone(), one)
    with pytest.raises(ValueError):  # 3 query heads per kv head
        flash_decode.flash_decode(torch.randn(1, 2, 3, 64, device=dev),
                                  *[torch.zeros(1, 2, 128, 64, device=dev)] * 2, one)
    pool = torch.zeros(4, 2, 16, 96, device=dev)  # paged pools of head dim 96
    with pytest.raises(ValueError):
        paged_decode.paged_decode(q, pool, pool.clone(), torch.zeros(1, 4, dtype=torch.int32,
                                                                     device=dev), one, "contig")
    w = QWeight.quantize(torch.randn(256, 256, device=dev) * 0.02)
    x = torch.randn(9, 256, device=dev)
    with pytest.raises(ValueError):  # kernel 15 takes at most 8 rows
        ffn.fused_owo_ffn(x, x, w, QWeight.quantize(torch.randn(256, 512, device=dev)),
                          QWeight.quantize(torch.randn(256, 256, device=dev)), x[0])
    q = torch.randn(1, 1, 2, 128, device=dev)
    c = torch.zeros(1, 2, 128, 128, device=dev)
    with pytest.raises(ValueError):  # kernel 16 takes one query head per kv head
        flash_decode.fused_attn_out(x[:1, None], torch.randn(1, 1, 4, 64, device=dev),
                                    q, q, c, c.clone(), one, w)
    with pytest.raises(ValueError):  # x of another width than Wo's output
        flash_decode.fused_attn_out(x[:1, None, :128], q, q, q, c, c.clone(), one, w)


def test_slice_gpu_matches_cpu(tmp_path):
    """A tiny f32 Q4_0 model loaded on the card (the four kernels) and on
    the CPU (their plain versions): logits of prefill + 4 decode steps
    within 1e-3 of the largest |logit| (bf16 cache on both sides)."""
    dev = cuda_device()
    cfg = LlamaConfig.tiny(n_vocab=300, n_embd=256, n_head=2, n_layer=2, n_ff=512, n_ctx=256)
    rng = np.random.default_rng(5)
    D, F, V = cfg.n_embd, cfg.n_ff, cfg.n_vocab

    def w(*shape):
        return (rng.standard_normal(shape) * 0.05).astype(np.float32)

    tensors = {"tok_embeddings.weight": w(V, D), "norm.weight": 1 + w(D),
               "output.weight": quantize_q4_0(w(V, D))}
    for i in range(cfg.n_layer):
        p = f"layers.{i}."
        for name, shape in [("attention.wq", (D, D)), ("attention.wk", (D, D)),
                            ("attention.wv", (D, D)), ("attention.wo", (D, D)),
                            ("feed_forward.w1", (F, D)), ("feed_forward.w2", (D, F)),
                            ("feed_forward.w3", (F, D))]:
            tensors[p + name + ".weight"] = quantize_q4_0(w(*shape))
        tensors[p + "attention_norm.weight"] = 1 + w(D)
        tensors[p + "ffn_norm.weight"] = 1 + w(D)
    tokens, scores = padded_vocab(V)
    hp = dict(n_vocab=V, n_embd=D, n_mult=cfg.n_mult, n_head=cfg.n_head, n_layer=cfg.n_layer,
              n_rot=cfg.head_dim, ftype=2)
    write_ggml(tmp_path / "m.bin", hp, tokens, scores, tensors)

    ids = torch.tensor([1, 40, 41, 42, 43, 44, 45, 7, 8, 9, 10])
    n = len(ids) - 4

    def run(d):
        tcfg, params, _ = load_model(str(tmp_path / "m.bin"), n_ctx=256, dtype=torch.float32,
                                     device=d)
        cache = tl.KVCache.create(tcfg, 1, 256, torch.bfloat16, d)
        toks = torch.zeros(1, 16, dtype=torch.long)
        toks[0, :n] = ids[:n]
        _, logits = make_prefill_fn(tcfg)(params, cache, toks.to(d),
                                          torch.tensor([n], dtype=torch.int32, device=d),
                                          torch.zeros(1, dtype=torch.int32, device=d))
        out = [logits.cpu()]
        for i in range(4):
            off = torch.tensor([n + i], dtype=torch.int32, device=d)
            h, cache = tl.forward(tcfg, params, ids[None, n + i:n + i + 1].to(d), cache, off)
            out.append(tl.logits_from_hidden(tcfg, params, h[:, 0]).cpu())
        return out

    for a, b in zip(run(dev), run(torch.device("cpu"))):
        assert _err(a, b) <= 1e-3 * b.abs().max().item()


def _pools(g, dev, layout, Hkv, n_pages, ps, dtype, Dh=Dh):
    shape = (n_pages, Hkv, ps, Dh) if layout == "contig" else (Hkv, n_pages, ps, Dh)
    return [torch.randn(shape, generator=g, device=dev).to(dtype) for _ in range(2)]


@pytest.mark.parametrize("Dh", HEAD_DIMS)
@pytest.mark.parametrize("layout", ["contig", "head"])
@pytest.mark.parametrize("rep", [1, 2, 4, 8])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_paged_decode_kernel_matches_plain(layout, rep, dtype, Dh):
    """4 KV heads: at Dh 64 and rep 8, TinyLlama's heads."""
    dev = cuda_device()
    g = torch.Generator(device=dev).manual_seed(rep)
    B, Hkv, ps, mp, n_pages = 5, 4, 128, 4, 24
    kp, vp = _pools(g, dev, layout, Hkv, n_pages, ps, dtype, Dh)
    table = torch.randperm(n_pages, generator=g, device=dev)[:B * mp].reshape(B, mp).int()
    lengths = torch.tensor([1, 37, 128, 129, 0], dtype=torch.int32, device=dev)
    q = (torch.randn(B, Hkv, rep, Dh, generator=g, device=dev) / Dh**0.5).to(dtype)
    got = paged_decode.paged_decode(q, kp, vp, table, lengths, layout)
    want = paged_decode.paged_decode_plain(q, kp, vp, table, lengths, layout)
    assert torch.equal(got[4], torch.zeros_like(got[4]))  # length 0 -> zeros, not NaN
    assert _err(got, want) <= _tol(want, dtype)


@pytest.mark.parametrize("Dh", HEAD_DIMS)
@pytest.mark.parametrize("layout", ["contig", "head"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_paged_append_and_gather_kernels_match_plain(layout, dtype, Dh):
    """Exact: distinct slots of one page all land; two rows on the trash
    page (page 0) leave it unspecified, so it is left out."""
    dev = cuda_device()
    g = torch.Generator(device=dev).manual_seed(7)
    Hkv, ps, n_pages = 4, 128, 10
    kp, vp = _pools(g, dev, layout, Hkv, n_pages, ps, dtype, Dh)
    kq, vq = kp.clone(), vp.clone()
    page = torch.tensor([3, 0, 3, 0, 8], dtype=torch.int32, device=dev)
    slot = torch.tensor([5, 9, 127, 9, 0], dtype=torch.int32, device=dev)
    kn = torch.randn(5, Hkv, Dh, generator=g, device=dev).to(dtype)
    vn = torch.randn(5, Hkv, Dh, generator=g, device=dev).to(dtype)
    paged_decode.paged_append(kp, vp, kn, vn, page, slot, layout)
    paged_decode.paged_append_plain(kq, vq, kn, vn, page, slot, layout)
    live = slice(1, None)
    for a, b in ((kp, kq), (vp, vq)):
        if layout == "contig":
            assert torch.equal(a[live], b[live])
        else:
            assert torch.equal(a[:, live], b[:, live])
    table = torch.randint(0, n_pages, (3, 5), generator=g, device=dev, dtype=torch.int32)
    got = paged_decode.gather_pages(kp, vp, table, layout)
    want = paged_decode.gather_pages_plain(kp, vp, table, layout)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_paged_forward_decode_matches_dense_on_the_card():
    """A tiny 2-layer model (head dim 128) on the card: prefill 120 tokens
    into pages, then 12 decode steps across the page boundary, against the
    dense forward: logits within 1e-3 of the largest (f32 everything)."""
    from tokenhawk_tpu_torch.runtime.paged import PagedKVCache

    dev = cuda_device()
    cfg = LlamaConfig.tiny(n_vocab=300, n_embd=256, n_head=2, n_layer=2, n_ff=512, n_ctx=256)
    g = torch.Generator(device=dev).manual_seed(3)
    params = tl.fuse_params(tl.init_params(cfg, g, dtype=torch.float32, device=dev,
                                           scale=0.05, quant="q4_0"))
    ids = torch.randint(3, 300, (1, 132), generator=g, device=dev)
    cache = tl.KVCache.create(cfg, 1, 256, torch.float32, dev)
    h_d, _ = tl.forward(cfg, params, ids[:, :120], cache, torch.zeros(1, dtype=torch.int32,
                                                                      device=dev))
    pool = PagedKVCache.create(cfg, 6, 128, torch.float32, dev)
    table = torch.tensor([[4, 1]], dtype=torch.int32, device=dev)
    h_p, _ = tl.forward_paged_prefill(cfg, params, ids[:, :120], pool, table)
    assert _err(h_p, h_d) <= 1e-3 * h_d.abs().max().item()
    for i in range(120, 132):
        pos = torch.tensor([i], dtype=torch.int32, device=dev)
        h_d, _ = tl.forward(cfg, params, ids[:, i:i + 1], cache, pos)
        h_p, _ = tl.forward_paged_decode(cfg, params, ids[:, i:i + 1], pool, table, pos)
        a = tl.logits_from_hidden(cfg, params, h_p[:, 0])
        b = tl.logits_from_hidden(cfg, params, h_d[:, 0])
        assert _err(a, b) <= 1e-3 * b.abs().max().item()


# ---------------------------------------------------------------------------
# The int8 KV cache: kernels 8-12
# ---------------------------------------------------------------------------


def _int8(g, dev, *shape):
    codes, scales = quantize_kv_block(torch.randn(shape, generator=g, device=dev))
    return codes, scales


@pytest.mark.parametrize("Dh", HEAD_DIMS)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_int8_codec_on_the_card_is_the_cpus(dtype, Dh):
    """The codec bit for bit on 8192 rows (the CPU's matches JAX's, see
    tests/test_torch_kvquant.py): the plain version on the card, and the
    quantizing append (kernel 11) on 64 sequences of 32 K and V heads,
    against the plain version on the CPU."""
    dev = cuda_device()
    g = torch.Generator(device=dev).manual_seed(11)
    B, Hkv, ps = 64, 32, 128
    spread = torch.exp(4 * torch.randn(B, Hkv, 1, generator=g, device=dev))
    kn = (torch.randn(B, Hkv, Dh, generator=g, device=dev) * spread).to(dtype)
    vn = (torch.randn(B, Hkv, Dh, generator=g, device=dev) * spread).to(dtype)
    want = [quantize_kv_block(x.cpu()) for x in (kn, vn)]
    for (q, s), (wq, ws) in zip((quantize_kv_block(kn), quantize_kv_block(vn)), want):
        assert torch.equal(q.cpu(), wq) and torch.equal(s.cpu(), ws)
    codes = torch.zeros(B, Hkv, ps, Dh, dtype=torch.int8, device=dev)
    scales = torch.zeros(B, Hkv, ps, device=dev)
    pool = [codes, scales, codes.clone(), scales.clone()]  # k, ks, v, vs
    page = torch.arange(B, dtype=torch.int32, device=dev)
    slot = torch.full((B,), 77, dtype=torch.int32, device=dev)
    paged_int8.paged_append_int8(*pool, kn, vn, page, slot, "contig")
    for (codes, scales), (wq, ws) in zip(((pool[0], pool[1]), (pool[2], pool[3])), want):
        assert torch.equal(codes[:, :, 77].cpu(), wq)
        assert torch.equal(scales[:, :, 77].cpu(), ws.float())


@pytest.mark.parametrize("Dh", HEAD_DIMS)
@pytest.mark.parametrize("rep", [1, 2, 4, 8])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_decode_int8_kernel_matches_plain(rep, dtype, Dh):
    """Kernel 8: the appended codes and scales exactly, the output within
    one output rounding; a row of length 0 gives zeros and appends
    nothing; the last length clamps to S."""
    dev = cuda_device()
    g = torch.Generator(device=dev).manual_seed(rep)
    B, Hkv, S = 5, 4, 512
    k, ks = _int8(g, dev, B, Hkv, S, Dh)
    v, vs = _int8(g, dev, B, Hkv, S, Dh)
    cache = [k, ks, v, vs]
    plain = [c.clone() for c in cache]
    lengths = torch.tensor([1, 33, 300, S + 5, 0], dtype=torch.int32, device=dev)
    q = (torch.randn(B, Hkv, rep, Dh, generator=g, device=dev) / Dh**0.5).to(dtype)
    kn = torch.randn(B, Hkv, Dh, generator=g, device=dev).to(dtype)
    vn = torch.randn(B, Hkv, Dh, generator=g, device=dev).to(dtype)
    before = kv_int8.launches["flash_decode_int8"]
    got = kv_int8.flash_decode_int8(q, kn, vn, *cache, lengths)
    assert kv_int8.launches["flash_decode_int8"] == before + 1
    want = kv_int8.flash_decode_int8_plain(q, kn, vn, *plain, lengths)
    for a, b in zip(cache, plain):
        assert torch.equal(a, b)
    assert torch.equal(got[4], torch.zeros_like(got[4]))
    assert _err(got, want) <= _tol(want, dtype)


@pytest.mark.parametrize("Dh", HEAD_DIMS)
@pytest.mark.parametrize("T,offset", [(64, 0), (16, 200), (13, 5), (512, 0), (2, 7)])
@pytest.mark.parametrize("rep", [1, 4])
def test_prefill_int8_kernel_matches_plain(T, offset, rep, Dh):
    dev = cuda_device()
    g = torch.Generator(device=dev).manual_seed(T + offset)
    B, Hkv, S = 2, 4, 512
    k, ks = _int8(g, dev, B, Hkv, S, Dh)
    v, vs = _int8(g, dev, B, Hkv, S, Dh)
    q = (torch.randn(B, Hkv, rep, T, Dh, generator=g, device=dev) / Dh**0.5).bfloat16()
    offsets = torch.tensor([offset, 0], dtype=torch.int32, device=dev)
    got = kv_int8.flash_attention_int8(q, k, ks, v, vs, offsets)
    want = kv_int8.flash_attention_int8_plain(q, k, ks, v, vs, offsets)
    assert _err(got, want) <= _tol(want, torch.bfloat16)


def _int8_pools(g, dev, layout, Hkv, n_pages, ps, Dh=Dh):
    shape = (n_pages, Hkv, ps, Dh) if layout == "contig" else (Hkv, n_pages, ps, Dh)
    out = []
    for _ in range(2):
        codes, scales = _int8(g, dev, *shape)
        out += [codes, scales.float()]
    return out  # k, ks, v, vs


@pytest.mark.parametrize("Dh", HEAD_DIMS)
@pytest.mark.parametrize("layout", ["contig", "head"])
@pytest.mark.parametrize("rep", [1, 2, 4, 8])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_paged_decode_int8_kernel_matches_plain(layout, rep, dtype, Dh):
    """4 KV heads: at Dh 64 and rep 8, TinyLlama's heads."""
    dev = cuda_device()
    g = torch.Generator(device=dev).manual_seed(rep)
    B, Hkv, ps, mp, n_pages = 5, 4, 128, 4, 24
    pool = _int8_pools(g, dev, layout, Hkv, n_pages, ps, Dh)
    table = torch.randperm(n_pages, generator=g, device=dev)[:B * mp].reshape(B, mp).int()
    lengths = torch.tensor([1, 37, 128, 129, 0], dtype=torch.int32, device=dev)
    q = (torch.randn(B, Hkv, rep, Dh, generator=g, device=dev) / Dh**0.5).to(dtype)
    got = paged_int8.paged_decode_int8(q, *pool, table, lengths, layout)
    want = paged_int8.paged_decode_int8_plain(q, *pool, table, lengths, layout)
    assert torch.equal(got[4], torch.zeros_like(got[4]))
    assert _err(got, want) <= _tol(want, dtype)


@pytest.mark.parametrize("Dh", HEAD_DIMS)
@pytest.mark.parametrize("layout", ["contig", "head"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_paged_append_and_gather_int8_kernels_match_plain(layout, dtype, Dh):
    """Exact: codes and scales of distinct slots all land; two rows on the
    trash page (page 0) leave it unspecified, so it is left out.  The
    gather dequantizes to `dtype` exactly as the plain multiply does."""
    dev = cuda_device()
    g = torch.Generator(device=dev).manual_seed(7)
    Hkv, ps, n_pages = 4, 128, 10
    pool = _int8_pools(g, dev, layout, Hkv, n_pages, ps, Dh)
    plain = [x.clone() for x in pool]
    page = torch.tensor([3, 0, 3, 0, 8], dtype=torch.int32, device=dev)
    slot = torch.tensor([5, 9, 127, 9, 0], dtype=torch.int32, device=dev)
    kn = torch.randn(5, Hkv, Dh, generator=g, device=dev).to(dtype)
    vn = torch.randn(5, Hkv, Dh, generator=g, device=dev).to(dtype)
    paged_int8.paged_append_int8(*pool, kn, vn, page, slot, layout)
    paged_int8.paged_append_int8_plain(*plain, kn, vn, page, slot, layout)
    live = slice(1, None)
    for a, b in zip(pool, plain):
        if layout == "contig":
            assert torch.equal(a[live], b[live])
        else:
            assert torch.equal(a[:, live], b[:, live])
    table = torch.randint(0, n_pages, (3, 5), generator=g, device=dev, dtype=torch.int32)
    got = paged_int8.gather_pages_int8(*pool, table, layout, dtype)
    want = paged_int8.gather_pages_int8_plain(*pool, table, layout, dtype)
    assert got[0].dtype == dtype
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_int8_forwards_on_the_card_match_the_cpu():
    """A tiny 2-layer model (head dim 128): the dense int8 cache (kernels 8
    and 9) and an int8 pool (kernels 10-12) on the card against the same
    forwards on the CPU (plain versions): hidden states within 1e-3 of the
    largest (f32 activations)."""
    from tokenhawk_tpu_torch.runtime.paged import PagedKVCache

    dev = cuda_device()
    cfg = LlamaConfig.tiny(n_vocab=300, n_embd=256, n_head=2, n_layer=2, n_ff=512, n_ctx=256)
    g = torch.Generator(device=dev).manual_seed(3)
    params = tl.fuse_params(tl.init_params(cfg, g, dtype=torch.float32, device=dev,
                                           scale=0.05, quant="q4_0"))
    ids = torch.randint(3, 300, (1, 140), generator=g, device=dev)

    def run(d):
        p, t = params.to(d), ids.to(d)

        def i32(*v):
            return torch.tensor(v, dtype=torch.int32, device=d)

        cache = tl.QuantKVCache.create(cfg, 1, 256, d)
        outs = [tl.forward(cfg, p, t[:, :120], cache, i32(0))[0]]
        outs += [tl.forward(cfg, p, t[:, i:i + 1], cache, i32(i))[0] for i in range(120, 124)]
        pool = PagedKVCache.create(cfg, 6, 128, "int8", d)
        table = i32(4, 1)[None]
        outs.append(tl.forward_paged_prefill(cfg, p, t[:, :128], pool, table)[0])
        outs.append(tl.forward_paged_prefill_cont(cfg, p, t[:, 128:136], pool, table, i32(128),
                                                  i32(8))[0])
        outs += [tl.forward_paged_decode(cfg, p, t[:, i:i + 1], pool, table, i32(i))[0]
                 for i in range(136, 140)]
        return [o.cpu() for o in outs]

    with torch.no_grad():
        for a, b in zip(run(dev), run(torch.device("cpu"))):
            assert _err(a, b) <= 1e-3 * b.abs().max().item()


# ---------------------------------------------------------------------------
# Speculative decoding: the draft at TinyLlama's widths (head dim 64)
# ---------------------------------------------------------------------------


def _plain_kernels(monkeypatch):
    """Route every kernel wrapper the model calls to its plain version, so
    the same program runs in plain PyTorch on the card."""
    from tokenhawk_tpu_torch.ops import linear
    from tokenhawk_tpu_torch.runtime import paged

    for mod, name, fn in [
            (linear, "quant_matmul", qmatmul.quant_matmul_plain),
            (tl, "fused_ffn", ffn.fused_ffn_plain),
            (tl, "flash_attention", flash_attention.flash_attention_plain),
            (tl, "flash_decode_append", flash_decode.flash_decode_append_plain),
            (tl, "flash_decode", flash_decode.flash_decode_plain),
            (tl, "flash_decode_int8", kv_int8.flash_decode_int8_plain),
            (tl, "flash_attention_int8", kv_int8.flash_attention_int8_plain),
            (paged, "paged_append", paged_decode.paged_append_plain),
            (tl, "gather_pages", paged_decode.gather_pages_plain)]:
        monkeypatch.setattr(mod, name, fn)


def test_speculative_round_at_tinyllama_width_matches_plain_on_the_card(monkeypatch):
    """One greedy round of the dense server's speculation (gamma 4, two
    slots) with a 2-layer TinyLlama-width draft (2048 wide, 32 heads over
    4 KV heads of 64, dense f32 weights: kernel 14 at rep 8) and a 2-layer
    target of the same widths in Q4_0 (kernels 1-4, kernel 4 at Dh 64),
    then the same program in plain PyTorch on the card: the same tokens
    and counts (f32 activations; the two differ by summation order)."""
    from tokenhawk_tpu_torch.runtime.speculative import make_spec_serving_fn

    dev = cuda_device()
    cfg = LlamaConfig(n_vocab=32000, n_embd=2048, n_head=32, n_kv_head=4, n_layer=2,
                      n_ff=5632, n_ctx=256, rms_norm_eps=1e-5)
    g = torch.Generator(device=dev).manual_seed(5)
    params_t = tl.fuse_params(tl.init_params(cfg, g, dtype=torch.float32, device=dev,
                                             quant="q4_0"))
    params_d = tl.fuse_params(tl.init_params(cfg, g, dtype=torch.float32, device=dev))
    prompt = torch.randint(3, cfg.n_vocab, (2, 40), generator=g, device=dev)
    step = make_spec_serving_fn(cfg, cfg, 4, eos_id=-1)

    def run():
        caches = [tl.KVCache.create(cfg, 2, 256, torch.float32, dev) for _ in range(2)]
        zeros = torch.zeros(2, dtype=torch.int32, device=dev)
        with torch.no_grad():
            for p, c in zip((params_d, params_t), caches):
                tl.forward(cfg, p, prompt[:, :-1], c, zeros)
        out = step(params_d, params_t, *caches, prompt[:, -1], zeros + 39,
                   torch.zeros(2, dtype=torch.bool, device=dev))
        return [x.cpu() for x in out[2:]]

    flash_decode.launches.update(flash_decode_attend=0)
    got = run()
    assert flash_decode.launches["flash_decode_attend"] == 4 * cfg.n_layer
    _plain_kernels(monkeypatch)
    want = run()
    assert flash_decode.launches["flash_decode_attend"] == 4 * cfg.n_layer
    for a, b in zip(got, want):
        assert torch.equal(a, b)
