# Copy of tokenhawk_tpu/ggml/kquants.py (imports rewritten, upstream citations as bare
# file:line): importing tokenhawk_tpu imports jax, which the GPU machine lacks.
# tests/test_torch_host.py holds the copy equal to its original.
"""k-quant block codecs (Q2_K..Q6_K): the formats real GGUF files ship.

llama.cpp's *_K model files store most projection weights in 256-element
super-blocks with second-level quantized scales; the reference era
predates them entirely.  This module extracts the block streams to
(codes, per-group scale, per-group min) triples — the NATIVE device
representation served by the generic qk Pallas kernel
(ops/qweight.from_kquant_raw; no requantize detour — bit-exact with
f32 sides, the default bf16 rounds the affine sides) — and
decodes/encodes dense f32 for tests and fallbacks.

Layouts were written against llama.cpp's documented block structs and
cross-validated against an independent scalar C implementation
(native/thawk_native.cpp thawk_dequant_*; tests/test_kquant_crosscheck.py
must agree bit-for-bit on arbitrary byte streams).

Block layouts (little-endian, QK_K = 256):
  block_q2_K: { u8 scales[16]; u8 qs[64]; f16 d; f16 dmin }   =  84 B
    16 sub-blocks of 16; 4-bit (scale|min) nibble pairs;
    y = d*sc*q - dmin*m, q 2-bit in [0, 3].
  block_q3_K: { u8 hmask[32]; u8 qs[64]; u8 sc[12]; f16 d }   = 110 B
    16 sub-blocks of 16; signed 6-bit scales (kmask crumb packing);
    3-bit codes split 2+1 between qs crumbs and hmask bits;
    y = d*(sc-32)*(q-4).
  block_q4_K: { f16 d; f16 dmin; u8 scales[12]; u8 qs[128] }  = 144 B
    8 sub-blocks of 32; 6-bit (scale, min) pairs packed in scales[12]
    (llama.cpp get_scale_min_k4); element y = d*sc*q - dmin*m, q in
    [0, 15]; qs bytes cover 64-element chunks: low nibbles are elements
    [0, 32), high nibbles [32, 64) of each chunk.
  block_q5_K: { f16 d; f16 dmin; u8 sc[12]; u8 qh[32]; qs[128] } = 176 B
    like Q4_K with a 5th code bit per element pulled from qh.
  block_q6_K: { u8 ql[128]; u8 qh[64]; i8 scales[16]; f16 d } = 210 B
    16 sub-blocks of 16 with int8 scales; 6-bit codes split 4+2 between
    ql nibbles and qh crumbs; y = d * scales[i] * (q - 32).
"""

from __future__ import annotations

import numpy as np

from tokenhawk_tpu_torch.ggml.format import GGMLType

QK_K = 256

KQUANT_BLOCK_BYTES = {
    GGMLType.Q2_K: 84,
    GGMLType.Q3_K: 110,
    GGMLType.Q4_K: 144,
    GGMLType.Q5_K: 176,
    GGMLType.Q6_K: 210,
}


def _unpack_scale_min_k4(scales: np.ndarray):
    """scales [nb, 12] u8 -> (sc [nb, 8], mn [nb, 8]) 6-bit values
    (llama.cpp get_scale_min_k4)."""
    s = scales.astype(np.uint8)
    sc = np.empty(s.shape[:-1] + (8,), np.uint8)
    mn = np.empty_like(sc)
    for j in range(4):
        sc[..., j] = s[..., j] & 63
        mn[..., j] = s[..., j + 4] & 63
    for j in range(4, 8):
        sc[..., j] = (s[..., j + 4] & 0x0F) | ((s[..., j - 4] >> 6) << 4)
        mn[..., j] = (s[..., j + 4] >> 4) | ((s[..., j] >> 6) << 4)
    return sc, mn


def extract_q4_k(raw: bytes, n: int):
    """Q4_K block stream -> (codes u8 [n] in [0,15], s f32 [n//32],
    m f32 [n//32]) with y = s[g]*code - m[g] per 32-element group.

    The (codes, s, m) triple is the NATIVE device representation: the
    int4 kernel stores code-8 (int4) with per-group scale s and affine
    bias 8*s - m, so real Q4_K files decode at ~4.9 bpw (bit-exact with
    f32 sides; bf16 sides round s and 8*s-m)
    instead of the old requantize-to-Q8_0 detour (2x the HBM traffic
    plus stacked rounding)."""
    nb = n // QK_K
    buf = np.frombuffer(raw, np.uint8, count=nb * 144).reshape(nb, 144)
    d = buf[:, 0:2].copy().view("<f2").astype(np.float32).reshape(nb)
    dmin = buf[:, 2:4].copy().view("<f2").astype(np.float32).reshape(nb)
    sc, mn = _unpack_scale_min_k4(buf[:, 4:16])  # [nb, 8]
    qs = buf[:, 16:144]  # [nb, 128]

    codes = np.empty((nb, QK_K), np.uint8)
    for chunk in range(4):  # 64 elements per chunk
        q = qs[:, chunk * 32 : (chunk + 1) * 32]
        codes[:, chunk * 64 : chunk * 64 + 32] = q & 0x0F
        codes[:, chunk * 64 + 32 : chunk * 64 + 64] = q >> 4
    s = (d[:, None] * sc.astype(np.float32)).reshape(nb * 8)
    m = (dmin[:, None] * mn.astype(np.float32)).reshape(nb * 8)
    return codes.reshape(n), s, m


def extract_q4_k_sb(raw: bytes, n: int):
    """Q4_K block stream -> SUPER-BLOCK parts: (codes u8 [n], sc6 u8
    [n//32], mn6 u8 [n//32], d f32 [n//256], dmin f32 [n//256]) with
    y = (d[sb]*sc6[g])*code - (dmin[sb]*mn6[g]).

    Keeping the two quantization levels separate on device costs
    2/32 B (int8 sc|mn) + 4/256 B (f16 d|dmin) per element instead of
    the flattened form's 2*2/32 B — 4.63 vs 5.0 bpw; the kernel fuses
    the d*sc expansion (two sublane-broadcast multiplies per tile)."""
    nb = n // QK_K
    buf = np.frombuffer(raw, np.uint8, count=nb * 144).reshape(nb, 144)
    d = buf[:, 0:2].copy().view("<f2").astype(np.float32).reshape(nb)
    dmin = buf[:, 2:4].copy().view("<f2").astype(np.float32).reshape(nb)
    sc, mn = _unpack_scale_min_k4(buf[:, 4:16])  # [nb, 8] u8
    qs = buf[:, 16:144]

    codes = np.empty((nb, QK_K), np.uint8)
    for chunk in range(4):
        q = qs[:, chunk * 32 : (chunk + 1) * 32]
        codes[:, chunk * 64 : chunk * 64 + 32] = q & 0x0F
        codes[:, chunk * 64 + 32 : chunk * 64 + 64] = q >> 4
    return (codes.reshape(n), sc.reshape(nb * 8), mn.reshape(nb * 8),
            d, dmin)


def dequant_q4_k(raw: bytes, n: int) -> np.ndarray:
    """Q4_K block stream -> f32 [n]."""
    codes, s, m = extract_q4_k(raw, n)
    q = codes.reshape(-1, 32).astype(np.float32)
    return (q * s[:, None] - m[:, None]).reshape(n)


def extract_q5_k(raw: bytes, n: int):
    """Q5_K block stream -> (codes u8 [n] in [0,31], s f32 [n//32],
    m f32 [n//32]) with y = s[g]*code - m[g] per 32-element group."""
    nb = n // QK_K
    buf = np.frombuffer(raw, np.uint8, count=nb * 176).reshape(nb, 176)
    d = buf[:, 0:2].copy().view("<f2").astype(np.float32).reshape(nb)
    dmin = buf[:, 2:4].copy().view("<f2").astype(np.float32).reshape(nb)
    sc, mn = _unpack_scale_min_k4(buf[:, 4:16])
    qh = buf[:, 16:48]  # [nb, 32]
    qs = buf[:, 48:176]  # [nb, 128]

    codes = np.empty((nb, QK_K), np.uint8)
    for chunk in range(4):  # 64 elements per chunk
        q = qs[:, chunk * 32 : (chunk + 1) * 32]
        u1 = np.uint8(1 << (2 * chunk))
        u2 = np.uint8(1 << (2 * chunk + 1))
        codes[:, chunk * 64 : chunk * 64 + 32] = (
            (q & 0x0F) + ((qh & u1) != 0).astype(np.uint8) * 16)
        codes[:, chunk * 64 + 32 : chunk * 64 + 64] = (
            (q >> 4) + ((qh & u2) != 0).astype(np.uint8) * 16)
    s = (d[:, None] * sc.astype(np.float32)).reshape(nb * 8)
    m = (dmin[:, None] * mn.astype(np.float32)).reshape(nb * 8)
    return codes.reshape(n), s, m


def dequant_q5_k(raw: bytes, n: int) -> np.ndarray:
    """Q5_K block stream -> f32 [n].

    block_q5_K: { f16 d; f16 dmin; u8 scales[12]; u8 qh[32]; u8 qs[128] }
    = 176 B; like Q4_K with a 5th code bit per element pulled from qh
    (the same 32 qh bytes serve all 8 sub-blocks via shifting masks)."""
    codes, s, m = extract_q5_k(raw, n)
    q = codes.reshape(-1, 32).astype(np.float32)
    return (q * s[:, None] - m[:, None]).reshape(n)


def extract_q6_k(raw: bytes, n: int):
    """Q6_K block stream -> (codes i8 [n] in [-32,31], s f32 [n//16])
    with y = s[g]*code per 16-element group (symmetric, no min)."""
    nb = n // QK_K
    buf = np.frombuffer(raw, np.uint8, count=nb * 210).reshape(nb, 210)
    ql = buf[:, 0:128]
    qh = buf[:, 128:192]
    scales = buf[:, 192:208].copy().view(np.int8).astype(np.float32)
    d = buf[:, 208:210].copy().view("<f2").astype(np.float32).reshape(nb)

    codes = np.empty((nb, QK_K), np.int8)
    for half in range(2):  # 128 elements per half
        qlh = ql[:, half * 64 : half * 64 + 64]
        qhh = qh[:, half * 32 : half * 32 + 32]
        l = np.arange(32)
        base = half * 128
        codes[:, base + l] = (
            ((qlh[:, l] & 0x0F) | (((qhh >> 0) & 3) << 4)).astype(np.int16) - 32
        ).astype(np.int8)
        codes[:, base + l + 32] = (
            ((qlh[:, l + 32] & 0x0F) | (((qhh >> 2) & 3) << 4)).astype(np.int16) - 32
        ).astype(np.int8)
        codes[:, base + l + 64] = (
            ((qlh[:, l] >> 4) | (((qhh >> 4) & 3) << 4)).astype(np.int16) - 32
        ).astype(np.int8)
        codes[:, base + l + 96] = (
            ((qlh[:, l + 32] >> 4) | (((qhh >> 6) & 3) << 4)).astype(np.int16) - 32
        ).astype(np.int8)
    s = (d[:, None] * scales).reshape(nb * 16)  # [n//16]
    return codes.reshape(n), s


def dequant_q6_k(raw: bytes, n: int) -> np.ndarray:
    """Q6_K block stream -> f32 [n]."""
    codes, s = extract_q6_k(raw, n)
    q = codes.reshape(-1, 16).astype(np.float32)
    return (q * s[:, None]).reshape(n)


def extract_q2_k(raw: bytes, n: int):
    """Q2_K block stream -> (codes u8 [n] in [0,3], s f32 [n//16],
    m f32 [n//16]) with y = s[g]*code - m[g] per 16-element group.

    block_q2_K: { u8 scales[16] (4-bit sc|mn pairs); u8 qs[64] (2-bit
    codes, 4 per byte); f16 d; f16 dmin } = 84 B."""
    nb = n // QK_K
    buf = np.frombuffer(raw, np.uint8, count=nb * 84).reshape(nb, 84)
    sc4 = buf[:, 0:16]  # [nb, 16]
    qs = buf[:, 16:80]  # [nb, 64]
    d = buf[:, 80:82].copy().view("<f2").astype(np.float32).reshape(nb)
    dmin = buf[:, 82:84].copy().view("<f2").astype(np.float32).reshape(nb)

    codes = np.empty((nb, QK_K), np.uint8)
    for half in range(2):  # 128 elements per half
        q = qs[:, half * 32 : half * 32 + 32]
        for j in range(4):
            codes[:, half * 128 + j * 32 : half * 128 + (j + 1) * 32] = (
                q >> (2 * j)) & 3
    s = (d[:, None] * (sc4 & 0x0F).astype(np.float32)).reshape(nb * 16)
    m = (dmin[:, None] * (sc4 >> 4).astype(np.float32)).reshape(nb * 16)
    return codes.reshape(n), s, m


def dequant_q2_k(raw: bytes, n: int) -> np.ndarray:
    codes, s, m = extract_q2_k(raw, n)
    q = codes.reshape(-1, 16).astype(np.float32)
    return (q * s[:, None] - m[:, None]).reshape(n)


def _unpack_scales_q3(sc12: np.ndarray) -> np.ndarray:
    """scales[12] u8 -> 16 signed 6-bit scales (value - 32), per block.

    llama.cpp's kmask unpack: the first 8 bytes hold the low 4 bits of
    the 16 values; bytes 8..11 hold the high 2-bit crumbs."""
    lo = np.concatenate([sc12[..., :8] & 0x0F, sc12[..., :8] >> 4], axis=-1)
    # crumb index for value v: byte 8 + v%4, shift 2*(v//4)
    v = np.arange(16)
    hi = (sc12[..., 8 + (v % 4)] >> (2 * (v // 4))) & 3
    return (lo | (hi << 4)).astype(np.int16) - 32


def extract_q3_k(raw: bytes, n: int):
    """Q3_K block stream -> (codes i8 [n] in [-4,3], s f32 [n//16])
    with y = s[g]*code per 16-element group (symmetric).

    block_q3_K: { u8 hmask[32]; u8 qs[64]; u8 scales[12]; f16 d }
    = 110 B; 3-bit codes split 2+1 between qs crumbs and hmask bits,
    with the high bit SUBTRACTING 4 when clear (llama.cpp
    dequantize_row_q3_K)."""
    nb = n // QK_K
    buf = np.frombuffer(raw, np.uint8, count=nb * 110).reshape(nb, 110)
    hmask = buf[:, 0:32]
    qs = buf[:, 32:96]
    sc16 = _unpack_scales_q3(buf[:, 96:108])  # [nb, 16] int16
    d = buf[:, 108:110].copy().view("<f2").astype(np.float32).reshape(nb)

    codes = np.empty((nb, QK_K), np.int8)
    for half in range(2):
        q = qs[:, half * 32 : half * 32 + 32]
        for j in range(4):
            low2 = (q >> (2 * j)) & 3
            hbit = (hmask >> (4 * half + j)) & 1
            codes[:, half * 128 + j * 32 : half * 128 + (j + 1) * 32] = (
                low2.astype(np.int16) + 4 * hbit.astype(np.int16) - 4
            ).astype(np.int8)
    s = (d[:, None] * sc16.astype(np.float32)).reshape(nb * 16)
    return codes.reshape(n), s


def dequant_q3_k(raw: bytes, n: int) -> np.ndarray:
    codes, s = extract_q3_k(raw, n)
    q = codes.reshape(-1, 16).astype(np.float32)
    return (q * s[:, None]).reshape(n)


def dequant_kquant(kind: GGMLType, raw: bytes, shape) -> np.ndarray:
    n = int(np.prod(shape))
    if kind == GGMLType.Q2_K:
        return dequant_q2_k(raw, n).reshape(shape)
    if kind == GGMLType.Q3_K:
        return dequant_q3_k(raw, n).reshape(shape)
    if kind == GGMLType.Q4_K:
        return dequant_q4_k(raw, n).reshape(shape)
    if kind == GGMLType.Q5_K:
        return dequant_q5_k(raw, n).reshape(shape)
    if kind == GGMLType.Q6_K:
        return dequant_q6_k(raw, n).reshape(shape)
    raise ValueError(f"unsupported k-quant {kind!r}")


# -- encoding (tests / synthetic files) -----------------------------------


def quantize_q4_k(x: np.ndarray) -> bytes:
    """f32 -> Q4_K block stream (reference-quality, not llama.cpp's
    iterative optimizer: per-sub-block min/max affine with 6-bit
    second-level scales — exact layout, simpler scale search)."""
    x = np.asarray(x, np.float32).reshape(-1, QK_K)
    nb = x.shape[0]
    out = np.zeros((nb, 144), np.uint8)
    for b in range(nb):
        sub = x[b].reshape(8, 32)
        mins = np.minimum(sub.min(axis=1), 0.0)  # m >= 0 in y = d*sc*q - dmin*m
        maxs = sub.max(axis=1)
        scale = (maxs - mins) / 15.0  # per-sub scale
        d = max(scale.max() / 63.0, 1e-12)
        dmin = max((-mins).max() / 63.0, 1e-12)
        sc6 = np.clip(np.round(scale / d), 0, 63).astype(np.uint8)
        mn6 = np.clip(np.round((-mins) / dmin), 0, 63).astype(np.uint8)
        # pack 6-bit pairs (inverse of _unpack_scale_min_k4)
        s12 = np.zeros(12, np.uint8)
        for j in range(4):
            s12[j] = sc6[j] & 63
            s12[j + 4] = mn6[j] & 63
        for j in range(4, 8):
            s12[j + 4] = (sc6[j] & 0x0F) | ((mn6[j] & 0x0F) << 4)
            s12[j - 4] |= (sc6[j] >> 4) << 6
            s12[j] |= (mn6[j] >> 4) << 6
        eff_d = d * sc6.astype(np.float32)
        eff_m = dmin * mn6.astype(np.float32)
        q = np.zeros((8, 32), np.uint8)
        for j in range(8):
            dj = eff_d[j] if eff_d[j] > 0 else 1.0
            q[j] = np.clip(np.round((sub[j] + eff_m[j]) / dj), 0, 15)
        qs = np.zeros(128, np.uint8)
        for chunk in range(4):
            qs[chunk * 32 : (chunk + 1) * 32] = (
                q[2 * chunk] | (q[2 * chunk + 1] << 4))
        out[b, 0:2] = np.frombuffer(np.float16(d).tobytes(), np.uint8)
        out[b, 2:4] = np.frombuffer(np.float16(dmin).tobytes(), np.uint8)
        out[b, 4:16] = s12
        out[b, 16:144] = qs
    return out.tobytes()


def quantize_q5_k(x: np.ndarray) -> bytes:
    """f32 -> Q5_K block stream (per-sub-block min/max affine, 5-bit
    codes, 6-bit super-scales)."""
    x = np.asarray(x, np.float32).reshape(-1, QK_K)
    nb = x.shape[0]
    out = np.zeros((nb, 176), np.uint8)
    for b in range(nb):
        sub = x[b].reshape(8, 32)
        mins = np.minimum(sub.min(axis=1), 0.0)
        maxs = sub.max(axis=1)
        scale = (maxs - mins) / 31.0
        d = max(scale.max() / 63.0, 1e-12)
        dmin = max((-mins).max() / 63.0, 1e-12)
        sc6 = np.clip(np.round(scale / d), 0, 63).astype(np.uint8)
        mn6 = np.clip(np.round((-mins) / dmin), 0, 63).astype(np.uint8)
        s12 = np.zeros(12, np.uint8)
        for j in range(4):
            s12[j] = sc6[j] & 63
            s12[j + 4] = mn6[j] & 63
        for j in range(4, 8):
            s12[j + 4] = (sc6[j] & 0x0F) | ((mn6[j] & 0x0F) << 4)
            s12[j - 4] |= (sc6[j] >> 4) << 6
            s12[j] |= (mn6[j] >> 4) << 6
        eff_d = d * sc6.astype(np.float32)
        eff_m = dmin * mn6.astype(np.float32)
        q = np.zeros((8, 32), np.uint8)
        for j in range(8):
            dj = eff_d[j] if eff_d[j] > 0 else 1.0
            q[j] = np.clip(np.round((sub[j] + eff_m[j]) / dj), 0, 31)
        qs = np.zeros(128, np.uint8)
        qh = np.zeros(32, np.uint8)
        for chunk in range(4):
            q1, q2 = q[2 * chunk], q[2 * chunk + 1]
            qs[chunk * 32 : (chunk + 1) * 32] = (q1 & 0x0F) | ((q2 & 0x0F) << 4)
            qh |= ((q1 >> 4) << (2 * chunk)).astype(np.uint8)
            qh |= ((q2 >> 4) << (2 * chunk + 1)).astype(np.uint8)
        out[b, 0:2] = np.frombuffer(np.float16(d).tobytes(), np.uint8)
        out[b, 2:4] = np.frombuffer(np.float16(dmin).tobytes(), np.uint8)
        out[b, 4:16] = s12
        out[b, 16:48] = qh
        out[b, 48:176] = qs
    return out.tobytes()


def quantize_q6_k(x: np.ndarray) -> bytes:
    """f32 -> Q6_K block stream (absmax per 16-element sub-block)."""
    x = np.asarray(x, np.float32).reshape(-1, QK_K)
    nb = x.shape[0]
    out = np.zeros((nb, 210), np.uint8)
    for b in range(nb):
        sub = x[b].reshape(16, 16)
        amax = np.abs(sub).max(axis=1)
        d = max(amax.max() / (127.0 * 31.0), 1e-12)  # scales i8, codes 6-bit
        s16 = np.clip(np.round(amax / (31.0 * d)), -128, 127).astype(np.int8)
        q = np.zeros((16, 16), np.int32)
        for j in range(16):
            sj = d * float(s16[j])
            sj = sj if sj != 0 else 1.0
            q[j] = np.clip(np.round(sub[j] / sj), -32, 31)
        code = (q + 32).astype(np.uint8).reshape(QK_K)  # 6-bit
        ql = np.zeros(128, np.uint8)
        qh = np.zeros(64, np.uint8)
        for half in range(2):
            base = half * 128
            c1 = code[base : base + 32]
            c2 = code[base + 32 : base + 64]
            c3 = code[base + 64 : base + 96]
            c4 = code[base + 96 : base + 128]
            ql[half * 64 : half * 64 + 32] = (c1 & 0x0F) | ((c3 & 0x0F) << 4)
            ql[half * 64 + 32 : half * 64 + 64] = (c2 & 0x0F) | ((c4 & 0x0F) << 4)
            qh[half * 32 : half * 32 + 32] = (
                (c1 >> 4) | ((c2 >> 4) << 2) | ((c3 >> 4) << 4) | ((c4 >> 4) << 6))
        out[b, 0:128] = ql
        out[b, 128:192] = qh
        out[b, 192:208] = np.frombuffer(s16.tobytes(), np.uint8)
        out[b, 208:210] = np.frombuffer(np.float16(d).tobytes(), np.uint8)
    return out.tobytes()


def quantize_q2_k(x: np.ndarray) -> bytes:
    """f32 -> Q2_K block stream (per-16 min/max affine, 4-bit
    second-level scales; exact layout, simple scale search)."""
    x = np.asarray(x, np.float32).reshape(-1, QK_K)
    nb = x.shape[0]
    out = np.zeros((nb, 84), np.uint8)
    for b in range(nb):
        sub = x[b].reshape(16, 16)
        mins = np.minimum(sub.min(axis=1), 0.0)
        maxs = sub.max(axis=1)
        scale = (maxs - mins) / 3.0
        d = max(scale.max() / 15.0, 1e-12)
        dmin = max((-mins).max() / 15.0, 1e-12)
        sc4 = np.clip(np.round(scale / d), 0, 15).astype(np.uint8)
        mn4 = np.clip(np.round((-mins) / dmin), 0, 15).astype(np.uint8)
        eff_d = d * sc4.astype(np.float32)
        eff_m = dmin * mn4.astype(np.float32)
        q = np.zeros((16, 16), np.uint8)
        for j in range(16):
            dj = eff_d[j] if eff_d[j] > 0 else 1.0
            q[j] = np.clip(np.round((sub[j] + eff_m[j]) / dj), 0, 3)
        code = q.reshape(QK_K)
        qs = np.zeros(64, np.uint8)
        for half in range(2):
            for j in range(4):
                c = code[half * 128 + j * 32 : half * 128 + (j + 1) * 32]
                qs[half * 32 : half * 32 + 32] |= (c << (2 * j)).astype(
                    np.uint8)
        out[b, 0:16] = sc4 | (mn4 << 4)
        out[b, 16:80] = qs
        out[b, 80:82] = np.frombuffer(np.float16(d).tobytes(), np.uint8)
        out[b, 82:84] = np.frombuffer(np.float16(dmin).tobytes(), np.uint8)
    return out.tobytes()


def quantize_q3_k(x: np.ndarray) -> bytes:
    """f32 -> Q3_K block stream (absmax per 16, signed 6-bit scales)."""
    x = np.asarray(x, np.float32).reshape(-1, QK_K)
    nb = x.shape[0]
    out = np.zeros((nb, 110), np.uint8)
    for b in range(nb):
        sub = x[b].reshape(16, 16)
        amax = np.abs(sub).max(axis=1)
        d = max(amax.max() / (31.0 * 4.0), 1e-12)
        sc16 = np.clip(np.round(amax / (4.0 * d)), -32, 31).astype(np.int16)
        q = np.zeros((16, 16), np.int32)
        for j in range(16):
            sj = d * float(sc16[j])
            sj = sj if sj != 0 else 1.0
            q[j] = np.clip(np.round(sub[j] / sj), -4, 3)
        code = (q + 4).astype(np.uint8).reshape(QK_K)  # 3-bit [0, 7]
        qs = np.zeros(64, np.uint8)
        hmask = np.zeros(32, np.uint8)
        for half in range(2):
            for j in range(4):
                c = code[half * 128 + j * 32 : half * 128 + (j + 1) * 32]
                qs[half * 32 : half * 32 + 32] |= ((c & 3) << (2 * j)).astype(
                    np.uint8)
                hmask |= ((c >> 2) << (4 * half + j)).astype(np.uint8)
        # pack 16 signed 6-bit scales: low 4 bits in bytes 0..7, high
        # crumbs in bytes 8..11 (inverse of _unpack_scales_q3)
        u = (sc16 + 32).astype(np.uint8)
        sc12 = np.zeros(12, np.uint8)
        sc12[0:8] = (u[0:8] & 0x0F) | ((u[8:16] & 0x0F) << 4)
        for v in range(16):
            sc12[8 + (v % 4)] |= ((u[v] >> 4) & 3) << (2 * (v // 4))
        out[b, 0:32] = hmask
        out[b, 32:96] = qs
        out[b, 96:108] = sc12
        out[b, 108:110] = np.frombuffer(np.float16(d).tobytes(), np.uint8)
    return out.tobytes()
