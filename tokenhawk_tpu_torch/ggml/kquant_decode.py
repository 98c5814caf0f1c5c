"""k-quant block streams (ggml/kquants.py's formats) unpacked with torch
ops on the device their weight goes to.

The loader copies a tensor's block bytes to the device once and unpacks
them there: the nibbles, crumbs and high bits of the codes, the 6-bit
(scale, min) pairs and the f16 super-block scales.  On the host, numpy's
decode of one Llama-3-8B-width 2-layer Q4_K_M file takes 35-55 s, most of
it in the Q6_K output matrix; on the card it is a few dozen launches a
tensor.

Each extract_* returns what its twin in ggml/kquants.py returns, as
tensors and bit for bit (tests/test_torch_kquant_decode.py): integer
codes, and float32 sides d * sc and dmin * mn, each one rounding of a
float32 product as there.  The functions take `blocks(kind, raw, n,
device)`'s uint8 [n // 256, block bytes] tensor.
"""

from __future__ import annotations

import numpy as np
import torch

from tokenhawk_tpu_torch.ggml.format import GGMLType
from tokenhawk_tpu_torch.ggml.kquants import KQUANT_BLOCK_BYTES, QK_K


def blocks(kind: GGMLType, raw, n: int, device=None) -> torch.Tensor:
    """The blocks of n weights of a `kind` stream (bytes or a memoryview
    of the file) as uint8 [n // 256, block bytes] on `device`: one copy
    out of the file, one to the device."""
    nb, size = n // QK_K, KQUANT_BLOCK_BYTES[kind]
    host = torch.from_numpy(np.frombuffer(raw, np.uint8, count=nb * size).copy())
    return host.to(device=device).reshape(nb, size)


def _f16(b: torch.Tensor) -> torch.Tensor:
    """uint8 [nb, 2] little-endian halves -> float32 [nb]."""
    return b.contiguous().view(torch.float16).reshape(-1).float()


def _scale_min_k4(s: torch.Tensor):
    """scales [nb, 12] u8 -> (sc [nb, 8], mn [nb, 8]) 6-bit values
    (llama.cpp get_scale_min_k4)."""
    sc = torch.cat([s[:, 0:4] & 63, (s[:, 8:12] & 0x0F) | ((s[:, 0:4] >> 6) << 4)], 1)
    mn = torch.cat([s[:, 4:8] & 63, (s[:, 8:12] >> 4) | ((s[:, 4:8] >> 6) << 4)], 1)
    return sc, mn


def _nibbles(qs: torch.Tensor) -> torch.Tensor:
    """qs [nb, 128] -> codes [nb, 256]: each 32-byte chunk's low nibbles
    are its 64 elements' first 32, the high nibbles the last 32."""
    q = qs.reshape(qs.shape[0], 4, 32)
    return torch.stack([q & 0x0F, q >> 4], 2).reshape(qs.shape[0], QK_K)


def _sides(d: torch.Tensor, sc: torch.Tensor) -> torch.Tensor:
    return (d[:, None] * sc.float()).reshape(-1)


def extract_q4_k(buf: torch.Tensor):
    """-> (codes u8 [n] in [0, 15], s f32 [n // 32], m f32 [n // 32])."""
    sc, mn = _scale_min_k4(buf[:, 4:16])
    return (_nibbles(buf[:, 16:144]).reshape(-1), _sides(_f16(buf[:, 0:2]), sc),
            _sides(_f16(buf[:, 2:4]), mn))


def extract_q4_k_sb(buf: torch.Tensor):
    """-> (codes u8 [n], sc6 u8 [n // 32], mn6 u8 [n // 32], d f32
    [n // 256], dmin f32 [n // 256])."""
    sc, mn = _scale_min_k4(buf[:, 4:16])
    return (_nibbles(buf[:, 16:144]).reshape(-1), sc.reshape(-1), mn.reshape(-1),
            _f16(buf[:, 0:2]), _f16(buf[:, 2:4]))


def extract_q5_k(buf: torch.Tensor):
    """-> (codes u8 [n] in [0, 31], s f32 [n // 32], m f32 [n // 32])."""
    sc, mn = _scale_min_k4(buf[:, 4:16])
    qh, qs = buf[:, 16:48], buf[:, 48:176]
    parts = []
    for chunk in range(4):  # 64 elements a chunk
        q = qs[:, chunk * 32:(chunk + 1) * 32]
        parts += [(q & 0x0F) + (((qh >> (2 * chunk)) & 1) << 4),
                  (q >> 4) + (((qh >> (2 * chunk + 1)) & 1) << 4)]
    return (torch.cat(parts, 1).reshape(-1), _sides(_f16(buf[:, 0:2]), sc),
            _sides(_f16(buf[:, 2:4]), mn))


def extract_q6_k(buf: torch.Tensor):
    """-> (codes i8 [n] in [-32, 31], s f32 [n // 16])."""
    ql, qh = buf[:, 0:128], buf[:, 128:192]
    scales = buf[:, 192:208].contiguous().view(torch.int8)
    parts = []
    for half in range(2):  # 128 elements a half
        lo, hi = ql[:, half * 64:half * 64 + 32], ql[:, half * 64 + 32:half * 64 + 64]
        h = qh[:, half * 32:half * 32 + 32]
        parts += [(lo & 0x0F) | ((h & 3) << 4), (hi & 0x0F) | (((h >> 2) & 3) << 4),
                  (lo >> 4) | (((h >> 4) & 3) << 4), (hi >> 4) | (((h >> 6) & 3) << 4)]
    codes = torch.cat(parts, 1).to(torch.int8) - 32
    return codes.reshape(-1), _sides(_f16(buf[:, 208:210]), scales)


def extract_q2_k(buf: torch.Tensor):
    """-> (codes u8 [n] in [0, 3], s f32 [n // 16], m f32 [n // 16])."""
    sc4, qs = buf[:, 0:16], buf[:, 16:80]
    parts = [(qs[:, half * 32:half * 32 + 32] >> (2 * j)) & 3
             for half in range(2) for j in range(4)]
    return (torch.cat(parts, 1).reshape(-1), _sides(_f16(buf[:, 80:82]), sc4 & 0x0F),
            _sides(_f16(buf[:, 82:84]), sc4 >> 4))


def extract_q3_k(buf: torch.Tensor):
    """-> (codes i8 [n] in [-4, 3], s f32 [n // 16])."""
    hmask, qs, sc12 = buf[:, 0:32], buf[:, 32:96], buf[:, 96:108]
    lo = torch.cat([sc12[:, :8] & 0x0F, sc12[:, :8] >> 4], 1)
    hi = torch.cat([(sc12[:, 8:12] >> (2 * k)) & 3 for k in range(4)], 1)
    sc16 = (lo | (hi << 4)).to(torch.int16) - 32
    parts = []
    for half in range(2):
        q = qs[:, half * 32:half * 32 + 32]
        for j in range(4):
            low2 = ((q >> (2 * j)) & 3).to(torch.int8)
            hbit = ((hmask >> (4 * half + j)) & 1).to(torch.int8)
            parts.append(low2 + 4 * hbit - 4)
    return torch.cat(parts, 1).reshape(-1), _sides(_f16(buf[:, 108:110]), sc16)


EXTRACT = {GGMLType.Q2_K: extract_q2_k, GGMLType.Q3_K: extract_q3_k,
           GGMLType.Q4_K: extract_q4_k, GGMLType.Q5_K: extract_q5_k,
           GGMLType.Q6_K: extract_q6_k}


def dequant(kind: GGMLType, raw, shape, device=None) -> torch.Tensor:
    """A k-quant tensor as float32 `shape` on `device`: kquants.dequant_kquant
    bit for bit (code * s - m per group, m absent for Q3_K and Q6_K)."""
    if kind not in EXTRACT:
        raise ValueError(f"unsupported k-quant {kind!r}")
    n = int(np.prod(shape))
    out = EXTRACT[kind](blocks(kind, raw, n, device))
    codes, s = out[0], out[1]
    y = codes.reshape(s.numel(), -1).float() * s[:, None]
    if len(out) == 3:
        y = y - out[2][:, None]
    return y.reshape(tuple(shape))
