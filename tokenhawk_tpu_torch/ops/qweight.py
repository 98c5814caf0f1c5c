"""Q4_0 weight container in the Hopper layout.

Counterpart of tokenhawk_tpu/ops/qweight.py for the Q4_0 kind.  The
reference keeps q4_0 contraction-major ([K//2, N] bytes, row j packed
with row j + K//2) because the TPU kernels tile (K, N) blocks into VMEM.
On the GPU the matmul kernels are GEMVs at decode: one warp walks one
output column down K, so the port stores each output column's codes
contiguously, output-major, which is GGML's own [out, in] order:

  qs:     uint8 [N, K//2]  group g of column n is bytes [16g, 16g+16) of
          row n; byte j holds code 32g+j in its low nibble and code
          32g+16+j in its high nibble, offset-binary (value + 8).
  scales: f32 [N, K//32]   one scale per (column, group of 32 inputs).

A lane loads one whole group (16 bytes) with one 16-byte load and one
4-byte scale; the lanes of a warp read 512 contiguous bytes.  The low
and high nibbles of a 4-byte word cover inputs 4i..4i+3 and 16+4i..
16+4i+3 of the group, two float4 loads of the activations.

`dequantize()` returns the logical [K, N] matrix (the reference's
orientation) and is the oracle every kernel test holds the port to.
"""

from __future__ import annotations

import dataclasses
from typing import Union

import numpy as np
import torch

from tokenhawk_tpu_torch.ggml.format import QK, GGMLType
from tokenhawk_tpu_torch.ggml.quants import QuantizedTensor


def _as_tensor(a, dtype=None, device=None) -> torch.Tensor:
    t = a if isinstance(a, torch.Tensor) else torch.from_numpy(np.array(a, order="C"))
    return t.to(device=device, dtype=dtype or t.dtype)


@dataclasses.dataclass
class QWeight:
    """Q4_0 weight of logical shape [K, N] (y = x @ W)."""

    qs: torch.Tensor  # uint8 [N, K//2]
    scales: torch.Tensor  # f32 [N, K//32]

    @property
    def shape(self):
        n, kh = self.qs.shape
        return (kh * 2, n)

    @property
    def nbytes(self) -> int:
        return self.qs.numel() * self.qs.element_size() + (
            self.scales.numel() * self.scales.element_size())

    def to(self, device) -> "QWeight":
        return QWeight(self.qs.to(device), self.scales.to(device))

    # -- construction ----------------------------------------------------

    @staticmethod
    def from_codes(codes, scales, device=None) -> "QWeight":
        """Offset-binary codes [N, K] in [0, 15] + scales [N, K//32]."""
        codes = _as_tensor(codes, torch.uint8, device)
        n, k = codes.shape
        if k % QK:
            raise ValueError(f"q4_0 input dim {k} must be a multiple of {QK}")
        c = codes.reshape(n, k // QK, 2, QK // 2)
        qs = (c[:, :, 0, :] | (c[:, :, 1, :] << 4)).reshape(n, k // 2)
        s = _as_tensor(scales, torch.float32, device).reshape(n, k // QK)
        return QWeight(qs.contiguous(), s.contiguous())

    @staticmethod
    def from_quantized_tensor(qt: QuantizedTensor, device=None) -> "QWeight":
        """GGML host tensor [out, in] -> QWeight of logical shape [in, out]."""
        if qt.kind != GGMLType.Q4_0 or qt.qs.ndim != 2:
            raise ValueError(f"only 2-D q4_0 weights are ported, got "
                             f"{qt.kind!r} {qt.shape}")
        codes = (qt.qs.astype(np.int16) + 8).astype(np.uint8)  # [out, in]
        return QWeight.from_codes(codes, qt.scales, device)

    @staticmethod
    def from_jax_packed(qs, scales, scales_hi, device=None) -> "QWeight":
        """The reference's packed q4_0 arrays (numpy) -> QWeight.

        qs uint8 [K//2, N]: byte row j holds logical row j (low nibble)
        and row j + K//2 (high nibble); scales / scales_hi [K//64, N]
        scale the low / high halves (tokenhawk_tpu.ops.qweight)."""
        qs = np.asarray(qs, np.uint8)
        codes = np.concatenate([qs & 0x0F, qs >> 4], axis=0)  # [K, N]
        full = np.concatenate([np.asarray(scales, np.float32),
                               np.asarray(scales_hi, np.float32)], axis=0)
        return QWeight.from_codes(codes.T, full.T, device)

    @staticmethod
    def quantize(w: torch.Tensor) -> "QWeight":
        """Dense [K, N] -> Q4_0 on w's device (signed-absmax, as
        ggml.quants.quantize_q4_0 does on the host)."""
        k, n = w.shape
        b = w.float().t().reshape(n, k // QK, QK)
        idx = b.abs().argmax(dim=-1, keepdim=True)
        d = torch.gather(b, -1, idx)[..., 0] / -8.0
        inv = torch.where(d != 0, 1.0 / torch.where(d != 0, d, 1.0), 0.0)
        q = torch.clamp(torch.round(b * inv[..., None]), -8, 7)
        codes = (q + 8).to(torch.uint8).reshape(n, k)
        return QWeight.from_codes(codes, d)

    # -- oracle ----------------------------------------------------------

    def codes(self) -> torch.Tensor:
        """Offset-binary codes at [N, K]."""
        n, kh = self.qs.shape
        g = self.qs.reshape(n, kh // (QK // 2), QK // 2)
        return torch.stack([g & 0x0F, g >> 4], dim=2).reshape(n, kh * 2)

    def dequantize(self, dtype=torch.float32) -> torch.Tensor:
        """Materialize the dense logical [K, N] matrix."""
        c = self.codes()
        n, k = c.shape
        w = (c.float() - 8.0).reshape(n, k // QK, QK) * self.scales[..., None]
        return w.reshape(n, k).t().to(dtype)


def concat_qweights(ws) -> QWeight:
    """Concatenate along the output axis (wq|wk|wv -> wqkv, w1|w3 -> w13)."""
    return QWeight(torch.cat([w.qs for w in ws], 0),
                   torch.cat([w.scales for w in ws], 0))


def take_columns(w: "ArrayOrQ", idx: torch.Tensor) -> "ArrayOrQ":
    """Select output columns (load-time permutations)."""
    if isinstance(w, QWeight):
        return QWeight(w.qs[idx].contiguous(), w.scales[idx].contiguous())
    return w[:, idx].contiguous()


ArrayOrQ = Union[torch.Tensor, QWeight]
