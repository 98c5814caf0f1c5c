"""Quantized weight container in the Hopper layout.

Counterpart of tokenhawk_tpu/ops/qweight.py.  The reference keeps codes
contraction-major ([K, N], q4_0 packed [K//2, N]) because the TPU kernels
tile (K, N) blocks into VMEM.  On the GPU the matmul kernels are GEMVs at
decode: one warp walks one output column down K, so the port stores each
output column's codes contiguously, output-major, which is GGML's own
[out, in] order.  Three kinds:

  kind "q4_0" (kernel 1; ggjt and GGUF Q4_0):
    qs:     uint8 [N, K//2]  group g of column n is bytes [16g, 16g+16) of
            row n; byte j holds code 32g+j in its low nibble and code
            32g+16+j in its high nibble, offset-binary (value + 8).
    scales: f32 [N, K//32]   one scale per (column, group of 32 inputs).
  kind "qk" (kernel 13; every other int-code kind), w = code*s + m:
    qs:     int8 [N, K]      the codes, one byte each.
    scales: f32 [N, K//G]    s per (column, group of G inputs).
    mins:   f32 [N, K//G]    m, or None for a symmetric kind.
    group:  G, 16 or 32.
  kind "q4k_sb" (kernel 17; Q4_K under THAWK_Q4K_SB=1), Q4_K's two levels
  kept apart, w = (code - 8) * s + b with s = d*sc and b = 8s - dmin*mn
  expanded per group of 32 (the reference's super-block form):
    qs:     uint8 [N, K//2]  Q4_K's codes, packed as q4_0's (code 32g+j in
            the low nibble of byte 16g+j, code 32g+16+j in its high one);
            a Q4_K code is already offset-binary.
    scales: f32 [N, K//256]  d per (column, super-block of 256 inputs).
    mins:   f32 [N, K//256]  dmin.
    scmn:   uint8 [N, 2*K//32]  the 6-bit sc of each group of 32, then its mn.
  About 0.59 B per weight against the flat qk form's 1.25.

The qk forms of the GGML kinds are the reference's (from_quantized_tensor
and from_kquant_raw with use_i4=False):

  Q8_0  code            s = d        no mins   G 32
  Q5_0  code - 16       s = d        no mins   G 32
  Q4_1  code            s = d        m = min   G 32
  Q5_1  code            s = d        m = min   G 32
  Q2_K  code            s = d*sc     m = -dmin*mn       G 16
  Q3_K  code (signed)   s = d*sc     no mins   G 16
  Q4_K  code (0..15)    s = d*sc     m = -dmin*mn       G 32
  Q5_K  code - 16       s = d*sc     m = 16s - dmin*mn  G 32
  Q6_K  code - 32       s = d*sc     no mins   G 16

Scales and mins are stored float32.  The constructors take the
reference's `scale_dtype`: at bfloat16 (load_model's default, as the
reference's) each side is rounded to bfloat16 and kept in float32, so the
kernels are unchanged and `dequantize()` equals the reference's
QWeight.dequantize bit for bit at either scale_dtype.  The flat qk form
rounds its derived s and bias; the q4k_sb form rounds d and dmin, as the
reference does, so at bfloat16 sides the two forms of one tensor are
different weights (bit-equal at float32).  Group codes of the flat form
take a byte each (1.25 B per Q4_K weight where the file holds 0.5625).

`dequantize()` returns the logical [K, N] matrix (the reference's
orientation) and is the oracle every kernel test holds the port to.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import numpy as np
import torch

from tokenhawk_tpu_torch.ggml.format import QK, GGMLType
from tokenhawk_tpu_torch.ggml.quants import QuantizedTensor


def _as_tensor(a, dtype=None, device=None) -> torch.Tensor:
    t = a if isinstance(a, torch.Tensor) else torch.from_numpy(np.array(a, order="C"))
    return t.to(device=device, dtype=dtype or t.dtype)


def _side(a, device, scale_dtype) -> torch.Tensor:
    """A scale or min array as float32, its values rounded to scale_dtype
    (round to nearest even, as the reference's device cast)."""
    t = _as_tensor(a, torch.float32, device)
    return t if scale_dtype == torch.float32 else t.to(scale_dtype).to(torch.float32)


@dataclasses.dataclass
class QWeight:
    """Quantized weight of logical shape [K, N] (y = x @ W)."""

    qs: torch.Tensor  # q4_0, q4k_sb: uint8 [N, K//2]; qk: int8 [N, K]
    scales: torch.Tensor  # f32 [N, K//group]; q4k_sb: d [N, K//256]
    mins: Optional[torch.Tensor] = None  # qk: f32 [N, K//group] or None; q4k_sb: dmin
    kind: str = "q4_0"
    group: int = QK
    scmn: Optional[torch.Tensor] = None  # q4k_sb only: uint8 [N, 2*K//32]

    @property
    def shape(self):
        n, k = self.qs.shape
        return (k * 2, n) if self.kind in ("q4_0", "q4k_sb") else (k, n)

    def tensors(self) -> list:
        """The tensors the weight holds: qs, scales, then mins and scmn
        where it has them."""
        return [t for t in (self.qs, self.scales, self.mins, self.scmn) if t is not None]

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in self.tensors())

    def _replace(self, fn) -> "QWeight":
        def opt(t):
            return None if t is None else fn(t)

        return dataclasses.replace(self, qs=fn(self.qs), scales=fn(self.scales),
                                   mins=opt(self.mins), scmn=opt(self.scmn))

    def to(self, device) -> "QWeight":
        return self._replace(lambda t: t.to(device))

    # -- construction ----------------------------------------------------

    @staticmethod
    def from_codes(codes, scales, device=None, scale_dtype=torch.float32) -> "QWeight":
        """q4_0: offset-binary codes [N, K] in [0, 15] + scales [N, K//32]."""
        qs = _pack_nibbles(_as_tensor(codes, torch.uint8, device))
        n, k = qs.shape[0], qs.shape[1] * 2
        s = _side(scales, device, scale_dtype).reshape(n, k // QK)
        return QWeight(qs, s.contiguous())

    @staticmethod
    def from_super_blocks(codes, sc, mn, d, dmin, device=None,
                          scale_dtype=torch.float32) -> "QWeight":
        """q4k_sb: Q4_K codes [N, K] in [0, 15], the 6-bit sc and mn
        [N, K//32], d and dmin [N, K//256] (rounded to scale_dtype)."""
        qs = _pack_nibbles(_as_tensor(codes, torch.uint8, device))
        n, k = qs.shape[0], qs.shape[1] * 2
        if k % 256:
            raise ValueError(f"q4k_sb input dim {k} must be a multiple of 256")
        scmn = torch.cat([_as_tensor(sc, torch.uint8, device).reshape(n, k // 32),
                          _as_tensor(mn, torch.uint8, device).reshape(n, k // 32)], 1)

        def side(a):
            return _side(a, device, scale_dtype).reshape(n, k // 256).contiguous()

        return QWeight(qs, side(d), side(dmin), kind="q4k_sb", group=32,
                       scmn=scmn.contiguous())

    @staticmethod
    def from_group_codes(codes, scales, mins=None, group: int = QK, device=None,
                         scale_dtype=torch.float32) -> "QWeight":
        """qk: signed codes [N, K] + scales (and mins) [N, K//group]."""
        qs = _as_tensor(codes, torch.int8, device)
        n, k = qs.shape
        if group not in (16, 32) or k % 32:
            raise ValueError(f"group-code weights take G 16 or 32 and K a multiple of 32, "
                             f"got G {group}, K {k}")

        def side(a):
            return _side(a, device, scale_dtype).reshape(n, k // group).contiguous()

        return QWeight(qs.contiguous(), side(scales), None if mins is None else side(mins),
                       kind="qk", group=group)

    @staticmethod
    def from_quantized_tensor(qt: QuantizedTensor, device=None,
                              scale_dtype=torch.float32) -> "QWeight":
        """GGML host tensor [out, in] -> QWeight of logical shape [in, out].

        Q4_0 goes to the q4_0 kind; Q8_0, Q5_0, Q4_1 and Q5_1 to qk with
        G 32 (the host codec's codes are already the reference's: Q5_0
        code - 16, Q4_1 / Q5_1 unsigned with their mins)."""
        if qt.qs.ndim != 2:
            raise ValueError(f"expected a 2-D weight, got {qt.shape}")
        if qt.kind == GGMLType.Q4_0:
            codes = (qt.qs.astype(np.int16) + 8).astype(np.uint8)  # [out, in]
            return QWeight.from_codes(codes, qt.scales, device, scale_dtype)
        if qt.kind not in (GGMLType.Q8_0, GGMLType.Q5_0, GGMLType.Q4_1, GGMLType.Q5_1):
            raise ValueError(f"no device form for {qt.kind!r}")
        return QWeight.from_group_codes(qt.qs, qt.scales, qt.mins, QK, device, scale_dtype)

    @staticmethod
    def from_kquant_raw(gtype: GGMLType, raw: bytes, shape, device=None,
                        scale_dtype=torch.float32, sb: bool = False,
                        sb_ok: bool = True) -> "QWeight":
        """GGUF k-quant block stream of an [out, in] tensor -> qk QWeight
        of logical shape [in, out]: the reference's from_kquant_raw with
        use_i4=False, in the port's output-major layout.  The derived
        sides s = d*sc and the bias are rounded to scale_dtype, as there.

        With `sb` (the loader's THAWK_Q4K_SB=1) a Q4_K tensor takes the
        q4k_sb kind where the reference's gate puts it: `sb_ok` (the loader
        clears it for feed_forward.w2) and q4k_sb_fits(in_dim).  Its d and
        dmin are rounded to scale_dtype, as there."""
        from tokenhawk_tpu_torch.ggml import kquant_decode as kd

        out_dim, in_dim = shape
        if gtype not in kd.EXTRACT:
            raise ValueError(f"not a supported k-quant: {gtype!r}")
        # Unpacked on the device (ggml/kquant_decode.py): kquants.extract_*'s
        # values, without numpy's seconds a large tensor on the host.
        buf = kd.blocks(gtype, raw, out_dim * in_dim, device)
        if gtype == GGMLType.Q4_K and sb and sb_ok and q4k_sb_fits(in_dim):
            codes, sc, mn, d, dmin = kd.extract_q4_k_sb(buf)
            return QWeight.from_super_blocks(
                codes.reshape(out_dim, in_dim), sc, mn, d, dmin, device, scale_dtype)
        out = kd.EXTRACT[gtype](buf)
        codes, s = out[0], out[1]
        if gtype == GGMLType.Q4_K:
            group, qs, bias = 32, codes.to(torch.int8), -out[2]
        elif gtype == GGMLType.Q5_K:
            group, qs, bias = 32, (codes.to(torch.int16) - 16).to(torch.int8), 16.0 * s - out[2]
        elif gtype == GGMLType.Q2_K:
            group, qs, bias = 16, codes.to(torch.int8), -out[2]
        else:  # Q6_K, Q3_K: signed codes, no min
            group, qs, bias = 16, codes, None
        return QWeight.from_group_codes(qs.reshape(out_dim, in_dim), s, bias, group, device,
                                        scale_dtype)

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
    def from_jax(kind: str, qs, scales, mins=None, scales_hi=None, group: int = QK,
                 device=None) -> "QWeight":
        """The reference's QWeight fields (numpy) -> QWeight: q4_0 packed,
        or the [K, N] int codes of q8_0, q4_1, qk_i8 and qk_i4 (int4 codes
        passed as int8) with their [K//G, N] sides, or q4k_sb: int4 codes
        - 8 [K, N] passed as int8, d / dmin [K//256, N] and scales_hi, the
        int8 rows [sc | mn] [2*K//32, N]."""
        if kind == "q4_0":
            return QWeight.from_jax_packed(qs, scales, scales_hi, device)
        if kind == "q4k_sb":
            hi = np.asarray(scales_hi).astype(np.uint8).T  # [N, 2*K//32]
            g = hi.shape[1] // 2
            return QWeight.from_super_blocks(
                (np.asarray(qs).astype(np.int16) + 8).astype(np.uint8).T, hi[:, :g], hi[:, g:],
                np.asarray(scales, np.float32).T, np.asarray(mins, np.float32).T, device)
        if kind not in ("q8_0", "q4_1", "qk_i8", "qk_i4"):
            raise ValueError(f"no device form for the reference's {kind!r}")
        return QWeight.from_group_codes(
            np.asarray(qs).astype(np.int8).T, np.asarray(scales, np.float32).T,
            None if mins is None else np.asarray(mins, np.float32).T, group, device)

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

    @staticmethod
    def random(k: int, n: int, form: str, generator: torch.Generator, device=None,
               std: float = 0.02) -> "QWeight":
        """Random codes and sides of one GGML kind, drawn on `device` (no
        dense matrix): form "q8_0", "q4_k" or "q6_k", or "q4k_sb" (Q4_K in
        the super-block form), with weights of about `std` around zero."""
        if form == "q4k_sb":
            codes = torch.randint(0, 16, (n, k), generator=generator, device=device,
                                  dtype=torch.uint8)
            sc = torch.randint(32, 64, (n, k // 32), generator=generator, device=device)
            # mn near sc and dmin = 7.5 d: each group's mean near zero.
            mn = (sc + torch.randint(-2, 3, sc.shape, generator=generator, device=device))
            u = torch.rand((n, k // 256), generator=generator, device=device)
            d = ((std / (4.61 * 47.5)) * (0.75 + 0.5 * u)).half()  # float16, as in a file
            return QWeight.from_super_blocks(codes, sc.to(torch.uint8), mn.to(torch.uint8),
                                             d.float(), (7.5 * d).float())
        # (code range, group, code std, with mins)
        lo, hi, group, code_std, affine = {
            "q8_0": (-127, 128, 32, 73.6, False), "q4_k": (0, 16, 32, 4.61, True),
            "q6_k": (-32, 32, 16, 18.5, False)}[form]
        codes = torch.randint(lo, hi, (n, k), generator=generator, device=device,
                              dtype=torch.int8)
        u = torch.rand((n, k // group), generator=generator, device=device)
        s = (std / code_std) * (0.75 + 0.5 * u)
        mins = -7.5 * s * (0.9 + 0.2 * u.flip(-1)) if affine else None
        return QWeight.from_group_codes(codes, s, mins, group)

    def flat(self) -> "QWeight":
        """A q4k_sb weight in the flat qk form of the same codes (G 32,
        s = d*sc, m = -dmin*mn, codes a byte each): the form the loader
        gives without THAWK_Q4K_SB at float32 sides.  The two dequantize
        alike wherever 8s - dmin*mn is exact in f32."""
        if self.kind != "q4k_sb":
            raise ValueError(f"flat() takes a q4k_sb weight, got {self.kind}")
        g = self.scmn.shape[1] // 2
        s = self.scales.repeat_interleave(8, dim=1) * self.scmn[:, :g].float()
        m = -(self.mins.repeat_interleave(8, dim=1) * self.scmn[:, g:].float())
        return QWeight.from_group_codes(self.codes().to(torch.int8), s, m, 32)

    # -- oracle ----------------------------------------------------------

    def codes(self) -> torch.Tensor:
        """Codes at [N, K]: offset-binary for q4_0 and q4k_sb, the qs for qk."""
        if self.kind == "qk":
            return self.qs
        n, kh = self.qs.shape
        g = self.qs.reshape(n, kh // (QK // 2), QK // 2)
        return torch.stack([g & 0x0F, g >> 4], dim=2).reshape(n, kh * 2)

    def dequantize(self, dtype=torch.float32) -> torch.Tensor:
        """Materialize the dense logical [K, N] matrix."""
        c = self.codes()
        n, k = c.shape
        if self.kind == "q4k_sb":
            # The reference's order: s = d*sc, b = 8s - dmin*mn, w = (code-8)*s + b.
            g = k // 32
            sc, mn = self.scmn[:, :g].float(), self.scmn[:, g:].float()
            s = self.scales.repeat_interleave(8, dim=1) * sc
            b = 8.0 * s - self.mins.repeat_interleave(8, dim=1) * mn
            w = (c.float() - 8.0).reshape(n, g, 32) * s[..., None] + b[..., None]
            return w.reshape(n, k).t().to(dtype)
        q = c.float() - 8.0 if self.kind == "q4_0" else c.float()
        w = q.reshape(n, k // self.group, self.group) * self.scales[..., None]
        if self.mins is not None:
            w = w + self.mins[..., None]
        return w.reshape(n, k).t().to(dtype)


def q4k_sb_fits(in_dim: int) -> bool:
    """The reference's width gate for the q4k_sb kind (qweight.py
    from_kquant_raw, kept for its TPU tiling): in_dim % 1024 == 0, and
    in_dim % 4096 == 0 or in_dim <= 16384."""
    return in_dim % 1024 == 0 and (in_dim % 4096 == 0 or in_dim <= 16384)


def _pack_nibbles(codes: torch.Tensor) -> torch.Tensor:
    """Offset-binary 4-bit codes uint8 [N, K] -> uint8 [N, K//2]: byte j of
    group g holds code 32g+j (low nibble) and 32g+16+j (high nibble)."""
    n, k = codes.shape
    if k % QK:
        raise ValueError(f"4-bit code input dim {k} must be a multiple of {QK}")
    c = codes.reshape(n, k // QK, 2, QK // 2)
    return (c[:, :, 0, :] | (c[:, :, 1, :] << 4)).reshape(n, k // 2).contiguous()


def concat_qweights(ws) -> QWeight:
    """Concatenate along the output axis (wq|wk|wv -> wqkv, w1|w3 -> w13);
    all of one kind, group and mins presence."""
    forms = {(w.kind, w.group, w.mins is None) for w in ws}
    if len(forms) != 1:
        raise ValueError(f"cannot concatenate mixed forms {forms}")

    def cat(field):
        parts = [getattr(w, field) for w in ws]
        return None if parts[0] is None else torch.cat(parts, 0)

    return dataclasses.replace(ws[0], **{f: cat(f) for f in ("qs", "scales", "mins", "scmn")})


def take_columns(w: "ArrayOrQ", idx: torch.Tensor) -> "ArrayOrQ":
    """Select output columns (load-time permutations)."""
    if isinstance(w, QWeight):
        return w._replace(lambda t: t[idx].contiguous())
    return w[:, idx].contiguous()


ArrayOrQ = Union[torch.Tensor, QWeight]
