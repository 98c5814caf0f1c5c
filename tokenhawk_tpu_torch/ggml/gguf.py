# Copy of tokenhawk_tpu/ggml/gguf.py (imports rewritten, upstream citations as bare
# file:line): importing tokenhawk_tpu imports jax, which the GPU machine lacks.
# tests/test_torch_host.py holds the copy equal to its original.
"""GGUF file reader (llama.cpp's successor to the ggjt v1 format).

The reference predates GGUF and loads only ggjt v1
(th-llama-loader.cpp:47-119); practically every LLaMA
weight file distributed since mid-2023 is GGUF, so reading it natively
is what lets a real weight-holder run this framework (and the committed
ppl-validation procedure, tools/validate_real_model.py) without a
conversion step.

Scope: GGUF v2/v3, little-endian, llama architecture, tensor types
F32/F16/Q4_0/Q4_1/Q8_0 (the same set the rest of the stack supports).
Unknown metadata keys are preserved but ignored; unknown tensor types
raise with the tensor name.

Two format differences from ggjt v1 handled here:
  - blocks carry f16 scales (block_q8_0 {f16 d; i8 qs[32]} = 34 B vs
    ggjt's f32-scale 36 B), parsed by `from_blocks_gguf`;
  - Q4_0 nibbles pack as halves (element j in the low nibble of byte j,
    element j+16 in the high nibble) instead of ggjt's even/odd
    interleave.

Tensor names translate to the ggjt names the rest of the loader uses
(blk.{i}.attn_q.weight -> layers.{i}.attention.wq.weight, ...), and the
exposed interface matches GGMLFile (hparams / vocab / tensors /
load_tensor / raw / close) so runtime/loader.py treats both uniformly.
"""

from __future__ import annotations

import mmap
import os
import struct
from typing import Any, Dict, List, Tuple, Union

import numpy as np

from tokenhawk_tpu_torch.ggml.format import GGMLType, QK
from tokenhawk_tpu_torch.ggml.quants import QuantizedTensor
from tokenhawk_tpu_torch.ggml.reader import GGMLHParams, TensorRecord, Vocab

GGUF_MAGIC = 0x46554747  # 'GGUF' little-endian

# metadata value types
_U8, _I8, _U16, _I16, _U32, _I32, _F32, _BOOL, _STR, _ARR, _U64, _I64, _F64 = range(13)

_SCALAR_FMT = {
    _U8: "<B", _I8: "<b", _U16: "<H", _I16: "<h", _U32: "<I", _I32: "<i",
    _F32: "<f", _BOOL: "<B", _U64: "<Q", _I64: "<q", _F64: "<d",
}

# GGUF block layouts (f16 scales): bytes per (block_elems) elements
_GGUF_BLOCK_BYTES = {
    GGMLType.Q4_0: 2 + QK // 2,  # f16 d + 16 nibble bytes = 18
    GGMLType.Q4_1: 4 + QK // 2,  # f16 d + f16 m + nibbles = 20
    GGMLType.Q5_0: 2 + 4 + QK // 2,  # f16 d + qh[4] + nibbles = 22
    GGMLType.Q5_1: 4 + 4 + QK // 2,  # f16 d + f16 m + qh + nibbles = 24
    GGMLType.Q8_0: 2 + QK,  # f16 d + 32 int8          = 34
}
# k-quants: 256-element super-blocks (ggml/kquants.py)
_KQUANT_KINDS = (GGMLType.Q2_K, GGMLType.Q3_K, GGMLType.Q4_K,
                 GGMLType.Q5_K, GGMLType.Q6_K)

# token_type values (tokenizer.ggml.token_type)
_TOKEN_BYTE = 6


def gguf_tensor_nbytes(kind: GGMLType, n_elem: int) -> int:
    if kind == GGMLType.F32:
        return 4 * n_elem
    if kind == GGMLType.F16:
        return 2 * n_elem
    if kind in _KQUANT_KINDS:
        from tokenhawk_tpu_torch.ggml.kquants import KQUANT_BLOCK_BYTES, QK_K

        return (n_elem // QK_K) * KQUANT_BLOCK_BYTES[kind]
    return (n_elem // QK) * _GGUF_BLOCK_BYTES[kind]


def from_blocks_gguf(
    kind: GGMLType, raw: bytes, shape: Tuple[int, ...]
) -> QuantizedTensor:
    """Parse a GGUF packed block stream into the canonical form."""
    n = int(np.prod(shape))
    nb = n // QK
    bb = _GGUF_BLOCK_BYTES[kind]
    buf = np.frombuffer(raw, dtype=np.uint8, count=nb * bb).reshape(nb, bb)
    if kind == GGMLType.Q8_0:
        d = buf[:, :2].copy().view("<f2").reshape(nb)
        qs = buf[:, 2:].copy().view(np.int8).reshape(nb, QK)
        return QuantizedTensor(kind, tuple(shape), qs.reshape(shape),
                               d.astype(np.float32).reshape(*shape[:-1], -1))
    if kind == GGMLType.Q4_0:
        d = buf[:, :2].copy().view("<f2").reshape(nb)
        packed = buf[:, 2:]
        qs = np.zeros((nb, QK), dtype=np.int8)
        qs[:, : QK // 2] = (packed & 0x0F).astype(np.int8) - 8
        qs[:, QK // 2 :] = (packed >> 4).astype(np.int8) - 8
        return QuantizedTensor(kind, tuple(shape), qs.reshape(shape),
                               d.astype(np.float32).reshape(*shape[:-1], -1))
    if kind == GGMLType.Q4_1:
        d = buf[:, :2].copy().view("<f2").reshape(nb)
        mn = buf[:, 2:4].copy().view("<f2").reshape(nb)
        packed = buf[:, 4:]
        qs = np.zeros((nb, QK), dtype=np.int8)
        qs[:, : QK // 2] = (packed & 0x0F).astype(np.int8)
        qs[:, QK // 2 :] = (packed >> 4).astype(np.int8)
        return QuantizedTensor(
            kind, tuple(shape), qs.reshape(shape),
            d.astype(np.float32).reshape(*shape[:-1], -1),
            mn.astype(np.float32).reshape(*shape[:-1], -1),
        )
    if kind == GGMLType.Q5_0:
        d = buf[:, :2].copy().view("<f2").reshape(nb)
        qh = buf[:, 2:6].copy().view("<u4").reshape(nb)
        packed = buf[:, 6:]
        qs = np.zeros((nb, QK), dtype=np.int8)
        hb = ((qh[:, None] >> np.arange(QK, dtype=np.uint32)[None, :]) & 1
              ).astype(np.int8) << 4
        qs[:, : QK // 2] = (packed & 0x0F).astype(np.int8)
        qs[:, QK // 2 :] = (packed >> 4).astype(np.int8)
        qs = (qs | hb) - 16  # 5-bit code - 16 in [-16, 15]
        return QuantizedTensor(kind, tuple(shape), qs.reshape(shape),
                               d.astype(np.float32).reshape(*shape[:-1], -1))
    if kind == GGMLType.Q5_1:
        d = buf[:, :2].copy().view("<f2").reshape(nb)
        mn = buf[:, 2:4].copy().view("<f2").reshape(nb)
        qh = buf[:, 4:8].copy().view("<u4").reshape(nb)
        packed = buf[:, 8:]
        qs = np.zeros((nb, QK), dtype=np.int8)
        hb = ((qh[:, None] >> np.arange(QK, dtype=np.uint32)[None, :]) & 1
              ).astype(np.int8) << 4
        qs[:, : QK // 2] = (packed & 0x0F).astype(np.int8)
        qs[:, QK // 2 :] = (packed >> 4).astype(np.int8)
        qs = qs | hb  # 5-bit code in [0, 31], affine
        return QuantizedTensor(
            kind, tuple(shape), qs.reshape(shape),
            d.astype(np.float32).reshape(*shape[:-1], -1),
            mn.astype(np.float32).reshape(*shape[:-1], -1),
        )
    raise ValueError(f"from_blocks_gguf: unsupported {kind!r}")


def pack_q5_0_blocks(x: np.ndarray) -> bytes:
    """f32 [n] -> GGUF Q5_0 block stream (tests/tooling)."""
    x = np.asarray(x, np.float32).reshape(-1, QK)
    amax_i = np.argmax(np.abs(x), axis=1)
    maxv = x[np.arange(x.shape[0]), amax_i]
    d = (maxv / -16.0).astype(np.float32)
    inv = np.where(d != 0, 1.0 / np.where(d == 0, 1.0, d), 0.0)
    q = np.clip(np.round(x * inv[:, None]) + 16, 0, 31).astype(np.uint8)
    out = bytearray()
    for b in range(x.shape[0]):
        out += np.float16(d[b]).tobytes()
        qh = 0
        for j in range(QK):
            qh |= int(q[b, j] >> 4) << j
        out += int(qh).to_bytes(4, "little")
        lo, hi = q[b, : QK // 2] & 0xF, q[b, QK // 2 :] & 0xF
        out += bytes((lo | (hi << 4)).astype(np.uint8))
    return bytes(out)


def pack_q5_1_blocks(x: np.ndarray) -> bytes:
    """f32 [n] -> GGUF Q5_1 block stream (tests/tooling)."""
    x = np.asarray(x, np.float32).reshape(-1, QK)
    mn = x.min(axis=1)
    d = ((x.max(axis=1) - mn) / 31.0).astype(np.float32)
    inv = np.where(d != 0, 1.0 / np.where(d == 0, 1.0, d), 0.0)
    q = np.clip(np.round((x - mn[:, None]) * inv[:, None]), 0, 31).astype(
        np.uint8)
    out = bytearray()
    for b in range(x.shape[0]):
        out += np.float16(d[b]).tobytes()
        out += np.float16(mn[b]).tobytes()
        qh = 0
        for j in range(QK):
            qh |= int(q[b, j] >> 4) << j
        out += int(qh).to_bytes(4, "little")
        lo, hi = q[b, : QK // 2] & 0xF, q[b, QK // 2 :] & 0xF
        out += bytes((lo | (hi << 4)).astype(np.uint8))
    return bytes(out)


def translate_name(name: str) -> str:
    """GGUF tensor name -> the ggjt name params_from_ggml expects."""
    if name == "token_embd.weight":
        return "tok_embeddings.weight"
    if name == "output_norm.weight":
        return "norm.weight"
    if name == "output.weight":
        return "output.weight"
    if name.startswith("blk."):
        _, i, rest = name.split(".", 2)
        table = {
            "attn_q.weight": "attention.wq.weight",
            "attn_k.weight": "attention.wk.weight",
            "attn_v.weight": "attention.wv.weight",
            "attn_output.weight": "attention.wo.weight",
            "attn_norm.weight": "attention_norm.weight",
            "ffn_gate.weight": "feed_forward.w1.weight",
            "ffn_down.weight": "feed_forward.w2.weight",
            "ffn_up.weight": "feed_forward.w3.weight",
            "ffn_norm.weight": "ffn_norm.weight",
        }
        if rest in table:
            return f"layers.{i}.{table[rest]}"
    return name  # rope_freqs.weight etc. pass through (ignored downstream)


def _vocab_from_metadata(md: Dict[str, Any]) -> Vocab:
    """tokenizer.ggml.* -> byte-piece Vocab (the ggjt v1 convention:
    real spaces, real bytes — GGUF keeps SentencePiece's ▁ and
    <0xXX> forms, llama.cpp converts at decode time, we convert once
    here)."""
    tok_model = md.get("tokenizer.ggml.model", "llama")
    if tok_model == "gpt2":
        # Byte-level BPE (Llama-3-family conversions): vocab strings live
        # in the GPT-2 byte->unicode space.  Decode them to raw bytes for
        # the generic Vocab (n_vocab, debugging); the real tokenizer is
        # tokenizer_bpe.BpeTokenizer via build_tokenizer().
        from tokenhawk_tpu_torch.tokenizer_bpe import CONTROL, unicode_to_bytes

        dec = unicode_to_bytes()
        tokens_s = md["tokenizer.ggml.tokens"]
        types = md.get("tokenizer.ggml.token_type", [1] * len(tokens_s))
        toks: List[bytes] = []
        for t, ty in zip(tokens_s, types):
            if ty == CONTROL or any(c not in dec for c in t):
                toks.append(t.encode("utf-8"))
            else:
                toks.append(bytes(dec[c] for c in t))
        return Vocab(toks, [0.0] * len(toks))
    if tok_model != "llama":
        # Unknown vocab convention — refusing loudly beats silently
        # mis-tokenizing.
        raise ValueError(
            f"unsupported GGUF tokenizer model {tok_model!r}: supported "
            "are 'llama' (SentencePiece) and 'gpt2' (byte-level BPE)")
    tokens_s: List[str] = md["tokenizer.ggml.tokens"]
    scores: List[float] = md.get(
        "tokenizer.ggml.scores", [0.0] * len(tokens_s))
    types: List[int] = md.get("tokenizer.ggml.token_type", [1] * len(tokens_s))
    tokens: List[bytes] = []
    for t, ty in zip(tokens_s, types):
        if ty == _TOKEN_BYTE and t.startswith("<0x") and t.endswith(">"):
            tokens.append(bytes([int(t[3:-1], 16)]))
        else:
            tokens.append(t.replace("▁", " ").encode("utf-8"))
    return Vocab(tokens, list(scores))


class GGUFFile:
    """Parsed GGUF file with lazy, zero-copy tensor access.

    Interface-compatible with reader.GGMLFile; adds `.metadata` (raw
    key-value dict) and `.config_overrides` (LlamaConfig kwargs read
    from the llama.* metadata)."""

    def __init__(self, path: Union[str, os.PathLike]):
        self.path = os.fspath(path)
        self._f = open(self.path, "rb")
        self._mm = mmap.mmap(self._f.fileno(), 0, access=mmap.ACCESS_READ)
        self.metadata, self._records = self._parse()
        self.tensors: Dict[str, TensorRecord] = {r.name: r for r in self._records}
        md = self.metadata
        arch = md.get("general.architecture", "llama")
        if arch != "llama":
            raise ValueError(f"unsupported GGUF architecture {arch!r}")
        self.vocab = _vocab_from_metadata(md)
        n_embd = int(md["llama.embedding_length"])
        n_head = int(md["llama.attention.head_count"])
        self.hparams = GGMLHParams(
            n_vocab=len(self.vocab),
            n_embd=n_embd,
            n_mult=256,  # unused: n_ff comes from metadata
            n_head=n_head,
            n_layer=int(md["llama.block_count"]),
            n_rot=int(md.get("llama.rope.dimension_count", n_embd // n_head)),
            ftype=int(md.get("general.file_type", 1)),
        )
        self.config_overrides: Dict[str, Any] = {}
        if "llama.feed_forward_length" in md:
            self.config_overrides["n_ff"] = int(md["llama.feed_forward_length"])
        kv = md.get("llama.attention.head_count_kv")
        if kv is not None and int(kv) != n_head:
            self.config_overrides["n_kv_head"] = int(kv)
        if "llama.attention.layer_norm_rms_epsilon" in md:
            self.config_overrides["rms_norm_eps"] = float(
                md["llama.attention.layer_norm_rms_epsilon"])
        if "llama.rope.freq_base" in md:
            self.config_overrides["rope_theta"] = float(md["llama.rope.freq_base"])
        # Tied embeddings: no output.weight tensor — the embedding matrix
        # ([V, D], the same [out, in] orientation) doubles as the head.
        if "output.weight" not in self.tensors and (
            "tok_embeddings.weight" in self.tensors
        ):
            emb = self.tensors["tok_embeddings.weight"]
            self.tensors["output.weight"] = TensorRecord(
                "output.weight", emb.ggml_type, emb.shape, emb.data_offset,
                emb.data_nbytes, emb.record_offset,
            )

    def build_tokenizer(self):
        """The file's tokenizer: SPM (``tokenizer.ggml.model == "llama"``)
        or byte-level BPE (``"gpt2"``, the Llama-3-family convention),
        with bos/eos ids taken from the metadata rather than the SPM
        defaults (Llama-3's BOS is 128000, EOS 128001/128009)."""
        md = self.metadata
        if md.get("tokenizer.ggml.model", "llama") == "gpt2":
            from tokenhawk_tpu_torch.tokenizer_bpe import BpeTokenizer

            return BpeTokenizer.from_gguf_metadata(md)
        from tokenhawk_tpu_torch.tokenizer import Tokenizer

        return Tokenizer.from_vocab(
            self.vocab,
            bos_id=int(md.get("tokenizer.ggml.bos_token_id", 1)),
            eos_id=int(md.get("tokenizer.ggml.eos_token_id", 2)),
        )

    # -- parsing ---------------------------------------------------------

    def _parse(self):
        mm = self._mm
        off = 0

        def scalar(ty):
            nonlocal off
            fmt = _SCALAR_FMT[ty]
            (v,) = struct.unpack_from(fmt, mm, off)
            off += struct.calcsize(fmt)
            return bool(v) if ty == _BOOL else v

        def string() -> str:
            nonlocal off
            (ln,) = struct.unpack_from("<Q", mm, off)
            off += 8
            s = bytes(mm[off : off + ln]).decode("utf-8", errors="replace")
            off += ln
            return s

        def value(ty):
            nonlocal off
            if ty == _STR:
                return string()
            if ty == _ARR:
                (ety,) = struct.unpack_from("<I", mm, off)
                off += 4
                (cnt,) = struct.unpack_from("<Q", mm, off)
                off += 8
                if ety in _SCALAR_FMT and ety != _BOOL:
                    fmt = _SCALAR_FMT[ety]
                    sz = struct.calcsize(fmt)
                    arr = np.frombuffer(mm, dtype=fmt, count=cnt, offset=off)
                    off += sz * cnt
                    return arr.tolist()
                return [value(ety) for _ in range(cnt)]
            return scalar(ty)

        (magic,) = struct.unpack_from("<I", mm, off)
        off += 4
        if magic != GGUF_MAGIC:
            raise ValueError(f"bad GGUF magic 0x{magic:08x}")
        (version,) = struct.unpack_from("<I", mm, off)
        off += 4
        if version not in (2, 3):
            raise ValueError(f"unsupported GGUF version {version}")
        n_tensors, n_kv = struct.unpack_from("<QQ", mm, off)
        off += 16

        md: Dict[str, Any] = {}
        for _ in range(n_kv):
            key = string()
            (ty,) = struct.unpack_from("<I", mm, off)
            off += 4
            md[key] = value(ty)

        infos = []
        for _ in range(n_tensors):
            name = string()
            (ndims,) = struct.unpack_from("<I", mm, off)
            off += 4
            dims = struct.unpack_from(f"<{ndims}Q", mm, off)  # ne0 fastest
            off += 8 * ndims
            ty, = struct.unpack_from("<I", mm, off)
            off += 4
            (rel_off,) = struct.unpack_from("<Q", mm, off)
            off += 8
            infos.append((name, dims, ty, rel_off))

        align = int(md.get("general.alignment", 32))
        data_start = (off + align - 1) & -(align)

        records: List[TensorRecord] = []
        for name, dims, ty, rel_off in infos:
            try:
                gtype = GGMLType(ty)
            except ValueError as e:
                raise ValueError(
                    f"tensor {name!r}: unsupported GGUF tensor type {ty}"
                ) from e
            shape = tuple(reversed(dims)) if dims else (1,)
            n_elem = int(np.prod(shape))
            nbytes = gguf_tensor_nbytes(gtype, n_elem)
            records.append(TensorRecord(
                translate_name(name), gtype, shape,
                data_start + rel_off, nbytes, -1,
            ))
        return md, records

    # -- access (GGMLFile-compatible) -------------------------------------

    def __iter__(self):
        return iter(self._records)

    def raw(self, name: str) -> memoryview:
        r = self.tensors[name]
        return memoryview(self._mm)[r.data_offset : r.data_offset + r.data_nbytes]

    def load_tensor(
        self, name: str, dequant: bool = False
    ) -> Union[np.ndarray, QuantizedTensor]:
        r = self.tensors[name]
        raw = self.raw(name)
        if r.ggml_type == GGMLType.F32:
            return np.frombuffer(raw, dtype="<f4").reshape(r.shape)
        if r.ggml_type == GGMLType.F16:
            return np.frombuffer(raw, dtype="<f2").reshape(r.shape)
        if r.ggml_type in _KQUANT_KINDS:
            # k-quants dequantize to dense f32 here; the model loader
            # requantizes 2-D projections to Q8_0 for the device path
            # (q8 is ~4 bits finer, so the k-quant rounding dominates).
            from tokenhawk_tpu_torch.ggml.kquants import dequant_kquant

            return dequant_kquant(r.ggml_type, bytes(raw), r.shape)
        qt = from_blocks_gguf(r.ggml_type, bytes(raw), r.shape)
        if dequant:
            from tokenhawk_tpu_torch.ggml.quants import dequantize

            return dequantize(qt)
        return qt

    def close(self):
        try:
            self._mm.close()
        except BufferError:
            pass
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def is_gguf(path: Union[str, os.PathLike]) -> bool:
    try:
        with open(path, "rb") as f:
            return struct.unpack("<I", f.read(4))[0] == GGUF_MAGIC
    except (OSError, struct.error):
        return False


# -- writing (tests / tooling) ------------------------------------------


class RawTensor:
    """Pre-packed tensor payload for write_gguf (k-quant test files)."""

    def __init__(self, kind: GGMLType, shape: Tuple[int, ...], raw: bytes):
        self.kind = kind
        self.shape = tuple(shape)
        self.raw = raw


def _pack_gguf_blocks(qt: QuantizedTensor) -> bytes:
    """Canonical QuantizedTensor -> GGUF packed block stream."""
    n = int(np.prod(qt.shape))
    nb = n // QK
    qs = np.asarray(qt.qs).reshape(nb, QK)
    d = np.asarray(qt.scales, np.float32).reshape(nb).astype("<f2")
    if qt.kind == GGMLType.Q8_0:
        out = np.zeros((nb, 2 + QK), np.uint8)
        out[:, :2] = d.view(np.uint8).reshape(nb, 2)
        out[:, 2:] = qs.astype(np.int8).view(np.uint8)
        return out.tobytes()
    if qt.kind == GGMLType.Q4_0:
        u = (qs.astype(np.int16) + 8).astype(np.uint8)
        out = np.zeros((nb, 2 + QK // 2), np.uint8)
        out[:, :2] = d.view(np.uint8).reshape(nb, 2)
        out[:, 2:] = u[:, : QK // 2] | (u[:, QK // 2 :] << 4)
        return out.tobytes()
    raise ValueError(f"write: unsupported {qt.kind!r}")


def write_gguf(
    path: Union[str, os.PathLike],
    metadata: Dict[str, Any],
    tensors: Dict[str, Union[np.ndarray, QuantizedTensor]],
    version: int = 3,
) -> None:
    """Write a GGUF v3 file.

    Tensor names are GGUF-native (blk.N..., token_embd.weight, ...);
    values are f32/f16 numpy arrays or QuantizedTensors (Q4_0/Q8_0).
    Metadata values: int -> u32 (u64 if large), float -> f32, str, bool,
    and homogeneous lists thereof.
    """

    def enc_string(s: str) -> bytes:
        b = s.encode("utf-8")
        return struct.pack("<Q", len(b)) + b

    def enc_value(v) -> Tuple[int, bytes]:
        if isinstance(v, bool):
            return _BOOL, struct.pack("<B", int(v))
        if isinstance(v, int):
            if 0 <= v < 2**32:
                return _U32, struct.pack("<I", v)
            return _I64 if v < 0 else _U64, struct.pack(
                "<q" if v < 0 else "<Q", v)
        if isinstance(v, float):
            return _F32, struct.pack("<f", v)
        if isinstance(v, str):
            return _STR, enc_string(v)
        if isinstance(v, (list, tuple, np.ndarray)):
            items = list(v)
            if not items:
                return _ARR, struct.pack("<IQ", _U32, 0)
            parts = []
            ety = None
            for it in items:
                t, b = enc_value(
                    it.item() if isinstance(it, np.generic) else it)
                ety = t if ety is None else ety
                if t != ety:
                    raise ValueError("heterogeneous GGUF array")
                parts.append(b)
            return _ARR, struct.pack("<IQ", ety, len(items)) + b"".join(parts)
        if isinstance(v, np.generic):
            return enc_value(v.item())
        raise TypeError(f"unsupported metadata value {type(v)}")

    align = int(metadata.get("general.alignment", 32))
    blobs: List[Tuple[str, int, Tuple[int, ...], bytes]] = []
    for name, t in tensors.items():
        if isinstance(t, RawTensor):
            blobs.append((name, int(t.kind), t.shape, t.raw))
        elif isinstance(t, QuantizedTensor):
            blobs.append((name, int(t.kind), t.shape, _pack_gguf_blocks(t)))
        else:
            a = np.ascontiguousarray(t)
            if a.dtype == np.float16:
                ty = int(GGMLType.F16)
            else:
                a = a.astype("<f4")
                ty = int(GGMLType.F32)
            blobs.append((name, ty, a.shape, a.tobytes()))

    out = bytearray()
    out += struct.pack("<IIQQ", GGUF_MAGIC, version, len(blobs), len(metadata))
    for k, v in metadata.items():
        ty, b = enc_value(v)
        out += enc_string(k) + struct.pack("<I", ty) + b
    rel = 0
    offsets = []
    for name, ty, shape, payload in blobs:
        dims = tuple(reversed(shape))  # ne0 fastest
        out += enc_string(name)
        out += struct.pack("<I", len(dims))
        out += struct.pack(f"<{len(dims)}Q", *dims)
        out += struct.pack("<IQ", ty, rel)
        offsets.append(rel)
        rel = (rel + len(payload) + align - 1) & -(align)
    pad = (-len(out)) % align
    out += b"\0" * pad
    for (name, ty, shape, payload), rel_off in zip(blobs, offsets):
        assert len(out) % align == 0 or rel_off == 0
        out += payload
        out += b"\0" * ((-len(payload)) % align)
    with open(path, "wb") as f:
        f.write(bytes(out))
