# Copy of tokenhawk_tpu/ggml/reader.py (imports rewritten, upstream citations as bare
# file:line): importing tokenhawk_tpu imports jax, which the GPU machine lacks.
# tests/test_torch_host.py holds the copy equal to its original.
"""GGML (ggjt v1) file reader.

Streaming, mmap-backed: tensor payloads are exposed as zero-copy numpy
views into the mapped file so a 13 GB model never needs a second host
copy (the reference streams through a 128 MB scratch vector instead,
th-llama-loader.cpp:571-621).

Capability parity targets:
  - header + scored vocab parse     (th-llama-loader.cpp:47-119)
  - tensor records with 32-byte
    data alignment                  (th-llama-loader.cpp:121-265)
plus the Q4_0/Q4_1/Q8_0 support the reference rejects.
"""

from __future__ import annotations

import dataclasses
import mmap
import os
import struct
from typing import Dict, Iterator, List, Optional, Tuple, Union

import numpy as np

from tokenhawk_tpu_torch.ggml.format import (
    GGML_MAGIC,
    GGML_MAGIC_UNVERSIONED,
    GGML_VERSION,
    GGMLType,
    is_quantized,
    tensor_nbytes,
)
from tokenhawk_tpu_torch.ggml.quants import QuantizedTensor, from_blocks

_ALIGN = 32


@dataclasses.dataclass
class GGMLHParams:
    n_vocab: int
    n_embd: int
    n_mult: int
    n_head: int
    n_layer: int
    n_rot: int
    ftype: int


@dataclasses.dataclass
class TensorRecord:
    name: str
    ggml_type: GGMLType
    shape: Tuple[int, ...]  # numpy/logical order: rows-major, last dim = columns
    data_offset: int
    data_nbytes: int
    record_offset: int = -1  # file offset where this record's header begins


@dataclasses.dataclass
class Vocab:
    tokens: List[bytes]
    scores: List[float]

    def __len__(self) -> int:
        return len(self.tokens)


class GGMLFile:
    """Parsed GGML file with lazy, zero-copy tensor access."""

    def __init__(self, path: Union[str, os.PathLike]):
        self.path = os.fspath(path)
        self._f = open(self.path, "rb")
        self._mm = mmap.mmap(self._f.fileno(), 0, access=mmap.ACCESS_READ)
        self.hparams, self.vocab, self._records = self._parse()
        self.tensors: Dict[str, TensorRecord] = {r.name: r for r in self._records}

    # -- parsing ---------------------------------------------------------

    def _parse(self):
        mm = self._mm
        off = 0

        def u32() -> int:
            nonlocal off
            (v,) = struct.unpack_from("<I", mm, off)
            off += 4
            return v

        def i32() -> int:
            nonlocal off
            (v,) = struct.unpack_from("<i", mm, off)
            off += 4
            return v

        def f32() -> float:
            nonlocal off
            (v,) = struct.unpack_from("<f", mm, off)
            off += 4
            return v

        magic = u32()
        if magic == GGML_MAGIC_UNVERSIONED:
            raise ValueError("unversioned 'ggml' files are not supported")
        if magic != GGML_MAGIC:
            raise ValueError(f"bad magic 0x{magic:08x} (want 0x{GGML_MAGIC:08x})")
        version = u32()
        if version != GGML_VERSION:
            raise ValueError(f"unsupported ggjt version {version}")

        hp = GGMLHParams(u32(), u32(), u32(), u32(), u32(), u32(), u32())

        tokens: List[bytes] = []
        scores: List[float] = []
        for _ in range(hp.n_vocab):
            ln = u32()
            if ln > 8096:
                raise ValueError(f"vocab entry too large ({ln} bytes)")
            tok = bytes(mm[off : off + ln])
            off += ln
            tokens.append(tok)
            scores.append(f32())
        vocab = Vocab(tokens, scores)

        records: List[TensorRecord] = []
        total = len(mm)
        while off < total:
            record_start = off
            ndims = i32()
            name_len = i32()
            ftype = i32()
            if ndims < 0 or ndims > 4 or name_len < 0 or ftype < 0:
                raise ValueError(f"corrupt tensor record at offset {off}")
            dims = [i32() for _ in range(ndims)]  # fastest-varying first
            name = bytes(mm[off : off + name_len]).decode("utf-8")
            off += name_len
            off = (off + _ALIGN - 1) & -_ALIGN
            try:
                gtype = GGMLType(ftype)
            except ValueError as e:
                raise ValueError(f"tensor {name!r}: unsupported ftype {ftype}") from e
            shape = tuple(reversed(dims)) if dims else (1,)
            n_elem = int(np.prod(shape))
            nbytes = tensor_nbytes(gtype, n_elem)
            records.append(
                TensorRecord(name, gtype, shape, off, nbytes, record_start)
            )
            off += nbytes
        return hp, vocab, records

    # -- access ----------------------------------------------------------

    def __iter__(self) -> Iterator[TensorRecord]:
        return iter(self._records)

    def raw(self, name: str) -> memoryview:
        r = self.tensors[name]
        return memoryview(self._mm)[r.data_offset : r.data_offset + r.data_nbytes]

    def load_tensor(
        self, name: str, dequant: bool = False
    ) -> Union[np.ndarray, QuantizedTensor]:
        """Materialize one tensor.

        F32/F16 come back as zero-copy numpy views (F16 stays f16);
        quantized types come back as QuantizedTensor (or dense f32 when
        dequant=True).
        """
        r = self.tensors[name]
        raw = self.raw(name)
        if r.ggml_type == GGMLType.F32:
            return np.frombuffer(raw, dtype="<f4").reshape(r.shape)
        if r.ggml_type == GGMLType.F16:
            return np.frombuffer(raw, dtype="<f2").reshape(r.shape)
        qt = from_blocks(r.ggml_type, bytes(raw), r.shape)
        if dequant:
            from tokenhawk_tpu_torch.ggml.quants import dequantize

            return dequantize(qt)
        return qt

    def close(self):
        # Zero-copy tensor views may still alias the mapping; in that case
        # leave it to the GC (the mapping is read-only, this is safe).
        try:
            self._mm.close()
        except BufferError:
            pass
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def load_ggml(
    path: Union[str, os.PathLike], dequant: bool = False
) -> Tuple[GGMLHParams, Vocab, Dict[str, Union[np.ndarray, QuantizedTensor]]]:
    """Eagerly load every tensor of a GGML file."""
    f = GGMLFile(path)
    tensors = {name: f.load_tensor(name, dequant=dequant) for name in f.tensors}
    return f.hparams, f.vocab, tensors
