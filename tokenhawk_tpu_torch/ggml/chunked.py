# Copy of tokenhawk_tpu/ggml/chunked.py (imports rewritten, upstream citations as bare
# file:line): importing tokenhawk_tpu imports jax, which the GPU machine lacks.
# tests/test_torch_host.py holds the copy equal to its original.
"""TH chunk container: a GGML model split into streamable chunk files.

Format parity with the reference's chunk loader
(th-llama-loader.cpp:275-328):

    uint16 magic   = 0x1737
    uint16 version = 1
    uint32 file_type            (0 header, 1 weights, 2 footer)
    uint32 num_elements         (tensor records in a weights chunk)
    uint32 vocab_size           (header chunk)
    int64  original_file_offset (byte offset of the payload in the
                                 original GGML file — preserves the
                                 32-byte data alignment computation)
    int64  padding
    bytes  payload

The footer payload is a uint32 expected-file-count
(th-llama-loader.cpp:267-273).

`split_ggml` produces a chunk directory from a .bin model; `ChunkedReader`
re-assembles the tensor index without concatenating (chunks stay mmap'd),
so a model can stream chunk-by-chunk — the capability the reference's
browser frontend uses (web/chat.js slices the file in JS).
"""

from __future__ import annotations

import dataclasses
import os
import struct
from pathlib import Path
from typing import Dict, List, Tuple, Union

import numpy as np

from tokenhawk_tpu_torch.ggml.format import (
    TH_CHUNK_MAGIC,
    TH_CHUNK_VERSION,
    GGMLType,
    THChunkType,
    tensor_nbytes,
)
from tokenhawk_tpu_torch.ggml.reader import GGMLFile, GGMLHParams, TensorRecord, Vocab

_HDR = struct.Struct("<HHIIIqq")  # magic, version, ftype, n_elem, vocab, off, pad


def _write_chunk(path, file_type: int, n_elem: int, vocab_size: int,
                 orig_offset: int, payload: bytes):
    with open(path, "wb") as f:
        f.write(_HDR.pack(TH_CHUNK_MAGIC, TH_CHUNK_VERSION, file_type,
                          n_elem, vocab_size, orig_offset, 0))
        f.write(payload)


def split_ggml(
    model_path: Union[str, os.PathLike],
    out_dir: Union[str, os.PathLike],
    max_chunk_bytes: int = 128 * 1024 * 1024,
) -> List[Path]:
    """Split a ggjt file into header/weights/footer chunks <= max_chunk_bytes."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    src = GGMLFile(model_path)
    paths: List[Path] = []

    with open(model_path, "rb") as f:
        blob = f.read()

    # Header chunk: everything up to the first tensor record.
    records = list(src)
    first_rec_off = records[0].record_offset if records else len(blob)
    hp = src.hparams
    header_payload = blob[:first_rec_off]
    p = out_dir / "chunk_000_header.th"
    _write_chunk(p, THChunkType.HEADER, 0, hp.n_vocab, 0, header_payload)
    paths.append(p)

    # Weights chunks: whole tensor records, grouped under the size cap.
    idx = 1
    group: List[TensorRecord] = []
    group_start = None
    group_end = None

    def flush():
        nonlocal idx, group, group_start, group_end
        if not group:
            return
        payload = blob[group_start:group_end]
        p = out_dir / f"chunk_{idx:03d}_weights.th"
        _write_chunk(p, THChunkType.WEIGHTS, len(group), 0, group_start, payload)
        paths.append(p)
        idx += 1
        group, group_start, group_end = [], None, None

    for rec in records:
        rec_start = rec.record_offset
        rec_end = rec.data_offset + rec.data_nbytes
        if group and (rec_end - group_start) > max_chunk_bytes:
            flush()
        if not group:
            group_start = rec_start
        group.append(rec)
        group_end = rec_end
    flush()

    footer = out_dir / f"chunk_{idx:03d}_footer.th"
    _write_chunk(footer, THChunkType.FOOTER, 0, 0, 0,
                 struct.pack("<I", len(paths) + 1))
    paths.append(footer)
    src.close()
    return paths


@dataclasses.dataclass
class _Chunk:
    path: Path
    file_type: int
    n_elem: int
    vocab_size: int
    orig_offset: int
    payload_offset: int


class ChunkedReader:
    """Load a chunk directory produced by split_ggml (or the reference's
    chunking flow): presents the same API surface as GGMLFile."""

    def __init__(self, chunk_dir: Union[str, os.PathLike]):
        self.dir = Path(chunk_dir)
        files = sorted(self.dir.glob("*.th"))
        if not files:
            raise FileNotFoundError(f"no .th chunks in {chunk_dir}")
        self._chunks: List[_Chunk] = []
        expected = None
        header_payload = None
        weights: List[Tuple[_Chunk, bytes]] = []
        for path in files:
            data = path.read_bytes()
            magic, version, ftype, n_elem, vocab, off, _pad = _HDR.unpack_from(data)
            if magic != TH_CHUNK_MAGIC:
                raise ValueError(f"{path}: bad chunk magic 0x{magic:04x}")
            if version != TH_CHUNK_VERSION:
                raise ValueError(f"{path}: bad chunk version {version}")
            ch = _Chunk(path, ftype, n_elem, vocab, off, _HDR.size)
            self._chunks.append(ch)
            payload = data[_HDR.size:]
            if ftype == THChunkType.HEADER:
                header_payload = payload
            elif ftype == THChunkType.WEIGHTS:
                weights.append((ch, payload))
            elif ftype == THChunkType.FOOTER:
                (expected,) = struct.unpack_from("<I", payload)
        if header_payload is None:
            raise ValueError("missing header chunk")
        if expected is not None and expected != len(self._chunks):
            raise ValueError(
                f"chunk count mismatch: footer says {expected}, found "
                f"{len(self._chunks)}"
            )

        self.hparams, self.vocab = self._parse_header(header_payload)
        self.tensors: Dict[str, TensorRecord] = {}
        self._data: Dict[str, bytes] = {}
        for ch, payload in weights:
            self._parse_weights(ch, payload)

    @staticmethod
    def _parse_header(payload: bytes):
        import io

        from tokenhawk_tpu_torch.ggml.format import GGML_MAGIC, GGML_VERSION

        off = 0
        magic, version = struct.unpack_from("<II", payload, off)
        off += 8
        if magic != GGML_MAGIC or version != GGML_VERSION:
            raise ValueError("bad ggjt header in chunk")
        vals = struct.unpack_from("<7I", payload, off)
        off += 28
        hp = GGMLHParams(*vals)
        tokens, scores = [], []
        for _ in range(hp.n_vocab):
            (ln,) = struct.unpack_from("<I", payload, off)
            off += 4
            tokens.append(payload[off : off + ln])
            off += ln
            (sc,) = struct.unpack_from("<f", payload, off)
            off += 4
            scores.append(sc)
        return hp, Vocab(tokens, scores)

    def _parse_weights(self, ch: _Chunk, payload: bytes):
        off = 0
        for _ in range(ch.n_elem):
            ndims, name_len, ftype = struct.unpack_from("<iii", payload, off)
            off += 12
            dims = list(struct.unpack_from(f"<{ndims}i", payload, off))
            off += 4 * ndims
            name = payload[off : off + name_len].decode("utf-8")
            off += name_len
            # alignment is relative to the ORIGINAL file offset
            file_off = ch.orig_offset + off
            aligned = (file_off + 31) & -32
            off += aligned - file_off
            gtype = GGMLType(ftype)
            shape = tuple(reversed(dims)) if dims else (1,)
            nbytes = tensor_nbytes(gtype, int(np.prod(shape)))
            self.tensors[name] = TensorRecord(name, gtype, shape, aligned, nbytes)
            self._data[name] = payload[off : off + nbytes]
            off += nbytes

    def raw(self, name: str) -> bytes:
        return self._data[name]

    def close(self):  # API parity with GGMLFile
        self._data.clear()

    def load_tensor(self, name: str, dequant: bool = False):
        r = self.tensors[name]
        raw = self._data[name]
        if r.ggml_type == GGMLType.F32:
            return np.frombuffer(raw, dtype="<f4").reshape(r.shape)
        if r.ggml_type == GGMLType.F16:
            return np.frombuffer(raw, dtype="<f2").reshape(r.shape)
        from tokenhawk_tpu_torch.ggml.quants import dequantize, from_blocks

        qt = from_blocks(r.ggml_type, raw, r.shape)
        return dequantize(qt) if dequant else qt
