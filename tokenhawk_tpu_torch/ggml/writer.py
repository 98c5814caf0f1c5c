# Copy of tokenhawk_tpu/ggml/writer.py (imports rewritten, upstream citations as bare
# file:line): importing tokenhawk_tpu imports jax, which the GPU machine lacks.
# tests/test_torch_host.py holds the copy equal to its original.
"""GGML (ggjt v1) file writer.

Used to (a) build tiny test fixtures, (b) convert/re-quantize models
(f16 -> Q8_0/Q4_0/Q4_1), a capability the reference lacks entirely.
The record layout matches `tokenhawk_tpu_torch.ggml.format`.
"""

from __future__ import annotations

import os
import struct
from typing import Dict, List, Optional, Sequence, Union

import numpy as np

from tokenhawk_tpu_torch.ggml.format import GGML_MAGIC, GGML_VERSION, GGMLType
from tokenhawk_tpu_torch.ggml.quants import QuantizedTensor, to_blocks

_ALIGN = 32

TensorLike = Union[np.ndarray, QuantizedTensor]


def _tensor_type(t: TensorLike) -> GGMLType:
    if isinstance(t, QuantizedTensor):
        return t.kind
    if t.dtype == np.float32:
        return GGMLType.F32
    if t.dtype == np.float16:
        return GGMLType.F16
    raise ValueError(f"unsupported dtype {t.dtype}")


def _tensor_bytes(t: TensorLike) -> bytes:
    if isinstance(t, QuantizedTensor):
        return to_blocks(t)
    return np.ascontiguousarray(t).tobytes()


def write_ggml(
    path: Union[str, os.PathLike],
    hparams: Dict[str, int],
    vocab_tokens: Sequence[bytes],
    vocab_scores: Optional[Sequence[float]],
    tensors: Dict[str, TensorLike],
) -> None:
    """Write a ggjt-v1 file.

    hparams keys: n_vocab n_embd n_mult n_head n_layer n_rot ftype.
    Tensor dims are emitted fastest-varying first (reversed numpy shape).
    """
    if vocab_scores is None:
        vocab_scores = [0.0] * len(vocab_tokens)
    with open(path, "wb") as f:
        f.write(struct.pack("<II", GGML_MAGIC, GGML_VERSION))
        f.write(
            struct.pack(
                "<7I",
                hparams["n_vocab"],
                hparams["n_embd"],
                hparams.get("n_mult", 256),
                hparams["n_head"],
                hparams["n_layer"],
                hparams.get("n_rot", hparams["n_embd"] // hparams["n_head"]),
                hparams.get("ftype", 1),
            )
        )
        for tok, score in zip(vocab_tokens, vocab_scores):
            if isinstance(tok, str):
                tok = tok.encode("utf-8")
            f.write(struct.pack("<I", len(tok)))
            f.write(tok)
            f.write(struct.pack("<f", float(score)))

        for name, t in tensors.items():
            gtype = _tensor_type(t)
            shape = t.shape
            dims = list(reversed(shape))
            name_b = name.encode("utf-8")
            f.write(struct.pack("<iii", len(dims), len(name_b), int(gtype)))
            for d in dims:
                f.write(struct.pack("<i", int(d)))
            f.write(name_b)
            pos = f.tell()
            pad = ((pos + _ALIGN - 1) & -_ALIGN) - pos
            f.write(b"\x00" * pad)
            f.write(_tensor_bytes(t))
