"""Rank-local sharded weight loading for tensor parallelism.

Counterpart of tokenhawk_tpu/runtime/sharded_loader.py.  runtime/loader.py
`load_model(..., mesh)` builds the whole model on each rank and keeps its
shard; here each rank reads from the mmap'd ggjt file only the byte ranges
of its own shard (the reference does it in `make_array_from_callback`
callbacks), so a rank materializes 1/tp of every column- and row-parallel
weight plus the small replicated norms.

The port's weights are output-major, GGML's own [out, in] order
(ops/qweight.py), so:

  * a column-parallel shard (wq, wk, wv, w1, w3, the vocab columns of the
    output) is a contiguous run of the tensor's disk rows;
  * a row-parallel shard (wo, w2) is, in each disk row, a run of whole
    32-weight blocks;
  * the vocab-parallel embedding shard is a run of the table's rows.

It reads the kinds the reference's reads, F32, F16, Q8_0 and Q4_0, and
refuses any other with ValueError.  The shard's blocks decode on the host
and upload as runtime/loader.py's do, then the same load-time transforms
run on the shard (the RoPE column permutation within each local head,
then the wq|wk|wv and w1|w3 fusion), so the result is bit for bit
`load_model(..., mesh)`'s.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from tokenhawk_tpu_torch.config import LlamaConfig
from tokenhawk_tpu_torch.ggml.format import QK, TYPE_BLOCK_BYTES, GGMLType
from tokenhawk_tpu_torch.ggml.quants import from_blocks
from tokenhawk_tpu_torch.ggml.reader import GGMLFile
from tokenhawk_tpu_torch.models.llama import (
    LlamaParams,
    fuse_params,
    params_from_ggml,
    rope_half_params,
)
from tokenhawk_tpu_torch.parallel.mesh import TpMesh
from tokenhawk_tpu_torch.parallel.tp import local_config
from tokenhawk_tpu_torch.runtime.loader import model_config
from tokenhawk_tpu_torch.tokenizer import Tokenizer

READABLE = (GGMLType.F32, GGMLType.F16, GGMLType.Q8_0, GGMLType.Q4_0)
COL_PARALLEL = ("attention.wq", "attention.wk", "attention.wv", "feed_forward.w1",
                "feed_forward.w3")
ROW_PARALLEL = ("attention.wo", "feed_forward.w2")


class ShardReader:
    """Sub-matrix reads from a ggjt mmap; counts the bytes it decodes."""

    def __init__(self, f: GGMLFile):
        self.f = f
        self.bytes_read = 0

    def read(self, name: str, rows: slice = slice(None), cols: slice = slice(None)):
        """Disk rows x columns of tensor `name` ([out, in] order): float32
        numpy for F32 / F16, a QuantizedTensor of the sub-matrix for Q8_0 /
        Q4_0 (columns at whole blocks)."""
        rec = self.f.tensors[name]
        if rec.ggml_type not in READABLE:
            raise ValueError(f"load_model_sharded reads F32, F16, Q8_0 and Q4_0; "
                             f"{name} is {rec.ggml_type.name}")
        shape = rec.shape if len(rec.shape) == 2 else (1, *rec.shape)
        n_rows, n_cols = shape
        raw = self.f.raw(name)
        if rec.ggml_type in (GGMLType.F32, GGMLType.F16):
            dt = np.float32 if rec.ggml_type == GGMLType.F32 else np.float16
            view = np.frombuffer(raw, dt).reshape(shape)[rows, cols]
            self.bytes_read += view.nbytes
            out = np.asarray(view, np.float32)
            return out if len(rec.shape) == 2 else out[0]
        c0, c1, _ = cols.indices(n_cols)
        if c0 % QK or c1 % QK:
            raise ValueError(f"{name}: columns [{c0}, {c1}) cut a {QK}-weight block")
        bb = TYPE_BLOCK_BYTES[rec.ggml_type]
        blocks = np.frombuffer(raw, np.uint8).reshape(n_rows, n_cols // QK, bb)
        chunk = np.ascontiguousarray(blocks[rows, c0 // QK:c1 // QK])
        self.bytes_read += chunk.nbytes
        return from_blocks(rec.ggml_type, chunk.tobytes(), (chunk.shape[0], c1 - c0))


def _share(total: int, mesh: TpMesh) -> slice:
    per = total // mesh.tp
    return slice(mesh.index * per, (mesh.index + 1) * per)


def load_model_sharded(path: str, mesh: TpMesh, n_ctx: int = 2048, dtype=torch.bfloat16,
                       device="cuda", scale_dtype=torch.bfloat16, **config_overrides
                       ) -> Tuple[LlamaConfig, LlamaParams, Tokenizer, ShardReader]:
    """ggjt file -> (config, this rank's params, tokenizer, its ShardReader),
    each weight read at this rank's byte ranges only (the reader counts
    them)."""
    f = GGMLFile(path)
    try:
        cfg = model_config(f, n_ctx, **config_overrides)
        lcfg = local_config(cfg, mesh.tp)
        tokenizer = Tokenizer.from_vocab(f.vocab)
        tokenizer.chat_template = None  # a ggjt file has none
        rd = ShardReader(f)
        tensors = {"tok_embeddings.weight": rd.read("tok_embeddings.weight",
                                                    _share(cfg.n_vocab, mesh)),
                   "norm.weight": rd.read("norm.weight"),
                   "output.weight": rd.read("output.weight", _share(cfg.n_vocab, mesh))}
        for i in range(cfg.n_layer):
            p = f"layers.{i}."
            for n in ("attention_norm", "ffn_norm"):
                tensors[p + n + ".weight"] = rd.read(p + n + ".weight")
            for n in COL_PARALLEL:
                rows = f.tensors[p + n + ".weight"].shape[0]
                tensors[p + n + ".weight"] = rd.read(p + n + ".weight", _share(rows, mesh))
            for n in ROW_PARALLEL:
                cols = f.tensors[p + n + ".weight"].shape[1]
                tensors[p + n + ".weight"] = rd.read(p + n + ".weight", slice(None),
                                                     _share(cols, mesh))
        params = params_from_ggml(lcfg, tensors, dtype=dtype, device=device,
                                  scale_dtype=scale_dtype)
    finally:
        f.close()
    # The RoPE permutation is within each head, so it runs on the local heads.
    _, params = rope_half_params(lcfg, params)
    cfg = dataclasses.replace(cfg, rope_style="half") if cfg.rope_style == "interleaved" else cfg
    return cfg, fuse_params(params), tokenizer, rd
