"""Model loading: GGML or GGUF file -> (config, device params, tokenizer).

Counterpart of tokenhawk_tpu/runtime/loader.py on one device.  The file
kind is sniffed from its magic bytes: ggjt v1 (or a TH chunk directory),
or GGUF, whose metadata overrides the config (GQA, rope base, norm eps,
n_ff) and carries the tokenizer (SentencePiece, or byte-level BPE for
Llama-3-family files).  Q4_0 / Q8_0 / Q4_1 / Q5_x blocks are decoded on
the host with numpy and uploaded in the port's layouts (ops/qweight.py);
k-quant projections go straight from their block stream to the native
group-code form (from_kquant_raw), never through the reference's Q8_0
requantization, which exists for its tensor-parallel path only.  The
embedding table is dequantized; a file without output.weight ties it to
the embedding.  k-quant blocks are unpacked on `device`
(ggml/kquant_decode.py, the reference's numpy decode bit for bit): the
host only copies their bytes.  Then the same load-time transforms as the reference run:
the interleaved->half RoPE column permutation and the wqkv / w13 fusion
(within one weight form).  Quant scales and mins are rounded to
`scale_dtype`, bfloat16 by default, as the reference's loader does (the
values rounded, the storage float32: ops/qweight.py).  The reference's `norms_2d` only works around a
TPU tile shape and has no counterpart.

THAWK_Q4K_SB=1, read once per load as the reference's loader reads it,
gives Q4_K projections the super-block kind (q4k_sb, kernel 17) where the
reference's gate does: every one but feed_forward.w2, at in_dim % 1024
== 0 and (in_dim % 4096 == 0 or in_dim <= 16384).  The reference stacks
its layers and re-encodes a family of mixed kinds exactly (to_qk16); the
port keeps each layer's kind (a Q6_K wv stays qk, and that layer's wq /
wk / wv stay unfused), so its function is the reference's.

With `mesh` (parallel/mesh.py make_mesh) `load_model` returns this rank's
shard of the model (parallel/tp.py shard_params_tp, then the per-shard
fusion), as the reference's loader does given a mesh and
parallel="tp".  Where the reference requantizes k-quant projections to
Q8_0 under TP, the port shards the file's own codes (whole groups and
super-blocks; ROADMAP Queue 3 records the difference).
runtime/sharded_loader.py reads only the rank's byte ranges instead.
"""

from __future__ import annotations

import os
from typing import Tuple

import torch

from tokenhawk_tpu_torch.config import LlamaConfig
from tokenhawk_tpu_torch.ggml import kquant_decode
from tokenhawk_tpu_torch.ggml.format import GGMLType
from tokenhawk_tpu_torch.ggml.reader import GGMLFile
from tokenhawk_tpu_torch.models.llama import (
    LlamaParams,
    fuse_params,
    params_from_ggml,
    rope_half_params,
)
from tokenhawk_tpu_torch.ops.qweight import QWeight
from tokenhawk_tpu_torch.tokenizer import Tokenizer

_KQUANTS = (GGMLType.Q2_K, GGMLType.Q3_K, GGMLType.Q4_K, GGMLType.Q5_K, GGMLType.Q6_K)


def model_config(f, n_ctx: int = 2048, **config_overrides) -> LlamaConfig:
    """The config of an open model file: its header, with n_ff and the
    number of KV heads read off the w1 and wk tensors (not in the ggjt
    header), as the reference does, and a GGUF file's metadata."""
    for k, v in getattr(f, "config_overrides", {}).items():
        config_overrides.setdefault(k, v)
    w1 = f.tensors.get("layers.0.feed_forward.w1.weight")
    if w1 is not None:
        config_overrides.setdefault("n_ff", w1.shape[0])
    wk = f.tensors.get("layers.0.attention.wk.weight")
    if wk is not None and f.hparams.n_embd and f.hparams.n_head:
        head_dim = f.hparams.n_embd // f.hparams.n_head
        config_overrides.setdefault("n_kv_head", wk.shape[0] // head_dim)
    return config_from_hparams(f.hparams, n_ctx=n_ctx, **config_overrides)


def config_from_hparams(hp, n_ctx: int = 2048, **overrides) -> LlamaConfig:
    kw = dict(n_vocab=hp.n_vocab, n_embd=hp.n_embd, n_head=hp.n_head,
              n_layer=hp.n_layer, n_mult=hp.n_mult, n_ctx=n_ctx)
    kw.update(overrides)
    return LlamaConfig(**kw)


def open_model_file(path: str):
    """A reader for `path`: ChunkedReader, GGUFFile or GGMLFile."""
    if os.path.isdir(path):
        from tokenhawk_tpu_torch.ggml.chunked import ChunkedReader

        return ChunkedReader(path)
    from tokenhawk_tpu_torch.ggml.gguf import GGUFFile, is_gguf

    return GGUFFile(path) if is_gguf(path) else GGMLFile(path)


def q4k_sb_enabled() -> bool:
    """The reference's THAWK_Q4K_SB=1: Q4_K weights in the super-block
    form where its gate admits them (read at each call)."""
    return os.environ.get("THAWK_Q4K_SB", "0") == "1"


def load_model(path: str, n_ctx: int = 2048, dtype=torch.bfloat16, device="cuda",
               scale_dtype=torch.bfloat16, mesh=None,
               **config_overrides) -> Tuple[LlamaConfig, LlamaParams, object]:
    """Load a ggjt or GGUF file (or TH chunk directory) onto `device`.
    Returns (config, params, tokenizer): a Tokenizer, or a BpeTokenizer
    for a GGUF file with a byte-level BPE vocab, with the file's
    `chat_template` (or None).  With `mesh` (a TpMesh) params are this
    rank's shard."""
    f = open_model_file(path)
    try:
        cfg = model_config(f, n_ctx, **config_overrides)
        if mesh is not None:
            from tokenhawk_tpu_torch.parallel.tp import validate_tp

            validate_tp(cfg, mesh.tp)
        tokenizer = (f.build_tokenizer() if hasattr(f, "build_tokenizer")
                     else Tokenizer.from_vocab(f.vocab))
        # A GGUF file's own chat template (the server renders it); None
        # for ggjt files.
        tokenizer.chat_template = getattr(f, "metadata", {}).get("tokenizer.chat_template")
        tensors = {}
        sb = q4k_sb_enabled()
        for name, rec in f.tensors.items():
            if (rec.ggml_type in _KQUANTS and len(rec.shape) == 2 and "norm" not in name
                    and name != "tok_embeddings.weight"):
                tensors[name] = QWeight.from_kquant_raw(
                    rec.ggml_type, f.raw(name), rec.shape, device, scale_dtype, sb=sb,
                    sb_ok=not name.endswith("feed_forward.w2.weight"))
            elif rec.ggml_type in _KQUANTS:  # the embedding table
                tensors[name] = kquant_decode.dequant(rec.ggml_type, f.raw(name), rec.shape,
                                                      device)
            else:
                tensors[name] = f.load_tensor(name)
        params = params_from_ggml(cfg, tensors, dtype=dtype, device=device,
                                  scale_dtype=scale_dtype)
    finally:
        f.close()
    cfg, params = rope_half_params(cfg, params)
    if mesh is not None:
        from tokenhawk_tpu_torch.parallel.tp import shard_params_tp

        params = shard_params_tp(cfg, params, mesh)
    return cfg, fuse_params(params), tokenizer
