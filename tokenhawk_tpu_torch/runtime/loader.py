"""Model loading: GGML file -> (config, device params, tokenizer).

Counterpart of tokenhawk_tpu/runtime/loader.py for ggjt files (and TH
chunk directories) on one device.  Q4_0 blocks are decoded on the host
with numpy and uploaded in the port's Q4_0 layout (ops/qweight.py); then
the same load-time transforms as the reference run: the interleaved->half
RoPE column permutation and the wqkv / w13 fusion.  The reference's
`norms_2d` only works around a TPU tile shape and has no counterpart.
"""

from __future__ import annotations

import os
from typing import Tuple

import torch

from tokenhawk_tpu_torch.config import LlamaConfig
from tokenhawk_tpu_torch.ggml.reader import GGMLFile
from tokenhawk_tpu_torch.models.llama import (
    LlamaParams,
    fuse_params,
    params_from_ggml,
    rope_half_params,
)
from tokenhawk_tpu_torch.tokenizer import Tokenizer


def config_from_hparams(hp, n_ctx: int = 2048, **overrides) -> LlamaConfig:
    kw = dict(n_vocab=hp.n_vocab, n_embd=hp.n_embd, n_head=hp.n_head,
              n_layer=hp.n_layer, n_mult=hp.n_mult, n_ctx=n_ctx)
    kw.update(overrides)
    return LlamaConfig(**kw)


def load_model(path: str, n_ctx: int = 2048, dtype=torch.bfloat16, device="cuda",
               **config_overrides) -> Tuple[LlamaConfig, LlamaParams, Tokenizer]:
    """Load a ggjt file (or TH chunk directory) onto `device`."""
    if os.path.isdir(path):
        from tokenhawk_tpu_torch.ggml.chunked import ChunkedReader

        f = ChunkedReader(path)
    else:
        f = GGMLFile(path)
    try:
        # n_ff and the number of kv heads are not in the ggjt header: read
        # them off the w1 and wk tensors, as the reference does.
        w1 = f.tensors.get("layers.0.feed_forward.w1.weight")
        if w1 is not None:
            config_overrides.setdefault("n_ff", w1.shape[0])
        wk = f.tensors.get("layers.0.attention.wk.weight")
        if wk is not None and f.hparams.n_embd and f.hparams.n_head:
            head_dim = f.hparams.n_embd // f.hparams.n_head
            config_overrides.setdefault("n_kv_head", wk.shape[0] // head_dim)
        cfg = config_from_hparams(f.hparams, n_ctx=n_ctx, **config_overrides)
        tokenizer = Tokenizer.from_vocab(f.vocab)
        tensors = {name: f.load_tensor(name) for name in f.tensors}
        params = params_from_ggml(cfg, tensors, dtype=dtype, device=device)
    finally:
        f.close()
    cfg, params = rope_half_params(cfg, params)
    return cfg, fuse_params(params), tokenizer
