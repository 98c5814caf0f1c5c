"""Perplexity / log-likelihood evaluation.

Counterpart of tokenhawk_tpu/runtime/eval.py: llama.cpp-style chunked
perplexity, each window scored from an empty bfloat16 cache through the
port's forward (its kernels on the card: kernel 4 for the window's
attention, the quantized matmul kernels at the window's rows) and the
output projection.  It puts one number on a weight form: the same file
loaded in two forms (THAWK_Q4K_SB=1 and not, say) scores the same token
stream.  The scoring runs where the parameters live: on the card, or on
the CPU for CPU tensors.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch

from tokenhawk_tpu_torch.config import LlamaConfig
from tokenhawk_tpu_torch.models.llama import KVCache, LlamaParams, forward, logits_from_hidden


def make_score_fn(cfg: LlamaConfig, seq_len: int):
    """fn: (params, tokens [B, T]) -> next-token logprobs [B, T-1] (f32),
    logprobs[b, t] = log P(tokens[b, t+1] | tokens[b, <=t]); T <= seq_len."""

    @torch.inference_mode()
    def score(params: LlamaParams, tokens: torch.Tensor) -> torch.Tensor:
        B, T = tokens.shape
        tokens = tokens.to(params.device)
        cache = KVCache.create(cfg, B, seq_len, torch.bfloat16, params.device)
        offsets = torch.zeros((B,), dtype=torch.int32, device=params.device)
        h, _ = forward(cfg, params, tokens, cache, offsets)
        logp = torch.log_softmax(logits_from_hidden(cfg, params, h), dim=-1)  # [B, T, V]
        return torch.gather(logp[:, :-1], -1, tokens[:, 1:, None].long())[..., 0]

    return score


def perplexity(cfg: LlamaConfig, params: LlamaParams, tokens: Sequence[int],
               window: int = 512) -> float:
    """Sliding non-overlapping window perplexity over a token stream
    (llama.cpp-style chunked evaluation: each window is scored from an
    empty context, the first token of each window unscored)."""
    toks = np.asarray(tokens, np.int64)
    n_win = len(toks) // window
    if n_win == 0:
        raise ValueError(f"need at least {window} tokens, got {len(toks)}")
    score = make_score_fn(cfg, window)
    total, count = 0.0, 0
    for i in range(n_win):
        chunk = torch.from_numpy(toks[i * window:(i + 1) * window][None, :])
        lp = score(params, chunk)
        total += float(lp.double().sum())
        count += lp.shape[1]
    return math.exp(-total / count)


def mean_nll(cfg: LlamaConfig, params: LlamaParams, tokens: Sequence[int],
             window: int = 512) -> float:
    return math.log(perplexity(cfg, params, tokens, window))
