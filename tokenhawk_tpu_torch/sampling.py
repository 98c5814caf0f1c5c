"""Sampling on the device: repeat penalty -> temperature -> top-k -> top-p.

Counterpart of tokenhawk_tpu/sampling.py (`sample` and its masks):
temp <= 0 is greedy argmax; the CTRL repetition penalty multiplies
negative logits by the penalty and divides positive ones; top-k keeps the
k best; top-p keeps the smallest prefix of the sorted distribution whose
mass reaches top_p, the crossing token included.  Draws come from an
explicit torch.Generator on the logits' device, so the ids never leave
the device inside a decode chunk.
"""

from __future__ import annotations

from typing import Optional

import torch

from tokenhawk_tpu_torch.config import SamplingConfig

_NEG_INF = -1e30


def normalize_eos(eos_id):
    """An eos spec (int, or an iterable for multi-EOS vocabs) -> (sentinel,
    sorted tuple).  The sentinel is what finished slots emit."""
    if isinstance(eos_id, (tuple, list, set, frozenset)):
        ids = tuple(sorted(int(e) for e in eos_id))
        if not ids:
            raise ValueError("empty eos id set")
        return ids[0], ids
    return int(eos_id), (int(eos_id),)


def is_eos(tok: torch.Tensor, eos_ids) -> torch.Tensor:
    """Elementwise membership in a tuple of end-of-generation ids."""
    m = tok == eos_ids[0]
    for e in eos_ids[1:]:
        m = m | (tok == e)
    return m


def apply_repeat_penalty(logits: torch.Tensor, last_tokens: torch.Tensor,
                         penalty: float) -> torch.Tensor:
    """logits [B, V] f32; last_tokens [B, N], entries < 0 are empty slots."""
    if penalty == 1.0:
        return logits
    B, V = logits.shape
    # Empty slots land in a spare column V that is dropped afterwards.
    idx = torch.where(last_tokens >= 0, last_tokens, V).long()
    seen = torch.zeros((B, V + 1), dtype=torch.bool, device=logits.device)
    seen.scatter_(1, idx, True)
    seen = seen[:, :V]
    penalized = torch.where(logits < 0, logits * penalty, logits / penalty)
    return torch.where(seen, penalized, logits)


def top_k_mask(logits: torch.Tensor, k: int) -> torch.Tensor:
    """Set everything below the k-th best logit to -inf."""
    V = logits.shape[-1]
    if k <= 0 or k >= V:
        return logits
    kth = torch.topk(logits, k, dim=-1).values[..., -1:]
    return torch.where(logits < kth, _NEG_INF, logits)


def top_p_mask(logits: torch.Tensor, p: float) -> torch.Tensor:
    """Nucleus filter: keep the smallest prefix with mass >= p (inclusive)."""
    if p >= 1.0:
        return logits
    sorted_logits = torch.sort(logits, dim=-1, descending=True).values
    probs = torch.softmax(sorted_logits, dim=-1)
    cum_excl = torch.cumsum(probs, dim=-1) - probs
    keep = cum_excl < p
    thresh = torch.where(keep, sorted_logits, torch.inf).amin(dim=-1, keepdim=True)
    return torch.where(logits < thresh, _NEG_INF, logits)


def processed_logits(logits: torch.Tensor, cfg: SamplingConfig,
                     last_tokens: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The logits a non-greedy draw samples from (penalty, temperature,
    top-k, top-p applied)."""
    logits = logits.float()
    if last_tokens is not None and cfg.repeat_penalty != 1.0:
        logits = apply_repeat_penalty(logits, last_tokens, cfg.repeat_penalty)
    logits = logits / cfg.temperature
    logits = top_k_mask(logits, cfg.top_k)
    return top_p_mask(logits, cfg.top_p)


def sample(logits: torch.Tensor, generator: Optional[torch.Generator], cfg: SamplingConfig,
           last_tokens: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Next-token ids: logits [B, V] -> [B] int64, on the logits' device."""
    if cfg.greedy:
        return torch.argmax(logits.float(), dim=-1)
    probs = torch.softmax(processed_logits(logits, cfg, last_tokens), dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]
