"""Sampling on the device: repeat penalty -> temperature -> top-k -> top-p.

Counterpart of tokenhawk_tpu/sampling.py (`sample` and its masks):
temp <= 0 is greedy argmax; the CTRL repetition penalty multiplies
negative logits by the penalty and divides positive ones; top-k keeps the
k best; top-p keeps the smallest prefix of the sorted distribution whose
mass reaches top_p, the crossing token included.  Draws come from an
explicit torch.Generator on the logits' device, so the ids never leave
the device inside a decode chunk.

The per-slot half (SamplingParams, sample_dynamic, processed_probs_dynamic,
categorical_probs) is the counterpart of the reference's traced sampling
for continuous batching and speculative sampling.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from tokenhawk_tpu_torch.config import SamplingConfig
from tokenhawk_tpu_torch.tokenizer import EOS_ID

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


def tokenizer_eos(tokenizer):
    """The eos spec of a tokenizer: its end-of-generation ids (a Llama-3
    BPE vocab stops on 128001 and the chat terminator 128009), else its
    eos_id, else the SentencePiece default 2."""
    eog = sorted(int(e) for e in getattr(tokenizer, "eog_ids", None) or () if e >= 0)
    if eog:
        return tuple(eog)
    eos_id = getattr(tokenizer, "eos_id", None)
    return EOS_ID if eos_id is None or eos_id < 0 else eos_id


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


# ---------------------------------------------------------------------------
# Per-slot sampling (continuous batching): every slot has its own settings
# and its own random stream, as device tensors, so requests with different
# settings share one decode step and a request's tokens do not depend on
# its batch neighbours.
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class SamplingParams:
    """Per-slot sampling parameters as [B] tensors.

    temperature <= 0 means greedy; top_k <= 0 disables top-k; top_p >= 1
    disables nucleus filtering; repeat_penalty == 1 disables the penalty.
    `seed` and a per-slot step counter drive the slot's random draws."""

    temperature: torch.Tensor  # [B] f32
    top_k: torch.Tensor  # [B] int64
    top_p: torch.Tensor  # [B] f32
    repeat_penalty: torch.Tensor  # [B] f32
    seed: torch.Tensor  # [B] int64

    @staticmethod
    def slot_values(cfg: SamplingConfig):
        """Host-side scalar tuple for one slot."""
        t = 0.0 if cfg.greedy else cfg.temperature
        return (t, cfg.top_k, cfg.top_p, cfg.repeat_penalty, cfg.seed)

    @staticmethod
    def _from_values(vals, device) -> "SamplingParams":
        t, k, p, r, s = zip(*vals)
        return SamplingParams(
            temperature=torch.tensor(t, dtype=torch.float32, device=device),
            top_k=torch.tensor(k, dtype=torch.int64, device=device),
            top_p=torch.tensor(p, dtype=torch.float32, device=device),
            repeat_penalty=torch.tensor(r, dtype=torch.float32, device=device),
            seed=torch.tensor(s, dtype=torch.int64, device=device))

    @staticmethod
    def broadcast(cfg: SamplingConfig, batch: int, device=None) -> "SamplingParams":
        return SamplingParams._from_values([SamplingParams.slot_values(cfg)] * batch, device)

    @staticmethod
    def from_configs(cfgs, pad_to: int, device=None) -> "SamplingParams":
        """Padded per-row params for a batched admission group: rows past
        len(cfgs) repeat the last config (their state is dropped)."""
        vals = [SamplingParams.slot_values(c) for c in cfgs]
        vals += [vals[-1]] * (pad_to - len(vals))
        return SamplingParams._from_values(vals, device)

    def fields(self):
        return [getattr(self, f.name) for f in dataclasses.fields(self)]

    def set_slot(self, slot: int, values) -> "SamplingParams":
        """Write one slot's values in place; returns self."""
        for a, v in zip(self.fields(), values):
            a[slot] = v
        return self

    def set_rows(self, slots: torch.Tensor, other: "SamplingParams") -> "SamplingParams":
        """self[slots[i]] = other[i] for every row, in place; returns self."""
        for a, v in zip(self.fields(), other.fields()):
            a[slots] = v
        return self


_M32 = 0xFFFFFFFF


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for int64 x in [0, 2^32), without int64 overflow."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _fmix32(h: torch.Tensor) -> torch.Tensor:
    """MurmurHash3's 32-bit finaliser (a bijection that mixes every bit)."""
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def uniform_rows(seeds: torch.Tensor, counters: torch.Tensor, n: int) -> torch.Tensor:
    """Counter-based U(0, 1) rows: [B] seeds / counters -> [B, n] f32.

    Element (b, i) is a hash of (seeds[b], counters[b], i) alone, so a
    slot's numbers depend on nothing else in the batch.  24 bits per draw,
    strictly inside (0, 1).  (The reference folds (seed, counter) into a
    jax.random key; torch cannot reproduce that stream.)"""
    dev = seeds.device
    key = _fmix32(_fmix32(seeds.long() & _M32) ^ (counters.long() & _M32))  # [B]
    idx = torch.arange(n, dtype=torch.int64, device=dev)
    bits = _fmix32(_fmix32(key[:, None] ^ _fmix32(idx)[None, :]) + idx[None, :] & _M32)
    return ((bits >> 8).float() + 0.5) * (1.0 / (1 << 24))


def _penalize(logits, sp: SamplingParams, last_tokens):
    if last_tokens is None:
        return logits
    B, V = logits.shape
    idx = torch.where(last_tokens >= 0, last_tokens, V).long()
    seen = torch.zeros((B, V + 1), dtype=torch.bool, device=logits.device)
    seen.scatter_(1, idx, True)
    pen = sp.repeat_penalty[:, None]
    penalized = torch.where(logits < 0, logits * pen, logits / pen)
    return torch.where(seen[:, :V], penalized, logits)


def _filtered(logits, sp: SamplingParams, last_tokens):
    """Penalised, tempered logits with everything outside each slot's
    top-k and top-p set to -1e30: one sort serves both masks."""
    V = logits.shape[-1]
    z = _penalize(logits, sp, last_tokens) / torch.clamp(sp.temperature, min=1e-6)[:, None]
    sorted_z = torch.sort(z, dim=-1, descending=True).values
    rank = torch.arange(V, device=z.device)[None, :]
    k = torch.where(sp.top_k <= 0, V, sp.top_k)[:, None]
    z_k = torch.where(rank < k, sorted_z, _NEG_INF)
    probs = torch.softmax(z_k, dim=-1)
    cum_excl = torch.cumsum(probs, dim=-1) - probs
    kept = (rank < k) & (cum_excl < sp.top_p[:, None])
    thresh = torch.where(kept, sorted_z, torch.inf).amin(dim=-1, keepdim=True)
    return torch.where(z < thresh, _NEG_INF, z)


def processed_probs_dynamic(logits: torch.Tensor, sp: SamplingParams,
                            last_tokens: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The per-slot distribution sample_dynamic draws from: [B, V] f32.

    Penalty, temperature, top-k and top-p applied; greedy slots
    (temperature <= 0) get a one-hot at the raw argmax (greedy is taken
    before the penalty, as the reference does)."""
    logits = logits.float()
    one_hot = torch.nn.functional.one_hot(torch.argmax(logits, dim=-1),
                                          logits.shape[-1]).float()
    probs = torch.softmax(_filtered(logits, sp, last_tokens), dim=-1)
    return torch.where(sp.temperature[:, None] <= 0.0, one_hot, probs)


def categorical_probs(probs: torch.Tensor, seeds: torch.Tensor,
                      counters: torch.Tensor) -> torch.Tensor:
    """One draw per row from probability rows [B, V] -> [B] int64, slot b's
    noise from (seeds[b], counters[b]) (Gumbel-max, as sample_dynamic).
    Zero-probability tokens are unreachable: speculative sampling's
    residual and top-k / top-p masks rely on it."""
    z = torch.where(probs > 0, torch.log(torch.clamp(probs, min=1e-30)), _NEG_INF)
    u = uniform_rows(seeds, counters, probs.shape[-1])
    return torch.argmax(z - torch.log(-torch.log(u)), dim=-1)


def sample_dynamic(logits: torch.Tensor, sp: SamplingParams, counters: torch.Tensor,
                   last_tokens: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-slot sampling: logits [B, V] -> [B] int64 on the logits' device.

    Greedy slots take the raw argmax; the others a Gumbel-max draw over
    their filtered logits with slot b's noise from (seed[b], counters[b])
    (uniform_rows): argmax(z + g) is distributed as softmax(z)."""
    logits = logits.float()
    greedy_ids = torch.argmax(logits, dim=-1)
    z = _filtered(logits, sp, last_tokens)
    u = uniform_rows(sp.seed, counters, logits.shape[-1])
    sampled = torch.argmax(z - torch.log(-torch.log(u)), dim=-1)
    return torch.where(sp.temperature <= 0.0, greedy_ids, sampled)
