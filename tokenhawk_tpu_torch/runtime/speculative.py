"""Speculative decoding: a small draft model proposes, the target verifies.

Counterpart of tokenhawk_tpu/runtime/speculative.py on one device.
Decode is bound by the weight bytes: the target's forward over gamma+1
tokens costs about what one token costs, so verifying gamma draft tokens
in one target pass multiplies the tokens per step by the acceptance
length.  Greedy form: the target's argmax over the drafted prefix either
reproduces each draft token (accept) or gives the correction (reject and
replace), so the output is the target-only greedy stream whatever the
draft; the draft changes speed, never content.

  * A round is eager PyTorch on the device: the draft's gamma steps are
    a Python loop over `forward` (the reference scans them), then one
    target forward over [B, gamma+1] tokens and the acceptance
    arithmetic.  Only the token ids and accept counts reach the host,
    once per round.
  * No KV rollback.  Both caches take K/V for the speculative positions
    as they go; on a rejection the offsets simply do not advance past
    the accepted prefix.  Every attention kernel masks by length, so the
    stale rows past the offset are invisible and are overwritten when
    those positions are reached again.
  * The invariant is runtime.engine's: the last committed token is not
    yet in the cache.  The draft writes [last, d_1 .. d_{g-1}] at
    offsets .. offsets+g-1; an accepted prefix d_1 .. d_k sits where the
    committed history needs it.  After a round that accepts all g drafts
    the draft's cache holds no row for d_g, as in the reference, whose
    rounds the port mirrors: the tokens are the target's whatever the
    draft sees, and only acceptance pays for the missing row.

The draft is a small dense model (a TinyLlama-class draft for LLaMA-7B),
so its decode steps run kernel 14 (ops/cuda/flash_decode.py) behind an
index copy; the dense target's verify runs kernel 4, the paged target's
forward_paged_verify (kernels 6, 7 and 4).

Sampled speculation (rejection sampling) follows the reference: draft
token x_i ~ p_d is accepted with probability min(1, p_t(x_i)/p_d(x_i)); at
the first rejection the committed token is drawn from norm(max(p_t - p_d,
0)); if all gamma drafts pass a bonus token is drawn from p_t.  Both
distributions are the processed ones (repeat penalty over a local copy of
the last-N ring, temperature, top-k, top-p), so committed tokens are
distributed as target-only sampling.  Greedy slots ride the same path
through exact one-hots.  Each round consumes gamma+2 counter values per
slot (gamma draft draws, one uniform row, one residual or bonus draw).
The draws come from the port's counter hash (sampling.uniform_rows), so
sampled streams are the reference's in distribution, not token for token.
"""

from __future__ import annotations

import time
from typing import List, Optional, Sequence

import numpy as np
import torch

from tokenhawk_tpu_torch.config import LlamaConfig, SamplingConfig
from tokenhawk_tpu_torch.models.llama import (
    KVCache,
    LlamaParams,
    forward,
    forward_paged_verify,
    logits_from_hidden,
)
from tokenhawk_tpu_torch.runtime.engine import Engine, _bucket
from tokenhawk_tpu_torch.sampling import (
    categorical_probs,
    is_eos,
    normalize_eos,
    processed_probs_dynamic,
    tokenizer_eos,
    uniform_rows,
)
from tokenhawk_tpu_torch.tokenizer import EOS_ID


def check_draft(cfg_draft: Optional[LlamaConfig], cfg_target: LlamaConfig) -> None:
    if cfg_draft is None:
        raise ValueError("draft_params needs its draft_cfg")
    if cfg_draft.n_vocab != cfg_target.n_vocab:
        raise ValueError("draft and target must share the vocab")


def _draft_greedy(cfg_draft, params_d, cache_d, last_tok, offsets, adv, gamma):
    """gamma greedy draft steps from last_tok at offsets (frozen slots,
    adv 0, rewrite their frontier) -> drafts [B, gamma] int64."""
    tok, off, drafts = last_tok, offsets, []
    for _ in range(gamma):
        h, _ = forward(cfg_draft, params_d, tok[:, None], cache_d, off)
        tok = torch.argmax(logits_from_hidden(cfg_draft, params_d, h[:, 0]), dim=-1)
        off = off + adv
        drafts.append(tok)
    return torch.stack(drafts, dim=1)


def _commit(drafts, k, y):
    """out [B, g+1]: drafts[:, j] for j < k, y at j == k, -1 after."""
    B, g = drafts.shape
    j = torch.arange(g + 1, device=drafts.device)[None, :]
    pad = torch.cat([drafts, torch.zeros_like(drafts[:, :1])], dim=1)
    out = torch.where(j < k[:, None], pad, -1)
    return torch.where(j == k[:, None], y[:, None], out)


def _accept_greedy(drafts, tgt):
    """k = length of the drafted prefix the target's argmax tgt [B, g+1]
    reproduces; the target's own token at the cut follows it."""
    gamma = drafts.shape[1]
    k = torch.cumprod((drafts == tgt[:, :gamma]).long(), dim=1).sum(dim=1)
    bonus = tgt.gather(1, k[:, None])[:, 0]
    return _commit(drafts, k, bonus), k


def _finish_round(out, k, done, eos_ids, offsets, last_tok):
    """EOS cut and frozen slots, shared by the greedy and sampled rounds:
    a done slot commits nothing; the round's output is cut at the first
    EOS among the committed tokens (inclusive), which latches done.
    Returns (out, n_new, offsets', done', last_tok')."""
    gamma = out.shape[1] - 1
    j = torch.arange(gamma + 1, device=out.device)[None, :]
    n_new = torch.where(done, 0, k + 1)
    eos = is_eos(out, eos_ids) & (j < n_new[:, None])
    eos_pos = torch.where(eos, j, gamma + 1).amin(dim=1)
    has_eos = eos_pos <= gamma
    n_new = torch.where(has_eos, eos_pos + 1, n_new)
    out = torch.where(j < n_new[:, None], out, -1)
    last_new = out.gather(1, torch.clamp(n_new - 1, 0, gamma)[:, None])[:, 0]
    return (out, n_new, offsets + n_new.to(offsets.dtype), done | has_eos,
            torch.where(done, last_tok, last_new))


def make_spec_decode_fn(cfg_draft: LlamaConfig, cfg_target: LlamaConfig, gamma: int):
    """One greedy speculative round on the device:
    (params_d, params_t, cache_d, cache_t, last_tok [B], offsets [B])
      -> (cache_d, cache_t, out [B, gamma+1] (-1-padded), n_new [B],
          offsets', last_tok').
    out[:, :n_new] extends the committed stream with k accepted drafts
    and the target's own token at the cut: target-only greedy decoding."""

    @torch.inference_mode()
    def step(params_d, params_t, cache_d, cache_t, last_tok, offsets):
        adv = torch.ones_like(offsets)
        drafts = _draft_greedy(cfg_draft, params_d, cache_d, last_tok, offsets, adv, gamma)
        seq = torch.cat([last_tok[:, None], drafts], dim=1)
        tgt = torch.argmax(_dense_target(cfg_target, params_t, cache_t)(seq, offsets, adv), dim=-1)
        out, k = _accept_greedy(drafts, tgt)
        n_new = k + 1
        last = out.gather(1, k[:, None])[:, 0]
        return cache_d, cache_t, out, n_new, offsets + n_new.to(offsets.dtype), last

    return step


def _spec_round_greedy(cfg_draft, gamma, eos_ids, target, params_d, cache_d, last_tok, offsets,
                       done):
    """The dense and paged servers' greedy round; `target(seq, offsets,
    adv)` is the target's verify, block -> logits.  Returns (out, n_new,
    offsets', done', last_tok')."""
    adv = (~done).to(offsets.dtype)
    drafts = _draft_greedy(cfg_draft, params_d, cache_d, last_tok, offsets, adv, gamma)
    seq = torch.cat([last_tok[:, None], drafts], dim=1)
    tgt = torch.argmax(target(seq, offsets, adv), dim=-1)
    out, k = _accept_greedy(drafts, tgt)
    return _finish_round(out, k, done, eos_ids, offsets, last_tok)


def _ring_push(ring, tok):
    return torch.cat([ring[:, 1:], tok[:, None]], dim=1)


def _accept_sampled(drafts, probs_d, probs_t, sp, counters):
    """Rejection-sampling accept/commit: drafts [B, g], draft
    distributions probs_d [B, g, V], target distributions probs_t
    [B, g+1, V] -> (out [B, g+1] committed tokens, -1 past position k;
    k [B] accepted draft counts)."""
    B, g, V = probs_d.shape
    pt_at = probs_t[:, :g].gather(-1, drafts[..., None])[..., 0]  # [B, g]
    pd_at = probs_d.gather(-1, drafts[..., None])[..., 0]
    u = uniform_rows(sp.seed, counters + g, g)  # [B, g]
    # u < min(1, pt/pd)  <=>  u * pd < pt  (pd > 0 at a drawn token)
    acc = u * torch.clamp(pd_at, min=1e-30) < pt_at
    k = torch.cumprod(acc.long(), dim=1).sum(dim=1)
    bi = torch.arange(B, device=drafts.device)
    pt_k = probs_t[bi, k]  # [B, V]
    pd_k = torch.cat([probs_d, torch.zeros_like(probs_d[:, :1])], dim=1)[bi, k]
    q = torch.clamp(pt_k - pd_k, min=0.0)
    qs = q.sum(dim=-1, keepdim=True)
    q = torch.where(qs > 1e-30, q / torch.clamp(qs, min=1e-30), pt_k)
    y = categorical_probs(q, sp.seed, counters + g + 1)
    return _commit(drafts, k, y), k


def _spec_round_sampled(cfg_draft, gamma, eos_ids, target, params_d, cache_d, last_tok, offsets,
                        done, last_n, sp, counters):
    """The servers' sampled round (`target` as in _spec_round_greedy).
    Returns (out, n_new, offsets', done', last_tok', last_n', counters')."""
    adv = (~done).to(offsets.dtype)
    tok, off, ring = last_tok, offsets, last_n
    drafts, probs_d = [], []
    for i in range(gamma):
        h, _ = forward(cfg_draft, params_d, tok[:, None], cache_d, off)
        probs = processed_probs_dynamic(logits_from_hidden(cfg_draft, params_d, h[:, 0]), sp,
                                        ring)
        tok = categorical_probs(probs, sp.seed, counters + i)
        off = off + adv
        ring = _ring_push(ring, tok)
        drafts.append(tok)
        probs_d.append(probs)
    drafts = torch.stack(drafts, dim=1)  # [B, gamma]
    probs_d = torch.stack(probs_d, dim=1)  # [B, gamma, V]

    seq = torch.cat([last_tok[:, None], drafts], dim=1)
    logits = target(seq, offsets, adv)  # [B, g+1, V]
    # Position i's penalty history is the committed ring and drafts[:i].
    ring, pts = last_n, []
    for i in range(gamma + 1):
        pts.append(processed_probs_dynamic(logits[:, i], sp, ring))
        if i < gamma:
            ring = _ring_push(ring, drafts[:, i])
    out, k = _accept_sampled(drafts, probs_d, torch.stack(pts, dim=1), sp, counters)
    out, n_new, offsets, done_new, last_tok = _finish_round(out, k, done, eos_ids, offsets,
                                                            last_tok)
    # The committed ring: push exactly the delivered tokens.
    ring = last_n
    for j in range(gamma + 1):
        ring = torch.where((j < n_new)[:, None], _ring_push(ring, out[:, j]), ring)
    return out, n_new, offsets, done_new, last_tok, ring, counters + (gamma + 2)


def _dense_target(cfg_target, params_t, cache_t):
    """The verify over a dense cache: the block's forward at offsets
    (kernel 4), its logits.  Frozen slots write past their frontier."""
    def target(seq, offsets, adv):
        h, _ = forward(cfg_target, params_t, seq, cache_t, offsets)
        return logits_from_hidden(cfg_target, params_t, h)

    return target


def _paged_target(cfg_target, params_t, cache_t, table):
    """The verify over the page pool (forward_paged_verify), its logits."""
    def target(seq, lengths, adv):
        h, _ = forward_paged_verify(cfg_target, params_t, seq, cache_t, table, lengths, adv)
        return logits_from_hidden(cfg_target, params_t, h)

    return target


def make_spec_serving_fn(cfg_draft: LlamaConfig, cfg_target: LlamaConfig, gamma: int,
                         eos_id=EOS_ID):
    """One greedy round shaped for the dense Scheduler:
    (params_d, params_t, cache_d, cache_t, last_tok [B], offsets [B], done [B])
      -> (cache_d, cache_t, out [B, gamma+1] (-1 past n_new), n_new [B],
          offsets', done', last_tok').
    Done slots freeze (their offsets stay, n_new 0, rows of -1; their
    forwards still run and write past the committed frontier, invisible to
    the length masks); EOS latches on the device, n_new counting it."""
    _, eos_ids = normalize_eos(eos_id)

    @torch.no_grad()
    def step(params_d, params_t, cache_d, cache_t, last_tok, offsets, done):
        target = _dense_target(cfg_target, params_t, cache_t)
        return (cache_d, cache_t, *_spec_round_greedy(
            cfg_draft, gamma, eos_ids, target, params_d, cache_d, last_tok, offsets, done))

    return step


def make_spec_serving_fn_paged(cfg_draft: LlamaConfig, cfg_target: LlamaConfig, gamma: int,
                               eos_id=EOS_ID):
    """make_spec_serving_fn over a paged target pool: the draft keeps a
    dense per-slot cache (it is small), the verify block goes through
    forward_paged_verify at each slot's frontier.
    (params_d, params_t, cache_d, cache_t, table, last_tok, lengths, done)
      -> (cache_d, cache_t, out, n_new, lengths', done', last_tok')."""
    _, eos_ids = normalize_eos(eos_id)

    @torch.no_grad()
    def step(params_d, params_t, cache_d, cache_t, table, last_tok, lengths, done):
        target = _paged_target(cfg_target, params_t, cache_t, table)
        return (cache_d, cache_t, *_spec_round_greedy(
            cfg_draft, gamma, eos_ids, target, params_d, cache_d, last_tok, lengths, done))

    return step


def make_spec_serving_fn_sampled(cfg_draft: LlamaConfig, cfg_target: LlamaConfig, gamma: int,
                                 eos_id=EOS_ID):
    """make_spec_serving_fn with per-slot sampled acceptance:
    (params_d, params_t, cache_d, cache_t, last_tok, offsets, done, last_n
     [B, N], sp: SamplingParams, counters [B])
      -> (cache_d, cache_t, out, n_new, offsets', done', last_tok',
          last_n', counters')."""
    _, eos_ids = normalize_eos(eos_id)

    @torch.no_grad()
    def step(params_d, params_t, cache_d, cache_t, last_tok, offsets, done, last_n, sp,
             counters):
        target = _dense_target(cfg_target, params_t, cache_t)
        return (cache_d, cache_t, *_spec_round_sampled(
            cfg_draft, gamma, eos_ids, target, params_d, cache_d, last_tok, offsets, done,
            last_n, sp, counters))

    return step


def make_spec_serving_fn_paged_sampled(cfg_draft: LlamaConfig, cfg_target: LlamaConfig,
                                       gamma: int, eos_id=EOS_ID):
    """Sampled acceptance over a paged target pool:
    (params_d, params_t, cache_d, cache_t, table, last_tok, lengths, done,
     last_n, sp, counters)
      -> (cache_d, cache_t, out, n_new, lengths', done', last_tok',
          last_n', counters')."""
    _, eos_ids = normalize_eos(eos_id)

    @torch.no_grad()
    def step(params_d, params_t, cache_d, cache_t, table, last_tok, lengths, done, last_n, sp,
             counters):
        target = _paged_target(cfg_target, params_t, cache_t, table)
        return (cache_d, cache_t, *_spec_round_sampled(
            cfg_draft, gamma, eos_ids, target, params_d, cache_d, last_tok, lengths, done,
            last_n, sp, counters))

    return step


@torch.no_grad()
def draft_prefill(cfg_draft: LlamaConfig, params_d: LlamaParams, draft_cache: KVCache,
                  rows, buckets: Sequence[int]) -> None:
    """Mirror admissions into the draft's dense per-slot cache: rows are
    (slot, tokens, base), tokens written at positions base.. of the slot's
    stripe.  Fresh prompts (base 0) share one padded forward over a
    fragment cache copied into their stripes; a continuation prefills
    straight into its stripe, a view.  The draft's logits are unused: the
    first token always comes from the target."""
    dev = draft_cache.k[0].device
    fresh = [(slot, toks) for slot, toks, base in rows if base == 0]
    if fresh:
        Tb = _bucket(max(len(t) for _, t in fresh), buckets)
        toks = np.zeros((len(fresh), Tb), np.int64)
        for i, (_, t) in enumerate(fresh):
            toks[i, :len(t)] = t
        frag = KVCache.create(cfg_draft, len(fresh), Tb, draft_cache.k[0].dtype, dev)
        forward(cfg_draft, params_d, torch.from_numpy(toks).to(dev), frag,
                torch.zeros((len(fresh),), dtype=torch.int32, device=dev))
        slots = torch.tensor([slot for slot, _ in fresh], device=dev)
        for big, small in zip(draft_cache.k + draft_cache.v, frag.k + frag.v):
            big[slots, :, :Tb] = small
    for slot, t, base in rows:
        if base == 0:
            continue
        S = draft_cache.k[0].shape[2]
        Tb = next((b for b in buckets if b >= len(t) and base + b <= S),
                  -(-len(t) // 8) * 8)
        toks = np.zeros((1, Tb), np.int64)
        toks[0, :len(t)] = t
        stripe = KVCache([k[slot:slot + 1] for k in draft_cache.k],
                         [v[slot:slot + 1] for v in draft_cache.v])
        forward(cfg_draft, params_d, torch.from_numpy(toks).to(dev), stripe,
                torch.tensor([base], dtype=torch.int32, device=dev))


class SpeculativeEngine:
    """Greedy generation with draft-model speculation.

    Both models must share the vocab (LLaMA-7B with a TinyLlama-class
    draft).  Output equals Engine(..., temperature=0).generate's, token
    for token where the two programs round alike (on the CPU in f32);
    only throughput changes."""

    def __init__(self, cfg_target: LlamaConfig, params_target: LlamaParams,
                 cfg_draft: LlamaConfig, params_draft: LlamaParams, tokenizer=None,
                 gamma: int = 4, max_seq: Optional[int] = None, cache_dtype=torch.bfloat16,
                 eos_id=None):
        if eos_id is None:
            eos_id = tokenizer_eos(tokenizer)
        eos_id, self.eos_ids_all = normalize_eos(eos_id)
        check_draft(cfg_draft, cfg_target)
        self.gamma = gamma
        self.eos_id = eos_id
        self.tokenizer = tokenizer
        greedy = SamplingConfig(temperature=0.0)
        # The Engines serve prefill and caches for both models.
        self.target = Engine(cfg_target, params_target, tokenizer=tokenizer, sampling=greedy,
                             max_seq=max_seq, cache_dtype=cache_dtype, eos_id=eos_id)
        self.draft = Engine(cfg_draft, params_draft, tokenizer=tokenizer, sampling=greedy,
                            max_seq=max_seq or cfg_target.n_ctx, cache_dtype=cache_dtype,
                            eos_id=eos_id)
        self._step = make_spec_decode_fn(cfg_draft, cfg_target, gamma)
        self.max_seq = max_seq or cfg_target.n_ctx

    def generate(self, prompt, max_new_tokens: int = 256, on_token=None):
        """Greedy speculative generation for one prompt.  Returns (tokens,
        stats): rounds, drafted, accepted_drafts, acceptance_rate,
        tokens_per_round, prefill_seconds, decode_seconds."""
        if isinstance(prompt, str):
            if self.tokenizer is None:
                raise ValueError("string prompt needs a tokenizer")
            ids = self.tokenizer.encode_prompt(prompt, add_bos=True)
        else:
            ids = list(prompt)
        dev = self.target.device

        t0 = time.perf_counter()
        # The target's prefill commits the prompt and picks token 1; the
        # draft's only fills its cache.
        t_cache, logits, _ = self.target.prefill(self.target.new_cache(1), [ids])
        d_cache, _, _ = self.draft.prefill(self.draft.new_cache(1), [ids])
        first = int(torch.argmax(logits[0], dim=-1))
        prefill_s = time.perf_counter() - t0

        tokens: List[int] = [first]
        if on_token:
            on_token(first)
        offsets = torch.tensor([len(ids)], dtype=torch.int32, device=dev)
        last = torch.tensor([first], dtype=torch.int64, device=dev)
        position = len(ids)  # host mirror of offsets[0]
        rounds = accepted = 0
        t0 = time.perf_counter()
        while (len(tokens) < max_new_tokens and tokens[-1] not in self.eos_ids_all
               and position + self.gamma + 1 < self.max_seq):
            d_cache, t_cache, out, n_new, offsets, last = self._step(
                self.draft.params, self.target.params, d_cache, t_cache, last, offsets)
            row = torch.cat([n_new[:, None], out], dim=1)[0].tolist()  # the round's one transfer
            n, new = row[0], row[1:1 + row[0]]
            rounds += 1
            accepted += n - 1
            position += n
            for tok in new:
                tokens.append(tok)
                if on_token:
                    on_token(tok)
                if tok in self.eos_ids_all or len(tokens) >= max_new_tokens:
                    break
            if any(tok in self.eos_ids_all for tok in new):
                break
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        decode_s = time.perf_counter() - t0
        stats = {
            "rounds": rounds,
            "drafted": rounds * self.gamma,
            "accepted_drafts": accepted,
            "acceptance_rate": accepted / (rounds * self.gamma) if rounds else 0.0,
            "tokens_per_round": (len(tokens) - 1) / rounds if rounds else 0.0,
            "prefill_seconds": prefill_s,
            "decode_seconds": decode_s,
        }
        return tokens[:max_new_tokens], stats
