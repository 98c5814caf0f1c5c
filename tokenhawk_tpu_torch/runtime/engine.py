"""Generation engine: prefill + chunked decode with on-device sampling.

Counterpart of tokenhawk_tpu/runtime/engine.py (single device).  The
reference compiles prefill and a `lax.scan` over a decode chunk; here the
same functions run eagerly: prefill is one forward over the prompt padded
to a power-of-two bucket, and a decode chunk is a Python loop of
`chunk` steps whose sampled ids, EOS latch and repeat-penalty ring stay
on the device.  The ids reach the host once per chunk.  Finished slots
emit the EOS sentinel and do not advance their offset.

cache_dtype is a torch dtype, "int8" (QuantKVCache, ops/kvquant.py) or
"auto": int8 when max_seq >= 1024, else bfloat16 (the reference's rule
on one device; bfloat16 under a mesh).

With `mesh` (parallel/mesh.py make_cp_mesh) and parallel="cp", every rank
of the ctx group runs the same Engine over the whole parameters and its
slice of the cache (parallel/cp.py), as the reference's Engine does over
its (data, ctx) mesh.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from tokenhawk_tpu_torch.config import LlamaConfig, SamplingConfig
from tokenhawk_tpu_torch.models.llama import (
    KVCache,
    LlamaParams,
    QuantKVCache,
    forward,
    logits_from_hidden,
)
from tokenhawk_tpu_torch.sampling import is_eos as _is_eos
from tokenhawk_tpu_torch.sampling import normalize_eos, sample, sample_dynamic, tokenizer_eos
from tokenhawk_tpu_torch.tokenizer import BOS_ID, EOS_ID, Tokenizer


@dataclasses.dataclass
class GenerationResult:
    tokens: List[int]
    text: str
    prompt_tokens: int
    prefill_seconds: float
    decode_seconds: float

    @property
    def decode_tokens_per_second(self) -> float:
        n = len(self.tokens)
        return n / self.decode_seconds if self.decode_seconds > 0 else 0.0


def prefill_buckets(max_seq: int) -> List[int]:
    """Prefill block lengths: powers of two from 16, then max_seq."""
    buckets = []
    b = 16
    while b < max_seq:
        buckets.append(b)
        b *= 2
    return buckets + [max_seq]


def _bucket(n: int, buckets: Sequence[int]) -> int:
    for b in buckets:
        if n <= b:
            return b
    raise ValueError(f"prompt length {n} exceeds max bucket {buckets[-1]}")


def resolve_cache_dtype(cache_dtype, max_seq: int):
    """"auto" -> "int8" when max_seq >= 1024, else bfloat16 (the
    reference's rule on one device); any other value as it is."""
    if cache_dtype == "auto":
        return "int8" if max_seq >= 1024 else torch.bfloat16
    return cache_dtype


def last_rows(h: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """h [B, T, D] -> the row at n[b]-1 of each sequence (clamped)."""
    idx = torch.clamp(n.long() - 1, 0, h.shape[1] - 1)
    return h[torch.arange(h.shape[0], device=h.device), idx]


def make_prefill_fn(cfg: LlamaConfig):
    """fn: (params, cache, tokens [B,Tb], lengths [B], offsets [B]) ->
    (cache, last_logits [B,V] f32)."""

    @torch.inference_mode()
    def prefill(params, cache, tokens, lengths, offsets):
        h, cache = forward(cfg, params, tokens, cache, offsets)
        return cache, logits_from_hidden(cfg, params, last_rows(h, lengths))

    return prefill


def make_decode_fn(cfg: LlamaConfig, sampling: SamplingConfig, chunk: int,
                   eos_id: int = EOS_ID, forward=forward):
    """fn decoding `chunk` tokens:
    (params, cache, last_tok [B], offsets [B], last_n [B,N], done [B], generator)
      -> (cache, tokens [B,chunk], offsets, last_n, done).
    `forward(cfg, params, tokens [B, 1], cache, offsets)` -> (hidden, cache)
    runs one token (models/llama.py forward; parallel/cp.py passes its own)."""
    eos0, eos_ids = normalize_eos(eos_id)

    @torch.inference_mode()
    def decode(params, cache, last_tok, offsets, last_n, done, generator):
        toks = []
        tok = last_tok
        for _ in range(chunk):
            h, cache = forward(cfg, params, tok[:, None], cache, offsets)
            logits = logits_from_hidden(cfg, params, h[:, 0])
            nxt = sample(logits, generator, sampling, last_n)
            nxt = torch.where(done, eos0, nxt)
            # Finished slots do not advance: an unbounded offset would walk
            # past the cache end.
            offsets = offsets + (~done).to(offsets.dtype)
            done = done | _is_eos(nxt, eos_ids)
            last_n = torch.cat([last_n[:, 1:], nxt[:, None]], dim=1)
            toks.append(nxt)
            tok = nxt
        return cache, torch.stack(toks, dim=1), offsets, last_n, done

    return decode


def make_decode_fn_dynamic(cfg: LlamaConfig, chunk: int, eos_id: int = EOS_ID):
    """Decode chunk with per-slot sampling parameters (the dense
    Scheduler's step):
    (params, cache, last_tok [B], offsets [B], last_n [B,N], done [B],
     sp: SamplingParams, counters [B])
      -> (cache, tokens [B,chunk], offsets, last_n, done, counters).
    Each slot draws from its own (seed, counter) stream.  Runs under
    no_grad, not inference_mode: the scheduler updates the returned slot
    state in place outside the call."""
    eos0, eos_ids = normalize_eos(eos_id)

    @torch.no_grad()
    def decode(params, cache, last_tok, offsets, last_n, done, sp, counters):
        toks = []
        tok = last_tok
        for _ in range(chunk):
            h, cache = forward(cfg, params, tok[:, None], cache, offsets)
            logits = logits_from_hidden(cfg, params, h[:, 0])
            nxt = sample_dynamic(logits, sp, counters, last_n)
            nxt = torch.where(done, eos0, nxt)
            offsets = offsets + (~done).to(offsets.dtype)
            counters = counters + 1
            done = done | _is_eos(nxt, eos_ids)
            last_n = torch.cat([last_n[:, 1:], nxt[:, None]], dim=1)
            toks.append(nxt)
            tok = nxt
        return cache, torch.stack(toks, dim=1), offsets, last_n, done, counters

    return decode


class Engine:
    """Single-model inference engine (synchronous API) on one device."""

    def __init__(
        self,
        cfg: LlamaConfig,
        params: LlamaParams,
        tokenizer: Optional[Tokenizer] = None,
        sampling: SamplingConfig = SamplingConfig(),
        max_seq: Optional[int] = None,
        batch_size: int = 1,
        cache_dtype=torch.bfloat16,
        decode_chunk: int = 8,
        eos_id: Optional[int] = None,
        mesh=None,
        parallel: Optional[str] = None,
    ):
        if parallel in ("tp", "pp"):
            item = "item 5" if parallel == "tp" else "item 5, after TP"
            raise NotImplementedError(f"parallel={parallel!r} is not ported yet "
                                      f"(ROADMAP.md Queue 1 {item})")
        if parallel not in (None, "cp") or (parallel == "cp") != (mesh is not None):
            raise ValueError(f"parallel={parallel!r} with mesh={mesh!r}: the port runs "
                             "parallel='cp' over a make_cp_mesh() mesh, or neither")
        if eos_id is None:
            eos_id = tokenizer_eos(tokenizer)
        self.cfg = cfg
        self.params = params
        self.device = params.device
        self.tokenizer = tokenizer
        self.sampling = sampling
        self.max_seq = max_seq or cfg.n_ctx
        self.batch_size = batch_size
        self.mesh = mesh
        if mesh is not None:
            # The reference's CP caches are bfloat16 or f32; it has no int8 CP.
            if cache_dtype == "int8":
                raise ValueError("an int8 cache has no CP form (the reference's neither)")
            if cache_dtype == "auto":
                cache_dtype = torch.bfloat16
        self.cache_dtype = resolve_cache_dtype(cache_dtype, self.max_seq)
        self.decode_chunk = decode_chunk
        self.eos_id, self.eos_ids = normalize_eos(eos_id)
        eos_id = self.eos_ids if len(self.eos_ids) > 1 else self.eos_id

        if mesh is not None:
            from tokenhawk_tpu_torch.parallel.cp import (
                make_cp_decode_fn,
                make_cp_prefill_fn,
                validate_cp,
            )

            validate_cp(cfg, mesh.ncp, self.max_seq)
            self._prefill = make_cp_prefill_fn(cfg, mesh)
            self._decode = make_cp_decode_fn(cfg, mesh, sampling, decode_chunk, eos_id)
            self._decode1 = make_cp_decode_fn(cfg, mesh, sampling, 1, eos_id)
        else:
            self._prefill = make_prefill_fn(cfg)
            self._decode = make_decode_fn(cfg, sampling, decode_chunk, eos_id)
            self._decode1 = make_decode_fn(cfg, sampling, 1, eos_id)

        self.buckets = prefill_buckets(self.max_seq)

        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(sampling.seed)

    # -- low-level API ---------------------------------------------------

    def new_cache(self, batch: Optional[int] = None):
        batch = batch or self.batch_size
        if self.mesh is not None:  # this rank's max_seq / ncp slots (parallel/cp.py)
            return KVCache.create(self.cfg, batch, self.max_seq // self.mesh.ncp,
                                  self.cache_dtype, self.device)
        if self.cache_dtype == "int8":
            return QuantKVCache.create(self.cfg, batch, self.max_seq, self.device)
        return KVCache.create(self.cfg, batch, self.max_seq, self.cache_dtype, self.device)

    def prefill(self, cache: KVCache, prompts: Sequence[Sequence[int]],
                offsets: Optional[np.ndarray] = None):
        """Prefill a batch of prompts (padded to one bucket)."""
        B = len(prompts)
        lens = np.array([len(p) for p in prompts], np.int32)
        Tb = _bucket(int(lens.max()), self.buckets)
        toks = np.zeros((B, Tb), np.int64)
        for i, p in enumerate(prompts):
            toks[i, : len(p)] = p
        if offsets is None:
            offsets = np.zeros((B,), np.int32)
        dev = self.device
        cache, logits = self._prefill(
            self.params, cache, torch.from_numpy(toks).to(dev),
            torch.from_numpy(lens).to(dev), torch.from_numpy(offsets).to(dev))
        return cache, logits, lens

    # -- user API --------------------------------------------------------

    def generate(
        self,
        prompt: Sequence[int] | str,
        max_new_tokens: int = 500,
        on_token: Optional[Callable[[int], None]] = None,
        on_text: Optional[Callable[[str], None]] = None,
    ) -> GenerationResult:
        """Generate from a single prompt, streaming tokens as they arrive."""
        if isinstance(prompt, str):
            if self.tokenizer is None:
                raise ValueError("string prompt requires a tokenizer")
            prompt_ids = self.tokenizer.encode_prompt(prompt, add_bos=True)
        else:
            prompt_ids = list(prompt)
        if not prompt_ids:
            bos = getattr(self.tokenizer, "bos_id", BOS_ID)
            prompt_ids = [bos if bos is not None and bos >= 0 else BOS_ID]
        if len(prompt_ids) >= self.max_seq:
            raise ValueError(
                f"prompt ({len(prompt_ids)} tokens) exceeds context {self.max_seq}")

        dev = self.device
        t0 = time.perf_counter()
        cache = self.new_cache(batch=1)
        cache, logits, lens = self.prefill(cache, [prompt_ids])

        # First sampled token comes from the prefill logits.
        n_ring = max(self.sampling.repeat_last_n, 1)
        last_n = np.full((1, n_ring), -1, np.int64)
        m = min(n_ring, len(prompt_ids))
        last_n[0, n_ring - m:] = prompt_ids[-m:]
        last_n = torch.from_numpy(last_n).to(dev)

        with torch.inference_mode():
            first = sample(logits, self.generator, self.sampling, last_n)
        first_id = int(first[0])  # waits for the device
        t1 = time.perf_counter()

        out_tokens: List[int] = []
        done_host = False

        def emit(tid: int) -> bool:
            nonlocal done_host
            if tid in self.eos_ids:
                done_host = True
                return False
            out_tokens.append(tid)
            if on_token:
                on_token(tid)
            if on_text and self.tokenizer:
                on_text(self.tokenizer.decode_token_bytes(tid).decode("utf-8", "replace"))
            return True

        emit(first_id)
        last_n = torch.cat([last_n[:, 1:], first[:, None]], dim=1)

        offsets = torch.tensor([len(prompt_ids)], dtype=torch.int32, device=dev)
        done = torch.tensor([done_host], device=dev)
        last_tok = first

        budget = min(max_new_tokens, self.max_seq - len(prompt_ids) - 1)
        produced = 1
        position = len(prompt_ids)  # host mirror of offsets[0]
        while produced < budget and not done_host:
            n = min(self.decode_chunk, budget - produced)
            # A full chunk may overshoot the budget (surplus discarded) as
            # long as the cache has room for all of it.
            if n == self.decode_chunk or self.max_seq - position > self.decode_chunk:
                fn, steps = self._decode, self.decode_chunk
            else:
                fn, steps = self._decode1, 1
            cache, toks, offsets, last_n, done = fn(
                self.params, cache, last_tok, offsets, last_n, done, self.generator)
            position += steps
            toks_host = toks[0].tolist()  # the chunk's one host transfer
            last_tok = toks[:, -1]
            for t in toks_host[:n]:
                produced += 1
                if not emit(int(t)):
                    break
            if done_host or int(toks_host[-1]) in self.eos_ids:
                done_host = True
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t2 = time.perf_counter()

        text = self.tokenizer.decode(out_tokens) if self.tokenizer else ""
        return GenerationResult(tokens=out_tokens, text=text, prompt_tokens=len(prompt_ids),
                                prefill_seconds=t1 - t0, decode_seconds=t2 - t1)
