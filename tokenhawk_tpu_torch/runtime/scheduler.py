"""Continuous batching over a dense per-slot KV cache.

Counterpart of tokenhawk_tpu/runtime/scheduler.py: up to `max_batch`
requests share one batched decode step.  Each slot owns a stripe
[Hkv, S, Dh] of every layer's cache; a prompt prefills into a fragment
cache that is copied into its slot's stripe; every decode chunk advances
all slots together (finished slots latch EOS on the device and do not
advance); per-request streaming callbacks fire as chunks come back, one
host transfer per chunk.  Sessions keep a slot's KV between requests, so
a follow-up message prefills only its new tokens, straight into the
stripe (a view of the cache, written in place).

With a draft model (draft_cfg / draft_params) every step is one
speculative round instead of a decode chunk (runtime/speculative.py):
the draft keeps its own dense per-slot cache, mirrored at every
admission, proposes gamma tokens, and the target commits the accepted
prefix and one token of its own.  Greedy slots take the exact-match
rule (the target-only greedy stream); a round with a sampled slot takes
rejection sampling for every slot.

Not ported yet: tensor parallelism (a mesh; ROADMAP Queue 1 item 8).
"""

from __future__ import annotations

import dataclasses
import itertools
import time
from collections import deque
from typing import Callable, Deque, List, Optional, Sequence

import numpy as np
import torch

from tokenhawk_tpu_torch.config import LlamaConfig, SamplingConfig
from tokenhawk_tpu_torch.models.llama import KVCache, LlamaParams
from tokenhawk_tpu_torch.runtime import speculative
from tokenhawk_tpu_torch.runtime.engine import (
    _bucket,
    make_decode_fn_dynamic,
    make_prefill_fn,
    prefill_buckets,
)
from tokenhawk_tpu_torch.sampling import SamplingParams, normalize_eos, sample_dynamic
from tokenhawk_tpu_torch.tokenizer import EOS_ID

TP_TODO = "tensor-parallel serving is not ported yet (ROADMAP Queue 1 item 8)"


@dataclasses.dataclass
class Request:
    prompt: List[int]
    max_new_tokens: int = 256
    # Per-request sampling parameters; None = the scheduler's default.
    sampling: Optional[SamplingConfig] = None
    # Multi-turn conversation id: successive requests with the same
    # session continue the same KV state (dense Scheduler only).
    session: Optional[str] = None
    on_token: Optional[Callable[[int], None]] = None
    on_done: Optional[Callable[["Request"], None]] = None
    # Stop sequences (bytes) checked against the decoded text stream.
    # Requires `detok` (token id -> bytes, supplied by the serving layer).
    # Matched text is never emitted: the stream holds back any suffix
    # that could be a stop prefix and flushes it on retirement.
    stop: Optional[List[bytes]] = None
    detok: Optional[Callable[[int], bytes]] = None
    on_text: Optional[Callable[[bytes], None]] = None
    # filled by the scheduler:
    id: int = -1
    output: List[int] = dataclasses.field(default_factory=list)
    submitted_at: float = 0.0
    first_token_at: Optional[float] = None
    done_at: Optional[float] = None
    finish_reason: str = ""
    n_past0: int = 0  # KV tokens already resident when this request started
    _text_buf: bytes = b""  # holdback buffer for stop-sequence streaming

    @property
    def ttft_seconds(self) -> Optional[float]:
        if self.first_token_at is None:
            return None
        return self.first_token_at - self.submitted_at

    def feed_text(self, tok: int) -> bool:
        """Stream one token's text through the stop-sequence filter.

        Returns True if a stop sequence matched (caller retires the
        slot).  Emits via on_text; never emits matched stop text, and
        holds back any tail that could still become a stop prefix."""
        if self.detok is None:
            return False

        def emit(chunk: bytes):
            if chunk and self.on_text is not None:
                self.on_text(chunk)

        b = self.detok(tok)
        if not self.stop:
            emit(b)
            return False
        buf = self._text_buf + b
        hit = min((i for i in (buf.find(s) for s in self.stop) if i >= 0),
                  default=-1)
        if hit >= 0:
            emit(buf[:hit])
            self._text_buf = b""
            return True
        # Longest suffix of buf that is a proper prefix of some stop.
        hold = 0
        for s in self.stop:
            for n in range(min(len(s) - 1, len(buf)), 0, -1):
                if buf.endswith(s[:n]):
                    hold = max(hold, n)
                    break
        emit(buf[: len(buf) - hold] if hold else buf)
        self._text_buf = buf[len(buf) - hold :] if hold else b""
        return False

    def flush_text(self):
        """Emit any held-back text (stream ended without a stop match)."""
        if self._text_buf and self.on_text is not None:
            self.on_text(self._text_buf)
        self._text_buf = b""


@dataclasses.dataclass
class Session:
    id: str
    slot: int
    n_past: int  # conversation length (prompt + replies), in tokens
    tail: List[int]  # recent conversation tokens (repeat-penalty ring)
    # History tokens sampled but never written to the KV cache (a token's
    # KV is written when it is used as input; the last reply token has no
    # next step if the decode chunk ended at its sampling).  They replay
    # at the start of the next continuation prefill.
    pending: List[int] = dataclasses.field(default_factory=list)
    last_used: float = 0.0


def make_rings(prompts: Sequence[Sequence[int]], n_ring: int, rows: int) -> np.ndarray:
    """Repeat-penalty rings [rows, n_ring] holding each prompt's last
    tokens right-aligned (-1 = empty)."""
    rings = np.full((rows, n_ring), -1, np.int64)
    for i, p in enumerate(prompts):
        m = min(n_ring, len(p))
        if m:
            rings[i, n_ring - m:] = list(p)[-m:]
    return rings


def to_device(device, a, dtype=None) -> torch.Tensor:
    """Host values (numpy or lists) -> a tensor on `device`."""
    return torch.as_tensor(np.asarray(a), dtype=dtype).to(device)


@torch.no_grad()
def admit_state(logits, sp: SamplingParams, counters, last_tok, last_n, done, slots,
                rings, slot_sp: SamplingParams):
    """Sample the first token of each admitted row from its prefill logits
    [Nb, V] and write every per-slot device field in place.  Rows whose
    slot index is out of range (batch padding) are dropped.  Returns the
    first tokens [Nb] (on the device)."""
    n = logits.shape[0]
    first = sample_dynamic(logits, slot_sp, torch.zeros((n,), dtype=torch.int64,
                                                        device=logits.device), rings)
    live = slots < last_tok.shape[0]
    s = slots[live]
    sp.set_rows(s, SamplingParams(*[a[live] for a in slot_sp.fields()]))
    counters[s] = 1
    last_tok[s] = first[live]
    last_n[s] = torch.cat([rings[:, 1:], first[:, None]], dim=1)[live]
    done[s] = False
    return first


class Scheduler:
    native_sessions = True  # KV-pinned multi-turn sessions (see Session)

    def __init__(
        self,
        cfg: LlamaConfig,
        params: LlamaParams,
        sampling: SamplingConfig = SamplingConfig(),
        max_batch: int = 8,
        max_seq: Optional[int] = None,
        cache_dtype=torch.bfloat16,
        decode_chunk: int = 8,
        eos_id: int = EOS_ID,
        mesh=None,
        draft_cfg: Optional[LlamaConfig] = None,
        draft_params: Optional[LlamaParams] = None,
        gamma: int = 4,
    ):
        if mesh is not None:
            raise NotImplementedError(TP_TODO)
        if cache_dtype in ("int8", "auto"):
            # The reference's dense Scheduler would build an int8 (k, v)
            # cache and truncate bf16 K/V into it (ROADMAP Queue 3).
            raise ValueError("the dense Scheduler keeps a bf16/f32 cache; int8 KV "
                             "serving is the PagedScheduler's (cache_dtype='int8')")
        self.cfg = cfg
        self.params = params
        self.device = params.device
        self.sampling = sampling
        self.B = max_batch
        self.S = max_seq or cfg.n_ctx
        self.eos_id, self.eos_ids = normalize_eos(eos_id)
        eos_id = self.eos_ids if len(self.eos_ids) > 1 else self.eos_id
        self.decode_chunk = decode_chunk
        self._prefill = make_prefill_fn(cfg)
        self._decode = make_decode_fn_dynamic(cfg, decode_chunk, eos_id)
        self.cache_dtype = cache_dtype
        self.cache = KVCache.create(cfg, self.B, self.S, cache_dtype, self.device)
        self.buckets = prefill_buckets(self.S)

        self.spec = draft_params is not None
        self.gamma = gamma
        if self.spec:
            speculative.check_draft(draft_cfg, cfg)
            self.draft_cfg, self.draft_params = draft_cfg, draft_params
            self.draft_cache = KVCache.create(draft_cfg, self.B, self.S, cache_dtype,
                                              self.device)
            self._spec_step = speculative.make_spec_serving_fn(draft_cfg, cfg, gamma, eos_id)
            self._spec_step_sampled = speculative.make_spec_serving_fn_sampled(
                draft_cfg, cfg, gamma, eos_id)
            # Host mirror of the slots' temperatures: a round whose live
            # slots are all greedy takes the cheaper exact-match round.
            self._slot_sampled = [False] * self.B

        self.n_ring = max(sampling.repeat_last_n, 1)
        self._reset_slot_state()
        self.pending: Deque[Request] = deque()
        self.finished: List[Request] = []
        self._ids = itertools.count()

        # Multi-turn sessions: sid -> Session; pinned maps an IDLE slot
        # to the session whose KV it retains between requests.  Pinned
        # slots are evicted LRU when fresh admissions need capacity.
        self.sessions: dict = {}
        self.pinned: dict = {}

    def _reset_slot_state(self):
        dev = self.device
        self.last_tok = torch.zeros((self.B,), dtype=torch.int64, device=dev)
        self.offsets = torch.zeros((self.B,), dtype=torch.int32, device=dev)
        self.last_n = torch.full((self.B, self.n_ring), -1, dtype=torch.int64, device=dev)
        self.done = torch.ones((self.B,), dtype=torch.bool, device=dev)
        self.sp = SamplingParams.broadcast(self.sampling, self.B, dev)
        self.counters = torch.zeros((self.B,), dtype=torch.int64, device=dev)
        self.slots: List[Optional[Request]] = [None] * self.B

    # ------------------------------------------------------------------

    def _fail(self, req: Request, reason: str) -> int:
        req.finish_reason = reason
        req.done_at = time.perf_counter()
        self.finished.append(req)
        req.flush_text()
        if req.on_done:
            req.on_done(req)
        return req.id

    def submit(self, req: Request) -> int:
        req.id = next(self._ids)
        req.submitted_at = time.perf_counter()
        if req.max_new_tokens <= 0:
            return self._fail(req, "length")
        if len(req.prompt) >= self.S:
            return self._fail(req, "error:prompt_too_long")
        sess = self.sessions.get(req.session) if req.session else None
        if sess is not None:
            # The padded new message (and a speculative round's block)
            # must fit behind the session's resident tokens.
            pad = -(-len(req.prompt) // 8) * 8 + (self.gamma if self.spec else 0)
            if sess.n_past + pad >= self.S:
                return self._fail(req, "error:context_full")
        self.pending.append(req)
        return req.id

    def reset_session(self, sid: str) -> bool:
        """Forget a session's KV state.  Safe while idle."""
        sess = self.sessions.pop(sid, None)
        if sess is None:
            return False
        self.pinned.pop(sess.slot, None)
        return True

    @property
    def n_active(self) -> int:
        return sum(s is not None for s in self.slots)

    @property
    def has_work(self) -> bool:
        return self.n_active > 0 or len(self.pending) > 0

    # ------------------------------------------------------------------

    def _admit_batch(self, group: list):
        """Admit a same-bucket group of plain requests with one padded
        prefill into a fragment cache, one copy into the slots' stripes
        and one fused state update.  The row count pads to a power of two;
        padding rows carry zero lengths and an out-of-range slot index."""
        Tb = group[0][2]
        n = len(group)
        Nb = 1 << (n - 1).bit_length()
        frag = KVCache.create(self.cfg, Nb, Tb, self.cache_dtype, self.device)
        toks = np.zeros((Nb, Tb), np.int64)
        lengths = np.zeros((Nb,), np.int32)
        slots = np.full((Nb,), self.B, np.int64)
        scfgs = []
        for i, (slot, req, _Tb) in enumerate(group):
            toks[i, : len(req.prompt)] = req.prompt
            lengths[i] = len(req.prompt)
            slots[i] = slot
            scfgs.append(req.sampling or self.sampling)
        lengths_dev = to_device(self.device, lengths)
        frag, logits = self._prefill(self.params, frag, to_device(self.device, toks), lengths_dev,
                                     torch.zeros((Nb,), dtype=torch.int32, device=self.device))
        slots_dev = to_device(self.device, slots)
        with torch.no_grad():
            for big, small in zip(self.cache.k + self.cache.v, frag.k + frag.v):
                big[slots_dev[:n], :, :Tb] = small[:n]
        rings = to_device(self.device, make_rings([r.prompt for _, r, _ in group], self.n_ring, Nb))
        first = admit_state(logits, self.sp, self.counters, self.last_tok, self.last_n,
                            self.done, slots_dev, rings,
                            SamplingParams.from_configs(scfgs, Nb, self.device))
        self.offsets[slots_dev[:n]] = lengths_dev[:n]
        if self.spec:
            self._draft_prefill([(slot, req.prompt, 0) for slot, req, _Tb in group])
        first_host = first.tolist()
        now = time.perf_counter()
        for i, (slot, req, _Tb) in enumerate(group):
            self._note_sampling(slot, req)
            req.n_past0 = 0
            self.slots[slot] = req
            self.pinned.pop(slot, None)
            req.first_token_at = now
            self._deliver(slot, int(first_host[i]))

    def _continue_one(self, slot: int, req: Request, sess) -> bool:
        """Continue a session: prefill only the new tokens (plus any
        pending unwritten reply tail) into the pinned slot's stripe at its
        write frontier.  The retained KV is the prefix cache."""
        combined = list(sess.pending) + list(req.prompt)
        base_w = sess.n_past - len(sess.pending)  # write frontier
        Tb = None
        for b in self.buckets:
            if b >= len(combined) and base_w + b <= self.S:
                Tb = b
                break
        if Tb is None:
            Tb = -(-len(combined) // 8) * 8  # tight pad near the context edge
        if base_w + Tb > self.S:
            self._fail(req, "error:context_full")
            return False
        stripe = KVCache([k[slot:slot + 1] for k in self.cache.k],
                         [v[slot:slot + 1] for v in self.cache.v])
        toks = np.zeros((1, Tb), np.int64)
        toks[0, : len(combined)] = combined
        _, logits = self._prefill(self.params, stripe, to_device(self.device, toks),
                                  to_device(self.device, [len(combined)], torch.int32),
                                  to_device(self.device, [base_w], torch.int32))
        if self.spec:
            self._draft_prefill([(slot, combined, base_w)])
        self._finish_admit(slot, req, logits, base=sess.n_past, tail=sess.tail)
        return True

    def _draft_prefill(self, rows):
        """Mirror admissions (slot, tokens, base) into the draft's cache."""
        speculative.draft_prefill(self.draft_cfg, self.draft_params, self.draft_cache, rows,
                                  self.buckets)

    def _note_sampling(self, slot: int, req: Request):
        if self.spec:
            self._slot_sampled[slot] = (req.sampling or self.sampling).temperature > 0.0

    def _finish_admit(self, slot: int, req: Request, logits, base: int, tail: List[int]):
        req.n_past0 = base
        hist = list(tail) + list(req.prompt)
        rings = to_device(self.device, make_rings([hist], self.n_ring, 1))
        scfg = req.sampling or self.sampling
        first = admit_state(logits, self.sp, self.counters, self.last_tok, self.last_n,
                            self.done, to_device(self.device, [slot]), rings,
                            SamplingParams.broadcast(scfg, 1, self.device))
        self.offsets[slot] = base + len(req.prompt)
        self._note_sampling(slot, req)
        self.slots[slot] = req
        # The slot now belongs to this request; drop any idle pin.
        self.pinned.pop(slot, None)
        req.first_token_at = time.perf_counter()
        self._deliver(slot, int(first[0]))

    def _deliver(self, slot: int, tok: int) -> bool:
        """Feed one token to the request in `slot`; True if it stays active."""
        req = self.slots[slot]
        if req is None:
            return False
        if tok in self.eos_ids:
            self._retire(slot, "eos")
            return False
        req.output.append(tok)
        if req.on_token:
            req.on_token(tok)
        if req.feed_text(tok):
            self._retire(slot, "stop")
            return False
        if len(req.output) >= req.max_new_tokens:
            self._retire(slot, "length")
            return False
        # A speculative slot retires gamma tokens early: the next round
        # writes a block of gamma+1 rows, which must stay inside the cache.
        margin = 1 + (self.gamma if self.spec else 0)
        if req.n_past0 + len(req.prompt) + len(req.output) >= self.S - margin:
            self._retire(slot, "context_full")
            return False
        return True

    def _retire(self, slot: int, reason: str):
        req = self.slots[slot]
        req.finish_reason = reason
        req.done_at = time.perf_counter()
        self.slots[slot] = None
        self.done[slot] = True
        if req.session is not None and not reason.startswith("error"):
            # Pin the slot: its KV stripe (prompt + response) is the
            # session's context for the next message.
            tail = (list(req.prompt) + list(req.output))[-self.n_ring:]
            sess = self.sessions.get(req.session)
            if sess is None:
                sess = Session(id=req.session, slot=slot, n_past=0, tail=[])
                self.sessions[req.session] = sess
            sess.slot = slot
            H = req.n_past0 + len(req.prompt) + len(req.output)
            sess.n_past = H
            # Tokens actually written to the cache = the device write
            # frontier (capped at H: overrun steps past retirement wrote
            # garbage beyond the history, which continuation overwrites).
            written = min(int(self.offsets[slot]), H)
            hist_req = list(req.prompt) + list(req.output)
            sess.pending = hist_req[written - req.n_past0:]
            sess.tail = ((sess.tail if req.n_past0 else []) + tail)[-self.n_ring:]
            sess.last_used = time.perf_counter()
            self.pinned[slot] = req.session
        self.finished.append(req)
        req.flush_text()
        if req.on_done:
            req.on_done(req)

    def cancel(self, req: "Request", reason: str = "cancelled") -> bool:
        """Abort a request (client disconnect): frees its slot or drops
        it from the queue.  Call from the scheduler thread."""
        if req in self.pending:
            self.pending.remove(req)
            req.finish_reason = reason
            req.done_at = time.perf_counter()
            self.finished.append(req)
            if req.on_done:
                req.on_done(req)
            return True
        for slot, r in enumerate(self.slots):
            if r is req:
                self._retire(slot, reason)
                return True
        return False

    def reset_device_state(self):
        """Recovery path: rebuild every device buffer from scratch after
        repeated step failures (callers retire the active slots first).
        Sessions lose their context; the pending queue is untouched."""
        self.cache = KVCache.create(self.cfg, self.B, self.S, self.cache_dtype, self.device)
        if self.spec:
            self.draft_cache = KVCache.create(self.draft_cfg, self.B, self.S, self.cache_dtype,
                                              self.device)
        self._reset_slot_state()
        self.sessions.clear()
        self.pinned.clear()

    def _free_slot(self, exclude=()) -> Optional[int]:
        """An idle unpinned slot, else evict the LRU pinned session.
        `exclude`: slots already claimed by a deferred (batched)
        admission this step."""
        for slot in range(self.B):
            if (self.slots[slot] is None and slot not in self.pinned
                    and slot not in exclude):
                return slot
        lru = None
        for slot, sid in self.pinned.items():
            if self.slots[slot] is None:
                sess = self.sessions.get(sid)
                t = sess.last_used if sess else 0.0
                if lru is None or t < lru[1]:
                    lru = (slot, t, sid)
        if lru is None:
            return None
        self.pinned.pop(lru[0], None)
        self.sessions.pop(lru[2], None)
        return lru[0]

    # ------------------------------------------------------------------

    def step(self):
        """Admit what fits, then run one decode chunk."""
        # Scan the whole queue: a request whose session slot is busy must
        # not starve unrelated work behind it.  Skipped requests keep
        # their order.
        deferred = []
        batch: list = []  # deferred plain admissions (slot, req, Tb)
        claimed: set = set()
        while self.pending:
            req = self.pending.popleft()
            sess = self.sessions.get(req.session) if req.session else None
            if sess is not None:
                if self.slots[sess.slot] is not None or sess.slot in claimed:
                    deferred.append(req)  # session busy; don't block others
                    continue
                self._continue_one(sess.slot, req, sess)
                continue
            slot = self._free_slot(exclude=claimed)
            if slot is None:
                deferred.append(req)
                continue  # later session continuations may still admit
            claimed.add(slot)
            batch.append((slot, req, _bucket(len(req.prompt), self.buckets)))
        for req in reversed(deferred):
            self.pending.appendleft(req)
        if batch:
            batch.sort(key=lambda e: e[2])
            for _, grp in itertools.groupby(batch, key=lambda e: e[2]):
                self._admit_batch(list(grp))
        if self.n_active == 0:
            return
        if self.spec:
            self._spec_round()
            return

        (self.cache, toks, self.offsets, self.last_n, self.done,
         self.counters) = self._decode(
            self.params, self.cache, self.last_tok, self.offsets,
            self.last_n, self.done, self.sp, self.counters,
        )
        self.last_tok = toks[:, -1]
        toks_host = toks.tolist()  # the chunk's one host transfer
        for slot in range(self.B):
            if self.slots[slot] is None:
                continue
            for t in toks_host[slot]:
                if not self._deliver(slot, int(t)):
                    break

    def _spec_round(self):
        """One speculative round over every slot; each live slot receives
        its n_new committed tokens (one host transfer)."""
        if any(self._slot_sampled[s] for s in range(self.B) if self.slots[s] is not None):
            (self.draft_cache, self.cache, out, n_new, self.offsets, self.done, self.last_tok,
             self.last_n, self.counters) = self._spec_step_sampled(
                self.draft_params, self.params, self.draft_cache, self.cache, self.last_tok,
                self.offsets, self.done, self.last_n, self.sp, self.counters)
        else:
            (self.draft_cache, self.cache, out, n_new, self.offsets, self.done,
             self.last_tok) = self._spec_step(
                self.draft_params, self.params, self.draft_cache, self.cache, self.last_tok,
                self.offsets, self.done)
        rows = torch.cat([n_new[:, None], out], dim=1).tolist()
        for slot, (n, *toks) in enumerate(rows):
            if self.slots[slot] is None:
                continue
            for t in toks[:n]:
                if not self._deliver(slot, int(t)):
                    break

    def run(self):
        """Run until all submitted work is complete."""
        while self.has_work:
            self.step()

    def generate_many(self, prompts: Sequence[Sequence[int]],
                      max_new_tokens: int = 256) -> List[Request]:
        reqs = [Request(prompt=list(p), max_new_tokens=max_new_tokens)
                for p in prompts]
        for r in reqs:
            self.submit(r)
        self.run()
        return reqs
