"""Continuous batching over a paged KV pool.

Counterpart of tokenhawk_tpu/runtime/paged_scheduler.py (bf16/f32 or
int8 pages, one device).  Same discipline as the dense Scheduler (slot
pool, batched admissions, chunked decode, EOS latching), but KV lives in
a shared page pool (runtime/paged.py): admission allocates the prompt's
pages, each decode chunk tops slots up, retirement returns pages to the
free list.

  - Free and retired slots' table rows point at a reserved trash page, so
    their (masked, EOS-latched) decode writes cannot touch a live page;
    mid-chunking slots decode through trash rows too (_masked_table).
  - Chunked prefill: prompts longer than `prefill_chunk` admit in
    page-aligned chunks, one per step while other slots decode.
  - Prefix cache: full prompt pages register under a content hash and
    later prompts that share the prefix reuse them (refcounted, LRU
    eviction of idle pages under pool pressure); same-step requests that
    share a cold prefix admit one leader alone first.
  - A request that can never fit fails with `oom_pages` instead of
    spinning; starved chunking slots give up the largest one first.
  - One host transfer per decode chunk: the sampled ids.
  - With a draft model (bf16/f32 pages only) every step is one
    speculative round (runtime/speculative.py): the draft keeps a dense
    per-slot cache, prefilled with the whole prompt at activation, and
    the target verifies its gamma tokens with forward_paged_verify at
    each slot's frontier, over the table cut to the live pages.
  - With `mesh` (parallel/mesh.py make_mesh): tensor parallelism
    (parallel/tp_paged.py).  Every rank of the model group runs the same
    scheduler over its shard of the parameters and a pool of its KV heads
    (int8 pages' scale pages with them); page tables, lengths and token
    ids are the same on every rank, and so is every control decision
    (parallel/multihost_serving.py replays the coordinator's).
"""

from __future__ import annotations

import hashlib
import itertools
import time
from collections import OrderedDict, deque
from typing import Deque, List, Optional

import numpy as np
import torch

from tokenhawk_tpu_torch.config import LlamaConfig, SamplingConfig
from tokenhawk_tpu_torch.models.llama import (
    KVCache,
    LlamaParams,
    forward_paged_decode,
    forward_paged_prefill,
    forward_paged_prefill_cont,
    logits_from_hidden,
)
from tokenhawk_tpu_torch.runtime import speculative
from tokenhawk_tpu_torch.runtime.engine import _bucket, last_rows, prefill_buckets
from tokenhawk_tpu_torch.runtime.paged import PageAllocator, PagedKVCache
from tokenhawk_tpu_torch.runtime.scheduler import (
    Request,
    admit_state,
    make_rings,
    to_device,
    tp_mesh,
)
from tokenhawk_tpu_torch.sampling import SamplingParams, normalize_eos, sample_dynamic
from tokenhawk_tpu_torch.sampling import is_eos as _is_eos
from tokenhawk_tpu_torch.tokenizer import EOS_ID


def make_paged_decode_fn_dynamic(cfg: LlamaConfig, chunk: int, eos_id: int = EOS_ID, tp=None):
    """fn decoding `chunk` tokens over the pool with per-slot sampling:
    (params, cache, table [B,mp] i32, last_tok [B], lengths [B] i32,
     last_n [B,N], done [B], sp, counters [B])
      -> (cache, tokens [B,chunk], done, counters, last_n).
    `tp` (every make_paged_*): this rank's shard (parallel/tp_paged.py)."""
    eos0, eos_ids = normalize_eos(eos_id)

    @torch.no_grad()
    def decode(params, cache, table, last_tok, lengths, last_n, done, sp, counters):
        toks = []
        tok = last_tok
        for _ in range(chunk):
            h, cache = forward_paged_decode(cfg, params, tok[:, None], cache, table, lengths,
                                            tp)
            logits = logits_from_hidden(cfg, params, h[:, 0], tp)
            nxt = sample_dynamic(logits, sp, counters, last_n)
            nxt = torch.where(done, eos0, nxt)
            lengths = lengths + (~done).to(lengths.dtype)
            counters = counters + 1
            done = done | _is_eos(nxt, eos_ids)
            last_n = torch.cat([last_n[:, 1:], nxt[:, None]], dim=1)
            toks.append(nxt)
            tok = nxt
        return cache, torch.stack(toks, dim=1), done, counters, last_n

    return decode


def make_paged_prefill_fn(cfg: LlamaConfig, tp=None):
    """fn: (params, cache, tokens [B,Tb], lengths [B], table [B,mp]) ->
    (cache, last logits [B,V] f32): fresh prompts straight into pages."""

    @torch.no_grad()
    def prefill(params, cache, tokens, lengths, table):
        h, cache = forward_paged_prefill(cfg, params, tokens, cache, table, tp)
        return cache, logits_from_hidden(cfg, params, last_rows(h, lengths), tp)

    return prefill


def make_paged_prefill_cont_fn(cfg: LlamaConfig, tp=None):
    """fn: (params, cache, tokens [B,C], table [B,W], start [B], n_new [B])
    -> (cache, logits [B,V] f32 of each row's last real token): one chunk
    attends to the slot's pages so far and writes its own KV in place."""

    @torch.no_grad()
    def prefill_cont(params, cache, tokens, table, start, n_new):
        h, cache = forward_paged_prefill_cont(cfg, params, tokens, cache, table, start, n_new,
                                              tp)
        return cache, logits_from_hidden(cfg, params, last_rows(h, n_new), tp)

    return prefill_cont


class PagedScheduler:
    # No KV-pinned sessions; the serving loop replays conversation text
    # instead, and the prefix cache makes the replay prefill only the new
    # tokens (serving/server.py ServingLoop.submit_text).
    native_sessions = False

    def __init__(
        self,
        cfg: LlamaConfig,
        params: LlamaParams,
        sampling: SamplingConfig = SamplingConfig(),
        max_batch: int = 8,
        max_seq: Optional[int] = None,
        page_size: int = 128,
        n_pages: Optional[int] = None,
        cache_dtype=torch.bfloat16,
        decode_chunk: int = 8,
        eos_id: int = EOS_ID,
        prefill_chunk: Optional[int] = None,
        prefix_cache: bool = False,
        draft_cfg: Optional[LlamaConfig] = None,
        draft_params: Optional[LlamaParams] = None,
        mesh=None,
        layout: str = "contig",
        gamma: int = 4,
    ):
        """prefill_chunk: admit prompts longer than this in page-aligned
        chunks interleaved with decode steps (a multiple of page_size;
        None = single-shot admission).  prefix_cache: reuse full prompt
        pages across requests.  layout: the pool's physical layout,
        "contig" (page-major) or "head" (head-major).  cache_dtype "int8"
        makes int8 pages with per-token scales (runtime/paged.py).
        draft_cfg / draft_params: speculative serving, gamma draft tokens
        per round."""
        self.mesh, self.cache_cfg = tp_mesh(mesh, cfg)
        if prefill_chunk is not None and prefill_chunk % page_size:
            raise ValueError("prefill_chunk must be a page_size multiple")
        self.cfg = cfg
        self.params = params
        self.device = params.device
        self.sampling = sampling
        self.B = max_batch
        self.S = max_seq or cfg.n_ctx
        self.ps = page_size
        self.eos_id, self.eos_ids = normalize_eos(eos_id)
        eos_id = self.eos_ids if len(self.eos_ids) > 1 else self.eos_id
        self.decode_chunk = decode_chunk
        self.max_pages = -(-self.S // page_size)
        if n_pages is None:
            # Default: full occupancy for half the slots + 1 trash page.
            n_pages = self.B * self.max_pages // 2 + 2
        self.n_pages = n_pages
        self.cache_dtype = cache_dtype
        self.layout = layout
        self._prefill = make_paged_prefill_fn(cfg, tp=mesh)
        self._decode = make_paged_decode_fn_dynamic(cfg, decode_chunk, eos_id, tp=mesh)
        self._prefill_cont = make_paged_prefill_cont_fn(cfg, tp=mesh)
        self.cache = PagedKVCache.create(self.cache_cfg, n_pages, page_size, cache_dtype,
                                         self.device, layout)
        self.spec = draft_params is not None
        self.gamma = gamma
        if self.spec:
            speculative.check_draft(draft_cfg, cfg)
            if cache_dtype == "int8":
                raise ValueError("speculative serving needs bf16 pages")
            self.draft_cfg, self.draft_params = draft_cfg, draft_params
            self.draft_cache = KVCache.create(draft_cfg, self.B, self.S, cache_dtype,
                                              self.device)
            # Under a mesh the draft is whole on every rank.
            self._spec_step = speculative.make_spec_serving_fn_paged(draft_cfg, cfg, gamma,
                                                                     eos_id, tp=mesh)
            self._spec_step_sampled = speculative.make_spec_serving_fn_paged_sampled(
                draft_cfg, cfg, gamma, eos_id, tp=mesh)
            self._slot_sampled = [False] * self.B
        self.prefill_chunk = prefill_chunk
        self.prefix_cache_enabled = prefix_cache
        self.prefix_hits = 0  # pages reused across requests (stats)
        self.n_ring = max(sampling.repeat_last_n, 1)
        self._reset_pool_state()
        self._reset_slot_state()

        self.pending: Deque[Request] = deque()
        self.finished: List[Request] = []
        self._ids = itertools.count()
        # First-page keys shared by >= 2 pending requests this step (the
        # cold-leader rule in _admit_one); refreshed by step().
        self._hot_prefixes: set = set()
        self.buckets = prefill_buckets(self.S)

    def _reset_pool_state(self):
        self.alloc = PageAllocator(self.n_pages)
        self.trash_page = self.alloc.alloc(1)[0]
        self.table = np.full((self.B, self.max_pages), self.trash_page, np.int32)
        self.slot_pages: List[List[int]] = [[] for _ in range(self.B)]
        self.lengths = np.zeros((self.B,), np.int32)
        # Mid-admission long prompts: slot -> (request, tokens prefilled).
        self.chunking: List[Optional[tuple]] = [None] * self.B
        # Prefix cache: content hash -> page id.  page_refs counts live
        # users; refcount-0 entries stay cached until evicted LRU.
        self._pc: "OrderedDict[bytes, int]" = OrderedDict()
        self.page_refs: dict = {}
        self.page_key: dict = {}
        self.slot_shared: List[set] = [set() for _ in range(self.B)]

    def _reset_slot_state(self):
        dev = self.device
        self.last_tok = torch.zeros((self.B,), dtype=torch.int64, device=dev)
        self.last_n = torch.full((self.B, self.n_ring), -1, dtype=torch.int64, device=dev)
        self.done = torch.ones((self.B,), dtype=torch.bool, device=dev)
        self.sp = SamplingParams.broadcast(self.sampling, self.B, dev)
        self.counters = torch.zeros((self.B,), dtype=torch.int64, device=dev)
        self.slots: List[Optional[Request]] = [None] * self.B

    # ------------------------------------------------------------------

    def _finish(self, req: Request, reason: str):
        req.finish_reason = reason
        req.done_at = time.perf_counter()
        self.finished.append(req)
        req.flush_text()
        if req.on_done:
            req.on_done(req)

    def submit(self, req: Request) -> int:
        req.id = next(self._ids)
        req.submitted_at = time.perf_counter()
        if req.max_new_tokens <= 0:
            req.finish_reason = "length"
            req.done_at = req.submitted_at
            self.finished.append(req)
            if req.on_done:
                req.on_done(req)
            return req.id
        if len(req.prompt) >= self.S:
            self._finish(req, "error:prompt_too_long")
            return req.id
        self.pending.append(req)
        return req.id

    @property
    def n_active(self) -> int:
        return sum(s is not None for s in self.slots)

    @property
    def n_chunking(self) -> int:
        return sum(c is not None for c in self.chunking)

    @property
    def has_work(self) -> bool:
        return self.n_active > 0 or self.n_chunking > 0 or len(self.pending) > 0

    # -- automatic prefix cache ----------------------------------------

    def _prefix_keys(self, prompt, n_pages: int):
        """Content keys for the first n_pages full pages, hashed
        incrementally (one digest per page over the growing prefix)."""
        h = hashlib.blake2b(digest_size=16)
        keys = []
        toks = np.asarray(prompt, np.int32)
        for p in range(n_pages):
            h.update(toks[p * self.ps : (p + 1) * self.ps].tobytes())
            keys.append(h.copy().digest())
        return keys

    def _alloc_pages(self, k: int):
        """Allocate k pages, evicting idle cached prefix pages LRU if the
        pool is dry.  Raises MemoryError if even eviction cannot."""
        try:
            return self.alloc.alloc(k)
        except MemoryError:
            for key in list(self._pc):
                page = self._pc[key]
                if self.page_refs.get(page, 0) <= 0:
                    del self._pc[key]
                    self.page_key.pop(page, None)
                    self.page_refs.pop(page, None)
                    self.alloc.free([page])
                    if self.alloc.n_free >= k:
                        break
            return self.alloc.alloc(k)

    def _table_width(self, n_tokens: int) -> int:
        """Power-of-two page count covering n_tokens (capped at
        max_pages): a continuation chunk gathers this many pages per
        layer, so its cost follows the live history, not max_seq."""
        need = -(-n_tokens // self.ps)
        n = 1
        while n < need:
            n *= 2
        return min(n, self.max_pages)

    def _reuse_prefix(self, slot: int, prompt) -> int:
        """Point the slot's leading table entries at cached pages shared
        with earlier prompts.  Returns tokens covered; stops at the page
        before the prompt's last token (one suffix token must run)."""
        if not self.prefix_cache_enabled:
            return 0
        keys = self._prefix_keys(prompt, (len(prompt) - 1) // self.ps)
        n = 0
        for key in keys:
            page = self._pc.get(key)
            if page is None:
                break
            self.table[slot, n] = page
            self.slot_pages[slot].append(page)
            self.slot_shared[slot].add(n)
            self.page_refs[page] = self.page_refs.get(page, 0) + 1
            self._pc.move_to_end(key)
            self.prefix_hits += 1
            n += 1
        return n * self.ps

    def _register_prompt_pages(self, slot: int, prompt):
        """Publish this slot's full prompt pages into the prefix cache
        (first writer wins)."""
        if not self.prefix_cache_enabled:
            return
        max_reg = (len(prompt) - 1) // self.ps
        keys = self._prefix_keys(prompt, max_reg)
        for pidx in range(max_reg):
            if pidx in self.slot_shared[slot] or keys[pidx] in self._pc:
                continue
            page = int(self.table[slot, pidx])
            self._pc[keys[pidx]] = page
            self.page_key[page] = keys[pidx]
            self.page_refs[page] = self.page_refs.get(page, 0) + 1
            self.slot_shared[slot].add(pidx)

    def _release_slot_pages(self, slot: int):
        """Retirement/cancel: decref shared pages (they stay cached at
        refcount 0 for reuse), free private ones."""
        for i, page in enumerate(self.slot_pages[slot]):
            if i in self.slot_shared[slot]:
                self.page_refs[page] = self.page_refs.get(page, 1) - 1
            else:
                self.alloc.free([page])
        self.slot_pages[slot] = []
        self.slot_shared[slot] = set()
        self.table[slot, :] = self.trash_page

    def _ensure_pages(self, slot: int, need_tokens: int) -> bool:
        """Grow the slot's page list to cover need_tokens; False if OOM."""
        need = -(-need_tokens // self.ps)
        have = len(self.slot_pages[slot])
        if need > self.max_pages:
            return False
        if need > have:
            try:
                new = self._alloc_pages(need - have)
            except MemoryError:
                return False
            self.table[slot, have:need] = new
            self.slot_pages[slot].extend(new)
        return True

    # -- admission -----------------------------------------------------

    def _admit_one(self, slot: int, req: Request, batch: list) -> bool:
        """Admit req into slot.  Plain and cached-prefix admissions only
        reserve pages and append to `batch` for one padded prefill per
        group; a long prompt starts chunking; a cold prompt whose first
        page another pending request shares admits alone right now, so
        its pages register before the followers look them up."""
        prompt = req.prompt
        reused = self._reuse_prefix(slot, prompt)  # tokens from the cache
        remaining = len(prompt) - reused
        if self.prefill_chunk is not None and remaining > self.prefill_chunk:
            if not self._ensure_pages(slot, reused + min(remaining, self.prefill_chunk)):
                self._release_slot_pages(slot)
                return False
            self.chunking[slot] = (req, reused)
            return True
        if reused:
            # Cached prefix: prefill only the suffix (continuation path,
            # page-aligned start).
            if not self._ensure_pages(slot, len(prompt)):
                self._release_slot_pages(slot)
                return False
            batch.append(("cont", slot, req, reused, -(-remaining // self.ps) * self.ps))
            return True
        Tb = _bucket(len(prompt), self.buckets)
        if not self._ensure_pages(slot, Tb):
            return False  # not enough pages right now
        cold_leader = (self.prefix_cache_enabled
                       and (len(prompt) - 1) // self.ps >= 1
                       and self._prefix_keys(prompt, 1)[0] in self._hot_prefixes)
        if not cold_leader:
            batch.append(("plain", slot, req, Tb))
            return True
        self._admit_batch([("plain", slot, req, Tb)])
        return True

    def _admit_batch(self, group: list):
        """One padded prefill for a same-bucket group of plain admissions.
        The row count pads to a power of two; padding rows carry zero
        lengths and all-trash tables, and their state update drops."""
        Tb = group[0][3]
        Nb = 1 << (len(group) - 1).bit_length()
        toks = np.zeros((Nb, Tb), np.int64)
        lengths = np.zeros((Nb,), np.int32)
        table = np.full((Nb, self.max_pages), self.trash_page, np.int32)
        for i, (_, slot, req, _Tb) in enumerate(group):
            toks[i, : len(req.prompt)] = req.prompt
            lengths[i] = len(req.prompt)
            table[i] = self.table[slot]
        dev = self.device
        self.cache, logits = self._prefill(self.params, self.cache, to_device(dev, toks),
                                           to_device(dev, lengths), to_device(dev, table))
        self._activate_many([(slot, req) for _, slot, req, _Tb in group], Nb, logits)

    def _prefill_cont_group(self, rows, Cb: int):
        """One padded prefill_cont over same-width continuation rows
        (slot, tokens, start): batched prefix-cache admissions and batched
        chunk advances.  Rows pad to a power of two and the table to the
        group's power-of-two page count; padding rows carry n_new 0 and
        all-trash tables.  Returns (Nb, logits [Nb, V])."""
        Nb = 1 << (len(rows) - 1).bit_length()
        W = max(self._table_width(start + Cb) for _, _, start in rows)
        toks = np.zeros((Nb, Cb), np.int64)
        starts = np.zeros((Nb,), np.int32)
        n_new = np.zeros((Nb,), np.int32)
        table = np.full((Nb, W), self.trash_page, np.int32)
        for i, (slot, row_toks, start) in enumerate(rows):
            toks[i, : len(row_toks)] = row_toks
            starts[i] = start
            n_new[i] = len(row_toks)
            table[i] = self.table[slot, :W]
        dev = self.device
        self.cache, logits = self._prefill_cont(
            self.params, self.cache, to_device(dev, toks), to_device(dev, table),
            to_device(dev, starts), to_device(dev, n_new))
        return Nb, logits

    def _admit_batch_cont(self, group: list):
        """Batched prefix-cache continuation admissions."""
        Nb, logits = self._prefill_cont_group(
            [(slot, req.prompt[reused:], reused) for _, slot, req, reused, _Cb in group],
            group[0][4])
        self._activate_many([(slot, req) for _, slot, req, _r, _Cb in group], Nb, logits)

    def _activate_many(self, rows: list, Nb: int, logits):
        """Sample the first tokens and write the slot state of an admitted
        group (logits [Nb, V]; rows is the live (slot, req) prefix)."""
        slots = np.full((Nb,), self.B, np.int64)
        slots[: len(rows)] = [slot for slot, _ in rows]
        rings = make_rings([req.prompt for _, req in rows], self.n_ring, Nb)
        slot_sp = SamplingParams.from_configs([req.sampling or self.sampling for _, req in rows],
                                              Nb, self.device)
        first = admit_state(logits, self.sp, self.counters, self.last_tok, self.last_n,
                            self.done, to_device(self.device, slots),
                            to_device(self.device, rings), slot_sp)
        if self.spec:
            speculative.draft_prefill(self.draft_cfg, self.draft_params, self.draft_cache,
                                      [(slot, req.prompt, 0) for slot, req in rows],
                                      self.buckets)
            for slot, req in rows:
                self._slot_sampled[slot] = (req.sampling or self.sampling).temperature > 0.0
        first_host = first.tolist()
        now = time.perf_counter()
        for i, (slot, req) in enumerate(rows):
            self._register_prompt_pages(slot, req.prompt)
            self.lengths[slot] = len(req.prompt)
            self.slots[slot] = req
            req.first_token_at = now
            self._deliver(slot, int(first_host[i]))

    def _fail_chunking(self, slot: int):
        req, _pos = self.chunking[slot]
        self.chunking[slot] = None
        self._release_slot_pages(slot)
        self._finish(req, "oom_pages")

    def _advance_chunking_batch(self):
        """Advance mid-admission prompts by one chunk each, one padded
        prefill_cont per chunk width.  While streams are live only one
        slot advances per step (the stall bound of chunked admission).
        Rows that complete their prompt sort to the front of their group
        so _activate_many takes the leading logits rows."""
        C = self.prefill_chunk
        rows = []  # (slot, req, pos, n_new, Cb, completes)
        for slot in range(self.B):
            if self.chunking[slot] is None:
                continue
            if rows and self.n_active > 0:
                break
            req, pos = self.chunking[slot]
            n_new = min(C, len(req.prompt) - pos)
            if not self._ensure_pages(slot, pos + n_new):
                # Transient shortage: retry next step while anything else
                # in flight could free pages.
                if self.n_active > 0 or self.n_chunking > 1 or rows:
                    continue
                self._fail_chunking(slot)
                continue
            # The last (short) chunk shrinks to a page multiple of the real
            # data so no pad-only page is ever written.
            Cb = C if n_new == C else -(-n_new // self.ps) * self.ps
            rows.append((slot, req, pos, n_new, Cb, pos + n_new >= len(req.prompt)))
        if not rows:
            # Every chunking slot is starved and nothing active can free
            # pages: fail the one with the largest total need.
            if self.n_active == 0 and self.n_chunking > 1:
                self._fail_chunking(max(
                    (s for s in range(self.B) if self.chunking[s] is not None),
                    key=lambda s: -(-len(self.chunking[s][0].prompt) // self.ps)))
            return
        rows.sort(key=lambda r: (r[4], not r[5]))
        for _, grp in itertools.groupby(rows, key=lambda r: r[4]):
            self._advance_chunk_group(list(grp))

    def _advance_chunk_group(self, group: list):
        """One padded prefill_cont advances a same-width group of chunks
        (different slots write disjoint pages)."""
        Nb, logits = self._prefill_cont_group(
            [(slot, req.prompt[pos : pos + n_new], pos)
             for slot, req, pos, n_new, _Cb, _done in group], group[0][4])
        completed = []
        for slot, req, pos, n_new, _Cb, done in group:
            if done:
                self.chunking[slot] = None
                completed.append((slot, req))
            else:
                self.chunking[slot] = (req, pos + n_new)
        if completed:
            self._activate_many(completed, Nb, logits)

    # -- decode --------------------------------------------------------

    def _deliver(self, slot: int, tok: int) -> bool:
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
        # writes a block of gamma+1 rows.
        margin = 1 + (self.gamma if self.spec else 0)
        if len(req.prompt) + len(req.output) >= self.S - margin:
            self._retire(slot, "context_full")
            return False
        return True

    def _retire(self, slot: int, reason: str):
        req = self.slots[slot]
        self.slots[slot] = None
        self.done[slot] = True
        self._release_slot_pages(slot)
        self.lengths[slot] = 0
        self._finish(req, reason)

    def _masked_table(self):
        """Table for decode: mid-chunking slots' rows point at the trash
        page so their done-masked writes cannot touch the pages being
        prefilled (shared prefix pages lie below every decode frontier)."""
        table = self.table
        if any(c is not None for c in self.chunking):
            table = table.copy()
            for slot, c in enumerate(self.chunking):
                if c is not None:
                    table[slot, :] = self.trash_page
        return table

    def step(self):
        if self.prefix_cache_enabled and len(self.pending) > 1:
            # First-page keys in >= 2 pending prompts get a solo leader
            # admission so followers reuse their pages (_admit_one).
            counts: dict = {}
            for req in self.pending:
                if (len(req.prompt) - 1) // self.ps >= 1:
                    k = self._prefix_keys(req.prompt, 1)[0]
                    counts[k] = counts.get(k, 0) + 1
            self._hot_prefixes = {k for k, c in counts.items() if c >= 2}
        else:
            self._hot_prefixes = set()
        batch: list = []  # deferred admissions
        for slot in range(self.B):
            if self.slots[slot] is None and self.chunking[slot] is None and self.pending:
                if not self._admit_one(slot, self.pending[0], batch):
                    if self.n_active == 0 and self.n_chunking == 0 and not batch:
                        # Nothing in flight can ever free capacity: the
                        # request is infeasible for this pool.
                        self._finish(self.pending.popleft(), "oom_pages")
                        continue
                    break  # page pool exhausted; decode to free capacity
                self.pending.popleft()
        # One padded prefill per (kind, token bucket).
        plains = sorted((e for e in batch if e[0] == "plain"), key=lambda e: e[3])
        for _, grp in itertools.groupby(plains, key=lambda e: e[3]):
            self._admit_batch(list(grp))
        conts = sorted((e for e in batch if e[0] == "cont"), key=lambda e: e[4])
        for _, grp in itertools.groupby(conts, key=lambda e: e[4]):
            self._admit_batch_cont(list(grp))
        if self.n_chunking:
            self._advance_chunking_batch()
        if self.n_active == 0:
            return

        # Top up pages so every live slot can absorb a full chunk (or a
        # speculative round's gamma+1 rows).
        grow = (self.gamma + 1 if self.spec else self.decode_chunk) + 1
        for slot in range(self.B):
            if self.slots[slot] is not None:
                if not self._ensure_pages(slot, int(self.lengths[slot]) + grow):
                    self._retire(slot, "oom_pages")
        if self.n_active == 0:
            return
        if self.spec:
            self._spec_round()
            return
        (self.cache, toks, self.done, self.counters, self.last_n) = self._decode(
            self.params, self.cache, to_device(self.device, self._masked_table()), self.last_tok,
            to_device(self.device, self.lengths), self.last_n, self.done, self.sp, self.counters)
        self.last_tok = toks[:, -1]
        toks_host = toks.tolist()  # the chunk's one host transfer
        for slot in range(self.B):
            if self.slots[slot] is None:
                continue
            n_emitted = 0
            for t in toks_host[slot]:
                n_emitted += 1
                if not self._deliver(slot, int(t)):
                    break
            self.lengths[slot] += n_emitted

    def _spec_round(self):
        """One speculative round over every slot.  The verify reads the
        table cut to the power-of-two page count that covers every slot's
        block (rows past it are masked in any case).  One host transfer:
        the committed ids and their counts."""
        W = self._table_width(int(self.lengths.max()) + self.gamma + 1)
        table = to_device(self.device, self._masked_table()[:, :W])
        lengths = to_device(self.device, self.lengths)
        if any(self._slot_sampled[s] for s in range(self.B) if self.slots[s] is not None):
            (self.draft_cache, self.cache, out, n_new, _, self.done, self.last_tok, self.last_n,
             self.counters) = self._spec_step_sampled(
                self.draft_params, self.params, self.draft_cache, self.cache, table,
                self.last_tok, lengths, self.done, self.last_n, self.sp, self.counters)
        else:
            (self.draft_cache, self.cache, out, n_new, _, self.done,
             self.last_tok) = self._spec_step(
                self.draft_params, self.params, self.draft_cache, self.cache, table,
                self.last_tok, lengths, self.done)
        rows = torch.cat([n_new[:, None], out], dim=1).tolist()
        self.lengths += np.array([row[0] for row in rows], np.int32)
        for slot, (n, *toks) in enumerate(rows):
            if self.slots[slot] is None:
                continue
            for t in toks[:n]:
                if not self._deliver(slot, int(t)):
                    break

    # -- serving surface (serving/server.py drives either scheduler) ----

    def cancel(self, req: Request, reason: str = "cancelled") -> bool:
        """Abort a request: drops it from the queue, frees its slot, or
        abandons a mid-chunking admission (pages returned to the pool)."""
        if req in self.pending:
            self.pending.remove(req)
            req.finish_reason = reason
            req.done_at = time.perf_counter()
            self.finished.append(req)
            if req.on_done:
                req.on_done(req)
            return True
        for slot, c in enumerate(self.chunking):
            if c is not None and c[0] is req:
                self.chunking[slot] = None
                self._release_slot_pages(slot)
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

    @property
    def sessions(self) -> dict:
        return {}  # multi-turn sessions live in the dense Scheduler

    def reset_session(self, sid: str) -> None:
        pass  # no session state to clear

    def reset_device_state(self):
        """Recovery path: rebuild the page pool and slot state from scratch
        after repeated step failures (callers retire the active slots
        first); the pending queue is untouched."""
        self.cache = PagedKVCache.create(self.cache_cfg, self.n_pages, self.ps, self.cache_dtype,
                                         self.device, self.layout)
        if self.spec:
            self.draft_cache = KVCache.create(self.draft_cfg, self.B, self.S, self.cache_dtype,
                                              self.device)
        self._reset_pool_state()
        self._reset_slot_state()

    def run(self):
        while self.has_work:
            self.step()

    def generate_many(self, prompts, max_new_tokens: int = 256) -> List[Request]:
        reqs = [Request(prompt=list(p), max_new_tokens=max_new_tokens) for p in prompts]
        for r in reqs:
            self.submit(r)
        self.run()
        return reqs
