"""Lockstep serving over the ranks of a tensor-parallel group.

Counterpart of tokenhawk_tpu/parallel/multihost_serving.py.  A server at
--tp N is N processes (parallel/multihost.py), each with a scheduler
(runtime/scheduler.py, runtime/paged_scheduler.py) over its shard; every
rank must run the same forwards in the same order, so every rank must
take the same control decisions.  Everything a scheduler decides from
device results already agrees (every rank samples the same gathered
logits); the only other inputs are external: which requests arrive, in
what order, and which are cancelled.  Rank 0, the coordinator, owns the
external world (the HTTP frontend, its queue, cancellations) and
broadcasts a control packet each step; the other ranks replay it into
their own scheduler and step in lockstep.

A packet goes over the group in two phases, its length and then its
bytes, each a tensor on the group's device (NCCL carries only CUDA
tensors): the same collectives as the model, no side channel.
`LockstepScheduler` puts the coordinator's driver behind the scheduler
interface serving/server.py's ServingLoop drives; every call of that
interface that changes scheduler state (submit, cancel, a session's
reset) travels in the packets, so it reaches every rank in the same
place.

Failures end the group.  A round that raises on one rank may leave the
ranks waiting in different collectives, so no rank steps on after one:
the coordinator fails its requests and its server exits 1, a follower's
`follow` returns 1, and the launcher (torchrun) stops the other ranks
when one exits with an error.  While the server is idle the coordinator
sends an empty round every KEEPALIVE_S seconds, so that no follower
waits in a broadcast past the group's collective timeout
(parallel/multihost.py GROUP_TIMEOUT).
"""

from __future__ import annotations

import base64
import json
import sys
import time
import traceback
from typing import Callable, List, Optional

import torch
import torch.distributed as dist

from tokenhawk_tpu_torch.config import SamplingConfig
from tokenhawk_tpu_torch.parallel.mesh import TpMesh
from tokenhawk_tpu_torch.runtime.scheduler import Request

# Seconds between the idle coordinator's empty rounds: well inside the
# group's collective timeout (parallel/multihost.py GROUP_TIMEOUT).
KEEPALIVE_S = 60.0


def group_broadcast(mesh: TpMesh, device) -> Callable[[Optional[bytes]], bytes]:
    """A broadcast of packets from the group's rank 0 over `mesh`'s group:
    the length, then the bytes, as tensors on `device`."""
    src = dist.get_global_rank(mesh.group, 0)

    def broadcast(payload: Optional[bytes]) -> bytes:
        data = payload or b""
        n = torch.tensor([len(data)], dtype=torch.int64, device=device)
        dist.broadcast(n, src, group=mesh.group)
        size = int(n.item())
        if size == 0:
            return b""
        if mesh.index == 0:
            buf = torch.frombuffer(bytearray(data), dtype=torch.uint8).to(device)
        else:
            buf = torch.empty((size,), dtype=torch.uint8, device=device)
        dist.broadcast(buf, src, group=mesh.group)
        return buf.cpu().numpy().tobytes()

    return broadcast


def encode_packet(reqs: List[Request], cancels: List[int], stop: bool = False,
                  resets: Optional[List[str]] = None) -> bytes:
    """Admissions + cancellations + session resets + loop control ->
    deterministic wire bytes (the reference's, byte for byte, for a
    packet without resets).

    Everything a scheduler takes control decisions from travels here:
    prompt, budget, sampling, stop sequences (they retire slots), the
    session id (it pins slots) and the sessions reset (they unpin
    slots).  Callbacks and detok do not: callbacks are external
    effects, and detok is a function of the model file that every rank
    builds for itself (the driver's `detok`)."""
    def sp(r):
        if r.sampling is None:
            return None
        s = r.sampling
        return [s.temperature, s.top_k, s.top_p, s.repeat_penalty, s.repeat_last_n, s.seed]

    packet = {
        "reqs": [
            [list(r.prompt), r.max_new_tokens, sp(r),
             [base64.b64encode(s).decode() for s in r.stop] if r.stop else None,
             r.session]
            for r in reqs
        ],
        "cancel": list(cancels),
        "stop": bool(stop),
    }
    if resets:
        packet["reset"] = list(resets)
    return json.dumps(packet).encode()


def decode_packet(data: bytes):
    """-> (requests, cancelled replay ids, stop): the reference's fields."""
    return _decode(data)[:3]


def _decode(data: bytes):
    if not data:
        return [], [], False, []
    obj = json.loads(data.decode())
    reqs = []
    for prompt, mnt, sp, stop_seqs, session in obj["reqs"]:
        sampling = None
        if sp is not None:
            sampling = SamplingConfig(temperature=sp[0], top_k=int(sp[1]), top_p=sp[2],
                                      repeat_penalty=sp[3], repeat_last_n=int(sp[4]),
                                      seed=int(sp[5]))
        reqs.append(Request(prompt=prompt, max_new_tokens=mnt, sampling=sampling,
                            stop=[base64.b64decode(s) for s in stop_seqs]
                            if stop_seqs is not None else None,
                            session=session))
    return (reqs, obj["cancel"], obj.get("stop", False),
            obj.get("reset", []))


class MultihostServingDriver:
    """Lockstep scheduler driver for one rank.

    Coordinator (rank 0): `submit()` externally arriving requests (they
    queue here, not in the scheduler), then `step()` in a loop.  Followers:
    their own scheduler over their shard, `step()` in the same loop;
    admissions arrive in the broadcast.  Callbacks fire with data on the
    coordinator's request objects only; the followers compute the same
    tokens and drop them.  `broadcast` defaults to group_broadcast over
    the scheduler's mesh."""

    def __init__(self, sched, is_coordinator: Optional[bool] = None,
                 broadcast: Optional[Callable[[Optional[bytes]], bytes]] = None,
                 detok: Optional[Callable[[int], bytes]] = None):
        self.sched = sched
        mesh = getattr(sched, "mesh", None)
        if is_coordinator is None:
            is_coordinator = mesh is None or mesh.index == 0
        if broadcast is None:
            broadcast = (group_broadcast(mesh, sched.device) if mesh is not None
                         else lambda payload: payload or b"")
        self.is_coordinator = is_coordinator
        self._bcast = broadcast
        # Stop-sequence retirement is a control decision: every rank runs
        # the same detok, its own, built from the shared model file.
        self._detok = detok
        self._queue: List[Request] = []
        self._cancels: List[int] = []
        self._resets: List[str] = []
        self.last_round = time.monotonic()
        # replay_id -> Request, in replay order on every rank, so that a
        # coordinator cancel(replay_id) names the same request everywhere
        # (the schedulers cancel by object identity).
        self._replay: dict = {}
        self._next_replay_id = 0

    # -- coordinator-side external API ----------------------------------

    def submit(self, req: Request) -> int:
        """Queue a request; returns its replay id (for cancel()).  Replay
        ids follow queue order, which is packet order, which is the
        followers' submit order: the same numbering everywhere."""
        if not self.is_coordinator:
            raise RuntimeError("submit() is coordinator-only; followers receive "
                               "admissions in the broadcast")
        if req.stop and req.detok is None:
            req.detok = self._detok
        if req.stop and req.detok is None:
            raise ValueError("request has stop sequences but no detok: stop matching is a "
                             "control decision and would never fire (pass detok on the "
                             "request or to the driver)")
        rid = self._next_replay_id
        self._next_replay_id += 1
        self._replay[rid] = req
        self._queue.append(req)
        return rid

    def cancel(self, replay_id: int) -> None:
        if not self.is_coordinator:
            raise RuntimeError("cancel() is coordinator-only")
        self._cancels.append(replay_id)

    def reset_session(self, sid: str) -> None:
        """Forget a session's state: here at once (the server reads the
        sessions when it tokenizes the next message), on the followers at
        the next round, before its admissions.  Either way before the
        next step, which is where a scheduler admits what was submitted,
        so the order against this round's submissions does not matter."""
        if not self.is_coordinator:
            raise RuntimeError("reset_session() is coordinator-only")
        self.sched.reset_session(sid)
        self._resets.append(sid)

    def replay_id(self, req: Request) -> Optional[int]:
        """The replay id of a live submitted request, or None."""
        for rid, r in self._replay.items():
            if r is req:
                return rid
        return None

    # -- lockstep loop ----------------------------------------------------

    def step(self, stop: bool = False) -> bool:
        """One control round: broadcast the external decisions, replay
        them into the local scheduler, advance it one step.  Returns False
        after a stop round (which steps nothing), else True.  Every control
        decision, loop termination included, is the coordinator's and
        travels in the packet."""
        if self.is_coordinator:
            packet = encode_packet(self._queue, self._cancels, stop=stop, resets=self._resets)
            pending, self._queue = self._queue, []
            self._cancels, self._resets = [], []
        else:
            packet, pending = None, []
        reqs, cancels, stopped, resets = _decode(self._bcast(packet))
        self.last_round = time.monotonic()
        if stopped:
            return False
        if self.is_coordinator:
            # The coordinator's own objects (callbacks and all); the packet
            # is what the followers rebuild from.
            reqs = pending
        else:
            for sid in resets:
                self.sched.reset_session(sid)
            for r in reqs:
                if r.stop:
                    if self._detok is None:
                        raise RuntimeError("packet request carries stop sequences but this "
                                           "follower has no detok: stop matching would "
                                           "diverge from the coordinator")
                    r.detok = self._detok
                rid = self._next_replay_id
                self._next_replay_id += 1
                self._replay[rid] = r
        for r in reqs:
            self.sched.submit(r)
        for rid in cancels:
            # An id of a request already finished resolves but no-ops.
            req = self._replay.get(rid)
            if req is not None and hasattr(self.sched, "cancel"):
                self.sched.cancel(req)
        self.sched.step()
        # Drop finished requests, so that long-lived serving holds none.
        if self._replay:
            self._replay = {i: r for i, r in self._replay.items() if r.done_at is None}
        return True

    @property
    def has_work(self) -> bool:
        """The coordinator's view (its queue and scheduler); followers obey
        the packets instead."""
        return bool(self._queue or self._resets) or self.sched.has_work

    def run(self) -> None:
        """Drain to idle in lockstep.  Coordinator: rounds while it has
        work, then one stop round.  Follower: rounds until the stop packet."""
        if self.is_coordinator:
            while self.has_work:
                self.step()
            self.step(stop=True)
        else:
            while self.step():
                pass


class LockstepScheduler:
    """The coordinator's driver behind the scheduler interface that
    serving/server.py's ServingLoop drives.  Submissions, cancellations
    and session resets go into the next packet and each step is one
    lockstep round; the rest of the interface reads the local scheduler.
    While idle, `has_work` turns true once KEEPALIVE_S has passed without
    a round, so the loop's next step is the empty keep-alive round.  A
    round that raises ends the group (the module's docstring): it fails
    every request (`fail_all`), calls `on_fatal` (the server's shutdown)
    and re-raises for the loop to count; `slots` then holds nothing for
    the loop to retire on this rank alone, `has_work` stays false and
    later submissions fail at once.  `shutdown()` sends the stop round
    that ends the followers' `run()`."""

    def __init__(self, driver: MultihostServingDriver):
        if not driver.is_coordinator:
            raise ValueError("LockstepScheduler wraps the coordinator's driver")
        self.driver = driver
        self.failed: Optional[BaseException] = None
        self.on_fatal: Optional[Callable[[], None]] = None

    # -- reads of the local scheduler ---------------------------------------

    @property
    def n_active(self) -> int:
        return self.driver.sched.n_active

    @property
    def pending(self) -> list:
        """What waits for a slot: the next packet's and the scheduler's."""
        return [*self.driver._queue, *self.driver.sched.pending]

    @property
    def sessions(self) -> dict:
        return getattr(self.driver.sched, "sessions", {})

    @property
    def native_sessions(self) -> bool:
        return getattr(self.driver.sched, "native_sessions", True)

    @property
    def prefix_hits(self) -> int:
        return getattr(self.driver.sched, "prefix_hits", 0)

    @property
    def slots(self) -> list:
        """Nothing for ServingLoop's recovery to retire: the round that
        raised failed every request already."""
        return []

    @property
    def has_work(self) -> bool:
        keepalive_due = time.monotonic() - self.driver.last_round >= KEEPALIVE_S
        return self.failed is None and (self.driver.has_work or keepalive_due)

    # -- state changes, through the packets ---------------------------------

    def submit(self, req: Request) -> Optional[int]:
        if self.failed is not None:
            _finish(req, f"error:{type(self.failed).__name__}")
            return None
        return self.driver.submit(req)

    def cancel(self, req: Request, reason: str = "cancelled") -> bool:
        rid = self.driver.replay_id(req)
        if rid is None or self.failed is not None:
            return False
        self.driver.cancel(rid)
        return True

    def reset_session(self, sid: str) -> None:
        if self.failed is None:
            self.driver.reset_session(sid)

    def step(self):
        if self.failed is not None:
            raise RuntimeError("the tensor-parallel group failed in an earlier round"
                               ) from self.failed
        try:
            self.driver.step()
        except BaseException as e:
            self.failed = e
            self.fail_all(f"error:{type(e).__name__}")
            if self.on_fatal is not None:
                self.on_fatal()
            raise

    def fail_all(self, reason: str) -> None:
        """After a failed round: finish every request this rank holds with
        `reason` (their callbacks fire): active, chunking, waiting, not yet
        sent, or lost in the admission that raised."""
        sched = self.driver.sched
        for slot, req in enumerate(sched.slots):
            if req is not None:
                sched._retire(slot, reason)
        for c in list(getattr(sched, "chunking", [])):
            if c is not None:
                sched.cancel(c[0], reason)
        for req in list(sched.pending):
            sched.cancel(req, reason)
        self.driver._queue = []
        live, self.driver._replay = self.driver._replay, {}
        for req in live.values():
            if req.done_at is None:
                _finish(req, reason)

    def shutdown(self):
        """The stop round, unless the group already failed."""
        if self.failed is None:
            self.driver.step(stop=True)


def _finish(req: Request, reason: str) -> None:
    req.finish_reason = reason
    req.done_at = time.perf_counter()
    if req.on_done:
        req.on_done(req)


def follow(driver: MultihostServingDriver) -> int:
    """A follower's serving loop: replay rounds until the coordinator's
    stop round (0).  A round that raises ends this rank (1, the traceback
    on stderr): the ranks may wait in different collectives, so the group
    cannot go on, and the launcher stops the others."""
    try:
        driver.run()
    except Exception:
        traceback.print_exc(file=sys.stderr)
        return 1
    return 0
