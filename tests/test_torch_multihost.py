"""The port's lockstep multi-process serving (parallel/multihost_serving.py,
parallel/multihost.py) and its entry points under torchrun.

  - encode_packet writes the JAX package's bytes for the same requests,
    and decode_packet reads them back;
  - tests/test_multihost_serving.py's in-process fake transport pair over
    the port's PagedScheduler: a follower replaying the packets finishes
    with the coordinator's outputs, cancellations resolve through the
    replay map on both sides, stop sequences retire at the same step, and
    the coordinator-only calls refuse on a follower;
  - session resets travel in the packets, in their place among the
    submissions (the dense Scheduler pins a session's slot); the idle
    coordinator's keep-alive rounds; a failed round ends the server
    (every request fails, no rank-local recovery);
  - the packets over a gloo group of 2 spawned ranks, each with a TP
    PagedScheduler: rank 0's outputs equal the one-process scheduler's,
    and the follower's rank 0's; a follower whose round raises ends the
    group instead of leaving the coordinator waiting;
  - `torchrun --nproc-per-node 2 -m tokenhawk_tpu_torch.cli --tp 2` and
    `-m tokenhawk_tpu_torch.serving --tp 2` on the CPU give the greedy
    output of `--tp 1`: the paged server one request, the dense server a
    session, its reset and the next messages.
"""

import dataclasses
import json
import socket
import subprocess
import sys
import threading
import time
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

from tokenhawk_tpu.config import SamplingConfig as JSamplingConfig
from tokenhawk_tpu.parallel.multihost_serving import encode_packet as j_encode_packet
from tokenhawk_tpu.runtime.scheduler import Request as JRequest
from tokenhawk_tpu_torch.config import LlamaConfig, SamplingConfig
from tokenhawk_tpu_torch.models.llama import init_params
from tokenhawk_tpu_torch.parallel.multihost_serving import (
    KEEPALIVE_S,
    LockstepScheduler,
    MultihostServingDriver,
    decode_packet,
    encode_packet,
)
from tokenhawk_tpu_torch.runtime.paged_scheduler import PagedScheduler
from tokenhawk_tpu_torch.runtime.scheduler import Request, Scheduler
from tokenhawk_tpu_torch.serving.server import serve
from tokenhawk_tpu_torch.tokenizer import byte_fallback_vocab

from torch_dist import run_ranks
from torch_helpers import padded_vocab, subprocess_env
from torch_tp_workers import failing_follower_worker, lockstep_worker

ROOT = Path(__file__).resolve().parents[1]
CFG = LlamaConfig(n_vocab=97, n_embd=64, n_head=2, n_layer=2, n_ctx=96, n_ff=96)
TP_CFG = dataclasses.replace(CFG, n_vocab=96)  # tp 2 divides its vocabulary


def _params(cfg=CFG):
    return init_params(cfg, torch.Generator().manual_seed(3), dtype=torch.float32, device="cpu")


def _sched(params=None, cfg=CFG):
    return PagedScheduler(cfg, params or _params(cfg), sampling=SamplingConfig(temperature=0.0),
                          max_batch=2, max_seq=96, page_size=16, n_pages=24, decode_chunk=4,
                          cache_dtype=torch.float32)


class FakeTransport:
    """One-way packet queue standing in for the group broadcast."""

    def __init__(self):
        self.q = []

    def coordinator(self, payload):
        self.q.append(payload)
        return payload

    def follower(self, payload):
        assert payload is None
        return self.q.pop(0)


def _dense(params=None):
    return Scheduler(CFG, params or _params(), sampling=SamplingConfig(temperature=0.0),
                     max_batch=2, max_seq=96, decode_chunk=4, cache_dtype=torch.float32)


def _pair(make=_sched, transport=None, **kw):
    t = transport or FakeTransport()
    return (MultihostServingDriver(make(), is_coordinator=True, broadcast=t.coordinator, **kw),
            MultihostServingDriver(make(), is_coordinator=False, broadcast=t.follower, **kw))


def _lockstep(drv_c, drv_f, every_round=None):
    """Coordinator and follower rounds until the coordinator is idle, then
    the stop round; every_round(n) after the n-th round."""
    rounds = 0
    while drv_c.has_work:
        drv_c.step()
        assert drv_f.step()
        rounds += 1
        if every_round:
            every_round(rounds)
    drv_c.step(stop=True)
    assert drv_f.step() is False


def test_packets_are_the_reference_bytes():
    fields = [dict(prompt=[1, 2, 3], max_new_tokens=5),
              dict(prompt=[4], max_new_tokens=2, sampling=(0.7, 11, 0.9, 1.1, 32, 42)),
              dict(prompt=[9, 8], max_new_tokens=3, stop=[b"\x00raw\xff", b"END"],
                   session="chat-42")]

    def reqs(req_cls, sc_cls):
        out = []
        for f in fields:
            f = dict(f)
            if "sampling" in f:
                t, k, p, rp, n, s = f["sampling"]
                f["sampling"] = sc_cls(temperature=t, top_k=k, top_p=p, repeat_penalty=rp,
                                       repeat_last_n=n, seed=s)
            out.append(req_cls(**f))
        return out

    for cancels, stop in (([7], False), ([], True)):
        data = encode_packet(reqs(Request, SamplingConfig), cancels, stop)
        assert data == j_encode_packet(reqs(JRequest, JSamplingConfig), cancels, stop)
        out, got_cancels, got_stop = decode_packet(data)
        assert [r.prompt for r in out] == [f["prompt"] for f in fields]
        assert out[0].sampling is None and out[1].sampling.top_k == 11
        assert out[2].stop == [b"\x00raw\xff", b"END"] and out[2].session == "chat-42"
        assert (got_cancels, got_stop) == (cancels, stop)
    assert decode_packet(b"") == ([], [], False)
    # Session resets ride in a key of their own: a packet with them reads
    # back with the reference's fields unchanged.
    data = encode_packet(reqs(Request, SamplingConfig), [], resets=["a", "chat-42"])
    assert decode_packet(data)[1:] == ([], False)
    assert json.loads(data)["reset"] == ["a", "chat-42"]


def test_follower_reproduces_coordinator():
    drv_c, drv_f = _pair()
    rng = np.random.default_rng(0)
    r1 = Request(prompt=rng.integers(3, 90, 5).tolist(), max_new_tokens=8)
    r2 = Request(prompt=rng.integers(3, 90, 3).tolist(), max_new_tokens=5,
                 sampling=SamplingConfig(temperature=0.8, top_k=20, seed=9))
    drv_c.submit(r1)
    _lockstep(drv_c, drv_f, lambda rounds: rounds == 2 and drv_c.submit(r2))
    want = {tuple(r.prompt): r.output for r in drv_c.sched.finished}
    got = {tuple(r.prompt): r.output for r in drv_f.sched.finished}
    assert want == got and len(want) == 2
    assert r1.output and r2.output  # the coordinator's callbacks saw tokens


def test_cancel_resolves_through_replay_map_and_lockstep_scheduler():
    drv_c, drv_f = _pair()
    front = LockstepScheduler(drv_c)
    rng = np.random.default_rng(1)
    r1 = Request(prompt=rng.integers(3, 90, 4).tolist(), max_new_tokens=40)
    r2 = Request(prompt=rng.integers(3, 90, 4).tolist(), max_new_tokens=40)
    assert front.submit(r1) != front.submit(r2)
    assert front.has_work and front.n_active == 0  # queued in the driver, not yet admitted
    _lockstep(drv_c, drv_f, lambda rounds: rounds == 2 and front.cancel(r2))
    by_c = {tuple(r.prompt): r for r in drv_c.sched.finished}
    by_f = {tuple(r.prompt): r for r in drv_f.sched.finished}
    for by in (by_c, by_f):
        assert by[tuple(r2.prompt)].finish_reason == "cancelled"
        assert len(by[tuple(r2.prompt)].output) < 40
        assert by[tuple(r1.prompt)].finish_reason != "cancelled"
    for key in by_c:
        assert by_c[key].output == by_f[key].output
    assert not front.cancel(r1)  # finished: no replay id left
    with pytest.raises(ValueError):
        LockstepScheduler(drv_f)


def test_stop_sequence_parity_across_ranks():
    detok = lambda t: f"<{t}>".encode()  # noqa: E731
    drv_c, drv_f = _pair()
    probe = Request(prompt=[5, 6, 7], max_new_tokens=12)
    drv_c.submit(probe)
    _lockstep(drv_c, drv_f)
    assert len(probe.output) >= 4
    drv_c, drv_f = _pair(detok=detok)
    drv_c.submit(Request(prompt=[5, 6, 7], max_new_tokens=12, stop=[detok(probe.output[3])]))
    _lockstep(drv_c, drv_f)
    fin_c, fin_f = drv_c.sched.finished[-1], drv_f.sched.finished[-1]
    assert fin_c.finish_reason == fin_f.finish_reason == "stop"
    assert fin_c.output == fin_f.output and len(fin_c.output) < len(probe.output)


def _session_state(sched):
    return ({sid: (x.slot, x.n_past, list(x.tail), list(x.pending))
             for sid, x in sched.sessions.items()}, dict(sched.pinned))


def test_session_resets_reach_every_rank_in_their_place():
    """The dense Scheduler pins a session's slot: a reset must unpin it on
    every rank before the session's next message is admitted, or the
    ranks admit that message at different slots and offsets.  The
    coordinator's own scheduler forgets the session at once (the server
    reads its sessions when it tokenizes the next message)."""
    params = _params()
    drv_c, drv_f = _pair(lambda: _dense(params))
    front = LockstepScheduler(drv_c)
    rng = np.random.default_rng(4)
    turn = [Request(prompt=rng.integers(3, 90, n).tolist(), max_new_tokens=6, session="s")
            for n in (5, 4, 3)]
    other = Request(prompt=rng.integers(3, 90, 4).tolist(), max_new_tokens=5, session="t")
    front.submit(turn[0])
    _lockstep(drv_c, drv_f)
    front.submit(turn[1])  # a continuation of "s"
    _lockstep(drv_c, drv_f)
    front.submit(other)  # ahead of the reset: admitted after it, "t" pins
    front.reset_session("t")
    front.reset_session("s")
    assert "s" not in drv_c.sched.sessions and "s" in drv_f.sched.sessions
    assert front.has_work
    front.submit(turn[2])  # opens "s" again, from nothing
    _lockstep(drv_c, drv_f)
    assert _session_state(drv_c.sched) == _session_state(drv_f.sched)
    assert set(drv_c.sched.sessions) == {"s", "t"}
    assert [r.output for r in drv_c.sched.finished] == [r.output for r in drv_f.sched.finished]
    # The reopened session answers as a fresh scheduler does.
    fresh = _dense(params)
    again = Request(prompt=turn[2].prompt, max_new_tokens=6, session="s")
    fresh.submit(again)
    fresh.run()
    assert turn[2].output == again.output
    assert drv_c.sched.sessions["s"].n_past == fresh.sessions["s"].n_past


def test_idle_coordinator_sends_keepalive_rounds():
    """Idle, the server's scheduler reports work once a keep-alive is due,
    and the step that follows is one empty round, which the follower
    replays."""
    t = FakeTransport()
    drv_c, drv_f = _pair(transport=t)
    front = LockstepScheduler(drv_c)
    assert not front.has_work  # not due
    drv_c.last_round -= KEEPALIVE_S
    assert front.has_work and not drv_c.has_work
    front.step()
    assert len(t.q) == 1 and decode_packet(t.q[0]) == ([], [], False)
    assert drv_f.step() and not drv_f.sched.has_work  # an empty round, replayed


def test_failed_round_ends_the_lockstep_server():
    """A coordinator round that raises fails every request the server
    holds and stops the loop; nothing is retired or rebuilt on this rank
    alone, and later rounds refuse."""
    drv_c, _ = _pair(_dense)
    front = LockstepScheduler(drv_c)
    sched, calls = drv_c.sched, []
    real_step = sched.step

    def step():
        calls.append(1)
        if len(calls) == 2:
            raise RuntimeError("injected device fault")
        real_step()

    sched.step = step
    sched.reset_device_state = lambda: pytest.fail("rank-local rebuild under lockstep")
    httpd = serve(front, byte_fallback_vocab(), host="127.0.0.1", port=0)
    loop = httpd.serving_loop
    ended = threading.Event()
    front.on_fatal = ended.set
    try:
        outs = [loop.submit_text([5, 6, 7], max_tokens=20),
                loop.submit_text([8, 9], max_tokens=20)]
        assert ended.wait(60)
        reasons = []
        for out in outs:
            while (piece := out.get(timeout=30)) is not None and not (
                    isinstance(piece, tuple) and piece[0] == "__done__"):
                pass
            reasons.append(piece[1])
        assert reasons == ["error:RuntimeError"] * 2
        deadline = time.time() + 30  # the loop counts the error after on_fatal
        while loop.stats["step_errors"] == 0 and time.time() < deadline:
            time.sleep(0.01)
        assert loop.stats["step_errors"] == 1 and loop.stats["recoveries"] == 0
        assert isinstance(front.failed, RuntimeError) and not front.has_work
        with pytest.raises(RuntimeError, match="failed in an earlier round"):
            front.step()
        late = Request(prompt=[1, 2], max_new_tokens=2)
        front.submit(late)
        assert late.finish_reason == "error:RuntimeError"
    finally:
        httpd.server_close()
        loop.stop()


def test_follower_failure_ends_the_group(tmp_path):
    """Two gloo ranks: the follower's round raises, its `follow` returns 1
    and the coordinator's next collective fails instead of waiting for
    it."""
    params = _params(TP_CFG)
    np_params = {"tok_embd": params.tok_embd.numpy(), "norm": params.norm.numpy(),
                 "output": params.output.numpy(),
                 "layers": [{f.name: (None if getattr(lp, f.name) is None
                                      else getattr(lp, f.name).numpy())
                             for f in dataclasses.fields(lp)} for lp in params.layers]}
    coordinator, follower = run_ranks(failing_follower_worker, 2, tmp_path,
                                      dataclasses.asdict(TP_CFG), np_params, timeout=120)
    assert follower == 1
    assert coordinator[0] == "failed" and coordinator[1] <= 3, coordinator


def test_follower_refuses_what_is_the_coordinators():
    t = FakeTransport()
    drv_c = MultihostServingDriver(_sched(), is_coordinator=True, broadcast=t.coordinator,
                                   detok=lambda t_: b"x")
    drv_f = MultihostServingDriver(_sched(), is_coordinator=False, broadcast=t.follower)
    with pytest.raises(RuntimeError):
        drv_f.submit(Request(prompt=[1], max_new_tokens=1))
    with pytest.raises(RuntimeError):
        drv_f.cancel(0)
    drv_c.submit(Request(prompt=[1, 2], max_new_tokens=2, stop=[b"zz"]))
    drv_c.step()
    with pytest.raises(RuntimeError, match="detok"):
        drv_f.step()


def test_packets_over_a_gloo_group(tmp_path):
    """Two ranks of a TP PagedScheduler in lockstep, packets broadcast over
    gloo: both finish with the one-process scheduler's outputs."""
    params = _params(TP_CFG)
    np_params = {"tok_embd": params.tok_embd.numpy(), "norm": params.norm.numpy(),
                 "output": params.output.numpy(),
                 "layers": [{f.name: (None if getattr(lp, f.name) is None
                                      else getattr(lp, f.name).numpy())
                             for f in dataclasses.fields(lp)} for lp in params.layers]}
    first, late = [5, 9, 13, 2, 7], [3, 4, 5]
    ranks = run_ranks(lockstep_worker, 2, tmp_path, dataclasses.asdict(TP_CFG), np_params,
                      first, late, 6)
    one = _sched(params, TP_CFG)
    want = {tuple(p): out for p, out in
            zip((first, late), (r.output for r in one.generate_many([first, late], 6)))}
    for finished in ranks:
        assert {tuple(p): out for p, out in finished} == want


# -- the entry points under torchrun ---------------------------------------------


@pytest.fixture(scope="module")
def model_file(tmp_path_factory):
    from tokenhawk_tpu_torch.ggml.quants import quantize_q4_0
    from tokenhawk_tpu_torch.ggml.writer import write_ggml

    cfg = LlamaConfig(n_vocab=320, n_embd=128, n_head=4, n_layer=2, n_ctx=64, n_ff=256)
    rng = np.random.default_rng(3)

    def w(*shape):
        return (rng.standard_normal(shape) * 0.05).astype(np.float32)

    D, F, V = cfg.n_embd, cfg.n_ff, cfg.n_vocab
    tensors = {"tok_embeddings.weight": w(V, D), "norm.weight": np.ones(D, np.float32),
               "output.weight": quantize_q4_0(w(V, D))}
    for i in range(cfg.n_layer):
        p = f"layers.{i}."
        for name, shape in (("attention.wq", (D, D)), ("attention.wk", (D, D)),
                            ("attention.wv", (D, D)), ("attention.wo", (D, D)),
                            ("feed_forward.w1", (F, D)), ("feed_forward.w2", (D, F)),
                            ("feed_forward.w3", (F, D))):
            tensors[p + name + ".weight"] = quantize_q4_0(w(*shape))
        tensors[p + "attention_norm.weight"] = np.ones(D, np.float32)
        tensors[p + "ffn_norm.weight"] = np.ones(D, np.float32)
    tokens, scores = padded_vocab(V)
    hp = dict(n_vocab=V, n_embd=D, n_mult=cfg.n_mult, n_head=cfg.n_head, n_layer=cfg.n_layer,
              n_rot=cfg.head_dim, ftype=2)
    path = tmp_path_factory.mktemp("tp_model") / "tiny-q4_0.bin"
    write_ggml(path, hp, tokens, scores, tensors)
    return path


def _launch(module, tp, args, **kw):
    """`python -m module --tp 1 ...`, or torchrun with tp ranks."""
    head = ([sys.executable, "-m", module] if tp == 1 else
            [sys.executable, "-m", "torch.distributed.run", "--standalone",
             f"--nproc-per-node={tp}", "-m", module])
    return subprocess.Popen(head + ["--tp", str(tp), "--device", "cpu", "--dtype", "f32",
                                    *args], cwd=ROOT, env=subprocess_env(PYTHONPATH=str(ROOT)),
                            text=True, **kw)


def test_cli_at_tp_2_prints_the_tp_1_output(model_file):
    args = ["-m", str(model_file), "Hello there", "--greedy", "--max-tokens", "12",
            "--n-ctx", "64"]
    outs = []
    for tp in (1, 2):
        proc = _launch("tokenhawk_tpu_torch.cli", tp, args, stdout=subprocess.PIPE,
                       stderr=subprocess.PIPE)
        out, err = proc.communicate(timeout=120)
        assert proc.returncode == 0, err
        assert "12 generated" in err
        outs.append(out)
    assert outs[0] == outs[1] and outs[0].strip()


def _server_bodies(model_file, flags, posts):
    """The entry point at --tp 1, then under torchrun at --tp 2: each
    post's SSE body, every one ending as a request or a reset ends."""
    bodies = []
    for tp in (1, 2):
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        proc = _launch("tokenhawk_tpu_torch.serving", tp,
                       ["-m", str(model_file), *flags, "--n-ctx", "64", "--greedy",
                        "--port", str(port)],
                       stdout=subprocess.DEVNULL, stderr=subprocess.PIPE)
        base = f"http://127.0.0.1:{port}"
        try:
            deadline = time.time() + 120
            while True:
                try:
                    with urllib.request.urlopen(base + "/health", timeout=5) as r:
                        health = json.loads(r.read())
                    break
                except OSError:
                    assert proc.poll() is None and time.time() < deadline, proc.stderr.read()
                    time.sleep(0.5)
            assert health["tp"] == tp and health["paged"] is ("--paged" in flags)
            body = []
            for post in posts:
                req = urllib.request.Request(base + "/generate", method="POST",
                                             data=json.dumps(post).encode(),
                                             headers={"Content-Type": "application/json"})
                with urllib.request.urlopen(req, timeout=120) as r:
                    body.append(r.read().decode())
                want = "reset" if post["prompt"] == "[cmd] reset" else "length"
                assert body[-1].rstrip().split("\n")[-1] == f'data: {{"finish_reason": "{want}"}}'
            with urllib.request.urlopen(base + "/health", timeout=5) as r:
                assert json.loads(r.read())["step_errors"] == 0
            bodies.append(body)
        finally:
            proc.terminate()
            proc.wait(timeout=30)
    return bodies


def test_server_at_tp_2_streams_the_tp_1_output(model_file):
    tp1, tp2 = _server_bodies(model_file, ["--paged", "--page-size", "16"],
                              [{"prompt": "Hi there", "max_tokens": 8}])
    assert tp1 == tp2


def test_dense_server_at_tp_2_resets_a_session_as_tp_1_does(model_file):
    """The dense server pins a session's slot on every rank: a session,
    its reset, a message that opens it again and one that continues it."""
    tp1, tp2 = _server_bodies(model_file, [], [
        {"prompt": "Hi there", "max_tokens": 8, "session": "s"},
        {"prompt": "[cmd] reset", "session": "s"},
        {"prompt": "Hello", "max_tokens": 8, "session": "s"},
        {"prompt": " again", "max_tokens": 6, "session": "s"}])
    assert tp1 == tp2
