# Copy of tokenhawk_tpu/serving/server.py (imports rewritten, upstream citations as bare
# file:line): importing tokenhawk_tpu imports jax, which the GPU machine lacks.
# tests/test_torch_host.py holds the copy equal to its original.
"""HTTP serving frontend with streaming chat.

Capability parity with the reference's browser frontend
(web/main.cpp + web/chat.js: a chat page that streams
tokens into the DOM via the onNewToken callback), rebuilt as a
server-side component: stdlib HTTP server + Server-Sent-Events token
streaming, backed by the continuous-batching scheduler so many chats
share the TPU.

Endpoints:
  GET  /            chat UI (static HTML/JS, serving/web/)
  GET  /health      JSON liveness + model info
  POST /generate    {"prompt": str, "max_tokens": int, "stop": [str], ...}
                    -> text/event-stream of {"token": str} events
  POST /v1/completions
                    OpenAI-compatible completions: {"prompt", "max_tokens",
                    "temperature", "top_p", "stop", "stream", "seed"} ->
                    OpenAI JSON (or SSE chunks with stream=true), so
                    existing OpenAI-client tooling points here unchanged.
  POST /v1/chat/completions
                    OpenAI-compatible chat: messages render through the
                    model's own chat template (GGUF tokenizer.chat_template
                    metadata, jinja2) or a plain role-tagged fallback.
"""

from __future__ import annotations

import json
import queue
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path
from typing import Optional

from tokenhawk_tpu_torch.runtime.scheduler import Request, Scheduler
from tokenhawk_tpu_torch.tokenizer import Tokenizer

_WEB_DIR = Path(__file__).parent / "web"
_SENTINEL = object()

# Chat-template guardrails: GGUF files are untrusted input, so the
# tokenizer.chat_template metadata they carry is attacker-controlled
# jinja source.  Render it only inside jinja2's immutable sandbox
# (blocks attribute-chain escapes like ''.__class__.__mro__...), cap
# the template source size, and bound render wall-time (a template
# can still spin, e.g. nested loops over long ranges).
_TEMPLATE_MAX_BYTES = 64 * 1024
_RENDER_TIMEOUT_S = 5.0
_RENDER_MAX_CHARS = 1 << 20
_template_cache: dict = {}


def _render_chat_template(tmpl: str, messages) -> str:
    import jinja2
    import jinja2.sandbox

    if len(tmpl) > _TEMPLATE_MAX_BYTES:
        raise jinja2.TemplateError("chat template too large")
    compiled = _template_cache.get(tmpl)
    if compiled is None:
        env = jinja2.sandbox.ImmutableSandboxedEnvironment()

        def raise_exception(msg):
            raise jinja2.TemplateError(msg)

        env.globals["raise_exception"] = raise_exception
        compiled = env.from_string(tmpl)
        _template_cache.clear()  # one model per server; keep one entry
        _template_cache[tmpl] = compiled

    result: list = []

    def run():
        try:
            result.append(compiled.render(
                messages=messages, add_generation_prompt=True,
                bos_token="<s>", eos_token="</s>",
            ))
        except BaseException as e:  # surfaced on the caller thread
            result.append(e)

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(_RENDER_TIMEOUT_S)
    if t.is_alive():
        raise jinja2.TemplateError("chat template render timed out")
    if isinstance(result[0], BaseException):
        raise result[0]
    if len(result[0]) > _RENDER_MAX_CHARS:
        raise jinja2.TemplateError("chat template output too large")
    return result[0]


class ServingLoop:
    """Owns the Scheduler on a dedicated thread; thread-safe submit()."""

    # Consecutive device-step failures before the loop rebuilds the
    # scheduler's device state (fresh caches/slots; sessions evicted).
    RECOVER_AFTER = 3

    def __init__(self, scheduler: Scheduler, tokenizer: Tokenizer):
        self.scheduler = scheduler
        self.tokenizer = tokenizer
        self._inbox: "queue.Queue" = queue.Queue()
        self._wake = threading.Event()
        # Text-replay sessions for schedulers without KV-pinned sessions
        # (PagedScheduler): sid -> conversation text so far, LRU-bounded
        # (the dense scheduler bounds its sessions by slot eviction; this
        # map must not grow per client forever).  The replay re-prefills,
        # but with the prefix cache on, only the new tokens compute.
        from collections import OrderedDict, defaultdict, deque

        self._session_hist: "OrderedDict[str, str]" = OrderedDict()
        self.MAX_SESSIONS = 256
        # Per-session serialization for text-replay sessions: history is
        # read and written only on the loop thread, and a second message
        # on a session waits until the first completes, so concurrent
        # messages can never replay stale history (each turn sees the
        # previous turn's output).
        self._session_inflight: set = set()
        self._session_waitq: "dict[str, deque]" = defaultdict(deque)
        self._session_gen: "dict[str, int]" = defaultdict(int)
        self._stop = False
        self._thread = threading.Thread(target=self._run, daemon=True)
        import time as _time

        self.stats = {
            "started_at": _time.time(),
            "steps": 0,
            "step_errors": 0,
            "consecutive_errors": 0,
            "recoveries": 0,
            "last_error": "",
            "last_error_at": 0.0,
            "requests": 0,
            "completed": 0,
        }

    def health(self) -> dict:
        """Liveness + degradation report (beyond the reference's
        load-failed flag, th-llama-loader.cpp:473-476).

        status: "ok" normally; "degraded" while step errors are
        accumulating (a recovery will trigger at RECOVER_AFTER)."""
        import time as _time

        s = dict(self.stats)
        degraded = s["consecutive_errors"] > 0 or (
            s["last_error_at"] and _time.time() - s["last_error_at"] < 60.0
        )
        return {
            "status": "degraded" if degraded else "ok",
            "uptime_s": round(_time.time() - s.pop("started_at"), 1),
            "active": self.scheduler.n_active,
            "queued": len(self.scheduler.pending),
            "prefix_cache_hits": getattr(self.scheduler, "prefix_hits", 0),
            **s,
        }

    def start(self):
        self._thread.start()
        return self

    def stop(self):
        self._stop = True
        self._wake.set()
        self._thread.join(timeout=10)

    def submit_text(self, prompt: str, max_tokens: int = 256,
                    sampling=None, session: Optional[str] = None,
                    stop=None) -> "queue.Queue":
        """Returns a queue yielding decoded-token strings, then
        ("__done__", finish_reason) and _SENTINEL.

        `sampling`: optional per-request SamplingConfig (temperature /
        top_k / top_p / repeat_penalty / seed) applied to this request
        only.  `session`: conversation id — messages with the same id
        share KV context (multi-turn chat); the literal message
        "[cmd] reset" clears it (web/main.cpp:160-179).
        """
        out: "queue.Queue" = queue.Queue()
        if session is not None and prompt.strip() == "[cmd] reset":
            self._inbox.put(("reset", session, out))
            self._wake.set()
            return out
        native = getattr(self.scheduler, "native_sessions", True)
        ids = None
        if isinstance(prompt, list):
            # Pre-tokenized prompt (OpenAI accepts token-id arrays).
            ids = [int(t) for t in prompt]
            prompt = self.tokenizer.decode(ids)
        if session is not None and not native:
            # Text-replay session: history is owned by the loop thread,
            # so resolve the replayed prompt there (and serialize turns
            # per session) instead of racing on _session_hist here.
            self._inbox.put(("session_submit", session, prompt, max_tokens,
                             sampling, stop, out))
            self._wake.set()
            return out
        if ids is None:
            is_continuation = (
                native and session is not None
                and session in self.scheduler.sessions
            )  # BOS only opens a conversation; continuations append
            ids = self.tokenizer.encode_prompt(
                prompt, add_bos=not is_continuation)
        out.n_prompt_tokens = len(ids)

        def on_text(b: bytes):
            out.put(b.decode("utf-8", "replace"))

        def on_done(req: Request):
            self.stats["completed"] += 1
            out.put(("__done__", req.finish_reason))
            out.put(_SENTINEL)

        req = Request(prompt=ids, max_new_tokens=max_tokens,
                      sampling=sampling, session=session,
                      stop=[x.encode("utf-8") for x in stop] if stop else None,
                      detok=self.tokenizer.decode_token_bytes,
                      on_text=on_text, on_done=on_done)
        out.request = req  # handle for cancel-on-disconnect
        self._inbox.put(req)
        self._wake.set()
        return out

    def _submit_session_now(self, session: str, prompt: str,
                            max_tokens: int, sampling, stop,
                            out: "queue.Queue") -> None:
        """Loop-thread half of a text-replay session submission: resolve
        the replayed prompt against the (loop-thread-owned) history and
        submit.  Callers must have marked the session in-flight."""
        gen = self._session_gen[session]
        full = self._session_hist.get(session, "") + prompt
        ids = self.tokenizer.encode_prompt(full, add_bos=True)
        out.n_prompt_tokens = len(ids)

        def on_text(b: bytes):
            out.put(b.decode("utf-8", "replace"))

        def on_done(req: Request):
            self.stats["completed"] += 1
            # on_done runs on the loop thread (inside scheduler.step).
            if (not req.finish_reason.startswith("error")
                    and self._session_gen.get(session, -1) == gen):
                self._session_hist[session] = (
                    full + self.tokenizer.decode(req.output))
                self._session_hist.move_to_end(session)
                while len(self._session_hist) > self.MAX_SESSIONS:
                    self._session_hist.popitem(last=False)
            waitq = self._session_waitq.get(session)
            if waitq:
                self._submit_session_now(session, *waitq.popleft())
            else:
                self._session_inflight.discard(session)
                self._session_waitq.pop(session, None)
            out.put(("__done__", req.finish_reason))
            out.put(_SENTINEL)

        req = Request(prompt=ids, max_new_tokens=max_tokens,
                      sampling=sampling, session=session,
                      stop=[x.encode("utf-8") for x in stop] if stop else None,
                      detok=self.tokenizer.decode_token_bytes,
                      on_text=on_text, on_done=on_done)
        out.request = req
        self.stats["requests"] += 1
        self.scheduler.submit(req)

    def cancel(self, req: Request) -> None:
        """Abort a request from any thread (routed via the inbox so all
        scheduler state changes happen on the loop thread)."""
        self._inbox.put(("cancel", req))
        self._wake.set()

    def _run(self):
        while not self._stop:
            drained = False
            while True:
                try:
                    item = self._inbox.get_nowait()
                except queue.Empty:
                    break
                if isinstance(item, tuple) and item[0] == "reset":
                    _, sid, out = item
                    self.scheduler.reset_session(sid)
                    self._session_hist.pop(sid, None)
                    self._session_gen[sid] += 1  # in-flight turn won't write
                    for parked in self._session_waitq.pop(sid, ()):
                        parked[-1].put(("__done__", "reset"))
                        parked[-1].put(_SENTINEL)
                    out.put("LLM context reset.")
                    out.put(("__done__", "reset"))
                    out.put(_SENTINEL)
                elif isinstance(item, tuple) and item[0] == "session_submit":
                    _, sid, prompt, max_tokens, sampling, stop, out = item
                    if sid in self._session_inflight:
                        self._session_waitq[sid].append(
                            (prompt, max_tokens, sampling, stop, out))
                    else:
                        self._session_inflight.add(sid)
                        self._submit_session_now(
                            sid, prompt, max_tokens, sampling, stop, out)
                elif isinstance(item, tuple) and item[0] == "cancel":
                    self.scheduler.cancel(item[1])
                else:
                    self.stats["requests"] += 1
                    self.scheduler.submit(item)
                drained = True
            try:
                if self.scheduler.has_work:
                    self.scheduler.step()
                    self.stats["steps"] += 1
                    self.stats["consecutive_errors"] = 0
                elif not drained:
                    self._wake.wait(timeout=0.05)
                    self._wake.clear()
            except Exception as e:  # keep serving; fail active requests
                import sys
                import time as _time
                import traceback

                traceback.print_exc(file=sys.stderr)
                self.stats["step_errors"] += 1
                self.stats["consecutive_errors"] += 1
                self.stats["last_error"] = f"{type(e).__name__}: {e}"[:200]
                self.stats["last_error_at"] = _time.time()
                for slot, req in enumerate(self.scheduler.slots):
                    if req is not None:
                        self.scheduler._retire(slot, f"error:{type(e).__name__}")
                for c in list(getattr(self.scheduler, "chunking", [])):
                    if c is not None:
                        # mid-chunking admission: fail it too, or its SSE
                        # consumer blocks forever after a state rebuild
                        self.scheduler.cancel(
                            c[0], f"error:{type(e).__name__}")
                if self.stats["consecutive_errors"] >= self.RECOVER_AFTER:
                    # Repeated failures: assume poisoned device state and
                    # rebuild it (pending requests survive and re-admit).
                    try:
                        self.scheduler.reset_device_state()
                        self.stats["recoveries"] += 1
                        self.stats["consecutive_errors"] = 0
                        print("serving loop: device state rebuilt after "
                              "repeated step failures", file=sys.stderr)
                    except Exception:
                        traceback.print_exc(file=sys.stderr)


def _make_handler(loop: ServingLoop, model_info: dict):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # quiet
            pass

        def _send(self, code: int, body: bytes, ctype: str):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path in ("/", "/index.html"):
                page = (_WEB_DIR / "index.html").read_bytes()
                self._send(200, page, "text/html; charset=utf-8")
            elif self.path == "/chat.js":
                self._send(200, (_WEB_DIR / "chat.js").read_bytes(),
                           "application/javascript")
            elif self.path == "/health":
                body = json.dumps({**loop.health(), **model_info}).encode()
                self._send(200, body, "application/json")
            elif self.path == "/v1/models":
                mid = model_info.get("model", "tokenhawk-tpu")
                body = json.dumps({"object": "list", "data": [
                    {"id": mid, "object": "model",
                     "owned_by": "tokenhawk-tpu"}]}).encode()
                self._send(200, body, "application/json")
            else:
                self._send(404, b"not found", "text/plain")

        def _openai_completions(self):
            import time as _time
            import uuid

            n = int(self.headers.get("Content-Length", "0"))
            try:
                payload = json.loads(self.rfile.read(n) or b"{}")
                prompt = payload["prompt"]
                if isinstance(prompt, list) and len(prompt) == 1 \
                        and isinstance(prompt[0], str):
                    prompt = prompt[0]  # batch of one text prompt
                if not (isinstance(prompt, str)
                        or (isinstance(prompt, list)
                            and prompt
                            and all(isinstance(t, int) for t in prompt))):
                    raise ValueError("prompt must be a string or token ids")
                max_tokens = int(payload.get("max_tokens", 16))
                stream = bool(payload.get("stream", False))
                stop = payload.get("stop")
                if isinstance(stop, str):
                    stop = [stop]
                sampling = None
                keys = ("temperature", "top_p", "seed")
                if any(k in payload for k in keys):
                    from tokenhawk_tpu_torch.config import SamplingConfig

                    d = SamplingConfig()
                    sampling = SamplingConfig(
                        temperature=float(payload.get("temperature",
                                                      d.temperature)),
                        top_p=float(payload.get("top_p", d.top_p)),
                        top_k=d.top_k,
                        seed=int(payload.get("seed", d.seed)),
                    )
            except (KeyError, ValueError, TypeError, json.JSONDecodeError):
                self._send(400, json.dumps(
                    {"error": {"message": "bad request",
                               "type": "invalid_request_error"}}).encode(),
                    "application/json")
                return

            out = loop.submit_text(prompt, max_tokens, sampling=sampling,
                                   stop=stop)
            cid = f"cmpl-{uuid.uuid4().hex[:24]}"
            created = int(_time.time())
            model = model_info.get("model", "tokenhawk-tpu")

            def finish_of(reason):
                if reason.startswith("error") or reason in (
                        "oom_pages", "cancelled"):
                    return "error"
                return {"eos": "stop", "stop": "stop",
                        "length": "length",
                        "context_full": "length"}.get(reason, "stop")

            if stream:
                self.send_response(200)
                self.send_header("Content-Type", "text/event-stream")
                self.send_header("Cache-Control", "no-cache")
                self.end_headers()
                try:
                    reason = ""
                    while True:
                        piece = out.get()
                        if piece is _SENTINEL:
                            done = {"id": cid, "object": "text_completion",
                                    "created": created, "model": model,
                                    "choices": [{"index": 0, "text": "",
                                                 "finish_reason":
                                                     finish_of(reason)}]}
                            self.wfile.write(
                                f"data: {json.dumps(done)}\n\n".encode())
                            self.wfile.write(b"data: [DONE]\n\n")
                            self.wfile.flush()
                            break
                        if isinstance(piece, tuple) and piece[0] == "__done__":
                            reason = piece[1]
                            continue
                        chunk = {"id": cid, "object": "text_completion",
                                 "created": created, "model": model,
                                 "choices": [{"index": 0, "text": piece,
                                              "finish_reason": None}]}
                        self.wfile.write(
                            f"data: {json.dumps(chunk)}\n\n".encode())
                        self.wfile.flush()
                except OSError:
                    req = getattr(out, "request", None)
                    if req is not None:
                        loop.cancel(req)
                return

            parts, reason = [], ""
            while True:
                piece = out.get()
                if piece is _SENTINEL:
                    break
                if isinstance(piece, tuple) and piece[0] == "__done__":
                    reason = piece[1]
                    continue
                parts.append(piece)
            if finish_of(reason) == "error":
                code = 400 if reason.startswith("error") else 503
                self._send(code, json.dumps({"error": {
                    "message": reason,
                    "type": ("invalid_request_error"
                             if code == 400 else "overloaded_error"),
                }}).encode(), "application/json")
                return
            n_prompt = getattr(out, "n_prompt_tokens", 0)
            n_completion = getattr(out, "request", None)
            n_completion = (len(n_completion.output)
                            if n_completion is not None else len(parts))
            body = json.dumps({
                "id": cid, "object": "text_completion", "created": created,
                "model": model,
                "choices": [{"index": 0, "text": "".join(parts),
                             "logprobs": None,
                             "finish_reason": finish_of(reason)}],
                "usage": {"prompt_tokens": n_prompt,
                          "completion_tokens": n_completion,
                          "total_tokens": n_prompt + n_completion},
            }).encode()
            self._send(200, body, "application/json")

        def _render_chat(self, messages):
            """messages [{role, content}] -> prompt text via the model's
            chat template (GGUF metadata) or a role-tagged fallback."""
            tmpl = model_info.get("chat_template")
            if tmpl:
                return _render_chat_template(tmpl, messages)
            parts = []
            for m in messages:
                parts.append(f"{m['role']}: {m['content']}")
            parts.append("assistant:")
            return "\n".join(parts)

        def _openai_chat(self):
            import time as _time
            import uuid

            n = int(self.headers.get("Content-Length", "0"))
            try:
                payload = json.loads(self.rfile.read(n) or b"{}")
                messages = payload["messages"]
                if not (isinstance(messages, list) and messages and all(
                        isinstance(m, dict) and isinstance(m.get("role"), str)
                        and isinstance(m.get("content"), str)
                        for m in messages)):
                    raise ValueError("bad messages")
                prompt = self._render_chat(messages)
                max_tokens = int(payload.get("max_tokens",
                                             payload.get(
                                                 "max_completion_tokens",
                                                 256)))
                stream = bool(payload.get("stream", False))
                stop = payload.get("stop")
                if isinstance(stop, str):
                    stop = [stop]
                sampling = None
                if any(k in payload for k in ("temperature", "top_p", "seed")):
                    from tokenhawk_tpu_torch.config import SamplingConfig

                    d = SamplingConfig()
                    sampling = SamplingConfig(
                        temperature=float(payload.get("temperature",
                                                      d.temperature)),
                        top_p=float(payload.get("top_p", d.top_p)),
                        top_k=d.top_k,
                        seed=int(payload.get("seed", d.seed)),
                    )
            except (KeyError, ValueError, TypeError, json.JSONDecodeError,
                    Exception) as e:
                self._send(400, json.dumps(
                    {"error": {"message": f"bad request: {e}",
                               "type": "invalid_request_error"}}).encode(),
                    "application/json")
                return

            out = loop.submit_text(prompt, max_tokens, sampling=sampling,
                                   stop=stop)
            cid = f"chatcmpl-{uuid.uuid4().hex[:24]}"
            created = int(_time.time())
            model = model_info.get("model", "tokenhawk-tpu")

            def finish_of(reason):
                if reason.startswith("error") or reason in (
                        "oom_pages", "cancelled"):
                    return "error"
                return {"eos": "stop", "stop": "stop", "length": "length",
                        "context_full": "length"}.get(reason, "stop")

            if stream:
                self.send_response(200)
                self.send_header("Content-Type", "text/event-stream")
                self.send_header("Cache-Control", "no-cache")
                self.end_headers()
                try:
                    reason = ""
                    first = True
                    while True:
                        piece = out.get()
                        if piece is _SENTINEL:
                            done = {"id": cid,
                                    "object": "chat.completion.chunk",
                                    "created": created, "model": model,
                                    "choices": [{"index": 0, "delta": {},
                                                 "finish_reason":
                                                     finish_of(reason)}]}
                            self.wfile.write(
                                f"data: {json.dumps(done)}\n\n".encode())
                            self.wfile.write(b"data: [DONE]\n\n")
                            self.wfile.flush()
                            break
                        if isinstance(piece, tuple) and piece[0] == "__done__":
                            reason = piece[1]
                            continue
                        delta = {"content": piece}
                        if first:
                            delta["role"] = "assistant"
                            first = False
                        chunk = {"id": cid, "object": "chat.completion.chunk",
                                 "created": created, "model": model,
                                 "choices": [{"index": 0, "delta": delta,
                                              "finish_reason": None}]}
                        self.wfile.write(
                            f"data: {json.dumps(chunk)}\n\n".encode())
                        self.wfile.flush()
                except OSError:
                    req = getattr(out, "request", None)
                    if req is not None:
                        loop.cancel(req)
                return

            parts, reason = [], ""
            while True:
                piece = out.get()
                if piece is _SENTINEL:
                    break
                if isinstance(piece, tuple) and piece[0] == "__done__":
                    reason = piece[1]
                    continue
                parts.append(piece)
            if finish_of(reason) == "error":
                code = 400 if reason.startswith("error") else 503
                self._send(code, json.dumps({"error": {
                    "message": reason,
                    "type": ("invalid_request_error"
                             if code == 400 else "overloaded_error"),
                }}).encode(), "application/json")
                return
            n_prompt = getattr(out, "n_prompt_tokens", 0)
            req = getattr(out, "request", None)
            n_completion = len(req.output) if req is not None else len(parts)
            body = json.dumps({
                "id": cid, "object": "chat.completion", "created": created,
                "model": model,
                "choices": [{"index": 0,
                             "message": {"role": "assistant",
                                         "content": "".join(parts)},
                             "finish_reason": finish_of(reason)}],
                "usage": {"prompt_tokens": n_prompt,
                          "completion_tokens": n_completion,
                          "total_tokens": n_prompt + n_completion},
            }).encode()
            self._send(200, body, "application/json")

        def do_POST(self):
            if self.path == "/v1/completions":
                self._openai_completions()
                return
            if self.path == "/v1/chat/completions":
                self._openai_chat()
                return
            if self.path != "/generate":
                self._send(404, b"not found", "text/plain")
                return
            n = int(self.headers.get("Content-Length", "0"))
            try:
                payload = json.loads(self.rfile.read(n) or b"{}")
                prompt = payload["prompt"]
                max_tokens = int(payload.get("max_tokens", 256))
                session = payload.get("session")
                if session is not None and not isinstance(session, str):
                    raise ValueError("session must be a string")
                stop = payload.get("stop")
                if stop is not None:
                    if isinstance(stop, str):
                        stop = [stop]
                    if (not isinstance(stop, list)
                            or not all(isinstance(x, str) and x for x in stop)):
                        raise ValueError("stop must be a string or list")
                sampling = None
                keys = ("temperature", "top_k", "top_p", "repeat_penalty",
                        "seed")
                if any(k in payload for k in keys):
                    from tokenhawk_tpu_torch.config import SamplingConfig

                    d = SamplingConfig()
                    sampling = SamplingConfig(
                        temperature=float(payload.get("temperature",
                                                      d.temperature)),
                        top_k=int(payload.get("top_k", d.top_k)),
                        top_p=float(payload.get("top_p", d.top_p)),
                        repeat_penalty=float(payload.get("repeat_penalty",
                                                         d.repeat_penalty)),
                        seed=int(payload.get("seed", d.seed)),
                    )
            except (KeyError, ValueError, TypeError, json.JSONDecodeError):
                self._send(400, b'{"error":"bad request"}', "application/json")
                return

            out = loop.submit_text(prompt, max_tokens, sampling=sampling,
                                   session=session, stop=stop)
            self.send_response(200)
            self.send_header("Content-Type", "text/event-stream")
            self.send_header("Cache-Control", "no-cache")
            self.end_headers()
            try:
                reason = ""
                while True:
                    piece = out.get()
                    if piece is _SENTINEL:
                        data = json.dumps({"finish_reason": reason})
                        self.wfile.write(f"event: done\ndata: {data}\n\n".encode())
                        self.wfile.flush()
                        break
                    if isinstance(piece, tuple) and piece[0] == "__done__":
                        reason = piece[1]
                        continue
                    data = json.dumps({"token": piece})
                    self.wfile.write(f"data: {data}\n\n".encode())
                    self.wfile.flush()
            except OSError:
                # Client went away (EPIPE/ECONNRESET/...): stop burning
                # tokens on its request.
                req = getattr(out, "request", None)
                if req is not None:
                    loop.cancel(req)

    return Handler


def serve(
    scheduler: Scheduler,
    tokenizer: Tokenizer,
    host: str = "127.0.0.1",
    port: int = 22345,  # parity with the reference's serve.py port
    model_info: Optional[dict] = None,
) -> ThreadingHTTPServer:
    loop = ServingLoop(scheduler, tokenizer).start()
    handler = _make_handler(loop, model_info or {})
    httpd = ThreadingHTTPServer((host, port), handler)
    httpd.serving_loop = loop  # keep a handle for shutdown
    return httpd
