"""The port's HTTP server (tokenhawk_tpu_torch.serving), mirroring
tests/test_serving.py on the CPU.

The server module is a copy of the JAX package's (tests/test_torch_host.py
holds its text to the original); these tests drive it over the port's
schedulers, dense and paged, through /health, /generate (SSE),
/v1/completions, /v1/chat/completions and the 400s for malformed bodies.
A greedy completion's text equals what the JAX Scheduler generates for
the same prompt ids on the same weights.  The entry point
`python -m tokenhawk_tpu_torch.serving --device cpu` starts, answers and
refuses the options not ported yet (--kv int8 is served: see
tests/test_torch_paged_int8.py).
"""

import json
import os
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tokenhawk_tpu.config import LlamaConfig, SamplingConfig
from tokenhawk_tpu.models.llama import params_from_ggml
from tokenhawk_tpu.runtime.scheduler import Scheduler as JScheduler
from tokenhawk_tpu_torch.config import SamplingConfig as TSamplingConfig
from tokenhawk_tpu_torch.models.llama import params_from_jax
from tokenhawk_tpu_torch.runtime.paged_scheduler import PagedScheduler
from tokenhawk_tpu_torch.runtime.scheduler import Scheduler
from tokenhawk_tpu_torch.serving import __main__ as serving_main
from tokenhawk_tpu_torch.serving.server import serve
from tokenhawk_tpu_torch.tokenizer import byte_fallback_vocab

from helpers import make_ggml_weights
from torch_helpers import numpy_params, port_config

ROOT = Path(__file__).resolve().parents[1]
CFG = LlamaConfig.tiny(n_vocab=512, n_ctx=64)
GREEDY = TSamplingConfig(temperature=0.0)


@pytest.fixture(scope="module")
def params():
    jparams = params_from_ggml(CFG, make_ggml_weights(CFG, np.random.default_rng(11)),
                               dtype=jnp.float32)
    return jparams, params_from_jax(numpy_params(jparams))


def _make(kind, tparams):
    if kind == "paged":
        return PagedScheduler(port_config(CFG), tparams, sampling=GREEDY, max_batch=2,
                              cache_dtype=torch.float32, decode_chunk=4, page_size=16,
                              prefix_cache=True, prefill_chunk=16)
    return Scheduler(port_config(CFG), tparams, sampling=GREEDY, max_batch=2,
                     cache_dtype=torch.float32, decode_chunk=4)


@pytest.fixture(scope="module", params=["dense", "paged"])
def server(request, params):
    sched = _make(request.param, params[1])
    httpd = serve(sched, byte_fallback_vocab(), host="127.0.0.1", port=0,
                  model_info={"model": "tiny-test"})
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    yield f"http://127.0.0.1:{httpd.server_address[1]}", httpd
    httpd.shutdown()
    httpd.serving_loop.stop()


def _post(url, payload, raw=None):
    req = urllib.request.Request(url, data=raw if raw is not None else json.dumps(
        payload).encode(), headers={"Content-Type": "application/json"}, method="POST")
    with urllib.request.urlopen(req, timeout=120) as r:
        return r.headers["Content-Type"], r.read().decode()


def _status(url, payload=None, raw=None):
    try:
        _post(url, payload, raw)
    except urllib.error.HTTPError as e:
        return e.code, e.read()
    return 200, b""


def test_health_and_index(server):
    base, httpd = server
    with urllib.request.urlopen(base + "/health", timeout=30) as r:
        data = json.loads(r.read())
    assert data["status"] == "ok" and data["model"] == "tiny-test"
    assert data["step_errors"] == 0
    with urllib.request.urlopen(base + "/", timeout=30) as r:
        assert "tokenhawk" in r.read().decode()
    with urllib.request.urlopen(base + "/chat.js", timeout=30) as r:
        assert "generate" in r.read().decode()


def test_generate_streams_tokens(server):
    base, _ = server
    ctype, body = _post(base + "/generate", {"prompt": "hi", "max_tokens": 6})
    assert ctype.startswith("text/event-stream")
    frames = [f for f in body.split("\n\n") if f.strip()]
    assert frames[-1].startswith("event: done")
    assert json.loads(frames[-1].split("data: ")[1])["finish_reason"] == "length"
    data = [json.loads(f[6:]) for f in frames if f.startswith("data: ")]
    assert len(data) >= 1 and all("token" in d for d in data)


def test_concurrent_streams_all_finish(server):
    base, httpd = server
    bodies = [None] * 3

    def go(i):
        bodies[i] = _post(base + "/generate", {"prompt": f"req {i}", "max_tokens": 5})[1]

    threads = [threading.Thread(target=go, args=(i,)) for i in range(3)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=120)
    assert all(b is not None for b in bodies), bodies
    reasons = [json.loads(b.split("event: done\ndata: ")[1])["finish_reason"] for b in bodies]
    assert all(r in ("length", "eos") for r in reasons), reasons
    assert httpd.serving_loop.health()["step_errors"] == 0


def test_completions_match_jax_scheduler(server, params):
    """Greedy /v1/completions text = the JAX Scheduler's greedy tokens for
    the same prompt ids, decoded with the same vocabulary."""
    base, _ = server
    _, body = _post(base + "/v1/completions", {"prompt": [1, 72, 105], "max_tokens": 5})
    body = json.loads(body)
    assert body["object"] == "text_completion"
    assert body["usage"]["prompt_tokens"] == 3
    j = JScheduler(CFG, params[0], sampling=SamplingConfig(temperature=0.0), max_batch=2,
                   cache_dtype=jnp.float32, decode_chunk=4)
    [r] = j.generate_many([[1, 72, 105]], max_new_tokens=5)
    assert body["choices"][0]["text"] == byte_fallback_vocab().decode(r.output)
    assert body["usage"]["completion_tokens"] == len(r.output)


def test_completions_stream_and_chat(server):
    base, _ = server
    _, body = _post(base + "/v1/completions", {"prompt": "Hi", "max_tokens": 4,
                                               "stream": True})
    assert body.rstrip().endswith("data: [DONE]")
    chunks = [json.loads(x[6:]) for x in body.splitlines()
              if x.startswith("data: ") and x != "data: [DONE]"]
    assert chunks[-1]["choices"][0]["finish_reason"] in ("stop", "length")
    _, body = _post(base + "/v1/chat/completions",
                    {"messages": [{"role": "system", "content": "be brief"},
                                  {"role": "user", "content": "hi"}], "max_tokens": 4})
    body = json.loads(body)
    assert body["object"] == "chat.completion"
    assert body["choices"][0]["message"]["role"] == "assistant"
    assert body["usage"]["prompt_tokens"] > 0
    _, body = _post(base + "/v1/chat/completions",
                    {"messages": [{"role": "user", "content": "hi"}], "max_tokens": 3,
                     "stream": True})
    lines = [json.loads(x[6:]) for x in body.splitlines()
             if x.startswith("data: ") and x != "data: [DONE]"]
    assert lines[0]["choices"][0]["delta"].get("role") == "assistant"


@pytest.mark.parametrize("path,payload,raw", [
    ("/generate", None, b"{}"),
    ("/generate", None, b"not json"),
    ("/generate", {"prompt": "Hi", "stop": [1, 2]}, None),
    ("/v1/completions", {"max_tokens": 4}, None),
    ("/v1/completions", {"prompt": [5] * 200, "max_tokens": 3}, None),  # > n_ctx
    ("/v1/chat/completions", {"messages": "hi"}, None),
])
def test_malformed_requests_get_400(server, path, payload, raw):
    base, _ = server
    code, _ = _status(base + path, payload, raw)
    assert code == 400


def test_paged_session_replay_reuses_prefix_pages(params):
    sched = _make("paged", params[1])
    httpd = serve(sched, byte_fallback_vocab(), host="127.0.0.1", port=0)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        _, b1 = _post(base + "/generate", {"prompt": "hello there my friend, how are you",
                                           "max_tokens": 3, "session": "s1"})
        assert "event: done" in b1
        hits = sched.prefix_hits
        _, b2 = _post(base + "/generate", {"prompt": " and more", "max_tokens": 3,
                                           "session": "s1"})
        assert "event: done" in b2 and sched.prefix_hits > hits
        _, b3 = _post(base + "/generate", {"prompt": "[cmd] reset", "session": "s1"})
        assert "reset" in b3 and "s1" not in httpd.serving_loop._session_hist
    finally:
        httpd.shutdown()
        httpd.serving_loop.stop()


def test_web_assets_are_the_reference_ones():
    for name in ("index.html", "chat.js"):
        assert ((ROOT / "tokenhawk_tpu_torch/serving/web" / name).read_bytes()
                == (ROOT / "tokenhawk_tpu/serving/web" / name).read_bytes())


@pytest.mark.parametrize("flag", [["--tp", "2"], ["--draft-model", "d.bin", "--tp", "2"],
                                  ["--gamma", "3", "--tp", "4"], ["--kv", "int8", "--tp", "2"]])
def test_entry_point_refuses_unported_options(flag, capsys):
    with pytest.raises(SystemExit) as e:
        serving_main.main(["-m", "model.bin", *flag])
    assert e.value.code == 2
    assert "ROADMAP Queue 1" in capsys.readouterr().err
    assert serving_main.build_parser().parse_args(["-m", "x"]).device == "cuda"


def test_entry_point_serves_on_the_cpu(tmp_path):
    """`python -m tokenhawk_tpu_torch.serving --paged --device cpu` on a
    tiny ggjt file: /health answers, one request streams to the end."""
    from tokenhawk_tpu_torch.ggml.writer import write_ggml
    from torch_helpers import padded_vocab

    cfg = LlamaConfig.tiny(n_vocab=300, n_embd=128, n_head=2, n_layer=1, n_ff=256)
    tokens, scores = padded_vocab(cfg.n_vocab)
    hp = dict(n_vocab=cfg.n_vocab, n_embd=cfg.n_embd, n_mult=cfg.n_mult, n_head=cfg.n_head,
              n_layer=cfg.n_layer, n_rot=cfg.head_dim, ftype=0)
    path = tmp_path / "tiny.bin"
    write_ggml(path, hp, tokens, scores, make_ggml_weights(cfg, np.random.default_rng(3)))
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.Popen(
        [sys.executable, "-m", "tokenhawk_tpu_torch.serving", "-m", str(path), "--paged",
         "--device", "cpu", "--dtype", "f32", "--n-ctx", "64", "--page-size", "16",
         "--port", str(port)], cwd=ROOT, env=env, stdout=subprocess.DEVNULL,
        stderr=subprocess.PIPE, text=True)
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
        assert health["paged"] is True and health["device"] == "cpu"
        _, body = _post(base + "/generate", {"prompt": "hi", "max_tokens": 4})
        assert body.rstrip().split("\n")[-1].startswith("data: {\"finish_reason\"")
    finally:
        proc.terminate()
        proc.wait(timeout=30)
