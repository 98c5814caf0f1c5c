"""The port's GGUF path against the JAX package's, end to end on the CPU.

Three tiny files, each loaded by both packages (with scale_dtype=float32,
so both hold the file's exact weights; at both loaders' default, bfloat16
sides, they agree too; the reference's programs on its CPU path, XLA, as
its own end-to-end tests run them):
  - "q4_k_m": a Llama-3-shaped GGUF in llama.cpp's Q4_K_M mix
    (ggml/synth.py): 4 query heads per KV head of 128, rope base 500000,
    eps 1e-5, a byte-level BPE vocab with Llama-3's specials; layer 1
    stores attn_v and ffn_down in Q6_K, so its wq|wk|wv cannot fuse and
    kernel 2 pairs Q4_K with Q6_K, layer 0 all Q4_K; a Q6_K head;
  - "q8_0": a GGUF of the same widths in Q8_0, SentencePiece vocab;
  - "ggjt": a ggjt file with Q8_0 projections and a Q4_1 w2 and head.
For each: config, tokenizer and weights agree (dequantized, bit for
bit); prefill logits agree to f32 summation order (rtol 1e-4, atol 1e-4
of the largest |logit|); 16 greedy tokens of two prompts are the
reference Engine's through the port's Engine, Scheduler and
PagedScheduler (for "q4_k_m" also through the reference's Scheduler
and PagedScheduler).  Then, on a copy of the q4_k_m file whose head
swaps two rows so that greedy decoding meets <|eot_id|> at its third
token, the CLI and `python -m tokenhawk_tpu_torch.serving --paged` run
in subprocesses with --device cpu: both stop there (an end-of-generation
id that is not the file's eos_id), and the server renders the file's
chat template.
"""

import dataclasses
import json
import os
import shutil
import socket
import subprocess
import sys
import time
import urllib.request
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tokenhawk_tpu.config import SamplingConfig as JSamplingConfig
from tokenhawk_tpu.models.llama import make_unrolled_cache
from tokenhawk_tpu.runtime.engine import Engine as JEngine
from tokenhawk_tpu.runtime.engine import make_prefill_fn as j_make_prefill_fn
from tokenhawk_tpu.runtime.loader import load_model as j_load_model
from tokenhawk_tpu.runtime.paged_scheduler import PagedScheduler as JPaged
from tokenhawk_tpu.runtime.scheduler import Scheduler as JDense
from tokenhawk_tpu_torch.config import LlamaConfig, SamplingConfig
from tokenhawk_tpu_torch.ggml import synth
from tokenhawk_tpu_torch.ggml.format import GGMLType
from tokenhawk_tpu_torch.ggml.quants import quantize
from tokenhawk_tpu_torch.ggml.writer import write_ggml
from tokenhawk_tpu_torch.models import llama as tl
from tokenhawk_tpu_torch.ops.qweight import QWeight
from tokenhawk_tpu_torch.runtime.engine import Engine
from tokenhawk_tpu_torch.runtime.engine import make_prefill_fn
from tokenhawk_tpu_torch.runtime.loader import load_model
from tokenhawk_tpu_torch.runtime.paged_scheduler import PagedScheduler
from tokenhawk_tpu_torch.runtime.scheduler import Scheduler

from helpers import make_ggml_weights
from torch_helpers import padded_vocab, spm_metadata

ROOT = Path(__file__).resolve().parents[1]
CFG = LlamaConfig.tiny(n_vocab=512, n_embd=512, n_head=4, n_kv_head=1, n_layer=2, n_ff=768,
                       n_ctx=128, rope_theta=500000.0, rms_norm_eps=1e-5)
GGJT_CFG = LlamaConfig.tiny(n_vocab=300, n_embd=256, n_head=2, n_layer=2, n_ff=512, n_ctx=128)
PROMPTS = ["hello world, once more", "Tell me 3 stories about 42 cats"]
N_NEW = 16


def _write(kind, path):
    if kind == "q4_k_m":
        md = synth.bpe_vocab_metadata(CFG.n_vocab, np.random.default_rng(1), n_special=16)
        synth.write_random_llama(path, CFG, "q4_k_m", md, seed=11, std=0.05)
    elif kind == "q8_0":
        synth.write_random_llama(path, CFG, "q8_0", spm_metadata(CFG.n_vocab), seed=12,
                                 std=0.05)
    else:
        tensors = make_ggml_weights(GGJT_CFG, np.random.default_rng(13))
        for name, v in tensors.items():
            if v.ndim == 2 and name != "tok_embeddings.weight":
                q41 = name == "output.weight" or name.endswith("w2.weight")
                tensors[name] = quantize(v, GGMLType.Q4_1 if q41 else GGMLType.Q8_0)
        tokens, scores = padded_vocab(GGJT_CFG.n_vocab)
        hp = dict(n_vocab=GGJT_CFG.n_vocab, n_embd=GGJT_CFG.n_embd, n_mult=GGJT_CFG.n_mult,
                  n_head=GGJT_CFG.n_head, n_layer=GGJT_CFG.n_layer, n_rot=GGJT_CFG.head_dim,
                  ftype=7)
        write_ggml(path, hp, tokens, scores, tensors)
    return str(path)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("gguf_models")
    return {k: _write(k, d / f"{k}.{'bin' if k == 'ggjt' else 'gguf'}")
            for k in ("q4_k_m", "q8_0", "ggjt")}


@pytest.fixture(scope="module")
def loaded(files):
    out = {}
    for kind, path in files.items():
        j = j_load_model(path, n_ctx=CFG.n_ctx, dtype=jnp.float32, scale_dtype=jnp.float32)
        t = load_model(path, n_ctx=CFG.n_ctx, dtype=torch.float32, device="cpu",
                       scale_dtype=torch.float32)
        out[kind] = (j, t)
    return out


@pytest.fixture(scope="module")
def reference_tokens(loaded):
    """The reference Engine's 16 greedy tokens for each prompt, and its
    prompt ids."""
    out = {}
    for kind, ((jcfg, jparams, jtok), _) in loaded.items():
        eng = JEngine(jcfg, jparams, tokenizer=jtok, sampling=JSamplingConfig(temperature=0.0),
                      cache_dtype=jnp.float32, decode_chunk=4, eos_id=-1)
        out[kind] = [(jtok.encode_prompt(p), eng.generate(p, max_new_tokens=N_NEW).tokens)
                     for p in PROMPTS]
    return out


def _dense(w):
    """A projection's logical [K, N] values (either package), f32 numpy."""
    return np.asarray(w.dequantize(torch.float32) if isinstance(w, QWeight)
                      else w.dequantize(jnp.float32))


def _qkv(lp):
    if lp.wqkv is not None:
        return _dense(lp.wqkv)
    return np.concatenate([_dense(lp.wq), _dense(lp.wk), _dense(lp.wv)], axis=1)


def _w13(lp):
    return _dense(lp.w13) if lp.w13 is not None else np.concatenate(
        [_dense(lp.w1), _dense(lp.w3)], axis=1)


@pytest.mark.parametrize("kind", ["q4_k_m", "q8_0", "ggjt"])
def test_load_matches_reference(loaded, kind):
    (jcfg, jparams, jtok), (tcfg, tparams, ttok) = loaded[kind]
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    assert type(ttok).__name__ == type(jtok).__name__
    for p in PROMPTS:
        assert ttok.encode_prompt(p) == jtok.encode_prompt(p)
    np.testing.assert_array_equal(tparams.tok_embd.numpy(), np.asarray(jparams.tok_embd))
    np.testing.assert_array_equal(_dense(tparams.output), _dense(jparams.output))
    assert len(tparams.layers) == len(jparams.layers)
    for tp, jp in zip(tparams.layers, jparams.layers):
        for get in (_qkv, _w13):
            np.testing.assert_array_equal(get(tp), get(jp))
        for name in ("wo", "w2"):
            np.testing.assert_array_equal(_dense(getattr(tp, name)), _dense(getattr(jp, name)))
        assert isinstance(tp.w13, QWeight) and isinstance(tp.w2, QWeight)  # kernel 2's pair
    if kind == "q4_k_m":  # Q4_K_M: layer 1's Q6_K wv keeps wq | wk | wv apart
        assert tcfg.n_kv_head == 1 and tcfg.rope_theta == 500000.0
        assert tparams.layers[0].wqkv is not None and tparams.layers[1].wqkv is None
        assert (tparams.layers[1].wv.group, tparams.layers[1].w2.group) == (16, 16)
        assert tparams.output.group == 16 and tparams.output.mins is None


@pytest.mark.parametrize("kind", ["q4_k_m", "q8_0", "ggjt"])
def test_tokenizer_carries_the_servers_stop_ids_and_chat_template(files, loaded, kind):
    """The stop ids and chat template the reference's server derives from
    the file (tokenhawk_tpu/serving/__main__.py) are what the port's
    loaded tokenizer gives its server."""
    from tokenhawk_tpu.ggml.gguf import GGUFFile, is_gguf
    from tokenhawk_tpu_torch.sampling import tokenizer_eos

    (_, _, jtok), (_, _, ttok) = loaded[kind]
    eog = getattr(jtok, "eog_ids", None)
    want = tuple(sorted(int(e) for e in eog if e >= 0)) if eog else None
    if not want:
        want = getattr(jtok, "eos_id", 2)
    if want is None or (isinstance(want, int) and want < 0):
        want = 2
    assert tokenizer_eos(ttok) == want
    template = None
    if is_gguf(files[kind]):
        with GGUFFile(files[kind]) as gf:
            template = gf.metadata.get("tokenizer.chat_template")
    assert ttok.chat_template == template
    assert (template is not None) == (kind == "q4_k_m")


def _prompt(jtok):
    ids = jtok.encode_prompt(PROMPTS[1])
    toks = np.zeros((1, 48), np.int32)
    toks[0, :len(ids)] = ids
    return toks, np.array([len(ids)], np.int32), np.zeros(1, np.int32)


def _reference_logits(jcfg, jparams, jtok):
    toks, lens, offs = _prompt(jtok)
    _, out = j_make_prefill_fn(jcfg)(jparams, make_unrolled_cache(jcfg, 1, 64, jnp.float32),
                                     jnp.asarray(toks), jnp.asarray(lens), jnp.asarray(offs))
    return np.asarray(out)


def _port_logits(tcfg, tparams, jtok):
    toks, lens, offs = (torch.from_numpy(a) for a in _prompt(jtok))
    _, out = make_prefill_fn(tcfg)(tparams, tl.KVCache.create(tcfg, 1, 64, torch.float32, "cpu"),
                                   toks.long(), lens, offs)
    return out.numpy()


@pytest.mark.parametrize("kind", ["q4_k_m", "q8_0", "ggjt"])
def test_prefill_logits_match_reference(loaded, kind):
    (jcfg, jparams, jtok), (tcfg, tparams, _) = loaded[kind]
    want = _reference_logits(jcfg, jparams, jtok)
    np.testing.assert_allclose(_port_logits(tcfg, tparams, jtok), want, rtol=1e-4,
                               atol=1e-4 * np.abs(want).max())


@pytest.mark.parametrize("kind", ["q4_k_m", "q8_0", "ggjt"])
def test_reference_default_bf16_sides_move_the_logits(files, loaded, kind):
    """Both loaders round quant scales and mins to bfloat16 by default.
    At the defaults the dequantized weights are equal bit for bit and the
    prefill logits agree to f32 summation order; the rounding itself moves
    the logits away from the float32 load's by more than that tolerance.
    Prints the move (run with -s)."""
    (jcfg, _, jtok), (_, f32_params, _) = loaded[kind]
    _, jparams, _ = j_load_model(files[kind], n_ctx=CFG.n_ctx, dtype=jnp.float32)
    tcfg, tparams, _ = load_model(files[kind], n_ctx=CFG.n_ctx, dtype=torch.float32,
                                  device="cpu")
    for tp, jp in zip(tparams.layers, jparams.layers):
        for get in (_qkv, _w13):
            np.testing.assert_array_equal(get(tp), get(jp))
        for name in ("wo", "w2"):
            np.testing.assert_array_equal(_dense(getattr(tp, name)), _dense(getattr(jp, name)))
    np.testing.assert_array_equal(_dense(tparams.output), _dense(jparams.output))
    want = _reference_logits(jcfg, jparams, jtok)
    got = _port_logits(tcfg, tparams, jtok)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * np.abs(want).max())
    f32 = _port_logits(tcfg, f32_params, jtok)
    move, top = float(np.abs(f32 - got).max()), float(np.abs(want).max())
    print(f"{kind}: bf16 sides move the logits by {move:.4g} (max |logit| {top:.4g}, "
          f"{move / top:.2%})")
    assert 1e-4 * top < move < 0.05 * top


@pytest.mark.parametrize("kind", ["q4_k_m", "q8_0", "ggjt"])
@pytest.mark.parametrize("runtime", ["Engine", "Scheduler", "PagedScheduler"])
def test_greedy_tokens_match_reference(loaded, reference_tokens, kind, runtime):
    _, (tcfg, tparams, ttok) = loaded[kind]
    want = [toks for _, toks in reference_tokens[kind]]
    assert all(len(w) == N_NEW for w in want)
    greedy = SamplingConfig(temperature=0.0)
    if runtime == "Engine":
        eng = Engine(tcfg, tparams, tokenizer=ttok, sampling=greedy, cache_dtype=torch.float32,
                     decode_chunk=4, eos_id=-1)
        got = [eng.generate(p, max_new_tokens=N_NEW).tokens for p in PROMPTS]
    else:
        kw = dict(sampling=greedy, max_batch=2, cache_dtype=torch.float32, decode_chunk=4,
                  eos_id=-1)
        sched = (Scheduler(tcfg, tparams, **kw) if runtime == "Scheduler" else
                 PagedScheduler(tcfg, tparams, page_size=16, prefill_chunk=16, **kw))
        got = [r.output for r in sched.generate_many([ids for ids, _ in reference_tokens[kind]],
                                                     max_new_tokens=N_NEW)]
    assert got == want


@pytest.mark.parametrize("runtime", ["Scheduler", "PagedScheduler"])
def test_reference_schedulers_agree_on_q4_k_m(loaded, reference_tokens, runtime):
    """The reference's own schedulers give its Engine's tokens on the
    Q4_K_M file, so the port's three runtimes match all three of its."""
    (jcfg, jparams, _), _ = loaded["q4_k_m"]
    kw = dict(sampling=JSamplingConfig(temperature=0.0), max_batch=2, cache_dtype=jnp.float32,
              decode_chunk=4, eos_id=-1)
    sched = JDense(jcfg, jparams, **kw) if runtime == "Scheduler" else JPaged(
        jcfg, jparams, page_size=16, prefill_chunk=16, **kw)
    got = [r.output for r in sched.generate_many(
        [ids for ids, _ in reference_tokens["q4_k_m"]], max_new_tokens=N_NEW)]
    assert got == [toks for _, toks in reference_tokens["q4_k_m"]]


@pytest.fixture(scope="module")
def stop_file(files, loaded, reference_tokens, tmp_path_factory):
    """A copy of the q4_k_m file whose head rows of its third greedy token
    (for PROMPTS[0]) and <|eot_id|> are swapped: greedy decoding now
    stops on <|eot_id|> after two tokens."""
    _, (_, _, tok) = loaded["q4_k_m"]
    eot = tok.token_to_id["<|eot_id|>"]
    assert eot in tok.eog_ids and eot != tok.eos_id
    first = reference_tokens["q4_k_m"][0][1][:3]
    assert len(set(first)) == 3 and eot not in first
    path = str(tmp_path_factory.mktemp("stop") / "stop.gguf")
    shutil.copy(files["q4_k_m"], path)
    synth.swap_output_rows(path, first[2], eot)
    return path, first[:2]


def test_cli_stops_on_eot(stop_file):
    path, head = stop_file
    out = subprocess.run(
        [sys.executable, "-m", "tokenhawk_tpu_torch.cli", "-m", path, PROMPTS[0], "--device",
         "cpu", "--dtype", "f32", "--greedy", "--max-tokens", "8", "--n-ctx", "128"],
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=str(ROOT)), capture_output=True, text=True,
        timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert f"{len(head)} generated" in out.stderr, out.stderr[-2000:]


def _post(url, payload):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        return r.read().decode()


def test_paged_server_stops_on_eot_and_renders_the_chat_template(stop_file, loaded):
    import jinja2

    path, head = stop_file
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    proc = subprocess.Popen(
        [sys.executable, "-m", "tokenhawk_tpu_torch.serving", "-m", path, "--paged", "--device",
         "cpu", "--dtype", "f32", "--n-ctx", "128", "--page-size", "16", "--greedy", "--port",
         str(port)], cwd=ROOT, env=dict(os.environ, PYTHONPATH=str(ROOT)),
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
    base = f"http://127.0.0.1:{port}"
    try:
        deadline = time.time() + 120
        while True:
            try:
                with urllib.request.urlopen(base + "/health", timeout=5) as r:
                    json.loads(r.read())
                break
            except OSError:
                assert proc.poll() is None and time.time() < deadline, proc.stderr.read()
                time.sleep(0.5)
        frames = [f for f in _post(base + "/generate", {"prompt": PROMPTS[0],
                                                        "max_tokens": 8}).split("\n\n") if f]
        assert frames[-1].startswith("event: done")
        assert json.loads(frames[-1].split("data: ", 1)[1])["finish_reason"] == "eos"
        assert sum(f.startswith("data: {\"token\"") for f in frames) == len(head)

        messages = [{"role": "user", "content": "Hi there"}]
        chat = json.loads(_post(base + "/v1/chat/completions",
                                {"messages": messages, "max_tokens": 4}))
        rendered = jinja2.Template(synth.CHAT_TEMPLATE).render(messages=messages,
                                                                add_generation_prompt=True)
        tok = loaded["q4_k_m"][1][2]
        assert chat["usage"]["prompt_tokens"] == len(tok.encode_prompt(rendered))
        with urllib.request.urlopen(base + "/health", timeout=5) as r:
            assert json.loads(r.read())["step_errors"] == 0
    finally:
        proc.terminate()
        proc.wait(timeout=30)
