"""The port runs where jax is absent (the GPU machine has none).

A subprocess blocks `jax` and `regex` (sys.modules["jax"] = None makes
any import of it fail; the GPU machine has neither), imports every
module of tokenhawk_tpu_torch, checks that nothing of tokenhawk_tpu came
along, runs the byte-level BPE tokenizer, a tiny Engine.generate (bf16
and int8 caches, then with the fused decode-layer kernels 15 and 16 that
THAWK_FUSED_OWO / THAWK_FUSED_ATTN turn on), both continuous-batching schedulers (the paged one
on bf16 and int8 pages), speculative decoding (SpeculativeEngine and
both schedulers with a draft) and the perplexity of a Q4_K_M model in the
super-block form (runtime/eval.py) and a context-parallel
Engine.generate (parallel/, a gloo group of one rank) and a decode run of
the bench (bench.py) on the CPU.  A source scan backs it up for imports
inside functions.
"""

import re
import subprocess
import sys
from pathlib import Path

from torch_helpers import subprocess_env

ROOT = Path(__file__).resolve().parents[1]

SCRIPT = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None
sys.modules["regex"] = None
import torch
import tokenhawk_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for n in names:
    importlib.import_module(n)
assert not any(m == "tokenhawk_tpu" or m.startswith("tokenhawk_tpu.") for m in sys.modules)
import numpy as np
from tokenhawk_tpu_torch.ggml.synth import bpe_vocab_metadata
from tokenhawk_tpu_torch.tokenizer_bpe import BpeTokenizer
bpe = BpeTokenizer.from_gguf_metadata(bpe_vocab_metadata(600, np.random.default_rng(0), 16))
assert bpe.decode(bpe.encode("Hi there, it's 2024!<|eot_id|>")) == "Hi there, it's 2024!"
from tokenhawk_tpu_torch.config import LlamaConfig, SamplingConfig
from tokenhawk_tpu_torch.models.llama import fuse_params, init_params
from tokenhawk_tpu_torch.runtime.engine import Engine
from tokenhawk_tpu_torch.tokenizer import byte_fallback_vocab
cfg = LlamaConfig.tiny(n_vocab=300, n_embd=256, n_head=2, n_layer=2, n_ff=512, n_ctx=128)
for quant in ("q4_0", None):  # Q4_0 projections, then dense ones
    params = fuse_params(init_params(cfg, torch.Generator().manual_seed(0),
                                     dtype=torch.float32, device="cpu", quant=quant))
    eng = Engine(cfg, params, byte_fallback_vocab(), SamplingConfig(temperature=0.7),
                 cache_dtype=torch.float32, decode_chunk=4, eos_id=-1)
    r = eng.generate("hi there", max_new_tokens=9)
    assert len(r.tokens) == 9 and all(0 <= t < 300 for t in r.tokens), r.tokens
import os
from tokenhawk_tpu_torch.models import llama as M
calls = {"fused_owo_ffn": 0, "fused_attn_out": 0}
def spy(name):
    fn = getattr(M, name)
    def run(*args, **kwargs):
        calls[name] += 1
        return fn(*args, **kwargs)
    setattr(M, name, run)
for name in calls:
    spy(name)
os.environ.update(THAWK_FUSED_OWO="1", THAWK_FUSED_ATTN="1")
fcfg = LlamaConfig.tiny(n_vocab=300, n_embd=512, n_head=4, n_layer=2, n_ff=512, n_ctx=128)
fparams = fuse_params(init_params(fcfg, torch.Generator().manual_seed(0), dtype=torch.float32,
                                  device="cpu", quant="q4_0"))
del os.environ["THAWK_FUSED_OWO"], os.environ["THAWK_FUSED_ATTN"]
assert fparams.fusions == M.Fusions(owo=True, attn=True), fparams.fusions
for fusions in (M.Fusions(owo=True, attn=True), M.Fusions(owo=True)):
    fparams.fusions = fusions  # kernel 16 then kernel 2, or kernel 15, at each decode step
    r = Engine(fcfg, fparams, byte_fallback_vocab(), SamplingConfig(temperature=0.0),
               cache_dtype=torch.float32, decode_chunk=4, eos_id=-1).generate("hi", max_new_tokens=5)
    assert len(r.tokens) == 5 and all(0 <= t < 300 for t in r.tokens), r.tokens
assert all(calls.values()), calls
from tokenhawk_tpu_torch.runtime.paged_scheduler import PagedScheduler
from tokenhawk_tpu_torch.runtime.scheduler import Scheduler
eng = Engine(cfg, params, byte_fallback_vocab(), SamplingConfig(temperature=0.7), max_seq=1024,
             cache_dtype="auto", decode_chunk=4, eos_id=-1)
assert eng.cache_dtype == "int8"
assert len(eng.generate("hi there", max_new_tokens=9).tokens) == 9
for sched in (PagedScheduler(cfg, params, max_batch=2, cache_dtype=torch.float32, page_size=16,
                             prefix_cache=True, prefill_chunk=32, eos_id=-1),
              PagedScheduler(cfg, params, max_batch=2, cache_dtype="int8", page_size=16,
                             prefix_cache=True, prefill_chunk=32, eos_id=-1, layout="head"),
              Scheduler(cfg, params, max_batch=2, cache_dtype=torch.float32, eos_id=-1)):
    reqs = sched.generate_many([[1, 5, 9], list(range(3, 70))], max_new_tokens=5)
    assert [r.finish_reason for r in reqs] == ["length"] * 2, reqs
from tokenhawk_tpu_torch.runtime.speculative import SpeculativeEngine
toks, stats = SpeculativeEngine(cfg, params, cfg, params, gamma=3,
                                cache_dtype=torch.float32, eos_id=-1).generate([1, 5], 9)
assert len(toks) == 9 and stats["rounds"] > 0
for sched in (Scheduler(cfg, params, max_batch=2, cache_dtype=torch.float32, eos_id=-1,
                        draft_cfg=cfg, draft_params=params),
              PagedScheduler(cfg, params, max_batch=2, cache_dtype=torch.float32, page_size=16,
                             eos_id=-1, draft_cfg=cfg, draft_params=params)):
    reqs = sched.generate_many([[1, 5, 9], list(range(3, 40))], max_new_tokens=5)
    assert [r.finish_reason for r in reqs] == ["length"] * 2, reqs
import math
from tokenhawk_tpu_torch.runtime.eval import perplexity
scfg = LlamaConfig.tiny(n_vocab=300, n_embd=1024, n_head=8, n_layer=2, n_ff=1024, n_ctx=64)
sparams = fuse_params(init_params(scfg, torch.Generator().manual_seed(0), dtype=torch.float32,
                                  device="cpu", quant="q4_k_m", sb=True))
assert sparams.layers[0].wqkv.kind == "q4k_sb" and sparams.layers[0].w2.kind == "qk"
assert math.isfinite(perplexity(scfg, sparams, list(range(3, 67)), window=32))
import tempfile
import torch.distributed as dist
from tokenhawk_tpu_torch.parallel.mesh import make_cp_mesh
with tempfile.TemporaryDirectory() as tmp:
    dist.init_process_group("gloo", init_method=f"file://{tmp}/store", rank=0, world_size=1)
    r = Engine(cfg, params, byte_fallback_vocab(), SamplingConfig(temperature=0.7),
               cache_dtype=torch.float32, decode_chunk=4, eos_id=-1, mesh=make_cp_mesh(),
               parallel="cp").generate("hi there", max_new_tokens=9)
    dist.destroy_process_group()
assert len(r.tokens) == 9 and all(0 <= t < 300 for t in r.tokens), r.tokens
import contextlib, dataclasses, io
from tokenhawk_tpu_torch import bench
with contextlib.redirect_stdout(io.StringIO()):  # the bench's JSON line
    rec = bench.run(dataclasses.replace(cfg, n_ctx=256), bench.parse_args(
        ["--device", "cpu", "--mode", "decode", "--ctx", "256", "--prompt-tokens", "16",
         "--tokens", "16", "--chunk", "8"]))
assert rec["metric"] == "llama7b_q4_0_decode_tokens_per_sec" and rec["value"] > 0, rec
print("OK", len(names))
"""


def test_port_imports_and_generates_without_jax():
    out = subprocess.run([sys.executable, "-c", SCRIPT], cwd=ROOT, env=subprocess_env(),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.startswith("OK")


def test_port_sources_import_no_jax():
    pat = re.compile(r"^\s*(import|from)\s+(jax|tokenhawk_tpu|regex)\b", re.M)
    files = sorted((ROOT / "tokenhawk_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 20
    offenders = [str(f) for f in files if pat.search(f.read_text())]
    assert offenders == []
