"""Rank-local sharded loading of the port (runtime/sharded_loader.py), the
twin of tests/test_sharded_loader.py.

On a tiny ggjt file at F32, Q8_0 and Q4_0, every rank's
load_model_sharded params are bit for bit load_model(..., mesh)'s (the
whole model loaded, then sliced: parallel/tp.py shard_params_tp); the
ranks together read each byte of the file's tensors about once (the
norms once a rank); a kind the reference's sharded loader does not read
is refused by name; and 2 spawned gloo ranks decode the sharded Q4_0
model greedily to the JAX package's tokens from its own load_model_sharded
on a 2-device model mesh.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tokenhawk_tpu.config import LlamaConfig, SamplingConfig
from tokenhawk_tpu.ggml.format import GGMLType
from tokenhawk_tpu.ggml.quants import quantize
from tokenhawk_tpu.ggml.writer import write_ggml
from tokenhawk_tpu.parallel import make_mesh as j_make_mesh
from tokenhawk_tpu.runtime.engine import Engine as JEngine
from tokenhawk_tpu.runtime.sharded_loader import load_model_sharded as j_load_model_sharded
from tokenhawk_tpu.tokenizer import byte_fallback_vocab
from tokenhawk_tpu_torch.ggml.reader import GGMLFile
from tokenhawk_tpu_torch.models.llama import LayerParams
from tokenhawk_tpu_torch.ops.qweight import QWeight
from tokenhawk_tpu_torch.parallel.mesh import TpMesh
from tokenhawk_tpu_torch.runtime.loader import load_model
from tokenhawk_tpu_torch.runtime.sharded_loader import load_model_sharded

from helpers import make_ggml_weights
from torch_dist import run_ranks
from torch_tp_workers import sharded_engine_worker

CFG = LlamaConfig.tiny(n_vocab=512, n_embd=256, n_head=4, n_ctx=64, n_ff=512)
VOCAB = [b"<unk>", b"<s>", b"</s>"] + [bytes([b]) for b in range(256)] + [
    bytes([65 + i // 26, 65 + i % 26]) for i in range(512 - 259)]
KINDS = {"f32": None, "q8_0": GGMLType.Q8_0, "q4_0": GGMLType.Q4_0}
PROMPT = [1, 9, 17, 33]


def _write(path, kind):
    tensors = make_ggml_weights(CFG, np.random.default_rng(41))
    if kind is not None:
        tensors = {k: (quantize(v, kind) if v.ndim == 2 and "norm" not in k
                       and k != "tok_embeddings.weight" else v) for k, v in tensors.items()}
    hp = dict(n_vocab=len(VOCAB), n_embd=CFG.n_embd, n_mult=CFG.n_mult, n_head=CFG.n_head,
              n_layer=CFG.n_layer, n_rot=CFG.head_dim, ftype=0)
    write_ggml(path, hp, VOCAB, None, tensors)
    return path


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("sharded")
    return {k: _write(d / f"{k}.bin", kind) for k, kind in KINDS.items()}


def _assert_same(a, b):
    if isinstance(a, QWeight):
        assert isinstance(b, QWeight) and (a.kind, a.group) == (b.kind, b.group)
        for x, y in zip(a.tensors(), b.tensors(), strict=True):
            assert x.dtype == y.dtype and torch.equal(x, y)
    elif a is None:
        assert b is None
    else:
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("kind", list(KINDS))
def test_sharded_load_is_load_model_sliced(files, kind, tp):
    for i in range(tp):
        mesh = TpMesh(None, i, tp)  # loading runs no collective
        cfg, got, _, _ = load_model_sharded(files[kind], mesh, n_ctx=64, device="cpu")
        want_cfg, want, _ = load_model(files[kind], n_ctx=64, device="cpu", mesh=mesh)
        assert cfg == want_cfg
        for name in ("tok_embd", "norm", "output"):
            _assert_same(getattr(got, name), getattr(want, name))
        for lg, lw in zip(got.layers, want.layers, strict=True):
            for f in dataclasses.fields(LayerParams):
                _assert_same(getattr(lg, f.name), getattr(lw, f.name))


def test_sharded_load_reads_each_byte_about_once(files):
    """The ranks together decode every tensor byte once, and the norms
    once a rank: not tp times the file."""
    tp = 4
    f = GGMLFile(files["f32"])
    tensor_bytes = sum(r.data_nbytes for r in f.tensors.values())
    norm_bytes = sum(r.data_nbytes for n, r in f.tensors.items() if "norm" in n)
    f.close()
    read = sum(load_model_sharded(files["f32"], TpMesh(None, i, tp), n_ctx=64,
                                  device="cpu")[3].bytes_read for i in range(tp))
    assert read == tensor_bytes + (tp - 1) * norm_bytes


def test_sharded_load_refuses_other_kinds(tmp_path):
    path = _write(tmp_path / "q4_1.bin", GGMLType.Q4_1)
    with pytest.raises(ValueError, match="Q4_1"):
        load_model_sharded(path, TpMesh(None, 0, 2), n_ctx=64, device="cpu")


def test_sharded_tp_engine_matches_jax_sharded_load(files, tmp_path):
    tp = 2
    got = run_ranks(sharded_engine_worker, tp, tmp_path, str(files["q4_0"]), PROMPT, 6)
    assert all(g == got[0] for g in got)
    mesh = j_make_mesh(dp=1, tp=tp)
    cfg, params, _, _ = j_load_model_sharded(files["q4_0"], mesh, n_ctx=64, dtype=jnp.float32,
                                             scale_dtype=jnp.float32)
    eng = JEngine(cfg, params, tokenizer=byte_fallback_vocab(),
                  sampling=SamplingConfig(temperature=0.0), cache_dtype=jnp.float32,
                  decode_chunk=4, mesh=mesh, parallel="tp")
    assert got[0] == eng.generate(PROMPT, max_new_tokens=6).tokens
