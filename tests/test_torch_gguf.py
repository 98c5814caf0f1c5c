"""The port's GGUF reader and writer (copies) against the JAX package's.

A file written by the reference's write_gguf, holding tensors of one
kind (F32, F16, Q4_0, Q8_0 as QuantizedTensors; Q5_0, Q5_1 and Q2_K..Q6_K
as RawTensors from the reference's packers and quantizers), reads to the
same metadata, hparams, config_overrides, records, raw bytes and tensors
in both packages, and the port's writer writes the same bytes.  A file
without output.weight ties it to token_embd in both, and the port's
load_model then serves the embedding as the head.  load_model builds the
tokenizer the file names: SentencePiece ("llama"), byte-level BPE
("gpt2"), or refuses another, as the reference does.  All exact.
"""

import dataclasses

import numpy as np
import pytest
import torch

from tokenhawk_tpu.ggml import gguf as j_gguf
from tokenhawk_tpu.ggml import kquants as j_kq
from tokenhawk_tpu.ggml.format import GGMLType as JType
from tokenhawk_tpu.ggml.quants import quantize as j_quantize
from tokenhawk_tpu.runtime.loader import load_model as j_load_model
from tokenhawk_tpu_torch.config import LlamaConfig
from tokenhawk_tpu_torch.ggml import gguf as t_gguf
from tokenhawk_tpu_torch.ggml import synth
from tokenhawk_tpu_torch.ggml.format import GGMLType as TType
from tokenhawk_tpu_torch.ggml.quants import QuantizedTensor as TQuantizedTensor
from tokenhawk_tpu_torch.runtime.loader import load_model as t_load_model
from tokenhawk_tpu_torch.tokenizer import Tokenizer
from tokenhawk_tpu_torch.tokenizer_bpe import BpeTokenizer

from torch_helpers import spm_metadata

CFG = LlamaConfig.tiny(n_vocab=320, n_embd=256, n_head=4, n_kv_head=2, n_layer=1, n_ff=512,
                       n_ctx=64, rope_theta=500000.0, rms_norm_eps=1e-5)
KINDS = ["F32", "F16", "Q4_0", "Q8_0", "Q5_0", "Q5_1", "Q2_K", "Q3_K", "Q4_K", "Q5_K", "Q6_K"]


def _tensor(kind, shape, rng):
    x = (rng.standard_normal(shape) * 0.05).astype(np.float32)
    if kind == "F32":
        return x
    if kind == "F16":
        return x.astype(np.float16)
    if kind in ("Q4_0", "Q8_0"):
        return j_quantize(x, JType[kind])
    pack = {"Q5_0": j_gguf.pack_q5_0_blocks, "Q5_1": j_gguf.pack_q5_1_blocks}.get(kind) or \
        getattr(j_kq, f"quantize_{kind.lower()}")
    return j_gguf.RawTensor(JType[kind], shape, pack(x.reshape(-1)))


def _to_port(t):
    if isinstance(t, j_gguf.RawTensor):
        return t_gguf.RawTensor(TType(int(t.kind)), t.shape, t.raw)
    if isinstance(t, np.ndarray):
        return t
    return TQuantizedTensor(TType(int(t.kind)), t.shape, t.qs, t.scales, t.mins)


@pytest.mark.parametrize("kind", KINDS)
def test_reader_and_writer_match_reference(tmp_path, kind):
    rng = np.random.default_rng(KINDS.index(kind))
    D, F, Dkv = CFG.n_embd, CFG.n_ff, CFG.n_embd_kv
    tensors = {"token_embd.weight": _tensor(kind, (CFG.n_vocab, D), rng),
               "output_norm.weight": np.ones(D, np.float32),
               "output.weight": _tensor(kind, (CFG.n_vocab, D), rng),
               "blk.0.attn_k.weight": _tensor(kind, (Dkv, D), rng),
               "blk.0.ffn_down.weight": _tensor(kind, (D, F), rng)}
    md = {**synth.llama_metadata(CFG, 1), **spm_metadata(CFG.n_vocab)}
    j_gguf.write_gguf(tmp_path / "j.gguf", md, tensors)
    t_gguf.write_gguf(tmp_path / "t.gguf", md, {k: _to_port(v) for k, v in tensors.items()})
    assert (tmp_path / "j.gguf").read_bytes() == (tmp_path / "t.gguf").read_bytes()

    with j_gguf.GGUFFile(tmp_path / "j.gguf") as jf, t_gguf.GGUFFile(tmp_path / "j.gguf") as tf:
        assert t_gguf.is_gguf(tmp_path / "j.gguf")
        assert tf.metadata == jf.metadata
        assert dataclasses.asdict(tf.hparams) == dataclasses.asdict(jf.hparams)
        assert tf.config_overrides == jf.config_overrides == {
            "n_ff": F, "n_kv_head": 2, "rms_norm_eps": pytest.approx(1e-5), "rope_theta": 500000.0}
        assert tf.vocab.tokens == jf.vocab.tokens
        assert [dataclasses.astuple(r) for r in tf.tensors.values()] == \
            [dataclasses.astuple(r) for r in jf.tensors.values()]
        for name in jf.tensors:
            assert bytes(tf.raw(name)) == bytes(jf.raw(name))
            a, b = jf.load_tensor(name), tf.load_tensor(name)
            if isinstance(a, np.ndarray):
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)
            else:
                assert int(a.kind) == int(b.kind) and a.shape == b.shape
                for f in ("qs", "scales", "mins"):
                    x, y = getattr(a, f), getattr(b, f)
                    assert (x is None) == (y is None)
                    if x is not None:
                        np.testing.assert_array_equal(x, y)


def test_tied_embeddings(tmp_path):
    """No output.weight: both readers alias token_embd, and the port's
    head is the embedding (a Q4_K head in the group-code form, the
    embedding dequantized: equal values)."""
    path = tmp_path / "tied.gguf"
    cfg = dataclasses.replace(CFG, n_layer=2)
    synth.write_random_llama(path, cfg, "q4_k_m", spm_metadata(cfg.n_vocab), seed=1, tied=True)
    with j_gguf.GGUFFile(path) as jf, t_gguf.GGUFFile(path) as tf:
        for f in (jf, tf):
            assert dataclasses.astuple(f.tensors["output.weight"])[1:] == \
                dataclasses.astuple(f.tensors["tok_embeddings.weight"])[1:]
    _, params, _ = t_load_model(str(path), n_ctx=64, dtype=torch.float32, device="cpu",
                                scale_dtype=torch.float32)
    assert params.output.kind == "qk" and params.output.group == 32
    assert torch.equal(params.output.dequantize(), params.tok_embd.t())


@pytest.mark.parametrize("model", ["llama", "gpt2", "bert"])
def test_tokenizer_choice(tmp_path, model):
    path = tmp_path / f"{model}.gguf"
    md = (synth.bpe_vocab_metadata(CFG.n_vocab, np.random.default_rng(0), 16)
          if model == "gpt2" else spm_metadata(CFG.n_vocab))
    md["tokenizer.ggml.model"] = model
    synth.write_random_llama(path, CFG, "q8_0", md, seed=2)
    if model == "bert":
        for load in (j_load_model, t_load_model):
            with pytest.raises(ValueError, match="tokenizer model"):
                load(str(path), n_ctx=64)
        return
    _, _, jt = j_load_model(str(path), n_ctx=64)
    _, _, tt = t_load_model(str(path), n_ctx=64, dtype=torch.float32, device="cpu")
    assert isinstance(tt, BpeTokenizer if model == "gpt2" else Tokenizer)
    assert type(tt).__name__ == type(jt).__name__
    assert (tt.bos_id, tt.eos_id) == (jt.bos_id, jt.eos_id)
    text = "Hello world, it's 42"
    assert tt.encode_prompt(text) == jt.encode_prompt(text)
