"""The port's copies of the jax-free host modules against their originals.

Importing any module of tokenhawk_tpu runs its jax patches, so the port
carries copies of config, ggml I/O, the SentencePiece tokenizer and the
timing helpers.  These tests hold each copy to its original: the source
text (apart from the rewritten imports and the note on top), and the
results of the reader, writer, quantizers and tokenizer on the same
generated inputs.
"""

import dataclasses
import re
from pathlib import Path

import numpy as np
import pytest

from tokenhawk_tpu import config as j_config
from tokenhawk_tpu import tokenizer as j_tok
from tokenhawk_tpu.ggml import chunked as j_chunked
from tokenhawk_tpu.ggml import quants as j_quants
from tokenhawk_tpu.ggml import reader as j_reader
from tokenhawk_tpu.ggml import writer as j_writer
from tokenhawk_tpu.ggml.format import GGMLType as JType
from tokenhawk_tpu.utils import timing as j_timing
from tokenhawk_tpu_torch import config as t_config
from tokenhawk_tpu_torch import tokenizer as t_tok
from tokenhawk_tpu_torch.ggml import chunked as t_chunked
from tokenhawk_tpu_torch.ggml import quants as t_quants
from tokenhawk_tpu_torch.ggml import reader as t_reader
from tokenhawk_tpu_torch.ggml import writer as t_writer
from tokenhawk_tpu_torch.ggml.format import GGMLType as TType
from tokenhawk_tpu_torch.utils import timing as t_timing

from helpers import make_ggml_weights
from torch_helpers import padded_vocab

ROOT = Path(__file__).resolve().parents[1]
COPIES = ["config.py", "tokenizer.py", "ggml/format.py", "ggml/quants.py", "ggml/reader.py",
          "ggml/writer.py", "ggml/chunked.py", "ggml/kquants.py", "ggml/gguf.py",
          "utils/timing.py", "serving/server.py"]
CFG = j_config.LlamaConfig.tiny(n_vocab=300, n_embd=128, n_head=2, n_layer=2, n_ff=256)


@pytest.mark.parametrize("rel", COPIES)
def test_copy_source_matches_original(rel):
    orig = (ROOT / "tokenhawk_tpu" / rel).read_text()
    copy = (ROOT / "tokenhawk_tpu_torch" / rel).read_text()
    body = "".join(copy.splitlines(keepends=True)[3:])  # drop the 3-line note
    want = re.sub(r"\btokenhawk_tpu\.", "tokenhawk_tpu_torch.", orig)
    assert body == re.sub(r"/\w+/reference/", "", want)  # upstream citations: bare file:line


def _tensors(kind):
    tensors = make_ggml_weights(CFG, np.random.default_rng(7))
    if kind is None:
        return tensors
    return {k: (j_quants.quantize(v, kind)
                if v.ndim == 2 and "norm" not in k and k != "tok_embeddings.weight" else v)
            for k, v in tensors.items()}


def _to_port(v):
    if isinstance(v, np.ndarray):
        return v
    return t_quants.QuantizedTensor(TType(int(v.kind)), v.shape, v.qs, v.scales, v.mins)


@pytest.mark.parametrize("kind", [None, JType.Q4_0, JType.Q8_0, JType.Q4_1])
def test_writer_and_reader_match(tmp_path, kind):
    tensors = _tensors(kind)
    tokens, scores = padded_vocab(CFG.n_vocab)
    hp = dict(n_vocab=CFG.n_vocab, n_embd=CFG.n_embd, n_mult=CFG.n_mult, n_head=CFG.n_head,
              n_layer=CFG.n_layer, n_rot=CFG.head_dim, ftype=2)
    j_writer.write_ggml(tmp_path / "j.bin", hp, tokens, scores, tensors)
    t_writer.write_ggml(tmp_path / "t.bin", hp, tokens, scores,
                        {k: _to_port(v) for k, v in tensors.items()})
    assert (tmp_path / "j.bin").read_bytes() == (tmp_path / "t.bin").read_bytes()

    jf, tf = j_reader.GGMLFile(tmp_path / "j.bin"), t_reader.GGMLFile(tmp_path / "j.bin")
    assert dataclasses.asdict(jf.hparams) == dataclasses.asdict(tf.hparams)
    assert jf.vocab.tokens == tf.vocab.tokens and jf.vocab.scores == tf.vocab.scores
    assert list(jf.tensors) == list(tf.tensors)
    for name in jf.tensors:
        a, b = jf.load_tensor(name), tf.load_tensor(name)
        if isinstance(a, np.ndarray):
            np.testing.assert_array_equal(a, b)
        else:
            assert int(a.kind) == int(b.kind) and a.shape == b.shape
            np.testing.assert_array_equal(a.qs, b.qs)
            np.testing.assert_array_equal(a.scales, b.scales)
    jf.close()
    tf.close()


def test_chunked_reader_matches(tmp_path):
    tokens, scores = padded_vocab(CFG.n_vocab)
    hp = dict(n_vocab=CFG.n_vocab, n_embd=CFG.n_embd, n_head=CFG.n_head,
              n_layer=CFG.n_layer, ftype=2)
    j_writer.write_ggml(tmp_path / "m.bin", hp, tokens, scores, _tensors(JType.Q4_0))
    j_chunked.split_ggml(tmp_path / "m.bin", tmp_path / "chunks", max_chunk_bytes=200_000)
    jr, tr = j_chunked.ChunkedReader(tmp_path / "chunks"), t_chunked.ChunkedReader(tmp_path / "chunks")
    assert list(jr.tensors) == list(tr.tensors)
    for name in jr.tensors:
        np.testing.assert_array_equal(jr.load_tensor(name, dequant=True),
                                      tr.load_tensor(name, dequant=True))


@pytest.mark.parametrize("kind", ["q4_0", "q8_0", "q4_1"])
def test_quantizers_match(kind):
    x = np.random.default_rng(1).standard_normal((8, 96)).astype(np.float32)
    a = getattr(j_quants, f"quantize_{kind}")(x)
    b = getattr(t_quants, f"quantize_{kind}")(x)
    np.testing.assert_array_equal(a.qs, b.qs)
    np.testing.assert_array_equal(a.scales, b.scales)
    assert j_quants.to_blocks(a) == t_quants.to_blocks(b)
    np.testing.assert_array_equal(j_quants.dequantize(a), t_quants.dequantize(b))
    kt = TType[a.kind.name]
    np.testing.assert_array_equal(
        t_quants.from_blocks(kt, t_quants.to_blocks(b), b.shape).qs, b.qs)


@pytest.mark.parametrize("text", ["Hello world", "héllo, wörld! 😀", "", "  spaces\tand\nlines"])
def test_tokenizer_matches(text):
    extra = {"▁he": -1.0, "ll": -2.0, "llo": -1.5, "▁hello": -0.5, "wor": -3.0, "ld": -2.5}
    j = j_tok.byte_fallback_vocab(extra)
    t = t_tok.byte_fallback_vocab(extra)
    assert j.encode_prompt(text) == t.encode_prompt(text)
    assert j.encode(text, add_bos=False) == t.encode(text, add_bos=False)
    ids = j.encode_prompt(text)
    assert j.decode(ids) == t.decode(ids)
    assert [j.decode_token_bytes(i) for i in ids] == [t.decode_token_bytes(i) for i in ids]


def test_config_and_timing_match():
    for preset in ("tiny", "llama_7b", "llama_13b", "llama2_70b"):
        a = getattr(j_config.LlamaConfig, preset)()
        b = getattr(t_config.LlamaConfig, preset)()
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
        assert (a.head_dim, a.n_embd_kv, a.q_per_kv) == (b.head_dim, b.n_embd_kv, b.q_per_kv)
    assert (dataclasses.asdict(j_config.SamplingConfig())
            == dataclasses.asdict(t_config.SamplingConfig()))
    samples = list(np.random.default_rng(2).exponential(5.0, 200))
    assert j_timing.descriptive_stats(samples) == t_timing.descriptive_stats(samples)
