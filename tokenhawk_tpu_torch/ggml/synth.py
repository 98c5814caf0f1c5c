"""Random GGUF LLaMA files from a seed (tests, and chip_smoke.py at full width).

Projections are random block streams of the kinds a llama.cpp recipe
picks, written as they are (gguf.RawTensor): nothing is quantized, so a
Llama-3-8B-width file takes seconds where quantizing dense weights in
numpy would take minutes.  Every block's f16 d (and dmin) is finite and
sized so that the weights come out with a standard deviation of about
`std`.  The vocabulary is byte-level BPE (tokenizer.ggml.model "gpt2",
pre "llama-bpe"): the 256 byte tokens, seeded merges, and Llama-3's
special tokens at the top (<|begin_of_text|> first, <|eot_id|> ninth
after it).

    recipe "q4_k_m": Q4_K everywhere, Q6_K for output and for attn_v and
                     ffn_down on the layers Q4_K_M gives more bits
                     (q4_k_m_more_bits), token_embd Q4_K;
    recipe "q8_0":   Q8_0 everywhere (random codes, f16 scales).
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from tokenhawk_tpu_torch.ggml.format import QK, GGMLType
from tokenhawk_tpu_torch.ggml.gguf import RawTensor, write_gguf
from tokenhawk_tpu_torch.ggml.kquants import KQUANT_BLOCK_BYTES, QK_K
from tokenhawk_tpu_torch.ggml.quants import QuantizedTensor
from tokenhawk_tpu_torch.models.llama import q4_k_m_more_bits
from tokenhawk_tpu_torch.tokenizer_bpe import CONTROL, NORMAL, bytes_to_unicode

# Per k-quant kind: byte offsets of the f16 d and dmin in a block, the
# divisor that turns a weight std into d for uniform random codes and
# sub-scales, and dmin / d (which centres the affine kinds' weights).
_BLOCK_D = {
    GGMLType.Q2_K: (80, 82, 8.4, 1.5),
    GGMLType.Q3_K: (108, None, 37.0, 0.0),
    GGMLType.Q4_K: (0, 2, 145.0, 7.5),
    GGMLType.Q5_K: (0, 2, 290.0, 15.5),
    GGMLType.Q6_K: (208, None, 1184.0, 0.0),
}

LLAMA3_SPECIALS = ["<|begin_of_text|>", "<|end_of_text|>"] + [
    f"<|reserved_special_token_{i}|>" for i in range(4)] + [
    "<|start_header_id|>", "<|end_header_id|>", "<|reserved_special_token_4|>", "<|eot_id|>"]

# Llama-3's chat format (the tokenizer adds <|begin_of_text|> itself).
CHAT_TEMPLATE = (
    "{% for m in messages %}<|start_header_id|>{{ m['role'] }}<|end_header_id|>\n\n"
    "{{ m['content'] }}<|eot_id|>{% endfor %}"
    "{% if add_generation_prompt %}<|start_header_id|>assistant<|end_header_id|>\n\n{% endif %}")


def random_kquant(kind: GGMLType, shape, rng: np.random.Generator, std: float = 0.02):
    """A random [out, in] tensor of k-quant `kind` as GGUF blocks."""
    n = int(np.prod(shape))
    if n % QK_K:
        raise ValueError(f"{kind.name} needs a multiple of {QK_K} elements, got {shape}")
    nb, size = n // QK_K, KQUANT_BLOCK_BYTES[kind]
    buf = np.frombuffer(bytearray(rng.bytes(nb * size)), np.uint8).reshape(nb, size)
    d_at, m_at, div, ratio = _BLOCK_D[kind]
    d = (std / div * (0.75 + 0.5 * rng.random(nb))).astype("<f2")
    buf[:, d_at:d_at + 2] = d.view(np.uint8).reshape(nb, 2)
    if m_at is not None:
        dmin = (d.astype(np.float32) * ratio).astype("<f2")
        buf[:, m_at:m_at + 2] = dmin.view(np.uint8).reshape(nb, 2)
    return RawTensor(kind, tuple(shape), buf.tobytes())


def random_q8_0(shape, rng: np.random.Generator, std: float = 0.02) -> QuantizedTensor:
    """A random [out, in] Q8_0 tensor whose scales are exact in f16."""
    out_dim, in_dim = shape
    qs = rng.integers(-127, 128, size=shape, dtype=np.int8)
    d = (std / 73.6 * (0.75 + 0.5 * rng.random((out_dim, in_dim // QK))))
    return QuantizedTensor(GGMLType.Q8_0, tuple(shape), qs,
                           d.astype(np.float16).astype(np.float32))


def bpe_vocab_metadata(n_vocab: int, rng: np.random.Generator, n_special: int = 256) -> Dict:
    """tokenizer.* metadata of a byte-level BPE vocab of n_vocab tokens:
    the 256 byte tokens, then merges of a pool token with one letter,
    digit or the space mark (so prompts of words merge), then n_special
    >= 10 CONTROL tokens that begin with LLAMA3_SPECIALS."""
    if n_special < len(LLAMA3_SPECIALS):
        raise ValueError(f"n_special {n_special} < {len(LLAMA3_SPECIALS)}")
    enc = bytes_to_unicode()
    tokens: List[str] = [enc[b] for b in range(256)]
    seen = set(tokens)
    base = [enc[b] for b in b" abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789"]
    pool = list(base)
    merges: List[str] = []
    n_regular = n_vocab - n_special
    while len(tokens) < n_regular:
        for a, b in zip(rng.integers(0, len(pool), 4096), rng.integers(0, len(base), 4096)):
            left, right = pool[a], base[b]
            if left + right in seen:
                continue
            merges.append(f"{left} {right}")
            tokens.append(left + right)
            seen.add(left + right)
            pool.append(left + right)
            if len(tokens) == n_regular:
                break
    specials = (LLAMA3_SPECIALS + [f"<|reserved_special_token_{i}|>"
                                   for i in range(5, n_special)])[:n_special]
    return {
        "tokenizer.ggml.model": "gpt2",
        "tokenizer.ggml.pre": "llama-bpe",
        "tokenizer.ggml.tokens": tokens + specials,
        "tokenizer.ggml.token_type": [NORMAL] * len(tokens) + [CONTROL] * len(specials),
        "tokenizer.ggml.merges": merges,
        "tokenizer.ggml.bos_token_id": n_regular,
        "tokenizer.ggml.eos_token_id": n_regular + 1,
        "tokenizer.chat_template": CHAT_TEMPLATE,
    }


def llama_metadata(cfg, file_type: int) -> Dict:
    """general.* and llama.* metadata of a LlamaConfig."""
    return {
        "general.architecture": "llama",
        "general.file_type": file_type,
        "llama.embedding_length": cfg.n_embd,
        "llama.block_count": cfg.n_layer,
        "llama.attention.head_count": cfg.n_head,
        "llama.attention.head_count_kv": cfg.n_kv_head,
        "llama.feed_forward_length": cfg.n_ff,
        "llama.rope.dimension_count": cfg.head_dim,
        "llama.rope.freq_base": float(cfg.rope_theta),
        "llama.attention.layer_norm_rms_epsilon": float(cfg.rms_norm_eps),
    }


def write_random_llama(path, cfg, recipe: str, tokenizer_md: Dict, seed: int,
                       std: float = 0.02, tied: bool = False) -> None:
    """A random LLaMA-family GGUF of cfg's widths in `recipe` ("q4_k_m"
    or "q8_0"); norm gains are f32 near 1.  With `tied`, no output.weight
    (the reader ties it to token_embd)."""
    if recipe not in ("q4_k_m", "q8_0"):
        raise ValueError(f"unknown recipe {recipe!r}")
    rng = np.random.default_rng(seed)
    D, F, V, Dkv = cfg.n_embd, cfg.n_ff, cfg.n_vocab, cfg.n_kv_head * cfg.head_dim

    def w(out_dim, in_dim, kind=GGMLType.Q4_K):
        if recipe == "q8_0":
            return random_q8_0((out_dim, in_dim), rng, std)
        return random_kquant(kind, (out_dim, in_dim), rng, std)

    def gain():
        return (1.0 + 0.1 * rng.standard_normal(D)).astype(np.float32)

    tensors = {"token_embd.weight": w(V, D), "output_norm.weight": gain()}
    if not tied:
        tensors["output.weight"] = w(V, D, GGMLType.Q6_K)
    for i in range(cfg.n_layer):
        more = GGMLType.Q6_K if q4_k_m_more_bits(i, cfg.n_layer) else GGMLType.Q4_K
        p = f"blk.{i}."
        tensors.update({
            p + "attn_norm.weight": gain(), p + "attn_q.weight": w(D, D),
            p + "attn_k.weight": w(Dkv, D), p + "attn_v.weight": w(Dkv, D, more),
            p + "attn_output.weight": w(D, D), p + "ffn_norm.weight": gain(),
            p + "ffn_gate.weight": w(F, D), p + "ffn_down.weight": w(D, F, more),
            p + "ffn_up.weight": w(F, D)})
    # general.file_type: llama.cpp's LLAMA_FTYPE_MOSTLY_Q8_0 = 7, _Q4_K_M = 15
    md = {**llama_metadata(cfg, 7 if recipe == "q8_0" else 15), **tokenizer_md}
    write_gguf(path, md, tensors)


def swap_output_rows(path, a: int, b: int) -> None:
    """Swap rows a and b of a GGUF file's output.weight in place, so the
    head scores token a as it scored b and b as a: the way to make a
    random model emit a chosen token (a stop id) where it would have
    emitted another."""
    from tokenhawk_tpu_torch.ggml.gguf import GGUFFile

    with GGUFFile(path) as f:
        rec, emb = f.tensors["output.weight"], f.tensors["tok_embeddings.weight"]
    if rec.data_offset == emb.data_offset:
        raise ValueError("output.weight is tied to the embedding")
    row = rec.data_nbytes // rec.shape[0]
    with open(path, "r+b") as fh:
        rows = []
        for i in (a, b):
            fh.seek(rec.data_offset + i * row)
            rows.append(fh.read(row))
        for i, data in zip((a, b), reversed(rows)):
            fh.seek(rec.data_offset + i * row)
            fh.write(data)
