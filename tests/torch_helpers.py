"""Shared utilities of the tests of the PyTorch port (tests/test_torch_*.py)."""

from __future__ import annotations

import os

import numpy as np
import pytest
import torch

# The suite runs in several worker processes on one CPU; torch's default of
# one intra-op thread per core in each of them oversubscribes the cores, and
# the many tiny ops of these tests then wait on each other's threads.
torch.set_num_threads(1)


def subprocess_env(**extra) -> dict:
    """os.environ, with `extra`, for a process a test starts: one OpenMP
    and MKL thread, as this process has.  Torch's default of a thread per
    core in each of several such processes beside the suite's workers
    oversubscribes the cores by an order of magnitude."""
    return dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1", **extra)


def cuda_device() -> torch.device:
    """The GPU for a kernel test; skips the test where there is none.

    Called inside the test, never at import: every pytest-xdist worker
    must collect the same tests."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    return torch.device("cuda")


def t(a, dtype=None, device=None) -> torch.Tensor:
    """numpy -> torch (copied, so the numpy array stays untouched)."""
    return torch.from_numpy(np.array(a)).to(device=device, dtype=dtype)


def jax_q4(w: np.ndarray):
    """Dense [K, N] -> the JAX package's packed q4_0 QWeight (f32 scales)
    and the port's QWeight built from the same packed arrays."""
    from tokenhawk_tpu.ops.qweight import quantize_array
    from tokenhawk_tpu_torch.ops.qweight import QWeight

    qw = quantize_array(w, "q4_0")
    pw = QWeight.from_jax_packed(np.asarray(qw.qs), np.asarray(qw.scales),
                                 np.asarray(qw.scales_hi))
    return qw, pw


def padded_vocab(n: int):
    """Byte-fallback vocab (specials + 256 bytes) padded with unused pieces
    to n entries: (tokens, scores)."""
    from tokenhawk_tpu_torch.tokenizer import byte_fallback_vocab

    v = byte_fallback_vocab()
    pad = n - v.n_vocab
    return (v.id_to_token + [f"<unused{i}>".encode() for i in range(pad)],
            v.scores + [-1e9] * pad)


def numpy_params(params):
    """The JAX package's LlamaParams as the numpy mapping the port's
    params_from_jax takes (stacked or unrolled layers)."""
    import dataclasses

    from tokenhawk_tpu.ops.qweight import QWeight as JQWeight

    def conv(w):
        if w is None:
            return None
        if isinstance(w, JQWeight) and w.kind == "q4_0":
            return {"qs": np.asarray(w.qs), "scales": np.asarray(w.scales, np.float32),
                    "scales_hi": np.asarray(w.scales_hi, np.float32)}
        if isinstance(w, JQWeight):  # int codes [K, N] with [K//G, N] sides
            return {"kind": w.kind, "group": w.group, "qs": np.asarray(w.qs).astype(np.int8),
                    "scales": np.asarray(w.scales, np.float32),
                    "mins": None if w.mins is None else np.asarray(w.mins, np.float32)}
        return np.asarray(w, np.float32)

    def layer(lp):
        return {f.name: conv(getattr(lp, f.name)) for f in dataclasses.fields(lp)}

    lay = params.layers
    return {"tok_embd": conv(params.tok_embd), "norm": conv(params.norm),
            "output": conv(params.output),
            "layers": [layer(lp) for lp in lay] if isinstance(lay, tuple) else layer(lay)}


def port_config(jcfg):
    """The port's LlamaConfig equal to a JAX LlamaConfig."""
    import dataclasses

    from tokenhawk_tpu_torch.config import LlamaConfig

    return LlamaConfig(**dataclasses.asdict(jcfg))


def spm_metadata(n_vocab: int) -> dict:
    """GGUF tokenizer.* metadata of a SentencePiece vocab: <unk>, <s>,
    </s>, the 256 byte pieces, then word pieces up to n_vocab."""
    tokens = ["<unk>", "<s>", "</s>"] + [f"<0x{b:02X}>" for b in range(256)]
    tokens += [f"\u2581w{i}" for i in range(n_vocab - len(tokens))]
    return {"tokenizer.ggml.model": "llama", "tokenizer.ggml.tokens": tokens,
            "tokenizer.ggml.scores": [0.0] * 259 + [-1.0 - i for i in range(n_vocab - 259)],
            "tokenizer.ggml.token_type": [2, 3, 3] + [6] * 256 + [1] * (n_vocab - 259),
            "tokenizer.ggml.bos_token_id": 1, "tokenizer.ggml.eos_token_id": 2}
