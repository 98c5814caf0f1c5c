"""Shared utilities of the tests of the PyTorch port (tests/test_torch_*.py)."""

from __future__ import annotations

import numpy as np
import pytest
import torch


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
