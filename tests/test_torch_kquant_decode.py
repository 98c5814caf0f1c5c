"""ggml/kquant_decode.py, the loader's k-quant unpacking in torch, against
the numpy decode it replaces (ggml/kquants.py, the reference's copy).

Every kind, on arbitrary byte streams (any code, scale and f16 bit
pattern) and on the quantizers' output of Gaussian weights: the codes and
the float32 sides bit for bit, the super-block parts of Q4_K, and the
dense decode of the embedding table.  The loader's results against the
JAX package's stand in tests/test_torch_gguf_model.py.
"""

import numpy as np
import pytest
import torch

from tokenhawk_tpu_torch.ggml import kquant_decode as kd
from tokenhawk_tpu_torch.ggml import kquants
from tokenhawk_tpu_torch.ggml.format import GGMLType

KINDS = {
    GGMLType.Q2_K: (kquants.extract_q2_k, kquants.quantize_q2_k),
    GGMLType.Q3_K: (kquants.extract_q3_k, kquants.quantize_q3_k),
    GGMLType.Q4_K: (kquants.extract_q4_k, kquants.quantize_q4_k),
    GGMLType.Q5_K: (kquants.extract_q5_k, kquants.quantize_q5_k),
    GGMLType.Q6_K: (kquants.extract_q6_k, kquants.quantize_q6_k),
}
SHAPE = (24, 512)  # [out, in]: 48 blocks


def _stream(kind, source):
    rng = np.random.default_rng(int(kind) * 2 + (source == "bytes"))
    if source == "bytes":
        n = SHAPE[0] * SHAPE[1] // kquants.QK_K * kquants.KQUANT_BLOCK_BYTES[kind]
        return rng.integers(0, 256, n, dtype=np.uint8).tobytes()
    return KINDS[kind][1](rng.standard_normal(SHAPE).astype(np.float32))


def _same(got: torch.Tensor, want: np.ndarray):
    """Equal values of equal dtype; float32 bit for bit (NaN where NaN)."""
    got = got.numpy()
    assert got.dtype == want.dtype and got.shape == want.shape
    if want.dtype == np.float32:
        nan = np.isnan(want)
        np.testing.assert_array_equal(np.isnan(got), nan)
        got, want = got[~nan].view(np.uint32), want[~nan].view(np.uint32)
    np.testing.assert_array_equal(got, want)


# Arbitrary f16 scales include inf and NaN: numpy warns on inf * 0.
@pytest.mark.filterwarnings("ignore:invalid value encountered:RuntimeWarning")
@pytest.mark.parametrize("source", ["bytes", "quantized"])
@pytest.mark.parametrize("kind", list(KINDS), ids=lambda k: k.name)
def test_extract_matches_numpy(kind, source):
    raw = _stream(kind, source)
    n = SHAPE[0] * SHAPE[1]
    got = kd.EXTRACT[kind](kd.blocks(kind, raw, n))
    want = KINDS[kind][0](raw, n)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _same(g, w)
    _same(kd.dequant(kind, memoryview(raw), SHAPE),
          kquants.dequant_kquant(kind, raw, SHAPE))


@pytest.mark.parametrize("source", ["bytes", "quantized"])
def test_q4_k_super_block_parts_match_numpy(source):
    raw = _stream(GGMLType.Q4_K, source)
    n = SHAPE[0] * SHAPE[1]
    got = kd.extract_q4_k_sb(kd.blocks(GGMLType.Q4_K, raw, n))
    for g, w in zip(got, kquants.extract_q4_k_sb(raw, n)):
        _same(g, w)


def test_unsupported_kind_raises():
    with pytest.raises(ValueError, match="unsupported k-quant"):
        kd.dequant(GGMLType.Q8_0, b"\0" * 34, (1, 32))
