"""Matmul over dense or quantized weights (counterpart of tokenhawk_tpu/ops/linear.py).

A quantized weight goes to ops/cuda/qmatmul.py with the RMSNorm fused:
kernel 1 for Q4_0, kernel 13 for a group-code weight (Q8_0, Q5_0, Q4_1,
Q5_1, the k-quants), kernel 17 for a Q4_K super-block weight; a dense
weight to torch.matmul, as the JAX package leaves dense products to XLA.
"""

from __future__ import annotations

import torch

from tokenhawk_tpu_torch.ops.cuda.qmatmul import quant_matmul
from tokenhawk_tpu_torch.ops.norms import rms_norm
from tokenhawk_tpu_torch.ops.qweight import ArrayOrQ, QWeight


def matmul(x: torch.Tensor, w: ArrayOrQ, norm_gain: torch.Tensor | None = None, *,
           eps: float = 1e-6) -> torch.Tensor:
    """x [..., K] @ w [K, N] -> [..., N] in x.dtype, f32 accumulation;
    rms_norm(x, norm_gain) first when `norm_gain` is given."""
    if isinstance(w, QWeight):
        return quant_matmul(x, w, norm_gain, eps=eps)
    if norm_gain is not None:
        x = rms_norm(x, norm_gain, eps)
    return torch.matmul(x, w.to(x.dtype))
