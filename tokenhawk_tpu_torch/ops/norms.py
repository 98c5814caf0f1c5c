"""RMSNorm fused with its gain (counterpart of tokenhawk_tpu/ops/norms.py).

Statistics in f32 whatever the activation dtype; the result is rounded
back to the input dtype, as in the reference.
"""

from __future__ import annotations

import torch


def rms_norm(x: torch.Tensor, gain: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    x32 = x.float()
    ms = (x32 * x32).mean(dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(ms + eps)
    return (y * gain.float()).to(x.dtype)
