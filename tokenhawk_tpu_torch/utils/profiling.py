"""Profiling and roofline accounting on the card.

Counterpart of tokenhawk_tpu/utils/profiling.py:

  - `trace()` records CPU and CUDA activity with torch.profiler and writes
    a chrome trace (`<log_dir>/trace.json`, read by
    experiments/trace_summarize.py);
  - roofline accounting: the bytes a decode step must move against the
    card's HBM bandwidth, and the FLOPs a prefill must spend against its
    tensor-core peak.

The card's figures are its spec sheet's, keyed by
torch.cuda.get_device_name().  An unknown card raises unless the caller
passes the figure: no other card's numbers stand in.

One difference from the reference at batch > 1 (its profiling.py:82-85
adds kv_stream_bytes(...) // batch to the whole weight stream, and its
bench compares tok/s / B against that): here a decode step of B rows
reads the weights once and the KV of all B rows, so

    roofline tok/s = B * bandwidth / (weight bytes + KV bytes of B rows),

the aggregate rate of the step.  At B = 1 the two agree.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
from typing import Optional

import torch

from tokenhawk_tpu_torch.ops.qweight import QWeight

H100_SXM = "NVIDIA H100 80GB HBM3"
# HBM bandwidth, GB/s (NVIDIA H100 SXM5 data sheet).
HBM_GBPS = {H100_SXM: 3350.0}
# Dense bf16 tensor-core peak, TFLOP/s (the same data sheet).
PEAK_TFLOPS_BF16 = {H100_SXM: 989.0}


def card_name() -> str:
    """torch.cuda.get_device_name() of the current device; raises without one."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass the card's figures explicitly")
    return torch.cuda.get_device_name()


def _figure(table: dict, what: str, card: Optional[str], given: Optional[float]) -> float:
    if given is not None:
        return float(given)
    card = card or card_name()
    if card not in table:
        raise KeyError(f"no {what} on record for {card!r}: pass it explicitly")
    return table[card]


def hbm_gbps(card: Optional[str] = None, given: Optional[float] = None) -> float:
    """The card's HBM GB/s (`given` wins)."""
    return _figure(HBM_GBPS, "HBM bandwidth", card, given)


def peak_tflops(card: Optional[str] = None, given: Optional[float] = None) -> float:
    """The card's dense bf16 TFLOP/s (`given` wins)."""
    return _figure(PEAK_TFLOPS_BF16, "bf16 peak", card, given)


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a trace: `with trace('/tmp/trace'): step()` writes
    /tmp/trace/trace.json."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def _nbytes(w) -> int:
    if w is None:
        return 0
    if isinstance(w, QWeight):
        return w.nbytes
    return w.numel() * w.element_size()


def weight_stream_bytes(params) -> int:
    """Bytes of parameters streamed from HBM per decode step: every
    layer's weights once per use, in the port's device layout (a
    QWeight's tensors, a dense tensor's bytes), counted layer by layer so
    that layers sharing buffers still count each use; everything but the
    embedding table (a row gather)."""
    total = _nbytes(params.norm) + _nbytes(params.output)
    for lp in params.layers:
        total += sum(_nbytes(getattr(lp, f.name)) for f in dataclasses.fields(lp))
    return total


def kv_stream_bytes(cfg, n_past: int, batch: int = 1, dtype_bytes: int = 2) -> int:
    """KV-cache bytes read per decode step at a given context depth."""
    return 2 * cfg.n_layer * batch * cfg.n_kv_head * n_past * cfg.head_dim * dtype_bytes


def decode_speed_of_light(params, cfg=None, n_past: int = 0, batch: int = 1,
                          card: Optional[str] = None, kv_dtype_bytes: int = 2,
                          hbm: Optional[float] = None) -> float:
    """Roofline decode tok/s of a step of `batch` rows: batch x HBM
    bandwidth / (weight bytes + the KV bytes of every row).  `hbm` (GB/s)
    replaces the card's figure, e.g. with a measured one.

    kv_dtype_bytes: 1 for int8 KV caches."""
    step_bytes = weight_stream_bytes(params)
    if cfg is not None and n_past:
        step_bytes += kv_stream_bytes(cfg, n_past, batch, kv_dtype_bytes)
    return max(batch, 1) * hbm_gbps(card, hbm) * 1e9 / step_bytes


def roofline_fraction(achieved_tok_s: float, params, **kw) -> float:
    """Aggregate tok/s of a step against decode_speed_of_light(**kw)."""
    return achieved_tok_s / decode_speed_of_light(params, **kw)


def prefill_flops(cfg, n_tokens: int, batch: int = 1) -> float:
    """Tensor-core FLOPs one prefill pass must spend (matmuls + attention).

    Weight matmuls: 2 * T * (all projection params) plus the logits head.
    Attention: causal QK^T + PV, 2 * 2 * H * T^2/2 * Dh per layer (the
    masked half skipped).  The embedding gather and elementwise work are
    not counted."""
    d, f, v = cfg.n_embd, cfg.n_ff, cfg.n_vocab
    dq = cfg.n_head * cfg.head_dim
    dkv = cfg.n_kv_head * cfg.head_dim
    per_tok = 2 * cfg.n_layer * (d * (dq + 2 * dkv)  # wq/wk/wv
                                 + dq * d            # wo
                                 + 3 * d * f)        # w1/w2/w3
    per_tok += 2 * d * v  # logits head (the reference keeps it: conservative)
    attn = 2 * cfg.n_layer * 2 * cfg.n_head * (n_tokens ** 2 / 2) * cfg.head_dim
    return batch * (per_tok * n_tokens + attn)


def prefill_speed_of_light(cfg, n_tokens: int, batch: int = 1, card: Optional[str] = None,
                           peak: Optional[float] = None) -> float:
    """Roofline prefill seconds: prefill_flops at the card's bf16 peak
    (`peak` in TFLOP/s replaces it)."""
    return prefill_flops(cfg, n_tokens, batch) / (peak_tflops(card, peak) * 1e12)


def prefill_roofline_fraction(cfg, n_tokens: int, seconds: float, batch: int = 1,
                              card: Optional[str] = None, peak: Optional[float] = None) -> float:
    """Fraction of the compute roofline a prefill of `seconds` achieved."""
    return prefill_speed_of_light(cfg, n_tokens, batch, card, peak) / seconds
