"""Compare Q4 dequant arithmetic variants on the card (steady state).

    python -m tokenhawk_tpu_torch.experiments.dequant_exp

Counterpart of experiments/dequant_exp.py.  Kernel 21
(csrc/dequant_exp.cu) replaces its Pallas kernel (`build`, make_kernel's
`kern`): x [8, K] bfloat16 times a split-half Q4 weight, codes [K/2, N]
uint8 (low nibble against x[:, :K/2], high nibble against x[:, K/2:]),
scales [K/64, N] bfloat16 shared by both nibbles, each weight dequantized
in f32 and rounded to bfloat16, f32 sums, a bfloat16 output.  VARIANTS
are the reference's: "int32", "u8int8" (the same values by byte ops) and
"biasdot" (no -8: wrong by design).  The script times each variant over
NW = 8 distinct weight sets (about 190 MB, past the 50 MB L2) chained 3
times, as the reference's scan does, and prints us per matmul and GB/s.

Tolerance against the plain version: f32 sums in another order, one
bfloat16 step of the largest |output|.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from tokenhawk_tpu_torch.ops.cuda import build

K, N, B = 4096, 11008, 8
NW = 8
VARIANTS = ("int32", "u8int8", "biasdot")
launches = {"dequant_exp": 0}
ROWS_PER_SPLIT = 1024  # x columns a block's 512 packed rows cover
COLS_PER_BLOCK = 128

# x, qs, s, partials, out; K, N, variant; stream.
_ARGS = [build.P] * 5 + [build.I] * 3 + [build.P]


def dequant_matmul_plain(x: torch.Tensor, qs: torch.Tensor, s: torch.Tensor,
                         variant: str = "int32") -> torch.Tensor:
    """Kernel 21's function in plain PyTorch."""
    kp = qs.shape[0]
    bias = 0.0 if variant == "biasdot" else 8.0
    sf = s.float().repeat_interleave(32, dim=0)
    lo = (((qs & 0x0F).float() - bias) * sf).to(torch.bfloat16).float()
    hi = (((qs >> 4).float() - bias) * sf).to(torch.bfloat16).float()
    return (x[:, :kp].float() @ lo + x[:, kp:].float() @ hi).to(x.dtype)


def dequant_matmul(x: torch.Tensor, qs: torch.Tensor, s: torch.Tensor,
                   variant: str = "int32") -> torch.Tensor:
    """x bfloat16 [8, K], qs uint8 [K/2, N], s bfloat16 [K/64, N] ->
    bfloat16 [8, N]."""
    if variant not in VARIANTS:
        raise ValueError(f"variant {variant!r} not in {VARIANTS}")
    if not x.is_cuda:
        return dequant_matmul_plain(x, qs, s, variant)
    rows, k = x.shape
    kp, n = qs.shape
    build.require(rows == B and x.dtype == torch.bfloat16, f"x must be bfloat16 [{B}, K]")
    build.require(k == 2 * kp and k % ROWS_PER_SPLIT == 0,
                  f"K {k} must be 2 x the code rows ({kp}) and a multiple of {ROWS_PER_SPLIT}")
    build.require(n % COLS_PER_BLOCK == 0, f"N {n} must be a multiple of {COLS_PER_BLOCK}")
    build.require(qs.dtype == torch.uint8 and s.dtype == torch.bfloat16
                  and s.shape == (k // 64, n), "codes uint8 [K/2, N], scales bfloat16 [K/64, N]")
    build.require_cuda(x, qs, s)
    partials = torch.empty((k // ROWS_PER_SPLIT, B, n), dtype=torch.float32, device=x.device)
    out = torch.empty((B, n), dtype=torch.bfloat16, device=x.device)
    fn = build.function("th_dequant_exp", _ARGS)
    rc = fn(x.data_ptr(), qs.data_ptr(), s.data_ptr(), partials.data_ptr(), out.data_ptr(), k,
            n, VARIANTS.index(variant), build.stream_of(x))
    build.check(rc, "dequant_exp")
    launches["dequant_exp"] += 1
    return out


def bytes_per_matmul(k: int = K, n: int = N) -> int:
    """The reference's byte count of one matmul: the codes, and the scales
    once for each half."""
    return k // 2 * n + k // 32 * n * 2


def time_variant(variant: str, x, packed, scales, trials: int = 3) -> float:
    """Seconds per matmul: 3 chained passes over the weight sets, each
    output's first K columns (scaled by 1e-3) the next input, CUDA events
    around the whole, the median of `trials`."""
    k = x.shape[1]

    def loop():
        y = x
        for _ in range(3):
            for qs, s in zip(packed, scales):
                y = (dequant_matmul(y, qs, s, variant)[:, :k] * 1e-3).contiguous()
        return y

    loop()
    torch.cuda.synchronize()
    times = []
    for _ in range(trials):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        loop()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / 1e3)
    return float(np.median(times)) / (3 * len(packed))


def main() -> int:
    if not torch.cuda.is_available():
        print("dequant_exp: no CUDA device; nothing run", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    x = torch.randn((B, K), generator=g, device=dev).to(torch.bfloat16)
    packed = [torch.full((K // 2, N), 37 + i, dtype=torch.uint8, device=dev) for i in range(NW)]
    scales = [torch.full((K // 64, N), 0.01, dtype=torch.bfloat16, device=dev)
              for _ in range(NW)]
    bpi = bytes_per_matmul()
    for variant in VARIANTS:
        t = time_variant(variant, x, packed, scales)
        print(f"{variant}: {t * 1e6:.0f} us/mm -> {bpi / t / 1e9:.0f} GB/s", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
