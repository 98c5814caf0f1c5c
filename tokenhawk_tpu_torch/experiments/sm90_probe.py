"""Probe the sm_90a ops the port's dequantizing kernels rely on.

    python -m tokenhawk_tpu_torch.experiments.sm90_probe

Counterpart of experiments/mosaic_probe.py, which asked whether Mosaic
lowers each op a Q4/Q8 dequant needs on a TPU.  Kernel 22
(csrc/sm90_probe.cu) runs the same seven probes, one for one, on the same
inputs; each has a plain PyTorch version here.  A probe prints `ok` and
its first four values when its kernel runs and equals the plain version
exactly, else `FAIL` and the reason; any FAIL makes the script exit 1.
The int8 dot goes through the tensor cores (mma.sync m16n8k32 s8 -> s32,
inline PTX).
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from tokenhawk_tpu_torch.ops.cuda import build

PROBES = (
    "i8->f32 convert",
    "u8->i16->f32",
    "u8 &0xF in u8, ->i32->f32",
    "int4 ref ->f32 (on-device int4)",
    "in-kernel u8 bitcast->int4",
    "int8 MXU dot",
    "fma pattern v*s+m",
)
launches = {"sm90_probe": 0}

# probe, in0, in1, out; rows, cols, depth; stream.
_ARGS = [build.I] + [build.P] * 3 + [build.I] * 3 + [build.P]


def inputs(device=None) -> dict:
    """The reference's inputs: u8 arange(1024) (wrapped) and i8 arange(-64,
    64) tiled, both [8, 128]; int4 codes arange(-8, 8) tiled [8, 128] (as
    int8); int8 ones [128, 128]; the fma's scale 2.0 per column [128]."""
    return {
        "u8": torch.arange(8 * 128, device=device).to(torch.uint8).reshape(8, 128),
        "i8": torch.arange(-64, 64, device=device).to(torch.int8).tile(8).reshape(8, 128),
        "i4": torch.arange(-8, 8, device=device).to(torch.int8).tile(64).reshape(8, 128),
        "i8sq": torch.ones((128, 128), dtype=torch.int8, device=device),
        "s": torch.full((128,), 2.0, device=device),
    }


def pack_int4(codes: torch.Tensor) -> torch.Tensor:
    """Signed codes in [-8, 7] [R, C] -> uint8 [R, C/2], two a byte, the
    even column in the low nibble."""
    c = (codes.to(torch.int16) & 0x0F).to(torch.uint8)
    return c[:, 0::2] | (c[:, 1::2] << 4)


def _nibble_i4(v: torch.Tensor) -> torch.Tensor:
    v = v.to(torch.int16)
    return torch.where(v >= 8, v - 16, v).float()


def probe_plain(i: int, ins: dict) -> torch.Tensor:
    """Probe i's function in plain PyTorch."""
    u8 = ins["u8"]
    if i == 0:
        return ins["i8"].float()
    if i == 1:
        return (u8.to(torch.int16) & 0xF).float()
    if i == 2:
        return (u8 & 0xF).to(torch.int32).float()
    if i == 3:
        return ins["i4"].float()
    if i == 4:
        return _nibble_i4(u8 & 0xF)
    if i == 5:
        a = ins["i8sq"].double()
        return (a @ a).to(torch.int32)
    return u8.to(torch.int32).float() * ins["s"] + 1.0


def probe(i: int, ins: dict) -> torch.Tensor:
    """Probe i through kernel 22 (the plain version for CPU tensors)."""
    if not ins["u8"].is_cuda:
        return probe_plain(i, ins)
    if i == 5:
        return int8_matmul(ins["i8sq"], ins["i8sq"])
    src = ins["i8"] if i == 0 else pack_int4(ins["i4"]) if i == 3 else ins["u8"]
    rows, cols = ins["u8"].shape
    out = torch.empty((rows, cols), dtype=torch.float32, device=src.device)
    build.require_cuda(src, ins["s"], out)
    _launch(i, src, ins["s"], out, rows, cols, 0)
    return out


def int8_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Probe 5 at any size: int8 a [M, K] @ b [K, N] -> int32 [M, N]
    through the tensor cores; M % 16, N % 8, K % 32 == 0."""
    m, k = a.shape
    n = b.shape[1]
    build.require(a.dtype == b.dtype == torch.int8 and b.shape[0] == k,
                  "int8 a [M, K] and b [K, N]")
    build.require(m % 16 == 0 and n % 8 == 0 and k % 32 == 0, "M % 16, N % 8, K % 32 must be 0")
    build.require_cuda(a, b)
    out = torch.empty((m, n), dtype=torch.int32, device=a.device)
    _launch(5, a, b, out, m, n, k)
    return out


def _launch(i, in0, in1, out, rows, cols, depth) -> None:
    fn = build.function("th_sm90_probe", _ARGS)
    rc = fn(i, in0.data_ptr(), in1.data_ptr(), out.data_ptr(), rows, cols, depth,
            build.stream_of(out))
    build.check(rc, f"sm90_probe {PROBES[i]}")
    launches["sm90_probe"] += 1


def main() -> int:
    if not torch.cuda.is_available():
        print("sm90_probe: no CUDA device; nothing run", file=sys.stderr)
        return 1
    ins = inputs("cuda")
    failed = 0
    for i, name in enumerate(PROBES):
        try:
            out = probe(i, ins)
            torch.cuda.synchronize()
            if not torch.equal(out, probe_plain(i, ins)):
                raise AssertionError("differs from the plain version")
            print(f"ok   {name}: {np.asarray(out.cpu()).ravel()[:4]}", flush=True)
        # A probe that does not build, launch or agree is the probe's finding.
        except (RuntimeError, ValueError, AssertionError) as e:
            failed += 1
            msg = str(e).split("\n")[0][:140]
            print(f"FAIL {name}: {type(e).__name__}: {msg}", flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())
