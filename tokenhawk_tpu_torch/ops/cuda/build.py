"""Build and load the port's CUDA kernels.

Each `tokenhawk_tpu_torch/csrc/*.cu` compiles with its own nvcc process,
all started together, and the objects link into one shared library with a
plain C interface, loaded through ctypes.  The build runs
at first use, into `tokenhawk_tpu_torch/_build/`, under a name keyed by a
hash of the sources and flags, so a checkout builds everything itself
and a rebuilt source never loads a stale library.  A failed build raises.

The C functions launch on the stream they are given and return
cudaGetLastError(); `check` turns a non-zero code into an exception.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lib = None
_fns = {}

P = ctypes.c_void_p
I = ctypes.c_int
F = ctypes.c_float
LL = ctypes.c_longlong


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    return os.path.join(home, "bin", "nvcc")


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"libthawk_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernels unless this version is already built."""
    so = library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{so.stem}.{os.getpid()}"
    sources = sorted(CSRC.glob("*.cu"))
    objs = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in sources]
    cmds = [[nvcc(), *NVCC_FLAGS, "-c", "-o", str(o), str(src)]
            for src, o in zip(sources, objs)]
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for c in cmds]
    results = [(c, *p.communicate(), p.returncode) for c, p in zip(cmds, procs)]
    tmp = so.with_name(f"{tag}.tmp")
    if all(rc == 0 for *_, rc in results):
        link = [nvcc(), *NVCC_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)]
        proc = subprocess.run(link, capture_output=True, text=True)
        results.append((link, proc.stdout, proc.stderr, proc.returncode))
    (BUILD_DIR / "build.log").write_text("".join(
        " ".join(c) + "\n" + out + err for c, out, err, _ in results))
    for o in objs:
        o.unlink(missing_ok=True)
    failed = [(c, err, rc) for c, _, err, rc in results if rc != 0]
    if failed:
        c, err, rc = failed[0]
        raise RuntimeError(f"nvcc failed with code {rc} ({c[-1]}):\n{err[-6000:]}")
    os.replace(tmp, so)
    return so


def library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        _lib = ctypes.CDLL(str(build()))
        _lib.th_error_string.argtypes = [I]
        _lib.th_error_string.restype = ctypes.c_char_p
    return _lib


def function(name: str, argtypes):
    """A C launcher of the library with its argument types declared."""
    fn = _fns.get(name)
    if fn is None:
        fn = getattr(library(), name)
        fn.argtypes = argtypes
        fn.restype = I
        _fns[name] = fn
    return fn


def check(code: int, name: str) -> None:
    if code != 0:
        msg = library().th_error_string(code).decode()
        raise RuntimeError(f"{name}: kernel launch failed: CUDA error {code} ({msg})")


@functools.lru_cache(maxsize=None)
def sm_count(device: torch.device) -> int:
    """The SMs of a CUDA device (a host query, no sync)."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def dtype_code(dtype: torch.dtype) -> int:
    if dtype == torch.float32:
        return 0
    if dtype == torch.bfloat16:
        return 1
    raise TypeError(f"kernels take float32 or bfloat16, got {dtype}")


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def require_cuda(*tensors: torch.Tensor) -> None:
    """Inputs of one launch: CUDA, contiguous, 16-byte aligned, one device."""
    dev = tensors[0].device
    for t in tensors:
        require(t.is_cuda and t.device == dev, f"expected CUDA tensors on {dev}, got {t.device}")
        require(t.is_contiguous(), "expected a contiguous tensor")
        require(t.data_ptr() % 16 == 0, "expected a 16-byte aligned tensor")
