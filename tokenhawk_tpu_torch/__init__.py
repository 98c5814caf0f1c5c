"""tokenhawk_tpu_torch — the PyTorch and CUDA port of tokenhawk_tpu.

The JAX package `tokenhawk_tpu` is the reference; this package carries
its LLaMA Q4_0 serving path (GGML load -> prefill -> sampled decode ->
CLI) to one NVIDIA Hopper GPU.  Plain tensor code is PyTorch; every
Pallas kernel on that path is a CUDA C++ kernel under `csrc/`, built
for sm_90a at first use and bound through ctypes (`ops/cuda`).

Module names mirror the reference so each counterpart is easy to find.
Nothing here imports jax: importing any module of `tokenhawk_tpu` runs
its jax patches, so the jax-free host modules the slice needs (config,
ggml I/O, tokenizer, timing) are carried as copies.
"""

__version__ = "0.1.0"
