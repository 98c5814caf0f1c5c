"""Hand-written CUDA kernels (csrc/*.cu) and their plain PyTorch versions.

Each wrapper launches its kernel for CUDA tensors and uses the plain
version only for tensors on the CPU; there is no other fallback."""
