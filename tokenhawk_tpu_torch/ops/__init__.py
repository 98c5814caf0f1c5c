"""Tensor ops: norms, RoPE, Q4_0 weights, matmul and attention."""
