"""GGML file I/O (copies of tokenhawk_tpu.ggml modules)."""
