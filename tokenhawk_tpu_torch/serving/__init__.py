"""HTTP serving of the port (counterpart of tokenhawk_tpu/serving)."""
