"""LLaMA model as functions over per-layer parameters."""
