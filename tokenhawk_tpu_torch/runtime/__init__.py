"""Model loading and the generation engine."""
