"""Data pipelines: the deterministic synthetic token stream."""
