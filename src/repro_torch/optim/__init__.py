"""Optimizers: AdamW with global-norm clipping."""
