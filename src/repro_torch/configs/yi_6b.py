"""yi-6b — llama-architecture dense GQA [arXiv:2403.04652; hf].

32L, d_model 4096, 32H GQA kv=4 (head_dim 128), swiglu d_ff 11008,
vocab 64000.  long_500k skipped (full attention).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="yi-6b",
    family="dense",
    n_layers=32,
    d_model=4096,
    vocab=64_000,
    n_heads=32,
    n_kv_heads=4,
    head_dim=128,
    rope_base=5_000_000.0,
    d_ff=11_008,
    mlp_type="swiglu",
    tie_embeddings=False,
)
