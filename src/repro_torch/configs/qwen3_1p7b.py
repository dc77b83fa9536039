"""qwen3-1.7b — dense GQA with qk-norm [hf:Qwen/Qwen3-8B; hf].

28L, d_model 2048, 16H GQA kv=8 (head_dim 128), swiglu d_ff 6144,
vocab 151936.  long_500k skipped (full attention).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-1.7b",
    family="dense",
    n_layers=28,
    d_model=2048,
    vocab=151_936,
    n_heads=16,
    n_kv_heads=8,
    head_dim=128,
    qk_norm=True,
    rope_base=1_000_000.0,
    d_ff=6144,
    mlp_type="swiglu",
    tie_embeddings=True,
)
