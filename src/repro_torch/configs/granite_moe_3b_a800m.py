"""granite-moe-3b-a800m — MoE 40 experts top-8
[hf:ibm-granite/granite-3.0-1b-a400m-base; hf].

32L, d_model 1536, 24H GQA kv=8 (head_dim 64), expert d_ff 512,
40 experts top-8, vocab 49155.  40 experts do not divide the 16-way model
axis -> expert-internal TP on d_ff instead of EP (DESIGN.md §6); vocab
49155 is odd -> embedding sharded on d_model.
long_500k skipped (full attention).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m",
    family="moe",
    n_layers=32,
    d_model=1536,
    vocab=49_155,
    n_heads=24,
    n_kv_heads=8,
    head_dim=64,
    d_ff=512,
    mlp_type="swiglu",
    n_experts=40,
    experts_top_k=8,
    tie_embeddings=True,
)
