"""llama4-scout-17b-a16e — MoE 16 experts top-1 + shared expert, early
fusion [hf:meta-llama/Llama-4-Scout-17B-16E; unverified].

48L, d_model 5120, 40H GQA kv=8 (head_dim 128), expert d_ff 8192,
16 routed experts top-1 + always-on shared expert, vocab 202048.
True expert parallelism: 16 experts = 16-way model axis.
long_500k skipped (chunked-attention variant not modeled).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama4-scout-17b-a16e",
    family="moe",
    n_layers=48,
    d_model=5120,
    vocab=202_048,
    n_heads=40,
    n_kv_heads=8,
    head_dim=128,
    rope_base=500_000.0,
    d_ff=8192,
    mlp_type="swiglu",
    n_experts=16,
    experts_top_k=1,
    shared_expert=True,
    tie_embeddings=False,
)
