"""gemma3-4b — dense, 5:1 local:global attention, 128k ctx
[hf:google/gemma-3-1b-pt; unverified].

34 layers, d_model 2560, 8 query heads (GQA kv=4) with head_dim 256
(attention width 2048 != d_model, as in gemma), geglu d_ff 10240,
262144-entry vocabulary, qk-norm, sliding window 1024 on local layers.
long_500k skipped: the global layers are full attention.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-4b",
    family="dense",
    n_layers=34,
    d_model=2560,
    vocab=262_144,
    n_heads=8,
    n_kv_heads=4,
    head_dim=256,
    qk_norm=True,
    attn_window=1024,
    local_global_pattern=5,
    rope_base=1_000_000.0,
    d_ff=10_240,
    mlp_type="geglu",
    tie_embeddings=True,
)
