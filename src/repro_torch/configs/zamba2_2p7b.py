"""zamba2-2.7b — hybrid Mamba2 + shared attention [arXiv:2411.15242; hf].

54 Mamba2 blocks (d_model 2560, state 64) with one *shared* GQA attention
block (32H, MHA kv=32, head_dim 80) applied every 6 blocks (9 applications;
params shared, KV caches per application).  Runs the long_500k cell: the
SSM state is O(1) in sequence length and the shared-attention KV cache is
sequence-sharded (SP).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b",
    family="hybrid",
    n_layers=54,
    d_model=2560,
    vocab=32_000,
    n_heads=32,
    n_kv_heads=32,
    head_dim=80,
    d_ff=0,
    ssm_type="mamba2",
    ssm_state=64,
    ssm_conv=4,
    ssm_expand=2,
    ssm_head_dim=64,
    shared_attn_every=6,
    tie_embeddings=True,
)
