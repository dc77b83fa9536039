"""falcon-mamba-7b — pure Mamba1 SSM, attention-free [arXiv:2410.05355;
unverified].

64L, d_model 4096 (d_inner 8192), state 16, conv 4, vocab 65024.
Runs long_500k: decode state is O(1) in sequence length.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="falcon-mamba-7b",
    family="ssm",
    n_layers=64,
    d_model=4096,
    vocab=65_024,
    d_ff=0,
    ssm_type="mamba1",
    ssm_state=16,
    ssm_conv=4,
    ssm_expand=2,
    tie_embeddings=True,
)
