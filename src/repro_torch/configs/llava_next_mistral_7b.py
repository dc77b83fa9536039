"""llava-next-mistral-7b — VLM: mistral-7B backbone + anyres tiling
[hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified].

32L, d_model 4096, 32H GQA kv=8 (head_dim 128), swiglu d_ff 14336,
vocab 32000.  Vision frontend is a STUB: input_specs() provides
precomputed patch embeddings (B, 2880, 4096) = 5 anyres tiles x 576.
long_500k skipped (full attention).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-mistral-7b",
    family="vlm",
    n_layers=32,
    d_model=4096,
    vocab=32_000,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    rope_base=1_000_000.0,
    d_ff=14_336,
    mlp_type="swiglu",
    frontend="vision",
    num_patches=2880,
    tie_embeddings=False,
)
