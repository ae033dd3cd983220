"""zamba2-7b [hybrid]: Mamba2 backbone + shared attention blocks. 81L
d_model=3584 32H (GQA kv=32) d_ff=14336 vocab=32000 ssm_state=64.
Shared transformer block applied every 6 mamba layers (each application
keeps its own KV cache). [arXiv:2411.15242]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-7b",
    family="hybrid",
    n_layers=81,
    d_model=3584,
    n_heads=32,
    n_kv_heads=32,
    d_ff=14336,
    vocab=32000,
    ssm_state=64,
    ssm_expand=2,
    ssm_headdim=64,
    attn_every=6,
)
