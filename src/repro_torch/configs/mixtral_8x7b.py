"""mixtral-8x7b [moe]: 8 experts top-2, SWA(4096). 32L d_model=4096 32H
(GQA kv=8) d_ff(expert)=14336 vocab=32000. [arXiv:2401.04088]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x7b",
    family="moe",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=0,
    d_ff_expert=14336,
    n_experts=8,
    top_k=2,
    vocab=32000,
    window=4096,
    rope_theta=1e6,
)
