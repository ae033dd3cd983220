"""moonshot-v1-16b-a3b [moe]: kimi/moonlight, 64 experts top-6. 48L
d_model=2048 16H (GQA kv=16) d_ff(expert)=1408 vocab=163840.
[hf:moonshotai/Moonlight-16B-A3B]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="moonshot-v1-16b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=0,
    d_ff_expert=1408,
    n_experts=64,
    top_k=6,
    vocab=163840,
)
