"""starcoder2-7b [dense]: GQA + RoPE. 32L d_model=4608 36H (GQA kv=4)
d_ff=18432 vocab=49152. [arXiv:2402.19173]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-7b",
    family="dense",
    n_layers=32,
    d_model=4608,
    n_heads=36,
    n_kv_heads=4,
    d_ff=18432,
    vocab=49152,
    rope_theta=1e5,
)
