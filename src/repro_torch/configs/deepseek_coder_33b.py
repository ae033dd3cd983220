"""deepseek-coder-33b [dense]: llama-arch. 62L d_model=7168 56H (GQA kv=8)
d_ff=19200 vocab=32256. [arXiv:2401.14196]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-coder-33b",
    family="dense",
    n_layers=62,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_ff=19200,
    vocab=32256,
    rope_theta=1e5,
)
