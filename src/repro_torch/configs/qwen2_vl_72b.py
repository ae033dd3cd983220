"""qwen2-vl-72b [vlm]: M-RoPE, dynamic resolution (frontend stubbed:
input_specs provides token ids + (3,B,S) M-RoPE position ids). 80L
d_model=8192 64H (GQA kv=8) d_ff=29568 vocab=152064. [arXiv:2409.12191]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-72b",
    family="vlm",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=29568,
    vocab=152064,
    rope_theta=1e6,
    mrope_sections=(16, 24, 24),
)
