"""The paper's own evaluation models (Table 2): GPT 125M/355M (seq 1024,
vocab 50257) and LLaMA 1B/3B (seq 8192, vocab 32000).  The port's copy of
``repro/configs/paper_models.py``: the same four configs, field for field."""
from repro_torch.configs.base import ModelConfig

CONFIGS = {
    "gpt-125m": ModelConfig(
        name="gpt-125m", family="dense", n_layers=12, d_model=768,
        n_heads=12, n_kv_heads=12, d_ff=3072, vocab=50257),
    "gpt-355m": ModelConfig(
        name="gpt-355m", family="dense", n_layers=24, d_model=1024,
        n_heads=16, n_kv_heads=16, d_ff=4096, vocab=50257),
    "llama-1b": ModelConfig(
        name="llama-1b", family="dense", n_layers=22, d_model=2048,
        n_heads=32, n_kv_heads=4, d_ff=5632, vocab=32000),
    "llama-3b": ModelConfig(
        name="llama-3b", family="dense", n_layers=26, d_model=3200,
        n_heads=32, n_kv_heads=32, d_ff=8640, vocab=32000),
}
