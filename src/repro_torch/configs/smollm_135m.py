"""smollm-135m [dense]: llama-arch small. 30L d_model=576 9H (GQA kv=3)
d_ff=1536 vocab=49152. [hf:HuggingFaceTB/SmolLM-135M]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="smollm-135m",
    family="dense",
    n_layers=30,
    d_model=576,
    n_heads=9,
    n_kv_heads=3,
    d_ff=1536,
    vocab=49152,
)
