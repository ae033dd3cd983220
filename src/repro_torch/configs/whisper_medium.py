"""whisper-medium [audio]: enc-dec, conv frontend stubbed (precomputed frame
embeddings). 24 enc + 24 dec layers, d_model=1024, 16H (kv=16), d_ff=4096,
vocab=51865. [arXiv:2212.04356]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-medium",
    family="encdec",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=4096,
    vocab=51865,
    n_enc_layers=24,
    n_frames=1500,
)
