"""Model architecture config: the port's own copy of ``ModelConfig``.

Counterpart of ``repro/configs/base.py:10-134``, reduced to the fields of the
dense family that the port serves (plus ``window``, which
``models.transformer.check_supported`` rejects until the mixtral slice).  Each
field and the ``reduced()`` cut are the reference's, so a config means the
same model in both packages; the MoE, SSM, hybrid, encoder-decoder and VLM
fields arrive with their slices.  ``RunConfig`` and its policy table arrive
with the training slice.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                     # the port serves "dense" only
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0               # 0 -> d_model // n_heads
    rope_theta: float = 10_000.0
    window: int = 0                 # sliding window (mixtral)
    norm_eps: float = 1e-5
    dtype: str = "bfloat16"
    attn_chunk: int = 512           # KV chunk of the plain online-softmax path

    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.d_model // max(self.n_heads, 1)

    @property
    def padded_vocab(self) -> int:
        """Vocab rounded up to 128 (padding logits are masked)."""
        return -(-self.vocab // 128) * 128

    def reduced(self) -> "ModelConfig":
        """A tiny same-family config for CPU smoke tests (the reference's cut)."""
        return dataclasses.replace(
            self,
            name=self.name + "-reduced",
            n_layers=min(self.n_layers, 4),
            d_model=128,
            n_heads=min(self.n_heads, 4),
            n_kv_heads=min(self.n_kv_heads, 2),
            head_dim=32,
            d_ff=256 if self.d_ff else 0,
            vocab=512,
            window=min(self.window, 64) if self.window else 0,
            attn_chunk=64,
            dtype="float32",
        )
