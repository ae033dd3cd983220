"""Model architecture config: the port's own copy of ``ModelConfig``.

Counterpart of ``repro/configs/base.py:10-134``, reduced to the fields of the
dense family that the port serves and trains (plus ``window``, which
``models.transformer.check_supported`` rejects until the mixtral slice).  Each
field and the ``reduced()`` cut are the reference's, so a config means the
same model in both packages; the MoE, SSM, hybrid, encoder-decoder and VLM
fields arrive with their slices.  ``RunConfig`` is the reference's
(``base.py:158-204``), every field included.
"""
from __future__ import annotations

import dataclasses

from repro_torch.comm.policy import PolicyTable


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
    loss_chunk: int = 8192          # token chunk of the CE loss

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
            loss_chunk=1024,
            dtype="float32",
        )


@dataclasses.dataclass(frozen=True)
class RunConfig:
    """Parallelism + training knobs for one run (the reference's fields).

    With ``policies`` (a per-op :class:`~repro_torch.comm.policy.PolicyTable`)
    the trainer builds its communicator from that table, and the
    single-policy fields serve only as the facade fallback.  ``zero_stage``
    3 raises in the port's trainer until ``fsdp_all_gather`` is ported
    (ROADMAP A5).
    """

    zero_stage: int = 1              # 1 (3: ROADMAP A5)
    collective_mode: str = "auto"    # flat | hier | pipelined | auto
    backend: str = "xla"             # collective ring backend: xla | pallas
    policies: PolicyTable | None = None   # per-op, size-classed policy table
    n_channels: int = 4              # pipeline channels of "pipelined" mode
    n_stripes: int = 1               # stripes of the pallas rings
    pipeline_chunk_bytes: int | None = None   # alternative channel sizing
    bucket_bytes: int = 64 * 1024 * 1024      # gradient fusion bucket size
    n_micro: int = 1                 # gradient-accumulation micro-steps
    remat: bool = True               # activation checkpointing per block
    learning_rate: float = 3e-4
    weight_decay: float = 0.1
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    grad_clip: float = 1.0
    cross_dtype: str | None = None   # cross-pod gradient compression
    wire_quant: str | None = None    # wire codec of the pallas rings
                                     # (None | "int8" | "fp8", DESIGN.md §17)
    error_feedback: str = "auto"     # "auto" (on iff the gradient rings
                                     # quantize) | "on" | "off"
    param_dtype: str = "bfloat16"
    master_dtype: str = "float32"
    seed: int = 0
