"""Model architecture config: the port's own copy of ``ModelConfig``.

Counterpart of ``repro/configs/base.py:10-204``, every family included:
dense, MoE with its sliding window (mixtral), SSM (Mamba2 / SSD), the SSM +
shared-attention hybrid (zamba2), the encoder-decoder (whisper) and the VLM
with M-RoPE (qwen2-vl).  Each field, ``n_params`` / ``n_active_params``,
``full_attention`` and the ``reduced()`` cut are the reference's, so a
config means the same model in both packages.
``ShapeConfig`` and the four shapes (``SHAPES``) and ``RunConfig`` are the
reference's (``base.py:138-204``), every field included.
"""
from __future__ import annotations

import dataclasses

from repro_torch.comm.policy import PolicyTable


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                     # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0               # 0 -> d_model // n_heads
    rope_theta: float = 10_000.0
    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    d_ff_expert: int = 0
    capacity_factor: float = 1.25
    # --- SSM (Mamba2 / SSD) ---
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_headdim: int = 64
    ssm_groups: int = 1
    ssm_conv: int = 4
    ssm_chunk: int = 256
    # --- hybrid (zamba2) ---
    attn_every: int = 0             # shared attention block every k ssm layers
    # --- sliding window (mixtral) ---
    window: int = 0
    # --- encoder-decoder (whisper) ---
    n_enc_layers: int = 0
    n_frames: int = 0
    # --- vlm (qwen2-vl) ---
    mrope_sections: tuple[int, ...] = ()
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

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def n_ssm_heads(self) -> int:
        return self.d_inner // self.ssm_headdim if self.ssm_state else 0

    @property
    def full_attention(self) -> bool:
        """True if attention cost is quadratic and unbounded (no window/ssm)."""
        return self.family in ("dense", "moe", "encdec", "vlm") and self.window == 0

    def n_params(self) -> float:
        """Analytic parameter count of the reference (norms and biases not
        counted; the hybrid's shared block counted once; the encoder-decoder's
        decoder MLP priced as gated, 3·d·d_ff, where its tree holds 2·d·d_ff:
        ROADMAP C8)."""
        d, hd = self.d_model, self.head_dim_
        attn = d * (self.n_heads * hd) * 2 + d * (self.n_kv_heads * hd) * 2
        mlp = 3 * d * self.d_ff if self.d_ff else 0
        moe = 0
        if self.n_experts:
            mlp = 0
            moe = self.n_experts * 3 * d * self.d_ff_expert + d * self.n_experts
        ssm = 0
        if self.ssm_state:
            din, gn = self.d_inner, self.ssm_groups * self.ssm_state
            proj_in = d * (2 * din + 2 * gn + self.n_ssm_heads)
            ssm = proj_in + din * d + self.ssm_conv * (din + 2 * gn)
        if self.family == "ssm":
            return float(self.n_layers * ssm + 2 * self.vocab * d)
        if self.family == "hybrid":
            return float(self.n_layers * ssm + attn + 3 * d * self.d_ff + 2 * self.vocab * d)
        total = self.n_layers * (attn + mlp + moe)
        if self.family == "encdec":
            total += self.n_enc_layers * (d * d * 4 + 2 * d * self.d_ff)   # encoder blocks
            total += self.n_layers * (d * d * 4)                            # cross-attention
        return float(total + 2 * self.vocab * d)

    def n_active_params(self) -> float:
        """Active parameters per token (an MoE token uses top_k experts)."""
        if not self.n_experts:
            return self.n_params()
        expert = 3 * self.d_model * self.d_ff_expert
        return float(self.n_params() - self.n_layers * (self.n_experts - self.top_k) * expert)

    def reduced(self) -> "ModelConfig":
        """A tiny same-family config for CPU smoke tests (the reference's cut)."""
        return dataclasses.replace(
            self,
            name=self.name + "-reduced",
            n_layers=min(self.n_layers,
                         4 if self.family != "hybrid" else 2 * max(self.attn_every, 1)),
            d_model=128,
            n_heads=min(self.n_heads, 4),
            n_kv_heads=min(self.n_kv_heads, 2),
            head_dim=32,
            d_ff=256 if self.d_ff else 0,
            d_ff_expert=128 if self.d_ff_expert else 0,
            vocab=512,
            n_experts=min(self.n_experts, 4),
            top_k=min(self.top_k, 2),
            ssm_state=min(self.ssm_state, 16),
            ssm_headdim=32 if self.ssm_state else self.ssm_headdim,
            ssm_chunk=32,
            n_enc_layers=min(self.n_enc_layers, 2),
            n_frames=min(self.n_frames, 64),
            window=min(self.window, 64) if self.window else 0,
            mrope_sections=(4, 6, 6) if self.mrope_sections else (),
            attn_chunk=64,
            loss_chunk=1024,
            dtype="float32",
        )


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                        # train | prefill | decode

    def applicable(self, cfg: ModelConfig) -> bool:
        if self.seq_len >= 500_000 and cfg.full_attention:
            return False             # long_500k skipped for pure full attention
        return True


TRAIN_4K = ShapeConfig("train_4k", 4096, 256, "train")
PREFILL_32K = ShapeConfig("prefill_32k", 32768, 32, "prefill")
DECODE_32K = ShapeConfig("decode_32k", 32768, 128, "decode")
LONG_500K = ShapeConfig("long_500k", 524288, 1, "decode")
SHAPES = {s.name: s for s in (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)}


@dataclasses.dataclass(frozen=True)
class RunConfig:
    """Parallelism + training knobs for one run (the reference's fields).

    With ``policies`` (a per-op :class:`~repro_torch.comm.policy.PolicyTable`)
    the trainer builds its communicator from that table, and the
    single-policy fields serve only as the facade fallback.
    """

    zero_stage: int = 1              # 1 or 3 (the paper evaluates both)
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
