"""Architecture registry of the port.

Counterpart of ``repro/configs/__init__.py``.  The port runs every
architecture of the reference's ``ARCH_IDS`` and all the paper's own models
(``PAPER_IDS``, Table 2): the dense configs (smollm-135m and -360m,
starcoder2-7b, deepseek-coder-33b, and gpt-125m / gpt-355m / llama-1b /
llama-3b), the two MoE models, mixtral-8x7b (sliding window) and
moonshot-v1-16b-a3b, the SSM and hybrid models, mamba2-2.7b and zamba2-7b,
the VLM qwen2-vl-72b (M-RoPE) and the encoder-decoder whisper-medium.
``PENDING`` (arch -> the ROADMAP item that brings it) is empty: an
architecture listed there raises ``NotImplementedError`` naming its item,
and an unknown name raises ``KeyError`` listing the known ones.
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import (DECODE_32K, LONG_500K, PREFILL_32K, SHAPES,  # noqa: F401
                                      TRAIN_4K, ModelConfig, ShapeConfig)

# the paper's own evaluation models (Table 2)
PAPER_IDS = ("gpt-125m", "gpt-355m", "llama-1b", "llama-3b")

_MODULES = {"whisper-medium": "whisper_medium",
            "smollm-360m": "smollm_360m",
            "smollm-135m": "smollm_135m",
            "starcoder2-7b": "starcoder2_7b",
            "deepseek-coder-33b": "deepseek_coder_33b",
            "zamba2-7b": "zamba2_7b",
            "mixtral-8x7b": "mixtral_8x7b",
            "moonshot-v1-16b-a3b": "moonshot_v1_16b_a3b",
            "qwen2-vl-72b": "qwen2_vl_72b",
            "mamba2-2.7b": "mamba2_27b",
            **{arch: "paper_models" for arch in PAPER_IDS}}

# arch -> the ROADMAP item of the slice that ports it
PENDING: dict[str, str] = {}

# the reference's assigned architectures that the port runs (the paper's
# models are PAPER_IDS, as in the reference)
ARCH_IDS = tuple(a for a in _MODULES if a not in PAPER_IDS)


def get_config(arch_id: str) -> ModelConfig:
    if arch_id in PENDING:
        raise NotImplementedError(
            f"{arch_id} is not in the port yet: ROADMAP {PENDING[arch_id]}")
    if arch_id not in _MODULES:
        raise KeyError(f"unknown architecture {arch_id!r}: the port has "
                       f"{', '.join(ARCH_IDS + PAPER_IDS)}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch_id]}")
    return mod.CONFIGS[arch_id] if hasattr(mod, "CONFIGS") else mod.CONFIG


def all_configs() -> dict[str, ModelConfig]:
    """The config of every architecture in ``ARCH_IDS``, by name (the
    reference's ``all_configs``)."""
    return {a: get_config(a) for a in ARCH_IDS}
