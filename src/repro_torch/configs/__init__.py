"""Architecture registry of the port.

Counterpart of ``repro/configs/__init__.py``.  The port runs the
architectures whose slice has landed: smollm-135m (dense; serving and
training), the two MoE models, mixtral-8x7b (sliding window) and
moonshot-v1-16b-a3b, and the SSM and hybrid models, mamba2-2.7b and
zamba2-7b (serving).  Asking for any other raises
``NotImplementedError`` naming the ROADMAP item that brings it.
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import ModelConfig

_MODULES = {"smollm-135m": "smollm_135m",
            "mixtral-8x7b": "mixtral_8x7b",
            "moonshot-v1-16b-a3b": "moonshot_v1_16b_a3b",
            "mamba2-2.7b": "mamba2_27b",
            "zamba2-7b": "zamba2_7b"}

# arch -> the ROADMAP item of the slice that ports it
PENDING = {
    "smollm-360m": "A8 (remaining configs and families)",
    "starcoder2-7b": "A8 (remaining configs and families)",
    "deepseek-coder-33b": "A8 (remaining configs and families)",
    "whisper-medium": "A8 (remaining configs and families)",
    "qwen2-vl-72b": "A8 (remaining configs and families)",
}

ARCH_IDS = tuple(_MODULES)


def get_config(arch_id: str) -> ModelConfig:
    if arch_id in PENDING:
        raise NotImplementedError(
            f"{arch_id} is not in the port yet: ROADMAP {PENDING[arch_id]}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch_id]}")
    return mod.CONFIG
