"""Architecture registry of the port.

Counterpart of ``repro/configs/__init__.py``.  The port runs the
architectures whose slice has landed: smollm-135m (dense; serving and
training), the two MoE models, mixtral-8x7b (sliding window) and
moonshot-v1-16b-a3b, and the SSM and hybrid models, mamba2-2.7b and
zamba2-7b (serving).  Asking for an architecture of the reference that is
not ported yet (``PENDING``: the rest of its ``ARCH_IDS`` and the paper's
own models, ``PAPER_IDS``) raises ``NotImplementedError`` naming the ROADMAP
item that brings it; an unknown name raises ``KeyError`` listing both.
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
_A8A = "A8a (the paper's models and the remaining dense configs)"
PENDING = {
    "gpt-125m": _A8A,
    "gpt-355m": _A8A,
    "llama-1b": _A8A,
    "llama-3b": _A8A,
    "smollm-360m": _A8A,
    "starcoder2-7b": _A8A,
    "deepseek-coder-33b": _A8A,
    "qwen2-vl-72b": "A8b (VLM)",
    "whisper-medium": "A8c (enc-dec)",
}

ARCH_IDS = tuple(_MODULES)


def get_config(arch_id: str) -> ModelConfig:
    if arch_id in PENDING:
        raise NotImplementedError(
            f"{arch_id} is not in the port yet: ROADMAP {PENDING[arch_id]}")
    if arch_id not in _MODULES:
        raise KeyError(f"unknown architecture {arch_id!r}: the port has "
                       f"{', '.join(ARCH_IDS)}; pending {', '.join(PENDING)}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch_id]}")
    return mod.CONFIG
