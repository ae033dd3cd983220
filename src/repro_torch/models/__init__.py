"""Model substrate of the port: attention, MoE, the transformer (dense and
MoE families), registry."""
from repro_torch.models.registry import Model, build  # noqa: F401
