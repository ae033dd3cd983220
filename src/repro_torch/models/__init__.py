"""Model substrate of the port: attention, the dense transformer, registry."""
from repro_torch.models.registry import Model, build  # noqa: F401
