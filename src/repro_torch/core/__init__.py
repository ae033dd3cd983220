"""Port core: the TACC runtime dispatch table.

The collectives, the HetCCL front door, balancing, topology and the
simulator arrive with the training slice (ROADMAP A2).
"""
from repro_torch.core import tacc  # noqa: F401
