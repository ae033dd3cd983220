"""Port core: the TACC runtime dispatch table, the meshes of ranks, the
collectives and the HetCCL front door.

    tacc         runtime dispatch (kernels by device, collectives by mode)
    device       where entry points run (cuda unless asked for cpu)
    mesh         ThreadMesh / DistMesh: the counterpart of shard_map's axes
    collectives  flat / hier / pipelined collectives, xla rings
    hetccl       HetCCLConfig, install/use, all_reduce ... tree_all_reduce
    balance      per-island micro-batch shares (HetPlan), profiling
    topology     chips, islands, clusters: what the planner prices
    simulator    the α-β model the planner prices with
"""
from repro_torch.core import tacc  # noqa: F401
