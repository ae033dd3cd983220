"""Cluster topology descriptions: chips, pods (vendor islands), clusters.

Counterpart of ``repro/core/topology.py``; the module is jax-free there, and
the port keeps its own copy.  In the paper the heterogeneity boundary is the
GPU *vendor* (all-NVIDIA nodes vs all-AMD nodes): ``PodSpec`` is the paper's
"vendor island", ``ClusterSpec`` the heterogeneous cluster (paper Table 1).

The chip sheets below are the planner's *model* of each chip (the numbers
its α-β simulator prices with), copied as data from the reference; none of
them is a measurement of the port.  ``launch/mesh.py::cluster_for_mesh``
maps a mesh of ranks onto one of these clusters.

All bandwidths are bytes/s, all compute in FLOP/s.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence


@dataclasses.dataclass(frozen=True)
class ChipSpec:
    """A single accelerator's capabilities, as the planner models them."""

    name: str
    peak_flops: float            # peak dense matmul FLOP/s (16-bit)
    hbm_bytes: float             # device memory capacity
    hbm_bw: float                # device memory bandwidth, bytes/s
    local_link_bw: float         # intra-island per-link bandwidth
    local_links: int = 1         # number of usable links per chip
    mfu: float = 0.5             # achievable fraction of peak in training
    # The paper (Appendix F.2) observes AMD's effective utilization is about
    # half of NVIDIA's at similar peak FLOPS (software-stack maturity); the
    # model carries that in ``mfu``.  The balancer never uses peak FLOPS
    # directly, only *profiled* throughput, exactly as HetCCL does.

    @property
    def effective_flops(self) -> float:
        return self.peak_flops * self.mfu


# ---------------------------------------------------------------------------
# The reference's island sheets (its production dry-run target and a
# previous-generation island for mixed fleets)
# ---------------------------------------------------------------------------

TPU_V5E = ChipSpec(
    name="tpu-v5e",
    peak_flops=197e12,
    hbm_bytes=16e9,
    hbm_bw=819e9,
    local_link_bw=50e9,
    local_links=4,
    mfu=0.5,
)

TPU_V4 = ChipSpec(
    name="tpu-v4",
    peak_flops=275e12,
    hbm_bytes=32e9,
    hbm_bw=1228e9,
    local_link_bw=50e9,
    local_links=6,
    mfu=0.45,
)

# ---------------------------------------------------------------------------
# The paper's hardware (Table 1) for figure-level validation of the simulator
# ---------------------------------------------------------------------------

V100_PCIE = ChipSpec(
    name="nvidia-v100-pcie",
    peak_flops=112e12,           # FP16, paper Appendix F.2
    hbm_bytes=32e9,
    hbm_bw=900e9,
    local_link_bw=13e9,          # effective PCIe Gen3 x16
    local_links=1,
    mfu=0.40,                    # profiled N:A throughput ratio ~ 2:1 (paper F.2)
)

W7800 = ChipSpec(
    name="amd-w7800",
    peak_flops=90.5e12,          # FP16, paper Appendix F.2
    hbm_bytes=32e9,
    hbm_bw=576e9,
    local_link_bw=26e9,          # effective PCIe Gen4 x16
    local_links=1,
    mfu=0.25,                    # "substantially lower effective utilization" (F.2)
)

# The data-sheet island of the card the port's ranks run on (the default of
# ``launch/mesh.py::cluster_for_mesh``).
H100_NVLINK = ChipSpec(
    name="nvidia-h100-sxm",
    peak_flops=989e12,
    hbm_bytes=80e9,
    hbm_bw=3350e9,
    local_link_bw=450e9,         # NVLink4 aggregate one-direction
    local_links=1,
    mfu=0.5,
)

MI300X_XGMI = ChipSpec(
    name="amd-mi300x",
    peak_flops=1307e12,
    hbm_bytes=192e9,
    hbm_bw=5300e9,
    local_link_bw=448e9,         # xGMI aggregate
    local_links=1,
    mfu=0.4,
)

# InfiniBand HDR (paper Table 1: ConnectX-6 HDR), the inter-island fabric.
IB_HDR_BW = 25e9                 # 200 Gb/s
# Host-staged path effective bandwidth (Fig 1a / Fig 16 non-RDMA baseline):
# bounded by two extra host copies sharing host memory bandwidth.
HOST_STAGED_BW = 6e9
# Per-message fixed cost (alpha) of an RDMA op vs an MPI host-mediated op.
RDMA_ALPHA = 5e-6
MPI_ALPHA = 1.5e-6               # MPI wins small messages (paper Fig 13)
MPI_HOST_REDUCE_BW = 8e9         # CPU-side reduction path for MPI all-reduce (Fig 14)


@dataclasses.dataclass(frozen=True)
class PodSpec:
    """A homogeneous island: the paper's per-vendor nodes."""

    name: str
    chip: ChipSpec
    n_chips: int
    rdma: bool = True            # False -> host-staged (Fig 16 ablation)

    @property
    def effective_flops(self) -> float:
        return self.chip.effective_flops * self.n_chips


@dataclasses.dataclass(frozen=True)
class ClusterSpec:
    """A (possibly heterogeneous) cluster of islands."""

    pods: Sequence[PodSpec]
    inter_pod_bw: float = IB_HDR_BW   # per-chip-pair cross-island bandwidth
    inter_pod_alpha: float = RDMA_ALPHA

    @property
    def n_chips(self) -> int:
        return sum(p.n_chips for p in self.pods)

    @property
    def homogeneous(self) -> bool:
        return len({p.chip.name for p in self.pods}) <= 1

    def inventory(self, pod: "PodSpec | str"):
        """The (mutable) :class:`~repro_torch.transport.links.LinkInventory`
        of ``pod``'s chip, built on first use and cached per cluster
        instance, so health changes (a link marked down or degraded) persist
        and flow into every bandwidth query below."""
        from repro_torch.transport.links import LinkInventory
        cache = self.__dict__.get("_inventories")
        if cache is None:
            cache = {}
            object.__setattr__(self, "_inventories", cache)
        name = pod if isinstance(pod, str) else pod.name
        if name not in cache:
            spec = pod if not isinstance(pod, str) else \
                next(p for p in self.pods if p.name == name)
            cache[name] = LinkInventory.from_chip(spec.chip)
        return cache[name]

    def effective_link_bw(self, pod: "PodSpec | str") -> float:
        """Endpoint capacity of ``pod``'s chips: the sum of *healthy* link
        bandwidth in the transport inventory (the static ``local_link_bw x
        local_links`` product only while every link is up)."""
        return self.inventory(pod).healthy_bw()

    def slowest_endpoint_bw(self) -> float:
        """Cross-island transfers are bounded by the slower endpoint (paper
        §5.2), each endpoint's capacity from its inventory."""
        return min(min(self.effective_link_bw(p) for p in self.pods),
                   self.inter_pod_bw)


# Ready-made clusters ------------------------------------------------------

def paper_cluster(n_nvidia: int = 4, n_amd: int = 4, rdma: bool = True) -> ClusterSpec:
    """The paper's four-node testbed (Table 1): 2 NVIDIA nodes x4 V100 + 2 AMD x4 W7800."""
    pods = []
    if n_nvidia:
        pods.append(PodSpec("nvidia", V100_PCIE, n_nvidia, rdma=rdma))
    if n_amd:
        pods.append(PodSpec("amd", W7800, n_amd, rdma=rdma))
    return ClusterSpec(tuple(pods))


def tpu_multipod(n_pods: int = 2, chips_per_pod: int = 256,
                 chips: Sequence[ChipSpec] | None = None) -> ClusterSpec:
    """The reference's dry-run target: ``n_pods`` islands of v5e (optionally
    mixed)."""
    chips = chips or [TPU_V5E] * n_pods
    pods = tuple(PodSpec(f"pod{i}", c, chips_per_pod) for i, c in enumerate(chips))
    return ClusterSpec(pods, inter_pod_bw=IB_HDR_BW)


def tpu_mixed_fleet(n_v5e: int = 2, n_v4: int = 2,
                    chips_per_pod: int = 128) -> ClusterSpec:
    """A mixed-generation fleet of v5e and v4 islands: the reference's
    analogue of the paper's NVIDIA + AMD testbed, which the plan autotuner
    (``repro_torch.plan``) balances shares across."""
    chips = [TPU_V5E] * n_v5e + [TPU_V4] * n_v4
    return tpu_multipod(n_v5e + n_v4, chips_per_pod, chips)
