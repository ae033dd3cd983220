"""A mesh of ranks as the planner sees it: its axis sizes and its modeled
cluster.

Counterpart of the jax-free part of ``repro/launch/mesh.py``
(``mesh_axis_sizes``, ``pod_size_of``, ``cluster_for_mesh``,
``resolve_stripes``), for the port's meshes: a
:class:`~repro_torch.core.mesh.ThreadMesh` or
:class:`~repro_torch.core.mesh.DistMesh` (``shape`` a dict of axis sizes,
``axes``, ``size``; no ``.devices``), and the port's production and smoke
meshes (:func:`make_production_mesh`, :func:`make_smoke_mesh`).

One deliberate departure (DESIGN_TORCH.md §23): ``cluster_for_mesh`` with
``chips=None`` models every island as ``topology.H100_NVLINK``, the card the
port's ranks run on, where the reference's default is its v5e island.
Pass ``chips`` to price another fleet (e.g. the paper's V100 + W7800
testbed) on the same mesh.
"""
from __future__ import annotations

# The port's production meshes of ranks (DESIGN_TORCH.md §24).  The
# reference's are (data 16, model 16) and (pod 4, data 8, model 16): 512
# chips with a model axis.  The port has no model axis, so every chip is a
# data-parallel rank, and ``TRAIN_4K``'s global batch of 256 sequences takes
# at most 256 of them (``global_batch % dp == 0``): 256 ranks on one island,
# or on four islands of 64 (the reference's four islands, each half as big).
PRODUCTION_SHAPES = {"single": {"data": 256}, "multi": {"pod": 4, "data": 64}}


def mesh_axis_sizes(mesh) -> dict[str, int]:
    """``{axis: size}`` in the mesh's axis order."""
    return {a: int(mesh.shape[a]) for a in mesh.axes}


def pod_size_of(mesh) -> int:
    """Ranks per island (0 when the mesh has no 'pod' axis)."""
    sizes = mesh_axis_sizes(mesh)
    if "pod" not in sizes:
        return 0
    return mesh.size // sizes["pod"]


def cluster_for_mesh(mesh, chips=None, inter_pod_bw: float | None = None):
    """Map a mesh of ranks onto the topology model the planner prices
    (``repro_torch.plan``, DESIGN.md §9).

    Islands come from the mesh's 'pod' axis (one island when absent); each
    island gets ``mesh.size / n_pods`` chips.  ``chips`` is the hardware each
    island is modeled as: one ``ChipSpec`` for a homogeneous fleet or one per
    pod; ``None`` means ``H100_NVLINK`` for every island.  ``inter_pod_bw``
    defaults to InfiniBand HDR (``topology.IB_HDR_BW``).

    Returns:
        A ``topology.ClusterSpec`` whose pod count and sizes mirror the mesh
        (pods named ``pod0``, ``pod1``, ...), equal to the reference's for a
        JAX mesh of the same shape and the same ``chips``.
    """
    from repro_torch.core.topology import (ChipSpec, ClusterSpec, H100_NVLINK,
                                           IB_HDR_BW, PodSpec)
    n_pods = mesh_axis_sizes(mesh).get("pod", 1)
    per_pod = mesh.size // n_pods
    if chips is None:
        chips = [H100_NVLINK] * n_pods
    elif isinstance(chips, ChipSpec):
        chips = [chips] * n_pods
    chips = list(chips)
    if len(chips) != n_pods:
        raise ValueError(f"{len(chips)} chip sheets for a mesh of {n_pods} pods")
    pods = tuple(PodSpec(f"pod{i}", c, per_pod) for i, c in enumerate(chips))
    return ClusterSpec(
        pods, inter_pod_bw=IB_HDR_BW if inter_pod_bw is None else inter_pod_bw)


def resolve_stripes(stripes: str, backend: str, mesh) -> int:
    """The launcher's ``--stripes`` resolution (DESIGN.md §11).

    An integer pins the count; ``"auto"`` asks ``transport.plan_stripes``
    over the mesh's modeled cluster (:func:`cluster_for_mesh`), meaningful
    only for the pallas backend on a multi-island mesh (the xla ring is one
    logical transfer), so everything else resolves to 1.  The representative
    payload is one gradient bucket's cross-ring shard (``bucket_bytes`` over
    the data axis), the transfer the stripes carry.
    """
    if stripes != "auto":
        return int(stripes)
    sizes = mesh_axis_sizes(mesh)
    if backend != "pallas" or sizes.get("pod", 1) <= 1:
        return 1
    from repro_torch.configs.base import RunConfig
    from repro_torch.transport import auto_stripes
    return auto_stripes(cluster_for_mesh(mesh),
                        RunConfig().bucket_bytes // sizes.get("data", 1))


def make_production_mesh(*, multi_pod: bool = False):
    """The port's production mesh, as the dry run sees it: a
    ``core.mesh.ShapeMesh`` of :data:`PRODUCTION_SHAPES` on ``meta`` (one
    rank per island runs; the collectives are shape-only)."""
    from repro_torch.core.mesh import ShapeMesh
    return ShapeMesh(PRODUCTION_SHAPES["multi" if multi_pod else "single"])


def make_smoke_mesh(n_pods: int = 1, data: int = 1, *, device="cuda"):
    """A small ``ThreadMesh`` (on the card unless ``device="cpu"``): axes
    ("pod", "data") with more than one pod, else ("data",)."""
    from repro_torch.core.mesh import ThreadMesh
    shape = {"pod": n_pods, "data": data} if n_pods > 1 else {"data": data}
    return ThreadMesh(shape, device=device)
