"""A mesh of ranks as the planner sees it: its axis sizes and its modeled
cluster.

Counterpart of the jax-free part of ``repro/launch/mesh.py``
(``mesh_axis_sizes``, ``pod_size_of``, ``cluster_for_mesh``,
``resolve_stripes``), for the port's meshes: a
:class:`~repro_torch.core.mesh.ThreadMesh` or
:class:`~repro_torch.core.mesh.DistMesh` (``shape`` a dict of axis sizes,
``axes``, ``size``; no ``.devices``), the port's production and smoke
meshes (:func:`make_production_mesh`, :func:`make_smoke_mesh`), and
:func:`spawn_dist_mesh`, which starts a ``DistMesh`` of processes and
returns each rank's result.

One deliberate departure (DESIGN_TORCH.md §23): ``cluster_for_mesh`` with
``chips=None`` models every island as ``topology.H100_NVLINK``, the card the
port's ranks run on, where the reference's default is its v5e island.
Pass ``chips`` to price another fleet (e.g. the paper's V100 + W7800
testbed) on the same mesh.
"""
from __future__ import annotations

import os
import shutil
import tempfile
import time
import traceback

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


# ---------------------------------------------------------------------------
# A DistMesh of processes
# ---------------------------------------------------------------------------

def _dist_rank(rank, world, workdir, shape, device, fn, args):
    """One spawned rank: its log to ``rank<r>.log``, its result (or its
    error) to ``rank<r>.pt``."""
    import sys

    import torch
    import torch.distributed as dist
    log = open(os.path.join(workdir, f"rank{rank}.log"), "w", buffering=1)
    os.dup2(log.fileno(), 1)
    os.dup2(log.fileno(), 2)
    sys.stdout = sys.stderr = log
    out = os.path.join(workdir, f"rank{rank}.pt")
    try:
        from repro_torch.core.mesh import DistMesh
        from repro_torch.kernels import peer
        if str(device).startswith("cuda"):
            torch.cuda.set_device(rank % torch.cuda.device_count())
        # gloo: NCCL refuses two ranks of one card (DESIGN_TORCH.md §28)
        dist.init_process_group("gloo", init_method=f"file://{workdir}/rendezvous",
                                rank=rank, world_size=world)
        mesh = DistMesh(shape, device=device)
        try:
            result = fn(mesh, *args)
        finally:
            peer.close_arenas()
        torch.save({"ok": True, "result": result}, out + ".tmp")
        os.replace(out + ".tmp", out)
        dist.destroy_process_group()
    except BaseException:                        # noqa: BLE001  (reported to the parent)
        traceback.print_exc()
        torch.save({"ok": False, "error": traceback.format_exc()}, out + ".tmp")
        os.replace(out + ".tmp", out)
        log.flush()
        os._exit(1)
    log.flush()


def _tail(path: str, n: int = 60) -> str:
    try:
        with open(path) as f:
            return "".join(f.readlines()[-n:])
    except OSError:
        return "(no log)"


def spawn_dist_mesh(fn, shape: dict[str, int], *, args=(), device="cuda",
                    timeout: float = 600.0, workdir: str | None = None) -> list:
    """Run ``fn(mesh, *args)`` on every rank of a ``DistMesh`` of
    ``shape``, one spawned process per rank, and return the ranks' results
    in rank order.

    Each process joins the process group (gloo, ``init_method`` a
    ``file://`` rendezvous in ``workdir``), builds the mesh on ``device``
    (``"cuda"``: every rank on ``rank % device_count``), calls ``fn`` and
    frees the ring arenas (``peer.close_arenas``).  ``fn`` and ``args``
    must pickle (a module-level function); the result goes back through
    ``torch.save``.  A rank that
    raises or exits, or a run past ``timeout`` seconds, stops every process
    and raises with the failing rank's log.  ``workdir`` keeps each rank's
    log, ``rank<r>.log``; by default a new temporary directory, removed
    after a run that succeeds."""
    import torch
    import torch.multiprocessing as mp
    world = 1
    for v in shape.values():
        world *= int(v)
    own_dir = workdir is None
    workdir = workdir or tempfile.mkdtemp(prefix="repro-dist-")
    os.makedirs(workdir, exist_ok=True)
    for name in os.listdir(workdir):
        if name == "rendezvous" or name.startswith("rank"):
            os.remove(os.path.join(workdir, name))
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_dist_rank, daemon=True,
                         args=(r, world, workdir, dict(shape), str(device), fn, tuple(args)))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    failed = None
    try:
        while any(p.is_alive() for p in procs):
            bad = [r for r, p in enumerate(procs) if not p.is_alive() and p.exitcode != 0]
            if bad:
                failed = (bad[0], f"exit code {procs[bad[0]].exitcode}")
                break
            if time.monotonic() > deadline:
                late = [r for r, p in enumerate(procs) if p.is_alive()]
                failed = (late[0], f"still running after {timeout} s (ranks {late})")
                break
            time.sleep(0.05)
        else:
            bad = [r for r, p in enumerate(procs) if p.exitcode != 0]
            if bad:
                failed = (bad[0], f"exit code {procs[bad[0]].exitcode}")
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
        for p in procs:
            p.join(10)
            if p.is_alive():
                p.kill()
                p.join()
    if failed is not None:
        r, why = failed
        raise RuntimeError(f"DistMesh rank {r} of {world} failed ({why}); its log "
                           f"({workdir}/rank{r}.log), last lines:\n"
                           f"{_tail(os.path.join(workdir, f'rank{r}.log'))}")
    results = []
    for r in range(world):
        got = torch.load(os.path.join(workdir, f"rank{r}.pt"), weights_only=False)
        results.append(got["result"])
    if own_dir:
        shutil.rmtree(workdir, ignore_errors=True)
    return results
