"""Checkpointless recovery: reshard optimizer state from surviving replicas
(DESIGN.md §13).

Counterpart of ``repro/elastic/recover.py``.  The insight the elastic path
exploits: ZeRO replication often *already* holds every shard of the train
state on the surviving pods.  With ZeRO-3 (parameters and optimizer state
sharded over intra-pod "data" only, replicated across pods) a pod loss
destroys replicas but no unique data: the state is gathered from the live
ranks and placed on the survivor mesh without touching a checkpoint, turning
recovery cost from ``state_bytes / disk_bw`` into an inter-pod gather
(``simulator.rebuild_time``).  With ZeRO-1 the flat 1/W optimizer shards
span ("pod", "data"): a pod loss destroys unique shards, and recovery
*must* fall back to the checkpoint chain.  The EF residuals are rank-local
over the whole DP world under both stages: they die with the pod too.

The port's train state is a list of per-rank states on a ``ThreadMesh``
(every rank a thread of one process, all on one card), so "the devices of a
pod" are the ranks of its pod coordinate (:func:`pod_devices`).  The ground
truth of coverage is :func:`assemble_from_survivors`, which gathers every
leaf from the live ranks alone (``checkpoint.StateLayout.gather``) and names
the leaves they cannot tile; placement onto the new mesh reuses
``checkpoint.place_tree``, the machinery a resharding restore uses.
"""
from __future__ import annotations

import dataclasses

from repro_torch.core.tree import flatten
from repro_torch.train import checkpoint as ckpt_mod


class IncompleteCoverage(RuntimeError):
    """Surviving replicas do not tile some leaf's full logical array —
    checkpointless recovery is impossible; fall back to the checkpoint."""

    def __init__(self, missing: list[str]):
        self.missing = list(missing)
        super().__init__(
            f"{len(self.missing)} leaves lost shards with the dead pod "
            f"(first: {self.missing[0] if self.missing else '?'})")


@dataclasses.dataclass(frozen=True)
class RecoveryResult:
    """state: the recovered per-rank states, placed on the new program.
    method: "checkpointless" (gathered from live ranks) or "checkpoint".
    step:   the step the state corresponds to — unchanged for
            checkpointless, the restored checkpoint's step for fallback.
    missing: leaf paths that lacked coverage (empty on the checkpointless
            path; the reason for the fallback otherwise)."""

    state: object
    method: str
    step: int
    missing: tuple[str, ...] = ()


def pod_devices(mesh, pod_index: int) -> list[int]:
    """The ranks of one pod (island) of a mesh with a "pod" axis."""
    return [r for r in range(mesh.size) if mesh.coords(r)["pod"] == pod_index]


def survivor_mesh(mesh, pod_index: int):
    """The mesh minus one pod, on the same device.  With one pod left the
    "pod" axis is dropped: the survivor program has no pod axis and its
    communicator degrades to flat, as ``comm.create`` resolves a
    single-island topology."""
    from repro_torch.core.mesh import ThreadMesh
    if type(mesh) is not ThreadMesh:
        raise NotImplementedError("survivor meshes are carved from a ThreadMesh")
    if not 0 <= pod_index < mesh.shape.get("pod", 0):
        raise ValueError(f"pod {pod_index} of mesh {mesh.shape}")
    shape = dict(mesh.shape)
    shape["pod"] -= 1
    if shape["pod"] == 0:
        raise ValueError(f"mesh {mesh.shape} has no pod to spare")
    if shape["pod"] == 1:
        del shape["pod"]
    return ThreadMesh(shape, device=mesh.device)


def assemble_from_survivors(state, dead, layout):
    """Full logical arrays of every leaf of ``state`` (per-rank states of
    the program ``layout``), read from the ranks not in ``dead`` alone.

    Returns ``(flat, missing)``: the arrays in the logical tree's flatten
    order (leaves with holes are None, the step an int) and the paths of
    the leaves whose surviving shards do not tile them.  In a real fleet the
    reads are RDMA gathers from live peers; on one card they are the live
    ranks' tensors, and a dead rank's state is never read."""
    tree, missing = ckpt_mod.StateLayout.of(layout).gather(state, dead)
    return flatten(tree)[0], missing


def recover_state(state, step: int, new_prog, dead, *, layout,
                  ckpt_dir: str | None = None,
                  verify: bool = True) -> RecoveryResult:
    """Recover the train state onto ``new_prog``'s mesh after losing the
    ranks in ``dead`` of ``state``'s program ``layout``.

    Tries the checkpointless path first: assemble every leaf from the
    surviving ranks' in-memory states and place it on the new program —
    recovery resumes from ``step``, *newer* than any checkpoint.  On
    incomplete coverage (ZeRO-1's flat shards, EF residuals) falls back to
    :func:`repro_torch.train.checkpoint.restore_latest` onto the new
    program (after the pending async save, the newest restore point),
    resuming from the checkpoint's step; a checkpoint whose EF residuals
    belong to another world size is refused there, as in the reference.
    No ``ckpt_dir`` means no fallback: :class:`IncompleteCoverage`
    propagates.
    """
    new_layout = ckpt_mod.StateLayout.of(new_prog)
    like = new_layout.logical_like()
    flat, missing = assemble_from_survivors(state, dead, layout)
    if not missing:
        placed = ckpt_mod.place_tree(flat, like, new_layout)
        return RecoveryResult(state=placed, method="checkpointless",
                              step=step, missing=())
    if ckpt_dir is None:
        raise IncompleteCoverage(missing)
    ckpt_mod.wait_pending()
    ckpt_step, placed = ckpt_mod.restore_latest(ckpt_dir, like, new_layout,
                                                verify=verify)
    return RecoveryResult(state=placed, method="checkpoint", step=ckpt_step,
                          missing=tuple(missing))
