"""Meshes of ranks: the counterpart of ``shard_map``'s manual axes.

The reference's collectives are per-rank code: they run inside
``shard_map`` and call ``lax.axis_index``, ``lax.axis_size``,
``lax.ppermute``, ``lax.psum_scatter``, ``lax.all_gather`` and ``lax.psum``
on named axes ("pod", "data").  The port keeps that per-rank shape, so
``core/collectives.py`` ports nearly line for line: each rank runs the same
function, and the module functions below (:func:`axis_index`,
:func:`ppermute`, ...) act for the rank that calls them.

Two meshes carry those functions (counterparts of ``repro/core/compat.py``'s
``shard_map`` and ``repro/launch/mesh.py``):

* :class:`ThreadMesh` runs every rank in one process, one thread per rank,
  all on one device.  Exchanges go through shared slots and a
  ``threading.Barrier``.  On one device the vendor-local stage
  (``psum_scatter`` / ``all_gather`` over "data") is a plain torch sum or
  concatenation across the ranks' tensors: there is no NCCL between ranks
  of one card.  A ``ppermute`` hop is a copy (``clone``), as a wire hop
  would be.  The fused ring kernels (``kernels/ring_dma.py``) run one launch
  for every rank of the mesh through :meth:`ThreadMesh.rendezvous`.
* :class:`DistMesh` is the same interface over ``torch.distributed``: one
  process per rank, a process group per axis.  ``ppermute`` is
  ``batch_isend_irecv``.  On CUDA ranks the fused ring kernels run one
  launch per rank over peer memory (``kernels/peer.py``'s arenas, one per
  ring group, freed by ``peer.close_arenas``; DESIGN_TORCH.md §28); on CPU
  ranks the pallas rings take the emulated schedule.  The local stage
  ("data" ``psum`` / ``psum_scatter`` / ``all_gather``) runs on the group's
  backend:

  - gloo (one card shared by several processes, where NCCL refuses two
    ranks of one device, and the CPU): ``all_gather``, then the sum in
    group order, as a ThreadMesh sums, so both meshes give the same bits.
    gloo moves CUDA tensors through host memory itself; its send and recv
    take host tensors only, so ``ppermute`` copies a CUDA tensor to the
    host and back (it is off the fused rings' path);
  - nccl (one card per rank): ``all_reduce``, and ``reduce_scatter_tensor``
    for an in-order tiled scatter over dim 0.  No test reaches this branch
    yet: every run so far has one card (ROADMAP A3).

Rank order is pod-major: ``rank = pod * D + data`` for ``{"pod": P,
"data": D}``, as ``HetCCLConfig.dp_axes`` orders the ranks.  A group over
several axes is ordered by those axes' coordinates, the first axis major.
"""
from __future__ import annotations

import contextlib
import functools
import math
import threading
from typing import Callable, Sequence

import torch

from repro_torch.core import tacc
from repro_torch.core.device import resolve_device

Axes = str | Sequence[str]

_tls = threading.local()
_PROCESS_MESH: "DistMesh | None" = None
# A context factory ``hook(rank)`` every ThreadMesh rank's thread enters
# around its function (the step counter installs it while it counts; None
# otherwise): a thread does not inherit its starter's dispatch mode.
RANK_HOOK: "Callable | None" = None


def _axes_tuple(axes: Axes) -> tuple[str, ...]:
    return (axes,) if isinstance(axes, str) else tuple(axes)


class _Mesh:
    """Shape bookkeeping shared by both meshes."""

    def __init__(self, shape: dict[str, int]):
        if not shape or any(int(v) < 1 for v in shape.values()):
            raise ValueError(f"mesh shape {shape!r}: axes of size >= 1 needed")
        self.shape = {str(k): int(v) for k, v in shape.items()}
        self.axes = tuple(self.shape)
        self.size = math.prod(self.shape.values())

    def coords(self, rank: int) -> dict[str, int]:
        out = {}
        for a in reversed(self.axes):
            rank, out[a] = divmod(rank, self.shape[a])
        return out

    def rank_of(self, coords: dict[str, int]) -> int:
        r = 0
        for a in self.axes:
            r = r * self.shape[a] + coords[a]
        return r

    def axis_size(self, axes: Axes) -> int:
        return math.prod(self.shape[a] for a in _axes_tuple(axes))

    def axis_index(self, rank: int, axes: Axes) -> int:
        c = self.coords(rank)
        idx = 0
        for a in _axes_tuple(axes):
            idx = idx * self.shape[a] + c[a]
        return idx

    def group(self, rank: int, axes: Axes) -> list[int]:
        """Ranks that share ``rank``'s coordinates off ``axes``, ordered by
        their index along ``axes``."""
        axes = _axes_tuple(axes)
        base = self.coords(rank)
        out = []
        for i in range(self.axis_size(axes)):
            c = dict(base)
            for a in reversed(axes):
                i, c[a] = divmod(i, self.shape[a])
            out.append(self.rank_of(c))
        return out

    # -- collectives over ``_gather`` (each mesh's own exchange), in group
    # order: a ThreadMesh and a gloo DistMesh give the same bits

    def psum(self, rank, x, axes):
        parts, _ = self._gather(rank, x, axes)
        return functools.reduce(torch.add, parts)

    def psum_scatter(self, rank, x, axes, scatter_dimension=0, tiled=False):
        parts, me = self._gather(rank, x, axes)
        n = len(parts)
        if tiled:
            parts = [p.chunk(n, scatter_dimension)[me] for p in parts]
        else:
            parts = [p.select(scatter_dimension, me) for p in parts]
        return functools.reduce(torch.add, parts)

    def all_gather(self, rank, x, axes, axis=0, tiled=False):
        parts, _ = self._gather(rank, x, axes)
        return torch.cat(parts, axis) if tiled else torch.stack(parts, axis)

    def all_to_all(self, rank, x, axes, split_axis=0, concat_axis=0):
        parts, me = self._gather(rank, x, axes)
        n = len(parts)
        return torch.cat([p.chunk(n, split_axis)[me] for p in parts], concat_axis)


class ThreadMesh(_Mesh):
    """All ranks in this process, one thread each, on one device.

        mesh = ThreadMesh({"pod": 2, "data": 2})          # on the card
        outs = mesh.run(fn, xs)        # outs[r] = fn(xs[r]) on rank r

    ``device`` defaults to ``"cuda"`` and raises without a card unless the
    caller passes ``"cpu"``.  An exception in one rank aborts the barrier, so
    the others raise instead of waiting; :meth:`run` re-raises the first
    rank's own error, and gives up after ``timeout`` seconds.

    ``psum``, ``psum_scatter``, ``all_gather`` and ``all_to_all`` read the
    peers' tensors by reference, after the exchange: a rank that writes one
    of its inputs in place after such a collective must first wait for
    every rank's reads (:meth:`barrier`; on the card the ranks share one
    stream, so reads enqueued before the barrier run before the write).
    """

    def __init__(self, shape: dict[str, int], device="cuda"):
        super().__init__(shape)
        dev = resolve_device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        self.device = dev
        self._slots: list = [None] * self.size
        self._pending: Callable | None = None
        self._results: list | None = None
        self._barrier = threading.Barrier(self.size, action=self._action)
        self._timeout: float | None = None

    def _action(self):
        fn, self._pending = self._pending, None
        if fn is not None:
            self._results = fn(list(self._slots))

    def _wait(self):
        self._barrier.wait(self._timeout)

    def run(self, fn: Callable, *per_rank: Sequence, timeout: float = 600.0) -> list:
        """``[fn(a[r], b[r], ...) for r]``, rank r on thread r; ``per_rank``
        holds one sequence of length ``size`` per argument."""
        for a in per_rank:
            if len(a) != self.size:
                raise ValueError(f"{len(a)} inputs for a mesh of {self.size} ranks")
        self._barrier = threading.Barrier(self.size, action=self._action)
        self._timeout = timeout
        self._pending = None
        results: list = [None] * self.size
        errors: list = [None] * self.size

        hook = RANK_HOOK

        def body(r):
            _tls.mesh, _tls.rank = self, r
            try:
                if self.device.type == "cuda":
                    torch.cuda.set_device(self.device)
                with hook(r) if hook is not None else contextlib.nullcontext():
                    results[r] = fn(*(a[r] for a in per_rank))
            except BaseException as e:          # noqa: BLE001  (re-raised below)
                errors[r] = e
                self._barrier.abort()
            finally:
                _tls.mesh = None

        threads = [threading.Thread(target=body, args=(r,), daemon=True,
                                    name=f"mesh-rank-{r}")
                   for r in range(self.size)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout)
        if any(t.is_alive() for t in threads):
            self._barrier.abort()
            raise TimeoutError(f"ThreadMesh.run: a rank did not finish in {timeout} s")
        errs = [e for e in errors if e is not None]
        if errs:        # a rank's own error, before the others' broken barriers
            raise next((e for e in errs
                        if not isinstance(e, threading.BrokenBarrierError)), errs[0])
        return results

    def _exchange(self, rank: int, value) -> list:
        self._slots[rank] = value
        self._wait()
        out = list(self._slots)
        self._wait()
        return out

    def barrier(self, rank: int) -> None:
        """Every rank of the mesh has reached this point."""
        self._wait()

    def rendezvous(self, rank: int, value, launch: Callable[[list], list]):
        """Every rank deposits ``value``; the last to arrive calls
        ``launch(values)`` once for all ranks (values in rank order); each
        rank gets ``launch``'s result at its own index.  ``launch`` must
        depend only on its argument and on what every rank passes alike."""
        self._slots[rank] = value
        self._pending = launch
        self._wait()
        out = self._results[rank]
        self._wait()
        return out

    # -- per-rank collectives ------------------------------------------------

    def ppermute(self, rank, x, axis, perm):
        vals = self._exchange(rank, x)
        grp = self.group(rank, axis)
        me = grp.index(rank)
        src = [s for s, d in perm if d == me]
        return vals[grp[src[0]]].clone() if src else torch.zeros_like(x)

    def _gather(self, rank, x, axes):
        vals = self._exchange(rank, x)
        grp = self.group(rank, axes)
        return [vals[g] for g in grp], grp.index(rank)

    def share(self, rank, value, axes):
        """Every rank deposits ``value``; returns the values of ``rank``'s
        group over ``axes`` themselves (references, no copy), in group
        order.  What ranks of one process can do that ranks of a
        ``DistMesh`` cannot: ZeRO-3's gathers read the peers' shards."""
        return self._gather(rank, value, axes)[0]


class ShapeMesh(ThreadMesh):
    """A mesh of ranks on the ``meta`` device that runs one rank per island:
    the dry run's mesh (``launch.dryrun``).

    Every collective is a shape-only stand-in: it returns a tensor of the
    shape the real collective would return and reads no peer (there is no
    data on ``meta``).  So the live ranks need not meet: :meth:`run` runs
    the first rank of every pod (of every pod whose work differs, after
    :meth:`same_pods`), one after the other, each on a thread of its own
    (the per-rank functions read the thread's rank), and gives every rank
    its pod's result.  Pods differ only in their live micro-steps
    (``HetPlan.live_mask``), which the step computes all the same.
    """

    def __init__(self, shape: dict[str, int]):
        _Mesh.__init__(self, shape)
        self.device = torch.device("meta")
        self.per_pod = self.size // self.shape.get("pod", 1)
        self.stand_in = list(range(self.shape.get("pod", 1)))
        self.live = [p * self.per_pod for p in range(self.shape.get("pod", 1))]

    def same_pods(self, stand_in: Sequence[int]) -> None:
        """Run pod ``stand_in[p]``'s rank for pod ``p`` (pods whose work is
        the same, e.g. equal shares of the batch, need one run)."""
        self.stand_in = [int(p) for p in stand_in]
        self.live = [p * self.per_pod for p in sorted(set(self.stand_in))]

    def run(self, fn: Callable, *per_rank: Sequence, timeout: float = 600.0) -> list:
        for a in per_rank:
            if len(a) != self.size:
                raise ValueError(f"{len(a)} inputs for a mesh of {self.size} ranks")
        out: dict[int, object] = {}
        hook = RANK_HOOK

        def body(r):
            _tls.mesh, _tls.rank = self, r
            try:
                with hook(r) if hook is not None else contextlib.nullcontext():
                    out[r] = fn(*(a[r] for a in per_rank))
            except BaseException as e:          # noqa: BLE001  (re-raised below)
                out[r] = e
            finally:
                _tls.mesh = None

        for r in self.live:
            t = threading.Thread(target=body, args=(r,), daemon=True, name=f"shape-rank-{r}")
            t.start()
            t.join(timeout)
            if isinstance(out.get(r), BaseException):
                raise out[r]
        return [out[self.stand_in[r // self.per_pod] * self.per_pod]
                for r in range(self.size)]

    def barrier(self, rank: int) -> None:
        pass

    def rendezvous(self, rank: int, value, launch):
        raise RuntimeError("a ShapeMesh runs no fused kernel")

    def ppermute(self, rank, x, axis, perm):
        return torch.empty_like(x)

    def share(self, rank, value, axes):
        return [value] * self.axis_size(axes)

    def psum(self, rank, x, axes):
        return x.clone()

    def psum_scatter(self, rank, x, axes, scatter_dimension=0, tiled=False):
        n = self.axis_size(axes)
        if tiled:
            return x.chunk(n, scatter_dimension)[0].clone()
        return x.select(scatter_dimension, 0).clone()

    def all_gather(self, rank, x, axes, axis=0, tiled=False):
        parts = [x] * self.axis_size(axes)
        return torch.cat(parts, axis) if tiled else torch.stack(parts, axis)

    def all_to_all(self, rank, x, axes, split_axis=0, concat_axis=0):
        n = self.axis_size(axes)
        return torch.cat([x.chunk(n, split_axis)[0]] * n, concat_axis)


class DistMesh(_Mesh):
    """The mesh over ``torch.distributed``: this process is one rank.

        dist.init_process_group("gloo", init_method=..., rank=r, world_size=n)
        mesh = DistMesh({"pod": 2, "data": 1}, device="cpu")
        out = mesh.run(fn, x)          # this rank's fn(x)

    Every rank builds the mesh (it creates one process group per axis
    group, collectively).  ``device`` defaults to ``"cuda"`` (this rank's
    card, ``rank % device_count``: every rank on the one card of a
    one-card host) and raises without a card unless the caller passes
    ``"cpu"``.
    """

    def __init__(self, shape: dict[str, int], device="cuda"):
        import torch.distributed as dist
        super().__init__(shape)
        if not dist.is_initialized():
            raise RuntimeError("DistMesh needs torch.distributed.init_process_group first")
        if dist.get_world_size() != self.size:
            raise ValueError(f"world size {dist.get_world_size()} != mesh size {self.size}")
        self.rank = dist.get_rank()
        dev = resolve_device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", self.rank % torch.cuda.device_count())
        self.device = dev
        self._nccl = dist.get_backend() == "nccl"
        self._groups = {}
        subsets = [(a,) for a in self.axes] + ([self.axes] if len(self.axes) > 1 else [])
        for axes in subsets:               # the same calls in the same order on every rank
            for r in range(self.size):
                grp = tuple(self.group(r, axes))
                if (axes, grp) not in self._groups and grp[0] == r:
                    self._groups[(axes, grp)] = dist.new_group(list(grp))

    def run(self, fn: Callable, *args):
        """This rank's ``fn(*args)`` with the mesh active."""
        global _PROCESS_MESH
        prev, _PROCESS_MESH = _PROCESS_MESH, self
        try:
            if self.device.type == "cuda":
                torch.cuda.set_device(self.device)
            return fn(*args)
        finally:
            _PROCESS_MESH = prev

    def _ordered(self, axes):
        """(process group, global ranks in this mesh's group order)."""
        axes = _axes_tuple(axes)
        canon = tuple(a for a in self.axes if a in axes)
        grp = self.group(self.rank, axes)
        return self._groups[(canon, tuple(self.group(self.rank, canon)))], grp

    def ppermute(self, rank, x, axis, perm):
        import torch.distributed as dist
        grp = self.group(rank, axis)
        me = grp.index(rank)
        host = x.is_cuda and not self._nccl       # gloo sends host tensors only
        src = x.contiguous().cpu() if host else x.contiguous()
        out = torch.zeros_like(src)
        ops = [dist.P2POp(dist.isend, src, grp[d]) for s, d in perm if s == me]
        recv = [s for s, d in perm if d == me]
        if recv:
            ops.append(dist.P2POp(dist.irecv, out, grp[recv[0]]))
        if ops:
            for w in dist.batch_isend_irecv(ops):
                w.wait()
        return out.to(x.device) if host else out

    def barrier(self, rank: int) -> None:
        """Nothing to wait for: this mesh's collectives copy what they read
        from the peers (``ThreadMesh.barrier`` orders in-place writes)."""

    def _gather(self, rank, x, axes):
        import torch.distributed as dist
        pg, grp = self._ordered(axes)
        got = [torch.empty_like(x) for _ in grp]
        dist.all_gather(got, x.contiguous(), group=pg)
        by_rank = dict(zip(sorted(grp), got))
        return [by_rank[g] for g in grp], grp.index(rank)

    def psum(self, rank, x, axes):
        import torch.distributed as dist
        if not self._nccl:          # in group order, as a ThreadMesh sums
            return super().psum(rank, x, axes)
        pg, _ = self._ordered(axes)
        out = x.clone()
        dist.all_reduce(out, group=pg)
        return out

    def psum_scatter(self, rank, x, axes, scatter_dimension=0, tiled=False):
        import torch.distributed as dist
        if not self._nccl:          # in group order, as a ThreadMesh sums
            return super().psum_scatter(rank, x, axes, scatter_dimension, tiled)
        pg, grp = self._ordered(axes)
        n, me = len(grp), grp.index(rank)
        if scatter_dimension == 0 and sorted(grp) == grp:
            src = x.contiguous()
            out = torch.empty((src.shape[0] // n,) + tuple(src.shape[1:]),
                              dtype=x.dtype, device=x.device)
            dist.reduce_scatter_tensor(out, src, group=pg)
            return out if tiled else out.reshape(x.shape[1:])
        total = x.clone()
        dist.all_reduce(total, group=pg)
        if tiled:
            return total.chunk(n, scatter_dimension)[me].contiguous()
        return total.select(scatter_dimension, me).contiguous()


# ---------------------------------------------------------------------------
# Per-rank functions: act for the calling rank of the active mesh.
# ---------------------------------------------------------------------------

def current() -> tuple[_Mesh, int]:
    """(mesh, rank) of the caller: its ThreadMesh thread, else the
    process's active DistMesh."""
    m = getattr(_tls, "mesh", None)
    if m is not None:
        return m, _tls.rank
    if _PROCESS_MESH is not None:
        return _PROCESS_MESH, _PROCESS_MESH.rank
    raise RuntimeError("not inside a mesh: per-rank collectives run under "
                       "ThreadMesh.run or DistMesh.run")


def axis_index(axes: Axes) -> int:
    m, r = current()
    return m.axis_index(r, axes)


def axis_size(axes: Axes) -> int:
    return current()[0].axis_size(axes)


def barrier() -> None:
    """The calling rank waits until every rank of its mesh has come here."""
    m, r = current()
    m.barrier(r)


@tacc.stage("collective-permute")
def ppermute(x, axis: str, perm):
    m, r = current()
    return m.ppermute(r, x, axis, list(perm))


@tacc.stage("all-reduce")
def psum(x, axes: Axes):
    m, r = current()
    return m.psum(r, x, axes)


@tacc.stage("reduce-scatter")
def psum_scatter(x, axes: Axes, *, scatter_dimension: int = 0, tiled: bool = False):
    m, r = current()
    return m.psum_scatter(r, x, axes, scatter_dimension, tiled)


@tacc.stage("all-gather")
def all_gather(x, axes: Axes, *, axis: int = 0, tiled: bool = False):
    m, r = current()
    return m.all_gather(r, x, axes, axis, tiled)


@tacc.stage("all-to-all")
def all_to_all(x, axes: Axes, *, split_axis: int = 0, concat_axis: int = 0):
    m, r = current()
    return m.all_to_all(r, x, axes, split_axis, concat_axis)
