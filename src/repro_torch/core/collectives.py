"""HetCCL collectives: vendor-local native stages + cross-island P2P rings.

Counterpart of ``repro/core/collectives.py:1-795``.  The paper's mechanism
(§4.1-§4.2): a collective over a heterogeneous group is decomposed into a
*vendor-local* stage run by the vendor's library and a *cross-vendor* stage
built from point-to-point transfers, so only the unavoidable cross-island
hop crosses the slow boundary.

Everything here is per-rank code and runs inside a mesh
(:mod:`repro_torch.core.mesh`), as the reference runs inside ``shard_map``:

* vendor-local stage -> ``mesh.psum`` / ``psum_scatter`` / ``all_gather``
  over the intra-island axes (a plain sum or concatenation on a
  ``ThreadMesh``, the process group's collectives on a ``DistMesh``);
* cross-island stage -> explicit ``mesh.ppermute`` rings over ``"pod"``.

Registered in TACC under ``"flat"``, ``"hier"`` and ``"pipelined"``, each
declaring the policy fields it consumes.  The ring implementation is the
``backend`` keyword: ``"xla"`` is the ppermute rings below, ``"pallas"`` the
rings of :mod:`repro_torch.kernels.ring_dma` (the fused CUDA kernels on a
``ThreadMesh`` on the card, their emulated schedule elsewhere).

``fsdp_all_gather`` (ZeRO-3's parameter gather, an autograd Function whose
adjoint is a reduce-scatter) closes the module; :class:`FsdpScope` says where
its adjoint runs.  ``software_pipeline`` keeps the reference's wavefront
order, but eager PyTorch runs the stages one after another: nothing overlaps
yet.
"""
from __future__ import annotations

import functools
from typing import Sequence

import torch
import torch.nn.functional as F

from repro_torch.core import mesh, tacc
from repro_torch.transport.stripe import MXU_TILE_BYTES

Axis = str | Sequence[str]


def _axes_tuple(axes: Axis) -> tuple[str, ...]:
    return (axes,) if isinstance(axes, str) else tuple(axes)


def axis_world(axes: Axis) -> int:
    n = 1
    for a in _axes_tuple(axes):
        n *= mesh.axis_size(a)
    return n


RING_BACKENDS = ("xla", "pallas")


def resolve_ring_backend(backend: str, *, bidir: bool = False,
                         n_stripes: int = 1, wire_quant: str | None = None):
    """(reduce_scatter, all_gather) ring primitives for ``backend``:
    ``"xla"`` the ppermute rings here, ``"pallas"`` the rings of
    :mod:`repro_torch.kernels.ring_dma` with ``n_stripes`` and the
    ``wire_quant`` codec bound in (the xla rings carry no codec)."""
    if backend == "pallas":
        from repro_torch.kernels import ring_dma
        rs = (ring_dma.ring_reduce_scatter_bidir if bidir
              else ring_dma.ring_reduce_scatter)
        ag = (ring_dma.ring_all_gather_bidir if bidir
              else ring_dma.ring_all_gather)
        kw = {}
        if n_stripes and int(n_stripes) > 1:
            kw["n_stripes"] = int(n_stripes)
        if wire_quant is not None:
            kw["wire_quant"] = wire_quant
        if kw:
            rs = functools.partial(rs, **kw)
            ag = functools.partial(ag, **kw)
        return rs, ag
    if backend != "xla":
        raise ValueError(f"unknown collective backend {backend!r}; "
                         f"expected one of {RING_BACKENDS}")
    return ((ring_reduce_scatter_bidir if bidir else ring_reduce_scatter),
            (ring_all_gather_bidir if bidir else ring_all_gather))


# ---------------------------------------------------------------------------
# Ring primitives over a single axis (the "RDMA" stage).
# ---------------------------------------------------------------------------

def chunked(x, n: int):
    """x (n*c, ...) -> (n, c, ...): the ring's n chunks of dim 0."""
    if x.shape[0] % n:
        raise ValueError(f"dim 0 of {tuple(x.shape)} does not split into {n} chunks")
    return x.reshape((n, x.shape[0] // n) + tuple(x.shape[1:]))


def _fwd_perm(n: int) -> list[tuple[int, int]]:
    return [(j, (j + 1) % n) for j in range(n)]


def _ring_perm(n: int, direction: int) -> list[tuple[int, int]]:
    return [(j, (j + direction) % n) for j in range(n)]


def _ring_rs_chunks(chunks, axis: str, direction: int = 1):
    """chunks: (n, c, ...) -> this rank's reduced chunk (c, ...)."""
    n = chunks.shape[0]
    idx = mesh.axis_index(axis)
    perm = _ring_perm(n, direction)
    acc = list(chunks.unbind(0))
    for s in range(n - 1):
        rblk = mesh.ppermute(acc[(idx - direction * (s + 1)) % n], axis, perm)
        recv = (idx - direction * (s + 2)) % n
        acc[recv] = acc[recv] + rblk
    return acc[idx]


def ring_reduce_scatter(x, axis: str):
    """x: (n*c, ...) tiled on dim 0 -> this rank's reduced chunk (c, ...)."""
    n = mesh.axis_size(axis)
    if n == 1:
        return x
    return _ring_rs_chunks(chunked(x, n), axis, 1)


def ring_reduce_scatter_bidir(x, axis: str):
    """Bidirectional ring reduce-scatter: the payload's two halves travel
    clockwise and counterclockwise in one loop."""
    n = mesh.axis_size(axis)
    if n == 1:
        return x
    chunks = chunked(x, n)
    c = chunks.shape[1]
    if c < 2:
        return _ring_rs_chunks(chunks, axis, 1)
    h = c // 2
    idx = mesh.axis_index(axis)
    perm_f, perm_b = _ring_perm(n, 1), _ring_perm(n, -1)
    af, ab = list(chunks[:, :h].unbind(0)), list(chunks[:, h:].unbind(0))
    for s in range(n - 1):
        rf = mesh.ppermute(af[(idx - s - 1) % n], axis, perm_f)
        rb = mesh.ppermute(ab[(idx + s + 1) % n], axis, perm_b)
        af[(idx - s - 2) % n] = af[(idx - s - 2) % n] + rf
        ab[(idx + s + 2) % n] = ab[(idx + s + 2) % n] + rb
    return torch.cat([af[idx], ab[idx]], 0)


def ring_reduce_scatter_mixed(x, axis: str, wire_dtype=None):
    """Ring reduce-scatter with a narrow wire and f32 accumulation: the
    payload crosses in ``wire_dtype`` (default x.dtype), the accumulator
    stays f32.  Returns the f32 chunk this rank owns."""
    n = mesh.axis_size(axis)
    if n == 1:
        return x.float()
    wire_dtype = wire_dtype or x.dtype
    acc = list(chunked(x, n).float().unbind(0))
    idx = mesh.axis_index(axis)
    perm = _fwd_perm(n)
    for s in range(n - 1):
        rblk = mesh.ppermute(acc[(idx - s - 1) % n].to(wire_dtype), axis, perm)
        recv = (idx - s - 2) % n
        acc[recv] = acc[recv] + rblk.float()
    return acc[idx]


def _ring_ag_stack(x, axis: str, direction: int = 1):
    """x: (c, ...) per-rank chunk -> (n, c, ...) rank-stacked."""
    n = mesh.axis_size(axis)
    idx = mesh.axis_index(axis)
    perm = _ring_perm(n, direction)
    out = [None] * n
    out[idx] = cur = x
    for s in range(n - 1):
        cur = mesh.ppermute(cur, axis, perm)       # chunk of rank (idx - d*(s+1))
        out[(idx - direction * (s + 1)) % n] = cur
    return torch.stack(out, 0)


def ring_all_gather(x, axis: str):
    """x: (c, ...) per-rank chunk -> (n*c, ...) rank-major, all ranks equal."""
    n = mesh.axis_size(axis)
    if n == 1:
        return x
    return _ring_ag_stack(x, axis, 1).reshape((n * x.shape[0],) + tuple(x.shape[1:]))


def ring_all_gather_bidir(x, axis: str):
    """Bidirectional ring all-gather: each half of every rank's chunk
    circulates in its own direction."""
    n = mesh.axis_size(axis)
    if n == 1:
        return x
    c = x.shape[0]
    if c < 2:
        return ring_all_gather(x, axis)
    h = c // 2
    idx = mesh.axis_index(axis)
    perm_f, perm_b = _ring_perm(n, 1), _ring_perm(n, -1)
    accf, accb = [None] * n, [None] * n
    accf[idx] = curf = x[:h]
    accb[idx] = curb = x[h:]
    for s in range(n - 1):
        curf = mesh.ppermute(curf, axis, perm_f)      # chunk of rank (idx - s - 1)
        curb = mesh.ppermute(curb, axis, perm_b)      # chunk of rank (idx + s + 1)
        accf[(idx - s - 1) % n] = curf
        accb[(idx + s + 1) % n] = curb
    out = torch.cat([torch.stack(accf, 0), torch.stack(accb, 0)], 1)   # (n, c, ...)
    return out.reshape((n * c,) + tuple(x.shape[1:]))


def ring_all_reduce(x, axis: str):
    """Bandwidth-optimal ring all-reduce (reduce-scatter + all-gather)."""
    n = mesh.axis_size(axis)
    if n == 1:
        return x
    shape, dtype = x.shape, x.dtype
    flat = x.reshape(-1)
    pad = (-flat.shape[0]) % n
    if pad:
        flat = F.pad(flat, (0, pad))
    red = ring_all_gather(ring_reduce_scatter(flat, axis), axis)
    if pad:
        red = red[: flat.shape[0] - pad]
    return red.reshape(shape).to(dtype)


def ring_all_to_all(x, axis: str):
    """x: (n, ...) block i destined for rank i -> (n, ...) block j from rank
    j, with n-1 ppermutes of stride s."""
    n = mesh.axis_size(axis)
    if n == 1:
        return x
    idx = mesh.axis_index(axis)
    out = [None] * n
    out[idx] = x[idx]
    for s in range(1, n):
        perm = [(j, (j + s) % n) for j in range(n)]
        out[(idx - s) % n] = mesh.ppermute(x[(idx + s) % n], axis, perm)
    return torch.stack(out, 0)


def ring_broadcast(x, axis: str, root: int = 0):
    """Chain-forward the root's value around the ring (n-1 hops)."""
    n = mesh.axis_size(axis)
    if n == 1:
        return x
    perm = _fwd_perm(n)
    idx = mesh.axis_index(axis)
    cur = kept = x
    for s in range(n - 1):
        cur = mesh.ppermute(cur, axis, perm)
        if (idx - root) % n == s + 1:
            kept = cur
    return kept


# ---------------------------------------------------------------------------
# Flat (single-stage, native) collectives: the homogeneous baseline.
# Each registration declares exactly the CommPolicy fields it consumes.
# ---------------------------------------------------------------------------

def _flat_rank_index(all_axes: tuple[str, ...]) -> int:
    """Pod-major flat rank over ``all_axes`` (rank = pod·D + data)."""
    flat_idx, stride = 0, 1
    for a in reversed(all_axes):
        flat_idx += mesh.axis_index(a) * stride
        stride *= mesh.axis_size(a)
    return flat_idx


def _moved(x, dim):
    return torch.movedim(x, dim, 0) if dim != 0 else x


def _unmoved(x, dim):
    return torch.movedim(x, 0, dim) if dim != 0 else x


@tacc.register("all_reduce", "flat", default=True,
               policy_fields=("backend", "n_stripes", "wire_quant"))
def flat_all_reduce(x, axes: Axis, pod_axis: str | None = None, *,
                    backend: str = "xla", n_stripes: int = 1,
                    wire_quant: str | None = None):
    all_axes = _axes_tuple(axes) + ((pod_axis,) if pod_axis else ())
    if backend == "pallas":
        # the single-stage ring with the pallas rings, one per axis
        from repro_torch.kernels import ring_dma
        out = x
        for a in all_axes:
            out = ring_dma.ring_all_reduce(out, a, n_stripes=n_stripes,
                                           wire_quant=wire_quant)
        return out
    return mesh.psum(x, all_axes)


@tacc.register("all_gather", "flat", default=True,
               policy_fields=("backend", "n_stripes", "wire_quant"))
def flat_all_gather(x, axes: Axis, pod_axis: str | None = None, *, dim: int = 0,
                    tiled: bool = True, backend: str = "xla",
                    n_stripes: int = 1, wire_quant: str | None = None):
    gather_axes = _axes_tuple(axes) + ((pod_axis,) if pod_axis else ())
    if backend == "pallas" and tiled:
        from repro_torch.kernels import ring_dma
        out = _moved(x, dim)
        for a in gather_axes:
            out = ring_dma.ring_all_gather(out, a, n_stripes=n_stripes,
                                           wire_quant=wire_quant)
        return _unmoved(out, dim)
    out = x
    for a in gather_axes:
        out = mesh.all_gather(out, a, axis=dim, tiled=tiled)
    return out


@tacc.register("reduce_scatter", "flat", default=True,
               policy_fields=("backend", "n_stripes", "wire_quant"))
def flat_reduce_scatter(x, axes: Axis, pod_axis: str | None = None, *,
                        dim: int = 0, backend: str = "xla",
                        n_stripes: int = 1, wire_quant: str | None = None):
    all_axes = ((pod_axis,) if pod_axis else ()) + _axes_tuple(axes)
    if backend == "pallas":
        from repro_torch.kernels import ring_dma
        out = _moved(x, dim)
        for a in all_axes:
            out = ring_dma.ring_reduce_scatter(out, a, n_stripes=n_stripes,
                                               wire_quant=wire_quant)
        return _unmoved(out, dim)
    out = x
    for a in all_axes:
        out = mesh.psum_scatter(out, a, scatter_dimension=dim, tiled=True)
    return out


@tacc.register("all_to_all", "flat", default=True)
def flat_all_to_all(x, axes: Axis, pod_axis: str | None = None, *,
                    split_axis: int = 0, concat_axis: int = 0):
    all_axes = ((pod_axis,) if pod_axis else ()) + _axes_tuple(axes)
    return mesh.all_to_all(x, all_axes, split_axis=split_axis, concat_axis=concat_axis)


@tacc.register("broadcast", "flat", default=True)
def flat_broadcast(x, axes: Axis, pod_axis: str | None = None, *, root: int = 0):
    all_axes = _axes_tuple(axes) + ((pod_axis,) if pod_axis else ())
    # zero the non-root contributions, then sum
    mine = x if _flat_rank_index(all_axes) == root else torch.zeros_like(x)
    return mesh.psum(mine, all_axes)


@tacc.register("reduce", "flat", default=True)
def flat_reduce(x, axes: Axis, pod_axis: str | None = None, *, root: int = 0):
    all_axes = _axes_tuple(axes) + ((pod_axis,) if pod_axis else ())
    s = mesh.psum(x, all_axes)
    return s if _flat_rank_index(all_axes) == root else torch.zeros_like(s)


@tacc.register("p2p", "flat", default=True)
def p2p(x, axis: str, perm: Sequence[tuple[int, int]]):
    """Point-to-point send/recv (the RDMA verbs analogue)."""
    return mesh.ppermute(x, axis, list(perm))


# ---------------------------------------------------------------------------
# Hierarchical (HetCCL) collectives: local native stage + cross-pod ring.
# ---------------------------------------------------------------------------

def _flatten_pad(x, multiple: int):
    flat = x.reshape(-1)
    pad = (-flat.shape[0]) % multiple
    if pad:
        flat = F.pad(flat, (0, pad))
    return flat, pad


def _local_world(local: tuple[str, ...]) -> int:
    D = 1
    for a in local:
        D *= mesh.axis_size(a)
    return D


@tacc.register("all_reduce", "hier",
               policy_fields=("backend", "n_stripes", "cross_dtype",
                              "wire_quant"))
def hier_all_reduce(x, axes: Axis, pod_axis: str | None = "pod", *,
                    cross_dtype=None, backend: str = "xla",
                    n_stripes: int = 1, wire_quant: str | None = None):
    """AllReduce = local ReduceScatter -> cross-pod ring AllReduce -> local
    AllGather.  ``cross_dtype`` casts the payload only while it crosses the
    pod boundary; ``backend="pallas"`` keeps an f32 accumulator under it.  A
    ``wire_quant`` codec on the pallas rings supersedes ``cross_dtype`` (the
    codec owns the wire format)."""
    local = _axes_tuple(axes)
    if not pod_axis:
        return mesh.psum(x, local)
    cross_rs, cross_ag = resolve_ring_backend(backend, n_stripes=n_stripes,
                                              wire_quant=wire_quant)
    if wire_quant is not None and backend == "pallas":
        cross_dtype = None
    D = _local_world(local)
    P = mesh.axis_size(pod_axis)
    shape, dtype = x.shape, x.dtype
    flat, pad = _flatten_pad(x, D * P)
    n = flat.shape[0]
    shard = mesh.psum_scatter(flat.reshape(D, n // D), local,
                              scatter_dimension=0, tiled=False) if D > 1 else flat
    cross = cross_dtype is not None and cross_dtype != dtype
    if cross:
        shard = shard.to(cross_dtype)
    shard = cross_ag(cross_rs(shard, pod_axis), pod_axis)
    if cross:
        shard = shard.to(dtype)
    flat = mesh.all_gather(shard, local, axis=0, tiled=False).reshape(n) \
        if D > 1 else shard
    if pad:
        flat = flat[:n - pad]
    return flat.reshape(shape)


@tacc.register("all_gather", "hier",
               policy_fields=("backend", "n_stripes", "wire_quant"))
def hier_all_gather(x, axes: Axis, pod_axis: str | None = "pod", *, dim: int = 0,
                    tiled: bool = True, backend: str = "xla",
                    n_stripes: int = 1, wire_quant: str | None = None):
    """Local native gather, then cross-pod ring gather (pod-major order)."""
    out = flat_all_gather(x, axes, None, dim=dim, tiled=tiled)
    if pod_axis:
        _, cross_ag = resolve_ring_backend(backend, n_stripes=n_stripes,
                                           wire_quant=wire_quant)
        out = _unmoved(cross_ag(_moved(out, dim), pod_axis), dim)
    return out


@tacc.register("reduce_scatter", "hier",
               policy_fields=("backend", "n_stripes", "wire_quant"))
def hier_reduce_scatter(x, axes: Axis, pod_axis: str | None = "pod", *,
                        dim: int = 0, backend: str = "xla",
                        n_stripes: int = 1, wire_quant: str | None = None):
    """Cross-pod ring reduce-scatter first (P2P), then local native stage."""
    out = x
    if pod_axis:
        cross_rs, _ = resolve_ring_backend(backend, n_stripes=n_stripes,
                                           wire_quant=wire_quant)
        out = _unmoved(cross_rs(_moved(out, dim), pod_axis), dim)
    return flat_reduce_scatter(out, axes, None, dim=dim)


@tacc.register("all_to_all", "hier")
def hier_all_to_all(x, axes: Axis, pod_axis: str | None = "pod", *,
                    split_axis: int = 0, concat_axis: int = 0):
    """Two-stage A2A: cross-pod superblocks via the P2P ring, then the local
    native A2A.  Equals flat all_to_all over (pod, *axes) for dim 0."""
    if not pod_axis:
        return flat_all_to_all(x, axes, None, split_axis=split_axis,
                               concat_axis=concat_axis)
    if split_axis != 0 or concat_axis != 0:
        raise ValueError("hier all_to_all supports split_axis = concat_axis = 0")
    P = mesh.axis_size(pod_axis)
    D = _local_world(_axes_tuple(axes))
    n = x.shape[0]
    if n % (P * D):
        raise ValueError(f"dim 0 of {tuple(x.shape)} does not split over {P * D} ranks")
    rest = tuple(x.shape[1:])
    blk = x.reshape((P, D, n // (P * D)) + rest)
    blk = ring_all_to_all(blk, pod_axis)             # exchange pod superblocks
    blk = blk.reshape((P, n // P) + rest)
    out = mesh.all_to_all(blk, _axes_tuple(axes), split_axis=1, concat_axis=1)
    return out.reshape((n,) + rest)


@tacc.register("broadcast", "hier")
def hier_broadcast(x, axes: Axis, pod_axis: str | None = "pod", *, root: int = 0):
    out = flat_broadcast(x, axes, None, root=root)   # local stage from local root
    if pod_axis:
        out = ring_broadcast(out, pod_axis, root=0)
    return out


@tacc.register("reduce", "hier",
               policy_fields=("backend", "n_stripes", "wire_quant"))
def hier_reduce(x, axes: Axis, pod_axis: str | None = "pod", *, root: int = 0,
                backend: str = "xla", n_stripes: int = 1,
                wire_quant: str | None = None):
    s = hier_all_reduce(x, axes, pod_axis, backend=backend,
                        n_stripes=n_stripes, wire_quant=wire_quant)
    all_axes = _axes_tuple(axes) + ((pod_axis,) if pod_axis else ())
    return s if _flat_rank_index(all_axes) == root else torch.zeros_like(s)


# ---------------------------------------------------------------------------
# Pipelined (multi-channel) hierarchical collectives: the payload is split
# into ``n_channels`` chunks run on a skewed wavefront, so chunk k's
# cross-pod ring may overlap chunk k+1's local stage; the cross stage uses
# the bidirectional rings.
# ---------------------------------------------------------------------------

def software_pipeline(chunks: list, stages: Sequence) -> list:
    """Run every chunk through ``stages`` on a skewed wavefront schedule:
    wave t computes stage (t - k) of chunk k for every live chunk.

    The reference pins each wave with an ``optimization_barrier`` so XLA may
    overlap its stages; eager PyTorch runs them in this order, one after
    another (stream overlap is later work).  Semantically the identity.
    """
    C, S = len(chunks), len(stages)
    vals = list(chunks)
    for t in range(C + S - 1):
        for k in range(C):
            if 0 <= t - k < S:
                vals[k] = stages[t - k](vals[k])
    return vals


MAX_CHANNELS = 16    # schedule-unroll guard: each channel runs its own stages


def resolve_channels(nbytes: int, n_channels: int,
                     chunk_bytes: int | None, limit: int,
                     n_stripes: int = 1) -> int:
    """Channel count for a payload: an explicit chunk size wins, else
    ``n_channels``; clamped to [1, min(limit, MAX_CHANNELS)] and so that a
    ``channels x stripes`` fragment never drops below one tile
    (``MXU_TILE_BYTES``)."""
    c = -(-nbytes // chunk_bytes) if chunk_bytes else n_channels
    tile_limit = max(nbytes // (MXU_TILE_BYTES * max(int(n_stripes), 1)), 1)
    return max(1, min(c, limit, MAX_CHANNELS, tile_limit))


@tacc.register("all_reduce", "pipelined",
               policy_fields=("backend", "n_stripes", "cross_dtype",
                              "n_channels", "wire_quant"))
def pipelined_all_reduce(x, axes: Axis, pod_axis: str | None = "pod", *,
                         cross_dtype=None, n_channels: int = 4,
                         pipeline_chunk_bytes: int | None = None,
                         bidir: bool = True, backend: str = "xla",
                         n_stripes: int = 1, wire_quant: str | None = None):
    """AllReduce as a C-channel pipeline of (local RS -> cross ring -> local
    AG); equals :func:`hier_all_reduce`."""
    local = _axes_tuple(axes)
    if not pod_axis:
        return mesh.psum(x, local) if local else x
    D = _local_world(local)
    P = mesh.axis_size(pod_axis)
    shape, dtype = x.shape, x.dtype
    C = resolve_channels(x.numel() * x.element_size(), n_channels,
                         pipeline_chunk_bytes, max(x.numel() // (D * P), 1),
                         n_stripes)
    flat, pad = _flatten_pad(x, C * D * P)
    n = flat.shape[0]
    chunks = list(flat.chunk(C)) if C > 1 else [flat]
    cross_ring_rs, cross_ring_ag = resolve_ring_backend(
        backend, bidir=bidir, n_stripes=n_stripes, wire_quant=wire_quant)
    if wire_quant is not None and backend == "pallas":
        cross_dtype = None       # the codec owns the wire format
    cast = cross_dtype is not None and cross_dtype != dtype

    def local_rs(c):
        if D == 1:
            return c
        return mesh.psum_scatter(c.reshape(D, c.shape[0] // D), local,
                                 scatter_dimension=0, tiled=False)

    def cross(c):
        if cast:
            c = c.to(cross_dtype)
        c = cross_ring_ag(cross_ring_rs(c, pod_axis), pod_axis)
        return c.to(dtype) if cast else c

    def local_ag(c):
        if D == 1:
            return c
        return mesh.all_gather(c, local, axis=0, tiled=False).reshape(-1)

    outs = software_pipeline(chunks, (local_rs, cross, local_ag))
    flat = torch.cat(outs) if C > 1 else outs[0]
    if pad:
        flat = flat[:n - pad]
    return flat.reshape(shape)


@tacc.register("all_gather", "pipelined",
               policy_fields=("backend", "n_stripes", "n_channels",
                              "wire_quant"))
def pipelined_all_gather(x, axes: Axis, pod_axis: str | None = "pod", *,
                         dim: int = 0, tiled: bool = True,
                         n_channels: int = 4,
                         pipeline_chunk_bytes: int | None = None,
                         bidir: bool = True, backend: str = "xla",
                         n_stripes: int = 1, wire_quant: str | None = None):
    """Two-stage gather, pipelined: chunk k's cross-pod ring gather may
    overlap chunk k+1's local gather.  Pod-major result order."""
    if not pod_axis:
        return flat_all_gather(x, axes, None, dim=dim, tiled=tiled)
    if not tiled:
        # stacked layout: keep the serial hier schedule (same output)
        return hier_all_gather(x, axes, pod_axis, dim=dim, tiled=False)
    xm = _moved(x, dim)
    c0 = xm.shape[0]
    C = resolve_channels(x.numel() * x.element_size(), n_channels,
                         pipeline_chunk_bytes, c0, n_stripes)
    chunks = list(torch.tensor_split(xm, C)) if C > 1 else [xm]
    _, cross_ring_ag = resolve_ring_backend(backend, bidir=bidir,
                                            n_stripes=n_stripes,
                                            wire_quant=wire_quant)
    outs = software_pipeline(
        chunks, (lambda c: flat_all_gather(c, axes, None, dim=0, tiled=True),
                 lambda c: cross_ring_ag(c, pod_axis)))
    if C > 1:
        # chunk j holds [rank0 chunk-j, rank1 chunk-j, ...]: back to rank-major
        W = axis_world(_axes_tuple(axes)) * mesh.axis_size(pod_axis)
        rest = tuple(xm.shape[1:])
        parts = [o.reshape((W, o.shape[0] // W) + rest) for o in outs]
        out = torch.cat(parts, 1).reshape((W * c0,) + rest)
    else:
        out = outs[0]
    return _unmoved(out, dim)


@tacc.register("reduce_scatter", "pipelined",
               policy_fields=("backend", "n_stripes", "n_channels",
                              "wire_quant"))
def pipelined_reduce_scatter(x, axes: Axis, pod_axis: str | None = "pod", *,
                             dim: int = 0, n_channels: int = 4,
                             pipeline_chunk_bytes: int | None = None,
                             bidir: bool = True, backend: str = "xla",
                             n_stripes: int = 1,
                             wire_quant: str | None = None):
    """Two-stage reduce-scatter, pipelined: chunk k's local stage may overlap
    chunk k+1's cross-pod ring."""
    if not pod_axis:
        return flat_reduce_scatter(x, axes, None, dim=dim)
    xm = _moved(x, dim)
    W = axis_world(_axes_tuple(axes)) * mesh.axis_size(pod_axis)
    n = xm.shape[0]
    if n % W:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split over {W} ranks")
    s = n // W                                        # rows this rank keeps
    C = resolve_channels(x.numel() * x.element_size(), n_channels,
                         pipeline_chunk_bytes, s, n_stripes)
    rest = tuple(xm.shape[1:])
    # chunk j carries rows [r*s + j*s/C, ...) of every rank r: split the
    # per-rank dim, not the raw leading dim
    grouped = xm.reshape((W, s) + rest)
    chunks = [c.reshape((W * c.shape[1],) + rest)
              for c in torch.tensor_split(grouped, C, 1)] if C > 1 else [xm]
    cross_ring_rs, _ = resolve_ring_backend(backend, bidir=bidir,
                                            n_stripes=n_stripes,
                                            wire_quant=wire_quant)
    outs = software_pipeline(
        chunks, (lambda c: cross_ring_rs(c, pod_axis),
                 lambda c: flat_reduce_scatter(c, axes, None, dim=0)))
    out = torch.cat(outs) if C > 1 else outs[0]
    return _unmoved(out, dim)


# ---------------------------------------------------------------------------
# Differentiable wrapper (used inside the model's forward: ZeRO-3).
# ---------------------------------------------------------------------------

class FsdpScope:
    """One rank's ZeRO-3 parameter gathers for one training step, and the
    gradients their adjoint owes.

    The reference's ``fsdp_all_gather`` is a custom VJP whose adjoint
    reduce-scatters inside the backward.  Here autograd runs the CUDA part of
    every rank's backward on its one device thread, outside any mesh rank:
    on a ``ThreadMesh`` a collective started there would wait for peers
    whose backward is queued behind it on that thread.  So the adjoint is
    split in two (DESIGN_TORCH.md §16): the Function's backward hands the
    full gradient to this scope (:meth:`pending`), and the rank's own thread
    calls :meth:`reduce_pending` after the micro-step's backward, which
    reduce-scatters each handed gradient through :func:`fsdp_reduce_scatter`
    in one order on every rank.  The sum over micro-steps of those
    reduce-scatters is the reference's gradient.

    The forward gathers may run on autograd's thread too: under ``remat`` a
    block's gathers sit inside its checkpoint and run again in the backward.
    On a ``ThreadMesh`` the scope therefore takes references to the group's
    shard leaves once, on the rank's thread (``ThreadMesh.share``), and a
    gather concatenates them without waiting for anyone; the ranks update
    their parameters into new tensors, so the shards stay as they were for
    the whole step.  On a ``DistMesh`` (one process, one autograd thread per
    rank) a gather is the mesh's all-gather.

    ``shards``: the rank's parameter leaves as the model reads them (their
    identity keys the gathers); ``comm``: the communicator whose
    ``reduce_scatter`` policy the adjoint takes.
    """

    def __init__(self, shards, axis: str = "data", comm=None):
        self.mesh, self.rank = mesh.current()
        self.axis, self.comm = axis, comm
        self._index = {id(t): j for j, t in enumerate(shards)}
        self._peers = None
        if isinstance(self.mesh, mesh.ThreadMesh):
            self._peers = self.mesh.share(self.rank, [t.detach() for t in shards], axis)
        self._pending: list = []

    def gather(self, leaf, dim: int, layer: int | None = None):
        """``fsdp_all_gather`` of ``leaf`` (or of its slice ``leaf[layer]``,
        a layer of a stacked leaf) along ``dim`` of what is gathered."""
        x = leaf if layer is None else leaf[layer]
        return fsdp_all_gather(x, self.axis, dim, self, (self._index[id(leaf)], layer))

    def _all_gather(self, x, key, dim: int):
        if self._peers is None:
            return self.mesh.all_gather(self.rank, x, self.axis, dim, True)
        j, layer = key
        parts = [p[j] if layer is None else p[j][layer] for p in self._peers]
        return torch.cat(parts, dim)

    def pending(self, key, dim: int, g) -> None:
        """The adjoint's first half (autograd's thread): keep the full
        gradient ``g`` of the gather ``key`` for :meth:`reduce_pending`."""
        self._pending.append((key, dim, g))          # list.append: thread-safe

    def reduce_pending(self) -> list:
        """The adjoint's second half, on the rank's thread: every kept
        gradient reduce-scattered over the axis (sorted by key, so every
        rank issues the same collectives in the same order), as
        ``[((leaf index, layer), shard gradient in g's dtype)]``; the kept
        gradients are dropped."""
        todo = sorted(self._pending, key=lambda e: (e[0][0], -1 if e[0][1] is None else e[0][1]))
        self._pending = []
        return [(key, fsdp_reduce_scatter(g, self.axis, dim, self.comm))
                for key, dim, g in todo]


class _FsdpAllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim, scope, key):
        ctx.dim, ctx.scope, ctx.key = dim, scope, key
        return scope._all_gather(x, key, dim)

    @staticmethod
    def backward(ctx, g):
        ctx.scope.pending(ctx.key, ctx.dim, g)
        return None, None, None, None, None


def fsdp_all_gather(x, axis: str, dim: int, scope: FsdpScope, key):
    """AllGather whose adjoint is ReduceScatter: ZeRO-3's parameter gather.

    Forward: the tiled all-gather of ``x`` over ``axis`` along ``dim`` (the
    reference's ``lax.all_gather(..., tiled=True)``).  Adjoint: the
    reduce-scatter of the incoming gradient over ``axis``, which ``scope``
    runs on the rank's thread (:class:`FsdpScope`); autograd gets no
    gradient for ``x`` from here, so the caller differentiates with
    ``allow_unused=True`` and takes the shard gradients from
    ``scope.reduce_pending()``.  ``key`` names the gather in the scope."""
    return _FsdpAllGather.apply(x, axis, dim, scope, key)


def fsdp_reduce_scatter(g, axis: str, dim: int = 0, comm=None):
    """The adjoint of :func:`fsdp_all_gather`: ``g`` reduce-scattered over
    ``axis`` along ``dim``, in ``g``'s dtype.  Routed through ``comm``'s
    (default: the installed communicator's) ``reduce_scatter`` policy for
    this payload, as in the reference: under ``backend="pallas"`` the ring
    of ``kernels.ring_dma`` with the narrow wire (g's dtype), the policy's
    stripes and wire codec, its accumulator f32; otherwise
    :func:`ring_reduce_scatter_mixed` (f32 accumulation).  Per-rank code."""
    if comm is None:
        from repro_torch.core import hetccl    # hetccl imports this module
        comm = hetccl.current()
    gm = g.movedim(dim, 0) if dim else g
    pol = comm.policy("reduce_scatter", g.numel() * g.element_size())
    if pol.backend == "pallas":
        from repro_torch.kernels import ring_dma
        out = ring_dma.ring_reduce_scatter(gm, axis, wire_dtype=g.dtype,
                                           n_stripes=pol.n_stripes,
                                           wire_quant=pol.wire_quant)
    else:
        out = ring_reduce_scatter_mixed(gm, axis)
    out = out.movedim(0, dim) if dim else out
    return out.to(g.dtype)
