"""HetCCL public API: the drop-in collective layer (paper §4, Fig 2b).

Counterpart of ``repro/core/hetccl.py:42-510``.  Applications call these
functions inside a mesh (``core.mesh``); dispatch is communicator-scoped
(DESIGN.md §12): the active :class:`repro_torch.comm.Communicator` resolves
each call's payload to a ``CommPolicy`` from its per-op, size-classed
``PolicyTable``, and TACC routes to the *flat*, *hier* or *pipelined*
implementation at run time.  :func:`install` swaps the backend under an
unmodified application (the paper's LD_PRELOAD trick); :func:`uninstall`
and :func:`use` restore it.  :class:`HetCCLConfig` is the single-policy
facade, compiled into a one-row table.

:func:`tree_all_reduce` is the bucketed gradient all-reduce (leaves
flattened into fixed-size fusion buckets, each reduced as reduce-scatter
then all-gather on a wavefront across buckets).

An installed (or communicator-pinned) ``obs.Tracer`` records every
dispatch as a span (:func:`install_tracer`, the reference's
``hetccl.py:307-350``).  Not ported yet: the collective watchdog
(``arm_watchdog``), which comes with the elastic slice (ROADMAP A10b).
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import threading
from typing import Any, Sequence

import torch

from repro_torch.comm.communicator import Communicator, from_config
from repro_torch.comm.policy import CommPolicy, PolicyTable, size_class
from repro_torch.core import collectives as _coll
from repro_torch.core import mesh as _mesh
from repro_torch.core import tacc
from repro_torch.core.tree import flatten as _flatten
from repro_torch.transport.stripe import MAX_STRIPES

_SWAPPABLE_OPS = ("all_reduce", "all_gather", "reduce_scatter", "all_to_all",
                  "broadcast", "reduce")


@dataclasses.dataclass(frozen=True)
class HetCCLConfig:
    """Runtime configuration of the collective layer.

    mode:        "flat" | "hier" | "pipelined" | "auto" ("hier" iff a pod
                 axis is present).
    local_axes:  intra-island mesh axes carrying data parallelism.
    pod_axis:    the island boundary axis (None on single-island meshes).
    bucket_bytes: gradient fusion bucket size.
    cross_dtype: optional dtype of the cross-island stage (compression on
                 the slow links).
    n_channels:  pipeline channel count of the "pipelined" mode.
    pipeline_chunk_bytes: alternative channel sizing (bytes per chunk).
    backend:     "xla" | "pallas" ring implementation (orthogonal to mode):
                 "pallas" takes the rings of ``repro_torch.kernels.ring_dma``
                 (fused CUDA kernels on a ThreadMesh on the card, their
                 emulated schedule elsewhere).
    n_stripes:   per-link stripes of the pallas rings (collapsed to 1 for
                 xla).
    wire_quant:  the per-chunk wire codec of the pallas rings (None | "int8"
                 | "fp8", DESIGN.md §17); collapsed to None for xla.
    """

    mode: str = "auto"
    local_axes: tuple[str, ...] = ("data",)
    pod_axis: str | None = "pod"
    bucket_bytes: int = 64 * 1024 * 1024
    cross_dtype: Any = None
    n_channels: int = 4
    pipeline_chunk_bytes: int | None = None
    backend: str = "xla"
    n_stripes: int = 1
    wire_quant: str | None = None

    def resolved_mode(self) -> str:
        if self.mode == "auto":
            return "hier" if self.pod_axis else "flat"
        if self.mode not in ("flat", "hier", "pipelined"):
            raise ValueError(
                f"unknown collective mode {self.mode!r}; "
                "expected flat | hier | pipelined | auto")
        return self.mode

    def resolved_backend(self) -> str:
        if self.backend not in _coll.RING_BACKENDS:
            raise ValueError(
                f"unknown collective backend {self.backend!r}; "
                f"expected one of {_coll.RING_BACKENDS}")
        return self.backend

    def resolved_stripes(self) -> int:
        """Effective stripe count: validated, capped, 1 for xla."""
        if int(self.n_stripes) < 1:
            raise ValueError(f"n_stripes must be >= 1, got {self.n_stripes}")
        if self.resolved_backend() != "pallas":
            return 1
        return min(int(self.n_stripes), MAX_STRIPES)

    def dp_axes(self) -> tuple[str, ...]:
        """Pod-major: the gather order of flat and hier all_gather."""
        return ((self.pod_axis,) if self.pod_axis else ()) + self.local_axes

    def to_policy(self) -> CommPolicy:
        return CommPolicy(mode=self.resolved_mode(),
                          backend=self.resolved_backend(),
                          n_channels=max(int(self.n_channels), 1),
                          n_stripes=self.resolved_stripes(),
                          cross_dtype=self.cross_dtype,
                          wire_quant=(self.wire_quant
                                      if self.resolved_backend() == "pallas"
                                      else None))

    def to_table(self) -> PolicyTable:
        """A single-policy config is a one-row policy table."""
        return PolicyTable.single(self.to_policy())

    def communicator(self) -> Communicator:
        return from_config(self)


_CURRENT = from_config(HetCCLConfig(pod_axis=None))
# (previous communicator, TACC defaults before each install), LIFO
_INSTALL_STACK: list[tuple[Communicator, dict[str, str]]] = []


def _as_communicator(cfg) -> Communicator:
    """None -> the active communicator; HetCCLConfig -> its facade compile;
    Communicator -> as is."""
    if cfg is None:
        return _CURRENT
    if isinstance(cfg, Communicator):
        return cfg
    return from_config(cfg)


def install(config: "HetCCLConfig | Communicator") -> Communicator:
    """Swap the active collective backend (the LD_PRELOAD analogue); returns
    the communicator it displaced.  Installing exactly the communicator the
    latest install displaced undoes that install."""
    return _install(config, allow_undo=True)


def _install(config, *, allow_undo: bool) -> Communicator:
    global _CURRENT
    c = _as_communicator(config)      # validates before mutating any state
    prev = _CURRENT
    if allow_undo and _INSTALL_STACK and c == _INSTALL_STACK[-1][0]:
        uninstall()
        return prev
    prev_defaults = {op: tacc.get_default(op) for op in _SWAPPABLE_OPS}
    _INSTALL_STACK.append((prev, prev_defaults))
    _CURRENT = c
    for op in _SWAPPABLE_OPS:
        tacc.set_default(op, c.default_variant(op))
    return prev


def uninstall() -> Communicator:
    """Undo the most recent :func:`install` (communicator and TACC
    defaults); a no-op returning the current one when nothing is installed."""
    global _CURRENT
    if not _INSTALL_STACK:
        return _CURRENT
    prev, prev_defaults = _INSTALL_STACK.pop()
    _CURRENT = prev
    for op, variant in prev_defaults.items():
        tacc.set_default(op, variant)
    return prev


@contextlib.contextmanager
def use(config: "HetCCLConfig | Communicator"):
    """``with hetccl.use(cfg): ...`` installs ``cfg`` and restores the
    previous backend on exit, even on an exception."""
    _install(config, allow_undo=False)
    try:
        yield config
    finally:
        uninstall()


def current() -> Communicator:
    """The active communicator (flat, no pod axis, when nothing is
    installed)."""
    return _CURRENT


def _payload_bytes(op: str, x, c: Communicator) -> int:
    """The logical payload the policy table keys on: for all_gather the
    gathered buffer, for the others the input."""
    nbytes = x.numel() * x.element_size()
    if op == "all_gather" and c.table.rows:
        nbytes *= _coll.axis_world(c.dp_axes())
    return nbytes


# Calls per collective row, ``(op, size class, variant, CommPolicy) ->
# calls`` summed over ranks: each rank's call counts once.  The card checks
# hold it to the rows a training step must reach; ``reset_dispatches``
# zeroes it.
_dispatch_lock = threading.Lock()
dispatches: collections.Counter = collections.Counter()


def reset_dispatches() -> None:
    with _dispatch_lock:
        dispatches.clear()


# Telemetry hook (DESIGN.md §16): an installed repro_torch.obs.Tracer records
# every dispatch as a policy-tagged span; install/uninstall are stack-safe,
# like the communicator's.
_TRACER = None
_TRACER_STACK: list = []


def install_tracer(tracer) -> None:
    """Make ``tracer`` the process dispatch-span recorder.  Stack-safe:
    :func:`uninstall_tracer` restores whatever was installed before."""
    global _TRACER
    _TRACER_STACK.append(_TRACER)
    _TRACER = tracer


def uninstall_tracer() -> None:
    global _TRACER
    _TRACER = _TRACER_STACK.pop() if _TRACER_STACK else None


def current_tracer():
    """The tracer observing dispatches, if any (communicator-pinned tracers
    take precedence inside :func:`_call` itself)."""
    return _TRACER


def _call(op: str, x, cfg, **kw):
    """Resolve this payload's policy from the communicator's table, then let
    tacc.dispatch map exactly the fields the resolved variant declared.  The
    call counts in :data:`dispatches` under its row, which is this thread's
    current row (``tacc.in_row``) while it runs; a tracer (pinned to the
    communicator, else the installed one) records it as a span of that row,
    so the spans grouped by row equal :data:`dispatches`."""
    c = _as_communicator(cfg)
    nbytes = _payload_bytes(op, x, c)
    pol = c.policy(op, nbytes)
    variant = c.variant_for(op, pol)
    if variant == "pipelined" and c.pipeline_chunk_bytes:
        kw.setdefault("pipeline_chunk_bytes", c.pipeline_chunk_bytes)
    row = (op, size_class(nbytes, c.table.bounds), variant, pol)
    with _dispatch_lock:
        dispatches[row] += 1
    tr = c.tracer if c.tracer is not None else _TRACER
    if tr is None or not tr.enabled:
        with tacc.in_row(row):
            return tacc.dispatch(op, x, c.local_axes, c.pod_axis,
                                 variant=variant, policy=pol, **kw)
    with tr.collective(op, nbytes, pol, size_class=row[1], row=row), tacc.in_row(row):
        return tacc.dispatch(op, x, c.local_axes, c.pod_axis,
                             variant=variant, policy=pol, **kw)


def all_reduce(x, cfg=None, **kw):
    """Sum ``x`` across the DP world (pod-major flat group); identical on
    every DP rank.  ``cfg``: communicator or HetCCLConfig override."""
    return _call("all_reduce", x, cfg, **kw)


def all_gather(x, cfg=None, **kw):
    """Concatenate every DP rank's ``x`` along ``dim`` (default 0),
    pod-major."""
    return _call("all_gather", x, cfg, **kw)


def reduce_scatter(x, cfg=None, **kw):
    """Sum across the DP world, keep this rank's 1/world shard of ``dim``."""
    return _call("reduce_scatter", x, cfg, **kw)


def all_to_all(x, cfg=None, **kw):
    """Split ``split_axis`` world-ways; rank j keeps chunk j of every rank,
    concatenated on ``concat_axis``."""
    return _call("all_to_all", x, cfg, **kw)


def broadcast(x, cfg=None, **kw):
    """Every rank receives root's ``x`` (``root``, default 0)."""
    return _call("broadcast", x, cfg, **kw)


def reduce(x, cfg=None, **kw):
    """Sum across the DP world; only ``root`` keeps it, the others get
    zeros."""
    return _call("reduce", x, cfg, **kw)


def p2p(x, axis: str, perm: Sequence[tuple[int, int]]):
    """Raw point-to-point permute over ``axis``; ranks not named as a
    destination receive zeros."""
    return tacc.dispatch("p2p", x, axis, perm)


def world_size(cfg=None) -> int:
    """Total DP ranks of ``cfg``'s axes in the active mesh."""
    return _coll.axis_world(_as_communicator(cfg).dp_axes())


# ---------------------------------------------------------------------------
# Bucketed gradient reduction (DDP-style fusion).
# ---------------------------------------------------------------------------

def _dtype_name(t) -> str:
    return str(t.dtype).removeprefix("torch.")


def _make_buckets(leaves, bucket_bytes: int) -> list[list[int]]:
    """Group leaf indices into ~bucket_bytes fusion buckets of equal dtype."""
    order = sorted(range(len(leaves)), key=lambda i: _dtype_name(leaves[i]))
    buckets: list[list[int]] = []
    cur: list[int] = []
    cur_bytes = 0
    cur_dtype = None
    for i in order:
        lf = leaves[i]
        nbytes = lf.numel() * lf.element_size()
        if cur and (lf.dtype != cur_dtype or cur_bytes + nbytes > bucket_bytes):
            buckets.append(cur)
            cur, cur_bytes = [], 0
        cur.append(i)
        cur_dtype = lf.dtype
        cur_bytes += nbytes
    if cur:
        buckets.append(cur)
    return buckets


def bucket_zeros(like, cfg=None, *, dtype=None):
    """Zero leaves of the shapes of ``like`` (a list of tensors), in
    ``dtype`` or each in its own, laid out as :func:`tree_all_reduce`
    buckets them (DDP's gradient buckets): the leaves of a bucket are
    consecutive views of one flat buffer that also holds the bucket's pad to
    a multiple of the world size.  ``tree_all_reduce`` reduces such a bucket
    in its buffer, without a ``torch.cat``, and returns these same leaves: a
    tree of them is donated to it (the trainer's gradient sums).  Per-rank
    code (the world size sets the pad)."""
    c = _as_communicator(cfg)
    metas = [torch.empty(t.shape, dtype=dtype or t.dtype, device="meta") for t in like]
    world = max(world_size(c), 1)
    out = [None] * len(like)
    for bucket in _make_buckets(metas, c.bucket_bytes):
        n = sum(metas[i].numel() for i in bucket)
        buf = torch.zeros(n + (-n) % world, dtype=metas[bucket[0]].dtype,
                          device=like[bucket[0]].device)
        buf._hetccl_bucket = True
        off = 0
        for i in bucket:
            out[i] = buf[off:off + metas[i].numel()].view(metas[i].shape)
            off += metas[i].numel()
    return out


def _bucket_buffer(leaves, bucket, world: int):
    """The buffer of a :func:`bucket_zeros` bucket whose leaves are exactly
    ``bucket``'s, in order and padded for ``world`` ranks, or None."""
    base = leaves[bucket[0]]._base
    if base is None or not getattr(base, "_hetccl_bucket", False):
        return None
    off = 0
    for i in bucket:
        lf = leaves[i]
        if (lf._base is not base or not lf.is_contiguous()
                or lf.storage_offset() - base.storage_offset() != off):
            return None
        off += lf.numel()
    return base if base.numel() == off + (-off) % world else None


def tree_all_reduce(tree, cfg=None, *, mean_by=None):
    """All-reduce every leaf of ``tree``, fused into ~bucket_bytes buckets.

    Leaves are grouped by dtype into buckets, and each bucket's all-reduce is
    decomposed into reduce-scatter -> all-gather on a wavefront across
    buckets (bucket i's all-gather next to bucket i+1's reduce-scatter).
    With a ``cross_dtype`` policy each bucket takes the fused all_reduce
    instead (cross-stage compression only exists there).  ``mean_by``:
    optional scalar every floating leaf is divided by after the reduction.

    Leaves are new tensors, except for a bucket made by
    :func:`bucket_zeros`: it is reduced in its own buffer, each bucket's
    result written back before the next bucket's is gathered (on the
    all_reduce path, once every rank has issued its reads of every bucket),
    and its leaves are returned themselves (the same values, bit for bit;
    DESIGN_TORCH.md §19).
    """
    c = _as_communicator(cfg)
    leaves, rebuild = _flatten(tree)
    buckets = _make_buckets(leaves, c.bucket_bytes)
    world = world_size(c)

    flats, pads, donated = [], [], []
    for bucket in buckets:
        buf = _bucket_buffer(leaves, bucket, max(world, 1))
        if buf is not None:
            n = sum(leaves[i].numel() for i in bucket)
            flats.append(buf)
            pads.append(buf.numel() - n)
            donated.append(True)
            continue
        flat = torch.cat([leaves[i].reshape(-1) for i in bucket]) \
            if len(bucket) > 1 else leaves[bucket[0]].reshape(-1)
        pad = (-flat.shape[0]) % max(world, 1)
        if pad:
            flat = torch.nn.functional.pad(flat, (0, pad))
        flats.append(flat)
        pads.append(pad)
        donated.append(False)

    def written_back(k, red):
        """Bucket k's reduced values into its donated buffer (the pad keeps
        its zeros); the buffer stands for them from here on."""
        if not donated[k]:
            return red
        n = red.shape[0] - pads[k]
        flats[k][:n].copy_(red[:n])
        return flats[k]

    big = max((f.numel() * f.element_size() for f in flats), default=0)
    indexed = list(enumerate(flats))
    if world > 1 and c.policy("all_reduce", big).cross_dtype is None:
        reduced = _coll.software_pipeline(
            indexed,
            (lambda kf: (kf[0], reduce_scatter(kf[1], c, dim=0)),
             lambda ks: written_back(ks[0], all_gather(ks[1], c, dim=0))))
    elif world > 1:
        reduced = _coll.software_pipeline(indexed, (lambda kf: all_reduce(kf[1], c),))
        if any(donated):
            # a flat all_reduce reads the peers' buckets by reference
            # (ThreadMesh.psum): no rank writes its bucket back before every
            # rank has issued its reads
            _mesh.barrier()
            reduced = [written_back(k, red) for k, red in enumerate(reduced)]
    else:
        reduced = flats

    out = list(leaves)
    for bucket, red, pad, own in zip(buckets, reduced, pads, donated):
        if own:
            continue
        if pad:
            red = red[:red.shape[0] - pad]
        off = 0
        for i in bucket:
            sz = leaves[i].numel()
            out[i] = red[off:off + sz].reshape(leaves[i].shape)
            off += sz
    if mean_by is not None:
        own = {i for bucket, d in zip(buckets, donated) if d for i in bucket}
        for i, o in enumerate(out):
            if o.is_floating_point():
                div = torch.as_tensor(mean_by, dtype=o.dtype, device=o.device)
                out[i] = o.div_(div) if i in own else o / div
    return rebuild(out)
