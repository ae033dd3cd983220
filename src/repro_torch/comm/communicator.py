"""Communicators: a per-group object owning the policy table (DESIGN.md §12).

Counterpart of ``repro/comm/communicator.py:37-225``.  A
:class:`Communicator` holds the group identity (``local_axes``, ``pod_axis``,
pod-major like everything else, DESIGN.md §3) and a **resolved**
:class:`~repro_torch.comm.policy.PolicyTable` mapping ``(op, size_class) ->
CommPolicy``, and the transport binding: the link inventory is bound **at
creation**, not per call, so a communicator on a degraded island stripes
over the links that island has (DESIGN.md §11).

The ``tracer`` field pins an ``obs.Tracer`` to the communicator's
dispatches.  Not ported yet: ``deadline_table``, which comes with the
watchdog in the elastic slice (ROADMAP A10b).
"""
from __future__ import annotations

import dataclasses
from typing import Any

from repro_torch.comm.policy import (CommPolicy, DEFAULT_SIZE_CLASS_BOUNDS,
                                     PolicyTable, RING_BACKED_OPS)
from repro_torch.core import tacc
from repro_torch.transport.stripe import MAX_STRIPES

DEFAULT_BUCKET_BYTES = 64 * 1024 * 1024


def variant_for(op: str, mode: str) -> str:
    """Per-op TACC variant with graceful degradation: ops without a
    ``pipelined`` registration fall back to ``hier``, and ops without that
    to ``flat``."""
    avail = tacc.variants(op)
    if mode in avail:
        return mode
    if mode == "pipelined" and "hier" in avail:
        return "hier"
    return "flat"


def _resolve_policy(p: CommPolicy, pod_axis: str | None,
                    stripe_cap: int, op: str | None = None) -> CommPolicy:
    """Compile one table row: "auto" mode against the group's pod axis,
    stripes collapsed for xla (one ppermute is one logical transfer) and
    clamped to ``stripe_cap``, ``wire_quant`` collapsed to None for the xla
    backend and non-ring ops (only the pallas rings carry a quantized
    payload; ``op`` None means the row applies to every op and keeps the
    codec)."""
    mode = p.mode
    if mode == "auto":
        mode = "hier" if pod_axis else "flat"
    stripes = 1 if p.backend != "pallas" else \
        max(min(int(p.n_stripes), stripe_cap), 1)
    wire_quant = p.wire_quant
    if p.backend != "pallas" or (op is not None and op not in RING_BACKED_OPS):
        wire_quant = None
    return CommPolicy(mode=mode, backend=p.backend,
                      n_channels=max(int(p.n_channels), 1),
                      n_stripes=stripes, cross_dtype=p.cross_dtype,
                      wire_quant=wire_quant)


@dataclasses.dataclass(frozen=True, eq=False)
class Communicator:
    """A per-group collective context: axes + resolved policy table.

    Accepted everywhere an ``HetCCLConfig`` is (the ``cfg`` argument of
    every ``hetccl`` op, ``hetccl.install``/``use``); ``dataclasses.replace``
    works on it, e.g. ZeRO-3's pod-only projection ``replace(c,
    local_axes=())``, which keeps the table and the inventory.  Compares
    equal to a legacy ``HetCCLConfig`` whose facade compile gives the same
    table.
    """

    local_axes: tuple[str, ...] = ("data",)
    pod_axis: str | None = "pod"
    table: PolicyTable = PolicyTable()
    bucket_bytes: int = DEFAULT_BUCKET_BYTES
    pipeline_chunk_bytes: int | None = None
    # transport binding (DESIGN.md §11); identity only: health is mutable
    # state, not part of the communicator's value
    inventory: Any = dataclasses.field(default=None, compare=False, repr=False)
    # telemetry binding (DESIGN.md §16): a pinned repro_torch.obs.Tracer
    # records this group's dispatches, taking precedence over the installed
    # process tracer; like the inventory, an observer, not identity
    tracer: Any = dataclasses.field(default=None, compare=False, repr=False)

    def _value(self):
        return (self.local_axes, self.pod_axis, self.table,
                self.bucket_bytes, self.pipeline_chunk_bytes)

    def __eq__(self, other):
        if isinstance(other, Communicator):
            return self._value() == other._value()
        if hasattr(other, "to_policy"):            # legacy config facade
            return self._value() == from_config(other)._value()
        return NotImplemented

    def __hash__(self):
        return hash(self._value())

    def dp_axes(self) -> tuple[str, ...]:
        """Pod-major DP axes (rank = pod·D + data, DESIGN.md §3)."""
        return ((self.pod_axis,) if self.pod_axis else ()) + self.local_axes

    def policy(self, op: str, nbytes: float) -> CommPolicy:
        """The resolved policy for one concrete payload of ``op``."""
        return self.table.resolve(op, nbytes)

    def class_policy(self, op: str, cls: str) -> CommPolicy:
        """The resolved policy for a named size class of ``op``."""
        return self.table.lookup(op, cls)

    def variant_for(self, op: str, policy: CommPolicy | None = None) -> str:
        """TACC variant ``op`` dispatches to under ``policy``."""
        policy = policy or self.table.default
        return variant_for(op, policy.mode)

    def default_variant(self, op: str) -> str:
        """Registry default installed for raw ``tacc.dispatch`` callers: the
        op's large-class policy."""
        return self.variant_for(op, self.class_policy(op, "large"))

    def resolved_mode(self) -> str:
        """The mode of the large-class all_reduce policy."""
        return self.class_policy("all_reduce", "large").mode


def create(local_axes: tuple[str, ...] = ("data",),
           pod_axis: str | None = "pod", *,
           table: PolicyTable | None = None,
           policies=None, default: CommPolicy | None = None,
           bounds: tuple[int, int] = DEFAULT_SIZE_CLASS_BOUNDS,
           bucket_bytes: int = DEFAULT_BUCKET_BYTES,
           pipeline_chunk_bytes: int | None = None,
           topology_slice=None, link_inventory=None) -> Communicator:
    """Create a communicator for one group (the ``ncclCommInitRank``
    analogue, DESIGN.md §12).

    Args:
        local_axes: intra-island mesh axes carrying data parallelism.
        pod_axis: the island-boundary axis (None on single-island meshes).
        table: a prebuilt :class:`PolicyTable`; or build one from
        policies: ``{(op, size_class) | op: CommPolicy}`` rows, with
        default: the fallback policy (flat/xla when omitted).
        bounds: size-class boundaries of a table built here.
        bucket_bytes: gradient fusion bucket size.
        pipeline_chunk_bytes: alternative channel sizing for pipelined rows.
        topology_slice: optional ``core.topology.ClusterSpec`` this group
            runs on; binds the slowest island's link inventory (the
            endpoint that bounds every cross-island pair, paper §5.2).
        link_inventory: an explicit ``transport.LinkInventory`` to bind
            instead.  Stripes are clamped to its *healthy* links here, at
            creation, not per call (DESIGN.md §11).
    Returns:
        A :class:`Communicator` with every table row resolved.
    """
    if table is None:
        table = PolicyTable.of(policies or {}, default=default, bounds=bounds)
    elif policies is not None or default is not None:
        raise ValueError("pass either table= or policies=/default=, not both")
    if link_inventory is None and topology_slice is not None:
        pods = list(getattr(topology_slice, "pods", ()) or ())
        if pods:
            slow = min(pods, key=lambda p: topology_slice.effective_link_bw(p))
            link_inventory = topology_slice.inventory(slow)
    cap = MAX_STRIPES
    if link_inventory is not None:
        cap = min(cap, max(len(link_inventory.healthy_links()), 1))
    resolved = PolicyTable(
        rows=tuple((k, _resolve_policy(p, pod_axis, cap, op=k[0]))
                   for k, p in table.rows),
        default=_resolve_policy(table.default, pod_axis, cap),
        bounds=table.bounds)
    return Communicator(local_axes=tuple(local_axes), pod_axis=pod_axis,
                        table=resolved, bucket_bytes=int(bucket_bytes),
                        pipeline_chunk_bytes=pipeline_chunk_bytes,
                        inventory=link_inventory)


def from_config(cfg) -> Communicator:
    """Compile a legacy single-policy ``HetCCLConfig`` into a communicator
    with a one-row table (the facade contract, DESIGN.md §12)."""
    return create(tuple(cfg.local_axes), cfg.pod_axis,
                  table=PolicyTable.single(cfg.to_policy()),
                  bucket_bytes=cfg.bucket_bytes,
                  pipeline_chunk_bytes=cfg.pipeline_chunk_bytes)


def check_runnable(table: PolicyTable) -> PolicyTable:
    """Raise ``ValueError``, naming the row, for any row of ``table`` that
    the port cannot run as written, instead of letting it degrade quietly:
    a stripe count above ``MAX_STRIPES`` (the most the ring kernels take), a
    mode the row's op has no TACC registration for, or a ``pallas`` row on
    an op whose implementation does not take the backend.  The planner's
    tables pass (their candidates are pruned the same way); the trainer
    checks ``RunConfig.policies`` with it before creating its communicator.
    Returns ``table``."""
    from repro_torch.core import hetccl    # registers the collectives
    ops = hetccl._SWAPPABLE_OPS
    for (op, cls), p in table.rows:
        where = f"policy row ({op!r}, {cls!r}) = {p}"
        if int(p.n_stripes) > MAX_STRIPES:
            raise ValueError(f"{where}: {p.n_stripes} stripes, the ring kernels take at "
                             f"most {MAX_STRIPES}")
        if p.mode == "auto":
            continue
        for o in (ops if op == "*" else (op,)):
            if p.mode not in tacc.variants(o):
                raise ValueError(f"{where}: {o} has no {p.mode!r} implementation "
                                 f"(registered: {tacc.variants(o)})")
            if p.backend == "pallas" and "backend" not in tacc.policy_fields(o, p.mode):
                raise ValueError(f"{where}: {o}/{p.mode} does not take a backend, so a "
                                 "pallas row would run as xla")
    if int(table.default.n_stripes) > MAX_STRIPES:
        raise ValueError(f"default policy {table.default}: {table.default.n_stripes} "
                         f"stripes, the ring kernels take at most {MAX_STRIPES}")
    return table
