"""Communicators: a per-group object owning the policy table (DESIGN.md §12).

Counterpart of ``repro/comm/communicator.py:37-225``.  A
:class:`Communicator` holds the group identity (``local_axes``, ``pod_axis``,
pod-major like everything else, DESIGN.md §3) and a **resolved**
:class:`~repro_torch.comm.policy.PolicyTable` mapping ``(op, size_class) ->
CommPolicy``.

Not ported yet: the transport binding (a link inventory that clamps stripes
to an island's healthy links; one card has no links), the tracer binding
(ROADMAP A10) and ``deadline_table`` (the elastic slice).
"""
from __future__ import annotations

import dataclasses

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
    every ``hetccl`` op, ``hetccl.install``/``use``).  Compares equal to a
    legacy ``HetCCLConfig`` whose facade compile gives the same table.
    """

    local_axes: tuple[str, ...] = ("data",)
    pod_axis: str | None = "pod"
    table: PolicyTable = PolicyTable()
    bucket_bytes: int = DEFAULT_BUCKET_BYTES
    pipeline_chunk_bytes: int | None = None

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
           pipeline_chunk_bytes: int | None = None) -> Communicator:
    """Create a communicator for one group (the ``ncclCommInitRank``
    analogue, DESIGN.md §12): ``table``, or ``policies`` rows
    ``{(op, size_class) | op: CommPolicy}`` with a ``default``; every row
    is resolved here."""
    if table is None:
        table = PolicyTable.of(policies or {}, default=default, bounds=bounds)
    elif policies is not None or default is not None:
        raise ValueError("pass either table= or policies=/default=, not both")
    resolved = PolicyTable(
        rows=tuple((k, _resolve_policy(p, pod_axis, MAX_STRIPES, op=k[0]))
                   for k, p in table.rows),
        default=_resolve_policy(table.default, pod_axis, MAX_STRIPES),
        bounds=table.bounds)
    return Communicator(local_axes=tuple(local_axes), pod_axis=pod_axis,
                        table=resolved, bucket_bytes=int(bucket_bytes),
                        pipeline_chunk_bytes=pipeline_chunk_bytes)


def from_config(cfg) -> Communicator:
    """Compile a legacy single-policy ``HetCCLConfig`` into a communicator
    with a one-row table (the facade contract, DESIGN.md §12)."""
    return create(tuple(cfg.local_axes), cfg.pod_axis,
                  table=PolicyTable.single(cfg.to_policy()),
                  bucket_bytes=cfg.bucket_bytes,
                  pipeline_chunk_bytes=cfg.pipeline_chunk_bytes)
