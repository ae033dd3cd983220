"""Telemetry probes: one dispatch per policy-table cell, between steps.

Counterpart of ``repro/obs/probe.py``.  The reference needs probes because
its dispatch hook sees only eager calls and a jitted step hides every
collective; the port dispatches eagerly, so every collective of a step is a
span already.  Probes still do what they do there: between steps they
dispatch one collective per active policy-table cell through a *probe
communicator* (no local axes, no pod axis) on a one-rank mesh, so every
cell of the table gets a span with the run's policy tags and the
simulator's modeled time, including the cells the step did not reach (the
rows ``plan.measured.rows_from_flight`` ingests as calibration).  Probe
spans are tagged ``probe=True``.

With empty axes every collective runs its one-rank path: the hierarchy
short-circuits on a falsy pod axis and a sum over no axes is the identity,
so the probe runs policy resolution and variant mapping on this process
alone.  ``all_to_all`` is left out, as in the reference.
"""
from __future__ import annotations

import contextlib
import dataclasses

# One representative payload per size class, as in the reference.
PROBE_CLASS_BYTES = {"small": 16 * 1024, "medium": 1 << 20, "large": 16 << 20}

_PROBE_OPS = ("all_gather", "all_reduce", "broadcast", "reduce",
              "reduce_scatter")
_PROBE_KW = {"broadcast": {"root": 0}, "reduce": {"root": 0}}


def probe_communicator(comm, tracer=None):
    """Clone ``comm``'s policy table onto an empty-group communicator (and
    optionally pin ``tracer`` to it): the probe dispatch target."""
    from repro_torch.comm import communicator as comm_mod
    pc = comm_mod.create((), None, table=comm.table,
                         bucket_bytes=comm.bucket_bytes)
    if tracer is not None:
        pc = dataclasses.replace(pc, tracer=tracer)
    return pc


def probe_cells(comm) -> list[tuple[str, str]]:
    """The ``(op, size_class)`` cells a probe pass covers: every explicit
    policy-table row (wildcard-class rows expand to every class), or the
    full probe-able grid on a facade table."""
    rows = set()
    for (op, cls), _pol in comm.table.rows:
        if op not in _PROBE_OPS:
            continue
        for c in (PROBE_CLASS_BYTES if cls == "*" else (cls,)):
            rows.add((op, c))
    if rows:
        return sorted(rows)
    return [(op, cls) for op in _PROBE_OPS for cls in PROBE_CLASS_BYTES]


def run_probes(probe_comm, *, cells=None, step: int | None = None,
               device="cuda") -> int:
    """Dispatch one collective per cell through ``probe_comm`` on a one-rank
    mesh on ``device``.  Returns the number of probe dispatches; the tracer
    pinned to ``probe_comm`` (or the installed one) records each as a
    collective span tagged ``probe=True``; an armed watchdog is disarmed for
    the duration, as in the reference (a probe is not a step's collective)."""
    import torch

    from repro_torch.core import hetccl
    from repro_torch.core.mesh import ThreadMesh

    tracer = probe_comm.tracer if probe_comm.tracer is not None \
        else hetccl.current_tracer()
    if cells is None:
        cells = probe_cells(probe_comm)
    cells = [(op, cls) for op, cls in cells if op in _PROBE_OPS]
    if tracer is not None:
        tracer.set_step(step)
    mesh = ThreadMesh({"data": 1}, device=device)

    def body(_):
        payloads: dict[int, object] = {}
        for op, cls in cells:
            nbytes = PROBE_CLASS_BYTES[cls]
            if nbytes not in payloads:
                payloads[nbytes] = torch.zeros(nbytes // 4, dtype=torch.float32,
                                               device=mesh.device)
            getattr(hetccl, op)(payloads[nbytes], probe_comm, **_PROBE_KW.get(op, {}))
        return len(cells)

    ctx = tracer.extra(probe=True) if tracer is not None else contextlib.nullcontext()
    wd = hetccl.armed_watchdog()
    hetccl.disarm_watchdog()
    try:
        with ctx:
            return mesh.run(body, [None])[0]
    finally:
        if wd is not None:
            hetccl.arm_watchdog(wd)
