"""Collective hang watchdog: model-derived deadlines, priced not guessed
(DESIGN.md §15).

Counterpart of ``repro/elastic/watchdog.py``, the port's own copy.

A hung cross-vendor collective is the canonical gray failure (Holmes builds
its cross-cluster design around exactly this): the NIC acks, the heartbeat
still beats between steps, but one all-reduce never completes and the whole
synchronous fleet waits forever.  Detecting it needs a *deadline* per
collective — and a guessed timeout is either so loose it hides hour-long
stalls or so tight it kills healthy runs.

This module derives the deadline for every ``(op, size_class, backend)``
row of the active :class:`~repro_torch.comm.policy.PolicyTable` from first
principles plus evidence:

    deadline = modeled_s              (simulator price of the row's policy)
             * scale                  (measured/modeled ratio of that cell
                                       from a bench record, when one is
                                       given; geometric-median fleet ratio
                                       for unmeasured cells)
             * noise                  (the cell's IQR-high/median spread)
             * tolerance              (the only free knob, default 4x)

and validates ``deadline >= tolerance * measured median`` for every cell the
record measured — a deadline below observed reality is a derivation bug and
raises at table-build time, not at 3am.

The port reads only a bench record its caller names (:func:`load_bench`):
the repository's ``BENCH_comm.json`` describes the JAX package's CPU runs,
not the card (``plan/measured.py`` says so too), so without a record every
deadline is the modeled time times the tolerance (DESIGN_TORCH.md §25).

On breach the :class:`CollectiveWatchdog` emits a typed :class:`HangEvent`
whose ``action`` walks the escalation ladder

    bounded retry  ->  communicator rebuild  ->  pod-dead membership path

(retry a transient stall; rebuild communicators for a wedged channel — the
NCCL-communicator-abort analogue; amputate the pod when even a fresh
communicator hangs).  The ladder position is the count of *consecutive*
breaches: any in-deadline collective resets it.  The dispatch-path hook
lives in ``hetccl._call`` (:func:`repro_torch.core.hetccl.arm_watchdog`);
the ranks of a ``ThreadMesh`` that time one collective give it one verdict
(:meth:`CollectiveWatchdog.watch`'s ``group``); the elastic run loop
(``elastic.chaos.run_elastic``) drives the ladder.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import threading
import time
from typing import Mapping

from repro_torch.comm.policy import SIZE_CLASSES, WILDCARD, size_class
from repro_torch.core import simulator as sim

DEFAULT_TOLERANCE = 4.0

ACTION_RETRY = "retry"
ACTION_REBUILD = "rebuild"
ACTION_EVICT = "evict"


@dataclasses.dataclass(frozen=True)
class DeadlineRule:
    """One priced deadline: the full derivation kept for auditability."""

    op: str
    size_class: str
    backend: str
    modeled_s: float                    # simulator price of the policy row
    scale: float                        # calibration ratio applied
    noise: float                        # measured IQR-high/median headroom
    measured_median_s: float | None     # BENCH_comm.json evidence (if any)
    deadline_s: float
    wire_quant: str | None = None       # the row's wire codec (DESIGN.md §17)


class DeadlineCoverageError(ValueError):
    """A policy-table row has no derived deadline (or a derived deadline
    undercuts the measured median) — the coverage contract of DESIGN.md §15,
    enforced like ``plan.measured.missing_table_rows``."""


@dataclasses.dataclass(frozen=True)
class DeadlineTable:
    """Frozen ``(op, size_class) -> DeadlineRule`` mapping."""

    rows: tuple[DeadlineRule, ...]
    tolerance: float = DEFAULT_TOLERANCE

    def lookup(self, op: str, nbytes: float | None = None,
               cls: str | None = None) -> DeadlineRule | None:
        if cls is None:
            if nbytes is None:
                raise ValueError("need nbytes or cls")
            cls = size_class(nbytes)
        for r in self.rows:
            if r.op == op and r.size_class == cls:
                return r
        return None

    def missing_rows(self, policy_table) -> list[tuple[str, str]]:
        """The (op, size_class) rows of ``policy_table`` with no deadline —
        must be empty for the active table (CI watchdog smoke)."""
        have = {(r.op, r.size_class) for r in self.rows}
        missing = []
        for (op, cls), _ in policy_table.rows:
            for c in (SIZE_CLASSES if cls == WILDCARD else (cls,)):
                if (op, c) not in have and (op, c) not in missing:
                    missing.append((op, c))
        return missing

    def missing_cells(self, cells) -> list[tuple]:
        """Dispatched cells with no deadline rule — the quant-aware coverage
        check of the CI smoke.  Accepts ``(op, size_class, backend)``
        3-tuples (``Tracer.dispatched_cells``) and ``(..., wire_quant)``
        4-tuples (``Tracer.dispatched_quant_cells``); a 4-tuple cell matches
        only a rule whose codec agrees, so a quantized dispatch can never
        hide behind an unquantized deadline."""
        have4 = {(r.op, r.size_class, r.backend, r.wire_quant)
                 for r in self.rows}
        have3 = {k[:3] for k in have4}
        out = []
        for cell in sorted(tuple(c) for c in cells):
            hit = cell in have4 if len(cell) == 4 else cell in have3
            if not hit and cell not in out:
                out.append(cell)
        return out

    def representative(self) -> DeadlineRule:
        """The bandwidth-dominant rule (largest deadline) — the gradient-path
        collective a step-level stall is attributed to when the hung op is
        not directly observable."""
        if not self.rows:
            raise ValueError("empty deadline table")
        return max(self.rows, key=lambda r: r.deadline_s)


def load_bench(path: str) -> dict | None:
    """The bench record at ``path`` (None when there is no such file).  No
    default: the caller names the record that describes its hardware."""
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


def _bench_cells(bench_comm: Mapping) -> tuple[dict, float, float]:
    """Per-(op, size_class, backend) calibration evidence from the measured
    record: (max ratio, max median, max IQR-high/median) per cell, plus the
    fleet-wide geometric-median ratio and noise for unmeasured cells."""
    from repro_torch.plan import measured as meas
    report = meas.calibration_report(bench_comm)
    fleet_scale = meas.comm_scale_from_report(report)
    noise_by_name = {}
    for e in bench_comm["entries"]:
        med = float(e["median_s"])
        hi = float(e.get("iqr_hi_s", med))
        noise_by_name[e["name"]] = max(hi / med, 1.0) if med > 0 else 1.0
    cells: dict[tuple[str, str, str], dict] = {}
    for r in report:
        c = cells.setdefault((r.op, r.size_class, r.backend),
                             {"ratio": 0.0, "median": 0.0, "noise": 1.0})
        if math.isfinite(r.ratio):
            c["ratio"] = max(c["ratio"], r.ratio)
        c["median"] = max(c["median"], r.measured_s)
        c["noise"] = max(c["noise"], noise_by_name.get(r.name, 1.0))
    fleet_noise = max((c["noise"] for c in cells.values()), default=1.0)
    return cells, fleet_scale, fleet_noise


def derive_deadlines(cluster, policy_table, bench_comm: Mapping | None = None,
                     *, tolerance: float = DEFAULT_TOLERANCE) -> DeadlineTable:
    """Derive the deadline for every row of ``policy_table`` on ``cluster``.

    Args:
        cluster: the modeled :class:`~repro_torch.core.topology.ClusterSpec` the
            collectives run over (the simulator's pricing input).
        policy_table: the active :class:`~repro_torch.comm.policy.PolicyTable`;
            a one-row legacy facade (``rows == ()``) expands its default
            policy over every (op, size_class) cell so coverage never
            depends on how the table was authored.
        bench_comm: a measured bench record (``BENCH_comm.json``'s schema,
            :func:`load_bench`); when given,
            each cell's deadline is scaled by its own measured/modeled
            ratio and IQR spread, and validated >= tolerance x the measured
            median (:class:`DeadlineCoverageError` otherwise).
        tolerance: headroom multiplier over the calibrated expectation.
    """
    from repro_torch.plan.autotuner import CLASS_REP_BYTES, POLICY_OPS
    if tolerance <= 1.0:
        raise ValueError(f"tolerance must exceed 1.0, got {tolerance}")
    cells, fleet_scale, fleet_noise = (_bench_cells(bench_comm)
                                       if bench_comm is not None
                                       else ({}, 1.0, 1.0))
    table_rows = list(policy_table.rows) or \
        [((op, WILDCARD), policy_table.default) for op in POLICY_OPS]
    n_pods = len(getattr(cluster, "pods", ()) or ())
    rules: dict[tuple[str, str], DeadlineRule] = {}
    for (op, cls), pol in table_rows:
        for c in (SIZE_CLASSES if cls == WILDCARD else (cls,)):
            if (op, c) in rules:     # exact row beats wildcard (table order)
                continue
            mode = pol.mode if pol.mode != "auto" else \
                ("hier" if n_pods > 1 else "flat")
            quant = getattr(pol, "wire_quant", None) \
                if pol.backend == "pallas" else None
            modeled = sim.collective_time(
                op, float(CLASS_REP_BYTES[c]), cluster, mode,
                n_channels=max(int(pol.n_channels), 1), backend=pol.backend,
                n_stripes=max(int(pol.n_stripes), 1)
                if pol.backend == "pallas" else 1,
                wire_quant=quant)
            cell = cells.get((op, c, pol.backend))
            scale = cell["ratio"] if cell and cell["ratio"] > 0 \
                else fleet_scale
            noise = cell["noise"] if cell else fleet_noise
            median = cell["median"] if cell else None
            deadline = modeled * scale * noise * tolerance
            if median is not None:
                deadline = max(deadline, median * tolerance)
                if deadline < median:
                    raise DeadlineCoverageError(
                        f"derived deadline {deadline:.3g}s for "
                        f"({op},{c},{pol.backend}) undercuts the measured "
                        f"median {median:.3g}s")
            rules[(op, c)] = DeadlineRule(
                op=op, size_class=c, backend=pol.backend, modeled_s=modeled,
                scale=scale, noise=noise, measured_median_s=median,
                deadline_s=deadline, wire_quant=quant)
    return DeadlineTable(rows=tuple(rules.values()), tolerance=tolerance)


@dataclasses.dataclass(frozen=True)
class HangEvent:
    """One collective-deadline breach, with its ladder verdict.

    ``elapsed_s`` is ``inf`` for a stall that never completed (the chaos
    ``hang:`` injection / a dispatch that was abandoned); ``breaches`` is
    the consecutive-breach count that positioned ``action`` on the
    retry -> rebuild -> evict ladder.
    """

    op: str
    size_class: str
    backend: str
    pod: str | None
    step: int
    deadline_s: float
    elapsed_s: float
    breaches: int
    action: str


class CollectiveHangError(RuntimeError):
    """Raised by :meth:`CollectiveWatchdog.watch` when a dispatched
    collective overran its deadline.  Carries the :class:`HangEvent`."""

    def __init__(self, event: HangEvent):
        self.event = event
        super().__init__(
            f"collective hang: {event.op}/{event.size_class} took "
            f"{event.elapsed_s:.3g}s > deadline {event.deadline_s:.3g}s "
            f"(breach #{event.breaches} -> {event.action})")


class CollectiveHangSignal(RuntimeError):
    """Control-flow escape from the elastic step loop (the hang analogue of
    ``chaos.MembershipSignal``): carries the breach and its verdict."""

    def __init__(self, step: int, event: HangEvent):
        self.step = step
        self.event = event
        super().__init__(f"collective hang at step {step}: "
                         f"{event.op}/{event.size_class} -> {event.action}")


class CollectiveWatchdog:
    """Deadline enforcement + the escalation ladder.

    ``max_retries`` bounds the retry rung; breach ``max_retries + 1`` asks
    for a communicator rebuild and anything past that for eviction.  The
    counter is *consecutive*: :meth:`clear` (called on any in-deadline
    collective, and by the run loop on every completed step) resets the
    incident — a rebuild does **not**, which is what makes a post-rebuild
    breach escalate instead of retrying forever.  The clock is injectable
    so hang tests are deterministic.  The counter and the event list take a
    lock: the rank threads of a mesh and the run loop share one watchdog.
    """

    def __init__(self, deadlines: DeadlineTable, *, max_retries: int = 2,
                 clock=time.perf_counter):
        if max_retries < 0:
            raise ValueError(f"max_retries must be >= 0, got {max_retries}")
        self.deadlines = deadlines
        self.max_retries = max_retries
        self._clock = clock
        self._lock = threading.Lock()
        self._breaches = 0
        self.events: list[HangEvent] = []

    @property
    def breaches(self) -> int:
        """Current consecutive-breach count (the ladder position)."""
        return self._breaches

    def _action(self, breaches: int) -> str:
        if breaches <= self.max_retries:
            return ACTION_RETRY
        if breaches == self.max_retries + 1:
            return ACTION_REBUILD
        return ACTION_EVICT

    def clear(self) -> None:
        """An in-deadline collective (or completed step): incident over."""
        with self._lock:
            self._breaches = 0

    def deadline_for(self, op: str, nbytes: float) -> float | None:
        rule = self.deadlines.lookup(op, nbytes)
        return rule.deadline_s if rule is not None else None

    def observe(self, op: str, nbytes: float, elapsed_s: float, *,
                step: int = 0, pod: str | None = None) -> HangEvent | None:
        """Record one completed dispatch; returns the breach (or None).
        Uncovered (op, size_class) cells are not watched — the CI watchdog
        smoke guarantees the active table has none."""
        rule = self.deadlines.lookup(op, nbytes)
        if rule is None:
            return None
        if elapsed_s <= rule.deadline_s:
            self.clear()
            return None
        return self._breach(rule, elapsed_s, step, pod)

    def stall(self, *, pod: str | None = None, step: int = 0,
              op: str | None = None) -> HangEvent:
        """A collective that never completed (elapsed unbounded): the chaos
        ``hang:`` injection and the step-level stall detector both land
        here.  Attributed to ``op``'s large class when given, else to the
        table's bandwidth-dominant rule (the gradient path)."""
        rule = (self.deadlines.lookup(op, cls="large") if op else None) \
            or self.deadlines.representative()
        return self._breach(rule, math.inf, step, pod)

    def _breach(self, rule: DeadlineRule, elapsed_s: float, step: int,
                pod: str | None) -> HangEvent:
        with self._lock:
            self._breaches += 1
            ev = HangEvent(op=rule.op, size_class=rule.size_class,
                           backend=rule.backend, pod=pod, step=step,
                           deadline_s=rule.deadline_s, elapsed_s=elapsed_s,
                           breaches=self._breaches,
                           action=self._action(self._breaches))
            self.events.append(ev)
        return ev

    @contextlib.contextmanager
    def watch(self, op: str, nbytes: float, *, step: int = 0,
              pod: str | None = None, group=None):
        """Time one dispatch against its deadline (the ``hetccl._call``
        hook); raises :class:`CollectiveHangError` on breach.

        ``group``: for a collective that several ranks time at once, a
        function ``group(elapsed_s, verdict)`` that calls ``verdict`` once
        for all of them (on the largest elapsed time) and returns its
        result to each: one collective, one verdict, so four rank threads
        of one slow all-reduce give one breach, as the reference's single
        dispatch does (``hetccl._one_verdict``)."""
        t0 = self._clock()
        yield
        elapsed = self._clock() - t0

        def verdict(e):
            return self.observe(op, nbytes, e, step=step, pod=pod)

        ev = verdict(elapsed) if group is None else group(elapsed, verdict)
        if ev is not None:
            raise CollectiveHangError(ev)
