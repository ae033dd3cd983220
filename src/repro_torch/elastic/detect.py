"""Failure detection: link health aggregated to pod level, step heartbeats,
typed membership events (DESIGN.md §13).

Counterpart of ``repro/elastic/detect.py``, the port's own copy: pure logic
over the port's ``core.topology.ClusterSpec`` and its link inventories.
The transport layer already makes *links* first-class (``transport.links``:
up / degraded / down per NIC), and the supervised loop already times steps.
What was missing is the classification layer a fleet control plane acts on:

  * :class:`HeartbeatMonitor` — per-pod step heartbeats with a configurable
    timeout and a registration/revival grace period (Holmes-style liveness:
    a pod that stops completing steps is dead even if its NICs still ack);
  * :class:`FailureDetector` — polls both signals over the fleet's
    :class:`~repro_torch.core.topology.ClusterSpec` inventories and emits typed
    :class:`PodEvent`\\ s on *transitions* only (no event storms):

      - ``link-degraded``  -> transport failover territory (restripe,
        re-price; numerics unaffected, DESIGN.md §11);
      - ``link-recovered`` -> the inverse transition, logged for re-pricing;
      - ``pod-dead``       -> membership change (drain, rebuild, re-plan,
        recover — ``elastic.membership``);
      - ``pod-joined``     -> membership change in the other direction.

Every event carries the membership *epoch* it was observed in, so a late
event from a previous epoch is recognizable as stale.  Pure stdlib (no torch
import): the detector runs on a login node next to the numpy-only planner.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Iterable

from repro_torch.transport.links import LINK_UP

EVENT_LINK_DEGRADED = "link-degraded"
EVENT_LINK_RECOVERED = "link-recovered"
EVENT_POD_DEAD = "pod-dead"
EVENT_POD_JOINED = "pod-joined"
MEMBERSHIP_EVENTS = frozenset({EVENT_POD_DEAD, EVENT_POD_JOINED})

# Gray-failure events (DESIGN.md §15): the straggler ladder's edges and the
# watchdog's communicator rebuild.  Plan events change the *plan* (DP
# de-weighting), not the membership — the epoch machine stays in RUNNING.
EVENT_POD_SLOW = "pod-slow"
EVENT_POD_QUARANTINED = "pod-quarantined"
EVENT_POD_REINSTATED = "pod-reinstated"
EVENT_COMM_REBUILD = "comm-rebuild"
PLAN_EVENTS = frozenset({EVENT_POD_QUARANTINED, EVENT_POD_REINSTATED})

# Pod-level health classifications the detector aggregates link state into.
POD_UP = "up"
POD_DEGRADED = "degraded"
POD_DEAD = "dead"


@dataclasses.dataclass(frozen=True)
class PodEvent:
    """One classified health transition of one pod.

    kind:   one of the EVENT_* constants above.
    pod:    the island's name (``PodSpec.name``).
    epoch:  membership epoch the event was observed in (stale-event fence).
    step:   training step at observation time (for chaos scripts / logs).
    detail: free-form cause ("links 0,2 down", "heartbeat timeout", ...).
    seq:    monotonic per-detector sequence number — the total order of
            emission, which ``step`` alone can't give when several pods
            fault in the same step (-1 on events built outside a detector).
    """

    kind: str
    pod: str
    epoch: int
    step: int
    detail: str = ""
    seq: int = -1

    @property
    def membership_change(self) -> bool:
        """True for the events the epoch state machine must act on."""
        return self.kind in MEMBERSHIP_EVENTS

    @property
    def plan_change(self) -> bool:
        """True for the events that re-plan DP shares in place
        (quarantine / reinstatement — DESIGN.md §15)."""
        return self.kind in PLAN_EVENTS


class HeartbeatMonitor:
    """Step-heartbeat liveness with timeout + grace (DESIGN.md §13).

    A pod beats once per completed step (:meth:`beat`); :meth:`expired`
    flags pods silent for longer than ``timeout_s``.  ``grace_s`` suspends
    the timeout after registration or revival (compile + checkpoint load
    legitimately stall the first beats).  The clock is injectable so chaos
    tests are deterministic.
    """

    def __init__(self, timeout_s: float = 30.0, grace_s: float = 60.0,
                 clock=time.monotonic):
        if timeout_s <= 0:
            raise ValueError(f"timeout_s must be > 0, got {timeout_s}")
        self.timeout_s = timeout_s
        self.grace_s = grace_s
        self._clock = clock
        self._last_beat: dict[str, float] = {}
        self._last_step: dict[str, int] = {}
        self._registered: dict[str, float] = {}

    def register(self, pod: str, now: float | None = None) -> None:
        """(Re-)arm liveness for ``pod``; starts the grace window."""
        now = self._clock() if now is None else now
        self._registered[pod] = now
        self._last_beat.pop(pod, None)
        self._last_step.pop(pod, None)

    def beat(self, pod: str, step: int, now: float | None = None) -> None:
        now = self._clock() if now is None else now
        if pod not in self._registered:
            self._registered[pod] = now
        self._last_beat[pod] = now
        self._last_step[pod] = step

    def last_step(self, pod: str) -> int | None:
        return self._last_step.get(pod)

    def expired(self, pod: str, now: float | None = None) -> bool:
        """True when ``pod`` is registered and silent past timeout (grace
        window excepted)."""
        if pod not in self._registered:
            return False
        now = self._clock() if now is None else now
        anchor = self._last_beat.get(pod)
        if anchor is None:
            anchor = self._registered[pod]
            return now - anchor > self.grace_s + self.timeout_s
        if now - self._registered[pod] <= self.grace_s:
            return False
        return now - anchor > self.timeout_s


class FailureDetector:
    """Aggregate link health + heartbeats into :class:`PodEvent` streams.

    Owns the *fleet* view: it polls the original cluster's (mutable,
    shared) link inventories — the same objects the transport layer and
    chaos injector mutate — so a NIC marked down anywhere is visible here
    without any plumbing.  The active membership lives in
    ``elastic.membership``; the detector keeps watching dead pods so a
    revived one surfaces as ``pod-joined``.

    ``epoch`` is advanced by the membership layer after each rebuild
    (``Membership.attach_detector``); events are stamped with it.

    The gray middle (DESIGN.md §15): an optional
    :class:`~repro_torch.elastic.quarantine.StragglerTracker` receives per-pod
    step-time attributions via :meth:`observe_step` and its ladder edges
    surface here as typed plan events (``pod-slow`` / ``pod-quarantined`` /
    ``pod-reinstated``); an eviction verdict lands the pod on the *ban*
    list, which classifies as dead on the next poll — re-using the
    membership path instead of growing a second one.
    """

    def __init__(self, cluster, heartbeat: HeartbeatMonitor | None = None,
                 epoch: int = 0, straggler=None):
        self.cluster = cluster
        self.heartbeat = heartbeat
        self.straggler = straggler
        self.epoch = epoch
        self.events: list[PodEvent] = []
        self._last: dict[str, str] = {p.name: POD_UP for p in cluster.pods}
        self._banned: set[str] = set()
        self._seq = 0
        self._observers: list = []

    # -- emission (the single event source) ---------------------------------

    def subscribe(self, fn) -> None:
        """Register ``fn(event)`` to be called on every emitted event (how
        the telemetry plane taps the stream without polling ``events``)."""
        self._observers.append(fn)

    def emit(self, kind: str, pod: str, step: int, detail: str = "",
             epoch: int | None = None) -> PodEvent:
        """Stamp, record, and fan out one event.  Every event this detector
        produces flows through here, so ``seq`` is a total emission order —
        deterministic even when several pods fault in the same step."""
        ev = PodEvent(kind=kind, pod=pod,
                      epoch=self.epoch if epoch is None else epoch,
                      step=step, detail=detail, seq=self._seq)
        self._seq += 1
        self.events.append(ev)
        for fn in self._observers:
            fn(ev)
        return ev

    # -- gray failures (straggler ladder) -----------------------------------

    def observe_step(self, pod_name: str, step: int,
                     seconds: float) -> PodEvent | None:
        """Attribute one per-unit-of-work step time to ``pod_name`` and run
        the quarantine ladder; emits the typed event for a crossed edge.
        No-op when no straggler tracker is attached."""
        if self.straggler is None:
            return None
        from repro_torch.elastic import quarantine as q
        tr = self.straggler.observe(pod_name, step, seconds)
        if tr is None:
            return None
        if tr.to == q.POD_SUSPECT:
            kind = EVENT_POD_SLOW
        elif tr.to == q.POD_QUARANTINED:
            kind = EVENT_POD_QUARANTINED
        elif tr.to == q.POD_EVICTED:
            # Too slow to keep even de-weighted: amputate via the existing
            # membership path — ban makes the next poll say pod-dead.
            self.ban(pod_name)
            return None
        else:
            kind = EVENT_POD_REINSTATED
        return self.emit(kind, pod_name, step,
                         f"{tr.frm}->{tr.to} at {tr.ratio:.2f}x baseline")

    def ban(self, pod_name: str) -> None:
        """Administratively declare ``pod_name`` dead (straggler eviction /
        post-rebuild hang): classified dead until :meth:`unban`, so link
        revival can't bounce it back in as ``pod-joined``."""
        self._banned.add(pod_name)

    def unban(self, pod_name: str) -> None:
        self._banned.discard(pod_name)

    # -- classification -----------------------------------------------------

    def classify(self, pod, now: float | None = None) -> tuple[str, str]:
        """(pod-health, cause) from link aggregation + heartbeat."""
        if pod.name in self._banned:
            return POD_DEAD, "banned (straggler eviction)"
        inv = self.cluster.inventory(pod)
        if inv.n_healthy() == 0:
            return POD_DEAD, "all links down"
        if self.heartbeat is not None and self.heartbeat.expired(pod.name, now):
            return POD_DEAD, "heartbeat timeout"
        impaired = [l.index for l in inv.links
                    if inv.health(l.index).state != LINK_UP]
        if impaired:
            return POD_DEGRADED, "links " + ",".join(map(str, impaired))
        return POD_UP, ""

    def poll(self, step: int = 0, now: float | None = None) -> list[PodEvent]:
        """Classify every pod; emit events for *transitions* since the last
        poll (steady state emits nothing).  Returned events are also
        appended to :attr:`events`.  Pods are visited in ``cluster.pods``
        order, so same-step multi-pod faults emit in a deterministic order
        (and carry distinct ``seq`` stamps)."""
        out: list[PodEvent] = []
        for pod in self.cluster.pods:
            health, cause = self.classify(pod, now)
            prev = self._last.get(pod.name, POD_UP)
            if health == prev:
                continue
            self._last[pod.name] = health
            if health == POD_DEAD:
                kind = EVENT_POD_DEAD
            elif prev == POD_DEAD:
                # back from the dead: links restored / heartbeats resumed
                kind = EVENT_POD_JOINED
                cause = cause or "links restored"
            elif health == POD_DEGRADED:
                kind = EVENT_LINK_DEGRADED
            else:
                kind = EVENT_LINK_RECOVERED
            out.append(self.emit(kind, pod.name, step, cause))
        return out

    def notice_join(self, pod_name: str, step: int = 0) -> PodEvent:
        """Externally announced join (scheduler handed us a replacement pod
        that was never part of this detector's fleet view)."""
        self._last[pod_name] = POD_UP
        return self.emit(EVENT_POD_JOINED, pod_name, step, "scheduler join")


def dead_pods(events: Iterable[PodEvent]) -> list[str]:
    """Pods whose most recent membership event is ``pod-dead``."""
    state: dict[str, str] = {}
    for ev in events:
        if ev.membership_change:
            state[ev.pod] = ev.kind
    return [p for p, k in state.items() if k == EVENT_POD_DEAD]
