"""Per-pod straggler quarantine: hysteresis state machine over attributed
step times (DESIGN.md §15).

Counterpart of ``repro/elastic/quarantine.py``, the port's own copy.

On a synchronous heterogeneous fleet one thermally throttled island sets the
pace of every step (H2's observation; the motivation for the paper's
balancer).  The clean-failure machinery (``elastic.detect`` /
``elastic.membership``) only knows dead-or-alive; this module owns the gray
middle: a pod that still heartbeats and still acks its links but runs its
micro-steps persistently slower than its healthy baseline.

The ladder is deliberately *graded* — eviction throws away throughput the
pod still has, so the control plane de-weights before it amputates:

    healthy --sustained > suspect_ratio--> suspect
    suspect --sustained > quarantine_ratio--> quarantined
        (quarantine = the pod's DP share is de-weighted through
         ``plan.refine.deweighted_profiles`` / ``ft.replan_auto``;
         the pod keeps training, just on fewer micro-steps)
    quarantined --sustained <= clear_ratio--> healthy   (reinstated)
    quarantined --sustained >= evict_ratio--> evicted   (pod-dead path)

Every edge requires a *streak* of consecutive observations (no single-sample
transitions), the reinstate threshold sits strictly below the suspect
threshold (classic hysteresis gap), and each reinstatement multiplies the
next reinstate streak requirement by ``flap_penalty`` — an oscillating pod
ratchets toward staying quarantined instead of thrashing the planner with
replans.

Observations are *per-unit-of-work* seconds (seconds per micro-step): the
baseline is each pod's own frozen healthy reference, so absolute speed
differences between heterogeneous islands never trip the tracker — only a
pod drifting against *itself* does.  In production the number arrives as
heartbeat metadata; the chaos injector synthesizes it deterministically
(``ChaosScript.compute_factor``).  Pure stdlib, like the rest of the
detection layer.
"""
from __future__ import annotations

import dataclasses
import statistics

POD_HEALTHY = "healthy"
POD_SUSPECT = "suspect"
POD_QUARANTINED = "quarantined"
POD_EVICTED = "evicted"
STRAGGLER_STATES = (POD_HEALTHY, POD_SUSPECT, POD_QUARANTINED, POD_EVICTED)


@dataclasses.dataclass(frozen=True)
class QuarantinePolicy:
    """Thresholds and streak lengths of the hysteresis ladder.

    Ratios are step-time multiples of the pod's frozen healthy baseline.
    The defaults encode the hysteresis invariants the tests pin:
    ``clear_ratio < suspect_ratio < quarantine_ratio < evict_ratio`` and
    ``reinstate_after > quarantine_after`` (leaving quarantine is harder
    than entering it — the flap-damping direction).
    """

    suspect_ratio: float = 1.25
    quarantine_ratio: float = 1.5
    clear_ratio: float = 1.1
    evict_ratio: float = 8.0
    suspect_after: int = 2       # consecutive slow samples: healthy->suspect
    quarantine_after: int = 3    # consecutive slow samples: suspect->quarantined
    reinstate_after: int = 4     # consecutive clear samples to reinstate
    evict_after: int = 3         # consecutive extreme samples to evict
    flap_penalty: int = 2        # reinstate_after multiplier per reinstatement
    baseline_window: int = 3     # healthy samples frozen into the baseline

    def __post_init__(self):
        if not (self.clear_ratio < self.suspect_ratio
                < self.quarantine_ratio < self.evict_ratio):
            raise ValueError(
                "need clear_ratio < suspect_ratio < quarantine_ratio < "
                f"evict_ratio, got {self}")
        if self.reinstate_after <= 0 or self.baseline_window <= 0:
            raise ValueError(f"streaks must be positive: {self}")


@dataclasses.dataclass(frozen=True)
class StragglerTransition:
    """One state-machine edge of one pod (what the detector turns into a
    typed :class:`~repro_torch.elastic.detect.PodEvent`)."""

    pod: str
    step: int
    frm: str
    to: str
    ratio: float        # step-time multiple of the healthy baseline


@dataclasses.dataclass
class _PodHealth:
    state: str = POD_HEALTHY
    baseline: float | None = None     # frozen healthy per-unit seconds
    warmup: list = dataclasses.field(default_factory=list)
    ratio: float = 1.0                # latest observed multiple
    slow_streak: int = 0
    ok_streak: int = 0
    evict_streak: int = 0
    reinstatements: int = 0           # flap counter


class StragglerTracker:
    """Per-pod step-time attribution + the hysteresis ladder.

    Feed :meth:`observe` one (pod, step, seconds-per-unit-of-work) sample
    per completed step; it returns a :class:`StragglerTransition` when the
    pod crosses a ladder edge and ``None`` in steady state.  The first
    ``baseline_window`` samples of each pod freeze its healthy baseline —
    unlike an EMA, a later sustained slowdown can never absorb into the
    reference (the ``ft.StragglerMonitor`` fleet-aggregate bug this class
    exists to not repeat).
    """

    def __init__(self, policy: QuarantinePolicy | None = None):
        self.policy = policy or QuarantinePolicy()
        self._pods: dict[str, _PodHealth] = {}
        self.transitions: list[StragglerTransition] = []

    # -- queries -------------------------------------------------------------

    def state(self, pod: str) -> str:
        return self._pods[pod].state if pod in self._pods else POD_HEALTHY

    def ratio(self, pod: str) -> float:
        return self._pods[pod].ratio if pod in self._pods else 1.0

    def quarantined(self) -> list[str]:
        return [p for p, h in self._pods.items()
                if h.state == POD_QUARANTINED]

    def replan_factors(self) -> dict[str, float]:
        """The de-weighting input for ``plan.refine.deweighted_profiles``:
        every quarantined pod's measured slowdown multiple.  Healthy and
        suspect pods are absent (suspects are advisory — the planner only
        moves on quarantine, that's the hysteresis point)."""
        return {p: max(h.ratio, 1.0) for p, h in self._pods.items()
                if h.state == POD_QUARANTINED}

    # -- the ladder ----------------------------------------------------------

    def observe(self, pod: str, step: int,
                seconds: float) -> StragglerTransition | None:
        if seconds <= 0:
            raise ValueError(f"step seconds must be > 0, got {seconds}")
        h = self._pods.setdefault(pod, _PodHealth())
        if h.state == POD_EVICTED:
            return None
        pol = self.policy
        if h.baseline is None:
            h.warmup.append(seconds)
            if len(h.warmup) >= pol.baseline_window:
                h.baseline = statistics.median(h.warmup)
            return None
        h.ratio = r = seconds / h.baseline
        if h.state == POD_HEALTHY:
            h.slow_streak = h.slow_streak + 1 if r > pol.suspect_ratio else 0
            if h.slow_streak >= pol.suspect_after:
                return self._edge(h, pod, step, POD_SUSPECT)
        elif h.state == POD_SUSPECT:
            if r > pol.quarantine_ratio:
                h.slow_streak, h.ok_streak = h.slow_streak + 1, 0
                if h.slow_streak >= pol.quarantine_after:
                    return self._edge(h, pod, step, POD_QUARANTINED)
            elif r <= pol.suspect_ratio:
                h.ok_streak, h.slow_streak = h.ok_streak + 1, 0
                if h.ok_streak >= pol.suspect_after:
                    return self._edge(h, pod, step, POD_HEALTHY)
            else:                      # the gray band between the thresholds
                h.slow_streak = h.ok_streak = 0
        elif h.state == POD_QUARANTINED:
            h.evict_streak = h.evict_streak + 1 if r >= pol.evict_ratio else 0
            if h.evict_streak >= pol.evict_after:
                return self._edge(h, pod, step, POD_EVICTED)
            if r <= pol.clear_ratio:
                h.ok_streak += 1
                need = pol.reinstate_after * (pol.flap_penalty
                                              ** h.reinstatements)
                if h.ok_streak >= need:
                    h.reinstatements += 1
                    return self._edge(h, pod, step, POD_HEALTHY)
            else:
                h.ok_streak = 0
        return None

    def _edge(self, h: _PodHealth, pod: str, step: int,
              to: str) -> StragglerTransition:
        tr = StragglerTransition(pod=pod, step=step, frm=h.state, to=to,
                                 ratio=h.ratio)
        h.state = to
        h.slow_streak = h.ok_streak = h.evict_streak = 0
        self.transitions.append(tr)
        return tr
