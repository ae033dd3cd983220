"""Membership epochs: the explicit state machine that survives pod loss and
join without a job relaunch (DESIGN.md §13).

Counterpart of ``repro/elastic/membership.py``, the port's own copy.  The
communicators it creates are the port's (``repro_torch.comm.create``); a
train program built on the new mesh (``train.trainer.rebuild_program``)
binds a fresh one of its own from the re-planned run config.

Each membership change is one *epoch transition*:

    RUNNING --(pod-dead | pod-joined)--> DRAINING --> REBUILDING --> RUNNING

DRAINING fences the step loop (in-flight work for the old topology is
abandoned or completed, never mixed into the new epoch); REBUILDING then

  1. snapshots the surviving :class:`~repro_torch.core.topology.ClusterSpec` —
     link-health inventories of surviving pods are *carried over*, so a NIC
     degraded before the pod loss stays degraded in the new epoch's pricing;
  2. rebuilds the communicator stack via :func:`repro_torch.comm.create` against
     the new topology slice (communicators bind topology at creation,
     DESIGN.md §12 — a membership change therefore *requires* new ones);
  3. re-plans shares/policies through :func:`repro_torch.train.ft.replan_auto`
     (batch contract preserved) — or, without an autotuner plan, through
     the shares-only :func:`repro_torch.train.ft.replan`;
  4. prices the epoch with :func:`repro_torch.core.simulator.rebuild_time`
     (checkpointless vs checkpoint-fallback recovery, DESIGN.md §13).

State *recovery* onto the new mesh is ``elastic.recover``'s job; the
:class:`RebuildResult` returned here carries everything it and the trainer
rebuild path need.
"""
from __future__ import annotations

import dataclasses
from typing import Any

from repro_torch.core import simulator as sim
from repro_torch.core.balance import HetPlan, PodProfile
from repro_torch.core.topology import ClusterSpec, PodSpec
from repro_torch.elastic.detect import EVENT_POD_DEAD, FailureDetector, PodEvent

RUNNING = "RUNNING"
DRAINING = "DRAINING"
REBUILDING = "REBUILDING"
STATES = (RUNNING, DRAINING, REBUILDING)


class MembershipError(RuntimeError):
    """An epoch transition the fleet cannot survive (last pod died, join of
    an unknown pod, event from a stale epoch)."""


@dataclasses.dataclass(frozen=True)
class RebuildResult:
    """Everything one completed epoch transition produced.

    epoch:        the new epoch number (monotonic).
    event:        the membership event that triggered the rebuild.
    cluster:      the surviving/extended topology snapshot (health carried).
    comm:         fresh communicator bound to ``cluster``'s topology slice.
    plan:         re-balanced micro-batch shares for the new pod set.
    train_plan:   the re-ranked autotuner plan (None on the shares-only
                  path); materialize with ``.run_config()`` for the trainer.
    modeled_checkpointless_s / modeled_checkpoint_s:
                  simulator prices of the two recovery paths for
                  ``state_bytes`` of state (DESIGN.md §13) — checkpointless
                  is strictly cheaper, which is why recovery prefers it
                  whenever shard coverage allows.
    """

    epoch: int
    event: PodEvent
    cluster: ClusterSpec
    comm: Any
    plan: HetPlan
    train_plan: Any = None
    state_bytes: float = 0.0
    modeled_checkpointless_s: float = 0.0
    modeled_checkpoint_s: float = 0.0

    @property
    def pod_axis(self) -> str | None:
        return "pod" if len(self.cluster.pods) > 1 else None


class Membership:
    """The epoch state machine (one per training job).

    Args:
        cluster: the starting topology (epoch 0's membership).
        train_plan: the incumbent ``repro_torch.plan.TrainPlan`` when the run was
            planned by the autotuner — rebuilds then go through
            ``ft.replan_auto`` for fresh shares *and* policies.  Omit it to
            fall back to shares-only ``ft.replan`` on ``plan``.
        plan: the incumbent ``HetPlan`` (required without ``train_plan``).
        local_axes: intra-island DP axes for rebuilt communicators.
        detector: optional :class:`FailureDetector` whose ``epoch`` stamp
            this machine advances after every rebuild.
    """

    def __init__(self, cluster: ClusterSpec, *, train_plan=None,
                 plan: HetPlan | None = None,
                 local_axes: tuple[str, ...] = ("data",),
                 detector: FailureDetector | None = None):
        if train_plan is None and plan is None:
            raise ValueError("need train_plan (autotuner path) or plan "
                             "(shares-only path)")
        self.cluster = cluster
        self.train_plan = train_plan
        self.plan = plan if plan is not None else train_plan.plan
        self.local_axes = tuple(local_axes)
        self.detector = detector
        self.epoch = 0
        self.state = RUNNING
        self.transitions: list[tuple[int, str]] = [(0, RUNNING)]
        self.results: list[RebuildResult] = []
        # every pod ever seen, so a revived island can rejoin by name
        self._known: dict[str, PodSpec] = {p.name: p for p in cluster.pods}

    # -- state machine ------------------------------------------------------

    def _to(self, state: str) -> None:
        self.state = state
        self.transitions.append((self.epoch, state))

    def register(self, pod: PodSpec) -> None:
        """Make a brand-new pod joinable (scheduler handed us hardware the
        job has never seen)."""
        self._known[pod.name] = pod

    def on_event(self, ev: PodEvent,
                 state_bytes: float = 0.0) -> RebuildResult | None:
        """Drive one event through the machine.

        Link-level events return None (transport failover handles them
        in-epoch, DESIGN.md §11); membership events run the full
        DRAINING -> REBUILDING -> RUNNING transition and return the
        :class:`RebuildResult`.  Events stamped with an older epoch than the
        current one are stale and rejected.
        """
        if ev.epoch < self.epoch:
            raise MembershipError(
                f"stale event from epoch {ev.epoch} (now {self.epoch}): {ev}")
        if not ev.membership_change:
            return None
        if ev.kind == EVENT_POD_DEAD:
            survivors = tuple(p for p in self.cluster.pods
                              if p.name != ev.pod)
            if not survivors:
                raise MembershipError(f"last pod died: {ev}")
            if len(survivors) == len(self.cluster.pods):
                return None              # already removed (duplicate event)
        else:                            # EVENT_POD_JOINED
            if ev.pod not in self._known:
                raise MembershipError(
                    f"join of unknown pod {ev.pod!r}; register() its "
                    f"PodSpec first")
            if any(p.name == ev.pod for p in self.cluster.pods):
                return None              # already a member (duplicate event)
            survivors = tuple(self.cluster.pods) + (self._known[ev.pod],)
        self._to(DRAINING)
        self._to(REBUILDING)
        result = self._rebuild(ev, survivors, state_bytes)
        self.cluster = result.cluster
        self.plan = result.plan
        if result.train_plan is not None:
            self.train_plan = result.train_plan
        self.epoch = result.epoch
        if self.detector is not None:
            self.detector.epoch = self.epoch
        self._to(RUNNING)
        self.results.append(result)
        return result

    def rebuild_in_place(self, ev: PodEvent, state_bytes: float = 0.0, *,
                         factors: dict[str, float] | None = None
                         ) -> RebuildResult:
        """Epoch transition with the *same* pod set (DESIGN.md §15).

        The gray-failure rungs change the communicator or the plan, never
        the membership: a watchdog ``rebuild`` verdict needs fresh
        communicators (a wedged channel is reset by re-initialization, the
        NCCL-communicator-abort analogue), and a quarantine/reinstatement
        edge re-weights DP shares in place.  Both still walk
        DRAINING -> REBUILDING -> RUNNING and bump the epoch — in-flight
        work against the old communicators must be fenced exactly like a
        membership change, and the stale-event guard must cover them.

        Args:
            ev: the triggering event (``comm-rebuild`` / ``pod-quarantined``
                / ``pod-reinstated``), stamped with the current epoch.
            factors: ``None`` keeps the incumbent plan (pure communicator
                rebuild); a ``pod -> slowdown multiple`` mapping re-plans
                DP shares through de-weighted profiles
                (:func:`repro_torch.plan.refine.deweighted_profiles`) — pass
                ``{}`` to re-plan on *base* profiles (the reinstatement
                path, restoring healthy shares).
        """
        from repro_torch import comm as comm_mod
        from repro_torch.train import ft
        if ev.epoch < self.epoch:
            raise MembershipError(
                f"stale event from epoch {ev.epoch} (now {self.epoch}): {ev}")
        self._to(DRAINING)
        self._to(REBUILDING)
        cluster = self._snapshot(tuple(self.cluster.pods))
        pod_axis = "pod" if len(cluster.pods) > 1 else None
        new_tp = None
        if factors is None:
            plan = self.plan
            if self.train_plan is not None:
                comm = comm_mod.create(self.local_axes, pod_axis,
                                       table=self.train_plan.policy_table(),
                                       bucket_bytes=self.train_plan.bucket_bytes,
                                       topology_slice=cluster)
            else:
                comm = comm_mod.create(self.local_axes, pod_axis,
                                       topology_slice=cluster)
        else:
            from repro_torch.plan.refine import deweighted_profiles
            base = [PodProfile(p.name, p.effective_flops, p.n_chips)
                    for p in cluster.pods]
            profiles = deweighted_profiles(base, factors)
            if self.train_plan is not None:
                new_tp = ft.replan_auto(self.train_plan, profiles=profiles,
                                        cluster=cluster)
                plan = new_tp.plan
                comm = comm_mod.create(self.local_axes, pod_axis,
                                       table=new_tp.policy_table(),
                                       bucket_bytes=new_tp.bucket_bytes,
                                       topology_slice=cluster)
            else:
                plan = ft.replan(self.plan, profiles)
                comm = comm_mod.create(self.local_axes, pod_axis,
                                       topology_slice=cluster)
        result = RebuildResult(
            epoch=self.epoch + 1, event=ev, cluster=cluster, comm=comm,
            plan=plan, train_plan=new_tp, state_bytes=state_bytes,
            modeled_checkpointless_s=sim.rebuild_time(
                cluster, state_bytes, checkpointless=True),
            modeled_checkpoint_s=sim.rebuild_time(
                cluster, state_bytes, checkpointless=False))
        self.cluster = cluster
        self.plan = plan
        if new_tp is not None:
            self.train_plan = new_tp
        self.epoch = result.epoch
        if self.detector is not None:
            self.detector.epoch = self.epoch
        self._to(RUNNING)
        self.results.append(result)
        return result

    # -- rebuild internals --------------------------------------------------

    def _snapshot(self, pods: tuple[PodSpec, ...]) -> ClusterSpec:
        """Topology snapshot for the new epoch, with the *shared* link
        inventories of carried-over pods pre-seeded — a degraded NIC on a
        survivor stays degraded in the new epoch's stripe plans and prices."""
        new = ClusterSpec(pods, inter_pod_bw=self.cluster.inter_pod_bw,
                          inter_pod_alpha=self.cluster.inter_pod_alpha)
        carried = {p.name: self.cluster.inventory(p)
                   for p in self.cluster.pods
                   if any(q.name == p.name for q in pods)}
        object.__setattr__(new, "_inventories", carried)
        return new

    def _rebuild(self, ev: PodEvent, pods: tuple[PodSpec, ...],
                 state_bytes: float) -> RebuildResult:
        from repro_torch import comm as comm_mod
        from repro_torch.train import ft
        cluster = self._snapshot(pods)
        pod_axis = "pod" if len(pods) > 1 else None
        new_tp = None
        if self.train_plan is not None:
            new_tp = ft.replan_auto(self.train_plan, cluster=cluster)
            plan = new_tp.plan
            comm = comm_mod.create(self.local_axes, pod_axis,
                                   table=new_tp.policy_table(),
                                   bucket_bytes=new_tp.bucket_bytes,
                                   topology_slice=cluster)
        else:
            profiles = [PodProfile(p.name, p.effective_flops, p.n_chips)
                        for p in pods]
            plan = ft.replan(self.plan, profiles)
            comm = comm_mod.create(self.local_axes, pod_axis,
                                   topology_slice=cluster)
        return RebuildResult(
            epoch=self.epoch + 1, event=ev, cluster=cluster, comm=comm,
            plan=plan, train_plan=new_tp, state_bytes=state_bytes,
            modeled_checkpointless_s=sim.rebuild_time(
                cluster, state_bytes, checkpointless=True),
            modeled_checkpoint_s=sim.rebuild_time(
                cluster, state_bytes, checkpointless=False))
