"""Deterministic chaos harness + the elastic run loop (DESIGN.md §13).

Counterpart of ``repro/elastic/chaos.py``.  The port's loop is the
reference's around the port's ``train.ft.run_supervised``; its meshes are
``ThreadMesh``\\ es on one device, so a pod's "devices" are the ranks of
its pod coordinate, a membership's mesh is carved from the full mesh's
shape (:func:`_member_mesh`), and recovery reads the live ranks' states
alone (``elastic.recover``; DESIGN_TORCH.md §25).

:class:`ChaosScript` injects faults at scripted steps — kill a pod (all its
links down), degrade or flap a single link, revive a pod — by mutating the
same shared :class:`~repro_torch.transport.links.LinkInventory` objects the
transport layer and :class:`~repro_torch.elastic.detect.FailureDetector` watch.
Nothing here is random: the same script against the same seed produces the
same event stream, which is what lets the chaos tests assert *bit-identical*
loss continuation against an uninterrupted baseline.

:func:`run_elastic` is the epoch-segmented supervisor around
:func:`repro_torch.train.ft.run_supervised`:

    segment (epoch k) --PodLost/PodJoin--> detector.poll -> Membership
        -> survivor mesh + rebuilt program -> recover_state
        -> segment (epoch k+1, ``start_step`` = recovered step)

Link-level faults never leave the segment (transport failover territory);
membership faults raise out of the step loop — deliberately *not* in
``run_supervised``'s ``retryable`` tuple — and drive one full epoch
transition before the loop resumes.

Gray failures (DESIGN.md §15) ride the same machinery with two more ops:
``slow`` (a priced compute slowdown the straggler ladder must quarantine)
and ``hang`` (a collective stall the watchdog must convert to recovery).
Both are *modeled*, never slept: ``slow`` synthesizes the per-pod
step-time attributions the detector consumes, ``hang`` drives
``CollectiveWatchdog.stall`` — so gray-failure tests stay exactly as
deterministic as the kill/revive ones.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

from repro_torch.elastic import recover as recover_mod
from repro_torch.elastic.detect import (EVENT_COMM_REBUILD, FailureDetector,
                                        PodEvent)
from repro_torch.elastic.membership import Membership, RebuildResult
from repro_torch.elastic.watchdog import (ACTION_EVICT, ACTION_REBUILD,
                                          CollectiveHangSignal, CollectiveWatchdog,
                                          HangEvent)

OP_KILL = "kill"
OP_REVIVE = "revive"
OP_DEGRADE = "degrade"
OP_DOWN = "down"
OP_UP = "up"
OP_SLOW = "slow"
OP_HANG = "hang"
OPS = (OP_KILL, OP_REVIVE, OP_DEGRADE, OP_DOWN, OP_UP, OP_SLOW, OP_HANG)


class MembershipSignal(RuntimeError):
    """Control-flow escape from the step loop: the detector saw membership
    events at ``step``.  Carries the events; the elastic loop catches it."""

    def __init__(self, step: int, events: list[PodEvent]):
        self.step = step
        self.events = list(events)
        super().__init__(f"membership change at step {step}: "
                         + ", ".join(f"{e.kind}:{e.pod}" for e in events))


class PodLostError(MembershipSignal):
    """A pod died mid-run (the chaos kill, or a real all-links-down)."""


class PodJoinSignal(MembershipSignal):
    """A pod (re)joined mid-run."""


class PlanSignal(MembershipSignal):
    """The straggler ladder crossed a plan-changing edge (quarantine or
    reinstatement): DP shares must be re-weighted in place
    (``Membership.rebuild_in_place``), membership unchanged."""


@dataclasses.dataclass(frozen=True)
class ChaosAction:
    """One scripted fault: at ``step``, apply ``op`` to ``pod`` (and
    optionally one ``link`` of it, at ``factor`` of nominal bandwidth —
    or, for ``slow``, ``factor``× compute slowdown through step ``until``
    inclusive, open-ended when ``until`` is None)."""

    step: int
    op: str
    pod: str
    link: int | None = None
    factor: float | None = None
    until: int | None = None

    def __post_init__(self):
        if self.op not in OPS:
            raise ValueError(f"unknown chaos op {self.op!r}; expected "
                             f"one of {OPS}")
        if self.op == OP_DEGRADE and (self.link is None or self.factor is None):
            raise ValueError("degrade needs a link index and a factor")
        if self.op in (OP_DOWN, OP_UP) and self.link is None:
            raise ValueError(f"{self.op} needs a link index")
        if self.op == OP_SLOW:
            if self.factor is None or self.factor < 1.0:
                raise ValueError(f"slow needs a factor >= 1, got {self.factor}")
        elif self.until is not None:
            raise ValueError(f"{self.op} takes no step range")
        if self.until is not None and self.until < self.step:
            raise ValueError(f"step range {self.step}-{self.until} is empty")

    def spec(self) -> str:
        """Render back to the ``--chaos`` grammar (``parse_script``'s
        inverse — the round-trip the grammar tests pin)."""
        if self.op == OP_SLOW:
            rng = f"{self.step}" + (f"-{self.until}"
                                    if self.until is not None else "")
            return f"{self.op}:{self.pod}x{self.factor:g}@{rng}"
        if self.op == OP_DEGRADE:
            return f"{self.op}:{self.pod}.{self.link}x{self.factor:g}@{self.step}"
        if self.op in (OP_DOWN, OP_UP):
            return f"{self.op}:{self.pod}.{self.link}@{self.step}"
        return f"{self.op}:{self.pod}@{self.step}"


class ChaosScript:
    """An ordered fault schedule, applied against a cluster's inventories."""

    def __init__(self, actions: list[ChaosAction]):
        self.actions = sorted(actions, key=lambda a: a.step)
        self._hangs_cleared: set[tuple[str, int]] = set()

    def at(self, step: int) -> list[ChaosAction]:
        return [a for a in self.actions if a.step == step]

    def apply(self, cluster, step: int) -> list[ChaosAction]:
        """Mutate ``cluster``'s link inventories per the actions scheduled
        at ``step``; returns the applied actions.  Raises :class:`ValueError`
        naming the offending pod when an action references one not in
        ``cluster``."""
        applied = self.at(step)
        by_name = {p.name: p for p in cluster.pods}
        for a in applied:
            pod = by_name.get(a.pod)
            if pod is None:
                raise ValueError(
                    f"chaos action {a.spec()!r} references unknown pod "
                    f"{a.pod!r}; cluster has {sorted(by_name)}")
            if a.op in (OP_SLOW, OP_HANG):
                continue    # priced faults: no link-inventory mutation
            inv = cluster.inventory(pod)
            if a.op == OP_KILL:
                for link in inv.links:
                    inv.mark_down(link.index)
            elif a.op == OP_REVIVE:
                for link in inv.links:
                    inv.mark_up(link.index)
            elif a.op == OP_DEGRADE:
                inv.mark_degraded(a.link, a.factor)
            elif a.op == OP_DOWN:
                inv.mark_down(a.link)
            else:
                inv.mark_up(a.link)
        return applied

    # -- priced gray faults (DESIGN.md §15) ---------------------------------

    def compute_factor(self, pod: str, step: int) -> float:
        """Product of ``pod``'s active ``slow`` factors at ``step`` — the
        deterministic per-pod step-time attribution the straggler ladder
        consumes (in place of real per-pod timing in this modeled
        environment)."""
        f = 1.0
        for a in self.actions:
            if (a.op == OP_SLOW and a.pod == pod and a.step <= step
                    and (a.until is None or step <= a.until)):
                f *= a.factor
        return f

    def has_hangs(self) -> bool:
        return any(a.op == OP_HANG for a in self.actions)

    def active_hangs(self, step: int) -> list[str]:
        """Pods with an injected collective stall pending at ``step``.  A
        hang persists (a wedged channel does not heal itself) until
        :meth:`clear_hangs` — the communicator-rebuild rung."""
        return [a.pod for a in self.actions
                if a.op == OP_HANG and a.step <= step
                and (a.pod, a.step) not in self._hangs_cleared]

    def clear_hangs(self, upto_step: int | None = None) -> None:
        """A communicator rebuild reset the wedged channel: injected hangs
        scheduled at or before ``upto_step`` (all, when None) stop firing."""
        for a in self.actions:
            if a.op == OP_HANG and (upto_step is None or a.step <= upto_step):
                self._hangs_cleared.add((a.pod, a.step))


def parse_script(spec: str) -> ChaosScript:
    """Parse the ``--chaos`` flag grammar into a :class:`ChaosScript`.

    Grammar (';'-separated actions)::

        kill:POD@STEP            all links of POD down at STEP
        revive:POD@STEP          all links of POD back up
        degrade:POD.LINKxFRAC@STEP   one link at FRAC of nominal bw
        down:POD.LINK@STEP       one link down
        up:POD.LINK@STEP         one link back up
        slow:PODxFACTOR@STEP[-STEP]  FACTORx compute slowdown over the
                                     (inclusive) step range; no range =
                                     sustained from STEP on
        hang:POD@STEP            collective stall at STEP (persists until
                                 the watchdog's communicator rebuild)

    Example: ``"slow:pod1x2.5@3-10;hang:pod0@12;kill:pod1@20"``.
    """
    actions = []
    for part in filter(None, (s.strip() for s in spec.split(";"))):
        try:
            head, step_s = part.rsplit("@", 1)
            op, target = head.split(":", 1)
            link, factor, until = None, None, None
            if op == OP_SLOW and "-" in step_s:
                step_s, until_s = step_s.split("-", 1)
                until = int(until_s)
            if op in (OP_DEGRADE, OP_SLOW):
                target, factor_s = target.rsplit("x", 1)
                factor = float(factor_s)
            if "." in target and op in (OP_DEGRADE, OP_DOWN, OP_UP):
                target, link_s = target.rsplit(".", 1)
                link = int(link_s)
            actions.append(ChaosAction(step=int(step_s), op=op, pod=target,
                                       link=link, factor=factor, until=until))
        except (ValueError, TypeError) as e:
            raise ValueError(f"bad chaos action {part!r}: {e}") from e
    return ChaosScript(actions)


@dataclasses.dataclass
class ElasticReport:
    """What one elastic run did: merged per-step metric history (a step
    replayed after a checkpoint fallback keeps its *latest* record),
    segment boundaries, the detector's event stream, each epoch's
    :class:`RebuildResult` and recovery method."""

    history: list[dict]
    segments: list[dict]
    events: list[PodEvent]
    rebuilds: list[RebuildResult]
    recoveries: list[recover_mod.RecoveryResult]
    final_prog: object = None   # the TrainProgram of the last epoch — the
                                # handle a caller keeps training with
    hang_events: list[HangEvent] = dataclasses.field(default_factory=list)

    @property
    def recovery_methods(self) -> list[str]:
        return [r.method for r in self.recoveries]

    @property
    def hang_actions(self) -> list[str]:
        """The watchdog's ladder walk (retry/rebuild/evict per breach)."""
        return [e.action for e in self.hang_events]


# Nominal per-unit-of-work seconds the chaos injector synthesizes per-pod
# step attributions from (only *ratios* to each pod's own frozen baseline
# matter to the quarantine ladder, so the unit is arbitrary).
BASE_STEP_S = 1.0


def run_elastic(prog, state, make_batches: Callable, *, cluster,
                ckpt_dir: str, n_steps: int, script: ChaosScript | None = None,
                train_plan=None, detector: FailureDetector | None = None,
                watchdog: CollectiveWatchdog | None = None,
                telemetry=None, bench_comm=None,
                ckpt_every: int = 50, state_bytes: float = 0.0,
                max_restarts: int = 3, backoff_base: float = 0.0):
    """Run ``n_steps`` surviving membership changes without a job restart.

    Args:
        prog: the :class:`~repro_torch.train.trainer.TrainProgram` on the
            full mesh (a ``ThreadMesh``).  ``cluster``'s pod order must
            match the mesh's "pod" axis (as
            :func:`repro_torch.launch.mesh.cluster_for_mesh` builds it).
        state: initial (or resumed) per-rank states of ``prog``.
        make_batches: ``prog -> (step -> batch)`` factory — rebuilt per
            epoch so batches match the re-planned program's layout.  Must be
            deterministic in ``step`` (the bit-exact-continuation contract).
        script: optional :class:`ChaosScript` injecting faults; omit it to
            run with detection armed but no injected failures.
        train_plan: the incumbent planner plan; enables the full
            ``replan_auto`` path on rebuild (fresh shares *and* policies).
        detector: optional preconfigured :class:`FailureDetector` (e.g.
            with a heartbeat monitor or a
            :class:`~repro_torch.elastic.quarantine.StragglerTracker`);
            defaults to link-health only — plus a straggler tracker when the
            script injects ``slow`` faults.
        watchdog: optional :class:`CollectiveWatchdog`; derived from the
            program's policy table when the script injects ``hang`` faults
            (calibrated by ``bench_comm`` when one is passed: the port
            names no default record, ``elastic.watchdog``).  Armed on the
            ``hetccl`` dispatch path for the duration of the run.
        telemetry: optional :class:`repro_torch.obs.Telemetry` bundle
            (DESIGN.md §16).  The loop installs its tracer for the run,
            subscribes its metrics to the detector's event stream, runs its
            probes between steps, and triggers its post-mortem dumps on
            chaos faults and hang escalations.
    Returns:
        ``(final_state, ElasticReport)``.
    """
    from repro_torch.core import hetccl
    from repro_torch.train import ft, trainer as trainer_mod

    if detector is None:
        straggler = None
        if script is not None and any(a.op == OP_SLOW
                                      for a in script.actions):
            from repro_torch.elastic.quarantine import StragglerTracker
            straggler = StragglerTracker()
        detector = FailureDetector(cluster, straggler=straggler)
    if watchdog is None and script is not None and script.has_hangs():
        from repro_torch.elastic.watchdog import derive_deadlines
        watchdog = CollectiveWatchdog(
            derive_deadlines(cluster, prog.comm.table, bench_comm))
    membership = Membership(cluster, train_plan=train_plan, plan=prog.plan,
                            detector=detector)
    full_mesh = prog.mesh       # entry mesh holds every pod's ranks
    by_step: dict[int, dict] = {}
    segments: list[dict] = []
    rebuilds: list[RebuildResult] = []
    recoveries: list[recover_mod.RecoveryResult] = []
    pending_plan: list[PodEvent] = []
    if watchdog is not None:
        hetccl.arm_watchdog(watchdog)
    if telemetry is not None:
        telemetry.bind(cluster=cluster, comm=prog.comm)
        detector.subscribe(telemetry.on_pod_event)
        telemetry.install()
    try:
        state, report = _elastic_loop(
            prog, state, make_batches, cluster=cluster, ckpt_dir=ckpt_dir,
            n_steps=n_steps, script=script, detector=detector,
            watchdog=watchdog, telemetry=telemetry, membership=membership,
            full_mesh=full_mesh,
            by_step=by_step, segments=segments, rebuilds=rebuilds,
            recoveries=recoveries, pending_plan=pending_plan,
            ckpt_every=ckpt_every, state_bytes=state_bytes,
            max_restarts=max_restarts, backoff_base=backoff_base,
            ft=ft, trainer_mod=trainer_mod)
    finally:
        if telemetry is not None:
            telemetry.uninstall()
        if watchdog is not None:
            hetccl.disarm_watchdog()
    return state, report


def _elastic_loop(prog, state, make_batches, *, cluster, ckpt_dir, n_steps,
                  script, detector, watchdog, telemetry, membership,
                  full_mesh, by_step,
                  segments, rebuilds, recoveries, pending_plan, ckpt_every,
                  state_bytes, max_restarts, backoff_base, ft, trainer_mod):
    step, epoch = 0, 0

    while step < n_steps:
        seg_start = step
        batches = make_batches(prog)
        # Ordered, not a set: beat/observe iteration below feeds the
        # detector's ladder, whose emission order must be deterministic
        # under same-step multi-pod faults (not hash-seed dependent).
        members = tuple(p.name for p in membership.cluster.pods)

        def seg_batches(s, _b=batches, _members=members):
            if script is not None:
                applied = script.apply(cluster, s)
                if telemetry is not None:
                    for a in applied:
                        telemetry.on_chaos(a.op, a.pod, step=s)
            events = detector.poll(step=s)
            changes = [e for e in events if e.membership_change]
            if changes:
                if any(e.kind == "pod-dead" and e.pod in _members
                       for e in changes):
                    raise PodLostError(s, changes)
                raise PodJoinSignal(s, changes)
            if pending_plan:
                raise PlanSignal(s, list(pending_plan))
            if watchdog is not None and script is not None:
                for pod in script.active_hangs(s):
                    if pod in _members:
                        ev = watchdog.stall(pod=pod, step=s)
                        raise CollectiveHangSignal(s, ev)
            return _b(s)

        def beat_all(s, _rec, _members=members):
            by_step[s] = _rec
            if watchdog is not None:
                watchdog.clear()        # the step's collectives completed
            if telemetry is not None:
                telemetry.on_step(s, _rec, dur_s=_rec.get("step_s"))
                telemetry.probe_step(s)
            if detector.heartbeat is not None:
                for name in _members:
                    detector.heartbeat.beat(name, s)
            if detector.straggler is not None:
                for name in _members:
                    f = (script.compute_factor(name, s)
                         if script is not None else 1.0)
                    ev = detector.observe_step(name, s, BASE_STEP_S * f)
                    if ev is not None and ev.plan_change:
                        pending_plan.append(ev)

        # the optimizer writes its state in place (the step donates it), so
        # the states this scope holds are the newest only through
        # ``latest``: recovery reads the post-last-completed-step states
        latest = {"state": state}

        def seg_step(st, batch, _fn=prog.step_fn):
            new_st, metrics = _fn(st, batch)
            latest["state"] = new_st
            return new_st, metrics

        try:
            state, _ = ft.run_supervised(
                seg_step, state, seg_batches, ckpt_dir=ckpt_dir,
                ckpt_every=ckpt_every, n_steps=n_steps, layout=prog,
                start_step=step, max_restarts=max_restarts,
                backoff_base=backoff_base, metrics_cb=beat_all)
            segments.append({"epoch": epoch, "start": seg_start,
                             "end": n_steps})
            step = n_steps
        except CollectiveHangSignal as sig:
            # the watchdog ladder: retry -> communicator rebuild -> evict
            state = latest["state"]
            segments.append({"epoch": epoch, "start": seg_start,
                             "end": sig.step})
            ev = sig.event
            if telemetry is not None:
                telemetry.on_hang(ev, step=sig.step)
            if ev.action == ACTION_REBUILD:
                pe = detector.emit(EVENT_COMM_REBUILD, ev.pod or "",
                                   sig.step,
                                   f"hang {ev.op}/{ev.size_class} "
                                   f"breach #{ev.breaches}",
                                   epoch=membership.epoch)
                result = membership.rebuild_in_place(pe, state_bytes)
                rebuilds.append(result)
                # same mesh, same plan: a new program is the communicator
                # rebuild (communicators bind at creation, DESIGN.md §12);
                # the states stay valid, no recovery needed
                prog = trainer_mod.rebuild_program(prog, prog.mesh,
                                                   rc=prog.rc,
                                                   plan=result.plan)
                if script is not None:
                    script.clear_hangs(sig.step)
                watchdog.clear()
                epoch = membership.epoch
                if telemetry is not None:
                    telemetry.rebind_comm(prog.comm, epoch=epoch,
                                          step=sig.step)
            elif ev.action == ACTION_EVICT and ev.pod:
                # even a fresh communicator hangs on this pod: amputate.
                # ban -> next poll classifies it dead -> the existing
                # membership path does the rest
                detector.ban(ev.pod)
            step = sig.step     # ACTION_RETRY: just re-enter at the step
            continue
        except PlanSignal as sig:
            # quarantine / reinstatement: re-weight DP shares in place
            state = latest["state"]
            segments.append({"epoch": epoch, "start": seg_start,
                             "end": sig.step})
            ev = sig.events[-1]
            if ev.epoch < membership.epoch:
                ev = dataclasses.replace(ev, epoch=membership.epoch)
            factors = (detector.straggler.replan_factors()
                       if detector.straggler is not None else {})
            result = membership.rebuild_in_place(ev, state_bytes,
                                                 factors=factors)
            rebuilds.append(result)
            rc = (result.train_plan.run_config(prog.rc)
                  if result.train_plan is not None else prog.rc)
            prog = trainer_mod.rebuild_program(prog, prog.mesh, rc=rc,
                                               plan=result.plan)
            pending_plan.clear()
            step, epoch = sig.step, membership.epoch
            if telemetry is not None:
                telemetry.rebind_comm(prog.comm, epoch=epoch, step=step)
            continue
        except MembershipSignal as sig:
            state = latest["state"]
            segments.append({"epoch": epoch, "start": seg_start,
                             "end": sig.step})
            old_members = [p.name for p in membership.cluster.pods]
            result = None
            for ev in sig.events:
                if ev.epoch < membership.epoch:
                    # same-poll concurrent event, observed before an earlier
                    # event of this batch bumped the epoch — not stale
                    ev = dataclasses.replace(ev, epoch=membership.epoch)
                r = membership.on_event(ev, state_bytes)
                result = r or result
            if result is None:      # duplicate events, nothing changed
                step = sig.step
                continue
            rebuilds.append(result)
            old_prog = prog
            new_members = [p.name for p in membership.cluster.pods]
            new_mesh = _member_mesh(full_mesh, cluster,
                                    membership.cluster.pods)
            rc = (result.train_plan.run_config(prog.rc)
                  if result.train_plan is not None else prog.rc)
            prog = trainer_mod.rebuild_program(prog, new_mesh, rc=rc,
                                               plan=result.plan)
            # the old mesh's ranks of a pod that left; their states are
            # never read, and go with the old program
            dead = [r for r in range(old_prog.mesh.size)
                    if old_members[old_prog.mesh.coords(r).get("pod", 0)]
                    not in new_members]
            rec = recover_mod.recover_state(state, sig.step, prog, dead,
                                            layout=old_prog,
                                            ckpt_dir=ckpt_dir)
            recoveries.append(rec)
            del old_prog
            state, step, epoch = rec.state, rec.step, membership.epoch
            if telemetry is not None:
                telemetry.rebind_comm(prog.comm, epoch=epoch, step=step)

    history = [by_step[s] for s in sorted(by_step)]
    return state, ElasticReport(history=history, segments=segments,
                                events=list(detector.events),
                                rebuilds=rebuilds, recoveries=recoveries,
                                final_prog=prog,
                                hang_events=(list(watchdog.events)
                                             if watchdog is not None else []))


def _member_mesh(full_mesh, full_cluster, member_pods):
    """The mesh of the current membership, carved from the *original* full
    mesh's shape on its device: one pod coordinate per member, and no "pod"
    axis for one member.  On one card every rank is a thread of this
    process, so a revived pod's ranks are new threads of the same shape."""
    from repro_torch.core.mesh import ThreadMesh
    names = {p.name for p in member_pods}
    n_pods = sum(1 for p in full_cluster.pods if p.name in names)
    shape = {a: n for a, n in full_mesh.shape.items() if a != "pod"}
    if n_pods > 1:
        shape = {"pod": n_pods, **shape}
    return ThreadMesh(shape, device=full_mesh.device)
