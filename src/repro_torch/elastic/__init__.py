"""repro_torch.elastic: pod-loss survival without a job restart (DESIGN.md
§13), plus the gray-failure ladder (DESIGN.md §15).

Counterpart of ``repro/elastic``, exporting the same names.  On one card the
ranks of a ``ThreadMesh`` stand for a pod's devices (DESIGN_TORCH.md §25).

The fault-domain control plane that closes the detect -> rebuild -> re-plan
-> recover loop in one place:

    detect.py      link health + step heartbeats -> typed PodEvents
    membership.py  epoch state machine (RUNNING -> DRAINING -> REBUILDING)
    recover.py     checkpointless ZeRO resharding from surviving replicas
    chaos.py       deterministic fault injector + the elastic run loop
    watchdog.py    model-derived collective deadlines + the hang ladder
                   (retry -> communicator rebuild -> evict)
    quarantine.py  per-pod straggler hysteresis (healthy -> suspect ->
                   quarantined -> evicted), DP de-weighting over eviction

Quick start::

    from repro_torch import elastic
    script = elastic.parse_script("slow:pod1x2.5@3-10;kill:pod1@20")
    state, report = elastic.run_elastic(
        prog, state, make_batches, cluster=cluster, script=script,
        ckpt_dir=ckpt_dir, n_steps=30, train_plan=tp)
    assert report.recovery_methods  # "checkpointless" under ZeRO-3 (no EF)
"""
from repro_torch.elastic.chaos import (ChaosAction, ChaosScript, ElasticReport,
                                       MembershipSignal, PlanSignal, PodJoinSignal,
                                       PodLostError, parse_script, run_elastic)
from repro_torch.elastic.detect import (EVENT_COMM_REBUILD, EVENT_LINK_DEGRADED,
                                        EVENT_LINK_RECOVERED, EVENT_POD_DEAD,
                                        EVENT_POD_JOINED, EVENT_POD_QUARANTINED,
                                        EVENT_POD_REINSTATED, EVENT_POD_SLOW,
                                        FailureDetector, HeartbeatMonitor, PodEvent,
                                        dead_pods)
from repro_torch.elastic.membership import (DRAINING, REBUILDING, RUNNING,
                                            Membership, MembershipError,
                                            RebuildResult)
from repro_torch.elastic.quarantine import (POD_EVICTED, POD_HEALTHY,
                                            POD_QUARANTINED, POD_SUSPECT,
                                            QuarantinePolicy, StragglerTracker,
                                            StragglerTransition)
from repro_torch.elastic.recover import (IncompleteCoverage, RecoveryResult,
                                         assemble_from_survivors, pod_devices,
                                         recover_state, survivor_mesh)
from repro_torch.elastic.watchdog import (CollectiveHangError, CollectiveHangSignal,
                                          CollectiveWatchdog, DeadlineRule,
                                          DeadlineTable, HangEvent,
                                          derive_deadlines, load_bench)

__all__ = [
    "ChaosAction", "ChaosScript", "ElasticReport", "MembershipSignal",
    "PlanSignal", "PodJoinSignal", "PodLostError", "parse_script",
    "run_elastic",
    "EVENT_COMM_REBUILD", "EVENT_LINK_DEGRADED", "EVENT_LINK_RECOVERED",
    "EVENT_POD_DEAD", "EVENT_POD_JOINED", "EVENT_POD_QUARANTINED",
    "EVENT_POD_REINSTATED", "EVENT_POD_SLOW",
    "FailureDetector", "HeartbeatMonitor", "PodEvent", "dead_pods",
    "DRAINING", "REBUILDING", "RUNNING", "Membership", "MembershipError",
    "RebuildResult",
    "POD_EVICTED", "POD_HEALTHY", "POD_QUARANTINED", "POD_SUSPECT",
    "QuarantinePolicy", "StragglerTracker", "StragglerTransition",
    "IncompleteCoverage", "RecoveryResult", "assemble_from_survivors",
    "pod_devices", "recover_state", "survivor_mesh",
    "CollectiveHangError", "CollectiveHangSignal", "CollectiveWatchdog",
    "DeadlineRule", "DeadlineTable", "HangEvent", "derive_deadlines",
    "load_bench",
]
