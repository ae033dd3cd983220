"""The port's elastic control plane (``repro_torch.elastic``) held against the
JAX package's (``repro.elastic``) on the same inputs: the chaos grammar,
the failure detector and heartbeats, the straggler ladder, membership epochs
and their modeled prices, the derived deadlines and the hang ladder.  Every
module here is pure logic (injectable clocks, synthesized observations), so
the two packages must agree exactly: events field for field, plans share for
share, and every modeled time to a relative 1e-12 (the port's simulator is
held to the reference's to that in ``test_torch_plan.py``).

Last, the port's dispatch hook (``hetccl.arm_watchdog``) on a 4-rank CPU
``ThreadMesh``: one slow eager collective is one breach, not one per rank
thread, and a train step's own dispatches pass unwatched (DESIGN_TORCH.md
§25).
"""
import dataclasses
import json
import math
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import comm as ref_comm  # noqa: E402
from repro import elastic as ref  # noqa: E402
from repro.core import balance as ref_balance  # noqa: E402
from repro.plan import autotuner as ref_autotuner  # noqa: E402
from repro.plan import measured as ref_measured  # noqa: E402
from repro_torch import comm as port_comm  # noqa: E402
from repro_torch import elastic as port  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import RunConfig  # noqa: E402
from repro_torch.core import balance as port_balance  # noqa: E402
from repro_torch.core import hetccl, mesh  # noqa: E402
from repro_torch.data.pipeline import DataPipeline  # noqa: E402
from repro_torch.elastic import watchdog as port_wd  # noqa: E402
from repro_torch.models import build  # noqa: E402
from repro_torch.plan import autotuner as port_autotuner  # noqa: E402
from repro_torch.plan import measured as port_measured  # noqa: E402
from repro_torch.train.trainer import make_train_program  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# (elastic, bench_cluster, policy_table_for, balance, comm) of each package
PKGS = {"ref": (ref, ref_measured.bench_cluster, ref_autotuner.policy_table_for, ref_balance,
                ref_comm),
        "port": (port, port_measured.bench_cluster, port_autotuner.policy_table_for,
                 port_balance, port_comm)}
REL = 1e-12


def both(fn):
    """``fn`` run on each package's modules: ``(reference's, port's)``."""
    return fn(*PKGS["ref"]), fn(*PKGS["port"])


def _ev(e):
    return (e.kind, e.pod, e.step, e.detail, e.epoch, e.seq)


# ---------------------------------------------------------------------------
# The chaos grammar
# ---------------------------------------------------------------------------

SPECS = ["kill:pod1@4", "revive:pod1@8", "degrade:pod0.1x0.25@2", "down:pod0.0@6",
         "up:pod0.0@7", "slow:pod1x2.5@3-10", "slow:pod0x1.5@12", "hang:pod1@14"]


def test_parse_script_round_trips_every_op_like_the_reference():
    def parsed(el, *_):
        s = el.parse_script(";".join(SPECS))
        return ([(a.step, a.op, a.pod, a.link, a.factor, a.until) for a in s.actions],
                sorted(a.spec() for a in s.actions),
                el.parse_script(";".join(a.spec() for a in s.actions)).actions == s.actions)
    want, got = both(parsed)
    assert got == want
    assert got[1] == sorted(SPECS) and got[2]


@pytest.mark.parametrize("bad", ["explode:pod0@1", "degrade:pod0@1", "slow:pod0@1",
                                 "slow:pod0x0.5@1", "kill:pod0@x", "down:pod0@3"])
def test_parse_script_refuses_what_the_reference_refuses(bad):
    for pkg in ("ref", "port"):
        with pytest.raises(ValueError):
            PKGS[pkg][0].parse_script(bad)


def test_chaos_action_checks_and_windows_match():
    def run(el, bench_cluster, *_):
        errs = []
        for kw in (dict(op="slow"), dict(op="slow", factor=0.5), dict(op="kill", until=4),
                   dict(op="slow", factor=2.0, step=5, until=3)):
            kw = {"step": 1, "pod": "pod0", **kw}
            try:
                el.ChaosAction(**kw)
                errs.append(None)
            except ValueError as e:
                errs.append(str(e))
        s = el.parse_script("slow:pod1x2@3-5;slow:pod1x3@5-6;slow:pod0x4@8;hang:pod1@4")
        factors = [(p, t, s.compute_factor(p, t)) for p in ("pod0", "pod1") for t in range(10)]
        hangs = [s.active_hangs(t) for t in range(3, 7)]
        s.clear_hangs(4)
        cluster = bench_cluster(2, 2)
        s.apply(cluster, 3)
        with pytest.raises(ValueError, match="podX"):
            el.parse_script("kill:podX@0").apply(cluster, 0)
        return errs, factors, hangs, s.active_hangs(9), \
            cluster.inventory(cluster.pods[1]).n_healthy()
    want, got = both(run)
    assert got == want
    assert got[0][0] is not None and got[2] == [[], ["pod1"], ["pod1"], ["pod1"]]


# ---------------------------------------------------------------------------
# Failure detection and heartbeats
# ---------------------------------------------------------------------------

def test_heartbeat_monitor_matches_the_reference():
    def run(el, *_):
        t = {"now": 0.0}
        hb = el.HeartbeatMonitor(timeout_s=10.0, grace_s=5.0, clock=lambda: t["now"])
        seen = [hb.expired("p0")]
        hb.register("p0")
        for now, beat in ((14.0, None), (15.0, None), (15.0 + 1e-9, None), (16.0, 3),
                          (25.0, None), (26.1, None), (30.0, "register"), (35.0, None),
                          (35.5, None), (36.0, 4), (45.0, None), (46.5, None)):
            t["now"] = now
            if beat == "register":
                hb.register("p0")
            elif beat is not None:
                hb.beat("p0", beat)
            seen.append((now, hb.expired("p0"), hb.last_step("p0")))
        return seen
    want, got = both(run)
    assert got == want
    assert [e[1] for e in got[1:4]] == [False, False, True]


def _detector_script(el, bench_cluster, *_):
    """One detector over a scripted fleet: link faults, heartbeats, straggler
    samples, a ban and an external join; every emitted event."""
    cluster = bench_cluster(3, 2)
    t = {"now": 0.0}
    hb = el.HeartbeatMonitor(timeout_s=10.0, grace_s=0.0, clock=lambda: t["now"])
    det = el.FailureDetector(cluster, heartbeat=hb, straggler=el.StragglerTracker())
    log = []
    det.subscribe(lambda e: log.append(_ev(e)))
    inv = [cluster.inventory(p) for p in cluster.pods]
    for step in range(14):
        t["now"] = 3.0 * step
        for p in cluster.pods:
            if not (p.name == "pod2" and 3 <= step < 9):     # pod2 stalls a while
                hb.beat(p.name, step)
        if step == 1:
            inv[0].mark_degraded(1, 0.25)
        if step == 2:
            inv[0].mark_up(1)
        if step == 4:
            for link in inv[1].links:
                inv[1].mark_down(link.index)
        if step == 6:
            for link in inv[1].links:
                inv[1].mark_up(link.index)
        if step == 7:
            det.epoch = 1
        for p in cluster.pods:                  # pod0 runs 2x slow from step 3
            det.observe_step(p.name, step, 2.0 if p.name == "pod0" and step >= 3 else 1.0)
        if step == 11:
            det.ban("pod0")
        if step == 13:
            det.unban("pod0")
        det.poll(step=step)
    det.notice_join("pod9", step=14)
    return log, [_ev(e) for e in det.events], el.dead_pods(det.events)


def test_failure_detector_emits_the_reference_events():
    want, got = both(_detector_script)
    assert got == want
    kinds = [e[0] for e in got[0]]
    for k in ("link-degraded", "link-recovered", "pod-dead", "pod-joined", "pod-slow",
              "pod-quarantined"):
        assert k in kinds, k
    assert [e[5] for e in got[0]] == list(range(len(got[0])))       # seq: emission order


# ---------------------------------------------------------------------------
# The straggler ladder
# ---------------------------------------------------------------------------

def _sample_stream(seed=7, n=160):
    """Per-step (pod, seconds) samples: regimes of healthy, slow, gray-band,
    extreme and recovered step times for three pods, jittered."""
    rs = np.random.RandomState(seed)
    out = []
    for step in range(n):
        for pod, base in (("pod0", 1.0), ("pod1", 2.5), ("pod2", 0.4)):
            phase = (step // 12 + {"pod0": 0, "pod1": 3, "pod2": 5}[pod]) % 7
            mult = (1.0, 1.3, 2.2, 1.05, 1.4, 9.5, 1.0)[phase]
            out.append((pod, step, base * mult * (1.0 + 0.02 * rs.randn())))
    return out


def test_straggler_tracker_walks_the_reference_ladder():
    def run(el, *_):
        tr = el.StragglerTracker(el.QuarantinePolicy(reinstate_after=3, flap_penalty=2))
        edges = [tr.observe(p, s, x) for p, s, x in _sample_stream()]
        return ([None if e is None else dataclasses.astuple(e) for e in edges],
                {p: (tr.state(p), tr.ratio(p)) for p in ("pod0", "pod1", "pod2")},
                tr.replan_factors(), tr.quarantined())
    want, got = both(run)
    assert got == want
    seen = {e[3] for e in got[0] if e is not None}
    assert {"suspect", "quarantined", "healthy"} <= seen, seen


def test_quarantine_policy_checks_match():
    for el, *_ in PKGS.values():
        with pytest.raises(ValueError, match="clear_ratio"):
            el.QuarantinePolicy(clear_ratio=2.0)
        with pytest.raises(ValueError, match="seconds"):
            el.StragglerTracker().observe("pod1", 0, 0.0)


# ---------------------------------------------------------------------------
# Membership epochs
# ---------------------------------------------------------------------------

def _result(r):
    return ([p.name for p in r.cluster.pods], r.plan.micro_per_pod, r.plan.total_micro,
            r.epoch, r.event.kind, r.event.pod, r.pod_axis, r.state_bytes,
            r.modeled_checkpointless_s, r.modeled_checkpoint_s,
            None if r.train_plan is None else (r.train_plan.mode, r.train_plan.backend,
                                               r.train_plan.n_channels,
                                               r.train_plan.bucket_bytes))


def _same_results(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g[:8] == w[:8] and g[10] == w[10]
        for a, b in zip(g[8:10], w[8:10]):
            assert a == pytest.approx(b, rel=REL)


def _membership_walk(el, bench_cluster, _table, balance, _comm, planned):
    cluster = bench_cluster(3, 2)
    det = el.FailureDetector(cluster)
    kw = {"plan": balance.uniform_plan(3, 6, 1)}
    if planned:
        from importlib import import_module
        plan_mod = import_module(el.__name__.split(".")[0] + ".plan")
        cfg_mod = import_module(el.__name__.split(".")[0] + ".configs")
        req = plan_mod.plan_request(cluster, cfg_mod.get_config("smollm-135m").reduced(),
                                    global_batch=12, seq_len=64, data_axis=2, zero_stage=1)
        kw = {"train_plan": plan_mod.autotune(req)}
    m = el.Membership(cluster, detector=det, **kw)
    cluster.inventory(cluster.pods[0]).mark_degraded(1, 0.5)
    PodEvent = el.PodEvent
    out, errs = [], []
    assert m.on_event(PodEvent("link-degraded", "pod0", 0, 1)) is None
    out.append(m.on_event(PodEvent("pod-dead", "pod2", 0, 3), state_bytes=4e9))
    out.append(m.rebuild_in_place(PodEvent("pod-quarantined", "pod1", 1, 5),
                                  state_bytes=4e9, factors={"pod1": 2.5}))
    out.append(m.rebuild_in_place(PodEvent("comm-rebuild", "pod0", 2, 6), state_bytes=1e6))
    out.append(m.on_event(PodEvent("pod-joined", "pod2", 3, 8), state_bytes=2e9))
    out.append(m.rebuild_in_place(PodEvent("pod-reinstated", "pod1", 4, 9), factors={}))
    assert m.on_event(PodEvent("pod-joined", "pod2", 5, 10)) is None     # duplicate
    for ev in (PodEvent("pod-dead", "pod0", 1, 11), PodEvent("pod-joined", "pod7", 5, 11)):
        try:
            m.on_event(ev)
        except el.MembershipError as e:
            errs.append(type(e).__name__)
    inv = out[0].cluster.inventory(out[0].cluster.pods[0])
    return ([_result(r) for r in out], [s for _, s in m.transitions], m.epoch, det.epoch,
            errs, inv.health(1).bw_fraction)


@pytest.mark.parametrize("planned", [False, True], ids=["shares-only", "replan-auto"])
def test_membership_epochs_match_the_reference(planned):
    want, got = both(lambda *p: _membership_walk(*p, planned))
    _same_results(got[0], want[0])
    assert got[1:] == want[1:]
    results, transitions, epoch, det_epoch, errs, bw = got
    assert epoch == det_epoch == 5 and errs == ["MembershipError", "MembershipError"]
    assert bw == 0.5                                 # survivor health carried over
    assert results[0][0] == ["pod0", "pod1"] and results[3][0] == ["pod0", "pod1", "pod2"]
    assert transitions[:4] == ["RUNNING", "DRAINING", "REBUILDING", "RUNNING"]
    if not planned:
        assert results[1][1] == (4, 2)               # de-weighted off the straggler
        assert results[4][1] == (2, 2, 2)            # reinstated: base profiles


def test_rebuild_in_place_prices_and_fences_like_the_reference():
    def run(el, bench_cluster, _t, balance, *_):
        cluster = bench_cluster(2, 2)
        m = el.Membership(cluster, plan=balance.uniform_plan(2, 6, 1),
                          detector=el.FailureDetector(cluster))
        stale = el.PodEvent(kind="comm-rebuild", pod="pod1", epoch=0, step=5)
        r = m.rebuild_in_place(stale, state_bytes=3e8)
        fenced = []
        for call in (lambda: m.rebuild_in_place(stale),
                     lambda: m.on_event(el.PodEvent("pod-dead", "pod1", 0, 6))):
            with pytest.raises(el.MembershipError, match="stale"):
                call()
            fenced.append(True)
        return [_result(r)], fenced, r.plan is m.plan
    want, got = both(run)
    _same_results(got[0], want[0])
    assert got[1:] == want[1:] == ([True, True], True)


# ---------------------------------------------------------------------------
# Derived deadlines and the hang ladder
# ---------------------------------------------------------------------------

def _rows(dt):
    return [(r.op, r.size_class, r.backend, r.modeled_s, r.scale, r.noise,
             r.measured_median_s, r.deadline_s, r.wire_quant) for r in dt.rows]


def _same_rows(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g[:3] == w[:3] and g[8] == w[8]
        assert g[6] == w[6] if w[6] is None else g[6] == pytest.approx(w[6], rel=REL)
        for a, b in zip(g[3:6] + (g[7],), w[3:6] + (w[7],)):
            assert a == pytest.approx(b, rel=REL)


BENCH = json.loads((ROOT / "BENCH_comm.json").read_text())


@pytest.mark.parametrize("table", ["planner", "facade"])
@pytest.mark.parametrize("record", [None, "BENCH_comm.json"])
def test_derive_deadlines_match_the_reference_row_by_row(table, record):
    """The committed bench record is fed to both packages as data (it
    describes the JAX package's CPU runs; the port's launcher derives its
    deadlines with no record)."""
    bench = BENCH if record else None

    def run(el, bench_cluster, table_for, _b, comm_mod):
        cluster = (ref_measured._record_cluster(bench) if bench and el is ref else
                   port_measured._record_cluster(bench) if bench else bench_cluster(2, 2))
        tab = table_for(cluster) if table == "planner" else comm_mod.create(("data",), None).table
        dt = el.derive_deadlines(cluster, tab, bench, tolerance=3.0)
        return _rows(dt), dt.missing_rows(tab), dt.representative().op
    want, got = both(run)
    _same_rows(got[0], want[0])
    assert got[1:] == want[1:] and got[1] == []
    if bench is None:
        assert all(r[4] == r[5] == 1.0 and r[7] == pytest.approx(r[3] * 3.0) for r in got[0])
    else:
        assert any(r[6] is not None for r in got[0])


def test_communicator_deadline_table_is_derive_deadlines():
    cluster = port_measured.bench_cluster(2, 2)
    c = port_comm.create(("data",), "pod", table=port_autotuner.policy_table_for(cluster))
    assert _rows(c.deadline_table(cluster)) == _rows(port.derive_deadlines(cluster, c.table))
    assert c.deadline_table(cluster, tolerance=2.0).tolerance == 2.0


def test_load_bench_reads_only_the_named_record(tmp_path):
    assert port.load_bench(str(tmp_path / "none.json")) is None
    assert port.load_bench(str(ROOT / "BENCH_comm.json")) == BENCH
    with pytest.raises(TypeError):
        port.load_bench()                 # no default record


def test_hang_ladder_walks_like_the_reference():
    def run(el, bench_cluster, table_for, *_):
        cluster = bench_cluster(2, 2)
        dt = el.derive_deadlines(cluster, table_for(cluster))
        t = {"now": 0.0}
        wd = el.CollectiveWatchdog(dt, max_retries=2, clock=lambda: t["now"])
        rule = dt.lookup("all_reduce", cls="large")
        walk = [wd.observe("all_reduce", 64 << 20, rule.deadline_s * 0.5)]
        walk += [wd.observe("all_reduce", 64 << 20, rule.deadline_s * 2) for _ in range(4)]
        wd.clear()
        walk.append(wd.stall(pod="pod1", step=7))
        walk.append(wd.stall(pod="pod1", step=7, op="all_gather"))
        small = dt.lookup("all_gather", cls="small")
        with wd.watch("all_gather", 1024):
            t["now"] += small.deadline_s * 0.1
        try:
            with wd.watch("all_gather", 1024, step=3, pod="pod0"):
                t["now"] += small.deadline_s * 2
        except el.CollectiveHangError as e:
            walk.append(e.event)
        with pytest.raises(ValueError, match="max_retries"):
            el.CollectiveWatchdog(dt, max_retries=-1)
        return [None if e is None else dataclasses.astuple(e) for e in walk], \
            [dataclasses.astuple(e) for e in wd.events]
    want, got = both(run)
    assert len(got[0]) == len(want[0]) and len(got[1]) == len(want[1])
    for g, w in zip(got[0] + got[1], want[0] + want[1]):
        if g is None or w is None:
            assert g is w
            continue
        assert g[:5] == w[:5] and g[7:] == w[7:]
        assert g[5] == pytest.approx(w[5], rel=REL)
        assert g[6] == w[6] or g[6] == pytest.approx(w[6], rel=REL)
    # the in-deadline watch cleared the incident: the last breach retries
    assert [e[-1] for e in got[1]] == ["retry", "retry", "rebuild", "evict", "retry",
                                       "retry", "retry"] and math.isinf(got[0][5][6])


# ---------------------------------------------------------------------------
# The dispatch hook on a CPU ThreadMesh
# ---------------------------------------------------------------------------

def _table_with(deadline_s: float):
    cluster = port_measured.bench_cluster(2, 2)
    dt = port.derive_deadlines(cluster, port_autotuner.policy_table_for(cluster))
    return dataclasses.replace(dt, rows=tuple(dataclasses.replace(r, deadline_s=deadline_s)
                                              for r in dt.rows))


@pytest.fixture
def slow_dispatch(monkeypatch):
    """Every rank's dispatch sleeps ``delay["s"]`` before the collective."""
    real = hetccl.tacc.dispatch
    delay = {"s": 0.0}

    def slow(*a, **kw):
        time.sleep(delay["s"])
        return real(*a, **kw)
    monkeypatch.setattr(hetccl.tacc, "dispatch", slow)
    return delay


@pytest.mark.parametrize("op", ["all_reduce", "all_gather", "reduce_scatter"])
def test_one_slow_collective_on_four_rank_threads_is_one_breach(slow_dispatch, op):
    m = mesh.ThreadMesh({"pod": 2, "data": 2}, device="cpu")
    cfg = hetccl.HetCCLConfig(mode="hier", backend="pallas")
    wd = port.CollectiveWatchdog(_table_with(0.02))
    xs = [torch.full((8, 3), float(r)) for r in range(4)]
    slow_dispatch["s"] = 0.2
    hetccl.arm_watchdog(wd)
    try:
        with pytest.raises(port.CollectiveHangError) as ei:
            m.run(lambda v: getattr(hetccl, op)(v, cfg), xs)
        assert [e.action for e in wd.events] == ["retry"] and wd.breaches == 1
        assert ei.value.event is wd.events[0] and ei.value.event.op == op
        assert ei.value.event.elapsed_s >= 0.2
        # an in-deadline collective completes and clears the incident
        wd.deadlines = _table_with(60.0)
        slow_dispatch["s"] = 0.0
        outs = m.run(lambda v: getattr(hetccl, op)(v, cfg), xs)
        assert len(outs) == 4 and wd.breaches == 0 and len(wd.events) == 1
    finally:
        hetccl.disarm_watchdog()
    # disarmed: the slow collective goes unwatched
    slow_dispatch["s"] = 0.05
    assert len(m.run(lambda v: getattr(hetccl, op)(v, cfg), xs)) == 4
    assert len(wd.events) == 1


def test_a_train_step_is_unwatched_and_probes_disarm(tmp_path):
    """A zero-deadline table armed around a train step raises nothing: the
    step's dispatches pass unwatched (the reference's traced dispatches);
    the same table breaches on a direct collective on the mesh, and the
    telemetry probes disarm the watchdog around their own dispatches."""
    from repro_torch import obs
    cfg = get_config("smollm-135m").reduced()
    m = mesh.ThreadMesh({"pod": 2, "data": 2}, device="cpu")
    prog = make_train_program(build(cfg), m, RunConfig(zero_stage=3, collective_mode="hier",
                                                       backend="pallas",
                                                       param_dtype="float32"),
                              port_balance.uniform_plan(2, 2, 1))
    wd = port.CollectiveWatchdog(_table_with(0.0))
    hetccl.arm_watchdog(wd)
    try:
        state = prog.init_fn(generator=torch.Generator().manual_seed(0))
        batch = DataPipeline(seed=0, plan=prog.plan, dp_world=prog.dp_world(), seq_len=16,
                             vocab=cfg.vocab).batch_at(0)
        state, met = prog.step_fn(state, batch)
        assert np.isfinite(met["loss"].item()) and wd.events == []
        tel = obs.Telemetry(cluster=port_measured.bench_cluster(2, 2), device="cpu")
        tel.bind(comm=prog.comm)
        assert tel.probe_step(0) > 0 and wd.events == []
        assert hetccl.armed_watchdog() is wd
        with pytest.raises(port.CollectiveHangError):
            m.run(lambda v: hetccl.all_reduce(v, prog.comm), [torch.ones(4)] * 4)
        assert [e.action for e in wd.events] == ["retry"]
    finally:
        hetccl.disarm_watchdog()
    assert port_wd.CollectiveWatchdog is port.CollectiveWatchdog


def test_watchdog_counter_survives_concurrent_breaches():
    """The rank threads and the run loop share one watchdog: breaches from
    many threads at once (more threads than cores, a short switch
    interval) are each counted once, numbered 1..N with no lost update."""
    import sys
    import threading
    wd = port.CollectiveWatchdog(_table_with(1e-3), max_retries=10**6)
    n_threads, per = 32, 200
    start = threading.Barrier(n_threads)

    def breach():
        start.wait(10)
        for _ in range(per):
            wd.observe("all_reduce", 1 << 20, 1.0)

    prev = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=breach) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(prev)
    assert wd.breaches == len(wd.events) == n_threads * per
    assert sorted(e.breaches for e in wd.events) == list(range(1, n_threads * per + 1))
