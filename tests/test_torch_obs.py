"""The port's telemetry plane (``repro_torch.obs``) held against the JAX
package's (``repro.obs``): the same spans and events, made with an injected
clock, give the same Chrome trace, step report, histograms, snapshot,
metric lines and flight dumps; ``modeled_spans`` agree on one table and
cluster.  Then what only the port has: a tracer shared by a ThreadMesh's
rank threads (spans nested per thread, stamped with rank and pod, grouped by
row equal to ``hetccl.dispatches``), the dispatch hooks, the probes, the
flight-dump calibration rows, and the launcher's ``--trace`` artifacts.
"""
import dataclasses
import json
import time

import numpy as np
import pytest
import torch

import repro.obs as robs
from repro.comm.policy import CommPolicy as RPolicy
from repro.core import topology as rtopo
from repro.plan.autotuner import policy_table_for as r_policy_table_for
from repro_torch import obs
from repro_torch.comm import communicator as comm_mod
from repro_torch.comm.policy import CommPolicy
from repro_torch.core import hetccl, mesh, topology
from repro_torch.plan.autotuner import policy_table_for
from repro_torch.plan.measured import flight_cells, rows_from_flight


def fake_clock(start=0.0, tick=1.0):
    state = {"t": start}

    def clock():
        state["t"] += tick
        return state["t"]
    return clock


def _scenario(o, policy_cls, topo, seed):
    """Spans and events from a seed, through package ``o``; returns every
    wire form as JSON text."""
    rng = np.random.default_rng(seed)
    fr = o.FlightRecorder(capacity=64)
    fm = o.FleetMetrics()
    tr = o.Tracer(cluster=topo.paper_cluster(), clock=fake_clock(tick=0.25),
                  sinks=(fr, fm))
    ops = ("all_reduce", "all_gather", "reduce_scatter")
    for step in range(3):
        tr.set_step(step)
        with tr.span("fwd", phase="compute"):
            for _ in range(4):
                op = ops[int(rng.integers(3))]
                nbytes = int(2 ** rng.integers(10, 26))
                pol = policy_cls(mode=("flat", "hier")[int(rng.integers(2))],
                                 backend=("xla", "pallas")[int(rng.integers(2))],
                                 n_channels=int(rng.integers(1, 4)))
                with tr.collective(op, nbytes, pol, pod=f"pod{int(rng.integers(2))}"):
                    pass
        tr.record(f"step {step}", o.CAT_STEP, float(rng.uniform(0.1, 2.0)), track="step",
                  step=step)
        fm.on_step_record(step, {"loss": float(rng.uniform(1, 5))})
        fr.on_event("epoch", epoch=step, pod="pod1", t_s=float(step))
        fm.on_epoch(step)
        fm.on_chaos("kill", "pod0")
    events = [e for e in fr.dump("x")["entries"] if e["kind"] == "event"]
    out = {
        "chrome": o.chrome_trace(tr.spans, events=events),
        "chrome_dump": o.chrome_trace(dump=fr.dump("end", step=3)),
        "report": o.step_report(tr.spans, top=5),
        "snapshot": fm.snapshot(),
        "line": o.metric_line("fleet_snapshot", labels={"arch": "smollm-135m"},
                              metrics={"snapshot": fm.snapshot()}, meta={"seed": seed}),
        "flight": o.validate_dump(fr.dump("end", step=3)),
        "hist": [(h.counts, h.n, h.sum) for h in (
            _hist(o.Histogram(), rng, seed), _hist(o.Histogram(o.RESIDUAL_EDGES), rng, seed))],
        "cells": sorted(tr.dispatched_cells()),
        "edges": (list(o.HIST_EDGES), list(o.RESIDUAL_EDGES)),
        "schemas": (o.SPAN_SCHEMA_VERSION, o.METRICS_SCHEMA_VERSION, o.METRIC_LINE_SCHEMA,
                    o.FLIGHT_SCHEMA_VERSION, o.PROBE_CLASS_BYTES),
    }
    return {k: json.dumps(v, sort_keys=True) for k, v in out.items()}


def _hist(h, rng, seed):
    for v in np.random.default_rng(seed + 1).lognormal(-4, 3, 200):
        h.observe(float(v))
    return h


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_same_spans_and_events_give_the_same_json(seed):
    want = _scenario(robs, RPolicy, rtopo, seed)
    got = _scenario(obs, CommPolicy, topology, seed)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k] == want[k], k


@pytest.mark.parametrize("cluster", ["paper", "mixed"])
def test_modeled_spans_equal_the_reference(cluster):
    if cluster == "paper":
        cl, rcl = topology.paper_cluster(), rtopo.paper_cluster()
    else:
        cl, rcl = topology.tpu_mixed_fleet(2, 2, 2), rtopo.tpu_mixed_fleet(2, 2, 2)
    got = obs.modeled_spans(policy_table_for(cl), cl, step=3)
    want = robs.modeled_spans(r_policy_table_for(rcl), rcl, step=3)
    assert got and json.dumps(got, sort_keys=True) == json.dumps(want, sort_keys=True)


def test_metric_line_file_roundtrip_reads_like_the_reference(tmp_path):
    p = tmp_path / "m.jsonl"
    obs.append_metric_line(p, obs.metric_line("dryrun_cell", labels={"arch": "a"},
                                              metrics={"compute_s": 0.5}))
    assert obs.read_metric_lines(p) == robs.read_metric_lines(p)


# ------------------------------------------------------- the tracer under threads

def _tracer_run(fn, shape=None, cluster=None, tracer=None):
    tr = tracer or obs.Tracer(cluster=cluster)
    hetccl.reset_dispatches()
    hetccl.install_tracer(tr)
    try:
        m = mesh.ThreadMesh(shape or {"pod": 2, "data": 2}, device="cpu")
        outs = m.run(fn, list(range(m.size)))
    finally:
        hetccl.uninstall_tracer()
    return tr, outs


def test_spans_nest_on_their_own_rank_thread():
    cfg = hetccl.HetCCLConfig(mode="hier", backend="pallas")

    def body(r):
        tr = hetccl.current_tracer()
        with tr.span(f"rank {r} phase"):
            time.sleep(0.01 * (r % 2))          # interleave the ranks' spans
            hetccl.all_reduce(torch.full((40, 3), float(r)), cfg)
            hetccl.all_gather(torch.full((8,), float(r)), cfg)
        return tr.open_depth

    tr, depths = _tracer_run(body)
    assert depths == [0, 0, 0, 0]
    by_id = {s.id: s for s in tr.spans}
    coll = tr.collective_spans()
    assert len(coll) == 8
    for s in coll:
        parent = by_id[s.parent]
        assert parent.name == f"rank {s.tags['rank']} phase"
        assert parent.tags["rank"] == s.tags["rank"] and s.depth == 1
        assert s.pod == f"pod{s.tags['rank'] // 2}" == parent.pod
    assert tr.dispatch_rows() == hetccl.dispatches
    assert len({s.id for s in tr.spans}) == len(tr.spans)


def test_train_step_spans_equal_dispatches_row_for_row():
    from repro_torch.configs import get_config
    from repro_torch.configs.base import RunConfig
    from repro_torch.core.balance import uniform_plan
    from repro_torch.data.pipeline import DataPipeline
    from repro_torch.models import build
    from repro_torch.train.trainer import make_train_program

    cfg = get_config("smollm-135m").reduced()
    m = mesh.ThreadMesh({"pod": 2, "data": 2}, device="cpu")
    cluster = topology.paper_cluster()
    rc = RunConfig(zero_stage=3, learning_rate=1e-3, param_dtype="float32",
                   wire_quant="int8",
                   policies=policy_table_for(cluster, bucket_bytes=1 << 20, zero_stage=3))
    prog = make_train_program(build(cfg), m, rc, uniform_plan(2, 4, 1))
    state = prog.init_fn()
    batch = DataPipeline(seed=0, plan=prog.plan, dp_world=prog.dp_world(), seq_len=32,
                         vocab=cfg.vocab).batch_at(0)
    tr = obs.Tracer(cluster=cluster)
    hetccl.reset_dispatches()
    hetccl.install_tracer(tr)
    try:
        prog.step_fn(state, batch)
    finally:
        hetccl.uninstall_tracer()
    rows = tr.dispatch_rows()
    assert rows == hetccl.dispatches and sum(rows.values()) > 20
    spans = tr.collective_spans()
    assert {s.tags["rank"] for s in spans} == {0, 1, 2, 3}
    assert all(s.modeled_s and s.modeled_s > 0 for s in spans)
    # the class a span carries is the one its call was dispatched under
    assert all(s.tags["size_class"] == s.row[1] for s in spans)


# ------------------------------------------------------------------ the hooks

def test_install_tracer_is_stack_safe_and_pinned_tracer_wins():
    t1, t2 = obs.Tracer(), obs.Tracer()
    hetccl.install_tracer(t1)
    hetccl.install_tracer(t2)
    assert hetccl.current_tracer() is t2
    hetccl.uninstall_tracer()
    assert hetccl.current_tracer() is t1
    hetccl.uninstall_tracer()
    assert hetccl.current_tracer() is None
    pinned = obs.Tracer()
    c = dataclasses.replace(comm_mod.create((), None), tracer=pinned)
    assert c == comm_mod.create((), None)        # an observer, not identity
    installed = obs.Tracer()
    _tracer_run(lambda r: hetccl.all_reduce(torch.ones(16), c), {"data": 1},
                tracer=installed)
    assert len(pinned.collective_spans()) == 1 and installed.spans == []


def test_disabled_tracer_overhead_near_zero():
    c = comm_mod.create((), None)
    m = mesh.ThreadMesh({"data": 1}, device="cpu")
    x = torch.ones(16)

    def median_dispatch_s(_):
        ts = []
        for _ in range(60):
            t0 = time.perf_counter()
            hetccl.all_reduce(x, c)
            ts.append(time.perf_counter() - t0)
        return sorted(ts)[len(ts) // 2]

    base = m.run(median_dispatch_s, [0])[0]
    tr = obs.Tracer(enabled=False)
    hetccl.install_tracer(tr)
    try:
        disabled = m.run(median_dispatch_s, [0])[0]
    finally:
        hetccl.uninstall_tracer()
    assert tr.spans == []
    assert disabled < max(base * 3.0, base + 100e-6)


# ------------------------------------------------- probes and calibration rows

def test_probes_cover_the_table_and_flight_rows_cover_dispatched_cells():
    cluster = topology.tpu_mixed_fleet(2, 2, 2)
    table = policy_table_for(cluster)
    tel = obs.Telemetry(cluster=cluster, device="cpu")
    c = comm_mod.create((), None, table=table)
    tel.bind(comm=c)
    with tel:
        n = tel.probe_step(0)
        assert obs.active() is tel
    assert obs.active() is None
    assert n == len(obs.probe_cells(c))
    spans = tel.tracer.collective_spans()
    assert {(s.tags["op"], s.tags["size_class"]) for s in spans} == \
        {(op, cls) for (op, cls), _ in table.rows if op != "all_to_all"}
    assert all(s.tags.get("probe") for s in spans)
    dump = obs.validate_dump(tel.flight.dump("test"))
    rows = rows_from_flight(dump)
    assert rows and set(flight_cells(rows)) == tel.tracer.dispatched_cells()
    assert all(r.measured_s > 0 and r.modeled_s > 0 for r in rows)


def test_launcher_trace_writes_every_artifact(tmp_path, capsys):
    from repro_torch.launch import train
    out = train.run(train.parser().parse_args([
        "--device", "cpu", "--steps", "2", "--seq", "32", "--trace", str(tmp_path / "tr"),
        "--metrics-out", str(tmp_path / "m.jsonl"), "--ckpt-every", "1"]))
    tel = out["telemetry"]
    assert tel is not None and len(out["history"]) == 2
    obs.load_chrome_trace(tmp_path / "tr" / "trace.json")
    snap = json.loads((tmp_path / "tr" / "metrics.json").read_text())
    assert snap == tel.snapshot()
    steps = [c for c in snap["counters"] if c["name"] == "steps_total"]
    assert steps and steps[0]["value"] == 2
    assert "collective time share" in (tmp_path / "tr" / "report.txt").read_text()
    (line,) = obs.read_metric_lines(tmp_path / "m.jsonl")
    assert line["kind"] == "fleet_snapshot"
    (dump_path,) = tel.dump_paths
    dump = obs.load_dump(dump_path)
    assert dump["dropped"] == 0
    assert set(flight_cells(rows_from_flight(dump))) == tel.tracer.dispatched_cells()
    # the step's own dispatches are stamped with the step they ran in
    in_step = [s for s in tel.tracer.collective_spans() if not s.tags.get("probe")]
    assert {s.step for s in in_step} == {0, 1}
    printed = capsys.readouterr().out
    assert "telemetry trace:" in printed and "done: loss" in printed
