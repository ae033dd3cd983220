"""The port's α-β simulator, plan autotuner, refinement and measured
calibration against the JAX package's (``repro.core.simulator``,
``repro.plan``), the launcher's ``--plan`` / ``--policy`` / ``--stripes``,
training on the planner's table and uneven shares against the JAX trainer,
and a bf16 ``cross_dtype`` run against its f32-accumulate oracle (ROADMAP
A5b).

The planner modules are jax-free copies of one another, so the simulator is
held to the reference to 1e-12 relative over a grid of op x bytes x mode x
backend x channels x stripes x codec on five clusters, and the planner's
frontiers, choices, shares, table rows and modeled times exactly.  Whole
training steps use ``tests/test_torch_train.py``'s tolerances (its module
note says why): step 0 within 1e-5, losses within 1e-2 over 3 steps, the
parameters within a relative L2 of 1e-2 (an int8 parameter all-gather).
"""
import dataclasses
import importlib
import importlib.util
import types
from collections import Counter
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import plan as jax_plan  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs.base import RunConfig as JaxRunConfig  # noqa: E402
from repro.core import balance as jax_balance  # noqa: E402
from repro.core import simulator as jax_sim  # noqa: E402
from repro.core import topology as jax_topology  # noqa: E402
from repro.launch import mesh as jax_launch_mesh  # noqa: E402
from repro.models import build as jax_build  # noqa: E402
from repro.train.trainer import make_train_program as jax_make_train_program  # noqa: E402
from repro_torch import plan  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import RunConfig  # noqa: E402
from repro_torch.convert import params_from_jax, unshard_params  # noqa: E402
from repro_torch.core import balance, collectives, hetccl, mesh, tacc  # noqa: E402
from repro_torch.core import simulator as sim, topology  # noqa: E402
from repro_torch.core.tree import leaves  # noqa: E402
from repro_torch.data import pipeline  # noqa: E402
from repro_torch.kernels import ring_dma  # noqa: E402
from repro_torch.launch import mesh as launch_mesh  # noqa: E402
from repro_torch.launch import train as launcher  # noqa: E402
from repro_torch.models import build  # noqa: E402
from repro_torch.train import optim  # noqa: E402
from repro_torch.train.trainer import make_train_program  # noqa: E402

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(smoke)

REL = 1e-12


def _close(a, b) -> bool:
    return a == b or abs(a - b) <= REL * max(abs(a), abs(b))


def _clusters(topo):
    """Five clusters, built by ``topo``'s package: the paper's testbed, the
    v5e multi-pod, the mixed fleet, two H100 islands, and a v5e pair whose
    slower island has a link down and one degraded."""
    degraded = topo.tpu_multipod(2, 8)
    degraded.inventory("pod1").mark_down(0)
    degraded.inventory("pod1").mark_degraded(2, 0.5)
    return {"paper": topo.paper_cluster(4, 4),
            "v5e_multipod": topo.tpu_multipod(4, 16),
            "mixed_fleet": topo.tpu_mixed_fleet(2, 2, 8),
            "h100": topo.ClusterSpec(tuple(topo.PodSpec(f"pod{i}", topo.H100_NVLINK, 4)
                                           for i in range(2))),
            "v5e_degraded": degraded}


OPS = ("all_reduce", "all_gather", "reduce_scatter", "broadcast", "reduce", "all_to_all")
BYTES = (4096.0, 3 * 2**20 + 5.0, 96 * 2**20)


# ---------------------------------------------------------------------------
# (a) the simulator
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["paper", "v5e_multipod", "mixed_fleet", "h100", "v5e_degraded"])
def test_simulator_matches_the_reference(name):
    """Every simulator function on a grid over one cluster, to 1e-12
    relative: each collective under each (mode, backend, channels, stripes,
    codec), exact-C pipelines, MPI and point-to-point, policy-table
    pricing, the bucketed and ZeRO-3 traffic, whole steps, rebuilds,
    throughput, balanced plans and the efficiency figure."""
    c, jc = _clusters(topology)[name], _clusters(jax_topology)[name]
    n = 0
    for op in OPS:
        for nb in BYTES:
            for mode in ("auto", "flat", "hier", "pipelined"):
                for backend in ("xla", "pallas"):
                    for ch in (1, 4):
                        for k in (1, 4, "auto"):
                            for q in (None, "int8"):
                                kw = dict(n_channels=ch, backend=backend, n_stripes=k,
                                          wire_quant=q)
                                a = sim.collective_time(op, nb, c, mode, **kw)
                                b = jax_sim.collective_time(op, nb, jc, mode, **kw)
                                assert _close(a, b), (op, nb, mode, kw, a, b)
                                n += 1
                for bidir in (True, False):
                    assert _close(sim.pipelined_channel_time(op, nb, c, 3, bidir=bidir,
                                                             backend="pallas", n_stripes=2),
                                  jax_sim.pipelined_channel_time(op, nb, jc, 3, bidir=bidir,
                                                                 backend="pallas",
                                                                 n_stripes=2))
            assert _close(sim.mpi_collective_time(op, nb, c),
                          jax_sim.mpi_collective_time(op, nb, jc))
            assert _close(sim.collective_busbw(op, nb, c, "hier", "pallas"),
                          jax_sim.collective_busbw(op, nb, jc, "hier", "pallas"))
    assert n == len(OPS) * len(BYTES) * 4 * 2 * 2 * 3 * 2
    for rdma in (True, False):
        src, dst = c.pods[0], c.pods[-1]
        jsrc, jdst = jc.pods[0], jc.pods[-1]
        for nb in BYTES:
            assert _close(sim.p2p_time(nb, src, dst, c.inter_pod_bw, rdma=rdma),
                          jax_sim.p2p_time(nb, jsrc, jdst, jc.inter_pod_bw, rdma=rdma))
            assert _close(sim.p2p_bandwidth(nb, src, dst, 7e9),
                          jax_sim.p2p_bandwidth(nb, jsrc, jdst, 7e9))
    # policy-table pricing on the planner's own table for this cluster
    table, jtable = plan.policy_table_for(c), jax_plan.policy_table_for(jc)
    for op in OPS:
        for nb in BYTES:
            assert _close(sim.policy_collective_time(op, nb, c, table),
                          jax_sim.policy_collective_time(op, nb, jc, jtable))
    # training-step models
    n_pods = len(c.pods)
    for zero in (1, 3):
        w = sim.TrainWorkload("m", 6 * 1.3e8, 2 * 1.35e8, 4096, 2, zero)
        jw = jax_sim.TrainWorkload("m", 6 * 1.3e8, 2 * 1.35e8, 4096, 2, zero)
        assert w.tokens_per_micro == jw.tokens_per_micro
        hp = balance.make_plan([balance.PodProfile(p.name, p.effective_flops)
                                for p in c.pods], 4 * n_pods, 2)
        jhp = jax_balance.make_plan([jax_balance.PodProfile(p.name, p.effective_flops)
                                     for p in jc.pods], 4 * n_pods, 2)
        factors = {c.pods[-1].name: 1.5}
        assert all(_close(a, b) for a, b in zip(
            sim.pod_compute_seconds(w, c, hp, factors),
            jax_sim.pod_compute_seconds(jw, jc, jhp, factors)))
        for mode in ("flat", "hier", "pipelined"):
            for backend in ("xla", "pallas"):
                assert _close(sim.step_time(w, c, hp, mode, 0.25, 2.0, backend, factors),
                              jax_sim.step_time(jw, jc, jhp, mode, 0.25, 2.0, backend,
                                                factors))
                assert _close(sim.throughput_tokens_per_s(w, c, hp, mode, 0.1, 1.5, backend),
                              jax_sim.throughput_tokens_per_s(jw, jc, jhp, mode, 0.1, 1.5,
                                                              backend))
                kw = dict(n_channels=4, backend=backend, n_stripes=2)
                assert _close(sim.bucketed_all_reduce_time(2.7e8, c, mode,
                                                           bucket_bytes=16 * 2**20, **kw),
                              jax_sim.bucketed_all_reduce_time(2.7e8, jc, mode,
                                                               bucket_bytes=16 * 2**20, **kw))
                assert _close(sim.zero3_comm_time(2.7e8, 30, c, mode, **kw),
                              jax_sim.zero3_comm_time(2.7e8, 30, jc, mode, **kw))
                assert _close(sim.planned_step_time(w, c, hp, mode, n_layers=30,
                                                    bucket_bytes=2**26, overlap=0.2,
                                                    comm_scale=3.0, compute_scale=1.5,
                                                    compute_factors=factors, **kw),
                              jax_sim.planned_step_time(jw, jc, jhp, mode, n_layers=30,
                                                        bucket_bytes=2**26, overlap=0.2,
                                                        comm_scale=3.0, compute_scale=1.5,
                                                        compute_factors=factors, **kw))
        assert _close(sim.bucketed_all_reduce_time(2.7e8, c, policies=table),
                      jax_sim.bucketed_all_reduce_time(2.7e8, jc, policies=jtable))
        assert _close(sim.zero3_comm_time(2.7e8, 30, c, policies=table),
                      jax_sim.zero3_comm_time(2.7e8, 30, jc, policies=jtable))
        assert _close(sim.planned_step_time(w, c, hp, policies=table, n_layers=30),
                      jax_sim.planned_step_time(jw, jc, jhp, policies=jtable, n_layers=30))
        assert dataclasses.asdict(sim.balanced_plan(w, c, 4 * n_pods + 1)) == \
            dataclasses.asdict(jax_sim.balanced_plan(jw, jc, 4 * n_pods + 1))
    for ckpt in (True, False):
        assert _close(sim.rebuild_time(c, 3e9, checkpointless=ckpt, detect_s=2.0),
                      jax_sim.rebuild_time(jc, 3e9, checkpointless=ckpt, detect_s=2.0))
    if name == "paper":
        w = sim.TrainWorkload("m", 6 * 1.3e8, 2 * 1.35e8, 1024, 1, 1)
        jw = jax_sim.TrainWorkload("m", 6 * 1.3e8, 2 * 1.35e8, 1024, 1, 1)
        homo = [topology.paper_cluster(4, 0), topology.paper_cluster(0, 4)]
        jhomo = [jax_topology.paper_cluster(4, 0), jax_topology.paper_cluster(0, 4)]
        assert _close(sim.efficiency(w, c, homo, 8), jax_sim.efficiency(jw, jc, jhomo, 8))
    for mod, cl in ((sim, c), (jax_sim, jc)):
        with pytest.raises(ValueError):
            mod.collective_time("all_reduce", 1e6, cl, "ring")
        with pytest.raises(ValueError):
            mod.collective_time("all_reduce", 1e6, cl, "hier", backend="nccl")


# ---------------------------------------------------------------------------
# (b) the planner
# ---------------------------------------------------------------------------

PLAN_CASES = {  # id -> (cluster name, arch, global batch, seq, data axis, extra request kw)
    "paper-smollm": ("paper", "smollm-135m", 256, 4096, 4, {}),
    "h100-smollm-zero1": ("h100", "smollm-135m", 16, 512, 2,
                          dict(zero_stage=1, micro_tokens=1024)),
    "v5e-llama-1b": ("v5e_multipod", "llama-1b", 128, 8192, 8, {}),
    "mixed-mixtral-zero3": ("mixed_fleet", "mixtral-8x7b", 64, 4096, 4,
                            dict(zero_stage=3, overlap=0.3, comm_scale=2.0)),
    "degraded-mamba2": ("v5e_degraded", "mamba2-2.7b", 32, 2048, 4, {}),
}


def _requests(case):
    name, arch, gb, seq, data, kw = PLAN_CASES[case]
    return (plan.plan_request(_clusters(topology)[name], get_config(arch), gb, seq,
                              data_axis=data, **kw),
            jax_plan.plan_request(_clusters(jax_topology)[name], jax_get_config(arch), gb, seq,
                                  data_axis=data, **kw))


@pytest.mark.parametrize("case", sorted(PLAN_CASES))
def test_planner_matches_the_reference(case):
    """``rank`` (the whole frontier, in order), ``autotune``,
    ``autotune_policies`` and ``policy_table_for``: the same choices,
    shares, table rows and modeled times; the workload, HBM estimate,
    profiles and the materialized ``RunConfig`` likewise."""
    req, jreq = _requests(case)
    assert (req.micro_batch(), req.total_micro(), req.tensor_parallel()) == \
        (jreq.micro_batch(), jreq.total_micro(), jreq.tensor_parallel())
    assert dataclasses.asdict(req.comm_cluster()) == dataclasses.asdict(jreq.comm_cluster())
    for zero in (1, 3):
        w = plan.workload_for(req.model, req.seq_len, 2, zero, 2)
        jw = jax_plan.workload_for(jreq.model, jreq.seq_len, 2, zero, 2)
        assert dataclasses.asdict(w) == dataclasses.asdict(jw)
        assert plan.estimate_hbm_bytes(req, zero, 2) == jax_plan.estimate_hbm_bytes(jreq, zero, 2)
    assert [dataclasses.asdict(p) for p in plan.pod_profiles(req.cluster)] == \
        [dataclasses.asdict(p) for p in jax_plan.pod_profiles(jreq.cluster)]
    frontier, jfrontier = plan.rank(req), jax_plan.rank(jreq)
    assert [t.summary() for t in frontier] == [t.summary() for t in jfrontier]
    for fn in (plan.autotune, plan.autotune_policies):
        tp, jtp = fn(req), getattr(jax_plan, fn.__name__)(jreq)
        assert tp.summary() == jtp.summary()
        assert tp.plan.micro_per_pod == jtp.plan.micro_per_pod
        assert tp.policy_table().summary() == jtp.policy_table().summary()
        rc, jrc = tp.run_config(RunConfig(learning_rate=3e-4)), \
            jtp.run_config(JaxRunConfig(learning_rate=3e-4))
        fields = ("zero_stage", "collective_mode", "backend", "n_channels", "n_stripes",
                  "bucket_bytes", "n_micro", "learning_rate")
        assert [getattr(rc, f) for f in fields] == [getattr(jrc, f) for f in fields]
        assert (rc.policies is None) == (jrc.policies is None)
        h, jh = tp.hetccl_config(), jtp.hetccl_config()
        assert (h.mode, h.pod_axis, h.bucket_bytes, h.n_channels, h.backend, h.n_stripes,
                h.wire_quant) == (jh.mode, jh.pod_axis, jh.bucket_bytes, jh.n_channels,
                                  jh.backend, jh.n_stripes, jh.wire_quant)
    for space_kw in (dict(per_op=False), dict(modes=("hier",), backends=("pallas",)),
                     dict(stripe_counts=(2,), wire_quants=(None,))):
        space = dataclasses.replace(plan.DEFAULT_SPACE, **space_kw)
        jspace = dataclasses.replace(jax_plan.DEFAULT_SPACE, **space_kw)
        assert plan.autotune(req, space).summary() == jax_plan.autotune(jreq, jspace).summary()
    c = req.comm_cluster()
    jc = jreq.comm_cluster()
    for kw in (dict(), dict(grad_bytes=2.7e8, bucket_bytes=16 * 2**20),
               dict(grad_bytes=2.7e8, zero_stage=3, n_layers=30)):
        assert plan.policy_table_for(c, **kw).summary() == \
            jax_plan.policy_table_for(jc, **kw).summary()
    for op in OPS:
        for nb in BYTES:
            p, t = plan.best_policy(op, nb, c)
            jp, jt = jax_plan.best_policy(op, nb, jc)
            assert p.summary() == jp.summary() and t == jt
    assert plan.grad_payload_bytes(2.7e8, 2**24, 1, 30) == \
        jax_plan.grad_payload_bytes(2.7e8, 2**24, 1, 30)
    for name in jax_plan.__all__:
        assert hasattr(plan, name), name


def test_planner_choices_on_the_card_runs():
    """The plans ``chip_smoke.py`` [31] trains on: H100 islands pick the
    pipelined pallas rows with four channels and one stripe, the paper's
    V100 + W7800 testbed shares (3, 1) with a 16 MiB bucket, and a large
    class that carries int8 beside an uncompressed medium class."""
    m = mesh.ThreadMesh({"pod": 2, "data": 2}, device="cpu")
    cfg = get_config("smollm-135m")
    for chips, shares, bucket in ((None, (2, 2), 64), ([topology.V100_PCIE, topology.W7800],
                                                       (3, 1), 16)):
        req = plan.plan_request(launch_mesh.cluster_for_mesh(m, chips), cfg, global_batch=16,
                                seq_len=512, data_axis=2, zero_stage=1, micro_tokens=1024)
        tp = plan.autotune_policies(req)
        assert (tp.mode, tp.backend, tp.n_channels, tp.n_stripes) == ("pipelined", "pallas",
                                                                       4, 1)
        assert tp.plan.micro_per_pod == shares and tp.bucket_bytes >> 20 == bucket
        t = tp.policies
        assert t.lookup("reduce_scatter", "large").wire_quant == "int8"
        assert t.lookup("reduce_scatter", "medium").wire_quant is None
    v5e = plan.autotune_policies(plan.plan_request(
        launch_mesh.cluster_for_mesh(m, topology.TPU_V5E), cfg, global_batch=16, seq_len=512,
        data_axis=2, zero_stage=1, micro_tokens=1024))
    assert v5e.n_stripes == 4


# ---------------------------------------------------------------------------
# (c) refinement and measured calibration
# ---------------------------------------------------------------------------

def test_refine_matches_the_reference():
    req, jreq = _requests("paper-smollm")
    tp, jtp = plan.autotune(req), jax_plan.autotune(jreq)
    for observed in (None, 0.05, 1e3, 1e-9):
        if observed is not None:
            assert plan.calibrate(tp, observed) == jax_plan.calibrate(jtp, observed)
        profs = [balance.PodProfile("nvidia", 9.1e5), balance.PodProfile("amd", 3.8e5)]
        jprofs = [jax_balance.PodProfile("nvidia", 9.1e5), jax_balance.PodProfile("amd", 3.8e5)]
        for p, jp in ((None, None), (profs, jprofs)):
            a = plan.refine(tp, p, observed_step_s=observed)
            b = jax_plan.refine(jtp, jp, observed_step_s=observed)
            assert a.summary() == b.summary()
            assert [t.summary() for t in plan.refined_frontier(tp, p, observed)] == \
                [t.summary() for t in jax_plan.refined_frontier(jtp, jp, observed)]
    jax_refine = importlib.import_module("repro.plan.refine")
    refine = importlib.import_module("repro_torch.plan.refine")
    profs = [balance.PodProfile("nvidia", 9.1e5), balance.PodProfile("amd", 3.8e5)]
    jprofs = [jax_balance.PodProfile("nvidia", 9.1e5), jax_balance.PodProfile("amd", 3.8e5)]
    for factors in ({}, {"amd": 2.5}, {"nvidia": 1.0, "amd": 4.0}):
        assert [dataclasses.asdict(p) for p in refine.deweighted_profiles(profs, factors)] == \
            [dataclasses.asdict(p) for p in jax_refine.deweighted_profiles(jprofs, factors)]
    for bad in ({"amd": 0.5}, {"intel": 2.0}):
        with pytest.raises(ValueError):
            refine.deweighted_profiles(profs, bad)


def _bench_comm():
    """A collective record in ``benchmarks/measure.py``'s schema: a sweep
    over sizes for several (op, mode, backend, stripes) cells, one cell at a
    single size, and the policy table's rows of a (4, 2) bench mesh."""
    rng = np.random.RandomState(5)
    entries = []
    sizes = {"small": 16384, "medium": 2**20, "large": 64 * 2**20}
    for op in ("all_reduce", "all_gather", "reduce_scatter"):
        for mode, backend, k in (("flat", "xla", 1), ("hier", "pallas", 2),
                                 ("pipelined", "pallas", 1)):
            for cls, nb in sizes.items():
                entries.append({
                    "name": f"comm/{op}/{mode}-{backend}-c4-k{k}/{cls}", "op": op,
                    "size_class": cls, "mode": mode, "backend": backend, "n_channels": 4,
                    "n_stripes": k, "nbytes": nb, "group": "sweep",
                    "median_s": float(1e-4 + nb / 2e9 * (1 + 0.1 * rng.rand())),
                    "wire_quant": None})
    entries.append({"name": "comm/broadcast/hier-xla-c1-k1/small", "op": "broadcast",
                    "size_class": "small", "mode": "hier", "backend": "xla", "n_channels": 1,
                    "n_stripes": 1, "nbytes": 16384, "group": "sweep", "median_s": 3e-4,
                    "wire_quant": None})
    table = jax_plan.policy_table_for(jax_plan.bench_cluster(4, 2))
    for (op, cls), p in table.rows[:-3]:                 # three rows left unmeasured
        entries.append({"name": f"policy/{op}/{cls}", "op": op, "size_class": cls,
                        "mode": p.mode, "backend": p.backend, "n_channels": p.n_channels,
                        "n_stripes": p.n_stripes, "nbytes": sizes[cls], "group": "policy",
                        "median_s": float(2e-4 * (1 + rng.rand())), "wire_quant": p.wire_quant})
    return {"schema_version": 1, "kind": "comm", "config": {"mesh": [4, 2],
                                                            "mesh_axes": ["pod", "data"]},
            "entries": entries}


def _bench_train():
    return {"schema_version": 1, "kind": "train", "config": {"mesh": [2, 2, 2]},
            "entries": [{"name": "train/smollm-135m/zero1-hier-xla/step", "op": "train_step",
                         "median_s": 0.161, "modeled_step_s": 3.996e-05,
                         "tokens_per_s_median": 1589.76, "tokens_per_step": 256,
                         "mode": "hier", "backend": "xla",
                         "request": {"arch": "smollm-135m", "backend": "xla", "data_axis": 2,
                                     "global_batch": 4, "mode": "hier", "model_axis": 2,
                                     "n_pods": 2, "reduced": True, "seq_len": 64,
                                     "zero_stage": 1}}]}


def _flight_dump():
    entries = [{"kind": "mark", "name": "step"}]
    for i, (op, cls, nb) in enumerate((("all_reduce", "large", 64 * 2**20),
                                       ("all_reduce", "large", 64 * 2**20),
                                       ("all_gather", "medium", 2**20),
                                       ("reduce_scatter", "small", 4096))):
        entries.append({"kind": "span", "cat": "collective", "dur_s": 1e-3 * (i + 1),
                        "modeled_s": 2e-4 * (i + 1),
                        "tags": {"op": op, "size_class": cls, "mode": "auto",
                                 "backend": "pallas", "n_channels": 4, "n_stripes": 2,
                                 "nbytes": nb}})
    entries.append({"kind": "span", "cat": "compute", "dur_s": 1.0, "tags": {}})
    return {"entries": entries}


def _rows(rows):
    return [r.summary() for r in rows]


def test_measured_calibration_matches_the_reference():
    """Every function of ``plan.measured`` on synthetic records in the
    bench schema (built here, no file read): the report, the α-β fits, the
    comm scale, the coverage, the flight ingest, the train-step request and
    its modeled time, the measured profiles, the calibrated plan, the
    planner check and the whole calibration record."""
    from repro.plan import measured as jm
    from repro_torch.plan import measured as m
    comm_rec, train_rec, dump = _bench_comm(), _bench_train(), _flight_dump()
    assert dataclasses.asdict(m.bench_cluster(4, 2)) == dataclasses.asdict(jm.bench_cluster(4, 2))
    rep, jrep = m.calibration_report(comm_rec), jm.calibration_report(comm_rec)
    assert _rows(rep) == _rows(jrep) and len(rep) == len(comm_rec["entries"])
    assert [f.summary() for f in m.fit_alpha_beta(rep)] == \
        [f.summary() for f in jm.fit_alpha_beta(jrep)]
    assert m.comm_scale_from_report(rep) == jm.comm_scale_from_report(jrep)
    table = plan.policy_table_for(m.bench_cluster(4, 2))
    jtable = jax_plan.policy_table_for(jm.bench_cluster(4, 2))
    assert m.missing_table_rows(rep, table) == jm.missing_table_rows(jrep, jtable)
    assert len(m.missing_table_rows(rep, table)) == 3
    for cl, jcl in ((None, None), (topology.paper_cluster(2, 2),
                                   jax_topology.paper_cluster(2, 2))):
        rows, jrows = m.rows_from_flight(dump, cl), jm.rows_from_flight(dump, jcl)
        assert _rows(rows) == _rows(jrows) and len(rows) == 3
        assert m.flight_cells(rows) == jm.flight_cells(jrows)
    params = train_rec["entries"][0]["request"]
    req, jreq = m.train_request(params), jm.train_request(params)
    assert (req.global_batch, req.seq_len, req.data_axis, req.zero_stage, req.model.name) == \
        (jreq.global_batch, jreq.seq_len, jreq.data_axis, jreq.zero_stage, jreq.model.name)
    assert m.modeled_train_step_s(req, params) == jm.modeled_train_step_s(jreq, params)
    e = train_rec["entries"][0]
    assert [dataclasses.asdict(p) for p in m.profiles_from_train(e, req.cluster)] == \
        [dataclasses.asdict(p) for p in jm.profiles_from_train(e, jreq.cluster)]
    tp, jtp = plan.autotune(req), jax_plan.autotune(jreq)
    assert m.calibrated_plan(tp, e).summary() == jm.calibrated_plan(jtp, e).summary()
    check, jcheck = m.planner_check(e), jm.planner_check(e)
    assert check == jcheck and check["unchanged"]
    assert m.calibration_record(comm_rec, train_rec) == jm.calibration_record(comm_rec, train_rec)
    assert m.calibration_record(None, None) == jm.calibration_record(None, None)
    with pytest.raises(ValueError):
        m.profiles_from_train(dict(e, median_s=0.0), req.cluster)
    with pytest.raises(ValueError):
        m.comm_scale_from_report([])


# ---------------------------------------------------------------------------
# (d) the launcher
# ---------------------------------------------------------------------------

def _jax_mesh():
    return types.SimpleNamespace(axis_names=("pod", "data"), devices=np.empty((2, 2)))


def test_launcher_plan_auto_prints_the_reference_plan(capsys):
    """``--plan auto`` with the paper's chips: the printed plan (mode,
    backend, channels, stripes, bucket, rows, shares, modeled step) and the
    whole TrainPlan are the reference planner's for the same request, and a
    step trains on its shares."""
    cfg, jcfg = get_config("smollm-135m").reduced(), jax_get_config("smollm-135m").reduced()
    jreq = jax_plan.plan_request(
        jax_launch_mesh.cluster_for_mesh(_jax_mesh(), [jax_topology.V100_PCIE,
                                                       jax_topology.W7800]),
        jcfg, global_batch=8, seq_len=64, data_axis=2, zero_stage=1, micro_tokens=64)
    for policy, fn in (("auto", jax_plan.autotune_policies), ("legacy", jax_plan.autotune)):
        jtp = fn(jreq, dataclasses.replace(jax_plan.DEFAULT_SPACE, per_op=policy == "auto"))
        args = launcher.parser().parse_args(
            ["--device", "cpu", "--plan", "auto", "--policy", policy, "--chips", "v100,w7800",
             "--seq", "64"])
        m = mesh.ThreadMesh({"pod": 2, "data": 2}, device="cpu")
        rc, hp, tp = launcher.plan_run(args, m, cfg)
        assert tp.summary() == jtp.summary()
        assert hp.micro_per_pod == jtp.plan.micro_per_pod == (3, 1)
        assert launcher.plan_line(tp) == launcher.plan_line(jtp)
        assert (rc.policies is None) == (policy == "legacy")
    hist = launcher.main(["--device", "cpu", "--steps", "1", "--seq", "64", "--plan", "auto",
                          "--chips", "v100,w7800"])
    out = capsys.readouterr().out
    assert launcher.plan_line(jax_plan.autotune_policies(jreq)) in out
    assert "shares=(3, 1)" in out and np.isfinite(hist).all()


def test_launcher_policy_and_stripes_flags_match_the_reference():
    """The default ``--policy auto`` trains on the reference's table for the
    mesh's cluster (H100 islands by default, DESIGN_TORCH.md §23);
    ``legacy`` on the facade, ``flat`` flat; a pinned ``--stripes``
    narrows the table's search; a stripe count the rings do not take
    raises."""
    cfg = get_config("smollm-135m").reduced()
    m = mesh.ThreadMesh({"pod": 2, "data": 2}, device="cpu")

    def run(*flags):
        return launcher.plan_run(launcher.parser().parse_args(["--device", "cpu", *flags]),
                                 m, cfg)

    for chips, jchips, extra in (("h100", jax_topology.H100_NVLINK, ()),
                                 ("v5e", jax_topology.TPU_V5E, ("--stripes", "2"))):
        rc, hp, tp = run("--chips", chips, *extra)
        jspace = jax_plan.DEFAULT_SPACE
        if extra:
            jspace = dataclasses.replace(jspace, stripe_counts=(2,))
        want = jax_plan.policy_table_for(jax_launch_mesh.cluster_for_mesh(_jax_mesh(), jchips),
                                         jspace, bucket_bytes=JaxRunConfig().bucket_bytes,
                                         zero_stage=1)
        assert tp is None and hp.micro_per_pod == (2, 2)
        assert rc.policies.summary() == want.summary()
    rc, _, _ = run("--policy", "legacy", "--backend", "pallas", "--mode", "pipelined")
    assert rc.policies is None and (rc.collective_mode, rc.backend, rc.n_stripes) == \
        ("pipelined", "pallas", 1)
    rc, _, _ = run("--policy", "flat", "--mode", "hier")
    assert rc.policies is None and rc.collective_mode == "flat"
    rc, _, _ = run("--wire-quant", "int8")
    assert rc.wire_quant == "int8" and rc.policies.summary() == run()[0].policies.summary()
    # a cross dtype: the table is searched without the codec, whose rows
    # would not take it
    rc, _, _ = run("--cross-dtype", "bfloat16")
    assert rc.cross_dtype == "bfloat16"
    assert rc.policies.summary() == jax_plan.policy_table_for(
        jax_launch_mesh.cluster_for_mesh(_jax_mesh(), jax_topology.H100_NVLINK),
        dataclasses.replace(jax_plan.DEFAULT_SPACE, wire_quants=(None,)),
        bucket_bytes=JaxRunConfig().bucket_bytes, zero_stage=1).summary()
    assert all(p.wire_quant is None for _, p in rc.policies.rows)
    _, _, tp = run("--cross-dtype", "bfloat16", "--plan", "auto", "--chips", "v100,w7800")
    assert tp.plan.micro_per_pod == (3, 1) and tp.wire_quant is None
    for bad in ("0", "9"):
        with pytest.raises(ValueError, match="stripes"):
            run("--stripes", bad)
    with pytest.raises(ValueError, match="--chips"):
        run("--chips", "a100")


# ---------------------------------------------------------------------------
# (e) training on the planner's table and uneven shares, against JAX
# ---------------------------------------------------------------------------

KEY, SEQ = 42, 64
CFG, JCFG = get_config("smollm-135m").reduced(), jax_get_config("smollm-135m").reduced()
MODEL, JMODEL = build(CFG), jax_build(JCFG)
# size-class bounds and bucket scaled to the reduced model (per ZeRO stage:
# ZeRO-3's payloads are a layer's shards), so that its buckets and leaves
# fall in all three classes, int8 on the large rows beside uncompressed
# medium and small rows within one step, with few large ones (each is a
# long program for the JAX trainer to compile)
BOUNDS = {1: (8 * 1024, 1536 * 1024), 3: (8 * 1024, 160 * 1024)}
BUCKET = 2 * 2**20


@pytest.fixture
def one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _jax_params():
    return jax.tree.map(np.asarray, jax.device_get(
        JMODEL.init(jax.random.PRNGKey(KEY), dtype="float32")))


def _planned(zero: int, space_kw=None):
    """The planner's TrainPlan for the paper's testbed on (pod=2, data=2),
    both packages, its table re-bounded to the reduced model's sizes."""
    m = mesh.ThreadMesh({"pod": 2, "data": 2}, device="cpu")
    kw = dict(global_batch=8, seq_len=SEQ, data_axis=2, zero_stage=zero, micro_tokens=SEQ)
    space = dataclasses.replace(plan.DEFAULT_SPACE, **(space_kw or {}))
    jspace = dataclasses.replace(jax_plan.DEFAULT_SPACE, **(space_kw or {}))
    tp = plan.autotune_policies(plan.plan_request(launch_mesh.cluster_for_mesh(
        m, [topology.V100_PCIE, topology.W7800]), CFG, **kw), space)
    jtp = jax_plan.autotune_policies(jax_plan.plan_request(jax_launch_mesh.cluster_for_mesh(
        _jax_mesh(), [jax_topology.V100_PCIE, jax_topology.W7800]), JCFG, **kw), jspace)
    assert tp.summary() == jtp.summary() and tp.plan.micro_per_pod == (3, 1)
    return (m, tp, dataclasses.replace(tp.policies, bounds=BOUNDS[zero]),
            jtp, dataclasses.replace(jtp.policies, bounds=BOUNDS[zero]))


@pytest.mark.parametrize("zero", [1, 3])
def test_planned_steps_match_jax(mesh3, one_thread, zero):
    """3 steps on the planner's per-op table (pipelined pallas rows, int8
    on the large class beside uncompressed medium and small classes, xla
    gathers) and its (3, 1) shares, ZeRO-1 and ZeRO-3, against the JAX
    trainer on the same table and shares (module note's tolerances).  The
    step's dispatches reach rows of every class, the large ones quantized
    (error feedback on); under ZeRO-3 the sharded leaves' all-reduce runs
    on the pod-only projection of the communicator, which keeps the table:
    its large rows quantize."""
    m, tp, table, jtp, jtable = _planned(zero)
    rc_kw = dict(zero_stage=zero, learning_rate=1e-3, param_dtype="float32",
                 bucket_bytes=BUCKET)
    rc = tp.run_config(RunConfig(**rc_kw))
    rc = dataclasses.replace(rc, policies=table, bucket_bytes=BUCKET)
    jrc = dataclasses.replace(jtp.run_config(JaxRunConfig(**rc_kw)), policies=jtable,
                              bucket_bytes=BUCKET)
    assert optim.ef_codec(rc) == "int8"
    jprog = jax_make_train_program(JMODEL, mesh3, jrc, jtp.plan)
    jstate = jprog.init_fn(jax.random.PRNGKey(KEY))
    prog = make_train_program(MODEL, m, rc, tp.plan)
    state = prog.init_fn(params_from_jax(_jax_params(), metas=MODEL.abstract_params()))
    hetccl.reset_dispatches()
    got, want = [], []
    for s in range(3):
        nm, gmb, _ = prog.batch_shape(SEQ)
        assert (nm, gmb) == jprog.batch_shape(SEQ)[:2] == (3, 4)
        b = pipeline.synthetic_batch(0, s, nm, gmb, SEQ, CFG.vocab)
        state, met = prog.step_fn(state, b)
        jstate, jmet = jprog.step_fn(jstate, {k: jnp.asarray(v) for k, v in b.items()})
        got.append(met["loss"].item())
        want.append(float(jmet["loss"]))
        assert met["tokens"].item() == 4 * 2 * SEQ       # live micro-steps x data x seq
    print(f"\n  zero{zero} planned: losses JAX {want}\n                   port {got}")
    assert abs(got[0] - want[0]) <= 1e-5
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-2)
    classes = {(op, cls, pol.wire_quant) for (op, cls, _, pol) in hetccl.dispatches}
    assert ("reduce_scatter" if zero == 1 else "all_reduce", "large", "int8") in classes
    assert {cls for (_, cls, _) in classes} == {"small", "medium", "large"}
    assert all(pol == prog.comm.policy(op, 1) if cls == "small" else True
               for (op, cls, _, pol) in hetccl.dispatches)
    if zero == 3:
        full = unshard_params([state[0]["params"], state[1]["params"]], MODEL.abstract_params())
    else:
        full = state[0]["params"]
    jl = [np.asarray(x) for x in jax.tree.leaves(jax.device_get(jstate["params"]))]
    gl = [p.numpy() for p in leaves(full)]
    rel = (sum(float(((g - w) ** 2).sum()) for g, w in zip(gl, jl))
           / sum(float((w ** 2).sum()) for w in jl)) ** 0.5
    print(f"                   params relative L2 {rel:.3e}")
    assert rel <= 1e-2


# ---------------------------------------------------------------------------
# (f) ROADMAP A5b: a bf16 cross_dtype run against the f32-accumulate oracle
# ---------------------------------------------------------------------------

def _captured_reduction(monkeypatch):
    """``chip_smoke.reduction_capture`` in place of ``hetccl.tree_all_reduce``
    (the ZeRO-1 gradient reduction): per rank, the leaves it was given and
    the leaves it returned."""
    wrapper, seen = smoke.reduction_capture(hetccl, mesh, keep_inputs=True)
    monkeypatch.setattr(hetccl, "tree_all_reduce", wrapper)
    return seen


A5B_CASES = {  # id -> RunConfig fields beyond the common ones (None: the planner's table)
    "facade-hier-xla": dict(collective_mode="hier", backend="xla"),
    "facade-hier-pallas": dict(collective_mode="hier", backend="pallas"),
    "facade-pipelined-pallas": dict(collective_mode="pipelined", backend="pallas"),
    "planner-table": None,
}


@pytest.mark.parametrize("case", sorted(A5B_CASES))
def test_bf16_cross_dtype_run_against_the_f32_accumulate_oracle(one_thread, monkeypatch, case):
    """A5b: ``RunConfig(cross_dtype="bfloat16")`` composed into the facade
    (hier and pipelined; xla and pallas) and into the planner's table, on
    the (3, 1) shares: step 0's reduced gradients on every rank lie within
    ``chip_smoke.bf16_cross_bound`` (the bound run c of [31] gates on the
    card) of the oracle built from the same step's local
    gradients (each cross-island shard rounded to bf16, then summed), and
    the bf16 stage acted (the result is not the f32 sum).  The planner's
    table is priced without the codec, since a codec row owns its wire
    format and takes no cross dtype (``with_cross_dtype``); every one of its
    all_reduce rows then carries bf16.  Two more steps stay finite."""
    m = mesh.ThreadMesh({"pod": 2, "data": 2}, device="cpu")
    extra = A5B_CASES[case]
    rc_kw = dict(zero_stage=1, learning_rate=1e-3, param_dtype="float32",
                 cross_dtype="bfloat16")
    if extra is None:
        _, tp, _, _, _ = _planned(1, dict(wire_quants=(None,)))
        rc = tp.run_config(RunConfig(**rc_kw))
        assert all(p.wire_quant is None for _, p in rc.policies.rows)
        hp = tp.plan
    else:
        rc = RunConfig(**rc_kw, **extra)
        hp = balance.make_plan([balance.PodProfile("p0", 2.0), balance.PodProfile("p1", 1.0)],
                               4, 1)
    assert hp.micro_per_pod == (3, 1)
    prog = make_train_program(MODEL, m, rc, hp)
    assert prog.comm.policy("all_reduce", 2**30).cross_dtype == torch.bfloat16
    state = prog.init_fn(params_from_jax(_jax_params(), metas=MODEL.abstract_params()))
    seen = _captured_reduction(monkeypatch)
    nm, gmb, _ = prog.batch_shape(SEQ)
    losses = []
    for s in range(3):
        state, met = prog.step_fn(state, pipeline.synthetic_batch(0, s, nm, gmb, SEQ,
                                                                  CFG.vocab))
        losses.append(met["loss"].item())
        if s == 0:
            step0 = {k: dict(v) for k, v in seen.items()}
    assert np.isfinite(losses).all()
    worst, acted = 0.0, False
    for j in range(len(step0["in"][0])):
        shards = [step0["in"][2 * p][j] + step0["in"][2 * p + 1][j] for p in range(2)]
        oracle, bound = smoke.bf16_cross_bound(torch, shards)
        f32_sum = shards[0] + shards[1]
        for r in range(4):
            got = step0["out"][r][j].double()
            err = (got - oracle).abs()
            assert bool((err <= bound).all()), (case, j, r, float((err - bound).max()))
            worst = max(worst, float((err / bound.clamp(min=1e-30)).max()))
            acted |= bool((got != f32_sum.double()).any())
    print(f"\n  {case}: worst |port - oracle| / bound {worst:.3f}; losses {losses}")
    assert acted


# ---------------------------------------------------------------------------
# (g) chip_smoke [31]'s expectations and the int8 bound, on the CPU
# ---------------------------------------------------------------------------

def _counting_fused(monkeypatch):
    """Pin the rings to their fused schedule on the CPU (the plain versions
    of the kernels' protocols run) and count each launch the card would
    make, by the thread's dispatch row and stripes, as the kernels do."""
    got = Counter()
    monkeypatch.setattr(ring_dma, "_schedule", lambda op: "fused")
    real_rs, real_ag = ring_dma.reduce_scatter_fused, ring_dma.all_gather_fused

    def rs(inputs, rings, *, n_stripes=1, **kw):
        c = inputs[0].numel() // len(rings[0])
        if c:
            got[(tacc.current_row(),
                 f"ring_reduce_scatter/S{ring_dma._clamp_stripes(n_stripes, c)}")] += 1
        return real_rs(inputs, rings, n_stripes=n_stripes, **kw)

    def ag(inputs, rings, *, n_stripes=1, **kw):
        nbytes = inputs[0].numel() * inputs[0].element_size()
        words = nbytes // 4 if nbytes % 4 == 0 else nbytes // 2
        if words:
            got[(tacc.current_row(),
                 f"ring_all_gather/S{ring_dma._clamp_stripes(n_stripes, words)}")] += 1
        return real_ag(inputs, rings, n_stripes=n_stripes, **kw)

    monkeypatch.setattr(ring_dma, "reduce_scatter_fused", rs)
    monkeypatch.setattr(ring_dma, "all_gather_fused", ag)
    return got


EXPECT_CASES = {  # id -> RunConfig fields (None: the planner's table, re-bounded)
    "planned-int8": None,
    "planned-bf16": dict(cross_dtype="bfloat16"),
    "facade-hier-pallas": dict(collective_mode="hier", backend="pallas", n_stripes=3),
    "facade-flat-pallas": dict(collective_mode="flat", backend="pallas", n_stripes=2),
    "facade-pipelined-pallas-bf16": dict(collective_mode="pipelined", backend="pallas",
                                         n_channels=3, cross_dtype="bfloat16"),
    "facade-hier-xla": dict(collective_mode="hier", backend="xla"),
}


@pytest.mark.parametrize("case", sorted(EXPECT_CASES))
def test_planned_expectations_of_the_card_run(one_thread, monkeypatch, case):
    """``chip_smoke.planned_expectations`` (what [31] holds each run's
    dispatches and fused ring launches to, from the leaves, the buckets and
    the table alone) against one step on the CPU with the rings pinned to
    the fused schedule: the same calls per row, the same launches per row
    and stripes."""
    m = mesh.ThreadMesh({"pod": 2, "data": 2}, device="cpu")
    extra = EXPECT_CASES[case]
    rc_kw = dict(zero_stage=1, learning_rate=1e-3, param_dtype="float32", bucket_bytes=BUCKET)
    if extra is None or case.startswith("planned"):
        space = dict(wire_quants=(None,)) if extra else None
        _, tp, table, _, _ = _planned(1, space)
        rc = dataclasses.replace(tp.run_config(RunConfig(**rc_kw, **(extra or {}))),
                                 policies=table, bucket_bytes=BUCKET)
        hp = tp.plan
    else:
        rc = RunConfig(**rc_kw, **extra)
        hp = balance.uniform_plan(2, 4, 1)
    prog = make_train_program(MODEL, m, rc, hp)
    state = prog.init_fn(params_from_jax(_jax_params(), metas=MODEL.abstract_params()))
    got = _counting_fused(monkeypatch)
    hetccl.reset_dispatches()
    nm, gmb, _ = prog.batch_shape(SEQ)
    prog.step_fn(state, pipeline.synthetic_batch(0, 0, nm, gmb, SEQ, CFG.vocab))
    p_leaves = leaves(MODEL.init(torch.Generator().manual_seed(0), dtype=torch.float32))
    g_leaves = [torch.empty(p.shape, dtype=torch.float32, device="meta") for p in p_leaves]
    want_disp, want_fused = smoke.planned_expectations(hetccl, collectives, ring_dma,
                                                       prog.comm, g_leaves, p_leaves, 2, 2)
    assert Counter(hetccl.dispatches) == want_disp
    assert got == want_fused
    rows = {r[2:] for r in want_disp}
    print(f"\n  {case}: {sum(want_disp.values())} calls over {len(want_disp)} rows, "
          f"{sum(want_fused.values())} fused launches; variants {sorted({v for v, _ in rows})}")
    if case == "facade-hier-xla":
        assert not want_fused
    else:
        assert want_fused


def test_int8_reduction_bound_holds_and_is_not_vacuous(one_thread, monkeypatch):
    """``chip_smoke.int8_reduction_bound`` on the CPU, as [31] uses it: the
    planner's int8 table (re-bounded, (3, 1) shares, error feedback) against
    the f32 oracle on the facade (hier/xla), step 0's reduced gradients:
    every element within its bound, the bound well under the gradient
    (global relative bound below 0.2), and the int8 run not the f32 sum."""
    m = mesh.ThreadMesh({"pod": 2, "data": 2}, device="cpu")
    _, tp, table, _, _ = _planned(1)
    rc_kw = dict(zero_stage=1, learning_rate=1e-3, param_dtype="float32", bucket_bytes=BUCKET)
    rc_b = dataclasses.replace(tp.run_config(RunConfig(**rc_kw)), policies=table,
                               bucket_bytes=BUCKET)
    rc_d = RunConfig(**rc_kw, collective_mode="hier", backend="xla")
    params = params_from_jax(_jax_params(), metas=MODEL.abstract_params())
    outs = {}
    for name, rc in (("d", rc_d), ("b", rc_b)):
        prog = make_train_program(MODEL, m, rc, tp.plan)
        state = prog.init_fn(params)
        seen = _captured_reduction(monkeypatch)
        nm, gmb, _ = prog.batch_shape(SEQ)
        prog.step_fn(state, pipeline.synthetic_batch(0, 0, nm, gmb, SEQ, CFG.vocab))
        outs[name] = {k: dict(v) for k, v in seen.items()}
    g_leaves = [torch.empty(t.shape, device="meta") for t in outs["d"]["in"][0]]
    bound = smoke.int8_reduction_bound(
        torch, [outs["d"]["in"][r] for r in range(4)],
        hetccl._make_buckets(g_leaves, BUCKET), 2)
    got, want = outs["b"]["out"][0], outs["d"]["out"][0]
    worst = max(float(((g - w).abs() / b.clamp(min=1e-30)).max())
                for g, w, b in zip(got, want, bound))
    rel_bound = float(torch.sqrt(sum((b.double() ** 2).sum() for b in bound))
                      / torch.sqrt(sum((w.double() ** 2).sum() for w in want)))
    err = float(torch.sqrt(sum(((g - w).double() ** 2).sum() for g, w in zip(got, want)))
                / torch.sqrt(sum((w.double() ** 2).sum() for w in want)))
    print(f"\n  int8 vs f32: rel L2 {err:.3e}, global bound {rel_bound:.3e}, worst element "
          f"|err| / bound {worst:.3f}")
    assert worst <= 1 and 0 < err <= rel_bound < 0.2


@pytest.mark.parametrize("barrier", [True, False])
def test_donated_all_reduce_writes_back_after_every_rank_read(monkeypatch, barrier):
    """``tree_all_reduce``'s all_reduce path (a cross dtype on the largest
    bucket's row) on ``bucket_zeros`` buckets: a flat all_reduce reads the
    peers' buckets by reference, so no rank may write its reduced bucket
    back before every rank has read.  Ranks 1-3 are held back after the
    exchange; with the barrier every rank gets the exact sum, and with the
    barrier removed (``barrier=False``) the held-back ranks read rank 0's
    reduced bucket, which the card run c of [31] once showed on the final
    norm's bucket."""
    import time
    m = mesh.ThreadMesh({"pod": 2, "data": 2}, device="cpu")
    rng = np.random.RandomState(11)
    leaves_in = [[torch.from_numpy(rng.randn(*s).astype(np.float32)) for s in ((33,), (7, 5))]
                 for _ in range(4)]
    cfg = hetccl.HetCCLConfig(mode="flat", cross_dtype=torch.bfloat16, bucket_bytes=1 << 20)
    real_gather = mesh.ThreadMesh._gather

    def slow_gather(self, rank, x, axes):
        out = real_gather(self, rank, x, axes)
        if rank:
            time.sleep(0.05)
        return out

    monkeypatch.setattr(mesh.ThreadMesh, "_gather", slow_gather)
    if not barrier:
        monkeypatch.setattr(mesh.ThreadMesh, "barrier", lambda self, rank: None)

    def rank_fn(ls):
        bufs = hetccl.bucket_zeros(ls, cfg)
        for b, x in zip(bufs, ls):
            b.copy_(x)
        return hetccl.tree_all_reduce(bufs, cfg)

    outs = m.run(rank_fn, leaves_in)
    want = [sum(ls[j] for ls in leaves_in) for j in range(2)]
    exact = all(torch.allclose(o[j], want[j], rtol=0, atol=1e-5) for o in outs for j in range(2))
    assert exact == barrier
