"""The port's elastic run loop (``repro_torch.elastic``, DESIGN.md §13, §15)
on reduced smollm-135m on a CPU ``ThreadMesh`` (pod=2, data=2): the
reference's acceptance cases (``tests/test_elastic.py``) held bit for bit
against the port's own uninterrupted and continued runs, shard coverage
after a pod loss, and every chaos script once through both packages'
``run_elastic`` (the JAX package's on ``mesh3``).

Tolerances against the JAX package: the two elastic reports must agree in
their events, rebuilt pod sets and shares, recovery methods and steps, and
hang actions exactly; their losses within ``test_torch_train.py``'s step
tolerances (step 0 within 1e-5, later steps 1e-2: the reduced model at init
is ill-conditioned, so whole steps drift apart after step 0).  Those hold
over that module's 3 steps at lr 1e-3; these runs take up to 10, at lr 1e-4,
where Adam's first updates (+-lr a weight, whatever the gradient's size)
move the two packages' weights apart ten times less: the largest gap reads
1.3e-3 over 10 steps (at lr 1e-3 it reads 6.5e-2 by step 9).  Against the
port's own baselines everything is bit for bit.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import elastic as ref  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs.base import RunConfig as JaxRunConfig  # noqa: E402
from repro.core import balance as jax_balance  # noqa: E402
from repro.data import pipeline as jax_pipeline  # noqa: E402
from repro.launch.mesh import cluster_for_mesh as jax_cluster_for_mesh  # noqa: E402
from repro.models import build as jax_build  # noqa: E402
from repro.train import checkpoint as jax_ck  # noqa: E402
from repro.train.trainer import make_train_program as jax_make_train_program  # noqa: E402
from repro.train.trainer import rebuild_program as jax_rebuild_program  # noqa: E402
from repro_torch import elastic  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import RunConfig  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core import balance  # noqa: E402
from repro_torch.core.mesh import ThreadMesh  # noqa: E402
from repro_torch.core.tree import flatten, leaves  # noqa: E402
from repro_torch.data.pipeline import DataPipeline  # noqa: E402
from repro_torch.launch.mesh import cluster_for_mesh  # noqa: E402
from repro_torch.models import build  # noqa: E402
from repro_torch.train import checkpoint as ck  # noqa: E402
from repro_torch.train import ft  # noqa: E402
from repro_torch.train.trainer import make_train_program, rebuild_program  # noqa: E402

CFG = get_config("smollm-135m").reduced()
JCFG = jax_get_config("smollm-135m").reduced()
MODEL, JMODEL = build(CFG), jax_build(JCFG)
KEY = 1
SEQ = 32
LR = 1e-4
STEP0_ATOL, LOSS_ATOL = 1e-5, 1e-2      # test_torch_train.py's step tolerances

# id -> (ZeRO stage, micro-steps over both pods, chaos script, steps, ckpt_every)
CASES = {
    "kill_zero3": (3, 4, "kill:pod1@2", 4, 50),
    "kill_pod0_zero3": (3, 4, "kill:pod0@2", 4, 50),
    "kill_zero1_fallback": (1, 4, "kill:pod1@3", 4, 2),
    "kill_then_rejoin": (3, 4, "kill:pod1@2;revive:pod1@4", 6, 50),
    "link_degrade": (3, 4, "degrade:pod0.0x0.25@1", 3, 50),
    "hang_ladder": (3, 4, "hang:pod1@1", 3, 50),
    "slow_quarantine": (3, 6, "slow:pod1x2.5@3-30", 10, 50),
}


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: the mesh's rank threads are the parallelism, and
    a run repeats bit for bit whatever the host's core count."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


_PARAMS = {}


def _port_params():
    """The JAX init's parameters (``KEY``), carried over once."""
    if not _PARAMS:
        p = jax.tree.map(np.asarray, jax.device_get(
            JMODEL.init(jax.random.PRNGKey(KEY), dtype="float32")))
        _PARAMS["p"] = params_from_jax(p, metas=MODEL.abstract_params())
    return _PARAMS["p"]


def _prog(zero, micro=4, shape=None, **rc_kw):
    shape = shape or {"pod": 2, "data": 2}
    n_pods = shape.get("pod", 1)
    rc = RunConfig(zero_stage=zero, collective_mode="hier", learning_rate=LR,
                   param_dtype="float32", **rc_kw)
    return make_train_program(MODEL, ThreadMesh(shape, device="cpu"), rc,
                              balance.uniform_plan(n_pods, micro, 1))


def _batches(prog):
    return DataPipeline(seed=0, plan=prog.plan, dp_world=prog.dp_world(), seq_len=SEQ,
                        vocab=CFG.vocab).batch_at


def _snapshot(prog, state):
    """The logical state, copied (the optimizer writes the ranks' states in
    place)."""
    tree = ck.StateLayout(prog).logical_state(state)
    return flatten(tree)[1]([t.clone() if isinstance(t, torch.Tensor) else t
                             for t in leaves(tree)])


def _placed(tree, prog):
    return ck.place_tree(leaves(tree), ck.StateLayout(prog).logical_like(), prog)


_RUNS = {}


def _port_run(case, tmp_path):
    """``run_elastic`` of ``case`` on the port (once per worker)."""
    if case not in _RUNS:
        zero, micro, spec, n_steps, every = CASES[case]
        prog = _prog(zero, micro)
        d = tmp_path / f"port_{case}"
        state, report = elastic.run_elastic(
            prog, prog.init_fn(_port_params()), _batches,
            cluster=cluster_for_mesh(prog.mesh), ckpt_dir=str(d), n_steps=n_steps,
            script=elastic.parse_script(spec), ckpt_every=every)
        _RUNS[case] = (prog, state, report, str(d))
    return _RUNS[case]


_BASE = {}


def _baseline(tmp_path, zero=3):
    """4 uninterrupted steps of the ZeRO-``zero`` program under ``run_supervised``
    from the same init: the losses and the logical state after step 2."""
    if zero not in _BASE:
        prog = _prog(zero)
        state, h1 = ft.run_supervised(prog.step_fn, prog.init_fn(_port_params()),
                                      _batches(prog), ckpt_dir=str(tmp_path / f"b{zero}"),
                                      ckpt_every=100, n_steps=2, layout=prog)
        at2 = _snapshot(prog, state)
        _, h2 = ft.run_supervised(prog.step_fn, state, _batches(prog),
                                  ckpt_dir=str(tmp_path / f"b{zero}"), ckpt_every=100,
                                  n_steps=4, start_step=2, layout=prog)
        _BASE[zero] = ([h["loss"] for h in h1 + h2], at2)
    return _BASE[zero]


def _continued(sprog, tree, start, n_steps, tmp_path):
    """The survivor program stepped from ``tree`` (a logical state) with the
    same batches: its losses."""
    _, hist = ft.run_supervised(sprog.step_fn, _placed(tree, sprog), _batches(sprog),
                                ckpt_dir=str(tmp_path / "cont"), ckpt_every=100,
                                n_steps=n_steps, start_step=start, layout=sprog)
    return [h["loss"] for h in hist]


# ---------------------------------------------------------------------------
# The reference's acceptance cases, bit for bit against the port's own runs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["kill_zero3", "kill_pod0_zero3"])
def test_chaos_kill_zero3_checkpointless_bit_exact(tmp_path, case):
    """Kill a pod at step 2 under ZeRO-3 (pod 1, or pod 0, whose ranks hold
    rank 0): the recovery is checkpointless (no checkpoint exists before the
    kill), steps 0-1 equal an uninterrupted run and steps 2-3 the survivor
    program stepped from that run's step-2 state, bit for bit."""
    prog, _, report, _ = _port_run(case, tmp_path)
    assert report.recovery_methods == ["checkpointless"]
    assert report.recoveries[0].step == 2
    assert [h["step"] for h in report.history] == list(range(4))
    killed = CASES[case][2].split(":")[1].split("@")[0]
    assert [p.name for p in report.rebuilds[0].cluster.pods] == \
        [p for p in ("pod0", "pod1") if p != killed]
    sprog = report.final_prog
    assert "pod" not in sprog.mesh.axes and sprog.mesh.size == 2
    assert sprog.plan.micro_per_pod == (4,)
    losses, at2 = _baseline(tmp_path)
    assert [h["loss"] for h in report.history[:2]] == losses[:2]
    assert [h["loss"] for h in report.history[2:]] == _continued(sprog, at2, 2, 4, tmp_path)


def test_chaos_kill_zero1_checkpoint_fallback_bit_exact(tmp_path):
    """Kill pod 1 at step 3 under ZeRO-1: the flat optimizer shards died with
    it, so recovery restores the step-2 checkpoint onto the survivors, and
    the replayed steps equal that checkpoint restored onto the same survivor
    program and stepped with the same batches, bit for bit."""
    prog, _, report, ckpt_dir = _port_run("kill_zero1_fallback", tmp_path)
    rec = report.recoveries[0]
    assert report.recovery_methods == ["checkpoint"] and rec.step == 2
    assert rec.missing and all(p.startswith("['opt']") for p in rec.missing)
    assert [h["step"] for h in report.history] == list(range(4))
    sprog = report.final_prog
    assert ck.latest_step(ckpt_dir) == 4            # the elastic run kept checkpointing
    base = ck.restore(ckpt_dir, 2, None, sprog)
    _, hist = ft.run_supervised(sprog.step_fn, base, _batches(sprog),
                                ckpt_dir=str(tmp_path / "c"), ckpt_every=100, n_steps=4,
                                start_step=2, layout=sprog)
    assert [h["loss"] for h in report.history[2:]] == [h["loss"] for h in hist]
    losses, _ = _baseline(tmp_path, zero=1)
    assert [h["loss"] for h in report.history[:2]] == losses[:2]


def test_chaos_kill_then_rejoin(tmp_path):
    """Pod 1 dies at step 2 and revives at step 4: two epochs, both
    recoveries checkpointless, the final program back on both pods."""
    _, state, report, _ = _port_run("kill_then_rejoin", tmp_path)
    assert report.recovery_methods == ["checkpointless", "checkpointless"]
    assert [e.kind for e in report.events if e.membership_change] == \
        ["pod-dead", "pod-joined"]
    assert [h["step"] for h in report.history] == list(range(6))
    assert report.final_prog.mesh.shape == {"pod": 2, "data": 2}
    assert len(report.rebuilds) == 2 and report.rebuilds[-1].epoch == 2
    assert all(np.isfinite(h["loss"]) for h in report.history)
    assert len(state) == 4


def test_chaos_link_degrade_stays_in_epoch(tmp_path):
    """A degraded link is transport-failover territory: an event, no
    membership change, no rebuild, and the trajectory of an uninterrupted
    run, bit for bit."""
    _, _, report, _ = _port_run("link_degrade", tmp_path)
    assert report.recovery_methods == [] and report.rebuilds == []
    assert [e.kind for e in report.events] == ["link-degraded"]
    assert [h["loss"] for h in report.history] == _baseline(tmp_path)[0][:3]


def test_chaos_hang_ladder_bit_exact(tmp_path):
    """A hung collective at step 1: the ladder retries twice, then rebuilds
    the communicator in place (a new program on the same mesh); no state
    recovery, and the whole trajectory is the uninterrupted run's."""
    prog, _, report, _ = _port_run("hang_ladder", tmp_path)
    assert report.hang_actions == ["retry", "retry", "rebuild"]
    assert report.recovery_methods == []
    assert [rb.event.kind for rb in report.rebuilds] == ["comm-rebuild"]
    assert [p.name for p in report.rebuilds[0].cluster.pods] == ["pod0", "pod1"]
    assert all(ev.pod == "pod1" and ev.step == 1 for ev in report.hang_events)
    assert report.final_prog is not prog and report.final_prog.mesh is prog.mesh
    assert report.final_prog.comm is not prog.comm
    assert [h["loss"] for h in report.history] == _baseline(tmp_path)[0][:3]


def test_chaos_slow_quarantine_replan(tmp_path):
    """A sustained 2.5x-slow pod walks healthy -> suspect -> quarantined, and
    the replan de-weights its share (4, 2) instead of evicting it."""
    _, _, report, _ = _port_run("slow_quarantine", tmp_path)
    assert [e.kind for e in report.events] == ["pod-slow", "pod-quarantined"]
    assert report.recovery_methods == []
    rb = report.rebuilds[0]
    assert rb.event.kind == "pod-quarantined"
    assert [p.name for p in rb.cluster.pods] == ["pod0", "pod1"]
    assert rb.plan.micro_per_pod == (4, 2) and rb.plan.total_micro == 6
    assert [h["step"] for h in report.history] == list(range(10))
    assert report.final_prog.plan.micro_per_pod == (4, 2)
    assert all(np.isfinite(h["loss"]) for h in report.history)


# ---------------------------------------------------------------------------
# Coverage: what a pod loss leaves
# ---------------------------------------------------------------------------

def _jax_state(mesh3, zero, **rc_kw):
    rc = JaxRunConfig(zero_stage=zero, collective_mode="hier", learning_rate=LR,
                      param_dtype="float32", **rc_kw)
    jprog = jax_make_train_program(JMODEL, mesh3, rc, jax_balance.uniform_plan(2, 4, 1))
    return jprog, jprog.init_fn(jax.random.PRNGKey(KEY))


@pytest.mark.parametrize("dead_pod", [0, 1])
def test_zero3_state_is_covered_by_either_pod(dead_pod):
    prog = _prog(3)
    state = prog.init_fn(_port_params())
    state, _ = prog.step_fn(state, _batches(prog)(0))
    dead = elastic.pod_devices(prog.mesh, dead_pod)
    assert dead == [2 * dead_pod, 2 * dead_pod + 1]
    want = leaves(ck.StateLayout(prog).logical_state(state))
    survivors = [None if r in dead else s for r, s in enumerate(state)]   # never read
    flat, missing = elastic.assemble_from_survivors(survivors, dead, prog)
    assert missing == []
    assert len(flat) == len(want)
    assert all(a == b if isinstance(b, int) else torch.equal(a, b) for a, b in zip(flat, want))


def test_zero1_state_is_not_covered_and_names_the_reference_paths(mesh3):
    prog = _prog(1)
    state = prog.init_fn(_port_params())
    _, missing = elastic.assemble_from_survivors(state, elastic.pod_devices(prog.mesh, 1), prog)
    jprog, jstate = _jax_state(mesh3, 1)
    _, jmissing = ref.assemble_from_survivors(jstate, ref.pod_devices(mesh3, 1))
    assert missing and sorted(missing) == sorted(jmissing)
    assert all(p.startswith("['opt']") for p in missing)
    with pytest.raises(elastic.IncompleteCoverage):
        elastic.recover_state(state, 3, _prog(1, shape={"data": 2}),
                              elastic.pod_devices(prog.mesh, 1), layout=prog)


def test_zero3_with_error_feedback_loses_its_residuals(tmp_path, mesh3):
    """The EF residuals are each rank's own, over the whole DP world: they
    die with the pod, and the checkpoint fallback refuses them on the
    smaller world, where the reference refuses them too."""
    rc_kw = dict(backend="pallas", wire_quant="int8")
    prog = _prog(3, **rc_kw)
    state = prog.init_fn(_port_params())
    dead = elastic.pod_devices(prog.mesh, 1)
    _, missing = elastic.assemble_from_survivors(state, dead, prog)
    assert missing and all(p.startswith("['opt']['ef']") for p in missing)
    ck.save(str(tmp_path / "p"), 2, state, prog)
    sprog = rebuild_program(prog, elastic.survivor_mesh(prog.mesh, 1),
                            plan=ft.replan(prog.plan, [balance.PodProfile("pod0", 1.0, 2)]))
    with pytest.raises(ValueError, match="ef"):
        elastic.recover_state(state, 3, sprog, dead, layout=prog, ckpt_dir=str(tmp_path / "p"))
    jprog, jstate = _jax_state(mesh3, 3, **rc_kw)
    _, jmissing = ref.assemble_from_survivors(jstate, ref.pod_devices(mesh3, 1))
    assert sorted(jmissing) == sorted(missing)
    jax_ck.save(str(tmp_path / "r"), 2, jstate)
    jsprog = jax_rebuild_program(jprog, ref.survivor_mesh(mesh3, 1),
                                 plan=jax_balance.uniform_plan(1, 4, 1))
    with pytest.raises(ValueError):
        ref.recover_state(jstate, 3, jsprog, ref.pod_devices(mesh3, 1),
                          ckpt_dir=str(tmp_path / "r"))


def test_survivor_and_member_meshes():
    from repro_torch.elastic.chaos import _member_mesh
    m = ThreadMesh({"pod": 3, "data": 2}, device="cpu")
    assert elastic.pod_devices(m, 2) == [4, 5]
    s = elastic.survivor_mesh(m, 1)
    assert s.shape == {"pod": 2, "data": 2} and s.device == m.device
    assert elastic.survivor_mesh(s, 0).shape == {"data": 2}
    with pytest.raises(ValueError):
        elastic.survivor_mesh(m, 3)
    cluster = cluster_for_mesh(m)
    assert _member_mesh(m, cluster, cluster.pods[:2]).shape == {"pod": 2, "data": 2}
    assert _member_mesh(m, cluster, cluster.pods[2:]).shape == {"data": 2}


# ---------------------------------------------------------------------------
# Every script once through both packages
# ---------------------------------------------------------------------------

def _jax_batches(prog):
    pipe = jax_pipeline.DataPipeline(seed=0, plan=prog.plan, dp_world=prog.dp_world(),
                                     seq_len=SEQ, vocab=JCFG.vocab)
    return lambda s: {k: jnp.asarray(v) for k, v in pipe.batch_at(s).items()}


def _summary(report):
    return {"events": [(e.kind, e.pod, e.step, e.epoch) for e in report.events],
            "rebuilds": [([p.name for p in r.cluster.pods], r.plan.micro_per_pod, r.epoch,
                          r.event.kind) for r in report.rebuilds],
            "recoveries": [(r.method, r.step) for r in report.recoveries],
            "hangs": [(e.action, e.pod, e.step, e.breaches) for e in report.hang_events],
            "steps": [h["step"] for h in report.history],
            "segments": report.segments}


@pytest.mark.parametrize("case", sorted(CASES))
def test_elastic_report_matches_the_reference(tmp_path, mesh3, case):
    zero, micro, spec, n_steps, every = CASES[case]
    rc = JaxRunConfig(zero_stage=zero, collective_mode="hier", learning_rate=LR,
                      param_dtype="float32")
    jprog = jax_make_train_program(JMODEL, mesh3, rc, jax_balance.uniform_plan(2, micro, 1))
    _, jreport = ref.run_elastic(
        jprog, jprog.init_fn(jax.random.PRNGKey(KEY)), _jax_batches,
        cluster=jax_cluster_for_mesh(mesh3), ckpt_dir=str(tmp_path / "ref"), n_steps=n_steps,
        script=ref.parse_script(spec), ckpt_every=every)
    _, _, report, _ = _port_run(case, tmp_path)
    assert _summary(report) == _summary(jreport)
    got = [h["loss"] for h in report.history]
    want = [float(h["loss"]) for h in jreport.history]
    print(f"\n  {case}: losses JAX {want}\n  {' ' * len(case)}        port {got}")
    assert abs(got[0] - want[0]) <= STEP0_ATOL
    np.testing.assert_allclose(got, want, rtol=0, atol=LOSS_ATOL)


# ---------------------------------------------------------------------------
# chip_smoke.py [33], reduced on the CPU
# ---------------------------------------------------------------------------

class _CpuLaunches:
    """Counts on the CPU what the card's kernel wrappers count there: rank
    0's calls of the two ring functions (one fused launch covers every rank
    of the mesh), every rank's attention forwards and the backwards of the
    forwards autograd differentiates (remat runs each forward twice)."""

    def __init__(self, monkeypatch):
        import threading

        from repro_torch.core import mesh as mesh_mod
        from repro_torch.core import tacc
        from repro_torch.kernels import ring_dma
        self.n, lock = {}, threading.Lock()
        self.reset()

        def add(key):
            with lock:
                self.n[key] += 1

        def rank0(key, fn):
            def counted(*a, **kw):
                if mesh_mod.current()[1] == 0:
                    add(key)
                return fn(*a, **kw)
            return counted

        for key in ("ring_reduce_scatter", "ring_all_gather"):
            monkeypatch.setattr(ring_dma, key, rank0(key, getattr(ring_dma, key)))

        class Backward(torch.autograd.Function):
            @staticmethod
            def forward(ctx, x):
                return x.view_as(x)

            @staticmethod
            def backward(ctx, g):
                add("flash_attention_bwd")
                return g

        attention = tacc._TABLE["attention"]["cpu"]

        def counted_attention(*a, **kw):
            add("flash_attention_fwd")
            return Backward.apply(attention(*a, **kw))
        monkeypatch.setitem(tacc._TABLE["attention"], "cpu", counted_attention)

    def reset(self):
        self.n.update(dict.fromkeys(("flash_attention_fwd", "flash_attention_bwd",
                                     "ring_reduce_scatter", "ring_all_gather"), 0))

    def read(self):
        return dict(self.n)


def test_chip_smoke_phase_33_runs_reduced_on_the_cpu(monkeypatch, capsys):
    """``chip_smoke.py`` [33]'s own gates, reduced on the CPU: both runs
    through the launcher, their reports, the lost ranks NaN before the
    recovery, the launches (counted here as the card's wrappers count them)
    against ``elastic_launches``, and the runs bit for bit against the
    uninterrupted and continued ones."""
    import importlib.util
    import pathlib

    from repro_torch.core import hetccl
    from repro_torch.core import mesh as mesh_mod
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    out = cs.phase_elastic(torch, np, mesh_mod, hetccl, _CpuLaunches(monkeypatch),
                           {"nvidia_smi": "the CPU"},
                           flags=["--seq", "16", "--micro-batch", "1", "--n-micro", "2"],
                           device="cpu")
    assert out["a"]["hang_actions"] == ["retry", "retry", "rebuild"]
    assert out["a"]["recovery_methods"] == ["checkpointless"]
    assert out["b"]["recovery_methods"] == ["checkpoint"]
    assert all(v > 0 for run in out.values() for v in run["launches"].values())
    printed = capsys.readouterr().out
    assert printed.count("equal bit for bit True") == 2 and "(NaN)" in printed
