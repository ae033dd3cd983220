"""Checkpoints and the supervised loop of the port (``repro_torch.train.
checkpoint``, ``repro_torch.train.ft``), mirroring ``tests/test_checkpoint.py``
on a CPU ThreadMesh: roundtrip, retention, failure recovery bit for bit,
restore onto a mesh of another size under ZeRO-1 and ZeRO-3 (the full
logical arrays bit for bit), a corrupt leaf and the fallback, a stale tmp
dir, async saves and their failures.  Across packages: a directory saved by
the reference's ``checkpoint.save`` restores in the port and the other way
round, with equal ``crc``\\ s (bf16 leaves: the same bytes and crc).
"""
import json
import os

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.train import checkpoint as rck
from repro.train import ft as rft
from repro_torch.configs import get_config
from repro_torch.configs.base import RunConfig
from repro_torch.core.balance import PodProfile, uniform_plan
from repro_torch.core.mesh import ThreadMesh
from repro_torch.core.tree import leaves
from repro_torch.data.pipeline import DataPipeline
from repro_torch.models import build
from repro_torch.train import checkpoint as ck
from repro_torch.train import ft
from repro_torch.train.trainer import make_train_program

CFG = get_config("smollm-135m").reduced()
MODEL = build(CFG)
SEQ = 32


def _prog(shape=None, zero=1, **rc_kw):
    shape = shape or {"pod": 2, "data": 2}
    rc = RunConfig(zero_stage=zero, collective_mode="hier", learning_rate=1e-3,
                   param_dtype="float32", **rc_kw)
    n_pods = shape.get("pod", 1)
    return make_train_program(MODEL, ThreadMesh(shape, device="cpu"), rc,
                              uniform_plan(n_pods, 2 * n_pods, 1))


def _batches(prog):
    pipe = DataPipeline(seed=0, plan=prog.plan, dp_world=prog.dp_world(), seq_len=SEQ,
                        vocab=CFG.vocab)
    return pipe.batch_at


def _same(a, b) -> bool:
    la, lb = leaves(a), leaves(b)
    return len(la) == len(lb) and all(
        x == y if isinstance(x, int) else (x.dtype == y.dtype and torch.equal(x, y))
        for x, y in zip(la, lb))


def _stepped(prog, seed=0):
    state = prog.init_fn(generator=torch.Generator().manual_seed(seed))
    state, _ = prog.step_fn(state, _batches(prog)(0))
    return state


def test_save_restore_roundtrip(tmp_path):
    prog = _prog()
    state = _stepped(prog)
    ck.save(str(tmp_path), 7, state, prog)
    assert ck.latest_step(str(tmp_path)) == 7
    restored = ck.restore(str(tmp_path), 7, None, prog)
    assert len(restored) == 4
    for a, b in zip(state, restored):
        assert _same(a, b)
    manifest = json.loads((tmp_path / "step_00000007" / "manifest.json").read_text())
    assert manifest["step"] == 7 and manifest["leaves"][0]["path"].startswith("['opt']")


def test_retention_keeps_last_k(tmp_path):
    prog = _prog()
    state = prog.init_fn()
    for s in (1, 2, 3, 4, 5):
        ck.save(str(tmp_path), s, state, prog, keep=2)
    steps = sorted(d for d in os.listdir(tmp_path) if d.startswith("step_"))
    assert len(steps) == 2 and steps[-1].endswith("00000005")


def test_failure_recovery_bit_exact(tmp_path):
    """4 steps with a failure injected at step 3 equal an uninterrupted run:
    losses and final state, bit for bit."""
    prog = _prog({"pod": 2, "data": 1})
    runs = {}
    for name, fail_at in (("fail", 3), ("clean", None)):
        s0 = prog.init_fn(generator=torch.Generator().manual_seed(1))
        ck.save(str(tmp_path / name), 0, s0, prog)
        runs[name] = ft.run_supervised(
            prog.step_fn, s0, _batches(prog), ckpt_dir=str(tmp_path / name), ckpt_every=2,
            n_steps=4, layout=prog, fail_at=fail_at, backoff_base=0.0)
    (s_fail, h_fail), (s_clean, h_clean) = runs["fail"], runs["clean"]
    by_fail = {h["step"]: h["loss"] for h in h_fail}
    by_clean = {h["step"]: h["loss"] for h in h_clean}
    assert sorted(by_fail) == sorted(by_clean) == list(range(4))
    assert [h["step"] for h in h_fail] == [0, 1, 2, 2, 3]      # step 2 ran again
    assert all(by_fail[s] == by_clean[s] for s in range(4))
    assert all(_same(a, b) for a, b in zip(s_fail, s_clean))


def test_resume_from_the_latest_checkpoint_equals_the_straight_run(tmp_path):
    """With error feedback on: the residuals resume too."""
    prog = _prog({"pod": 2, "data": 1}, backend="pallas", wire_quant="int8")
    s0 = prog.init_fn()
    straight, h_straight = ft.run_supervised(prog.step_fn, s0, _batches(prog),
                                             ckpt_dir=str(tmp_path / "a"), ckpt_every=2,
                                             n_steps=4, layout=prog)
    first = prog.init_fn()
    ft.run_supervised(prog.step_fn, first, _batches(prog), ckpt_dir=str(tmp_path / "b"),
                      ckpt_every=2, n_steps=2, layout=prog)
    fresh = _prog({"pod": 2, "data": 1}, backend="pallas", wire_quant="int8")   # a fresh program
    resumed, h_resumed = ft.run_supervised(fresh.step_fn, fresh.init_fn(), _batches(fresh),
                                           ckpt_dir=str(tmp_path / "b"), ckpt_every=2,
                                           n_steps=4, layout=fresh)
    assert [h["step"] for h in h_resumed] == [2, 3]
    assert [h["loss"] for h in h_resumed] == [h["loss"] for h in h_straight[2:]]
    assert all(_same(a, b) for a, b in zip(straight, resumed))


@pytest.mark.parametrize("zero", [1, 3])
@pytest.mark.parametrize("target", [{"data": 2}, {"pod": 2, "data": 1}, {"data": 4},
                                    {"pod": 1, "data": 3}])
def test_restore_onto_a_mesh_of_another_size(tmp_path, zero, target):
    """A (2, 2) state restores onto another mesh: params, master and moments
    equal the saved full arrays bit for bit, and it takes a step."""
    prog = _prog(zero=zero)
    state = _stepped(prog, seed=2)
    ck.save(str(tmp_path), 3, state, prog)
    saved = ck.StateLayout(prog).logical_state(state)
    other = _prog(target, zero=zero)
    restored = ck.restore(str(tmp_path), 3, None, other)
    assert len(restored) == other.mesh.size
    assert _same(saved, ck.StateLayout(other).logical_state(restored))
    _, m = other.step_fn(restored, _batches(other)(1))
    assert np.isfinite(float(m["loss"]))


def test_error_feedback_residuals_do_not_reshard(tmp_path):
    """EF residuals are each rank's own: the same world restores them, a
    world of another size fails on their shape (as in the reference)."""
    prog = _prog(backend="pallas", wire_quant="int8")
    state = _stepped(prog)
    assert "ef" in state[0]["opt"]
    ck.save(str(tmp_path), 1, state, prog)
    same = ck.restore(str(tmp_path), 1, None, _prog({"pod": 1, "data": 4}, backend="pallas",
                                                    wire_quant="int8"))
    assert _same([s["opt"]["ef"] for s in state], [s["opt"]["ef"] for s in same])
    with pytest.raises(ValueError, match=r"shape mismatch \['opt'\]\['ef'\]"):
        ck.restore(str(tmp_path), 1, None, _prog({"data": 2}, backend="pallas",
                                                 wire_quant="int8"))


def test_straggler_monitor_and_replan():
    mon = ft.StragglerMonitor(alpha=0.5, tolerance=0.2)
    assert not mon.observe(1.0)
    assert not mon.observe(1.05)
    assert mon.observe(2.0)
    plan = uniform_plan(2, 8, 2)
    new = ft.replan(plan, [PodProfile("a", 3.0), PodProfile("b", 1.0)])
    assert new.micro_per_pod == (6, 2) and new.total_micro == plan.total_micro
    assert [ft._backoff_s(k, 0.05, 5.0, 0.25) for k in (1, 2, 3)] == \
        [rft._backoff_s(k, 0.05, 5.0, 0.25) for k in (1, 2, 3)]


def test_replan_auto_equals_the_reference():
    from repro import plan as rplan
    from repro.configs import get_config as rget
    from repro.core import topology as rtopo
    from repro_torch import plan
    from repro_torch.core import topology

    def replanned(p, topo, cfg, pods):
        req = p.plan_request(topo.paper_cluster(), cfg, global_batch=64, seq_len=1024,
                             data_axis=4, zero_stage=1)
        tp = p.autotune(req)
        return (ft if p is plan else rft).replan_auto(
            tp, pods, observed_step_s=2.0 * tp.modeled_step_s).summary()

    got = replanned(plan, topology, CFG, [PodProfile("nvidia", 3.0), PodProfile("amd", 1.0)])
    from repro.core.balance import PodProfile as RProfile
    want = replanned(rplan, rtopo, rget("smollm-135m").reduced(),
                     [RProfile("nvidia", 3.0), RProfile("amd", 1.0)])
    assert json.dumps(got, sort_keys=True, default=str) == \
        json.dumps(want, sort_keys=True, default=str)


def test_corrupt_leaf_detected_and_fallback(tmp_path):
    prog = _prog()
    state = prog.init_fn(generator=torch.Generator().manual_seed(3))
    ck.save(str(tmp_path), 2, state, prog)
    ck.save(str(tmp_path), 4, state, prog)
    victim = tmp_path / "step_00000004" / "arr_00000.npy"
    arr = np.load(victim)
    arr.flat[0] += 1.0
    np.save(victim, arr)
    with pytest.raises(ck.CorruptCheckpointError):
        ck.restore(str(tmp_path), 4, None, prog)
    ck.restore(str(tmp_path), 4, None, prog, verify=False)
    step, restored = ck.restore_latest(str(tmp_path), None, prog)
    assert step == 2 and all(_same(a, b) for a, b in zip(state, restored))


def test_restore_latest_all_corrupt_raises(tmp_path):
    prog = _prog()
    ck.save(str(tmp_path), 1, prog.init_fn(), prog)
    os.remove(tmp_path / "step_00000001" / "arr_00000.npy")
    with pytest.raises(ck.CorruptCheckpointError):
        ck.restore_latest(str(tmp_path), None, prog)
    with pytest.raises(FileNotFoundError):
        ck.restore_latest(str(tmp_path / "empty"), None, prog)


def test_stale_tmp_swept_and_not_restorable(tmp_path):
    prog = _prog()
    stale = tmp_path / "step_00000009.tmp"
    stale.mkdir(parents=True)
    (stale / "garbage").write_text("partial write")
    assert ck.retained_steps(str(tmp_path)) == [] and ck.latest_step(str(tmp_path)) is None
    ck.save(str(tmp_path), 1, prog.init_fn(), prog)
    assert not stale.exists() and ck.retained_steps(str(tmp_path)) == [1]


def test_async_save_copies_to_the_host_first(tmp_path):
    """save(blocking=False) returns the future; the state it writes is the
    one at the call, though the caller overwrites its tensors after."""
    tree = {"w": torch.arange(6, dtype=torch.float32), "b": [torch.ones(2, 2)]}
    want = {"w": tree["w"].clone(), "b": [tree["b"][0].clone()]}
    fut = ck.save(str(tmp_path), 5, tree, blocking=False)
    tree["w"].mul_(-1)
    assert fut.result().endswith("step_00000005")
    ck.wait_pending()
    assert _same(ck.restore(str(tmp_path), 5, tree), want)


def test_background_save_failure_surfaces_at_next_save(tmp_path):
    blocker = tmp_path / "not_a_dir"
    blocker.write_text("file where the ckpt dir should go")
    bad = ck.save_async(str(blocker), 1, {"w": torch.ones(4)})
    with pytest.raises(Exception):
        bad.result()
    with pytest.raises(Exception):
        ck.save_async(str(tmp_path / "ok"), 2, {"w": torch.ones(4)})
    ck.wait_pending()


# --------------------------------------------------------------- across packages

def _tree(seed):
    rng = np.random.default_rng(seed)
    return {"params": {"w": rng.standard_normal((7, 5)).astype(np.float32),
                       "b": [rng.standard_normal(3).astype(np.float32),
                             rng.standard_normal((2, 2, 2)).astype(np.float32)]},
            "scale": rng.standard_normal(()).astype(np.float32)}


def _crcs(path):
    m = json.loads((path / "manifest.json").read_text())
    return [(e["path"], e["shape"], e["dtype"], e["crc"]) for e in m["leaves"]]


def test_reference_checkpoint_restores_in_the_port_and_back(tmp_path):
    tree = _tree(0)
    rck.save(str(tmp_path / "ref"), 3, {k: jnp.asarray(v) if not isinstance(v, dict) else
                                        {kk: (jnp.asarray(vv) if not isinstance(vv, list) else
                                              [jnp.asarray(x) for x in vv])
                                         for kk, vv in v.items()}
                                        for k, v in tree.items()})
    port_tree = {"params": {"w": torch.from_numpy(tree["params"]["w"]),
                            "b": [torch.from_numpy(x) for x in tree["params"]["b"]]},
                 "scale": torch.from_numpy(tree["scale"])}
    ck.save(str(tmp_path / "port"), 3, port_tree)
    assert _crcs(tmp_path / "ref" / "step_00000003") == \
        _crcs(tmp_path / "port" / "step_00000003")
    got = ck.restore(str(tmp_path / "ref"), 3, port_tree)
    assert _same(got, port_tree)
    like = {"params": {"w": jnp.zeros((7, 5)), "b": [jnp.zeros(3), jnp.zeros((2, 2, 2))]},
            "scale": jnp.zeros(())}
    back = rck.restore(str(tmp_path / "port"), 3, like)
    np.testing.assert_array_equal(np.asarray(back["params"]["w"]), tree["params"]["w"])
    np.testing.assert_array_equal(np.asarray(back["params"]["b"][1]), tree["params"]["b"][1])
    np.testing.assert_array_equal(np.asarray(back["scale"]), tree["scale"])


def test_bf16_leaves_keep_the_reference_bytes_and_crc(tmp_path):
    x = np.random.default_rng(1).standard_normal((4, 6)).astype(np.float32)
    rck.save(str(tmp_path / "ref"), 1, {"w": x.astype(ml_dtypes.bfloat16)})
    t = torch.from_numpy(x).to(torch.bfloat16)
    ck.save(str(tmp_path / "port"), 1, {"w": t})
    (ref_leaf,), (port_leaf,) = (_crcs(tmp_path / d / "step_00000001") for d in ("ref", "port"))
    assert port_leaf == ref_leaf == ("['w']", [4, 6], "bfloat16", ref_leaf[3])
    for d in ("ref", "port"):          # the port reads both packages' bf16 leaves
        got = ck.restore(str(tmp_path / d), 1, {"w": t})
        assert got["w"].dtype == torch.bfloat16 and torch.equal(got["w"], t)


def test_chip_smoke_phase_32_runs_reduced_on_the_cpu(capsys):
    """``chip_smoke.py`` [32]'s own gates, reduced on the CPU: the traced
    run's spans against the dispatches, resume and reshard bit for bit, the
    counter against ``meta``, two dry-run cells."""
    import importlib.util
    import pathlib

    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core import hetccl
    from repro_torch.core import mesh as mesh_mod
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    cells = (("smollm-135m", "train_4k", "multi", "auto",
              {"cfg": CFG, "shape_cfg": ShapeConfig("train_256", 256, 256, "train")}),
             ("smollm-135m", "decode_32k", "single", "manual",
              {"cfg": CFG, "shape_cfg": ShapeConfig("decode_256", 256, 4, "decode")}))
    out = cs.phase_ckpt_obs(torch, np, get_config, build, mesh_mod, hetccl,
                            {"a": {"median_ms": 1000.0}}, {"nvidia_smi": "the CPU"},
                            flags=["--seq", "32", "--micro-batch", "1", "--n-micro", "2"],
                            device="cpu", dryrun_cells=cells)
    assert len(out["losses"]) == cs.CKPT_STEPS and out["calibration_rows"]
    assert out["card_hbm_bytes_rank0"] == out["meta_hbm_bytes_rank0"]
    assert set(out["dryrun"]) == {"smollm-135m/train_4k/multi", "smollm-135m/decode_32k/single"}
    printed = capsys.readouterr().out
    assert "equal bit for bit True" in printed and "one-card roofline" in printed
