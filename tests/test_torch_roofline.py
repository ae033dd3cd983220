"""The port's step counter and roofline (``repro_torch.roofline``) and its dry
run (``repro_torch.launch.dryrun``), held against the JAX package.

Mirrors ``tests/test_roofline.py`` (one matmul's FLOPs exactly; L layers
counted L times; an all-gather's wire bytes over g = 4 within 1%); its fusion
test flips, since eager elementwise chains are counted per op.  Then:
``model_flops_spec``, ``wire_and_operand_bytes`` and ``Roofline`` equal the
reference's; the dot FLOPs of a reduced smollm-135m prefill and train step
on one rank lie within 2% of ``analyze_hlo`` on the reference's compiled
program once the two terms DESIGN_TORCH.md §24 names are taken out; a step
counted on ``meta`` equals the same step counted on the CPU; and a dry-run
cell of a reduced config of every family runs on ``meta``.
"""
import importlib
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.roofline import analysis as ranalysis
from repro_torch.configs import ARCH_IDS, PAPER_IDS, SHAPES, get_config
from repro_torch.configs.base import RunConfig, ShapeConfig
from repro_torch.core import mesh
from repro_torch.core.balance import uniform_plan
from repro_torch.launch import dryrun
from repro_torch.models import build
from repro_torch.roofline import analysis, hw
from repro_torch.train.trainer import make_train_program

SMOLLM = get_config("smollm-135m").reduced()


@pytest.fixture(scope="module")
def ref_dryrun():
    """The reference's dryrun module, whose import sets XLA_FLAGS for 512
    devices: restored at once (nothing here initializes a backend)."""
    saved = os.environ.get("XLA_FLAGS")
    try:
        return importlib.import_module("repro.launch.dryrun")
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved


def _count(fn):
    with analysis.counting() as sc:
        fn()
    return sc


# ------------------------------------------------------------ calibration

def test_single_matmul_flops_exact():
    M, K, N = 256, 512, 128
    a, b = torch.randn(M, K), torch.randn(K, N)
    st = _count(lambda: a @ b).per_chip()
    assert st.dot_flops == 2 * M * K * N
    assert st.hbm_bytes == (M * K + K * N + M * N) * 4


def test_layer_loop_counted_per_layer():
    L, M, K = 5, 64, 64
    ws, x = torch.randn(L, K, K), torch.randn(M, K)

    def f():
        h = x
        for w in ws:
            h = h @ w
    assert _count(f).per_chip().dot_flops == L * 2 * M * K * K


def test_model_layers_counted_layer_by_layer():
    """The loss of a model of 2L layers counts L layers' FLOPs more than L."""
    toks = torch.zeros((1, 32), dtype=torch.long)

    def flops(n_layers):
        import dataclasses
        model = build(dataclasses.replace(SMOLLM, n_layers=n_layers))
        params = model.init(torch.Generator().manual_seed(0), dtype=torch.float32)
        return _count(lambda: model.loss(params, {"tokens": toks, "labels": toks})
                      ).per_chip().dot_flops

    f2, f4, f6 = flops(2), flops(4), flops(6)
    assert f4 - f2 == f6 - f4 > 0


def test_collective_wire_bytes():
    D = 4096
    m = mesh.ThreadMesh({"data": 4}, device="cpu")
    with analysis.counting() as sc:
        m.run(lambda x: mesh.all_gather(x, "data", tiled=True),
              [torch.ones(D // 4) for _ in range(4)])
    for r in range(4):
        got = sc.ranks[r].per_collective["all-gather"]["wire_bytes"]
        assert abs(got - (3 / 4) * D * 4) / (D * 4) < 0.01


def test_eager_elementwise_chain_counted_per_op():
    """Eager mode launches every op: a chain of 10 (tanh, mul) pairs moves
    its operand and result 20 times (the reference's fusion counts 2)."""
    N = 1 << 16
    x = torch.randn(N)

    def f():
        y = x
        for _ in range(10):
            y = torch.tanh(y) * 1.0001
    assert _count(f).per_chip().hbm_bytes == 20 * 2 * N * 4


# --------------------------------------------------------------- the reference

def test_model_flops_spec_equals_the_reference(ref_dryrun):
    """Every config and shape of both registries: the port's configs through
    both functions, and the reference's (the two the port has not yet among
    them) through the port's function."""
    from repro.configs import ARCH_IDS as RARCH_IDS
    from repro.configs import PAPER_IDS as RPAPER_IDS
    from repro.configs import SHAPES as RSHAPES
    from repro.configs import get_config as rget
    for arch in (*ARCH_IDS, *PAPER_IDS):
        for name, shape in SHAPES.items():
            assert dryrun.model_flops_spec(get_config(arch), shape) == \
                ref_dryrun.model_flops_spec(rget(arch), RSHAPES[name]), (arch, name)
    for arch in (*RARCH_IDS, *RPAPER_IDS):
        for shape in RSHAPES.values():
            assert dryrun.model_flops_spec(rget(arch), shape) == \
                ref_dryrun.model_flops_spec(rget(arch), shape), (arch, shape.name)


def test_wire_and_operand_bytes_and_roofline_equal_the_reference():
    for kind in ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
                 "collective-permute"):
        for g in (1, 2, 3, 4, 8, 64, 256):
            for nbytes in (4.0, 1000.0, 2.0 ** 20, 3.5e9):
                for duplex in (1.0, 0.5):
                    assert analysis.wire_and_operand_bytes(kind, g, nbytes, duplex) == \
                        ranalysis.wire_and_operand_bytes(kind, g, nbytes, duplex)
    kw = dict(dot_flops=3.1e15, hbm_bytes=7.7e12, wire_bytes=2.5e10, cross_pod_bytes=6e9,
              operand_bytes=1e10, per_collective={"all-reduce": {"count": 3, "wire_bytes": 1.0}})
    args = dict(arch="smollm-135m", shape="train_4k", mesh="multi", n_devices=512,
                model_flops_per_step=1.4e18, xla_flops=1.0, xla_bytes=2.0,
                memory_per_device={"temp_bytes": 5})
    got = analysis.Roofline(stats=analysis.HLOStats(**kw), **args)
    want = ranalysis.Roofline(stats=ranalysis.HLOStats(**kw), **args)
    assert got.row() == want.row()
    assert hw.V5E.peak_flops == 197e12 and hw.H100.peak_flops == 989e12
    assert hw.H100.hbm_bw == 3.35e12 and hw.H100.hbm_bytes == 80e9
    h100 = analysis.Roofline(stats=analysis.HLOStats(**kw), hw=hw.H100, **args)
    assert h100.compute_s == kw["dot_flops"] / 989e12


def _attention_gap(passes, B, S):
    """Attention's dot FLOPs that the reference computes and the port does
    not: the reference's chunk is the whole S x S block under the causal
    mask, the port prices the pairs the mask keeps."""
    c = SMOLLM
    return passes * c.n_layers * 4.0 * B * c.n_heads * c.head_dim_ * \
        (S * S - analysis.attention_pairs(S, S))


def test_train_step_dot_flops_within_2pct_of_analyze_hlo():
    from repro.configs import get_config as rget
    from repro.configs.base import RunConfig as RRC
    from repro.core import compat
    from repro.core.balance import uniform_plan as runiform
    from repro.models import build as rbuild
    from repro.train.trainer import make_train_program as rmake
    S, n_micro = 64, 2
    prog = rmake(rbuild(rget("smollm-135m").reduced()), compat.make_mesh((1, 1), ("data", "model")),
                 RRC(zero_stage=1, collective_mode="flat", param_dtype="float32"),
                 runiform(1, n_micro, 1))
    state = jax.eval_shape(prog.init_fn, jax.ShapeDtypeStruct((2,), jnp.uint32))
    batch = {k: jax.ShapeDtypeStruct((n_micro, 1, S), jnp.int32) for k in ("tokens", "labels")}
    want = ranalysis.analyze_hlo(prog.step_fn.lower(state, batch).compile().as_text(), 1)

    port = make_train_program(build(SMOLLM), mesh.ThreadMesh({"data": 1}, device="cpu"),
                              RunConfig(zero_stage=1, collective_mode="flat",
                                        param_dtype="float32"), uniform_plan(1, n_micro, 1))
    states = port.init_fn()
    b = {k: np.zeros((n_micro, 1, S), np.int64) for k in ("tokens", "labels")}
    got = _count(lambda: port.step_fn(states, b)).per_chip().dot_flops
    # DESIGN_TORCH.md §24: (1) attention in its four passes (forward, the
    # remat forward, the gradient's two), the mask's skipped pairs; (2) the
    # port's loss chunk recomputes the LM head's logits in the backward
    # (torch.utils.checkpoint), where XLA's program keeps the forward's
    head = n_micro * 2.0 * S * SMOLLM.d_model * SMOLLM.padded_vocab
    adjusted = got + n_micro * _attention_gap(4, 1, S) - head
    assert abs(adjusted - want.dot_flops) / want.dot_flops < 0.02, (got, want.dot_flops)


def test_prefill_dot_flops_within_2pct_of_analyze_hlo():
    from repro.configs import get_config as rget
    from repro.core import compat
    from repro.models import build as rbuild
    from repro.serve.engine import make_serve_programs as rserve
    B, S = 2, 64
    rmodel = rbuild(rget("smollm-135m").reduced())
    progs = rserve(rmodel, compat.make_mesh((1, 1), ("data", "model")), B, S)
    params = jax.tree.map(lambda m: jax.ShapeDtypeStruct(m.shape, jnp.float32),
                          rmodel.abstract_params(), is_leaf=lambda x: hasattr(x, "axes"))
    hlo = progs.prefill_fn.lower(params, {"tokens": jax.ShapeDtypeStruct((B, S), jnp.int32)}
                                 ).compile().as_text()
    want = ranalysis.analyze_hlo(hlo, 1).dot_flops

    from repro_torch.serve.engine import make_serve_programs
    model = build(SMOLLM)
    params_t = model.init(torch.Generator().manual_seed(0), dtype=torch.float32)
    pp = make_serve_programs(model, S, device="cpu")
    toks = torch.zeros((B, S), dtype=torch.long)
    got = _count(lambda: pp.prefill_fn(params_t, {"tokens": toks})).per_chip().dot_flops
    adjusted = got + _attention_gap(1, B, S)
    assert abs(adjusted - want) / want < 0.02, (got, want)


# --------------------------------------------------------- meta, CPU, variants

@pytest.mark.parametrize("zero,extra", [(1, {"backend": "pallas", "wire_quant": "int8"}),
                                        (3, {"backend": "xla"})])
def test_meta_count_equals_cpu_count(zero, extra):
    model = build(SMOLLM)
    counts = {}
    for dev in ("cpu", "meta"):
        m = (mesh.ThreadMesh({"pod": 2, "data": 2}, device="cpu") if dev == "cpu"
             else mesh.ShapeMesh({"pod": 2, "data": 2}))
        rc = RunConfig(zero_stage=zero, collective_mode="hier", param_dtype="float32", **extra)
        prog = make_train_program(model, m, rc, uniform_plan(2, 4, 1))
        states = (prog.init_fn() if dev == "cpu"
                  else prog.init_fn(dryrun.meta_params(model, torch.float32)))
        b = {k: np.zeros((2, 4, 32), np.int64) for k in ("tokens", "labels")}
        counts[dev] = _count(lambda: prog.step_fn(states, b)).per_chip()
    cpu, meta = counts["cpu"], counts["meta"]
    assert cpu.dot_flops == meta.dot_flops > 0
    assert cpu.wire_bytes == meta.wire_bytes > 0
    assert cpu.cross_pod_bytes == meta.cross_pod_bytes > 0
    assert cpu.per_collective == meta.per_collective


def test_kernel_ops_priced_by_the_function_whatever_the_variant():
    """Attention priced once, by its mask, the same through the chunked
    plain version at two chunk sizes; its internals are not counted."""
    from repro_torch.models.attention import attention
    q, k, v = (torch.randn(2, 48, 4, 16) for _ in range(3))
    counts = [_count(lambda c=c: attention(q, k, v, kind="causal", chunk=c)).per_chip()
              for c in (8, 48)]
    pairs = analysis.attention_pairs(48, 48)
    assert counts[0].dot_flops == counts[1].dot_flops == 4.0 * 2 * 4 * 16 * pairs
    assert counts[0].hbm_bytes == counts[1].hbm_bytes == 4 * q.numel() * 4
    # and with autograd: the gradient's own products, twice the forward's
    qg = q.clone().requires_grad_()
    st = _count(lambda: attention(qg, k, v, kind="causal").sum().backward()).per_chip()
    assert st.dot_flops == 3 * counts[0].dot_flops
    assert analysis.attention_pairs(8, 8, window=3) == 1 + 2 + 3 * 6
    assert analysis.attention_pairs(4, 4, kind="bidir", k_len=3) == 12


# ---------------------------------------------------------------- the dry run

@pytest.mark.parametrize("arch,zero", [("smollm-135m", 3), ("mixtral-8x7b", 1),
                                       ("mamba2-2.7b", 3), ("zamba2-7b", 1)])
def test_dry_run_cell_of_every_family_on_meta(arch, zero):
    cfg = get_config(arch).reduced()
    rec = dryrun.run_cell(arch, "train_4k", "multi", zero=zero, verbose=False, cfg=cfg,
                          plan_mode="auto", shape_cfg=ShapeConfig("train_256", 256, 256, "train"))
    assert rec["status"] == "ok", rec.get("traceback")
    assert rec["devices"] == 256 and rec["hw"] == hw.H100.name
    assert rec["hlo_dot_flops_per_chip"] > 0 and rec["wire_bytes_per_chip"] > 0
    assert rec["cross_pod_bytes_per_chip"] > 0 and rec["fits"]
    assert rec["state_bytes_per_rank"] > 0 and rec["live_peak_bytes"] > 0
    serve = dryrun.run_cell(arch, "prefill_32k", "single", verbose=False, cfg=cfg,
                            shape_cfg=ShapeConfig("prefill_256", 256, 4, "prefill"))
    assert serve["status"] == "ok", serve.get("traceback")
    assert serve["devices"] == 1 and serve["wire_bytes_per_chip"] == 0


def test_production_and_smoke_meshes():
    from repro_torch.launch.mesh import (PRODUCTION_SHAPES, cluster_for_mesh,
                                         make_production_mesh, make_smoke_mesh)
    for multi in (False, True):
        m = make_production_mesh(multi_pod=multi)
        assert SHAPES["train_4k"].global_batch % m.size == 0
        assert m.device.type == "meta"
    assert PRODUCTION_SHAPES["multi"]["pod"] == 4
    assert [p.n_chips for p in cluster_for_mesh(make_production_mesh(multi_pod=True)).pods] \
        == [64] * 4
    smoke = make_smoke_mesh(2, 2, device="cpu")
    assert smoke.shape == {"pod": 2, "data": 2} and smoke.device.type == "cpu"
    assert make_smoke_mesh(data=3, device="cpu").shape == {"data": 3}


def test_dryrun_main_writes_records_and_metric_lines(tmp_path, capsys):
    rc = dryrun.main(["--arch", "smollm-135m", "--shape", "decode_32k", "--mesh", "single",
                      "--out", str(tmp_path), "--metrics-out", str(tmp_path / "m.jsonl")])
    assert rc == 0
    import json
    rec = json.loads((tmp_path / "smollm-135m__decode_32k__single.json").read_text())
    assert rec["status"] == "ok" and math.isfinite(rec["memory_s"])
    from repro_torch.obs import read_metric_lines
    (line,) = read_metric_lines(tmp_path / "m.jsonl")
    assert line["kind"] == "dryrun_cell" and line["meta"]["status"] == "ok"
    assert "DONE failures=0" in capsys.readouterr().out
