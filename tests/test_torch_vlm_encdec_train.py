"""Training the VLM (qwen2-vl-72b) and the encoder-decoder (whisper-medium):
the port's trainer, gather plans, batch leaves, launcher and dry run
against the JAX package's.

Reduced configs in f32 (qwen2-vl: 4 layers, d_model 128, 4/2 heads of 32,
M-RoPE sections (4, 6, 6); whisper: 2 + 4 layers, d_model 128, 4/2 heads
of 32, 64 frames), weights from the JAX ``init`` carried across with
``convert.params_from_jax``.  Reduced whisper's stacked projections are
redrawn at std 1/sqrt(fan-in) from a seeded numpy RandomState, as
``chip_smoke.redraw_projections`` draws them on the card: at the
reference's init (ROADMAP C5) its f32 forward is chaotic
(``tests/test_torch_encdec.py``).  Tokens, labels, frames and the image
grid's positions (``chip_smoke.mrope_grid``) come from seeded numpy
RandomStates.  The JAX trainer runs on ``mesh3`` (pod=2, data=2, model=2)
with ``extra_batch_specs`` for ``mrope`` and ``frames``, the port's on a
CPU ``ThreadMesh({"pod": 2, "data": 2})``, 3 steps.

Tolerances, with their bases (readings on these inputs):

* qwen2-vl's steps against the JAX trainer: the reduced dense model at
  init is ill-conditioned (``tests/test_torch_train.py``'s note), so the
  smollm tolerances: step 0's loss within 1e-5 (reading 9.5e-7), the
  losses within 1e-2, the parameters within a relative L2 of 2e-3
  (reading 5.2e-4);
* whisper's (redrawn, well conditioned): step 0's loss within 1e-5
  (reading 0), the losses within 1e-4 (reading 4.3e-6), the parameters
  within a relative L2 of 1e-4 (reading 1.6e-5);
* ZeRO-3 against ZeRO-1 in the port, step 0 (f32): the same loss bit for
  bit (the gathers concatenate the shards), the gradient norm within 1e-6
  relative and each leaf's parameters after the step within 1e-6 relative
  (readings: the norm 0 and 1.1e-7, the worst leaf 4.3e-9 and 1.7e-7;
  the two stages sum the same f32 gradients in
  another order);
* the plain flash backward at Sq != Sk against autograd of the plain
  forward, both in f32: 1e-5 of each gradient's largest element (the same
  products summed in another order);
* the dry run's dot FLOPs against ``analyze_hlo`` of the reference's
  compiled program: 2% once the two terms DESIGN_TORCH.md §24 names are
  taken out, as ``tests/test_torch_roofline.py`` holds smollm's.
"""
import dataclasses
import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs.base import RunConfig as JaxRunConfig  # noqa: E402
from repro.core import balance as jax_balance  # noqa: E402
from repro.core import compat  # noqa: E402
from repro.models import build as jax_build  # noqa: E402
from repro.models import transformer as jax_tf  # noqa: E402
from repro.models.common import make_rules as jax_make_rules  # noqa: E402
from repro.roofline import analysis as ranalysis  # noqa: E402
from repro.train.trainer import make_train_program as jax_make_train_program  # noqa: E402
from repro_torch.configs import SHAPES, get_config  # noqa: E402
from repro_torch.configs.base import RunConfig, ShapeConfig  # noqa: E402
from repro_torch.convert import params_from_jax, shard_params, unshard_params  # noqa: E402
from repro_torch.core import balance, mesh  # noqa: E402
from repro_torch.core.tree import leaves  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.models import build  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.models.common import make_rules  # noqa: E402
from repro_torch.models.registry import Model  # noqa: E402
from repro_torch.roofline import analysis  # noqa: E402
from repro_torch.train import trainer  # noqa: E402
from repro_torch.train.trainer import make_train_program  # noqa: E402

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(smoke)

VLM, ENCDEC = "qwen2-vl-72b", "whisper-medium"
SEQ, N_MICRO, ROWS = 32, 2, 4            # the global batch: 2 micro-steps of 4 rows
GRID_START, GRID_SIDE = 4, 4
# (step-0 loss atol, losses atol, parameters relative L2): the module note
TOLS = {VLM: (1e-5, 1e-2, 2e-3), ENCDEC: (1e-5, 1e-4, 1e-4)}
ZERO_GRAD_NORM_RTOL, ZERO_LEAF_REL_L2 = 1e-6, 1e-6


@pytest.fixture
def one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _redrawn(tree, rng, stacked=False):
    """The stacked blocks' projections of ``tree`` drawn again as N(0, 1) /
    sqrt(fan-in), leaf by leaf in sorted order."""
    out = {}
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out[k] = _redrawn(v, rng, stacked or k.endswith("blocks"))
        elif stacked and k in smoke.PROJ_FAN_IN_DIMS:
            fan_in = np.prod(v.shape[1:1 + smoke.PROJ_FAN_IN_DIMS[k]])
            out[k] = (rng.randn(*v.shape) / np.sqrt(fan_in)).astype(v.dtype)
        else:
            out[k] = v
    return out


_CARRIED = {}


def _carried(arch):
    """(cfg, jcfg, the JAX init tree as numpy, port model, port params)."""
    if arch not in _CARRIED:
        cfg, jcfg = get_config(arch).reduced(), jax_get_config(arch).reduced()
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
        jmodel, model = jax_build(jcfg), build(cfg)
        tree = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(0), dtype="float32"))
        if arch == ENCDEC:
            tree = _redrawn(tree, np.random.RandomState(3))
        _CARRIED[arch] = (cfg, jcfg, tree, model,
                          params_from_jax(tree, metas=model.abstract_params()))
    return _CARRIED[arch]


def _batch(cfg, step, rows=ROWS, seq=SEQ):
    """The global batch of ``step``: tokens and labels (N_MICRO, rows, seq)
    int32, the VLM's ``mrope`` (N_MICRO, 3, rows, seq) holding an image grid
    whose rows differ, the encoder-decoder's ``frames`` (N_MICRO, rows,
    n_frames, d_model) f32 unit normals."""
    rng = np.random.RandomState(100 + step)
    b = {k: rng.randint(0, cfg.vocab, (N_MICRO, rows, seq)).astype(np.int32)
         for k in ("tokens", "labels")}
    if cfg.family == "vlm":
        # each row its grid at its own start, so a row taken from another
        # rank's slice shows
        grids = [smoke.mrope_grid(np, 1, seq, GRID_START + r, GRID_SIDE)[:, 0]
                 for r in range(rows)]
        b["mrope"] = np.stack([np.stack(grids, 1)] * N_MICRO).astype(np.int32)
    if cfg.family == "encdec":
        b["frames"] = rng.randn(N_MICRO, rows, cfg.n_frames, cfg.d_model).astype(np.float32)
    return b


def _extra_specs(cfg):
    dpa = ("pod", "data")
    return ({"mrope": P(None, None, dpa, None)} if cfg.family == "vlm"
            else {"frames": P(None, dpa, None, None)})


def _rel_l2(got, want) -> float:
    num = sum(float(((np.asarray(g, np.float64) - w) ** 2).sum()) for g, w in zip(got, want))
    return (num / sum(float((np.asarray(w, np.float64) ** 2).sum()) for w in want)) ** 0.5


# ---------------------------------------------------------------------------
# whole steps against the JAX trainer
# ---------------------------------------------------------------------------

def _jax_run(mesh3, arch, rc_kw, n_steps):
    cfg, jcfg, tree, _, _ = _carried(arch)

    class Carried(type(jax_build(jcfg))):
        """The reference's Model whose ``init`` is the carried tree."""

        def init(self, key, dtype=None):
            return jax.tree.map(lambda a: jnp.asarray(a, dtype or "float32"), tree)

    prog = jax_make_train_program(Carried(jcfg), mesh3, JaxRunConfig(**rc_kw),
                                  jax_balance.uniform_plan(2, 4, 1),
                                  extra_batch_specs=_extra_specs(cfg))
    state = prog.init_fn(jax.random.PRNGKey(0))
    losses = []
    for s in range(n_steps):
        state, met = prog.step_fn(state, {k: jnp.asarray(v) for k, v in _batch(cfg, s).items()})
        losses.append(float(met["loss"]))
    return losses, [np.asarray(x) for x in jax.tree.leaves(jax.device_get(state["params"]))]


def _port_run(arch, rc_kw, n_steps, m=None):
    cfg, _, _, model, params = _carried(arch)
    m = m or mesh.ThreadMesh({"pod": 2, "data": 2}, device="cpu")
    prog = make_train_program(model, m, RunConfig(**rc_kw), balance.uniform_plan(2, 4, 1))
    state = prog.init_fn(params)
    losses, norms = [], []
    for s in range(n_steps):
        state, met = prog.step_fn(state, _batch(cfg, s))
        losses.append(met["loss"].item())
        norms.append(met["grad_norm"].item())
    return prog, state, losses, norms


def _full_params(model, prog, state):
    if prog.rc.zero_stage == 3:
        return unshard_params([state[0]["params"], state[1]["params"]], model.abstract_params())
    return state[0]["params"]


# each family under both stages and on both backends
TRAIN_CASES = [(VLM, 1, "xla"), (VLM, 3, "pallas"), (ENCDEC, 1, "pallas"), (ENCDEC, 3, "xla")]


@pytest.mark.parametrize("arch,zero,backend", TRAIN_CASES,
                         ids=[f"{a}-zero{z}-{b}" for a, z, b in TRAIN_CASES])
def test_trainer_matches_jax(mesh3, one_thread, arch, zero, backend):
    """3 steps of the port's trainer against the JAX trainer with
    ``extra_batch_specs`` from the same init and batches (the VLM's batch
    holds an image grid in ``mrope``, the encoder-decoder's ``frames``):
    losses and the parameters after the steps (ZeRO-3's rebuilt from the
    "data" ranks' shards) within TOLS; every rank ends with the same
    parameters (ZeRO-3: each pod's ranks the same shards)."""
    rc_kw = dict(zero_stage=zero, learning_rate=1e-3, param_dtype="float32",
                 collective_mode="hier", backend=backend)
    want, jleaves = _jax_run(mesh3, arch, rc_kw, 3)
    cfg, _, _, model, _ = _carried(arch)
    prog, state, got, _ = _port_run(arch, rc_kw, 3)
    rel = _rel_l2([p.numpy() for p in leaves(_full_params(model, prog, state))], jleaves)
    print(f"\n  {arch} ZeRO-{zero} {backend}: losses JAX {want}\n  port {got}; params relative "
          f"L2 {rel:.3e}")
    step0_atol, loss_atol, param_rel = TOLS[arch]
    assert abs(got[0] - want[0]) <= step0_atol
    np.testing.assert_allclose(got, want, rtol=0, atol=loss_atol)
    assert rel <= param_rel
    for a, b in ((1, 0), (3, 2)) if zero == 1 else ((2, 0), (3, 1)):
        assert all(torch.equal(x, y) for x, y in zip(leaves(state[a]["params"]),
                                                     leaves(state[b]["params"])))


@pytest.mark.parametrize("arch", [VLM, ENCDEC])
def test_zero3_matches_zero1_at_step_0(one_thread, arch):
    """The port's ZeRO-3 against its own ZeRO-1 from one init and batch
    (hier, pallas, remat, f32): step 0's loss bit for bit, the gradient
    norm within ZERO_GRAD_NORM_RTOL and each leaf's parameters after the
    step within ZERO_LEAF_REL_L2."""
    _, _, _, model, _ = _carried(arch)
    out = {}
    for zero in (3, 1):
        prog, state, losses, norms = _port_run(arch, dict(
            zero_stage=zero, learning_rate=1e-3, param_dtype="float32",
            collective_mode="hier", backend="pallas"), 1)
        out[zero] = (losses[0], norms[0], leaves(_full_params(model, prog, state)))
    rel = [float((a - b).norm() / b.norm()) if b.norm() else float((a - b).norm())
           for a, b in zip(out[3][2], out[1][2])]
    (l3, g3, _), (l1, g1, _) = out[3], out[1]
    print(f"\n  {arch}: step-0 loss {l3} / {l1}, grad norm relative {abs(g3 - g1) / g1:.3e}, "
          f"worst leaf relative L2 {max(rel):.3e}")
    assert l3 == l1
    assert abs(g3 - g1) <= ZERO_GRAD_NORM_RTOL * g1
    assert max(rel) <= ZERO_LEAF_REL_L2


# ---------------------------------------------------------------------------
# the encoder-decoder's gather plans and shards
# ---------------------------------------------------------------------------

def test_encdec_gather_plans_and_shards_match_the_reference(mesh3):
    """ZeRO-3's plans of ``enc_blocks`` and ``dec_blocks`` (one layer's slice)
    and of the top-level leaves (``Model._gather_top``'s) equal the
    reference's ``gather_plan_of`` over its ``make_rules`` at
    ``zero_stage=3`` on ``mesh3``: ``pos_embed`` on dim 1, the norms and
    their shifts on dim 0, the biases without an "embed" dim replicated;
    ``shard_params`` cuts each leaf there and ``unshard_params`` gives the
    full tree back; the trainer's ``fsdp_dims`` are those dims."""
    cfg, jcfg, _, model, params = _carried(ENCDEC)
    jmetas, metas = jax_build(jcfg).abstract_params(), model.abstract_params()
    jrules, rules = jax_make_rules(jcfg, mesh3, 3), make_rules(3, 2)

    def dims(plan):
        return [p.dim for p in jax.tree.leaves(plan, is_leaf=lambda x: hasattr(x, "dim"))]

    for key in ("enc_blocks", "dec_blocks"):
        assert dims(jax_tf.gather_plan_of(jmetas[key], jrules, scanned=True)) == \
            [p.dim for p in leaves(tf.gather_plan_of(metas[key], rules, scanned=True))]
    top = sorted(k for k in metas if not k.endswith("blocks"))
    assert top == ["embed", "enc_norm", "enc_norm_b", "final_norm", "final_norm_b", "lm_head",
                   "pos_embed"]
    jtop = jax_tf.gather_plan_of({k: jmetas[k] for k in top}, jrules, scanned=False)
    ptop = tf.gather_plan_of({k: metas[k] for k in top}, rules, scanned=False)
    assert {k: jtop[k].dim for k in top} == {k: ptop[k].dim for k in top} == {
        "embed": 1, "enc_norm": 0, "enc_norm_b": 0, "final_norm": 0, "final_norm_b": 0,
        "lm_head": 0, "pos_embed": 1}
    dec = tf.gather_plan_of(metas["dec_blocks"], rules, scanned=True)
    assert (dec["cross_attn"]["bq"].dim, dec["cross_attn"]["bo"].dim, dec["mlp"]["b1"].dim,
            dec["ln3_b"].dim) == (None, 0, None, 0)
    shards = [shard_params(params, metas, i, 2) for i in range(2)]
    D = cfg.d_model
    assert tuple(shards[1]["pos_embed"].shape) == (metas["pos_embed"].shape[0], D // 2)
    assert torch.equal(shards[1]["dec_blocks"]["cross_attn"]["wo"],
                       params["dec_blocks"]["cross_attn"]["wo"][..., D // 2:])
    assert torch.equal(shards[0]["enc_blocks"]["attn"]["bq"], params["enc_blocks"]["attn"]["bq"])
    assert all(torch.equal(a, b) for a, b in zip(leaves(unshard_params(shards, metas)),
                                                 leaves(params)))
    prog = make_train_program(model, mesh.ThreadMesh({"pod": 2, "data": 2}, device="cpu"),
                              RunConfig(zero_stage=3), balance.uniform_plan(2, 4, 1))
    want = [None if a.shape == b.shape else next(i for i, (x, y) in enumerate(
        zip(a.shape, b.shape)) if x != y) for a, b in zip(leaves(params), leaves(shards[0]))]
    assert prog.fsdp_dims == want


# ---------------------------------------------------------------------------
# the batch leaves
# ---------------------------------------------------------------------------

def _seen_rows(arch, batch):
    """{(rank, micro-step): the micro-batch ``Model.loss`` got} over one
    step of a ZeRO-1 program on (pod=2, data=2)."""
    cfg, _, _, model, params = _carried(arch)
    m = mesh.ThreadMesh({"pod": 2, "data": 2}, device="cpu")
    prog = make_train_program(model, m, RunConfig(zero_stage=1, param_dtype="float32",
                                                  collective_mode="hier"),
                              balance.uniform_plan(2, 4, 1))
    state = prog.init_fn(params)
    seen, real = {}, Model.loss

    def rec(self, p, mb, **kw):
        r = mesh.axis_index("pod") * 2 + mesh.axis_index("data")
        i = sum(1 for key in seen if key[0] == r)
        seen[(r, i)] = {k: v.clone() for k, v in mb.items()}
        return real(self, p, mb, **kw)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(Model, "loss", rec)
        prog.step_fn(state, batch)
    return seen


def _wrong_leaves(arch, batch) -> set:
    """The leaves of ``batch`` that some rank's micro-batch does not hold as
    its own rows (pod-major DP order, one row a rank), in its dtype and
    shape; "steps" if the micro-batches seen are not one per rank and
    micro-step."""
    seen = _seen_rows(arch, batch)
    wrong = set() if len(seen) == 4 * N_MICRO else {"steps"}
    for (r, i), mb in seen.items():
        want = {"tokens": torch.from_numpy(batch["tokens"][i, r:r + 1]).long()}
        if "mrope" in batch:
            want["mrope"] = torch.from_numpy(batch["mrope"][i, :, r:r + 1]).long()
        if "frames" in batch:
            want["frames"] = torch.from_numpy(batch["frames"][i, r:r + 1])
        for k, w in want.items():
            if mb[k].dtype != w.dtype or mb[k].shape != w.shape or not torch.equal(mb[k], w):
                wrong.add(k)
    return wrong


def test_rank_batch_gives_each_rank_its_rows(one_thread, monkeypatch):
    """Each rank's micro-batch holds its own rows of every leaf: ``mrope``
    sliced on its batch dim (2) as int64, ``frames`` on dim 1 in f32.  Two
    planted faults of ``mrope``'s slice: on its stream axis (dim 1, of size
    3 where the four ranks need rows 0 to 3) the step raises; at the right
    dim but each rank's offset moved to the next rank's row, shapes and the
    other leaves are right and the row comparison alone fails (each row's
    grid starts at its own token, so a row from another rank shows).  A
    batch of the encoder-decoder without ``frames`` raises naming the leaf;
    the VLM trains on text-only positions without ``mrope``."""
    vcfg, ecfg = _carried(VLM)[0], _carried(ENCDEC)[0]
    vbatch, ebatch = _batch(vcfg, 0), _batch(ecfg, 0)
    assert _wrong_leaves(VLM, vbatch) == set()
    assert _wrong_leaves(ENCDEC, ebatch) == set()
    with monkeypatch.context() as mp:
        mp.setitem(trainer._BATCH_DIM, "mrope", 1)
        with pytest.raises(RuntimeError):
            _seen_rows(VLM, vbatch)
    real_narrow = torch.Tensor.narrow

    def next_rank_rows(t, dim, start, length):
        if t.dim() == 4 and t.shape[1] == 3 and dim == 2:      # mrope (n_micro, 3, B, S)
            start = (start + length) % t.shape[dim]
        return real_narrow(t, dim, start, length)

    with monkeypatch.context() as mp:
        mp.setattr(torch.Tensor, "narrow", next_rank_rows)
        assert _wrong_leaves(VLM, vbatch) == {"mrope"}
    text = _seen_rows(VLM, {k: vbatch[k] for k in ("tokens", "labels")})
    assert all("mrope" not in mb for mb in text.values())
    _, _, _, model, params = _carried(ENCDEC)
    prog = make_train_program(model, mesh.ThreadMesh({"pod": 2, "data": 2}, device="cpu"),
                              RunConfig(param_dtype="float32"), balance.uniform_plan(2, 4, 1))
    with pytest.raises(ValueError, match="frames"):
        prog.step_fn(prog.init_fn(params), {k: ebatch[k] for k in ("tokens", "labels")})


# ---------------------------------------------------------------------------
# the launcher and the dry run
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,zero", [(VLM, 1), (VLM, 3), (ENCDEC, 1), (ENCDEC, 3)])
def test_launcher_trains_both_families(capsys, arch, zero):
    from repro_torch.launch import train
    hist = train.main(["--device", "cpu", "--arch", arch, "--zero", str(zero), "--steps", "2",
                       "--seq", "16", "--backend", "pallas"])
    assert len(hist) == 2 and np.isfinite(hist).all()
    assert f"zero={zero}" in capsys.readouterr().out
    if arch == ENCDEC:
        cfg = _carried(ENCDEC)[0]
        plan = balance.uniform_plan(2, 4, 1)
        at = train.batch_source(cfg, plan, 4, 16, 0)
        b2, again, b3 = at(2), at(2), at(3)
        assert b2["frames"].shape == (2, 4, cfg.n_frames, cfg.d_model)
        assert b2["frames"].dtype == np.float32 and abs(b2["frames"].std() - 1) < 0.05
        assert np.array_equal(b2["frames"], again["frames"])      # a resumed run's batch
        assert not np.array_equal(b2["frames"], b3["frames"])


@pytest.mark.parametrize("arch", [VLM, ENCDEC])
def test_dryrun_train_4k_cell(arch):
    """The full-size ``train_4k`` cell on ``meta`` (the single mesh, ZeRO-3):
    status ok, ``model_flops`` the spec's, its batch carrying the family's
    leaf."""
    rec = dryrun.run_cell(arch, "train_4k", "single", verbose=False)
    assert rec["status"] == "ok", rec.get("traceback")
    assert rec["model_flops"] == dryrun.model_flops_spec(get_config(arch), SHAPES["train_4k"])
    assert rec["hlo_dot_flops_per_chip"] > 0 and rec["wire_bytes_per_chip"] > 0
    b = dryrun.train_batch(get_config(arch), 2, 4, 64)
    assert (tuple(b["mrope"].shape) == (2, 3, 4, 64) if arch == VLM
            else tuple(b["frames"].shape) == (2, 4, 1500, 1024)
            and b["frames"].dtype == torch.bfloat16)


@pytest.mark.parametrize("arch", [VLM, ENCDEC])
def test_dryrun_cell_dot_flops_within_2pct_of_analyze_hlo(arch):
    """A dry-run ``train_4k`` cell of the reduced config (one 1 x 64 micro-step
    a rank) counts the dot FLOPs of ``analyze_hlo`` on the reference's
    compiled one-rank program within 2%, once the port's two departures
    (DESIGN_TORCH.md §24) are taken out: attention priced by the pairs the
    mask keeps (four passes: forward, remat's, the gradient's two) and the
    loss chunk's recomputed head."""
    cfg, jcfg = get_config(arch).reduced(), jax_get_config(arch).reduced()
    S = 64
    rec = dryrun.run_cell(arch, "train_4k", "single", verbose=False, cfg=cfg,
                          shape_cfg=ShapeConfig("train_4k", S, 256, "train"))
    assert rec["status"] == "ok", rec.get("traceback")
    assert rec["model_flops"] == dryrun.model_flops_spec(cfg, rec_shape := ShapeConfig(
        "train_4k", S, 256, "train"))
    assert rec_shape.global_batch == 256
    from repro.configs.base import RunConfig as JRC
    m1 = compat.make_mesh((1, 1), ("data", "model"))
    extra = ({"mrope": P(None, None, "data", None)} if cfg.family == "vlm"
             else {"frames": P(None, "data", None, None)})
    prog = jax_make_train_program(jax_build(jcfg), m1, JRC(zero_stage=1, collective_mode="flat",
                                                         param_dtype="float32"),
                                  jax_balance.uniform_plan(1, 1, 1), extra_batch_specs=extra)
    state = jax.eval_shape(prog.init_fn, jax.ShapeDtypeStruct((2,), jnp.uint32))
    batch = {k: jax.ShapeDtypeStruct((1, 1, S), jnp.int32) for k in ("tokens", "labels")}
    if cfg.family == "vlm":
        batch["mrope"] = jax.ShapeDtypeStruct((1, 3, 1, S), jnp.int32)
    else:
        batch["frames"] = jax.ShapeDtypeStruct((1, 1, cfg.n_frames, cfg.d_model), jnp.bfloat16)
    want = ranalysis.analyze_hlo(prog.step_fn.lower(state, batch).compile().as_text(), 1)
    # the reference's four passes over the whole S x S block of each causal
    # attention (the VLM's layers, the decoder's self-attention)
    causal = 4 * 4.0 * cfg.n_layers * cfg.n_heads * cfg.head_dim_ * (
        S * S - analysis.attention_pairs(S, S))
    head = 2.0 * S * cfg.d_model * cfg.padded_vocab
    got = rec["hlo_dot_flops_per_chip"]
    adjusted = got + causal - head
    print(f"\n  {arch}: port {got:.4e}, adjusted {adjusted:.4e}, analyze_hlo "
          f"{want.dot_flops:.4e}")
    assert abs(adjusted - want.dot_flops) / want.dot_flops < 0.02


# ---------------------------------------------------------------------------
# the plain flash backward at Sq != Sk
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("Sq,Sk,k_len", [(20, 50, 37), (50, 20, 13), (33, 48, 48)])
def test_plain_flash_backward_at_sq_ne_sk(Sq, Sk, k_len):
    """``ref.attention_bwd`` (the flash backward's plain version) at Sq !=
    Sk, bidirectional with a ``k_len`` cut, GQA 4/2, against autograd of
    the plain forward ``ref.attention``, f32, given the plain row
    logsumexp; with ``product_dtype=bfloat16`` (chip_smoke [37]'s step-0
    yardstick) it lies a bf16 rounding away (rel L2 between 1e-5 and
    1e-2)."""
    rng = np.random.RandomState(Sq * 100 + Sk)
    q = torch.from_numpy(rng.randn(2, 4, Sq, 16).astype(np.float32))
    k, v = (torch.from_numpy(rng.randn(2, 2, Sk, 16).astype(np.float32)) for _ in range(2))
    do = torch.from_numpy(rng.randn(2, 4, Sq, 16).astype(np.float32))
    kw = dict(kind="bidir", window=0, k_len=k_len, scale=16 ** -0.5)
    req = [t.clone().requires_grad_() for t in (q, k, v)]
    o = ref.attention(*req, **kw)
    want = torch.autograd.grad(o, req, do)
    got = ref.attention_bwd(q, k, v, o.detach(), do, ref.attention_lse(q, k, **kw), **kw)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert float((g - w).abs().max()) <= 1e-5 * float(w.abs().max())
    if k_len < Sk:                                   # keys past k_len: no gradient
        assert float(got[1][:, :, k_len:].abs().max()) == 0.0
    # the kernel's bf16 rounding points (P and dS rounded for the products):
    # off by the bf16 rounding, not by a fault
    bf = ref.attention_bwd(q, k, v, o.detach(), do, ref.attention_lse(q, k, **kw), **kw,
                           product_dtype=torch.bfloat16)
    for g, w in zip(bf, want):
        rel = float((g - w).norm() / w.norm())
        assert 1e-5 < rel < 1e-2
