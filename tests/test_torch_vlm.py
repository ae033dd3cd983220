"""The port's VLM (qwen2-vl-72b, M-RoPE) against the JAX package's.

Reduced qwen2-vl-72b (4 layers, d_model 128, 4/2 heads of 32, M-RoPE
sections (4, 6, 6)) in f32.  The weights are the JAX package's ``init`` tree
with every RMSNorm scale (``ln1``, ``ln2``, ``final_norm``) set to seeded
values around 1 (the init's ones would hide a norm read from the wrong
leaf), carried into the port with ``params_from_jax``; tokens and positions
come from seeded numpy RandomStates.

M-RoPE with three equal streams is plain RoPE, so every check that holds
the sections runs an image block laid out by qwen2-vl's ``get_rope_index``
rule (arXiv:2409.12191 §2.1, ``chip_smoke.mrope_grid``): text at t = h = w
= i, then a side x side grid of vision positions (t fixed at the block's
start, h and w its row and column offset by the start), then text again
from the grid's largest position + 1.  The text-only layout (``arange``
on all three streams, the engine's) runs beside it.

Tolerances, with their reasons:

* ``apply_rope``: atol 2e-4 (unit inputs, positions below 600: the f32
  inverse frequencies of numpy's pow and torch's may differ by an ulp,
  which at an angle of 600 rad moves it by ~4e-5);
* prefill logits, every cache leaf, 4 decode steps, the forward's logits:
  1e-4 of the largest |value| (readings 1e-5 to 2e-5: sums in another
  order through four layers);
* the loss: rtol 1e-5; each gradient leaf: relative L2 1e-4 of the leaf;
* decode against teacher forcing (the port alone): 1e-4 of the scale.
"""
import dataclasses
import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core import compat  # noqa: E402
from repro.core import tacc as jax_tacc  # noqa: E402
from repro.models import Ctx  # noqa: E402
from repro.models import build as jax_build  # noqa: E402
from repro.models import common as jax_common  # noqa: E402
from repro.models import transformer as jax_tf  # noqa: E402
from repro.serve import engine as jax_engine  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.launch import dryrun, serve  # noqa: E402
from repro_torch.models import build  # noqa: E402
from repro_torch.models import common  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.serve import engine  # noqa: E402

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(smoke)

ARCH = "qwen2-vl-72b"
REL = 1e-4                    # of the largest |value| (module docstring)
CTX = Ctx(rules={"_axis_sizes": {}, "_zero_stage": 1}, manual=False,
          dp_axes=("data",))
B, S, STEPS = 2, 40, 4
# the image block of the reduced prompts: 8 text tokens, a 4 x 4 grid, 16 text
GRID_START, GRID_SIDE = 8, 4


@pytest.fixture
def jax_interpret():
    prev = jax_tacc.get_platform()
    jax_tacc.set_platform("interpret")
    try:
        yield
    finally:
        jax_tacc.set_platform(prev)


def _perturbed(tree, rng, name=""):
    """The init tree with each norm scale set to 1 + 0.1 N(0, 1)."""
    if isinstance(tree, dict):
        return {k: _perturbed(tree[k], rng, k) for k in sorted(tree)}
    a = np.asarray(tree)
    if name in ("ln1", "ln2", "final_norm"):
        return (1 + 0.1 * rng.randn(*a.shape)).astype(a.dtype)
    return a


@pytest.fixture(scope="module")
def vlm():
    cfg, jcfg = get_config(ARCH).reduced(), jax_get_config(ARCH).reduced()
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert cfg.family == "vlm" and cfg.mrope_sections == (4, 6, 6)
    jmodel, model = jax_build(jcfg), build(cfg)
    tree = _perturbed(jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(0))),
                      np.random.RandomState(1))
    params = params_from_jax(tree, metas=model.abstract_params())
    assert model.n_params() == jmodel.n_params()
    return cfg, jcfg, jmodel, jax.tree.map(jnp.asarray, tree), model, params


def _tokens(cfg, n, seed):
    return np.random.RandomState(seed).randint(0, cfg.vocab, (B, n)).astype(np.int32)


def _positions(layout):
    if layout == "grid":
        return smoke.mrope_grid(np, B, S, GRID_START, GRID_SIDE)
    return np.broadcast_to(np.arange(S)[None, None], (3, B, S)).astype(np.int64)


def _scale(want):
    a = np.abs(np.asarray(want, np.float32))
    return max(a[a < 1e29].max(), 1e-30)


def _close_scaled(got, want, rel=REL):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32),
                               atol=rel * _scale(want), rtol=0)


def test_grid_layout_follows_get_rope_index():
    pos = smoke.mrope_grid(np, 1, 12, 2, 3)[:, 0]
    np.testing.assert_array_equal(pos, [
        [0, 1, 2, 2, 2, 2, 2, 2, 2, 2, 2, 5],
        [0, 1, 2, 2, 2, 3, 3, 3, 4, 4, 4, 5],
        [0, 1, 2, 3, 4, 2, 3, 4, 2, 3, 4, 5]])


@pytest.mark.parametrize("hd,sections", [(32, (4, 6, 6)), (128, (16, 24, 24))])
def test_apply_rope_sections_match_jax(hd, sections):
    """Distinct streams (random positions, and the grid layout) against the
    reference; equal streams equal plain RoPE, and distinct ones do not."""
    rng = np.random.RandomState(hd)
    x = rng.randn(B, S, 3, hd).astype(np.float32)
    for pos in (rng.randint(0, 600, (3, B, S)), _positions("grid")):
        want = jax_common.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e6, sections)
        got = common.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 1e6, sections)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4, rtol=0)
    text = torch.from_numpy(_positions("text").copy())
    plain = common.apply_rope(torch.from_numpy(x), text[0], 1e6)
    assert torch.equal(common.apply_rope(torch.from_numpy(x), text, 1e6, sections), plain)
    grid = common.apply_rope(torch.from_numpy(x), torch.from_numpy(_positions("grid")),
                             1e6, sections)
    assert not torch.allclose(grid, plain, atol=1e-3)


@pytest.mark.parametrize("layout", ["grid", "text"])
def test_pair_positions_once_a_forward_equal_the_sections_path(layout, monkeypatch):
    """The layers rotate by the per-pair positions that ``_layer_positions``
    takes once a forward: bit-equal to ``apply_rope(..., sections)``, and
    the stream index is built once a prefill, not once a layer."""
    cfg = get_config("qwen2-vl-72b").reduced()
    hd, sections = cfg.head_dim_, cfg.mrope_sections
    pos = torch.from_numpy(_positions(layout).copy())
    x = torch.from_numpy(np.random.RandomState(7).randn(B, S, 3, hd).astype(np.float32))
    pairs = common.mrope_pair_positions(pos, sections, hd)
    assert pairs.shape == (B, S, hd // 2)
    assert torch.equal(common.apply_rope(x, pairs, 1e6, pairwise=True),
                       common.apply_rope(x, pos, 1e6, sections))
    calls = []
    real = common.mrope_pair_positions
    monkeypatch.setattr(tf, "mrope_pair_positions", lambda *a: calls.append(1) or real(*a))
    model = build(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    tokens = torch.from_numpy(np.random.RandomState(8).randint(0, cfg.vocab, (B, S)))
    with torch.inference_mode():
        model.prefill(params, {"tokens": tokens, "mrope": pos}, max_len=S + 1)
    assert len(calls) == 1 and cfg.n_layers > 1


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_leaves(tree[k], f"{prefix}.{k}" if prefix else k))
        return out
    return {prefix: tree}


def _close_caches(tcache, jcache):
    tl, jl = _leaves(tcache), _leaves(jcache)
    assert sorted(tl) == sorted(jl) == ["k", "pos", "v"]
    assert tl["pos"] == int(jl["pos"])
    for name in ("k", "v"):
        assert tuple(tl[name].shape) == tuple(jl[name].shape), name
        _close_scaled(tl[name], jl[name])


@pytest.mark.parametrize("layout", ["grid", "text"])
def test_prefill_and_decode_match_jax(vlm, layout, jax_interpret):
    """Prefill logits and the cache, then 4 decode steps teacher-forced
    (their positions the cache position on three streams, both packages:
    ROADMAP C8).  The JAX prefill reaches the Pallas flash kernel
    (interpret mode)."""
    cfg, _, jmodel, jparams, model, params = vlm
    toks, pos = _tokens(cfg, S + STEPS, 3), _positions(layout)
    max_len = S + STEPS
    jl, jcache = jax.jit(lambda p, b: jmodel.prefill(p, b, CTX, max_len=max_len))(
        jparams, {"tokens": toks[:, :S], "mrope": pos})
    tl, tcache = model.prefill(params, {"tokens": torch.from_numpy(toks[:, :S]).long(),
                                        "mrope": torch.from_numpy(pos.copy())},
                               max_len=max_len)
    assert tuple(tl.shape) == (B, 1, cfg.padded_vocab)
    _close_scaled(tl, jl)
    _close_caches(tcache, jcache)
    jdec = jax.jit(lambda p, c, t: jmodel.decode(p, c, t, CTX))
    for t in range(S, S + STEPS):
        jl, jcache = jdec(jparams, jcache, toks[:, t:t + 1])
        tl, tcache = model.decode(params, tcache, torch.from_numpy(toks[:, t:t + 1]).long())
        _close_scaled(tl, jl)
    _close_caches(tcache, jcache)


def test_grid_positions_move_the_logits(vlm):
    """The sections act: the grid layout's prefill logits differ from the
    text-only layout's on the same tokens (by far more than REL)."""
    cfg, _, _, _, model, params = vlm
    toks = torch.from_numpy(_tokens(cfg, S, 3)).long()
    out = {layout: model.prefill(params, {"tokens": toks, "mrope": torch.from_numpy(
        _positions(layout).copy())})[0] for layout in ("grid", "text")}
    gap = (out["grid"] - out["text"]).abs().max().item()
    assert gap > 100 * REL * _scale(out["text"].numpy())


def test_forward_lm_matches_jax(vlm):
    cfg, jcfg, _, jparams, model, params = vlm
    toks, pos = _tokens(cfg, S, 4), _positions("grid")
    jx, _ = jax_tf.forward_lm(jparams, toks, jcfg, CTX, mrope=pos)
    want = jax_tf.lm_logits(jparams, jx, jcfg, CTX)
    x, aux = tf.forward_lm(params, torch.from_numpy(toks).long(), cfg,
                           mrope=torch.from_numpy(pos.copy()))
    _close_scaled(tf.lm_logits(params, x, cfg), want)
    assert float(aux) == 0.0


def test_loss_and_gradients_match_jax(vlm):
    """``Model.loss`` (with ``mrope`` on the grid layout) and the gradient of
    every leaf against ``jax.value_and_grad`` of the reference's loss."""
    cfg, _, jmodel, jparams, model, params = vlm
    toks, pos = _tokens(cfg, S + 1, 5), _positions("grid")
    jbatch = {"tokens": toks[:, :S], "labels": toks[:, 1:], "mrope": pos}
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p: jmodel.loss(p, jbatch, CTX)[0]))(jparams)
    leaves = {k: v.clone().requires_grad_() for k, v in _leaves(params).items()}
    tree = _tree_from(leaves)
    loss, count, aux = model.loss(tree, {k: torch.from_numpy(np.ascontiguousarray(v)).long()
                                         for k, v in jbatch.items()})
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    assert float(count) == B * S and float(aux) == 0.0
    jl = _leaves(jax.tree.map(np.asarray, jgrads))
    assert sorted(jl) == sorted(leaves)
    for name, t in leaves.items():
        g, want = t.grad.numpy(), jl[name]
        assert np.linalg.norm(g - want) <= 1e-4 * np.linalg.norm(want), name


def _tree_from(leaves):
    out: dict = {}
    for name, t in leaves.items():
        node = out
        *path, last = name.split(".")
        for k in path:
            node = node.setdefault(k, {})
        node[last] = t
    return out


def test_decode_matches_teacher_forcing(vlm):
    """Text-only positions: prefill half, decode the rest token by token;
    each step's logits equal the full forward's at that position (the
    reference's ``test_decode_matches_teacher_forcing``)."""
    cfg, _, _, _, model, params = vlm
    toks = torch.from_numpy(_tokens(cfg, 24, 6)).long()
    x, _ = tf.forward_lm(params, toks, cfg)
    full = tf.lm_logits(params, x, cfg)
    _, cache = model.prefill(params, {"tokens": toks[:, :12]}, max_len=24)
    for t in range(12, 16):
        logits, cache = model.decode(params, cache, toks[:, t:t + 1])
        _close_scaled(logits[:, 0], full[:, t].numpy())


def _recording(fn, log, kind):
    def run(*args):
        logits, cache = fn(*args)
        inp = args[-1] if kind == "decode" else args[-1]
        log.append((kind, {k: np.array(v) for k, v in inp.items()} if kind == "prefill"
                    else np.array(inp), np.array(logits, np.float32)))
        return logits, cache
    return run


def test_batcher_matches_jax(vlm, jax_interpret):
    """Both batchers over 3 requests in 2 slots: the port's batch (tokens and
    the text-only ``mrope``) equals the reference's, and each step's logits
    match teacher-forced."""
    cfg, _, jmodel, jparams, model, params = vlm
    slots, prompt_len, max_new = 2, 16, 3
    max_len = prompt_len + max_new
    rng = np.random.RandomState(7)
    prompts = [rng.randint(0, cfg.vocab, n).astype(np.int32) for n in (16, 9, 12)]
    jprogs = jax_engine.make_serve_programs(jmodel, compat.make_mesh((1, 1), ("data", "model")),
                                            batch=slots, seq_len=prompt_len, max_len=max_len)
    jlog, tlog = [], []
    jprogs = dataclasses.replace(jprogs,
                                 prefill_fn=_recording(jprogs.prefill_fn, jlog, "prefill"))
    jax_engine.Batcher(jprogs, jparams, batch_slots=slots, prompt_len=prompt_len,
                       max_len=max_len).run(
        [jax_engine.Request(i, p, max_new) for i, p in enumerate(prompts)])
    progs = engine.make_serve_programs(model, seq_len=prompt_len, max_len=max_len,
                                       device="cpu")
    progs = dataclasses.replace(progs, prefill_fn=_recording(progs.prefill_fn, tlog, "prefill"))
    done = engine.Batcher(progs, params, batch_slots=slots, prompt_len=prompt_len,
                          max_len=max_len).run(
        [engine.Request(i, p, max_new) for i, p in enumerate(prompts)])
    assert [r.uid for r in done] == [0, 1, 2] and all(len(r.out) == max_new for r in done)
    assert len(tlog) == len(jlog) == 2
    for (_, tb, tl), (_, jb, jl) in zip(tlog, jlog):
        assert sorted(tb) == sorted(jb) == ["mrope", "tokens"]
        np.testing.assert_array_equal(tb["mrope"], jb["mrope"])
        np.testing.assert_array_equal(tb["tokens"], jb["tokens"])
        np.testing.assert_allclose(tl, jl, atol=REL * _scale(jl), rtol=0)


def test_serve_launcher_serves_the_vlm():
    done = serve.main(["--arch", ARCH, "--device", "cpu", "--batch", "2", "--prompt-len", "16",
                       "--max-new", "3"])
    assert len(done) == 2 and all(len(r.out) == 3 for r in done)


def test_dryrun_decode_32k_on_meta_counts_the_closed_form():
    """Full-size qwen2-vl-72b (80 layers) on ``meta``: one decode step of
    128 sequences on a fresh cache of 32768; the counter's dot FLOPs equal
    the closed form (each projection 2·m·k·n, attention 4·d per valid
    (query, key) pair, the head over the padded vocab)."""
    cfg = get_config(ARCH)
    rec = dryrun.run_cell(ARCH, "decode_32k", "single", verbose=False)
    assert rec["status"] == "ok", rec.get("traceback")
    Bd, D, Hq, Hkv, hd, F = 128, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_, cfg.d_ff
    per_layer = (2 * Bd * D * (Hq + 2 * Hkv) * hd + 4 * Bd * Hq * hd * 1
                 + 2 * Bd * Hq * hd * D + 3 * 2 * Bd * D * F)
    assert rec["hlo_dot_flops_per_chip"] == cfg.n_layers * per_layer + 2 * Bd * D * cfg.padded_vocab
    assert rec["model_flops"] == dryrun.model_flops_spec(cfg, dryrun.SHAPES["decode_32k"])
    assert rec["devices"] == 1 and rec["wire_bytes_per_chip"] == 0
