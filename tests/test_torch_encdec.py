"""The port's encoder-decoder (whisper-medium) against the JAX package's.

Reduced whisper-medium widths (d_model 128, 4/2 heads of 32, d_ff 256, 64
frames, vocab 512) in f32.  The weights are the JAX package's ``init`` tree
with every bias (``bq``, ``bv``, ``bo``, ``b1``, ``b2``) and every
LayerNorm shift set to seeded 0.1 N(0, 1) values and every LayerNorm scale
to 1 + 0.1 N(0, 1) (the init's zeros and ones would hide a bias or a norm
read from the wrong leaf, or not added), carried into the port with
``params_from_jax``; tokens and frames come from seeded numpy RandomStates.
The JAX package runs on its default (``cpu``) TACC platform: its prefill
passes the cache position to attention as a traced value, which its flash
wrapper cannot test against 0 under ``jit``.

Depth.  ``reduced()`` cuts whisper to 2 encoder and 4 decoder layers.  The
reference's init reads fan-in from the layer axis (ROADMAP C5), so those
stacked weights have std 1/sqrt(2) and 1/sqrt(4): attention scores of
std ~30, softmaxes near one-hot, and f32 rounding amplified until each
package's f32 prefill lies 3e-4 to 5e-3 of the logits' scale from a float64
run of the port (``test_reduced_depth_is_f32_noise`` prints them).  At
whisper-medium's own depth (24 + 24 layers, ``DEEP``) the same widths give
std 1/sqrt(24) and both packages lie within 1.2e-5 of that run, so the
model-level comparisons run there.  With the stacked projections redrawn
at std 1/sqrt(fan-in), as ``chip_smoke.py``'s [35] draws whisper-medium
(``chip_smoke.redraw_projections``), the reduced depth is well conditioned
too: ``test_redrawn_projections_condition_the_reduced_depth`` holds the
port's f32 prefill within 1e-5 of the scale of its float64 run.

Tolerances, with their reasons:

* ``layer_norm``, the blocks' sublayers on the same inputs (biased
  attention without RoPE, cross-attention, the ungated GELU MLP), f32:
  1e-5 of the largest |value| (sums in another order);
* at ``DEEP``: prefill logits, every cache leaf (``cross_k`` and
  ``cross_v`` among them), 4 decode steps, the forward's logits, the
  batcher's steps: 1e-4 of the largest |value| (readings 5e-6 to 1.1e-5);
  the loss rtol 1e-5, each gradient leaf relative L2 1e-3 of the leaf;
* at the reduced depth: each package within 2e-2 of the scale from the
  float64 run, and of each other (readings above); redrawn, the port
  within 1e-5 of its float64 run;
* decode against teacher forcing (the port alone, ``DEEP``): 1e-4.
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
from repro.models import Ctx  # noqa: E402
from repro.models import build as jax_build  # noqa: E402
from repro.models import common as jax_common  # noqa: E402
from repro.models import encdec as jax_encdec  # noqa: E402
from repro.models import transformer as jax_tf  # noqa: E402
from repro.serve import engine as jax_engine  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.launch import dryrun, serve  # noqa: E402
from repro_torch.models import build  # noqa: E402
from repro_torch.models import common  # noqa: E402
from repro_torch.models import encdec  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.serve import engine  # noqa: E402

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(smoke)

ARCH = "whisper-medium"
REL = 1e-4                    # of the largest |value| (module docstring)
NOISE = 2e-2                  # the reduced depth's f32 noise bound
TOL = 1e-5                    # the function-level checks
DEEP = {"n_layers": 24, "n_enc_layers": 24}
CTX = Ctx(rules={"_axis_sizes": {}, "_zero_stage": 1}, manual=False,
          dp_axes=("data",))
B, S, STEPS = 2, 40, 4
NORMS = ("ln1", "ln2", "ln3", "enc_norm", "final_norm")


def _perturbed(tree, rng, name=""):
    """The init tree with biases and norm shifts 0.1 N(0, 1), norm scales
    1 + 0.1 N(0, 1)."""
    if isinstance(tree, dict):
        return {k: _perturbed(tree[k], rng, k) for k in sorted(tree)}
    a = np.asarray(tree)
    if name in ("bq", "bv", "bo", "b1", "b2") or name.endswith("_b"):
        return (0.1 * rng.randn(*a.shape)).astype(a.dtype)
    if name in NORMS:
        return (1 + 0.1 * rng.randn(*a.shape)).astype(a.dtype)
    return a


def _carried(**over):
    cfg = dataclasses.replace(get_config(ARCH).reduced(), **over)
    jcfg = dataclasses.replace(jax_get_config(ARCH).reduced(), **over)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    jmodel, model = jax_build(jcfg), build(cfg)
    tree = _perturbed(jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(0))),
                      np.random.RandomState(1))
    params = params_from_jax(tree, metas=model.abstract_params())
    assert model.n_params() == jmodel.n_params()
    return cfg, jcfg, jmodel, jax.tree.map(jnp.asarray, tree), model, params


@pytest.fixture(scope="module")
def whisper():
    return _carried()


@pytest.fixture(scope="module")
def deep():
    return _carried(**DEEP)


def _batch(cfg, n, seed):
    rng = np.random.RandomState(seed)
    return {"tokens": rng.randint(0, cfg.vocab, (B, n)).astype(np.int32),
            "frames": rng.randn(B, cfg.n_frames, cfg.d_model).astype(np.float32)}


def _torch_batch(batch):
    return {k: torch.from_numpy(np.ascontiguousarray(v)).long() if v.dtype.kind == "i"
            else torch.from_numpy(v) for k, v in batch.items()}


def _scale(want):
    a = np.abs(np.asarray(want, np.float32))
    return max(a[a < 1e29].max(), 1e-30)


def _close_scaled(got, want, rel=REL):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32),
                               atol=rel * _scale(want), rtol=0)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_leaves(tree[k], f"{prefix}.{k}" if prefix else k))
        return out
    return {prefix: tree}


# ---------------------------------------------------------------------------
# functions and blocks on the same inputs
# ---------------------------------------------------------------------------

def test_layer_norm_matches_jax():
    rng = np.random.RandomState(0)
    x = (rng.randn(3, 7, 128) * 5 + 2).astype(np.float32)
    scale, bias = (1 + rng.randn(128)).astype(np.float32), rng.randn(128).astype(np.float32)
    want = jax_common.layer_norm(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias))
    got = common.layer_norm(torch.from_numpy(x), torch.from_numpy(scale),
                            torch.from_numpy(bias))
    _close_scaled(got, want, TOL)
    bf = common.layer_norm(torch.from_numpy(x).bfloat16(), torch.from_numpy(scale),
                           torch.from_numpy(bias))
    assert bf.dtype == torch.bfloat16


def test_sublayers_match_jax(whisper):
    """Layer 0's biased self-attention (bidirectional and causal, no RoPE),
    the cross-attention over encoder states and the ungated GELU MLP."""
    cfg, jcfg, _, jparams, _, params = whisper
    rng = np.random.RandomState(2)
    h = rng.randn(B, S, cfg.d_model).astype(np.float32)
    enc = rng.randn(B, cfg.n_frames, cfg.d_model).astype(np.float32)
    jl = {k: jax.tree.map(lambda a: a[0], jparams[k]) for k in ("enc_blocks", "dec_blocks")}
    tl = {k: tf.layer_params(params[k], 0) for k in ("enc_blocks", "dec_blocks")}
    th, tenc = torch.from_numpy(h), torch.from_numpy(enc)
    for kind, blk, key in (("bidir", "enc_blocks", "attn"), ("causal", "dec_blocks", "self_attn")):
        want, _ = jax_tf.attn_sublayer(jl[blk][key], jnp.asarray(h), None, jcfg, CTX, kind=kind)
        got, _ = tf.attn_sublayer(tl[blk][key], th, None, cfg, kind=kind)
        _close_scaled(got, want, TOL)
    jk, jv = jax_encdec._cross_kv(jl["dec_blocks"]["cross_attn"], jnp.asarray(enc), jcfg)
    tk, tv = encdec._cross_kv(tl["dec_blocks"]["cross_attn"], tenc)
    _close_scaled(tk, jk, TOL)
    _close_scaled(tv, jv, TOL)
    want = jax_encdec._cross_attend(jl["dec_blocks"]["cross_attn"], jnp.asarray(h), jk, jv,
                                    jcfg, CTX)
    _close_scaled(encdec._cross_attend(tl["dec_blocks"]["cross_attn"], th, tk, tv, cfg),
                  want, TOL)
    for blk in ("enc_blocks", "dec_blocks"):
        want = jax_tf.mlp_sublayer(jl[blk]["mlp"], jnp.asarray(h), jcfg, CTX)
        _close_scaled(tf.mlp_sublayer(tl[blk]["mlp"], th, cfg), want, TOL)
    assert "w3" not in tl["dec_blocks"]["mlp"] and "bk" not in tl["dec_blocks"]["self_attn"]


def test_encode_matches_jax(deep):
    cfg, jcfg, _, jparams, _, params = deep
    frames = _batch(cfg, S, 3)["frames"]
    want = jax_encdec.encode(jparams, jnp.asarray(frames), jcfg, CTX)
    _close_scaled(encdec.encode(params, torch.from_numpy(frames), cfg), want)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def _close_caches(tcache, jcache):
    tl, jl = _leaves(tcache), _leaves(jcache)
    assert sorted(tl) == sorted(jl) == ["cross_k", "cross_v", "k", "pos", "v"]
    assert tl["pos"] == int(jl["pos"])
    for name in ("k", "v", "cross_k", "cross_v"):
        assert tuple(tl[name].shape) == tuple(jl[name].shape), name
        _close_scaled(tl[name], jl[name])


def test_prefill_and_decode_match_jax(deep):
    """Prefill logits and every cache leaf, then 4 decode steps
    teacher-forced; the cross k and v come out of prefill once and decode
    leaves them as they were, bit for bit."""
    cfg, _, jmodel, jparams, model, params = deep
    batch = _batch(cfg, S + STEPS, 4)
    toks, max_len = batch["tokens"], S + STEPS
    pre = {"tokens": toks[:, :S], "frames": batch["frames"]}
    jl, jcache = jax.jit(lambda p, b: jmodel.prefill(p, b, CTX, max_len=max_len))(
        jparams, pre)
    tl, tcache = model.prefill(params, _torch_batch(pre), max_len=max_len)
    assert tuple(tl.shape) == (B, 1, cfg.padded_vocab)
    assert tuple(tcache["cross_k"].shape) == (cfg.n_layers, B, cfg.n_frames, cfg.n_kv_heads,
                                              cfg.head_dim_)
    _close_scaled(tl, jl)
    _close_caches(tcache, jcache)
    cross = [tcache["cross_k"].clone(), tcache["cross_v"].clone()]
    jdec = jax.jit(lambda p, c, t: jmodel.decode(p, c, t, CTX))
    for t in range(S, S + STEPS):
        jl, jcache = jdec(jparams, jcache, toks[:, t:t + 1])
        tl, tcache = model.decode(params, tcache, torch.from_numpy(toks[:, t:t + 1]).long())
        _close_scaled(tl, jl)
    _close_caches(tcache, jcache)
    assert torch.equal(tcache["cross_k"], cross[0]) and torch.equal(tcache["cross_v"], cross[1])


def test_reduced_depth_is_f32_noise(whisper):
    """``reduced()`` (2 + 4 layers): the port's f32 prefill and the JAX
    package's, each against a float64 run of the port (its norms' statistics
    stay f32, as the reference casts them), and against each other."""
    cfg, _, jmodel, jparams, model, params = whisper
    batch = _batch(cfg, S, 5)
    jl, _ = jax.jit(lambda p, b: jmodel.prefill(p, b, CTX))(jparams, batch)
    tb = _torch_batch(batch)
    tl, _ = model.prefill(params, tb)
    m64 = build(dataclasses.replace(cfg, dtype="float64"))
    dl, _ = m64.prefill(jax.tree.map(lambda t: t.double(), params),
                        {**tb, "frames": tb["frames"].double()})
    jl, tl, dl = np.asarray(jl, np.float64), tl.double().numpy(), dl.numpy()
    real = np.abs(dl) < 1e29
    scale = np.abs(dl[real]).max()
    errs = {"jax-f64": np.abs(jl - dl)[real].max() / scale,
            "port-f64": np.abs(tl - dl)[real].max() / scale,
            "port-jax": np.abs(tl - jl)[real].max() / scale}
    print("\n  reduced whisper prefill logits, of the scale: "
          + ", ".join(f"{k} {v:.2e}" for k, v in errs.items()))
    assert max(errs.values()) <= NOISE


def test_redrawn_projections_condition_the_reduced_depth(whisper):
    """``chip_smoke.redraw_projections`` on reduced whisper: the 16 stacked
    projections (the encoder's six, the decoder's ten) drawn at std
    1/sqrt(fan-in) (``wo``'s fan-in heads x head dim), nothing else
    touched, and the port's f32 prefill then within 1e-5 of the scale of
    its float64 run."""
    cfg, _, _, _, model, params = whisper
    p = jax.tree.map(lambda t: t.clone(), params)
    assert smoke.redraw_projections(torch, p, 2) == 16
    before = _leaves(params)
    for name, t in _leaves(p).items():
        dims = smoke.PROJ_FAN_IN_DIMS.get(name.rsplit(".", 1)[-1])
        if dims and "blocks" in name:
            fan_in = np.prod(t.shape[1:1 + dims])
            assert abs(t.std().item() * fan_in ** 0.5 - 1) < 0.05, name
        else:
            assert torch.equal(t, before[name]), name
    tb = _torch_batch(_batch(cfg, S, 5))
    tl, _ = model.prefill(p, tb)
    m64 = build(dataclasses.replace(cfg, dtype="float64"))
    dl, _ = m64.prefill(jax.tree.map(lambda t: t.double(), p),
                        {**tb, "frames": tb["frames"].double()})
    tl, dl = tl.double().numpy(), dl.numpy()
    real = np.abs(dl) < 1e29
    err = np.abs(tl - dl)[real].max() / np.abs(dl[real]).max()
    print(f"\n  reduced whisper, projections redrawn: port-f64 {err:.2e} of the scale")
    assert err <= 1e-5


def test_forward_and_loss_match_jax(deep):
    """The teacher-forced forward's logits, ``Model.loss`` and the gradient
    of every leaf against ``jax.value_and_grad`` of the reference's loss."""
    cfg, jcfg, jmodel, jparams, model, params = deep
    batch = _batch(cfg, S + 1, 6)
    toks = batch["tokens"]
    jbatch = {"tokens": toks[:, :S], "labels": toks[:, 1:], "frames": batch["frames"]}
    jx, _ = jax_encdec.forward(jparams, jbatch, jcfg, CTX)
    want = jax_tf.lm_logits(jparams, jx, jcfg, CTX)
    x, aux = encdec.forward(params, _torch_batch(jbatch), cfg)
    _close_scaled(tf.lm_logits(params, x, cfg), want)
    assert float(aux) == 0.0
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p: jmodel.loss(p, jbatch, CTX)[0]))(jparams)
    leaves = {k: v.clone().requires_grad_() for k, v in _leaves(params).items()}
    tree = {}
    for name, t in leaves.items():
        node = tree
        *path, last = name.split(".")
        for k in path:
            node = node.setdefault(k, {})
        node[last] = t
    loss, count, _ = model.loss(tree, _torch_batch(jbatch), remat=True)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    assert float(count) == B * S
    jl = _leaves(jax.tree.map(np.asarray, jgrads))
    assert sorted(jl) == sorted(leaves)
    for name, t in leaves.items():
        g, want = t.grad.numpy(), jl[name]
        assert np.linalg.norm(g - want) <= 1e-3 * np.linalg.norm(want), name


def test_decode_matches_teacher_forcing(deep):
    """Prefill half, decode the rest token by token: each step's logits
    equal the teacher-forced forward's at that position."""
    cfg, _, _, _, model, params = deep
    batch = _torch_batch(_batch(cfg, 24, 7))
    x, _ = encdec.forward(params, batch, cfg)
    full = tf.lm_logits(params, x, cfg)
    toks = batch["tokens"]
    _, cache = model.prefill(params, {"tokens": toks[:, :12], "frames": batch["frames"]},
                             max_len=24)
    for t in range(12, 16):
        logits, cache = model.decode(params, cache, toks[:, t:t + 1])
        _close_scaled(logits[:, 0], full[:, t].numpy())


# ---------------------------------------------------------------------------
# serving: the batcher's frames, the reference's fault, the launcher
# ---------------------------------------------------------------------------

def test_batcher_matches_jax(deep):
    """The port's ``Batcher`` over 3 requests with their frames in 2 slots
    (left padding, a dummy slot of zero frames): each prefill and decode step
    against the JAX model's on the same batch, teacher-forced."""
    cfg, _, jmodel, jparams, model, params = deep
    slots, prompt_len, max_new = 2, 16, 3
    max_len = prompt_len + max_new
    rng = np.random.RandomState(9)
    reqs = [engine.Request(i, rng.randint(0, cfg.vocab, n).astype(np.int32), max_new,
                           frames=rng.randn(cfg.n_frames, cfg.d_model).astype(np.float32))
            for i, n in enumerate((16, 9, 12))]
    log = []
    progs = engine.make_serve_programs(model, seq_len=prompt_len, max_len=max_len,
                                       device="cpu")

    def prefill_fn(p, batch):
        log.append(("prefill", {k: v.clone() for k, v in batch.items()}))
        logits, cache = progs.prefill_fn(p, batch)
        log[-1] += (logits,)
        return logits, cache

    def decode_fn(p, cache, tok):
        logits, cache = progs.decode_fn(p, cache, tok)
        log.append(("decode", tok.clone(), logits))
        return logits, cache

    done = engine.Batcher(dataclasses.replace(progs, prefill_fn=prefill_fn,
                                              decode_fn=decode_fn),
                          params, batch_slots=slots, prompt_len=prompt_len,
                          max_len=max_len).run(reqs)
    assert [r.uid for r in done] == [0, 1, 2] and all(len(r.out) == max_new for r in done)
    jpre = jax.jit(lambda p, b: jmodel.prefill(p, b, CTX, max_len=max_len))
    jdec = jax.jit(lambda p, c, t: jmodel.decode(p, c, t, CTX))
    prefills = [e for e in log if e[0] == "prefill"]
    assert len(prefills) == 2
    np.testing.assert_array_equal(prefills[1][1]["frames"][1].numpy(), 0)   # the dummy slot
    np.testing.assert_array_equal(prefills[0][1]["frames"][0].numpy(), reqs[0].frames)
    for entry in log:
        if entry[0] == "prefill":
            batch = {k: np.asarray(v.numpy(), np.int32 if k == "tokens" else np.float32)
                     for k, v in entry[1].items()}
            want, jcache = jpre(jparams, batch)
            got = entry[2]
        else:
            want, jcache = jdec(jparams, jcache, np.asarray(entry[1].numpy(), np.int32))
            got = entry[2]
        _close_scaled(got, want)


def test_batcher_needs_frames(whisper):
    cfg, _, _, _, model, params = whisper
    progs = engine.make_serve_programs(model, seq_len=8, max_len=10, device="cpu")
    b = engine.Batcher(progs, params, batch_slots=2, prompt_len=8, max_len=10)
    with pytest.raises(ValueError, match="request 0: .*frames"):
        b.run([engine.Request(0, np.arange(8, dtype=np.int32), 2)])
    with pytest.raises(ValueError, match="frames of shape"):
        b.run([engine.Request(0, np.arange(8, dtype=np.int32), 2,
                              frames=np.zeros((3, cfg.d_model), np.float32))])


def test_reference_batcher_builds_no_frames_leaf(whisper):
    """ROADMAP C8: the reference's ``Batcher`` builds no ``frames`` leaf, so
    its prefill program, whose batch shardings name one, refuses the batch."""
    cfg, _, jmodel, jparams, _, _ = whisper
    jprogs = jax_engine.make_serve_programs(jmodel, compat.make_mesh((1, 1), ("data", "model")),
                                            batch=2, seq_len=8, max_len=10)
    with pytest.raises(ValueError, match="frames"):
        jax_engine.Batcher(jprogs, jparams, batch_slots=2, prompt_len=8, max_len=10).run(
            [jax_engine.Request(0, np.arange(8, dtype=np.int32), 2)])


def test_serve_launcher_serves_whisper():
    done = serve.main(["--arch", ARCH, "--device", "cpu", "--batch", "2", "--prompt-len", "16",
                       "--max-new", "3"])
    assert len(done) == 2 and all(len(r.out) == 3 for r in done)


def test_dryrun_decode_32k_on_meta_counts_the_closed_form():
    """Full-size whisper-medium (24 + 24 layers) on ``meta``: one decode step
    of 128 sequences on a fresh cache of 32768 and the cross k/v of 1500
    frames; the counter's dot FLOPs equal the closed form (each projection
    2·m·k·n, attention 4·d per valid (query, key) pair: one in the self
    attention, the frames in the cross)."""
    cfg = get_config(ARCH)
    rec = dryrun.run_cell(ARCH, "decode_32k", "single", verbose=False)
    assert rec["status"] == "ok", rec.get("traceback")
    Bd, D, Hq, Hkv, hd, F = 128, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_, cfg.d_ff
    self_attn = 2 * Bd * D * (Hq + 2 * Hkv) * hd + 4 * Bd * Hq * hd * 1 + 2 * Bd * Hq * hd * D
    cross = 2 * Bd * D * Hq * hd + 4 * Bd * Hq * hd * cfg.n_frames + 2 * Bd * Hq * hd * D
    per_layer = self_attn + cross + 2 * 2 * Bd * D * F
    assert rec["hlo_dot_flops_per_chip"] == cfg.n_layers * per_layer + 2 * Bd * D * cfg.padded_vocab
    assert rec["model_flops"] == dryrun.model_flops_spec(cfg, dryrun.SHAPES["decode_32k"])
