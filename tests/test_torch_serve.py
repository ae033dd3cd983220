"""The port's serving path against the JAX package's, on carried weights.

Reduced smollm-135m in f32; and reduced gpt-125m and llama-3b (at its own
head dim of 100, which ``reduced()`` would cut to 32) for the paper's
models.  The weights are the JAX package's ``init``
tree carried across with ``repro_torch.convert.params_from_jax``; tokens come
from a seeded numpy RandomState.  The JAX side pins its TACC platform to
``interpret`` so that its prefill reaches the Pallas flash-attention body (the
way the JAX package's own tests reach it), and restores the platform after.
Tolerance: atol 1e-4 on f32 logits of unit scale (sums taken in another
order by the two frameworks).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core import compat  # noqa: E402
from repro.core import tacc as jax_tacc  # noqa: E402
from repro.models import Ctx  # noqa: E402
from repro.models import build as jax_build  # noqa: E402
from repro.models import transformer as jax_tf  # noqa: E402
from repro.serve import engine as jax_engine  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core import tacc  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.models import build  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.serve import engine  # noqa: E402

ATOL = 1e-4
CTX = Ctx(rules={"_axis_sizes": {}, "_zero_stage": 1}, manual=False,
          dp_axes=("data",))


@pytest.fixture
def jax_interpret():
    prev = jax_tacc.get_platform()
    jax_tacc.set_platform("interpret")
    try:
        yield
    finally:
        jax_tacc.set_platform(prev)


@pytest.fixture(scope="module")
def models():
    cfg = get_config("smollm-135m").reduced()
    jcfg = jax_get_config("smollm-135m").reduced()
    assert dataclasses.asdict(cfg).items() <= dataclasses.asdict(jcfg).items()
    jmodel = jax_build(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    model = build(cfg)
    params = params_from_jax(jax.tree.map(np.asarray, jparams),
                             metas=model.abstract_params())
    assert model.n_params() == jmodel.n_params()
    return cfg, jmodel, jparams, model, params


def _tokens(cfg, B, S, seed):
    return np.random.RandomState(seed).randint(0, cfg.vocab, (B, S)).astype(np.int32)


def _close(got, want):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=ATOL, rtol=0)


def test_prefill_and_decode_match_jax(models, jax_interpret):
    cfg, jmodel, jparams, model, params = models
    B, S, steps = 2, 24, 3
    toks = _tokens(cfg, B, S + steps, 0)
    jl, jcache = jax.jit(lambda p, b: jmodel.prefill(p, b, CTX, max_len=S + steps))(
        jparams, {"tokens": toks[:, :S]})
    tl, tcache = model.prefill(params, {"tokens": torch.from_numpy(toks[:, :S]).long()},
                               max_len=S + steps)
    assert tuple(tl.shape) == (B, 1, cfg.padded_vocab)
    _close(tl, jl)
    jdec = jax.jit(lambda p, c, t: jmodel.decode(p, c, t, CTX))
    for t in range(S, S + steps):         # teacher-forced on the same tokens
        jl, jcache = jdec(jparams, jcache, toks[:, t:t + 1])
        tl, tcache = model.decode(params, tcache, torch.from_numpy(toks[:, t:t + 1]).long())
        _close(tl, jl)
    assert tcache["pos"] == int(jcache["pos"]) == S + steps
    assert all(tuple(tcache[n].shape) == tuple(jcache[n].shape) for n in ("k", "v"))
    for name in ("k", "v"):               # entries reach ~20: tolerance scales
        want = np.asarray(jcache[name])
        np.testing.assert_allclose(tcache[name].numpy(), want,
                                   atol=ATOL * np.abs(want).max(), rtol=0)


def test_forward_lm_logits_match_jax(models, jax_interpret):
    """Logits at every position of a full forward (no cache)."""
    cfg, _, jparams, _, params = models
    toks = _tokens(cfg, 2, 40, 3)
    jx, _ = jax_tf.forward_lm(jparams, toks, jax_get_config("smollm-135m").reduced(), CTX)
    want = jax_tf.lm_logits(jparams, jx, jax_get_config("smollm-135m").reduced(), CTX)
    x, aux = tf.forward_lm(params, torch.from_numpy(toks).long(), cfg)
    assert float(aux) == 0.0                  # the dense family has no aux losses
    _close(tf.lm_logits(params, x, cfg), want)


def test_kernel_route_matches_chunked(models):
    """Attention pinned to the kernel route (on the CPU: the kernel's plain
    version) against the default chunked_attention, through the whole model."""
    cfg, _, _, model, params = models
    toks = {"tokens": torch.from_numpy(_tokens(cfg, 2, 40, 1)).long()}
    assert tacc.resolve_variant("attention", device_type="cpu") == "cpu"
    want, _ = model.prefill(params, toks)
    before = fa.launches
    tacc.set_platform("cuda")
    try:
        assert tacc.resolve_variant("attention", device_type="cpu") == "cuda"
        got, _ = model.prefill(params, toks)
    finally:
        tacc.set_platform(None)
    assert fa.launches == before
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=ATOL, rtol=0)


def _recording(fn, log, kind):
    def run(*args):
        logits, cache = fn(*args)
        inp = args[-1]["tokens"] if kind == "prefill" else args[-1]
        log.append((kind, np.array(inp), np.array(logits, np.float32)))
        return logits, cache
    return run


def _requests(cfg, cls):
    rng = np.random.RandomState(2)
    return [cls(i, rng.randint(0, cfg.vocab, n).astype(np.int32), m)
            for i, (n, m) in enumerate([(12, 5), (7, 3), (9, 5)])]


def test_batcher_matches_jax(models, jax_interpret):
    cfg, jmodel, jparams, model, params = models
    slots, prompt_len, max_new = 2, 12, 5
    max_len = prompt_len + max_new
    mesh = compat.make_mesh((1, 1), ("data", "model"))
    jprogs = jax_engine.make_serve_programs(jmodel, mesh, batch=slots,
                                            seq_len=prompt_len, max_len=max_len)
    jlog = []
    jprogs = dataclasses.replace(
        jprogs, prefill_fn=_recording(jprogs.prefill_fn, jlog, "prefill"),
        decode_fn=_recording(jprogs.decode_fn, jlog, "decode"))
    jdone = jax_engine.Batcher(jprogs, jparams, batch_slots=slots,
                               prompt_len=prompt_len, max_len=max_len
                               ).run(_requests(cfg, jax_engine.Request))

    progs = engine.make_serve_programs(model, seq_len=prompt_len,
                                       max_len=max_len, device="cpu")
    empty = progs.init_cache(slots, max_len)
    assert empty["pos"] == 0 and not empty["k"].any()
    # per-step logits, teacher-forced on the tokens the JAX batcher fed
    groups = []
    for kind, inp, want in jlog:
        inp = torch.from_numpy(inp).long()
        if kind == "prefill":
            got, cache = progs.prefill_fn(params, {"tokens": inp})
            groups.append([])
        else:
            got, cache = progs.decode_fn(params, cache, inp)
        _close(got, want)
        assert {n: tuple(cache[n].shape) for n in ("k", "v")} == \
            {n: tuple(empty[n].shape) for n in ("k", "v")}
        top2 = np.sort(want[:, -1], axis=-1)[:, -2:]
        groups[-1].append(top2[:, 1] - top2[:, 0])       # per-slot margins
    assert len(groups) == 2                # 3 requests in 2 slots: 2 prefills

    done = engine.Batcher(progs, params, batch_slots=slots, prompt_len=prompt_len,
                          max_len=max_len).run(_requests(cfg, engine.Request))
    assert [r.uid for r in done] == [r.uid for r in jdone] == [0, 1, 2]
    for r, jr in zip(done, jdone):
        assert len(r.out) == len(jr.out) == r.max_new
        assert all(0 <= t < cfg.vocab for t in r.out)
        margins = [groups[r.uid // slots][n][r.uid % slots] for n in range(r.max_new)]
        # tokens agree up to the first step whose top-2 gap is within tolerance
        n_sure = next((n for n, m in enumerate(margins) if m <= ATOL), r.max_new)
        assert n_sure > 0
        assert r.out[:n_sure] == jr.out[:n_sure]


# the paper's models, reduced: (arch, head dim that replaces reduced()'s 32,
# logits tolerance).  At d 100 the reduced model's attention output sums 400
# products through wo, whose init std is 1/2 (fan-in: its leading dim, the
# 4 layers), so f32 rounding grows: the JAX package's own f32 forward lies
# 2.7e-4 from a float64 run of the same weights there (the port's 1.6e-4;
# 3.6e-5 and 3.4e-5 at d 32), and port and JAX 2.8e-4 apart: 1e-3.
PAPER_CASES = [("gpt-125m", None, ATOL), ("llama-3b", 100, 1e-3)]


@pytest.mark.parametrize("arch,head_dim,atol", PAPER_CASES, ids=[a for a, _, _ in PAPER_CASES])
def test_paper_models_match_jax(jax_interpret, arch, head_dim, atol):
    """Prefill (the kernel route's plain version on the CPU, against the
    Pallas body in interpret mode), 3 teacher-forced decode steps and a full
    forward of reduced gpt-125m and llama-3b (d 100) against the JAX model
    on its carried weights: logits within ``atol`` (see PAPER_CASES); the
    full forward also within ``atol`` of the port's own float64 run."""
    cfg, jcfg = get_config(arch).reduced(), jax_get_config(arch).reduced()
    if head_dim:
        cfg, jcfg = (dataclasses.replace(c, head_dim=head_dim) for c in (cfg, jcfg))
    assert dataclasses.asdict(cfg).items() <= dataclasses.asdict(jcfg).items()
    jmodel, model = jax_build(jcfg), build(cfg)
    jparams = jmodel.init(jax.random.PRNGKey(1))
    params = params_from_jax(jax.tree.map(np.asarray, jparams), metas=model.abstract_params())
    assert model.n_params() == jmodel.n_params()
    B, S, steps = 2, 20, 3
    toks = _tokens(cfg, B, S + steps, 4)
    jl, jcache = jax.jit(lambda p, b: jmodel.prefill(p, b, CTX, max_len=S + steps))(
        jparams, {"tokens": toks[:, :S]})
    before = fa.launches
    tacc.set_platform("cuda")          # the flash route; on CPU tensors its plain version
    try:
        tl, tcache = model.prefill(params, {"tokens": torch.from_numpy(toks[:, :S]).long()},
                                   max_len=S + steps)
    finally:
        tacc.set_platform(None)
    assert fa.launches == before and tcache["k"].shape[-1] == cfg.head_dim_

    def close(got, want):
        np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                                   atol=atol, rtol=0)

    close(tl, jl)
    jdec = jax.jit(lambda p, c, t: jmodel.decode(p, c, t, CTX))
    for t in range(S, S + steps):
        jl, jcache = jdec(jparams, jcache, toks[:, t:t + 1])
        tl, tcache = model.decode(params, tcache, torch.from_numpy(toks[:, t:t + 1]).long())
        close(tl, jl)
    jx, _ = jax_tf.forward_lm(jparams, toks, jcfg, CTX)
    x, _ = tf.forward_lm(params, torch.from_numpy(toks).long(), cfg)
    logits = tf.lm_logits(params, x, cfg)
    close(logits, jax_tf.lm_logits(jparams, jx, jcfg, CTX))
    c64 = dataclasses.replace(cfg, dtype="float64")
    p64 = params_from_jax(jax.tree.map(lambda a: np.asarray(a, np.float64), jparams))
    x64, _ = tf.forward_lm(p64, torch.from_numpy(toks).long(), c64)
    close(logits, tf.lm_logits(p64, x64, c64).numpy())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_init_params_draws_a_large_leaf_slice_by_slice(monkeypatch, dtype):
    """``init_params`` draws a leaf past ``WHOLE_DRAW_BYTES`` one leading
    slice at a time (deepseek-coder-33b's stacked w1 on the card), so its
    f32 transient is one slice: the draws it asks of the generator, and a
    leaf of the same shape, dtype, scale and stream as the slices drawn in
    order.  The threshold is lowered so that a small stacked leaf takes that
    way and a 2-d leaf of the same tree does not; at the default both are
    drawn whole."""
    from repro_torch.models import common
    metas = {"stacked": common.ParamMeta((3, 64, 48), ("layers", "embed", "mlp"), scale=0.02),
             "two_d": common.ParamMeta((64, 48), ("embed", "mlp")),
             "zeros": common.ParamMeta((3, 48), ("layers", "mlp"), init="zeros")}
    randn, drawn = torch.randn, []

    def spy(*shape, **kw):
        drawn.append(tuple(shape[0]) if len(shape) == 1 else shape)
        return randn(*shape, **kw)

    monkeypatch.setattr(torch, "randn", spy)
    monkeypatch.setattr(common, "WHOLE_DRAW_BYTES", 20_000)      # 4 * 64 * 48 < it < 4 * 3 * 64 * 48
    got = common.init_params(torch.Generator().manual_seed(7), metas, dtype=dtype)
    assert drawn == [(64, 48)] * 3 + [(64, 48)]                  # sorted keys: stacked, two_d
    assert {k: (v.shape, v.dtype) for k, v in got.items()} == {
        "stacked": ((3, 64, 48), dtype), "two_d": ((64, 48), dtype), "zeros": ((3, 48), dtype)}
    gen = torch.Generator().manual_seed(7)
    want = torch.stack([randn(64, 48, generator=gen) * 0.02 for _ in range(3)])
    torch.testing.assert_close(got["stacked"], want.to(dtype), rtol=0, atol=0)
    torch.testing.assert_close(got["two_d"], (randn(64, 48, generator=gen) / 8).to(dtype),
                               rtol=0, atol=0)
    assert not torch.equal(got["stacked"][0], got["stacked"][1])
    assert abs(got["stacked"].float().std().item() / 0.02 - 1) < 0.05
    assert not got["zeros"].any()
    drawn.clear()
    monkeypatch.setattr(common, "WHOLE_DRAW_BYTES", 16 * 2**30)  # the default
    common.init_params(torch.Generator().manual_seed(7), metas, dtype=dtype)
    assert drawn == [(3, 64, 48), (64, 48)]
