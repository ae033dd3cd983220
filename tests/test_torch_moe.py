"""The port's MoE serving path against the JAX package's.

Inputs come from seeded numpy RandomStates; model weights are the JAX
package's ``init`` tree carried across with ``params_from_jax``.  Where the JAX
function reaches a Pallas kernel (the grouped matmul, flash attention), it runs
in interpret mode, as the JAX package's own tests run it: model-level tests pin
the JAX TACC platform to ``interpret`` and restore it after.  On the CPU the
port's kernel wrappers run their plain versions.

Tolerances:

* grouped matmul, f32: within rtol 1e-6 of the magnitude sum ``|x| @ |w|``
  (the scale of the rounding error of any order of the f32 sums; the JAX
  kernel sums K in 128-blocks);
* grouped matmul, bf16: within one bf16 ulp of the JAX value per element
  (both sum exact products in f32 and round once; the sums' order may flip
  a rounding);
* ``moe_ffn``, f32: routes, dispatch order, slots, keeps and ``moe_dropped``
  equal; outputs and aux losses within atol 1e-5;
* ``expert_ffn_gmm`` against ``expert_ffn_pallas``, bf16: within one bf16 ulp
  per element (a SiLU rounded at another point than the reference's, f32
  then cast, misses that by far; measured in the test);
* window cache: the updated cache equal, attention within atol 1e-6 (f32);
* model logits, f32: atol 5e-4 of the largest |logit| (about 2e-3 here),
  caches the same of their largest entry; aux losses atol 1e-5.  Not the
  dense model's atol 1e-4 (``test_torch_serve.py``): the reference's init
  scales every stacked weight by 1/sqrt(n_layers) (fan-in read from the
  layer axis), so the expert FFN's f32 sums have terms of 1e2 and outputs
  of 1e3, and both packages sit 2e-4 to 5e-4 from a float64 MoE of the same
  inputs (``test_moe_ffn_at_model_scale_is_f32_noise``); through 4 layers
  the two packages' logits then differ by up to 6.3e-4 at a scale of 4.2.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core import compat  # noqa: E402
from repro.core import tacc as jax_tacc  # noqa: E402
from repro.kernels import ops as jax_ops  # noqa: E402
from repro.models import Ctx  # noqa: E402
from repro.models import attention as jax_attn  # noqa: E402
from repro.models import build as jax_build  # noqa: E402
from repro.models import moe as jax_moe  # noqa: E402
from repro.models import transformer as jax_tf  # noqa: E402
from repro.serve import engine as jax_engine  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.kernels import grouped_matmul as gmm  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models import attention as attn  # noqa: E402
from repro_torch.models import build  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.serve import engine  # noqa: E402
from repro_torch.train.trainer import make_train_program  # noqa: E402

LOGIT_REL = 5e-4              # of the largest |logit| (module docstring)
MOE_ATOL = 1e-5
CTX = Ctx(rules={"_axis_sizes": {}, "_zero_stage": 1}, manual=False,
          dp_axes=("data",))
# the sweep shapes of tests/test_kernels.py::test_grouped_matmul_sweep
GMM_SWEEP = [(4, 200, 96, 160), (1, 128, 128, 128), (8, 64, 300, 48)]


@pytest.fixture
def jax_interpret():
    prev = jax_tacc.get_platform()
    jax_tacc.set_platform("interpret")
    try:
        yield
    finally:
        jax_tacc.set_platform(prev)


def _np(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _bf16_pair(a):
    """The same bf16 values as a JAX array and a torch tensor."""
    j = jnp.asarray(a, jnp.float32).astype(jnp.bfloat16)
    return j, torch.from_numpy(_np(j)).bfloat16()


def _bf16_ulp(v):
    """One bf16 ulp at each |v| (8 significant bits)."""
    mag = np.maximum(np.abs(v), np.finfo(np.float32).tiny)
    return np.exp2(np.floor(np.log2(mag)) - 7)


def _within_one_ulp(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return np.abs(got - want) <= _bf16_ulp(want)


# ---------------------------------------------------------------------------
# grouped matmul: the plain version against the JAX Pallas kernel
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("G,M,K,N", GMM_SWEEP)
def test_grouped_matmul_plain_matches_jax_pallas(G, M, K, N, dtype):
    rng = np.random.RandomState(G * 1000 + K)
    x = rng.randn(G, M, K).astype(np.float32)
    w = (rng.randn(G, K, N) * 0.1).astype(np.float32)
    if dtype == "float32":
        want = np.asarray(jax_ops.grouped_matmul(jnp.asarray(x), jnp.asarray(w),
                                                 interpret=True))
        got = gmm.grouped_matmul(torch.from_numpy(x), torch.from_numpy(w))
        assert got.dtype == torch.float32 and tuple(got.shape) == (G, M, N)
        scale = np.einsum("gmk,gkn->gmn", np.abs(x), np.abs(w))
        assert np.all(np.abs(got.numpy() - want) <= 1e-6 * scale)
        return
    (xj, xt), (wj, wt) = _bf16_pair(x), _bf16_pair(w)
    want = _np(jax_ops.grouped_matmul(xj, wj, interpret=True))
    got = gmm.grouped_matmul(xt, wt)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (G, M, N)
    assert _within_one_ulp(got.float().numpy(), want).all()
    assert torch.equal(got, ref.grouped_matmul(xt, wt))


def _stream_emulation(x, w, plan):
    """The decode route's arithmetic in plain torch: for each tile, each
    block's part (its units' K rows, an f32 sum of the bf16 products) in
    ascending block order, summed in f32 and rounded once to bf16."""
    G, M, K = x.shape
    N = w.shape[2]
    out = torch.empty(G, M, N, dtype=torch.float32)
    ku = plan.units_per_tile
    for t in range(G * plan.n_tiles):
        g, nt = divmod(t, plan.n_tiles)
        cols = slice(nt * plan.bn, min(N, (nt + 1) * plan.bn))
        acc = torch.zeros(M, cols.stop - cols.start)
        for b in plan.parts(t):
            u0, u1 = max(plan.start(b), t * ku), min(plan.start(b + 1), (t + 1) * ku)
            k0, k1 = (u0 - t * ku) * plan.bk, min(K, (u1 - t * ku) * plan.bk)
            acc = acc + x[g, :, k0:k1].float() @ w[g, k0:k1, cols].float()
        out[g, :, cols] = acc
    return out.to(x.dtype)


# (G, M, K, N, SMs): ragged K and N against the 128-row units and 256-column
# tiles; few SMs, so that tiles split into two and three parts
STREAM_EMULATION_CASES = [(3, 2, 1000, 600, 5), (2, 9, 520, 300, 7), (4, 16, 392, 264, 3),
                          (1, 1, 1800, 256, 4)]


@pytest.mark.parametrize("G,M,K,N,sms", STREAM_EMULATION_CASES)
def test_decode_stream_split_k_matches_jax_pallas(G, M, K, N, sms):
    """The decode route's partition (``stream_plan``) and its ascending f32
    sum of split-K parts, emulated in plain torch, against the JAX Pallas
    gmm in interpret mode: within one bf16 ulp per element, as the plain
    version is.  A part left out of the sum misses that by far."""
    rng = np.random.RandomState(G * 100 + K)
    (xj, xt), (wj, wt) = _bf16_pair(rng.randn(G, M, K)), _bf16_pair(rng.randn(G, K, N) * 0.1)
    plan = gmm.stream_plan(G, M, K, N, sms)
    assert max(len(plan.parts(t)) for t in range(G * plan.n_tiles)) >= 2
    want = _np(jax_ops.grouped_matmul(xj, wj, interpret=True))
    got = _stream_emulation(xt, wt, plan)
    assert _within_one_ulp(got.float().numpy(), want).all()
    t = next(t for t in range(G * plan.n_tiles) if len(plan.parts(t)) >= 2)
    g, nt = divmod(t, plan.n_tiles)
    b = plan.parts(t)[0]
    u0, u1 = max(plan.start(b), t * plan.units_per_tile), plan.start(b + 1)
    k0, k1 = (u0 - t * plan.units_per_tile) * plan.bk, (u1 - t * plan.units_per_tile) * plan.bk
    cols = slice(nt * plan.bn, min(N, (nt + 1) * plan.bn))
    short = got.float().clone()
    short[g, :, cols] -= xt[g, :, k0:k1].float() @ wt[g, k0:k1, cols].float()
    assert not _within_one_ulp(short.numpy(), want).all()


def test_grouped_matmul_registered_routes():
    from repro_torch.core import tacc
    assert tacc.resolve("grouped_matmul", device_type="cpu") is ref.grouped_matmul
    assert tacc.resolve("grouped_matmul", device_type="cuda") is gmm.grouped_matmul
    assert tacc.resolve("expert_ffn", device_type="cpu") is moe.expert_ffn_ref
    assert tacc.resolve("expert_ffn", device_type="cuda") is ops.expert_ffn_gmm


# ---------------------------------------------------------------------------
# moe_ffn: routes, drops and outputs against the JAX moe_ffn
# ---------------------------------------------------------------------------

def _jax_routes(x, router, E, k, C):
    """The reference's routing and sort-based dispatch steps
    (``repro/models/moe.py:73-89``), for the comparison of routes."""
    logits = x.astype(jnp.float32) @ router.astype(jnp.float32)
    probs = jax.nn.softmax(logits, axis=-1)
    _, expert_idx = jax.lax.top_k(probs, k)
    flat_e = expert_idx.reshape(-1)
    order = jnp.argsort(flat_e)
    sorted_e = flat_e[order]
    counts = jnp.bincount(flat_e, length=E)
    offsets = jnp.cumsum(counts) - counts
    pos = jnp.arange(flat_e.shape[0]) - offsets[sorted_e]
    keep = pos < C
    slot = jnp.where(keep, sorted_e * C + pos, E * C)
    return [np.asarray(a) for a in (expert_idx, order, slot, keep)]


# (name, T, D, F, E, k, capacity_factor)
MOE_CASES = [("mixtral_reduced", 96, 128, 128, 4, 2, 1.25),
             ("e8_k6", 80, 64, 48, 8, 6, 1.25),
             ("drops", 96, 128, 128, 4, 2, 0.5)]


@pytest.mark.parametrize("case", MOE_CASES, ids=[c[0] for c in MOE_CASES])
def test_moe_ffn_matches_jax(case):
    name, T, D, F, E, k, cf = case
    rng = np.random.RandomState(len(name))
    x = rng.randn(T, D).astype(np.float32)
    p = {"router": rng.randn(D, E).astype(np.float32) / np.sqrt(D),
         "w1": (rng.randn(E, D, F) / np.sqrt(D)).astype(np.float32),
         "w3": (rng.randn(E, D, F) / np.sqrt(D)).astype(np.float32),
         "w2": (rng.randn(E, F, D) / np.sqrt(F)).astype(np.float32)}
    want, jaux = jax_moe.moe_ffn(jnp.asarray(x), {n: jnp.asarray(v) for n, v in p.items()},
                                 n_experts=E, top_k=k, capacity_factor=cf,
                                 replicate_buffers=False)
    pt = {n: torch.from_numpy(v) for n, v in p.items()}
    got, aux = moe.moe_ffn(torch.from_numpy(x), pt, n_experts=E, top_k=k,
                           capacity_factor=cf)

    C = max(int(T * k * cf / E), 1)
    j_idx, j_order, j_slot, j_keep = _jax_routes(jnp.asarray(x), jnp.asarray(p["router"]),
                                                 E, k, C)
    _, _, _, idx = moe.route(torch.from_numpy(x), pt["router"], k)
    order, _, slot, keep = moe.dispatch_slots(idx, E, C)
    np.testing.assert_array_equal(idx.numpy(), j_idx)
    np.testing.assert_array_equal(order.numpy(), j_order)
    np.testing.assert_array_equal(slot.numpy(), j_slot)
    np.testing.assert_array_equal(keep.numpy(), j_keep)
    assert float(aux["moe_dropped"]) == float(jaux["moe_dropped"])
    if name == "drops":
        assert float(aux["moe_dropped"]) > 0.3
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=MOE_ATOL, rtol=0)
    for key in ("moe_aux", "moe_z"):
        np.testing.assert_allclose(float(aux[key]), float(jaux[key]), atol=MOE_ATOL, rtol=0)


def test_moe_ffn_at_model_scale_is_f32_noise(mixtral):
    """Layer 0's MoE of reduced mixtral with the reference's init: the two
    packages differ by no more than each differs from a float64 MoE (the
    reason the model-level tolerance is set against the logits' scale)."""
    _, jcfg, _, jparams, _, params = mixtral
    x = np.random.RandomState(0).randn(96, 128).astype(np.float32)
    kw = dict(n_experts=jcfg.n_experts, top_k=jcfg.top_k, capacity_factor=1.25)
    jo, _ = jax_moe.moe_ffn(jnp.asarray(x), {k: v[0] for k, v in jparams["blocks"]["moe"].items()},
                            replicate_buffers=False, **kw)
    lp = {k: v[0] for k, v in params["blocks"]["moe"].items()}
    to, _ = moe.moe_ffn(torch.from_numpy(x), lp, **kw)
    f64, _ = moe.moe_ffn(torch.from_numpy(x).double(), {k: v.double() for k, v in lp.items()},
                         **kw)
    jo, to, f64 = np.asarray(jo, np.float64), to.double().numpy(), f64.numpy()
    noise = max(np.abs(jo - f64).max(), np.abs(to - f64).max())
    print(f"\n  scale {np.abs(f64).max():.1f}; jax-f64 {np.abs(jo - f64).max():.2e}, "
          f"port-f64 {np.abs(to - f64).max():.2e}, port-jax {np.abs(to - jo).max():.2e}")
    assert np.abs(f64).max() > 100                 # the large-term regime
    assert np.abs(to - jo).max() <= 2 * noise
    assert noise <= 1e-5 * np.abs(f64).max()


def test_top_k_ties_go_to_the_lower_expert():
    """Equal router logits: jax.lax.top_k takes the lower ids; so does route."""
    x = torch.ones(3, 4)
    router = torch.zeros(4, 6)
    router[:, 4] = 1.0                     # expert 4 first, then ties among the rest
    _, _, gates, idx = moe.route(x, router, 3)
    _, j_idx = jax.lax.top_k(jax.nn.softmax(jnp.asarray((x @ router).numpy()), -1), 3)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(j_idx))
    assert idx[0].tolist() == [4, 0, 1]


def test_expert_ffn_gmm_matches_jax_pallas_bf16():
    rng = np.random.RandomState(7)
    E, C, D, F = 4, 40, 128, 128
    buf = rng.randn(E, C, D)
    ws = [rng.randn(E, D, F) / np.sqrt(D), rng.randn(E, D, F) / np.sqrt(D),
          rng.randn(E, F, D) / np.sqrt(F)]
    pairs = [_bf16_pair(a) for a in [buf] + ws]
    want = _np(jax_ops.expert_ffn_pallas(*[j for j, _ in pairs], interpret=True))
    tens = [t for _, t in pairs]
    got = ops.expert_ffn_gmm(*tens)
    assert got.dtype == torch.bfloat16
    assert _within_one_ulp(got.float().numpy(), want).all()
    # the rounding point matters at this tolerance: the same SiLU product
    # without the reference's cast of SiLU to bf16 before it misses
    h1 = gmm.grouped_matmul(tens[0], tens[1]).float()
    h3 = gmm.grouped_matmul(tens[0], tens[2]).float()
    other = gmm.grouped_matmul((torch.nn.functional.silu(h1) * h3).bfloat16(), tens[3])
    assert not _within_one_ulp(other.float().numpy(), want).all()


# ---------------------------------------------------------------------------
# the rolling window cache
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pos", [5, 15, 16, 37])
@pytest.mark.parametrize("window", [16, 13])
def test_window_cache_matches_jax(pos, window):
    rng = np.random.RandomState(pos)
    B, W, Hq, Hkv, hd = 2, 16, 4, 2, 32
    ck, cv = (rng.randn(B, W, Hkv, hd).astype(np.float32) for _ in range(2))
    kn, vn = (rng.randn(B, 1, Hkv, hd).astype(np.float32) for _ in range(2))
    q = rng.randn(B, 1, Hq, hd).astype(np.float32)
    jk, jv = jax_attn.window_cache_update(jnp.asarray(ck), jnp.asarray(cv),
                                          jnp.asarray(kn), jnp.asarray(vn), pos)
    jo = jax_attn.window_decode_attention(jnp.asarray(q), jk, jv, pos, window)
    tk, tv = torch.from_numpy(ck.copy()), torch.from_numpy(cv.copy())
    rk, rv = attn.window_cache_update(tk, tv, torch.from_numpy(kn), torch.from_numpy(vn), pos)
    assert rk is tk and rv is tv                               # in place
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    out = attn.window_decode_attention(torch.from_numpy(q), tk, tv, pos, window)
    np.testing.assert_allclose(out.numpy(), np.asarray(jo), atol=1e-6, rtol=0)


# ---------------------------------------------------------------------------
# the models: reduced mixtral (window 64) and reduced moonshot
# ---------------------------------------------------------------------------

def _carried(arch):
    cfg = get_config(arch).reduced()
    jcfg = jax_get_config(arch).reduced()
    assert dataclasses.asdict(cfg).items() <= dataclasses.asdict(jcfg).items()
    jmodel = jax_build(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    model = build(cfg)
    params = params_from_jax(jax.tree.map(np.asarray, jparams),
                             metas=model.abstract_params())
    assert model.n_params() == jmodel.n_params()
    return cfg, jcfg, jmodel, jparams, model, params


@pytest.fixture(scope="module")
def mixtral():
    return _carried("mixtral-8x7b")


@pytest.fixture(scope="module")
def moonshot():
    return _carried("moonshot-v1-16b-a3b")


def _tokens(cfg, B, S, seed):
    return np.random.RandomState(seed).randint(0, cfg.vocab, (B, S)).astype(np.int32)


def _scale(want):
    """Largest |value|, the masked vocab padding (-1e30) left out."""
    a = np.abs(np.asarray(want, np.float32))
    return a[a < 1e29].max()


def _close(got, want):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=LOGIT_REL * _scale(want), rtol=0)


def _prefill_decode(models, S, max_len, steps, seed):
    cfg, _, jmodel, jparams, model, params = models
    B = 2
    toks = _tokens(cfg, B, S + steps, seed)
    jl, jcache = jax.jit(lambda p, b: jmodel.prefill(p, b, CTX, max_len=max_len))(
        jparams, {"tokens": toks[:, :S]})
    tl, tcache = model.prefill(params, {"tokens": torch.from_numpy(toks[:, :S]).long()},
                               max_len=max_len)
    assert tuple(tl.shape) == (B, 1, cfg.padded_vocab)
    _close(tl, jl)
    assert all(tuple(tcache[n].shape) == tuple(jcache[n].shape) for n in ("k", "v"))
    jdec = jax.jit(lambda p, c, t: jmodel.decode(p, c, t, CTX))
    for t in range(S, S + steps):          # teacher-forced on the same tokens
        jl, jcache = jdec(jparams, jcache, toks[:, t:t + 1])
        tl, tcache = model.decode(params, tcache, torch.from_numpy(toks[:, t:t + 1]).long())
        _close(tl, jl)
    assert tcache["pos"] == int(jcache["pos"]) == S + steps
    for name in ("k", "v"):
        want = np.asarray(jcache[name])
        np.testing.assert_allclose(tcache[name].numpy(), want,
                                   atol=LOGIT_REL * np.abs(want).max(), rtol=0)
    return tcache


# (S, max_len, decode steps): shorter than the window (64), equal, longer
# (rolling cache from the prefill, decode wrapping its slots); a linear cache
# longer than the window (S < W < max_len) decoded past position W; and a
# cache exactly W long from S < W, whose decode wraps by the shape rule
MIXTRAL_CASES = [(40, 43, 3), (64, 67, 3), (80, 83, 3), (40, 100, 30), (40, 64, 30)]


@pytest.mark.parametrize("S,max_len,steps", MIXTRAL_CASES)
def test_mixtral_prefill_and_decode_match_jax(mixtral, jax_interpret, S, max_len, steps):
    W = mixtral[0].window
    assert W == 64
    cache = _prefill_decode(mixtral, S, max_len, steps, seed=S + max_len)
    rolling = S >= W or max_len == W
    assert cache["k"].shape[2] == (W if rolling else max_len)


def test_moonshot_prefill_and_decode_match_jax(moonshot, jax_interpret):
    cfg = moonshot[0]
    assert (cfg.n_experts, cfg.top_k, cfg.window) == (4, 2, 0)
    _prefill_decode(moonshot, 24, 28, 4, seed=11)


@pytest.mark.parametrize("arch", ["mixtral", "moonshot"])
def test_forward_lm_and_loss_aux_match_jax(request, arch):
    cfg, jcfg, jmodel, jparams, model, params = request.getfixturevalue(arch)
    toks = _tokens(cfg, 2, 48, 3)
    jx, jaux = jax_tf.forward_lm(jparams, toks, jcfg, CTX)
    want = jax_tf.lm_logits(jparams, jx, jcfg, CTX)
    x, aux = tf.forward_lm(params, torch.from_numpy(toks).long(), cfg)
    _close(tf.lm_logits(params, x, cfg), want)
    assert float(jaux) > 0
    np.testing.assert_allclose(float(aux), float(jaux), atol=MOE_ATOL, rtol=0)
    labels = _tokens(cfg, 2, 48, 4)
    jl, jc, ja = jmodel.loss(jparams, {"tokens": toks, "labels": labels}, CTX)
    tl, tc, ta = model.loss(params, {"tokens": torch.from_numpy(toks).long(),
                                     "labels": torch.from_numpy(labels).long()})
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    assert float(tc) == float(jc)
    np.testing.assert_allclose(float(ta), float(ja), atol=MOE_ATOL, rtol=0)


def _recording(fn, log, kind):
    def run(*args):
        logits, cache = fn(*args)
        inp = args[-1]["tokens"] if kind == "prefill" else args[-1]
        log.append((kind, np.array(inp), np.array(logits, np.float32)))
        return logits, cache
    return run


def test_batcher_matches_jax(mixtral, jax_interpret):
    """Reduced mixtral through both batchers: prompts of 70 (past the
    window), rolling caches, per-step logits teacher-forced, tokens equal up
    to the first step whose top-2 gap is within the tolerance."""
    cfg, _, jmodel, jparams, model, params = mixtral
    slots, prompt_len, max_new = 2, 70, 4
    max_len = prompt_len + max_new
    rng = np.random.RandomState(2)
    specs = [(70, 4), (50, 3), (66, 4)]
    mesh = compat.make_mesh((1, 1), ("data", "model"))
    jprogs = jax_engine.make_serve_programs(jmodel, mesh, batch=slots,
                                            seq_len=prompt_len, max_len=max_len)
    jlog = []
    jprogs = dataclasses.replace(
        jprogs, prefill_fn=_recording(jprogs.prefill_fn, jlog, "prefill"),
        decode_fn=_recording(jprogs.decode_fn, jlog, "decode"))
    prompts = [rng.randint(0, cfg.vocab, n).astype(np.int32) for n, _ in specs]
    jdone = jax_engine.Batcher(jprogs, jparams, batch_slots=slots, prompt_len=prompt_len,
                               max_len=max_len).run(
        [jax_engine.Request(i, p, m) for i, (p, (_, m)) in enumerate(zip(prompts, specs))])

    progs = engine.make_serve_programs(model, seq_len=prompt_len, max_len=max_len,
                                       device="cpu")
    empty = progs.init_cache(slots, max_len)
    assert tuple(empty["k"].shape)[2] == cfg.window            # sized by cache_metas
    margins = []
    for kind, inp, want in jlog:
        inp = torch.from_numpy(inp).long()
        if kind == "prefill":
            got, cache = progs.prefill_fn(params, {"tokens": inp})
            margins.append([])
        else:
            got, cache = progs.decode_fn(params, cache, inp)
        _close(got, want)
        assert tuple(cache["k"].shape) == tuple(empty["k"].shape)
        top2 = np.sort(want[:, -1], axis=-1)[:, -2:]
        # a top-2 gap within twice the tolerance may swap the greedy token
        margins[-1].append((top2[:, 1] - top2[:, 0]) / (2 * LOGIT_REL * _scale(want)))
    done = engine.Batcher(progs, params, batch_slots=slots, prompt_len=prompt_len,
                          max_len=max_len).run(
        [engine.Request(i, p, m) for i, (p, (_, m)) in enumerate(zip(prompts, specs))])
    assert [r.uid for r in done] == [r.uid for r in jdone] == [0, 1, 2]
    for r, jr in zip(done, jdone):
        assert len(r.out) == len(jr.out) == r.max_new
        m = [margins[r.uid // slots][n][r.uid % slots] for n in range(r.max_new)]
        n_sure = next((n for n, v in enumerate(m) if v <= 1), r.max_new)
        assert n_sure > 0
        assert r.out[:n_sure] == jr.out[:n_sure]


def test_moe_training_is_not_ported_yet():
    """ZeRO-3 of the MoE family is not ported (ZeRO-1 is: tests/
    test_torch_moe_train.py); it raises when the program is built, naming
    its ROADMAP item, not inside a step."""
    from repro_torch.configs.base import RunConfig
    from repro_torch.core import balance, mesh
    model = build(get_config("mixtral-8x7b").reduced())
    with pytest.raises(NotImplementedError, match="ROADMAP A6b"):
        make_train_program(model, mesh.ThreadMesh({"data": 1}, device="cpu"),
                           RunConfig(zero_stage=3), balance.uniform_plan(1, 1, micro_batch=1))
