"""The port's SSM and hybrid serving path against the JAX package's.

Inputs come from seeded numpy RandomStates; model weights are the JAX
package's ``init`` tree carried across with ``params_from_jax``.  The JAX
package's SSD kernel runs in interpret mode (``ssd_scan_pallas(...,
interpret=True)``), as its own tests run it; its model never reaches that
kernel (ROADMAP C1: ``models/ssm.py`` dispatches ``ssd_chunk``, which has
only a ``cpu`` registration), so the model-level tests hold the port against
the JAX model's jnp path.  The hybrid's shared attention reaches the Pallas
flash kernel: those tests pin the JAX TACC platform to ``interpret`` and
restore it after.  On the CPU the port's kernel wrappers run their plain
versions.

Tolerances, with their reasons:

* SSD scan at the kernel's layout, f32: atol 1e-5 + rtol 1e-5 against the
  JAX oracle and the Pallas kernel (outputs of order 1; the same f32 sums in
  another order); bf16 inputs: within one bf16 ulp of the JAX value per
  element (both compute in f32 and round once);
* SSD scan at the model's layout (y, the final state, with and without an
  initial state, G = 1 and 2), the decode step and both convolutions, f32:
  atol 1e-5 + rtol 1e-5 (outputs of order 1 to 10; the within-chunk cumsum
  and the einsums sum in another order);
* model logits and every cache leaf, f32: atol ``REL[family]`` of the
  largest |value|: 1e-4 for mamba2, 1e-3 for the hybrid.  The reference's
  init reads fan-in from the layer axis (ROADMAP C5), so the reduced models'
  stacked weights have std 1/sqrt(4) (mamba2) and 1/sqrt(2) (zamba2's
  groups): the pre-softplus dt has std 5.7 and 8, the SSD states reach
  thousands (the noise test prints them) and f32 rounding scales with them.  In
  the hybrid the JAX package's own f32 prefill lies 6.2e-4 of the logits'
  scale from a float64 run of the port, the port's f32 run 6.2e-5
  (``test_hybrid_at_model_scale_is_f32_noise`` prints both);
* prefill + decode against a longer prefill (the port alone): the same
  ``REL``; the SSD state through the chunked scan and through the
  recurrence differ by the order of f32 sums only.

``ssd_scan`` keeps the reference's rule that S is at most the chunk or a
multiple of it, so the prefill/decode consistency runs 31 + 1 against 32
(chunk = S) and 32 + 32 against 64 (two chunks of 32): a prompt of 63 with
chunk 32 is refused by both packages.
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
from repro.kernels import ref as jax_ref  # noqa: E402
from repro.kernels.ssd_scan import ssd_scan_pallas  # noqa: E402
from repro.models import Ctx  # noqa: E402
from repro.models import build as jax_build  # noqa: E402
from repro.models import ssm as jax_ssm  # noqa: E402
from repro.models import transformer as jax_tf  # noqa: E402
from repro.serve import engine as jax_engine  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core import tacc  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels import ssd_scan as ssd  # noqa: E402
from repro_torch.models import build  # noqa: E402
from repro_torch.models import ssm  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.serve import engine  # noqa: E402

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(smoke)

TOL = 1e-5                    # atol and rtol of the function-level f32 checks
REL = {"ssm": 1e-4, "hybrid": 1e-3}   # of the largest |value| (module docstring)
CTX = Ctx(rules={"_axis_sizes": {}, "_zero_stage": 1}, manual=False,
          dp_axes=("data",))
# the shapes of tests/test_kernels.py::test_ssd_scan_sweep: (B, H, nc, Q, P, N)
SSD_SWEEP = [(2, 3, 4, 64, 32, 16), (1, 2, 8, 32, 16, 8)]


@pytest.fixture
def jax_interpret():
    prev = jax_tacc.get_platform()
    jax_tacc.set_platform("interpret")
    try:
        yield
    finally:
        jax_tacc.set_platform(prev)


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _close(got, want, atol=TOL, rtol=TOL):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=atol, rtol=rtol)


def _kernel_layout_inputs(rng, B, H, nc, Q, P, N):
    """The reference test's inputs: x, dt, a_cum, B, C in f32."""
    x = (rng.randn(B, H, nc, Q, P) * 0.5).astype(np.float32)
    dt = (np.abs(rng.randn(B, H, nc, Q)) * 0.1).astype(np.float32)
    A = -np.abs(rng.randn(H)).astype(np.float32)
    a_cum = np.cumsum(dt * A[None, :, None, None], axis=3).astype(np.float32)
    Bi = (rng.randn(B, H, nc, Q, N) * 0.5).astype(np.float32)
    Ci = (rng.randn(B, H, nc, Q, N) * 0.5).astype(np.float32)
    return x, dt, a_cum, Bi, Ci


@pytest.mark.parametrize("shape", SSD_SWEEP)
def test_ssd_scan_plain_matches_jax_ref_and_pallas(shape):
    args = _kernel_layout_inputs(np.random.RandomState(sum(shape)), *shape)
    want_ref = jax_ref.ssd_scan(*map(jnp.asarray, args))
    want_pallas = ssd_scan_pallas(*map(jnp.asarray, args), interpret=True)
    got = ref.ssd_scan(*map(_t, args))
    assert got.dtype == torch.float32 and tuple(got.shape) == shape[:5]
    _close(got, want_ref)
    _close(got, want_pallas)
    # the wrapper runs exactly the plain version on a CPU tensor
    launches = ssd.launches
    assert torch.equal(ssd.ssd_scan(*map(_t, args)), got)
    assert ssd.launches == launches


def _bf16_ulp(v):
    mag = np.maximum(np.abs(v), np.finfo(np.float32).tiny)
    return np.exp2(np.floor(np.log2(mag)) - 7)


def test_ssd_scan_plain_bf16_within_one_ulp_of_jax():
    args = _kernel_layout_inputs(np.random.RandomState(5), *SSD_SWEEP[0])
    xj, Bj, Cj = (jnp.asarray(a).astype(jnp.bfloat16) for a in (args[0], args[3], args[4]))
    want = np.asarray(jax_ref.ssd_scan(xj, jnp.asarray(args[1]), jnp.asarray(args[2]), Bj, Cj)
                      .astype(jnp.float32))
    xt, Bt, Ct = (_t(np.asarray(a.astype(jnp.float32))).bfloat16() for a in (xj, Bj, Cj))
    got = ref.ssd_scan(xt, _t(args[1]), _t(args[2]), Bt, Ct)
    assert got.dtype == torch.bfloat16
    assert np.all(np.abs(got.float().numpy() - want) <= _bf16_ulp(want))


def _model_layout_inputs(rng, B, S, H, P, G, N):
    x = (rng.randn(B, S, H, P) * 0.5).astype(np.float32)
    dt = (np.abs(rng.randn(B, S, H)) * 0.3).astype(np.float32)
    A = -np.abs(rng.randn(H)).astype(np.float32) - 0.1
    Bi = (rng.randn(B, S, G, N) * 0.5).astype(np.float32)
    Ci = (rng.randn(B, S, G, N) * 0.5).astype(np.float32)
    D = rng.randn(H).astype(np.float32)
    return x, dt, A, Bi, Ci, D


# (B, S, H, P, G, N, chunk, with an initial state)
SCAN_CASES = [(2, 96, 4, 16, 1, 8, 32, False), (2, 96, 4, 16, 2, 8, 32, True),
              (1, 64, 8, 32, 2, 16, 64, True), (2, 40, 3, 16, 1, 8, 64, False)]


@pytest.mark.parametrize("case", SCAN_CASES)
def test_model_layout_ssd_scan_matches_jax(case):
    B, S, H, P, G, N, chunk, with_init = case
    rng = np.random.RandomState(S + H + G)
    x, dt, A, Bi, Ci, D = _model_layout_inputs(rng, B, S, H, P, G, N)
    init = (rng.randn(B, H, N, P).astype(np.float32) if with_init else None)
    jy, js = jax_ssm.ssd_scan(*map(jnp.asarray, (x, dt, A, Bi, Ci, D)), chunk,
                              init_state=None if init is None else jnp.asarray(init))
    targs = [_t(a) for a in (x, dt, A, Bi, Ci, D)]
    tinit = None if init is None else _t(init)
    y, s = ssm.ssd_scan(*targs, chunk, init_state=tinit)
    assert y.dtype == torch.float32 and s.dtype == torch.float32
    _close(y, jy)
    _close(s, js)
    # the kernel's model-layout plain version: the same function
    Q = min(chunk, S)
    a_cum = torch.cumsum((targs[1] * targs[2]).reshape(B, S // Q, Q, H), 2).reshape(B, S, H)
    y2, s2 = ssd.ssd_scan_model(targs[0], targs[1], a_cum, targs[3], targs[4], Q, tinit)
    _close(y2 + targs[0] * targs[5][:, None], jy)
    _close(s2, js)
    # and the sequential recurrence
    ry, rs = ssm.ssd_reference(*targs, init_state=tinit)
    _close(ry, jy, atol=1e-4, rtol=1e-4)
    _close(rs, js, atol=1e-4, rtol=1e-4)


def test_ssd_scan_refuses_a_ragged_sequence():
    x, dt, A, Bi, Ci, D = (_t(a) for a in _model_layout_inputs(
        np.random.RandomState(0), 1, 63, 2, 16, 1, 8))
    with pytest.raises(ValueError, match="multiple of the chunk"):
        ssm.ssd_scan(x, dt, A, Bi, Ci, D, 32)


def test_decode_step_and_convs_match_jax():
    rng = np.random.RandomState(7)
    B, H, P, G, N, W, C = 2, 4, 16, 2, 8, 4, 24
    x, dt, A, Bi, Ci, D = _model_layout_inputs(rng, B, 1, H, P, G, N)
    state = rng.randn(B, H, N, P).astype(np.float32)
    jy, js = jax_ssm.ssd_decode_step(*map(jnp.asarray, (state, x, dt, A, Bi, Ci, D)))
    ty, ts = ssm.ssd_decode_step(*(_t(a) for a in (state, x, dt, A, Bi, Ci, D)))
    _close(ty, jy)
    _close(ts, js)
    seq = rng.randn(B, 37, C).astype(np.float32)
    w = (rng.randn(W, C) * 0.5).astype(np.float32)
    _close(ssm.causal_conv1d(_t(seq), _t(w)), jax_ssm.causal_conv1d(jnp.asarray(seq),
                                                                      jnp.asarray(w)))
    cs, xn = rng.randn(B, W - 1, C).astype(np.float32), rng.randn(B, 1, C).astype(np.float32)
    jy, jst = jax_ssm.conv_decode_step(*map(jnp.asarray, (cs, xn, w)))
    ty, tst = ssm.conv_decode_step(_t(cs), _t(xn), _t(w))
    _close(ty, jy)
    _close(tst, jst)


# ---------------------------------------------------------------------------
# The mma route's arithmetic (csrc/ssd_scan.cu, bfloat16 inputs), emulated
# ---------------------------------------------------------------------------

def _split3(v):
    """v (f32) as three bf16-valued f32 parts hi + mid + lo, each the
    round-to-nearest of what the parts before it leave (split_pair)."""
    hi = v.bfloat16().float()
    mid = (v - hi).bfloat16().float()
    return hi, mid, (v - hi - mid).bfloat16().float()


def _mma_route_emulation(x, dt, a, Bm, Cm, init=None):
    """The bf16 route's arithmetic in plain torch, at the kernel's layout:
    x (B,H,nc,Q,P), dt and a (B,H,nc,Q), B and C (B,H,nc,Q,N), all f32
    holding bf16 values but dt and a -> (y f32, final state).  Products of
    two bf16 values are exact in f32, so an f32 matmul of bf16-valued
    operands is what the tensor cores compute (f32 sums in another order).
    C.B^T takes C and B as they are; W = S o exp(a_i - a_j) o dt_j (dt folded
    in, the exponent masked first) goes in as three parts against x; C.s
    against the state's three parts; the update's (exp(a_Q - a_j) dt_j
    B_j)^T in three parts against x.  A test helper, on no path."""
    Bb, H, nc, Q, P = x.shape
    s = torch.zeros(Bb, H, Bm.shape[-1], P) if init is None else init.float().clone()
    causal = torch.ones(Q, Q, dtype=torch.bool).tril()
    zero = torch.zeros(())
    ys = []
    for c in range(nc):
        ac, dtc, xc, Bc, Cc = a[:, :, c], dt[:, :, c], x[:, :, c], Bm[:, :, c], Cm[:, :, c]
        diff = torch.where(causal, ac[..., :, None] - ac[..., None, :], zero)
        W = torch.where(causal, (Cc @ Bc.transpose(-1, -2)) * torch.exp(diff)
                        * dtc[..., None, :], zero)
        y = sum(Cc @ part for part in _split3(s)) * torch.exp(ac)[..., None]
        ys.append(y + sum(part @ xc for part in _split3(W)))
        Bd = (torch.exp(ac[..., -1:] - ac) * dtc)[..., None] * Bc
        s = torch.exp(ac[..., -1])[..., None, None] * s + sum(
            part.transpose(-1, -2) @ xc for part in _split3(Bd))
    return torch.stack(ys, 2), s


def _ssd_inputs(rng, B, H, nc, Q, P, N, dt_scale):
    """The chip_smoke SSD inputs at the kernel's layout, from numpy: x unit
    normals and B, C normals of std 0.5 rounded to bf16 values, dt = scale *
    softplus(normal), A = -exp(0.25 * normal), f32."""
    def bf16(v):
        return torch.from_numpy(v.astype(np.float32)).bfloat16().float().numpy()

    x = bf16(rng.randn(B, H, nc, Q, P))
    dt = (dt_scale * np.log1p(np.exp(rng.randn(B, H, nc, Q)))).astype(np.float32)
    A = -np.exp(0.25 * rng.randn(H)).astype(np.float32)
    a_cum = np.cumsum(dt * A[None, :, None, None], axis=3).astype(np.float32)
    Bi, Ci = (bf16(0.5 * rng.randn(B, H, nc, Q, N)) for _ in range(2))
    return x, dt, a_cum, Bi, Ci


def _within_f32_limits(got, want):
    err = smoke.gmm_error(got, torch.from_numpy(np.array(want, np.float32)))
    assert smoke.gmm_ok(err, "float32", smoke.SSD_LIMITS), smoke.format_gmm(
        err, "float32", smoke.SSD_LIMITS)


# (B, H, nc, Q, P, N, dt scale): Mamba2's P 64 and N 128 at a reduced
# sequence, zamba2's N 64, dt near 20 (a falls by thousands within a chunk),
# one ragged N and a chunk of 64
MMA_EMU_CASES = [(1, 2, 3, 256, 64, 128, 1.0), (2, 2, 2, 128, 64, 64, 1.0),
                 (1, 2, 2, 256, 64, 128, 8.0), (2, 3, 4, 64, 32, 24, 0.01)]


@pytest.mark.parametrize("case", MMA_EMU_CASES, ids=["-".join(map(str, c)) for c in MMA_EMU_CASES])
def test_mma_route_arithmetic_matches_jax_ref_and_pallas(case):
    """The bf16 route's arithmetic (three-part splits, f32 sums) against the
    JAX oracle and the Pallas kernel in interpret mode, on the same
    bf16-valued inputs in f32, within SSD_LIMITS' f32 values."""
    args = _ssd_inputs(np.random.RandomState(sum(case[:6])), *case)
    got, _ = _mma_route_emulation(*map(_t, args))
    _within_f32_limits(got, jax_ref.ssd_scan(*map(jnp.asarray, args)))
    _within_f32_limits(got, ssd_scan_pallas(*map(jnp.asarray, args), interpret=True))


def test_mma_route_arithmetic_with_an_initial_state_matches_jax():
    """With an initial state, dt near 20 and near 0.1 (the slow decay carries
    the state through every chunk): y and the final state against the JAX
    model's ssd_scan (D = 0), within SSD_LIMITS' f32 values."""
    B, S, H, P, G, N, Q = 2, 384, 4, 32, 1, 64, 128
    nc = S // Q
    for dt_scale in (8.0, 0.1):
        rng = np.random.RandomState(11)
        bf16 = lambda v: _t(v).bfloat16().float()  # noqa: E731
        x = bf16(rng.randn(B, S, H, P))
        dt = _t(dt_scale * np.log1p(np.exp(rng.randn(B, S, H))))
        A = _t(-np.exp(0.25 * rng.randn(H)))
        Bi, Ci = (bf16(0.5 * rng.randn(B, S, G, N)) for _ in range(2))
        init = _t(rng.randn(B, H, N, P))
        jy, js = jax_ssm.ssd_scan(*(jnp.asarray(t.numpy()) for t in (x, dt, A, Bi, Ci)),
                                  jnp.zeros(H), Q, init_state=jnp.asarray(init.numpy()))
        a_cum = torch.cumsum((dt * A).reshape(B, nc, Q, H), 2).reshape(B, S, H)
        y, s = _mma_route_emulation(
            *(ssd._to_kernel_layout(t, nc, Q) for t in (x, dt, a_cum)),
            *(ssd._to_kernel_layout(t, nc, Q, H) for t in (Bi, Ci)), init)
        _within_f32_limits(y.movedim(1, 3).reshape(B, S, H, P), jy)
        _within_f32_limits(s, js)


def _smem_blocks_per_sm(smem):
    """Blocks whose shared memory one H100 SM holds: 233472 bytes, of which
    the runtime keeps 1024 per block."""
    return 233472 // (smem + 1024)


def test_mma_route_fits_two_blocks_per_sm():
    """The mma route's shared memory (smem_bytes, the source's mma_layout)
    lets two blocks share an SM at both models' shapes, N 128 (mamba2) and
    N 64 (zamba2), P 64, Q 256; the f32 route's layout did not at N 128."""
    for N in (128, 64):
        assert ssd.smem_bytes(N, 64, 256, torch.bfloat16) <= ssd.MAX_SMEM
        assert _smem_blocks_per_sm(ssd.smem_bytes(N, 64, 256, torch.bfloat16)) >= 2
    assert _smem_blocks_per_sm(ssd.smem_bytes(128, 64, 256, torch.float32)) == 1
    assert ssd.route(torch.bfloat16) == "mma" and ssd.route(torch.float32) == "f32"


def test_ssd_ops_resolve_per_device():
    """``ssd_scan`` dispatches the op ``ssd_scan``: the chunk loop for CPU
    tensors, the kernel's model-layout wrapper for CUDA tensors."""
    assert tacc.resolve("ssd_scan", device_type="cpu") is ssm.ssd_scan_chunks
    assert tacc.resolve("ssd_scan", device_type="cuda") is ssd.ssd_scan_model
    assert tacc.resolve("ssd_chunk", device_type="cpu") is ssm.ssd_chunk_ref


# ---------------------------------------------------------------------------
# the models: reduced mamba2-2.7b, reduced zamba2-7b, and a hybrid with a tail
# ---------------------------------------------------------------------------

def _carried(arch, **over):
    cfg = dataclasses.replace(get_config(arch).reduced(), **over)
    jcfg = dataclasses.replace(jax_get_config(arch).reduced(), **over)
    assert dataclasses.asdict(cfg).items() <= dataclasses.asdict(jcfg).items()
    jmodel = jax_build(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    model = build(cfg)
    params = params_from_jax(jax.tree.map(np.asarray, jparams),
                             metas=model.abstract_params())
    assert model.n_params() == jmodel.n_params()
    return cfg, jcfg, jmodel, jparams, model, params


@pytest.fixture(scope="module")
def mamba2():
    return _carried("mamba2-2.7b")


@pytest.fixture(scope="module")
def zamba2():
    return _carried("zamba2-7b")


@pytest.fixture(scope="module")
def zamba2_tail():
    """15 layers at attn_every 6: 2 groups and a tail of 3, the shape of
    zamba2's 81 = 13 x 6 + 3."""
    return _carried("zamba2-7b", n_layers=15)


def _tokens(cfg, B, S, seed):
    return np.random.RandomState(seed).randint(0, cfg.vocab, (B, S)).astype(np.int32)


def _scale(want):
    """Largest |value|, the masked vocab padding (-1e30) left out."""
    a = np.abs(np.asarray(want, np.float32))
    return max(a[a < 1e29].max(), 1e-30)


def _close_scaled(got, want, rel):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=rel * _scale(want), rtol=0)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_leaves(tree[k], f"{prefix}.{k}" if prefix else k))
        return out
    return {prefix: tree}


def _close_caches(tcache, jcache, rel):
    tl, jl = _leaves(tcache), _leaves(jcache)
    assert sorted(tl) == sorted(jl)
    for name in tl:
        if name == "pos":
            assert tl[name] == int(jl[name])
            continue
        assert tuple(tl[name].shape) == tuple(jl[name].shape), name
        _close_scaled(tl[name], jl[name], rel)


def _prefill_decode(models, S, max_len, steps, seed):
    cfg, _, jmodel, jparams, model, params = models
    B, rel = 2, REL[cfg.family]
    toks = _tokens(cfg, B, S + steps, seed)
    jl, jcache = jax.jit(lambda p, b: jmodel.prefill(p, b, CTX, max_len=max_len))(
        jparams, {"tokens": toks[:, :S]})
    tl, tcache = model.prefill(params, {"tokens": torch.from_numpy(toks[:, :S]).long()},
                               max_len=max_len)
    assert tuple(tl.shape) == (B, 1, cfg.padded_vocab)
    _close_scaled(tl, jl, rel)
    _close_caches(tcache, jcache, rel)
    jdec = jax.jit(lambda p, c, t: jmodel.decode(p, c, t, CTX))
    for t in range(S, S + steps):          # teacher-forced on the same tokens
        jl, jcache = jdec(jparams, jcache, toks[:, t:t + 1])
        tl, tcache = model.decode(params, tcache, torch.from_numpy(toks[:, t:t + 1]).long())
        _close_scaled(tl, jl, rel)
    _close_caches(tcache, jcache, rel)
    return tcache


def test_mamba2_prefill_and_decode_match_jax(mamba2):
    cache = _prefill_decode(mamba2, 64, 68, 4, seed=1)
    cfg = mamba2[0]
    assert tuple(cache["s"].shape) == (cfg.n_layers, 2, cfg.n_ssm_heads, cfg.ssm_state,
                                       cfg.ssm_headdim)
    assert cache["s"].dtype == torch.float32


def test_zamba2_prefill_and_decode_match_jax(zamba2, jax_interpret):
    cache = _prefill_decode(zamba2, 32, 36, 4, seed=2)
    assert "tail" not in cache and cache["groups"]["s"].dtype == torch.float32
    assert tuple(cache["shared_k"].shape)[:3] == (2, 2, 36)


def test_hybrid_with_a_tail_matches_jax(zamba2_tail, jax_interpret):
    cfg, _, _, _, model, params = zamba2_tail
    assert (cfg.n_layers, cfg.attn_every) == (15, 6)
    assert params["groups"]["ln"].shape[:2] == (2, 6) and params["tail"]["ln"].shape[0] == 3
    cache = _prefill_decode(zamba2_tail, 20, 23, 3, seed=3)
    assert cache["tail"]["s"].shape[0] == 3


def test_hybrid_at_model_scale_is_f32_noise(zamba2, jax_interpret):
    """Reduced zamba2's prefill logits: the port's f32 run and the JAX
    package's each against a float64 run of the port (its SSD path stays
    f32, as the reference casts it): the port lies closer to it than JAX
    does, and JAX within REL["hybrid"] of the scale."""
    cfg, _, jmodel, jparams, model, params = zamba2
    toks = _tokens(cfg, 2, 32, 2)
    jl, _ = jax.jit(lambda p, b: jmodel.prefill(p, b, CTX))(jparams, {"tokens": toks})
    batch = {"tokens": torch.from_numpy(toks).long()}
    tl, cache = model.prefill(params, batch)
    m64 = build(dataclasses.replace(cfg, dtype="float64"))
    dl, _ = m64.prefill(jax.tree.map(lambda t: t.double(), params), batch)
    jl, tl, dl = np.asarray(jl, np.float64), tl.double().numpy(), dl.numpy()
    real = np.abs(dl) < 1e29
    scale = np.abs(dl[real]).max()
    jax_err, port_err = np.abs(jl - dl)[real].max(), np.abs(tl - dl)[real].max()
    print(f"\n  logits scale {scale:.3f}; jax-f64 {jax_err:.2e}, port-f64 {port_err:.2e}, "
          f"port-jax {np.abs(tl - jl)[real].max():.2e}; largest |SSD state| "
          f"{cache['groups']['s'].abs().max().item():.1f}")
    assert port_err <= jax_err <= REL["hybrid"] * scale


@pytest.mark.parametrize("arch", ["mamba2", "zamba2", "zamba2_tail"])
def test_forward_lm_matches_jax(request, arch, jax_interpret):
    cfg, jcfg, _, jparams, model, params = request.getfixturevalue(arch)
    toks = _tokens(cfg, 2, 64, 4)
    jx, jaux = jax_tf.forward_lm(jparams, toks, jcfg, CTX)
    want = jax_tf.lm_logits(jparams, jx, jcfg, CTX)
    x, aux = tf.forward_lm(params, torch.from_numpy(toks).long(), cfg)
    _close_scaled(tf.lm_logits(params, x, cfg), want, REL[cfg.family])
    assert float(aux) == float(jaux) == 0.0


@pytest.mark.parametrize("arch", ["mamba2", "zamba2_tail"])
@pytest.mark.parametrize("S,total", [(31, 32), (32, 64)])
def test_prefill_then_decode_equals_a_longer_prefill(request, arch, S, total):
    """Prefill S, decode the next tokens teacher-forced: the last logits and
    the SSM states equal a prefill of all ``total`` tokens (31 + 1: chunk =
    S; 32 + 32: two chunks of 32 and a state carried across them)."""
    cfg, _, _, _, model, params = request.getfixturevalue(arch)
    toks = torch.from_numpy(_tokens(cfg, 2, total, 5)).long()
    _, cache = model.prefill(params, {"tokens": toks[:, :S]}, max_len=total)
    for t in range(S, total):
        logits, cache = model.decode(params, cache, toks[:, t:t + 1])
    want, full = model.prefill(params, {"tokens": toks}, max_len=total)
    _close_scaled(logits, want.numpy(), REL[cfg.family])
    for name, leaf in _leaves(full).items():
        if name.split(".")[-1] in ("s", "conv_x", "conv_B", "conv_C"):
            _close_scaled(_leaves(cache)[name], leaf.float().numpy(), REL[cfg.family])


def _recording(fn, log, kind):
    def run(*args):
        logits, cache = fn(*args)
        inp = args[-1]["tokens"] if kind == "prefill" else args[-1]
        log.append((kind, np.array(inp), np.array(logits, np.float32)))
        return logits, cache
    return run


@pytest.mark.parametrize("arch", ["mamba2", "zamba2"])
def test_batcher_matches_jax(request, arch, jax_interpret):
    """Both batchers over 3 requests in 2 slots (left padding, a dummy
    slot): per-step logits teacher-forced, tokens equal up to the first step
    whose top-2 gap is within the tolerance."""
    cfg, _, jmodel, jparams, model, params = request.getfixturevalue(arch)
    slots, prompt_len, max_new, rel = 2, 32, 4, REL[cfg.family]
    max_len = prompt_len + max_new
    specs = [(32, 4), (20, 3), (27, 4)]
    rng = np.random.RandomState(6)
    prompts = [rng.randint(0, cfg.vocab, n).astype(np.int32) for n, _ in specs]
    jprogs = jax_engine.make_serve_programs(jmodel, compat.make_mesh((1, 1), ("data", "model")),
                                            batch=slots, seq_len=prompt_len, max_len=max_len)
    jlog = []
    jprogs = dataclasses.replace(
        jprogs, prefill_fn=_recording(jprogs.prefill_fn, jlog, "prefill"),
        decode_fn=_recording(jprogs.decode_fn, jlog, "decode"))
    jdone = jax_engine.Batcher(jprogs, jparams, batch_slots=slots, prompt_len=prompt_len,
                               max_len=max_len).run(
        [jax_engine.Request(i, p, m) for i, (p, (_, m)) in enumerate(zip(prompts, specs))])
    progs = engine.make_serve_programs(model, seq_len=prompt_len, max_len=max_len,
                                       device="cpu")
    margins = []
    for kind, inp, want in jlog:
        inp = torch.from_numpy(inp).long()
        if kind == "prefill":
            got, cache = progs.prefill_fn(params, {"tokens": inp})
            margins.append([])
        else:
            got, cache = progs.decode_fn(params, cache, inp)
        _close_scaled(got, want, rel)
        top2 = np.sort(want[:, -1], axis=-1)[:, -2:]
        # a top-2 gap within twice the tolerance may swap the greedy token
        margins[-1].append((top2[:, 1] - top2[:, 0]) / (2 * rel * _scale(want)))
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


def test_init_cache_builds_the_hybrid_cache_and_decodes_from_it(zamba2_tail, jax_interpret):
    """``ServePrograms.init_cache`` over the hybrid's nested metas: f32 SSD
    states, ``pos`` an int, the rest in cfg.dtype; decoding from it (pos 0)
    matches the JAX engine's cache of zeros."""
    cfg, _, jmodel, jparams, model, params = zamba2_tail
    progs = engine.make_serve_programs(model, seq_len=8, max_len=8, device="cpu")
    cache = progs.init_cache(2, 8)
    assert sorted(cache) == ["groups", "pos", "shared_k", "shared_v", "tail"]
    assert cache["pos"] == 0
    assert cache["groups"]["s"].dtype == cache["tail"]["s"].dtype == torch.float32
    assert cache["groups"]["conv_x"].dtype == getattr(torch, cfg.dtype)
    assert tuple(cache["groups"]["s"].shape) == (2, 6, 2, cfg.n_ssm_heads, cfg.ssm_state,
                                                 cfg.ssm_headdim)
    jprogs = jax_engine.make_serve_programs(jmodel, compat.make_mesh((1, 1), ("data", "model")),
                                            batch=2, seq_len=8, max_len=8)
    jcache = jprogs.init_cache(2, 8)
    toks = _tokens(cfg, 2, 3, 8)
    for t in range(3):
        jl, jcache = jprogs.decode_fn(jparams, jcache, jnp.asarray(toks[:, t:t + 1]))
        tl, cache = progs.decode_fn(params, cache, torch.from_numpy(toks[:, t:t + 1]).long())
        _close_scaled(tl, jl, REL["hybrid"])
    _close_caches(cache, jcache, REL["hybrid"])


@pytest.mark.parametrize("arch", ["mamba2-2.7b", "zamba2-7b"])
def test_configs_and_param_counts_match_the_reference(arch):
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    assert dataclasses.asdict(cfg).items() <= dataclasses.asdict(jcfg).items()
    assert cfg.n_params() == jcfg.n_params()
    assert (cfg.d_inner, cfg.n_ssm_heads) == (jcfg.d_inner, jcfg.n_ssm_heads)
    red, jred = cfg.reduced(), jcfg.reduced()
    assert dataclasses.asdict(red).items() <= dataclasses.asdict(jred).items()
    assert red.n_params() == jred.n_params()
    assert build(cfg).n_params() == jax_build(jcfg).n_params()
