"""The port's MoE training path against the JAX package's.

The grouped matmul's backward (the plain version and the autograd Function
around the kernel), ``moe_ffn``'s gradients, the MoE models' loss and
gradients, and whole ZeRO-1 steps of reduced mixtral.  Inputs come from
seeded numpy RandomStates; model weights are the JAX ``init`` tree carried
across with ``params_from_jax``.  The reference has no Pallas backward: its
MoE trains through the VJP of its einsums (``repro/models/moe.py:44-55``),
so the JAX side is ``jax.vjp`` / ``jax.value_and_grad`` on its ``cpu``
paths.  On the CPU the port's wrappers run their plain versions.

Tolerances, from the readings on these inputs:

* plain backward, f32: within rtol 1e-6 of the magnitude sums (``|dy|
  |w|ᵀ`` and ``|x|ᵀ |dy|``, the scale of the rounding error of any order of
  the f32 sums); bf16: within one bf16 ulp per element (both sum exact
  products in f32 and round once);
* ``moe_ffn``'s gradients (f32): each leaf within 1e-5 of its largest
  element (readings up to 5.2e-7): the same f32 sums in another order;
* the models' gradients (f32): each leaf's relative L2 within 5e-4 of its
  norm (readings: worst leaf 1.36e-4 mixtral, 1.22e-4 moonshot) and the
  objective within rtol 1e-6.  Per leaf against its own norm, not one
  scale: the reference's init reads fan-in from the layer axis (ROADMAP
  C5), so the reduced MoE is ill-conditioned, its leaves' gradient norms
  span 1e1 to 6e4, and each package's f32 gradients lie 3.8e-4 to 4.3e-4
  (worst leaf) from the port's float64 gradients of the same model: the
  two packages are closer to each other than either is to float64;
* ZeRO-1 steps: the smollm trainer's tolerances (``test_torch_train.py``)
  for the step-0 loss (1e-5) and the parameters after 3 steps (relative L2
  2e-3; reading 1.12e-3), and 3e-2 for the losses of 3 steps (reading
  1.00e-2 at step 2, 3.8e-4 at step 1): routing is discontinuous, so once
  Adam's sign-sized first step has moved the two packages' weights apart by
  their gradients' rounding, a token whose top-k flips moves the loss by a
  step.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs.base import RunConfig as JaxRunConfig  # noqa: E402
from repro.core import balance as jax_balance  # noqa: E402
from repro.data import pipeline as jax_pipeline  # noqa: E402
from repro.kernels import ref as jax_ref  # noqa: E402
from repro.models import Ctx  # noqa: E402
from repro.models import build as jax_build  # noqa: E402
from repro.models import moe as jax_moe  # noqa: E402
from repro.train.trainer import make_train_program as jax_make_train_program  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import RunConfig  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core import balance, mesh  # noqa: E402
from repro_torch.core.tree import flatten, leaves  # noqa: E402
from repro_torch.data import pipeline  # noqa: E402
from repro_torch.kernels import grouped_matmul as gmm  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models import build  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.train.trainer import make_train_program  # noqa: E402

CTX = Ctx(rules={"_axis_sizes": {}, "_zero_stage": 1}, manual=False, dp_axes=("data",))
FFN_GRAD_TOL = 1e-5           # of each leaf's largest element
MODEL_GRAD_REL_L2 = 5e-4      # of each leaf's norm
STEP0_ATOL, LOSS_ATOL, PARAM_REL_L2 = 1e-5, 3e-2, 2e-3
SEQ = 32


def _np(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _bf16_ulp(v):
    mag = np.maximum(np.abs(v), np.finfo(np.float32).tiny)
    return np.exp2(np.floor(np.log2(mag)) - 7)


def _worst_over_max(got, want):
    """Largest |got - want| over the largest |want| of each pair, the worst."""
    return max(float(np.abs(np.asarray(g, np.float64) - np.asarray(w, np.float64)).max()
                     / np.abs(np.asarray(w, np.float64)).max()) for g, w in zip(got, want))


# ---------------------------------------------------------------------------
# (a) the plain backward against jax.vjp of the reference's grouped_matmul
# ---------------------------------------------------------------------------

# the sweep shapes of tests/test_torch_moe.py, a ragged capacity (333) and a
# capacity buffer whose dropped tokens' rows are zero: (G, M, K, N, zero_rows)
BWD_SHAPES = [(4, 200, 96, 160, False), (1, 128, 128, 128, False), (8, 64, 300, 48, False),
              (3, 333, 64, 72, False), (4, 90, 128, 64, True)]


def _bwd_inputs(G, M, K, N, zero_rows):
    rng = np.random.RandomState(G * 1000 + M)
    x = rng.randn(G, M, K).astype(np.float32)
    w = (rng.randn(G, K, N) * 0.1).astype(np.float32)
    dy = rng.randn(G, M, N).astype(np.float32)
    if zero_rows:                      # dropped tokens: zero rows, zero gradients
        x[:, ::3] = 0
        dy[:, ::3] = 0
    return x, w, dy


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("G,M,K,N,zero_rows", BWD_SHAPES)
def test_plain_backward_matches_jax_vjp(G, M, K, N, zero_rows, dtype):
    x, w, dy = _bwd_inputs(G, M, K, N, zero_rows)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    xj, wj, dyj = (jnp.asarray(a).astype(jdt) for a in (x, w, dy))
    _, vjp = jax.vjp(jax_ref.grouped_matmul, xj, wj)
    jdx, jdw = vjp(dyj)
    xt, wt, dyt = (torch.from_numpy(_np(a)).to(getattr(torch, dtype)) for a in (xj, wj, dyj))
    dx, dw = ref.grouped_matmul_bwd(xt, wt, dyt)
    assert dx.dtype == dw.dtype == xt.dtype
    assert tuple(dx.shape) == (G, M, K) and tuple(dw.shape) == (G, K, N)
    got, want = (dx.float().numpy(), dw.float().numpy()), (_np(jdx), _np(jdw))
    xa, wa, dya = np.abs(_np(xj)), np.abs(_np(wj)), np.abs(_np(dyj))
    scales = (np.einsum("gmn,gkn->gmk", dya, wa), np.einsum("gmk,gmn->gkn", xa, dya))
    for g, w_, s in zip(got, want, scales):
        # f32: the sums' order; bf16: that, rounded once to a neighbouring
        # bf16 value (where the sum cancels, the f32 term dominates)
        ulp = 0 if dtype == "float32" else _bf16_ulp(w_)
        assert np.all(np.abs(g - w_) <= ulp + 1e-6 * s)
    if zero_rows:                      # a dropped token's row of dx stays 0
        assert not dx[:, ::3].any()
    # the wrapper on CPU tensors is the plain version, with gradients asked
    # for one by one
    assert torch.equal(gmm.grouped_matmul_bwd(xt, wt, dyt)[0], dx)
    assert gmm.grouped_matmul_bwd(xt, wt, dyt, need_dx=False)[0] is None
    assert gmm.grouped_matmul_bwd(xt, wt, dyt, need_dw=False)[1] is None


# ---------------------------------------------------------------------------
# (b) the autograd Function
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("layout", ["dense", "layer_slice"])
def test_function_passes_gradcheck_in_f64(layout):
    """The Function's plain forward and backward on CPU tensors against
    ``torch.autograd.gradcheck`` in f64; w may be a layer slice of a stacked
    tensor (the model passes it so)."""
    rng = np.random.RandomState(5)
    x = torch.from_numpy(rng.randn(3, 5, 4)).requires_grad_()
    stacked = torch.from_numpy(rng.randn(2, 3, 4, 6)).requires_grad_()
    if layout == "layer_slice":
        assert torch.autograd.gradcheck(lambda a, s: gmm.grouped_matmul(a, s[1]), (x, stacked))
    else:
        w = stacked[0].detach().clone().requires_grad_()
        assert torch.autograd.gradcheck(gmm.grouped_matmul, (x, w))


def test_function_backward_asks_only_for_what_autograd_needs(monkeypatch):
    calls = []
    real = gmm.grouped_matmul_bwd
    monkeypatch.setattr(gmm, "grouped_matmul_bwd",
                        lambda *a: calls.append(a[3:]) or real(*a))
    x = torch.randn(2, 6, 4)
    w = torch.randn(2, 4, 3, requires_grad=True)
    y = gmm.grouped_matmul(x, w)
    assert y.grad_fn is not None and type(y.grad_fn).__name__ == "GroupedMatmulBackward"
    y.sum().backward()
    assert calls == [(False, True)] and w.grad is not None
    with torch.no_grad():
        assert gmm.grouped_matmul(x, w).grad_fn is None


def test_expert_ffn_gmm_gradients_match_the_plain_composition():
    """``ops.expert_ffn_gmm`` (three Functions, SiLU in f32 between them)
    against autograd of the same composition over the plain einsum, f32:
    equal to rounding."""
    rng = np.random.RandomState(3)
    E, C, D, F = 4, 24, 32, 40
    arrs = [rng.randn(E, C, D), rng.randn(E, D, F) / 6, rng.randn(E, D, F) / 6,
            rng.randn(E, F, D) / 6]
    ct = torch.from_numpy(rng.randn(E, C, D)).float()
    got_in = [torch.from_numpy(a).float().requires_grad_() for a in arrs]
    got = torch.autograd.grad(ops.expert_ffn_gmm(*got_in), got_in, ct)
    want_in = [torch.from_numpy(a).float().requires_grad_() for a in arrs]
    buf, w1, w3, w2 = want_in
    h = (torch.nn.functional.silu(ref.grouped_matmul(buf, w1)) * ref.grouped_matmul(buf, w3))
    want = torch.autograd.grad(ref.grouped_matmul(h, w2), want_in, ct)
    worst = _worst_over_max([g.numpy() for g in got], [w.numpy() for w in want])
    assert worst <= 1e-6, worst


# ---------------------------------------------------------------------------
# (c) moe_ffn's gradients against jax.vjp of the reference's moe_ffn
# ---------------------------------------------------------------------------

# (name, T, D, F, E, k, capacity_factor): as tests/test_torch_moe.py's cases
MOE_CASES = [("mixtral_reduced", 96, 128, 128, 4, 2, 1.25),
             ("e8_k6", 80, 64, 48, 8, 6, 1.25),
             ("drops", 96, 128, 128, 4, 2, 0.5)]
AUX_W = (0.01, 1e-3)        # the objective's weights of moe_aux and moe_z


def _moe_case(case):
    name, T, D, F, E, k, cf = case
    rng = np.random.RandomState(len(name) + 100)
    x = rng.randn(T, D).astype(np.float32)
    p = {"router": rng.randn(D, E).astype(np.float32) / np.sqrt(D),
         "w1": (rng.randn(E, D, F) / np.sqrt(D)).astype(np.float32),
         "w3": (rng.randn(E, D, F) / np.sqrt(D)).astype(np.float32),
         "w2": (rng.randn(E, F, D) / np.sqrt(F)).astype(np.float32)}
    ct = rng.randn(T, D).astype(np.float32)
    return x, p, ct, dict(n_experts=E, top_k=k, capacity_factor=cf)


@pytest.mark.parametrize("case", MOE_CASES, ids=[c[0] for c in MOE_CASES])
def test_moe_ffn_gradients_match_jax(case):
    """Gradients of sum(out * ct) + 0.01 moe_aux + 1e-3 moe_z (both aux
    losses, as the model weighs them) with respect to x, the router and the
    three expert weights: within FFN_GRAD_TOL of each leaf's largest
    element."""
    x, p, ct, kw = _moe_case(case)

    def jobj(xx, pp):
        out, aux = jax_moe.moe_ffn(xx, pp, replicate_buffers=False, **kw)
        return jnp.sum(out * ct) + AUX_W[0] * aux["moe_aux"] + AUX_W[1] * aux["moe_z"]

    jval, (jgx, jgp) = jax.value_and_grad(jobj, argnums=(0, 1))(
        jnp.asarray(x), {n: jnp.asarray(v) for n, v in p.items()})
    xt = torch.from_numpy(x).requires_grad_()
    pt = {n: torch.from_numpy(v).requires_grad_() for n, v in p.items()}
    out, aux = moe.moe_ffn(xt, pt, **kw)
    obj = (out * torch.from_numpy(ct)).sum() + AUX_W[0] * aux["moe_aux"] + AUX_W[1] * aux["moe_z"]
    names = ("router", "w1", "w3", "w2")
    grads = torch.autograd.grad(obj, [xt] + [pt[n] for n in names])
    # the objective's sum cancels: held at the scale of its terms
    scale = float((out.detach().abs() * torch.from_numpy(np.abs(ct))).sum())
    assert abs(float(obj) - float(jval)) <= 1e-6 * scale
    got = [g.numpy() for g in grads]
    want = [np.asarray(jgx)] + [np.asarray(jgp[n]) for n in names]
    worst = {n: _worst_over_max([g], [w]) for n, g, w in zip(("x",) + names, got, want)}
    print(f"\n  {case[0]}: worst |difference| over the leaf's largest element {worst}")
    assert max(worst.values()) <= FFN_GRAD_TOL
    assert np.abs(want[1]).max() > 0            # the router learns through the gates


def test_router_gradient_reaches_the_aux_losses_alone():
    """With the expert output's cotangent 0 the router's gradient is that of
    the aux losses alone, and matches the reference's: ``top1`` counts carry
    no gradient (as ``one_hot`` carries none there), ``moe_aux`` flows
    through the mean probabilities and ``moe_z`` through the logits."""
    x, p, _, kw = _moe_case(MOE_CASES[1])

    def jaux_obj(r):
        _, aux = jax_moe.moe_ffn(jnp.asarray(x), {**p, "router": r}, replicate_buffers=False,
                                 **kw)
        return AUX_W[0] * aux["moe_aux"] + AUX_W[1] * aux["moe_z"]

    want = np.asarray(jax.grad(jaux_obj)(jnp.asarray(p["router"])))
    r = torch.from_numpy(p["router"]).requires_grad_()
    _, aux = moe.moe_ffn(torch.from_numpy(x), {**{n: torch.from_numpy(v) for n, v in p.items()},
                                               "router": r}, **kw)
    (got,) = torch.autograd.grad(AUX_W[0] * aux["moe_aux"] + AUX_W[1] * aux["moe_z"], r)
    assert np.abs(want).max() > 0
    assert _worst_over_max([got.numpy()], [want]) <= FFN_GRAD_TOL


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dispatch_gradient_is_a_fixed_order_f32_sum(dtype):
    """The dispatch's backward (``GatherAssignments``) sums each token's k = 6
    gradients in f32 in one order and rounds once: bit-equal on repeat, equal
    to that sum written out, within f32 noise of JAX's scatter-add (f32);
    in bf16 autograd's own backward of ``x[tok_of]``, which adds in bf16,
    rounds five times and lands elsewhere."""
    T, D, E, k = 64, 32, 8, 6
    rng = np.random.RandomState(9)
    dt = getattr(torch, dtype)
    x = torch.from_numpy(rng.randn(T, D).astype(np.float32)).to(dt)
    idx = torch.from_numpy(np.stack([rng.permutation(E)[:k] for _ in range(T)]))
    order = moe.dispatch_slots(idx, E, T)[0]
    g = torch.from_numpy(rng.randn(T * k, D).astype(np.float32)).to(dt)

    def grad_x(gather):
        xr = x.clone().requires_grad_()
        (out,) = torch.autograd.grad(gather(xr), xr, g)
        return out

    runs = [grad_x(lambda a: moe.GatherAssignments.apply(a, order, k)) for _ in range(2)]
    assert torch.equal(runs[0], runs[1])
    per = torch.empty_like(g)
    per[order] = g
    assert torch.equal(runs[0], per.reshape(T, k, D).float().sum(1).to(dt))
    if dtype == "float32":
        tok_of = (order // k).numpy()
        want = np.asarray(jnp.zeros((T, D)).at[tok_of].add(jnp.asarray(g.numpy())))
        f64 = np.zeros((T, D))
        np.add.at(f64, tok_of, g.double().numpy())
        noise = np.abs(want - f64).max()
        assert np.abs(runs[0].numpy() - want).max() <= 2 * noise + 1e-7
    else:
        atomic_like = grad_x(lambda a: a[order // k])
        assert not torch.equal(atomic_like, runs[0])


# ---------------------------------------------------------------------------
# (d) the models' loss and gradients against jax.value_and_grad
# ---------------------------------------------------------------------------

def _carried(arch):
    cfg, jcfg = get_config(arch).reduced(), jax_get_config(arch).reduced()
    jmodel, model = jax_build(jcfg), build(cfg)
    jparams = jax.tree.map(np.asarray, jax.device_get(
        jmodel.init(jax.random.PRNGKey(0), dtype="float32")))
    return cfg, jmodel, jparams, model, params_from_jax(jparams, metas=model.abstract_params())


@pytest.fixture(scope="module", params=["mixtral-8x7b", "moonshot-v1-16b-a3b"])
def carried(request):
    return _carried(request.param)


def test_model_loss_and_gradients_match_jax(carried):
    """The trainer's objective ``loss + aux * count`` and every leaf's
    gradient against the reference's (``jax.value_and_grad`` of its
    ``model.loss``), with remat on and off: loss within rtol 1e-6, each
    leaf within MODEL_GRAD_REL_L2 of its norm; remat recomputes the routes
    and the aux term bit for bit (the same gradients, the same bits)."""
    cfg, jmodel, jparams, model, params = carried
    rng = np.random.RandomState(1)
    toks = rng.randint(0, cfg.vocab, (2, 40)).astype(np.int32)
    labs = rng.randint(0, cfg.vocab, (2, 40)).astype(np.int32)

    def jobj(p):
        ls, cnt, aux = jmodel.loss(p, {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labs)},
                                   CTX)
        return ls + aux * cnt, aux

    (jval, jaux), jg = jax.jit(jax.value_and_grad(jobj, has_aux=True))(jparams)
    ps, rebuild = flatten(params)
    batch = {"tokens": torch.from_numpy(toks).long(), "labels": torch.from_numpy(labs).long()}
    out = {}
    for remat in (False, True):
        req = [p.clone().requires_grad_() for p in ps]
        ls, cnt, aux = model.loss(rebuild(req), batch, remat=remat)
        obj = ls + aux * cnt
        out[remat] = (obj.detach(), aux.detach(), torch.autograd.grad(obj, req))
    obj, aux, grads = out[False]
    assert float(jaux) > 0
    np.testing.assert_allclose(float(obj), float(jval), rtol=1e-6)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5)
    jleaves = jax.tree.leaves(jg)
    assert len(jleaves) == len(grads)
    rel = [float(np.linalg.norm(g.numpy() - np.asarray(w)) / np.linalg.norm(np.asarray(w)))
           for g, w in zip(grads, jleaves)]
    norms = [float(np.linalg.norm(np.asarray(w))) for w in jleaves]
    print(f"\n  {cfg.name}: leaf gradient norms {min(norms):.2e} .. {max(norms):.2e}; "
          f"worst relative L2 {max(rel):.3e}")
    assert max(rel) <= MODEL_GRAD_REL_L2
    assert torch.equal(out[True][0], obj) and torch.equal(out[True][1], aux)
    assert all(torch.equal(a, b) for a, b in zip(out[True][2], grads))


# ---------------------------------------------------------------------------
# (e) ZeRO-1 steps of reduced mixtral against the JAX trainer
# ---------------------------------------------------------------------------

@pytest.fixture
def one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_zero1_trainer_matches_jax_on_mixtral(mesh3, one_thread, backend):
    """3 ZeRO-1 steps of reduced mixtral (hier) against the JAX trainer from
    the same init and batches: step-0 loss, losses and parameters within the
    module note's tolerances; every rank ends with the same parameters."""
    cfg, jmodel, jparams, model, params = _carried("mixtral-8x7b")
    rc_kw = dict(zero_stage=1, learning_rate=1e-3, param_dtype="float32",
                 collective_mode="hier", backend=backend)
    jprog = jax_make_train_program(jmodel, mesh3, JaxRunConfig(**rc_kw),
                                   jax_balance.uniform_plan(2, 4, 1))
    jstate = jprog.init_fn(jax.random.PRNGKey(0))
    prog = make_train_program(model, mesh.ThreadMesh({"pod": 2, "data": 2}, device="cpu"),
                              RunConfig(**rc_kw), balance.uniform_plan(2, 4, 1))
    state = prog.init_fn(params)
    want, got = [], []
    for s in range(3):
        nm, gmb, _ = prog.batch_shape(SEQ)
        b = pipeline.synthetic_batch(0, s, nm, gmb, SEQ, cfg.vocab)
        jb = jax_pipeline.synthetic_batch(0, s, nm, gmb, SEQ, cfg.vocab)
        jstate, jm = jprog.step_fn(jstate, {k: jnp.asarray(v) for k, v in jb.items()})
        state, m = prog.step_fn(state, b)
        want.append(float(jm["loss"]))
        got.append(m["loss"].item())
    jleaves = [np.asarray(x) for x in jax.tree.leaves(jax.device_get(jstate["params"]))]
    pleaves = [p.numpy() for p in leaves(state[0]["params"])]
    num = sum(float(((g - w) ** 2).sum()) for g, w in zip(pleaves, jleaves))
    rel = (num / sum(float((w ** 2).sum()) for w in jleaves)) ** 0.5
    print(f"\n  mixtral {backend}: losses JAX {want}\n  {' ' * len(backend)}          port "
          f"{got}; params relative L2 {rel:.3e}")
    assert abs(got[0] - want[0]) <= STEP0_ATOL
    np.testing.assert_allclose(got, want, rtol=0, atol=LOSS_ATOL)
    assert rel <= PARAM_REL_L2
    for s in state[1:]:
        assert all(torch.equal(a, b) for a, b in zip(leaves(s["params"]),
                                                     leaves(state[0]["params"])))


# ---------------------------------------------------------------------------
# (f) ZeRO-3 of the MoE family raises at build; (g) the launcher
# ---------------------------------------------------------------------------

def test_moe_zero3_raises_at_build_from_the_launcher():
    from repro_torch.launch import train
    with pytest.raises(NotImplementedError, match="ROADMAP A6b"):
        train.main(["--device", "cpu", "--steps", "1", "--seq", "16", "--zero", "3",
                    "--arch", "moonshot-v1-16b-a3b"])


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "moonshot-v1-16b-a3b"])
def test_train_launcher_runs_moe_on_the_cpu(capsys, arch):
    from repro_torch.launch import train
    hist = train.main(["--device", "cpu", "--steps", "2", "--seq", "32", "--arch", arch,
                       "--reduced", "--backend", "pallas"])
    assert len(hist) == 2 and np.isfinite(hist).all()
    out = capsys.readouterr().out
    assert f"arch={arch}-reduced" in out and "zero=1" in out and "tokens/s" in out
