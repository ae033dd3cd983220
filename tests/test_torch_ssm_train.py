"""The port's SSM and hybrid training path against the JAX package's.

The SSD scan's plain backward (``ref.ssd_scan_bwd`` through the autograd
Function ``ssd_scan.SsdScan``), the Function itself, the models' loss and
gradients (reduced mamba2-2.7b, reduced zamba2-7b, and zamba2 cut to 7
layers so that its tail runs), whole ZeRO-1 steps of both reduced models,
and ZeRO-3's refusal of the two families.  Inputs come from seeded numpy
RandomStates; model weights are the JAX ``init`` tree carried across with
``params_from_jax``.  The reference has no Pallas backward: it trains
through the VJP of its jnp scan (``repro/models/ssm.py:67-92``), so the JAX
side is ``jax.vjp`` / ``jax.value_and_grad`` on its ``cpu`` paths; its
attention runs there as its plain jnp attention, the one it differentiates
(its Pallas flash kernel has no VJP).  On the CPU the port's wrappers run
their plain versions; the SSD op is routed through the Function (its
``cpu`` variant pinned to ``ssd_scan.ssd_scan_model``, which takes the
Function when autograd records), where the port's CPU default is the
reference's chunk loop under autograd.

Tolerances, from the readings on these inputs:

* the SSD scan's gradients (x, dt, A, B, C, D, the initial state), f32:
  each leaf's summed |error| within 1e-5 of its magnitude sum: the summed
  |value| of an elementwise gradient, and for A and D, which sum over every
  position, the summed |term| (|dt dL/d(dt A)| and |x dy|, from a float64
  run of the port).  dA cancels: each package's f32 dA lies up to 1e-5 of
  its summed |value| from float64, but within 2e-7 of its term sum;
  readings up to 8.6e-7.  bf16 inputs held to the f32 oracle on the same
  values: within 4e-3 (dx, dB and dC are rounded to bf16 once by the
  backward and once more where autograd adds the D*x term's gradient to
  dx, each half an ulp, 2^-9, of the element at most);
* the models' gradients (f32): each leaf's relative L2 within
  MODEL_GRAD_REL_L2 of its norm (by family) and the objective within rtol
  1e-6.  Per leaf against its own norm, not one scale: the reference's init
  reads fan-in from the layer axis (ROADMAP C5), so the reduced models' SSD
  states reach thousands and their leaves' gradient norms span orders of
  magnitude.  Readings, worst leaf: mamba2 3.4e-5; zamba2 8.6e-4, where
  the JAX package's own f32 gradients lie 8.3e-4 from a float64 run of the
  port and the port's 4.6e-4 (the hybrid's f32 noise, as its logits'
  in ``tests/test_torch_ssm.py``); zamba2 at 7 layers 2.8e-4;
* ZeRO-1 steps: ``tests/test_torch_moe_train.py``'s bounds, the step-0
  loss within STEP0_ATOL and the three losses within LOSS_ATOL.
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
from repro.configs.base import RunConfig as JaxRunConfig  # noqa: E402
from repro.core import balance as jax_balance  # noqa: E402
from repro.data import pipeline as jax_pipeline  # noqa: E402
from repro.models import Ctx  # noqa: E402
from repro.models import build as jax_build  # noqa: E402
from repro.models import ssm as jax_ssm  # noqa: E402
from repro.train.trainer import make_train_program as jax_make_train_program  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import RunConfig  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core import balance, mesh, tacc  # noqa: E402
from repro_torch.core.tree import flatten  # noqa: E402
from repro_torch.data import pipeline  # noqa: E402
from repro_torch.kernels import ssd_scan as ssd  # noqa: E402
from repro_torch.models import build  # noqa: E402
from repro_torch.models import ssm  # noqa: E402
from repro_torch.train.trainer import make_train_program  # noqa: E402

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(smoke)

CTX = Ctx(rules={"_axis_sizes": {}, "_zero_stage": 1}, manual=False, dp_axes=("data",))
GRAD_L1 = {"float32": 1e-5, "bfloat16": 4e-3}   # of each leaf's summed |value|
MODEL_GRAD_REL_L2 = {"ssm": 2e-4, "hybrid": 2e-3}   # of each leaf's norm
STEP0_ATOL, LOSS_ATOL = 1e-5, 3e-2
SEQ = 64                      # two chunks of the reduced configs' 32


@pytest.fixture
def through_function():
    """The SSD op's ``cpu`` variant pinned to ``ssd_scan_model``, which runs
    the plain forward and, when autograd records, the Function's plain
    backward; restored after."""
    old = tacc.resolve("ssd_scan", "cpu")
    tacc.register("ssd_scan", "cpu")(ssd.ssd_scan_model)
    try:
        yield
    finally:
        tacc.register("ssd_scan", "cpu")(old)


# ---------------------------------------------------------------------------
# (a) the plain backward against jax.vjp of the reference's ssd_scan
# ---------------------------------------------------------------------------

# (B, nc, chunk Q, H, P, G, N, initial state)
SCAN_CASES = [(2, 1, 32, 4, 16, 1, 8, False), (1, 4, 16, 4, 8, 1, 8, True),
              (2, 4, 16, 4, 8, 2, 16, True), (1, 3, 24, 6, 16, 2, 8, False)]


def _scan_inputs(B, nc, Q, H, P, G, N, init):
    rng = np.random.RandomState(B * 100 + nc * 10 + G)
    S = nc * Q
    f = np.float32
    arrs = {"x": rng.randn(B, S, H, P).astype(f),
            "dt": np.log1p(np.exp(rng.randn(B, S, H))).astype(f),
            "A": -np.exp(0.25 * rng.randn(H)).astype(f),
            "B": (0.5 * rng.randn(B, S, G, N)).astype(f),
            "C": (0.5 * rng.randn(B, S, G, N)).astype(f),
            "D": rng.randn(H).astype(f)}
    if init:
        arrs["init"] = rng.randn(B, H, N, P).astype(f)
    cot = (rng.randn(B, S, H, P).astype(f), rng.randn(B, H, N, P).astype(f))
    return arrs, cot


def _port_scan_grads(arrs, cot, Q, dtype):
    """The port's ``ssm.ssd_scan`` through the Function: the gradients of
    sum(y * dy) + sum(final * dfin), in the order of ``arrs``."""
    dt_ = getattr(torch, dtype)
    t = {k: torch.from_numpy(v) for k, v in arrs.items()}
    for k in ("x", "B", "C"):
        t[k] = t[k].to(dt_)
    req = {k: v.clone().requires_grad_() for k, v in t.items()}
    seen = []
    real = ssd.ssd_scan_model_bwd
    ssd.ssd_scan_model_bwd = lambda *a, **kw: seen.append(1) or real(*a, **kw)
    try:
        y, fin = ssm.ssd_scan(req["x"], req["dt"], req["A"], req["B"], req["C"], req["D"], Q,
                              init_state=req.get("init"))
        dy = torch.from_numpy(cot[0]).to(y.dtype)
        obj = (y.float() * dy.float()).sum() + (fin * torch.from_numpy(cot[1])).sum()
        grads = torch.autograd.grad(obj, list(req.values()))
    finally:
        ssd.ssd_scan_model_bwd = real
    assert seen == [1]                  # the Function's backward, once
    return dict(zip(req, grads))


def _magnitude_sums(arrs, cot, Q):
    """Per leaf, the scale of its rounding error (module note), from a
    float64 run of the port's scan with dA = dt A a leaf of its own."""
    t = {k: torch.from_numpy(v.astype(np.float64)) for k, v in arrs.items()}
    B, S, H = t["dt"].shape
    dA = (t["dt"] * t["A"]).requires_grad_()
    req = {k: v.clone().requires_grad_() for k, v in t.items()}
    a_cum = torch.cumsum(dA.reshape(B, S // Q, Q, H), 2).reshape(B, S, H)
    y, fin = ssd.ssd_scan_model(req["x"], req["dt"], a_cum, req["B"], req["C"], Q,
                                req.get("init"))
    y = y + req["x"] * req["D"][:, None]
    dy, dfin = (torch.from_numpy(c.astype(np.float64)) for c in cot)
    grads = torch.autograd.grad((y * dy).sum() + (fin * dfin).sum(), [dA, *req.values()],
                                allow_unused=True)
    out = {k: float(g.abs().sum()) for k, g in zip(req, grads[1:]) if g is not None}
    out["A"] = float((t["dt"] * grads[0]).abs().sum())
    out["D"] = float((t["x"] * dy).abs().sum())
    return out


# every case in f32, and one in bf16 (G 2, four chunks, an initial state)
SCAN_PARAMS = [(c, "float32") for c in SCAN_CASES] + [(SCAN_CASES[2], "bfloat16")]


@pytest.mark.parametrize("case,dtype", SCAN_PARAMS,
                         ids=[f"B{c[0]}nc{c[1]}G{c[5]}init{int(c[7])}-{d}"
                              for c, d in SCAN_PARAMS])
def test_plain_backward_matches_jax_vjp(through_function, case, dtype):
    """Every gradient of the port's SSD scan (through ``SsdScan`` and the
    plain backward) against ``jax.vjp`` of ``repro.models.ssm.ssd_scan`` on
    the same values (bf16: the f32 oracle of the bf16-rounded inputs and
    cotangent), within GRAD_L1 of each leaf's summed |value|."""
    B, nc, Q, H, P, G, N, init = case
    arrs, cot = _scan_inputs(*case)
    if dtype == "bfloat16":        # the values both sides see: bf16-exact x, B, C and dy
        for k in ("x", "B", "C"):
            arrs[k] = np.array(jnp.asarray(arrs[k]).astype(jnp.bfloat16).astype(jnp.float32))
        cot = (np.array(jnp.asarray(cot[0]).astype(jnp.bfloat16).astype(jnp.float32)),
               cot[1])
    names = list(arrs)

    def jfn(*vals):
        kw = dict(zip(names, vals))
        return jax_ssm.ssd_scan(kw["x"], kw["dt"], kw["A"], kw["B"], kw["C"], kw["D"], Q,
                                init_state=kw.get("init"))

    _, vjp = jax.vjp(jfn, *(jnp.asarray(arrs[k]) for k in names))
    want = dict(zip(names, vjp((jnp.asarray(cot[0]), jnp.asarray(cot[1])))))
    got = _port_scan_grads(arrs, cot, Q, dtype)
    scale = _magnitude_sums(arrs, cot, Q)
    worst = {}
    for k in names:
        g, w = got[k].double().numpy(), np.asarray(want[k], np.float64)
        assert g.shape == w.shape, k
        worst[k] = float(np.abs(g - w).sum() / scale[k])
    print(f"\n  {dtype} {case}: summed |error| over the magnitude sum {worst}")
    assert max(worst.values()) <= GRAD_L1[dtype], worst


def test_plain_backward_keeps_group_sums_and_f64():
    """The model-layout plain backward: dB and dC are the f32 sums over each
    group's heads rounded once to B's type, and float64 stays float64."""
    arrs, cot = _scan_inputs(2, 2, 16, 4, 8, 2, 8, True)
    x, dt, Bm, Cm = (torch.from_numpy(arrs[k]) for k in ("x", "dt", "B", "C"))
    A = torch.from_numpy(arrs["A"])
    a = torch.cumsum((dt * A).reshape(2, 2, 16, 4), 2).reshape(2, 32, 4)
    dy, dfin, init = torch.from_numpy(cot[0]), torch.from_numpy(cot[1]), \
        torch.from_numpy(arrs["init"])
    out = ssd.ssd_scan_model_bwd_plain(x.bfloat16(), dt, a, Bm.bfloat16(), Cm.bfloat16(), 16,
                                       dy, dfin, init)
    assert [t.dtype for t in out] == [torch.bfloat16, torch.float32, torch.float32,
                                      torch.bfloat16, torch.bfloat16, torch.float32]
    heads = ssd.ref.ssd_scan_bwd(*(ssd._to_kernel_layout(t, 2, 16, h) for t, h in (
        (x.bfloat16(), None), (dt, None), (a, None), (Bm.bfloat16(), 4), (Cm.bfloat16(), 4),
        (dy, None))), init, dfin)[3]
    per_head = heads.movedim(1, 3).reshape(2, 32, 4, 8)
    assert torch.equal(out[3], per_head.reshape(2, 32, 2, 2, 8).sum(3).bfloat16())
    out64 = ssd.ssd_scan_model_bwd_plain(*(t.double() for t in (x, dt, a, Bm, Cm)), 16,
                                         dy.double(), dfin.double(), init.double())
    assert all(t.dtype == torch.float64 for t in out64)


# ---------------------------------------------------------------------------
# The mma route's arithmetic (csrc/ssd_scan_bwd.cu, bfloat16 inputs), emulated
# ---------------------------------------------------------------------------

# the six part products of two split f32 operands: (part of a, part of b),
# 0 hi, 1 mid, 2 lo; the kernel leaves out mid lo, lo mid and lo lo
SIX_PARTS = ((0, 0), (0, 1), (1, 0), (0, 2), (2, 0), (1, 1))


def _split3(v, lo=True):
    """v (f32) as three bf16-valued f32 parts hi + mid + lo, each the
    round-to-nearest of what the parts before it leave (split_pair); lo
    zero when ``lo`` is false (a planted fault)."""
    hi = v.bfloat16().float()
    mid = (v - hi).bfloat16().float()
    return hi, mid, ((v - hi - mid).bfloat16().float() if lo else torch.zeros_like(v))


def _mma_bwd_emulation(x, dt, a, Bm, Cm, dy, init=None, dfin=None, lo=True, mid_mid=True):
    """The bf16 route's arithmetic in plain torch, at the kernel's layout: x
    (B,H,nc,Q,P), dt and a (B,H,nc,Q), B and C (B,H,nc,Q,N), all f32 holding
    bf16 values but dt, a and dy (B,H,nc,Q,P) f32 -> {dx, ddt, da, dB, dC
    (per head), dinit} in f32.  A product of two bf16 values is exact in f32,
    so an f32 matmul of bf16-valued operands is what the tensor cores compute
    (f32 sums in another order).  Per product, as the kernel: C B^T exact;
    an exact operand against the three parts of the f32 one (dy x^T, M B,
    M^T C, x dy^T, x g^T, B g, C^T (exp(a) o dy)); the six part products
    where both are f32 (dy s^T, T^T dy).  The state's gradient as the
    kernel scans it: every chunk's own term D_c first, then g_{c-1} =
    exp(a_Q) g_c + D_c.  ``lo`` and ``mid_mid`` false plant the faults the
    route's own check must catch.  A test helper, on no path."""
    def parts(v):
        return _split3(v, lo)

    def a_split(f, exact):                     # the f32 operand on the left
        return sum(q @ exact for q in parts(f))

    def b_split(exact, f):                     # the f32 operand on the right
        return sum(exact @ q for q in parts(f))

    def six(f, h):
        pf, ph = parts(f), parts(h)
        return sum(pf[i] @ ph[j] for i, j in SIX_PARTS if mid_mid or (i, j) != (1, 1))

    Bb, H, nc, Q, P = x.shape
    N = Bm.shape[-1]
    causal = torch.ones(Q, Q, dtype=torch.bool).tril()
    zero = torch.zeros(())
    ea, keep, ed = torch.exp(a), torch.exp(a[..., -1]), torch.exp(a[..., -1:] - a)
    s = torch.zeros(Bb, H, N, P) if init is None else init.float()
    s_in = []                                  # the forward's chunk-entry states
    for c in range(nc):
        s_in.append(s)
        s = keep[:, :, c, None, None] * s + torch.einsum(
            "bhjn,bhjp->bhnp", Bm[:, :, c] * ed[:, :, c, :, None], x[:, :, c] * dt[:, :, c, :, None])
    own = [b_split(Cm[:, :, c].transpose(-1, -2), ea[:, :, c, :, None] * dy[:, :, c])
           for c in range(nc)]
    g = torch.zeros(Bb, H, N, P) if dfin is None else dfin.float()
    gs = [g] * nc
    for c in range(nc - 1, 0, -1):
        g = keep[:, :, c, None, None] * g + own[c]
        gs[c - 1] = g
    out = {k: [] for k in ("dx", "ddt", "da", "dB", "dC")}
    for c in range(nc):
        ac, dtc, xc, Bc, Cc, dyc = (t[:, :, c] for t in (a, dt, x, Bm, Cm, dy))
        L = torch.where(causal, torch.exp(torch.where(causal, ac[..., :, None] - ac[..., None, :],
                                                      zero)), zero)
        S = Cc @ Bc.transpose(-1, -2)
        # pass 1, rows i
        M = L * dtc[..., None, :] * a_split(dyc, xc.transpose(-1, -2))
        r = six(dyc, s_in[c].transpose(-1, -2))
        dC = ea[:, :, c, :, None] * r + a_split(M, Bc)
        dar = (S * M).sum(-1) + ea[:, :, c] * (Cc * r).sum(-1)
        # pass 2, rows j: the transposed products
        LT, ST = L.transpose(-1, -2), S.transpose(-1, -2)
        MT = LT * dtc[..., :, None] * b_split(xc, dyc.transpose(-1, -2))
        gx = dtc[..., None] * b_split(xc, gs[c].transpose(-1, -2))
        edc = ed[:, :, c]
        u = edc * (Bc * gx).sum(-1)
        dB = edc[..., None] * gx + a_split(MT, Cc)
        dxdt = edc[..., None] * b_split(Bc, gs[c]) + six(LT * ST, dyc)
        da = dar - (ST * MT).sum(-1) - u
        da[..., -1] += keep[:, :, c] * (gs[c] * s_in[c]).sum((-2, -1)) + u.sum(-1)
        for k, v in (("dx", dtc[..., None] * dxdt), ("ddt", (xc * dxdt).sum(-1)), ("da", da),
                     ("dB", dB), ("dC", dC)):
            out[k].append(v)
    res = {k: torch.stack(v, 2) for k, v in out.items()}
    res["dinit"] = keep[:, :, 0, None, None] * g + own[0] if init is not None else None
    return res


def _mma_bwd_model(x, dt, a_cum, B_in, C_in, chunk, dy, dfin=None, init_state=None, states=None,
                   needs=(True,) * 6, **faults):
    """The emulation at the model's layout, with ``ssd_scan_model_bwd``'s
    signature: dB and dC summed over each group's heads in f32."""
    Bb, S, H, P = x.shape
    G, N = B_in.shape[2], B_in.shape[3]
    nc = S // chunk

    def kl(t, heads=None):
        return ssd._to_kernel_layout(t, nc, chunk, heads).float()

    out = _mma_bwd_emulation(kl(x), kl(dt), kl(a_cum), kl(B_in, H), kl(C_in, H), kl(dy),
                             init_state, dfin, **faults)

    def back(t):
        return t.movedim(1, 3).reshape(Bb, S, H, *t.shape[4:])

    grads = (back(out["dx"]), back(out["ddt"]), back(out["da"]),
             *(back(out[k]).reshape(Bb, S, G, H // G, N).sum(3) for k in ("dB", "dC")),
             out["dinit"])
    return tuple(t if n else None for t, n in zip(grads, needs))


# (B, nc, chunk Q, H, P, G, N, initial state): chunks of 100 and 32 (not
# multiples of the 16-row strip, and of the 64-row stage), G 2 and G = H
MMA_SCAN_CASES = [(2, 3, 100, 4, 32, 2, 16, True), (1, 4, 32, 4, 16, 4, 8, True),
                  (1, 2, 64, 4, 64, 1, 32, False)]


def _bf16_valued(arrs):
    out = dict(arrs)
    for k in ("x", "B", "C"):
        out[k] = np.array(jnp.asarray(arrs[k]).astype(jnp.bfloat16).astype(jnp.float32))
    return out


@pytest.mark.parametrize("case", MMA_SCAN_CASES,
                         ids=[f"Q{c[2]}G{c[5]}H{c[3]}" for c in MMA_SCAN_CASES])
def test_mma_route_arithmetic_matches_jax_vjp(monkeypatch, through_function, case):
    """The bf16 route's arithmetic, emulated, as the Function's backward:
    every gradient of the port's SSD scan (x, dt, A, B, C, D, the initial
    state; dfin given) against ``jax.vjp`` of ``repro.models.ssm.ssd_scan``
    on the same bf16-valued x, B and C and f32 dt, dy and dfin.  Each leaf
    within SSD_BWD_LIMITS' f32 values (relative L2, worst row); A and D,
    whose gradients sum over every position, also within GRAD_L1 of their
    magnitude sums (dA cancels in f32 in both packages)."""
    arrs, cot = _scan_inputs(*case)
    arrs = _bf16_valued(arrs)
    Q, names = case[2], list(arrs)

    def jfn(*vals):
        kw = dict(zip(names, vals))
        return jax_ssm.ssd_scan(kw["x"], kw["dt"], kw["A"], kw["B"], kw["C"], kw["D"], Q,
                                init_state=kw.get("init"))

    _, vjp = jax.vjp(jfn, *(jnp.asarray(arrs[k]) for k in names))
    want = dict(zip(names, vjp((jnp.asarray(cot[0]), jnp.asarray(cot[1])))))
    monkeypatch.setattr(ssd, "ssd_scan_model_bwd", _mma_bwd_model)
    got = _port_scan_grads(arrs, cot, Q, "float32")
    scale = _magnitude_sums(arrs, cot, Q)
    errs = {}
    for k in names:
        g, w = got[k].double(), torch.from_numpy(np.asarray(want[k], np.float64))
        assert g.shape == w.shape, k
        rows = (1, -1) if g.dim() == 1 else (-1, g.shape[-1])
        errs[k] = smoke.gmm_error(g.reshape(rows), w.reshape(rows))
        errs[k]["l1"] = float((g - w).abs().sum() / scale[k])
    print(f"\n  {case}: " + "  ".join(f"{k} {e['rel_l2']:.2e}/{e['worst_row']:.2e}"
                                      for k, e in errs.items()))
    assert all(smoke.gmm_ok(e, "float32", smoke.SSD_BWD_LIMITS) for e in errs.values()), errs
    assert errs["A"]["l1"] <= GRAD_L1["float32"] and errs["D"]["l1"] <= GRAD_L1["float32"]


def _emulation_errors(case, **faults):
    """The emulation (with ``faults``) against the plain backward at the
    model's layout, on bf16-valued inputs of ``case`` at dt scale 1: the
    errors of chip_smoke's SSD_BWD_OUTPUTS (ssd_bwd_errors)."""
    B, nc, Q, H, P, G, N, init = case
    arrs, cot = _scan_inputs(*case)
    arrs = _bf16_valued(arrs)
    t = {k: torch.from_numpy(v) for k, v in arrs.items()}
    a = torch.cumsum((t["dt"] * t["A"]).reshape(B, nc, Q, H), 2).reshape(B, nc * Q, H)
    args = (t["x"], t["dt"], a, t["B"], t["C"], Q, torch.from_numpy(cot[0]),
            torch.from_numpy(cot[1]), t.get("init"))
    got = _mma_bwd_model(*args, **faults)
    want = ssd.ssd_scan_model_bwd_plain(*args)
    return smoke.ssd_bwd_errors(got, want)[0]


@pytest.mark.parametrize("fault", [None, "lo", "mid_mid"])
@pytest.mark.parametrize("case", MMA_SCAN_CASES,
                         ids=[f"Q{c[2]}G{c[5]}H{c[3]}" for c in MMA_SCAN_CASES])
def test_mma_route_check_catches_a_dropped_part(case, fault):
    """chip_smoke's route-own check (SSD_BWD_MMA_REL_L2 on ddt, da and d
    init): the emulated route passes it against the plain backward, and
    fails it with lo dropped from every split (16 bits of each f32
    operand) or with the mid x mid part products left out, which
    SSD_BWD_LIMITS (set for a route that rounds no operand) let through."""
    errs = _emulation_errors(case, **({fault: False} if fault else {}))
    print(f"\n  {case} {fault}: " + "  ".join(
        f"{k} {errs[k]['rel_l2']:.2e}" for k in smoke.SSD_BWD_MMA_CHECKED if k in errs))
    assert all(smoke.gmm_ok(e, "float32", smoke.SSD_BWD_LIMITS) for e in errs.values())
    assert smoke.ssd_bwd_mma_ok(errs) == (fault is None)


# ---------------------------------------------------------------------------
# (b) the autograd Function
# ---------------------------------------------------------------------------

def _f64_inputs(init):
    rng = np.random.RandomState(7)
    B, S, H, P, G, N, Q = 1, 12, 4, 3, 2, 5, 4

    def t(a):
        return torch.from_numpy(np.asarray(a, np.float64)).requires_grad_()

    dt = np.log1p(np.exp(rng.randn(B, S, H)))
    a = np.cumsum((-0.5 * dt).reshape(B, S // Q, Q, H), 2).reshape(B, S, H)
    ins = [t(rng.randn(B, S, H, P)), t(dt), t(a), t(rng.randn(B, S, G, N)),
           t(rng.randn(B, S, G, N))]
    return ins, (t(rng.randn(B, H, N, P)) if init else None), Q


@pytest.mark.parametrize("init", [False, True])
def test_function_passes_gradcheck_in_f64(init):
    """``SsdScan`` on CPU tensors (plain forward, plain backward) against
    ``torch.autograd.gradcheck`` in f64, y and the final state both."""
    ins, init_state, Q = _f64_inputs(init)
    if init:
        assert torch.autograd.gradcheck(
            lambda *z: ssd.SsdScan.apply(*z[:5], Q, z[5]), (*ins, init_state))
    else:
        assert torch.autograd.gradcheck(lambda *z: ssd.ssd_scan_model(*z, Q), tuple(ins))


def test_function_backward_asks_only_for_what_autograd_needs(monkeypatch):
    calls = []
    real = ssd.ssd_scan_model_bwd
    monkeypatch.setattr(ssd, "ssd_scan_model_bwd",
                        lambda *a, needs: calls.append(needs) or real(*a, needs=needs))
    ins, _, Q = _f64_inputs(False)
    x, dt, a, Bm, Cm = (t.detach() for t in ins)
    Bm.requires_grad_()
    y, fin = ssd.ssd_scan_model(x, dt, a, Bm, Cm, Q)
    assert type(y.grad_fn).__name__ == "SsdScanBackward"
    y.sum().backward()
    assert calls == [(False, False, False, True, False, False)] and Bm.grad is not None
    with torch.no_grad():
        assert ssd.ssd_scan_model(x, dt, a, Bm, Cm, Q)[0].grad_fn is None
    grads = real(x, dt, a, Bm, Cm, Q, torch.ones_like(y), needs=(True, False, True, False,
                                                                  False, True))
    assert [g is None for g in grads] == [False, True, False, True, True, True]


# ---------------------------------------------------------------------------
# (c) the models' loss and gradients against jax.value_and_grad
# ---------------------------------------------------------------------------

def _carried(arch, **over):
    cfg = dataclasses.replace(get_config(arch).reduced(), **over)
    jcfg = dataclasses.replace(jax_get_config(arch).reduced(), **over)
    jmodel, model = jax_build(jcfg), build(cfg)
    jparams = jax.tree.map(np.asarray, jax.device_get(
        jmodel.init(jax.random.PRNGKey(0), dtype="float32")))
    return cfg, jmodel, jparams, model, params_from_jax(jparams, metas=model.abstract_params())


MODEL_CASES = {"mamba2": ("mamba2-2.7b", {}), "zamba2": ("zamba2-7b", {}),
               "zamba2_7_layers": ("zamba2-7b", {"n_layers": 7})}


@pytest.fixture(scope="module", params=sorted(MODEL_CASES))
def carried(request):
    arch, over = MODEL_CASES[request.param]
    return _carried(arch, **over)


def test_model_loss_and_gradients_match_jax(carried, through_function):
    """The trainer's objective and every leaf's gradient against the
    reference's (``jax.value_and_grad`` of its ``model.loss``), the SSD op
    through the Function, with remat on and off: loss within rtol 1e-6, each
    leaf within MODEL_GRAD_REL_L2 of its norm; remat gives the same bits."""
    cfg, jmodel, jparams, model, params = carried
    rng = np.random.RandomState(1)
    toks = rng.randint(0, cfg.vocab, (2, SEQ)).astype(np.int32)
    labs = rng.randint(0, cfg.vocab, (2, SEQ)).astype(np.int32)

    def jobj(p):
        ls, cnt, aux = jmodel.loss(p, {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labs)},
                                   CTX)
        return ls + aux * cnt

    jval, jg = jax.jit(jax.value_and_grad(jobj))(jparams)
    ps, rebuild = flatten(params)
    batch = {"tokens": torch.from_numpy(toks).long(), "labels": torch.from_numpy(labs).long()}
    out, seen = {}, []
    real = ssd.ssd_scan_model_bwd
    ssd.ssd_scan_model_bwd = lambda *a, **kw: seen.append(1) or real(*a, **kw)
    try:
        for remat in (False, True):
            req = [p.clone().requires_grad_() for p in ps]
            ls, cnt, aux = model.loss(rebuild(req), batch, remat=remat)
            obj = ls + aux * cnt
            out[remat] = (obj.detach(), torch.autograd.grad(obj, req))
    finally:
        ssd.ssd_scan_model_bwd = real
    n_ssm = cfg.n_layers
    assert len(seen) == 2 * n_ssm                   # one Function backward per Mamba2 block
    obj, grads = out[False]
    np.testing.assert_allclose(float(obj), float(jval), rtol=1e-6)
    jleaves = jax.tree.leaves(jg)
    assert len(jleaves) == len(grads)
    rel = [float(np.linalg.norm(g.numpy() - np.asarray(w)) / np.linalg.norm(np.asarray(w)))
           for g, w in zip(grads, jleaves)]
    norms = [float(np.linalg.norm(np.asarray(w))) for w in jleaves]
    print(f"\n  {cfg.name} ({cfg.n_layers} layers): leaf gradient norms {min(norms):.2e} .. "
          f"{max(norms):.2e}; worst relative L2 {max(rel):.3e}")
    assert min(norms) > 0
    assert max(rel) <= MODEL_GRAD_REL_L2[cfg.family]
    assert torch.equal(out[True][0], obj)
    assert all(torch.equal(a, b) for a, b in zip(out[True][1], grads))
    if cfg.family == "hybrid" and cfg.n_layers % cfg.attn_every:
        assert "tail" in params


# ---------------------------------------------------------------------------
# (d) ZeRO-1 steps against the JAX trainer; ZeRO-3 refused
# ---------------------------------------------------------------------------

@pytest.fixture
def one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.mark.parametrize("backend", ["xla", "pallas"])
@pytest.mark.parametrize("arch", ["mamba2-2.7b", "zamba2-7b"])
def test_zero1_trainer_matches_jax(mesh3, one_thread, through_function, arch, backend):
    """3 ZeRO-1 steps of the reduced model (hier) against the JAX trainer
    from the same init and batches: the step-0 loss within STEP0_ATOL and
    the three losses within LOSS_ATOL; every rank ends with the same
    parameters."""
    cfg, jmodel, jparams, model, params = _carried(arch)
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
    print(f"\n  {arch} {backend}: losses JAX {want}\n    port {got}")
    assert abs(got[0] - want[0]) <= STEP0_ATOL
    np.testing.assert_allclose(got, want, rtol=0, atol=LOSS_ATOL)
    from repro_torch.core.tree import leaves
    for s in state[1:]:
        assert all(torch.equal(a, b) for a, b in zip(leaves(s["params"]),
                                                     leaves(state[0]["params"])))


@pytest.mark.parametrize("arch", ["mamba2-2.7b", "zamba2-7b"])
def test_zero3_of_the_ssm_families_raises_at_build(arch):
    """ZeRO-3 of the SSM and hybrid families needs its own gather plan
    (ROADMAP A7b): the trainer refuses it when the program is built, before
    any step; ZeRO-1 builds."""
    model = build(get_config(arch).reduced())
    m = mesh.ThreadMesh({"pod": 2, "data": 2}, device="cpu")
    plan = balance.uniform_plan(2, 2, micro_batch=1)
    with pytest.raises(NotImplementedError, match="ROADMAP A7b"):
        make_train_program(model, m, RunConfig(zero_stage=3), plan)
    assert make_train_program(model, m, RunConfig(zero_stage=1), plan).model is model
