"""The port's CUDA kernels against their plain versions, on the card.

Every test here needs an NVIDIA card: each is marked ``cuda`` and skips where
``torch.cuda.is_available()`` is false.  The flash-attention kernel is held to
the limits of ``chip_smoke.py`` (``ATTN_LIMITS``), the grouped matmul to
``GMM_LIMITS``; the collective kernels (``collective_reduce``, the fused ring
reduce-scatter and all-gather) bit for bit.  Planted faults in copies of the kernel sources must fail those checks,
and a ring fault that stalls the protocol must raise within seconds.  The
file imports nothing of JAX, so it also runs where JAX is not installed:

    PYTHONPATH=src python -m pytest -q -s --noconftest tests/test_torch_cuda.py
"""
import ctypes
import importlib.util
import subprocess
import time
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import hetccl, mesh  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import collective_reduce as cr  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import grouped_matmul as gmm  # noqa: E402
from repro_torch.kernels import ops, ring_dma  # noqa: E402

pytestmark = pytest.mark.cuda

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(smoke)

NO_CARD = "needs an NVIDIA card (torch.cuda.is_available() is false)"


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip(NO_CARD)
    return torch.Generator(device="cuda").manual_seed(0)


def _inputs(gen, B, Hq, Hkv, Sq, Sk, d, dtype):
    return smoke.attention_inputs(gen, B, Hq, Hkv, Sq, Sk, d, dtype, False)


def _assert_within_limits(got, want):
    dt = str(want.dtype).removeprefix("torch.")
    err = smoke.attention_error(got, want)
    assert smoke.within_limits(err, dt), smoke.format_error(err, dt)


@pytest.mark.parametrize("kind,window,k_len", [("causal", 0, None), ("bidir", 0, None),
                                               ("causal", 64, None), ("bidir", 0, 77)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Hq,Hkv,S,d", [(2, 4, 2, 256, 64), (1, 3, 1, 130, 32),
                                          (1, 8, 2, 200, 128)])
def test_kernel_matches_plain(gen, kind, window, k_len, dtype, B, Hq, Hkv, S, d):
    q, k, v = _inputs(gen, B, Hq, Hkv, S, S, d, dtype)
    before = fa.launches
    got = fa.flash_attention_fwd(q, k, v, kind=kind, window=window, k_len=k_len)
    torch.cuda.synchronize()
    assert fa.launches == before + 1
    want = fa.flash_attention_plain(q, k, v, kind=kind, window=window, k_len=k_len)
    assert got.dtype == dtype and got.shape == q.shape
    _assert_within_limits(got, want)


def test_model_layout_views_match_plain(gen):
    """ops.flash_attention hands the kernel transpose views of (B, S, H, d)."""
    q = torch.randn(2, 77, 9, 64, generator=gen, device="cuda").bfloat16()
    k = torch.randn(2, 77, 3, 64, generator=gen, device="cuda").bfloat16()
    v = torch.randn(2, 77, 3, 64, generator=gen, device="cuda").bfloat16()
    got = ops.flash_attention(q, k, v, kind="causal")
    assert got.is_contiguous()
    want = fa.flash_attention_plain(q.transpose(1, 2), k.transpose(1, 2),
                                    v.transpose(1, 2)).transpose(1, 2)
    _assert_within_limits(got, want)


@pytest.mark.parametrize("bad", ["head_dim", "dtype", "stride", "k_len"])
def test_kernel_raises_on_what_it_does_not_take(gen, bad):
    q, k, v = _inputs(gen, 1, 2, 1, 64, 64, 64, torch.bfloat16)
    kw = {}
    if bad == "head_dim":
        q, k, v = _inputs(gen, 1, 2, 1, 64, 64, 48, torch.bfloat16)
    elif bad == "dtype":
        q, k, v = (t.half() for t in (q, k, v))
    elif bad == "stride":
        q = torch.randn(1, 2, 64, 128, device="cuda").bfloat16()[..., ::2]
    else:
        kw["k_len"] = 65
    before = fa.launches
    with pytest.raises(ValueError):
        fa.flash_attention_fwd(q, k, v, **kw)
    assert fa.launches == before


# name -> (text in csrc/flash_attention.cu, its faulty replacement, the
# attention case (B, Hq, Hkv, S, d, kind, window) that reaches the fault)
FAULTS = {
    "diagonal_key_dropped": ("ok = ok && r >= c;", "ok = ok && r > c;",
                             (2, 9, 3, 512, 64, "causal", 0)),
    "corr_rescale_skipped": ("corr[i] = expf(m_r[i] - m_new);", "corr[i] = 1.f;",
                             (2, 9, 3, 512, 64, "causal", 0)),
    "partial_key_tile_dropped": ("t1 = (kend + bk - 1) / bk;", "t1 = kend / bk;",
                                 (2, 9, 3, 300, 64, "causal", 0)),
    "window_one_key_wide": ("ok = ok && (r - c) < p.window;",
                            "ok = ok && (r - c) <= p.window;",
                            (2, 9, 3, 512, 64, "causal", 64)),
}


def _compile_faults(tmp_path_factory, source, faults):
    """Each planted fault compiled from a copy of ``csrc/<source>.cu``, one
    nvcc per copy, all started together."""
    if not torch.cuda.is_available():
        pytest.skip(NO_CARD)
    src = (_build.CSRC / f"{source}.cu").read_text()
    out_dir = tmp_path_factory.mktemp(f"faulty_{source}")
    procs = {}
    for name, (good, bad, _) in faults.items():
        assert src.count(good) == 1, f"{name}: {good!r} is not in the source once"
        cu = out_dir / f"{name}.cu"
        cu.write_text(src.replace(good, bad))
        so = out_dir / f"lib{name}.so"
        procs[name] = (subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), so)
    libs = {}
    for name, (proc, so) in procs.items():
        log, _ = proc.communicate()
        assert proc.returncode == 0, log
        libs[name] = ctypes.CDLL(str(so))
    return libs


@pytest.fixture(scope="module")
def faulty_libs(tmp_path_factory):
    return _compile_faults(tmp_path_factory, "flash_attention", FAULTS)


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_planted_fault_fails_the_limits(gen, faulty_libs, monkeypatch, fault):
    B, Hq, Hkv, S, d, kind, window = FAULTS[fault][2]
    q, k, v = _inputs(gen, B, Hq, Hkv, S, S, d, torch.bfloat16)
    want = fa.flash_attention_plain(q, k, v, kind=kind, window=window)
    good = smoke.attention_error(
        fa.flash_attention_fwd(q, k, v, kind=kind, window=window), want)
    monkeypatch.setattr(fa, "_fn", fa.bind(faulty_libs[fault]))
    bad = smoke.attention_error(
        fa.flash_attention_fwd(q, k, v, kind=kind, window=window), want)
    print(f"\n  {fault}: kernel {smoke.format_error(good, 'bfloat16')}"
          f"\n  {' ' * len(fault)}  fault  {smoke.format_error(bad, 'bfloat16')}")
    assert smoke.within_limits(good, "bfloat16")
    assert not smoke.within_limits(bad, "bfloat16")


# ---------------------------------------------------------------------------
# Collective kernels: collective_reduce and the fused rings, bit for bit
# ---------------------------------------------------------------------------

RING_TEST_C = 100_003


@pytest.mark.parametrize("case", smoke.RING_CASES,
                         ids=["-".join(str(v) for v in c) for c in smoke.RING_CASES])
def test_ring_kernel_matches_plain_bitwise(gen, case):
    kind, n, n_rings = case[:3]
    xs, rings = smoke.ring_case_inputs(torch, gen, kind, n, n_rings, case[5], RING_TEST_C)
    before = ring_dma.rs_launches + ring_dma.ag_launches
    outs, wants = smoke.run_ring_case(torch, ring_dma, case, xs, rings)
    torch.cuda.synchronize()
    assert ring_dma.rs_launches + ring_dma.ag_launches == before + 1
    same, diff = smoke.bitwise_error(outs, wants)
    assert same, diff


@pytest.mark.parametrize("inc_dtype,length", smoke.REDUCE_CASES)
def test_collective_reduce_matches_plain_bitwise(gen, inc_dtype, length):
    acc = torch.randn(length, generator=gen, device="cuda")
    inc = torch.randn(length, generator=gen, device="cuda").to(getattr(torch, inc_dtype))
    before = cr.launches
    got = cr.collective_reduce(acc, inc)
    assert cr.launches == before + 1
    assert smoke.bitwise_error([got], [cr.collective_reduce_plain(acc, inc)])[0]


@pytest.mark.parametrize("mode", ["flat", "hier", "pipelined"])
def test_thread_mesh_pallas_equals_xla_on_the_card(gen, mode):
    """On a CUDA ThreadMesh the pallas backend launches the fused kernels and
    gives the xla rings' bits (f32) in hier and pipelined mode; flat xla is
    one psum over all ranks, flat pallas a ring per axis, so there the sums
    run in another order (rtol 1e-6)."""
    m = mesh.ThreadMesh({"pod": 2, "data": 2}, device="cuda")
    xs = [torch.randn(1000, 37, generator=gen, device="cuda") for _ in range(4)]
    outs = {}
    for b in ("xla", "pallas"):
        before = ring_dma.rs_launches + ring_dma.ag_launches
        cfg = hetccl.HetCCLConfig(mode=mode, backend=b, n_channels=2)
        outs[b] = m.run(lambda v: hetccl.all_reduce(v, cfg), xs)
        launched = ring_dma.rs_launches + ring_dma.ag_launches - before
        assert (launched > 0) == (b == "pallas")
    for a, b in zip(outs["xla"], outs["pallas"]):
        if mode == "flat":
            torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)
        else:
            assert torch.equal(a, b)


def test_fused_ring_raises_instead_of_falling_back(gen):
    """A wire dtype the kernel does not take raises on the card; nothing
    falls back to the emulated schedule."""
    m = mesh.ThreadMesh({"pod": 2}, device="cuda")
    xs = [torch.randn(8, generator=gen, device="cuda") for _ in range(2)]
    with pytest.raises(ValueError, match="wire dtype"):
        m.run(lambda v: ring_dma.ring_reduce_scatter(v, "pod", wire_dtype=torch.float16), xs)


# name -> (text in csrc/ring_dma.cu, its faulty replacement, the ring case
# (kind, n, rings, direction, stripes, input, wire) that reaches the fault)
RING_FAULTS = {
    "credit_never_signalled": (
        "if (s + 2 <= n - 2) cta_signal(cap_flag(g, g.src[r], par, k), tag(g, s));", "",
        ("rs", 4, 1, 1, 1, "float32", "float32")),
    "wrong_parity_slot_read": (
        "to_float(__ldcg(slot_me + par * c + e))",
        "to_float(__ldcg(slot_me + (par ^ 1) * c + e))",
        ("rs", 3, 1, 1, 2, "float32", "float32")),
    "bf16_rounding_skipped": (
        "return __float2bfloat16_rn(v);",
        "return __ushort_as_bfloat16((unsigned short)(__float_as_uint(v) >> 16));",
        ("rs", 4, 1, -1, 1, "float32", "bfloat16")),
}


@pytest.fixture(scope="module")
def faulty_ring_libs(tmp_path_factory):
    return _compile_faults(tmp_path_factory, "ring_dma", RING_FAULTS)


@pytest.mark.parametrize("fault", sorted(RING_FAULTS))
def test_planted_ring_fault_fails(gen, faulty_ring_libs, monkeypatch, fault):
    case = RING_FAULTS[fault][2]
    xs, rings = smoke.ring_case_inputs(torch, gen, case[0], case[1], case[2], case[5],
                                       RING_TEST_C)
    good, wants = smoke.run_ring_case(torch, ring_dma, case, xs, rings)
    assert smoke.bitwise_error(good, wants)[0]
    monkeypatch.setattr(ring_dma, "_lib", ring_dma.bind(faulty_ring_libs[fault]))
    t0 = time.perf_counter()
    try:
        bad, _ = smoke.run_ring_case(torch, ring_dma, case, xs, rings)
        torch.cuda.synchronize()
        same, diff = smoke.bitwise_error(bad, wants)
        reading = f"max_abs_err {diff:.3e}, bitwise equal: {same}"
        raised = None
    except ring_dma.RingProtocolError as e:
        same, raised = False, e
        reading = f"raised after {time.perf_counter() - t0:.2f} s: {e}"
    print(f"\n  {fault}: {reading}")
    assert not same
    if fault == "credit_never_signalled":
        assert raised is not None and time.perf_counter() - t0 < 30


# ---------------------------------------------------------------------------
# Training path: the codec kernels (bit for bit), the flash backward (the
# limits of chip_smoke.py's BWD_LIMITS), planted faults, a training run
# ---------------------------------------------------------------------------

from repro_torch.kernels import quant, ref  # noqa: E402


@pytest.mark.parametrize("name,rows,fill", smoke.QUANT_ROWS + [("bucket_hop", 6912, "randn")],
                         ids=[c[0] for c in smoke.QUANT_ROWS] + ["bucket_hop"])
def test_codec_kernels_match_plain_bitwise(gen, name, rows, fill):
    x = smoke.quant_inputs(torch, gen, rows, fill)
    acc = torch.randn(rows, 512, generator=gen, device="cuda")
    for xx, aa in ((x, acc), (x.reshape(-1)[1:1 + 509 * max(rows - 1, 1)].reshape(-1, 509),
                              acc.reshape(-1)[3:3 + 509 * max(rows - 1, 1)].reshape(-1, 509))):
        before = (quant.quant_launches, quant.dq_launches)
        c, s = quant.wire_quantize_int8(xx)
        d = quant.wire_dequant_accum_int8(aa, c, s)
        torch.cuda.synchronize()
        assert (quant.quant_launches, quant.dq_launches) == (before[0] + 1, before[1] + 1)
        c2, s2 = ref.wire_quantize(xx)
        assert smoke.same_bits(c, c2) and smoke.same_bits(s, s2)
        assert smoke.same_bits(d, ref.wire_dequant_accum(aa, c, s))


def _bwd_case(gen, case):
    name, B, Hq, Hkv, S, d, kind, window, k_len, dt, model_layout = case
    dtype = getattr(torch, dt)
    q, k, v = smoke.attention_inputs(gen, B, Hq, Hkv, S, S, d, dtype, model_layout)
    do = torch.randn(q.shape, generator=gen, device="cuda").to(dtype)
    kw = dict(kind=kind, window=window, k_len=S if k_len is None else k_len)
    o, lse = fa.flash_attention_fwd(q, k, v, return_lse=True, **kw)
    want = fa.flash_attention_bwd_plain(q, k, v, o, do, ref.attention_lse(q, k, **kw), **kw)
    return (q, k, v, o, do, lse), kw, want


def _bwd_within_limits(got, want, dt):
    rel_lim, row_lim = smoke.BWD_LIMITS[dt]
    errs = [smoke.bwd_error(g, w) for g, w in zip(got, want)]
    return all(e["rel_l2"] <= rel_lim and e["worst_row"] <= row_lim for e in errs), errs


@pytest.mark.parametrize("case", smoke.BWD_CASES, ids=[c[0] for c in smoke.BWD_CASES])
def test_flash_bwd_matches_plain(gen, case):
    args, kw, want = _bwd_case(gen, case)
    before = fa.bwd_launches
    got = fa.flash_attention_bwd(*args, **kw)
    torch.cuda.synchronize()
    assert fa.bwd_launches == before + 1
    ok, errs = _bwd_within_limits(got, want, case[9])
    assert ok, errs
    # no atomics: a second launch gives the same bits
    again = fa.flash_attention_bwd(*args, **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def test_flash_function_on_the_card_matches_plain_autograd(gen):
    """FlashAttention.apply on CUDA tensors (both kernels) against autograd of
    the plain attention, f32, in model layout through ops.flash_attention."""
    q = torch.randn(2, 130, 9, 64, generator=gen, device="cuda", requires_grad=True)
    k = torch.randn(2, 130, 3, 64, generator=gen, device="cuda", requires_grad=True)
    v = torch.randn(2, 130, 3, 64, generator=gen, device="cuda", requires_grad=True)
    do = torch.randn(2, 130, 9, 64, generator=gen, device="cuda")
    before = (fa.launches, fa.bwd_launches)
    out = ops.flash_attention(q, k, v, kind="causal")
    got = torch.autograd.grad(out, (q, k, v), do)
    assert (fa.launches, fa.bwd_launches) == (before[0] + 1, before[1] + 1)
    plain = fa.flash_attention_plain(q.transpose(1, 2), k.transpose(1, 2),
                                     v.transpose(1, 2)).transpose(1, 2)
    want = torch.autograd.grad(plain, (q, k, v), do)
    for g, w in zip(got, want):
        assert smoke.bwd_error(g, w)["rel_l2"] <= smoke.BWD_LIMITS["float32"][0]


# name -> (source, text in it, its faulty replacement, the case that reaches it)
TRAIN_FAULTS = {
    "roundf_for_rintf": ("quant", "rintf(", "roundf(", ("half_way", 600, "half")),
    "fma_in_dq_accum": ("quant", "return __fadd_rn(acc, __fmul_rn(static_cast<float>(c), s));",
                        "return acc + static_cast<float>(c) * s;", ("wide_range", 5000, "randn")),
    "gqa_head_skipped_in_dkdv": (
        "flash_attention_bwd",
        "for (int h = hk * group; h < (hk + 1) * group; ++h) {\n"
        "    const long long row_base = ((long long)b * p.Hq + h) * p.Sq;\n"
        "    for (int qt = t0; qt < t1; ++qt) {\n      const int q0 = qt * kMmaB;",
        "for (int h = hk * group; h < (hk + 1) * group - 1; ++h) {\n"
        "    const long long row_base = ((long long)b * p.Hq + h) * p.Sq;\n"
        "    for (int qt = t0; qt < t1; ++qt) {\n      const int q0 = qt * kMmaB;",
        smoke.BWD_CASES[0]),
    "causal_mask_dropped_in_bwd": ("flash_attention_bwd", "if (p.causal) ok = ok && r >= c;",
                                   "", smoke.BWD_CASES[0]),
}


@pytest.fixture(scope="module")
def faulty_train_libs(tmp_path_factory):
    libs = {}
    for source in ("quant", "flash_attention_bwd"):
        libs.update(_compile_faults(tmp_path_factory, source, {
            name: (good, bad, case) for name, (src, good, bad, case) in TRAIN_FAULTS.items()
            if src == source}))
    return libs


@pytest.mark.parametrize("fault", sorted(TRAIN_FAULTS))
def test_planted_training_fault_fails(gen, faulty_train_libs, monkeypatch, fault):
    source, _, _, case = TRAIN_FAULTS[fault]
    if source == "quant":
        _, rows, fill = case
        x = smoke.quant_inputs(torch, gen, rows, fill)
        acc = torch.randn(rows, 512, generator=gen, device="cuda")
        c, s = ref.wire_quantize(x)
        want = (c, s, ref.wire_dequant_accum(acc, c, s))

        def run():
            cc, ss = quant.wire_quantize_int8(x)
            return cc, ss, quant.wire_dequant_accum_int8(acc, c, s)

        good = run()
        monkeypatch.setattr(quant, "_lib", quant.bind(faulty_train_libs[fault]))
        bad = run()
        torch.cuda.synchronize()
        same = [smoke.same_bits(a, b) for a, b in zip(bad, want)]
        print(f"\n  {fault}: codes, scales, dequantize-accumulate bit for bit: {same}")
        assert all(smoke.same_bits(a, b) for a, b in zip(good, want))
        assert not all(same)
        return
    args, kw, want = _bwd_case(gen, case)
    good_ok, _ = _bwd_within_limits(fa.flash_attention_bwd(*args, **kw), want, case[9])
    monkeypatch.setattr(fa, "_bwd_fn", fa.bind_bwd(faulty_train_libs[fault]))
    bad_ok, errs = _bwd_within_limits(fa.flash_attention_bwd(*args, **kw), want, case[9])
    print(f"\n  {fault}: dq/dk/dv errors {[{k: f'{v:.3e}' for k, v in e.items()} for e in errs]}")
    assert good_ok and not bad_ok


def test_two_training_steps_on_the_card(gen):
    """A reduced model, bf16 parameters, int8 codec with error feedback, on a
    CUDA ThreadMesh (pod=2, data=2): finite falling losses and the launches
    the step implies."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import RunConfig
    from repro_torch.core import balance
    from repro_torch.core.tree import leaves
    from repro_torch.data.pipeline import synthetic_batch
    from repro_torch.models import build
    from repro_torch.train.trainer import make_train_program
    cfg = get_config("smollm-135m").reduced()
    model = build(cfg)
    m = mesh.ThreadMesh({"pod": 2, "data": 2}, device="cuda")
    plan = balance.uniform_plan(2, 4, micro_batch=2)
    prog = make_train_program(model, m, RunConfig(collective_mode="hier", backend="pallas",
                                                  wire_quant="int8", learning_rate=3e-3),
                              plan)
    params = model.init(torch.Generator(device="cuda").manual_seed(0), dtype=torch.bfloat16)
    state = prog.init_fn(params)
    batch = synthetic_batch(0, 0, plan.n_micro_max, plan.micro_batch * 4, 128, cfg.vocab)
    counters = smoke.Counters(fa, quant, ring_dma, cr, gmm)
    counters.reset()
    losses = []
    for _ in range(2):
        state, met = prog.step_fn(state, batch)
        losses.append(met["loss"].item())
    got = counters.read()
    n_buckets = len(hetccl._make_buckets([p.float() for p in leaves(params)],
                                         prog.comm.bucket_bytes))
    want = smoke.train_counts(cfg.n_layers, plan.n_micro_max, 4, len(leaves(params)),
                              n_buckets, 2)
    assert all(got[k] == 2 * v for k, v in want.items()), (got, want)
    assert all(map(lambda x: x == x and abs(x) < 1e4, losses)) and losses[1] < losses[0]


# ---------------------------------------------------------------------------
# MoE path: the grouped matmul (the limits of chip_smoke.py's GMM_LIMITS)
# ---------------------------------------------------------------------------

def _gmm_case(gen, case):
    name, G, M, K, N, dt, layout = case
    x, w = smoke.gmm_inputs(torch, gen, G, M, K, N, dt, layout)
    return x, w, ref.grouped_matmul(x, w)


@pytest.mark.parametrize("case", smoke.GMM_CASES, ids=[c[0] for c in smoke.GMM_CASES])
def test_gmm_matches_plain(gen, case):
    x, w, want = _gmm_case(gen, case)
    before = gmm.launches
    got = gmm.grouped_matmul(x, w)
    torch.cuda.synchronize()
    assert gmm.launches == before + 1
    assert got.dtype == x.dtype and got.shape == want.shape and got.is_contiguous()
    err = smoke.gmm_error(got, want)
    assert smoke.gmm_ok(err, case[5]), smoke.format_gmm(err, case[5])
    if case[6] == "zero_rows":
        assert bool((got[x.abs().amax(-1) == 0] == 0).all())
    assert torch.equal(got, gmm.grouped_matmul(x, w))        # no atomics: same bits


@pytest.mark.parametrize("bad", ["dtype", "mixed_dtype", "groups", "depth", "last_stride",
                                 "rank"])
def test_gmm_raises_on_what_it_does_not_take(gen, bad):
    x = torch.randn(4, 8, 64, generator=gen, device="cuda").bfloat16()
    w = torch.randn(4, 64, 32, generator=gen, device="cuda").bfloat16()
    if bad == "dtype":
        x, w = x.half(), w.half()
    elif bad == "mixed_dtype":
        w = w.float()
    elif bad == "groups":
        w = w[:3]
    elif bad == "depth":
        w = w[:, :48]
    elif bad == "last_stride":
        w = torch.randn(4, 64, 64, generator=gen, device="cuda").bfloat16()[..., ::2]
    else:
        x = x[0]
    before = gmm.launches
    with pytest.raises(ValueError):
        gmm.grouped_matmul(x, w)
    assert gmm.launches == before


def test_gmm_raises_where_autograd_needs_its_backward(gen):
    x = torch.randn(2, 8, 64, generator=gen, device="cuda", requires_grad=True)
    w = torch.randn(2, 64, 32, generator=gen, device="cuda")
    with pytest.raises(NotImplementedError, match="backward"):
        gmm.grouped_matmul(x, w)
    with torch.no_grad():
        assert gmm.grouped_matmul(x, w).shape == (2, 8, 32)


def test_expert_ffn_on_the_card_takes_the_kernel(gen):
    """moe_ffn on CUDA tensors reaches expert_ffn_gmm: three launches, and the
    output within FFN_LIMITS of the same composition through the plain gmm."""
    from repro_torch.core import tacc
    from repro_torch.models import moe
    T, D, F, E = 96, 256, 384, 4
    x = torch.randn(T, D, generator=gen, device="cuda").bfloat16()
    p = {"router": torch.randn(D, E, generator=gen, device="cuda").bfloat16(),
         "w1": (torch.randn(E, D, F, generator=gen, device="cuda") / 16).bfloat16(),
         "w3": (torch.randn(E, D, F, generator=gen, device="cuda") / 16).bfloat16(),
         "w2": (torch.randn(E, F, D, generator=gen, device="cuda") / 20).bfloat16()}
    before = gmm.launches
    out, aux = moe.moe_ffn(x, p, n_experts=E, top_k=2, capacity_factor=1.25)
    assert gmm.launches == before + 3
    assert tacc.resolve("expert_ffn", device_type="cuda") is ops.expert_ffn_gmm
    with smoke.patched(gmm, "grouped_matmul", ref.grouped_matmul):
        want, aux_plain = moe.moe_ffn(x, p, n_experts=E, top_k=2, capacity_factor=1.25)
    assert gmm.launches == before + 3
    err = smoke.gmm_error(out, want)
    assert smoke.gmm_ok(err, "bfloat16", smoke.FFN_LIMITS), err
    again, _ = moe.moe_ffn(x, p, n_experts=E, top_k=2, capacity_factor=1.25)
    assert torch.equal(out, again)                            # a fixed combine order
    assert float(aux["moe_dropped"]) == float(aux_plain["moe_dropped"])


# name -> (text in csrc/grouped_matmul.cu, its faulty replacement, the case
# of GMM_CASES that reaches the fault)
GMM_FAULTS = {
    "last_k_tile_skipped": ("const int n_ktiles = (p.K + kBK - 1) / kBK;",
                            "const int n_ktiles = (p.K + kBK - 1) / kBK - 1;",
                            "mixtral_prefill_w13"),
    "group_reads_group0_weights": (
        "static_cast<const __nv_bfloat16*>(p.w) + g * p.w_sg;",
        "static_cast<const __nv_bfloat16*>(p.w) + 0 * p.w_sg;", "mixtral_decode_w2"),
    "row_mask_off_by_one": ("const bool row_ok = gm < p.M;", "const bool row_ok = gm < p.M - 1;",
                            "mixtral_decode_w13"),
}


@pytest.fixture(scope="module")
def faulty_gmm_libs(tmp_path_factory):
    return _compile_faults(tmp_path_factory, "grouped_matmul", GMM_FAULTS)


@pytest.mark.parametrize("fault", sorted(GMM_FAULTS))
def test_planted_gmm_fault_fails_the_limits(gen, faulty_gmm_libs, monkeypatch, fault):
    case = next(c for c in smoke.GMM_CASES if c[0] == GMM_FAULTS[fault][2])
    x, w, want = _gmm_case(gen, case)
    good = gmm.grouped_matmul(x, w)
    monkeypatch.setattr(gmm, "_fn", gmm.bind(faulty_gmm_libs[fault]))
    bad = gmm.grouped_matmul(x, w)
    torch.cuda.synchronize()
    eg, eb = smoke.gmm_error(good, want), smoke.gmm_error(bad, want)
    print(f"\n  {fault}: kernel {smoke.format_gmm(eg, case[5])}"
          f"\n  {' ' * len(fault)}  fault  {smoke.format_gmm(eb, case[5])}")
    assert smoke.gmm_ok(eg, case[5])
    assert not smoke.gmm_ok(eb, case[5])


# name -> (text in csrc/grouped_matmul.cu, its replacement): the block tiles
# the kernel did not take, timed against the kernel in turns (-s prints them)
GMM_TILE_VARIANTS = {
    "decode_without_16_row_tile": (
        "if (M <= 16) return launch_bf16<16, 128, 1, 8>(p, vec, st);", "", None),
    "prefill_128x256_tile": (
        "return launch_bf16<128, 128, 2, 4>(p, vec, st);",
        "return launch_bf16<128, 256, 2, 4>(p, vec, st);", None),
}


@pytest.fixture(scope="module")
def tile_variant_libs(tmp_path_factory):
    return _compile_faults(tmp_path_factory, "grouped_matmul", GMM_TILE_VARIANTS)


@pytest.mark.parametrize("variant,shapes", [
    ("decode_without_16_row_tile", [(8, 2, 4096, 14336), (8, 2, 14336, 4096),
                                    (8, 1, 4096, 14336)]),
    ("prefill_128x256_tile", [(8, 1280, 4096, 14336), (64, 240, 2048, 1408)])])
def test_gmm_tile_choice(gen, tile_variant_libs, monkeypatch, variant, shapes):
    """The kernel's block tiles against the ones it did not take: the 16-row
    tile for M <= 16 is faster at decode than the 128-row tile alone, and a
    128x256 tile is not faster at prefill than 128x128."""
    kernel = gmm._kernel()
    other = gmm.bind(tile_variant_libs[variant])
    for G, M, K, N in shapes:
        x, w = smoke.gmm_inputs(torch, gen, G, M, K, N, "bfloat16", "dense")
        ms = {"kernel": [], variant: []}
        for fns in ((kernel, other), (other, kernel)):             # in turns
            for fn in fns:
                monkeypatch.setattr(gmm, "_fn", fn)
                ms["kernel" if fn is kernel else variant].append(
                    smoke.median_ms(lambda: gmm.grouped_matmul(x, w), reps=10))
        best = {k: min(v) for k, v in ms.items()}
        print(f"\n  ({G},{M},{K})@({G},{K},{N}) bf16: kernel {ms['kernel']} ms, "
              f"{variant} {ms[variant]} ms")
        if variant == "decode_without_16_row_tile":
            assert best["kernel"] < best[variant]
        else:
            assert best["kernel"] <= 1.05 * best[variant]
