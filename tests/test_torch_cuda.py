"""The port's CUDA kernels against their plain versions, on the card.

Every test here needs an NVIDIA card: each is marked ``cuda`` and skips where
``torch.cuda.is_available()`` is false.  The flash-attention kernel is held to
the limits of ``chip_smoke.py`` (``ATTN_LIMITS``), the grouped matmul to
``GMM_LIMITS``, the SSD scan to ``SSD_LIMITS`` and its backward to
``SSD_BWD_LIMITS``; the collective kernels (``collective_reduce``, the fused ring
reduce-scatter and all-gather) and the int8 codec's kernels (the chunk-512
fast path and the generic one) bit for bit.  Planted faults in copies of the kernel sources must fail those checks,
and a ring fault that stalls the protocol must raise within seconds.  The
file imports nothing of JAX, so it also runs where JAX is not installed:

    PYTHONPATH=src python -m pytest -q -s --noconftest tests/test_torch_cuda.py
"""
import contextlib
import ctypes
import importlib.util
import subprocess
import time
import types
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import hetccl, mesh  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import collective_reduce as cr  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import grouped_matmul as gmm  # noqa: E402
from repro_torch.kernels import ops, ref, ring_dma  # noqa: E402
from repro_torch.kernels import ssd_scan as ssd  # noqa: E402

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


@pytest.mark.parametrize("case", smoke.KERNEL_CASES, ids=[c[0] for c in smoke.KERNEL_CASES])
def test_smoke_kernel_cases_match_plain(gen, case):
    """chip_smoke's flash cases (the main path's shapes, d 112 with a k_len
    cut and Sq 333, Sq 40, ...) within ``ATTN_LIMITS``, the logsumexp too."""
    name, B, Hq, Hkv, Sq, Sk, d, kind, window, k_len, dt, model_layout = case
    q, k, v = smoke.attention_inputs(gen, B, Hq, Hkv, Sq, Sk, d, getattr(torch, dt),
                                     model_layout)
    kl = Sk if k_len is None else k_len
    got, lse = fa.flash_attention_fwd(q, k, v, kind=kind, window=window, k_len=kl,
                                      return_lse=True)
    _assert_within_limits(got, fa.flash_attention_plain(q, k, v, kind=kind, window=window,
                                                        k_len=kl))
    want_lse = ref.attention_lse(q, k, kind=kind, window=window, k_len=kl)
    torch.testing.assert_close(lse, want_lse, rtol=0, atol=1e-4)


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
    "corr_rescale_skipped": ("corr[i] = fast_exp2(m_r[i] - m_new);", "corr[i] = 1.f;",
                             (2, 9, 3, 512, 64, "causal", 0)),
    "partial_key_tile_dropped": ("t1 = (kend + bk - 1) / bk;", "t1 = kend / bk;",
                                 (2, 9, 3, 300, 64, "causal", 0)),
    "window_one_key_wide": ("ok = ok && (r - c) < p.window;",
                            "ok = ok && (r - c) <= p.window;",
                            (2, 9, 3, 512, 64, "causal", 64)),
    # the consumers read the next slot of the k/v ring: a tile not yet
    # loaded or a stale one
    "kv_ring_stage_flipped": ("const uint32_t k_tile = ring + s * T::kStageBytes;",
                              "const uint32_t k_tile = ring + (s + 1) % ST * T::kStageBytes;",
                              (2, 9, 3, 512, 64, "causal", 0)),
    # TMA fills what lies past the tensor with NaN, not zeros: at S 256 only
    # the padding of d 112 to 128 lies past it, so Q K^T meets NaN columns
    "d112_zero_fill_dropped": ("CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE",
                               "CU_TENSOR_MAP_FLOAT_OOB_FILL_NAN_REQUEST_ZERO_FMA",
                               (2, 8, 2, 256, 112, "causal", 0)),
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


# (incoming dtype, length, incoming's offset in elements): lengths that split
# the vectors' tiles (256 threads x 4 vectors of 4) and their unrolled loads
# unevenly, 4k + 1 and 16k + 3, fewer elements than a block's threads, and
# incoming misaligned by one element (the unaligned route)
REDUCE_EDGE_CASES = [(dt, n, off) for dt in ("float32", "bfloat16")
                     for n, off in ((4 * 1000 + 1, 0), (16 * 1000 + 3, 0), (100, 0),
                                    (4096 * 133 + 5, 0), (smoke.RING_C, 0), (16 * 1000 + 3, 1),
                                    (smoke.RING_C, 1))]


@pytest.mark.parametrize("inc_dtype,length,offset", REDUCE_EDGE_CASES)
def test_collective_reduce_edges_match_plain_bitwise(gen, inc_dtype, length, offset):
    acc = torch.randn(length, generator=gen, device="cuda")
    buf = torch.randn(length + offset, generator=gen, device="cuda").to(getattr(torch, inc_dtype))
    inc = buf[offset:]
    before = cr.launches
    got = cr.collective_reduce(acc, inc)
    assert cr.launches == before + 1
    assert smoke.bitwise_error([got], [cr.collective_reduce_plain(acc, inc)])[0]


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
    # the reduce-scatter's reader never credits its upstream, which waits for
    # the credit before it overwrites a parity (from n = 5 on): must raise
    "credit_never_signalled": (
        "if (s >= 1 && s + 1 <= n - 3) cta_signal(cap_flag(g, up, par ^ 1, k), tag(g, s - 1));",
        "", ("rs", 5, 1, 1, 1, "float32", "float32")),
    # the all-gather copies out the slot of the other parity
    "wrong_parity_slot_read": (
        "copy_piece(to, slot_me + nxt * g.pitch, cut(lo, hi, j, S), cut(lo, hi, j + 1, S));",
        "copy_piece(to, slot_me + par * g.pitch, cut(lo, hi, j, S), cut(lo, hi, j + 1, S));",
        ("ag", 3, 1, 1, 2, "float32", None)),
    # the reduce-scatter pulls the upstream's partial of the other parity
    "pull_reads_other_parity": (
        "reduce_piece<Wire>(dst, acc_up + (par ^ 1) * g.pitch, x + recv, p0, p1);",
        "reduce_piece<Wire>(dst, acc_up + par * g.pitch, x + recv, p0, p1);",
        ("rs", 4, 1, 1, 2, "float32", "float32")),
    "bf16_rounding_skipped": (
        "return __float2bfloat16_rn(v);",
        "return __ushort_as_bfloat16((unsigned short)(__float_as_uint(v) >> 16));",
        ("rs", 4, 1, -1, 1, "float32", "bfloat16")),
    # the reduce-scatter's scalar tail reads the elements after its own: most
    # pieces of c 100003 end inside a unit of eight, so their tails come out
    # shifted
    "rs_tail_reads_one_over": (
        "for (long long e = v0 + nv * V + threadIdx.x; e < b; e += blockDim.x)\n"
        "    dst[e] = add_hop<Wire>(to_float(x[e]), to_float(__ldcg(up + e)));",
        "for (long long e = v0 + nv * V + threadIdx.x; e < b; e += blockDim.x)\n"
        "    dst[e] = add_hop<Wire>(to_float(x[e + 1]), to_float(__ldcg(up + e + 1)));",
        ("rs", 2, 2, 1, 1, "float32", "float32")),
    # the all-gather's scalar tail reads the element after its own
    "ag_tail_reads_one_over": (
        "for (long long e = v0 + nv * V + threadIdx.x; e < b; e += blockDim.x) {\n"
        "    const T v = __ldcg(src + e);",
        "for (long long e = v0 + nv * V + threadIdx.x; e < b; e += blockDim.x) {\n"
        "    const T v = __ldcg(src + e + 1);",
        ("ag", 2, 2, 1, 1, "float32", None)),
    # a rank reads its own slots one 16-byte vector per slot off the pitch its
    # upstream writes them at (ranks past 0 read shifted data)
    "ag_slot_pitch_off_by_one_vector": (
        "const T* slot_me = static_cast<const T*>(g.slots) + (long long)r * 2 * g.pitch;",
        "const T* slot_me = static_cast<const T*>(g.slots) + (long long)r * 2 * (g.pitch - 16 / "
        "sizeof(T));",
        ("ag", 3, 1, -1, 2, "bfloat16", None)),
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


# chip_smoke's codec cases, the hop, and (55296, 512): smollm-135m's
# embedding, which error feedback encodes and decodes whole
@pytest.mark.parametrize("name,rows,fill", smoke.QUANT_ROWS + [("bucket_hop", 6912, "randn"),
                                                               ("largest_leaf", 55296, "randn")],
                         ids=[c[0] for c in smoke.QUANT_ROWS] + ["bucket_hop", "largest_leaf"])
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


def _codec_inputs(gen, rows, chunk, fill, offset):
    """(rows, chunk) f32 codec input and accumulator, ``offset`` elements
    into their buffers (1 breaks the 16-byte alignment of every row), filled
    as ``chip_smoke.quant_inputs`` fills its (., 512) rows."""
    n = rows * chunk + offset
    x = smoke.quant_inputs(torch, gen, -(-n // 512), fill).reshape(-1)
    acc = torch.randn(x.numel(), generator=gen, device="cuda")
    return (x[offset:n].reshape(rows, chunk), acc[offset:n].reshape(rows, chunk))


@pytest.mark.parametrize("offset", [0, 1], ids=["aligned", "offset1"])
@pytest.mark.parametrize("fill", ["randn", "zeros", "half", "nan"])
@pytest.mark.parametrize("rows", [1, 2, 34, 6913])
@pytest.mark.parametrize("chunk", [512, 100, 260])
def test_codec_paths_match_plain_bitwise(gen, chunk, rows, fill, offset):
    """Both codec kernels, on the chunk-512 fast path (aligned) and the
    generic one (other widths, or rows offset by one element), bit for bit
    against their plain versions: short rows (a 2-row and a 34-row norm
    leaf), a row count that is not a multiple of the block's 8, and the
    fills of chip_smoke's codec cases ("randn": chunks scaled from 1e-3 to
    1e3)."""
    x, acc = _codec_inputs(gen, rows, chunk, fill, offset)
    before = (quant.quant_launches, quant.dq_launches)
    c, s = quant.wire_quantize_int8(x)
    d = quant.wire_dequant_accum_int8(acc, c, s)
    torch.cuda.synchronize()
    assert (quant.quant_launches, quant.dq_launches) == (before[0] + 1, before[1] + 1)
    c2, s2 = ref.wire_quantize(x)
    assert smoke.same_bits(c, c2) and smoke.same_bits(s, s2)
    assert smoke.same_bits(d, ref.wire_dequant_accum(acc, c, s))


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


_BWD_CASE = {c[0]: c for c in smoke.BWD_CASES}
# name -> (source, text in it, its faulty replacement, the case that reaches it)
TRAIN_FAULTS = {
    "roundf_for_rintf": ("quant", "rintf(", "roundf(", ("half_way", 600, "half")),
    "fma_in_dq_accum": ("quant", "return __fadd_rn(acc, __fmul_rn(static_cast<float>(c), s));",
                        "return acc + static_cast<float>(c) * s;", ("wide_range", 5000, "randn")),
    # the absmax's shuffle reduction drops a lane's NaN (fmaxf takes the
    # number): a chunk with a NaN gets a finite scale instead of 1
    "nan_lost_in_shuffle": ("quant", "m = nan_max(m, __shfl_xor_sync(0xffffffffu, m, off));",
                            "m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));",
                            ("nan_chunk", 300, "nan")),
    # the fast decode reads its neighbour row's scale
    "dq_scale_of_another_row": ("quant", "const float s = scales[row];",
                                "const float s = scales[row ^ 1];",
                                ("wide_range", 5000, "randn")),
    # each cluster rank of the dK/dV pass takes one head fewer: at group 16
    # (clusters of 8, two heads a rank) every second head is left out
    "gqa_head_skipped_in_dkdv": (
        "flash_attention_bwd", "const int n_heads = group / cs;",
        "const int n_heads = group / cs - 1;", _BWD_CASE["gqa16_cluster8"]),
    # the cluster sum starts at rank 1: one head's dK/dV partial left out
    "head_partial_left_out_of_cluster_sum": (
        "flash_attention_bwd", "for (int rr = 0; rr < cs; ++rr) {",
        "for (int rr = 1; rr < cs; ++rr) {", smoke.BWD_CASES[0]),
    # the bf16 route's causal limit of a row's keys dropped
    "causal_mask_dropped_in_bwd": ("flash_attention_bwd", "if (p.causal) hi = min(hi, r + 1);",
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
    counters = smoke.Counters(fa, quant, ring_dma, cr, gmm, ssd)
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


def test_zero3_steps_on_the_card_match_zero1(gen):
    """Reduced llama-1b, f32 parameters, pallas rings, on a CUDA ThreadMesh
    (pod=2, data=2): 2 ZeRO-3 steps against 2 ZeRO-1 steps from the same
    init, losses within the reference's 5e-3 (tests/test_train.py), and the
    fsdp adjoint launches the fused reduce-scatter once per gathered (leaf,
    layer) per micro-step (its gathers run again in the backward, under
    remat, on autograd's thread)."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import RunConfig
    from repro_torch.core import balance, collectives
    from repro_torch.data.pipeline import synthetic_batch
    from repro_torch.models import build
    from repro_torch.train.trainer import make_train_program
    cfg = get_config("llama-1b").reduced()
    model = build(cfg)
    m = mesh.ThreadMesh({"pod": 2, "data": 2}, device="cuda")
    plan = balance.uniform_plan(2, 4, micro_batch=1)
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    batch = synthetic_batch(0, 0, plan.n_micro_max, plan.micro_batch * 4, 64, cfg.vocab)
    losses = {}
    for zero in (3, 1):
        prog = make_train_program(model, m, RunConfig(
            zero_stage=zero, collective_mode="hier", backend="pallas", learning_rate=1e-3,
            param_dtype="float32"), plan)
        state = prog.init_fn(params)
        with smoke.adjoint_rs_counter(collectives, ring_dma) as adjoint:
            losses[zero] = []
            for _ in range(2):
                state, met = prog.step_fn(state, batch)
                losses[zero].append(met["loss"].item())
        want = (9 * cfg.n_layers + 3) * plan.n_micro_max * 2 if zero == 3 else 0
        assert adjoint[0] == want, (zero, adjoint[0], want)
    assert losses[3][0] == pytest.approx(losses[1][0], abs=1e-5)
    assert max(abs(a - b) for a, b in zip(losses[3], losses[1])) <= 5e-3, losses


# Reduced moonshot (f32) one step under each stage on the card: the step-0
# loss within MOE_ZERO_LOSS_RTOL, the gradient norm within
# MOE_ZERO_GRAD_NORM_RTOL and every leaf's parameters after the step within
# MOE_ZERO_LEAF_REL_L2 (CPU readings: equal losses, norms 0-8.7e-8 apart,
# leaves 9.2e-9 at worst; a shard's offset shifted in the adjoint moves w1
# and w3 by 2.2e-3 and the norm by 1.1e-7: only the per-leaf check sees it).
MOE_ZERO_LOSS_RTOL, MOE_ZERO_GRAD_NORM_RTOL, MOE_ZERO_LEAF_REL_L2 = 1e-6, 1e-5, 1e-6


def _moe_zero_stages_on_the_card(plant=None):
    """(losses, gradient norms, per-leaf relative L2 after the step, the
    fsdp adjoint's fused reduce-scatter launches and the gathers a
    micro-step) of one ZeRO-3 and one ZeRO-1 step of reduced moonshot from
    one init on a CUDA ThreadMesh (pod=2, data=2), hier, pallas, remat;
    ``plant`` patches ZeRO-3's run."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import RunConfig
    from repro_torch.convert import unshard_params
    from repro_torch.core import balance, collectives
    from repro_torch.core.tree import leaves
    from repro_torch.data.pipeline import synthetic_batch
    from repro_torch.models import build
    from repro_torch.models.common import fsdp_dims, make_rules, meta_leaves
    from repro_torch.train.trainer import make_train_program
    cfg = get_config("moonshot-v1-16b-a3b").reduced()
    model = build(cfg)
    m = mesh.ThreadMesh({"pod": 2, "data": 2}, device="cuda")
    plan = balance.uniform_plan(2, 4, micro_batch=1)
    params = model.init(torch.Generator(device="cuda").manual_seed(0), dtype=torch.float32)
    batch = synthetic_batch(0, 0, plan.n_micro_max, plan.micro_batch * 4, 64, cfg.vocab)
    metas = model.abstract_params()
    gathers = sum(cfg.n_layers if mt.axes[0] == "layers" else 1
                  for d, mt in zip(fsdp_dims(metas, make_rules(3, 2)), meta_leaves(metas))
                  if d is not None)
    out = {}
    for zero in (3, 1):
        prog = make_train_program(model, m, RunConfig(
            zero_stage=zero, collective_mode="hier", backend="pallas", learning_rate=1e-3,
            param_dtype="float32"), plan)
        state = prog.init_fn(params)
        with pytest.MonkeyPatch.context() as mp:
            if plant is not None and zero == 3:
                plant(mp)
            with smoke.adjoint_rs_counter(collectives, ring_dma) as adjoint:
                state, met = prog.step_fn(state, batch)
        full = (unshard_params([state[0]["params"], state[1]["params"]], metas)
                if zero == 3 else state[0]["params"])
        out[zero] = (met["loss"].item(), met["grad_norm"].item(), leaves(full), adjoint[0])
    rel = [((a - b).norm() / b.norm()).item() for a, b in zip(out[3][2], out[1][2])]
    return ((out[3][0], out[1][0]), (out[3][1], out[1][1]), rel, (out[3][3], out[1][3]),
            gathers * plan.n_micro_max)


def test_moe_zero3_on_the_card_matches_zero1_at_step_0(gen):
    """Reduced moonshot on the card: ZeRO-3's step 0 against ZeRO-1's within
    the limits above, the expert leaves among those the fsdp adjoint
    reduce-scatters (one fused launch per gathered leaf and layer a
    micro-step, none under ZeRO-1)."""
    (l3, l1), (g3, g1), rel, (a3, a1), want = _moe_zero_stages_on_the_card()
    print(f"\n  loss {l3} / {l1}, grad norm {g3} / {g1}, worst leaf {max(rel):.3e}, "
          f"adjoint launches {a3} / {a1}")
    assert abs(l3 - l1) <= MOE_ZERO_LOSS_RTOL * abs(l1)
    assert abs(g3 - g1) <= MOE_ZERO_GRAD_NORM_RTOL * g1
    assert max(rel) <= MOE_ZERO_LEAF_REL_L2, rel
    assert (a3, a1) == (want, 0)


def test_moe_zero3_planted_adjoint_fault_fails_on_the_card(gen):
    """One shard's offset shifted in the adjoint's reduce-scatter of w1 and
    w3 (an expert stack gathered on dim 1): the check above fails on those
    two leaves."""
    def plant(mp):
        from repro_torch.core import collectives
        real = collectives.fsdp_reduce_scatter

        def shifted(g, axis, dim=0, comm=None):
            if g.dim() == 3 and dim == 1 and mesh.axis_index("data") == 0:
                g = torch.roll(g, g.shape[dim] // 4, dims=dim)
            return real(g, axis, dim, comm)

        mp.setattr(collectives, "fsdp_reduce_scatter", shifted)

    _, _, rel, _, _ = _moe_zero_stages_on_the_card(plant)
    bad = [i for i, r in enumerate(rel) if r > MOE_ZERO_LEAF_REL_L2]
    print(f"\n  planted fault: leaves {bad} out of the limit, worst {max(rel):.3e}")
    assert bad == [7, 9]      # blocks.moe.w1, blocks.moe.w3 in flatten order


def test_flash_d100_through_ops_in_model_layout(gen):
    """llama-3b's prefill path: ``ops.flash_attention`` on (B, S, H, 100)
    bf16 tensors (heads 200 bytes apart) copies q, k, v into padded rows and
    launches the d-100 route once; the output is a view of padded rows and
    agrees with the plain version within ATTN_LIMITS."""
    q, k, v = (torch.randn(2, 300, 8, 100, generator=gen, device="cuda").bfloat16()
               for _ in range(3))
    fa.reset_counts()
    got = ops.flash_attention(q, k, v, kind="causal")
    torch.cuda.synchronize()
    assert fa.launches == 1 and fa.d_launches == {100: 1}
    assert got.shape == q.shape and got.transpose(1, 2).stride()[2] == 104
    want = fa.flash_attention_plain(q.transpose(1, 2), k.transpose(1, 2),
                                    v.transpose(1, 2)).transpose(1, 2)
    _assert_within_limits(got, want)


def test_flash_function_at_d100_matches_plain_autograd(gen):
    """FlashAttention through ops.flash_attention at d 100 in bf16, GQA 8/2
    (both kernels, the copies into padded rows included) against autograd of
    the plain attention on the same bf16 inputs, in f32: within BWD_LIMITS
    (bf16)."""
    q = torch.randn(1, 200, 8, 100, generator=gen, device="cuda").bfloat16().requires_grad_()
    k = torch.randn(1, 200, 2, 100, generator=gen, device="cuda").bfloat16().requires_grad_()
    v = torch.randn(1, 200, 2, 100, generator=gen, device="cuda").bfloat16().requires_grad_()
    do = torch.randn(1, 200, 8, 100, generator=gen, device="cuda").bfloat16()
    before = (fa.launches, fa.bwd_launches)
    got = torch.autograd.grad(ops.flash_attention(q, k, v, kind="causal"), (q, k, v), do)
    assert (fa.launches, fa.bwd_launches) == (before[0] + 1, before[1] + 1)
    qf, kf, vf = (t.detach().float().requires_grad_() for t in (q, k, v))
    plain = fa.flash_attention_plain(qf.transpose(1, 2), kf.transpose(1, 2),
                                     vf.transpose(1, 2)).transpose(1, 2)
    want = torch.autograd.grad(plain, (qf, kf, vf), do.float())
    ok, errs = _bwd_within_limits(got, want, "bfloat16")
    assert ok, errs


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


def test_gmm_raises_where_autograd_needs_its_backward(gen, monkeypatch):
    """Where autograd needs the backward, grouped_matmul goes through the
    Function: the forward kernel, then the backward kernel for what autograd
    asks (here dx alone), within GMM_LIMITS of the plain backward; a backward
    launch that fails raises, and nothing falls back to the plain version."""
    x = torch.randn(2, 40, 64, generator=gen, device="cuda").bfloat16().requires_grad_()
    w = torch.randn(2, 64, 32, generator=gen, device="cuda").bfloat16()
    dy = torch.randn(2, 40, 32, generator=gen, device="cuda").bfloat16()
    before = (gmm.launches, dict(gmm.bwd_route_launches))
    (dx,) = torch.autograd.grad(gmm.grouped_matmul(x, w), x, dy)
    torch.cuda.synchronize()
    assert gmm.launches == before[0] + 1
    assert gmm.bwd_route_launches == {**before[1], "dx_wgmma": before[1]["dx_wgmma"] + 1}
    err = smoke.gmm_error(dx, ref.grouped_matmul_bwd(x.detach(), w, dy)[0])
    assert smoke.gmm_ok(err, "bfloat16"), smoke.format_gmm(err, "bfloat16")
    gmm._kernel()
    monkeypatch.setattr(gmm, "_strided_fn", lambda *a: 1)      # a refused launch
    bwd_before = gmm.bwd_launches
    with pytest.raises(RuntimeError, match="backward launch failed"):
        torch.autograd.grad(gmm.grouped_matmul(x, w), x, dy)
    assert gmm.bwd_launches == bwd_before
    with torch.no_grad():
        assert gmm.grouped_matmul(x, w).shape == (2, 40, 32)


@pytest.mark.parametrize("case", smoke.GMM_BWD_CASES, ids=[c[0] for c in smoke.GMM_BWD_CASES])
def test_gmm_bwd_matches_plain(gen, case):
    """chip_smoke's backward cases: dx and dw each within GMM_LIMITS of the
    plain backward, on the route ``bwd_route`` names, the same bits on a
    second launch (no atomics)."""
    name, G, M, K, N, dt, layout = case
    x, w, dy = smoke.gmm_bwd_inputs(torch, gen, G, M, K, N, dt, layout)
    before = dict(gmm.bwd_route_launches)
    got = gmm.grouped_matmul_bwd(x, w, dy)
    torch.cuda.synchronize()
    routes = [gmm.bwd_route(x, w, dy, which) for which in ("dx", "dw")]
    assert {r: n - before[r] for r, n in gmm.bwd_route_launches.items() if n != before[r]} \
        == dict.fromkeys(routes, 1)
    for g, want in zip(got, ref.grouped_matmul_bwd(x, w, dy)):
        assert g.dtype == x.dtype and g.shape == want.shape and g.is_contiguous()
        err = smoke.gmm_error(g, want)
        assert smoke.gmm_ok(err, dt), smoke.format_gmm(err, dt)
    again = gmm.grouped_matmul_bwd(x, w, dy)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


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
# of GMM_CASES that reaches the fault): the wgmma route at Mixtral's prefill
# shapes and edges, the mma.sync routes at decode and an unaligned view
GMM_FAULTS = {
    "wgmma_last_k_stage_skipped": ("n_k((p.K + bk - 1) / bk),",
                                   "n_k((p.K + bk - 1) / bk - 1),", "mixtral_prefill_w13"),
    "wgmma_weight_map_group_pinned_0": (
        "tma_load(box, &tm_w, full_bar + 8 * s, n0 + j * kBox, k0, g);",
        "tma_load(box, &tm_w, full_bar + 8 * s, n0 + j * kBox, k0, 0);", "mixtral_prefill_w2"),
    # the consumers read the w boxes of the next ring stage: a k step not yet
    # loaded or a stale one
    "wgmma_consumer_reads_next_stage": (
        "const uint32_t b = ring + s * kWStageBytes + kABytes;",
        "const uint32_t b = ring + (s + 1) % kWStages * kWStageBytes + kABytes;", "wgmma_edges"),
    "last_k_tile_skipped": ("const int n_ktiles = (p.K + kBK - 1) / kBK;",
                            "const int n_ktiles = (p.K + kBK - 1) / kBK - 1;", "odd_view"),
    "group_reads_group0_weights": (
        "tma_load_hint(st + j * kSWBytes, &tm_w, full_bar + 8 * s, n0 + j * kBox, k0, g,",
        "tma_load_hint(st + j * kSWBytes, &tm_w, full_bar + 8 * s, n0 + j * kBox, k0, 0,",
        "mixtral_decode_w2"),
    # the x map one row short: the last row of x reads as zeros
    "row_mask_off_by_one": ("encode_map(&tm_x, p.x, p.K, p.M, p.G, p.x_sm, p.x_sg, 8 * mt);",
                            "encode_map(&tm_x, p.x, p.K, p.M - 1, p.G, p.x_sm, p.x_sg, 8 * mt);",
                            "mixtral_decode_w13"),
    # the decode route's split-K: the first block's part of a split tile
    # left out of the sum
    "split_k_part_dropped": ("for (int b = b_first; b <= b_last; ++b) {",
                             "for (int b = b_first + 1; b <= b_last; ++b) {",
                             "mixtral_decode_w13"),
    # the consumers' wait one stage short: each unit is read before the wait
    # for its copies (the ring's protocol is kept, so nothing hangs)
    "stream_ring_wait_one_stage_short": (
        "mbar_wait(full_bar + 8 * s, (it / kSStages) & 1);\n      mma_unit(s);",
        "mma_unit(s);\n      mbar_wait(full_bar + 8 * s, (it / kSStages) & 1);",
        "mixtral_decode_w2"),
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
    print(f"\n  {fault} ({gmm.route(x, w)} route): kernel {smoke.format_gmm(eg, case[5])}"
          f"\n  {' ' * len(fault)}  fault  {smoke.format_gmm(eb, case[5])}")
    assert smoke.gmm_ok(eg, case[5])
    assert not smoke.gmm_ok(eb, case[5])


# name -> (text in csrc/grouped_matmul.cu, its faulty replacement, the case
# of GMM_BWD_CASES that reaches it): the backward's operand layouts and its
# stages of 80
GMM_BWD_FAULTS = {
    # dw's xᵀ (MN-major A): both consumer warpgroups read the first 64 rows
    # (moonshot's dw takes stages of 80)
    "dw_a_second_box_at_m0": (
        "tma_load(a + j * kBK * kRowBytes, &tm_x, full_bar + 8 * s, m0 + j * kBox, k0, g);",
        "tma_load(a + j * kBK * kRowBytes, &tm_x, full_bar + 8 * s, m0, k0, g);",
        "moonshot_w13_c480"),
    # dx's wᵀ (K-major B): every 64-row box of the tile's n rows the first
    "dx_b_boxes_at_n0": (
        "tma_load(box, &tm_w, full_bar + 8 * s, k0, n0 + j * kBox, g);",
        "tma_load(box, &tm_w, full_bar + 8 * s, k0, n0, g);", "ragged_m333"),
    # a stage of 80 takes the 4 k steps of a stage of 64: 16 of every 80
    # capacity rows left out of dw
    "dw_stage80_k_steps_cut": ("for (int kk = 0; kk < kBK / 16; ++kk)",
                               "for (int kk = 0; kk < kWBK / 16; ++kk)", "capacity_470"),
    # the strided route reads x as if it were dense in k
    "simt_x_stride_taken_as_1": ("(k0 + c) * p.x_sk]", "(k0 + c)]", "odd_view"),
}


@pytest.fixture(scope="module")
def faulty_gmm_bwd_libs(tmp_path_factory):
    return _compile_faults(tmp_path_factory, "grouped_matmul", GMM_BWD_FAULTS)


@pytest.mark.parametrize("fault", sorted(GMM_BWD_FAULTS))
def test_planted_gmm_bwd_fault_fails_the_limits(gen, faulty_gmm_bwd_libs, monkeypatch, fault):
    case = next(c for c in smoke.GMM_BWD_CASES if c[0] == GMM_BWD_FAULTS[fault][2])
    x, w, dy = smoke.gmm_bwd_inputs(torch, gen, *case[1:])
    want = ref.grouped_matmul_bwd(x, w, dy)
    good = gmm.grouped_matmul_bwd(x, w, dy)
    lib = faulty_gmm_bwd_libs[fault]
    gmm.bind(lib)                                  # sets the argument types
    monkeypatch.setattr(gmm, "_strided_fn", lib.grouped_matmul_strided)
    bad = gmm.grouped_matmul_bwd(x, w, dy)
    torch.cuda.synchronize()
    ok_good = [smoke.gmm_ok(smoke.gmm_error(g, wt), case[5]) for g, wt in zip(good, want)]
    ok_bad = [smoke.gmm_ok(smoke.gmm_error(b, wt), case[5]) for b, wt in zip(bad, want)]
    print(f"\n  {fault}: kernel within limits (dx, dw) {ok_good}, fault {ok_bad}")
    assert all(ok_good) and not all(ok_bad)


@pytest.mark.parametrize("which,tile_k", [("dx", 80), ("dw", 96)])
def test_gmm_bwd_refused_schedule_raises(gen, monkeypatch, which, tile_k):
    """A stage depth the kernel refuses (80 for dx, 96 anywhere) raises: the
    launch is refused and nothing runs in its place."""
    x, w, dy = smoke.gmm_bwd_inputs(torch, gen, 2, 300, 256, 384, "bfloat16", "dense")
    monkeypatch.setattr(gmm, "bwd_schedule", lambda *a: types.SimpleNamespace(tile_k=tile_k))
    with pytest.raises(RuntimeError, match="backward launch failed"):
        gmm.grouped_matmul_bwd(x, w, dy, which == "dx", which == "dw")


# the decode route's cases: Mixtral's decode shapes (the weight stream), one
# and sixteen rows, a layer slice of stacked weights, and rows TMA cannot
# describe (the 16-row mma.sync tile): (G, M, K, N, layout)
DECODE_REPEATS = {"mixtral_w13": (8, 2, 4096, 14336, "dense"),
                  "mixtral_w2": (8, 2, 14336, 4096, "dense"),
                  "m1": (8, 1, 4096, 14336, "dense"),
                  "m16_ragged": (3, 16, 1000, 696, "dense"),
                  "layer_slice": (8, 2, 4096, 14336, "layer"),
                  "aligned_column_view": (8, 5, 512, 1000, "layer_view"),
                  "unaligned_view": (4, 9, 256, 500, "odd_view")}


def test_gmm_stream_geometry_matches_the_library(gen):
    """The wrapper plans the weight stream (scratch, grid) with the library's
    tile and unit shape, which the module's constants state."""
    _, _, geometry = gmm._kernel()
    assert geometry == (gmm.STREAM_BN, gmm.STREAM_BK, gmm.STREAM_THREADS)


@pytest.mark.parametrize("case", sorted(DECODE_REPEATS))
def test_gmm_decode_route_repeats_bit_for_bit(gen, case):
    """The decode route within GMM_LIMITS of the plain version, and three
    launches give the same bits (the split-K parts are summed in one order)."""
    G, M, K, N, layout = DECODE_REPEATS[case]
    x, w = smoke.gmm_inputs(torch, gen, G, M, K, N, "bfloat16", layout)
    assert gmm.route(x, w) == "mma16"
    want = ref.grouped_matmul(x, w)
    before = gmm.route_launches["mma16"]
    outs = [gmm.grouped_matmul(x, w) for _ in range(3)]
    torch.cuda.synchronize()
    assert gmm.route_launches["mma16"] == before + 3
    err = smoke.gmm_error(outs[0], want)
    assert smoke.gmm_ok(err, "bfloat16"), smoke.format_gmm(err, "bfloat16")
    assert all(torch.equal(outs[0], o) for o in outs[1:])


# each route against the one it was chosen over, timed in turns (-s prints
# the readings): the 16-row mma.sync tile at decode against the 128 x 128
# tile, and wgmma + TMA at prefill against the 128 x 128 mma.sync tile
ROUTE_CHOICES = {
    "decode_16_row_tile": ("mma16", "mma128", [(8, 2, 4096, 14336), (8, 2, 14336, 4096),
                                               (8, 1, 4096, 14336)]),
    "prefill_wgmma": ("wgmma", "mma128", [(8, 1280, 4096, 14336), (8, 1280, 14336, 4096),
                                          (64, 240, 2048, 1408)]),
}


@pytest.mark.parametrize("choice", sorted(ROUTE_CHOICES))
def test_gmm_tile_choice(gen, monkeypatch, choice):
    """The route the wrapper takes is faster than the one it was chosen over
    on the same inputs (both are the same function: each within
    ``GMM_LIMITS`` of the plain version)."""
    taken, other, shapes = ROUTE_CHOICES[choice]
    chosen = gmm.route
    for G, M, K, N in shapes:
        x, w = smoke.gmm_inputs(torch, gen, G, M, K, N, "bfloat16", "dense")
        assert chosen(x, w) == taken
        want = ref.grouped_matmul(x, w)
        ms = {taken: [], other: []}
        for order in ((taken, other), (other, taken)):               # in turns
            for r in order:
                monkeypatch.setattr(gmm, "route", lambda a, b, r=r: r)
                before = gmm.route_launches[r]
                assert smoke.gmm_ok(smoke.gmm_error(gmm.grouped_matmul(x, w), want), "bfloat16")
                assert gmm.route_launches[r] == before + 1
                ms[r].append(smoke.median_ms(lambda: gmm.grouped_matmul(x, w), reps=10))
        best = {k: min(v) for k, v in ms.items()}
        print(f"\n  ({G},{M},{K})@({G},{K},{N}) bf16: {taken} {ms[taken]} ms, "
              f"{other} {ms[other]} ms")
        assert best[taken] < best[other]


# ---------------------------------------------------------------------------
# SSM path: the SSD scan (SSD_LIMITS of chip_smoke.py) and flash at d 112
# ---------------------------------------------------------------------------

def _ssd_case(gen, name):
    case = next(c for c in smoke.SSD_CASES if c[0] == name)
    return smoke.ssd_inputs(torch, gen, *case[1:])


@pytest.mark.parametrize("name", [c[0] for c in smoke.SSD_CASES])
def test_ssd_matches_plain(gen, name):
    inp = _ssd_case(gen, name)
    route = ssd.route(inp["x"].dtype)
    before, before_route = ssd.launches, ssd.route_launches[route]
    got = smoke.ssd_run(ssd, ref, inp, plain=False)
    torch.cuda.synchronize()
    assert ssd.launches == before + 1 and ssd.route_launches[route] == before_route + 1
    assert route == ("mma" if inp["x"].dtype == torch.bfloat16 else "f32")
    want = smoke.ssd_run(ssd, ref, inp, plain=True)
    errs, ok, dt = smoke.ssd_errors(got, want)
    assert ok, {k: smoke.format_gmm(e, dt, smoke.SSD_LIMITS) for k, e in errs.items()}
    scale = next(c for c in smoke.SSD_CASES if c[0] == name)[9]
    if route == "mma" and dt == "float32" and scale >= 1.0:
        assert smoke.ssd_mma_ok(errs), errs
    again = smoke.ssd_run(ssd, ref, inp, plain=False)
    assert all(torch.equal(a, b) for a, b in zip(got, again) if a is not None)   # no atomics


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_ssd_layout_matches_the_library(dtype):
    """kernels/ssd_scan.py's smem_bytes against the shared memory a launch
    gives a block (the library's, -1 where the route refuses the shapes), and
    two blocks per SM at both models' shapes on the mma route."""
    if not torch.cuda.is_available():
        pytest.skip(NO_CARD)
    for P in ssd.HEAD_DIMS:
        for N in (8, 12, 16, 24, 64, 128, 136, 256):
            for Q in (32, 100, 256):
                want = ssd.smem_bytes(N, P, Q, dtype)
                takes = want <= ssd.MAX_SMEM and (
                    dtype == torch.float32 or (N % 8 == 0 and N <= 128))
                assert ssd.kernel_smem_bytes(N, P, Q, dtype) == (want if takes else -1), (N, P, Q)
    if dtype == torch.bfloat16:
        assert all(ssd.blocks_per_sm(N, 64, 256, dtype) >= 2 for N in (128, 64))


@pytest.mark.parametrize("bad", ["dtype", "mixed_dtype", "head_dim", "groups", "last_stride",
                                 "shared_memory", "ragged_chunk", "init_shape",
                                 "mma_state_size"])
def test_ssd_raises_on_what_it_does_not_take(gen, bad):
    B, S, H, P, G, N, Q = 2, 128, 4, 32, 2, 16, 64
    kw = dict(B=B, S=S, H=H, P=P, G=G, N=N)
    if bad == "head_dim":
        kw["P"] = 48
    elif bad == "groups":
        kw["G"] = 3
    elif bad == "shared_memory":
        kw.update(P=128, N=256)
    elif bad == "mma_state_size":             # the mma route takes N % 8 == 0
        kw["N"] = 12
    inp = smoke.ssd_inputs(torch, gen, kw["B"], kw["S"], kw["H"], kw["P"], kw["G"], kw["N"], Q,
                           "bfloat16", 1.0, bad == "init_shape", "model")
    x, Bm, Cm, init = inp["x"], inp["B"], inp["C"], inp["init"]
    if bad == "dtype":
        x, Bm, Cm = x.half(), Bm.half(), Cm.half()
    elif bad == "mixed_dtype":
        Bm = Bm.float()
    elif bad == "last_stride":
        x = torch.randn(B, S, H, 2 * P, generator=gen, device="cuda").bfloat16()[..., ::2]
    elif bad == "ragged_chunk":
        Q = 48
    elif bad == "init_shape":
        init = init[:, :, :-1]
    before = ssd.launches
    with pytest.raises(ValueError):
        ssd.ssd_scan_model(x, inp["dt"], inp["a"], Bm, Cm, Q, init)
    assert ssd.launches == before


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_ssd_unaligned_views_match_plain(gen, dtype):
    """x, B and C as column views of wider tensors whose rows lie an odd
    number of elements apart: rows not 16-byte aligned, so the mma route
    loads its tiles element by element (no cp.async); within SSD_LIMITS of
    the plain version, both routes."""
    B, S, H, P, G, N, Q = 2, 512, 8, 64, 2, 64, 256
    dt_ = getattr(torch, dtype)
    inp = smoke.ssd_inputs(torch, gen, B, S, H, P, G, N, Q, dtype, 1.0, True, "model")

    def odd_view(t):
        wide = torch.zeros(*t.shape[:-1], t.shape[-1] + 5, dtype=dt_, device="cuda")
        wide[..., 3:3 + t.shape[-1]] = t
        return wide[..., 3:3 + t.shape[-1]]

    views = {k: odd_view(inp[k]) for k in ("x", "B", "C")}
    assert views["B"].stride(1) * views["B"].element_size() % 16
    got = ssd.ssd_scan_model(views["x"], inp["dt"], inp["a"], views["B"], views["C"], Q,
                             inp["init"])
    want = ssd.ssd_scan_model_plain(inp["x"], inp["dt"], inp["a"], inp["B"], inp["C"], Q,
                                    inp["init"])
    errs, ok, dt = smoke.ssd_errors(got, want)
    assert ok, {k: smoke.format_gmm(e, dt, smoke.SSD_LIMITS) for k, e in errs.items()}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_function_trains_through_the_kernels(gen, dtype):
    """The TACC op "ssd_scan" on CUDA tensors that require grad, as
    ``models.ssm.ssd_scan`` calls it (a_cum the within-chunk cumsum of
    dt * A, here of a leaf dA, and y + D * x after): one forward launch that
    writes the chunk states and one backward call (three launches); the
    gradients of x, dt, dA, B, C, D and the initial state within
    SSD_BWD_LIMITS of the same Function with its plain backward, and in f32
    also of the op pinned to its plain variant (the reference's chunk loop
    under autograd; in bf16 that route rounds dB and dC to bf16 per head and
    sums the heads in bf16, 2.8e-3 from the f32 sums); under no_grad the
    serving launch alone.  dA stands for A: A's gradient sums dA's over
    every position, where f32 sums cancel (tests/test_torch_ssm_train.py
    holds A's own)."""
    from repro_torch.core import tacc
    from repro_torch.models import ssm  # noqa: F401  (registers the op's plain variant)
    B, S, H, P, G, N, Q = 2, 512, 8, 64, 2, 64, 256
    dt_ = getattr(torch, dtype)
    x = torch.randn(B, S, H, P, generator=gen, device="cuda").to(dt_)
    dt = torch.nn.functional.softplus(torch.randn(B, S, H, generator=gen, device="cuda"))
    dA = -dt * torch.exp(0.25 * torch.randn(H, generator=gen, device="cuda"))
    Bm, Cm = ((0.5 * torch.randn(B, S, G, N, generator=gen, device="cuda")).to(dt_)
              for _ in range(2))
    D = torch.randn(H, generator=gen, device="cuda")
    init = torch.randn(B, H, N, P, generator=gen, device="cuda")
    ins = (x, dt, dA, Bm, Cm, D, init)
    dy = torch.randn(B, S, H, P, generator=gen, device="cuda").to(dt_)

    def op(req):
        x, dt, dA, Bm, Cm, D, init = req
        a_cum = torch.cumsum(dA.reshape(B, S // Q, Q, H), dim=2).reshape(B, S, H)
        y, fin = tacc.dispatch("ssd_scan", x, dt, a_cum, Bm, Cm, Q, init)
        return (y + x.float() * D[:, None]).to(x.dtype), fin

    def plain_bwd(*a, needs):
        grads = ssd.ssd_scan_model_bwd_plain(*a[:9])
        return tuple(g if n else None for g, n in zip(grads, needs))

    def grads(route):
        req = [t.detach().clone().requires_grad_() for t in ins]
        with contextlib.ExitStack() as stack:
            if route == "chunk_loop":
                stack.enter_context(smoke.patched_variant(tacc, "ssd_scan", "cuda",
                                                          tacc.resolve("ssd_scan", "cpu")))
            elif route == "plain_bwd":
                stack.enter_context(smoke.patched(ssd, "ssd_scan_model_bwd", plain_bwd))
            y, fin = op(req)
            obj = (y.float() * dy.float()).sum() + fin.sum()
            return torch.autograd.grad(obj, req)

    def held(got, want):
        for name, g, w in zip(("x", "dt", "dA", "B", "C", "D", "init"), got, want):
            assert g.dtype == w.dtype, name
            err = smoke.gmm_error(g.reshape(-1, g.shape[-1]), w.reshape(-1, w.shape[-1]))
            assert smoke.gmm_ok(err, str(g.dtype).removeprefix("torch."),
                                smoke.SSD_BWD_LIMITS), (name, err)

    ssd.reset_counts()
    got = grads("kernel")
    torch.cuda.synchronize()
    assert ssd.launches == 1 and ssd.bwd_launches == 1
    assert all(n == 1 for n in ssd.bwd_stage_launches.values())
    held(got, grads("plain_bwd"))
    assert ssd.launches == 2 and ssd.bwd_launches == 1
    if dtype == "float32":
        held(got, grads("chunk_loop"))
        assert ssd.launches == 2 and ssd.bwd_launches == 1
    with torch.no_grad():
        op(ins)
    assert ssd.launches == 3 and ssd.bwd_launches == 1


@pytest.mark.parametrize("name", [c[0] for c in smoke.SSD_BWD_CASES])
def test_ssd_bwd_matches_plain(gen, name):
    """The backward kernels against the plain backward (chip_smoke [27]): each
    gradient within SSD_BWD_LIMITS, the bf16 cases of dt scale 1 or more
    within the mma route's own check (SSD_BWD_MMA_REL_L2), bit-equal on a
    second run, the counts (per stage and per route) moved by exactly the
    launches made."""
    case = next(c for c in smoke.SSD_BWD_CASES if c[0] == name)
    inp = smoke.ssd_bwd_inputs(torch, gen, *case[1:])
    route = ssd.route(inp["x"].dtype)
    before = smoke.ssd_bwd_counts(ssd)
    got = smoke.ssd_bwd_run(ssd, inp, plain=False)
    again = smoke.ssd_bwd_run(ssd, inp, plain=False)
    torch.cuda.synchronize()
    assert smoke.ssd_bwd_counted(ssd, before, route)
    assert all(torch.equal(a, b) for a, b in zip(got, again) if a is not None)
    want = smoke.ssd_bwd_run(ssd, inp, plain=True)
    errs, ok = smoke.ssd_bwd_errors(got, want)
    print(f"\n  {name} ({route}): {smoke.format_ssd_bwd(errs)}")
    assert ok, errs
    if route == "mma" and case[9] >= 1:
        assert smoke.ssd_bwd_mma_ok(errs), errs
    assert (got[5] is None) == (inp["init"] is None)


# bf16 shapes around what the mma route takes: (N, P, Q)
SSD_BWD_MMA_SHAPES = [(N, P, Q) for N in (8, 16, 24, 60, 64, 120, 128, 136, 192)
                      for P in (16, 32, 64, 128) for Q in (16, 32, 100, 128, 256, 257, 512)]


def test_ssd_bwd_wrapper_refuses_what_the_library_refuses(gen):
    """On bf16 inputs the wrapper raises, before any launch, on exactly the
    shapes whose launches the library refuses (``ssd_scan_bwd_route_smem_bytes``
    -1 for the state or the chunks launch, or the forward's -1), naming
    ROADMAP C7 where the forward takes them, and runs the others; the f32
    route at the same shapes likewise."""
    taken = refused = 0
    for dtype in (torch.bfloat16, torch.float32):
        for N, P, Q in SSD_BWD_MMA_SHAPES:
            fwd = ssd.kernel_smem_bytes(N, P, Q, dtype) >= 0
            takes = fwd and min(ssd.bwd_smem_bytes(st, N, P, Q, dtype)
                                for st in ("state", "chunks")) >= 0
            x = torch.zeros(1, Q, 2, P, dtype=dtype, device="cuda")
            dt = torch.ones(1, Q, 2, device="cuda")
            bc = torch.zeros(1, Q, 1, N, dtype=dtype, device="cuda")
            dy = torch.zeros(1, Q, 2, P, device="cuda")
            states = torch.zeros(1, 2, 1, N, P, device="cuda")
            before = smoke.ssd_bwd_counts(ssd)
            if takes:
                ssd.ssd_scan_model_bwd(x, dt, -dt, bc, bc, Q, dy, None, None, states)
                taken += 1
            else:
                with pytest.raises(ValueError, match="ROADMAP C7" if fwd else None):
                    ssd.ssd_scan_model_bwd(x, dt, -dt, bc, bc, Q, dy, None, None, states)
                assert smoke.ssd_bwd_counts(ssd)[1] == before[1]
                refused += 1
    torch.cuda.synchronize()
    print(f"\n  {taken} shapes taken, {refused} refused")
    assert taken and refused


@pytest.mark.parametrize("name", ["mamba2_f32", "bf16_init_state", "q100_three_chunks",
                                  "g2_h8_init_state", "p128_n64"])
def test_ssd_states_leave_the_serving_launch_unchanged(gen, name):
    """A forward launch that writes the chunk states gives y and the final
    state bit for bit as the serving launch (no state pointer); the state
    entering chunk c is the final state of a scan over the first c chunks
    (chunk 0's is the initial state, or zeros)."""
    inp = _ssd_case(gen, name)
    args = (inp["x"], inp["dt"], inp["a"], inp["B"], inp["C"], inp["Q"], inp["init"])
    y, fin = ssd.ssd_scan_model(*args)
    y2, fin2, states = ssd.ssd_scan_model_states(*args)
    torch.cuda.synchronize()
    assert torch.equal(y, y2) and torch.equal(fin, fin2)
    Q = inp["Q"]
    want0 = inp["init"] if inp["init"] is not None else torch.zeros_like(fin)
    assert torch.equal(states[:, :, 0], want0.float())
    for c in range(1, states.shape[2]):
        pre = ssd.ssd_scan_model(*(t[:, :c * Q] for t in args[:5]), Q, inp["init"])[1]
        assert torch.equal(states[:, :, c], pre), c


def test_ssd_scan_on_the_card_takes_the_kernel(gen):
    """models.ssm.ssd_scan on CUDA tensors reaches the kernel through the
    TACC op "ssd_scan": one launch, and (y, final state) within SSD_LIMITS of
    the op pinned to its plain variant (the reference's chunk loop)."""
    from repro_torch.core import tacc
    from repro_torch.models import ssm
    B, S, H, P, G, N = 2, 512, 8, 64, 2, 64
    x = torch.randn(B, S, H, P, generator=gen, device="cuda").bfloat16()
    dt = torch.nn.functional.softplus(torch.randn(B, S, H, generator=gen, device="cuda"))
    A = -torch.exp(0.25 * torch.randn(H, generator=gen, device="cuda"))
    Bm, Cm = ((0.5 * torch.randn(B, S, G, N, generator=gen, device="cuda")).bfloat16()
              for _ in range(2))
    D = torch.randn(H, generator=gen, device="cuda")
    init = torch.randn(B, H, N, P, generator=gen, device="cuda")
    assert tacc.resolve("ssd_scan", device_type="cuda") is ssd.ssd_scan_model
    before = ssd.launches
    got = ssm.ssd_scan(x, dt, A, Bm, Cm, D, 256, init_state=init)
    assert ssd.launches == before + 1
    with smoke.patched_variant(tacc, "ssd_scan", "cuda", tacc.resolve("ssd_scan", "cpu")):
        want = ssm.ssd_scan(x, dt, A, Bm, Cm, D, 256, init_state=init)
    assert ssd.launches == before + 1
    assert got[0].dtype == torch.bfloat16 and got[1].dtype == torch.float32
    errs = {"y": smoke.gmm_error(got[0], want[0]), "state": smoke.gmm_error(got[1], want[1])}
    assert smoke.gmm_ok(errs["y"], "bfloat16", smoke.SSD_LIMITS), errs
    assert smoke.gmm_ok(errs["state"], "float32", smoke.SSD_LIMITS), errs


@pytest.mark.parametrize("case", smoke.FLASH_D112_CASES, ids=[c[0] for c in smoke.FLASH_D112_CASES])
def test_flash_d112_matches_plain(gen, case):
    _, B, Hq, Hkv, Sq, Sk, d, kind, window, k_len, dt, model_layout = case
    q, k, v = smoke.attention_inputs(gen, B, Hq, Hkv, Sq, Sk, d, getattr(torch, dt),
                                     model_layout)
    before = fa.launches
    got = fa.flash_attention_fwd(q, k, v, kind=kind)
    assert fa.launches == before + 1
    _assert_within_limits(got, fa.flash_attention_plain(q, k, v, kind=kind))


# name -> (text in csrc/ssd_scan_bwd.cu, its faulty replacement, the case of
# SSD_BWD_CASES that reaches the fault).  The bf16 (mma) route first, then
# the f32 route, which kept its code.
SSD_BWD_FAULTS = {
    # the combine drops g of the chunk after: the state's gradient is not carried
    "state_gradient_not_carried": ("      v = keep * v + gp[(c - 1) * NPn];",
                                   "      v = 0.f * v + gp[(c - 1) * NPn];",
                                   "slow_decay_init_dfin_bf16"),
    "column_sums_dropped": ("(e < 2 ? cs_a : cs_b) += sT[nn][e] * mv;",
                            "(e < 2 ? cs_a : cs_b) += 0.f * sT[nn][e] * mv;",
                            "g2_h8_init_dfin_bf16"),
    "head_reads_group0": ("  const int group = h / (p.H / p.G);", "  const int group = 0;",
                          "g2_h8_init_dfin_bf16"),
    "diagonal_mask_off_by_one": ("return j <= i && i < Q;", "return j < i && i < Q;",
                                 "g2_h8_init_dfin_bf16"),
    # the cluster's sum of dB and dC leaves out its last head
    "head_sum_skips_a_head": ("      if (k < heads) v += r[k];",
                              "      if (k + 1 < heads) v += r[k];", "g2_h8_init_dfin_bf16"),
    # every f32 operand goes in as hi + mid only
    "lo_split_part_dropped": (
        "const __nv_bfloat162 lw = __floats2bfloat162_rn(r0 - mf.x, r1 - mf.y);",
        "const __nv_bfloat162 lw = __floats2bfloat162_rn(0.f, 0.f);", "g2_h8_init_dfin_bf16"),
    "f32_route_state_gradient_not_carried": ("      g[e] *= keep;", "      g[e] *= 0.f;",
                                             "slow_decay_init_dfin"),
    "f32_route_column_sums_dropped": ("        dac[j0 + tx] += cs;",
                                      "        dac[j0 + tx] += 0.f * cs;", "g2_h8_init_dfin"),
    "f32_route_head_reads_group0": ("  const int grp = h / (p.H / p.G);", "  const int grp = 0;",
                                    "g2_h8_init_dfin"),
    "f32_route_diagonal_mask_off_by_one": ("const bool ok = j <= i && i < Q;",
                                           "const bool ok = j < i && i < Q;", "g2_h8_init_dfin"),
    "f32_route_head_sum_skips_a_head": ("for (int h = g * hg; h < (g + 1) * hg; ++h)",
                                        "for (int h = g * hg; h < (g + 1) * hg - 1; ++h)",
                                        "g2_h8_init_dfin"),
}
# Faults whose error stays inside SSD_BWD_LIMITS and must fail the mma
# route's own check (SSD_BWD_MMA_REL_L2 of chip_smoke.py) instead: hi + mid
# keep 16 bits of every f32 operand, 2.3e-6 to 3.8e-6 in the CPU emulation
# (tests/test_torch_ssm_train.py) against the f32 limit of 2e-5.
SSD_BWD_FAULTS_UNDER_LIMITS = {"lo_split_part_dropped"}


@pytest.fixture(scope="module")
def faulty_ssd_bwd_libs(tmp_path_factory):
    return _compile_faults(tmp_path_factory, "ssd_scan_bwd", SSD_BWD_FAULTS)


@pytest.mark.parametrize("fault", sorted(SSD_BWD_FAULTS))
def test_planted_ssd_bwd_fault_fails_the_limits(gen, faulty_ssd_bwd_libs, monkeypatch, fault):
    case = next(c for c in smoke.SSD_BWD_CASES if c[0] == SSD_BWD_FAULTS[fault][2])
    inp = smoke.ssd_bwd_inputs(torch, gen, *case[1:])
    want = smoke.ssd_bwd_run(ssd, inp, plain=True)
    good = smoke.ssd_bwd_errors(smoke.ssd_bwd_run(ssd, inp, plain=False), want)
    monkeypatch.setattr(ssd, "_bwd_fn", ssd.bind_bwd(faulty_ssd_bwd_libs[fault]))
    bad = smoke.ssd_bwd_errors(smoke.ssd_bwd_run(ssd, inp, plain=False), want)
    torch.cuda.synchronize()
    print(f"\n  {fault} kernel: {smoke.format_ssd_bwd(good[0])}\n  {fault} fault : "
          f"{smoke.format_ssd_bwd(bad[0])}")
    assert good[1]
    if fault in SSD_BWD_FAULTS_UNDER_LIMITS:
        assert smoke.ssd_bwd_mma_ok(good[0]) and not smoke.ssd_bwd_mma_ok(bad[0])
    else:
        assert not bad[1]


@pytest.mark.parametrize("case", smoke.FLASH_D112_BWD_CASES,
                         ids=[c[0] for c in smoke.FLASH_D112_BWD_CASES])
def test_flash_backward_at_d112_matches_plain(gen, case):
    before = fa.bwd_launches
    worst, ok, _ = smoke.flash_bwd_case(torch, fa, ref, gen, case)
    assert fa.bwd_launches == before + 1
    assert ok, worst


# name -> (text in csrc/ssd_scan.cu, its faulty replacement, the case of
# SSD_CASES that reaches the fault).  The mma route (bf16 cases) first, then
# the f32 route, which kept its code.
SSD_FAULTS = {
    "state_not_carried": ("const float keep = expf(a_last);", "const float keep = 0.f;",
                          "slow_decay_bf16"),
    # the state update runs before the rows, which then read the new state
    "state_updated_before_rows_read_it": (
        "    mma_rows<P>(p, ch);\n    mma_state<P>(p, ch, a_last);",
        "    mma_state<P>(p, ch, a_last);\n    mma_rows<P>(p, ch);", "slow_decay_bf16"),
    "head_reads_group0": ("const int group = h / (p.H / p.G);", "const int group = 0;", "g2_h8"),
    # every f32 operand goes in as hi + mid only
    "lo_split_part_dropped": (
        "const __nv_bfloat162 l = __floats2bfloat162_rn(r0 - mf.x, r1 - mf.y);",
        "const __nv_bfloat162 l = __floats2bfloat162_rn(0.f, 0.f);", "mamba2_dt_to_20"),
    # the diagonal block's mask drops the diagonal (j == i)
    "diagonal_mask_off_by_one": ("const bool in_mask = j <= i && i < Q;",
                                 "const bool in_mask = j < i && i < Q;", "one_chunk"),
    # no wait for the tile of a step: its buffer may be read before the
    # copies land.  A race: where a step's work hides the copies' latency
    # the output comes out right, so the case is one whose phases are one
    # step each (chunks of 32), where every tile is read right after it is
    # issued
    "cp_async_wait_one_stage_short": ("cp_async_wait<0>();  // tile k has landed",
                                      "cp_async_wait<1>();  // tile k has landed", "q32_g16"),
    "f32_route_state_not_carried": ("s_next[e] = chunk_decay * s_cur[e];", "s_next[e] = 0.f;",
                                    "slow_decay"),
    "f32_route_state_updated_before_rows_read_it": ("const float* s_read = s_cur;",
                                                    "const float* s_read = s_next;",
                                                    "slow_decay"),
}
# Faults whose error stays inside SSD_LIMITS and must fail the mma route's
# own check (SSD_MMA_REL_L2 of chip_smoke.py) instead.  hi + mid keep 16 bits
# of every f32 operand: the error comes out near 2.5e-6 (the CPU emulation in
# tests/test_torch_ssm.py reads 2.5e-6 against 9e-8 for three parts), under
# the f32 limit of 2e-5, which was set for a route that rounds no operand.
SSD_FAULTS_UNDER_LIMITS = {"lo_split_part_dropped"}


@pytest.fixture(scope="module")
def faulty_ssd_libs(tmp_path_factory):
    return _compile_faults(tmp_path_factory, "ssd_scan", SSD_FAULTS)


@pytest.mark.parametrize("fault", sorted(SSD_FAULTS))
def test_planted_ssd_fault_fails_the_limits(gen, faulty_ssd_libs, monkeypatch, fault):
    inp = _ssd_case(gen, SSD_FAULTS[fault][2])
    want = smoke.ssd_run(ssd, ref, inp, plain=True)
    good = smoke.ssd_errors(smoke.ssd_run(ssd, ref, inp, plain=False), want)
    monkeypatch.setattr(ssd, "_fn", ssd.bind(faulty_ssd_libs[fault]))
    bad = smoke.ssd_errors(smoke.ssd_run(ssd, ref, inp, plain=False), want)
    torch.cuda.synchronize()
    for label, (errs, _, dt) in (("kernel", good), ("fault ", bad)):
        print(f"\n  {fault} {label}: " + "  ".join(
            f"{k} {smoke.format_gmm(e, dt, smoke.SSD_LIMITS)}" for k, e in errs.items()))
    assert good[1]
    if fault in SSD_FAULTS_UNDER_LIMITS:
        assert smoke.ssd_mma_ok(good[0]) and not smoke.ssd_mma_ok(bad[0])
    else:
        assert not bad[1]
