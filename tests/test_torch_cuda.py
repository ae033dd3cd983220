"""The port's CUDA flash-attention kernel against its plain version, on the card.

Every test here needs an NVIDIA card: each is marked ``cuda`` and skips where
``torch.cuda.is_available()`` is false.  The kernel is held to the limits of
``chip_smoke.py`` (``ATTN_LIMITS``), and planted faults in copies of the
kernel source must fail them.  The file imports nothing of JAX, so it also
runs where JAX is not installed:

    PYTHONPATH=src python -m pytest -q -s --noconftest tests/test_torch_cuda.py
"""
import ctypes
import importlib.util
import subprocess
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

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


@pytest.fixture(scope="module")
def faulty_libs(tmp_path_factory):
    """Each planted fault compiled from a copy of the kernel source, one nvcc
    per copy, all started together."""
    if not torch.cuda.is_available():
        pytest.skip(NO_CARD)
    src = (_build.CSRC / "flash_attention.cu").read_text()
    out_dir = tmp_path_factory.mktemp("faulty_kernels")
    procs = {}
    for name, (good, bad, _) in FAULTS.items():
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
