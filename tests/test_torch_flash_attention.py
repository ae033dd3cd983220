"""The port's flash attention against the JAX package's, on the same inputs.

Inputs come from a seeded numpy RandomState and go to both packages.  On the
CPU the port's ``flash_attention_fwd`` runs its plain version; the JAX side
runs the Pallas kernel body in interpret mode, as tests/test_kernels.py does.
The kernel itself is held against the plain version on the card by
tests/test_torch_cuda.py and chip_smoke.py.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jax_ops  # noqa: E402
from repro.kernels.flash_attention import flash_attention_fwd as jax_fwd  # noqa: E402
from repro.models import attention as jax_attn  # noqa: E402
from repro_torch.core import tacc  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import attention as attn_mod  # noqa: E402

DTYPES = {"float32": (jnp.float32, torch.float32, 3e-4),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 3e-2)}


def _both(a: np.ndarray, dtype: str):
    jd, td, _ = DTYPES[dtype]
    return jnp.asarray(a).astype(jd), torch.from_numpy(a).to(td)


def _close(got_torch, want_jax, atol):
    np.testing.assert_allclose(got_torch.float().numpy(),
                               np.asarray(want_jax, np.float32), atol=atol, rtol=0)


@pytest.mark.parametrize("kind,window,k_len", [("causal", 0, None), ("bidir", 0, None),
                                               ("causal", 64, None), ("bidir", 0, 77)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,Hq,Hkv,S,d", [(2, 4, 2, 256, 64), (1, 3, 1, 128, 32)])
def test_flash_attention_fwd_matches_jax(kind, window, k_len, dtype, B, Hq, Hkv, S, d):
    rng = np.random.RandomState(0)
    q = (rng.randn(B, Hq, S, d) * 0.5).astype(np.float32)
    k = (rng.randn(B, Hkv, S, d) * 0.5).astype(np.float32)
    v = (rng.randn(B, Hkv, S, d) * 0.5).astype(np.float32)
    (qj, qt), (kj, kt), (vj, vt) = (_both(a, dtype) for a in (q, k, v))
    want = jax_fwd(qj, kj, vj, kind=kind, window=window, k_len=k_len,
                   bq=128, bk=128, interpret=True)
    before = fa.launches
    got = fa.flash_attention_fwd(qt, kt, vt, kind=kind, window=window, k_len=k_len)
    assert fa.launches == before          # a CPU tensor never reaches the kernel
    assert got.dtype == qt.dtype and tuple(got.shape) == q.shape
    _close(got, want, DTYPES[dtype][2])


@pytest.mark.parametrize("Sq,Sk,q_offset,k_len", [(40, 40, 0, None),   # ragged: kernel route
                                                  (5, 5, 0, None),     # Sq < 8: chunked
                                                  (1, 40, 39, 40)])    # decode: chunked
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ops_flash_attention_matches_jax(Sq, Sk, q_offset, k_len, dtype):
    rng = np.random.RandomState(1)
    B, Hq, Hkv, d = 2, 4, 2, 32
    q = (rng.randn(B, Sq, Hq, d) * 0.5).astype(np.float32)
    k = (rng.randn(B, Sk, Hkv, d) * 0.5).astype(np.float32)
    v = (rng.randn(B, Sk, Hkv, d) * 0.5).astype(np.float32)
    (qj, qt), (kj, kt), (vj, vt) = (_both(a, dtype) for a in (q, k, v))
    want = jax_ops.flash_attention(qj, kj, vj, kind="causal", q_offset=q_offset,
                                   k_len=k_len, interpret=True)
    got = ops.flash_attention(qt, kt, vt, kind="causal", q_offset=q_offset,
                              k_len=k_len)
    assert tuple(got.shape) == q.shape
    _close(got, want, DTYPES[dtype][2])
    # the dense oracles of both packages, at the same offsets
    kw = dict(kind="causal", q_offset=q_offset, k_len=k_len)
    _close(attn_mod.dense_reference(qt, kt, vt, **kw),
           jax_attn.dense_reference(qj, kj, vj, **kw), DTYPES[dtype][2])


def test_tacc_resolves_from_the_tensor_device():
    assert tacc.resolve_variant("attention", device_type="cpu") == "cpu"
    assert tacc.resolve_variant("attention", device_type="cuda") == "cuda"
    assert tacc.resolve("attention", device_type="cpu") is attn_mod.chunked_attention
    assert tacc.resolve("attention", device_type="cuda") is ops.flash_attention
    assert tacc.resolve("attention", variant="cuda") is ops.flash_attention
    assert {"cpu", "cuda"} <= set(tacc.table()["attention"])
    assert tacc.get_platform() is None
    tacc.set_platform("cuda")
    try:
        assert tacc.resolve_variant("attention", device_type="cpu") == "cuda"
    finally:
        tacc.set_platform(None)
    with pytest.raises(tacc.TaccError):
        tacc.resolve("attention", variant="interpret")
