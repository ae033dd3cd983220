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

import jax  # noqa: E402
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


# ---------------------------------------------------------------------------
# Backward: the plain version the kernel is held to, and the autograd Function
# ---------------------------------------------------------------------------

BWD_CASES = [("causal", 0, None, 4, 2), ("bidir", 0, None, 4, 4), ("causal", 24, None, 6, 2),
             ("bidir", 0, 53, 4, 1), ("causal", 0, 61, 3, 3)]


@pytest.mark.parametrize("kind,window,k_len,Hq,Hkv", BWD_CASES)
def test_attention_bwd_plain_matches_jax_vjp(kind, window, k_len, Hq, Hkv):
    """``ref.attention_bwd`` (which the CUDA backward is held to on the card)
    against ``jax.vjp`` of the reference's dense attention, f32, rtol 1e-5
    (atol 1e-6 for the exact zeros of masked keys); the row logsumexp
    against ``jax.nn.logsumexp`` of the same masked scores."""
    from repro.kernels import ref as jax_ref
    from repro_torch.kernels import ref
    rng = np.random.RandomState(7)
    B, S, d = 2, 80, 32
    q, do = ((rng.randn(B, Hq, S, d) * 0.7).astype(np.float32) for _ in range(2))
    k, v = ((rng.randn(B, Hkv, S, d) * 0.7).astype(np.float32) for _ in range(2))
    kw = dict(kind=kind, window=window, k_len=k_len)
    o, vjp = jax.vjp(lambda a, b, c: jax_ref.attention(a, b, c, **kw), q, k, v)
    want = vjp(jnp.asarray(do))
    qt, kt, vt, dot = (torch.from_numpy(a) for a in (q, k, v, do))
    lse = ref.attention_lse(qt, kt, **kw)
    got = ref.attention_bwd(qt, kt, vt, torch.from_numpy(np.array(o)), dot, lse, **kw)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-6)
    s = jnp.einsum("bhgqd,bhkd->bhgqk", jnp.asarray(q).reshape(B, Hkv, Hq // Hkv, S, d)
                   * d ** -0.5, jnp.asarray(k))
    qp, kp = np.arange(S)[:, None], np.arange(S)[None, :]
    valid = np.ones((S, S), bool) if kind == "bidir" else qp >= kp
    if window:
        valid &= qp - kp < window
    if k_len is not None:
        valid &= kp < k_len
    want_lse = jax.nn.logsumexp(jnp.where(valid, s, -1e30), axis=-1).reshape(B, Hq, S)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse), rtol=1e-6, atol=1e-6)


def _cluster_dkdv(q, k, v, o, do, lse, kind, window, k_len, tile=64, skip_rank=None):
    """The bf16 backward's dK/dV decomposition in plain torch (f32): per kv
    head, cluster rank r of ``fa.bwd_cluster(group)`` runs over its heads in
    ascending order and, per head, over 64-row query tiles, adding each
    tile's P^T dO and dS^T Q to one running sum; the cluster then sums its
    ranks in ascending order (and scales dK once).  ``skip_rank``: leave
    that rank's partial out of the sum."""
    from repro_torch.kernels import ref
    B, Hq, Sq, d = q.shape
    Hkv = k.shape[1]
    group = Hq // Hkv
    cs, m = fa.bwd_cluster(group)
    scale = d ** -0.5
    s = ref._scores(q, k, kind, window, k_len, scale)       # (B, Hkv, g, Sq, Sk), masked
    p = torch.exp(s - lse.reshape(B, Hkv, group, Sq, 1))
    dof = do.reshape(B, Hkv, group, Sq, d)
    delta = (dof * o.reshape(B, Hkv, group, Sq, d)).sum(-1, keepdim=True)
    ds = p * (torch.einsum("bhgqd,bhkd->bhgqk", dof, v) - delta)
    qg = q.reshape(B, Hkv, group, Sq, d)
    ranks_dk, ranks_dv = [], []
    for r in range(cs):
        dk = torch.zeros_like(k)
        dv = torch.zeros_like(v)
        for h in range(r * m, (r + 1) * m):
            for q0 in range(0, Sq, tile):
                rows = slice(q0, q0 + tile)
                dv = dv + torch.einsum("bhqk,bhqd->bhkd", p[:, :, h, rows], dof[:, :, h, rows])
                dk = dk + torch.einsum("bhqk,bhqd->bhkd", ds[:, :, h, rows], qg[:, :, h, rows])
        ranks_dk.append(dk)
        ranks_dv.append(dv)
    dk, dv = torch.zeros_like(k), torch.zeros_like(v)
    for r, (a, b) in enumerate(zip(ranks_dk, ranks_dv)):
        if r != skip_rank:
            dk, dv = dk + a, dv + b
    return dk * scale, dv


@pytest.mark.parametrize("Hq,Hkv", [(4, 4), (4, 2), (6, 2), (8, 2), (16, 1)])
@pytest.mark.parametrize("kind,window,k_len", [("causal", 0, None), ("causal", 24, None),
                                               ("bidir", 0, 61)])
def test_backward_cluster_partials_match_jax_vjp(kind, window, k_len, Hq, Hkv):
    """The bf16 backward's per-head dK/dV partials, summed in the kernel's
    order (``bwd_cluster``: heads ascending within a rank, ranks ascending
    within the cluster), against ``jax.vjp`` of the reference's dense
    attention, f32, groups 1, 2, 3, 4 and 16 (a group larger than the
    cluster of 8): rtol 1e-5 and atol 1e-6 of the tensor's largest
    magnitude (sums over 150 query rows taken tile by tile, in another order
    than the reference's).  Leaving one rank's partial out misses it by far."""
    from repro.kernels import ref as jax_ref
    from repro_torch.kernels import ref
    rng = np.random.RandomState(11)
    B, S, d = 2, 150, 32
    q, do = ((rng.randn(B, Hq, S, d) * 0.7).astype(np.float32) for _ in range(2))
    k, v = ((rng.randn(B, Hkv, S, d) * 0.7).astype(np.float32) for _ in range(2))
    kw = dict(kind=kind, window=window, k_len=k_len)
    o, vjp = jax.vjp(lambda a, b, c: jax_ref.attention(a, b, c, **kw), q, k, v)
    _, want_dk, want_dv = vjp(jnp.asarray(do))
    qt, kt, vt, dot = (torch.from_numpy(a) for a in (q, k, v, do))
    lse = ref.attention_lse(qt, kt, **kw)
    dk, dv = _cluster_dkdv(qt, kt, vt, torch.from_numpy(np.array(o)), dot, lse, **kw)
    for got, want in ((dk, want_dk), (dv, want_dv)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6 * np.abs(want).max())
    cs, m = fa.bwd_cluster(Hq // Hkv)
    assert cs * m == Hq // Hkv and cs <= fa.MAX_CLUSTER
    if Hq // Hkv == 16:
        assert (cs, m) == (8, 2)
    if cs > 1:                     # one rank's heads left out of the cluster sum
        _, short = _cluster_dkdv(qt, kt, vt, torch.from_numpy(np.array(o)), dot, lse, **kw,
                                 skip_rank=0)
        assert not np.allclose(short.numpy(), np.asarray(want_dv), rtol=1e-2, atol=1e-2)


@pytest.mark.parametrize("kind,window,k_len,Hq,Hkv", BWD_CASES[:3])
def test_flash_attention_function_on_cpu_matches_autograd(kind, window, k_len, Hq, Hkv):
    """``FlashAttention.apply`` on CPU tensors (both directions plain)
    against torch autograd of ``ref.attention``; no kernel is counted."""
    from repro_torch.kernels import ref
    g = torch.Generator().manual_seed(3)
    q = torch.randn(2, Hq, 48, 32, generator=g, requires_grad=True)
    k = torch.randn(2, Hkv, 48, 32, generator=g, requires_grad=True)
    v = torch.randn(2, Hkv, 48, 32, generator=g, requires_grad=True)
    do = torch.randn(2, Hq, 48, 32, generator=g)
    before = (fa.launches, fa.bwd_launches)
    o = fa.FlashAttention.apply(q, k, v, kind, window, k_len, None)
    got = torch.autograd.grad(o, (q, k, v), do)
    o2 = ref.attention(q, k, v, kind=kind, window=window, k_len=k_len)
    want = torch.autograd.grad(o2, (q, k, v), do)
    torch.testing.assert_close(o, o2, rtol=1e-6, atol=1e-6)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
    assert (fa.launches, fa.bwd_launches) == before


def test_ops_attention_records_through_the_function_only_under_grad():
    """The model-layout entry takes FlashAttention when autograd records and
    the forward alone otherwise (on CPU tensors both are plain)."""
    g = torch.Generator().manual_seed(4)
    q = torch.randn(1, 40, 4, 32, generator=g, requires_grad=True)
    k = torch.randn(1, 40, 2, 32, generator=g, requires_grad=True)
    v = torch.randn(1, 40, 2, 32, generator=g, requires_grad=True)
    out = ops.flash_attention(q, k, v, kind="causal")
    fn = out.grad_fn.next_functions[0][0]              # under the final transpose
    assert "FlashAttention" in type(fn).__name__
    with torch.no_grad():
        assert ops.flash_attention(q, k, v, kind="causal").grad_fn is None
    want = attn_mod.dense_reference(q, k, v, kind="causal")
    torch.testing.assert_close(out, want, rtol=1e-5, atol=1e-5)
    dq, = torch.autograd.grad(out.sum(), (q,))
    dq2, = torch.autograd.grad(want.sum(), (q,))
    torch.testing.assert_close(dq, dq2, rtol=1e-4, atol=1e-5)


# ---------------------------------------------------------------------------
# Head dim 100 (llama-3b): the plain versions against JAX, and the kernels'
# padding in plain torch
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind,window,k_len", [("causal", 0, None), ("bidir", 0, None),
                                               ("causal", 64, None), ("bidir", 0, 77)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_fwd_matches_jax_at_d100(kind, window, k_len, dtype):
    """``flash_attention_fwd`` at d 100 (its plain version on the CPU)
    against the Pallas kernel in interpret mode, which takes the head dim
    whole; the tolerances of the d 64 cases."""
    rng = np.random.RandomState(5)
    B, Hq, Hkv, S, d = 1, 4, 2, 256, 100
    q = (rng.randn(B, Hq, S, d) * 0.5).astype(np.float32)
    k = (rng.randn(B, Hkv, S, d) * 0.5).astype(np.float32)
    v = (rng.randn(B, Hkv, S, d) * 0.5).astype(np.float32)
    (qj, qt), (kj, kt), (vj, vt) = (_both(a, dtype) for a in (q, k, v))
    want = jax_fwd(qj, kj, vj, kind=kind, window=window, k_len=k_len,
                   bq=128, bk=128, interpret=True)
    got = fa.flash_attention_fwd(qt, kt, vt, kind=kind, window=window, k_len=k_len)
    assert got.dtype == qt.dtype and tuple(got.shape) == q.shape
    _close(got, want, DTYPES[dtype][2])


@pytest.mark.parametrize("kind,window,k_len,Hq,Hkv", BWD_CASES[:3])
def test_attention_bwd_plain_matches_jax_vjp_at_d100(kind, window, k_len, Hq, Hkv):
    """``ref.attention_bwd`` at d 100 against ``jax.vjp`` of the reference's
    dense attention, f32, with the tolerances of the d 32 cases."""
    from repro.kernels import ref as jax_ref
    from repro_torch.kernels import ref
    rng = np.random.RandomState(8)
    B, S, d = 1, 72, 100
    q, do = ((rng.randn(B, Hq, S, d) * 0.7).astype(np.float32) for _ in range(2))
    k, v = ((rng.randn(B, Hkv, S, d) * 0.7).astype(np.float32) for _ in range(2))
    kw = dict(kind=kind, window=window, k_len=k_len)
    o, vjp = jax.vjp(lambda a, b, c: jax_ref.attention(a, b, c, **kw), q, k, v)
    want = vjp(jnp.asarray(do))
    qt, kt, vt, dot = (torch.from_numpy(a) for a in (q, k, v, do))
    lse = ref.attention_lse(qt, kt, **kw)
    got = ref.attention_bwd(qt, kt, vt, torch.from_numpy(np.array(o)), dot, lse, **kw)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-6)


def test_zero_padding_d100_changes_nothing():
    """The d-100 routes' design in plain torch, f32: q, k, v (and dO) padded
    with zero columns to the width the kernels compute over (128 in the
    forward, 112 in the backward), at d 100's own scale, give the d-100
    output, row logsumexp and gradients in their first 100 columns, and
    zeros in the padding columns of dQ, dK and dV, which the kernels
    therefore need not store: within 1e-6."""
    from repro_torch.kernels import ref
    g = torch.Generator().manual_seed(6)
    B, Hq, Hkv, S, d = 2, 4, 2, 90, 100
    q, do = (torch.randn(B, Hq, S, d, generator=g) for _ in range(2))
    k, v = (torch.randn(B, Hkv, S, d, generator=g) for _ in range(2))
    kw = dict(kind="causal", window=0, k_len=None, scale=d ** -0.5)

    def pad(t, width):
        return torch.nn.functional.pad(t, (0, width - d))

    o = ref.attention(q, k, v, **kw)
    lse = ref.attention_lse(q, k, **kw)
    o128 = ref.attention(pad(q, 128), pad(k, 128), pad(v, 128), **kw)
    torch.testing.assert_close(o128[..., :d], o, rtol=0, atol=1e-6)
    assert torch.equal(o128[..., d:], torch.zeros_like(o128[..., d:]))
    torch.testing.assert_close(ref.attention_lse(pad(q, 128), pad(k, 128), **kw), lse,
                               rtol=0, atol=1e-6)
    want = ref.attention_bwd(q, k, v, o, do, lse, **kw)
    got = ref.attention_bwd(*(pad(t, 112) for t in (q, k, v, o, do)), lse, **kw)
    for a, b in zip(got, want):
        torch.testing.assert_close(a[..., :d], b, rtol=0, atol=1e-6)
        assert torch.equal(a[..., d:], torch.zeros_like(a[..., d:]))


def test_tma_ready_pads_only_unaligned_views():
    """The wrappers' layout step: a bf16 view in model layout at d 100
    (heads 200 bytes apart) is copied into rows padded to 104 elements, the
    same values; views the kernels take (d 64, d 112, f32, a padded view)
    come back as they are, and so does one whose last dim is not dense (for
    ``_check`` to refuse)."""
    x = torch.randn(2, 40, 3, 100).bfloat16().transpose(1, 2)
    y = fa.tma_ready(x)
    assert y.shape == x.shape and torch.equal(y, x)
    assert y.stride() == (3 * 40 * 104, 40 * 104, 104, 1) and y.data_ptr() % 16 == 0
    assert fa.tma_ready(y) is y
    for t in (torch.randn(2, 40, 3, 64).bfloat16().transpose(1, 2),
              torch.randn(2, 40, 3, 112).bfloat16().transpose(1, 2),
              torch.randn(2, 40, 3, 100).transpose(1, 2),
              torch.randn(2, 3, 40, 200).bfloat16()[..., ::2]):
        assert fa.tma_ready(t) is t
    assert 100 in fa.HEAD_DIMS and 100 in fa.BWD_HEAD_DIMS
