"""Plain-torch oracles for the port's kernels (kernel-layout signatures).

Counterpart of ``repro/kernels/ref.py``: ``attention``, ``grouped_matmul``
(``ref.py:33-37``) and its backward, ``collective_reduce`` (``ref.py:73-74``) and plain ring
oracles; the wire codec's plain versions (``repro/kernels/quant.py:59-128``,
the software fp8 codec included); and the attention forward's row logsumexp
and its backward, which the reference gets from autodiff and the port's
backward kernel computes; and the SSD chunked scan (``ref.py:40-70``),
with the final state the model needs beside its output.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30
INT8_TOP = 127.0             # symmetric int8 top code
E4M3_MAX = 448.0             # e4m3fn max finite (exp 15, mantissa 6)


def _valid(Sq, Sk, kind, window, k_len, device):
    q_pos = torch.arange(Sq, device=device)[:, None]
    k_pos = torch.arange(Sk, device=device)[None, :]
    valid = torch.ones((Sq, Sk), dtype=torch.bool, device=device)
    if kind == "causal":
        valid &= q_pos >= k_pos
    if window:
        valid &= (q_pos - k_pos) < window
    if k_len is not None:
        valid &= k_pos < k_len
    return valid


def _scores(q, k, kind, window, k_len, scale):
    """Masked f32 scores (B, Hkv, g, Sq, Sk), q scaled before the product."""
    B, Hq, Sq, d = q.shape
    _, Hkv, Sk, _ = k.shape
    qf = q.float().reshape(B, Hkv, Hq // Hkv, Sq, d) * scale
    s = torch.einsum("bhgqd,bhkd->bhgqk", qf, k.float())
    return torch.where(_valid(Sq, Sk, kind, window, k_len, q.device), s, NEG_INF)


def attention(q, k, v, *, kind="causal", window=0, k_len=None, scale=None):
    """q (B,Hq,S,d), k/v (B,Hkv,Sk,d) -> (B,Hq,S,d).  Dense softmax oracle."""
    B, Hq, Sq, d = q.shape
    scale = scale if scale is not None else d ** -0.5
    p = torch.softmax(_scores(q, k, kind, window, k_len, scale), dim=-1)
    o = torch.einsum("bhgqk,bhkd->bhgqd", p, v.float())
    return o.reshape(B, Hq, Sq, d).to(q.dtype)


def attention_lse(q, k, *, kind="causal", window=0, k_len=None, scale=None):
    """The f32 row logsumexp (B, Hq, Sq) of the masked, scaled scores: what
    the flash forward writes for its backward."""
    B, Hq, Sq, d = q.shape
    scale = scale if scale is not None else d ** -0.5
    s = _scores(q, k, kind, window, k_len, scale)
    return torch.logsumexp(s, dim=-1).reshape(B, Hq, Sq)


def attention_bwd(q, k, v, o, do, lse, *, kind="causal", window=0, k_len=None,
                  scale=None):
    """Dense attention backward in f32, kernel layout.

    q, o, do (B, Hq, Sq, d); k, v (B, Hkv, Sk, d); lse (B, Hq, Sq) from the
    forward.  P is recomputed as exp(s - lse); with D = rowsum(dO * O),
    dS = P * (dO V^T - D), dQ = scale dS K, dK = scale dS^T Q and
    dV = P^T dO, dK and dV summed over the query heads of their kv head.
    Returns (dq, dk, dv) in f32.
    """
    B, Hq, Sq, d = q.shape
    _, Hkv, Sk, _ = k.shape
    g = Hq // Hkv
    scale = scale if scale is not None else d ** -0.5
    s = _scores(q, k, kind, window, k_len, scale)
    p = torch.exp(s - lse.float().reshape(B, Hkv, g, Sq, 1))
    dof = do.float().reshape(B, Hkv, g, Sq, d)
    delta = (dof * o.float().reshape(B, Hkv, g, Sq, d)).sum(-1, keepdim=True)
    dv = torch.einsum("bhgqk,bhgqd->bhkd", p, dof)
    ds = p * (torch.einsum("bhgqd,bhkd->bhgqk", dof, v.float()) - delta)
    dq = torch.einsum("bhgqk,bhkd->bhgqd", ds, k.float()) * scale
    dk = torch.einsum("bhgqk,bhgqd->bhkd", ds,
                      q.float().reshape(B, Hkv, g, Sq, d)) * scale
    return dq.reshape(B, Hq, Sq, d), dk, dv


def _acc_dtype(x):
    """f32, or f64 for f64 inputs (so that ``gradcheck`` can run)."""
    return torch.float64 if x.dtype == torch.float64 else torch.float32


def grouped_matmul(x, w):
    """x (G,M,K) @ w (G,K,N) -> (G,M,N), f32 accumulation, in x.dtype."""
    ct = _acc_dtype(x)
    return torch.einsum("gmk,gkn->gmn", x.to(ct), w.to(ct)).to(x.dtype)


def grouped_matmul_bwd(x, w, dy):
    """(dx, dw) of ``grouped_matmul(x, w)`` for the output gradient dy
    (G,M,N): dx = dy wᵀ (G,M,K) and dw = xᵀ dy (G,K,N), f32 einsums rounded
    to x.dtype: the VJP of the reference's einsum (``ref.py:33-37``)."""
    ct = _acc_dtype(x)
    dyc = dy.to(ct)
    dx = torch.einsum("gmn,gkn->gmk", dyc, w.to(ct))
    dw = torch.einsum("gmk,gmn->gkn", x.to(ct), dyc)
    return dx.to(x.dtype), dw.to(x.dtype)


def ssd_scan_states(x, dt, a_cum, B_in, C_in, init_state=None):
    """Kernel-layout SSD scan with its state.  x (B,H,nc,Q,P), dt/a_cum
    (B,H,nc,Q) (a_cum the within-chunk cumsum of dt*A), B_in/C_in
    (B,H,nc,Q,N), init_state (B,H,N,P) or None (zeros) -> (y (B,H,nc,Q,P)
    f32, final state (B,H,N,P) f32).  The exponent is masked before the exp
    (for i < j it is positive and may overflow)."""
    Bb, H, nc, Q, P = x.shape
    N = B_in.shape[-1]
    a = a_cum.float()
    causal = torch.ones((Q, Q), dtype=torch.bool, device=x.device).tril()
    xdt = x.float() * dt.float()[..., None]
    s = (torch.zeros((Bb, H, N, P), dtype=torch.float32, device=x.device)
         if init_state is None else init_state.float())
    ys = []
    for c in range(nc):
        ac = a[:, :, c]                                       # (B,H,Q)
        Bc, Cc, xc = B_in[:, :, c].float(), C_in[:, :, c].float(), xdt[:, :, c]
        diff = torch.where(causal, ac[..., :, None] - ac[..., None, :], 0.0)
        L = torch.where(causal, torch.exp(diff), 0.0)
        scores = torch.einsum("bhin,bhjn->bhij", Cc, Bc)
        y = torch.einsum("bhij,bhjp->bhip", scores * L, xc)
        y = y + torch.einsum("bhin,bhnp->bhip", Cc, s) * torch.exp(ac)[..., None]
        decay_end = torch.exp(ac[..., -1:] - ac)              # (B,H,Q)
        s_new = torch.einsum("bhjn,bhjp->bhnp", Bc * decay_end[..., None], xc)
        s = torch.exp(ac[..., -1])[..., None, None] * s + s_new
        ys.append(y)
    return torch.stack(ys, dim=2), s


def ssd_scan(x, dt, a_cum, B_in, C_in):
    """Kernel-layout SSD oracle (the reference's signature) -> y
    (B,H,nc,Q,P) in x.dtype."""
    return ssd_scan_states(x, dt, a_cum, B_in, C_in)[0].to(x.dtype)


def collective_reduce(acc, incoming):
    """acc + incoming, summed in f32, in acc's dtype (the wire's decompression
    fused into the ring step's accumulate)."""
    return (acc.float() + incoming.float()).to(acc.dtype)


def ring_reduce_scatter(xs):
    """Per-rank inputs (n*c, ...) of one ring -> rank r's reduced chunk r,
    summed in float64 in rank order: the oracle the rings are held to."""
    n = len(xs)
    total = sum(x.double() for x in xs)
    return list(total.chunk(n, 0))


def ring_all_gather(xs):
    """Per-rank chunks (c, ...) -> every rank holds their rank-major
    concatenation."""
    cat = torch.cat(list(xs), 0)
    return [cat for _ in xs]


# ---------------------------------------------------------------------------
# Wire codec (DESIGN.md §17): (nchunks, chunk) f32 <-> codes + scales
# ---------------------------------------------------------------------------

def encode_e4m3(y):
    """f32 -> uint8 e4m3 bit codes (round half to even, saturating at 448,
    never the NaN code 0x7f): the reference's software codec in torch bit
    arithmetic, with no ``float8_e4m3fn`` cast (ROADMAP C3)."""
    y = y.float()
    sign = (y < 0).to(torch.uint8)
    a = torch.minimum(y.abs(), torch.tensor(E4M3_MAX, device=y.device))
    e = torch.clamp(torch.floor(torch.log2(torch.where(a > 0, a, 1.0))), -6.0, 8.0)
    step = torch.exp2(e - 3.0)
    q = torch.round(a / step)
    roll = q >= 16.0                      # mantissa overflow -> next exponent
    e = torch.where(roll, torch.clamp(e + 1.0, max=8.0), e)
    q = torch.where(roll, 8.0, q)
    q = torch.where(e >= 8.0, torch.clamp(q, max=14.0), q)   # 0x7f is NaN: cap 448
    q = torch.where(a > 0, q, 0.0)
    norm = q >= 8.0
    exp_field = torch.where(norm, e + 7.0, 0.0).to(torch.uint8)
    mant = torch.where(norm, q - 8.0, q).to(torch.uint8)
    return (sign << 7) | (exp_field << 3) | mant


def decode_e4m3(bits):
    """uint8 e4m3 bit codes -> f32 values."""
    bits = bits.to(torch.uint8)
    sign = torch.where((bits >> 7) > 0, -1.0, 1.0)
    exp_field = ((bits >> 3) & 0xF).float()
    mant = (bits & 0x7).float()
    norm = exp_field > 0
    q = torch.where(norm, mant + 8.0, mant)
    e = torch.where(norm, exp_field - 7.0, -6.0)
    return sign * q * torch.exp2(e - 3.0)


def _chunk_scale(x2, top: float):
    """Per-row absmax times the f32 reciprocal of ``top``, 1 where the absmax
    is not > 0 (a zero row, and a row holding a NaN, whose absmax is NaN as
    under ``jnp.max``).  The reciprocal product is the jitted reference's
    arithmetic: XLA rewrites ``absmax / top`` (a division by a constant) into
    ``absmax * (1 / top)``, and the ring runs the codec only under jit."""
    absmax = x2.abs().amax(dim=1, keepdim=True)
    inv = torch.tensor(1.0, dtype=torch.float32) / top      # rounded to f32
    return torch.where(absmax > 0, absmax * inv.to(absmax.device), 1.0)


def wire_quantize(x2, *, codec: str = "int8"):
    """x2 (nchunks, chunk) f32 -> (codes (nchunks, chunk), scales
    (nchunks, 1) f32).  int8: ``clip(round_half_even(x / scale), -127,
    127)``, a NaN code 0 (XLA's float-to-int8 convert of NaN); fp8: the
    e4m3 software codec of ``x / scale``."""
    x2 = x2.float()
    if codec == "int8":
        scale = _chunk_scale(x2, INT8_TOP)
        q = torch.clamp(torch.round(x2 / scale), -INT8_TOP, INT8_TOP)
        return torch.where(torch.isnan(q), 0.0, q).to(torch.int8), scale
    if codec == "fp8":
        scale = _chunk_scale(x2, E4M3_MAX)
        return encode_e4m3(x2 / scale), scale
    raise ValueError(f"unknown wire_quant codec {codec!r}")


def wire_dequant_accum(acc2, codes2, scales, *, codec: str = "int8"):
    """acc2 (nchunks, chunk) f32 + decode(codes2) * scales -> f32; the
    product and the sum each rounded on their own."""
    if codec == "int8":
        vals = codes2.float()
    elif codec == "fp8":
        vals = decode_e4m3(codes2)
    else:
        raise ValueError(f"unknown wire_quant codec {codec!r}")
    return acc2.float() + vals * scales.float()
