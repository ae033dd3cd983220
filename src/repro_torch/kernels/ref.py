"""Plain-torch oracles for the port's kernels (kernel-layout signatures).

Counterpart of ``repro/kernels/ref.py``: ``attention``, ``collective_reduce``
(``ref.py:73-74``) and plain ring oracles.  The other oracles arrive with
their kernels.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def attention(q, k, v, *, kind="causal", window=0, k_len=None, scale=None):
    """q (B,Hq,S,d), k/v (B,Hkv,Sk,d) -> (B,Hq,S,d).  Dense softmax oracle."""
    B, Hq, Sq, d = q.shape
    _, Hkv, Sk, _ = k.shape
    g = Hq // Hkv
    scale = scale if scale is not None else d ** -0.5
    qf = q.float().reshape(B, Hkv, g, Sq, d) * scale
    s = torch.einsum("bhgqd,bhkd->bhgqk", qf, k.float())
    q_pos = torch.arange(Sq, device=q.device)[:, None]
    k_pos = torch.arange(Sk, device=q.device)[None, :]
    valid = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if kind == "causal":
        valid &= q_pos >= k_pos
    if window:
        valid &= (q_pos - k_pos) < window
    if k_len is not None:
        valid &= k_pos < k_len
    s = torch.where(valid, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqk,bhkd->bhgqd", p, v.float())
    return o.reshape(B, Hq, Sq, d).to(q.dtype)


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
