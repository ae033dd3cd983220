"""Attention: chunked online-softmax in plain torch, dispatch, KV cache.

Counterpart of ``repro/models/attention.py:24-158``.  ``chunked_attention``
is the ``cpu`` (default) TACC variant and the decode path; on a CUDA tensor
``attention`` dispatches to the flash kernel (``repro_torch.kernels.ops``).
The rolling window cache of sliding-window models (mixtral):
``window_cache_update`` and ``window_decode_attention``, plain torch on every
device, as in the reference.

Supports causal, bidirectional, sliding-window, GQA and decode against a KV
cache.  Softmax statistics accumulate in f32.
"""
from __future__ import annotations

import torch

import repro_torch.kernels  # noqa: F401  (registers the "cuda" attention variant)
from repro_torch.core import tacc

NEG_INF = -1e30


def _mask(q_pos, k_pos, kind: str, window: int):
    """(Sq, Sk) boolean validity mask from global positions."""
    if kind == "bidir":
        m = torch.ones((q_pos.shape[0], k_pos.shape[0]), dtype=torch.bool,
                       device=q_pos.device)
    else:
        m = q_pos[:, None] >= k_pos[None, :]
    if window:
        m &= (q_pos[:, None] - k_pos[None, :]) < window
    return m


@tacc.register("attention", "cpu", default=True)
def chunked_attention(q, k, v, *, kind: str = "causal", window: int = 0,
                      q_offset=0, k_offset=0, k_len=None, chunk: int = 512,
                      scale: float | None = None):
    """Online-softmax attention over KV chunks.

    q: (B, Sq, Hq, hd);  k, v: (B, Sk, Hkv, hd);  Hq % Hkv == 0.
    q_offset/k_offset: global positions of q[0] / k[0] (cache decode uses
    q_offset = cache_len).  k_len: valid KV prefix length.
    Returns (B, Sq, Hq, hd) in q.dtype.
    """
    B, Sq, Hq, hd = q.shape
    _, Sk, Hkv, _ = k.shape
    g = Hq // Hkv
    dev = q.device
    scale = scale if scale is not None else hd ** -0.5
    qf = (q.float() * scale).reshape(B, Sq, Hkv, g, hd)
    chunk = min(chunk, Sk)
    n_chunks = -(-Sk // chunk)
    q_pos = q_offset + torch.arange(Sq, device=dev)
    kv_valid_len = Sk if k_len is None else k_len

    m = torch.full((B, Hkv, g, Sq), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((B, Hkv, g, Sq), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, Hkv, g, Sq, hd), dtype=torch.float32, device=dev)
    for c in range(n_chunks):
        # the last chunk may be short: the reference pads it with zero keys,
        # which its k_len mask then removes; slicing drops them outright
        kb = k[:, c * chunk:(c + 1) * chunk]
        vb = v[:, c * chunk:(c + 1) * chunk]
        k_pos = k_offset + c * chunk + torch.arange(kb.shape[1], device=dev)
        s = torch.einsum("bqhgd,bkhd->bhgqk", qf, kb.float())
        valid = _mask(q_pos, k_pos, kind, window) \
            & (k_pos < k_offset + kv_valid_len)[None, :]
        s = torch.where(valid, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bhgqk,bkhd->bhgqd", p,
                                                   vb.float())
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]       # (B, Hkv, g, Sq, hd)
    out = out.permute(0, 3, 1, 2, 4).reshape(B, Sq, Hq, hd)
    return out.to(q.dtype)


def attention(q, k, v, **kw):
    """TACC-dispatched attention (cuda -> flash kernel, cpu -> chunked)."""
    return tacc.dispatch("attention", q, k, v, **kw)


def dense_reference(q, k, v, *, kind="causal", window=0, q_offset=0,
                    k_offset=0, k_len=None, scale=None):
    """O(S^2)-memory oracle for tests."""
    B, Sq, Hq, hd = q.shape
    _, Sk, Hkv, _ = k.shape
    g = Hq // Hkv
    dev = q.device
    scale = scale if scale is not None else hd ** -0.5
    qf = (q.float() * scale).reshape(B, Sq, Hkv, g, hd)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qf, k.float())
    q_pos = q_offset + torch.arange(Sq, device=dev)
    k_pos = k_offset + torch.arange(Sk, device=dev)
    valid = _mask(q_pos, k_pos, kind, window)
    if k_len is not None:
        valid &= (k_pos < k_offset + k_len)[None, :]
    s = torch.where(valid, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bhgqd", p, v.float())
    return out.permute(0, 3, 1, 2, 4).reshape(B, Sq, Hq, hd).to(q.dtype)


# ---------------------------------------------------------------------------
# KV cache
# ---------------------------------------------------------------------------

def cache_update(cache_k, cache_v, k_new, v_new, pos):
    """Insert (B, S_new, Hkv, hd) at offset ``pos``.

    Writes in place, where the reference returns new buffers from
    ``dynamic_update_slice`` (and donates the old ones); returns the same
    buffers so callers read like the reference.
    """
    S = k_new.shape[1]
    cache_k[:, pos:pos + S] = k_new.to(cache_k.dtype)
    cache_v[:, pos:pos + S] = v_new.to(cache_v.dtype)
    return cache_k, cache_v


def window_cache_update(cache_k, cache_v, k_new, v_new, pos):
    """Rolling cache of size W (sliding-window decode): one step at slot
    ``pos % W``, written in place like :func:`cache_update`."""
    W = cache_k.shape[1]
    slot = pos % W
    cache_k[:, slot:slot + k_new.shape[1]] = k_new.to(cache_k.dtype)
    cache_v[:, slot:slot + v_new.shape[1]] = v_new.to(cache_v.dtype)
    return cache_k, cache_v


def window_decode_attention(q, cache_k, cache_v, pos, window: int):
    """Decode against a rolling window cache: slot i holds the largest
    position p <= pos with p % W == i; keys outside (pos - window, pos] or
    before position 0 are masked."""
    W = cache_k.shape[1]
    dev = q.device
    slots = torch.arange(W, device=dev)
    k_pos = pos - torch.remainder(pos % W - slots, W)        # (W,) global positions
    B, _, Hq, hd = q.shape
    Hkv = cache_k.shape[2]
    g = Hq // Hkv
    qf = (q.float() * hd ** -0.5).reshape(B, 1, Hkv, g, hd)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qf, cache_k.float())
    valid = (k_pos <= pos) & (k_pos > pos - window) & (k_pos >= 0)
    s = torch.where(valid, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bhgqd", p, cache_v.float())
    return out.permute(0, 3, 1, 2, 4).reshape(B, 1, Hq, hd).to(q.dtype)
