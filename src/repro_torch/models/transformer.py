"""Decoder LM, dense family: parameters, blocks, forward, loss, prefill, decode.

Counterpart of the dense path of ``repro/models/transformer.py``.  The
reference scans over stacked layer parameters under ``jax.checkpoint``; the
port loops over the same stacked tensors in Python, and with ``remat`` wraps
each block (and each chunk of the loss) in ``torch.utils.checkpoint``
(non-reentrant), which recomputes the block's forward inside the backward.
The MoE, SSM, hybrid, VLM and enc-dec families wait for their slices
(ROADMAP A6-A8), and with them the rolling window cache.

bf16 rounding points follow the reference: the projections are matmuls in
the activation dtype (f32 accumulation inside, result rounded to it),
``rms_norm`` keeps f32 statistics, RoPE multiplies in f32, and SiLU runs in
f32 before the cast back.
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn_mod
from repro_torch.models.common import (ParamMeta, apply_rope, embed_lookup,
                                       rms_norm)


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def check_supported(cfg: ModelConfig) -> None:
    if cfg.family != "dense":
        raise NotImplementedError(
            f"family {cfg.family!r} is not in the port yet (ROADMAP A6-A8)")
    if cfg.window:
        raise NotImplementedError(
            "the rolling window cache arrives with the MoE/mixtral slice "
            "(ROADMAP A6)")


# ---------------------------------------------------------------------------
# Parameter metadata
# ---------------------------------------------------------------------------

def _attn_metas(cfg: ModelConfig, L: int) -> dict:
    D, Hq, Hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    return {
        "wq": ParamMeta((L, D, Hq, hd), ("layers", "embed", "q_heads", "head")),
        "wk": ParamMeta((L, D, Hkv, hd), ("layers", "embed", "kv_heads", "head")),
        "wv": ParamMeta((L, D, Hkv, hd), ("layers", "embed", "kv_heads", "head")),
        "wo": ParamMeta((L, Hq, hd, D), ("layers", "q_heads", "head", "embed")),
    }


def _mlp_metas(cfg: ModelConfig, L: int) -> dict:
    D, F_ = cfg.d_model, cfg.d_ff
    return {
        "w1": ParamMeta((L, D, F_), ("layers", "embed", "mlp")),
        "w2": ParamMeta((L, F_, D), ("layers", "mlp", "embed")),
        "w3": ParamMeta((L, D, F_), ("layers", "embed", "mlp")),
    }


def abstract_params(cfg: ModelConfig) -> dict:
    """Meta tree of the dense family.  Vocab dims use padded_vocab."""
    check_supported(cfg)
    D, V, L = cfg.d_model, cfg.padded_vocab, cfg.n_layers
    return {
        "embed": ParamMeta((V, D), ("vocab", "embed"), "normal", 0.02),
        "final_norm": ParamMeta((D,), ("embed",), "ones"),
        "lm_head": ParamMeta((D, V), ("embed", "vocab")),
        "blocks": {
            "ln1": ParamMeta((L, D), ("layers", "embed"), "ones"),
            "ln2": ParamMeta((L, D), ("layers", "embed"), "ones"),
            "attn": _attn_metas(cfg, L),
            "mlp": _mlp_metas(cfg, L),
        },
    }


def layer_params(blocks: dict, i: int) -> dict:
    """Layer ``i`` of a stacked block tree (views, no copies)."""
    return {k: layer_params(v, i) if isinstance(v, dict) else v[i]
            for k, v in blocks.items()}


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------

def _qkv(p, x, positions, cfg: ModelConfig):
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"].to(x.dtype))
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"].to(x.dtype))
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"].to(x.dtype))
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def attn_sublayer(p, h, positions, cfg: ModelConfig, *, kind="causal",
                  cache=None, pos=None):
    """Attention over pre-normed input ``h``.  Returns (output, new_cache).

    cache: (k, v) buffers of this layer for decode, updated in place;
    pos: current cache length.
    """
    q, k, v = _qkv(p, h, positions, cfg)
    new_cache = None
    if cache is None:
        out = attn_mod.attention(q, k, v, kind=kind, window=cfg.window,
                                 chunk=cfg.attn_chunk)
    else:
        ck, cv = attn_mod.cache_update(*cache, k, v, pos)
        out = attn_mod.attention(q, ck, cv, kind=kind, window=cfg.window,
                                 q_offset=pos, k_len=pos + q.shape[1],
                                 chunk=cfg.attn_chunk)
        new_cache = (ck, cv)
    proj = torch.einsum("bshk,hkd->bsd", out, p["wo"].to(h.dtype))
    return proj, new_cache


def mlp_sublayer(p, h, cfg: ModelConfig):
    """Gated-SiLU FFN over pre-normed input; SiLU in f32."""
    h1 = torch.einsum("bsd,df->bsf", h, p["w1"].to(h.dtype))
    h3 = torch.einsum("bsd,df->bsf", h, p["w3"].to(h.dtype))
    hh = F.silu(h1.float()).to(h.dtype) * h3
    return torch.einsum("bsf,fd->bsd", hh, p["w2"].to(h.dtype))


def dense_block(p, x, positions, cfg, cache=None, pos=None):
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    a, new_cache = attn_sublayer(p["attn"], h, positions, cfg, cache=cache,
                                 pos=pos)
    x = x + a
    h2 = rms_norm(x, p["ln2"], cfg.norm_eps)
    x = x + mlp_sublayer(p["mlp"], h2, cfg)
    return x, new_cache


# ---------------------------------------------------------------------------
# Whole-model forwards
# ---------------------------------------------------------------------------

def _positions_for(tokens, offset=0):
    B, S = tokens.shape
    pos = offset + torch.arange(S, device=tokens.device)
    return pos[None, :].expand(B, S)


def _block_out(p, positions, cfg, x):
    return dense_block(p, x, positions, cfg)[0]


def forward_lm(params, tokens, cfg: ModelConfig, *, remat: bool = False):
    """Token ids (B, S) -> final normed hidden states (B, S, D).  The dense
    family has no auxiliary losses, so the reference's ``aux`` is dropped.
    ``remat``: activation checkpointing per block (the reference's
    ``jax.checkpoint`` over the scan body)."""
    positions = _positions_for(tokens)
    x = embed_lookup(params["embed"], tokens).to(_dtype(cfg))
    for i in range(cfg.n_layers):
        fn = functools.partial(_block_out, layer_params(params["blocks"], i),
                               positions, cfg)
        x = checkpoint(fn, x, use_reentrant=False) if remat else fn(x)
    return rms_norm(x, params["final_norm"], cfg.norm_eps)


def _chunk_loss(head, pad_mask, xs, ls, ms):
    logits = (xs @ head.to(xs.dtype)).float()
    logits = logits.masked_fill(pad_mask, -1e30)          # mask the vocab pad
    lse = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, ls[:, None])[:, 0]
    return torch.sum((lse - gold) * ms)


def lm_loss_from_hidden(params, x, labels, mask, cfg: ModelConfig, *,
                        remat: bool = False):
    """Chunked cross-entropy over ``cfg.loss_chunk`` tokens at a time, the
    vocab padding masked with -1e30.  Returns (sum of token losses, token
    count), f32.  With ``remat`` each chunk's logits are recomputed in the
    backward instead of kept (the reference checkpoints the chunk body)."""
    B, S, D = x.shape
    T = B * S
    xf = x.reshape(T, D)
    lf = labels.reshape(T).long()
    mf = mask.reshape(T).float()
    chunk = min(cfg.loss_chunk, T)
    head = params["lm_head"]
    pad_mask = torch.arange(cfg.padded_vocab, device=x.device) >= cfg.vocab
    loss_sum = torch.zeros((), dtype=torch.float32, device=x.device)
    for lo in range(0, T, chunk):
        part = (head, pad_mask, xf[lo:lo + chunk], lf[lo:lo + chunk], mf[lo:lo + chunk])
        loss_sum = loss_sum + (checkpoint(_chunk_loss, *part, use_reentrant=False)
                               if remat else _chunk_loss(*part))
    return loss_sum, mf.sum()


def lm_logits(params, x, cfg: ModelConfig):
    logits = torch.einsum("bsd,dv->bsv", x, params["lm_head"].to(x.dtype))
    if cfg.padded_vocab != cfg.vocab:                  # mask the vocab pad
        pad = torch.arange(cfg.padded_vocab, device=x.device) >= cfg.vocab
        logits = logits.masked_fill(pad, -1e30)
    return logits


# ---------------------------------------------------------------------------
# Caches
# ---------------------------------------------------------------------------

def cache_metas(cfg: ModelConfig, batch: int, max_len: int) -> dict:
    """Meta tree of the decode cache; ``pos`` is kept on the host as an int."""
    hd = cfg.head_dim_
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, hd)
    axes = ("layers", "cbatch", "cseq", "kv_heads", "head")
    return {"k": ParamMeta(shape, axes, "zeros"),
            "v": ParamMeta(shape, axes, "zeros"),
            "pos": ParamMeta((), (), "zeros")}


# ---------------------------------------------------------------------------
# Decode / prefill
# ---------------------------------------------------------------------------

def decode_lm(params, cache, tokens, cfg: ModelConfig):
    """One decode step.  tokens (B, 1) -> (logits (B, 1, V), cache).  The
    cache's k/v buffers are updated in place and returned with pos + 1."""
    pos = int(cache["pos"])
    positions = _positions_for(tokens, offset=pos)
    x = embed_lookup(params["embed"], tokens).to(_dtype(cfg))
    for i in range(cfg.n_layers):
        x, _ = dense_block(layer_params(params["blocks"], i), x, positions, cfg,
                           cache=(cache["k"][i], cache["v"][i]), pos=pos)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = lm_logits(params, x, cfg)
    return logits, {"k": cache["k"], "v": cache["v"], "pos": pos + 1}


def prefill_lm(params, tokens, cfg: ModelConfig, *, max_len: int | None = None):
    """Prefill: forward over the prompt, returning last-position logits + a
    cache of capacity ``max_len`` (>= S) positioned at S, ready for decode."""
    B, S = tokens.shape
    max_len = max(max_len or S, S)
    dtype = _dtype(cfg)
    positions = _positions_for(tokens)
    x = embed_lookup(params["embed"], tokens).to(dtype)
    shape = (cfg.n_layers, B, max_len, cfg.n_kv_heads, cfg.head_dim_)
    ks = torch.zeros(shape, dtype=dtype, device=x.device)
    vs = torch.zeros(shape, dtype=dtype, device=x.device)
    for i in range(cfg.n_layers):
        p = layer_params(params["blocks"], i)
        hn = rms_norm(x, p["ln1"], cfg.norm_eps)
        q, k, v = _qkv(p["attn"], hn, positions, cfg)
        out = attn_mod.attention(q, k, v, kind="causal", window=cfg.window,
                                 chunk=cfg.attn_chunk)
        x = x + torch.einsum("bshk,hkd->bsd", out, p["attn"]["wo"].to(x.dtype))
        h2 = rms_norm(x, p["ln2"], cfg.norm_eps)
        x = x + mlp_sublayer(p["mlp"], h2, cfg)
        # written in place where the reference pads k/v out to max_len
        ks[i, :, :S] = k
        vs[i, :, :S] = v
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = lm_logits(params, x[:, -1:], cfg)
    return logits, {"k": ks, "v": vs, "pos": S}
