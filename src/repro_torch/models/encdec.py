"""Whisper-style encoder-decoder (audio frontend stubbed): parameters,
encoder, teacher-forced decoder, prefill and decode.

Counterpart of ``repro/models/encdec.py``.  The conv/audio frontend is a
stub, as in the reference: the batch's ``frames`` (B, n_frames, d_model)
are frame embeddings that already hold the conv downsampling and the
sinusoidal positions.  After them: ``n_enc_layers`` bidirectional encoder
blocks, ``n_layers`` causal decoder blocks with cross-attention over the
encoder's output, LayerNorm (scale and shift) and ungated GELU MLPs with
biases, learned decoder positions (``pos_embed``) and no RoPE.  The blocks
are those of ``models/transformer.py`` with their biases (``bq``, ``bv``,
``bo``; ``b1``, ``b2``).

Where the port departs from the reference's shape of the computation, not
its numbers:

* The reference scans over stacked layers; the port loops over the same
  stacked tensors (``remat`` wraps each block in ``torch.utils.checkpoint``
  in the training forward).
* ZeRO-3 (``fsdp`` and ``rules``): each encoder and decoder block gathers
  its layer's slice of ``enc_blocks`` / ``dec_blocks`` at its top, on the
  reference's plan (``gather_plan_of`` over the stacked metas), so under
  ``remat`` the gather sits inside the block's checkpoint, as in the
  reference's scan body: once in the forward and once more in the
  recompute, the gathered weights not kept between them.  The top-level
  leaves (embedding, ``pos_embed``, the norms, the head) come gathered
  from ``Model.loss``.
* Prefill's self-attention runs over the prompt's own k and v (flash with
  Sk = S, as the port's ``transformer._prefill_block`` does), which are
  then written into the cache of ``max_len`` positions; the reference
  attends over the zero-padded cache with ``k_len`` = S, the same pairs.
* The cross-attention's k and v are computed once per layer in prefill and
  kept in the cache (``cross_k``, ``cross_v``, in the model dtype); decode
  reads them and never recomputes them.  Decode's attentions (Sq = 1) take
  the wrapper's ``chunked_attention`` route, as the reference's do.
"""
from __future__ import annotations

import functools

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn_mod
from repro_torch.models import transformer as tf
from repro_torch.models.common import ParamMeta, embed_lookup, layer_norm

MAX_DEC_POS = 32768


def abstract_params(cfg: ModelConfig) -> dict:
    D, V = cfg.d_model, cfg.padded_vocab
    Le, Ld = cfg.n_enc_layers, cfg.n_layers

    def lns(L, names):
        out = {}
        for n in names:
            out[n] = ParamMeta((L, D), ("layers", "embed"), "ones")
            out[n + "_b"] = ParamMeta((L, D), ("layers", "embed"), "zeros")
        return out

    return {
        "enc_blocks": {
            **lns(Le, ("ln1", "ln2")),
            "attn": tf._attn_metas(cfg, L=Le, bias=True),
            "mlp": tf._mlp_metas(cfg, L=Le, gated=False, bias=True),
        },
        "enc_norm": ParamMeta((D,), ("embed",), "ones"),
        "enc_norm_b": ParamMeta((D,), ("embed",), "zeros"),
        "embed": ParamMeta((V, D), ("vocab", "embed"), "normal", 0.02),
        "pos_embed": ParamMeta((MAX_DEC_POS, D), (None, "embed"), "normal", 0.01),
        "dec_blocks": {
            **lns(Ld, ("ln1", "ln2", "ln3")),
            "self_attn": tf._attn_metas(cfg, L=Ld, bias=True),
            "cross_attn": tf._attn_metas(cfg, L=Ld, bias=True),
            "mlp": tf._mlp_metas(cfg, L=Ld, gated=False, bias=True),
        },
        "final_norm": ParamMeta((D,), ("embed",), "ones"),
        "final_norm_b": ParamMeta((D,), ("embed",), "zeros"),
        "lm_head": ParamMeta((D, V), ("embed", "vocab")),
    }


def _ln(p, name, x, cfg):
    return layer_norm(x, p[name], p[name + "_b"], cfg.norm_eps)


def _cross_kv(p, enc_out):
    """The cross-attention's k and v of the encoder output (B, F, D): the
    key projection has no bias, the value's has ``bv``."""
    k = torch.einsum("bfd,dhk->bfhk", enc_out, p["wk"].to(enc_out.dtype))
    v = torch.einsum("bfd,dhk->bfhk", enc_out, p["wv"].to(enc_out.dtype))
    return k, v + p["bv"].to(enc_out.dtype)


def _cross_attend(p, h, ck, cv, cfg: ModelConfig):
    """Bidirectional attention of the pre-normed decoder input over the
    encoder's k and v, with ``bq`` and ``bo``."""
    q = torch.einsum("bsd,dhk->bshk", h, p["wq"].to(h.dtype)) + p["bq"].to(h.dtype)
    out = attn_mod.attention(q, ck, cv, kind="bidir", chunk=cfg.attn_chunk)
    return tf.out_proj(p, out, h.dtype)


def _enc_block(lp, cfg: ModelConfig, h):
    a, _ = tf.attn_sublayer(lp["attn"], _ln(lp, "ln1", h, cfg), None, cfg, kind="bidir")
    h = h + a
    return h + tf.mlp_sublayer(lp["mlp"], _ln(lp, "ln2", h, cfg), cfg)


def _block_params(blocks, i: int, gplan, fsdp):
    """Layer ``i`` of a stacked block tree: views, or under ZeRO-3 its
    sharded leaves gathered over "data" (``tf.maybe_gather``)."""
    if fsdp is None:
        return tf.layer_params(blocks, i)
    return tf.maybe_gather(blocks, gplan, fsdp, layer=i)


def _gplan(cfg: ModelConfig, key: str, rules):
    return tf.gather_plan_of(abstract_params(cfg)[key], rules, scanned=True)


def _enc_out(blocks, i, gplan, fsdp, cfg, h):
    return _enc_block(_block_params(blocks, i, gplan, fsdp), cfg, h)


def encode(params, frames, cfg: ModelConfig, *, remat: bool = False, fsdp=None, rules=None):
    """frames (B, F, D) -> the encoder's normed output (B, F, D), in the
    model dtype.  ``fsdp`` (an ``FsdpScope``) with ``rules``: ZeRO-3, each
    block's layer gathered inside the block."""
    x = frames.to(tf._dtype(cfg))
    gplan = _gplan(cfg, "enc_blocks", rules) if fsdp is not None else None
    for i in range(cfg.n_enc_layers):
        fn = functools.partial(_enc_out, params["enc_blocks"], i, gplan, fsdp, cfg)
        x = checkpoint(fn, x, use_reentrant=False) if remat else fn(x)
    return layer_norm(x, params["enc_norm"], params["enc_norm_b"], cfg.norm_eps)


def _dec_block(lp, cfg: ModelConfig, h, enc_out):
    """One decoder block over the whole sequence: (h, its self-attention's k
    and v, the cross-attention's k and v)."""
    q, k, v = tf._qkv(lp["self_attn"], _ln(lp, "ln1", h, cfg), None, cfg)
    out = attn_mod.attention(q, k, v, kind="causal", window=cfg.window,
                             chunk=cfg.attn_chunk)
    h = h + tf.out_proj(lp["self_attn"], out, h.dtype)
    ck, cv = _cross_kv(lp["cross_attn"], enc_out)
    h = h + _cross_attend(lp["cross_attn"], _ln(lp, "ln2", h, cfg), ck, cv, cfg)
    h = h + tf.mlp_sublayer(lp["mlp"], _ln(lp, "ln3", h, cfg), cfg)
    return h, k, v, ck, cv


def _dec_out(blocks, i, gplan, fsdp, cfg, h, enc_out):
    return _dec_block(_block_params(blocks, i, gplan, fsdp), cfg, h, enc_out)[0]


def _dec_embed(params, tokens, cfg: ModelConfig, start: int):
    """Token embeddings plus the learned positions ``start`` onwards."""
    dtype = tf._dtype(cfg)
    x = embed_lookup(params["embed"], tokens).to(dtype)
    return x + params["pos_embed"][start:start + tokens.shape[1]].to(dtype)


def decode_train(params, tokens, enc_out, cfg: ModelConfig, *, remat: bool = False,
                 fsdp=None, rules=None):
    """Teacher-forced decoder forward -> the final normed hidden (B, S, D);
    ``fsdp`` and ``rules`` as :func:`encode`."""
    x = _dec_embed(params, tokens, cfg, 0)
    gplan = _gplan(cfg, "dec_blocks", rules) if fsdp is not None else None
    for i in range(cfg.n_layers):
        fn = functools.partial(_dec_out, params["dec_blocks"], i, gplan, fsdp, cfg)
        x = checkpoint(fn, x, enc_out, use_reentrant=False) if remat else fn(x, enc_out)
    return layer_norm(x, params["final_norm"], params["final_norm_b"], cfg.norm_eps)


def forward(params, batch, cfg: ModelConfig, *, remat: bool = False, fsdp=None, rules=None):
    """(the decoder's final hidden (B, S, D), aux 0) of a batch with
    ``frames`` and ``tokens``; ``fsdp`` and ``rules`` as :func:`encode`."""
    enc_out = encode(params, batch["frames"], cfg, remat=remat, fsdp=fsdp, rules=rules)
    hidden = decode_train(params, batch["tokens"], enc_out, cfg, remat=remat, fsdp=fsdp,
                          rules=rules)
    return hidden, torch.zeros((), dtype=torch.float32, device=hidden.device)


def prefill(params, batch, cfg: ModelConfig, max_len: int | None = None):
    """Encode, then the decoder over the prompt.  Returns (last-position
    logits (B, 1, V), cache): the self-attention's k/v in ``max_len`` (>= S)
    positions, the cross-attention's over the frames, ``pos`` = S."""
    enc_out = encode(params, batch["frames"], cfg)
    tokens = batch["tokens"]
    B, S = tokens.shape
    max_len = max(max_len or S, S)
    cache = tf.zeros_cache(tf.cache_metas(cfg, B, max_len), enc_out.dtype, enc_out.device)
    cache["pos"] = S
    x = _dec_embed(params, tokens, cfg, 0)
    for i in range(cfg.n_layers):
        x, k, v, ck, cv = _dec_block(tf.layer_params(params["dec_blocks"], i), cfg, x, enc_out)
        cache["k"][i, :, :S] = k
        cache["v"][i, :, :S] = v
        cache["cross_k"][i] = ck
        cache["cross_v"][i] = cv
    x = layer_norm(x, params["final_norm"], params["final_norm_b"], cfg.norm_eps)
    return tf.lm_logits(params, x[:, -1:], cfg), cache


def decode_step(params, cache, tokens, cfg: ModelConfig):
    """One decoder token (B, 1) with the cached self and cross k/v.  The
    self-attention's buffers are written in place; ``cross_k`` and
    ``cross_v`` are only read.  Returns (logits (B, 1, V), cache with pos +
    1)."""
    pos = int(cache["pos"])
    x = _dec_embed(params, tokens, cfg, pos)
    for i in range(cfg.n_layers):
        lp = tf.layer_params(params["dec_blocks"], i)
        a, _ = tf.attn_sublayer(lp["self_attn"], _ln(lp, "ln1", x, cfg), None, cfg,
                                kind="causal", cache=(cache["k"][i], cache["v"][i]), pos=pos)
        x = x + a
        x = x + _cross_attend(lp["cross_attn"], _ln(lp, "ln2", x, cfg), cache["cross_k"][i],
                              cache["cross_v"][i], cfg)
        x = x + tf.mlp_sublayer(lp["mlp"], _ln(lp, "ln3", x, cfg), cfg)
    x = layer_norm(x, params["final_norm"], params["final_norm_b"], cfg.norm_eps)
    return tf.lm_logits(params, x, cfg), {**cache, "pos": pos + 1}
