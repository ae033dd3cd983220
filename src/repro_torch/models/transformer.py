"""Decoder LM, dense / MoE / VLM / SSM / hybrid families: parameters,
blocks, forward, loss, prefill, decode; and the blocks the encoder-decoder
(``models/encdec.py``) is built from.

Counterpart of those paths of ``repro/models/transformer.py``, the sliding
window's rolling cache included (mixtral).  The reference scans over stacked
layer parameters under ``jax.checkpoint``; the port loops over the same
stacked tensors in Python, and with ``remat`` wraps each block (and each
chunk of the loss) in ``torch.utils.checkpoint`` (non-reentrant), which
recomputes the block's forward inside the backward.  The SSM family
(mamba2) stacks Mamba2 blocks; the hybrid (zamba2) runs ``n_layers //
attn_every`` groups of ``attn_every`` Mamba2 blocks, each group followed by
one shared attention + MLP block (its weights shared, its KV cache one per
group), then a tail of the ``n_layers % attn_every`` blocks left.  The VLM
(qwen2-vl) is the dense family with M-RoPE: its positions are three streams
(3, B, S), the batch's ``mrope`` leaf or, without one, the text-only
positions broadcast to three streams (the reference's rule, decode's
too).  The encoder-decoder's blocks add biases (``bq``, ``bv``, ``bo``;
``b1``, ``b2``), the ungated GELU MLP and no RoPE.

ZeRO-3 (every family): the forward takes an
:class:`~repro_torch.core.collectives.FsdpScope` and gathers the sharded
leaves over "data" (:func:`maybe_gather`, on the plans of
:func:`blocks_gplan`: the reference's ``PlanLeaf`` / ``gather_plan_of`` /
``_blocks_gplan`` / ``maybe_gather``).  A dense, MoE or Mamba2 block
gathers its own at its top, so under ``remat`` the gather sits inside the
checkpointed block, as in the reference's scan body: the gathered weights
are not kept for the backward but gathered again there.  A MoE block's
router and expert stacks are gathered on their "embed" dim like the rest (a
layer's router on dim 0, w1 and w3 on dim 1, w2 on dim 2).  The hybrid
follows the reference's plan: its shared block is gathered once per
forward, outside every checkpoint, and kept for the backward (one adjoint
per leaf and micro-step); a group's ``attn_every`` Mamba2 blocks are
gathered at once, as the slice ``groups[g]``, once in the forward and once
more in the backward (:class:`_GroupGather`); the tail's blocks are
gathered one by one.  The checkpoint unit stays the block, where the
reference checkpoints the group body whole: four ranks of zamba2-7b's
group recompute at once do not fit one card (DESIGN_TORCH.md §22).  A
Mamba2 block's convolutions, ``A_log``, ``dt_bias``, ``D`` and ``gnorm``
have no "embed" dim and stay whole on every rank.

bf16 rounding points follow the reference: the projections are matmuls in
the activation dtype (f32 accumulation inside, result rounded to it), each
bias added in that dtype after the product, ``rms_norm`` and ``layer_norm``
keep f32 statistics, RoPE multiplies in f32, and SiLU and GELU (the tanh
approximation, ``jax.nn.gelu``'s default) run in f32 before the cast back.
The Mamba2 block keeps the reference's points too: the short convolutions
sum in f32 and SiLU runs in f32 before the cast back, dt = softplus(f32),
and the SSD state is f32 (``ssd_scan`` returns it so; the cache keeps it
so).
"""
from __future__ import annotations

import dataclasses
import functools

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.core.tree import tree_map
from repro_torch.models import attention as attn_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.common import (ParamMeta, apply_rope, embed_lookup,
                                       fsdp_dim, mrope_pair_positions, rms_norm,
                                       tree_map_meta)

FAMILIES = ("dense", "moe", "vlm", "ssm", "hybrid", "encdec")


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def check_supported(cfg: ModelConfig) -> None:
    """Every family of the reference: dense and MoE (each with or without a
    sliding window), VLM, SSM, hybrid and the encoder-decoder."""
    if cfg.family not in FAMILIES:
        raise ValueError(f"unknown family {cfg.family!r}: the families are "
                         f"{', '.join(FAMILIES)}")


# ---------------------------------------------------------------------------
# Parameter metadata
# ---------------------------------------------------------------------------

def _attn_metas(cfg: ModelConfig, L: int | None = None, bias: bool = False) -> dict:
    """Stacked over L layers, or one block's (the hybrid's shared block).
    ``bias`` (the encoder-decoder's): ``bq``, ``bv`` and ``bo``; whisper's
    key projection has none."""
    D, Hq, Hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    pre, pax = ((L,), ("layers",)) if L else ((), ())
    m = {
        "wq": ParamMeta(pre + (D, Hq, hd), pax + ("embed", "q_heads", "head")),
        "wk": ParamMeta(pre + (D, Hkv, hd), pax + ("embed", "kv_heads", "head")),
        "wv": ParamMeta(pre + (D, Hkv, hd), pax + ("embed", "kv_heads", "head")),
        "wo": ParamMeta(pre + (Hq, hd, D), pax + ("q_heads", "head", "embed")),
    }
    if bias:
        m["bq"] = ParamMeta(pre + (Hq, hd), pax + ("q_heads", "head"), "zeros")
        m["bv"] = ParamMeta(pre + (Hkv, hd), pax + ("kv_heads", "head"), "zeros")
        m["bo"] = ParamMeta(pre + (D,), pax + ("embed",), "zeros")
    return m


def _mlp_metas(cfg: ModelConfig, L: int | None = None, gated: bool = True,
               bias: bool = False) -> dict:
    """Gated-SiLU (``w3``) or, ungated, GELU; ``bias``: ``b1`` and ``b2``."""
    D, F_ = cfg.d_model, cfg.d_ff
    pre, pax = ((L,), ("layers",)) if L else ((), ())
    m = {
        "w1": ParamMeta(pre + (D, F_), pax + ("embed", "mlp")),
        "w2": ParamMeta(pre + (F_, D), pax + ("mlp", "embed")),
    }
    if gated:
        m["w3"] = ParamMeta(pre + (D, F_), pax + ("embed", "mlp"))
    if bias:
        m["b1"] = ParamMeta(pre + (F_,), pax + ("mlp",), "zeros")
        m["b2"] = ParamMeta(pre + (D,), pax + ("embed",), "zeros")
    return m


def _moe_metas(cfg: ModelConfig, L: int) -> dict:
    D, E, F_ = cfg.d_model, cfg.n_experts, cfg.d_ff_expert
    return {
        "router": ParamMeta((L, D, E), ("layers", "embed", "experts")),
        "w1": ParamMeta((L, E, D, F_), ("layers", "experts", "embed", "expert_mlp")),
        "w3": ParamMeta((L, E, D, F_), ("layers", "experts", "embed", "expert_mlp")),
        "w2": ParamMeta((L, E, F_, D), ("layers", "experts", "expert_mlp", "embed")),
    }


def _ssm_metas(cfg: ModelConfig, pre: tuple[int, ...], pax: tuple[str, ...]) -> dict:
    """A Mamba2 block's parameters, stacked over the leading dims ``pre``."""
    D, din = cfg.d_model, cfg.d_inner
    G, N, H, W = cfg.ssm_groups, cfg.ssm_state, cfg.n_ssm_heads, cfg.ssm_conv
    return {
        "ln": ParamMeta(pre + (D,), pax + ("embed",), "ones"),
        "w_z": ParamMeta(pre + (D, din), pax + ("embed", "inner")),
        "w_x": ParamMeta(pre + (D, din), pax + ("embed", "inner")),
        "w_B": ParamMeta(pre + (D, G * N), pax + ("embed", "state")),
        "w_C": ParamMeta(pre + (D, G * N), pax + ("embed", "state")),
        "w_dt": ParamMeta(pre + (D, H), pax + ("embed", "ssm_heads")),
        "conv_x": ParamMeta(pre + (W, din), pax + ("conv", "inner"), "normal", 0.5),
        "conv_B": ParamMeta(pre + (W, G * N), pax + ("conv", "state"), "normal", 0.5),
        "conv_C": ParamMeta(pre + (W, G * N), pax + ("conv", "state"), "normal", 0.5),
        "A_log": ParamMeta(pre + (H,), pax + ("ssm_heads",), "zeros"),
        "dt_bias": ParamMeta(pre + (H,), pax + ("ssm_heads",), "zeros"),
        "D": ParamMeta(pre + (H,), pax + ("ssm_heads",), "ones"),
        "gnorm": ParamMeta(pre + (din,), pax + ("inner",), "ones"),
        "out_proj": ParamMeta(pre + (din, D), pax + ("inner", "embed")),
    }


def abstract_params(cfg: ModelConfig) -> dict:
    """Meta tree of the decoder families (the encoder-decoder's is
    ``encdec.abstract_params``).  Vocab dims use padded_vocab; the VLM's
    tree is the dense one."""
    check_supported(cfg)
    if cfg.family == "encdec":
        raise ValueError("the encoder-decoder's tree is models.encdec.abstract_params")
    D, V, L = cfg.d_model, cfg.padded_vocab, cfg.n_layers
    base = {
        "embed": ParamMeta((V, D), ("vocab", "embed"), "normal", 0.02),
        "final_norm": ParamMeta((D,), ("embed",), "ones"),
        "lm_head": ParamMeta((D, V), ("embed", "vocab")),
    }
    if cfg.family == "ssm":
        base["blocks"] = _ssm_metas(cfg, (L,), ("layers",))
    elif cfg.family == "hybrid":
        n_groups, leftover = divmod(L, cfg.attn_every)
        base["groups"] = _ssm_metas(cfg, (n_groups, cfg.attn_every), ("group", "layers"))
        if leftover:
            base["tail"] = _ssm_metas(cfg, (leftover,), ("layers",))
        base["shared"] = {"ln1": ParamMeta((D,), ("embed",), "ones"),
                          "ln2": ParamMeta((D,), ("embed",), "ones"),
                          "attn": _attn_metas(cfg), "mlp": _mlp_metas(cfg)}
    else:
        base["blocks"] = {
            "ln1": ParamMeta((L, D), ("layers", "embed"), "ones"),
            "ln2": ParamMeta((L, D), ("layers", "embed"), "ones"),
            "attn": _attn_metas(cfg, L),
        }
        if cfg.family == "moe":
            base["blocks"]["moe"] = _moe_metas(cfg, L)
        else:
            base["blocks"]["mlp"] = _mlp_metas(cfg, L)
    return base


def layer_params(blocks: dict, i: int) -> dict:
    """Layer ``i`` of a stacked block tree (views, no copies)."""
    return {k: layer_params(v, i) if isinstance(v, dict) else v[i]
            for k, v in blocks.items()}


# ---------------------------------------------------------------------------
# ZeRO-3 gather plan
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PlanLeaf:
    """Per parameter: the dim gathered over "data" in what the forward reads
    (a layer's slice of a stacked leaf), or None (replicated).  The
    reference's ``PlanLeaf`` also carries the gathered slice's "model" axis
    sharding, which the port does not have."""

    dim: int | None


def gather_plan_of(metas, rules, scanned: bool):
    """A PlanLeaf per leaf of ``metas`` under ``rules`` (``make_rules``);
    ``scanned``: the leaves are stacked over layers and gathered one layer
    at a time, so the dims count from the layer's slice."""
    def one(m: ParamMeta):
        dim = fsdp_dim(m, rules)
        return PlanLeaf(None if dim is None else dim - (1 if scanned else 0))
    return tree_map_meta(one, metas)


def blocks_gplan(cfg: ModelConfig, rules) -> dict:
    """The gather plans of the stacked block trees ("blocks", "groups",
    "tail": one layer's slice, or one group's, at a time) and of the
    hybrid's unstacked "shared" block (the reference's ``_blocks_gplan``).
    A group's slice ``groups[g]`` keeps its ``attn_every`` dim, so its
    leaves gather on the "embed" dim less one, as a layer's do."""
    metas = abstract_params(cfg)
    out = {k: gather_plan_of(metas[k], rules, scanned=True)
           for k in ("blocks", "groups", "tail") if k in metas}
    if "shared" in metas:
        out["shared"] = gather_plan_of(metas["shared"], rules, scanned=False)
    return out


def maybe_gather(params, gather_plan, fsdp, layer: int | None = None):
    """ZeRO-3: every leaf of ``params`` with a gather dim all-gathered over
    "data" through ``fsdp`` (an ``FsdpScope``); with ``layer``, the leaves
    are stacked and layer ``layer``'s slice is what is read and gathered."""
    def one(p, plan: PlanLeaf):
        if plan.dim is None:
            return p if layer is None else p[layer]
        return fsdp.gather(p, plan.dim, layer)
    return tree_map(one, params, gather_plan)


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------

def _qkv(p, x, positions, cfg: ModelConfig):
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"].to(x.dtype))
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"].to(x.dtype))
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"].to(x.dtype))
    if "bq" in p:
        q = q + p["bq"].to(x.dtype)
        v = v + p["bv"].to(x.dtype)
    if cfg.family != "encdec":                       # whisper has no RoPE
        # M-RoPE's positions come one per frequency pair (_layer_positions)
        pairwise = bool(cfg.mrope_sections)
        q = apply_rope(q, positions, cfg.rope_theta, pairwise=pairwise)
        k = apply_rope(k, positions, cfg.rope_theta, pairwise=pairwise)
    return q, k, v


def out_proj(p, out, dtype):
    """The attention output's projection (B, S, Hq, hd) -> (B, S, D), with
    ``bo`` where the block has one."""
    proj = torch.einsum("bshk,hkd->bsd", out, p["wo"].to(dtype))
    return proj + p["bo"].to(dtype) if "bo" in p else proj


def attn_sublayer(p, h, positions, cfg: ModelConfig, *, kind="causal",
                  cache=None, pos=None):
    """Attention over pre-normed input ``h``.  Returns (output, new_cache).

    cache: (k, v) buffers of this layer for decode, updated in place;
    pos: current cache length.  A cache exactly ``cfg.window`` long is the
    rolling window cache (the reference's rule: a test of shape, not of
    position); any other is linear.
    """
    q, k, v = _qkv(p, h, positions, cfg)
    new_cache = None
    if cache is None:
        out = attn_mod.attention(q, k, v, kind=kind, window=cfg.window,
                                 chunk=cfg.attn_chunk)
    else:
        ck, cv = cache
        if cfg.window and ck.shape[1] == cfg.window:
            ck, cv = attn_mod.window_cache_update(ck, cv, k, v, pos)
            out = attn_mod.window_decode_attention(q, ck, cv, pos, cfg.window)
        else:
            ck, cv = attn_mod.cache_update(ck, cv, k, v, pos)
            out = attn_mod.attention(q, ck, cv, kind=kind, window=cfg.window,
                                     q_offset=pos, k_len=pos + q.shape[1],
                                     chunk=cfg.attn_chunk)
        new_cache = (ck, cv)
    return out_proj(p, out, h.dtype), new_cache


def mlp_sublayer(p, h, cfg: ModelConfig):
    """FFN over pre-normed input: gated-SiLU where ``w3`` is present, else
    GELU (tanh approximation); each in f32 before the cast back."""
    h1 = torch.einsum("bsd,df->bsf", h, p["w1"].to(h.dtype))
    if "b1" in p:
        h1 = h1 + p["b1"].to(h.dtype)
    if "w3" in p:
        h3 = torch.einsum("bsd,df->bsf", h, p["w3"].to(h.dtype))
        hh = F.silu(h1.float()).to(h.dtype) * h3
    else:
        hh = F.gelu(h1.float(), approximate="tanh").to(h.dtype)
    out = torch.einsum("bsf,fd->bsd", hh, p["w2"].to(h.dtype))
    return out + p["b2"].to(h.dtype) if "b2" in p else out


def ffn_sublayer(p, h2, cfg: ModelConfig):
    """The block's FFN over pre-normed ``h2`` (B, S, D): the MoE over all
    B*S tokens at once, or the dense MLP.  Returns (output, aux dict)."""
    if "moe" in p:
        B, S, D = h2.shape
        out, aux = moe_mod.moe_ffn(h2.reshape(B * S, D), p["moe"],
                                   n_experts=cfg.n_experts, top_k=cfg.top_k,
                                   capacity_factor=cfg.capacity_factor)
        return out.reshape(B, S, D), aux
    return mlp_sublayer(p["mlp"], h2, cfg), {}


def dense_block(p, x, positions, cfg, cache=None, pos=None):
    """One block; returns (x, new_cache, aux) (aux is {} for the dense MLP).
    Also the hybrid's shared block (``ln1``, ``attn``, ``ln2``, ``mlp``)."""
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    a, new_cache = attn_sublayer(p["attn"], h, positions, cfg, cache=cache,
                                 pos=pos)
    x = x + a
    h2 = rms_norm(x, p["ln2"], cfg.norm_eps)
    f, aux = ffn_sublayer(p, h2, cfg)
    return x + f, new_cache, aux


def _prefill_block(p, x, positions, cfg):
    """``dense_block`` over a whole prompt, also returning its k and v."""
    hn = rms_norm(x, p["ln1"], cfg.norm_eps)
    q, k, v = _qkv(p["attn"], hn, positions, cfg)
    out = attn_mod.attention(q, k, v, kind="causal", window=cfg.window,
                             chunk=cfg.attn_chunk)
    x = x + out_proj(p["attn"], out, x.dtype)
    h2 = rms_norm(x, p["ln2"], cfg.norm_eps)
    return x + ffn_sublayer(p, h2, cfg)[0], k, v


def _silu_to(t, dtype):
    return F.silu(t.float()).to(dtype)


def _ssm_in(p, x, cfg):
    """The block's input projections of the normed x: (z, x, B, C, dt), each
    a matmul in x's type (the reference's einsums)."""
    h = rms_norm(x, p["ln"], cfg.norm_eps)
    return tuple(torch.einsum("bsd,de->bse", h, p[w].to(x.dtype))
                 for w in ("w_z", "w_x", "w_B", "w_C", "w_dt"))


def _ssm_out(p, x, y, z, cfg):
    """Gate, group norm and output projection of the SSD output y (B,S,H,P)."""
    y = y.reshape(x.shape[0], x.shape[1], cfg.d_inner)
    y = rms_norm(y * _silu_to(z, y.dtype), p["gnorm"], cfg.norm_eps)
    return x + torch.einsum("bse,ed->bsd", y, p["out_proj"].to(x.dtype))


def _ssd_args(p, x, xin, Bp, Cp, dt, cfg):
    """(x (B,S,H,P), dt f32, A, B (B,S,G,N), C) of the SSD from the block's
    post-conv projections; dt = softplus(dt + dt_bias) in f32."""
    B_, S = x.shape[:2]
    H, Pd, G, N = cfg.n_ssm_heads, cfg.ssm_headdim, cfg.ssm_groups, cfg.ssm_state
    dt = F.softplus(dt.float() + p["dt_bias"].float())
    A = -torch.exp(p["A_log"].float())
    return (xin.reshape(B_, S, H, Pd), dt, A, Bp.reshape(B_, S, G, N),
            Cp.reshape(B_, S, G, N))


def ssm_block(p, x, cfg: ModelConfig, state=None, conv=None):
    """Mamba2 block.  With ``state`` ({"s"}) and ``conv`` ({"x", "B", "C"},
    the last W - 1 pre-conv projections) one decode step, returning (x,
    ({"s": new}, {"x", "B", "C": new})); else the whole sequence, (x, None)."""
    z, xin, Bp, Cp, dt = _ssm_in(p, x, cfg)
    new_state = None
    if state is None:
        xin, Bp, Cp = (_silu_to(ssm_mod.causal_conv1d(t, p[w]), x.dtype)
                       for t, w in ((xin, "conv_x"), (Bp, "conv_B"), (Cp, "conv_C")))
        xh, dt, A, Bh, Ch = _ssd_args(p, x, xin, Bp, Cp, dt, cfg)
        y, _ = ssm_mod.ssd_scan(xh, dt, A, Bh, Ch, p["D"], cfg.ssm_chunk)
    else:
        (xin, cx), (Bp, cB), (Cp, cC) = (
            ssm_mod.conv_decode_step(conv[k], t, p[w])
            for k, t, w in (("x", xin, "conv_x"), ("B", Bp, "conv_B"), ("C", Cp, "conv_C")))
        xin, Bp, Cp = (_silu_to(t, x.dtype) for t in (xin, Bp, Cp))
        xh, dt, A, Bh, Ch = _ssd_args(p, x, xin, Bp, Cp, dt, cfg)
        y, s_new = ssm_mod.ssd_decode_step(state["s"], xh, dt, A, Bh, Ch, p["D"])
        new_state = ({"s": s_new}, {"x": cx, "B": cB, "C": cC})
    return _ssm_out(p, x, y, z, cfg), new_state


def ssm_prefill_block(p, x, cfg: ModelConfig):
    """SSM block that also returns its final (ssd, conv) states for decoding:
    (x, {"s": (B,H,N,P) f32}, {"x", "B", "C": the last W - 1 pre-conv
    projections})."""
    z, xin0, Bp0, Cp0, dt = _ssm_in(p, x, cfg)
    W = cfg.ssm_conv
    conv_states = {"x": xin0[:, -(W - 1):], "B": Bp0[:, -(W - 1):], "C": Cp0[:, -(W - 1):]}
    xin, Bp, Cp = (_silu_to(ssm_mod.causal_conv1d(t, p[w]), x.dtype)
                   for t, w in ((xin0, "conv_x"), (Bp0, "conv_B"), (Cp0, "conv_C")))
    xh, dt, A, Bh, Ch = _ssd_args(p, x, xin, Bp, Cp, dt, cfg)
    y, final_state = ssm_mod.ssd_scan(xh, dt, A, Bh, Ch, p["D"], cfg.ssm_chunk)
    return _ssm_out(p, x, y, z, cfg), {"s": final_state}, conv_states


# ---------------------------------------------------------------------------
# Whole-model forwards
# ---------------------------------------------------------------------------

def _positions_for(cfg: ModelConfig, tokens, offset=0, mrope=None):
    """(B, S) positions from ``offset``; with M-RoPE (3, B, S): ``mrope``
    where the batch has it, else the text-only positions broadcast to the
    three streams (the reference's default, decode's positions too)."""
    B, S = tokens.shape
    if cfg.mrope_sections and mrope is not None:
        return mrope
    pos = (offset + torch.arange(S, device=tokens.device))[None, :].expand(B, S)
    return pos[None].expand(3, B, S) if cfg.mrope_sections else pos


def _layer_positions(cfg: ModelConfig, tokens, offset=0, mrope=None):
    """The positions every layer's ``_qkv`` takes: ``_positions_for``'s, with
    M-RoPE's three streams turned, once a forward, into each frequency
    pair's (B, S, head_dim/2) (``mrope_pair_positions``)."""
    pos = _positions_for(cfg, tokens, offset, mrope)
    if cfg.mrope_sections:
        return mrope_pair_positions(pos, cfg.mrope_sections, cfg.head_dim_)
    return pos


def _block_out(p, positions, cfg, x):
    """(x, the block's aux loss term) of one block, for the forward's loop."""
    x, _, a = dense_block(p, x, positions, cfg)
    return x, (a["moe_aux"] * 0.01 + a["moe_z"] * 1e-3) if a else 0.0


def _ssm_out_only(p, positions, cfg, x):
    return ssm_block(p, x, cfg)[0], 0.0


def _layers(params, cfg):
    """(kind, block params) in the order the model runs them: "dense" (dense
    and MoE blocks), "ssm" (Mamba2 blocks) and the hybrid's "shared" block
    after each group of ``attn_every`` Mamba2 blocks, then its tail."""
    if cfg.family != "hybrid":
        kind = "ssm" if cfg.family == "ssm" else "dense"
        return [(kind, layer_params(params["blocks"], i)) for i in range(cfg.n_layers)]
    out = []
    for gi in range(cfg.n_layers // cfg.attn_every):
        gp = layer_params(params["groups"], gi)
        out += [("ssm", layer_params(gp, li)) for li in range(cfg.attn_every)]
        out.append(("shared", params["shared"]))
    if "tail" in params:
        out += [("ssm", layer_params(params["tail"], li))
                for li in range(params["tail"]["ln"].shape[0])]
    return out


def _gathered_block_out(blocks, i, gplan, fsdp, positions, cfg, out_fn, x):
    """``out_fn`` (``_block_out`` or ``_ssm_out_only``) of layer ``i`` of
    the stacked ``blocks``, its sharded leaves gathered first."""
    return out_fn(maybe_gather(blocks, gplan, fsdp, layer=i), positions, cfg, x)


class _GroupGather:
    """ZeRO-3's gather of the hybrid's group ``g``, shared by its Mamba2
    blocks: the slice ``groups[g]`` is gathered at once when a block first
    reads it, kept while the group's blocks run, and dropped after the last
    of them: block ``attn_every - 1`` in the forward, block 0 in remat's
    recompute, which runs the blocks in reverse.  So a group is gathered
    once per forward and once more in the backward, and the gathered
    leaves live only while their group runs (the blocks' checkpoints hold
    this object, not the leaves)."""

    def __init__(self, groups, g: int, gplan, fsdp, n_blocks: int):
        self._args = (groups, gplan, fsdp, g)
        self._n = n_blocks
        self._gp, self._last = None, None

    def layer(self, li: int) -> dict:
        """Block ``li``'s parameters: views of the gathered group."""
        if self._gp is None:
            groups, gplan, fsdp, g = self._args
            self._gp = maybe_gather(groups, gplan, fsdp, layer=g)
            self._last = self._n - 1 if li == 0 else 0
        p = layer_params(self._gp, li)
        if li == self._last:
            self._gp = None
        return p


def _group_block_out(gg: _GroupGather, li, positions, cfg, x):
    return ssm_block(gg.layer(li), x, cfg)[0], 0.0


def _gathered_blocks(params, positions, cfg, fsdp, gplans):
    """ZeRO-3's blocks of the forward, each a function of x returning (x,
    aux) that reads its sharded leaves gathered: a block of the dense, MoE
    and SSM families gathers its own at its top; the hybrid's shared block
    is gathered here, once, outside every block, and a group's Mamba2
    blocks share one gather of the group (:class:`_GroupGather`); the tail
    gathers per block."""
    if cfg.family != "hybrid":
        out_fn = _ssm_out_only if cfg.family == "ssm" else _block_out
        return [functools.partial(_gathered_block_out, params["blocks"], i, gplans["blocks"],
                                  fsdp, positions, cfg, out_fn) for i in range(cfg.n_layers)]
    shared = maybe_gather(params["shared"], gplans["shared"], fsdp)
    fns = []
    for g in range(cfg.n_layers // cfg.attn_every):
        gg = _GroupGather(params["groups"], g, gplans["groups"], fsdp, cfg.attn_every)
        fns += [functools.partial(_group_block_out, gg, li, positions, cfg)
                for li in range(cfg.attn_every)]
        fns.append(functools.partial(_block_out, shared, positions, cfg))
    if "tail" in params:
        fns += [functools.partial(_gathered_block_out, params["tail"], i, gplans["tail"], fsdp,
                                  positions, cfg, _ssm_out_only)
                for i in range(params["tail"]["ln"].shape[0])]
    return fns


def forward_lm(params, tokens, cfg: ModelConfig, *, mrope=None, remat: bool = False,
               fsdp=None, rules=None):
    """Token ids (B, S) -> (final normed hidden states (B, S, D), aux), aux
    the f32 sum over layers of ``moe_aux`` * 0.01 + ``moe_z`` * 1e-3 (0 for
    the other families), as in the reference.  ``remat``: activation
    checkpointing per block (the reference's ``jax.checkpoint`` over the scan
    body).  ``fsdp`` (an ``FsdpScope``) with ``rules`` (``make_rules``):
    ZeRO-3, the stacked blocks' leaves sharded and gathered on the
    reference's plan (:func:`_gathered_blocks`; the embedding and final norm
    come gathered); ``remat`` checkpoints each block as without ZeRO-3.
    ``mrope``: the VLM's (3, B, S) positions (``_positions_for``)."""
    positions = _layer_positions(cfg, tokens, mrope=mrope)
    x = embed_lookup(params["embed"], tokens).to(_dtype(cfg))
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if fsdp is not None:
        fns = _gathered_blocks(params, positions, cfg, fsdp, blocks_gplan(cfg, rules))
    else:
        fns = [functools.partial(_ssm_out_only if kind == "ssm" else _block_out, p,
                                 positions, cfg) for kind, p in _layers(params, cfg)]
    for fn in fns:
        x, a = checkpoint(fn, x, use_reentrant=False) if remat else fn(x)
        aux = aux + a
    return rms_norm(x, params["final_norm"], cfg.norm_eps), aux


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

def _ssm_state_metas(cfg: ModelConfig, batch: int, pre, pax) -> dict:
    H, Pd, N, W = cfg.n_ssm_heads, cfg.ssm_headdim, cfg.ssm_state, cfg.ssm_conv
    GN, din = cfg.ssm_groups * N, cfg.d_inner
    return {
        "s": ParamMeta(pre + (batch, H, N, Pd), pax + ("cbatch", "ssm_heads", "state", "head"),
                       "zeros"),
        "conv_x": ParamMeta(pre + (batch, W - 1, din), pax + ("cbatch", "conv", "inner"), "zeros"),
        "conv_B": ParamMeta(pre + (batch, W - 1, GN), pax + ("cbatch", "conv", "state"), "zeros"),
        "conv_C": ParamMeta(pre + (batch, W - 1, GN), pax + ("cbatch", "conv", "state"), "zeros"),
    }


def cache_metas(cfg: ModelConfig, batch: int, max_len: int) -> dict:
    """Meta tree of the decode cache; ``pos`` is kept on the host as an int.
    With a sliding window the cache holds ``min(max_len, window)`` positions.
    SSM: per layer the SSD state ``s`` and the conv states; hybrid: those
    under ``groups`` (n_groups, attn_every, ...) and ``tail``, and the shared
    block's k/v once per group; encoder-decoder: the decoder's k/v and the
    cross-attention's ``cross_k`` / ``cross_v`` over the encoder's frames."""
    hd = cfg.head_dim_
    pos = ParamMeta((), (), "zeros")
    if cfg.family == "ssm":
        return {**_ssm_state_metas(cfg, batch, (cfg.n_layers,), ("layers",)), "pos": pos}
    if cfg.family == "hybrid":
        n_groups, leftover = divmod(cfg.n_layers, cfg.attn_every)
        kv = ParamMeta((n_groups, batch, max_len, cfg.n_kv_heads, hd),
                       ("group", "cbatch", "cseq", "kv_heads", "head"), "zeros")
        out = {"groups": _ssm_state_metas(cfg, batch, (n_groups, cfg.attn_every),
                                          ("group", "layers")),
               "shared_k": kv, "shared_v": kv, "pos": pos}
        if leftover:
            out["tail"] = _ssm_state_metas(cfg, batch, (leftover,), ("layers",))
        return out
    S = min(max_len, cfg.window) if cfg.window else max_len
    shape = (cfg.n_layers, batch, S, cfg.n_kv_heads, hd)
    axes = ("layers", "cbatch", "cseq", "kv_heads", "head")
    out = {"k": ParamMeta(shape, axes, "zeros"),
           "v": ParamMeta(shape, axes, "zeros"),
           "pos": pos}
    if cfg.family == "encdec":
        cross = ParamMeta((cfg.n_layers, batch, cfg.n_frames, cfg.n_kv_heads, hd),
                          ("layers", "cbatch", "frames", "kv_heads", "head"), "zeros")
        out["cross_k"] = out["cross_v"] = cross
    return out


def zeros_cache(metas: dict, dtype: torch.dtype, device) -> dict:
    """A cache of zeros from its meta tree: the SSD state ``s`` in f32 (as
    ``ssd_scan`` returns it), ``pos`` the int 0, every other leaf in
    ``dtype``."""
    def one(name, m):
        if not m.shape:
            return 0
        return torch.zeros(m.shape, dtype=torch.float32 if name == "s" else dtype,
                           device=device)
    return {k: zeros_cache(v, dtype, device) if isinstance(v, dict) else one(k, v)
            for k, v in metas.items()}


def _ssm_cache_layers(cache, cfg):
    """Per-block views of an SSM or hybrid cache, in the order of ``_layers``:
    a Mamba2 block's states {"s", "conv_x", "conv_B", "conv_C"}, and a shared
    block's (k, v) of its group."""
    if cfg.family == "ssm":
        states = {k: v for k, v in cache.items() if k != "pos"}
        return [layer_params(states, i) for i in range(cfg.n_layers)]
    out = []
    for gi in range(cfg.n_layers // cfg.attn_every):
        gst = layer_params(cache["groups"], gi)
        out += [layer_params(gst, li) for li in range(cfg.attn_every)]
        out.append((cache["shared_k"][gi], cache["shared_v"][gi]))
    if "tail" in cache:
        out += [layer_params(cache["tail"], li) for li in range(cache["tail"]["s"].shape[0])]
    return out


def _set_ssm_states(st, s, conv):
    """Write a Mamba2 block's new states into its cache views ``st``."""
    st["s"].copy_(s["s"])
    for k in ("x", "B", "C"):
        st[f"conv_{k}"].copy_(conv[k])


# ---------------------------------------------------------------------------
# Decode / prefill
# ---------------------------------------------------------------------------

def decode_lm(params, cache, tokens, cfg: ModelConfig):
    """One decode step.  tokens (B, 1) -> (logits (B, 1, V), cache).  The
    cache's buffers (k/v; SSD and conv states) are updated in place and
    returned with pos + 1."""
    pos = int(cache["pos"])
    positions = _layer_positions(cfg, tokens, offset=pos)
    x = embed_lookup(params["embed"], tokens).to(_dtype(cfg))
    if cfg.family in ("ssm", "hybrid"):
        views = _ssm_cache_layers(cache, cfg)
    else:
        views = [(cache["k"][i], cache["v"][i]) for i in range(cfg.n_layers)]
    for (kind, p), view in zip(_layers(params, cfg), views):
        if kind == "ssm":
            x, (s, conv) = ssm_block(p, x, cfg, state=view, conv={
                k: view[f"conv_{k}"] for k in ("x", "B", "C")})
            _set_ssm_states(view, s, conv)
        else:
            x, _, _ = dense_block(p, x, positions, cfg, cache=view, pos=pos)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = lm_logits(params, x, cfg)
    return logits, {**cache, "pos": pos + 1}


def prefill_lm(params, tokens, cfg: ModelConfig, *, mrope=None,
               max_len: int | None = None):
    """Prefill: forward over the prompt, returning last-position logits + a
    cache positioned at S, ready for decode.  The cache holds ``max_len``
    (>= S) positions, except with a sliding window and S >= window: then it
    is the rolling cache of ``window`` slots, the last ``window`` positions
    at slot ``pos % window`` (the reference's rule).  ``mrope``: the VLM's
    (3, B, S) positions; decode goes on from the cache position, broadcast
    to the three streams, as in the reference (ROADMAP C8)."""
    B, S = tokens.shape
    max_len = max(max_len or S, S)
    dtype = _dtype(cfg)
    positions = _layer_positions(cfg, tokens, mrope=mrope)
    x = embed_lookup(params["embed"], tokens).to(dtype)
    if cfg.family in ("ssm", "hybrid"):
        return _prefill_ssm(params, x, positions, cfg, max_len)
    Sc = min(S, cfg.window) if cfg.window else S
    rolling = bool(cfg.window) and Sc == cfg.window
    shape = (cfg.n_layers, B, Sc if rolling else max_len, cfg.n_kv_heads, cfg.head_dim_)
    ks = torch.zeros(shape, dtype=dtype, device=x.device)
    vs = torch.zeros(shape, dtype=dtype, device=x.device)
    slots = torch.arange(S - Sc, S, device=x.device) % Sc if rolling else None
    for i in range(cfg.n_layers):
        x, k, v = _prefill_block(layer_params(params["blocks"], i), x, positions, cfg)
        # written in place where the reference pads k/v out to max_len (or
        # scatters the last window into a new rolling cache)
        if rolling:
            ks[i][:, slots] = k[:, -Sc:]
            vs[i][:, slots] = v[:, -Sc:]
        else:
            ks[i, :, :S] = k
            vs[i, :, :S] = v
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = lm_logits(params, x[:, -1:], cfg)
    return logits, {"k": ks, "v": vs, "pos": S}


def _prefill_ssm(params, x, positions, cfg: ModelConfig, max_len: int):
    """``prefill_lm`` of the SSM and hybrid families: each Mamba2 block's SSD
    state (f32) and last W - 1 pre-conv projections, and each shared block's
    k/v in a linear cache of ``max_len`` positions, written in place into a
    cache of zeros (the reference pads k/v out to max_len)."""
    B, S = x.shape[:2]
    cache = zeros_cache(cache_metas(cfg, B, max_len), x.dtype, x.device)
    cache["pos"] = S
    for (kind, p), view in zip(_layers(params, cfg), _ssm_cache_layers(cache, cfg)):
        if kind == "ssm":
            x, s, conv = ssm_prefill_block(p, x, cfg)
            _set_ssm_states(view, s, conv)
        else:
            x, k, v = _prefill_block(p, x, positions, cfg)
            view[0][:, :S] = k
            view[1][:, :S] = v
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return lm_logits(params, x[:, -1:], cfg), cache
