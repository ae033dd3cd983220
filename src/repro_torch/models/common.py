"""Shared model machinery: parameter metadata, init, sharding rule, norms,
RoPE and M-RoPE.

Counterpart of ``repro/models/common.py:24-57, 121-210``.  Parameters are
plain nested dicts of tensors with the reference's tree layout, so weights
carry across one for one (``repro_torch.convert``).  A parallel tree of
:class:`ParamMeta` gives shapes, logical axes and initializers.

Of the reference's logical-axis rules (``make_rules``, ``spec_tree``) the
port keeps the one that shards parameters over a mesh of ranks: ZeRO-3's
``"embed" -> "data"`` (:func:`make_rules`, :func:`fsdp_dim`).  The rest place
tensors over a TPU's "model" axis, which the port does not have.
"""
from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Any, Callable

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class ParamMeta:
    shape: tuple[int, ...]
    axes: tuple[str | None, ...]          # logical axis name per dim
    init: str = "normal"                  # normal | zeros | ones
    scale: float | None = None            # stddev; None -> 1/sqrt(fan_in)

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)


def tree_map_meta(fn: Callable[[ParamMeta], Any], tree):
    """Map ``fn`` over the ParamMeta leaves of a nested dict, keys in sorted
    order (the reference's flattening order)."""
    if isinstance(tree, ParamMeta):
        return fn(tree)
    return {k: tree_map_meta(fn, tree[k]) for k in sorted(tree)}


def meta_leaves(tree) -> list[ParamMeta]:
    out: list[ParamMeta] = []
    tree_map_meta(out.append, tree)
    return out


# A leaf whose f32 draw would take more than this is drawn one slice of its
# leading dim (a layer) at a time, into its output.  deepseek-coder-33b's
# stacked w1 (62, 7168, 19200) would take 34 GB; no leaf of the earlier
# served and trained configs comes near it (mixtral's largest, 15 GB).
WHOLE_DRAW_BYTES = 16 * 2**30


def init_params(generator: torch.Generator, metas, dtype=torch.float32):
    """Materialize a parameter tree from its metadata tree, on the
    generator's device.  The numbers differ from the reference's
    ``jax.random`` ones; tests carry the reference's weights across instead.

    A leaf is drawn whole in f32 and scaled in place (one f32 transient the
    leaf's size), or, past ``WHOLE_DRAW_BYTES``, one leading slice at a
    time (a transient of one slice): the cast result is the only
    leaf-sized tensor."""
    device = generator.device

    def init_one(m: ParamMeta):
        if m.init == "zeros":
            return torch.zeros(m.shape, dtype=dtype, device=device)
        if m.init == "ones":
            return torch.ones(m.shape, dtype=dtype, device=device)
        fan_in = m.shape[0] if len(m.shape) > 1 else m.shape[-1]
        scale = m.scale if m.scale is not None else 1.0 / np.sqrt(max(fan_in, 1))
        if len(m.shape) > 1 and 4 * math.prod(m.shape) > WHOLE_DRAW_BYTES:
            out = torch.empty(m.shape, dtype=dtype, device=device)
            for i in range(m.shape[0]):
                out[i] = torch.randn(m.shape[1:], generator=generator,
                                     dtype=torch.float32, device=device).mul_(scale)
            return out
        w = torch.randn(m.shape, generator=generator, dtype=torch.float32,
                        device=device)
        return w.mul_(scale).to(dtype)

    return tree_map_meta(init_one, metas)


# ---------------------------------------------------------------------------
# ZeRO-3 sharding rule
# ---------------------------------------------------------------------------

def make_rules(zero_stage: int, data_size: int) -> dict:
    """The reference's logical->mesh rules (``make_rules``) reduced to the
    parameter sharding of a mesh of ranks: under ZeRO-3 the ``"embed"`` dims
    go to the ``"data"`` axis (``data_size`` ranks), else nothing is
    sharded."""
    return {"_axis_sizes": {"data": data_size},
            "embed": "data" if zero_stage >= 3 else None}


def fsdp_dim(m: ParamMeta, rules: dict) -> int | None:
    """The dim of a leaf sharded over ``"data"`` under ``rules``: its first
    dim whose logical axis maps there and whose size the axis divides (the
    reference's ``spec_tree`` replicates a dim it cannot split evenly), or
    None for a replicated leaf."""
    n = rules["_axis_sizes"].get("data", 1)
    for i, (size, ax) in enumerate(zip(m.shape, m.axes)):
        if ax is not None and rules.get(ax) == "data" and size % n == 0:
            return i
    return None


def fsdp_dims(metas, rules: dict) -> list:
    """``fsdp_dim`` of every leaf of ``metas``, in flatten order."""
    return [fsdp_dim(m, rules) for m in meta_leaves(metas)]


def shard_leaf(p, dim: int | None, index: int, n: int):
    """Rank ``index`` of ``n``'s shard of a full leaf: its ``index``-th of
    ``n`` equal slices along ``dim`` (a copy), or the leaf itself where
    ``dim`` is None (replicated)."""
    return p if dim is None else p.chunk(n, dim)[index].clone()


# ---------------------------------------------------------------------------
# Norms / embeddings / RoPE
# ---------------------------------------------------------------------------

def rms_norm(x, scale, eps=1e-5):
    """f32 statistics and scaling, result cast back to x.dtype."""
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    out = x32 * torch.rsqrt(var + eps) * scale.float()
    return out.to(x.dtype)


def layer_norm(x, scale, bias, eps=1e-5):
    """f32 statistics (the population variance, as ``jnp.var``), scale and
    shift; result cast back to x.dtype."""
    x32 = x.float()
    mu = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.var(x32, dim=-1, keepdim=True, unbiased=False)
    out = (x32 - mu) * torch.rsqrt(var + eps) * scale.float() + bias.float()
    return out.to(x.dtype)


def embed_lookup(table, tokens):
    return table[tokens]


def rope_freqs(head_dim: int, theta: float, device=None):
    """(head_dim/2,) f32 inverse frequencies, computed on ``device`` so that no
    host-to-device copy (and with it no stream synchronisation) sits on the
    per-layer path."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exps)


def mrope_pair_positions(positions, sections: tuple[int, ...], head_dim: int):
    """M-RoPE's (3, B, S) stream positions (temporal, height, width) as the
    (B, S, head_dim/2) position of each frequency pair, read from the stream
    that owns it (``sections`` pairs each, in order; their sum is
    head_dim/2).  The stream index is built on the positions' device, as
    the frequencies are.  A forward takes it once for all its layers."""
    assert sum(sections) == head_dim // 2, (sections, head_dim)
    pair = torch.arange(head_dim // 2, device=positions.device)
    stream = torch.zeros_like(pair)                                 # stream of each pair
    for start in itertools.accumulate(sections[:-1]):
        stream += pair >= start
    return positions.movedim(0, -1)[..., stream]


def apply_rope(x, positions, theta: float, sections: tuple[int, ...] = (),
               pairwise: bool = False):
    """Rotary embedding, split-half convention.

    x: (..., S, H, hd); positions: (..., S) int, or with ``sections``
    (M-RoPE, qwen2-vl) (3, B, S): the temporal, height and width streams
    (``mrope_pair_positions``), or with ``pairwise`` already one position
    per frequency pair, (..., S, hd/2).  The product with the f32 sin/cos
    is taken in f32 and cast back to x.dtype, as in the reference (there JAX
    promotes bf16 * f32 to f32; torch promotes the same way, and the
    explicit ``float()`` states it).
    """
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)                         # (hd/2,)
    if sections:
        positions, pairwise = mrope_pair_positions(positions, sections, hd), True
    if pairwise:
        angles = positions.float() * freqs                          # (..., S, hd/2)
    else:
        angles = positions.float()[..., None] * freqs               # (..., S, hd/2)
    angles = angles[..., None, :]                                   # broadcast over heads
    sin, cos = torch.sin(angles), torch.cos(angles)
    x1, x2 = x[..., : hd // 2].float(), x[..., hd // 2:].float()
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)
