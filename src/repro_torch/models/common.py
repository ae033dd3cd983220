"""Shared model machinery: parameter metadata, init, norms, RoPE.

Counterpart of ``repro/models/common.py:24-57, 162-210``.  Parameters are
plain nested dicts of tensors with the reference's tree layout, so weights
carry across one for one (``repro_torch.convert``).  A parallel tree of
:class:`ParamMeta` gives shapes and initializers.

No sharding layer: the reference's logical-axis rules (``make_rules``,
``spec_tree``, ``Ctx.wsc``) place tensors on a TPU mesh and mean nothing on
one card, so they are not ported; ``ParamMeta.axes`` is kept as a label.
"""
from __future__ import annotations

import dataclasses
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


def init_params(generator: torch.Generator, metas, dtype=torch.float32):
    """Materialize a parameter tree from its metadata tree, on the
    generator's device.  The numbers differ from the reference's
    ``jax.random`` ones; tests carry the reference's weights across instead."""
    device = generator.device

    def init_one(m: ParamMeta):
        if m.init == "zeros":
            return torch.zeros(m.shape, dtype=dtype, device=device)
        if m.init == "ones":
            return torch.ones(m.shape, dtype=dtype, device=device)
        fan_in = m.shape[0] if len(m.shape) > 1 else m.shape[-1]
        scale = m.scale if m.scale is not None else 1.0 / np.sqrt(max(fan_in, 1))
        w = torch.randn(m.shape, generator=generator, dtype=torch.float32,
                        device=device)
        return (w * scale).to(dtype)

    return tree_map_meta(init_one, metas)


# ---------------------------------------------------------------------------
# Norms / embeddings / RoPE
# ---------------------------------------------------------------------------

def rms_norm(x, scale, eps=1e-5):
    """f32 statistics and scaling, result cast back to x.dtype."""
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    out = x32 * torch.rsqrt(var + eps) * scale.float()
    return out.to(x.dtype)


def embed_lookup(table, tokens):
    return table[tokens]


def rope_freqs(head_dim: int, theta: float, device=None):
    """(head_dim/2,) f32 inverse frequencies, computed on ``device`` so that no
    host-to-device copy (and with it no stream synchronisation) sits on the
    per-layer path."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x, positions, theta: float):
    """Rotary embedding, split-half convention.

    x: (..., S, H, hd); positions: (..., S) int.  The product with the f32
    sin/cos is taken in f32 and cast back to x.dtype, as in the reference
    (there JAX promotes bf16 * f32 to f32; torch promotes the same way, and
    the explicit ``float()`` states it).  M-RoPE (qwen2-vl) waits for the VLM
    slice.
    """
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)                         # (hd/2,)
    angles = positions.float()[..., None] * freqs                   # (..., S, hd/2)
    angles = angles[..., None, :]                                   # broadcast over heads
    sin, cos = torch.sin(angles), torch.cos(angles)
    x1, x2 = x[..., : hd // 2].float(), x[..., hd // 2:].float()
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)
