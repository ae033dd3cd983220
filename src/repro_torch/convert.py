"""Carry weights from the JAX package's parameter tree into the port.

The port keeps the reference's tree layout one for one, so the conversion is
a leaf-by-leaf copy: ``embed (V, D)``, ``final_norm (D,)``,
``lm_head (D, V)``, ``blocks.{ln1, ln2} (L, D)``,
``blocks.attn.{wq, wk, wv} (L, D, H, hd)``, ``blocks.attn.wo (L, Hq, hd, D)``,
and the FFN: dense ``blocks.mlp.{w1, w3} (L, D, F)``, ``blocks.mlp.w2
(L, F, D)``, or MoE ``blocks.moe.router (L, D, E)``, ``blocks.moe.{w1, w3}
(L, E, D, F)``, ``blocks.moe.w2 (L, E, F, D)``; SSM ``blocks.{ln, w_z, w_x,
w_B, w_C, w_dt, conv_x, conv_B, conv_C, A_log, dt_bias, D, gnorm, out_proj}``
stacked over (L,); hybrid the same Mamba2 leaves under ``groups``
(n_groups, attn_every, ...) and ``tail`` (n_layers % attn_every, ...), and
the unstacked shared block ``shared.{ln1, ln2} (D,)``, ``shared.attn``,
``shared.mlp``.  With ``metas`` every key and shape of the tree is checked
against the port's, whatever the family.  The input
is a nested dict of numpy arrays (``jax.tree.map(np.asarray, params)`` on the
JAX side); this module imports nothing of JAX.

ZeRO-3 keeps each rank's shard of the leaves whose "embed" dim splits over
"data": :func:`shard_params` cuts a full tree into a rank's shards (what the
trainer's init does), :func:`unshard_params` rebuilds full leaves from the
shards of the "data" ranks, to hold a ZeRO-3 state against a gathered one
(the JAX trainer's state, read through its global shardings, is gathered).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.tree import flatten
from repro_torch.models.common import ParamMeta, fsdp_dims, make_rules, shard_leaf


def _to_tensor(a: np.ndarray) -> torch.Tensor:
    a = np.array(a, copy=True, order="C")     # own, writable memory
    if a.dtype.name == "bfloat16":            # ml_dtypes' bfloat16: same bits
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def params_from_jax(tree, *, metas=None):
    """Nested dict of numpy arrays -> nested dict of CPU tensors, dtypes kept.

    metas: the port's ``abstract_params`` tree; when given, keys and shapes
    must match it exactly.
    """
    def conv(node, meta, path):
        if isinstance(node, dict):
            if meta is not None and (not isinstance(meta, dict)
                                     or sorted(meta) != sorted(node)):
                raise ValueError(f"{path or 'root'}: keys {sorted(node)} do "
                                 f"not match the port's tree")
            return {k: conv(node[k], None if meta is None else meta[k],
                            f"{path}.{k}" if path else k)
                    for k in node}
        t = _to_tensor(np.asarray(node))
        if meta is not None and (not isinstance(meta, ParamMeta)
                                 or tuple(t.shape) != meta.shape):
            raise ValueError(f"{path}: shape {tuple(t.shape)} does not match "
                             f"the port's {getattr(meta, 'shape', meta)}")
        return t

    return conv(tree, metas, "")


def shard_params(params, metas, index: int, n_data: int):
    """"data" rank ``index`` of ``n_data``'s ZeRO-3 shards of a full tree."""
    ps, rebuild = flatten(params)
    return rebuild([shard_leaf(p, d, index, n_data)
                    for p, d in zip(ps, fsdp_dims(metas, make_rules(3, n_data)))])


def unshard_params(shards, metas):
    """Full leaves from the ZeRO-3 shards of every "data" rank (``shards``:
    one tree per rank, in "data" order): sharded leaves concatenated along
    their dim, replicated ones taken from the first rank."""
    flat = [flatten(t)[0] for t in shards]
    _, rebuild = flatten(shards[0])
    dims = fsdp_dims(metas, make_rules(3, len(shards)))
    return rebuild([parts[0] if d is None else torch.cat(parts, d)
                    for d, parts in zip(dims, zip(*flat))])
