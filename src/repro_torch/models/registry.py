"""Model registry: one interface over the families the port serves.

Counterpart of ``repro/models/registry.py:24-113``.  ``build(cfg)`` gives a
:class:`Model` with ``abstract_params`` / ``init`` / ``n_params`` /
``loss`` / ``prefill`` / ``decode`` / ``cache_metas``.  There is no sharding
context: the reference's ``ctx`` arguments place tensors on a mesh, and one
card has none.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as tf
from repro_torch.models.common import init_params, meta_leaves


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig

    def abstract_params(self):
        return tf.abstract_params(self.cfg)

    def init(self, generator: torch.Generator, dtype: torch.dtype | None = None):
        """Random weights on the generator's device, in ``cfg.dtype`` unless
        ``dtype`` says otherwise."""
        dtype = dtype or getattr(torch, self.cfg.dtype)
        return init_params(generator, self.abstract_params(), dtype)

    def n_params(self) -> int:
        return sum(math.prod(m.shape) for m in meta_leaves(self.abstract_params()))

    def loss(self, params, batch, *, remat: bool = False):
        """(sum of token CE losses, token count, aux) for ``batch`` with
        "tokens" and "labels" (B, S) and an optional f32 "mask"; aux is the
        forward's MoE aux losses (0 for the dense family).  ``remat``:
        activation checkpointing per block."""
        hidden, aux = tf.forward_lm(params, batch["tokens"], self.cfg, remat=remat)
        mask = batch.get("mask")
        if mask is None:
            mask = torch.ones(batch["labels"].shape, dtype=torch.float32,
                              device=hidden.device)
        loss_sum, count = tf.lm_loss_from_hidden(params, hidden, batch["labels"],
                                                 mask, self.cfg, remat=remat)
        return loss_sum, count, aux

    def prefill(self, params, batch, max_len: int | None = None):
        return tf.prefill_lm(params, batch["tokens"], self.cfg, max_len=max_len)

    def decode(self, params, cache, tokens):
        return tf.decode_lm(params, cache, tokens, self.cfg)

    def cache_metas(self, batch: int, max_len: int):
        return tf.cache_metas(self.cfg, batch, max_len)


def build(cfg: ModelConfig) -> Model:
    tf.check_supported(cfg)
    return Model(cfg)
