"""Model registry: one interface over every family of the reference.

Counterpart of ``repro/models/registry.py:24-113``.  ``build(cfg)`` gives a
:class:`Model` with ``abstract_params`` / ``init`` / ``n_params`` /
``loss`` / ``prefill`` / ``decode`` / ``cache_metas``.  There is no sharding
context: the reference's ``ctx`` arguments place tensors on a mesh, and one
card has none; ZeRO-3's parameter sharding comes to ``loss`` as an
``FsdpScope`` and its rules.  The encoder-decoder's batch carries
``frames`` (B, n_frames, d_model), the VLM's may carry ``mrope`` (3, B, S).
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import encdec as encdec_mod
from repro_torch.models import transformer as tf
from repro_torch.models.common import init_params, meta_leaves

# the stacked (and shared) block trees: gathered per block inside the forward
_SCANNED_KEYS = frozenset({"blocks", "groups", "tail", "shared", "enc_blocks",
                           "dec_blocks"})


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig

    def abstract_params(self):
        if self.cfg.family == "encdec":
            return encdec_mod.abstract_params(self.cfg)
        return tf.abstract_params(self.cfg)

    def init(self, generator: torch.Generator, dtype: torch.dtype | None = None):
        """Random weights on the generator's device, in ``cfg.dtype`` unless
        ``dtype`` says otherwise."""
        dtype = dtype or getattr(torch, self.cfg.dtype)
        return init_params(generator, self.abstract_params(), dtype)

    def n_params(self) -> int:
        return sum(math.prod(m.shape) for m in meta_leaves(self.abstract_params()))

    def _gather_top(self, params, fsdp, rules):
        """ZeRO-3: gather the leaves outside the stacked blocks (embedding,
        final norm, head; the encoder-decoder's ``pos_embed`` on its dim 1,
        ``enc_norm(_b)`` and ``final_norm_b`` too) over "data" before use."""
        if fsdp is None:
            return params
        top = {k: v for k, v in self.abstract_params().items() if k not in _SCANNED_KEYS}
        gplan = tf.gather_plan_of(top, rules, scanned=False)
        return {**params, **tf.maybe_gather({k: params[k] for k in top}, gplan, fsdp)}

    def loss(self, params, batch, *, remat: bool = False, fsdp=None, rules=None):
        """(sum of token CE losses, token count, aux) for ``batch`` with
        "tokens" and "labels" (B, S) and an optional f32 "mask"; aux is the
        forward's MoE aux losses (0 for the other families).  ``remat``:
        activation checkpointing per block.  ``fsdp`` and ``rules``: ZeRO-3
        (``params`` are this rank's shards; ``forward_lm``, ``encdec.forward``)."""
        params = self._gather_top(params, fsdp, rules)
        if self.cfg.family == "encdec":
            hidden, aux = encdec_mod.forward(params, batch, self.cfg, remat=remat, fsdp=fsdp,
                                             rules=rules)
        else:
            hidden, aux = tf.forward_lm(params, batch["tokens"], self.cfg,
                                        mrope=batch.get("mrope"), remat=remat,
                                        fsdp=fsdp, rules=rules)
        mask = batch.get("mask")
        if mask is None:
            mask = torch.ones(batch["labels"].shape, dtype=torch.float32,
                              device=hidden.device)
        loss_sum, count = tf.lm_loss_from_hidden(params, hidden, batch["labels"],
                                                 mask, self.cfg, remat=remat)
        return loss_sum, count, aux

    def prefill(self, params, batch, max_len: int | None = None):
        if self.cfg.family == "encdec":
            return encdec_mod.prefill(params, batch, self.cfg, max_len=max_len)
        return tf.prefill_lm(params, batch["tokens"], self.cfg, mrope=batch.get("mrope"),
                             max_len=max_len)

    def decode(self, params, cache, tokens):
        if self.cfg.family == "encdec":
            return encdec_mod.decode_step(params, cache, tokens, self.cfg)
        return tf.decode_lm(params, cache, tokens, self.cfg)

    def cache_metas(self, batch: int, max_len: int):
        return tf.cache_metas(self.cfg, batch, max_len)


def build(cfg: ModelConfig) -> Model:
    tf.check_supported(cfg)
    return Model(cfg)
