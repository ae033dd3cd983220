"""Serving on one card: prefill/decode programs and a fixed-slot batcher.

Counterpart of ``repro/serve/engine.py:49-157``.  The reference compiles
pjit programs with shardings over a mesh; serving has no cross-pod
collectives, so on one card the programs reduce to the model's eager prefill
and decode under ``torch.inference_mode``, and ``serve_rules`` has nothing
to place.  The :class:`Batcher` keeps the reference's left padding and dummy
slots, and the VLM's text-only M-RoPE positions (``arange`` broadcast to
three streams).

Departure (ROADMAP C8, DESIGN_TORCH.md §26): the reference's ``Batcher``
builds no ``frames`` leaf, so it cannot serve the encoder-decoder (its
prefill reads ``batch["frames"]``).  The port's :class:`Request` carries an
optional ``frames`` (n_frames, d_model), which the batcher stacks for an
``encdec`` model (zeros for a dummy slot); a request without them raises a
``ValueError`` naming ``frames``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.core.device import resolve_device
from repro_torch.models import Model
from repro_torch.models.transformer import zeros_cache


@dataclasses.dataclass
class ServePrograms:
    model: Model
    device: torch.device
    prefill_fn: Callable[[Any, dict], tuple]
    decode_fn: Callable[[Any, dict, torch.Tensor], tuple]

    def init_cache(self, batch: int, max_len: int) -> dict:
        """Zeros over the model's (possibly nested) cache metas: f32 for the
        SSD state ``s``, the int 0 for ``pos``, ``cfg.dtype`` elsewhere."""
        return zeros_cache(self.model.cache_metas(batch, max_len),
                           getattr(torch, self.model.cfg.dtype), self.device)


def make_serve_programs(model: Model, seq_len: int, max_len: int | None = None,
                        device="cuda") -> ServePrograms:
    device = resolve_device(device)
    max_len = max_len or seq_len

    @torch.inference_mode()
    def prefill_fn(params, batch):
        return model.prefill(params, batch, max_len=max_len)

    @torch.inference_mode()
    def decode_fn(params, cache, tokens):
        return model.decode(params, cache, tokens)

    return ServePrograms(model=model, device=device, prefill_fn=prefill_fn,
                         decode_fn=decode_fn)


# ---------------------------------------------------------------------------
# A minimal continuous batcher (example-level serving loop)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray          # (S,) int32
    max_new: int
    out: list = dataclasses.field(default_factory=list)
    frames: Any = None          # (n_frames, d_model) frame embeddings (encdec)


class Batcher:
    """Fixed-slot batcher: pads prompts to a common length, prefills the
    batch, then decodes greedily until every request hits max_new."""

    def __init__(self, progs: ServePrograms, params, batch_slots: int,
                 prompt_len: int, max_len: int):
        self.p = progs
        self.params = params
        self.slots = batch_slots
        self.prompt_len = prompt_len
        self.max_len = max_len

    def _frames(self, group: list[Request]) -> torch.Tensor:
        """The group's frames stacked (slots, n_frames, d_model) on the
        card; a dummy slot's are zeros."""
        cfg, dev = self.p.model.cfg, self.p.device
        shape = (cfg.n_frames, cfg.d_model)
        out = []
        for r in group:
            if r.uid < 0:
                out.append(torch.zeros(shape, device=dev))
                continue
            if r.frames is None:
                raise ValueError(f"request {r.uid}: an encoder-decoder request needs its "
                                 f"frames {shape}")
            f = torch.as_tensor(r.frames)
            if tuple(f.shape) != shape:
                raise ValueError(f"request {r.uid}: frames of shape {tuple(f.shape)}, "
                                 f"expected {shape}")
            out.append(f.to(dev, torch.float32))
        return torch.stack(out)

    def run(self, requests: list[Request]) -> list[Request]:
        done: list[Request] = []
        family = self.p.model.cfg.family
        for i in range(0, len(requests), self.slots):
            group = requests[i:i + self.slots]
            while len(group) < self.slots:
                group.append(Request(-1, np.zeros(1, np.int32), 1))
            toks = np.zeros((self.slots, self.prompt_len), np.int64)
            for j, r in enumerate(group):
                s = min(len(r.prompt), self.prompt_len)
                toks[j, -s:] = r.prompt[:s]
            batch = {"tokens": torch.as_tensor(toks, device=self.p.device)}
            if family == "vlm":         # text-only positions on three streams
                pos = torch.arange(self.prompt_len, device=self.p.device)
                batch["mrope"] = pos[None, None].expand(3, self.slots, self.prompt_len)
            elif family == "encdec":
                batch["frames"] = self._frames(group)
            logits, cache = self.p.prefill_fn(self.params, batch)
            cur = logits[:, -1].argmax(-1)[:, None]
            n_new = max(r.max_new for r in group)
            for _ in range(n_new):
                cur_host = cur[:, 0].tolist()
                for j, r in enumerate(group):
                    if len(r.out) < r.max_new:
                        r.out.append(cur_host[j])
                logits, cache = self.p.decode_fn(self.params, cache, cur)
                cur = logits[:, -1].argmax(-1)[:, None]
            done.extend(r for r in group if r.uid >= 0)
        return done
