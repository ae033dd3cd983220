"""Deterministic, shardable synthetic data with balancer-aware shares.

Counterpart of ``repro/data/pipeline.py``; the module is jax-free there, and
the port keeps its own copy, so the tokens of a (seed, step) are the same
numbers in both packages.  Batches are (n_micro, global_micro_batch, seq)
int32 token/label arrays; the global micro-batch dim is split over the DP
ranks pod-major (rank r takes rows ``r * micro_batch`` up to the next
rank's), so the rows of an island's masked micro-steps are exactly the rows
the plan's live mask zeroes out.

Every token is a pure function of (seed, step, row, position), so a restart
replays the identical stream.  A background thread keeps batches ahead.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Iterator

import numpy as np

from repro_torch.core.balance import HetPlan


def synthetic_batch(seed: int, step: int, n_micro: int, global_mb: int,
                    seq: int, vocab: int, extra: dict | None = None) -> dict:
    """Deterministic pseudo-text: a per-row splitmix-style stream (fast,
    seekable), numpy arrays."""
    rows = n_micro * global_mb
    with np.errstate(over="ignore"):              # intended u64 wraparound
        base = np.uint64(seed) * np.uint64(0x9E3779B97F4A7C15) + np.uint64(step + 1)
        row_keys = (np.arange(rows, dtype=np.uint64) + np.uint64(1)) * np.uint64(
            0xBF58476D1CE4E5B9) + base
        pos = np.arange(seq + 1, dtype=np.uint64)
        z = row_keys[:, None] + pos[None, :] * np.uint64(0x94D049BB133111EB)
        z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        z = z ^ (z >> np.uint64(31))
        toks = (z % np.uint64(vocab)).astype(np.int32)
    tokens = toks[:, :-1].reshape(n_micro, global_mb, seq)
    labels = toks[:, 1:].reshape(n_micro, global_mb, seq)
    out = {"tokens": tokens, "labels": labels}
    if extra:
        out.update(extra)
    return out


@dataclasses.dataclass
class DataPipeline:
    """Balancer-aware synthetic pipeline with prefetch and exact resume."""

    seed: int
    plan: HetPlan
    dp_world: int
    seq_len: int
    vocab: int
    prefetch: int = 2

    def batch_at(self, step: int) -> dict:
        return synthetic_batch(self.seed, step, self.plan.n_micro_max,
                               self.plan.micro_batch * self.dp_world,
                               self.seq_len, self.vocab)

    def iter_from(self, start_step: int) -> Iterator[tuple[int, dict]]:
        """Prefetching iterator starting at ``start_step`` (resume point)."""
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def producer():
            s = start_step
            while not stop.is_set():
                try:
                    q.put((s, self.batch_at(s)), timeout=0.5)
                    s += 1
                except queue.Full:
                    continue

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                yield q.get()
        finally:
            stop.set()

    def tokens_per_step(self) -> int:
        """Live tokens per optimizer step (masked micro-steps excluded)."""
        return self.plan.total_micro * self.plan.micro_batch * self.seq_len * \
            (self.dp_world // len(self.plan.micro_per_pod))
