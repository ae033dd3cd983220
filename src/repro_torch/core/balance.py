"""Workload balancing across islands (paper §4.5, Appendix F.2).

Counterpart of ``repro/core/balance.py:31-141``; the module is jax-free
there, and the port keeps its own copy.  Each island gets
a share of micro-steps proportional to its profiled throughput,
``b_i = B * s_i / sum_j s_j``.  Every rank runs ``n_micro_max`` micro-steps of
one shape, and an island with a smaller share masks its trailing
micro-steps; gradients are weighted by true token counts, so the math is the
paper's weighted data parallelism.

:func:`plan_from_cluster` seeds the split from the topology model's
effective FLOP/s, :func:`profile_throughput` measures an island's tokens/s in
a short profiling run, and :func:`imbalance` scores a plan's straggler
factor.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Sequence

import numpy as np

from repro_torch.core.topology import ClusterSpec


@dataclasses.dataclass(frozen=True)
class PodProfile:
    """Measured throughput of one island; only ratios between islands
    matter to the balancer."""

    name: str
    tokens_per_s: float
    n_devices: int = 1


@dataclasses.dataclass(frozen=True)
class HetPlan:
    """A balanced micro-batch assignment.

    micro_per_pod[i]  -- live micro-steps island i runs per step,
    n_micro_max       -- uniform loop length (= max over islands),
    weights[i]        -- island i's fraction of the global batch processed.
    """

    pod_names: tuple[str, ...]
    micro_per_pod: tuple[int, ...]
    n_micro_max: int
    micro_batch: int              # per-rank micro-batch size (uniform)

    @property
    def weights(self) -> tuple[float, ...]:
        tot = sum(self.micro_per_pod)
        return tuple(m / tot for m in self.micro_per_pod)

    def live_mask(self) -> np.ndarray:
        """(n_pods, n_micro_max) 0/1 mask of live micro-steps."""
        m = np.zeros((len(self.micro_per_pod), self.n_micro_max), np.float32)
        for i, k in enumerate(self.micro_per_pod):
            m[i, :k] = 1.0
        return m

    @property
    def total_micro(self) -> int:
        return sum(self.micro_per_pod)


def make_plan(profiles: Sequence[PodProfile], total_micro: int,
              micro_batch: int, min_per_pod: int = 1) -> HetPlan:
    """Proportional micro-batch split with largest-remainder rounding to
    whole micro-batches; ``sum(micro_per_pod) == total_micro`` whenever
    ``total_micro >= n_pods * min_per_pod``.

        make_plan([PodProfile("nvidia", 2.0), PodProfile("amd", 1.0)],
                  total_micro=12, micro_batch=1).micro_per_pod    # (8, 4)
    """
    speeds = np.array([p.tokens_per_s for p in profiles], np.float64)
    if speeds.sum() <= 0:
        raise ValueError("profiles must have positive throughput")
    ideal = total_micro * speeds / speeds.sum()
    base = np.maximum(np.floor(ideal).astype(int), min_per_pod)
    # shrink the most-overshooting island that is still above the minimum
    while base.sum() > total_micro:
        cand = [i for i in range(len(base)) if base[i] > min_per_pod]
        if not cand:
            break                      # total < n_pods * min: keep minimums
        i = cand[int(np.argmax((base - ideal)[cand]))]
        base[i] -= 1
    rem = total_micro - base.sum()
    if rem > 0:
        order = np.argsort(-(ideal - base))
        for i in order[:rem]:
            base[i] += 1
    return HetPlan(
        pod_names=tuple(p.name for p in profiles),
        micro_per_pod=tuple(int(b) for b in base),
        n_micro_max=int(base.max()),
        micro_batch=micro_batch,
    )


def uniform_plan(n_pods: int, total_micro: int, micro_batch: int,
                 names: Sequence[str] | None = None) -> HetPlan:
    """``total_micro`` split evenly over ``n_pods`` (requires divisibility):
    the unbalanced baseline."""
    if total_micro % n_pods:
        raise ValueError(f"{total_micro} micro-steps do not split evenly "
                         f"over {n_pods} pods")
    k = total_micro // n_pods
    return HetPlan(
        pod_names=tuple(names or (f"pod{i}" for i in range(n_pods))),
        micro_per_pod=(k,) * n_pods,
        n_micro_max=k,
        micro_batch=micro_batch,
    )



def plan_from_cluster(cluster: ClusterSpec, total_micro: int,
                      micro_batch: int) -> HetPlan:
    """:func:`make_plan` seeded from the topology model instead of a
    measured profile: each island's speed is its modeled effective FLOP/s
    (``topology.PodSpec.effective_flops``), the pre-profiling default the
    plan autotuner also starts from (``repro_torch.plan``)."""
    profiles = [PodProfile(p.name, p.effective_flops, p.n_chips)
                for p in cluster.pods]
    return make_plan(profiles, total_micro, micro_batch)


def profile_throughput(step_fn: Callable[[], object], tokens_per_step: int,
                       warmup: int = 1, iters: int = 3, *,
                       device=None) -> tuple[float, float]:
    """The paper's short profiling run: ``warmup`` steps, then the median of
    ``iters`` timed steps.

    ``step_fn`` runs one training step of this island.  On a CUDA
    ``device`` each timed step is bracketed by ``torch.cuda.synchronize``,
    so the host clock covers the card's work (a step returns before its
    kernels end); elsewhere the host clock alone.  Returns ``(tokens_per_s,
    profiling_seconds)``: the speed that seeds :func:`make_plan` (or
    ``plan.refine``) and the run's whole overhead.
    """
    sync = _synchronizer(device)
    t_start = time.perf_counter()
    for _ in range(warmup):
        step_fn()
    sync()
    samples = []
    for _ in range(iters):
        t0 = time.perf_counter()
        step_fn()
        sync()
        samples.append(time.perf_counter() - t0)
    dt = float(np.median(samples))
    return tokens_per_step / dt, time.perf_counter() - t_start


def _synchronizer(device):
    if device is None:
        return lambda: None
    import torch
    device = torch.device(device)
    if device.type == "cuda":
        return lambda: torch.cuda.synchronize(device)
    return lambda: None


def imbalance(plan: HetPlan, profiles: Sequence[PodProfile]) -> float:
    """Straggler factor of a plan: max_i(b_i/s_i) / mean_i(b_i/s_i).

    1.0 means every island finishes its micro-steps together (the collective
    never waits); the uniform plan on a 2:1 fleet scores ~1.33.
    """
    t = np.array([m / p.tokens_per_s
                  for m, p in zip(plan.micro_per_pod, profiles)])
    return float(t.max() / t.mean())
