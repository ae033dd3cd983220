"""Fault tolerance: supervised training loop with checkpoint/restart,
failure injection, straggler detection, and elastic re-planning.

Counterpart of ``repro/train/ft.py``.  The port's train state is a list of
per-rank states, so the loop takes the program as ``layout`` (the
reference's ``state_shardings``): checkpoints hold its full logical arrays
and a restore places them back on its ranks (``train.checkpoint``).  The
loop's periodic checkpoints are async, as the reference's module describes
them: the state's host copy at the step, its write beside the next steps;
a retry waits for the pending write, the newest restore point.

At 1000+-node scale the failure model is: a pod (island) drops, the job is
restarted by the cluster scheduler on the surviving/replacement pods, and
training must resume bit-exact from the last checkpoint — possibly on a
different mesh (elastic).  This module implements the control plane:

  run_supervised(...)   — step loop with retry-on-failure + periodic async
                          checkpoints + deterministic data resume;
  StragglerMonitor      — per-step EMA timing; flags pods whose profiled
                          throughput drifted (thermal throttling etc.), which
                          triggers re-profiling -> new balance plan (the
                          paper's "online re-profiling" future work, App. A);
  replan(...)           — elastic re-balance when the pod set changes;
  replan_auto(...)      — same, but through the plan autotuner: measured
                          profiles + observed step time re-rank the whole
                          (shares, mode, channels, bucket) configuration
                          (repro_torch.plan.refine, DESIGN.md §9).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable

from repro_torch.core.balance import HetPlan, PodProfile, make_plan
from repro_torch.train import checkpoint as ckpt_mod


@dataclasses.dataclass
class StragglerMonitor:
    """EMA of *healthy* step time; flags drift beyond ``tolerance``.

    The smoothed estimate (:attr:`ema`) is the measured step time the plan
    autotuner's refinement loop consumes (``repro_torch.plan.refine`` /
    :func:`replan_auto`, DESIGN.md §9): a drift flag triggers re-profiling,
    the EMA calibrates the planner's compute model.

    Drifted samples are excluded from the EMA: the reference tracks the
    healthy regime only, so a *sustained* slowdown stays flagged every step
    instead of being absorbed into the baseline after a few observations
    (which would both silence the flag and mis-calibrate the planner with
    degraded step times).  Per-pod attribution and the graded
    quarantine response live in the reference's ``elastic.quarantine``
    (DESIGN.md §15; the port's elastic slice, ROADMAP A10b); this monitor is
    the fleet-aggregate tripwire.
    """

    alpha: float = 0.1
    tolerance: float = 0.2
    _ema: float | None = None

    def observe(self, step_time: float) -> bool:
        if self._ema is None:
            self._ema = step_time
            return False
        drifted = step_time > self._ema * (1 + self.tolerance)
        if not drifted:
            self._ema = (1 - self.alpha) * self._ema + self.alpha * step_time
        return drifted

    @property
    def ema(self) -> float | None:
        """Smoothed healthy step seconds (None until the first
        observation)."""
        return self._ema


def replan(old_plan: HetPlan, profiles: list[PodProfile]) -> HetPlan:
    """Rebalance after pod-set or throughput change (elastic scaling).

    Shares-only: keeps the old plan's total micro-steps and micro-batch and
    redistributes them over ``profiles``.  When the run was planned by the
    autotuner, prefer :func:`replan_auto`, which re-ranks the *whole*
    configuration (mode/channels/bucket too) under the same contract.
    """
    total = old_plan.total_micro
    return make_plan(profiles, total, old_plan.micro_batch)


def replan_auto(train_plan, profiles: list[PodProfile] | None = None,
                observed_step_s: float | None = None, cluster=None):
    """Elastic re-plan through the autotuner (DESIGN.md §9 re-plan contract).

    Args:
        train_plan: the incumbent ``repro_torch.plan.TrainPlan`` (carries the
            original request: global batch, micro granularity, cluster).
        profiles: measured per-pod throughputs (e.g. from
            ``balance.profile_throughput`` after a drift flag).
        observed_step_s: measured step seconds (``StragglerMonitor.ema``);
            recalibrates the planner's compute model before re-ranking.
        cluster: pass the new ``ClusterSpec`` when the pod *set* changed
            (island lost/replaced); the batch contract is preserved.
    Returns:
        A fresh best ``TrainPlan`` — materialize with ``.run_config()`` and
        restart from the last checkpoint on the new plan.
    """
    from repro_torch import plan as plan_mod
    if cluster is not None:
        req = dataclasses.replace(train_plan.request, cluster=cluster)
        train_plan = dataclasses.replace(train_plan, request=req)
        if profiles is None:
            profiles = list(plan_mod.pod_profiles(cluster))
    return plan_mod.refine(train_plan, profiles,
                           observed_step_s=observed_step_s)


class InjectedFailure(RuntimeError):
    pass


def _backoff_s(restarts: int, base: float, cap: float, jitter: float) -> float:
    """Exponential backoff with deterministic jitter.

    ``base * 2^(restarts-1)`` capped at ``cap``, stretched by up to
    ``jitter`` fraction.  The jitter term is a golden-ratio hash of the
    restart count — decorrelated across retries (the point of jitter: no
    thundering herd when every island retries together) yet reproducible,
    so recovery tests stay deterministic.
    """
    delay = min(base * (2.0 ** max(restarts - 1, 0)), cap)
    frac = (restarts * 0.6180339887498949) % 1.0
    return delay * (1.0 + jitter * frac)


def run_supervised(step_fn: Callable, state, batches, *, ckpt_dir: str,
                   ckpt_every: int = 50, n_steps: int = 100,
                   layout=None, fail_at: int | None = None,
                   max_restarts: int = 3,
                   retryable: tuple[type[BaseException], ...] = (InjectedFailure,),
                   backoff_base: float = 0.05, backoff_cap: float = 5.0,
                   backoff_jitter: float = 0.25,
                   start_step: int | None = None,
                   monitor: StragglerMonitor | None = None,
                   log_every: int = 10, metrics_cb: Callable | None = None,
                   drift_cb: Callable | None = None):
    """Run ``n_steps`` with checkpointing and automatic restart.

    ``batches``: callable step -> batch (deterministic, seekable).
    ``layout``: the train program whose per-rank states ``state`` is (the
    reference's ``state_shardings``); None for a plain tree.
    ``fail_at``: inject one failure at that step (tests the recovery path).
    ``retryable``: exception types that take the restore-and-retry path —
    real transient collective failures (a flapped link mid-all-reduce, a
    preempted host) recover exactly like injected ones.  Anything outside
    the tuple propagates (pod loss escalates to the elastic control plane,
    DESIGN.md §13; the port's elastic slice, ROADMAP A10b).  Each retry backs off exponentially
    (``backoff_base * 2^k`` capped at ``backoff_cap``) with deterministic
    jitter, bounded by ``max_restarts``.
    ``start_step``: trust ``(state, start_step)`` and skip the
    latest-checkpoint auto-resume — the checkpointless elastic recovery
    entry point, where the in-memory state is *newer* than any checkpoint.
    ``drift_cb``: called as ``drift_cb(step, step_seconds)`` whenever the
    straggler monitor flags drift — the hook the re-planning control plane
    hangs off (kick a profiling run, then :func:`replan_auto` and restart on
    the refined plan; DESIGN.md §9).
    Returns (final_state, history list of metric dicts).
    """
    history = []
    like = None if layout is not None else state
    if start_step is not None:
        step = start_step
    else:
        start = ckpt_mod.latest_step(ckpt_dir)
        step = 0
        if start is not None:
            start, state = ckpt_mod.restore_latest(ckpt_dir, like, layout)
            step = start
    restarts = 0
    injected = {"done": False}
    while step < n_steps:
        try:
            t0 = time.perf_counter()
            batch = batches(step)
            if fail_at is not None and step == fail_at and not injected["done"]:
                injected["done"] = True
                raise InjectedFailure(f"injected failure at step {step}")
            state, metrics = step_fn(state, batch)
            # reading the metrics waits for the device: the step's time
            # includes its kernels, not only their enqueue
            values = {k: float(v) for k, v in metrics.items()
                      if not isinstance(v, bool)}
            dt = time.perf_counter() - t0
            if monitor is not None and monitor.observe(dt):
                metrics = {**metrics, "straggler_flag": True}
                if drift_cb is not None:
                    drift_cb(step, dt)
            history.append({"step": step, "step_s": dt, **values})
            if metrics_cb:
                metrics_cb(step, history[-1])
            step += 1
            if step % ckpt_every == 0 or step == n_steps:
                # host copy now, the write on the background thread
                ckpt_mod.save(ckpt_dir, step, state, layout, blocking=False)
        except retryable:
            restarts += 1
            if restarts > max_restarts:
                raise
            delay = _backoff_s(restarts, backoff_base, backoff_cap,
                               backoff_jitter)
            if delay > 0:
                time.sleep(delay)
            try:
                ckpt_mod.wait_pending()         # the newest save is the restore point
                last, state = ckpt_mod.restore_latest(ckpt_dir, like, layout)
                step = last
            except FileNotFoundError:
                step = 0            # restart from scratch (no ckpt yet)
    ckpt_mod.wait_pending()
    return state, history
