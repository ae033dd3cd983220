"""Profile-driven plan refinement (DESIGN.md §9 refinement loop).

The first plan is priced from hardware constants (Table-1-style roofline
numbers).  Real fleets drift: software stacks mature unevenly (paper
Appendix F.2), chips throttle, islands get replaced.  The paper's answer is
a short profiling run feeding measured throughputs back into the balancer
(§4.5, Table 4); this module generalizes that to the *whole* plan:

    tp   = plan.autotune(req)                     # constants-based plan
    ...train, measure...
    tp2  = plan.refine(tp, measured_profiles,     # re-ranked plan
                       observed_step_s=monitor.ema)

``refine`` re-runs the full search with (a) measured per-pod throughputs
replacing the roofline speeds in the balancer and (b) a compute calibration
factor solved from the observed step time, so the re-ranked frontier is
anchored to reality rather than datasheet constants.  The re-plan contract
(DESIGN.md §9): the request (global batch, micro-batch granularity, cluster)
is preserved verbatim; only shares, mode, channels, bucket and stage may
change.  Counterpart of ``repro/plan/refine.py``, the port's own copy.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, Sequence

from repro_torch.core.balance import PodProfile
from repro_torch.plan.autotuner import (DEFAULT_SPACE, SearchSpace, TrainPlan,
                                  rank)

# Calibration clamp: a single observed step can be wildly off (first-step
# compile, checkpoint stall); never let one sample move the compute model
# by more than this factor either way.
_CAL_MIN, _CAL_MAX = 0.25, 8.0


def calibrate(tp: TrainPlan, observed_step_s: float) -> float:
    """Solve the compute calibration factor from one measured step time.

    The communication term is structural (wire bytes over modeled
    bandwidths), so the residual between observation and model is attributed
    to compute:  scale = (observed - comm_modeled) / compute_modeled,
    clamped to [0.25, 8] (DESIGN.md §9).

    Args:
        tp: the plan that produced the observation.
        observed_step_s: measured seconds per optimizer step (e.g. the
            ``StragglerMonitor`` EMA).
    Returns:
        The new compute scale, composed with the plan's existing one.
    """
    base_compute = tp.modeled_compute_s / max(tp.compute_scale, 1e-12)
    if base_compute <= 0:
        return tp.compute_scale
    scale = (observed_step_s - tp.modeled_comm_s) / base_compute
    return float(min(max(scale, _CAL_MIN), _CAL_MAX))


def refine(tp: TrainPlan, profiles: Sequence[PodProfile] | None = None,
           observed_step_s: float | None = None,
           space: SearchSpace | None = None) -> TrainPlan:
    """Re-plan with measured evidence; returns a fresh best :class:`TrainPlan`.

    Args:
        tp: the incumbent plan (carries the original :class:`PlanRequest`
            *and* the profiles its shares were computed from).
        profiles: measured per-pod throughputs (``balance.PodProfile``, e.g.
            from ``balance.profile_throughput``); when given they replace the
            speeds used so far.  When omitted, the incumbent's own profiles
            are reused — earlier measurements are never silently discarded
            in favor of datasheet constants.  Must cover the request's
            pods — elastic pod-set changes go through
            ``train.ft.replan_auto``, which rebuilds the request first.
        observed_step_s: measured step time under ``tp``; recalibrates the
            compute model via :func:`calibrate` before re-ranking.
        space: optionally narrow/widen the search space for the re-plan;
            defaults to the incumbent's space.
    Returns:
        The best plan of the re-ranked frontier.  May equal ``tp`` (modulo
        calibration) — a stable plan under new evidence is a valid outcome.

    Example::

        profs = [PodProfile("pod0", 9.1e5), PodProfile("pod1", 3.8e5)]
        tp2 = refine(tp, profs, observed_step_s=monitor.ema)
        rc2 = tp2.run_config(rc)        # restart the trainer on the new plan
    """
    return refined_frontier(tp, profiles, observed_step_s, space)[0]


def deweighted_profiles(profiles: Sequence[PodProfile],
                        factors: Mapping[str, float]) -> list[PodProfile]:
    """Scale pod throughputs down by measured slowdown multiples.

    The quarantine response (DESIGN.md §15): a pod observed running at
    ``factors[pod]`` × its healthy step time keeps training on
    ``tokens_per_s / factors[pod]`` — the balancer then shifts DP shares
    off it proportionally instead of evicting working (if slow) hardware.
    Pods absent from ``factors`` (and an empty mapping — the reinstatement
    path) keep their base throughput.  Factors must be >= 1: speeding a pod
    *up* is a profiling update (:func:`refine` with measured profiles),
    not a de-weighting.
    """
    bad = {p: f for p, f in factors.items() if f < 1.0}
    if bad:
        raise ValueError(f"de-weight factors must be >= 1, got {bad}")
    unknown = set(factors) - {p.name for p in profiles}
    if unknown:
        raise ValueError(f"de-weight factors for unknown pods {sorted(unknown)}; "
                         f"profiles cover {[p.name for p in profiles]}")
    return [dataclasses.replace(p, tokens_per_s=p.tokens_per_s
                                / factors.get(p.name, 1.0))
            for p in profiles]


def refined_frontier(tp: TrainPlan,
                     profiles: Sequence[PodProfile] | None = None,
                     observed_step_s: float | None = None,
                     space: SearchSpace | None = None) -> list[TrainPlan]:
    """Like :func:`refine` but returns the whole re-ranked frontier (for
    ``benchmarks/plan_sweep.py`` and offline what-if analysis)."""
    scale = tp.compute_scale
    if observed_step_s is not None:
        scale = calibrate(tp, observed_step_s)
    return rank(tp.request, space or tp.space or DEFAULT_SPACE,
                profiles=profiles if profiles is not None else tp.profiles,
                compute_scale=scale)
