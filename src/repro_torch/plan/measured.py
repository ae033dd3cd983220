"""Measured→planner calibration (DESIGN.md §14): close the modeled↔measured
loop.

Counterpart of ``repro/plan/measured.py``, the port's own copy.  Every
function takes a record dict in the schema of ``benchmarks/measure.py``
(collective timings: ``{"config": {"mesh": ...}, "entries": [...]}``; a
train-step entry: ``median_s``, ``modeled_step_s``, ...) or a
flight-recorder dump; none reads a file.  This module (numpy and stdlib
only, like the rest of the planner) turns them into planner evidence:

* :func:`calibration_report` — one :class:`CalibrationRow` per measured
  collective, pairing the measured median with the α-β simulator's price for
  the *same* (op, payload, mode, backend, channels, stripes) on the bench
  mesh's modeled topology.  The ratio column is the per-(op, size_class,
  backend) model error — the audit trail for every price the planner quotes.
* :func:`fit_alpha_beta` — effective per-(op, mode, backend, stripes) α-β
  terms solved from the measured sweep (least squares over payload sizes),
  the measured analogue of the simulator's hardware constants.
* :func:`profiles_from_train` / :func:`calibrated_plan` — the measured
  train-step feeds ``plan.refine`` (re-ranked shares from measured
  :class:`~repro_torch.core.balance.PodProfile`\\ s) and ``plan.calibrate``
  (the clamped compute-residual attribution, DESIGN.md §9).  A one-host
  bench has one host factor for every island, so refinement must re-rank
  to exactly the incumbent choice — the stability check
  :func:`planner_check` asserts.

The bench records' cluster (:func:`bench_cluster`) is the reference's: the
records it reads describe the reference's benches.  The port's own records
come with its benchmark (ROADMAP A11).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Mapping, Sequence

import numpy as np

from repro_torch.core import simulator as sim
from repro_torch.core.balance import PodProfile
from repro_torch.core.topology import (ClusterSpec, IB_HDR_BW, PodSpec, TPU_V5E,
                                 tpu_mixed_fleet)
from repro_torch.plan.autotuner import (PlanRequest, SearchSpace, TrainPlan,
                                  autotune, plan_request, pod_profiles, rank)
from repro_torch.plan.refine import calibrate, refine

REPORT_SCHEMA_VERSION = 1


def bench_cluster(n_pods: int, chips_per_pod: int) -> ClusterSpec:
    """The modeled topology of a bench mesh: v5e islands, one per 'pod'
    rank — jax-free mirror of ``launch.mesh.cluster_for_mesh`` so the
    calibration side can rebuild exactly the cluster the harness priced
    against from the record's ``config.mesh`` alone."""
    pods = tuple(PodSpec(f"pod{i}", TPU_V5E, chips_per_pod)
                 for i in range(n_pods))
    return ClusterSpec(pods, inter_pod_bw=IB_HDR_BW)


def _record_cluster(record: Mapping) -> ClusterSpec:
    mesh = record["config"]["mesh"]
    return bench_cluster(int(mesh[0]), int(math.prod(mesh[1:])))


# ---------------------------------------------------------------------------
# Per-collective modeled-vs-measured rows
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class CalibrationRow:
    """One measured collective paired with its modeled price."""

    name: str
    op: str
    size_class: str
    mode: str
    backend: str
    n_channels: int
    n_stripes: int
    nbytes: int
    group: str                  # "sweep" | "policy" | "flight"
    measured_s: float           # median of the measured samples
    modeled_s: float            # simulator price of the same configuration

    @property
    def ratio(self) -> float:
        """measured / modeled — the model error this row audits.  >1 means
        the simulator is optimistic for this cell (a bench host's wall
        time against the modeled chip's constants differs by a large,
        mostly-uniform host factor; what matters is the *spread* across
        cells, not the level)."""
        return self.measured_s / self.modeled_s if self.modeled_s > 0 \
            else float("inf")

    def summary(self) -> dict:
        return {"name": self.name, "op": self.op,
                "size_class": self.size_class, "mode": self.mode,
                "backend": self.backend, "n_channels": self.n_channels,
                "n_stripes": self.n_stripes, "nbytes": self.nbytes,
                "group": self.group, "measured_s": self.measured_s,
                "modeled_s": self.modeled_s, "ratio": self.ratio}


def calibration_report(bench_comm: Mapping,
                       cluster: ClusterSpec | None = None
                       ) -> tuple[CalibrationRow, ...]:
    """Pair every measured collective entry with the simulator's price for
    the identical configuration on the bench mesh's modeled cluster.  Every
    (op, size_class, backend) the harness measured gets a row — including
    each row of the active policy table (``group == "policy"``)."""
    cluster = cluster or _record_cluster(bench_comm)
    rows = []
    for e in bench_comm["entries"]:
        modeled = sim.collective_time(
            e["op"], float(e["nbytes"]), cluster, e["mode"],
            n_channels=max(int(e["n_channels"]), 1),
            backend=e["backend"], n_stripes=max(int(e["n_stripes"]), 1))
        rows.append(CalibrationRow(
            name=e["name"], op=e["op"], size_class=e["size_class"],
            mode=e["mode"], backend=e["backend"],
            n_channels=int(e["n_channels"]), n_stripes=int(e["n_stripes"]),
            nbytes=int(e["nbytes"]), group=e.get("group", "sweep"),
            measured_s=float(e["median_s"]), modeled_s=float(modeled)))
    return tuple(rows)


def rows_from_flight(dump: Mapping, cluster: ClusterSpec | None = None
                     ) -> tuple[CalibrationRow, ...]:
    """Ingest a flight-recorder dump (``repro.obs.flight``) as calibration
    rows — the *online* counterpart of ``BENCH_comm.json`` (DESIGN.md §14).

    Every collective span in the dump carries measured wall time plus the
    full policy identity and the tracer's modeled price; spans sharing one
    ``(op, size_class, mode, backend, n_channels, n_stripes, nbytes)`` cell
    collapse to a single row at the measured *median*.  Pass ``cluster`` to
    re-price modeled time on a specific topology; otherwise the price
    recorded in the span is used (same simulator, priced at dispatch time).
    """
    cells: dict[tuple, dict] = {}
    for e in dump.get("entries", ()):
        if e.get("kind") != "span" or e.get("cat") != "collective":
            continue
        t = e.get("tags") or {}
        if e.get("dur_s") is None or "op" not in t:
            continue
        key = (t["op"], t["size_class"], t["mode"], t["backend"],
               int(t["n_channels"]), int(t["n_stripes"]), int(t["nbytes"]))
        cell = cells.setdefault(key, {"measured": [], "modeled": []})
        cell["measured"].append(float(e["dur_s"]))
        if e.get("modeled_s") is not None:
            cell["modeled"].append(float(e["modeled_s"]))
    rows = []
    for (op, cls, mode, backend, nch, nk, nbytes), cell \
            in sorted(cells.items()):
        if cluster is not None:
            eff_mode = mode if mode != "auto" else (
                "hier" if len(cluster.pods) > 1 else "flat")
            modeled = float(sim.collective_time(
                op, float(nbytes), cluster, eff_mode,
                n_channels=max(nch, 1), backend=backend,
                n_stripes=max(nk, 1)))
        elif cell["modeled"]:
            modeled = float(np.median(cell["modeled"]))
        else:
            modeled = 0.0
        rows.append(CalibrationRow(
            name=f"flight/{op}/{cls}/{mode}-{backend}-c{nch}-k{nk}",
            op=op, size_class=cls, mode=mode, backend=backend,
            n_channels=nch, n_stripes=nk, nbytes=nbytes, group="flight",
            measured_s=float(np.median(cell["measured"])),
            modeled_s=modeled))
    return tuple(rows)


def flight_cells(rows: Sequence[CalibrationRow]
                 ) -> list[tuple[str, str, str]]:
    """The ``(op, size_class, backend)`` cells a flight ingest covered —
    compared against the cells a run dispatched, every one of them must
    calibrate."""
    return sorted({(r.op, r.size_class, r.backend) for r in rows
                   if r.group == "flight"})


def comm_scale_from_report(report: Sequence[CalibrationRow]) -> float:
    """Effective communication multiplier of this host: the geometric median
    of the measured/modeled ratios (robust — one weird cell can't move it).
    The measured analogue of ``PlanRequest.comm_scale``."""
    ratios = [r.ratio for r in report if math.isfinite(r.ratio) and r.ratio > 0]
    if not ratios:
        raise ValueError("calibration report has no finite ratios")
    return float(10.0 ** np.median(np.log10(ratios)))


def missing_table_rows(report: Sequence[CalibrationRow],
                       table) -> list[tuple[str, str]]:
    """The (op, size_class) rows of ``table`` (a
    :class:`repro_torch.comm.policy.PolicyTable`) with *no* modeled-vs-measured
    row — the calibration coverage contract is that this is empty for the
    active policy table (DESIGN.md §14)."""
    have = {(r.op, r.size_class) for r in report if r.group == "policy"}
    return [key for key, _ in table.rows if key not in have]


@dataclasses.dataclass(frozen=True)
class AlphaBetaFit:
    """Effective α-β terms of one (op, mode, backend, stripes) measured
    across payload sizes:  t(n) ≈ alpha_s + n / beta_bytes_per_s."""

    op: str
    mode: str
    backend: str
    n_stripes: int
    alpha_s: float
    beta_bytes_per_s: float
    n_points: int

    def summary(self) -> dict:
        return dataclasses.asdict(self)


def fit_alpha_beta(report: Sequence[CalibrationRow]
                   ) -> tuple[AlphaBetaFit, ...]:
    """Least-squares α-β fit per (op, mode, backend, stripes) over the sweep
    sizes.  Cells measured at a single size get ``alpha = median(t)`` and an
    infinite β (no slope information — never extrapolated silently)."""
    groups: dict[tuple, list[tuple[float, float]]] = {}
    for r in report:
        if r.group != "sweep":
            continue
        groups.setdefault((r.op, r.mode, r.backend, r.n_stripes),
                          []).append((float(r.nbytes), r.measured_s))
    fits = []
    for (op, mode, backend, k), pts in sorted(groups.items()):
        xs = np.array([p[0] for p in pts])
        ts = np.array([p[1] for p in pts])
        if len(set(xs.tolist())) >= 2:
            slope, intercept = np.polyfit(xs, ts, 1)
            beta = 1.0 / slope if slope > 0 else float("inf")
            alpha = max(float(intercept), 0.0)
        else:
            alpha, beta = float(np.median(ts)), float("inf")
        fits.append(AlphaBetaFit(op=op, mode=mode, backend=backend,
                                 n_stripes=k, alpha_s=alpha,
                                 beta_bytes_per_s=float(beta),
                                 n_points=len(pts)))
    return tuple(fits)


# ---------------------------------------------------------------------------
# Train-step calibration → plan.refine / plan.calibrate
# ---------------------------------------------------------------------------

def train_request(params: Mapping) -> PlanRequest:
    """Rebuild the planning request of the train microbench from the
    parameters a train record holds — so the modeled step
    time is reproducible from the committed record alone."""
    from repro_torch.configs import get_config
    cfg = get_config(params["arch"])
    if params.get("reduced"):
        cfg = cfg.reduced()
    chips_per_pod = int(params["data_axis"]) * int(params.get("model_axis", 1))
    cluster = bench_cluster(int(params["n_pods"]), chips_per_pod)
    return plan_request(cluster, cfg,
                        global_batch=int(params["global_batch"]),
                        seq_len=int(params["seq_len"]),
                        data_axis=int(params["data_axis"]),
                        zero_stage=int(params["zero_stage"]))


def modeled_train_step_s(request: PlanRequest, params: Mapping) -> float:
    """The simulator's price for *exactly* the benched configuration (not
    the best plan): pin the space to the bench mode/backend and read that
    candidate off the frontier."""
    space = SearchSpace(modes=(params["mode"],), backends=(params["backend"],),
                        stripe_counts=(1,), per_op=False)
    frontier = rank(request, space)
    for tp in frontier:
        if tp.mode == params["mode"] and tp.backend == params["backend"]:
            return tp.modeled_step_s
    raise LookupError(f"no frontier candidate for {params['mode']}/"
                      f"{params['backend']}")


def profiles_from_train(train_entry: Mapping, cluster: ClusterSpec
                        ) -> tuple[PodProfile, ...]:
    """Measured :class:`PodProfile`\\ s for ``cluster``: each island's
    hardware-constant speed scaled by the *measured* host factor
    (modeled / measured step time of the bench run).

    The bench host is one machine, so the factor is uniform across islands —
    which is also the honest measurement: the balancer only consumes speed
    *ratios* (``balance.make_plan``), so uniform scaling re-anchors the
    absolute level that ``plan.calibrate`` audits while provably preserving
    the share split.  A real mixed fleet would measure one factor per island
    (``balance.profile_throughput``) and feed them through the same path."""
    measured = float(train_entry["median_s"])
    modeled = float(train_entry["modeled_step_s"])
    if measured <= 0 or modeled <= 0:
        raise ValueError("train entry needs positive measured and modeled "
                         "step times")
    factor = modeled / measured
    return tuple(PodProfile(p.name, p.tokens_per_s * factor, p.n_devices)
                 for p in pod_profiles(cluster))


def calibrated_plan(tp: TrainPlan, train_entry: Mapping) -> TrainPlan:
    """Re-plan ``tp`` on measured evidence: measured profiles via
    :func:`profiles_from_train` (re-ranked shares) + the observed step time
    through ``plan.calibrate`` (clamped compute-residual attribution,
    DESIGN.md §9)."""
    profiles = profiles_from_train(train_entry, tp.request.cluster)
    return refine(tp, profiles,
                  observed_step_s=float(train_entry["median_s"]))


def _choice_key(tp: TrainPlan) -> dict:
    return {"mode": tp.mode, "backend": tp.backend,
            "n_channels": tp.n_channels, "n_stripes": tp.n_stripes,
            "bucket_bytes": tp.bucket_bytes, "zero_stage": tp.zero_stage,
            "micro_per_pod": list(tp.plan.micro_per_pod)}


def default_planner_request() -> PlanRequest:
    """The mixed-fleet smoke request of the reference's per-op policy check:
    the planner decision the calibration loop must not perturb."""
    from repro_torch.configs import get_config
    return plan_request(tpu_mixed_fleet(2, 2, 128), get_config("smollm-135m"),
                        global_batch=256, seq_len=4096, data_axis=8)


def planner_check(train_entry: Mapping,
                  request: PlanRequest | None = None) -> dict:
    """Feed the measured evidence through ``plan.refine`` on the unperturbed
    mixed fleet and verify the planner's choice is stable: a uniform host
    factor must re-anchor prices, not flip decisions.  Returns the
    before/after choice keys, the clamped ``plan.calibrate`` compute scale,
    and ``unchanged``."""
    request = request or default_planner_request()
    before = autotune(request)
    after = calibrated_plan(before, train_entry)
    return {
        "request": {"model": request.model.name,
                    "global_batch": request.global_batch,
                    "seq_len": request.seq_len,
                    "n_pods": len(request.cluster.pods)},
        "before": _choice_key(before),
        "after": _choice_key(after),
        "compute_scale": calibrate(before,
                                   float(train_entry["median_s"])),
        "unchanged": _choice_key(before) == _choice_key(after),
    }


# ---------------------------------------------------------------------------
# The full calibration record (results/calibration_report.json)
# ---------------------------------------------------------------------------

def calibration_record(bench_comm: Mapping | None,
                       bench_train: Mapping | None,
                       request: PlanRequest | None = None) -> dict:
    """Assemble the auditable calibration report: modeled-vs-measured error
    per (op, size_class, backend), effective α-β fits, policy-table
    coverage, and the planner-stability round trip (DESIGN.md §14)."""
    out: dict = {"schema_version": REPORT_SCHEMA_VERSION, "rows": [],
                 "alpha_beta_fits": [], "comm_scale": None, "train": None,
                 "planner_check": None, "coverage": None}
    if bench_comm is not None:
        report = calibration_report(bench_comm)
        out["rows"] = [r.summary() for r in report]
        out["alpha_beta_fits"] = [f.summary() for f in
                                  fit_alpha_beta(report)]
        out["comm_scale"] = comm_scale_from_report(report)
        from repro_torch.plan.autotuner import policy_table_for
        table = policy_table_for(_record_cluster(bench_comm))
        missing = missing_table_rows(report, table)
        out["coverage"] = {"policy_rows": len(table.rows),
                           "measured": len(table.rows) - len(missing),
                           "missing": [list(k) for k in missing]}
    if bench_train is not None:
        e = bench_train["entries"][0]
        out["train"] = {
            "measured_step_s": float(e["median_s"]),
            "modeled_step_s": float(e["modeled_step_s"]),
            "ratio": float(e["median_s"]) / float(e["modeled_step_s"]),
            "tokens_per_s_median": float(e["tokens_per_s_median"]),
        }
        check = planner_check(e, request)
        out["planner_check"] = check
        out["train"]["compute_scale"] = check["compute_scale"]
    return out
