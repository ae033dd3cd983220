"""Process-local fleet metrics: counters, gauges, deterministic histograms,
and the unified metric-line envelope (DESIGN.md §16).

Counterpart of ``repro/obs/metrics.py``, with the same edges, snapshot and
envelope, so the same events give the same JSON in both packages.  The
elastic layer's events (pod events, hangs) arrive with the elastic slice
(ROADMAP A10b); their subscribers are here already.

The registry turns the stack's fire-and-forget typed events — transport
:class:`~repro_torch.transport.flow.FailoverEvent`\\ s, watchdog
:class:`~repro.elastic.watchdog.HangEvent`\\ s, elastic
:class:`~repro.elastic.detect.PodEvent`\\ s (quarantine transitions,
membership epoch changes), and the tracer's spans — into queryable state:
``snapshot()`` returns a schema-versioned dict, deterministic in content
and ordering for identical event streams.

Histogram buckets are **fixed log-spaced edges** computed from constants —
no wall-clock, no data-dependent resizing — so two runs observing the same
values produce bit-identical bucket counts (the determinism contract
``tests/test_obs.py`` pins).

The metric-line envelope at the bottom is the shared JSONL schema of the
repo's perf trails: ``results/perf_log.jsonl`` and
``benchmarks/measure.py``'s history both emit :func:`metric_line` records,
and :func:`read_metric_lines` keeps parsing the two legacy line shapes so
existing history files stay loadable.

Stdlib-pure (json only at the file edges).
"""
from __future__ import annotations

import bisect
import dataclasses
import json
import pathlib
from typing import Iterable, Mapping

METRICS_SCHEMA_VERSION = 1

# 1 µs .. 1000 s, four buckets per decade: fixed, wall-clock-free edges so
# bucket assignment is a pure function of the observed value.
HIST_EDGES: tuple[float, ...] = tuple(
    round(10.0 ** (-6 + i / 4), 12) for i in range(4 * 9 + 1))

# Residual (measured/modeled) histograms want a ratio-shaped range instead:
# 2^-8 .. 2^8, four buckets per octave.
RESIDUAL_EDGES: tuple[float, ...] = tuple(
    round(2.0 ** (-8 + i / 4), 12) for i in range(4 * 16 + 1))


@dataclasses.dataclass
class Counter:
    value: float = 0.0

    def inc(self, n: float = 1.0) -> None:
        self.value += n


@dataclasses.dataclass
class Gauge:
    value: float | None = None

    def set(self, v: float) -> None:
        self.value = float(v)


class Histogram:
    """Fixed-edge histogram: ``counts[i]`` is the number of observations in
    ``(edges[i-1], edges[i]]`` with under/overflow at the ends."""

    def __init__(self, edges: Iterable[float] = HIST_EDGES):
        self.edges = tuple(float(e) for e in edges)
        if list(self.edges) != sorted(set(self.edges)):
            raise ValueError("histogram edges must be strictly increasing")
        self.counts = [0] * (len(self.edges) + 1)
        self.n = 0
        self.sum = 0.0

    def observe(self, v: float) -> None:
        self.counts[bisect.bisect_left(self.edges, float(v))] += 1
        self.n += 1
        self.sum += float(v)

    def nonzero(self) -> dict[int, int]:
        """Sparse view for snapshots (most of the fixed range stays empty)."""
        return {i: c for i, c in enumerate(self.counts) if c}


def _label_key(labels: Mapping) -> tuple:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


class MetricsRegistry:
    """Name+labels keyed instrument store with a deterministic snapshot."""

    def __init__(self):
        self._counters: dict[tuple, tuple[str, dict, Counter]] = {}
        self._gauges: dict[tuple, tuple[str, dict, Gauge]] = {}
        self._hists: dict[tuple, tuple[str, dict, Histogram]] = {}

    def counter(self, name: str, **labels) -> Counter:
        key = (name, _label_key(labels))
        if key not in self._counters:
            self._counters[key] = (name, dict(labels), Counter())
        return self._counters[key][2]

    def gauge(self, name: str, **labels) -> Gauge:
        key = (name, _label_key(labels))
        if key not in self._gauges:
            self._gauges[key] = (name, dict(labels), Gauge())
        return self._gauges[key][2]

    def histogram(self, name: str, edges: Iterable[float] = HIST_EDGES,
                  **labels) -> Histogram:
        key = (name, _label_key(labels))
        if key not in self._hists:
            self._hists[key] = (name, dict(labels), Histogram(edges))
        return self._hists[key][2]

    def snapshot(self) -> dict:
        """Schema-versioned, deterministically ordered digest of every
        instrument — the ``obs.snapshot()`` payload."""
        return {
            "schema_version": METRICS_SCHEMA_VERSION,
            "counters": [
                {"name": n, "labels": lb, "value": c.value}
                for _, (n, lb, c) in sorted(self._counters.items())],
            "gauges": [
                {"name": n, "labels": lb, "value": g.value}
                for _, (n, lb, g) in sorted(self._gauges.items())],
            "histograms": [
                {"name": n, "labels": lb, "n": h.n, "sum": h.sum,
                 "edges": list(h.edges),
                 "counts": {str(i): c for i, c in h.nonzero().items()}}
                for _, (n, lb, h) in sorted(self._hists.items())],
        }


class FleetMetrics:
    """The subscriber half: one method per typed event stream, writing into
    a :class:`MetricsRegistry`.  Every ``on_*`` is safe to wire directly —
    they take the event objects the emitting layer already produces."""

    def __init__(self, registry: MetricsRegistry | None = None):
        self.registry = registry or MetricsRegistry()

    # -- spans (Tracer sink protocol) ---------------------------------------

    def on_span(self, sp) -> None:
        if sp.dur_s is None:
            return
        if sp.cat == "collective" and "op" in sp.tags:
            lb = {"op": sp.tags["op"], "size_class": sp.tags["size_class"],
                  "backend": sp.tags["backend"]}
            self.registry.counter("collective_dispatch_total", **lb).inc()
            self.registry.histogram("collective_s", **lb).observe(sp.dur_s)
            r = sp.residual
            if r is not None:
                self.registry.histogram("collective_residual",
                                        edges=RESIDUAL_EDGES, **lb).observe(r)
        elif sp.cat == "step":
            self.registry.counter("steps_total").inc()
            self.registry.histogram("step_s").observe(sp.dur_s)

    # -- elastic typed events -----------------------------------------------

    def on_pod_event(self, ev) -> None:
        """A :class:`repro.elastic.detect.PodEvent` (all kinds: membership,
        link health, quarantine ladder, comm rebuilds)."""
        self.registry.counter("pod_events_total", kind=ev.kind,
                              pod=ev.pod).inc()
        self.registry.gauge("last_event_step", kind=ev.kind).set(ev.step)

    def on_epoch(self, epoch: int) -> None:
        self.registry.gauge("membership_epoch").set(epoch)
        self.registry.counter("epoch_changes_total").inc()

    def on_hang(self, ev) -> None:
        """A watchdog :class:`repro.elastic.watchdog.HangEvent` breach."""
        self.registry.counter("watchdog_breach_total", op=ev.op,
                              size_class=ev.size_class,
                              action=ev.action).inc()
        self.registry.gauge("watchdog_breach_streak").set(ev.breaches)

    # -- transport ----------------------------------------------------------

    def on_failover(self, ev) -> None:
        """A transport :class:`repro_torch.transport.flow.FailoverEvent`."""
        self.registry.counter("transport_failover_total",
                              down_link=ev.down_link).inc()
        self.registry.histogram("failover_slowdown",
                                edges=RESIDUAL_EDGES).observe(ev.slowdown)

    # -- chaos / steps ------------------------------------------------------

    def on_chaos(self, op: str, pod: str) -> None:
        self.registry.counter("chaos_actions_total", op=op, pod=pod).inc()

    def on_step_record(self, step: int, rec: Mapping) -> None:
        self.registry.gauge("last_step").set(step)
        if "loss" in rec:
            self.registry.gauge("loss").set(float(rec["loss"]))

    def snapshot(self) -> dict:
        return self.registry.snapshot()


# ---------------------------------------------------------------------------
# The unified perf JSONL envelope (+ legacy readers)
# ---------------------------------------------------------------------------

METRIC_LINE_SCHEMA = 1


def metric_line(kind: str, *, labels: Mapping | None = None,
                metrics: Mapping | None = None,
                meta: Mapping | None = None) -> dict:
    """One JSONL record of the unified perf schema: ``labels`` identify the
    measured configuration (the join key), ``metrics`` carry the numbers,
    ``meta`` anything else (host fingerprint, timestamps)."""
    line = {"obs_schema": METRIC_LINE_SCHEMA, "kind": str(kind),
            "labels": dict(labels or {}), "metrics": dict(metrics or {})}
    if meta:
        line["meta"] = dict(meta)
    return line


def append_metric_line(path, line: Mapping) -> None:
    p = pathlib.Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    with open(p, "a") as f:
        f.write(json.dumps(dict(line), sort_keys=True) + "\n")


def _normalize_legacy(raw: dict) -> dict:
    """Lift a pre-unification JSONL line into the envelope shape.

    Two legacy dialects exist: ``benchmarks/measure.py`` history lines
    (``{"ts", "kind", "host", "config", "entries"}``) and raw
    ``results/perf_log.jsonl`` roofline records (flat dicts keyed by run
    identity + modeled numbers)."""
    if {"kind", "entries", "config"} <= raw.keys():        # bench history
        return {"obs_schema": METRIC_LINE_SCHEMA,
                "kind": f"bench_{raw['kind']}",
                "labels": {"mesh": raw["config"].get("mesh"),
                           "smoke": raw["config"].get("smoke")},
                "metrics": raw["entries"],
                "meta": {"ts": raw.get("ts"), "host": raw.get("host"),
                         "legacy": True}}
    label_keys = ("tag", "arch", "shape", "mesh", "zero", "mode", "backend",
                  "policy", "n_channels", "n_stripes", "cross_dtype",
                  "seq_shard_acts")
    return {"obs_schema": METRIC_LINE_SCHEMA, "kind": "perf_iteration",
            "labels": {k: raw[k] for k in label_keys if k in raw},
            "metrics": {k: v for k, v in raw.items() if k not in label_keys},
            "meta": {"legacy": True}}


def read_metric_lines(path) -> list[dict]:
    """Parse a perf JSONL trail — unified-envelope lines pass through,
    legacy lines (old ``perf_log.jsonl`` / ``bench_history.jsonl`` shapes)
    are normalized — so history files written before the schema unification
    keep loading (the back-compat contract)."""
    out = []
    for ln in pathlib.Path(path).read_text().splitlines():
        ln = ln.strip()
        if not ln:
            continue
        raw = json.loads(ln)
        if raw.get("obs_schema") == METRIC_LINE_SCHEMA:
            out.append(raw)
        elif "obs_schema" in raw:
            raise ValueError(f"unsupported obs_schema {raw['obs_schema']!r} "
                             f"(reader speaks {METRIC_LINE_SCHEMA})")
        else:
            out.append(_normalize_legacy(raw))
    return out
