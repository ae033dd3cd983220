"""repro_torch.obs — the unified telemetry plane (DESIGN.md §16).

Counterpart of ``repro/obs/__init__.py``, with its schemas byte for byte
(DESIGN_TORCH.md §24).  One subsystem, four members, one span/event stream:

- :mod:`~repro_torch.obs.span` — the :class:`Tracer`; every ``hetccl``
  dispatch of every mesh rank becomes a policy-tagged span carrying the
  simulator's modeled time (its own modeled↔measured residual).
- :mod:`~repro_torch.obs.metrics` — counters/gauges/deterministic histograms
  subscribed to the stack's typed events; ``obs.snapshot()`` is the
  queryable fleet state.  Also home of the unified perf JSONL envelope.
- :mod:`~repro_torch.obs.flight` — bounded ring of recent spans/events, dumped
  post-mortem on hang escalation, eviction, or chaos faults.
- :mod:`~repro_torch.obs.export` — Chrome-trace JSON (one lane per pod, one
  ribbon per collective stream) and the ``step_report()`` text table.

:class:`Telemetry` is the pre-wired bundle the launchers construct: it fans
the tracer into the metrics registry and the flight recorder, installs the
dispatch hook stack-safely, runs probes between steps, and owns the
dump-on-fault policy (``elastic.run_elastic`` triggers it on faults).
"""
from __future__ import annotations

import pathlib
import time

from repro_torch.obs.span import (SPAN_SCHEMA_VERSION, CAT_COLLECTIVE, CAT_PHASE,
                            CAT_STEP, Span, Tracer)
from repro_torch.obs.metrics import (HIST_EDGES, METRIC_LINE_SCHEMA,
                               METRICS_SCHEMA_VERSION, RESIDUAL_EDGES,
                               Counter, FleetMetrics, Gauge, Histogram,
                               MetricsRegistry, append_metric_line,
                               metric_line, read_metric_lines)
from repro_torch.obs.flight import (FLIGHT_SCHEMA_VERSION, FlightRecorder,
                              load_dump, validate_dump)
from repro_torch.obs.export import (chrome_trace, load_chrome_trace, modeled_spans,
                              step_report, validate_chrome_trace,
                              write_chrome_trace)
from repro_torch.obs.probe import (PROBE_CLASS_BYTES, probe_cells,
                             probe_communicator, run_probes)

__all__ = [
    "SPAN_SCHEMA_VERSION", "CAT_COLLECTIVE", "CAT_PHASE", "CAT_STEP",
    "Span", "Tracer",
    "HIST_EDGES", "RESIDUAL_EDGES", "METRICS_SCHEMA_VERSION",
    "METRIC_LINE_SCHEMA", "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "FleetMetrics", "metric_line", "append_metric_line", "read_metric_lines",
    "FLIGHT_SCHEMA_VERSION", "FlightRecorder", "validate_dump", "load_dump",
    "chrome_trace", "write_chrome_trace", "load_chrome_trace",
    "validate_chrome_trace", "step_report", "modeled_spans",
    "PROBE_CLASS_BYTES", "probe_communicator", "probe_cells", "run_probes",
    "Telemetry", "active", "snapshot",
]

_ACTIVE: "Telemetry | None" = None


def active() -> "Telemetry | None":
    """The installed telemetry bundle, if any."""
    return _ACTIVE


def snapshot() -> dict:
    """Schema-versioned fleet-state digest of the active telemetry (an
    empty registry's snapshot when none is installed)."""
    t = _ACTIVE
    return t.snapshot() if t is not None else MetricsRegistry().snapshot()


class Telemetry:
    """Tracer + metrics + flight recorder, pre-wired.

    Args:
        cluster: optional :class:`~repro_torch.core.topology.ClusterSpec`; enables
            simulator pricing on every collective span.
        out_dir: where post-mortem dumps / final artifacts land.  Without
            one, dumps accumulate on :attr:`dumps` in memory.
        capacity: flight-recorder ring size.
        probes: run per-cell probes between steps.
        probe_every: probe cadence in steps.
        device: where the probes' one-rank mesh runs ("cuda" unless the
            caller asks for "cpu").
    """

    def __init__(self, *, cluster=None, out_dir=None, capacity: int = 4096,
                 probes: bool = True, probe_every: int = 1, device="cuda"):
        self.flight = FlightRecorder(capacity=capacity)
        self.metrics = FleetMetrics()
        self.tracer = Tracer(cluster=cluster,
                             sinks=(self.flight, self.metrics))
        self.out_dir = pathlib.Path(out_dir) if out_dir else None
        self.probes = probes
        self.probe_every = max(int(probe_every), 1)
        self.device = device
        self.dumps: list[dict] = []
        self.dump_paths: list[str] = []
        self.comm = None
        self._probe_comm = None
        self._installed = False
        self._n_dumps = 0

    # -- wiring -------------------------------------------------------------

    def bind(self, *, cluster=None, comm=None) -> "Telemetry":
        """Late-bind the pricing cluster and/or the live communicator (the
        probe communicator is derived from the latter's policy table)."""
        if cluster is not None:
            self.tracer.cluster = cluster
        if comm is not None:
            self.comm = comm
            self._probe_comm = probe_communicator(comm, tracer=self.tracer)
        return self

    def install(self) -> "Telemetry":
        """Install the tracer as the process dispatch hook (stack-safe via
        ``hetccl.install_tracer``) and publish as ``obs.active()``."""
        global _ACTIVE
        from repro_torch.core import hetccl
        hetccl.install_tracer(self.tracer)
        _ACTIVE = self
        self._installed = True
        return self

    def uninstall(self) -> None:
        global _ACTIVE
        if not self._installed:
            return
        from repro_torch.core import hetccl
        hetccl.uninstall_tracer()
        if _ACTIVE is self:
            _ACTIVE = None
        self._installed = False

    def __enter__(self) -> "Telemetry":
        return self.install()

    def __exit__(self, *exc) -> None:
        self.uninstall()

    # -- the event fan-in (what run_elastic / the launchers call) -----------

    def _event(self, event: str, **payload) -> None:
        self.flight.on_event(event, t_s=time.perf_counter(), **payload)

    def on_step(self, step: int, rec=None, dur_s: float | None = None,
                pod: str | None = None) -> None:
        self.tracer.set_step(step)
        if dur_s is not None:
            self.tracer.record(f"step {step}", CAT_STEP, dur_s,
                               track="step", step=step, pod=pod)
        if rec is not None:
            self.metrics.on_step_record(step, rec)

    def probe_step(self, step: int) -> int:
        """Between-steps probe pass (no-op off cadence / unbound)."""
        if not self.probes or self._probe_comm is None \
                or step % self.probe_every:
            return 0
        return run_probes(self._probe_comm, step=step, device=self.device)

    def on_pod_event(self, ev) -> None:
        """Subscriber for :class:`repro.elastic.detect.PodEvent` streams;
        a pod leaving the membership (eviction / death) is a dump trigger."""
        self.metrics.on_pod_event(ev)
        self._event("pod_event", event_kind=ev.kind, pod=ev.pod,
                    epoch=ev.epoch, step=ev.step, seq=getattr(ev, "seq", -1),
                    detail=ev.detail)
        if ev.kind == "pod-dead":
            self.dump_postmortem(f"pod-dead-{ev.pod}", step=ev.step)

    def on_epoch(self, epoch: int, *, step: int | None = None) -> None:
        if epoch == self.tracer.comm_epoch:
            return
        self.tracer.comm_epoch = epoch
        self.metrics.on_epoch(epoch)
        self._event("epoch", epoch=epoch, step=step)

    def on_hang(self, ev, *, step: int | None = None) -> None:
        """A watchdog :class:`HangEvent`; rebuild/evict escalations trigger
        a post-mortem dump (the flight recorder's raison d'être)."""
        self.metrics.on_hang(ev)
        self._event("hang", op=ev.op, size_class=ev.size_class, pod=ev.pod,
                    breaches=ev.breaches, action=ev.action,
                    deadline_s=ev.deadline_s, elapsed_s=ev.elapsed_s,
                    step=step if step is not None else ev.step)
        if ev.action in ("rebuild", "evict"):
            self.dump_postmortem(f"hang-{ev.action}", step=step)

    def on_chaos(self, op: str, pod: str, *, step: int | None = None,
                 dump: bool = True) -> None:
        self.metrics.on_chaos(op, pod)
        self._event("chaos", op=op, pod=pod, step=step)
        if dump:
            self.dump_postmortem(f"chaos-{op}", step=step)

    def on_failover(self, ev) -> None:
        """A transport :class:`FailoverEvent`."""
        self.metrics.on_failover(ev)
        self._event("failover", down_link=ev.down_link,
                    slowdown=ev.slowdown)

    def rebind_comm(self, comm, *, epoch: int | None = None,
                    step: int | None = None) -> None:
        """After an elastic rebuild: re-derive the probe communicator from
        the new policy table and bump the span epoch tag."""
        self.bind(comm=comm)
        if epoch is not None:
            self.on_epoch(epoch, step=step)

    # -- outputs ------------------------------------------------------------

    def dump_postmortem(self, reason: str, *, step: int | None = None) -> str | None:
        self._n_dumps += 1
        if self.out_dir is not None:
            path = self.out_dir / f"flight-{self._n_dumps:03d}-{reason}.json"
            p = self.flight.dump_to(path, reason, step=step)
            self.dump_paths.append(p)
            return p
        self.dumps.append(self.flight.dump(reason, step=step))
        return None

    def snapshot(self) -> dict:
        return self.metrics.snapshot()

    def chrome_trace(self) -> dict:
        return chrome_trace(self.tracer.spans,
                            events=[e for e in self.flight._buf
                                    if e.get("kind") == "event"])

    def step_report(self, *, top: int = 8) -> str:
        return step_report(self.tracer.spans, top=top)

    def write(self, *, metrics_out=None) -> dict:
        """Write final artifacts: ``trace.json`` (Chrome trace),
        ``metrics.json`` (snapshot), ``report.txt`` under ``out_dir``,
        plus an optional unified-envelope JSONL snapshot line at
        ``metrics_out``.  Returns ``{artifact: path}``."""
        out = {}
        if self.out_dir is not None:
            self.out_dir.mkdir(parents=True, exist_ok=True)
            out["trace"] = write_chrome_trace(self.out_dir / "trace.json",
                                              self.chrome_trace())
            import json
            mpath = self.out_dir / "metrics.json"
            mpath.write_text(json.dumps(self.snapshot(), indent=1,
                                        sort_keys=True) + "\n")
            out["metrics"] = str(mpath)
            rpath = self.out_dir / "report.txt"
            rpath.write_text(self.step_report() + "\n")
            out["report"] = str(rpath)
        if metrics_out is not None:
            append_metric_line(metrics_out, metric_line(
                "fleet_snapshot", metrics={"snapshot": self.snapshot()}))
            out["metrics_out"] = str(metrics_out)
        return out
