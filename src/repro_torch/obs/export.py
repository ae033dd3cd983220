"""Trace export: Chrome-trace JSON (chrome://tracing / Perfetto) and the
``step_report()`` text table (DESIGN.md §16).

Counterpart of ``repro/obs/export.py``; the trace, the report and
``modeled_spans`` are the reference's, byte for byte.  On the port the pod
lanes are the mesh's islands (``obs.span``).

The Chrome Trace Event Format is the lingua franca of timeline viewers:
"X" complete events carry ``ts``/``dur`` in microseconds on a
``(pid, tid)`` grid, and "M" metadata events name the rows.  We map one
*process* per pod (the controller's own spans land on pid 0) and one
*thread* per track — ``comm:<op>`` for each collective stream, ``step`` for
the train loop, ``phase`` for everything else — so the viewer shows per-pod
lanes with one ribbon per collective, exactly the per-stage breakdown
HETHUB/H2-style bottleneck hunting needs (PAPERS.md).

Works from live :class:`~repro_torch.obs.span.Span` objects or from a flight
recorder dump (whose span entries are ``Span.summary()`` dicts); flight
*event* entries become "i" instant events on the pod lane.

Stdlib-pure.
"""
from __future__ import annotations

import json
import pathlib
from typing import Iterable, Mapping

CHROME_TRACE_SCHEMA = 1

_CONTROLLER = "controller"


def _as_summary(sp) -> dict:
    return sp if isinstance(sp, Mapping) else sp.summary()


def chrome_trace(spans: Iterable = (), events: Iterable[Mapping] = (), *,
                 dump: Mapping | None = None) -> dict:
    """Build a Chrome-trace JSON object (``{"traceEvents": [...]}``).

    ``spans`` accepts :class:`Span` objects or their ``summary()`` dicts;
    ``events`` accepts flight-recorder event entries.  Pass ``dump=`` to
    export a flight dump directly (its entries are split by kind).
    """
    spans = [_as_summary(s) for s in spans]
    events = list(events)
    if dump is not None:
        for e in dump.get("entries", ()):
            (spans if e.get("kind") == "span" else events).append(e)

    # Deterministic pid/tid assignment: controller first, then pods by name;
    # track ids in first-seen order per process.
    pods = sorted({s.get("pod") for s in spans if s.get("pod")}
                  | {e.get("pod") for e in events if e.get("pod")})
    pid_of = {_CONTROLLER: 0, **{p: i + 1 for i, p in enumerate(pods)}}
    tid_of: dict[tuple, int] = {}

    out = []
    for name, pid in sorted(pid_of.items(), key=lambda kv: kv[1]):
        out.append({"ph": "M", "name": "process_name", "pid": pid, "tid": 0,
                    "args": {"name": name if name == _CONTROLLER
                             else f"pod:{name}"}})

    def tid(pid: int, track: str) -> int:
        key = (pid, track)
        if key not in tid_of:
            tid_of[key] = len([k for k in tid_of if k[0] == pid])
            out.append({"ph": "M", "name": "thread_name", "pid": pid,
                        "tid": tid_of[key], "args": {"name": track}})
        return tid_of[key]

    for s in spans:
        if s.get("dur_s") is None:
            continue
        pid = pid_of.get(s.get("pod") or _CONTROLLER, 0)
        args = {"step": s.get("step"), **(s.get("tags") or {})}
        if s.get("modeled_s") is not None:
            args["modeled_s"] = s["modeled_s"]
            args["residual"] = s.get("residual")
        out.append({"ph": "X", "name": s["name"], "cat": s.get("cat", "phase"),
                    "pid": pid, "tid": tid(pid, s.get("track") or "phase"),
                    "ts": s["t0_s"] * 1e6, "dur": s["dur_s"] * 1e6,
                    "args": args})

    for e in events:
        pid = pid_of.get(e.get("pod") or _CONTROLLER, 0)
        args = {k: v for k, v in e.items()
                if k not in ("kind", "event", "t_s", "pod")}
        out.append({"ph": "i", "name": e.get("event", "event"), "cat": "event",
                    "pid": pid, "tid": tid(pid, "events"), "s": "p",
                    "ts": float(e.get("t_s", 0.0)) * 1e6, "args": args})

    return {"traceEvents": out, "displayTimeUnit": "ms",
            "otherData": {"schema": CHROME_TRACE_SCHEMA}}


def write_chrome_trace(path, trace: Mapping) -> str:
    p = pathlib.Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text(json.dumps(validate_chrome_trace(trace)) + "\n")
    return str(p)


def load_chrome_trace(path) -> dict:
    return validate_chrome_trace(json.loads(pathlib.Path(path).read_text()))


def validate_chrome_trace(trace: Mapping) -> dict:
    """Check the invariants the Chrome/Perfetto loader needs; raises
    ``ValueError`` on violation (the CI trace-smoke contract)."""
    if not isinstance(trace, Mapping) or "traceEvents" not in trace:
        raise ValueError("chrome trace must be a dict with 'traceEvents'")
    named: set[tuple[int, int]] = set()
    for ev in trace["traceEvents"]:
        ph = ev.get("ph")
        if ph not in ("X", "M", "i"):
            raise ValueError(f"unsupported event phase {ph!r}: {ev}")
        for f in ("name", "pid", "tid"):
            if f not in ev:
                raise ValueError(f"trace event missing {f!r}: {ev}")
        if ph == "M":
            if ev["name"] == "thread_name":
                named.add((ev["pid"], ev["tid"]))
        elif ph == "X":
            if "ts" not in ev or "dur" not in ev:
                raise ValueError(f"'X' event missing ts/dur: {ev}")
            if ev["dur"] < 0:
                raise ValueError(f"negative duration: {ev}")
            if (ev["pid"], ev["tid"]) not in named:
                raise ValueError(f"'X' event on unnamed track "
                                 f"({ev['pid']},{ev['tid']}): {ev['name']}")
        elif ph == "i" and "ts" not in ev:
            raise ValueError(f"'i' event missing ts: {ev}")
    return dict(trace)


# ---------------------------------------------------------------------------
# step_report: the terminal-sized view
# ---------------------------------------------------------------------------

def step_report(spans: Iterable, *, top: int = 8) -> str:
    """Per-op time-share table + worst modeled↔measured residuals.

    The at-a-glance answer to "where did the step go, and where does the
    model disagree with the machine" — the text twin of the Chrome trace.
    """
    spans = [_as_summary(s) for s in spans]
    coll = [s for s in spans if s.get("cat") == "collective"
            and s.get("dur_s") is not None]
    if not coll:
        return "step_report: no collective spans recorded"

    by_op: dict[tuple, dict] = {}
    for s in coll:
        t = s.get("tags") or {}
        key = (t.get("op", s["name"]), t.get("size_class", "?"),
               t.get("backend", "?"))
        agg = by_op.setdefault(key, {"n": 0, "sum": 0.0, "modeled": 0.0})
        agg["n"] += 1
        agg["sum"] += s["dur_s"]
        if s.get("modeled_s"):
            agg["modeled"] += s["modeled_s"]
    total = sum(a["sum"] for a in by_op.values())

    lines = [f"collective time share ({len(coll)} dispatches, "
             f"{total * 1e3:.3f} ms total)",
             f"  {'op':<16} {'class':<7} {'backend':<8} {'n':>5} "
             f"{'total_ms':>10} {'share':>7} {'meas/model':>10}"]
    for key, agg in sorted(by_op.items(),
                           key=lambda kv: -kv[1]["sum"]):
        ratio = (f"{agg['sum'] / agg['modeled']:10.2f}"
                 if agg["modeled"] else f"{'-':>10}")
        lines.append(f"  {key[0]:<16} {key[1]:<7} {key[2]:<8} "
                     f"{agg['n']:>5} {agg['sum'] * 1e3:>10.3f} "
                     f"{agg['sum'] / total:>6.1%} {ratio}")

    resid = sorted((s for s in coll if s.get("residual") is not None),
                   key=lambda s: -abs(__import__("math").log(s["residual"])))
    if resid:
        lines.append(f"top residuals (|log measured/modeled|, worst {top}):")
        for s in resid[:top]:
            t = s.get("tags") or {}
            lines.append(
                f"  {t.get('op', s['name']):<16} {t.get('size_class', '?'):<7}"
                f" {t.get('backend', '?'):<8} step={s.get('step')!s:<6}"
                f" measured={s['dur_s'] * 1e3:9.3f}ms"
                f" modeled={s['modeled_s'] * 1e3:9.3f}ms"
                f" ratio={s['residual']:8.2f}")
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# Modeled traces (dryrun: no dispatches, only the simulator's plan)
# ---------------------------------------------------------------------------

def modeled_spans(table, cluster, *, step: int = 0) -> list[dict]:
    """Synthesize span summaries from a policy table priced on ``cluster`` —
    what ``launch.dryrun --trace`` exports when nothing actually runs.  One
    span per policy-table row, laid end-to-end per op track, measured time
    = modeled time (residual 1.0 by construction)."""
    from repro_torch.core import simulator as sim
    from repro_torch.plan.autotuner import CLASS_REP_BYTES

    out, t = [], 0.0
    cells = []
    for (op, cls), pol in table.rows:
        # wildcard-class rows expand to one span per concrete class
        for c in (CLASS_REP_BYTES if cls == "*" else (cls,)):
            cells.append(((op, c), pol))
    for (op, cls), pol in sorted(cells, key=lambda kv: kv[0]):
        nbytes = float(CLASS_REP_BYTES[cls])
        mode = pol.mode
        if mode == "auto":
            mode = "hier" if len(cluster.pods) > 1 else "flat"
        try:
            dt = float(sim.collective_time(
                op, nbytes, cluster, mode,
                n_channels=max(int(pol.n_channels), 1), backend=pol.backend,
                n_stripes=max(int(pol.n_stripes), 1)
                if pol.backend == "pallas" else 1))
        except Exception:
            continue
        out.append({"span_schema": 1, "id": len(out), "name": op,
                    "cat": "collective", "track": f"comm:{op}", "t0_s": t,
                    "dur_s": dt, "depth": 0, "parent": None, "step": step,
                    "pod": None, "modeled_s": dt, "residual": 1.0,
                    "tags": {"op": op, "size_class": cls,
                             "backend": pol.backend, "mode": pol.mode,
                             "n_channels": int(pol.n_channels),
                             "n_stripes": int(pol.n_stripes),
                             "nbytes": int(nbytes), "modeled": True}})
        t += dt
    return out
