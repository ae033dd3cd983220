"""Flight recorder: a bounded ring of the last N spans/events, dumped as a
post-mortem JSON on faults (DESIGN.md §16).

Counterpart of ``repro/obs/flight.py``; the dump format is the reference's.

The black-box pattern: keep only recent telemetry in a fixed-size deque
(memory bounded no matter how long the run), and when something goes wrong —
a hang escalation, a pod eviction, a chaos-script fault — snapshot the ring
into a schema-versioned dump.  ``run_elastic`` wires the triggers
(:class:`repro_torch.obs.Telemetry` owns the policy of *when*); this module owns
the ring and the dump format.

A dump is also the online calibration feed: every collective span in it
carries ``(op, size_class, backend, mode, n_channels, n_stripes, nbytes)``
tags plus measured and modeled seconds, which
:func:`repro_torch.plan.measured.rows_from_flight` aggregates into
:class:`~repro_torch.plan.measured.CalibrationRow`\\ s — the always-on counterpart
of the committed ``BENCH_comm.json`` (DESIGN.md §14).

Stdlib-pure.
"""
from __future__ import annotations

import collections
import json
import pathlib
import threading
from typing import Mapping

FLIGHT_SCHEMA_VERSION = 1

DEFAULT_CAPACITY = 4096


class FlightRecorder:
    """Bounded span/event ring with post-mortem dumps.

    Implements the tracer sink protocol (:meth:`on_span`); events from the
    elastic/transport layers land via :meth:`on_event`.  ``dropped`` counts
    entries the ring evicted — a dump records it so a reader knows the
    window is partial.
    """

    def __init__(self, capacity: int = DEFAULT_CAPACITY):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self._buf: collections.deque = collections.deque(maxlen=self.capacity)
        self._total = 0
        self._lock = threading.Lock()    # the mesh's rank threads append

    def __len__(self) -> int:
        return len(self._buf)

    @property
    def dropped(self) -> int:
        return self._total - len(self._buf)

    # -- intake -------------------------------------------------------------

    def on_span(self, sp) -> None:
        """Tracer sink: record one finished span (its JSON digest)."""
        self._add({"kind": "span", **sp.summary()})

    def on_event(self, event: str, **payload) -> None:
        """Record one typed occurrence (pod event, hang, chaos action,
        failover, epoch change) — ``payload`` must be JSON-friendly."""
        self._add({"kind": "event", "event": str(event), **payload})

    def _add(self, entry: dict) -> None:
        with self._lock:
            self._total += 1
            self._buf.append(entry)

    # -- dumps --------------------------------------------------------------

    def dump(self, reason: str, *, step: int | None = None) -> dict:
        """Snapshot the ring (oldest first) into a schema-versioned dump."""
        with self._lock:
            entries = [dict(e) for e in self._buf]
            total = self._total
        return {
            "flight_schema": FLIGHT_SCHEMA_VERSION,
            "reason": str(reason),
            "step": step,
            "capacity": self.capacity,
            "n_total": total,
            "dropped": total - len(entries),
            "entries": entries,
        }

    def dump_to(self, path, reason: str, *, step: int | None = None) -> str:
        p = pathlib.Path(path)
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(json.dumps(validate_dump(self.dump(reason, step=step)),
                                indent=1, sort_keys=True) + "\n")
        return str(p)


def validate_dump(dump: Mapping) -> dict:
    """Schema check of one flight dump; raises ``ValueError`` on violation.
    The contract the CI trace smoke and ``rows_from_flight`` lean on."""
    if not isinstance(dump, Mapping):
        raise ValueError(f"flight dump must be a dict, got {type(dump)}")
    if dump.get("flight_schema") != FLIGHT_SCHEMA_VERSION:
        raise ValueError(f"unsupported flight_schema "
                         f"{dump.get('flight_schema')!r} "
                         f"(recorder speaks {FLIGHT_SCHEMA_VERSION})")
    for key in ("reason", "capacity", "n_total", "dropped", "entries"):
        if key not in dump:
            raise ValueError(f"flight dump missing {key!r}")
    entries = dump["entries"]
    if len(entries) > dump["capacity"]:
        raise ValueError(f"{len(entries)} entries exceed capacity "
                         f"{dump['capacity']}")
    if dump["dropped"] != dump["n_total"] - len(entries):
        raise ValueError("dropped/n_total/entries counts disagree")
    for e in entries:
        kind = e.get("kind")
        if kind == "span":
            for f in ("name", "cat", "track", "t0_s", "tags"):
                if f not in e:
                    raise ValueError(f"span entry missing {f!r}: {e}")
        elif kind == "event":
            if "event" not in e:
                raise ValueError(f"event entry missing 'event': {e}")
        else:
            raise ValueError(f"unknown flight entry kind {kind!r}")
    return dict(dump)


def load_dump(path) -> dict:
    return validate_dump(json.loads(pathlib.Path(path).read_text()))
