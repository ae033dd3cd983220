"""Nestable spans + the collective span source (DESIGN.md §16).

Counterpart of ``repro/obs/span.py``.  A :class:`Span` is one timed region
(a collective dispatch, a train step, a probe, any ``with tracer.span(...)``
block) carried as plain data, so every consumer (the flight recorder's ring,
the metrics registry, the Chrome-trace exporter) subscribes to one stream.
The :class:`Tracer` owns the open-span stacks (nesting), the wall clock
(injectable, so tests are deterministic), and the simulator pricing cache
that stamps each *collective* span with the alpha-beta model's time for
exactly the policy that dispatched it: a span carries its own
modeled-vs-measured residual.

The port's ranks are threads of one process (``core.mesh.ThreadMesh``) that
dispatch at once, so, unlike the reference's single-threaded tracer
(DESIGN_TORCH.md §24):

* the open-span stack is per thread: a span nests under its own thread's
  open span, never under another rank's;
* a span opened on a mesh rank's thread carries ``tags["rank"]`` and, on a
  mesh with a "pod" axis, ``pod="pod<i>"`` (the name ``launch.mesh.
  cluster_for_mesh`` gives island i), so the Chrome trace's per-pod lanes
  are the mesh's islands; off a mesh (or with an explicit ``pod=``) a span
  is what the reference would record, byte for byte;
* span ids, the ``spans`` list and the sinks are updated under one lock.

The dispatch hook lives in ``repro_torch.core.hetccl._call``: every dispatch
is recorded (the port has no jit to hide one).  A collective span's
``dur_s`` is the host wall time of the call on its rank's thread: on the
card, the enqueue of its kernels plus its waits at the mesh's barriers, not
the device time of its kernels (the ranks share one stream).  No span
synchronizes the device.

Stdlib-pure: the simulator and mesh imports are lazy.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
from typing import Any, Callable, Iterable, Mapping

from repro_torch.comm.policy import size_class

SPAN_SCHEMA_VERSION = 1

CAT_COLLECTIVE = "collective"
CAT_STEP = "step"
CAT_PHASE = "phase"


@dataclasses.dataclass
class Span:
    """One timed region.  ``dur_s`` is None while the span is open; a
    finished collective span with a modeled price exposes ``residual``
    (measured/modeled, the ratio convention of
    :class:`repro_torch.plan.measured.CalibrationRow`).  ``row`` is the
    dispatch row ``(op, size class, variant, CommPolicy)`` of a collective
    span made by ``hetccl._call`` (not part of the wire form)."""

    id: int
    name: str
    cat: str
    track: str
    t0_s: float
    dur_s: float | None = None
    depth: int = 0
    parent: int | None = None
    step: int | None = None
    pod: str | None = None
    tags: dict = dataclasses.field(default_factory=dict)
    modeled_s: float | None = None
    row: Any = dataclasses.field(default=None, repr=False, compare=False)

    @property
    def residual(self) -> float | None:
        """measured / modeled wall time (None until both exist)."""
        if self.dur_s is None or not self.modeled_s:
            return None
        return self.dur_s / self.modeled_s

    def summary(self) -> dict:
        """JSON-friendly digest: the flight-recorder / export wire form."""
        return {"span_schema": SPAN_SCHEMA_VERSION, "id": self.id,
                "name": self.name, "cat": self.cat, "track": self.track,
                "t0_s": self.t0_s, "dur_s": self.dur_s, "depth": self.depth,
                "parent": self.parent, "step": self.step, "pod": self.pod,
                "tags": dict(self.tags), "modeled_s": self.modeled_s,
                "residual": self.residual}


def _mesh_rank() -> tuple[int | None, str | None]:
    """(rank, pod name) of the calling mesh rank, or (None, None) off a mesh."""
    from repro_torch.core import mesh
    m = getattr(mesh._tls, "mesh", None)
    if m is None:
        return None, None
    r = mesh._tls.rank
    pod = f"pod{m.axis_index(r, 'pod')}" if "pod" in m.axes else None
    return r, pod


class Tracer:
    """Nestable span recording with sink fan-out, safe under the mesh's
    rank threads.

    ``sinks`` are objects with an ``on_span(span)`` method (the flight
    recorder and the fleet metrics registry); each *finished* span is handed
    to every sink, under the tracer's lock.  ``enabled=False`` (or
    :meth:`disable`) turns :meth:`collective` into a no-op context; the
    dispatch hook also short-circuits before calling in, so with no tracer
    installed the hot path reads one attribute more than it did.

    ``cluster`` (a :class:`repro_torch.core.topology.ClusterSpec`) is the
    pricing side: with it set, every collective span gets the simulator's
    modeled time for its exact ``(op, nbytes, policy)``, memoized.

    ``comm_epoch`` is stamped into every collective span's tags.
    """

    def __init__(self, *, cluster=None, clock: Callable[[], float] =
                 time.perf_counter, sinks: Iterable = (), enabled: bool = True,
                 comm_epoch: int = 0):
        self.cluster = cluster
        self.enabled = enabled
        self.comm_epoch = comm_epoch
        self.sinks = list(sinks)
        self.spans: list[Span] = []
        self._clock = clock
        self._local = threading.local()
        self._lock = threading.RLock()
        self._next_id = 0
        self._step: int | None = None
        self._extra: dict = {}
        self._price_cache: dict[tuple, float | None] = {}

    # -- lifecycle ----------------------------------------------------------

    def set_step(self, step: int | None) -> None:
        """Current training step, stamped into subsequently opened spans."""
        self._step = step

    def enable(self) -> None:
        self.enabled = True

    def disable(self) -> None:
        self.enabled = False

    @property
    def _stack(self) -> list[Span]:
        """The calling thread's open spans."""
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    @property
    def open_depth(self) -> int:
        """Open spans of the calling thread."""
        return len(self._stack)

    # -- span plumbing ------------------------------------------------------

    def _new(self, name, cat, track, t0, dur, pod, step, tags, modeled_s) -> Span:
        stack = self._stack
        tags = {**self._extra, **dict(tags or {})}
        rank, mesh_pod = _mesh_rank()
        if rank is not None:
            tags.setdefault("rank", rank)
            if pod is None:
                pod = mesh_pod
        with self._lock:
            sid = self._next_id
            self._next_id += 1
        return Span(id=sid, name=name, cat=cat,
                    track=track if track is not None else cat, t0_s=t0,
                    dur_s=dur, depth=len(stack),
                    parent=stack[-1].id if stack else None,
                    step=self._step if step is None else step, pod=pod,
                    tags=tags, modeled_s=modeled_s)

    def begin(self, name: str, cat: str = CAT_PHASE, *,
              track: str | None = None, pod: str | None = None,
              step: int | None = None, tags: Mapping | None = None,
              modeled_s: float | None = None) -> Span:
        """Open a span nested under the calling thread's open span."""
        sp = self._new(name, cat, track, self._clock(), None, pod, step, tags,
                       modeled_s)
        self._stack.append(sp)
        return sp

    def end(self, sp: Span) -> Span:
        """Close ``sp`` (and, stack-safely, any span leaked open inside it on
        this thread)."""
        now = self._clock()
        stack = self._stack
        while stack:
            top = stack.pop()
            if top.dur_s is None:
                top.dur_s = now - top.t0_s
            self._finish(top)
            if top is sp:
                break
        return sp

    def _finish(self, sp: Span) -> None:
        with self._lock:
            self.spans.append(sp)
            for sink in self.sinks:
                sink.on_span(sp)

    def record(self, name: str, cat: str, dur_s: float, *,
               track: str | None = None, pod: str | None = None,
               step: int | None = None, tags: Mapping | None = None,
               modeled_s: float | None = None) -> Span:
        """Record an already-measured region as a closed span (e.g. the
        train loop's own step timing): ``t0`` is back-dated by ``dur_s``."""
        sp = self._new(name, cat, track, self._clock() - dur_s, dur_s, pod,
                       step, tags, modeled_s)
        self._finish(sp)
        return sp

    @contextlib.contextmanager
    def span(self, name: str, cat: str = CAT_PHASE, **tags):
        """``with tracer.span("restore", phase="ckpt"): ...``: the general
        nestable region."""
        sp = self.begin(name, cat, tags=tags)
        try:
            yield sp
        finally:
            self.end(sp)

    @contextlib.contextmanager
    def extra(self, **tags):
        """Merge ``tags`` into every span opened inside the context (how the
        probe runner marks its dispatches ``probe=True``)."""
        prev = self._extra
        self._extra = {**prev, **tags}
        try:
            yield
        finally:
            self._extra = prev

    # -- the collective span source (the hetccl._call hook) -----------------

    def price(self, op: str, nbytes: float, policy) -> float | None:
        """Simulator price of ``(op, nbytes, policy)`` on the bound cluster
        (None without one).  Memoized: dispatch repeats the same cells."""
        if self.cluster is None:
            return None
        key = (op, int(nbytes), policy)
        cached = self._price_cache.get(key, self)
        if cached is not self:
            return cached
        from repro_torch.core import simulator as sim
        mode = policy.mode
        if mode == "auto":      # unresolved facade row: price the default
            n_pods = len(getattr(self.cluster, "pods", ()) or ())
            mode = "hier" if n_pods > 1 else "flat"
        try:
            val = float(sim.collective_time(
                op, float(nbytes), self.cluster, mode,
                n_channels=max(int(policy.n_channels), 1),
                backend=policy.backend,
                n_stripes=max(int(policy.n_stripes), 1)
                if policy.backend == "pallas" else 1,
                wire_quant=getattr(policy, "wire_quant", None)))
        except Exception:
            val = None          # unpriceable op: the span stays
        with self._lock:
            self._price_cache[key] = val
        return val

    @contextlib.contextmanager
    def collective(self, op: str, nbytes: float, policy, *,
                   pod: str | None = None, size_class: str | None = None,
                   row=None):
        """Record one dispatch as a span tagged with the full policy
        identity: the instrumented hook of ``hetccl._call``.  ``size_class``
        is the class the call was dispatched under (the communicator's table
        bounds; the default bounds when None); ``row`` the dispatch row,
        kept on the span.  The span is finalized even when the dispatch
        raises; the error type lands in the tags."""
        if not self.enabled:
            yield None
            return
        cls = size_class if size_class is not None else _default_class(nbytes)
        sp = self.begin(op, CAT_COLLECTIVE, track=f"comm:{op}", pod=pod,
                        tags={"op": op, "size_class": cls,
                              "backend": policy.backend, "mode": policy.mode,
                              "n_channels": int(policy.n_channels),
                              "n_stripes": int(policy.n_stripes),
                              "wire_quant": getattr(policy, "wire_quant",
                                                    None),
                              "nbytes": int(nbytes),
                              "comm_epoch": self.comm_epoch},
                        modeled_s=self.price(op, nbytes, policy))
        sp.row = row
        try:
            yield sp
        except BaseException as e:
            sp.tags["error"] = type(e).__name__
            raise
        finally:
            self.end(sp)

    # -- views --------------------------------------------------------------

    def collective_spans(self) -> list[Span]:
        with self._lock:
            return [s for s in self.spans if s.cat == CAT_COLLECTIVE]

    def dispatch_rows(self):
        """``Counter`` of the dispatch rows ``(op, size class, variant,
        CommPolicy)`` of the recorded collective spans: equal to
        ``hetccl.dispatches`` over the same calls."""
        import collections
        return collections.Counter(s.row for s in self.collective_spans()
                                   if s.row is not None)

    def dispatched_cells(self) -> set[tuple[str, str, str]]:
        """Every ``(op, size_class, backend)`` cell a dispatch hit: the
        coverage set ``plan.measured.rows_from_flight`` reproduces from a
        flight dump."""
        return {(s.tags["op"], s.tags["size_class"], s.tags["backend"])
                for s in self.collective_spans() if "op" in s.tags}

    def dispatched_quant_cells(self) -> set[tuple[str, str, str, str | None]]:
        """``(op, size_class, backend, wire_quant)`` dispatch coverage."""
        return {(s.tags["op"], s.tags["size_class"], s.tags["backend"],
                 s.tags.get("wire_quant"))
                for s in self.collective_spans() if "op" in s.tags}


def _default_class(nbytes: float) -> str:
    return size_class(nbytes)
