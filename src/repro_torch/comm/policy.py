"""Collective policies and the per-op, size-classed PolicyTable (DESIGN.md §12).

HetCCL's real API is communicator-scoped: an NCCL/RCCL communicator is
created once per process group and every collective issued on it is tuned
per (op, payload) against that group.  H2 (§4) and Holmes (§5) both show the
winning schedule differs *per collective and per message size* — a tiny
broadcast wants the flat latency-optimal path while a large gradient
reduce-scatter wants the pipelined, striped DMA rings.  A single global
(mode, backend, channels, stripes) tuple structurally cannot express that.

Counterpart of ``repro/comm/policy.py``, kept as the port's own copy (the
port imports nothing of ``repro``).  This module is the pure-data half of
``repro_torch.comm`` (stdlib only, importable without torch):

* :class:`CommPolicy` — one fully-specified collective schedule
  (mode, backend, n_channels, n_stripes, cross_dtype);
* :func:`size_class` — deterministic payload bucketing
  (``small`` ≤ 64 KiB < ``medium`` ≤ 8 MiB < ``large`` by default);
* :class:`PolicyTable` — the resolved mapping ``(op, size_class) ->
  CommPolicy`` a :class:`~repro_torch.comm.communicator.Communicator` owns, with
  wildcard rows and a default policy so a legacy single-policy config
  compiles into a one-row table (:meth:`PolicyTable.single` — the
  ``HetCCLConfig`` facade contract, DESIGN.md §12).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Iterable, Mapping

# Size-class boundaries (inclusive upper edges): payloads of ≤ bounds[0]
# bytes are "small", ≤ bounds[1] "medium", anything larger "large".
DEFAULT_SIZE_CLASS_BOUNDS = (64 * 1024, 8 * 1024 * 1024)

# Ops whose cross-island stage is ring-backed — the only ops a ``pallas``
# backend row (and therefore a ``wire_quant`` codec, DESIGN.md §17) can
# change.
RING_BACKED_OPS = frozenset(
    {"all_reduce", "all_gather", "reduce_scatter", "reduce"})
SIZE_CLASSES = ("small", "medium", "large")
WILDCARD = "*"

MODES = ("flat", "hier", "pipelined")
BACKENDS = ("xla", "pallas")
# Wire quantization codecs (DESIGN.md §17); None = uncompressed wire.
WIRE_QUANTS = ("int8", "fp8")


def size_class(nbytes: float,
               bounds: tuple[int, int] = DEFAULT_SIZE_CLASS_BOUNDS) -> str:
    """Deterministic bucket of a payload size: boundaries belong to the
    smaller class (64 KiB is ``small``, 64 KiB + 1 B is ``medium``)."""
    lo, hi = bounds
    if not 0 < lo < hi:
        raise ValueError(f"size-class bounds must be 0 < lo < hi, got {bounds}")
    if nbytes <= lo:
        return "small"
    if nbytes <= hi:
        return "medium"
    return "large"


@dataclasses.dataclass(frozen=True)
class CommPolicy:
    """One collective schedule, fully specified (DESIGN.md §12).

    mode:        "flat" | "hier" | "pipelined" ("auto" is accepted as input
                 and resolved against the communicator's pod axis at
                 creation — a stored table row is always concrete).
    backend:     "xla" | "pallas" ring implementation (DESIGN.md §10).
    n_channels:  pipeline channel budget of the "pipelined" mode (1 for the
                 serial modes).
    n_stripes:   multi-NIC stripe count of the DMA rings (DESIGN.md §11;
                 collapsed to 1 for the xla backend at communicator
                 creation).
    cross_dtype: optional wire dtype of the cross-island stage (gradient
                 compression; a dtype name string keeps the policy hashable
                 and JSON-friendly).
    wire_quant:  optional wire quantization codec of the pallas rings
                 (None | "int8" | "fp8", DESIGN.md §17): per-chunk absmax
                 scaling with an f32 accumulator and the scale sidecar on
                 the wire.  Collapsed to None for the xla backend and
                 non-ring ops at communicator creation — only the DMA
                 rings carry a quantized payload.
    """

    mode: str = "flat"
    backend: str = "xla"
    n_channels: int = 1
    n_stripes: int = 1
    cross_dtype: Any = None
    wire_quant: str | None = None

    def __post_init__(self):
        if self.mode not in MODES + ("auto",):
            raise ValueError(
                f"unknown collective mode {self.mode!r}; "
                f"expected one of {MODES + ('auto',)}")
        if self.backend not in BACKENDS:
            raise ValueError(
                f"unknown collective backend {self.backend!r}; "
                f"expected one of {BACKENDS}")
        if int(self.n_channels) < 1:
            raise ValueError(f"n_channels must be >= 1, got {self.n_channels}")
        if int(self.n_stripes) < 1:
            raise ValueError(f"n_stripes must be >= 1, got {self.n_stripes}")
        if self.wire_quant is not None:
            if self.wire_quant not in WIRE_QUANTS:
                raise ValueError(
                    f"unknown wire_quant codec {self.wire_quant!r}; "
                    f"expected None or one of {WIRE_QUANTS}")
            object.__setattr__(self, "wire_quant", str(self.wire_quant))

    def summary(self) -> dict:
        """JSON-friendly digest (dry-run records, perf_log rows)."""
        return {"mode": self.mode, "backend": self.backend,
                "n_channels": int(self.n_channels),
                "n_stripes": int(self.n_stripes),
                "cross_dtype": str(self.cross_dtype)
                if self.cross_dtype is not None else None,
                "wire_quant": self.wire_quant}

    def label(self) -> str:
        """Compact human-readable tag (figure/row names)."""
        base = f"{self.mode}-{self.backend}-c{self.n_channels}-k{self.n_stripes}"
        return base if self.wire_quant is None else f"{base}-q{self.wire_quant}"


def _norm_key(key) -> tuple[str, str]:
    """Row keys: ``(op, size_class)``, or a bare op meaning all classes."""
    if isinstance(key, str):
        return (key, WILDCARD)
    op, cls = key
    if cls not in SIZE_CLASSES + (WILDCARD,):
        raise ValueError(
            f"unknown size class {cls!r}; expected one of "
            f"{SIZE_CLASSES + (WILDCARD,)}")
    return (str(op), str(cls))


@dataclasses.dataclass(frozen=True)
class PolicyTable:
    """The resolved ``(op, size_class) -> CommPolicy`` map a communicator
    owns (DESIGN.md §12).

    Lookup precedence: exact ``(op, size_class)`` row -> ``(op, "*")``
    wildcard row -> the table :attr:`default`.  Rows are normalized to a
    sorted tuple so two tables with the same content compare (and hash)
    equal bit-for-bit — the facade contract relies on that.
    """

    rows: tuple[tuple[tuple[str, str], CommPolicy], ...] = ()
    default: CommPolicy = CommPolicy()
    bounds: tuple[int, int] = DEFAULT_SIZE_CLASS_BOUNDS

    def __post_init__(self):
        norm = tuple(sorted((_norm_key(k), v) for k, v in self.rows))
        if len({k for k, _ in norm}) != len(norm):
            raise ValueError(f"duplicate PolicyTable rows: {norm}")
        for _, v in norm:
            if not isinstance(v, CommPolicy):
                raise TypeError(f"PolicyTable rows must map to CommPolicy, "
                                f"got {v!r}")
        object.__setattr__(self, "rows", norm)
        object.__setattr__(self, "bounds",
                           (int(self.bounds[0]), int(self.bounds[1])))
        size_class(1, self.bounds)          # validates the bounds
        object.__setattr__(self, "_index", dict(norm))

    @classmethod
    def single(cls, policy: CommPolicy,
               bounds: tuple[int, int] = DEFAULT_SIZE_CLASS_BOUNDS
               ) -> "PolicyTable":
        """The one-row table a legacy single-policy config compiles into:
        every (op, size_class) resolves to ``policy``."""
        return cls(rows=(), default=policy, bounds=bounds)

    @classmethod
    def of(cls, mapping: Mapping | Iterable, default: CommPolicy | None = None,
           bounds: tuple[int, int] = DEFAULT_SIZE_CLASS_BOUNDS
           ) -> "PolicyTable":
        """Build from ``{(op, size_class) | op: CommPolicy}`` (bare-op keys
        mean every size class).  ``default`` falls back to a fresh flat
        policy when omitted."""
        items = mapping.items() if isinstance(mapping, Mapping) else mapping
        return cls(rows=tuple(items), default=default or CommPolicy(),
                   bounds=bounds)

    def lookup(self, op: str, cls: str) -> CommPolicy:
        """Policy for ``(op, size_class)`` under the precedence above."""
        idx = self._index
        hit = idx.get((op, cls))
        if hit is None:
            hit = idx.get((op, WILDCARD))
        return hit if hit is not None else self.default

    def resolve(self, op: str, nbytes: float) -> CommPolicy:
        """Policy for one concrete payload: deterministic size-class
        bucketing, then :meth:`lookup`."""
        return self.lookup(op, size_class(nbytes, self.bounds))

    def with_cross_dtype(self, cross_dtype) -> "PolicyTable":
        """A copy with ``cross_dtype`` filled into every policy that leaves
        it unset (explicit row values win) — how a run-level compression
        knob (``RunConfig.cross_dtype``) composes with a planner-emitted
        table that doesn't tune compression."""
        def fill(p: CommPolicy) -> CommPolicy:
            if p.cross_dtype is not None:
                return p
            return dataclasses.replace(p, cross_dtype=cross_dtype)
        return PolicyTable(rows=tuple((k, fill(p)) for k, p in self.rows),
                           default=fill(self.default), bounds=self.bounds)

    def with_wire_quant(self, wire_quant: str | None) -> "PolicyTable":
        """A copy with ``wire_quant`` filled into every policy that leaves
        it unset — same exact-row-wins composition contract as
        :meth:`with_cross_dtype` (DESIGN.md §17): a planner-emitted quant
        row is never overridden by the run-level knob, and filling ``None``
        is the identity (run knob absent, planner rows stand)."""
        if wire_quant is None:
            return self

        def fill(p: CommPolicy) -> CommPolicy:
            if p.wire_quant is not None:
                return p
            return dataclasses.replace(p, wire_quant=wire_quant)
        return PolicyTable(rows=tuple((k, fill(p)) for k, p in self.rows),
                           default=fill(self.default), bounds=self.bounds)

    def distinct_policies(self) -> tuple[CommPolicy, ...]:
        """The set of distinct policies the table can resolve to (dedup'd,
        deterministic order) — the acceptance check for a genuinely per-op
        table is ``len(...) >= 2``."""
        out: list[CommPolicy] = []
        for _, p in self.rows + ((("", ""), self.default),):
            if p not in out:
                out.append(p)
        return tuple(out)

    def summary(self) -> dict:
        """JSON-friendly digest (the dry-run record / perf_log row)."""
        return {"bounds": list(self.bounds),
                "default": self.default.summary(),
                "rows": {f"{op}/{cls}": p.summary()
                         for (op, cls), p in self.rows}}
