"""Roofline analysis of one step of the port's own program.

Counterpart of ``repro/roofline/analysis.py``.  Its HLO-free parts are
copied as they are (``_DTYPE_BYTES``, :func:`wire_and_operand_bytes`,
:class:`HLOStats`, :class:`Roofline`, with the hardware sheet passed in and
v5e the default, so a Roofline equals the reference's on the same inputs).
The reference fills ``HLOStats`` by parsing XLA's compiled HLO text
(``analyze_hlo``), which the port does not have; that parser is not ported
(ROADMAP, "Not to port").  Its counterpart here, :func:`counting`, fills the
same fields from one step of the port's program as it runs, on a mesh of
ranks, on any device (``meta`` for the dry run, the CPU, the card):

* dot FLOPs: 2·|out|·K of every matmul-class aten op (``mm``, ``addmm``,
  ``bmm``, ``baddbmm``), seen by a ``TorchDispatchMode`` on each rank's
  threads (autograd's included);
* HBM bytes: operands plus results of every dispatched aten op that is not
  a view.  In eager mode every op is a kernel boundary, so the memory term
  counts every elementwise op's traffic, where the reference's counts XLA's
  fusion boundaries;
* wire bytes: one count per collective *stage* the step runs (a function
  marked ``tacc.stage``: the rings, the native stages of the mesh, ZeRO-3's
  gathers), priced by :func:`wire_and_operand_bytes` on the stage's group,
  its payload in the wire's element width (the input's dtype, a
  ``wire_dtype``, or the codec's bytes per element), the share of stages
  over the "pod" axis apart as ``cross_pod_bytes``;
* each TACC kernel op (``KERNEL_OPS``: attention, the expert FFN, the
  grouped matmul, the SSD scan, the wire codec, the collective reduction)
  is priced once, by the function it computes: its dot FLOPs from its
  shapes and masks (:func:`kernel_dot_flops`), its bytes its inputs read and
  its outputs written once; the aten ops of whichever variant runs beneath
  it are not counted, and neither are those of its backward, which is
  priced as the gradient's own products (twice the forward's dot FLOPs)
  and bytes.  So the count of a step is the same whichever variant runs:
  the plain versions on ``meta`` or the CPU, the CUDA kernels on the card
  (DESIGN_TORCH.md §24).
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode, _get_current_dispatch_mode_stack

from repro_torch.roofline import hw

_DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "f8e4m3fn": 1, "f8e5m2": 1,
    "s16": 2, "u16": 2, "f16": 2, "bf16": 2,
    "s32": 4, "u32": 4, "f32": 4,
    "s64": 8, "u64": 8, "f64": 8, "c64": 8, "c128": 16,
}


def wire_and_operand_bytes(kind: str, g: int, out_bytes: float,
                           duplex_mult: float = 1.0) -> tuple[float, float]:
    """Ring-model (wire, operand) bytes of one collective op (the
    reference's single source of the per-op wire convention): factors apply
    to the *full logical buffer*; a reduce-scatter's out_bytes is the 1/g
    shard, so its full buffer is g * out_bytes."""
    if kind == "all-reduce":
        return 2.0 * (g - 1) / g * out_bytes, out_bytes
    if kind == "all-gather":
        return (g - 1) / g * out_bytes, out_bytes / max(g, 1)
    if kind == "reduce-scatter":
        return (g - 1) / g * (g * out_bytes), out_bytes * g
    if kind == "all-to-all":
        return (g - 1) / g * out_bytes, out_bytes
    return out_bytes * duplex_mult, out_bytes      # collective-permute


@dataclasses.dataclass
class HLOStats:
    dot_flops: float = 0.0
    hbm_bytes: float = 0.0
    wire_bytes: float = 0.0            # ring-model per-chip bytes on the wire
    cross_pod_bytes: float = 0.0       # subset of wire_bytes crossing islands
    operand_bytes: float = 0.0         # spec-literal: sum of operand sizes
    per_collective: dict = dataclasses.field(default_factory=dict)
    n_while: int = 0
    notes: list = dataclasses.field(default_factory=list)


def sum_stats(stats) -> HLOStats:
    """The sum of several ranks' counts (the work of one card that hosts
    them all)."""
    out = HLOStats()
    for s in stats:
        for f in ("dot_flops", "hbm_bytes", "wire_bytes", "cross_pod_bytes", "operand_bytes"):
            setattr(out, f, getattr(out, f) + getattr(s, f))
        for k, v in s.per_collective.items():
            agg = out.per_collective.setdefault(k, {"count": 0, "wire_bytes": 0.0})
            agg["count"] += v["count"]
            agg["wire_bytes"] += v["wire_bytes"]
    return out


@dataclasses.dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    n_devices: int
    model_flops_per_step: float         # analytic (6·N·D etc.), global
    stats: HLOStats
    xla_flops: float                    # the reference's cost_analysis; 0 here
    xla_bytes: float
    memory_per_device: dict
    hw: hw.HwSheet = hw.V5E

    @property
    def compute_s(self) -> float:
        return self.stats.dot_flops / self.hw.peak_flops

    @property
    def memory_s(self) -> float:
        return self.stats.hbm_bytes / self.hw.hbm_bw

    @property
    def collective_s(self) -> float:
        """Intra-island bytes at the island's wire speed + cross-island
        bytes at the cross wire's (serial upper bound; the overlap-aware
        step bound is max-of-terms)."""
        intra = self.stats.wire_bytes - self.stats.cross_pod_bytes
        return intra / self.hw.ici_bw + self.stats.cross_pod_bytes / self.hw.dci_bw

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def step_s(self) -> float:
        """Perfect-overlap bound: the max of the three terms."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_flops_fraction(self) -> float:
        """MODEL_FLOPS / (per-chip dot flops × chips)."""
        total_hw = self.stats.dot_flops * self.n_devices
        return self.model_flops_per_step / total_hw if total_hw else float("nan")

    @property
    def roofline_fraction(self) -> float:
        """Achievable MFU bound: useful flops / (chips × peak × step time)."""
        denom = self.n_devices * self.hw.peak_flops * self.step_s
        return self.model_flops_per_step / denom if denom else float("nan")

    def row(self) -> dict:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "devices": self.n_devices,
            "compute_s": self.compute_s, "memory_s": self.memory_s,
            "collective_s": self.collective_s, "dominant": self.dominant,
            "model_flops": self.model_flops_per_step,
            "hlo_dot_flops_per_chip": self.stats.dot_flops,
            "useful_flops_frac": self.useful_flops_fraction,
            "roofline_frac": self.roofline_fraction,
            "wire_bytes_per_chip": self.stats.wire_bytes,
            "cross_pod_bytes_per_chip": self.stats.cross_pod_bytes,
            "operand_bytes_per_chip": self.stats.operand_bytes,
            "hbm_bytes_per_chip": self.stats.hbm_bytes,
            "per_collective": self.stats.per_collective,
            "xla_flops": self.xla_flops, "xla_bytes": self.xla_bytes,
            "memory_per_device": self.memory_per_device,
        }


# ---------------------------------------------------------------------------
# The step counter
# ---------------------------------------------------------------------------

KERNEL_OPS = ("attention", "expert_ffn", "grouped_matmul", "ssd_scan",
              "collective_reduce", "wire_quantize", "wire_dequant_accum")

_aten = torch.ops.aten
# matmul-class ops -> the position of their left operand (its last dim is K)
_MM = {_aten.mm.default: 0, _aten.addmm.default: 1, _aten.bmm.default: 0,
       _aten.baddbmm.default: 1}


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def _tensors(obj) -> list:
    if isinstance(obj, torch.Tensor):
        return [obj]
    if isinstance(obj, (list, tuple)):
        return [t for o in obj for t in _tensors(o)]
    if isinstance(obj, dict):
        return [t for o in obj.values() for t in _tensors(o)]
    return []


def attention_pairs(Sq: int, Sk: int, kind: str = "causal", window: int = 0,
                    q_offset: int = 0, k_offset: int = 0, k_len=None) -> int:
    """Valid (query, key) pairs of one head under the model's mask
    (``models.attention._mask`` and the ``k_len`` prefix), counted row by
    row in closed form."""
    import numpy as np
    p = q_offset + np.arange(Sq, dtype=np.int64)
    lo = np.full(Sq, k_offset, dtype=np.int64)
    hi = np.full(Sq, k_offset + (Sk if k_len is None else int(k_len)) - 1, dtype=np.int64)
    if kind != "bidir":
        hi = np.minimum(hi, p)
    if window:
        lo = np.maximum(lo, p - int(window) + 1)
    return int(np.maximum(hi - lo + 1, 0).sum())


def kernel_dot_flops(op: str, args, kwargs) -> float:
    """Dot FLOPs of one kernel op's forward, from its shapes and masks."""
    if op == "attention":
        q, k = args[0], args[1]
        B, Sq, Hq, d = q.shape
        pairs = attention_pairs(Sq, k.shape[1], kwargs.get("kind", "causal"),
                                kwargs.get("window", 0), kwargs.get("q_offset", 0),
                                kwargs.get("k_offset", 0), kwargs.get("k_len"))
        return 4.0 * B * Hq * d * pairs              # q k^T and p v
    if op == "expert_ffn":
        E, C, D = args[0].shape
        return 6.0 * E * C * D * args[1].shape[-1]   # w1, w3, w2
    if op == "grouped_matmul":
        G, M, K = args[0].shape
        return 2.0 * G * M * K * args[1].shape[-1]
    if op == "ssd_scan":
        x, B_in = args[0], args[3]
        Bsz, S, H, P = x.shape
        N, Q = B_in.shape[-1], int(args[5])
        # per chunk and head: C B^T (2QQN), its masked product with x
        # (2QQP), the chunk's state B^T x (2QNP), the carried state's output
        # C h (2QNP)
        return Bsz * H * (S // Q) * (2.0 * Q * Q * N + 2.0 * Q * Q * P + 4.0 * Q * N * P)
    return 0.0


class _RankCounter(TorchDispatchMode):
    """One rank's counts: a dispatch mode on the rank's threads (autograd
    carries it to its own), quiet inside a kernel op or a stage."""

    def __init__(self, stats: HLOStats, live: "LiveBytes | None" = None):
        super().__init__()
        self.stats = stats
        self.live = live
        self._lock = threading.Lock()
        self._depth = threading.local()

    @property
    def suppressed(self) -> bool:
        return getattr(self._depth, "n", 0) > 0

    def quiet(self, d: int) -> None:
        self._depth.n = getattr(self._depth, "n", 0) + d

    @contextlib.contextmanager
    def quieted(self):
        self.quiet(1)
        try:
            yield
        finally:
            self.quiet(-1)

    def add(self, flops: float = 0.0, hbm: float = 0.0) -> None:
        with self._lock:
            self.stats.dot_flops += flops
            self.stats.hbm_bytes += hbm

    def add_stage(self, key: str, wire: float, operand: float, hbm: float,
                  crosses: bool) -> None:
        with self._lock:
            st = self.stats
            st.wire_bytes += wire
            st.operand_bytes += operand
            st.hbm_bytes += hbm
            if crosses:
                st.cross_pod_bytes += wire
            agg = st.per_collective.setdefault(key, {"count": 0, "wire_bytes": 0.0})
            agg["count"] += 1
            agg["wire_bytes"] += wire

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func.is_view:
            return out
        if self.live is not None:
            self.live.allocated(_tensors(out), _tensors(args))
        if self.suppressed:
            return out
        flops = _dot_flops(func, args, out)
        # operands read, results written (an in-place op's result is the
        # operand it writes)
        ins = {id(t): t for t in _tensors(args) + _tensors(kwargs)}
        outs = {id(t): t for t in _tensors(out)}
        self.add(flops, sum(_nbytes(t) for t in (*ins.values(), *outs.values())))
        return out


def _einsum_flops(eq: str, ops) -> float:
    """Dot FLOPs of an einsum as torch contracts it, operand pairs from the
    left: a pair with an index summed away is a batched matmul (2 x the
    product of every index size of the pair), one without is a product."""
    lhs, out = eq.replace(" ", "").split("->")
    terms = lhs.split(",")
    size = {}
    for t, op in zip(terms, ops):
        size.update(zip(t, op.shape))
    flops, cur = 0.0, terms[0]
    for i, t in enumerate(terms[1:], 1):
        keep = set(out).union(*terms[i + 1:])
        union = set(cur) | set(t)
        if union - keep:
            flops += 2.0 * math.prod(size[c] for c in union)
        cur = "".join(c for c in dict.fromkeys(cur + t) if c in keep)
    return flops


def _dot_flops(func, args, out) -> float:
    """Dot FLOPs of one aten op, 2·|out|·K: the matmul class, and the
    composite ops (einsum, matmul, linear) that reach the mode whole under
    ``torch.inference_mode``, where autograd does not decompose them."""
    if func in _MM:
        return 2.0 * out.numel() * args[_MM[func]].shape[-1]
    if func is _aten.einsum.default:
        return _einsum_flops(args[0], args[1])
    if func in (_aten.matmul.default, _aten.linear.default):
        return 2.0 * out.numel() * args[0].shape[-1]
    return 0.0


def _current_counter() -> _RankCounter | None:
    for m in reversed(_get_current_dispatch_mode_stack()):
        if isinstance(m, _RankCounter):
            return m
    return None


class _Enter(torch.autograd.Function):
    """Identity on a kernel op's inputs; its backward, the last of the op's
    backward nodes to run, ends the quiet span :class:`_Exit` began."""

    @staticmethod
    def forward(ctx, counter, *xs):
        ctx.counter = counter
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *gs):
        ctx.counter.quiet(-1)
        return (None, *gs)


class _Exit(torch.autograd.Function):
    """Identity on a kernel op's outputs; its backward, the first of the
    op's backward nodes, prices the op's gradient and quiets the counter
    until :class:`_Enter`'s backward."""

    @staticmethod
    def forward(ctx, counter, price, *ys):
        ctx.counter, ctx.price = counter, price
        with counter.quieted():
            return tuple(y.clone() for y in ys)

    @staticmethod
    def backward(ctx, *gs):
        ctx.counter.add(*ctx.price)
        ctx.counter.quiet(1)
        return (None, None, *gs)


class _Observer:
    """``tacc._OBSERVER`` while counting: prices kernel ops and stages for
    the rank counter of the calling thread (and passes every other call
    through)."""

    def __init__(self):
        self._shapes: dict = {}

    def kernel(self, op, impl, args, kwargs):
        c = _current_counter()
        if op not in KERNEL_OPS or c is None or c.suppressed:
            return impl(*args, **kwargs)
        flops = kernel_dot_flops(op, args, kwargs)
        ins = _tensors(args) + _tensors(kwargs)
        in_bytes = sum(_nbytes(t) for t in ins)
        grad = torch.is_grad_enabled() and any(t.requires_grad for t in ins)
        if grad:
            req = [i for i, a in enumerate(args)
                   if isinstance(a, torch.Tensor) and a.requires_grad]
            entered = _Enter.apply(c, *(args[i] for i in req))
            args = list(args)
            for i, t in zip(req, entered):
                args[i] = t
        with c.quieted():
            out = impl(*args, **kwargs)
        outs = _tensors(out)
        out_bytes = sum(_nbytes(t) for t in outs)
        c.add(flops, in_bytes + out_bytes)
        if not grad:
            return out
        diff = [t for t in outs if t.requires_grad]
        if not diff:
            return out
        exited = iter(_Exit.apply(c, (2.0 * flops, 2.0 * in_bytes + out_bytes), *diff))
        swap = {id(t): next(exited) for t in diff}
        if isinstance(out, torch.Tensor):
            return swap.get(id(out), out)
        return type(out)(swap.get(id(t), t) if isinstance(t, torch.Tensor) else t
                         for t in out)

    def _shape_only(self, fn, args, kwargs):
        """A stage on a ``ShapeMesh`` (no data): the first call of a
        signature runs its schedule, later ones reuse its result's shape."""
        x = args[0]
        key = (fn, tuple(x.shape), x.dtype, repr(args[1:]), repr(sorted(kwargs.items())))
        hit = self._shapes.get(key)
        if hit is None:
            out = fn(*args, **kwargs)
            self._shapes[key] = (tuple(out.shape), out.dtype)
            return out
        return torch.empty(hit[0], dtype=hit[1], device=x.device)

    def stage(self, kind, fn, args, kwargs, group=None):
        c = _current_counter()
        if c is None or c.suppressed:
            return fn(*args, **kwargs)
        from repro_torch.core import mesh
        m = getattr(mesh._tls, "mesh", None)
        with c.quieted():
            if isinstance(m, mesh.ShapeMesh):
                out = self._shape_only(fn, args, kwargs)
            else:
                out = fn(*args, **kwargs)
        if group is None:
            axes = args[1] if len(args) > 1 else kwargs.get("axis", kwargs.get("axes"))
            axes = (axes,) if isinstance(axes, str) else tuple(axes)
            group = (m.axis_size(axes), "pod" in axes and m.axis_size("pod") > 1)
        g, crosses = group
        x, n = args[0], out.numel()
        if kwargs.get("wire_quant"):
            from repro_torch.kernels import quant
            esize = quant.wire_bytes_per_elem(kwargs["wire_quant"])
        elif kwargs.get("wire_dtype") is not None:
            esize = kwargs["wire_dtype"].itemsize
        else:
            esize = x.element_size()
        wire, operand = wire_and_operand_bytes(kind, g, n * esize) if g > 1 else (0.0, 0.0)
        c.add_stage(kind + ("/xpod" if crosses else ""), wire, operand,
                    _nbytes(x) + _nbytes(out), crosses)
        return out


class LiveBytes:
    """The bytes of the tensors that a rank's ops made and that are still
    alive, and their high-water mark (views and in-place results are not
    new memory).  What the dry run reports as a step's live-tensor peak
    above the state it starts from."""

    def __init__(self):
        self.now = 0
        self.peak = 0
        self._lock = threading.Lock()

    def allocated(self, outs, ins) -> None:
        own = {id(t) for t in ins}
        for t in outs:
            if id(t) in own:
                continue
            n = _nbytes(t)
            with self._lock:
                self.now += n
                self.peak = max(self.peak, self.now)
            weakref.finalize(t, self._freed, n)

    def _freed(self, n: int) -> None:
        with self._lock:
            self.now -= n


@dataclasses.dataclass
class StepCount:
    """What :func:`counting` saw: ``ranks[r]`` the counts of mesh rank r
    (rank 0 for work off a mesh, on the thread that counts); with
    ``live=True``, ``live[r]`` its :class:`LiveBytes`."""

    ranks: dict = dataclasses.field(default_factory=dict)
    live: dict = dataclasses.field(default_factory=dict)

    def per_chip(self) -> HLOStats:
        """The busiest rank's counts (a chip per rank)."""
        return max(self.ranks.values(), key=lambda s: (s.dot_flops, s.wire_bytes))

    def total(self) -> HLOStats:
        """Every rank's counts summed (one card that hosts them all)."""
        return sum_stats(self.ranks.values())


_count_lock = threading.Lock()


@contextlib.contextmanager
def counting(*, live: bool = False):
    """Count everything run inside the block, per rank: on a ThreadMesh's
    rank threads (and autograd's, for them), and on this thread as rank 0.

        with analysis.counting() as sc:
            prog.step_fn(state, batch)
        stats = sc.per_chip()

    ``live=True`` also tracks each rank's live-tensor bytes
    (:class:`LiveBytes`).  One count at a time in a process."""
    from repro_torch.core import mesh, tacc
    sc = StepCount()

    def counter(r):
        with _count_lock:
            st = sc.ranks.setdefault(r, HLOStats())
            lb = sc.live.setdefault(r, LiveBytes()) if live else None
        return _RankCounter(st, lb)

    prev_obs, prev_hook = tacc._OBSERVER, mesh.RANK_HOOK
    if prev_obs is not None:
        raise RuntimeError("a step count is already running")
    tacc._OBSERVER, mesh.RANK_HOOK = _Observer(), counter
    try:
        with counter(0):
            yield sc
    finally:
        tacc._OBSERVER, mesh.RANK_HOOK = prev_obs, prev_hook


def roofline_of(count: StepCount, *, arch: str, shape: str, mesh: str,
                model_flops: float, sheet: hw.HwSheet = hw.H100,
                n_devices: int | None = None, shared: bool = False,
                memory_per_device: dict | None = None) -> Roofline:
    """The Roofline of a counted step: per chip (one rank a chip, ``sheet``,
    ``n_devices`` chips, default the ranks counted) or ``shared`` (every rank
    on one card: the ranks' sum on ``hw.H100_SHARED``)."""
    if shared:
        stats, n, sheet = count.total(), 1, hw.H100_SHARED
    else:
        stats, n = count.per_chip(), n_devices or len(count.ranks)
    return Roofline(arch=arch, shape=shape, mesh=mesh, n_devices=n,
                    model_flops_per_step=model_flops, stats=stats, xla_flops=0.0,
                    xla_bytes=0.0, memory_per_device=memory_per_device or {}, hw=sheet)
