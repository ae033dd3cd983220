"""Analytic α-β performance model of collectives and training steps on
heterogeneous clusters.

Counterpart of ``repro/core/simulator.py``; the module is jax-free there,
and the port keeps its own copy, function for function:

  time(op, n bytes, group) = α·(steps) + Σ_stage bytes_on_wire / bw_stage

with the hierarchical decomposition HetCCL uses: vendor-local stages run at
island-local bandwidth, the cross-island stage at the RDMA (or host-staged)
bandwidth, bounded by the slower endpoint (paper §5.2: "HetCCL (HET) achieves
performance bounded by the slower of the two vendor libraries").

The ``repro_torch.plan`` autotuner prices every candidate configuration with
it (:func:`planned_step_time`; cost model: DESIGN.md §9).  Every time it
returns is the model's time on the *priced* cluster (``core.topology``),
never a measurement of the port.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Sequence

from repro_torch.core.balance import HetPlan, PodProfile, make_plan, uniform_plan
from repro_torch.core.topology import (ClusterSpec, HOST_STAGED_BW, MPI_ALPHA,
                                 MPI_HOST_REDUCE_BW, PodSpec, RDMA_ALPHA)
from repro_torch.transport.stripe import StripePlan, plan_stripes


# ---------------------------------------------------------------------------
# Point-to-point (paper Fig 8 / Fig 13 / Fig 16)
# ---------------------------------------------------------------------------

def p2p_time(nbytes: float, src: PodSpec, dst: PodSpec, inter_bw: float,
             alpha: float = RDMA_ALPHA, rdma: bool = True) -> float:
    """One cross-island transfer: bounded by the slower endpoint."""
    path_bw = min(src.chip.local_link_bw * src.chip.local_links,
                  dst.chip.local_link_bw * dst.chip.local_links,
                  inter_bw)
    if not (rdma and src.rdma and dst.rdma):
        # host-staged: GPU->CPU->NIC->CPU->GPU (Fig 1a / Fig 16)
        path_bw = min(path_bw, HOST_STAGED_BW)
    return alpha + nbytes / path_bw


def p2p_bandwidth(nbytes: float, src: PodSpec, dst: PodSpec, inter_bw: float,
                  **kw) -> float:
    return nbytes / p2p_time(nbytes, src, dst, inter_bw, **kw)


# ---------------------------------------------------------------------------
# Collectives (paper Figs 7, 11, 14, 15)
# ---------------------------------------------------------------------------

_RING_FACTORS = {
    # fraction of the buffer each rank moves per link in a ring algorithm
    "all_reduce": lambda n: 2.0 * (n - 1) / n,
    "all_gather": lambda n: (n - 1) / n,
    "reduce_scatter": lambda n: (n - 1) / n,
    "reduce": lambda n: (n - 1) / n,
    "broadcast": lambda n: (n - 1) / n,
    "all_to_all": lambda n: (n - 1) / n,
}

# Ops whose explicit (ppermute / DMA) rings accumulate chunks on-device.
_REDUCING_OPS = frozenset({"all_reduce", "reduce_scatter", "reduce"})
# Chunk accumulate = read acc + read incoming + write acc per reduced byte.
REDUCE_RW_FACTOR = 3.0
# Double-buffer streams of the ring kernels; MUST equal
# kernels.ring_dma.NUM_BUFFERS (tests/test_torch_transport.py holds them
# equal).  A literal, so that this module imports no kernel module.
DMA_STREAMS = 2

RING_BACKENDS = ("xla", "pallas")

# Wire-quantization pricing constants (DESIGN.md §17).  The codec layout MUST
# match kernels.quant: one code byte per element plus an f32 scale per
# DEFAULT_CHUNK-element chunk (tests/test_torch_transport.py holds them
# equal).  Literals, so that this module imports no kernel module.
QUANT_CODE_BYTES = 1.0           # int8 and fp8-e4m3 both ship 1 byte/elem
QUANT_SCALE_BYTES = 4.0          # f32 scale sidecar, per chunk
QUANT_CHUNK = 512.0              # MUST equal kernels.quant.DEFAULT_CHUNK
QUANT_WIRE_RATIO = (QUANT_CODE_BYTES + QUANT_SCALE_BYTES / QUANT_CHUNK) / 4.0
# Extra HBM passes of the codec per wire-touched byte: quantize reads the f32
# partial and writes codes; the decode is fused into the accumulate.  Priced
# against the same HBM-bound reduce bandwidth as the chunk accumulate.
QUANT_COMPUTE_FACTOR = 1.0
# Per-ring-step launch cost of the quantize/dequant kernel pair (fused with
# the hop's DMA dispatch, so marginal) — the fixed term that makes
# quantization a strict loss on small/latency-bound payloads (the planner
# additionally never emits quant rows outside the large class).
QUANT_STEP_ALPHA = 1e-6

WIRE_QUANTS = (None, "int8", "fp8")


def _reduce_bw(cluster: ClusterSpec) -> float:
    """On-device accumulate throughput of the slowest island (HBM-bound)."""
    return min(p.chip.hbm_bw for p in cluster.pods) / REDUCE_RW_FACTOR


def _stripe_plan(cluster: ClusterSpec, n_stripes, nbytes: float,
                 n_transfers: int = 1):
    """Transport stripe schedule for the cross-island ring (DESIGN.md §11).

    ``n_stripes``: 1/None -> no plan (the legacy aggregate-endpoint wire
    model); an int > 1 -> exactly that many per-link DMA streams (clamped to
    the healthy links); ``"auto"`` -> the transport planner picks k.  The
    plan rides the slowest endpoint's inventory — the pod whose healthy
    links bound every cross-island pair (paper §5.2) — with each stream's
    rate additionally bounded by the fabric's per-link ``inter_pod_bw`` (one
    NIC, one fabric path: the multi-NIC RDMA premise).  ``nbytes`` is one
    ring step's chunk (the byte floor slices per-step transfers, not the
    whole ring's traffic) and ``n_transfers`` the step count the fill term
    repeats over.
    """
    if n_stripes in (None, 1):
        return None
    slow = min(cluster.pods, key=lambda p: cluster.effective_link_bw(p))
    inv = cluster.inventory(slow)
    if n_stripes == "auto":
        return plan_stripes(inv, inv, nbytes=nbytes,
                            inter_bw=cluster.inter_pod_bw,
                            n_transfers=n_transfers)
    return plan_stripes(inv, inv, nbytes=nbytes,
                        inter_bw=cluster.inter_pod_bw,
                        max_stripes=int(n_stripes), exact=True)


def _explicit_ring_time(op: str, nbytes: float, n: int, bw: float,
                        alpha: float, reduce_bw: float, *,
                        half: float = 1.0, backend: str = "xla",
                        stripes: StripePlan | None = None,
                        wire_quant: str | None = None) -> float:
    """One explicit ring (ppermute or DMA) over ``n`` ranks (DESIGN.md §10).

    backend "xla": XLA schedules each ring step's wire transfer and its chunk
    accumulate serially, so reducing ops pay ``W + R`` on top of the per-hop
    α.  backend "pallas": the DMA kernel double-buffers ``DMA_STREAMS``
    sub-chunks — while chunk k reduces, chunk k+1's remote copy is in flight —
    so the stage pays ``Σ_k max(wire_k, reduce_k)`` plus the fill/drain of
    the pipeline: ``(W+R)/S + (S-1)/S · max(W, R)``.  ``half`` is the
    bidirectional-ring wire discount (reduction volume is unaffected).

    ``stripes`` (pallas only) replaces the aggregate-bandwidth wire term
    with the transport layer's per-link model (DESIGN.md §11): the bytes on
    the wire are pad-and-sliced over the plan's links and the wire time is
    stripe fill + max over links of that link's per-stripe time, degraded
    links priced at their reduced bandwidth.  The reduction term is
    unaffected (it is HBM-bound, not NIC-bound).

    ``wire_quant`` (pallas only, DESIGN.md §17) shrinks the wire bytes to
    the codec's 1 byte/element plus the f32 per-chunk scale sidecar
    (:data:`QUANT_WIRE_RATIO`) and charges the codec's HBM passes
    (:data:`QUANT_COMPUTE_FACTOR`, folded into the overlappable reduce-side
    term) plus a per-step kernel-launch pair (:data:`QUANT_STEP_ALPHA`) —
    the fixed cost that keeps quantization a loss on latency-bound payloads.
    """
    if n <= 1:
        return 0.0
    if backend not in RING_BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; expected "
                         f"one of {RING_BACKENDS}")
    if wire_quant not in WIRE_QUANTS:
        raise ValueError(f"unknown wire_quant {wire_quant!r}; expected "
                         f"one of {WIRE_QUANTS}")
    if backend != "pallas":
        # only the DMA rings carry a quantized payload (the communicator
        # collapses wire_quant to None for xla rows; mirror that here)
        wire_quant = None
    steps = (2 if op == "all_reduce" else 1) * (n - 1)
    wire_bytes = half * _RING_FACTORS[op](n) * nbytes
    Q = 0.0
    if wire_quant is not None:
        wire_bytes *= QUANT_WIRE_RATIO
        Q = (_RING_FACTORS[op](n) * nbytes * QUANT_COMPUTE_FACTOR / reduce_bw
             + QUANT_STEP_ALPHA * steps)
    if backend == "pallas" and stripes is not None:
        # per-link wire term: the k-descriptor fill recurs every ring step
        W = stripes.wire_time(wire_bytes, n_transfers=steps)
    else:
        W = wire_bytes / bw
    R = 0.0
    if op in _REDUCING_OPS:
        # reduction happens in the reduce-scatter half: (n-1)/n of the buffer
        R = _RING_FACTORS["reduce_scatter"](n) * nbytes / reduce_bw
    R += Q       # codec passes are HBM-bound like the accumulate — overlap
    if backend == "pallas" and R:
        S = DMA_STREAMS
        body = (W + R) / S + (S - 1) / S * max(W, R)
    else:
        body = W + R
    return alpha * steps + body


def _local_collective_time(op: str, nbytes: float, pod: PodSpec,
                           n_ranks: int, alpha: float = RDMA_ALPHA,
                           bw: float | None = None) -> float:
    """Vendor-local stage: the island's native library over its interconnect.
    Always priced as the native (fused-reduction) library — the backend knob
    only swaps the explicit cross-island rings (DESIGN.md §10).  ``bw``
    overrides the static link product with the pod's *healthy* aggregate
    (``ClusterSpec.effective_link_bw``, DESIGN.md §11) — a downed NIC slows
    the local stage too, not just the cross ring."""
    if n_ranks <= 1:
        return 0.0
    if bw is None:
        bw = pod.chip.local_link_bw * pod.chip.local_links
    steps = n_ranks - 1
    return alpha * steps + _RING_FACTORS[op](n_ranks) * nbytes / bw


def _pipelined_stage_times(op: str, chunk_bytes: float, cluster: ClusterSpec,
                           alpha: float, bidir: bool,
                           backend: str = "xla",
                           n_stripes=1,
                           wire_quant: str | None = None) -> list[float]:
    """Per-chunk stage costs of the pipelined hierarchical schedule.

    Stage list mirrors the hier decomposition (local native stage(s) + the
    cross-island ring); ``bidir`` halves the cross ring's *bandwidth* term —
    the bidirectional rings push half the payload per direction over the
    full-duplex link — while the per-hop α count is unchanged.  ``backend``
    selects the cross ring's wire/reduce schedule (DESIGN.md §10),
    ``n_stripes`` its multi-NIC stripe schedule (§11; pallas only) and
    ``wire_quant`` its payload codec (§17; pallas only — vendor-local
    stages always run the native library on uncompressed payloads).
    """
    pods = list(cluster.pods)
    P = len(pods)
    shard = chunk_bytes / max(min(p.n_chips for p in pods), 1)
    cross_bw = cluster.slowest_endpoint_bw()
    red_bw = _reduce_bw(cluster)
    half = 0.5 if bidir else 1.0
    # the plan slices one ring step's chunk (~shard/P) and repeats its fill
    # over the ~P-1 steps; exact step counts are applied at pricing time
    stripes = _stripe_plan(cluster, n_stripes, shard / max(P, 1),
                           n_transfers=max(P - 1, 1)) \
        if backend == "pallas" else None
    def local(op_, p):
        return _local_collective_time(op_, chunk_bytes, p, p.n_chips,
                                      bw=cluster.effective_link_bw(p))

    if op == "all_reduce":
        return [
            max(local("reduce_scatter", p) for p in pods),
            _explicit_ring_time("all_reduce", shard, P, cross_bw, alpha,
                                red_bw, half=half, backend=backend,
                                stripes=stripes, wire_quant=wire_quant),
            max(local("all_gather", p) for p in pods),
        ]
    if op in ("all_gather", "reduce_scatter", "broadcast", "reduce"):
        ring_half = half if op in ("all_gather", "reduce_scatter") else 1.0
        return [
            max(local(op, p) for p in pods),
            _explicit_ring_time(op, shard, P, cross_bw, alpha, red_bw,
                                half=ring_half, backend=backend,
                                stripes=stripes, wire_quant=wire_quant),
        ]
    if op == "all_to_all":
        return [
            max(local(op, p) for p in pods),
            alpha * (P - 1) + chunk_bytes * (P - 1) / P / cross_bw,
        ]
    raise ValueError(op)


def _pipelined_time(op: str, nbytes: float, cluster: ClusterSpec,
                    alpha: float, n_channels: int, bidir: bool,
                    backend: str = "xla", n_stripes=1,
                    wire_quant: str | None = None) -> float:
    """Multi-channel software-pipelined time: with C chunks the slowest stage
    is paid C times and the others once (classic pipeline fill/drain), i.e.

        T(C) = Σ_s t_s(n/C) + (C-1) · max_s t_s(n/C).

    The channel count is auto-tuned (min over 1..n_channels): more channels
    amortize the serial stages but pay per-chunk α, so the optimum is
    payload-dependent.  C=1 degenerates to the serial hier schedule, which
    makes the pipelined mode never slower than hier in this model.
    """
    best = float("inf")
    for c in range(1, max(int(n_channels), 1) + 1):
        stages = _pipelined_stage_times(op, nbytes / c, cluster, alpha, bidir,
                                        backend, n_stripes, wire_quant)
        best = min(best, sum(stages) + (c - 1) * max(stages))
    return best


def pipelined_channel_time(op: str, nbytes: float, cluster: ClusterSpec,
                           n_channels: int, alpha: float | None = None,
                           bidir: bool = True, backend: str = "xla",
                           n_stripes=1,
                           wire_quant: str | None = None) -> float:
    """T(C) at *exactly* C channels — no auto-tune.  For channel sweeps that
    want to show the fill/drain-vs-α tradeoff (collective_time's pipelined
    mode returns min over 1..n_channels and is monotone in n_channels)."""
    alpha = cluster.inter_pod_alpha if alpha is None else alpha
    c = max(int(n_channels), 1)
    stages = _pipelined_stage_times(op, nbytes / c, cluster, alpha, bidir,
                                    backend, n_stripes, wire_quant)
    return sum(stages) + (c - 1) * max(stages)


def collective_time(op: str, nbytes: float, cluster: ClusterSpec,
                    mode: str = "auto", alpha: float | None = None, *,
                    n_channels: int = 4, bidir: bool = True,
                    backend: str = "xla", n_stripes=1,
                    wire_quant: str | None = None) -> float:
    """Time of one collective over every chip in ``cluster``.

    mode "flat": one ring over all chips, every link bounded by the slowest
    endpoint in the group (what a naive single-stage heterogeneous ring pays).
    mode "hier": HetCCL — local stage per island at native bandwidth +
    cross-island ring over per-island shards, the two stages *serial*.
    mode "pipelined": hier with the payload split into up to ``n_channels``
    chunks, chunk k's cross-island ring overlapping chunk k+1's local stage
    (and bidirectional cross rings unless ``bidir=False``).  ``n_channels``
    defaults to HetCCLConfig's default so model and execution describe the
    same schedule.

    backend "xla" | "pallas" picks the explicit-ring schedule (DESIGN.md
    §10): the ppermute rings serialize each step's wire and reduce, the DMA
    rings double-buffer them to ``Σ_k max(wire_k, reduce_k)``.  Native
    single-island collectives ("flat" on one island, and every vendor-local
    stage) are backend-invariant — the vendor library already fuses its
    reduction, which is exactly why the pallas rings only ever pay off on the
    cross-island stage.

    n_stripes (pallas only): the transport layer's multi-NIC stripe count
    (DESIGN.md §11) — an int pins k per-link DMA streams, ``"auto"`` lets
    ``transport.plan_stripes`` pick k from the cluster's link inventories.
    The default 1 keeps the legacy aggregate-endpoint wire model; the xla
    backend ignores the knob (a ppermute ring is one logical transfer),
    mirroring ``HetCCLConfig.resolved_stripes``.

    wire_quant (pallas only, DESIGN.md §17): None | "int8" | "fp8" payload
    codec of the explicit rings — 1 code byte/element plus the f32 per-chunk
    scale sidecar on the wire, the codec's HBM passes and per-step launch
    cost charged on top.  The xla backend ignores the knob, mirroring the
    communicator's creation-time collapse.
    """
    alpha = cluster.inter_pod_alpha if alpha is None else alpha
    pods = list(cluster.pods)
    n = cluster.n_chips
    if backend not in RING_BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; expected "
                         f"one of {RING_BACKENDS}")
    if n <= 1:
        return 0.0
    if mode == "auto":
        mode = "hier" if len(pods) > 1 else "flat"
    if mode not in ("flat", "hier", "pipelined"):
        raise ValueError(f"unknown mode {mode!r}; expected "
                         "flat | hier | pipelined | auto")
    if len(pods) == 1 or mode == "flat":
        bw = cluster.slowest_endpoint_bw() if len(pods) > 1 else \
            cluster.effective_link_bw(pods[0])
        if backend == "pallas":
            # explicit DMA ring over every chip: same wire as the native
            # ring plus the (overlapped) on-device reduction — never cheaper
            # than the vendor library on its own island.
            stripes = _stripe_plan(cluster, n_stripes, nbytes / max(n, 1),
                                   n_transfers=max(n - 1, 1)) \
                if len(pods) > 1 else None
            return _explicit_ring_time(op, nbytes, n, bw, alpha,
                                       _reduce_bw(cluster), backend="pallas",
                                       stripes=stripes,
                                       wire_quant=wire_quant)
        return alpha * (n - 1) + _RING_FACTORS[op](n) * nbytes / bw
    if mode == "pipelined":
        # only the ops with a "pipelined" TACC registration run the
        # multi-channel schedule; the backend falls back to hier for the
        # rest (hetccl._variant_for) and the model must not credit them
        # with overlap the runtime never achieves.
        if op in ("all_reduce", "all_gather", "reduce_scatter"):
            return _pipelined_time(op, nbytes, cluster, alpha, n_channels,
                                   bidir, backend, n_stripes, wire_quant)
        mode = "hier"
    # hierarchical: local stage + cross-pod ring on 1/n_local shards —
    # the serial (C=1, unidirectional) case of the pipelined stage model.
    stages = _pipelined_stage_times(op, nbytes, cluster, alpha, False, backend,
                                    n_stripes, wire_quant)
    return sum(stages)


def policy_collective_time(op: str, nbytes: float, cluster: ClusterSpec,
                           policies, alpha: float | None = None) -> float:
    """Price one collective under the policy a per-op, size-classed
    :class:`repro_torch.comm.policy.PolicyTable` resolves for this payload
    (DESIGN.md §12) — the pricing mirror of the communicator dispatch path:
    the same (op, size class) row that routes the runtime call selects the
    (mode, backend, channels, stripes) tuple priced here."""
    p = policies.resolve(op, nbytes)
    return collective_time(op, nbytes, cluster, p.mode, alpha,
                           n_channels=max(int(p.n_channels), 1),
                           backend=p.backend, n_stripes=p.n_stripes,
                           wire_quant=p.wire_quant)


def collective_busbw(op: str, nbytes: float, cluster: ClusterSpec,
                     mode: str = "auto", backend: str = "xla") -> float:
    """Algorithm bandwidth (bytes / time), the y-axis of paper Figs 7/11."""
    return nbytes / collective_time(op, nbytes, cluster, mode, backend=backend)


def mpi_collective_time(op: str, nbytes: float, cluster: ClusterSpec) -> float:
    """GPU-aware-MPI baseline (paper Fig 13/14): lower per-message α, but
    reductions staged through host memory."""
    n = cluster.n_chips
    t = MPI_ALPHA * math.ceil(math.log2(max(n, 2)))
    bw = cluster.slowest_endpoint_bw()
    t += _RING_FACTORS[op](n) * nbytes / bw
    if op in ("all_reduce", "reduce", "reduce_scatter"):
        t += 2.0 * nbytes / MPI_HOST_REDUCE_BW   # host-staged reduction
    return t


# ---------------------------------------------------------------------------
# End-to-end training step (paper Fig 9, Table 4)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TrainWorkload:
    """Per-micro-batch cost of one model under one ZeRO stage."""

    name: str
    flops_per_token: float        # fwd+bwd FLOPs per token (≈ 6·N with remat factor)
    param_bytes: float            # gradient/parameter traffic volume
    seq_len: int
    micro_batch: int              # per-device micro-batch (sequences)
    zero_stage: int = 1

    @property
    def tokens_per_micro(self) -> int:
        return self.micro_batch * self.seq_len


def pod_compute_seconds(workload: TrainWorkload, cluster: ClusterSpec,
                        plan: HetPlan,
                        compute_factors=None) -> tuple[float, ...]:
    """Per-pod compute seconds for one step: pod i runs
    ``plan.micro_per_pod[i]`` micro-steps at its effective FLOP/s.

    ``compute_factors``: optional ``pod name -> slowdown multiple`` (>= 1)
    modeling a gray-degraded island (thermal throttling, the chaos ``slow:``
    injection, DESIGN.md §15).  The synchronous step pays the *max* over
    pods — which is exactly why one slow island sets the fleet's pace and
    why quarantine de-weights it (``plan.refine.deweighted_profiles``).
    """
    factors = compute_factors or {}
    out = []
    for pod, n_micro in zip(cluster.pods, plan.micro_per_pod):
        per_micro = (workload.tokens_per_micro * pod.n_chips *
                     workload.flops_per_token) / pod.effective_flops
        out.append(n_micro * per_micro * float(factors.get(pod.name, 1.0)))
    return tuple(out)


def step_time(workload: TrainWorkload, cluster: ClusterSpec, plan: HetPlan,
              mode: str = "auto", overlap: float = 0.0,
              comm_scale: float = 1.0, backend: str = "xla",
              compute_factors=None) -> float:
    """One optimizer step: max-over-pods compute + collective traffic.

    ZeRO-1: grads AllReduce'd once per step (bucketed);
    ZeRO-3: per-layer param AllGather (fwd+bwd) + grad ReduceScatter, modeled
    as 3x param volume split between local and cross stages.
    ``overlap``: fraction of communication hidden under compute (0 = none).
    ``comm_scale``: multiplier for per-layer sync granularity + link
    contention effects the bulk α-β terms miss (paper ZeRO-3 on PCIe: layers
    × 3 blocking collectives sharing one link with gradient traffic; ~20 on
    the paper testbed, 1.0 for bulk-synchronous estimates).
    ``compute_factors``: per-pod slowdown multiples
    (:func:`pod_compute_seconds`).
    """
    comp = max(pod_compute_seconds(workload, cluster, plan, compute_factors))
    if workload.zero_stage >= 3:
        comm = collective_time("all_gather", 2 * workload.param_bytes, cluster,
                               mode, backend=backend)
        comm += collective_time("reduce_scatter", workload.param_bytes,
                                cluster, mode, backend=backend)
    else:
        comm = collective_time("all_reduce", workload.param_bytes, cluster,
                               mode, backend=backend)
    return comp + (1.0 - overlap) * comm_scale * comm


def bucketed_all_reduce_time(param_bytes: float, cluster: ClusterSpec,
                             mode: str = "auto", *,
                             bucket_bytes: float = 64 * 1024 * 1024,
                             n_channels: int = 4,
                             backend: str = "xla", n_stripes=1,
                             policies=None) -> float:
    """Gradient-reduction time as ``hetccl.tree_all_reduce`` executes it.

    The runtime fuses leaves into ~``bucket_bytes`` buckets and reduces each
    as a reduce-scatter -> all-gather pair on a skewed wavefront (bucket i's
    all-gather overlaps bucket i+1's reduce-scatter, DESIGN.md §7), so with
    ``B`` buckets the model is the same fill/drain pipeline as the
    multi-channel collectives (DESIGN.md §9):

        T(B) = t_rs(b) + t_ag(b) + (B-1) · max(t_rs(b), t_ag(b)),  b = n/B.

    Small buckets amortize nothing and pay per-bucket α; one huge bucket
    loses the cross-bucket overlap — ``bucket_bytes`` is therefore a real
    planner dimension, not a cosmetic knob.

    Args:
        param_bytes: total gradient volume (bytes).
        cluster: the cluster being priced.
        mode: collective mode each bucket's RS/AG runs under.
        bucket_bytes: fusion bucket size (``HetCCLConfig.bucket_bytes``).
        n_channels: channel budget of the ``pipelined`` mode.
        policies: optional per-op ``PolicyTable`` (DESIGN.md §12); when
            given, each half runs under the policy the table resolves for
            its payload and the single-policy args above are ignored.
    Returns:
        Modeled seconds for the whole gradient reduction.
    """
    n_buckets = max(int(math.ceil(param_bytes / max(bucket_bytes, 1))), 1)
    b = param_bytes / n_buckets
    if policies is not None:
        t_rs = policy_collective_time("reduce_scatter", b, cluster, policies)
        t_ag = policy_collective_time("all_gather", b, cluster, policies)
    else:
        t_rs = collective_time("reduce_scatter", b, cluster, mode,
                               n_channels=n_channels, backend=backend,
                               n_stripes=n_stripes)
        t_ag = collective_time("all_gather", b, cluster, mode,
                               n_channels=n_channels, backend=backend,
                               n_stripes=n_stripes)
    return t_rs + t_ag + (n_buckets - 1) * max(t_rs, t_ag)


def zero3_comm_time(param_bytes: float, n_layers: int, cluster: ClusterSpec,
                    mode: str = "auto", *, n_channels: int = 4,
                    backend: str = "xla", n_stripes=1,
                    policies=None) -> float:
    """ZeRO-3 traffic at per-layer granularity (DESIGN.md §9).

    The trainer gathers each layer's params inside the scan (fwd + bwd = 2×
    param volume of all-gather) and reduce-scatters each layer's grads, so
    the α cost scales with ``n_layers`` — which is exactly why small models
    on α-heavy fabrics prefer ZeRO-1 and the planner must see that.
    ``policies``: optional per-op ``PolicyTable`` (DESIGN.md §12), same
    contract as :func:`bucketed_all_reduce_time`.
    """
    layers = max(int(n_layers), 1)
    per = param_bytes / layers
    if policies is not None:
        t_ag = policy_collective_time("all_gather", per, cluster, policies)
        t_rs = policy_collective_time("reduce_scatter", per, cluster,
                                      policies)
    else:
        t_ag = collective_time("all_gather", per, cluster, mode,
                               n_channels=n_channels, backend=backend,
                               n_stripes=n_stripes)
        t_rs = collective_time("reduce_scatter", per, cluster, mode,
                               n_channels=n_channels, backend=backend,
                               n_stripes=n_stripes)
    return layers * (2.0 * t_ag + t_rs)


def planned_step_time(workload: TrainWorkload, cluster: ClusterSpec,
                      plan: HetPlan, mode: str = "auto", *,
                      n_channels: int = 4,
                      bucket_bytes: float = 64 * 1024 * 1024,
                      n_layers: int = 1, overlap: float = 0.0,
                      comm_scale: float = 1.0,
                      compute_scale: float = 1.0,
                      backend: str = "xla", n_stripes=1,
                      policies=None, compute_factors=None) -> float:
    """Step time of one fully-specified plan candidate (DESIGN.md §9).

    Same compute model as :func:`step_time` (max over pods of each pod's
    micro-step count at its effective FLOP/s), but communication is priced at
    the granularity the runtime actually emits: ZeRO-1 through the bucketed
    wavefront (:func:`bucketed_all_reduce_time`), ZeRO-3 per layer
    (:func:`zero3_comm_time`).  ``compute_scale`` is the profile-refinement
    calibration factor (observed/modeled; ``repro_torch.plan.refine``).
    ``policies``: optional per-op ``PolicyTable`` (DESIGN.md §12) — each op
    class is then priced under its own policy instead of the single
    mode/backend/channels/stripes tuple.  ``compute_factors``: per-pod
    slowdown multiples (a gray-degraded island, DESIGN.md §15).

    Returns:
        Modeled seconds per optimizer step for this candidate.
    """
    comp = max(pod_compute_seconds(workload, cluster, plan, compute_factors))
    if workload.zero_stage >= 3:
        comm = zero3_comm_time(workload.param_bytes, n_layers, cluster, mode,
                               n_channels=n_channels, backend=backend,
                               n_stripes=n_stripes, policies=policies)
    else:
        comm = bucketed_all_reduce_time(workload.param_bytes, cluster, mode,
                                        bucket_bytes=bucket_bytes,
                                        n_channels=n_channels,
                                        backend=backend, n_stripes=n_stripes,
                                        policies=policies)
    return compute_scale * comp + (1.0 - overlap) * comm_scale * comm


# Rebuild-epoch cost constants (the elastic loop, DESIGN.md §13).  Control-plane
# terms are fleet-scale estimates, not per-chip physics: detection waits out
# the heartbeat timeout, the re-plan is a numpy search on a login core, and
# communicator (re)creation is per-pair alpha setup.
REBUILD_CONTROL_S = 0.5          # replan + communicator-table compile
CKPT_DISK_BW = 2e9               # bytes/s restore read from shared storage


def rebuild_time(cluster: ClusterSpec, state_bytes: float, *,
                 checkpointless: bool = True, detect_s: float = 5.0,
                 disk_bw: float = CKPT_DISK_BW) -> float:
    """Modeled seconds a membership-change epoch costs (DESIGN.md §13).

    The elastic loop is detect -> rebuild -> re-plan -> recover; the first
    three are control-plane (``detect_s`` heartbeat timeout +
    :data:`REBUILD_CONTROL_S`), and recovery is dominated by moving
    ``state_bytes`` of optimizer/param state onto the new mesh:

    * checkpointless: shards gather from live peers over the surviving
      fabric — bounded by the slowest endpoint (paper §5.2), exactly the
      bandwidth every cross-island collective already pays;
    * checkpoint fallback: the same re-place traffic *plus* reading the
      checkpoint from shared storage at ``disk_bw`` first — strictly
      costlier for any state size, which is why the recovery path prefers
      checkpointless whenever ZeRO replication covers every shard.

    ``state_bytes``: bytes that must land on the new mesh (full logical
    state for a pod join, the dead pod's re-placed share for a loss —
    caller's choice; only relative pricing matters to the control plane).
    """
    bw = cluster.slowest_endpoint_bw()
    alpha = cluster.inter_pod_alpha * max(len(cluster.pods) - 1, 1)
    t = detect_s + REBUILD_CONTROL_S + alpha + state_bytes / bw
    if not checkpointless:
        t += state_bytes / disk_bw
    return t


def throughput_tokens_per_s(workload: TrainWorkload, cluster: ClusterSpec,
                            plan: HetPlan, mode: str = "auto",
                            overlap: float = 0.0,
                            comm_scale: float = 1.0,
                            backend: str = "xla") -> float:
    live = sum(m * workload.tokens_per_micro * p.n_chips
               for m, p in zip(plan.micro_per_pod, cluster.pods))
    return live / step_time(workload, cluster, plan, mode, overlap,
                            comm_scale, backend)


def balanced_plan(workload: TrainWorkload, cluster: ClusterSpec,
                  total_micro: int) -> HetPlan:
    """Profiling-based plan: speeds from each pod's effective throughput."""
    profs = [PodProfile(p.name, p.effective_flops, p.n_chips) for p in cluster.pods]
    return make_plan(profs, total_micro, workload.micro_batch)


def efficiency(workload: TrainWorkload, het_cluster: ClusterSpec,
               homo_clusters: Sequence[ClusterSpec], total_micro: int,
               mode: str = "hier") -> float:
    """Paper §5.3: het throughput / sum of homogeneous throughputs."""
    het_tp = throughput_tokens_per_s(
        workload, het_cluster, balanced_plan(workload, het_cluster, total_micro),
        mode)
    homo_tp = 0.0
    for c in homo_clusters:
        share = max(1, round(total_micro * c.n_chips / het_cluster.n_chips))
        homo_tp += throughput_tokens_per_s(
            workload, c, uniform_plan(len(c.pods), share * len(c.pods),
                                      workload.micro_batch), "flat")
    return het_tp / homo_tp if homo_tp else float("nan")
