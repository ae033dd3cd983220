"""The heterogeneity-aware plan autotuner (DESIGN.md §9).

Counterpart of ``repro/plan/autotuner.py``, the port's own copy with the
same names, signatures and choices (``tests/test_torch_plan.py`` holds the
two equal on the same requests).

HetCCL's knobs — per-pod micro-batch shares (paper §4.5), collective mode
(flat | hier | pipelined), pipeline channel count, gradient fusion bucket
size, ZeRO stage — each exist as a separate flag the user must hand-tune.
The paper's value proposition ("practical training on mixed fleets without
changes to existing applications") implies a planner that picks them
*jointly*.  This module is that planner:

    request    = plan_request(cluster, model_cfg, global_batch, seq_len,
                              data_axis=8)
    trainplan  = autotune(request)            # or rank(request) for the
    rc         = trainplan.run_config()       # full candidate frontier

Every candidate in the search space (DESIGN.md §9) is priced with the
calibrated α-β simulator (``simulator.planned_step_time``: roofline compute
per pod + collective traffic at the granularity the runtime actually emits),
checked against a coarse HBM feasibility model, and ranked deterministically.
The winning :class:`TrainPlan` materializes directly into the existing
``RunConfig``/``HetCCLConfig`` pair, so ``launch.train`` gains a
``--plan auto`` path that replaces the hand-set collective flags.

The planner is pure numpy (no torch of its own), so it runs on a host
before any card is touched, and re-runs cheaply with measured evidence
(``repro_torch.plan.refine``).
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

from repro_torch.comm.policy import (CommPolicy, PolicyTable, RING_BACKED_OPS,
                               SIZE_CLASSES, size_class)
from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.core import simulator as sim
from repro_torch.core.balance import HetPlan, PodProfile, make_plan
from repro_torch.core.topology import ClusterSpec

MiB = 1024 * 1024

# Deterministic tie-break order: on equal modeled time prefer the simpler
# schedule (fewer moving parts to debug on a real fleet).
_MODE_ORDER = {"flat": 0, "hier": 1, "pipelined": 2}
_BACKEND_ORDER = {"xla": 0, "pallas": 1}

# The collectives a policy table covers and the representative payload the
# per-op search prices each size class at (DESIGN.md §12).  The class that
# contains the actual gradient-path payload is re-priced at that exact size
# instead, so the emitted table is optimal for the traffic the step emits.
POLICY_OPS = ("all_reduce", "all_gather", "reduce_scatter", "broadcast",
              "reduce", "all_to_all")
CLASS_REP_BYTES = {"small": 16 * 1024, "medium": MiB, "large": 64 * MiB}
# Ops whose registered implementations actually consume backend/n_stripes/
# wire_quant (declare them as policy fields): only these may carry pallas/
# striped/quantized rows — emitting a schedule the runtime cannot execute
# would make the modeled speedup fictional.  Re-exported from
# ``repro_torch.comm.policy`` (the communicator's creation-time collapse and the
# planner's candidate pruning must agree on one set).
assert RING_BACKED_OPS     # imported from repro_torch.comm.policy


@dataclasses.dataclass(frozen=True)
class SearchSpace:
    """The joint space ``autotune`` searches (DESIGN.md §9).

    modes:        collective modes to consider.  ``flat`` is always priced as
                  a baseline even when absent, so the returned plan can never
                  be one the simulator prices slower than flat.
    n_channels:   channel counts tried for the ``pipelined`` mode (flat/hier
                  have no channels; they are enumerated once with C=1).
    bucket_bytes: gradient fusion bucket sizes (ZeRO-1 only; ZeRO-3 traffic
                  is per-layer and takes the default bucket).
    zero_stages:  ZeRO stages to consider (pinned by ``PlanRequest.zero_stage``
                  when the caller has already chosen).
    backends:     ring implementations to consider (DESIGN.md §10): "xla"
                  ppermute rings vs "pallas" DMA rings with the overlapped
                  in-kernel reduction.  Varied only for hier/pipelined —
                  flat's native single-stage collective is backend-invariant
                  (the vendor library already fuses its reduction).
    stripe_counts: multi-NIC stripe counts of the transport layer (DESIGN.md
                  §11): per-link DMA streams of the cross-island ring.
                  Varied only for the pallas backend — the xla ppermute ring
                  is one logical transfer and ignores the knob
                  (``HetCCLConfig.resolved_stripes``) — and priced via the
                  simulator's per-link wire term, so on single-link chips
                  every count models identically and the tie-break keeps 1.
    per_op:       also emit per-op, size-classed policy-table candidates
                  (DESIGN.md §12): for each (zero stage, bucket) pair one
                  extra candidate whose every (op, size class) runs its own
                  argmin policy over this space.  Such a candidate is never
                  modeled slower than any single-policy candidate sharing
                  its (zero, bucket); exact ties break toward the simpler
                  single-policy plan.
    wire_quants:  wire-quantization codecs of the per-op search (DESIGN.md
                  §17).  Tried only for pallas rows of ring-backed ops in
                  the **large** size class — quantizing a latency-bound
                  payload is a strict loss (the codec's per-step launch
                  cost, ``simulator.QUANT_STEP_ALPHA``) and the planner
                  never emits it — and only kept where modeled *strictly*
                  faster (the uncompressed wire wins exact ties).  ``None``
                  (the uncompressed baseline) is always priced even when
                  absent from the tuple.
    """

    modes: tuple[str, ...] = ("flat", "hier", "pipelined")
    n_channels: tuple[int, ...] = (2, 4, 8)
    bucket_bytes: tuple[int, ...] = (16 * MiB, 64 * MiB, 256 * MiB)
    zero_stages: tuple[int, ...] = (1, 3)
    backends: tuple[str, ...] = ("xla", "pallas")
    stripe_counts: tuple[int, ...] = (1, 2, 4)
    per_op: bool = True
    wire_quants: tuple = (None, "int8")


DEFAULT_SPACE = SearchSpace()
DEFAULT_BUCKET = 64 * MiB


@dataclasses.dataclass(frozen=True)
class PlanRequest:
    """Everything the planner needs to price candidates — kept on the
    resulting :class:`TrainPlan` so the profile-refinement loop can re-plan
    without the caller re-assembling context (DESIGN.md §9 re-plan contract).

    cluster:      island/fabric description (``repro_torch.core.topology``).
    model:        the architecture being trained.
    global_batch: sequences per optimizer step (the training contract the
                  planner must preserve across re-plans).
    seq_len:      sequence length.
    data_axis:    DP devices *per island* (the mesh's 'data' axis size) —
                  uniform across islands, per the SPMD contract
                  (DESIGN.md §3).
    micro_tokens: target tokens per device per micro-step (bounds the remat
                  activation stash, same heuristic as the dry-run).
    zero_stage:   pin the ZeRO stage instead of searching over it.
    comm_scale:   sync-granularity/contention multiplier passed through to
                  the simulator (see ``simulator.step_time``).
    overlap:      fraction of communication hidden under compute.
    """

    cluster: ClusterSpec
    model: ModelConfig
    global_batch: int
    seq_len: int
    data_axis: int = 1
    micro_tokens: int = 8192
    zero_stage: int | None = None
    comm_scale: float = 1.0
    overlap: float = 0.0

    def micro_batch(self) -> int:
        """Per-device micro-batch: fill ``micro_tokens`` but never exceed the
        per-device share of the global batch (dry-run heuristic)."""
        dp_world = self.data_axis * len(self.cluster.pods)
        per_dev = max(self.global_batch // max(dp_world, 1), 1)
        return max(1, min(per_dev, self.micro_tokens // max(self.seq_len, 1)))

    def total_micro(self) -> int:
        """Live micro-steps summed over pods: global_batch sequences split
        into (micro_batch × data_axis)-sequence micro-steps.

        Raises:
            ValueError: when ``global_batch`` cannot be realized exactly —
                not divisible by ``micro_batch() × data_axis``, or too small
                to give every island its minimum one micro-step.  The batch
                size is a training contract; the planner never silently
                trains a different one.
        """
        mb = self.micro_batch()
        total, rem = divmod(self.global_batch, mb * self.data_axis)
        if rem or total < len(self.cluster.pods):
            raise ValueError(
                f"global_batch={self.global_batch} is not realizable as "
                f"micro-steps of micro_batch={mb} x data_axis="
                f"{self.data_axis} over {len(self.cluster.pods)} pods "
                f"(needs a multiple of {mb * self.data_axis}, at least "
                f"{len(self.cluster.pods)} of them)")
        return total

    def tensor_parallel(self) -> int:
        """Model-parallel degree per DP lane (chips per pod / data_axis)."""
        min_chips = min(p.n_chips for p in self.cluster.pods)
        return max(min_chips // max(self.data_axis, 1), 1)

    def comm_cluster(self) -> ClusterSpec:
        """The DP projection of the cluster: the group DP collectives really
        run over is ``data_axis`` devices per island (the TP dimension holds
        different shards and never joins a DP ring, DESIGN.md §3), so
        communication must be priced on islands of ``data_axis`` chips — not
        all chips — or it is overpriced by the TP degree (DESIGN.md §9)."""
        pods = tuple(dataclasses.replace(p, n_chips=self.data_axis)
                     for p in self.cluster.pods)
        return ClusterSpec(pods, inter_pod_bw=self.cluster.inter_pod_bw,
                           inter_pod_alpha=self.cluster.inter_pod_alpha)


@dataclasses.dataclass(frozen=True)
class TrainPlan:
    """One fully-specified, priced configuration (DESIGN.md §9).

    The tentpole contract: a TrainPlan materializes directly into the
    existing config objects — :meth:`run_config` for the trainer,
    :meth:`hetccl_config` for a bare collective-layer install — so adopting
    the planner requires no changes to application code.
    """

    request: PlanRequest
    space: SearchSpace
    plan: HetPlan                 # per-pod micro-batch shares
    mode: str                     # flat | hier | pipelined
    backend: str                  # xla | pallas ring implementation (§10)
    n_channels: int               # 1 for non-pipelined modes (serial)
    bucket_bytes: int
    zero_stage: int
    modeled_step_s: float
    modeled_compute_s: float
    modeled_comm_s: float
    modeled_tokens_per_s: float
    fits_hbm: bool
    hbm_bytes_per_device: float
    n_stripes: int = 1            # per-link DMA streams of the cross ring
                                  # (transport layer, DESIGN.md §11; pallas)
    wire_quant: str | None = None  # wire codec of the gradient-path row
                                   # (DESIGN.md §17; per-op candidates only —
                                   # single-policy plans never quantize)
    compute_scale: float = 1.0    # profile-refinement calibration (refine())
    # the per-pod speeds the shares were computed from (measured profiles or
    # the hardware-constant fallback) — carried so refine() re-plans on the
    # same evidence instead of silently reverting to datasheet speeds
    profiles: tuple[PodProfile, ...] | None = None
    # per-op, size-classed policy table (DESIGN.md §12): set on the
    # ``SearchSpace.per_op`` candidates, None on single-policy candidates
    # (their scalar tuple above is the whole story).  On a per-op candidate
    # the scalar mode/backend/channels/stripes mirror the gradient-path
    # (reduce_scatter at the dominant payload) row for display and as the
    # facade fallback of :meth:`hetccl_config`.
    policies: PolicyTable | None = None

    def run_config(self, base: RunConfig | None = None) -> RunConfig:
        """Materialize into the trainer's :class:`RunConfig`.

        Args:
            base: optional RunConfig whose non-planned knobs (learning rate,
                dtypes, remat, ...) are preserved; defaults to ``RunConfig()``.
        Returns:
            ``base`` with the planner-owned fields (``zero_stage``,
            ``collective_mode``, ``n_channels``, ``bucket_bytes``,
            ``n_micro``, ``policies``) replaced.  A per-op candidate's
            table rides along in ``RunConfig.policies`` and the trainer
            builds its communicator from it (DESIGN.md §12).

        Example::

            rc = autotune(req).run_config(RunConfig(learning_rate=1e-3))
            prog = make_train_program(model, mesh, rc, autotune(req).plan)
        """
        base = base or RunConfig()
        return dataclasses.replace(
            base, zero_stage=self.zero_stage, collective_mode=self.mode,
            backend=self.backend, n_channels=self.n_channels,
            n_stripes=self.n_stripes,
            bucket_bytes=self.bucket_bytes, n_micro=self.plan.n_micro_max,
            policies=self.policies)

    def policy_table(self) -> PolicyTable:
        """The communicator policy table this plan stands for (DESIGN.md
        §12): the per-op table of a ``per_op`` candidate, or the one-row
        facade compile of a single-policy candidate — so every TrainPlan,
        legacy or not, materializes into the same communicator surface."""
        if self.policies is not None:
            return self.policies
        return PolicyTable.single(CommPolicy(
            mode=self.mode, backend=self.backend,
            n_channels=max(int(self.n_channels), 1),
            n_stripes=self.n_stripes, wire_quant=self.wire_quant))

    def hetccl_config(self, local_axes: tuple[str, ...] = ("data",),
                      pod_axis: str | None = "pod"):
        """Materialize into a bare :class:`repro_torch.core.hetccl.HetCCLConfig`
        (for ``hetccl.install``/``use`` outside the trainer)."""
        from repro_torch.core import hetccl   # lazy: the planner needs no torch
        return hetccl.HetCCLConfig(
            mode=self.mode, local_axes=local_axes,
            pod_axis=pod_axis if len(self.request.cluster.pods) > 1 else None,
            bucket_bytes=self.bucket_bytes, n_channels=self.n_channels,
            backend=self.backend, n_stripes=self.n_stripes,
            wire_quant=self.wire_quant)

    def summary(self) -> dict:
        """JSON-friendly digest (the dry-run record / plan_sweep row)."""
        return {
            "mode": self.mode, "backend": self.backend,
            "n_channels": self.n_channels,
            "n_stripes": self.n_stripes,
            "wire_quant": self.wire_quant,
            "bucket_MiB": self.bucket_bytes // MiB,
            "zero_stage": self.zero_stage,
            "micro_per_pod": list(self.plan.micro_per_pod),
            "micro_batch": self.plan.micro_batch,
            "modeled_step_s": self.modeled_step_s,
            "modeled_compute_s": self.modeled_compute_s,
            "modeled_comm_s": self.modeled_comm_s,
            "modeled_tokens_per_s": self.modeled_tokens_per_s,
            "fits_hbm": self.fits_hbm,
            "hbm_GB_per_device": self.hbm_bytes_per_device / 1e9,
            "compute_scale": self.compute_scale,
            "policies": (self.policies.summary()
                         if self.policies is not None else None),
        }


def workload_for(cfg: ModelConfig, seq_len: int, micro_batch: int,
                 zero_stage: int, tensor_parallel: int = 1) -> sim.TrainWorkload:
    """Build the simulator workload for one model config.

    FLOPs follow the dry-run spec formula (6·N_active·D, embedding lookup
    excluded).  Both ``flops_per_token`` and ``param_bytes`` are divided by
    the tensor-parallel degree: each device computes only its TP shard of
    every token and holds (hence DP-reduces) only its TP shard of the
    gradients — price the result against the DP projection of the cluster
    (``PlanRequest.comm_cluster``), never the full chip count.
    """
    n_active = cfg.n_active_params() - cfg.vocab * cfg.d_model
    tp = max(tensor_parallel, 1)
    return sim.TrainWorkload(
        name=cfg.name,
        flops_per_token=6.0 * n_active / tp,
        param_bytes=2.0 * cfg.n_params() / tp,
        seq_len=seq_len, micro_batch=micro_batch, zero_stage=zero_stage)


def estimate_hbm_bytes(request: PlanRequest, zero_stage: int,
                       micro_batch: int) -> float:
    """Coarse per-device HBM estimate used only for feasibility pruning.

    Counts (per TP shard of N params): bf16 params + f32 grad accumulators,
    with optimizer state (m, v, f32 master = 12 B/param) sharded over the DP
    world under either stage; ZeRO-3 additionally shards params+grads and
    holds one layer's gathered params as working set.  Activations are the
    remat residual stash: one bf16 residual per layer plus a small working
    multiple.  Deliberately rough — the authoritative check remains the
    dry-run's ``memory_analysis`` — but enough to stop the planner selecting
    ZeRO-1 for a 33B model on 16 GB chips.
    """
    cfg = request.model
    n = cfg.n_params() / request.tensor_parallel()
    dp_world = max(request.data_axis * len(request.cluster.pods), 1)
    opt = 12.0 * n / dp_world
    if zero_stage >= 3:
        state = (2.0 + 4.0) * n / dp_world + opt
        state += 2.0 * 2.0 * n / max(cfg.n_layers, 1)   # gathered layer (fwd+bwd)
    else:
        state = (2.0 + 4.0) * n + opt
    act = micro_batch * request.seq_len * cfg.d_model * 2.0 * (cfg.n_layers + 4)
    return state + act


def pod_profiles(cluster: ClusterSpec) -> tuple[PodProfile, ...]:
    """Default (un-profiled) speeds: each island's effective FLOP/s, the same
    constants the balancer's examples use before a measured profile exists."""
    return tuple(PodProfile(p.name, p.effective_flops, p.n_chips)
                 for p in cluster.pods)


def plan_request(cluster: ClusterSpec, model: ModelConfig, global_batch: int,
                 seq_len: int, **kw) -> PlanRequest:
    """Convenience constructor mirroring :class:`PlanRequest`'s fields."""
    return PlanRequest(cluster=cluster, model=model,
                       global_batch=global_batch, seq_len=seq_len, **kw)


def _comm_candidates(space: SearchSpace):
    """Deterministic (mode, backend, n_channels, stripes) enumeration with
    dimension pruning: channel counts only vary the pipelined mode, ring
    backends only the modes with an explicit cross-island ring (hier /
    pipelined — flat's native collective is backend-invariant, DESIGN.md
    §10), stripe counts only the pallas backend (the xla ring is one
    logical transfer, §11); the flat baseline is always included."""
    seen = set()
    modes = tuple(space.modes)
    if "flat" not in modes:
        modes = ("flat",) + modes
    backends = tuple(space.backends) or ("xla",)
    stripe_counts = tuple(space.stripe_counts) or (1,)
    for mode in modes:
        channels = space.n_channels if mode == "pipelined" else (1,)
        mode_backends = backends if mode != "flat" else (
            backends if "xla" not in backends else ("xla",))
        for backend in mode_backends:
            stripes_dim = stripe_counts if backend == "pallas" else (1,)
            for c in channels:
                for k in stripes_dim:
                    key = (mode, backend, c, k)
                    if key not in seen:
                        seen.add(key)
                        yield key


def _candidates(space: SearchSpace, zero_stages: Sequence[int]):
    """Single-policy candidates: :func:`_comm_candidates` × ZeRO stages ×
    bucket sizes (buckets only vary ZeRO-1).  Yields
    (mode, backend, n_channels, bucket, zero, stripes)."""
    for zero in zero_stages:
        buckets = space.bucket_bytes if zero < 3 else (DEFAULT_BUCKET,)
        for mode, backend, c, k in _comm_candidates(space):
            for b in buckets:
                yield (mode, backend, c, b, zero, k)


def best_policy(op: str, nbytes: float, cluster: ClusterSpec,
                space: SearchSpace = DEFAULT_SPACE) -> tuple[CommPolicy, float]:
    """The argmin (mode, backend, channels, stripes) policy for one
    (op, payload) over ``space``, priced with the α-β simulator — the
    per-cell primitive of the policy-table search (DESIGN.md §12).

    Returns:
        ``(policy, modeled_seconds)``.  Ties break toward the simpler
        schedule (uncompressed wire, then flat < hier < pipelined,
        xla < pallas, fewer stripes, fewer channels), so degenerate cells
        (single island, single-link chips, tiny payloads) keep the legacy
        configuration.  ``wire_quant`` codecs enter the search only for
        pallas rows of ring-backed ops in the large size class (DESIGN.md
        §17) and must be *strictly* faster to win.
    """
    quant_dim = tuple(dict.fromkeys((None,) + tuple(space.wire_quants)))
    best = None
    for mode, backend, c, k in _comm_candidates(space):
        if op not in RING_BACKED_OPS:
            backend, k = "xla", 1   # the op can't execute a pallas/striped row
        quants = quant_dim if (backend == "pallas" and op in RING_BACKED_OPS
                               and size_class(nbytes) == "large") else (None,)
        for q in quants:
            t = sim.collective_time(op, nbytes, cluster, mode, n_channels=c,
                                    backend=backend, n_stripes=k,
                                    wire_quant=q)
            key = (t, q is not None, _MODE_ORDER[mode],
                   _BACKEND_ORDER[backend], k, c)
            if best is None or key < best[0]:
                best = (key, CommPolicy(mode=mode, backend=backend,
                                        n_channels=c, n_stripes=k,
                                        wire_quant=q))
    return best[1], best[0][0]


def grad_payload_bytes(param_bytes: float, bucket_bytes: float,
                        zero_stage: int, n_layers: int) -> float:
    """The payload one gradient-path collective actually carries: a fusion
    bucket under ZeRO-1 (``bucketed_all_reduce_time``'s ``b``), one layer's
    shard under ZeRO-3 (``zero3_comm_time``'s ``per``)."""
    if zero_stage >= 3:
        return param_bytes / max(int(n_layers), 1)
    n_buckets = max(-(-int(param_bytes) // max(int(bucket_bytes), 1)), 1)
    return param_bytes / n_buckets


def policy_table_for(cluster: ClusterSpec, space: SearchSpace = DEFAULT_SPACE,
                     *, grad_bytes: float | None = None,
                     bucket_bytes: float = DEFAULT_BUCKET,
                     zero_stage: int = 1, n_layers: int = 1) -> PolicyTable:
    """Search the per-op, size-classed policy table for ``cluster``
    (DESIGN.md §12): every (op, size class) cell gets its own
    :func:`best_policy`, priced at the class's representative payload —
    except the class containing the actual gradient-path payload (when
    ``grad_bytes`` is given), which is priced at that exact size so the
    table is optimal for the traffic the training step emits.

    Because each cell is an independent argmin over the same space a
    single-policy candidate draws from, pricing a step under this table is
    never slower than under any single policy from that space.
    """
    actual = None
    if grad_bytes:
        actual = grad_payload_bytes(grad_bytes, bucket_bytes, zero_stage,
                                     n_layers)
    rows = {}
    for op in POLICY_OPS:
        for cls in SIZE_CLASSES:
            rep = CLASS_REP_BYTES[cls]
            if actual is not None and size_class(actual) == cls and \
                    op in ("all_reduce", "all_gather", "reduce_scatter"):
                rep = actual
            rows[(op, cls)] = best_policy(op, rep, cluster, space)[0]
    return PolicyTable.of(rows, default=rows[("all_reduce", "large")])


def rank(request: PlanRequest, space: SearchSpace = DEFAULT_SPACE, *,
         profiles: Sequence[PodProfile] | None = None,
         compute_scale: float = 1.0) -> list[TrainPlan]:
    """Price every candidate and return the full frontier, best first.

    Args:
        request: the planning problem (cluster, model, batch contract).
        space: the joint search space; ``DEFAULT_SPACE`` covers the modes,
            channel counts and bucket sizes the runtime supports.
        profiles: measured per-pod throughputs from a profiling run; when
            absent the balancer falls back to the cluster's hardware
            constants (``pod_profiles``) — exactly the paper's
            profile-then-plan split (§4.5).
        compute_scale: calibration factor from the refinement loop
            (``repro.plan.refine``); 1.0 before any measurement.
    Returns:
        Candidates sorted by (feasibility, modeled step time, simplicity).
        Deterministic: equal-cost candidates break ties toward the simpler
        schedule (flat < hier < pipelined, then xla < pallas, fewer
        stripes, fewer channels, smaller buckets, lower ZeRO stage) — so on
        single-link chips, where every stripe count prices identically, the
        planner keeps stripes=1.
    """
    cluster = request.cluster
    profiles = tuple(profiles) if profiles else pod_profiles(cluster)
    if len(profiles) != len(cluster.pods):
        raise ValueError(
            f"{len(profiles)} profiles for {len(cluster.pods)} pods")
    mb = request.micro_batch()
    hetplan = make_plan(profiles, request.total_micro(), mb)
    zero_stages = ((request.zero_stage,) if request.zero_stage is not None
                   else tuple(space.zero_stages))
    comm_cluster = request.comm_cluster()
    w = workload_for(request.model, request.seq_len, mb, 1,
                     request.tensor_parallel())
    live_tokens = hetplan.total_micro * mb * request.data_axis * request.seq_len
    # compute is candidate-invariant (shares and micro schedule are fixed
    # per request; mode/channels/bucket/stage only change communication):
    # price it once — max over pods of that pod's micro-step count at its
    # per-chip effective FLOP/s, as in simulator.planned_step_time.
    comp = compute_scale * max(
        n_micro * w.tokens_per_micro * w.flops_per_token
        / p.chip.effective_flops
        for p, n_micro in zip(cluster.pods, hetplan.micro_per_pod))

    out = []
    for mode, backend, n_channels, bucket, zero, stripes in _candidates(
            space, zero_stages):
        if zero >= 3:
            comm = sim.zero3_comm_time(w.param_bytes, request.model.n_layers,
                                       comm_cluster, mode,
                                       n_channels=n_channels, backend=backend,
                                       n_stripes=stripes)
        else:
            comm = sim.bucketed_all_reduce_time(w.param_bytes, comm_cluster,
                                                mode, bucket_bytes=bucket,
                                                n_channels=n_channels,
                                                backend=backend,
                                                n_stripes=stripes)
        comm = (1.0 - request.overlap) * request.comm_scale * comm
        step_s = comp + comm
        hbm = estimate_hbm_bytes(request, zero, mb)
        out.append(TrainPlan(
            request=request, space=space, plan=hetplan, mode=mode,
            backend=backend, n_channels=n_channels, bucket_bytes=bucket,
            zero_stage=zero, n_stripes=stripes,
            modeled_step_s=step_s, modeled_compute_s=comp,
            modeled_comm_s=comm,
            modeled_tokens_per_s=live_tokens / step_s if step_s > 0 else 0.0,
            fits_hbm=hbm <= min(p.chip.hbm_bytes for p in cluster.pods),
            hbm_bytes_per_device=hbm, compute_scale=compute_scale,
            profiles=profiles))

    if space.per_op:
        # per-op policy-table candidates (DESIGN.md §12): one per
        # (zero stage, bucket) pair, every (op, size class) at its own
        # argmin policy — never modeled slower than a single-policy
        # candidate sharing the (zero, bucket), ties lose to it below.
        n_layers = request.model.n_layers
        for zero in zero_stages:
            buckets = space.bucket_bytes if zero < 3 else (DEFAULT_BUCKET,)
            for bucket in buckets:
                table = policy_table_for(
                    comm_cluster, space, grad_bytes=w.param_bytes,
                    bucket_bytes=bucket, zero_stage=zero, n_layers=n_layers)
                if zero >= 3:
                    comm = sim.zero3_comm_time(w.param_bytes, n_layers,
                                               comm_cluster, policies=table)
                else:
                    comm = sim.bucketed_all_reduce_time(
                        w.param_bytes, comm_cluster, bucket_bytes=bucket,
                        policies=table)
                comm = (1.0 - request.overlap) * request.comm_scale * comm
                step_s = comp + comm
                hbm = estimate_hbm_bytes(request, zero, mb)
                dom = table.resolve("reduce_scatter", grad_payload_bytes(
                    w.param_bytes, bucket, zero, n_layers))
                out.append(TrainPlan(
                    request=request, space=space, plan=hetplan,
                    mode=dom.mode, backend=dom.backend,
                    n_channels=dom.n_channels, bucket_bytes=bucket,
                    zero_stage=zero, n_stripes=dom.n_stripes,
                    wire_quant=dom.wire_quant,
                    modeled_step_s=step_s, modeled_compute_s=comp,
                    modeled_comm_s=comm,
                    modeled_tokens_per_s=(live_tokens / step_s
                                          if step_s > 0 else 0.0),
                    fits_hbm=hbm <= min(p.chip.hbm_bytes
                                        for p in cluster.pods),
                    hbm_bytes_per_device=hbm, compute_scale=compute_scale,
                    profiles=profiles, policies=table))

    out.sort(key=lambda t: (not t.fits_hbm, t.modeled_step_s,
                            t.policies is not None,
                            _MODE_ORDER[t.mode], _BACKEND_ORDER[t.backend],
                            t.n_stripes, t.n_channels, t.bucket_bytes,
                            t.zero_stage))
    return out


def autotune(request: PlanRequest, space: SearchSpace = DEFAULT_SPACE, *,
             profiles: Sequence[PodProfile] | None = None,
             compute_scale: float = 1.0) -> TrainPlan:
    """Pick the best plan for ``request`` (the ``--plan auto`` entry point).

    Equivalent to ``rank(...)[0]``.  Because the flat baseline is always in
    the candidate set and ranking is by modeled step time, the returned plan
    is never one the simulator prices slower than ``flat`` *among
    memory-feasible candidates* (feasibility outranks speed: when flat
    itself fails the HBM gate a slower-but-fitting plan legitimately wins) —
    and on a homogeneous single island it degenerates to exactly the flat,
    uniform hand-tuned configuration (DESIGN.md §9).

    Example::

        from repro_torch import plan
        from repro_torch.core.topology import tpu_multipod
        req = plan.plan_request(tpu_multipod(4, 128), cfg,
                                global_batch=256, seq_len=4096, data_axis=8)
        tp = plan.autotune(req)
        rc = tp.run_config()            # feed straight into make_train_program
    """
    return rank(request, space, profiles=profiles,
                compute_scale=compute_scale)[0]


def autotune_policies(request: PlanRequest, space: SearchSpace = DEFAULT_SPACE,
                      *, profiles: Sequence[PodProfile] | None = None,
                      compute_scale: float = 1.0) -> TrainPlan:
    """The best *per-op policy-table* plan (the ``--policy auto`` entry
    point, DESIGN.md §12): the top-ranked candidate that carries a
    :class:`PolicyTable`.

    By construction its modeled step time is ≤ the best single-policy plan
    of the same frontier (each table cell is the argmin over the space any
    single policy is drawn from); a single-policy plan only outranks it on
    an exact tie, where the table degenerates to one policy anyway.  Falls
    back to the overall best plan when the space disables per-op search.

    Example::

        tp = plan.autotune_policies(req)
        rc = tp.run_config()            # RunConfig.policies carries the table
        print(tp.policy_table().summary())
    """
    frontier = rank(request, space, profiles=profiles,
                    compute_scale=compute_scale)
    return next((t for t in frontier if t.policies is not None), frontier[0])
