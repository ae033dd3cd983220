"""Deterministic stripe planning: split one ring chunk over k links
(DESIGN.md §11).

Counterpart of ``repro/transport/stripe.py``, the port's own copy; the
rings read ``MXU_TILE_BYTES`` and ``MAX_STRIPES``.  The ring backend
(``kernels.ring_dma``, §10) moves each cross-island
chunk as one logical transfer; a chip with 4-6 usable links therefore leaves
most of its NIC capacity idle — exactly the gap HetCCL's multi-NIC RDMA
engine closes (paper §4.1, Holmes' link-aware scheduling).  A
:class:`StripePlan` is the deterministic answer to "how many per-link DMA
streams, on which links, at what rate":

  * payloads are **pad-and-sliced**: every stripe carries the same padded
    share (ceil(nbytes / k)), so the kernels keep static shapes and the
    ragged tail costs one stripe's padding, never a dynamic shape;
  * a plan never stripes below :data:`MIN_STRIPE_BYTES` — a descriptor's
    fixed cost dwarfs the wire time of a tiny stripe — and callers that
    also chunk (pipeline channels, gradient buckets) must keep
    ``channels × stripes`` fragments above one reduce tile
    (:data:`MXU_TILE_BYTES`, enforced by ``collectives.resolve_channels``);
  * link selection is deterministic: healthiest (highest effective
    bandwidth) links first, index as tie-break, so the same inventory
    always produces the same plan — replans are diffable.

Cost model (the simulator's per-link wire term): issuing k streams costs a
serial fill of ``(k-1) · STRIPE_FILL_S`` per transfer (one DMA descriptor
per extra stripe, re-issued on every ring step), then the stripes fly
concurrently, so

    wire_time(n, T) = T·(k-1)·fill + max_j  ceil(n/k) / bw_j

with ``T`` the number of transfers carrying the bytes (ring steps) and
``bw_j`` the per-stripe path rate: min(local link, peer link, fabric
per-link bound).  More healthy links can therefore never model slower —
``plan_stripes`` prices every k up to the feasible cap and keeps the best
(ties break toward fewer stripes).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

from repro_torch.transport.links import LinkInventory

# One f32 tile of the reference's reduce kernel (8 x 128 x 4 B): the floor
# that any fragmenting knob (channels x stripes) must respect.  The port keeps
# the reference's value so both packages split payloads alike.
MXU_TILE_BYTES = 8 * 128 * 4
# Planning floor per stripe: below this the per-descriptor fixed cost beats
# the wire time saved, so the planner refuses to stripe finer.
MIN_STRIPE_BYTES = 64 * 1024
# Serial per-extra-stripe issue cost (DMA descriptor + semaphore arm) — the
# "stripe fill" term of the cost model.
STRIPE_FILL_S = 1e-6
# Hard cap on streams per transfer: the kernel's semaphore lanes scale as
# 2 parities × NUM_BUFFERS streams × stripes, and no chip in the fleet has
# more usable links than this.
MAX_STRIPES = 8


@dataclasses.dataclass(frozen=True)
class StripePlan:
    """A deterministic split of one transfer across per-link DMA streams.

    link_ids:   local link index each stripe rides (the chip's NIC set).
    stripe_bws: effective bytes/s of each stripe's path — health-priced and
                bounded by the peer's link and the fabric's per-link rate.
    """

    n_stripes: int
    link_ids: tuple[int, ...]
    stripe_bws: tuple[float, ...]
    min_stripe_bytes: int = MIN_STRIPE_BYTES

    def __post_init__(self):
        if self.n_stripes < 1 or len(self.link_ids) != self.n_stripes \
                or len(self.stripe_bws) != self.n_stripes:
            raise ValueError(f"inconsistent StripePlan: {self}")

    @property
    def aggregate_bw(self) -> float:
        return sum(self.stripe_bws)

    def stripe_bytes(self, nbytes: float) -> int:
        """Bytes per stripe after pad-and-slice (every stripe equal)."""
        return int(math.ceil(float(nbytes) / self.n_stripes))

    def wire_time(self, nbytes: float, n_transfers: int = 1) -> float:
        """Modeled seconds to move ``nbytes`` under this plan: stripe fill
        plus the max over links of that link's per-stripe wire time.

        ``n_transfers``: how many separate transfers carry the bytes — the
        kernel issues k DMA descriptors on *every* ring step, so a ring of
        ``steps`` hops pays the ``(k-1)·fill`` term ``steps`` times (the
        per-link wire term is volume-proportional either way).
        """
        per = self.stripe_bytes(nbytes)
        return (max(int(n_transfers), 1) * (self.n_stripes - 1) *
                STRIPE_FILL_S + max(per / bw for bw in self.stripe_bws))


def plan_stripes(inv_a: LinkInventory, inv_b: Optional[LinkInventory] = None,
                 *, nbytes: float, inter_bw: float = math.inf,
                 max_stripes: int | None = None,
                 min_stripe_bytes: int = MIN_STRIPE_BYTES,
                 n_transfers: int = 1, exact: bool = False) -> StripePlan:
    """Pick the stripe count and link set for one island-pair transfer.

    Args:
        inv_a: the sending chip's inventory (its link_ids name the plan's
            streams).
        inv_b: the receiving endpoint's inventory; defaults to ``inv_a``
            (symmetric islands, the common case — a stripe's rate is bounded
            by the slower of the paired links either way).
        nbytes: representative size of *one* transfer (a ring step's chunk,
            not the whole ring's traffic) — the byte floor slices this.
        inter_bw: fabric per-link bound — each DMA stream rides its own NIC
            through the fabric (the HetCCL multi-NIC premise), so the bound
            applies per stripe, not to the aggregate.
        max_stripes: cap on k (e.g. the planner's pinned ``--stripes`` value).
        min_stripe_bytes: never slice below this many bytes per stripe.
        n_transfers: how many such transfers the flow repeats (ring steps);
            scales the per-transfer fill term when auto-pricing k.
        exact: use exactly min(max_stripes, feasible) stripes instead of
            searching k — the simulator's pinned-k pricing path.
    Returns:
        The deterministic best (or exact) :class:`StripePlan`.
    Raises:
        RuntimeError: when either endpoint has no healthy link — a transfer
            with no path must surface, never silently price as zero.
    """
    inv_b = inv_b if inv_b is not None else inv_a
    order = lambda inv: sorted(  # noqa: E731  (tiny local sort key)
        inv.healthy_links(),
        key=lambda l: (-inv.effective_bw(l.index), l.index))
    a, b = order(inv_a), order(inv_b)
    if not a or not b:
        raise RuntimeError(
            f"no healthy links for transfer: {inv_a!r} -> {inv_b!r}")
    cap = min(len(a), len(b), MAX_STRIPES)
    if max_stripes is not None:
        cap = min(cap, max(int(max_stripes), 1))
    cap = max(min(cap, max(int(nbytes) // max(min_stripe_bytes, 1), 1)), 1)

    def mk(k: int) -> StripePlan:
        bws = tuple(min(inv_a.effective_bw(la.index),
                        inv_b.effective_bw(lb.index), inter_bw)
                    for la, lb in zip(a[:k], b[:k]))
        return StripePlan(k, tuple(l.index for l in a[:k]), bws,
                          min_stripe_bytes)

    if exact:
        return mk(cap)
    return min((mk(k) for k in range(1, cap + 1)),
               key=lambda p: (p.wire_time(nbytes * max(int(n_transfers), 1),
                                          n_transfers), p.n_stripes))


def auto_stripes(cluster, nbytes: float) -> int:
    """Transport-chosen stripe count for a cluster's cross-island stage: the
    ``--stripes auto`` resolution outside the full plan autotuner (DESIGN.md
    §11).  Plans over the slowest endpoint's inventory — the pod whose
    healthy links bound every cross-island pair."""
    slow = min(cluster.pods, key=lambda p: cluster.effective_link_bw(p))
    inv = cluster.inventory(slow)
    return plan_stripes(inv, inv, nbytes=nbytes,
                        inter_bw=cluster.inter_pod_bw).n_stripes
