"""Flow-level scheduling: stripes -> semaphore lanes, and priced failover
(DESIGN.md §11).

Counterpart of ``repro/transport/flow.py``, the port's own copy.  The stripe
planner (``transport.stripe``) decides *how many* streams and on *which
links*; this module owns what happens between planning and the wire:

  * :meth:`FlowScheduler.lanes` — the deterministic mapping from a
    :class:`StripePlan` to the ring kernels' per-(step parity, stream,
    stripe) lanes (2 parities × NUM_BUFFERS streams × k stripes); a
    :class:`FlowLane` names one of those slots plus the link its stripe
    rides, so a hung lane maps straight back to a NIC.
  * :meth:`FlowScheduler.failover` — the down-link contract: when a link
    dies mid-plan, the flow is **restriped over the surviving links and the
    change is priced** (old vs new modeled wire time), never silently
    dropped or absorbed.  Striping is pad-and-slice of the same bytes, so
    numerics are unaffected; only time changes, and the
    :class:`FailoverEvent` records by how much.

N_STREAMS must equal ``kernels.ring_dma.NUM_BUFFERS``
(``tests/test_torch_transport.py`` holds the two equal).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

from repro_torch.transport.links import LinkInventory
from repro_torch.transport.stripe import StripePlan, plan_stripes

# Double-buffer streams per ring step (== kernels.ring_dma.NUM_BUFFERS) and
# step parities of the ring protocol (DESIGN.md §10).  Literals, so that this
# module imports no kernel module; the equality is tested.
N_STREAMS = 2
N_PARITIES = 2


@dataclasses.dataclass(frozen=True)
class FlowLane:
    """One semaphore lane of the DMA ring kernels: the (parity, stream,
    stripe) slot plus the link the stripe rides."""

    parity: int
    stream: int
    stripe: int
    link: int

    def sem_index(self, n_stripes: int) -> int:
        """Flat index into the kernel's (parity, stream, stripe) semaphore
        array, laid out (parity, stream, stripe) as the reference's kernels lay theirs."""
        return (self.parity * N_STREAMS + self.stream) * n_stripes + self.stripe


@dataclasses.dataclass(frozen=True)
class FailoverEvent:
    """One priced restripe: what died, what the flow looked like before and
    after, and the modeled cost of surviving it."""

    down_link: int
    old_plan: StripePlan
    new_plan: StripePlan
    nbytes: float
    old_time_s: float
    new_time_s: float

    @property
    def slowdown(self) -> float:
        """new/old modeled wire time — >= 1.0 unless the dead link was
        already the straggler of the old plan."""
        return self.new_time_s / self.old_time_s if self.old_time_s else 1.0


class FlowScheduler:
    """Maps stripes to semaphore lanes and re-plans around link failures.

    One scheduler per island-pair flow; it owns (a reference to) the local
    inventory, so health mutations made through it are visible to everything
    else pricing the same chip (``ClusterSpec.effective_link_bw``).
    """

    def __init__(self, inventory: LinkInventory,
                 peer: Optional[LinkInventory] = None,
                 inter_bw: float = math.inf, observer=None):
        self.inventory = inventory
        self.peer = peer
        self.inter_bw = inter_bw
        self.events: list[FailoverEvent] = []
        # telemetry tap: an object with on_failover(event), notified on
        # every failover
        self.observer = observer

    def plan(self, nbytes: float, max_stripes: int | None = None,
             exact: bool = False) -> StripePlan:
        """Current-health stripe plan for a transfer of ``nbytes``."""
        return plan_stripes(self.inventory, self.peer, nbytes=nbytes,
                            inter_bw=self.inter_bw, max_stripes=max_stripes,
                            exact=exact)

    def lanes(self, plan: StripePlan) -> tuple[FlowLane, ...]:
        """Every semaphore lane the kernels arm for ``plan``, in the layout
        order of the kernel's (parity, stream, stripe) semaphore arrays."""
        return tuple(
            FlowLane(parity=p, stream=s, stripe=j, link=plan.link_ids[j])
            for p in range(N_PARITIES)
            for s in range(N_STREAMS)
            for j in range(plan.n_stripes))

    def failover(self, plan: StripePlan, down_link: int,
                 nbytes: float) -> FailoverEvent:
        """Mark ``down_link`` dead and restripe over the surviving links.

        Returns the priced :class:`FailoverEvent` (also appended to
        ``self.events``).  Raises RuntimeError — not a silent drop — when no
        healthy link survives.
        """
        old_time = plan.wire_time(nbytes)
        self.inventory.mark_down(down_link)
        new_plan = self.plan(nbytes)
        ev = FailoverEvent(down_link=down_link, old_plan=plan,
                           new_plan=new_plan, nbytes=nbytes,
                           old_time_s=old_time,
                           new_time_s=new_plan.wire_time(nbytes))
        self.events.append(ev)
        if self.observer is not None:
            self.observer.on_failover(ev)
        return ev
