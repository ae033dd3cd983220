"""Per-chip link inventory and health (DESIGN.md §11).

Counterpart of ``repro/transport/links.py``, the port's own copy.  HetCCL's
core enabler is an RDMA transport that drives *every* usable NIC per GPU
(paper §4.1).  This module makes those links first-class, beyond the static
``ChipSpec.local_link_bw × local_links`` product:

  * :class:`Link` — one NIC / lane with its nominal bandwidth;
  * :class:`LinkHealth` — mutable up / degraded-bandwidth / down state;
  * :class:`LinkInventory` — the per-chip set of links plus their health,
    the object the stripe planner (``transport.stripe``), the simulator's
    endpoint model (``ClusterSpec.effective_link_bw``) and the
    communicator's stripe clamp (``comm.create``) consume.

Pure stdlib (no torch import of its own), like the planner that reads it.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable

# Link health states.  "degraded" keeps the link in the stripe set but at
# ``bw_fraction`` of nominal rate (a retrained PCIe lane); "down" removes
# it from every plan until marked up again.
LINK_UP = "up"
LINK_DEGRADED = "degraded"
LINK_DOWN = "down"
_STATES = (LINK_UP, LINK_DEGRADED, LINK_DOWN)


@dataclasses.dataclass(frozen=True)
class Link:
    """One physical link (NIC / lane / PCIe path) of a chip."""

    index: int
    bw: float                    # nominal bytes/s, one direction


@dataclasses.dataclass
class LinkHealth:
    """Mutable health of one link.

    bw_fraction: achieved fraction of nominal bandwidth — 1.0 when up,
    the retrained rate when degraded, irrelevant when down.
    """

    state: str = LINK_UP
    bw_fraction: float = 1.0


class LinkInventory:
    """A chip's links plus their mutable health.

    The identity object of the transport layer: the stripe planner asks it
    which links may carry a DMA stream and at what effective rate, the flow
    scheduler mutates it when a link flaps, and ``ClusterSpec`` derives its
    endpoint bandwidth from it (sum of *healthy* link bandwidth, not the
    static product).
    """

    def __init__(self, links: Iterable[Link], chip_name: str = ""):
        self.links: tuple[Link, ...] = tuple(links)
        if not self.links:
            raise ValueError("LinkInventory needs at least one link")
        self.chip_name = chip_name
        self._by_index: dict[int, Link] = {l.index: l for l in self.links}
        self._health: dict[int, LinkHealth] = {
            l.index: LinkHealth() for l in self.links}

    @classmethod
    def from_chip(cls, chip) -> "LinkInventory":
        """Derive the inventory from a ``topology.ChipSpec`` (duck-typed:
        anything with ``local_links`` / ``local_link_bw`` / ``name``)."""
        n = max(int(getattr(chip, "local_links", 1)), 1)
        bw = float(chip.local_link_bw)
        return cls((Link(i, bw) for i in range(n)),
                   chip_name=getattr(chip, "name", ""))

    # -- health mutations ---------------------------------------------------

    def health(self, index: int) -> LinkHealth:
        return self._health[index]

    def mark_down(self, index: int) -> None:
        self._health[index].state = LINK_DOWN

    def mark_degraded(self, index: int, bw_fraction: float) -> None:
        if not 0.0 < bw_fraction <= 1.0:
            raise ValueError(f"bw_fraction must be in (0, 1], got {bw_fraction}")
        h = self._health[index]
        h.state = LINK_DEGRADED
        h.bw_fraction = bw_fraction

    def mark_up(self, index: int) -> None:
        h = self._health[index]
        h.state = LINK_UP
        h.bw_fraction = 1.0

    # -- queries ------------------------------------------------------------

    def effective_bw(self, index: int) -> float:
        """Current bytes/s of one link: nominal × health fraction, 0 if down."""
        link = self._by_index[index]
        h = self._health[index]
        if h.state == LINK_DOWN:
            return 0.0
        return link.bw * (h.bw_fraction if h.state == LINK_DEGRADED else 1.0)

    def healthy_links(self) -> tuple[Link, ...]:
        """Links that may carry a stripe (up or degraded, never down)."""
        return tuple(l for l in self.links
                     if self._health[l.index].state != LINK_DOWN)

    def n_healthy(self) -> int:
        return len(self.healthy_links())

    def healthy_bw(self) -> float:
        """Aggregate effective bandwidth over non-down links — the endpoint
        capacity ``ClusterSpec.effective_link_bw`` reports (DESIGN.md §11)."""
        return sum(self.effective_bw(l.index) for l in self.healthy_links())

    def __repr__(self) -> str:  # debugging / failover logs
        states = ",".join(f"{l.index}:{self._health[l.index].state}"
                          for l in self.links)
        return (f"LinkInventory({self.chip_name or 'chip'}, "
                f"{len(self.links)} links [{states}], "
                f"healthy_bw={self.healthy_bw():.3g})")
