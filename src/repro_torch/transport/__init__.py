"""repro_torch.transport — the multi-NIC striped transport layer (DESIGN.md
§11).

Counterpart of ``repro/transport``, the port's own copy: a per-chip
:class:`LinkInventory` with mutable health (up / degraded / down), a
deterministic :class:`StripePlan` that splits each ring chunk across k
per-link streams, and a :class:`FlowScheduler` that maps stripes to the ring
kernels' lanes and prices failover when a link dies.  Pure stdlib (no
torch import of its own), like the planner that reads it.
"""
from repro_torch.transport.links import (LINK_DEGRADED, LINK_DOWN, LINK_UP, Link,
                                         LinkHealth, LinkInventory)
from repro_torch.transport.stripe import (MAX_STRIPES, MIN_STRIPE_BYTES,
                                          MXU_TILE_BYTES, STRIPE_FILL_S, StripePlan,
                                          auto_stripes, plan_stripes)
from repro_torch.transport.flow import (FailoverEvent, FlowLane, FlowScheduler,
                                        N_PARITIES, N_STREAMS)

__all__ = [
    "LINK_DEGRADED", "LINK_DOWN", "LINK_UP", "Link", "LinkHealth",
    "LinkInventory",
    "MAX_STRIPES", "MIN_STRIPE_BYTES", "MXU_TILE_BYTES", "STRIPE_FILL_S",
    "StripePlan", "auto_stripes", "plan_stripes",
    "FailoverEvent", "FlowLane", "FlowScheduler", "N_PARITIES", "N_STREAMS",
]
