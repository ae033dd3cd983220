"""Stripe constants of the transport layer.

Counterpart of ``repro/transport/stripe.py:47-57``, constants only: the
collectives clamp channel and stripe counts with them.  ``LinkInventory``
and stripe planning are not ported (one card has no links to plan over).
"""

# One f32 tile of the reference's reduce kernel (8 x 128 x 4 B): the floor
# that any fragmenting knob (channels x stripes) must respect.  The port
# keeps the reference's value so both packages split payloads alike.
MXU_TILE_BYTES = 8 * 128 * 4

# Hard cap on stripes per transfer (per-link streams of one wire hop).
MAX_STRIPES = 8
