"""Transport constants the collectives need (``stripe.py``).

The link inventory, stripe planning and flow scheduling of
``repro/transport`` are not ported: on one card there are no links to plan.
"""
