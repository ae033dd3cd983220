"""Roofline hardware sheets.

Counterpart of ``repro/roofline/hw.py``: its TPU v5e constants, as they are
(the reference's target), and beside them the sheets of the card the port
runs on.  A :class:`HwSheet` is what ``analysis.Roofline`` prices a step
with; ``V5E`` is the reference's module constants as a sheet.

* ``H100``: one H100 SXM per rank, from ``core.topology.H100_NVLINK`` (989e12
  dense bf16 FLOP/s, 3.35e12 B/s of HBM, 80e9 B), its island's wire the
  NVLink bandwidth there (``local_link_bw``) and the cross-island wire
  InfiniBand HDR (``topology.IB_HDR_BW``), as ``launch.mesh.
  cluster_for_mesh`` models a mesh of H100 islands.
* ``H100_SHARED``: every rank of a ``ThreadMesh`` on one card.  Its "wire" is
  HBM: a collective stage between two ranks of one card reads the payload
  from HBM and writes it to HBM, so a wire byte costs two HBM bytes, within
  an island or across one.  The step's terms are the sums over the card's
  ranks (``analysis.Roofline.shared``).
"""
from __future__ import annotations

import dataclasses

PEAK_FLOPS = 197e12        # bf16 FLOP/s per chip
HBM_BW = 819e9             # bytes/s per chip
ICI_BW = 50e9              # bytes/s per link
HBM_BYTES = 16e9           # capacity per chip
DCI_BW = 10e9              # bytes/s per chip across the pod boundary
                           # (inter-pod DCI ~ 1/5 of an ICI link; cross-island
                           # wire is the scarce resource HetCCL economizes)


@dataclasses.dataclass(frozen=True)
class HwSheet:
    """One chip's roofline numbers: peak bf16 FLOP/s, HBM bytes/s and
    capacity, and the wire bytes/s within an island (``ici_bw``) and across
    the island boundary (``dci_bw``)."""

    name: str
    peak_flops: float
    hbm_bw: float
    hbm_bytes: float
    ici_bw: float
    dci_bw: float


V5E = HwSheet("tpu-v5e", PEAK_FLOPS, HBM_BW, HBM_BYTES, ICI_BW, DCI_BW)


def _h100_sheets() -> tuple[HwSheet, HwSheet]:
    from repro_torch.core.topology import H100_NVLINK, IB_HDR_BW
    c = H100_NVLINK
    own = HwSheet("nvidia-h100-sxm", c.peak_flops, c.hbm_bw, c.hbm_bytes,
                  c.local_link_bw * c.local_links, IB_HDR_BW)
    shared = HwSheet("nvidia-h100-sxm, ranks sharing one card", c.peak_flops, c.hbm_bw,
                     c.hbm_bytes, c.hbm_bw / 2, c.hbm_bw / 2)
    return own, shared


H100, H100_SHARED = _h100_sheets()
