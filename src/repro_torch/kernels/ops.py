"""Model-layout kernel wrappers and their TACC registrations.

Counterpart of ``repro/kernels/ops.py``.  The hand-written CUDA kernels are
the ``cuda`` entry points; the plain-torch paths stay the ``cpu`` defaults,
and TACC picks per call from the device of the first tensor argument.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core import tacc
from repro_torch.kernels import grouped_matmul as gmm
from repro_torch.kernels import quant, ref
from repro_torch.kernels import ssd_scan as ssd
from repro_torch.kernels.collective_reduce import collective_reduce
from repro_torch.kernels.flash_attention import FlashAttention, flash_attention_fwd


# ---------------------------------------------------------------------------
# attention: model layout (B, S, H, d) -> kernel layout (B, H, S, d)
# ---------------------------------------------------------------------------

@tacc.register("attention", "cuda")
def flash_attention(q, k, v, *, kind="causal", window=0, q_offset=0,
                    k_offset=0, k_len=None, chunk=None, scale=None):
    """Model-layout wrapper for the flash kernels.

    Decode (Sq < 8) and offset cases go to ``chunked_attention``, as in the
    reference (``repro/kernels/ops.py:48``): a shape rule, not a catch-all for
    kernel failures.  Ragged lengths need no padding here: the kernel masks
    its loads and stores, which matches the reference's pad-to-128 with
    ``k_len`` = Sk and padded query rows sliced off.  When autograd records
    (grad enabled and an input requires grad) the call goes through
    :class:`FlashAttention`, whose backward is the backward kernel; otherwise
    through the forward kernel alone.
    """
    from repro_torch.models.attention import chunked_attention
    Sq = q.shape[1]
    if Sq < 8 or q_offset != 0 or k_offset != 0:
        return chunked_attention(q, k, v, kind=kind, window=window,
                                 q_offset=q_offset, k_offset=k_offset,
                                 k_len=k_len, chunk=chunk or 512, scale=scale)
    eff_k_len = k.shape[1] if k_len is None else k_len
    # transpose views: the kernel reads the model layout through its strides
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        out = FlashAttention.apply(qt, kt, vt, kind, window, eff_k_len, scale)
    else:
        out = flash_attention_fwd(qt, kt, vt, kind=kind, window=window,
                                  k_len=eff_k_len, scale=scale)
    return out.transpose(1, 2)


# ---------------------------------------------------------------------------
# grouped matmul / expert FFN
# ---------------------------------------------------------------------------

tacc.register("grouped_matmul", "cpu", default=True)(ref.grouped_matmul)
tacc.register("grouped_matmul", "cuda")(gmm.grouped_matmul)


@tacc.register("expert_ffn", "cuda")
def expert_ffn_gmm(buf, w1, w3, w2):
    """SwiGLU over the capacity buffer via three grouped matmuls, the
    counterpart of the reference's ``expert_ffn_pallas``.  buf (E, C, D);
    w1, w3 (E, D, F); w2 (E, F, D).  SiLU runs in f32 and is cast back before
    the product with h3, as there (the ``cpu`` variant,
    ``models.moe.expert_ffn_ref``, keeps the reference's compute-dtype SiLU).
    ``gmm.grouped_matmul`` is looked up at each call, so a caller may wrap it.
    The gradient goes through autograd: each grouped matmul's backward is
    the backward kernel (``grouped_matmul.GroupedMatmul``), SiLU's and the
    product's are autograd's own.
    """
    h1 = gmm.grouped_matmul(buf, w1)
    h3 = gmm.grouped_matmul(buf, w3)
    h = F.silu(h1.float()).to(buf.dtype) * h3
    return gmm.grouped_matmul(h, w2)


# ---------------------------------------------------------------------------
# SSD scan: the model's layout, (y without D*x, final state), one forward
# launch per call; when autograd records, through ``ssd.SsdScan``, whose
# backward is the backward kernel.  The op sits one level above the
# reference's per-chunk ``ssd_chunk`` (ROADMAP C1): ``models/ssm.py``
# registers the ``cpu`` chunk loop (autograd differentiates it there).
# ---------------------------------------------------------------------------

tacc.register("ssd_scan", "cuda")(ssd.ssd_scan_model)


# ---------------------------------------------------------------------------
# collective local reduction: acc (f32) + incoming (wire dtype) -> f32
# ---------------------------------------------------------------------------

tacc.register("collective_reduce", "cpu", default=True)(ref.collective_reduce)
tacc.register("collective_reduce", "cuda")(collective_reduce)


# ---------------------------------------------------------------------------
# wire codec (DESIGN.md §17): (nchunks, chunk) quantize / dequantize-accumulate
# ---------------------------------------------------------------------------

tacc.register("wire_quantize", "cpu", default=True)(ref.wire_quantize)
tacc.register("wire_quantize", "cuda")(quant.wire_quantize_cuda)
tacc.register("wire_dequant_accum", "cpu", default=True)(ref.wire_dequant_accum)
tacc.register("wire_dequant_accum", "cuda")(quant.wire_dequant_accum_cuda)
