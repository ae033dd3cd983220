"""Hand-written Hopper kernels (CUDA C++ in ``csrc/``), resolved via TACC.

flash_attention   -- online-softmax attention forward (causal/bidir/window,
                     k_len, GQA; the row logsumexp on request); replaces the
                     Pallas ``_flash_kernel``; its backward
                     (``csrc/flash_attention_bwd.cu``) has no TPU
                     counterpart, and ``FlashAttention`` joins the two
grouped_matmul    -- (G, M, K) @ (G, K, N) with an f32 accumulator, the MoE
                     expert FFN's product; replaces ``_gmm_kernel``
quant             -- the int8 wire codec: per-chunk absmax quantize and
                     dequantize-accumulate; replaces ``_quant_int8_kernel``
                     and ``_dq_accum_kernel``
collective_reduce -- a ring step's accumulate, acc (f32) + incoming (f32 or
                     bf16); replaces the Pallas ``_reduce_kernel``
ssd_scan          -- the Mamba2 SSD chunked scan, an (N, P) f32 state carried
                     in shared memory per (batch, head), the final state as
                     an output; replaces ``_ssd_kernel``; its backward
                     (``csrc/ssd_scan_bwd.cu``) has no TPU counterpart, and
                     ``SsdScan`` joins the two
ring_dma          -- fused ring reduce-scatter / all-gather over every rank
                     of a ThreadMesh on one card, and their emulated
                     schedules, and the quantized rings; replaces
                     ``_rs_dma_kernel`` / ``_ag_dma_kernel``

Each kernel has its plain-torch version beside it (``ref.py``), which the
wrapper runs for CPU tensors; ``ops.py`` holds the model-layout wrappers and
the TACC registrations.  Sources are built by ``_build.py`` at first use.
"""
from repro_torch.kernels import ops, ring_dma  # noqa: F401  (register TACC entries)
