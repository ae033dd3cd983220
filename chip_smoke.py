#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero before the last line:

1. device: torch's name for the card, and nvidia-smi's name and power limit;
2. build: every kernel source of the port compiled with nvcc for sm_90a;
3. kernel vs plain: ``flash_attention_fwd`` on the card against its plain
   version at the serving prefill shape and the edge cases, each case with
   its tolerance;
4. serve: full-width smollm-135m (30 layers, d_model 576, bf16, weights made
   from a seed) answers 8 requests of 512 prompt tokens, 32 new tokens each,
   through ``repro_torch.serve.engine.Batcher``.  The launch counts are set to
   0 just before and read just after: the kernel must have run once per layer
   per prefill batch.  Tokens must be < vocab and all logits finite.  In one
   more prefill the kernel's output at each layer must agree with the plain
   version on that layer's inputs, and the last-position logits must agree
   with a prefill whose attention is pinned to the plain variant;
5. times: CUDA events around back-to-back calls after warm-up, medians, for
   the kernel, its plain version, ``F.scaled_dot_product_attention`` (a
   yardstick the port never calls) and the bound (host clock for prefill,
   decode and tokens/s in phase 4); then the card's busy share in prefill
   and decode from a torch.profiler trace;
6. ring kernels vs plain: the fused ring reduce-scatter and all-gather
   (``csrc/ring_dma.cu``) against the plain versions of their schedules,
   and ``collective_reduce`` against its plain version, case by case, bit
   for bit;
7. collectives at full width: ``hetccl.tree_all_reduce`` of a gradient tree
   shaped like full-width smollm-135m (f32, every parameter, 651 MB per
   rank) on a ThreadMesh of ranks sharing the card: (pod=2, data=2) in modes
   hier and pipelined, backends xla and pallas, and hier/pallas with a bf16
   cross stage; (pod=4, data=1) hier.  The counts are set to 0 just before
   the (pod=2, data=2) hier/pallas run and read just after: the fused
   kernels must have run.  Pallas must equal xla bit for bit in f32, and
   both lie close to a float64 sum over ranks.  One more run pins the rings
   to the emulated schedule, whose accumulate launches ``collective_reduce``.
   Then host-clock times (backends in turns) and the card's busy share;
8. times of the collective kernels at the largest bucket's shape, with
   their bounds and library yardsticks;
9. codec kernels vs plain: ``quant_int8`` and ``dq_accum_int8``
   (``csrc/quant.cu``) against their plain versions, case by case, bit for
   bit (NaN where NaN), up to the largest bucket's hop shape;
10. flash backward vs plain: ``flash_attention_bwd``
   (``csrc/flash_attention_bwd.cu``) against its plain version at the
   training shape and the edge cases, each with its limits, and the
   forward's row logsumexp against its plain version;
11. training at full width: ZeRO-1 steps of full-width smollm-135m (bf16
   parameters, f32 master state, weights from a seed) on a ThreadMesh
   (pod=2, data=2), ``uniform_plan(2, 4, micro_batch=2)``, seq 512, one
   memorize batch, in three runs from the same init: ``backend="pallas",
   wire_quant="int8"`` with error feedback (the main path), ``"pallas"``
   without a codec (the fused ring kernels) and ``"xla"``.  The counts are set
   to 0 just before each run and read just after; each kernel must have run
   the times the step implies.  Step-0 loss is the same in all three, losses
   are finite and fall, and the int8 run ends within a stated limit of the
   run without a codec.  Then ms per step (runs in turns), tokens/s, the
   split of a step, the card's busy share and the peak memory;
12. times of the codec kernels at the largest bucket's hop shape and of the
   flash backward at the training shape, with their bounds, plain versions
   and (flash backward) SDPA's autograd as the yardstick;
13. grouped matmul vs plain: ``grouped_matmul`` (``csrc/grouped_matmul.cu``)
   against its plain version, case by case (``GMM_CASES``: the sweep shapes
   of tests/test_kernels.py in f32 and bf16, Mixtral's prefill and decode
   shapes, moonshot's expert shape, zero rows, views of stacked weights),
   each with its limits (``GMM_LIMITS``);
14. MoE serving at full width: mixtral-8x7b (d_model 4096, 8 experts top-2
   of d_ff 14336, window 4096) cut to 8 of its 32 layers, bf16, weights from
   a seed, answers 8 requests of 512 prompt tokens, 32 new tokens each,
   through ``Batcher``; the counts set to 0 just before and read just after:
   3 x 8 x 33 = 792 grouped-matmul launches, 8 flash.  In one more prefill
   every grouped matmul and every layer's expert FFN against their plain
   versions on the same inputs (the hard gate); then the last-position
   logits against expert_ffn pinned to the plain composition, gated on the
   requests whose routes and drops agree in every layer; tokens/s, prefill
   and decode ms, busy share, peak memory;
15. the sliding window at full width: the same model, 1 request of 4608
   prompt tokens and 16 new: flash with window 4096 at Sq 4608, the rolling
   cache (4096 slots), decode through ``window_decode_attention``, 408
   grouped-matmul launches, and the same comparisons but the per-layer one;
16. grouped-matmul times at Mixtral's prefill and decode shapes, with the
   plain version, ``torch.bmm`` (a yardstick the port never calls) and the
   bound;
17. a JSON line listing every kernel;
18. the last line, ``{"ok": true, "device": {...}}``.

Each phase prints its wall time.

It needs the repository around it: run alone, or where
``torch.cuda.is_available()`` is false, it exits non-zero and prints no result.
"""
import contextlib
import dataclasses
import gc
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

# H100 SXM data-sheet peaks (dense): device memory rate, bf16 tensor-core
# rate, and the f32 rate of the CUDA cores that the f32 route runs on.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}

# (name, B, Hq, Hkv, Sq, Sk, d, kind, window, k_len, dtype, model_layout)
# Inputs are unit-scale normals.  Every row of every case has a valid key.
KERNEL_CASES = [
    ("serve_prefill", 8, 9, 3, 512, 512, 64, "causal", 0, None, "bfloat16", True),
    ("ragged_s300", 8, 9, 3, 300, 300, 64, "causal", 0, None, "bfloat16", True),
    ("d128_hq36_hkv4", 2, 36, 4, 512, 512, 128, "causal", 0, None, "bfloat16", False),
    ("bidir_klen301", 2, 8, 2, 384, 384, 64, "bidir", 0, 301, "bfloat16", False),
    ("window64", 2, 9, 3, 512, 512, 64, "causal", 64, None, "bfloat16", False),
    ("bidir_sq100_sk300", 2, 4, 2, 100, 300, 64, "bidir", 0, None, "bfloat16", False),
    ("d32_reduced", 2, 4, 2, 200, 200, 32, "causal", 0, None, "bfloat16", True),
    ("f32", 2, 9, 3, 512, 512, 64, "causal", 0, None, "float32", True),
    ("f32_d128_bidir_window48_klen150", 1, 4, 1, 150, 200, 128, "bidir", 48, 150, "float32", False),
    # mixtral's window prefill (phase 15): d 128, GQA 32/8, window 4096 < Sq
    ("mixtral_window4096", 1, 32, 8, 4608, 4608, 128, "causal", 4096, None, "bfloat16", True),
]

# Kernel against its plain version, both errors relative to the plain output:
# (relative L2 of the whole output, worst relative L2 of one output row).  The
# row limit catches a fault confined to a few rows (a tile edge, a window
# boundary).  bf16: the kernel rounds P to bf16 for the P.V product, and both
# sides round the output to bf16 (an ulp is 2**-8 to 2**-7 of the value).
# f32: the same sums in another order.  Each limit is 2 to 5 times the
# largest reading over these cases on an H100 (PERF.md); the faults planted
# by tests/test_torch_cuda.py land 10 times and more above them.
ATTN_LIMITS = {"bfloat16": (5e-3, 1e-2), "float32": (1e-6, 3e-6)}

ARCH = "smollm-135m"
N_REQUESTS, PROMPT_LEN, MAX_NEW, SEED = 8, 512, 32, 0
# Prefill logits (last position, relative L2) through the kernel against
# attention pinned to the plain variant.  bf16: random weights amplify
# rounding over 30 layers, so two bf16 routes that round in different places
# drift apart; the limit is set from the readings on these seeds (0.148 to
# 0.156 on an H100, PERF.md).  The tight
# bf16 check at full depth is per layer (ATTN_LIMITS on each layer's own
# inputs).  f32: the same weights in f32, sums taken in another order only.
BF16_LOGITS_REL_TOL = 0.25
F32_LOGITS_REL_TOL = 1e-4

# Ring kernels against the plain versions of their schedules: both do the
# same adds in the same order, so the limit is bitwise equality.  Cases:
# (kind, ring length n, rings in the launch, direction, stripes, input
# dtype, wire dtype); c elements per chunk, ragged on purpose.
RING_C = 1_000_003
RING_CASES = (
    [("rs", n, 1, d, k, "float32", w) for n in (2, 3, 4, 5) for d in (1, -1)
     for k in (1, 2) for w in ("float32", "bfloat16")]
    + [("rs", 3, 1, 1, 2, "bfloat16", "bfloat16"), ("rs", 4, 1, -1, 1, "bfloat16", "bfloat16"),
       ("rs", 2, 2, 1, 1, "float32", "float32"), ("rs", 3, 2, -1, 2, "float32", "bfloat16")]
    + [("ag", n, 1, d, k, "float32", None) for n in (2, 3, 4, 5) for d in (1, -1)
       for k in (1, 2)]
    + [("ag", 3, 1, 1, 2, "bfloat16", None), ("ag", 2, 2, -1, 1, "float32", None)])
# collective_reduce: incoming dtype, length
REDUCE_CASES = [("float32", RING_C), ("bfloat16", RING_C), ("float32", 7), ("bfloat16", 4097)]

COLL_ARCH = "smollm-135m"
COLL_SEED = 1000
# relative L2 of the all-reduced tree against a float64 sum over ranks.  f32:
# the ring adds in f32 in its own order; four unit normals per element.
COLL_F32_REL_TOL = 1e-6
# bf16 cross stage: the shard is rounded to bf16 before the ring, each hop
# rounds the running partial, the result is rounded once more.  Twice the
# reading on an H100 (2.45e-3, PERF.md).
COLL_BF16_REL_TOL = 5e-3
COLL_TIMING_REPS = 5

# Flash backward against its plain version (dq, dk, dv, each against the
# plain f32 gradient): relative L2 of the whole tensor, and the worst row's
# error over the larger of its own norm and the mean row norm (a row's own
# norm can be 0: the first query row of a causal mask has dq = 0 exactly).
# bf16: P and dS are rounded to bf16 for the products that take them.
# Limits: about 3 times the largest reading over these cases on an H100
# (1.70e-3 and 3.87e-3 in bf16, 7.80e-7 and 1.22e-6 in f32; PERF.md).
BWD_LIMITS = {"bfloat16": (5e-3, 1e-2), "float32": (3e-6, 4e-6)}
# (name, B, Hq, Hkv, S, d, kind, window, k_len, dtype, model_layout)
BWD_CASES = [
    ("train", 2, 9, 3, 512, 64, "causal", 0, None, "bfloat16", True),
    ("train_f32", 2, 9, 3, 512, 64, "causal", 0, None, "float32", True),
    ("ragged_s300_bidir_klen201", 1, 4, 2, 300, 64, "bidir", 0, 201, "bfloat16", False),
    ("window48_d32", 2, 4, 1, 256, 32, "causal", 48, None, "bfloat16", False),
    ("d128_hq8_hkv2", 1, 8, 2, 200, 128, "causal", 0, None, "bfloat16", False),
    ("f32_d128_bidir_window40_klen130", 1, 4, 1, 150, 128, "bidir", 40, 130, "float32", False),
    ("f32_d32_s100", 2, 4, 2, 100, 32, "causal", 0, None, "float32", True),
]
# Codec cases: (name, rows of 512, fill); each also as an odd-width view
QUANT_ROWS = [("one_row", 1, "randn"), ("seven_rows", 7, "randn"), ("zero_chunks", 1000, "zeros"),
              ("half_way", 600, "half"), ("nan_chunk", 300, "nan"), ("wide_range", 5000, "randn")]

TRAIN_SEQ, TRAIN_MICRO_BATCH, TRAIN_STEPS, TRAIN_LR = 512, 2, 5, 1e-3
TRAIN_RUNS = {"int8_ef": dict(backend="pallas", wire_quant="int8"),
              "pallas": dict(backend="pallas"), "xla": dict(backend="xla")}
# The int8 run's final loss against the run without a codec, absolute.  The
# codec quantizes the gradients (with error feedback) and the parameter
# all-gather (ROADMAP C2); 5 steps at lr 1e-3 from one init.  About 3 times
# the reading on an H100 (5.25e-2, PERF.md).
TRAIN_INT8_LOSS_TOL = 0.15
TRAIN_TIMING_REPS = 2


# The MoE slice: full-width mixtral-8x7b cut to 8 of its 32 layers (every
# kernel at its published shape; 23.7 GB of bf16 weights), weights from a seed.
MOE_ARCH, MOE_LAYERS = "mixtral-8x7b", 8
MOE_REQUESTS, MOE_PROMPT, MOE_NEW = 8, 512, 32
WINDOW_PROMPT, WINDOW_NEW = 4608, 16       # past the 4096 window: rolling cache

# Grouped matmul against its plain version, both errors relative to the plain
# output: (relative L2 of the whole output, worst row's L2 error over the
# larger of its own norm and the mean row norm; a dropped token's row is 0).
# bf16: both sum exact products in f32 and round once, so they differ only
# where the two sums' order flips a rounding, by one ulp (2**-8 to 2**-7 of
# the value).  f32: the same sums in another order (fmaf in the kernel).
GMM_LIMITS = {"bfloat16": (1e-3, 5e-3), "float32": (1e-6, 4e-6)}
# expert_ffn through the kernel against the same composition through the
# plain version: h1 and h3 may differ by an ulp, which SiLU, the product and
# w2 carry into the output.
FFN_LIMITS = {"bfloat16": (5e-3, 2e-2), "float32": (1e-6, 4e-6)}
# Last-position logits (relative L2) of the served model through the kernel
# against expert_ffn pinned to the plain composition: gated on the requests
# whose routes and drops agree in every layer (routing is discontinuous: a
# request whose routes differ anywhere is compared but not gated), and on
# every request of a plain run that replays the kernel run's routes.
# bf16: random weights amplify rounding from layer to layer (the MoE
# outputs' drift is printed per layer), as in the dense serve phase; 0.1 was
# stated before the first reading and missed (0.020 to 0.160 over the 8
# requests, routes replayed, on an H100; PERF.md), so the limit is twice the
# largest reading.  The tight end-to-end check is f32: the same model's
# first MOE_F32_LAYERS layers in f32, where both routes differ only in the
# order of f32 sums.
MOE_LOGITS_REL_TOL = {"bfloat16": 0.3, "float32": 1e-4}
MOE_F32_LAYERS = 2
# (name, G, M, K, N, dtype, layout): "dense"; "zero_rows" (a capacity buffer
# with dropped tokens' rows zero); "layer_view" (w a layer slice of a stacked
# (L, G, K, N') tensor, columns 24..24+N, 16-byte aligned rows); "odd_view"
# (columns from 3: unaligned rows, the kernel's plain-load path).
GMM_CASES = [
    *[(f"sweep_{G}x{M}x{K}x{N}", G, M, K, N, dt, "dense")
      for G, M, K, N in ((4, 200, 96, 160), (1, 128, 128, 128), (8, 64, 300, 48))
      for dt in ("float32", "bfloat16")],
    ("mixtral_prefill_w13", 8, 1280, 4096, 14336, "bfloat16", "dense"),
    ("mixtral_prefill_w2", 8, 1280, 14336, 4096, "bfloat16", "dense"),
    ("mixtral_decode_w13", 8, 2, 4096, 14336, "bfloat16", "dense"),
    ("mixtral_decode_w2", 8, 2, 14336, 4096, "bfloat16", "dense"),
    ("mixtral_window_w13", 8, 1440, 4096, 14336, "bfloat16", "zero_rows"),
    ("moonshot_expert", 64, 240, 2048, 1408, "bfloat16", "dense"),
    ("zero_rows", 8, 300, 512, 640, "bfloat16", "zero_rows"),
    ("layer_view", 8, 100, 512, 1000, "bfloat16", "layer_view"),
    ("odd_view", 4, 33, 256, 500, "bfloat16", "odd_view"),
    ("ragged_k100_m9", 5, 9, 100, 70, "bfloat16", "dense"),
    ("f32_reduced_expert", 4, 80, 128, 128, "float32", "dense"),
    ("f32_ragged_views", 3, 77, 129, 65, "float32", "odd_view"),
]


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def median_ms(fn, reps=20, trials=7, warmup=3):
    """Time of one call on the card: CUDA events around ``reps`` calls made
    back to back, so the queue stays full and the host's time to launch a
    call hides behind the card's work; the median over ``trials``."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(trials):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) / reps for s, e in pairs)


def attention_inputs(gen, B, Hq, Hkv, Sq, Sk, d, dtype, model_layout):
    """q (B,Hq,Sq,d), k/v (B,Hkv,Sk,d); as transpose views of (B,S,H,d)
    tensors when ``model_layout``, the way the model's prefill passes them."""
    import torch

    def one(H, S):
        if model_layout:
            t = torch.randn(B, S, H, d, generator=gen, device="cuda")
            return t.to(dtype).transpose(1, 2)
        return torch.randn(B, H, S, d, generator=gen, device="cuda").to(dtype)

    return one(Hq, Sq), one(Hkv, Sk), one(Hkv, Sk)


def attention_error(out, want):
    """Errors of ``out`` against ``want`` (..., S, d): max abs, relative L2
    of the whole tensor, and the worst relative L2 of one row."""
    diff = out.float() - want.float()
    ref = want.float()
    rows = diff.norm(dim=-1) / ref.norm(dim=-1)
    return {"max_abs_err": diff.abs().max().item(),
            "rel_l2": (diff.norm() / ref.norm()).item(),
            "worst_row_rel_l2": rows.max().item()}


def within_limits(err, dtype_name):
    rel_lim, row_lim = ATTN_LIMITS[dtype_name]
    return err["rel_l2"] <= rel_lim and err["worst_row_rel_l2"] <= row_lim


def format_error(err, dtype_name):
    rel_lim, row_lim = ATTN_LIMITS[dtype_name]
    return (f"max_abs_err {err['max_abs_err']:.3e}  rel_l2 {err['rel_l2']:.3e} "
            f"(limit {rel_lim:.0e})  worst_row {err['worst_row_rel_l2']:.3e} "
            f"(limit {row_lim:.0e})")


def valid_pairs(Sq, Sk, kind, window, k_len):
    import numpy as np
    qp = np.arange(Sq)[:, None]
    kp = np.arange(Sk)[None, :]
    valid = kp < k_len
    if kind == "causal":
        valid = valid & (qp >= kp)
    if window:
        valid = valid & (qp - kp < window)
    return int(valid.sum())


def bound(q, k, v, kind, window, k_len):
    """(bound_ms, bound_by): bytes moved once over the memory rate against
    the valid (q, k) pairs' 4*d operations over the peak rate for the type."""
    B, Hq, Sq, d = q.shape
    Sk = k.shape[2]
    elem = q.element_size()
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * elem      # q, k, v, o
    flops = 4 * d * B * Hq * valid_pairs(Sq, Sk, kind, window, k_len)
    dtype = str(q.dtype).removeprefix("torch.")
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_kernels(fa, torch):
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    results = {}
    failed = []
    for (name, B, Hq, Hkv, Sq, Sk, d, kind, window, k_len, dt,
         model_layout) in KERNEL_CASES:
        dtype = getattr(torch, dt)
        q, k, v = attention_inputs(gen, B, Hq, Hkv, Sq, Sk, d, dtype, model_layout)
        kl = Sk if k_len is None else k_len
        out = fa.flash_attention_fwd(q, k, v, kind=kind, window=window, k_len=kl)
        want = fa.flash_attention_plain(q, k, v, kind=kind, window=window, k_len=kl)
        torch.cuda.synchronize()
        check(out.shape == want.shape and out.dtype == want.dtype,
              f"{name}: output {tuple(out.shape)} {out.dtype}")
        check(bool(torch.isfinite(out).all()), f"{name}: non-finite output")
        err = attention_error(out, want)
        ok = within_limits(err, dt)
        print(f"  {name:32s} {dt:8s} {format_error(err, dt)}  {'ok' if ok else 'FAIL'}")
        if not ok:
            failed.append(name)
        results[name] = {**err, "inputs": (q, k, v), "kind": kind,
                         "window": window, "k_len": kl}
    check(not failed, f"kernel disagrees with its plain version in {failed}")
    return results


def phase_layers(torch, tacc, ops, fa, model, params, batch):
    """The kernel on the inputs each layer of a real prefill gives it, against
    its plain version on the same inputs: the bf16 check at full depth that
    the model's amplification of rounding cannot blur."""
    errs = []

    def recorded(q, k, v, **kw):
        out = ops.flash_attention(q, k, v, **kw)
        want = fa.flash_attention_plain(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            kind=kw["kind"], window=kw["window"]).transpose(1, 2)
        errs.append(attention_error(out, want))
        return out

    tacc.register("attention", "cuda_layer_check")(recorded)
    tacc.set_platform("cuda_layer_check")
    try:
        with torch.inference_mode():
            model.prefill(params, batch)
    finally:
        tacc.set_platform(None)
    dt = model.cfg.dtype
    worst = {key: max(e[key] for e in errs) for key in errs[0]}
    ok = len(errs) == model.cfg.n_layers and all(within_limits(e, dt) for e in errs)
    print(f"  per layer ({len(errs)} layers), worst: {format_error(worst, dt)}  "
          f"{'ok' if ok else 'FAIL'}")
    check(ok, "the kernel disagrees with its plain version on a layer's inputs")
    return worst


def _tree_map(fn, tree):
    return {k: _tree_map(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def phase_serve(torch, np, fa, ops, tacc, get_config, build, engine):
    cfg = get_config(ARCH)
    dev = torch.device("cuda")
    model = build(cfg)
    max_len = PROMPT_LEN + MAX_NEW
    progs = engine.make_serve_programs(model, seq_len=PROMPT_LEN,
                                       max_len=max_len, device=dev)
    params = model.init(torch.Generator(device=dev).manual_seed(SEED))
    rng = np.random.RandomState(SEED)
    prompts = [rng.randint(0, cfg.vocab, PROMPT_LEN).astype(np.int32)
               for _ in range(N_REQUESTS)]
    print(f"  {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.n_heads}/{cfg.n_kv_heads} heads x {cfg.head_dim_}, d_ff {cfg.d_ff}, "
          f"vocab {cfg.vocab}, {cfg.dtype}, {model.n_params() / 1e6:.1f}M params")

    finite = [torch.ones((), dtype=torch.bool, device=dev)]

    def watched(fn):
        def run(*args):
            logits, cache = fn(*args)
            finite[0] = finite[0] & torch.isfinite(logits).all()
            return logits, cache
        return run

    watched_progs = dataclasses.replace(progs, prefill_fn=watched(progs.prefill_fn),
                                        decode_fn=watched(progs.decode_fn))

    def requests(max_new):
        return [engine.Request(i, p, max_new) for i, p in enumerate(prompts)]

    def batcher():
        return engine.Batcher(watched_progs, params, batch_slots=N_REQUESTS,
                              prompt_len=PROMPT_LEN, max_len=max_len)

    batcher().run(requests(2))            # warm-up: cuBLAS, kernel load
    torch.cuda.synchronize()

    fa.launches = 0
    t0 = time.perf_counter()
    done = batcher().run(requests(MAX_NEW))
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    launches = fa.launches

    n_batches = -(-N_REQUESTS // N_REQUESTS)
    check(launches == cfg.n_layers * n_batches,
          f"flash kernel launched {launches} times in the serve run, "
          f"expected {cfg.n_layers} per prefill batch x {n_batches}")
    check(len(done) == N_REQUESTS and all(len(r.out) == MAX_NEW for r in done),
          "not every request got its tokens")
    check(all(0 <= t < cfg.vocab for r in done for t in r.out),
          "a token is outside the vocab")
    check(bool(finite[0]), "non-finite logits in the serve run")
    n_tok = sum(len(r.out) for r in done)
    print(f"  served {len(done)} requests, {n_tok} tokens in {serve_s:.3f} s; "
          f"flash kernel launches {launches} "
          f"({cfg.n_layers} layers x {n_batches} prefill batch)")

    # The kernel route against attention pinned to the plain variant: per
    # layer on the layer's own inputs, then at the logits, in bf16 and with
    # the same weights in f32 (BF16_LOGITS_REL_TOL says why both).
    toks = torch.as_tensor(np.stack(prompts).astype(np.int64), device=dev)
    batch = {"tokens": toks}
    layers = phase_layers(torch, tacc, ops, fa, model, params, batch)

    def last_logits(m, p, plain):
        tacc.set_platform("cpu" if plain else None)
        try:
            with torch.inference_mode():
                return m.prefill(p, batch)[0][:, -1].float()
        finally:
            tacc.set_platform(None)

    def rel(a, b):
        return ((a - b).norm() / b.norm()).item()

    lk = last_logits(model, params, plain=False)
    lp = last_logits(model, params, plain=True)
    m32 = build(dataclasses.replace(cfg, dtype="float32"))
    p32 = _tree_map(lambda t: t.float(), params)
    lf = last_logits(m32, p32, plain=True)
    lfk = last_logits(m32, p32, plain=False)
    for t in (lk, lp, lf, lfk):
        check(bool(torch.isfinite(t).all()), "non-finite prefill logits")
    agree = {"bf16_kernel_vs_plain": rel(lk, lp),
             "bf16_plain_vs_f32": rel(lp, lf),
             "bf16_kernel_vs_f32": rel(lk, lf),
             "f32_kernel_vs_plain": rel(lfk, lf),
             "bf16_same_argmax": (lk.argmax(-1) == lp.argmax(-1)).float().mean().item()}
    print("  prefill last-position logits, rel L2: " + ", ".join(
        f"{k} {v:.3e}" for k, v in agree.items()))
    check(agree["bf16_kernel_vs_plain"] <= BF16_LOGITS_REL_TOL,
          f"bf16 kernel route is {agree['bf16_kernel_vs_plain']:.3e} from the plain "
          f"route, beyond {BF16_LOGITS_REL_TOL}")
    check(agree["f32_kernel_vs_plain"] <= F32_LOGITS_REL_TOL,
          f"f32 kernel route disagrees: {agree['f32_kernel_vs_plain']:.3e}")

    # serving times on the host clock, each ending in a synchronise
    def timed(fn, reps):
        out = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            out.append((time.perf_counter() - t) * 1e3)
        return statistics.median(out)

    prefill_ms = timed(lambda: progs.prefill_fn(params, batch), 5)
    _, cache = progs.prefill_fn(params, batch)
    cur = toks[:, -1:]

    def step():
        nonlocal cache
        _, cache = progs.decode_fn(params, cache, cur)

    decode_ms = timed(step, MAX_NEW - 2)

    def measure_busy():
        """Run last: the profiler's tracing may slow what runs after it."""
        nonlocal cache
        busy_prefill = device_busy_share(torch, lambda: progs.prefill_fn(params, batch), 1)
        _, cache = progs.prefill_fn(params, batch)
        busy_decode = device_busy_share(torch, step, MAX_NEW // 2)
        print(f"  card busy share (torch.profiler kernel time / host wall time): "
              f"prefill {busy_prefill}, decode {busy_decode}")
        return {"device_busy_prefill": busy_prefill, "device_busy_decode": busy_decode}

    serve = {"arch": cfg.name, "requests": len(done), "prompt_len": PROMPT_LEN,
             "new_tokens_per_request": MAX_NEW, "prefill_ms": prefill_ms,
             "decode_ms_per_token": decode_ms, "serve_s": serve_s,
             "tokens_per_s": n_tok / serve_s, "flash_launches": launches,
             "layer_worst_error": layers, "prefill_logits_rel_l2": agree}
    print(f"  prefill {prefill_ms:.3f} ms (batch {N_REQUESTS} x {PROMPT_LEN}), "
          f"decode {decode_ms:.3f} ms per step (batch {N_REQUESTS}), "
          f"{n_tok / serve_s:.1f} tokens/s end to end")
    return serve, launches, measure_busy


def device_busy_share(torch, fn, reps):
    """Kernel time on the card over host wall time for ``reps`` calls of
    ``fn``, from a torch.profiler trace of CUDA activity only (kernels of one
    stream do not overlap, so their sum is the busy time).  None when the
    trace holds no kernel: then the share is not measured."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t) * 1e6
    kernel_us = sum(e.time_range.elapsed_us() for e in prof.events()
                    if e.device_type == DeviceType.CUDA)
    return kernel_us / wall_us if kernel_us > 0 else None


def phase_times(fa, torch, case):
    import torch.nn.functional as F
    q, k, v = case["inputs"]
    kind, window, k_len = case["kind"], case["window"], case["k_len"]
    kernel_ms = median_ms(lambda: fa.flash_attention_fwd(
        q, k, v, kind=kind, window=window, k_len=k_len))
    plain_ms = median_ms(lambda: fa.flash_attention_plain(
        q, k, v, kind=kind, window=window, k_len=k_len), reps=10)
    library_ms = median_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=kind == "causal", enable_gqa=True))
    bound_ms, bound_by = bound(q, k, v, kind, window, k_len)
    print(f"  flash_attention_fwd at {tuple(q.shape)} / {tuple(k.shape)} "
          f"{str(q.dtype).removeprefix('torch.')} {kind}: kernel {kernel_ms:.4f} ms, "
          f"plain {plain_ms:.4f} ms, library (sdpa) {library_ms:.4f} ms, "
          f"bound {bound_ms:.4f} ms ({bound_by})")
    return kernel_ms, plain_ms, library_ms, bound_ms, bound_by


# ---------------------------------------------------------------------------
# Collective path: ring kernels, full-width tree_all_reduce, kernel times
# ---------------------------------------------------------------------------

def ring_case_inputs(torch, gen, kind, n, n_rings, in_dtype, c=RING_C):
    """Per-rank inputs of one launch: rings of length n, unit normals."""
    R = n * n_rings
    rings = [list(range(i * n, (i + 1) * n)) for i in range(n_rings)]
    shape = (n, c) if kind == "rs" else (c,)
    xs = [torch.randn(shape, generator=gen, device="cuda").to(getattr(torch, in_dtype))
          for _ in range(R)]
    return xs, rings


def run_ring_case(torch, ring_dma, case, xs, rings):
    """(kernel outputs, plain outputs) of one case."""
    kind, n, _, d, k, _, w = case
    if kind == "rs":
        kw = dict(direction=d, n_stripes=k, wire_dtype=getattr(torch, w))
        return (ring_dma.reduce_scatter_fused(xs, rings, **kw),
                ring_dma.reduce_scatter_fused_plain(xs, rings, **kw))
    kw = dict(direction=d, n_stripes=k)
    return (ring_dma.all_gather_fused(xs, rings, **kw),
            ring_dma.all_gather_fused_plain(xs, rings, **kw))


def bitwise_error(outs, wants):
    """(all equal bit for bit, largest absolute difference)."""
    import torch
    same = all(o.shape == w.shape and o.dtype == w.dtype and torch.equal(o, w)
               for o, w in zip(outs, wants))
    diff = max((o.double() - w.double()).abs().max().item() for o, w in zip(outs, wants))
    return same, diff


def phase_ring_kernels(torch, ring_dma, cr):
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    failed = []
    worst = {"ring_reduce_scatter": 0.0, "ring_all_gather": 0.0, "collective_reduce": 0.0}
    for case in RING_CASES:
        kind, n, n_rings, d, k, dt, w = case
        xs, rings = ring_case_inputs(torch, gen, kind, n, n_rings, dt)
        outs, wants = run_ring_case(torch, ring_dma, case, xs, rings)
        torch.cuda.synchronize()
        same, diff = bitwise_error(outs, wants)
        extra = ""
        if kind == "rs" and dt == w == "float32":
            # and both against the float64 sum over each ring's ranks
            want = [sum(xs[r].double() for r in ring)[ring.index(rk)]
                    for ring in rings for rk in ring]
            rel = max(((o.double() - t).norm() / t.norm()).item()
                      for o, t in zip(outs, want))
            extra = f"  rel_l2 vs f64 sum {rel:.2e}"
            same = same and rel <= COLL_F32_REL_TOL
        name = (f"{kind} n={n} rings={n_rings} dir={d:+d} stripes={k} in={dt}"
                + (f" wire={w}" if w else ""))
        key = "ring_reduce_scatter" if kind == "rs" else "ring_all_gather"
        worst[key] = max(worst[key], diff)
        print(f"  {name:62s} max_abs_err {diff:.3e}{extra}  {'ok' if same else 'FAIL'}")
        if not same:
            failed.append(name)
    for inc_dt, length in REDUCE_CASES:
        acc = torch.randn(length, generator=gen, device="cuda")
        inc = torch.randn(length, generator=gen, device="cuda").to(getattr(torch, inc_dt))
        out, want = cr.collective_reduce(acc, inc), cr.collective_reduce_plain(acc, inc)
        same, diff = bitwise_error([out], [want])
        name = f"collective_reduce f32 + {inc_dt} n={length}"
        worst["collective_reduce"] = max(worst["collective_reduce"], diff)
        print(f"  {name:62s} max_abs_err {diff:.3e}  {'ok' if same else 'FAIL'}")
        if not same:
            failed.append(name)
    check(not failed, f"ring kernels disagree with their plain versions in {failed}")
    return len(RING_CASES) + len(REDUCE_CASES), worst


def grad_shapes(get_config, build):
    """Leaf shapes of full-width smollm-135m's parameter tree."""
    from repro_torch.models.common import tree_map_meta
    model = build(get_config(COLL_ARCH))
    return model, tree_map_meta(lambda m: tuple(m.shape), model.abstract_params())


def _leaves(tree):
    if isinstance(tree, dict):
        return [lf for k in sorted(tree) for lf in _leaves(tree[k])]
    return [tree]


def make_grads(torch, shapes, R):
    """Per-rank f32 gradient trees, values from a seeded generator per rank."""
    out = []
    for r in range(R):
        gen = torch.Generator(device="cuda").manual_seed(COLL_SEED + r)
        out.append(_tree_map(lambda shp: torch.randn(shp, generator=gen, device="cuda"),
                             shapes))
    return out


def tree_rel_err(torch, got, grads):
    """Relative L2 of ``got`` against the float64 sum of every rank's tree."""
    num = den = 0.0
    for i, g in enumerate(_leaves(got)):
        want = sum(_leaves(t)[i].double() for t in grads)
        num += (g.double() - want).norm().item() ** 2
        den += want.norm().item() ** 2
    return (num / den) ** 0.5


def trees_equal(torch, a, b):
    return all(torch.equal(x, y) for x, y in zip(_leaves(a), _leaves(b)))


def phase_collectives(torch, hetccl, tacc, mesh_mod, ring_dma, cr, get_config, build):
    model, shapes = grad_shapes(get_config, build)
    n_params = model.n_params()
    print(f"  gradient tree of {COLL_ARCH}: {n_params} parameters, "
          f"{n_params * 4 / 1e6:.1f} MB of f32 per rank")
    results = {"n_params": n_params, "bytes_per_rank": n_params * 4}

    def run(m, grads, mode, backend, **kw):
        cfg = hetccl.HetCCLConfig(mode=mode, backend=backend, **kw)
        outs = m.run(lambda t: hetccl.tree_all_reduce(t, cfg), grads)
        torch.cuda.synchronize()
        check(all(trees_equal(torch, outs[0], o) for o in outs[1:]),
              f"{mode}/{backend}: the ranks' results differ")
        return outs[0]

    m22 = mesh_mod.ThreadMesh({"pod": 2, "data": 2}, device="cuda")
    grads = make_grads(torch, shapes, m22.size)
    run(m22, grads, "hier", "pallas")                 # warm-up: kernels, scratch, allocator
    run(m22, grads, "hier", "xla")

    cr.launches = ring_dma.rs_launches = ring_dma.ag_launches = 0
    main = run(m22, grads, "hier", "pallas")
    launches = {"ring_reduce_scatter": ring_dma.rs_launches,
                "ring_all_gather": ring_dma.ag_launches}
    print(f"  (pod=2, data=2) hier/pallas launches per tree_all_reduce: {launches}")
    check(launches["ring_reduce_scatter"] > 0 and launches["ring_all_gather"] > 0,
          "the fused ring kernels did not run on the collective path")

    readings = {}
    for mode in ("hier", "pipelined"):
        ref = run(m22, grads, mode, "xla")
        got = main if mode == "hier" else run(m22, grads, mode, "pallas")
        same = trees_equal(torch, got, ref)
        rel = {b: tree_rel_err(torch, t, grads) for b, t in (("xla", ref), ("pallas", got))}
        ok = same and max(rel.values()) <= COLL_F32_REL_TOL
        print(f"  (pod=2, data=2) {mode:9s} f32: pallas == xla bit for bit: {same}; "
              f"rel L2 vs f64 sum: xla {rel['xla']:.3e}, pallas {rel['pallas']:.3e} "
              f"(limit {COLL_F32_REL_TOL:.0e})  {'ok' if ok else 'FAIL'}")
        check(ok, f"{mode}: pallas and xla disagree or miss the f64 sum")
        readings[f"{mode}_f32_rel_l2"] = rel
        del ref, got

    bf = run(m22, grads, "hier", "pallas", cross_dtype=torch.bfloat16)
    rel_bf = tree_rel_err(torch, bf, grads)
    del bf
    print(f"  (pod=2, data=2) hier/pallas bf16 cross stage: rel L2 vs f64 sum {rel_bf:.3e} "
          f"(limit {COLL_BF16_REL_TOL:.0e})  {'ok' if rel_bf <= COLL_BF16_REL_TOL else 'FAIL'}")
    check(rel_bf <= COLL_BF16_REL_TOL, "bf16 cross stage beyond its limit")
    readings["hier_bf16_rel_l2"] = rel_bf

    # the emulated schedule on the card: ppermute hops + collective_reduce
    prev = {op: tacc.get_default(op) for op in ring_dma.SCHEDULE_OPS}
    for op in ring_dma.SCHEDULE_OPS:
        tacc.set_default(op, "emulated")
    try:
        cr.launches = ring_dma.rs_launches = ring_dma.ag_launches = 0
        emu = run(m22, grads, "hier", "pallas")
        reduce_launches = cr.launches
        fused_in_pinned = ring_dma.rs_launches + ring_dma.ag_launches
    finally:
        for op, variant in prev.items():
            tacc.set_default(op, variant)
    same = trees_equal(torch, emu, main)
    print(f"  rings pinned to the emulated schedule: collective_reduce launches "
          f"{reduce_launches}, fused launches {fused_in_pinned}; equal to the fused "
          f"run bit for bit: {same}  {'ok' if same else 'FAIL'}")
    check(same and reduce_launches > 0 and fused_in_pinned == 0,
          "the emulated schedule on the card disagrees or did not launch collective_reduce")
    launches["collective_reduce"] = reduce_launches
    del emu, main

    # host-clock times, backends in turns, then the card's busy share
    def timed(mode, backend):
        cfg = hetccl.HetCCLConfig(mode=mode, backend=backend)
        torch.cuda.synchronize()
        t = time.perf_counter()
        m22.run(lambda g: hetccl.tree_all_reduce(g, cfg), grads)
        torch.cuda.synchronize()
        return (time.perf_counter() - t) * 1e3

    times = {}
    for mode in ("hier", "pipelined"):
        ms = {"xla": [], "pallas": []}
        for _ in range(COLL_TIMING_REPS):
            for b in ("xla", "pallas"):
                ms[b].append(timed(mode, b))
        times[mode] = {b: statistics.median(v) for b, v in ms.items()}
    busy = {}
    for b in ("xla", "pallas"):
        cfg = hetccl.HetCCLConfig(mode="hier", backend=b)
        busy[b] = device_busy_share(
            torch, lambda: m22.run(lambda g: hetccl.tree_all_reduce(g, cfg), grads), 1)
    print(f"  tree_all_reduce host-clock ms (median of {COLL_TIMING_REPS}, backends in "
          f"turns): {json.dumps(times)}; card busy share hier: {json.dumps(busy)}")
    results.update(readings=readings, launches=launches, host_ms=times, busy=busy)

    buckets = hetccl._make_buckets(_leaves(grads[0]), hetccl.HetCCLConfig().bucket_bytes)
    big = max(sum(_leaves(grads[0])[i].numel() for i in b) for b in buckets)
    results["largest_bucket_elems"] = big
    del grads

    m41 = mesh_mod.ThreadMesh({"pod": 4, "data": 1}, device="cuda")
    grads = make_grads(torch, shapes, m41.size)
    ring_dma.rs_launches = 0
    got = run(m41, grads, "hier", "pallas")
    rs4 = ring_dma.rs_launches
    ref = run(m41, grads, "hier", "xla")
    same = trees_equal(torch, got, ref)
    rel = tree_rel_err(torch, got, grads)
    ok = same and rel <= COLL_F32_REL_TOL and rs4 > 0
    print(f"  (pod=4, data=1) hier f32: {rs4} fused reduce-scatter launches; pallas == xla "
          f"bit for bit: {same}; rel L2 vs f64 sum {rel:.3e}  {'ok' if ok else 'FAIL'}")
    check(ok, "(pod=4, data=1): pallas and xla disagree or miss the f64 sum")
    results["pod4_rel_l2"] = rel
    return results


def phase_collective_times(torch, ring_dma, cr, big):
    """Each collective kernel at the largest bucket's shape in the (pod=2,
    data=2) hier run: ranks 4, rings of 2 over "pod", c = bucket / 2."""
    R, n = 4, 2
    c = big // n
    rings = [[0, 2], [1, 3]]
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    xs = [torch.randn(n, c, generator=gen, device="cuda") for _ in range(R)]
    ag_in = [torch.randn(c, generator=gen, device="cuda") for _ in range(R)]
    out = {}

    def rs(check=False):
        return ring_dma.reduce_scatter_fused(xs, rings, check=check)

    def ag(check=False):
        return ring_dma.all_gather_fused(ag_in, rings, check=check)

    # f32 throughout: input, wire, output 4 bytes
    rs_bytes = R * n * c * 4 + R * c * 4
    ag_bytes = R * c * 4 + R * n * c * 4
    wire_bytes = (R // n) * n * (n - 1) * c * 4
    order = [r for ring in rings for r in ring]          # the ranks ring by ring
    stacked = torch.stack([xs[r] for r in order]).view(R // n, n, n, c)
    ag_stack = torch.stack([ag_in[r] for r in order]).view(R // n, 1, n, c)
    for name, fn, plain, lib, nbytes in (
            ("ring_reduce_scatter", rs,
             lambda: ring_dma.reduce_scatter_fused_plain(xs, rings),
             lambda: stacked.sum(1), rs_bytes),
            ("ring_all_gather", ag,
             lambda: ring_dma.all_gather_fused_plain(ag_in, rings),
             lambda: ag_stack.expand(R // n, n, n, c).contiguous(), ag_bytes)):
        fn(check=True)
        ms = median_ms(fn)
        ring_dma.check_errors()
        out[name] = {"ms": ms, "plain_ms": median_ms(plain, reps=3, trials=3, warmup=1),
                     "library_ms": median_ms(lib), "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
                     "bound_by": "bytes", "wire_bound_ms": wire_bytes / HBM_BYTES_PER_S * 1e3,
                     "shape": f"R={R} n={n} c={c} f32"}
    m = c // 2                                 # one stream of a chunk, the emulated step
    acc = torch.randn(m, generator=gen, device="cuda")
    inc = torch.randn(m, generator=gen, device="cuda")
    out["collective_reduce"] = {
        "ms": median_ms(lambda: cr.collective_reduce(acc, inc)),
        "plain_ms": median_ms(lambda: cr.collective_reduce_plain(acc, inc)),
        "library_ms": median_ms(lambda: torch.add(acc, inc)),
        "bound_ms": 3 * m * 4 / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
        "shape": f"n={m} f32 + f32"}
    for name, t in out.items():
        print(f"  {name} at {t['shape']}: kernel {t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, "
              f"library {t['library_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms (bytes)"
              + (f", ring wire bytes alone {t['wire_bound_ms']:.4f} ms" if "wire_bound_ms" in t
                 else ""))
    return out


# ---------------------------------------------------------------------------
# Training path: codec kernels, flash backward, full-width ZeRO-1 steps
# ---------------------------------------------------------------------------

def same_bits(a, b):
    """Equal bit for bit (f32: NaN where NaN, the other bits equal)."""
    import torch
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.dtype != torch.float32:
        return bool(torch.equal(a, b))
    na, nb = torch.isnan(a), torch.isnan(b)
    return bool(torch.equal(na, nb)) and bool(torch.equal(a[~na].view(torch.int32),
                                                          b[~nb].view(torch.int32)))


def quant_inputs(torch, gen, rows, fill):
    x = torch.randn(rows, 512, generator=gen, device="cuda")
    if fill == "zeros":
        x[::3] = 0.0
    elif fill == "half":                 # absmax 127 -> scale 1; k + 0.5 values
        x = (torch.arange(rows * 512, device="cuda") % 254 - 127).float().reshape(rows, 512) + 0.5
        x[:, 0] = 127.0
    elif fill == "nan":
        x[::7, 11] = float("nan")
    else:                                # chunks at scales from 1e-3 to 1e3
        x = x * torch.exp(torch.randn(rows, 1, generator=gen, device="cuda") * 3)
    return x


def phase_quant_kernels(torch, quant, ref, hop_rows):
    """Both codec kernels against their plain versions, bit for bit."""
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    failed, n = [], 0
    for name, rows, fill in QUANT_ROWS + [("bucket_hop", hop_rows, "randn")]:
        x = quant_inputs(torch, gen, rows, fill)
        acc = torch.randn(rows, 512, generator=gen, device="cuda")
        odd = x.reshape(-1)[1:1 + 509 * max(rows - 1, 1)].reshape(-1, 509)   # unaligned
        for label, xx, aa in ((name, x, acc),
                              (name + "_odd509", odd, acc.reshape(-1)[3:3 + odd.numel()]
                               .reshape(odd.shape))):
            c, sc = quant.wire_quantize_int8(xx)
            c2, sc2 = ref.wire_quantize(xx)
            d = quant.wire_dequant_accum_int8(aa, c, sc)
            d2 = ref.wire_dequant_accum(aa, c, sc)
            torch.cuda.synchronize()
            ok = same_bits(c, c2) and same_bits(sc, sc2) and same_bits(d, d2)
            n += 1
            print(f"  {label:28s} ({tuple(xx.shape)[0]} x {xx.shape[1]}) codes, scales, "
                  f"dequantize-accumulate bit for bit: {ok}  {'ok' if ok else 'FAIL'}")
            if not ok:
                failed.append(label)
    check(not failed, f"codec kernels disagree with their plain versions in {failed}")
    return n


def bwd_error(got, want):
    """Max abs, relative L2, and the worst row's error over the larger of its
    own norm and the mean row norm, of (..., S, d)."""
    diff = got.float() - want.float()
    rows = want.float().norm(dim=-1)
    return {"max_abs_err": diff.abs().max().item(),
            "rel_l2": (diff.norm() / want.float().norm()).item(),
            "worst_row": (diff.norm(dim=-1) / rows.clamp(min=rows.mean())).max().item()}


def phase_flash_bwd(torch, fa, ref):
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    failed, results = [], {}
    for name, B, Hq, Hkv, S, d, kind, window, k_len, dt, model_layout in BWD_CASES:
        dtype = getattr(torch, dt)
        q, k, v = attention_inputs(gen, B, Hq, Hkv, S, S, d, dtype, model_layout)
        do = torch.randn(q.shape, generator=gen, device="cuda").to(dtype)
        kl = S if k_len is None else k_len
        kw = dict(kind=kind, window=window, k_len=kl)
        o, lse = fa.flash_attention_fwd(q, k, v, return_lse=True, **kw)
        lse_plain = ref.attention_lse(q, k, **kw)
        got = fa.flash_attention_bwd(q, k, v, o, do, lse, **kw)
        want = fa.flash_attention_bwd_plain(q, k, v, o, do, lse_plain, **kw)
        torch.cuda.synchronize()
        errs = [bwd_error(g, w) for g, w in zip(got, want)]
        worst = {key: max(e[key] for e in errs) for key in errs[0]}
        lse_err = (lse - lse_plain).abs().max().item()
        rel_lim, row_lim = BWD_LIMITS[dt]
        ok = (worst["rel_l2"] <= rel_lim and worst["worst_row"] <= row_lim and lse_err <= 1e-4
              and all(bool(torch.isfinite(g).all()) for g in got))
        print(f"  {name:32s} {dt:8s} dq/dk/dv worst: max_abs_err {worst['max_abs_err']:.3e} "
              f"rel_l2 {worst['rel_l2']:.3e} (limit {rel_lim:.0e}) worst_row "
              f"{worst['worst_row']:.3e} (limit {row_lim:.0e}); lse max abs err {lse_err:.2e}"
              f"  {'ok' if ok else 'FAIL'}")
        if not ok:
            failed.append(name)
        results[name] = {**worst, "lse_err": lse_err,
                         "inputs": (q, k, v, o, do, lse), "kw": kw}
    check(not failed, f"flash backward disagrees with its plain version in {failed}")
    return results


def train_counts(n_layers, n_micro, R, n_leaves, n_buckets, n_pods):
    """Launches one ZeRO-1 step implies on R ranks (remat: the forward runs
    twice per layer).  The codec per rank: error feedback compresses each
    leaf (1 quantize, 1 decode); each bucket's quantized ring reduce-scatter
    quantizes and decodes both streams on each hop, its all-gather encodes
    once and decodes its own chunk and each hop's; each parameter's
    all-gather the same."""
    hops = n_pods - 1
    q = n_leaves + n_buckets * (2 * hops + 1) + n_leaves
    dq = n_leaves + n_buckets * (2 * hops + 1 + hops) + n_leaves * (1 + hops)
    return {"flash_attention_fwd": 2 * n_layers * n_micro * R,
            "flash_attention_bwd": n_layers * n_micro * R,
            "quant_int8": q * R, "dq_accum_int8": dq * R}


def phase_train(torch, np, get_config, build, mesh_mod, hetccl, counters):
    from repro_torch.configs.base import RunConfig
    from repro_torch.core import balance
    from repro_torch.core.tree import leaves as tree_leaves
    from repro_torch.data.pipeline import synthetic_batch
    from repro_torch.train import optim
    from repro_torch.train.trainer import make_train_program
    cfg = get_config(ARCH)
    model = build(cfg)
    m = mesh_mod.ThreadMesh({"pod": 2, "data": 2}, device="cuda")
    plan = balance.uniform_plan(2, 4, micro_batch=TRAIN_MICRO_BATCH)
    params = model.init(torch.Generator(device="cuda").manual_seed(SEED), dtype=torch.bfloat16)
    batch = synthetic_batch(SEED, 0, plan.n_micro_max, plan.micro_batch * m.size,
                            TRAIN_SEQ, cfg.vocab)
    n_tokens = int(np.prod(batch["tokens"].shape))
    print(f"  {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, bf16 params, f32 master "
          f"state; mesh {m.shape}, plan {plan.micro_per_pod} micro-steps of {plan.micro_batch} x "
          f"{TRAIN_SEQ} per rank, {n_tokens} tokens per step; remat on")
    progs = {name: make_train_program(model, m, RunConfig(collective_mode="hier",
                                                          learning_rate=TRAIN_LR, **kw), plan)
             for name, kw in TRAIN_RUNS.items()}
    leaves = tree_leaves(params)
    n_buckets = len(hetccl._make_buckets([p.float() for p in leaves],
                                         progs["int8_ef"].comm.bucket_bytes))
    want = train_counts(cfg.n_layers, plan.n_micro_max, m.size, len(leaves), n_buckets, 2)

    # warm-up step of each run (cuBLAS, allocator), then the checked runs
    for prog in progs.values():
        prog.step_fn(prog.init_fn(params), batch)
    torch.cuda.synchronize()
    runs, launches = {}, {}
    for name, prog in progs.items():
        state = prog.init_fn(params)
        if name == "int8_ef":
            check(all("ef" in s["opt"] for s in state), "int8 run: no error-feedback state")
            torch.cuda.reset_peak_memory_stats()
        counters.reset()
        losses = []
        for _ in range(TRAIN_STEPS):
            state, met = prog.step_fn(state, batch)
            losses.append(met["loss"].item())
        torch.cuda.synchronize()
        launches[name] = counters.read()
        if name == "int8_ef":
            peak_gib = torch.cuda.max_memory_allocated() / 2**30
        runs[name] = {"losses": losses, "grad_norm": met["grad_norm"].item(),
                      "tokens": int(met["tokens"].item())}
        print(f"  {name:8s} losses {['%.6f' % x for x in losses]}; launches {launches[name]}")
        del state
    for name, r in runs.items():
        check(all(np.isfinite(r["losses"])), f"{name}: non-finite loss")
        check(r["losses"][-1] < r["losses"][0], f"{name}: the loss did not fall: {r['losses']}")
        check(r["tokens"] == n_tokens, f"{name}: {r['tokens']} tokens counted, {n_tokens} fed")
    first = {name: r["losses"][0] for name, r in runs.items()}
    check(len(set(first.values())) == 1, f"step-0 losses differ: {first}")
    gap = abs(runs["int8_ef"]["losses"][-1] - runs["pallas"]["losses"][-1])
    print(f"  step-0 loss equal in all three runs: {first['xla']:.6f}; final loss int8 - none: "
          f"{gap:.4e} (limit {TRAIN_INT8_LOSS_TOL})  {'ok' if gap <= TRAIN_INT8_LOSS_TOL else 'FAIL'}")
    check(gap <= TRAIN_INT8_LOSS_TOL, "the int8 run strays beyond its limit")
    steps = TRAIN_STEPS
    for key, per_step in want.items():
        got = launches["int8_ef"][key]
        print(f"  int8_ef {key}: {got} launches in {steps} steps, {per_step} per step expected  "
              f"{'ok' if got == per_step * steps else 'FAIL'}")
        check(got == per_step * steps, f"{key}: {got} launches, {per_step * steps} expected")
    check(launches["pallas"]["ring_reduce_scatter"] == n_buckets * steps
          and launches["pallas"]["ring_all_gather"] == (n_buckets + len(leaves)) * steps,
          f"the run without a codec did not launch the fused rings per bucket and leaf: "
          f"{launches['pallas']}")
    check(launches["xla"]["ring_reduce_scatter"] == 0 and launches["int8_ef"]["quant_int8"] > 0,
          "a run took another route than its backend")

    # host-clock ms per step, runs in turns; the split of one int8 step
    states = {name: prog.init_fn(params) for name, prog in progs.items()}
    ms = {name: [] for name in progs}
    for _ in range(TRAIN_TIMING_REPS):
        for name, prog in progs.items():
            torch.cuda.synchronize()
            t = time.perf_counter()
            states[name], _ = prog.step_fn(states[name], batch)
            torch.cuda.synchronize()
            ms[name].append((time.perf_counter() - t) * 1e3)
    step_ms = {name: statistics.median(v) for name, v in ms.items()}
    split = step_split(torch, mesh_mod, optim, hetccl, progs["int8_ef"], states, batch)
    busy = device_busy_share(
        torch, lambda: progs["int8_ef"].step_fn(states["int8_ef"], batch), 1)
    print(f"  ms per step (host clock, median of {TRAIN_TIMING_REPS}, runs in turns): "
          f"{json.dumps({k: round(v, 1) for k, v in step_ms.items()})}; tokens/s "
          f"{json.dumps({k: round(n_tokens / v * 1e3, 1) for k, v in step_ms.items()})}")
    print(f"  int8 step split (rank 0, ms): {json.dumps(split)}; card busy share of an int8 "
          f"step {busy}; peak memory {peak_gib:.2f} GiB")
    return {"runs": runs, "launches": launches, "expected_per_step": want,
            "n_buckets": n_buckets, "step_ms": step_ms,
            "tokens_per_s": {k: n_tokens / v * 1e3 for k, v in step_ms.items()},
            "split_ms": split, "device_busy": busy, "peak_gib": peak_gib,
            "tokens_per_step": n_tokens}


def step_split(torch, mesh_mod, optim, hetccl, prog, states, batch):
    """One step with rank 0's phases timed on the host clock, each ended by a
    device synchronise (the ranks share the card, so the others' work counts
    in the phase it overlaps): forward+backward, ef_apply, tree_all_reduce,
    and the optimizer with the parameter all-gather."""
    split = {"forward_backward": 0.0, "ef_apply": 0.0, "tree_all_reduce": 0.0,
             "optimizer_and_param_all_gather": 0.0}
    orig = {"ef_apply": optim.ef_apply, "tree_all_reduce": hetccl.tree_all_reduce,
            "zero1_step": optim.zero1_step}

    def timed(key, fn):
        def run(*a, **kw):
            if mesh_mod.current()[1] != 0:
                return fn(*a, **kw)
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            split[key] += (time.perf_counter() - t) * 1e3
            return out
        return run

    optim.ef_apply = timed("ef_apply", orig["ef_apply"])
    hetccl.tree_all_reduce = timed("tree_all_reduce", orig["tree_all_reduce"])
    optim.zero1_step = timed("zero1", orig["zero1_step"])
    split["zero1"] = 0.0
    try:
        torch.cuda.synchronize()
        t = time.perf_counter()
        states["int8_ef"], _ = prog.step_fn(states["int8_ef"], batch)
        torch.cuda.synchronize()
        total = (time.perf_counter() - t) * 1e3
    finally:
        optim.ef_apply, hetccl.tree_all_reduce, optim.zero1_step = (
            orig["ef_apply"], orig["tree_all_reduce"], orig["zero1_step"])
    zero1 = split.pop("zero1")
    split["optimizer_and_param_all_gather"] = zero1 - split["ef_apply"] - split["tree_all_reduce"]
    split["forward_backward"] = total - zero1
    split["step"] = total
    return {k: round(v, 2) for k, v in split.items()}


def phase_train_kernel_times(torch, quant, ref, fa, hop_rows, bwd_case):
    import torch.nn.functional as F
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    x = quant_inputs(torch, gen, hop_rows, "randn")
    acc = torch.randn(hop_rows, 512, generator=gen, device="cuda")
    codes, scales = quant.wire_quantize_int8(x)
    n = x.numel()
    out = {
        "quant_int8": {
            "ms": median_ms(lambda: quant.wire_quantize_int8(x)),
            "plain_ms": median_ms(lambda: ref.wire_quantize(x)),
            "library_ms": None,
            "bound_ms": (n * 4 + n + hop_rows * 4) / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
            "shape": f"({hop_rows}, 512) f32 -> int8 codes + f32 scales"},
        "dq_accum_int8": {
            "ms": median_ms(lambda: quant.wire_dequant_accum_int8(acc, codes, scales)),
            "plain_ms": median_ms(lambda: ref.wire_dequant_accum(acc, codes, scales)),
            "library_ms": None,
            "bound_ms": (n * 4 + n + hop_rows * 4 + n * 4) / HBM_BYTES_PER_S * 1e3,
            "bound_by": "bytes", "shape": f"({hop_rows}, 512) f32 + int8 codes"}}
    q, k, v, o, do, lse = bwd_case["inputs"]
    kw = bwd_case["kw"]
    B, Hq, S, d = q.shape
    lse_plain = ref.attention_lse(q, k, **kw)
    elem = q.element_size()
    nbytes = (q.numel() * 3 + k.numel() * 2) * elem + lse.numel() * 4         + (q.numel() + 2 * k.numel()) * 4                     # dq, dk, dv written in f32
    flops = 5 * 2 * d * B * Hq * valid_pairs(S, S, kw["kind"], kw["window"], kw["k_len"])
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[str(q.dtype).removeprefix("torch.")] * 1e3
    qs, ks, vs = (t.detach().clone().requires_grad_() for t in (q, k, v))
    o_sdpa = F.scaled_dot_product_attention(qs, ks, vs, is_causal=kw["kind"] == "causal",
                                            enable_gqa=True)
    out["flash_attention_bwd"] = {
        "ms": median_ms(lambda: fa.flash_attention_bwd(q, k, v, o, do, lse, **kw)),
        "plain_ms": median_ms(lambda: fa.flash_attention_bwd_plain(q, k, v, o, do, lse_plain,
                                                                   **kw), reps=5),
        "library_ms": median_ms(lambda: torch.autograd.grad(o_sdpa, (qs, ks, vs), do,
                                                            retain_graph=True)),
        "bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "shape": f"q {tuple(q.shape)} k/v {tuple(k.shape)} {str(q.dtype).removeprefix('torch.')}"
                 f" {kw['kind']}"}
    for name, t in out.items():
        lib = f"{t['library_ms']:.4f} ms" if t["library_ms"] is not None else "none"
        print(f"  {name} at {t['shape']}: kernel {t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, "
              f"library {lib}, bound {t['bound_ms']:.4f} ms ({t['bound_by']})")
    return out


# ---------------------------------------------------------------------------
# MoE path: grouped matmul, full-width mixtral serving, sliding window
# ---------------------------------------------------------------------------

def gmm_inputs(torch, gen, G, M, K, N, dtype, layout):
    """x (G, M, K) unit normals, w (G, K, N) normals of std K**-0.5, laid out
    as ``layout`` says (see GMM_CASES)."""
    dt = getattr(torch, dtype)
    x = torch.randn(G, M, K, generator=gen, device="cuda").to(dt)
    if layout == "zero_rows":                        # drops: every 3rd row, the tail
        x[:, ::3] = 0
        x[:, M - M // 5:] = 0
    lead = {"layer_view": 24, "odd_view": 3}.get(layout, 0)
    width = N + lead + (8 if lead else 0)
    stacked = torch.randn(2 if lead else 1, G, K, width, generator=gen,
                          device="cuda").mul_(K ** -0.5).to(dt)
    w = stacked[-1, :, :, lead:lead + N]
    return x, w


def gmm_error(out, want):
    """Max abs, relative L2, and the worst row's L2 error over the larger of
    its own norm and the mean row norm, of (..., N)."""
    diff = out.float() - want.float()
    rows = want.float().norm(dim=-1)
    return {"max_abs_err": diff.abs().max().item(),
            "rel_l2": (diff.norm() / want.float().norm()).item(),
            "worst_row": (diff.norm(dim=-1) / rows.clamp(min=rows.mean())).max().item()}


def gmm_ok(err, dtype_name, limits=GMM_LIMITS):
    rel_lim, row_lim = limits[dtype_name]
    return err["rel_l2"] <= rel_lim and err["worst_row"] <= row_lim


def format_gmm(err, dtype_name, limits=GMM_LIMITS):
    rel_lim, row_lim = limits[dtype_name]
    return (f"max_abs_err {err['max_abs_err']:.3e}  rel_l2 {err['rel_l2']:.3e} "
            f"(limit {rel_lim:.0e})  worst_row {err['worst_row']:.3e} (limit {row_lim:.0e})")


def phase_gmm_kernels(torch, gmm, ref):
    """The kernel against its plain version, case by case."""
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    results, failed = {}, []
    for name, G, M, K, N, dt, layout in GMM_CASES:
        x, w = gmm_inputs(torch, gen, G, M, K, N, dt, layout)
        out = gmm.grouped_matmul(x, w)
        want = ref.grouped_matmul(x, w)
        torch.cuda.synchronize()
        check(out.shape == want.shape and out.dtype == want.dtype,
              f"{name}: output {tuple(out.shape)} {out.dtype}")
        check(bool(torch.isfinite(out).all()), f"{name}: non-finite output")
        err = gmm_error(out, want)
        zero_rows_ok = True
        if layout == "zero_rows":                   # a dropped token's row stays 0
            zero_rows_ok = bool((out[x.abs().amax(-1) == 0] == 0).all())
        ok = gmm_ok(err, dt) and zero_rows_ok
        print(f"  {name:22s} ({G},{M},{K})@({G},{K},{N}) {dt:8s} {layout:10s} "
              f"{format_gmm(err, dt)}{'' if zero_rows_ok else ' ZERO ROWS NOT ZERO'}  "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            failed.append(name)
        results[name] = err
        del x, w, out, want
    check(not failed, f"grouped_matmul disagrees with its plain version in {failed}")
    return results


@contextlib.contextmanager
def patched(obj, name, value):
    """``obj.name`` set to ``value`` inside the block, restored after."""
    old = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, old)


@contextlib.contextmanager
def patched_variant(tacc, op, variant, fn):
    """The TACC registration (op, variant) replaced by ``fn`` inside the block."""
    old = tacc.resolve(op, variant)
    tacc.register(op, variant)(fn)
    try:
        yield
    finally:
        tacc.register(op, variant)(old)


@contextlib.contextmanager
def route_log(torch, moe_mod, log):
    """Appends (expert ids (T, k), kept (T, k), output (T, D)) of every
    moe_ffn call."""
    orig_dispatch, orig_ffn = moe_mod.dispatch_slots, moe_mod.moe_ffn

    def rec(expert_idx, n_experts, capacity):
        order, tok_of, slot, keep = orig_dispatch(expert_idx, n_experts, capacity)
        kept = torch.empty_like(keep)
        kept[order] = keep
        log.append([expert_idx.clone(), kept.reshape(expert_idx.shape)])
        return order, tok_of, slot, keep

    def rec_ffn(*args, **kw):
        out, aux = orig_ffn(*args, **kw)
        log[-1].append(out)
        return out, aux

    with patched(moe_mod, "dispatch_slots", rec), patched(moe_mod, "moe_ffn", rec_ffn):
        yield


def moe_model(torch, get_config, build):
    """Full-width mixtral-8x7b cut to MOE_LAYERS layers, bf16, weights from SEED."""
    cfg = dataclasses.replace(get_config(MOE_ARCH), n_layers=MOE_LAYERS)
    model = build(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(SEED))
    torch.cuda.synchronize()
    return cfg, model, params


def phase_moe_layers(torch, tacc, gmm, ref, model, params, batch):
    """In one prefill, each grouped matmul against its plain version on the
    same inputs, and each layer's expert_ffn against the same composition
    through the plain version: the hard gate, which routing cannot blur."""
    gmm_errs, ffn_errs = [], []
    kernel_gmm = gmm.grouped_matmul
    kernel_ffn = tacc.resolve("expert_ffn", "cuda")

    def rec_gmm(x, w):
        out = kernel_gmm(x, w)
        gmm_errs.append(gmm_error(out, ref.grouped_matmul(x, w)))
        return out

    def rec_ffn(buf, w1, w3, w2):
        out = kernel_ffn(buf, w1, w3, w2)
        with patched(gmm, "grouped_matmul", ref.grouped_matmul):
            want = kernel_ffn(buf, w1, w3, w2)
        ffn_errs.append(gmm_error(out, want))
        return out

    with patched(gmm, "grouped_matmul", rec_gmm), \
            patched_variant(tacc, "expert_ffn", "cuda", rec_ffn), torch.inference_mode():
        model.prefill(params, batch)
    L = model.cfg.n_layers
    worst_gmm = {key: max(e[key] for e in gmm_errs) for key in gmm_errs[0]}
    worst_ffn = {key: max(e[key] for e in ffn_errs) for key in ffn_errs[0]}
    ok_gmm = len(gmm_errs) == 3 * L and all(gmm_ok(e, "bfloat16") for e in gmm_errs)
    ok_ffn = len(ffn_errs) == L and all(gmm_ok(e, "bfloat16", FFN_LIMITS) for e in ffn_errs)
    print(f"  per layer ({len(gmm_errs)} grouped matmuls), worst: "
          f"{format_gmm(worst_gmm, 'bfloat16')}  {'ok' if ok_gmm else 'FAIL'}")
    print(f"  per layer ({len(ffn_errs)} expert_ffn against the plain composition), worst: "
          f"{format_gmm(worst_ffn, 'bfloat16', FFN_LIMITS)}  {'ok' if ok_ffn else 'FAIL'}")
    check(ok_gmm and ok_ffn, "grouped_matmul or expert_ffn disagrees with its plain "
                             "version on a layer's inputs")
    return {"gmm": worst_gmm, "expert_ffn": worst_ffn}


@contextlib.contextmanager
def replayed_routes(torch, moe_mod, log):
    """moe.route returning, call by call, the expert ids recorded in ``log``,
    with the gates taken from this call's own probabilities at those ids."""
    orig = moe_mod.route
    calls = iter(log)

    def replay(x, router, top_k):
        logits, probs, _, _ = orig(x, router, top_k)
        idx = next(calls)[0]
        gates = probs.gather(1, idx)
        return logits, probs, gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9), idx

    with patched(moe_mod, "route", replay):
        yield


def compare_to_plain(torch, tacc, gmm, ref, moe_mod, model, params, batch):
    """Last-position logits and routes of a prefill through the kernel against
    prefills with expert_ffn pinned to the plain composition.  Free-running,
    the plain run's routes and drops may differ (routing is discontinuous):
    counted and reported, and the requests whose routes and drops agree in
    every layer gated on MOE_LOGITS_REL_TOL.  Replaying the kernel run's
    expert ids (gates from the plain run's own probabilities), every route
    and drop agrees by construction and every request is gated."""
    kernel_ffn = tacc.resolve("expert_ffn", "cuda")

    def plain_ffn(buf, w1, w3, w2):
        with patched(gmm, "grouped_matmul", ref.grouped_matmul):
            return kernel_ffn(buf, w1, w3, w2)

    def run(plain, replay=None):
        log = []
        with contextlib.ExitStack() as stack:
            if plain:
                stack.enter_context(patched_variant(tacc, "expert_ffn", "cuda", plain_ffn))
            if replay is not None:
                stack.enter_context(replayed_routes(torch, moe_mod, replay))
            stack.enter_context(route_log(torch, moe_mod, log))
            stack.enter_context(torch.inference_mode())
            logits = model.prefill(params, batch)[0][:, -1].float()
        check(bool(torch.isfinite(logits).all()), "non-finite prefill logits")
        return logits, log

    B, S = batch["tokens"].shape

    def differences(ra, rb):
        """(route differences, drop differences where the route agrees) per
        request, summed over layers, and per layer."""
        routes = torch.zeros(B, dtype=torch.long, device=batch["tokens"].device)
        drops = torch.zeros_like(routes)
        per_layer = []
        for (ia, ka, _), (ib, kb, _) in zip(ra, rb):
            r = (ia != ib).sum(-1).reshape(B, S).sum(-1)
            d = ((ia == ib) & (ka != kb)).sum(-1).reshape(B, S).sum(-1)
            routes += r
            drops += d
            per_layer.append((int(r.sum()), int(d.sum())))
        return routes, drops, per_layer

    def rel(a, b):
        return (a - b).norm(dim=-1) / b.norm(dim=-1)

    lk, rk = run(False)
    lp, rp = run(True)
    lr, rr = run(True, replay=rk)
    routes, drops, per_layer = differences(rk, rp)
    agree = (routes + drops) == 0
    free = rel(lk, lp)
    n_agree = int(agree.sum())
    worst_free = free[agree].max().item() if n_agree else None
    r2, d2, _ = differences(rk, rr)
    check(int(r2.sum()) == 0 and int(d2.sum()) == 0, "replayed routes differ")
    replayed = rel(lk, lr)
    drift = [(((a[2].float() - b[2].float()).norm() / b[2].float().norm()).item())
             for a, b in zip(rk, rr)]
    limit = MOE_LOGITS_REL_TOL[model.cfg.dtype]
    out = {"assignments": len(rk) * B * S * rk[0][0].shape[1],
           "routes_differing": int(routes.sum()), "drops_differing": int(drops.sum()),
           "per_layer_routes_drops_differing": per_layer, "rows_agreeing": n_agree, "rows": B,
           "rel_l2_free_rows_agreeing_max": worst_free, "rel_l2_free": free.tolist(),
           "rel_l2_replayed": replayed.tolist(), "rel_l2_replayed_max": replayed.max().item(),
           "moe_output_rel_l2_by_layer_replayed": drift,
           "same_argmax_free": (lk.argmax(-1) == lp.argmax(-1)).float().mean().item(),
           "same_argmax_replayed": (lk.argmax(-1) == lr.argmax(-1)).float().mean().item()}
    print(f"  kernel vs plain expert_ffn, free-running: of {out['assignments']} (token, expert) "
          f"assignments {out['routes_differing']} routes and {out['drops_differing']} drops "
          f"differ (per layer {per_layer}); {n_agree} of {B} requests agree in every layer "
          f"(logits rel L2 there: max {'-' if worst_free is None else f'{worst_free:.3e}'}); "
          f"all requests {['%.3e' % v for v in out['rel_l2_free']]}")
    print(f"  kernel vs plain expert_ffn, kernel routes replayed: last-position logits rel L2 "
          f"{['%.3e' % v for v in out['rel_l2_replayed']]} (limit {limit}); same argmax "
          f"{out['same_argmax_replayed']:.3f}; MoE output rel L2 by layer "
          f"{['%.2e' % v for v in drift]}")
    check(worst_free is None or worst_free <= limit,
          f"logits of requests whose routes agree differ by {worst_free}")
    check(out["rel_l2_replayed_max"] <= limit,
          f"logits with replayed routes differ by {out['rel_l2_replayed_max']:.3e}")
    return out


def phase_moe_serve(torch, np, fa, gmm, ref, tacc, moe_mod, attn_mod, engine, build, counters,
                    cfg, model, params, n_requests, prompt_len, max_new, window_run):
    """``n_requests`` x ``prompt_len`` prompt tokens x ``max_new`` new ones,
    greedy, through ``Batcher``; launch counts from the counters set to 0 just
    before and read just after.  ``window_run``: the prompt is past the window,
    so the cache must be the rolling one and decode go through
    ``window_decode_attention``."""
    dev = torch.device("cuda")
    max_len = prompt_len + max_new
    progs = engine.make_serve_programs(model, seq_len=prompt_len, max_len=max_len,
                                       device=dev)
    rng = np.random.RandomState(SEED + prompt_len)
    prompts = [rng.randint(0, cfg.vocab, prompt_len).astype(np.int32)
               for _ in range(n_requests)]
    finite = [torch.ones((), dtype=torch.bool, device=dev)]

    def watched(fn):
        def run(*args):
            logits, cache = fn(*args)
            finite[0] = finite[0] & torch.isfinite(logits).all()
            return logits, cache
        return run

    watched_progs = dataclasses.replace(progs, prefill_fn=watched(progs.prefill_fn),
                                        decode_fn=watched(progs.decode_fn))

    def serve(new):
        reqs = [engine.Request(i, p, new) for i, p in enumerate(prompts)]
        return engine.Batcher(watched_progs, params, batch_slots=n_requests,
                              prompt_len=prompt_len, max_len=max_len).run(reqs)

    serve(2)                                          # warm-up
    torch.cuda.synchronize()
    window_calls = [0]
    orig_wda = attn_mod.window_decode_attention

    def counted_wda(*a, **kw):
        window_calls[0] += 1
        return orig_wda(*a, **kw)

    torch.cuda.reset_peak_memory_stats()
    with patched(attn_mod, "window_decode_attention", counted_wda):
        counters.reset()
        t0 = time.perf_counter()
        done = serve(max_new)
        torch.cuda.synchronize()
        serve_s = time.perf_counter() - t0
        launches = counters.read()
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    L = cfg.n_layers
    want_gmm = 3 * L * (max_new + 1)
    n_tok = sum(len(r.out) for r in done)
    print(f"  served {len(done)} requests x {prompt_len} prompt tokens, {n_tok} new tokens "
          f"in {serve_s:.3f} s; grouped_matmul launches {launches['grouped_matmul']} "
          f"(3 x {L} layers x {max_new + 1} forwards = {want_gmm}), flash "
          f"{launches['flash_attention_fwd']} ({L} per prefill), window_decode_attention "
          f"calls {window_calls[0]}")
    check(launches["grouped_matmul"] == want_gmm,
          f"grouped_matmul launched {launches['grouped_matmul']} times, {want_gmm} expected")
    check(launches["flash_attention_fwd"] == L, "flash kernel not launched once per layer")
    check(len(done) == n_requests and all(len(r.out) == max_new for r in done),
          "not every request got its tokens")
    check(all(0 <= t < cfg.vocab for r in done for t in r.out), "a token is outside the vocab")
    check(bool(finite[0]), "non-finite logits in the serve run")
    check(window_calls[0] == (L * max_new if window_run else 0),
          f"window_decode_attention ran {window_calls[0]} times")

    toks = torch.as_tensor(np.stack(prompts).astype(np.int64), device=dev)
    batch = {"tokens": toks}
    out = {"arch": cfg.name, "n_layers": L, "requests": len(done), "prompt_len": prompt_len,
           "new_tokens_per_request": max_new, "serve_s": serve_s,
           "tokens_per_s": n_tok / serve_s, "launches": launches,
           "window_decode_calls": window_calls[0], "peak_gib": peak_gib}
    _, cache = progs.prefill_fn(params, batch)
    W = cfg.window
    rolling = cache["k"].shape[2] == W
    print(f"  cache after prefill: k {tuple(cache['k'].shape)}, pos {cache['pos']}; rolling "
          f"window cache: {rolling}")
    check(rolling == window_run and cache["pos"] == prompt_len,
          "the cache is not the one the prompt length calls for")
    del cache
    if not window_run:
        out["layer_worst_error"] = phase_moe_layers(torch, tacc, gmm, ref, model, params, batch)
    out["vs_plain"] = compare_to_plain(torch, tacc, gmm, ref, moe_mod, model, params, batch)
    if not window_run:                 # the same comparison in f32, first layers only
        cfg32 = dataclasses.replace(cfg, n_layers=MOE_F32_LAYERS, dtype="float32")
        p32 = _tree_map(lambda t: t.float(), {
            **{k: v for k, v in params.items() if k != "blocks"},
            "blocks": _tree_map(lambda t: t[:MOE_F32_LAYERS], params["blocks"])})
        print(f"  f32, first {MOE_F32_LAYERS} layers:")
        out["vs_plain_f32"] = compare_to_plain(torch, tacc, gmm, ref, moe_mod, build(cfg32),
                                               p32, batch)
        del p32

    def timed(fn, reps):
        ms = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t) * 1e3)
        return statistics.median(ms)

    out["prefill_ms"] = timed(lambda: progs.prefill_fn(params, batch), 3)
    _, cache = progs.prefill_fn(params, batch)
    cur = toks[:, -1:]

    def step():
        nonlocal cache
        _, cache = progs.decode_fn(params, cache, cur)

    out["decode_ms_per_step"] = timed(step, max_new - 2)
    out["device_busy_prefill"] = device_busy_share(
        torch, lambda: progs.prefill_fn(params, batch), 1)
    _, cache = progs.prefill_fn(params, batch)
    out["device_busy_decode"] = device_busy_share(torch, step, max_new // 2)
    del cache
    print(f"  prefill {out['prefill_ms']:.2f} ms (batch {n_requests} x {prompt_len}), decode "
          f"{out['decode_ms_per_step']:.2f} ms per step, {out['tokens_per_s']:.1f} tokens/s end "
          f"to end; card busy share prefill {out['device_busy_prefill']}, decode "
          f"{out['device_busy_decode']}; peak memory {peak_gib:.2f} GiB")
    return out


GMM_TIMED = {"prefill_w13": (8, 1280, 4096, 14336), "prefill_w2": (8, 1280, 14336, 4096),
             "decode_w13": (8, 2, 4096, 14336), "decode_w2": (8, 2, 14336, 4096)}


def phase_moe_kernel_times(torch, gmm, ref):
    """The kernel at Mixtral's prefill (C 1280) and decode (C 2) shapes, its
    plain version, torch.bmm (the yardstick; the port never calls it) and the
    bound: the larger of FLOPs over the bf16 peak and bytes (x, w read once,
    out written once) over the memory rate."""
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    out = {}
    for name, (G, M, K, N) in GMM_TIMED.items():
        x, w = gmm_inputs(torch, gen, G, M, K, N, "bfloat16", "dense")
        t_ops = 2 * G * M * K * N / PEAK_FLOPS["bfloat16"] * 1e3
        t_bytes = (x.numel() + w.numel() + G * M * N) * 2 / HBM_BYTES_PER_S * 1e3
        kernel = lambda: gmm.grouped_matmul(x, w)          # noqa: E731
        library = lambda: torch.bmm(x, w)                  # noqa: E731
        ms = [median_ms(kernel, reps=10), median_ms(library, reps=10)]
        ms += [median_ms(library, reps=10), median_ms(kernel, reps=10)]   # in turns
        out[name] = {"ms": statistics.median([ms[0], ms[3]]),
                     "library_ms": statistics.median([ms[1], ms[2]]),
                     "plain_ms": median_ms(lambda: ref.grouped_matmul(x, w), reps=2,
                                           trials=3, warmup=1),
                     "bound_ms": max(t_ops, t_bytes),
                     "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                     "shape": f"({G},{M},{K})@({G},{K},{N}) bf16"}
        t = out[name]
        print(f"  grouped_matmul {name} at {t['shape']}: kernel {t['ms']:.4f} ms, plain "
              f"{t['plain_ms']:.4f} ms, torch.bmm {t['library_ms']:.4f} ms, bound "
              f"{t['bound_ms']:.4f} ms ({t['bound_by']}); kernel / bound "
              f"{t['ms'] / t['bound_ms']:.2f}")
        del x, w
    return out


class Counters:
    """The launch counts of every kernel wrapper of the port."""

    def __init__(self, fa, quant, ring_dma, cr, gmm):
        self.mods = (fa, quant, ring_dma, cr, gmm)

    def reset(self):
        fa, quant, ring_dma, cr, gmm = self.mods
        fa.launches = fa.bwd_launches = quant.quant_launches = quant.dq_launches = 0
        ring_dma.rs_launches = ring_dma.ag_launches = cr.launches = gmm.launches = 0

    def read(self):
        fa, quant, ring_dma, cr, gmm = self.mods
        return {"flash_attention_fwd": fa.launches, "flash_attention_bwd": fa.bwd_launches,
                "quant_int8": quant.quant_launches, "dq_accum_int8": quant.dq_launches,
                "ring_reduce_scatter": ring_dma.rs_launches,
                "ring_all_gather": ring_dma.ag_launches, "collective_reduce": cr.launches,
                "grouped_matmul": gmm.launches}


@contextlib.contextmanager
def phase(label, walls):
    """Prints ``label``, runs the block, prints and records its wall time."""
    print(label)
    t = time.perf_counter()
    try:
        yield
    finally:
        walls[label] = time.perf_counter() - t
        print(f"  ({label.split()[0]} wall time {walls[label]:.1f} s)")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "needs an NVIDIA card", file=sys.stderr)
        return 1
    root = Path(__file__).resolve().parent
    sys.path.insert(0, str(root / "src"))
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.core import hetccl, tacc
    from repro_torch.core import mesh as mesh_mod
    from repro_torch.kernels import _build
    from repro_torch.kernels import collective_reduce as cr
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import grouped_matmul as gmm
    from repro_torch.kernels import ops, quant, ref, ring_dma
    from repro_torch.models import attention as attn_mod
    from repro_torch.models import build
    from repro_torch.models import moe as moe_mod
    from repro_torch.serve import engine

    walls = {}
    with phase("[1] device", walls):
        name = torch.cuda.get_device_name(0)
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60).stdout.strip()
        print(f"  torch: {name}; torch {torch.__version__}, cuda {torch.version.cuda}")
        print(smi.splitlines()[0])              # nvidia-smi's name, power.limit
    card = {"device": name, "nvidia_smi": smi.splitlines()[0]}

    with phase("[2] build", walls):
        logs = _build.build()
        print(f"  built {', '.join(logs)}")
        for src, log in logs.items():
            for line in log.splitlines():
                if "registers" in line or "spill" in line or "smem" in line:
                    print(f"  {src}: {line.strip()}")

    with phase("[3] kernel vs plain", walls):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        print(f"  torch.backends.cuda.matmul.allow_tf32 = "
              f"{torch.backends.cuda.matmul.allow_tf32}, "
              f"torch.backends.cudnn.allow_tf32 = {torch.backends.cudnn.allow_tf32}")
        cases = phase_kernels(fa, torch)

    with phase("[4] serve", walls):
        serve, launches, measure_busy = phase_serve(torch, np, fa, ops, tacc, get_config,
                                                    build, engine)

    with phase("[5] times", walls):
        main_case = cases["serve_prefill"]
        kernel_ms, plain_ms, library_ms, bound_ms, bound_by = phase_times(fa, torch, main_case)
        serve.update(measure_busy())
        print(json.dumps({"serve": serve, **card}))

    with phase("[6] ring kernels vs plain", walls):
        n_ring_cases, ring_err = phase_ring_kernels(torch, ring_dma, cr)

    with phase("[7] collectives at full width", walls):
        coll = phase_collectives(torch, hetccl, tacc, mesh_mod, ring_dma, cr, get_config,
                                 build)

    with phase("[8] collective kernel times", walls):
        ctimes = phase_collective_times(torch, ring_dma, cr, coll["largest_bucket_elems"])
        print(json.dumps({"collectives": coll, "kernel_times": ctimes, **card}))

    # the quantized ring's hop in the (pod=2, data=2) hier reduce-scatter of
    # the largest bucket: local shard big/2, pod chunk big/4, a stream big/8
    hop_rows = -(-coll["largest_bucket_elems"] // 8 // 512)

    with phase("[9] codec kernels vs plain", walls):
        n_quant_cases = phase_quant_kernels(torch, quant, ref, hop_rows)

    with phase("[10] flash backward vs plain", walls):
        bwd = phase_flash_bwd(torch, fa, ref)

    counters = Counters(fa, quant, ring_dma, cr, gmm)
    with phase("[11] training at full width", walls):
        train = phase_train(torch, np, get_config, build, mesh_mod, hetccl, counters)

    with phase("[12] training kernel times", walls):
        ttimes = phase_train_kernel_times(torch, quant, ref, fa, hop_rows, bwd["train"])
        print(json.dumps({"train": train, "flash_bwd_errors": {
            k: {kk: vv for kk, vv in v.items() if kk not in ("inputs", "kw")}
            for k, v in bwd.items()}, "kernel_times": ttimes, **card}))
    for v in bwd.values():                       # the training phases' tensors
        v.pop("inputs")
    gc.collect()
    torch.cuda.empty_cache()

    with phase("[13] grouped matmul vs plain", walls):
        gmm_cases = phase_gmm_kernels(torch, gmm, ref)

    moe = {}
    with phase(f"[14] MoE serve: {MOE_ARCH} at full width, {MOE_LAYERS} layers", walls):
        moe_cfg, moe_model_, moe_params = moe_model(torch, get_config, build)
        print(f"  {moe_cfg.name}: {moe_cfg.n_layers} of 32 layers, d_model {moe_cfg.d_model}, "
              f"{moe_cfg.n_heads}/{moe_cfg.n_kv_heads} heads x {moe_cfg.head_dim_}, "
              f"{moe_cfg.n_experts} experts top-{moe_cfg.top_k} of d_ff {moe_cfg.d_ff_expert}, "
              f"window {moe_cfg.window}, vocab {moe_cfg.vocab}, {moe_cfg.dtype}, "
              f"{moe_model_.n_params() / 1e9:.2f}B params")
        moe["serve"] = phase_moe_serve(
            torch, np, fa, gmm, ref, tacc, moe_mod, attn_mod, engine, build, counters, moe_cfg,
            moe_model_, moe_params, MOE_REQUESTS, MOE_PROMPT, MOE_NEW, window_run=False)

    with phase(f"[15] sliding window at full width: 1 x {WINDOW_PROMPT} + {WINDOW_NEW}", walls):
        moe["window"] = phase_moe_serve(
            torch, np, fa, gmm, ref, tacc, moe_mod, attn_mod, engine, build, counters, moe_cfg,
            moe_model_, moe_params, 1, WINDOW_PROMPT, WINDOW_NEW, window_run=True)
    del moe_params, moe_model_
    gc.collect()
    torch.cuda.empty_cache()

    with phase("[16] MoE kernel times", walls):
        gtimes = phase_moe_kernel_times(torch, gmm, ref)
        print(json.dumps({"moe": moe, "gmm_errors": gmm_cases, "kernel_times": gtimes,
                          "phase_wall_s": walls, **card}))

    print("[17] kernels")
    sources = {"collective_reduce": ("collective_reduce.cu",
                                     "src/repro/kernels/collective_reduce.py:84"),
               "ring_reduce_scatter": ("ring_dma.cu", "src/repro/kernels/ring_dma.py:252"),
               "ring_all_gather": ("ring_dma.cu", "src/repro/kernels/ring_dma.py:383")}
    kernels = [{
        "name": "flash_attention_fwd",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:31",
        "launches": launches,
        "max_abs_err": main_case["max_abs_err"],
        "rel_l2": main_case["rel_l2"],
        "worst_row_rel_l2": main_case["worst_row_rel_l2"],
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": library_ms,
        "check": "pass",
        "cases_checked": len(cases),
    }]
    for kname, (src, replaces) in sources.items():
        t = ctimes[kname]
        kernels.append({
            "name": kname, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{src}", "replaces": replaces,
            "launches": coll["launches"][kname], "max_abs_err": ring_err[kname],
            "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
            "check": "pass (bitwise)", "cases_checked": n_ring_cases, "shape": t["shape"]})
    train_launches = train["launches"]["int8_ef"]
    kernels[0]["train_launches"] = train_launches["flash_attention_fwd"]
    kernels[0]["mixtral_launches"] = moe["serve"]["launches"]["flash_attention_fwd"]
    tb = ttimes["flash_attention_bwd"]
    kernels.append({
        "name": "flash_attention_bwd", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
        "replaces": "src/repro/kernels/flash_attention.py:31",
        "note": "backward of the forward kernel; the TPU kernel is forward-only and the "
                "reference differentiates its plain attention",
        "launches": train_launches["flash_attention_bwd"],
        "max_abs_err": bwd["train"]["max_abs_err"], "rel_l2": bwd["train"]["rel_l2"],
        "worst_row": bwd["train"]["worst_row"], "ms": tb["ms"], "plain_ms": tb["plain_ms"],
        "bound_ms": tb["bound_ms"], "bound_by": tb["bound_by"], "library_ms": tb["library_ms"],
        "check": "pass", "cases_checked": len(bwd), "shape": tb["shape"]})
    for kname, replaces in (("quant_int8", "src/repro/kernels/quant.py:152"),
                            ("dq_accum_int8", "src/repro/kernels/quant.py:161")):
        t = ttimes[kname]
        kernels.append({
            "name": kname, "route": "cuda", "source": "src/repro_torch/kernels/csrc/quant.cu",
            "replaces": replaces, "launches": train_launches[kname], "max_abs_err": 0.0,
            "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"], "check": "pass (bitwise)",
            "cases_checked": n_quant_cases, "shape": t["shape"]})
    tp, td = gtimes["prefill_w13"], gtimes["decode_w13"]
    err = gmm_cases["mixtral_prefill_w13"]
    kernels.append({
        "name": "grouped_matmul", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/grouped_matmul.cu",
        "replaces": "src/repro/kernels/grouped_matmul.py:25",
        "launches": moe["serve"]["launches"]["grouped_matmul"],
        "max_abs_err": err["max_abs_err"], "rel_l2": err["rel_l2"],
        "worst_row": err["worst_row"], "ms": tp["ms"], "plain_ms": tp["plain_ms"],
        "bound_ms": tp["bound_ms"], "bound_by": tp["bound_by"], "library_ms": tp["library_ms"],
        "shape": tp["shape"], "decode_ms": td["ms"], "decode_plain_ms": td["plain_ms"],
        "decode_bound_ms": td["bound_ms"], "decode_bound_by": td["bound_by"],
        "decode_library_ms": td["library_ms"], "decode_shape": td["shape"],
        "window_launches": moe["window"]["launches"]["grouped_matmul"],
        "check": "pass", "cases_checked": len(gmm_cases)})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
