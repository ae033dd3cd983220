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
9. a JSON line listing every ported kernel;
10. the last line, ``{"ok": true, "device": {...}}``.

It needs the repository around it: run alone, or where
``torch.cuda.is_available()`` is false, it exits non-zero and prints no result.
"""
import dataclasses
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
    from repro_torch.kernels import ops, ring_dma
    from repro_torch.models import build
    from repro_torch.serve import engine

    print("[1] device")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(f"  torch: {name}; torch {torch.__version__}, cuda {torch.version.cuda}")
    print(smi.splitlines()[0])              # nvidia-smi's name, power.limit

    print("[2] build")
    t0 = time.perf_counter()
    logs = _build.build()
    build_s = time.perf_counter() - t0
    print(f"  built {', '.join(logs)} in {build_s:.1f} s")
    for src, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                print(f"  {src}: {line.strip()}")

    print("[3] kernel vs plain")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"  torch.backends.cuda.matmul.allow_tf32 = "
          f"{torch.backends.cuda.matmul.allow_tf32}, "
          f"torch.backends.cudnn.allow_tf32 = {torch.backends.cudnn.allow_tf32}")
    cases = phase_kernels(fa, torch)

    print("[4] serve")
    serve, launches, measure_busy = phase_serve(torch, np, fa, ops, tacc, get_config, build,
                                  engine)

    print("[5] times")
    main_case = cases["serve_prefill"]
    kernel_ms, plain_ms, library_ms, bound_ms, bound_by = phase_times(fa, torch, main_case)
    serve.update(measure_busy())
    print(json.dumps({"serve": serve, "device": name, "nvidia_smi": smi.splitlines()[0]}))

    print("[6] ring kernels vs plain")
    n_ring_cases, ring_err = phase_ring_kernels(torch, ring_dma, cr)

    print("[7] collectives at full width")
    coll = phase_collectives(torch, hetccl, tacc, mesh_mod, ring_dma, cr, get_config, build)

    print("[8] collective kernel times")
    ctimes = phase_collective_times(torch, ring_dma, cr, coll["largest_bucket_elems"])
    print(json.dumps({"collectives": coll, "kernel_times": ctimes, "device": name,
                      "nvidia_smi": smi.splitlines()[0]}))

    print("[9] kernels")
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
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
