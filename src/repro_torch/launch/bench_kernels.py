"""Time the grouped matmul's decode route and the flash-attention backward
at their main-path shapes against their one-call PyTorch yardsticks, in
turns, and optionally against the same kernel built from another source.

    python -m repro_torch.launch.bench_kernels [--rounds 6] \\
        [--other-gmm path/to/grouped_matmul.cu ...] [--other-bwd path/to/flash_attention_bwd.cu ...]

Shapes: Mixtral-8x7B's decode gmm, x (8, 2, 4096) @ w (8, 4096, 14336) and
x (8, 2, 14336) @ w (8, 14336, 4096) (``torch.bmm`` beside it); the flash
backward at smollm-135m's training shape, q (2, 9, 512, 64), k and v
(2, 3, 512, 64), bf16, causal (SDPA's backward beside it, through autograd).
Every contender is timed two ways: ``stream``, the mean CUDA-event time of
``--iters`` calls made back to back; ``graph``, the same calls captured in a
CUDA graph and replayed, so the host's time to launch a call is not in it.
Each round times every contender once, in the order A B C, then C B A, ...
Prints the card's name and power limit, every reading and each median, and
the largest difference between each other source's output and the
checkout's.  Needs the card and nvcc; the port never calls the yardsticks.
"""
from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import statistics
import subprocess
import sys
import time

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import grouped_matmul as gmm

GMM_SHAPES = {"decode_w13": (8, 2, 4096, 14336), "decode_w2": (8, 2, 14336, 4096)}
BWD_SHAPE = (2, 9, 3, 512, 64)          # B, Hq, Hkv, S, d: bf16, causal


def build_others(name: str, paths) -> dict:
    """{label: library} of other ``csrc/<name>.cu`` sources, built as the
    checkout's is, one nvcc per source, all started together; each labelled
    by its file name without the extension."""
    out_dir = _build.BUILD_DIR / "other"
    out_dir.mkdir(parents=True, exist_ok=True)
    running, libs = {}, {}
    for path in paths:
        src = open(path, "rb").read()
        tag = hashlib.sha256(src + " ".join(_build.NVCC_FLAGS).encode()).hexdigest()[:16]
        so = out_dir / f"lib{name}-{tag}.so"
        label = path.rsplit("/", 1)[-1].removesuffix(".cu")
        if not so.exists():
            running[label] = (subprocess.Popen(
                [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so), path],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), path)
        libs[label] = so
    for label, (proc, path) in running.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {path}:\n{log}")
    return {label: ctypes.CDLL(str(so)) for label, so in libs.items()}


def stream_ms(fn, iters):
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def captured(fn, iters):
    """``iters`` calls of fn captured in a CUDA graph on the current stream,
    which must not be the default one (so autograd's backward, which runs on
    its forward's stream, is captured where it runs)."""
    for _ in range(3):
        fn()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=torch.cuda.current_stream()):
        for _ in range(iters):
            fn()
    return graph


def in_turns(contenders, rounds, iters):
    """{name: {"stream": [ms...], "graph": [ms...]}} over ``rounds`` rounds,
    the contenders' order reversed every other round; run on a side stream
    (the caller's current stream)."""
    graphs = {name: captured(fn, iters) for name, fn in contenders.items()}
    names = list(contenders)
    out = {n: {"stream": [], "graph": []} for n in names}
    for _ in range(2):                                      # warm-up
        for n in names:
            stream_ms(contenders[n], iters)
            stream_ms(graphs[n].replay, 1)
    for r in range(rounds):
        for n in (names if r % 2 == 0 else names[::-1]):
            out[n]["stream"].append(stream_ms(contenders[n], iters))
            out[n]["graph"].append(stream_ms(graphs[n].replay, 1) / iters)
    return out


def host_us(fn, calls=100):
    """The caller's time per call, without waiting for the card: where it is
    above the card's time per call, back-to-back calls are host-bound."""
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t) / calls * 1e6
    torch.cuda.synchronize()
    return us


def report(label, readings):
    for name, kinds in readings.items():
        for kind, ms in kinds.items():
            print(f"  {label} {name:12s} {kind:6s} median {statistics.median(ms):.4f} ms "
                  f"(min {min(ms):.4f}, max {max(ms):.4f}; "
                  f"{', '.join(f'{v:.4f}' for v in ms)})")
    return {name: {kind: statistics.median(ms) for kind, ms in kinds.items()}
            for name, kinds in readings.items()}


def bench_gmm(gen, others, rounds, iters):
    out = {}
    for label, (G, M, K, N) in GMM_SHAPES.items():
        x = torch.randn(G, M, K, generator=gen, device="cuda").bfloat16()
        w = (torch.randn(G, K, N, generator=gen, device="cuda") * K ** -0.5).bfloat16()
        mine = gmm.grouped_matmul(x, w)
        contenders = {"kernel": lambda: gmm.grouped_matmul(x, w),
                      "torch.bmm": lambda: torch.bmm(x, w)}
        for name, lib in others.items():
            theirs = gmm.bind(lib)

            def call_other(theirs=theirs):
                saved = gmm._kernel()
                gmm._fn = theirs
                try:
                    return gmm.grouped_matmul(x, w)
                finally:
                    gmm._fn = saved
            diff = (call_other().float() - mine.float()).abs().max().item()
            print(f"  gmm {label}: {name}'s output max abs difference {diff:.3e} "
                  f"(stream geometry {theirs[2]})")
            contenders[name] = call_other
        out[label] = report(f"gmm {label}", in_turns(contenders, rounds, iters))
        print(f"  gmm {label}: bound {(x.numel() + w.numel() + G * M * N) * 2 / 3.35e9:.4f} "
              f"ms (bytes at 3.35 TB/s)")
        del x, w, mine
    return out


def bench_bwd(gen, others, rounds, iters):
    import torch.nn.functional as F
    B, Hq, Hkv, S, d = BWD_SHAPE
    q = torch.randn(B, S, Hq, d, generator=gen, device="cuda").bfloat16().transpose(1, 2)
    k, v = (torch.randn(B, S, Hkv, d, generator=gen, device="cuda").bfloat16().transpose(1, 2)
            for _ in range(2))
    do = torch.randn(q.shape, generator=gen, device="cuda").bfloat16()
    o, lse = fa.flash_attention_fwd(q, k, v, return_lse=True)
    qs, ks, vs = (t.detach().clone().requires_grad_() for t in (q, k, v))
    o_sdpa = F.scaled_dot_product_attention(qs, ks, vs, is_causal=True, enable_gqa=True)
    mine = fa.flash_attention_bwd(q, k, v, o, do, lse)
    contenders = {"kernel": lambda: fa.flash_attention_bwd(q, k, v, o, do, lse),
                  "sdpa_bwd": lambda: torch.autograd.grad(o_sdpa, (qs, ks, vs), do,
                                                          retain_graph=True)}
    for name, lib in others.items():
        theirs = fa.bind_bwd(lib)

        def call_other(theirs=theirs):
            saved = fa._bwd_kernel()
            fa._bwd_fn = theirs
            try:
                return fa.flash_attention_bwd(q, k, v, o, do, lse)
            finally:
                fa._bwd_fn = saved
        diff = max((a - b).abs().max().item() for a, b in zip(call_other(), mine))
        print(f"  flash_bwd: {name}'s output max abs difference {diff:.3e}")
        contenders[name] = call_other
    out = report("flash_bwd", in_turns(contenders, rounds, iters))
    for name, fn in contenders.items():
        out[name]["host_us"] = host_us(fn)
        print(f"  flash_bwd {name:12s} host time per call {out[name]['host_us']:.1f} us")
    profile_kernels(contenders, iters)
    return out


def profile_kernels(contenders, iters):
    """Device time per kernel name of ``iters`` calls of each contender, from
    a torch.profiler trace (the split of a call into its launches)."""
    from torch.profiler import ProfilerActivity, profile
    for name, fn in contenders.items():
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        for e in sorted(prof.key_averages(), key=lambda e: -e.self_device_time_total):
            if e.self_device_time_total > 0:
                print(f"  profile {name:12s} {e.count // iters:3d} x per call  "
                      f"{e.self_device_time_total / iters / 1e3:.4f} ms per call  {e.key[:90]}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernel", choices=("all", "gmm", "bwd"), default="all")
    ap.add_argument("--other-gmm", action="append", default=[],
                    help="another csrc/grouped_matmul.cu (may repeat)")
    ap.add_argument("--other-bwd", action="append", default=[],
                    help="another csrc/flash_attention_bwd.cu (may repeat)")
    ap.add_argument("--rounds", type=int, default=6)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs an NVIDIA card", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(f"card: {torch.cuda.get_device_name(0)}; nvidia-smi: {smi}")
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    result = {"card": smi}
    side = torch.cuda.Stream()            # inputs, yardsticks and captures all on it
    torch.cuda.set_stream(side)
    if args.kernel in ("all", "gmm"):
        others = build_others("grouped_matmul", args.other_gmm)
        result["gmm"] = bench_gmm(gen, others, args.rounds, args.iters)
    if args.kernel in ("all", "bwd"):
        others = build_others("flash_attention_bwd", args.other_bwd)
        result["flash_bwd"] = bench_bwd(gen, others, args.rounds, args.iters)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
