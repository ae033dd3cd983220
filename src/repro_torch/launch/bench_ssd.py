"""Time the SSD scan kernel of this checkout against the same kernel built
from another source, in turns, at both models' prefill shapes.

    python -m repro_torch.launch.bench_ssd --other path/to/ssd_scan.cu [--rounds 8]

Both libraries are loaded into one process and called on the same inputs
(bf16 x, B and C in the model's layout, inputs from a seed), in the order
A B, B A, A B, ... over the rounds; each reading is the mean of CUDA-event
time over ``--iters`` launches made back to back.  Prints the card's name and
power limit, every reading, each side's median and the largest difference
between the two sides' outputs.  The other source must take this one's C
arguments (``ssd_scan.bind``): nine pointers, the chunk-entry states' among
them.  A source older than that pointer takes eight, and its arguments
would not line up: it cannot be compared here.  Needs the card and nvcc.
"""
from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import statistics
import subprocess
import sys

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ssd_scan as ssd

# (name, B, S, H, P, G, N, Q): Mamba2-2.7B's and Zamba2-7B's SSD at the
# chip_smoke prefill (8 requests x 2048 tokens)
SHAPES = [("mamba2_prefill", 8, 2048, 80, 64, 1, 128, 256),
          ("zamba2_prefill", 8, 2048, 112, 64, 1, 64, 256)]


def build_other(path: str) -> ctypes.CDLL:
    """The library of another ``ssd_scan.cu``, built as the checkout's is."""
    src = open(path, "rb").read()
    tag = hashlib.sha256(src + " ".join(_build.NVCC_FLAGS).encode()).hexdigest()[:16]
    out_dir = _build.BUILD_DIR / "other"
    out_dir.mkdir(parents=True, exist_ok=True)
    so = out_dir / f"libssd_scan-{tag}.so"
    if not so.exists():
        proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so), path],
                              capture_output=True, text=True)
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {path}:\n{proc.stdout}{proc.stderr}")
    return ctypes.CDLL(str(so))


def inputs(gen, B, S, H, P, G, N, Q):
    """x unit normals, B and C normals of std 0.5 (bf16), dt = softplus(normal),
    A = -exp(0.25 normal), a the within-chunk cumsum of dt * A (f32)."""
    dev = "cuda"
    x = torch.randn(B, S, H, P, generator=gen, device=dev).bfloat16()
    dt = torch.nn.functional.softplus(torch.randn(B, S, H, generator=gen, device=dev))
    A = -torch.exp(0.25 * torch.randn(H, generator=gen, device=dev))
    a = torch.cumsum((dt * A).reshape(B, S // Q, Q, H), 2).reshape(B, S, H)
    bm, cm = ((0.5 * torch.randn(B, S, G, N, generator=gen, device=dev)).bfloat16()
              for _ in range(2))
    return x, dt, a, bm, cm, Q


def mean_ms(fn, iters):
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", required=True, help="another csrc/ssd_scan.cu")
    ap.add_argument("--rounds", type=int, default=8)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs an NVIDIA card", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "nvidia-smi failed")
    fns = {"this": ssd._kernel(), "other": ssd.bind(build_other(args.other))}
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    result = {}
    for name, *shape in SHAPES:
        inp = inputs(gen, *shape)
        outs, times = {}, {k: [] for k in fns}

        def run(side):
            ssd._fn = fns[side]
            return ssd.ssd_scan_model(*inp)

        for side in fns:                       # warm up; keep each side's output
            outs[side] = run(side)
            mean_ms(lambda: run(side), 2)
        for r in range(args.rounds):
            order = list(fns) if r % 2 == 0 else list(fns)[::-1]
            for side in order:
                times[side].append(mean_ms(lambda: run(side), args.iters))
        diff = max((a - b).abs().max().item() for a, b in zip(outs["this"], outs["other"]))
        med = {k: statistics.median(v) for k, v in times.items()}
        print(f"{name} B{shape[0]} S{shape[1]} H{shape[2]} P{shape[3]} G{shape[4]} "
              f"N{shape[5]} Q{shape[6]} bf16: this {med['this']:.4f} ms, other "
              f"{med['other']:.4f} ms (medians of {args.rounds}; this / other "
              f"{med['this'] / med['other']:.4f}); largest output difference {diff:.3e}")
        for side in fns:
            print(f"  {side:5s} " + " ".join(f"{t:.4f}" for t in times[side]))
        result[name] = {"this_ms": times["this"], "other_ms": times["other"],
                        "this_median_ms": med["this"], "other_median_ms": med["other"],
                        "max_output_diff": diff}
        del inp, outs
    ssd._fn = fns["this"]
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
