"""Time the int8 wire codec's kernels (``csrc/quant.cu``) and
``collective_reduce`` at the shapes a training step gives them, L2 cold.

    python -m repro_torch.launch.bench_codec [--rounds 8] [--other path/to/quant.cu ...]

Shapes: ``quant_int8`` and ``dq_accum_int8`` at (6912, 512), the ring hop
the codec was timed at so far, and at (55296, 512), full-width
smollm-135m's largest leaf (its embedding and its lm head, which error
feedback encodes and decodes whole); ``collective_reduce`` at the emulated
ring's step on the largest bucket (7,077,888 f32 elements), with f32 and with
bf16 incoming, each read in turns with ``torch.add``.

Every reading starts with L2 cold: a 256 MB read evicts it before the
reading's window opens, and the reading's K calls each take their own input
set, so no call finds its inputs in L2.  Each contender is read two ways:
``stream``, CUDA events around K calls made back to back from the host (the
wrapper's host time is in it where it exceeds the card's); ``graph``, the
same K calls captured in a CUDA graph and replayed (the host's time is not
in it).  Contenders are read in turns, the order reversed every other round;
the yardsticks are ``torch.addcmul`` beside ``dq_accum_int8`` and
``torch.add`` beside ``collective_reduce`` (the port never calls them).  The
wrapper's host microseconds per call are taken on the host clock without a
synchronize.  Each ``--other`` source is built as the checkout's is and read
in the same turns; its outputs are held against the checkout's bit for bit.

Then the codec's card time per training step: for every shape one int8+EF
ZeRO-1 step of full-width smollm-135m launches on a (pod=2, data=2) mesh
(:func:`codec_launch_rows`, from its leaves and buckets), the launches times
the graph reading, summed over shapes and the four ranks sharing the card.

Prints the card's name and power limit, every reading and each median, and a
JSON line last.  Needs the card and nvcc.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from collections import Counter

import torch

HBM_BYTES_PER_S = 3.35e12            # H100 SXM data sheet
CHUNK = 512                          # quant.DEFAULT_CHUNK
SHAPES = {"hop": 6912, "leaf": 55296}
REDUCE_ELEMS = 7_077_888             # the largest bucket's emulated ring step
FLUSH_BYTES = 256 << 20              # five times the 50 MB L2
SET_BUDGET = 1 << 30                 # bytes of input sets per shape and contender group
MAX_CALLS = 16                       # calls per reading


def codec_launch_rows(leaf_numels, bucket_numels, n_pods: int, n_data: int,
                      chunk: int = CHUNK) -> dict:
    """Codec launches of one ZeRO-1 int8+EF step on ONE rank of a hier
    (pod, data) mesh, by rows of ``chunk``: ``{"quant_int8": {rows: n},
    "dq_accum_int8": {rows: n}}``.

    * error feedback encodes each leaf whole and decodes it into zeros;
    * each gradient bucket (flat, padded to the world) takes the quantized
      cross-pod ring reduce-scatter first: pod chunks of B / P, each of the
      P - 1 steps encoding and decoding two streams of half a chunk; then,
      after the local reduce-scatter and all-gather, the cross-pod ring
      all-gather of B / P, encoded once and decoded P times;
    * each parameter's all-gather: the local gather of D master shards,
      encoded once and decoded P times.
    """
    world = n_pods * n_data
    q, dq = Counter(), Counter()

    def add(numel, nq, ndq):
        rows = -(-numel // chunk)
        if rows:
            q[rows] += nq
            dq[rows] += ndq

    for n in leaf_numels:
        add(n, 1, 1)
    for b in bucket_numels:
        c = (b + (-b) % world) // n_pods
        h = c // 2 if c >= 2 else 0
        for _ in range(n_pods - 1):
            for part in ((h, c - h) if h else (c,)):
                add(part, 1, 1)
        add(c, 1, n_pods)
    for n in leaf_numels:
        add((n + (-n) % world) // world * n_data, 1, n_pods)
    return {"quant_int8": dict(q), "dq_accum_int8": dict(dq)}


def smollm_step_rows(bucket_bytes: int = 64 * 1024 * 1024, n_pods: int = 2,
                     n_data: int = 2) -> dict:
    """:func:`codec_launch_rows` of full-width smollm-135m's gradient tree
    (meta tensors: nothing is allocated), bucketed as ``tree_all_reduce``
    buckets it."""
    from repro_torch.configs import get_config
    from repro_torch.core import hetccl
    from repro_torch.core.tree import leaves as tree_leaves
    from repro_torch.models import build
    from repro_torch.models.common import tree_map_meta
    grads = tree_leaves(tree_map_meta(lambda m: torch.empty(m.shape, device="meta"),
                                      build(get_config("smollm-135m")).abstract_params()))
    buckets = hetccl._make_buckets(grads, bucket_bytes)
    return codec_launch_rows([g.numel() for g in grads],
                             [sum(grads[i].numel() for i in b) for b in buckets], n_pods, n_data)


def step_bound_ms(step_rows: dict, ranks: int = 4) -> float:
    """The least card time of one step's codec launches (``step_rows``, one
    rank): their bytes at 3.35 TB/s, over ``ranks``."""
    return ranks * sum(n * codec_bytes(kernel, rows) for kernel, counts in step_rows.items()
                       for rows, n in counts.items()) / HBM_BYTES_PER_S * 1e3


def codec_bytes(kernel: str, rows: int, chunk: int = CHUNK) -> int:
    """Bytes the call must move: each input read once, each output written
    once (quantize: f32 in, int8 codes and f32 scales out; decode: f32
    accumulator, codes and scales in, f32 out)."""
    n = rows * chunk
    return n * 4 + n + rows * 4 + (n * 4 if kernel == "dq_accum_int8" else 0)


class ColdReader:
    """Readings with L2 cold: a read of ``FLUSH_BYTES`` before each one,
    outside the window that CUDA events open around ``run``."""

    def __init__(self):
        self.flush_buf = torch.zeros(FLUSH_BYTES // 4, device="cuda")

    def read(self, run, calls: int) -> float:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.sum(self.flush_buf)
        start.record()
        run()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / calls


def n_sets(set_bytes: int) -> int:
    """Input sets per shape: one per call of a reading, within SET_BUDGET."""
    return max(2, min(MAX_CALLS, SET_BUDGET // max(set_bytes, 1)))


def captured(calls):
    """The calls captured once in a CUDA graph on the current stream (which
    must not be the default one), after a warm-up."""
    for c in calls:
        c()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=torch.cuda.current_stream()):
        for c in calls:
            c()
    return graph


def cold_in_turns(reader, contenders, rounds: int, modes=("stream", "graph")) -> dict:
    """{name: {mode: [ms per call, ...]}}: each contender ({name: [call,
    ...]}, one call per input set) read once per round in each mode, the
    order reversed every other round."""
    graphs = {n: captured(calls) for n, calls in contenders.items()} if "graph" in modes \
        else {}
    runs = {n: {"stream": lambda calls=calls: [c() for c in calls],
                "graph": graphs[n].replay if n in graphs else None}
            for n, calls in contenders.items()}
    names = list(contenders)
    for n in names:                                            # warm-up
        for mode in modes:
            reader.read(runs[n][mode], 1)
    out = {n: {mode: [] for mode in modes} for n in names}
    for r in range(rounds):
        for n in (names if r % 2 == 0 else names[::-1]):
            for mode in modes:
                out[n][mode].append(reader.read(runs[n][mode], len(contenders[n])))
    return out


def host_us(call, calls: int = 200) -> float:
    """The caller's time per call on the host clock, without waiting for the
    card: where it exceeds the card's time, back-to-back calls are
    host-bound."""
    call()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(calls):
        call()
    us = (time.perf_counter() - t) / calls * 1e6
    torch.cuda.synchronize()
    return us


def medians(readings: dict) -> dict:
    return {n: {mode: statistics.median(ms) for mode, ms in modes.items()}
            for n, modes in readings.items()}


def with_lib(quant, lib, fn):
    """fn run with the codec wrapper bound to ``lib`` (None: the checkout's)."""
    if lib is None:
        return fn

    def run(*a):
        saved = quant._lib
        quant._lib = lib
        try:
            return fn(*a)
        finally:
            quant._lib = saved
    return run


def codec_sets(quant, kernel: str, rows: int, gen, count: int):
    """``count`` input sets at (rows, 512): x for quantize; acc, codes and
    scales for the decode (codes and scales from quantizing a chunk-scaled
    normal x)."""
    sets = []
    for _ in range(count):
        x = torch.randn(rows, CHUNK, generator=gen, device="cuda") \
            * torch.exp(torch.randn(rows, 1, generator=gen, device="cuda"))
        if kernel == "quant_int8":
            sets.append((x,))
        else:
            sets.append((torch.randn(rows, CHUNK, generator=gen, device="cuda"),
                         *quant.wire_quantize_int8(x)))
        del x
    return sets


def bench_codec_shape(reader, quant, kernel: str, rows: int, gen, libs: dict, rounds: int,
                      modes=("stream", "graph"), yardstick: bool = True) -> dict:
    """One codec kernel at (rows, 512): every library of ``libs`` ({name:
    bound library or None for the checkout's}) and, for the decode, the
    ``torch.addcmul`` yardstick, read in turns; medians, readings, bound,
    host us per call, and whether each library's output equals the first
    one's bit for bit."""
    fn = quant.wire_quantize_int8 if kernel == "quant_int8" else quant.wire_dequant_accum_int8
    sets = codec_sets(quant, kernel, rows, gen, n_sets(codec_bytes(kernel, rows)))
    contenders = {name: [lambda s=s, f=with_lib(quant, lib, fn): f(*s) for s in sets]
                  for name, lib in libs.items()}
    if kernel == "dq_accum_int8" and yardstick:
        contenders["torch.addcmul"] = [lambda s=s: torch.addcmul(*s) for s in sets]
    outs = {name: contenders[name][0]() for name in libs}
    outs = {name: o if isinstance(o, tuple) else (o,) for name, o in outs.items()}
    first = outs[next(iter(libs))]
    same = {name: all(torch.equal(a.view(torch.uint8), b.view(torch.uint8))
                      for a, b in zip(o, first)) for name, o in outs.items()}
    readings = cold_in_turns(reader, contenders, rounds, modes)
    result = {"rows": rows, "calls_per_reading": len(sets),
              "bound_ms": codec_bytes(kernel, rows) / HBM_BYTES_PER_S * 1e3,
              "median_ms": medians(readings), "readings": readings, "same_bits": same}
    if "stream" in modes:
        result["host_us"] = {name: host_us(calls[0]) for name, calls in contenders.items()}
    del sets, contenders, outs
    return result


def bench_reduce(reader, cr, gen, rounds: int, elems: int = REDUCE_ELEMS,
                 inc_dtype=torch.float32) -> dict:
    """``collective_reduce`` against ``torch.add`` at ``elems`` f32 + f32 (or
    bf16 incoming), read in turns both ways, L2 cold; ``same_bits`` holds the
    kernel's output against the plain version's."""
    nbytes = elems * (8 + torch.tensor([], dtype=inc_dtype).element_size())
    sets = [(torch.randn(elems, generator=gen, device="cuda"),
             torch.randn(elems, generator=gen, device="cuda").to(inc_dtype))
            for _ in range(n_sets(nbytes))]
    contenders = {"kernel": [lambda s=s: cr.collective_reduce(*s) for s in sets],
                  "torch.add": [lambda s=s: torch.add(*s) for s in sets]}
    same = torch.equal(cr.collective_reduce(*sets[0]).view(torch.int32),
                       cr.collective_reduce_plain(*sets[0]).view(torch.int32))
    readings = cold_in_turns(reader, contenders, rounds)
    return {"elems": elems, "inc_dtype": str(inc_dtype).removeprefix("torch."),
            "calls_per_reading": len(sets),
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "median_ms": medians(readings),
            "readings": readings, "same_bits": same,
            "host_us": {name: host_us(calls[0]) for name, calls in contenders.items()}}


def step_card_ms(reader, quant, step_rows: dict, gen, libs: dict, rounds: int = 3,
                 ranks: int = 4) -> dict:
    """The codec's card time per step for each library: for every (kernel,
    rows) of ``step_rows`` (one rank's launches), launches x the median graph
    reading, summed, times ``ranks``.  Returns {name: {"ms": total,
    "by_shape": {kernel: {rows: ms per call}}}}."""
    out = {name: {"ms": 0.0, "by_shape": {k: {} for k in step_rows}} for name in libs}
    for kernel, counts in step_rows.items():
        for rows, n in sorted(counts.items()):
            r = bench_codec_shape(reader, quant, kernel, rows, gen, libs, rounds,
                                  modes=("graph",), yardstick=False)
            for name in libs:
                ms = r["median_ms"][name]["graph"]
                out[name]["by_shape"][kernel][rows] = ms
                out[name]["ms"] += ranks * n * ms
    return out


def report(label, r):
    for name, modes in r["readings"].items():
        for mode, ms in modes.items():
            print(f"  {label} {name:16s} {mode:6s} median {statistics.median(ms):.5f} ms "
                  f"({', '.join(f'{v:.5f}' for v in ms)})")
    if "host_us" in r:
        print(f"  {label} host us per call: "
              + ", ".join(f"{n} {v:.1f}" for n, v in r["host_us"].items()))
    print(f"  {label} bound {r['bound_ms']:.5f} ms (bytes at 3.35 TB/s); "
          f"{r['calls_per_reading']} calls per reading"
          + (f"; bit for bit as the first: {r['same_bits']}" if "same_bits" in r else ""))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", action="append", default=[],
                    help="another csrc/quant.cu (may repeat)")
    ap.add_argument("--rounds", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs an NVIDIA card", file=sys.stderr)
        return 1
    from repro_torch.kernels import collective_reduce as cr
    from repro_torch.kernels import quant
    from repro_torch.launch.bench_kernels import build_others
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(f"card: {torch.cuda.get_device_name(0)}; nvidia-smi: {smi}")
    libs = {"kernel": None}
    libs.update({name: quant.bind(lib)
                 for name, lib in build_others("quant", args.other).items()})
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    side = torch.cuda.Stream()            # inputs, calls and captures all on it
    torch.cuda.set_stream(side)
    reader = ColdReader()
    result = {"card": smi, "codec": {}}
    for label, rows in SHAPES.items():
        for kernel in ("quant_int8", "dq_accum_int8"):
            r = bench_codec_shape(reader, quant, kernel, rows, gen, libs, args.rounds)
            report(f"{kernel} {label} ({rows}, 512)", r)
            result["codec"][f"{kernel}_{label}"] = {k: v for k, v in r.items()
                                                    if k != "readings"}
    for inc_dtype in (torch.float32, torch.bfloat16):
        r = bench_reduce(reader, cr, gen, args.rounds, inc_dtype=inc_dtype)
        report(f"collective_reduce ({r['elems']},) + {r['inc_dtype']}", r)
        result[f"collective_reduce_{r['inc_dtype']}"] = {k: v for k, v in r.items()
                                                          if k != "readings"}
    rows = smollm_step_rows()
    print(f"  one int8+EF step, one rank: launches by rows {json.dumps(rows)}")
    steps = step_card_ms(reader, quant, rows, gen, libs)
    bound = step_bound_ms(rows)
    for name, s in steps.items():
        print(f"  codec card time per step ({name}, 4 ranks, graph, L2 cold): "
              f"{s['ms']:.4f} ms (bound {bound:.4f} ms)")
    result["step"] = {"launch_rows": rows, "bound_ms": bound, **steps}
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
