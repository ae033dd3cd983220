"""The card's memory at the boundaries of a training step.

    PYTHONPATH=src python -m repro_torch.launch.memory_breakdown [--zero 1|3] [--steps 3] \
        [--arch moonshot-v1-16b-a3b] [--layers 1] [--micro 2]
    PYTHONPATH=src python src/repro_torch/launch/memory_breakdown.py --src build/parent/src

Trains ``--arch`` (any family; moonshot-v1-16b-a3b by default) at full width
cut to ``--layers`` layers on a (pod=2, data=2) ThreadMesh, ``chip_smoke.py``
[25]'s configuration (``--micro`` micro-steps of 1 x 4096 tokens a rank,
two by default, remat, hier, pallas, bf16 parameters, weights from seed 0,
lr 1e-3, loss chunks of 1024 tokens; [28]'s too, with mamba2-2.7b at
16 layers and zamba2-7b at 7), and runs every step under
:func:`step_memory`, which
prints the peak of each segment of the step and what is allocated at its
end.  ``--src`` puts another tree's ``src`` first on the path, so that its
trainer is the one read: for example the parent commit's, unpacked with
``git archive`` into a directory ``.gitignore`` lists; the configuration
and the readings are this file's.  A step that runs out of memory ends the
run, with the segments read before it.  Needs the card.
"""
import argparse
import dataclasses
import subprocess
import sys
import time


def step_memory(torch, mesh_mod, prog, state, batch):
    """One step of ``prog`` with the card's memory read at its boundaries:
    the peak of each segment (``torch.cuda.max_memory_allocated``, reset at
    each boundary) and what is allocated at its end, in GiB.  The segments:
    the forward and backward of every micro-step (up to the optimizer step);
    under ZeRO-1 ``hetccl.tree_all_reduce``, then the rest of
    ``optim.zero1_step`` (the shard update and the parameter all-gather);
    under ZeRO-3 ``optim.zero3_step`` (the pod all-reduce and the update);
    the trainer's return.  Each boundary inside the step is a barrier over
    the mesh's ranks (a ``psum``), at which rank 0 reads and resets.  Also
    the bytes the ring kernels' scratch keeps (``ring_dma._scratch``) at the
    end.  Returns ``(state, segments, scratch_gib, error)``: a step that
    runs out of memory returns the segments read before it, the state None
    and the error's first line; else the error is None."""
    from repro_torch.core import hetccl as hetccl_mod
    from repro_torch.kernels import ring_dma
    from repro_torch.train import optim
    segs, gib = [], 2 ** 30
    axes = tuple(prog.mesh.axes)

    def mark(label):
        torch.cuda.synchronize()
        segs.append({"segment": label, "peak_gib": torch.cuda.max_memory_allocated() / gib,
                     "allocated_gib": torch.cuda.memory_allocated() / gib})
        torch.cuda.reset_peak_memory_stats()

    def boundary(label):
        barrier = torch.zeros((), device=prog.mesh.device)
        mesh_mod.psum(barrier, axes)
        if mesh_mod.axis_index(axes) == 0:
            mark(label)
        mesh_mod.psum(barrier, axes)

    def bounded(fn, before, after):
        def run(*a, **kw):
            if before:
                boundary(before)
            out = fn(*a, **kw)
            boundary(after)
            return out
        return run

    orig = optim.zero1_step, optim.zero3_step, hetccl_mod.tree_all_reduce
    mark("before the step")
    optim.zero1_step = bounded(orig[0], "forward and backward",
                               "optimizer and parameter all-gather")
    optim.zero3_step = bounded(orig[1], "forward and backward", "pod all-reduce and optimizer")
    hetccl_mod.tree_all_reduce = bounded(orig[2], None, "tree_all_reduce")
    error = None
    try:
        state, _ = prog.step_fn(state, batch)
        mark("the step's return")
    except torch.cuda.OutOfMemoryError as e:
        state, error = None, str(e).splitlines()[0]
    finally:
        optim.zero1_step, optim.zero3_step, hetccl_mod.tree_all_reduce = orig
    scratch = sum(t.numel() * t.element_size() for sc in ring_dma._scratch.values()
                  for t in vars(sc).values() if isinstance(t, torch.Tensor))
    for seg in segs:
        print(f"    {seg['segment']}: peak {seg['peak_gib']:.2f} GiB, allocated after "
              f"{seg['allocated_gib']:.2f} GiB")
    print(f"    ring kernels' scratch kept: {scratch / gib:.4f} GiB"
          + (f"; out of memory: {error}" if error else ""), flush=True)
    return state, segs, scratch / gib, error


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--zero", type=int, default=1, choices=[1, 3])
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--src", default=None, help="a tree's src to read the trainer from")
    ap.add_argument("--arch", default="moonshot-v1-16b-a3b")
    ap.add_argument("--layers", type=int, default=1)
    ap.add_argument("--micro", type=int, default=2, help="micro-steps a rank")
    args = ap.parse_args(argv)
    if args.src:
        sys.path.insert(0, args.src)

    import torch

    import repro_torch
    from repro_torch.configs import get_config
    from repro_torch.configs.base import RunConfig
    from repro_torch.core import balance, mesh as mesh_mod
    from repro_torch.data.pipeline import synthetic_batch
    from repro_torch.models import build
    from repro_torch.train.trainer import make_train_program

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip())
    print(f"trainer from {repro_torch.__file__}; ZeRO-{args.zero}; {args.arch}, "
          f"{args.layers} layers, {args.micro} micro-steps a rank", flush=True)
    cfg = dataclasses.replace(get_config(args.arch), n_layers=args.layers, loss_chunk=1024)
    model = build(cfg)
    m = mesh_mod.ThreadMesh({"pod": 2, "data": 2}, device="cuda")
    plan = balance.uniform_plan(2, 2 * args.micro, micro_batch=1)
    params = model.init(torch.Generator(device="cuda").manual_seed(0), dtype=torch.bfloat16)
    prog = make_train_program(model, m, RunConfig(zero_stage=args.zero, collective_mode="hier",
                                                  backend="pallas", learning_rate=1e-3), plan)
    torch.cuda.reset_peak_memory_stats()
    state = prog.init_fn(params)
    del params
    for s in range(args.steps):
        batch = synthetic_batch(0, s, plan.n_micro_max, plan.micro_batch * m.size, 4096,
                                cfg.vocab)
        print(f"  step {s}:", flush=True)
        t = time.perf_counter()
        state, _, _, error = step_memory(torch, mesh_mod, prog, state, batch)
        print(f"    {(time.perf_counter() - t) * 1e3:.1f} ms", flush=True)
        if error:
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
