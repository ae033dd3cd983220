"""Training launcher of the port: ZeRO-1 or ZeRO-3 data parallelism over a
mesh of ranks.

    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \\
        [--zero 1|3] [--steps 5] [--mode hier] [--backend xla|pallas] \\
        [--wire-quant int8] [--error-feedback auto|on|off] [--seq 128] \\
        [--micro-batch 1] [--n-micro 2] [--mesh-shape 2,2] [--lr 1e-3] \\
        [--seed 0] [--reduced|--full-size] [--device cuda|cpu]

``--arch`` takes every dense and MoE architecture of the port
(``configs.ARCH_IDS`` and the paper's models, ``configs.PAPER_IDS``); the
SSM and hybrid families raise (ROADMAP A7).  ``--zero 3`` shards the
parameters over the mesh's "data" axis and gathers them per block inside the
forward (the dense family; the MoE family raises, ROADMAP A6b).

The ranks of ``--mesh-shape pod,data`` are threads of this process sharing
one device (a ``ThreadMesh``).  Runs on the card unless ``--device cpu`` is
given; with no card it raises.  Weights are random, made from ``--seed``;
the data is the deterministic synthetic stream of ``data.pipeline``.  Full
size trains in bf16 parameters with f32 master state, reduced in f32 (as the
reference's launcher).  Prints loss, tokens and grad norm per step, then
tokens/s (and the card's peak memory).

Not ported: the reference launcher's checkpoint, elastic, watchdog, trace
and ``--plan auto`` options (ROADMAP A10).
"""
import argparse
import time


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--zero", type=int, default=1, choices=[1, 3])
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--mode", default="hier")
    ap.add_argument("--backend", default="xla", choices=["xla", "pallas"])
    ap.add_argument("--wire-quant", default=None, choices=["int8", "fp8"])
    ap.add_argument("--error-feedback", default="auto", choices=["auto", "on", "off"])
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--micro-batch", type=int, default=1)
    ap.add_argument("--n-micro", type=int, default=2, help="micro-steps per pod")
    ap.add_argument("--mesh-shape", default="2,2", help="pod,data")
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full-size", dest="reduced", action="store_false")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch

    from repro_torch.configs import get_config
    from repro_torch.configs.base import RunConfig
    from repro_torch.core.balance import uniform_plan
    from repro_torch.core.mesh import ThreadMesh
    from repro_torch.data.pipeline import DataPipeline
    from repro_torch.models import build
    from repro_torch.train import optim
    from repro_torch.train.trainer import make_train_program

    n_pods, n_data = (int(x) for x in args.mesh_shape.split(","))
    mesh = ThreadMesh({"pod": n_pods, "data": n_data}, device=args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    model = build(cfg)
    rc = RunConfig(zero_stage=args.zero, collective_mode=args.mode, backend=args.backend,
                   wire_quant=args.wire_quant, error_feedback=args.error_feedback,
                   learning_rate=args.lr, seed=args.seed,
                   param_dtype="float32" if args.reduced else "bfloat16")
    plan = uniform_plan(n_pods, args.n_micro * n_pods, args.micro_batch)
    prog = make_train_program(model, mesh, rc, plan)
    print(f"arch={cfg.name} params={model.n_params():,} zero={rc.zero_stage} mesh={mesh.shape} "
          f"device={mesh.device} mode={prog.hcfg.resolved_mode()} backend={rc.backend} "
          f"wire_quant={rc.wire_quant} error_feedback={optim.ef_codec(rc) is not None}",
          flush=True)
    state = prog.init_fn()
    pipe = DataPipeline(seed=args.seed, plan=plan, dp_world=prog.dp_world(),
                        seq_len=args.seq, vocab=cfg.vocab)
    cuda = mesh.device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(mesh.device)
    tokens = 0
    t0 = time.perf_counter()
    hist = []
    for step in range(args.steps):
        state, m = prog.step_fn(state, pipe.batch_at(step))
        loss, tok, gn = m["loss"].item(), int(m["tokens"].item()), m["grad_norm"].item()
        tokens += tok
        hist.append(loss)
        print(f"step {step:4d}  loss {loss:.4f}  tokens {tok}  grad_norm {gn:.3f}",
              flush=True)
    dt = time.perf_counter() - t0
    peak = (f", peak memory {torch.cuda.max_memory_allocated(mesh.device) / 2**30:.2f} GiB"
            if cuda else "")
    print(f"done: loss {hist[0]:.4f} -> {hist[-1]:.4f}, {tokens} tokens in {dt:.2f} s "
          f"({tokens / dt:.1f} tokens/s){peak}")
    return hist


if __name__ == "__main__":
    main()
