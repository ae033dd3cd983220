"""Serving launcher of the port: prefill/decode a dense or MoE architecture
(smollm-135m, mixtral-8x7b, moonshot-v1-16b-a3b).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-135m \\
        [--batch 4] [--prompt-len 32] [--max-new 16] [--reduced|--full-size] \\
        [--device cuda|cpu] [--seed 0]

Runs on the card unless ``--device cpu`` is given; with no card it raises.
Weights are random, made from ``--seed``.
"""
import argparse
import time


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full-size", dest="reduced", action="store_false")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import build
    from repro_torch.serve.engine import (Batcher, Request, make_serve_programs,
                                          resolve_device)

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    model = build(cfg)
    max_len = args.prompt_len + args.max_new
    progs = make_serve_programs(model, seq_len=args.prompt_len, max_len=max_len,
                                device=device)
    params = model.init(torch.Generator(device=device).manual_seed(args.seed))
    rng = np.random.RandomState(args.seed)
    reqs = [Request(i, rng.randint(0, cfg.vocab, args.prompt_len // 2)
                    .astype(np.int32), args.max_new)
            for i in range(args.batch)]
    b = Batcher(progs, params, batch_slots=args.batch,
                prompt_len=args.prompt_len, max_len=max_len)
    t0 = time.perf_counter()
    done = b.run(reqs)          # ends on a host read of the last tokens
    dt = time.perf_counter() - t0
    tok = sum(len(r.out) for r in done)
    print(f"arch={cfg.name}: served {len(done)} reqs, {tok} tokens "
          f"in {dt:.2f}s ({tok / dt:.1f} tok/s)")
    return done


if __name__ == "__main__":
    main()
