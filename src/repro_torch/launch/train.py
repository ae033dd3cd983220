"""Training launcher of the port: ZeRO-1 or ZeRO-3 data parallelism over a
mesh of ranks, on the plan and policy table HetCCL's planner picks.

    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \\
        [--zero 1|3] [--steps 5] [--plan manual|auto] [--policy auto|flat|legacy] \\
        [--mode hier] [--backend xla|pallas] [--stripes auto|N] \\
        [--chips h100|v100,w7800|...] [--wire-quant int8] \\
        [--error-feedback auto|on|off] [--cross-dtype bfloat16] [--seq 128] \\
        [--micro-batch 1] [--n-micro 2] [--mesh-shape 2,2] [--lr 1e-3] \\
        [--seed 0] [--reduced|--full-size] [--device cuda|cpu] \\
        [--ckpt-dir DIR] [--ckpt-every 25] [--trace DIR] [--metrics-out PATH]

``--arch`` takes every architecture of the port (``configs.ARCH_IDS`` and
the paper's models, ``configs.PAPER_IDS``): dense, MoE, and the SSM and
hybrid families (mamba2-2.7b, zamba2-7b), whose SSD scan trains through its
backward kernel.  ``--zero 3`` shards the parameters over the mesh's "data"
axis and gathers them inside the forward, every family: per block, the MoE
family's router and expert stacks among them; the hybrid's shared block
once per forward and each group's Mamba2 blocks once per group (a Mamba2
block's leaves without an "embed" dim stay whole on every rank).

The collective configuration comes from the planner (``repro_torch.plan``,
DESIGN.md §9, §12), with the reference launcher's flags and defaults:

* ``--policy auto`` (the default): a per-op, size-classed ``PolicyTable``
  from ``plan.policy_table_for`` on the mesh's modeled cluster
  (``launch.mesh.cluster_for_mesh``); ``legacy``: the single-policy facade
  of ``--mode``/``--backend``/``--stripes``; ``flat``: flat everywhere.
* ``--plan auto``: ``plan.autotune_policies`` (``plan.autotune`` under
  ``--policy legacy``) picks the mode, backend, channels, stripes, bucket and
  the per-pod shares of the batch together; the step trains on its
  ``HetPlan`` and ``run_config``, and the plan is printed
  (``plan auto: mode=... shares=... modeled_step=...``).  The batch
  contract (micro-batch x micro-steps) is kept; ``--zero`` is kept.
* ``--stripes auto`` lets the planner (or, for a manual pallas run,
  ``transport.plan_stripes``) choose; an integer pins it.

``--chips`` names the chip sheets of ``core.topology`` the mesh's islands
are priced as (one, or one per pod): ``h100`` (the default: the card the
ranks run on), ``v100``, ``w7800`` (the paper's testbed), ``mi300x``,
``v5e``, ``v4``.  Every modeled time is the planner's model of that cluster,
not a measurement.  The port's own flags compose with the plan: a run-level
``--wire-quant`` fills only the rows without a codec; ``--cross-dtype``
fills every row without one, and the planner then searches the rows
without a codec (a codec row owns its wire format and would take no cross
dtype); ``--error-feedback auto`` turns error feedback on wherever the
gradient rows quantize.

The ranks of ``--mesh-shape pod,data`` are threads of this process sharing
one device (a ``ThreadMesh``).  Runs on the card unless ``--device cpu`` is
given; with no card it raises.  Weights are random, made from ``--seed``;
the data is the deterministic synthetic stream of ``data.pipeline``.  Full
size trains in bf16 parameters with f32 master state, reduced in f32 (as the
reference's launcher).  Prints loss, tokens and grad norm per step, then
tokens/s over the steps' own time (and the card's peak memory).

As in the reference, the steps run under ``train.ft.run_supervised``: a
checkpoint of the full logical state at step 0 (of a fresh run), then every
``--ckpt-every`` steps and at the end; a run whose ``--ckpt-dir`` holds
checkpoints resumes from the latest, on a mesh of any size
(``train.checkpoint``).
``--trace DIR`` / ``--metrics-out PATH`` install ``obs.Telemetry``: every
collective of every rank becomes a span with the simulator's modeled time on
the ``--chips`` cluster, the policy rows are probed between steps, and the
run writes ``trace.json``, ``metrics.json``, ``report.txt`` and the metric
line.

Not ported yet: the reference launcher's ``--elastic``, ``--chaos`` and
``--watchdog`` (ROADMAP A10b).
"""
import argparse
import dataclasses

# flight-recorder ring of a traced run: a full-width step of four ranks
# dispatches a few hundred collectives, and the end-of-run dump keeps them all
FLIGHT_CAPACITY = 1 << 16

CHIP_SHEETS = {"h100": "H100_NVLINK", "v100": "V100_PCIE", "w7800": "W7800",
               "mi300x": "MI300X_XGMI", "v5e": "TPU_V5E", "v4": "TPU_V4"}


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--zero", type=int, default=1, choices=[1, 3])
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--mode", default="hier")
    ap.add_argument("--backend", default="xla", choices=["xla", "pallas"],
                    help="ring backend of the legacy facade; --plan auto and the policy "
                         "table choose it per row")
    ap.add_argument("--stripes", default="auto",
                    help="per-link stripes of the pallas rings: auto = planner-chosen "
                         "(--plan auto searches it, a manual pallas run asks "
                         "transport.plan_stripes); an integer pins it")
    ap.add_argument("--plan", default="manual", choices=["manual", "auto"],
                    help="auto: repro_torch.plan picks mode/channels/bucket/shares")
    ap.add_argument("--policy", default="auto", choices=["auto", "flat", "legacy"],
                    help="auto = per-op, size-classed PolicyTable; legacy = the "
                         "single-policy facade of --mode/--backend/--stripes; flat = "
                         "flat everywhere")
    ap.add_argument("--chips", default="h100",
                    help=f"chip sheet(s) the islands are priced as, one or one per pod: "
                         f"{', '.join(CHIP_SHEETS)}")
    ap.add_argument("--wire-quant", default=None, choices=["int8", "fp8"])
    ap.add_argument("--error-feedback", default="auto", choices=["auto", "on", "off"])
    ap.add_argument("--cross-dtype", default=None, choices=["bfloat16", "float16"],
                    help="cross-island dtype of the all-reduce (rows without a codec)")
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--micro-batch", type=int, default=1)
    ap.add_argument("--n-micro", type=int, default=2, help="micro-steps per pod")
    ap.add_argument("--mesh-shape", default="2,2", help="pod,data")
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full-size", dest="reduced", action="store_false")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint directory; a run resumes from its latest step (default: "
                         "a temporary directory, removed at the end)")
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--trace", default=None, metavar="DIR",
                    help="telemetry plane (repro_torch.obs): record every collective "
                         "dispatch as a policy-tagged span with its modeled time, probe "
                         "every policy row between steps, and write trace.json, "
                         "metrics.json, report.txt and flight dumps to DIR")
    ap.add_argument("--metrics-out", default=None, metavar="PATH",
                    help="append a unified-schema metric line (the fleet snapshot) to "
                         "this JSONL file at the end of the run")
    return ap


def chip_sheets(names: str):
    """``--chips``: the ``core.topology`` sheets it names, one per pod or
    one for every pod."""
    from repro_torch.core import topology
    sheets = []
    for n in names.split(","):
        if n not in CHIP_SHEETS:
            raise ValueError(f"--chips {n!r}: expected one of {', '.join(CHIP_SHEETS)}")
        sheets.append(getattr(topology, CHIP_SHEETS[n]))
    return sheets[0] if len(sheets) == 1 else sheets


def plan_run(args, mesh, cfg):
    """The launcher's run configuration, shares and plan for ``args`` on
    ``mesh`` (the reference launcher's ``--plan`` / ``--policy`` /
    ``--stripes`` semantics, ``repro/launch/train.py:113-166``).

    Returns ``(rc, plan, tp)``: the ``RunConfig``, the ``HetPlan`` of
    per-pod shares, and the planner's ``TrainPlan`` under ``--plan auto``
    (else None).
    """
    from repro_torch import plan as plan_mod
    from repro_torch.configs.base import RunConfig
    from repro_torch.core.balance import uniform_plan
    from repro_torch.launch.mesh import cluster_for_mesh, mesh_axis_sizes, resolve_stripes
    from repro_torch.transport.stripe import MAX_STRIPES

    if args.stripes != "auto" and not 1 <= int(args.stripes) <= MAX_STRIPES:
        raise ValueError(f"--stripes {args.stripes}: the ring kernels take 1 to "
                         f"{MAX_STRIPES} stripes")
    sizes = mesh_axis_sizes(mesh)
    n_pods, data_axis = sizes.get("pod", 1), sizes.get("data", 1)
    cluster = cluster_for_mesh(mesh, chip_sheets(args.chips))
    rc = RunConfig(zero_stage=args.zero,
                   collective_mode="flat" if args.policy == "flat" else args.mode,
                   backend=args.backend, wire_quant=args.wire_quant,
                   error_feedback=args.error_feedback, cross_dtype=args.cross_dtype,
                   learning_rate=args.lr, seed=args.seed,
                   # --plan auto searches the count and replaces this
                   n_stripes=resolve_stripes(args.stripes, args.backend, mesh),
                   param_dtype="float32" if args.reduced else "bfloat16")
    space = plan_mod.DEFAULT_SPACE
    if args.stripes != "auto":
        space = dataclasses.replace(space, stripe_counts=(int(args.stripes),))
    if args.cross_dtype:
        # a codec row owns its wire format and takes no cross dtype
        # (PolicyTable.with_cross_dtype): with one asked for, the planner
        # searches the rows without a codec
        space = dataclasses.replace(space, wire_quants=(None,))
    if args.plan == "auto":
        req = plan_mod.plan_request(
            cluster, cfg, global_batch=args.n_micro * n_pods * args.micro_batch * data_axis,
            seq_len=args.seq, data_axis=data_axis, zero_stage=args.zero,
            micro_tokens=args.micro_batch * args.seq)
        if args.policy == "flat":
            space = dataclasses.replace(space, modes=("flat",), backends=("xla",),
                                        per_op=False)
        elif args.policy == "legacy":
            space = dataclasses.replace(space, per_op=False)
        tp = (plan_mod.autotune_policies(req, space) if args.policy == "auto"
              else plan_mod.autotune(req, space))
        return tp.run_config(rc), tp.plan, tp
    plan = uniform_plan(n_pods, args.n_micro * n_pods, args.micro_batch)
    if args.policy == "auto":
        rc = dataclasses.replace(rc, policies=plan_mod.policy_table_for(
            cluster, space, bucket_bytes=rc.bucket_bytes, zero_stage=args.zero))
    return rc, plan, None


def plan_line(tp) -> str:
    """The reference launcher's ``--plan auto`` line."""
    n_rows = len(tp.policies.rows) if tp.policies is not None else 0
    return (f"plan auto: mode={tp.mode} backend={tp.backend} C={tp.n_channels} "
            f"stripes={tp.n_stripes} bucket={tp.bucket_bytes >> 20}MiB "
            f"policy_rows={n_rows} shares={tp.plan.micro_per_pod} "
            f"modeled_step={tp.modeled_step_s:.4f}s")


def run(args) -> dict:
    """Train as ``args`` say: the reference launcher's supervised loop
    (``ft.run_supervised``; a fresh run's checkpoint at step 0, then every
    ``--ckpt-every`` steps and at the end; a restart resumes from the
    latest), with the telemetry plane under ``--trace`` / ``--metrics-out``.
    Returns ``{"prog", "state", "history", "telemetry"}``: the program, its
    final per-rank states, ``run_supervised``'s history and the telemetry
    bundle (None without ``--trace`` / ``--metrics-out``)."""
    import shutil
    import tempfile

    import torch

    from repro_torch.configs import get_config
    from repro_torch.core.mesh import ThreadMesh
    from repro_torch.data.pipeline import DataPipeline
    from repro_torch.launch.mesh import cluster_for_mesh
    from repro_torch.models import build
    from repro_torch.train import checkpoint as ck
    from repro_torch.train import ft, optim
    from repro_torch.train.trainer import make_train_program

    n_pods, n_data = (int(x) for x in args.mesh_shape.split(","))
    mesh = ThreadMesh({"pod": n_pods, "data": n_data}, device=args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    model = build(cfg)
    rc, plan, tp = plan_run(args, mesh, cfg)
    if tp is not None:
        print(plan_line(tp), flush=True)
    prog = make_train_program(model, mesh, rc, plan)
    print(f"arch={cfg.name} params={model.n_params():,} zero={rc.zero_stage} mesh={mesh.shape} "
          f"device={mesh.device} policy={args.policy} mode={prog.comm.resolved_mode()} "
          f"policy_rows={len(prog.comm.table.rows)} shares={plan.micro_per_pod} "
          f"wire_quant={rc.wire_quant} cross_dtype={rc.cross_dtype} "
          f"error_feedback={optim.ef_codec(rc) is not None}", flush=True)
    state = prog.init_fn()
    pipe = DataPipeline(seed=args.seed, plan=plan, dp_world=prog.dp_world(),
                        seq_len=args.seq, vocab=cfg.vocab)
    ckpt_dir = args.ckpt_dir or tempfile.mkdtemp(prefix="repro_torch_train_ckpt_")
    start = ck.latest_step(ckpt_dir)          # a run resumes from the latest
    fresh = start is None
    if fresh:
        start = 0
        ck.save(ckpt_dir, 0, state, prog, blocking=False)
    cuda = mesh.device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(mesh.device)

    def log(step, m):
        print(f"step {step:4d}  loss {m['loss']:.4f}  tokens {int(m['tokens'])}  "
              f"grad_norm {m['grad_norm']:.3f}", flush=True)

    telemetry, cb = None, log
    if args.trace or args.metrics_out:
        from repro_torch import obs
        telemetry = obs.Telemetry(cluster=cluster_for_mesh(mesh, chip_sheets(args.chips)),
                                  out_dir=args.trace, device=args.device,
                                  capacity=FLIGHT_CAPACITY)
        telemetry.bind(comm=prog.comm)
        telemetry.install()
        telemetry.tracer.set_step(start)

        def cb(step, m):
            telemetry.on_step(step, m, dur_s=m.get("step_s"))
            telemetry.probe_step(step)
            telemetry.tracer.set_step(step + 1)     # the next step's dispatches
            log(step, m)
    try:
        state, hist = ft.run_supervised(
            prog.step_fn, state, pipe.batch_at, ckpt_dir=ckpt_dir,
            ckpt_every=args.ckpt_every, n_steps=args.steps, layout=prog,
            start_step=0 if fresh else None,   # a fresh run trusts its init
            monitor=ft.StragglerMonitor(), metrics_cb=cb)
    finally:
        if telemetry is not None:
            telemetry.uninstall()
        if not args.ckpt_dir:
            shutil.rmtree(ckpt_dir, ignore_errors=True)
    if telemetry is not None:
        telemetry.dump_postmortem("end", step=args.steps)   # the run's flight record
        paths = telemetry.write(metrics_out=args.metrics_out)
        paths.update({f"flight {i}": p for i, p in enumerate(telemetry.dump_paths)})
        print(telemetry.step_report())
        for k, path in paths.items():
            print(f"telemetry {k}: {path}")
    tokens = sum(int(h["tokens"]) for h in hist)
    dt = sum(h["step_s"] for h in hist)
    peak = (f", peak memory {torch.cuda.max_memory_allocated(mesh.device) / 2**30:.2f} GiB"
            if cuda else "")
    if hist:
        print(f"done: loss {hist[0]['loss']:.4f} -> {hist[-1]['loss']:.4f}, {tokens} tokens "
              f"in {dt:.2f} s ({tokens / dt:.1f} tokens/s){peak}")
    return {"prog": prog, "state": state, "history": hist, "telemetry": telemetry}


def main(argv=None):
    """The launcher's command line; returns the losses of the steps run."""
    return [h["loss"] for h in run(parser().parse_args(argv))["history"]]


if __name__ == "__main__":
    main()
