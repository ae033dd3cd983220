"""Dry run of the port's production meshes: one step of every (arch x shape
x mesh) cell, shape-only, on the ``meta`` device.

Counterpart of ``repro/launch/dryrun.py``, which lowers and compiles every
cell for 512 forced host devices and reads XLA's memory and cost analyses.
The port has no compiler to ask; it runs the step itself, on ``meta``,
which is the nature of a dry run: no chip, no data.

* A train cell builds the train program on ``launch.mesh.
  make_production_mesh`` (a ``ShapeMesh``: one rank per island runs, the
  islands' shares may differ under ``--plan auto``), whose collectives are
  shape-only stand-ins; every collective resolves its policy through the
  communicator's table as usual, and each stage it runs is recorded (kind,
  group, bytes, whether it crosses an island) by the step counter.
* A serve cell is one card serving the whole batch: a prefill of
  ``global_batch x seq_len``, or one decode step on a cache of ``seq_len``.

Each cell reports the step's roofline terms on the H100 sheet
(``roofline.hw.H100``, one chip per rank), ``model_flops_spec`` (the
reference's, copied exactly), the per-rank state bytes (exact: the live
rank's tensors), the live-tensor high-water mark of the step above that
state, and whether the two fit the card's HBM.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch smollm-135m --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--mesh both] [--out DIR]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --plan auto   # the planner's config

``--out`` defaults to ``build/dryrun`` (ignored by git); ``results/dryrun/``
holds the reference's records.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback

import numpy as np
import torch

from repro_torch import plan as plan_mod
from repro_torch.configs import ARCH_IDS, SHAPES, get_config
from repro_torch.configs.base import ModelConfig, RunConfig, ShapeConfig
from repro_torch.core.balance import uniform_plan
from repro_torch.core.tree import flatten, leaves
from repro_torch.launch.mesh import cluster_for_mesh, make_production_mesh, mesh_axis_sizes
from repro_torch.models import build
from repro_torch.models.common import meta_leaves
from repro_torch.roofline import analysis, hw

DEFAULT_OUT = "build/dryrun"


def model_flops_spec(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """Spec formula: 6·N·D (train) / 2·N·D (inference), N = active params
    excluding the embedding table, D = tokens in the step."""
    n = cfg.n_active_params() - cfg.vocab * cfg.d_model   # embed lookup isn't matmul
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n * tokens
    return 2.0 * n * shape.global_batch                    # decode: one token/seq


def meta_params(model, dtype: torch.dtype):
    """The model's parameter tree as meta tensors of ``dtype``."""
    metas = model.abstract_params()
    _, rebuild = flatten(metas)
    return rebuild([torch.empty(tuple(m.shape), dtype=dtype, device="meta")
                    for m in meta_leaves(metas)])


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in leaves(tree)
               if isinstance(t, torch.Tensor))


def _train_config(cfg, shape, mesh, zero, plan_mode, backend, stripes, policy, rec, verbose):
    """(rc, plan) of a train cell: the reference's manual micro-batching or
    the planner's choice (``--plan auto``), with its policy table."""
    sizes = mesh_axis_sizes(mesh)
    n_pods = sizes.get("pod", 1)
    dp = mesh.size
    if shape.global_batch % dp:
        raise ValueError(f"global batch {shape.global_batch} over {dp} ranks")
    cluster = cluster_for_mesh(mesh)
    space = plan_mod.DEFAULT_SPACE
    if backend != "auto":
        space = dataclasses.replace(space, backends=(backend,))
    if stripes != "auto":
        space = dataclasses.replace(space, stripe_counts=(int(stripes),))
    if plan_mode == "auto":
        req = plan_mod.plan_request(cluster, cfg, shape.global_batch, shape.seq_len,
                                    data_axis=sizes.get("data", 1), zero_stage=zero)
        if policy == "flat":
            space = dataclasses.replace(space, modes=("flat",), backends=("xla",), per_op=False)
        elif policy == "legacy":
            space = dataclasses.replace(space, per_op=False)
        tp = (plan_mod.autotune_policies(req, space) if policy == "auto"
              else plan_mod.autotune(req, space))
        rec["plan"] = tp.summary()
        if verbose:
            n_rows = len(tp.policies.rows) if tp.policies is not None else 0
            print(f"  plan auto: mode={tp.mode} backend={tp.backend} C={tp.n_channels} "
                  f"stripes={tp.n_stripes} bucket={tp.bucket_bytes >> 20}MiB "
                  f"policy_rows={n_rows} shares={tp.plan.micro_per_pod} "
                  f"modeled_step={tp.modeled_step_s:.4f}s")
        return tp.run_config(), tp.plan
    # ~8k tokens per rank per micro-step, as the reference
    per_dev = shape.global_batch // dp
    mb = max(1, min(per_dev, 8192 // shape.seq_len))
    plan = uniform_plan(n_pods, (per_dev // mb) * n_pods, mb)
    rbackend = backend if backend != "auto" else "xla"
    rc = RunConfig(zero_stage=zero,
                   collective_mode="flat" if policy == "flat" else
                   ("hier" if n_pods > 1 else "flat"),
                   backend=rbackend, n_stripes=1 if stripes == "auto" else int(stripes))
    if policy == "auto":
        rc = dataclasses.replace(rc, policies=plan_mod.policy_table_for(
            cluster, space, bucket_bytes=rc.bucket_bytes, zero_stage=zero))
        rec["policy_table"] = rc.policies.summary()
    return rc, plan


def run_cell(arch: str, shape_name: str, mesh_kind: str, zero: int = 3,
             verbose: bool = True, plan_mode: str = "manual", backend: str = "auto",
             stripes: str = "auto", policy: str = "auto", trace_out: str | None = None,
             cfg: ModelConfig | None = None, shape_cfg: ShapeConfig | None = None) -> dict:
    """One cell's record (``status`` "ok", "skipped" or "FAILED").  ``cfg``
    and ``shape_cfg`` replace the registry's config of ``arch`` and shape
    ``shape_name`` (tests pass reduced ones).  Parameters take the config's
    dtype (bf16 at full size, as the reference's ``RunConfig``)."""
    cfg = cfg or get_config(arch)
    shape = shape_cfg or SHAPES[shape_name]
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_kind, "zero": zero,
           "policy": policy}
    if not shape.applicable(cfg):
        rec["status"] = "skipped"
        rec["reason"] = "long_500k requires sub-quadratic attention (DESIGN.md §4)"
        return rec
    model = build(cfg)
    t0 = time.time()
    try:
        if shape.kind == "train":
            from repro_torch.train.trainer import make_train_program
            mesh = make_production_mesh(multi_pod=mesh_kind == "multi")
            rc, plan = _train_config(cfg, shape, mesh, zero, plan_mode, backend, stripes,
                                     policy, rec, verbose)
            rc = dataclasses.replace(rc, param_dtype=cfg.dtype)
            if trace_out is not None:
                # the modeled trace of the cell: one span per policy-table row
                # priced by the simulator (nothing runs on a chip in a dry run)
                from repro_torch import obs
                cl = cluster_for_mesh(mesh)
                table = rc.policies if rc.policies is not None else plan_mod.policy_table_for(cl)
                obs.write_chrome_trace(trace_out, obs.chrome_trace(obs.modeled_spans(table, cl)))
                rec["trace"] = trace_out
            # one run for the islands of equal shares (the same live micro-steps)
            first = {}
            mesh.same_pods([first.setdefault(tuple(row), p)
                            for p, row in enumerate(plan.live_mask())])
            prog = make_train_program(model, mesh, rc, plan)
            states = prog.init_fn(meta_params(model, getattr(torch, rc.param_dtype)))
            nm, rows = prog.batch_shape(shape.seq_len)[:2]
            batch = {k: np.zeros((nm, rows, shape.seq_len), np.int64)
                     for k in ("tokens", "labels")}
            state_bytes = max(_nbytes(states[r]) for r in mesh.live)
            n_dev = mesh.size
            with analysis.counting(live=True) as sc:
                prog.step_fn(states, batch)
            count = analysis.StepCount({r: sc.ranks[r] for r in mesh.live},
                                       {r: sc.live[r] for r in mesh.live})
        else:
            from repro_torch.serve.engine import make_serve_programs
            n_dev = 1
            params = meta_params(model, getattr(torch, cfg.dtype))
            state_bytes = _nbytes(params)
            B, S = shape.global_batch, shape.seq_len
            progs = make_serve_programs(model, S, device="meta")
            with analysis.counting(live=True) as sc:
                if shape.kind == "prefill":
                    progs.prefill_fn(params, {"tokens": torch.zeros((B, S), dtype=torch.long,
                                                                    device="meta")})
                else:
                    cache = progs.init_cache(B, S)
                    state_bytes += _nbytes(cache)
                    progs.decode_fn(params, cache, torch.zeros((B, 1), dtype=torch.long,
                                                               device="meta"))
            count = sc
        live_peak = max(lb.peak for lb in count.live.values())
        roof = analysis.roofline_of(count, arch=arch, shape=shape_name, mesh=mesh_kind,
                                    model_flops=model_flops_spec(cfg, shape), sheet=hw.H100,
                                    n_devices=n_dev,
                                    memory_per_device={"state_bytes": state_bytes,
                                                       "live_peak_bytes": live_peak})
        rec.update(status="ok", run_s=round(time.time() - t0, 1), **roof.row(),
                   state_bytes_per_rank=state_bytes, live_peak_bytes=live_peak,
                   fits=state_bytes + live_peak <= hw.H100.hbm_bytes, hw=hw.H100.name)
        if verbose:
            print(f"  roofline (H100): compute={roof.compute_s:.4f}s memory={roof.memory_s:.4f}s "
                  f"collective={roof.collective_s:.4f}s dominant={roof.dominant} "
                  f"useful={roof.useful_flops_fraction:.2f} "
                  f"roofline_frac={roof.roofline_fraction:.3f}")
            print(f"  state {state_bytes / 2**30:.2f} GiB per rank, live peak "
                  f"{live_peak / 2**30:.2f} GiB, fits={rec['fits']}")
    except Exception as e:
        rec["status"] = "FAILED"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc(limit=12)
    return rec


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="both", choices=["single", "multi", "both"])
    ap.add_argument("--zero", type=int, default=3)
    ap.add_argument("--plan", default="manual", choices=["manual", "auto"],
                    help="auto: repro_torch.plan picks mode/backend/channels/bucket/shares "
                         "(train cells)")
    ap.add_argument("--backend", default="auto", choices=["auto", "xla", "pallas"],
                    help="pin the ring backend; auto lets --plan auto search it (manual "
                         "plans: xla).  Pinned runs get a __<backend> file suffix")
    ap.add_argument("--stripes", default="auto",
                    help="stripes of the pallas rings: auto = planner-chosen; an integer "
                         "pins it")
    ap.add_argument("--policy", default="auto", choices=["auto", "flat", "legacy"],
                    help="auto = per-op, size-classed PolicyTable; legacy = the "
                         "single-policy facade; flat = flat everywhere")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--trace", action="store_true",
                    help="also write a modeled Chrome trace per train cell "
                         "(<out>/<tag>.trace.json): one span per policy-table row priced by "
                         "the simulator")
    ap.add_argument("--metrics-out", default=None, metavar="PATH",
                    help="append one unified-schema metric line per cell (kind=dryrun_cell) "
                         "to this JSONL file")
    return ap


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    archs = ARCH_IDS if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    os.makedirs(args.out, exist_ok=True)
    failures = 0
    for arch in archs:
        for shape in shapes:
            for mesh_kind in meshes:
                tag = f"{arch}__{shape}__{mesh_kind}"
                if args.backend != "auto":
                    tag += f"__{args.backend}"
                print(f"=== {tag} ===", flush=True)
                trace_out = os.path.join(args.out, tag + ".trace.json") if args.trace else None
                rec = run_cell(arch, shape, mesh_kind, args.zero, plan_mode=args.plan,
                               backend=args.backend, stripes=args.stripes,
                               policy=args.policy, trace_out=trace_out)
                with open(os.path.join(args.out, tag + ".json"), "w") as f:
                    json.dump(rec, f, indent=1)
                if args.metrics_out:
                    from repro_torch.obs import append_metric_line, metric_line
                    append_metric_line(args.metrics_out, metric_line(
                        "dryrun_cell",
                        labels={"arch": arch, "shape": shape, "mesh": mesh_kind,
                                "zero": args.zero, "policy": args.policy},
                        metrics={k: v for k, v in rec.items()
                                 if isinstance(v, (int, float)) and not isinstance(v, bool)},
                        meta={"status": rec["status"]}))
                print(f"  -> {rec['status']} ({rec.get('run_s', '-')}s)", flush=True)
                if rec["status"] == "FAILED":
                    failures += 1
                    print(rec.get("traceback", rec.get("error")), flush=True)
    print(f"DONE failures={failures}")
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
