"""The data-parallel training step (ZeRO-1 or ZeRO-3) over a mesh of ranks.

Counterpart of ``repro/train/trainer.py``.  The reference runs one
``shard_map`` whose manual axes are the data-parallel ("pod", "data") axes;
the port runs the same per-rank body on a mesh of ranks (``core.mesh``): a
:class:`~repro_torch.core.mesh.ThreadMesh` (every rank a thread, one device)
or a :class:`~repro_torch.core.mesh.DistMesh` (one process per rank).

One step per rank: ``n_micro_max`` micro-steps, each weighted by the plan's
live mask for the rank's island (a masked micro-step is computed and
multiplied by 0, as the reference's ``lax.scan`` does), gradients summed in
f32; then ``psum`` of the token count and the loss over every DP rank, the
gradients scaled by 1/tokens, and the optimizer step:

* ZeRO-1: :func:`optim.zero1_step` (EF compression, HetCCL
  ``tree_all_reduce``, the shard update, HetCCL ``all_gather``);
* ZeRO-3: each rank holds its shard of every leaf whose "embed" dim splits
  over "data" (sliced out of the full init, as the reference's
  ``init_body`` does); the forward gathers them per block (the hybrid:
  its shared block once per forward, a group's blocks at once) through an
  ``FsdpScope``, each micro-step's gathered gradients are reduce-scattered
  into shard-shaped f32 sums (a stacked leaf's slice, a layer's or a
  group's, into that slice of the sum), the replicated leaves' gradients
  come from autograd, and :func:`optim.zero3_step` finishes the reduction
  and updates the shards.

The collectives run on the rank's own thread and never inside autograd:
autograd runs CUDA backward work on its own thread, which belongs to no mesh
rank (``FsdpScope`` says how ZeRO-3's adjoint gets out of it).  Gradients
are summed and scaled in place, and the optimizer state is donated to the
step (``optim``): at llama-1b on one card the four ranks' copies would not
fit twice.  ZeRO-1's f32 sums are views into the buckets of
``hetccl.tree_all_reduce`` (``hetccl.bucket_zeros``), donated to the step,
which reduces them in their own storage: four ranks of moonshot-v1-16b-a3b
(one layer) fit one card so (DESIGN_TORCH.md §19).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from repro_torch import comm as comm_mod
from repro_torch.configs.base import RunConfig
from repro_torch.core import hetccl, mesh as mesh_mod
from repro_torch.core.balance import HetPlan
from repro_torch.core.collectives import FsdpScope
from repro_torch.core.tree import flatten
from repro_torch.models.common import fsdp_dims, make_rules, shard_leaf
from repro_torch.models.registry import Model
from repro_torch.train import optim


@dataclasses.dataclass
class TrainProgram:
    """A training program bound to (model, mesh, plan, run config).

    ``init_fn(params=None, generator=None)`` builds the train state: on a
    ThreadMesh a list with one state per rank, on a DistMesh this rank's
    state.  A state is ``{"params", "opt", "step"}``.  ``step_fn(state,
    batch)`` takes the global batch (``batch_shape(seq)`` int arrays
    "tokens" and "labels", numpy or torch, and the family's extra leaves:
    the VLM's optional ``mrope`` (n_micro, 3, B, S) int positions, without
    which it trains on text-only positions; the encoder-decoder's
    ``frames`` (n_micro, B, n_frames, d_model), floating point, which it
    needs) and returns ``(state, metrics)``
    with the metrics ("loss", "grad_norm", "tokens") as 0-dim tensors,
    equal on every rank.  ``comm`` is the program's communicator;
    ``fsdp_dims`` the dim of each parameter leaf (flatten order) sharded over
    "data", None where it is whole on every rank (ZeRO-1: all None).
    """

    model: Model
    mesh: Any
    rc: RunConfig
    plan: HetPlan
    hcfg: hetccl.HetCCLConfig
    comm: comm_mod.Communicator
    step_fn: Callable
    init_fn: Callable
    fsdp_dims: list | None = None

    def batch_shape(self, seq_len: int) -> tuple[int, int, int]:
        return (self.plan.n_micro_max, self.plan.micro_batch * self.dp_world(), seq_len)

    def dp_world(self) -> int:
        return self.mesh.axis_size(self.hcfg.dp_axes())


def _dp_axes_of(m) -> tuple[tuple[str, ...], str | None]:
    pod = "pod" if "pod" in m.axes else None
    return (("data",) if "data" in m.axes else ()), pod


def _donated(acc: list, rebuild):
    """The tree of ``acc``'s gradient sums, the list emptied: passed straight
    into the optimizer step, it is the step's alone: ZeRO-1's
    ``tree_all_reduce`` writes the reduced values into the sums' own
    buckets, and each sum's memory goes once the update has read it."""
    tree = rebuild(acc)
    acc.clear()
    return tree


# the dim of each batch leaf that holds the global batch's rows (the
# reference's ``extra_batch_specs``: frames (n_micro, B, F, D), mrope
# (n_micro, 3, B, S))
_BATCH_DIM = {"tokens": 1, "labels": 1, "frames": 1, "mrope": 2}


def _batch_leaves(cfg) -> tuple[str, ...]:
    """The batch leaves a step of ``cfg``'s family reads (the reference's
    ``mb_tree``)."""
    extra = {"vlm": ("mrope",), "encdec": ("frames",)}.get(cfg.family, ())
    return ("tokens", "labels", *extra)


def make_train_program(model: Model, mesh, rc: RunConfig, plan: HetPlan) -> TrainProgram:
    """The ZeRO-1 or ZeRO-3 program (``rc.zero_stage``) of ``model`` on
    ``mesh`` (axes "pod" and/or "data"), with the communicator built from
    ``rc``: its policy table when ``rc.policies`` is set (a planner's table;
    a row the port cannot run raises here, ``comm.check_runnable``), else
    the single-policy facade.  ``plan``'s shares may be uneven: an island
    with fewer micro-steps masks the rest, and the loss and gradients weigh
    by the live tokens."""
    if rc.zero_stage not in (1, 3):
        raise ValueError(f"zero_stage={rc.zero_stage}: the stages are 1 and 3")
    local_axes, pod_axis = _dp_axes_of(mesh)
    cross = getattr(torch, rc.cross_dtype) if rc.cross_dtype else None
    hcfg = hetccl.HetCCLConfig(
        mode=rc.collective_mode, local_axes=local_axes, pod_axis=pod_axis,
        cross_dtype=cross, bucket_bytes=rc.bucket_bytes, n_channels=rc.n_channels,
        pipeline_chunk_bytes=rc.pipeline_chunk_bytes, backend=rc.backend,
        n_stripes=rc.n_stripes, wire_quant=rc.wire_quant)
    hcfg.resolved_mode()        # typos fail at build, not inside a step
    hcfg.resolved_stripes()
    if rc.policies is not None:
        table = comm_mod.check_runnable(rc.policies)
        if cross is not None:
            table = table.with_cross_dtype(cross)
        comm = comm_mod.create(local_axes, pod_axis,
                               table=table.with_wire_quant(rc.wire_quant),
                               bucket_bytes=rc.bucket_bytes,
                               pipeline_chunk_bytes=rc.pipeline_chunk_bytes)
    else:
        comm = comm_mod.from_config(hcfg)
    dp_axes = hcfg.dp_axes()
    dp_world = mesh.axis_size(dp_axes)
    if len(plan.micro_per_pod) != (mesh.axis_size(pod_axis) if pod_axis else 1):
        raise ValueError(f"a plan for {len(plan.micro_per_pod)} pods on mesh {mesh.shape}")
    live_mask = plan.live_mask()                      # (n_pods, n_micro_max)
    codec = optim.ef_codec(rc)
    param_dtype = getattr(torch, rc.param_dtype)
    device = mesh.device
    zero3 = rc.zero_stage == 3
    n_data = mesh.axis_size("data") if "data" in mesh.axes else 1
    # ZeRO-3 shards over "data" where the mesh has that axis (the reference's
    # make_rules); per leaf (flatten order) the dim sharded, or None
    rules = make_rules(rc.zero_stage if local_axes else 1, n_data)
    dims = fsdp_dims(model.abstract_params(), rules)
    fsdp_mask = [d is not None for d in dims]

    # a program's init and step are the counterpart of the reference's traced
    # code: an armed watchdog leaves their dispatches alone (hetccl.arm_watchdog)
    @hetccl.unwatched()
    def rank_init(params):
        ps, rebuild = flatten(params)
        ps = [p.to(device=device, dtype=param_dtype) for p in ps]
        if zero3:
            # this rank's shards out of the full init
            idx = mesh_mod.axis_index("data") if local_axes else 0
            params = rebuild([shard_leaf(p, d, idx, n_data) for p, d in zip(ps, dims)])
            opt = optim.zero3_init_opt(params)
        else:
            params = rebuild(ps)
            opt = optim.zero1_init_opt(params, dp_world)
            opt["master"] = optim.zero1_master_from_params(params, dp_axes)
        if codec:
            opt["ef"] = optim.ef_init(params)
        return {"params": params, "opt": opt, "step": 0}

    @hetccl.unwatched()
    def rank_step(state, batch):
        params, opt, step = state["params"], state["opt"], state["step"]
        live = live_mask[mesh_mod.axis_index(pod_axis) if pod_axis else 0]
        ps, rebuild = flatten(params)
        with torch.inference_mode(False), torch.enable_grad():
            req = [p.detach().requires_grad_() for p in ps]
            p_req = rebuild(req)
            fsdp = FsdpScope(req, "data", comm) if any(fsdp_mask) else None
            # ZeRO-1's sums lie in tree_all_reduce's buckets, which it reduces
            # in place; ZeRO-3's are shard-shaped and reduced leaf by leaf
            g_acc = ([torch.zeros(p.shape, dtype=torch.float32, device=device) for p in ps]
                     if zero3 else hetccl.bucket_zeros(ps, comm, dtype=torch.float32))
            loss_sum = torch.zeros((), dtype=torch.float32, device=device)
            count = torch.zeros((), dtype=torch.float32, device=device)
            for i in range(plan.n_micro_max):
                w = float(live[i])
                mb = {k: v[i] for k, v in batch.items()}
                ls, cnt, aux = model.loss(p_req, mb, remat=rc.remat, fsdp=fsdp, rules=rules)
                grads = torch.autograd.grad((ls + aux * cnt) * w, req,
                                            allow_unused=fsdp is not None)
                for a, g in zip(g_acc, grads):
                    if g is not None:                 # fsdp leaves: from the scope
                        a.add_(g)
                del grads
                if fsdp is not None:
                    for (j, layer), g in fsdp.reduce_pending():
                        (g_acc[j] if layer is None else g_acc[j][layer]).add_(g)
                loss_sum = loss_sum + ls.detach() * w
                count = count + cnt * w
        total = mesh_mod.psum(count, dp_axes)
        loss_total = mesh_mod.psum(loss_sum, dp_axes)
        inv = 1.0 / torch.clamp(total, min=1.0)
        for g in g_acc:
            g.mul_(inv)
        if zero3:
            new_params, new_opt, gnorm = optim.zero3_step(
                params, _donated(g_acc, rebuild), opt, step, rc, comm, fsdp_mask)
        else:
            new_params, new_opt, gnorm = optim.zero1_step(
                params, _donated(g_acc, rebuild), opt, step, rc, comm)
        metrics = {"loss": loss_total * inv, "grad_norm": gnorm, "tokens": total}
        return {"params": new_params, "opt": new_opt, "step": step + 1}, metrics

    batch_keys = _batch_leaves(model.cfg)

    def rank_batch(batch, r: int):
        """Rank r's rows of the global batch: pod-major DP order, each leaf
        sliced on its batch dim (``_BATCH_DIM``); token ids and positions as
        int64, ``frames`` in their own floating dtype."""
        mb, i = plan.micro_batch, mesh.axis_index(r, dp_axes)
        out = {}
        for k in batch_keys:
            if k not in batch:
                continue
            a = batch[k]
            a = a if isinstance(a, torch.Tensor) else torch.as_tensor(np.asarray(a))
            a = a.narrow(_BATCH_DIM[k], i * mb, mb)
            out[k] = a.to(device=device, dtype=a.dtype if k == "frames" else torch.long)
        return out

    threads = isinstance(mesh, mesh_mod.ThreadMesh)

    def init_fn(params=None, generator: torch.Generator | None = None):
        """Every rank's initial state from ``params`` (a host or device tree,
        e.g. ``convert.params_from_jax``), or from ``model.init(generator)``."""
        if params is None:
            if generator is None:
                generator = torch.Generator(device=device).manual_seed(rc.seed)
            params = model.init(generator, dtype=param_dtype)
        if threads:
            return mesh.run(rank_init, [params] * mesh.size)
        return mesh.run(rank_init, params)

    def step_fn(state, batch):
        if model.cfg.family == "encdec" and "frames" not in batch:
            raise ValueError(f"{model.cfg.name}: the batch has no 'frames' leaf (n_micro, B, "
                             f"n_frames, d_model), which the encoder reads")
        if threads:
            outs = mesh.run(rank_step, state,
                            [rank_batch(batch, r) for r in range(mesh.size)])
            return [o[0] for o in outs], outs[0][1]
        return mesh.run(rank_step, state, rank_batch(batch, mesh.rank))

    return TrainProgram(model=model, mesh=mesh, rc=rc, plan=plan, hcfg=hcfg, comm=comm,
                        step_fn=step_fn, init_fn=init_fn, fsdp_dims=dims)


def rebuild_program(prog: TrainProgram, mesh, rc: RunConfig | None = None,
                    plan: HetPlan | None = None) -> TrainProgram:
    """``prog``'s model on a new mesh: the elastic path's rebuild
    (``repro_torch.elastic``, DESIGN.md §13; the reference's
    ``trainer.py:272-287``).

    The run knobs carry over from ``prog`` unless the re-planned ``rc`` and
    ``plan`` (``ft.replan_auto`` or ``ft.replan``) are passed.  The new
    program builds a new communicator, the reference's communicator
    rebuild; its collective axes come from the new mesh, so a one-pod
    survivor mesh has no pod axis and the communicator degrades to flat.
    The fused rings' kept flags are per (device, rank count): a rebuild on
    the same ranks reuses them, a survivor mesh of another size gets its
    own (``kernels.ring_dma``)."""
    return make_train_program(prog.model, mesh, rc or prog.rc, plan or prog.plan)
