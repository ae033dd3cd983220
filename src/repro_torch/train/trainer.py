"""The data-parallel training step (ZeRO-1) over a mesh of ranks.

Counterpart of ``repro/train/trainer.py``.  The reference runs one
``shard_map`` whose manual axes are the data-parallel ("pod", "data") axes;
the port runs the same per-rank body on a mesh of ranks (``core.mesh``): a
:class:`~repro_torch.core.mesh.ThreadMesh` (every rank a thread, one device)
or a :class:`~repro_torch.core.mesh.DistMesh` (one process per rank).

One step per rank: ``n_micro_max`` micro-steps, each weighted by the plan's
live mask for the rank's island (a masked micro-step is computed and
multiplied by 0, as the reference's ``lax.scan`` does), gradients summed in
f32; then ``psum`` of the token count and the loss over every DP rank, the
gradients scaled by 1/tokens, and :func:`optim.zero1_step` (EF compression,
HetCCL ``tree_all_reduce``, the shard update, HetCCL ``all_gather``).

The collectives run after ``backward`` and never inside autograd: autograd
runs CUDA backward work on its own thread, which belongs to no mesh rank.
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
from repro_torch.core.tree import flatten, tree_map
from repro_torch.models.registry import Model
from repro_torch.train import optim


@dataclasses.dataclass
class TrainProgram:
    """A training program bound to (model, mesh, plan, run config).

    ``init_fn(params=None, generator=None)`` builds the train state: on a
    ThreadMesh a list with one state per rank, on a DistMesh this rank's
    state.  A state is ``{"params", "opt", "step"}``.  ``step_fn(state,
    batch)`` takes the global batch (``batch_shape(seq)`` int arrays
    "tokens" and "labels", numpy or torch) and returns ``(state, metrics)``
    with the metrics ("loss", "grad_norm", "tokens") as 0-dim tensors,
    equal on every rank.  ``comm`` is the program's communicator.
    """

    model: Model
    mesh: Any
    rc: RunConfig
    plan: HetPlan
    hcfg: hetccl.HetCCLConfig
    comm: comm_mod.Communicator
    step_fn: Callable
    init_fn: Callable

    def batch_shape(self, seq_len: int) -> tuple[int, int, int]:
        return (self.plan.n_micro_max, self.plan.micro_batch * self.dp_world(), seq_len)

    def dp_world(self) -> int:
        return self.mesh.axis_size(self.hcfg.dp_axes())


def _dp_axes_of(m) -> tuple[tuple[str, ...], str | None]:
    pod = "pod" if "pod" in m.axes else None
    return (("data",) if "data" in m.axes else ()), pod


def make_train_program(model: Model, mesh, rc: RunConfig, plan: HetPlan) -> TrainProgram:
    """The ZeRO-1 program of ``model`` on ``mesh`` (axes "pod" and/or
    "data"), with the communicator built from ``rc``: its policy table when
    ``rc.policies`` is set, else the single-policy facade."""
    if rc.zero_stage != 1:
        raise NotImplementedError(f"zero_stage={rc.zero_stage}: " + optim._ZERO3)
    if model.cfg.family == "moe":
        raise NotImplementedError(
            "MoE training needs the grouped-matmul backward and the aux-loss "
            "gradients, which are not ported yet (ROADMAP A6)")
    if model.cfg.family in ("ssm", "hybrid"):
        raise NotImplementedError(
            f"{model.cfg.family} training needs a backward of the SSD scan kernel, "
            "which is not ported yet (ROADMAP A7)")
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
        table = rc.policies
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

    def rank_init(params):
        params = tree_map(lambda p: p.to(device=device, dtype=param_dtype), params)
        opt = optim.zero1_init_opt(params, dp_world)
        opt["master"] = optim.zero1_master_from_params(params, dp_axes)
        if codec:
            opt["ef"] = optim.ef_init(params)
        return {"params": params, "opt": opt, "step": 0}

    def rank_step(state, batch):
        params, opt, step = state["params"], state["opt"], state["step"]
        live = live_mask[mesh_mod.axis_index(pod_axis) if pod_axis else 0]
        ps, rebuild = flatten(params)
        with torch.inference_mode(False), torch.enable_grad():
            req = [p.detach().requires_grad_() for p in ps]
            p_req = rebuild(req)
            g_acc = [torch.zeros(p.shape, dtype=torch.float32, device=device) for p in ps]
            loss_sum = torch.zeros((), dtype=torch.float32, device=device)
            count = torch.zeros((), dtype=torch.float32, device=device)
            for i in range(plan.n_micro_max):
                w = float(live[i])
                mb = {"tokens": batch["tokens"][i], "labels": batch["labels"][i]}
                ls, cnt, aux = model.loss(p_req, mb, remat=rc.remat)
                grads = torch.autograd.grad((ls + aux * cnt) * w, req)
                g_acc = [a + g.float() for a, g in zip(g_acc, grads)]
                loss_sum = loss_sum + ls.detach() * w
                count = count + cnt * w
        total = mesh_mod.psum(count, dp_axes)
        loss_total = mesh_mod.psum(loss_sum, dp_axes)
        inv = 1.0 / torch.clamp(total, min=1.0)
        grads = rebuild([g * inv for g in g_acc])
        new_params, new_opt, gnorm = optim.zero1_step(params, grads, opt, step, rc, comm)
        metrics = {"loss": loss_total * inv, "grad_norm": gnorm, "tokens": total}
        return {"params": new_params, "opt": new_opt, "step": step + 1}, metrics

    def rank_batch(batch, r: int):
        """Rank r's rows of the global batch: pod-major DP order."""
        mb, i = plan.micro_batch, mesh.axis_index(r, dp_axes)
        return {k: torch.as_tensor(np.asarray(batch[k])[:, i * mb:(i + 1) * mb])
                .to(device=device, dtype=torch.long) for k in ("tokens", "labels")}

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
        if threads:
            outs = mesh.run(rank_step, state,
                            [rank_batch(batch, r) for r in range(mesh.size)])
            return [o[0] for o in outs], outs[0][1]
        return mesh.run(rank_step, state, rank_batch(batch, mesh.rank))

    return TrainProgram(model=model, mesh=mesh, rc=rc, plan=plan, hcfg=hcfg, comm=comm,
                        step_fn=step_fn, init_fn=init_fn)
