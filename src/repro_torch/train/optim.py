"""AdamW with ZeRO-1 / ZeRO-3 state partitioning, every DP collective
through HetCCL.

Counterpart of ``repro/train/optim.py`` (paper §5.3, Appendix D.4).

* ZeRO-1: parameters are replicated across the data-parallel ranks; the f32
  master copy and the Adam moments are *flat shards*, each DP rank owning
  1/W of every tensor.  Per step: error-feedback compression of the local
  gradients when a wire codec resolves (DESIGN.md §17), then HetCCL
  ``tree_all_reduce`` of the gradients, the local shard update, and a HetCCL
  ``all_gather`` of the updated parameters (Table 3: "All-Gather (OS),
  All-Reduce (G)").
* ZeRO-3: parameters, master copy and moments are all shard-shaped (the
  "embed" dim split over "data", ``models.common.fsdp_dim``); the forward
  gathers parameters per block and the gradients arrive reduce-scattered
  over "data" (``core.collectives.fsdp_all_gather``), so the step finishes
  the reduction over "pod" and updates the shards in place of gathering.

Every function here is per-rank code: it runs inside a mesh of ranks
(``core.mesh``), as the reference's runs inside the train ``shard_map``.
The Adam update writes its moments and master copy in place: a step's state
is donated to it, as the reference's jitted step donates its state
(``donate_argnums``), and the port keeps one copy of the optimizer state on
the card instead of two.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import RunConfig
from repro_torch.core import hetccl, mesh
from repro_torch.core.tree import flatten, leaves, tree_map
from repro_torch.kernels import quant


def ef_codec(rc: RunConfig) -> str | None:
    """The wire codec error feedback compensates for, or None when EF is off.

    ``rc.error_feedback``: "auto" enables EF iff the gradient reductions
    quantize (a ``wire_quant`` codec on the large reduce_scatter /
    all_reduce rows once ``rc.wire_quant`` is composed into the table, or
    the facade's codec under ``backend="pallas"``); "on" also requires a
    codec to resolve; "off" disables EF (quantize without compensation).
    """
    if rc.error_feedback not in ("auto", "on", "off"):
        raise ValueError(f"unknown error_feedback {rc.error_feedback!r}; "
                         "expected 'auto', 'on' or 'off'")
    if rc.error_feedback == "off":
        return None
    codec = None
    if rc.policies is not None:
        table = rc.policies.with_wire_quant(rc.wire_quant)
        for op in ("reduce_scatter", "all_reduce"):
            p = table.lookup(op, "large")
            if p.backend == "pallas" and p.wire_quant:
                codec = p.wire_quant
                break
    elif rc.wire_quant and rc.backend == "pallas":
        codec = rc.wire_quant
    if codec is None and rc.error_feedback == "on":
        raise ValueError("error_feedback='on' but no wire_quant codec resolves: set "
                         "RunConfig.wire_quant (with backend='pallas') or plan a policy "
                         "table with quantized gradient rows")
    return codec


def ef_init(params):
    """Rank-local EF residuals: one flat f32 zero array per parameter leaf,
    the full leaf's size (each rank keeps the error of its own
    contribution)."""
    return tree_map(lambda p: torch.zeros(p.numel(), dtype=torch.float32,
                                          device=p.device), params)


def ef_apply(grads, residuals, codec: str):
    """Per-leaf error-feedback compression before the quantized collective:
    each local gradient is projected onto the codec's grid
    (:func:`quant.ef_compress` of ``g + residual``) and the projection error
    becomes the new residual.  Returns ``(compressed_grads, new_residuals)``."""
    gs, rebuild = flatten(grads)
    pairs = [quant.ef_compress(g.float().reshape(-1), r, codec=codec)
             for g, r in zip(gs, leaves(residuals))]
    return (rebuild([c.reshape(g.shape) for (c, _), g in zip(pairs, gs)]),
            rebuild([r for _, r in pairs]))


def dp_rank_and_world(dp_axes: tuple[str, ...]) -> tuple[int, int]:
    """Flat DP rank and world size of the calling rank; ``dp_axes``
    pod-major, so the rank order is HetCCL's all_gather order."""
    rank, world = 0, 1
    for a in dp_axes:
        n = mesh.axis_size(a)
        rank = rank * n + mesh.axis_index(a)
        world *= n
    return rank, world


def _pad_len(n: int, w: int) -> int:
    return -(-n // w) * w


def _f32(x: float, like) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=like.device)


# Elements per piece of an Adam update: the update is elementwise, so it runs
# over the flat leaf in pieces of this size, and its f32 temporaries stay a
# piece's size whatever the leaf's (four ranks of moonshot's 1.34 GB f32
# embedding share one card).
ADAM_PIECE = 1 << 24


def adam_update(g, m, v, master, step: int, rc: RunConfig, decay_mask: float = 1.0,
                scale=None):
    """One AdamW update in f32, all arguments shard-shaped; ``step`` is the
    number of updates before this one; ``scale`` (optional) multiplies the
    f32 gradient first (the clip).  The bias corrections are taken in f32,
    as the reference takes them from its f32 step counter.  ``m``, ``v`` and
    ``master`` (f32, contiguous) are updated in place, a piece of
    ``ADAM_PIECE`` elements at a time, and returned as ``(master, m, v)``:
    each in-place op is the functional op it replaces, and every op is
    elementwise, so the numbers are the same bits."""
    n = g.numel()
    if n > ADAM_PIECE:
        flat = [g.reshape(-1), m.view(-1), v.view(-1), master.view(-1)]
        for lo in range(0, n, ADAM_PIECE):
            _adam_piece(*(t[lo:lo + ADAM_PIECE] for t in flat), step, rc, decay_mask, scale)
    else:
        _adam_piece(g, m, v, master, step, rc, decay_mask, scale)
    return master, m, v


def _adam_piece(g, m, v, master, step, rc, decay_mask, scale):
    g = g.float() if scale is None else g.float() * scale
    m.mul_(rc.beta1).add_((1 - rc.beta1) * g)
    v.mul_(rc.beta2).add_((1 - rc.beta2) * g * g)
    t = _f32(step + 1.0, g)
    mhat = m / (1 - torch.pow(_f32(rc.beta1, g), t))
    vhat = v / (1 - torch.pow(_f32(rc.beta2, g), t))
    upd = mhat / (torch.sqrt(vhat) + rc.eps) + rc.weight_decay * decay_mask * master
    master.sub_(rc.learning_rate * upd)


# ---------------------------------------------------------------------------
# ZeRO-1: flat-sharded optimizer state
# ---------------------------------------------------------------------------

def _shard_of(flat, rank: int, world: int):
    pad = _pad_len(flat.numel(), world) - flat.numel()
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))
    n = flat.numel() // world
    return flat[rank * n:(rank + 1) * n]


def zero1_init_opt(params, dp_world: int):
    """Zero f32 moments, each 1/W of its tensor; ``"master"`` is filled by
    :func:`zero1_master_from_params`."""
    def one(p):
        return torch.zeros(_pad_len(p.numel(), dp_world) // dp_world,
                           dtype=torch.float32, device=p.device)

    return {"m": tree_map(one, params), "v": tree_map(one, params), "master": None}


def zero1_master_from_params(params, dp_axes):
    """This rank's flat f32 master shard of every parameter."""
    rank, world = dp_rank_and_world(dp_axes)
    return tree_map(lambda p: _shard_of(p.reshape(-1).float(), rank, world).clone(),
                    params)


def zero1_step(params, grads, opt, step: int, rc: RunConfig, comm):
    """Full ZeRO-1 step.  ``grads``: this rank's un-reduced gradient sums
    (scaled by 1/tokens); the caller may hand them over (the trainer does),
    so that they are freed once reduced.  Returns ``(new_params, new_opt, grad_norm)``.
    ``comm``: the program's communicator (or a ``HetCCLConfig``); every
    collective resolves its policy from it."""
    rank, world = dp_rank_and_world(comm.dp_axes())
    ef = opt.get("ef")
    if ef is not None:
        grads, ef = ef_apply(grads, ef, ef_codec(rc))
    grads = hetccl.tree_all_reduce(grads, comm)

    gnorm = global_norm(grads)
    scale = clip_scale(gnorm, rc.grad_clip)
    gs = leaves(grads)
    del grads                       # each gradient goes once its shard is read

    def one(p, g, m, v, master):
        decay = 0.0 if p.dim() <= 1 else 1.0          # no decay on norms/biases
        new_master, m, v = adam_update(_shard_of(g.reshape(-1), rank, world), m, v, master,
                                       step, rc, decay, scale)
        # the parameter AllGather (the ZeRO-1 optimizer-state gather, Table 3)
        full = hetccl.all_gather(new_master.to(p.dtype), comm, dim=0)
        return full[:p.numel()].reshape(p.shape), m, v, new_master

    ps, rebuild = flatten(params)
    out = [one(p, _popped(gs, i), m, v, master) for i, (p, m, v, master) in enumerate(
        zip(ps, leaves(opt["m"]), leaves(opt["v"]), leaves(opt["master"])))]
    new_opt = {"m": rebuild([o[1] for o in out]), "v": rebuild([o[2] for o in out]),
               "master": rebuild([o[3] for o in out])}
    if ef is not None:
        new_opt["ef"] = ef
    return rebuild([o[0] for o in out]), new_opt, gnorm


def _popped(items: list, i: int):
    """``items[i]``, the list's reference dropped: a donated gradient's memory
    goes as soon as its update has read it, not at the end of the step."""
    item, items[i] = items[i], None
    return item


# ---------------------------------------------------------------------------
# ZeRO-3: shard-shaped optimizer state, cross-pod ring on gradients
# ---------------------------------------------------------------------------

def zero3_init_opt(params):
    """m / v zeros and an f32 master copy, in the (already sharded)
    parameter shapes."""
    return {"m": tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                device=p.device), params),
            "v": tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                device=p.device), params),
            "master": tree_map(lambda p: p.to(torch.float32, copy=True), params)}


def zero3_step(params, grads, opt, step: int, rc: RunConfig, comm, fsdp_leaf_mask):
    """Full ZeRO-3 step.  ``grads``: this rank's shard-shaped gradient sums
    (scaled by 1/tokens), the fsdp leaves already reduce-scattered over
    "data" (the ``fsdp_all_gather`` adjoint); ``fsdp_leaf_mask``: a bool per
    leaf, True where it is sharded.  The reduction left:

    * fsdp leaves: all-reduce over "pod" only (HetCCL's cross stage);
    * replicated leaves: all-reduce over ("pod", "data").

    Error feedback, when a codec resolves, compensates the pod-stage ring on
    the shards (the fsdp reduce-scatter quantizes inside the backward, out
    of its reach, as in the reference).  Returns ``(new_params, new_opt,
    grad_norm)``."""
    pod_comm = dataclasses.replace(comm, local_axes=())
    ef = opt.get("ef")
    if ef is not None:
        grads, ef = ef_apply(grads, ef, ef_codec(rc))

    def sync(g, is_fsdp):
        if comm.pod_axis:
            return hetccl.all_reduce(g, pod_comm if is_fsdp else comm)
        return g if is_fsdp else hetccl.all_reduce(g, comm)

    gs, rebuild = flatten(grads)
    del grads                       # a reduced leaf replaces its sum, one at a time
    mask = leaves(fsdp_leaf_mask)
    for i, f in enumerate(mask):
        gs[i] = sync(gs[i], f)
    gnorm = global_norm_sharded(gs, mask, comm)
    scale = clip_scale(gnorm, rc.grad_clip)

    def one(p, g, m, v, master):
        decay = 0.0 if p.dim() <= 1 else 1.0
        new_master, m, v = adam_update(g, m, v, master, step, rc, decay, scale)
        return new_master.to(p.dtype), m, v, new_master

    out = [one(p, _popped(gs, i), m, v, master) for i, (p, m, v, master) in enumerate(
        zip(leaves(params), leaves(opt["m"]), leaves(opt["v"]), leaves(opt["master"])))]
    new_opt = {"m": rebuild([o[1] for o in out]), "v": rebuild([o[2] for o in out]),
               "master": rebuild([o[3] for o in out])}
    if ef is not None:
        new_opt["ef"] = ef
    return rebuild([o[0] for o in out]), new_opt, gnorm


# ---------------------------------------------------------------------------
# Gradient norms / clipping
# ---------------------------------------------------------------------------

def global_norm(tree):
    """sqrt of the sum of squares of every leaf, f32 (a 0-dim tensor)."""
    return torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in leaves(tree)))


def global_norm_sharded(tree, fsdp_leaf_mask, comm):
    """The norm when the fsdp leaves are distinct shards per "data" rank:
    their squares summed over the local axes, the replicated leaves' not."""
    gs = leaves(tree)
    dev = gs[0].device
    sq_sharded = torch.zeros((), dtype=torch.float32, device=dev)
    sq_repl = torch.zeros((), dtype=torch.float32, device=dev)
    for g, is_fsdp in zip(gs, leaves(fsdp_leaf_mask)):
        s = torch.sum(torch.square(g.float()))
        if is_fsdp:
            sq_sharded = sq_sharded + s
        else:
            sq_repl = sq_repl + s
    if comm.local_axes:
        sq_sharded = mesh.psum(sq_sharded, comm.local_axes)
    return torch.sqrt(sq_sharded + sq_repl)


def clip_scale(gnorm, max_norm: float):
    """min(1, max_norm / (gnorm + 1e-6)), or 1 when ``max_norm`` is 0."""
    if not max_norm:
        return torch.ones((), dtype=torch.float32, device=gnorm.device)
    return torch.clamp(max_norm / (gnorm + 1e-6), max=1.0)
