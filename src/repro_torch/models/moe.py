"""Mixture-of-Experts: top-k routing with capacity-buffer dispatch.

Counterpart of ``repro/models/moe.py:44-121``.  Dispatch is sort-based: the
token/expert assignments are sorted by expert id (a stable sort, as
``jnp.argsort``) and scattered into an (E, C, D) capacity buffer; assignments
past an expert's capacity ``C = max(int(T * k * capacity_factor / E), 1)``
are dropped to a scratch row (GShard semantics).  The expert FFN is the TACC
op ``expert_ffn``: ``expert_ffn_ref`` here for CPU tensors (the reference's
``cpu`` default), ``kernels.ops.expert_ffn_gmm`` (three grouped-matmul
kernels) for CUDA tensors.

Where the port differs in form, not in function:

* One card has no mesh: the reference's ``_replicated`` pins and the
  ``expert_axis`` sharding constraint place tensors on a TPU mesh and have
  nothing to do here, so they are not ported.
* Top-k is a stable descending sort, which breaks ties toward the lower
  expert index as ``jax.lax.top_k`` does (``torch.topk`` promises nothing on
  ties).
* The combine sums each token's k weighted terms in a fixed order (un-permuted
  to (T, k, D), then an f32 sum over k) where the reference scatter-adds them;
  on CUDA an atomic ``index_add_`` would change bits from run to run for
  k > 2.  Same function; for k <= 2 the same bits.  The dispatch's gradient
  is the same sum (:class:`GatherAssignments`): autograd's own, the backward
  of ``x[tok_of]``, scatter-adds each token's k gradients with atomics in
  x's type (moonshot's k = 6 rounds five times in bf16, in an order that
  changes from run to run).
* Expert counts are taken with ``index_add_`` on integers, not ``bincount``,
  which would synchronise with the host on CUDA to size its output.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

import repro_torch.kernels  # noqa: F401  (registers the "cuda" expert_ffn variant)
from repro_torch.core import tacc


@tacc.register("expert_ffn", "cpu", default=True)
def expert_ffn_ref(buf, w1, w3, w2):
    """SwiGLU over the capacity buffer.  buf (E,C,D); w* (E,D,F)/(E,F,D).

    The activation stays in the compute dtype, as in the reference's ``cpu``
    variant (the ``cuda`` variant takes SiLU in f32, as the reference's
    Pallas path does)."""
    h1 = torch.einsum("ecd,edf->ecf", buf, w1)
    h3 = torch.einsum("ecd,edf->ecf", buf, w3)
    h = F.silu(h1) * h3
    return torch.einsum("ecf,efd->ecd", h, w2)


def route(x, router, top_k: int):
    """Router of ``x (T, D)``: f32 logits (T, E), softmax probabilities,
    the top-k gates renormalised with a 1e-9 floor (T, k), and the expert ids
    (T, k), ties toward the lower id."""
    logits = x.float() @ router.float()
    probs = torch.softmax(logits, dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, expert_idx = vals[:, :top_k], idx[:, :top_k]
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    return logits, probs, gates, expert_idx


class GatherAssignments(torch.autograd.Function):
    """``x[order // k]``: the (T*k, D) rows of the assignments in expert
    order.  The backward un-permutes their gradients to (T, k, D) and sums
    each token's k in f32, in a fixed order, rounded once to x's type (the
    combine's sum; the reference's backward scatter-adds them)."""

    @staticmethod
    def forward(ctx, x, order, k: int):
        ctx.save_for_backward(order)
        ctx.k = k
        return x[order // k]

    @staticmethod
    def backward(ctx, g):
        (order,) = ctx.saved_tensors
        per_assignment = torch.empty_like(g)
        per_assignment[order] = g                      # a permutation: no sums
        T = order.numel() // ctx.k
        return per_assignment.reshape(T, ctx.k, -1).float().sum(1).to(g.dtype), None, None


def dispatch_slots(expert_idx, n_experts: int, capacity: int):
    """Sort-based dispatch of the (T, k) assignments.  Returns, in expert
    order: ``order`` (the stable sort of the flat assignments), ``tok_of``
    (each one's token), ``slot`` (its row in the (E*C,) buffer, E*C for a
    drop) and ``keep``."""
    T, k = expert_idx.shape
    flat_e = expert_idx.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    tok_of = order // k
    counts = torch.zeros(n_experts, dtype=torch.long, device=flat_e.device)
    counts.index_add_(0, flat_e, torch.ones_like(flat_e))
    offsets = torch.cumsum(counts, 0) - counts
    pos = torch.arange(T * k, device=flat_e.device) - offsets[sorted_e]
    keep = pos < capacity
    slot = torch.where(keep, sorted_e * capacity + pos,
                       torch.full_like(pos, n_experts * capacity))
    return order, tok_of, slot, keep


def moe_ffn(x, params, *, n_experts: int, top_k: int, capacity_factor: float,
            router_weight_key: str = "router"):
    """x: (T, D) tokens -> (out (T, D), aux_metrics dict).

    params: {"router": (D, E), "w1": (E, D, F), "w3": (E, D, F), "w2": (E, F, D)}.
    aux: ``moe_aux`` (switch-style load balance), ``moe_z`` (router z-loss),
    ``moe_dropped`` (the share of assignments past capacity), f32 scalars.
    """
    T, D = x.shape
    E, k = n_experts, top_k
    C = max(int(T * k * capacity_factor / E), 1)

    logits, probs, gate_vals, expert_idx = route(x, params[router_weight_key], k)
    order, _, slot, keep = dispatch_slots(expert_idx, E, C)

    buf = torch.zeros((E * C + 1, D), dtype=x.dtype, device=x.device)
    buf[slot] = GatherAssignments.apply(x, order, k)       # drops land on the scratch row
    buf = buf[:-1].reshape(E, C, D)

    out_buf = tacc.dispatch("expert_ffn", buf, params["w1"], params["w3"],
                            params["w2"])                  # (E, C, D)
    out_flat = out_buf.reshape(E * C, D)

    # ---- combine ------------------------------------------------------------
    gathered = out_flat[torch.clamp(slot, max=E * C - 1)]
    gathered = gathered * keep[:, None].to(gathered.dtype)
    gates_sorted = gate_vals.reshape(-1)[order]
    weighted = gathered * gates_sorted[:, None].to(gathered.dtype)
    per_assignment = torch.empty_like(weighted)
    per_assignment[order] = weighted                       # back to token order
    out = per_assignment.reshape(T, k, D).float().sum(1).to(x.dtype)

    # ---- aux losses (switch-style load balance + router z-loss) -------------
    me = probs.mean(dim=0)
    top1 = torch.zeros(E, dtype=torch.float32, device=x.device)
    top1.index_add_(0, expert_idx[:, 0], torch.ones(T, dtype=torch.float32,
                                                    device=x.device))
    ce = top1 / T
    aux_loss = E * torch.sum(me * ce)
    z_loss = torch.mean(torch.logsumexp(logits, dim=-1) ** 2)
    dropped = 1.0 - keep.float().mean()
    return out, {"moe_aux": aux_loss, "moe_z": z_loss, "moe_dropped": dropped}
