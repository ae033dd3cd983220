"""Rank bodies for the tests that spawn a DistMesh of processes
(``repro_torch.launch.mesh.spawn_dist_mesh``), on the CPU and on the card.

Kept apart from the test modules that import JAX: a spawned rank imports
the module that holds its function, and these need torch and the port
alone (the card's machine has no JAX).  The module holds no test.
"""
import time

import numpy as np
import torch

from repro_torch.core import tacc
from repro_torch.kernels import peer


def peer_rings(m, rs_inputs, ag_inputs, cases):
    """Every case ``(wire, stripes, direction)`` of the ring reduce-scatter
    and all-gather on this rank, through the per-rank route (the ``fused``
    variant pinned: its plain version over the shared-memory arena) and
    through the emulated schedule (gloo's hops), as numpy arrays."""
    from repro_torch.kernels import ring_dma
    x = torch.from_numpy(rs_inputs[m.rank])
    v = torch.from_numpy(ag_inputs[m.rank])
    n = m.axis_size("pod")
    out = {}

    def run():
        for wire, S, d in cases:
            w = getattr(torch, wire)
            chunks = x.reshape((n, x.shape[0] // n) + tuple(x.shape[1:]))
            out[("rs", wire, S, d)] = tacc.dispatch(
                "ring_reduce_scatter", chunks, "pod", d, w, S, variant="fused").numpy()
            out[("rs_emulated", wire, S, d)] = ring_dma.ring_reduce_scatter(
                x, "pod", direction=d, wire_dtype=w, n_stripes=S).numpy()
            if wire == "float32":
                out[("ag", S, d)] = tacc.dispatch(
                    "ring_all_gather", v, "pod", d, S, variant="fused").reshape(
                        (n * v.shape[0],) + tuple(v.shape[1:])).numpy()
                out[("ag_emulated", S, d)] = ring_dma.ring_all_gather(
                    v, "pod", direction=d, n_stripes=S).numpy()

    before = (ring_dma.rs_launches, ring_dma.ag_launches)
    m.run(run)
    assert (ring_dma.rs_launches, ring_dma.ag_launches) == before   # CPU: no kernel
    out["seq"] = peer.arena_for(m, "pod").seq
    return out


def peer_faults(m):
    """Three faults of the per-rank route on the CPU, in order.  After a
    good call (which sizes the arena), the last rank withholds one call and
    every other rank must raise.  Then, on a new arena, the first rank calls
    an all-gather where the others call a reduce-scatter, and the start
    handshake must name it.  Then, on a new arena, the last rank withholds
    a call that grows the arena: the others must raise at the host meeting
    that grows it, within ``peer.MEET_TIMEOUT_S`` (lowered here to 3 s),
    and every rank must find the arena broken when it closes it.  Returns {fault: (outcome,
    seconds)} for this rank."""
    import torch.distributed as dist

    from repro_torch.kernels import ring_dma
    out = {}
    x = torch.ones(m.axis_size("pod"), 64)
    last = m.rank == m.size - 1
    arena = peer.arena_for(m, "pod")
    ring_dma.reduce_scatter_peer(x, arena)
    dist.barrier()
    t0 = time.monotonic()
    if last:
        out["withheld"] = ("withheld", 0.0)
    else:
        try:
            ring_dma.reduce_scatter_peer(x, arena)
            out["withheld"] = ("no error", time.monotonic() - t0)
        except ring_dma.RingProtocolError as e:
            out["withheld"] = (str(e), time.monotonic() - t0)
    dist.barrier()
    peer.close_arenas()                 # a broken ring: a new arena, counting from 0
    arena = peer.arena_for(m, "pod")
    arena.ensure(1 << 20, 1 << 20)      # both calls' sizes, so that neither grows it
    dist.barrier()
    t0 = time.monotonic()
    try:
        if m.rank == 0:
            ring_dma.all_gather_peer(x[0], arena)
        else:
            ring_dma.reduce_scatter_peer(x, arena)
        out["order"] = ("no error", time.monotonic() - t0)
    except ring_dma.RingProtocolError as e:
        out["order"] = (str(e), time.monotonic() - t0)
    dist.barrier()
    peer.close_arenas()
    peer.MEET_TIMEOUT_S = 3.0
    arena = peer.arena_for(m, "pod")
    ring_dma.reduce_scatter_peer(x, arena)
    big = torch.ones(m.axis_size("pod"), 1 << 19)   # 2 MiB of partials a rank: it grows
    dist.barrier()
    t0 = time.monotonic()
    if last:
        out["grow"] = ("withheld", 0.0)
    else:
        try:
            ring_dma.reduce_scatter_peer(big, arena)
            out["grow"] = ("no error", time.monotonic() - t0)
        except ring_dma.RingProtocolError as e:
            out["grow"] = (str(e), time.monotonic() - t0)
    dist.barrier()
    peer.close_arenas()                 # no meeting: every rank finds the arena broken
    out["grow_broken"] = arena.broken
    return out


def train_with_checkpoints(m, params, zero: int, ckpt_from: str, ckpt_to: str):
    """One step of a reduced smollm-135m on this DistMesh, a checkpoint of it
    in ``ckpt_to``, then a resume from ``ckpt_from`` (a ThreadMesh's
    checkpoint at the same step) and one more step.  Returns the loss of
    each step and this rank's state leaves after the resumed step."""
    from repro_torch.configs import get_config
    from repro_torch.core import balance
    from repro_torch.core.tree import leaves
    from repro_torch.data.pipeline import synthetic_batch
    from repro_torch.models import build
    from repro_torch.train import checkpoint
    from repro_torch.train.trainer import make_train_program
    cfg = get_config("smollm-135m").reduced()
    prog = make_train_program(build(cfg), m, dist_train_rc(zero),
                              balance.uniform_plan(m.shape["pod"], 2, 1))
    nm, gmb, _ = prog.batch_shape(32)
    state = prog.init_fn(params)
    state, met0 = prog.step_fn(state, synthetic_batch(0, 0, nm, gmb, 32, cfg.vocab))
    checkpoint.save(ckpt_to, 1, state, layout=prog)
    step, state = checkpoint.restore_latest(ckpt_from, layout=prog)
    state, met1 = prog.step_fn(state, synthetic_batch(0, step, nm, gmb, 32, cfg.vocab))
    return {"losses": [met0["loss"].item(), met1["loss"].item()],
            "leaves": [np.asarray(t.numpy()) if isinstance(t, torch.Tensor) else t
                       for t in leaves(state)]}


def dist_train_rc(zero: int):
    from repro_torch.configs.base import RunConfig
    return RunConfig(zero_stage=zero, collective_mode="hier", backend="pallas",
                     wire_quant="int8", param_dtype="float32", learning_rate=1e-3)


def card_rings(m, c):
    """On the card: every case of the per-rank kernels on this rank against
    the one-launch kernel over all ranks (run in this process on the same
    inputs, regenerated from the seed) and against the plain version.
    Returns {case: (equal to the one launch, equal to the plain version)}."""
    from repro_torch.kernels import ring_dma
    arena = peer.arena_for(m, "pod")
    rings = ring_dma._mesh_rings(m, "pod")
    n, me = m.shape["pod"], m.rank
    out = {}
    cases = [("rs", w, S, d) for w in ("float32", "bfloat16") for S in (1, 4) for d in (1, -1)]
    cases += [("ag", w, S, d) for w in (4, 2) for S in (1, 4) for d in (1, -1)]
    for i, (kind, w, S, d) in enumerate(cases):
        gen = torch.Generator(device="cuda").manual_seed(i)
        if kind == "rs":
            xs = [torch.randn(n, c, generator=gen, device="cuda") for _ in range(m.size)]
            kw = dict(direction=d, wire_dtype=getattr(torch, w), n_stripes=S)
            got = ring_dma.reduce_scatter_peer(xs[me], arena, **kw)
            one = ring_dma.reduce_scatter_fused(xs, rings, **kw)[me]
            plain = ring_dma.reduce_scatter_fused_plain(xs, rings, **kw)[me]
        else:
            dt = torch.float32 if w == 4 else torch.bfloat16
            xs = [torch.randn(c, generator=gen, device="cuda").to(dt) for _ in range(m.size)]
            kw = dict(direction=d, n_stripes=S)
            got = ring_dma.all_gather_peer(xs[me], arena, **kw)
            one = ring_dma.all_gather_fused(xs, rings, **kw)[me]
            plain = ring_dma.all_gather_fused_plain(xs, rings, **kw)[me]
        word = torch.int32 if got.element_size() == 4 else torch.int16
        out[f"{kind} {w} S{S} d{d:+d}"] = (bool(torch.equal(got.view(word), one.view(word))),
                                           bool(torch.equal(got.view(word), plain.view(word))))
    out["launches"] = (ring_dma.rs_launches, ring_dma.ag_launches)
    return out


def card_withheld(m):
    """On the card: after a good call, the last rank withholds one; the
    others return (their error, seconds to it)."""
    import torch.distributed as dist

    from repro_torch.kernels import ring_dma
    arena = peer.arena_for(m, "pod")
    x = torch.ones(m.shape["pod"], 4096, device="cuda")
    ring_dma.reduce_scatter_peer(x, arena)
    dist.barrier()
    if m.rank == m.size - 1:
        return ("withheld", 0.0)
    t0 = time.monotonic()
    try:
        ring_dma.reduce_scatter_peer(x, arena)
        return ("no error", time.monotonic() - t0)
    except ring_dma.RingProtocolError as e:
        return (str(e), time.monotonic() - t0)
