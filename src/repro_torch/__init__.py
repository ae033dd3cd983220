"""HetCCL's PyTorch + CUDA port, beside the JAX package ``repro``.

The JAX package is the reference; this package is held against it module by
module.  It imports ``torch`` and nothing of JAX or of ``repro``: what it
needs from there it keeps its own copy of.  Module names mirror ``repro/``:

    configs/   ModelConfig, RunConfig and the architecture registry
    core/      tacc (runtime dispatch: cuda kernels / plain-torch cpu
               paths), meshes of ranks, collectives, hetccl, balance
    comm/      communicators and policy tables
    plan/      the plan autotuner: shares and per-op policy tables priced
               by the α-β simulator (core/simulator.py)
    transport/ link inventories, stripe planning, flow scheduling
    kernels/   hand-written Hopper kernels (csrc/*.cu), their wrappers,
               plain versions and TACC registrations
    models/    dense transformer (loss, remat), attention, registry
    train/     ZeRO-1 optimizer and the data-parallel training step
    data/      the deterministic synthetic data pipeline
    serve/     one-card prefill/decode programs and the batcher
    launch/    serve.py and train.py entry points, mesh.py (a mesh's
               modeled cluster)
    convert.py weights carried across from the JAX parameter tree

Entry points run on ``cuda`` unless the caller asks for ``cpu``; without a
card they raise.  There is no sharding layer: the reference's mesh rules
(``make_rules``, ``spec_tree``, ``serve_rules``, ``Ctx.wsc``) mean nothing on
one card.
"""
