"""The port's collectives and HetCCL front door against the JAX package's.

Inputs come from a seeded numpy RandomState and go to both packages: the JAX
side runs under ``compat.shard_map`` on a (pod=2, data=2) mesh of 4 host
devices, with ``collective_reduce`` pinned to interpret mode as
tests/test_ring_dma.py pins it; the port runs on a CPU ``ThreadMesh`` of the
same shape.  Per-rank outputs are compared within rtol 1e-6 (the local stage
sums in another order).  bf16 is held against the f32-accumulate oracle, not
against the JAX xla ring (ROADMAP C2).
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from repro.core import compat  # noqa: E402
from repro.core import hetccl as jax_hetccl  # noqa: E402
from repro.core import tacc as jax_tacc  # noqa: E402
from repro.kernels import ops as jax_ops  # noqa: E402,F401  (registers collective_reduce)
from repro_torch import comm  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import hetccl, mesh, tacc  # noqa: E402
from repro_torch.models import build  # noqa: E402
from repro_torch.models.common import tree_map_meta  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
RTOL = dict(rtol=1e-6, atol=1e-6)


@pytest.fixture(scope="module", autouse=True)
def interpret_reduce():
    prev = jax_tacc.get_default("collective_reduce")
    jax_tacc.set_default("collective_reduce", "interpret")
    yield
    jax_tacc.set_default("collective_reduce", prev)


@pytest.fixture(scope="module")
def jax_mesh():
    return compat.make_mesh((2, 2), ("pod", "data"))


def _jax_per_rank(jmesh, fn, x, in_spec):
    """fn on every rank of the (pod, data) mesh; per-rank outputs stacked."""
    sm = compat.shard_map(lambda v: jax.tree.map(lambda o: o[None], fn(v)), mesh=jmesh,
                          in_specs=in_spec, out_specs=P(("pod", "data")),
                          axis_names={"pod", "data"}, check_vma=False)
    return jax.tree.map(np.asarray, jax.jit(sm)(x))


def _port_per_rank(fn, xs):
    m = mesh.ThreadMesh({"pod": 2, "data": 2}, device="cpu")
    return m.run(fn, xs)


OPS = {  # op -> (per-rank input shape, JAX in_spec, how the port splits the input)
    "all_reduce": ((37, 3), P(("pod", "data")), "split"),
    "reduce_scatter": ((4 * 4 * 3, 2), P(None), "replicate"),
    "all_gather": ((5, 3), P(("pod", "data")), "split"),
}


def _op_inputs(op):
    shape, spec, how = OPS[op]
    rng = np.random.RandomState(sorted(OPS).index(op))
    if how == "split":
        x = rng.randn(4 * shape[0], *shape[1:]).astype(np.float32)
        return x, spec, [torch.from_numpy(p.copy()) for p in np.split(x, 4)]
    x = rng.randn(*shape).astype(np.float32)
    # reduce_scatter: each rank holds its own full-size tensor
    xs = [torch.from_numpy((x * (r + 1)).copy()) for r in range(4)]
    return x, spec, xs


@pytest.mark.parametrize("backend", ["xla", "pallas"])
@pytest.mark.parametrize("mode", ["flat", "hier", "pipelined"])
@pytest.mark.parametrize("op", sorted(OPS))
def test_collective_matches_jax(jax_mesh, op, mode, backend):
    x, spec, xs = _op_inputs(op)
    jcfg = jax_hetccl.HetCCLConfig(mode=mode, local_axes=("data",), pod_axis="pod",
                                   backend=backend, n_channels=2)
    cfg = hetccl.HetCCLConfig(mode=mode, local_axes=("data",), pod_axis="pod",
                              backend=backend, n_channels=2)
    if OPS[op][2] == "replicate":
        scale = jnp.arange(1, 5, dtype=jnp.float32)

        def jfn(v):
            r = jax.lax.axis_index("pod") * 2 + jax.lax.axis_index("data")
            return getattr(jax_hetccl, op)(v * scale[r], jcfg)
    else:
        def jfn(v):
            return getattr(jax_hetccl, op)(v, jcfg)
    want = _jax_per_rank(jax_mesh, jfn, x, spec)
    got = _port_per_rank(lambda v: getattr(hetccl, op)(v, cfg), xs)
    np.testing.assert_allclose(torch.stack(got).numpy(), want, **RTOL)


@pytest.mark.parametrize("op", ["broadcast", "reduce", "all_to_all"])
@pytest.mark.parametrize("mode", ["flat", "hier"])
def test_rooted_and_a2a_collectives_match_jax(jax_mesh, op, mode):
    rng = np.random.RandomState(5)
    x = rng.randn(4 * 8, 3).astype(np.float32)
    kw = {"root": 1} if op != "all_to_all" else {}
    jcfg = jax_hetccl.HetCCLConfig(mode=mode, local_axes=("data",), pod_axis="pod")
    cfg = hetccl.HetCCLConfig(mode=mode, local_axes=("data",), pod_axis="pod")
    want = _jax_per_rank(jax_mesh, lambda v: getattr(jax_hetccl, op)(v, jcfg, **kw),
                         x, P(("pod", "data")))
    got = _port_per_rank(lambda v: getattr(hetccl, op)(v, cfg, **kw),
                         [torch.from_numpy(p.copy()) for p in np.split(x, 4)])
    np.testing.assert_allclose(torch.stack(got).numpy(), want, **RTOL)


def test_p2p_matches_jax(jax_mesh):
    x = np.arange(4 * 3, dtype=np.float32).reshape(4, 3)
    perm = [(0, 1)]
    want = _jax_per_rank(jax_mesh, lambda v: jax_hetccl.p2p(v, "pod", perm), x,
                         P(("pod", "data")))
    got = _port_per_rank(lambda v: hetccl.p2p(v, "pod", perm),
                         [torch.from_numpy(p.copy()) for p in np.split(x, 4)])
    np.testing.assert_array_equal(torch.stack(got).numpy(), want)


def _grad_trees(seed=11):
    """Per-rank trees shaped like reduced smollm-135m's parameters, with a
    bf16 leaf and an int32 leaf beside the f32 ones (numpy, per rank)."""
    shapes = tree_map_meta(lambda m: tuple(m.shape),
                           build(get_config("smollm-135m").reduced()).abstract_params())
    rng = np.random.RandomState(seed)

    def one(shp):
        return rng.randn(*shp).astype(np.float32)

    trees = []
    for _ in range(4):
        t = jax.tree.map(one, shapes, is_leaf=lambda s: isinstance(s, tuple))
        t["steps"] = (rng.rand(9) * 10).astype(np.int32)
        trees.append(t)
    return trees


@pytest.mark.parametrize("backend", ["xla", "pallas"])
@pytest.mark.parametrize("mode", ["flat", "hier", "pipelined"])
def test_tree_all_reduce_matches_jax(jax_mesh, mode, backend):
    """A reduced-smollm-shaped tree, buckets smaller than a leaf (4 KiB), f32,
    bf16 and int32 leaves, mean_by: f32 leaves within rtol 1e-6 of JAX,
    int32 exact and not divided, bf16 within its rounding of the f32 sum."""
    trees = _grad_trees()
    leaves0, treedef = jax.tree.flatten(trees[0])
    stacked = [np.stack([jax.tree.leaves(t)[i] for t in trees]) for i in range(len(leaves0))]
    jcfg = jax_hetccl.HetCCLConfig(mode=mode, local_axes=("data",), pod_axis="pod",
                                   backend=backend, bucket_bytes=4096, n_channels=2)
    cfg = hetccl.HetCCLConfig(mode=mode, local_axes=("data",), pod_axis="pod",
                              backend=backend, bucket_bytes=4096, n_channels=2)
    bf16_keys = {"final_norm"}

    def jfn(*ls):
        tree = jax.tree.unflatten(treedef, [l[0] for l in ls])
        tree = {k: (v.astype(jnp.bfloat16) if k in bf16_keys else v) for k, v in tree.items()}
        out = jax_hetccl.tree_all_reduce(tree, jcfg, mean_by=jnp.asarray(4.0, jnp.float32))
        return tuple(o.astype(jnp.float32)[None] if o.dtype == jnp.bfloat16 else o[None]
                     for o in jax.tree.leaves(out))

    sm = compat.shard_map(jfn, mesh=jax_mesh, in_specs=(P(("pod", "data")),) * len(stacked),
                          out_specs=(P(("pod", "data")),) * len(stacked),
                          axis_names={"pod", "data"}, check_vma=False)
    want = [np.asarray(o) for o in jax.jit(sm)(*[s[:, None] for s in stacked])]

    def to_torch(t):
        out = jax.tree.map(torch.from_numpy, t)
        return {k: (v.to(torch.bfloat16) if k in bf16_keys else v) for k, v in out.items()}

    got = _port_per_rank(lambda t: hetccl.tree_all_reduce(t, cfg, mean_by=4.0),
                         [to_torch(t) for t in trees])
    keys = [jax.tree_util.keystr(p) for p, _ in jax.tree_util.tree_flatten_with_path(trees[0])[0]]
    for i, key in enumerate(keys):
        port = torch.stack([hetccl._flatten(g)[0][i] for g in got])
        w = want[i][:, 0]
        if "final_norm" in key:
            assert port.dtype == torch.bfloat16
            bf = stacked[i].astype(jnp.bfloat16).astype(np.float32)
            oracle = bf.astype(np.float64).sum(0) / 4.0
            np.testing.assert_allclose(port.float().numpy(), np.broadcast_to(oracle, w.shape),
                                       rtol=2e-2, atol=2e-2)
        elif "steps" in key:
            assert port.dtype == torch.int32
            np.testing.assert_array_equal(port.numpy(), w)
            np.testing.assert_array_equal(w[0], stacked[i].sum(0))
        else:
            np.testing.assert_allclose(port.numpy(), w, **RTOL)


# (shapes, dtypes, bucket_bytes): buckets of one leaf each, of many leaves,
# leaves whose buckets need padding to the world of 4, and f32 with bf16
IN_PLACE_LAYOUTS = {
    "one_leaf_buckets": ([(64, 3), (128,), (5, 4, 8)], ["float32"] * 3, 64),
    "many_leaf_buckets": ([(64, 3), (128,), (5, 4, 8), (2, 6)], ["float32"] * 4, 1 << 20),
    "padded": ([(7,), (3, 5), (11, 2), (1,), (13,)], ["float32"] * 5, 100),
    "mixed_dtypes": ([(9, 3), (6,), (5, 5), (4, 2), (33,)],
                     ["float32", "bfloat16", "float32", "bfloat16", "float32"], 96),
}
IN_PLACE_BACKENDS = {"xla": dict(backend="xla"), "pallas": dict(backend="pallas"),
                     "pallas-int8": dict(backend="pallas", wire_quant="int8")}


@pytest.mark.parametrize("layout", sorted(IN_PLACE_LAYOUTS))
@pytest.mark.parametrize("backend", sorted(IN_PLACE_BACKENDS))
def test_tree_all_reduce_in_place_is_bit_equal(backend, layout):
    """``tree_all_reduce`` of ``bucket_zeros`` leaves (hier, (pod=2, data=2))
    reduces each bucket in its own buffer: the same bits as the copying
    reduction of the same values (with ``mean_by``), the returned leaves are
    the donated ones, their storage the buffers'; the copying reduction's
    leaves are new.  A tree whose leaves do not fill their buckets exactly
    is reduced by copying, its inputs untouched."""
    shapes, dtypes, bucket_bytes = IN_PLACE_LAYOUTS[layout]
    cfg = hetccl.HetCCLConfig(mode="hier", local_axes=("data",), pod_axis="pod",
                              bucket_bytes=bucket_bytes, **IN_PLACE_BACKENDS[backend])
    rng = np.random.RandomState(sorted(IN_PLACE_LAYOUTS).index(layout))
    vals = [[torch.from_numpy(rng.randn(*sh).astype(np.float32)).to(getattr(torch, dt))
             for sh, dt in zip(shapes, dtypes)] for _ in range(4)]

    def rank(xs):
        donated = hetccl.bucket_zeros(xs, cfg)
        for d, x in zip(donated, xs):
            d.copy_(x)
        ptrs = [d.data_ptr() for d in donated]
        copied = hetccl.tree_all_reduce({"g": list(xs)}, cfg, mean_by=4.0)["g"]
        in_place = hetccl.tree_all_reduce({"g": list(donated)}, cfg, mean_by=4.0)["g"]
        fresh = hetccl.bucket_zeros(xs, cfg)
        for d, x in zip(fresh, xs):
            d.copy_(x)
        # a bucket without its first leaf is not filled: its other leaves copy
        cut = next((b for b in hetccl._make_buckets(xs, bucket_bytes) if len(b) > 1), [0])
        keep = [i for i in range(len(xs)) if i != cut[0]]
        got = hetccl.tree_all_reduce({"g": [fresh[i] for i in keep]}, cfg)["g"]
        partial = [(fresh[i], got[keep.index(i)], xs[i]) for i in cut[1:]]
        return xs, copied, in_place, donated, ptrs, partial

    outs = mesh.ThreadMesh({"pod": 2, "data": 2}, device="cpu").run(rank, vals)
    buckets = hetccl._make_buckets(vals[0], bucket_bytes)
    sizes = [sum(vals[0][i].numel() for i in b) for b in buckets]
    assert {"one_leaf_buckets": all(len(b) == 1 for b in buckets),
            "many_leaf_buckets": len(buckets) == 1,
            "padded": any(n % 4 for n in sizes) and max(map(len, buckets)) > 1,
            "mixed_dtypes": len({vals[0][b[0]].dtype for b in buckets}) == 2}[layout]
    for xs, copied, in_place, donated, ptrs, partial in outs:
        for c, p, d, x, ptr in zip(copied, in_place, donated, xs, ptrs):
            assert c.dtype == p.dtype == x.dtype
            assert torch.equal(c.view(torch.int16) if c.dtype == torch.bfloat16 else c,
                               p.view(torch.int16) if p.dtype == torch.bfloat16 else p)
            assert p is d and p.data_ptr() == ptr
            assert c.data_ptr() != x.data_ptr()
        assert partial or layout == "one_leaf_buckets"
        for f, q, x in partial:
            assert q.data_ptr() != f.data_ptr() and torch.equal(f, x)
    assert all(torch.equal(a, b) for a, b in zip(outs[0][1], outs[3][1]))



def test_bf16_rings_against_the_f32_accumulate_oracle(jax_mesh):
    """bf16 all_reduce (hier, both backends) against the f32-accumulate
    oracle: the sum of the bf16 inputs taken in f32 (``ref.collective_reduce``
    semantics).  The port's pallas ring keeps an f32 accumulator and rounds
    the partial to bf16 once per hop; its error stays within a few bf16
    ulps.  How far each of JAX's two bf16 outputs lies from the same oracle
    is printed (ROADMAP C2), not asserted."""
    rng = np.random.RandomState(7)
    x = rng.randn(4, 37, 3).astype(np.float32)
    xb = np.asarray(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))
    oracle = xb.astype(np.float64).sum(0)
    scale = np.abs(oracle).max()
    for backend in ("xla", "pallas"):
        jcfg = jax_hetccl.HetCCLConfig(mode="hier", local_axes=("data",), pod_axis="pod",
                                       backend=backend)
        jout = _jax_per_rank(jax_mesh, lambda v: jax_hetccl.all_reduce(
            v[0].astype(jnp.bfloat16), jcfg).astype(jnp.float32), x, P(("pod", "data")))
        cfg = hetccl.HetCCLConfig(mode="hier", local_axes=("data",), pod_axis="pod",
                                  backend=backend)
        got = torch.stack(_port_per_rank(lambda v: hetccl.all_reduce(v, cfg).float(),
                                         [torch.from_numpy(a).to(torch.bfloat16) for a in x]))
        port_err = np.abs(got.numpy() - oracle).max()
        print(f"\n  hier {backend} bf16: max abs err vs the f32-accumulate oracle: "
              f"JAX {np.abs(jout - oracle).max():.4g}, port {port_err:.4g} "
              f"(oracle max {scale:.3g})")
        # bf16 has 8 significant bits: an ulp of the sum's magnitude is scale/128
        assert port_err <= 2 * scale / 128


def test_pallas_schedule_pin_gives_the_same_bits():
    """Pinning the ring ops' TACC default to "emulated" is what the card run
    uses to reach the collective_reduce kernel; on the CPU both defaults give
    the emulated schedule and the same bits."""
    rng = np.random.RandomState(2)
    xs = [torch.from_numpy(rng.randn(4 * 6, 3).astype(np.float32)) for _ in range(4)]
    cfg = hetccl.HetCCLConfig(mode="hier", backend="pallas")
    base = _port_per_rank(lambda v: hetccl.all_reduce(v, cfg), xs)
    prev = {op: tacc.get_default(op) for op in ("ring_reduce_scatter", "ring_all_gather")}
    try:
        for op in prev:
            tacc.set_default(op, "emulated")
        pinned = _port_per_rank(lambda v: hetccl.all_reduce(v, cfg), xs)
    finally:
        for op, v in prev.items():
            tacc.set_default(op, v)
    assert all(torch.equal(a, b) for a, b in zip(base, pinned))


# ---------------------------------------------------------------------------
# Dispatch and communicators
# ---------------------------------------------------------------------------

def test_policy_dispatch_maps_only_declared_fields():
    seen = {}

    @tacc.register("test_policy_op", "v", policy_fields=("backend", "n_stripes"))
    def impl(x, *, backend="xla", n_stripes=1):
        seen.update(backend=backend, n_stripes=n_stripes)
        return x

    pol = comm.CommPolicy(mode="hier", backend="pallas", n_channels=3, n_stripes=2,
                          cross_dtype=torch.bfloat16)
    tacc.dispatch("test_policy_op", 1, variant="v", policy=pol)   # no n_channels handed in
    assert seen == {"backend": "pallas", "n_stripes": 2}
    tacc.dispatch("test_policy_op", 1, variant="v", policy=pol, n_stripes=5)
    assert seen["n_stripes"] == 5                      # explicit kwargs win
    assert tacc.policy_fields("test_policy_op", "v") == ("backend", "n_stripes")


def test_policy_fields_match_the_reference_registrations():
    from repro.core import collectives as _jax_coll  # noqa: F401  (registers)
    from repro_torch.core import collectives as _coll  # noqa: F401
    for op in ("all_reduce", "all_gather", "reduce_scatter", "all_to_all", "broadcast",
               "reduce", "p2p"):
        assert tacc.variants(op) == jax_tacc.variants(op)
        for v in tacc.variants(op):
            assert tacc.policy_fields(op, v) == jax_tacc.policy_fields(op, v), (op, v)


def test_install_use_and_facade():
    ops = ("all_reduce", "all_gather", "reduce_scatter")
    before = {op: tacc.get_default(op) for op in ops}
    cfg = hetccl.HetCCLConfig(mode="pipelined", backend="pallas", n_stripes=4)
    with hetccl.use(cfg):
        assert hetccl.current() == cfg
        assert {op: tacc.get_default(op) for op in ops} == {op: "pipelined" for op in ops}
        assert tacc.get_default("broadcast") == "hier"          # degrades to hier
    assert {op: tacc.get_default(op) for op in ops} == before
    prev = hetccl.install(cfg)
    assert hetccl.install(prev) == cfg                          # the undo pattern
    assert hetccl.current() == prev
    c = comm.create(("data",), "pod", policies={
        ("all_reduce", "large"): comm.CommPolicy("pipelined", "pallas", n_stripes=16),
        "broadcast": comm.CommPolicy("flat")})
    assert c.policy("all_reduce", 1 << 30).n_stripes == 8       # capped at MAX_STRIPES
    assert c.policy("all_reduce", 10).mode == "flat"
    assert c.variant_for("broadcast", c.policy("broadcast", 10)) == "flat"
    assert hetccl.HetCCLConfig(backend="xla", n_stripes=4).to_policy().n_stripes == 1


def test_wire_quant_and_unknown_backend_are_refused():
    """An unknown codec and an unknown backend are refused; a known codec
    binds on the pallas backend and collapses to None for xla."""
    with pytest.raises(ValueError, match="wire_quant"):
        hetccl.HetCCLConfig(backend="pallas", wire_quant="int4").communicator()
    c = hetccl.HetCCLConfig(backend="pallas", wire_quant="int8").communicator()
    assert c.policy("all_reduce", 1 << 30).wire_quant == "int8"
    assert c.policy("all_gather", 1 << 30).wire_quant == "int8"
    assert hetccl.HetCCLConfig(backend="xla", wire_quant="int8").communicator() \
        .policy("all_reduce", 1 << 30).wire_quant is None
    with pytest.raises(ValueError):
        hetccl.HetCCLConfig(backend="cuda").resolved_backend()
    from repro_torch.core import collectives as coll
    with pytest.raises(ValueError):
        coll.resolve_ring_backend("cuda")


def test_mesh_rank_error_aborts_the_others():
    """An exception in one rank breaks the barrier: the others raise instead
    of waiting, and run() re-raises the rank's own error."""
    m = mesh.ThreadMesh({"pod": 2, "data": 2}, device="cpu")

    def fn(v):
        if mesh.axis_index("pod") == 1 and mesh.axis_index("data") == 0:
            raise KeyError("rank 2 fails")
        return mesh.psum(v, "pod")

    with pytest.raises(KeyError, match="rank 2 fails"):
        m.run(fn, [torch.zeros(2)] * 4, timeout=60)
    assert m.run(lambda v: mesh.psum(v, ("pod", "data")), [torch.ones(2)] * 4)[0].tolist() \
        == [4.0, 4.0]


def test_mesh_exchanges_hold_under_thread_switching():
    """More ranks than cores, a short switch interval, many exchanges: every
    psum and ppermute still sees each rank's value of the same round."""
    m = mesh.ThreadMesh({"pod": 4, "data": 4}, device="cpu")
    rounds = 40

    def fn(v):
        me = mesh.axis_index(("pod", "data"))
        out = []
        for i in range(rounds):
            total = mesh.psum(v + i, ("pod", "data"))
            left = mesh.ppermute(v + i, "data", [(j, (j + 1) % 4) for j in range(4)])
            out.append((total.item(), left.item()))
        return me, out

    prev = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        res = m.run(fn, [torch.tensor(float(r)) for r in range(16)], timeout=120)
    finally:
        sys.setswitchinterval(prev)
    for r, (me, out) in enumerate(res):
        assert me == r
        src = (r // 4) * 4 + (r % 4 - 1) % 4
        assert out == [(120.0 + 16 * i, float(src + i)) for i in range(rounds)]


# ---------------------------------------------------------------------------
# DistMesh: the same collectives over torch.distributed (gloo, 2 processes)
# ---------------------------------------------------------------------------

DIST_RANK = r"""
import sys, torch, torch.distributed as dist
from repro_torch.core import hetccl, mesh, tacc
from repro_torch.kernels import peer
rank, init, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
dist.init_process_group("gloo", init_method=init, rank=rank, world_size=2)
m = mesh.DistMesh({"pod": 2, "data": 1}, device="cpu")
g = torch.Generator().manual_seed(rank)
x = torch.randn(5, 7, generator=g)
res = {b: m.run(hetccl.all_reduce, x, hetccl.HetCCLConfig(mode="hier", backend=b,
                                                         n_stripes=2))
       for b in ("xla", "pallas")}
# the fused variant on a DistMesh: one part per rank over the peer arena (on
# CPU tensors its plain version, over shared memory between the processes)
res["fused"] = m.run(lambda v: tacc.dispatch(
    "ring_reduce_scatter", v.reshape(5, -1)[:4].reshape(2, -1), "pod", 1, v.dtype,
    variant="fused"), x)
peer.close_arenas()
torch.save(res, out)
dist.destroy_process_group()
"""


def test_dist_mesh_gloo_matches_thread_mesh(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    init = f"file://{tmp_path / 'rendezvous'}"
    procs = [subprocess.Popen([sys.executable, "-c", DIST_RANK, str(r), init,
                               str(tmp_path / f"out{r}.pt")], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    for p in procs:
        log, _ = p.communicate(timeout=180)
        assert p.returncode == 0, log
    xs = [torch.randn(5, 7, generator=torch.Generator().manual_seed(r)) for r in range(2)]
    m = mesh.ThreadMesh({"pod": 2, "data": 1}, device="cpu")
    fused = m.run(lambda v: tacc.dispatch(
        "ring_reduce_scatter", v.reshape(5, -1)[:4].reshape(2, -1), "pod", 1, v.dtype,
        variant="emulated"), xs)
    for b in ("xla", "pallas"):
        cfg = hetccl.HetCCLConfig(mode="hier", backend=b, n_stripes=2)
        want = m.run(lambda v: hetccl.all_reduce(v, cfg), xs)
        for r in range(2):
            got = torch.load(tmp_path / f"out{r}.pt")
            assert torch.equal(got[b], want[r]), b
            assert torch.equal(got["fused"], fused[r])
