"""The fused rings' per-rank route across processes (ROADMAP A3;
DESIGN_TORCH.md §28), on the CPU.

A DistMesh rank on the card launches its own part of the ring kernels over
peer memory; its plain version runs the same steps, tags and tables over
the arena's shared-memory form (``kernels/peer.py``), across real gloo
processes spawned by ``launch.mesh.spawn_dist_mesh``.  Held here: that
protocol on 2 and 4 processes (reduce-scatter with an f32 and a bf16 wire,
all-gather; stripes 1 and 2; both directions) bit for bit against the JAX
package's ring primitives on the same seeded inputs (its accumulate in
Pallas interpret mode, as tests/test_torch_ring_dma.py runs it) and
against the emulated schedule on the same processes; a withheld call and
a call-order mismatch raising on the other ranks; which schedule a DistMesh
takes; and that a DistMesh on "cuda" without a card raises.  The kernel
itself is held against these plain versions on the card
(tests/test_torch_cuda.py, chip_smoke.py [38]).
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from jax.sharding import Mesh  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

import test_torch_dist_ranks  # noqa: E402
from repro.core import compat  # noqa: E402
from repro.core import tacc as jax_tacc  # noqa: E402
from repro.kernels import ops as jax_ops  # noqa: E402,F401  (registers collective_reduce)
from repro.kernels import ring_dma as jax_ring  # noqa: E402
from repro_torch.core import mesh, tacc  # noqa: E402
from repro_torch.kernels import peer, ring_dma  # noqa: E402
from repro_torch.launch.mesh import spawn_dist_mesh  # noqa: E402

CASES = [(wire, S, d) for wire in ("float32", "bfloat16") for S in (1, 2) for d in (1, -1)]


def _inputs(n):
    rng = np.random.RandomState(100 + n)
    return ([rng.randn(n * 6, 5).astype(np.float32) for _ in range(n)],
            [rng.randn(7, 3).astype(np.float32) for _ in range(n)])


@functools.lru_cache(maxsize=None)
def _jax_rings(n):
    """{case: (n, ...) per-rank outputs} of the JAX package's rings."""
    rs_in, ag_in = _inputs(n)
    ring = Mesh(np.array(jax.devices()[:n]), ("pod",))
    prev = jax_tacc.get_default("collective_reduce")
    jax_tacc.set_default("collective_reduce", "interpret")
    try:
        out = {}
        for wire, S, d in CASES:
            def f(x, v, wire=wire, S=S, d=d):
                got = {"rs": jax_ring.ring_reduce_scatter(x, "pod", direction=d,
                                                          wire_dtype=wire, n_stripes=S)[None]}
                if wire == "float32":
                    got["ag"] = jax_ring.ring_all_gather(v, "pod", direction=d,
                                                         n_stripes=S)[None]
                return got
            keys = ["rs"] + (["ag"] if wire == "float32" else [])
            sm = compat.shard_map(f, mesh=ring, in_specs=(P("pod"), P("pod")),
                                  out_specs={k: P("pod") for k in keys},
                                  axis_names={"pod"}, check_vma=False)
            got = jax.jit(sm)(np.concatenate(rs_in), np.concatenate(ag_in))
            out[("rs", wire, S, d)] = np.asarray(got["rs"])
            if "ag" in got:
                out[("ag", S, d)] = np.asarray(got["ag"])
        return out
    finally:
        jax_tacc.set_default("collective_reduce", prev)


@pytest.mark.parametrize("n", [2, 4])
def test_peer_protocol_matches_jax_and_emulated(tmp_path, n):
    """n gloo processes, each one rank of a ring on "pod": the per-rank
    protocol's plain version over the shared-memory arena gives the JAX
    package's bits and the emulated schedule's, for every case; every case
    is one call, counted by the arena's seq alike on every rank."""
    rs_in, ag_in = _inputs(n)
    got = spawn_dist_mesh(test_torch_dist_ranks.peer_rings, {"pod": n},
                          args=(rs_in, ag_in, CASES), device="cpu", timeout=120,
                          workdir=str(tmp_path))
    want = _jax_rings(n)
    n_calls = len(CASES) + len(CASES) // 2
    for r, out in enumerate(got):
        assert out["seq"] == n_calls
        for wire, S, d in CASES:
            np.testing.assert_array_equal(out[("rs", wire, S, d)].reshape(-1, 5),
                                          want[("rs", wire, S, d)][r])
            np.testing.assert_array_equal(out[("rs", wire, S, d)].reshape(-1, 5),
                                          out[("rs_emulated", wire, S, d)])
            if wire == "float32":
                np.testing.assert_array_equal(out[("ag", S, d)], want[("ag", S, d)][r])
                np.testing.assert_array_equal(out[("ag", S, d)], out[("ag_emulated", S, d)])


def test_peer_faults_raise_on_the_other_ranks(tmp_path):
    """Three processes.  The last rank withholds a call: the two others
    raise within the plain version's bound (plus start-up margin), naming a
    neighbour that never arrived or a wait that failed.  Then the first
    rank calls an all-gather where the others call a reduce-scatter: every
    rank raises at once (no bound waited out), the ranks next to the first
    naming the call-order fault.  Then the last rank withholds a call that
    grows the arena: the two others raise at the host meeting within its
    bound (3 s here, plus margin), naming the missing rank, and no rank
    waits on the process group; every rank then finds the arena broken."""
    got = spawn_dist_mesh(test_torch_dist_ranks.peer_faults, {"pod": 3}, device="cpu",
                          timeout=120, workdir=str(tmp_path))
    bound = ring_dma.PLAIN_TIMEOUT_S
    assert got[2]["withheld"][0] == "withheld"
    for r in (0, 1):
        msg, secs = got[r]["withheld"]
        assert msg != "no error" and "per-rank ring" in msg, msg
        assert secs < bound + 5.0, (r, secs)
    assert "never arrived" in got[0]["withheld"][0] or "never arrived" in got[1]["withheld"][0]
    for r in range(3):
        msg, secs = got[r]["order"]
        assert "another call" in msg, (r, msg)
        assert secs < bound, (r, secs)
    assert got[2]["grow"][0] == "withheld"
    for r in (0, 1):
        msg, secs = got[r]["grow"]
        assert "did not come to make, grow or close it" in msg and "[2]" in msg, (r, msg)
        assert secs < 3.0 + 5.0, (r, secs)
    assert all(got[r]["grow_broken"] for r in range(3))


class _CudaDistMesh(mesh.DistMesh):
    """A DistMesh as a rank on a card sees itself, without a process group:
    enough for the schedule and the dispatch to choose a route."""

    def __init__(self):
        mesh._Mesh.__init__(self, {"pod": 2})
        self.rank = 0
        self.device = torch.device("cuda", 0)


def test_dist_mesh_schedule_and_route(monkeypatch):
    """A DistMesh whose ranks are on "cuda" takes the TACC default (fused)
    and its rings go to the per-rank route, never to the emulated schedule
    unasked; pinned to "emulated" it takes that.  A CPU DistMesh, like a
    CPU ThreadMesh, takes the emulated schedule."""
    calls = []

    def fake_rs(x, arena, **kw):
        calls.append(("rs", arena, tuple(x.shape), kw))
        return torch.zeros(x.shape[1:])

    def fake_ag(x, arena, **kw):
        calls.append(("ag", arena, tuple(x.shape), kw))
        return torch.zeros((2,) + tuple(x.shape))

    monkeypatch.setattr(ring_dma, "reduce_scatter_peer", fake_rs)
    monkeypatch.setattr(ring_dma, "all_gather_peer", fake_ag)
    monkeypatch.setattr(peer, "arena_for", lambda m, axes: ("arena", axes))
    m = _CudaDistMesh()
    monkeypatch.setattr(mesh, "_PROCESS_MESH", m)
    assert ring_dma._schedule("ring_reduce_scatter") == "fused"
    assert ring_dma._schedule("ring_all_gather") == "fused"
    out = ring_dma.ring_reduce_scatter(torch.ones(8, 3), "pod", n_stripes=2)
    gathered = ring_dma.ring_all_gather(torch.ones(4, 3), "pod")
    assert tuple(out.shape) == (4, 3) and tuple(gathered.shape) == (8, 3)
    assert calls == [("rs", ("arena", "pod"), (2, 4, 3),
                      {"direction": 1, "wire_dtype": torch.float32, "n_stripes": 2}),
                     ("ag", ("arena", "pod"), (4, 3), {"direction": 1, "n_stripes": 1})]
    prev = tacc.get_default("ring_reduce_scatter")
    tacc.set_default("ring_reduce_scatter", "emulated")
    try:
        assert ring_dma._schedule("ring_reduce_scatter") == "emulated"
    finally:
        tacc.set_default("ring_reduce_scatter", prev)
    m.device = torch.device("cpu")
    assert ring_dma._schedule("ring_reduce_scatter") == "emulated"


def test_cuda_dist_mesh_without_a_card_raises(tmp_path):
    """On a host without a card a DistMesh asked for "cuda" raises: it
    never runs its ranks anywhere else."""
    import torch.distributed as dist
    if torch.cuda.is_available():
        pytest.skip("a card is present: the refusal is for hosts without one")
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'rv'}", rank=0,
                            world_size=1)
    try:
        with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
            mesh.DistMesh({"pod": 1}, device="cuda")
    finally:
        dist.destroy_process_group()
