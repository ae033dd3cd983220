"""The port's ring primitives against the JAX package's, on the same inputs.

Inputs come from a seeded numpy RandomState and go to both packages: the JAX
side runs under ``compat.shard_map`` on a ring of n host devices (axis
"pod"), with TACC ``collective_reduce`` pinned to the Pallas kernel's
interpret mode as tests/test_ring_dma.py pins it; the port runs on a CPU
``ThreadMesh`` of the same shape, where the pallas rings take the emulated
schedule.  f32 rings are held bit for bit.  The plain versions of the fused
kernels' schedules are held bit for bit against the emulated schedule; the
kernels themselves are held against those plain versions on the card
(tests/test_torch_cuda.py, chip_smoke.py).
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from repro.core import collectives as jax_coll  # noqa: E402
from repro.core import compat  # noqa: E402
from repro.core import tacc as jax_tacc  # noqa: E402
from repro.kernels import ops as jax_ops  # noqa: E402,F401  (registers collective_reduce)
from repro.kernels import ring_dma as jax_ring  # noqa: E402
from repro_torch.core import collectives as coll  # noqa: E402
from repro_torch.core import mesh  # noqa: E402
from repro_torch.core import tacc  # noqa: E402
from repro_torch.kernels import collective_reduce as cr  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels import ring_dma  # noqa: E402

# name -> (JAX ring, port ring, input kind); "rs" inputs are (n*n*3, 4) per
# rank, "ag" inputs (5, 3).  The pallas rings take n_stripes.
PRIMS = {
    "rs_xla": (jax_coll.ring_reduce_scatter, coll.ring_reduce_scatter, "rs"),
    "rs_bidir_xla": (jax_coll.ring_reduce_scatter_bidir, coll.ring_reduce_scatter_bidir, "rs"),
    "ag_xla": (jax_coll.ring_all_gather, coll.ring_all_gather, "ag"),
    "ag_bidir_xla": (jax_coll.ring_all_gather_bidir, coll.ring_all_gather_bidir, "ag"),
    "ar_xla": (jax_coll.ring_all_reduce, coll.ring_all_reduce, "rs"),
    "rs_pallas": (jax_ring.ring_reduce_scatter, ring_dma.ring_reduce_scatter, "rs"),
    "rs_bidir_pallas": (jax_ring.ring_reduce_scatter_bidir,
                        ring_dma.ring_reduce_scatter_bidir, "rs"),
    "ag_pallas": (jax_ring.ring_all_gather, ring_dma.ring_all_gather, "ag"),
    "ag_bidir_pallas": (jax_ring.ring_all_gather_bidir, ring_dma.ring_all_gather_bidir, "ag"),
    "ar_pallas": (jax_ring.ring_all_reduce, ring_dma.ring_all_reduce, "rs"),
}


@pytest.fixture(scope="module", autouse=True)
def interpret_reduce():
    """The JAX rings accumulate through the Pallas kernel body in interpret
    mode, as tests/test_ring_dma.py runs them; restored afterwards."""
    prev = jax_tacc.get_default("collective_reduce")
    jax_tacc.set_default("collective_reduce", "interpret")
    yield
    jax_tacc.set_default("collective_reduce", prev)


def _inputs(n, seed=0):
    rng = np.random.RandomState(seed + n)
    return {"rs": [rng.randn(n * n * 3, 4).astype(np.float32) for _ in range(n)],
            "ag": [rng.randn(5, 3).astype(np.float32) for _ in range(n)]}


def _kw(name, k):
    return {"n_stripes": k} if name.endswith("pallas") else {}


@functools.lru_cache(maxsize=None)
def _jax_rings(n, k):
    """Every primitive's per-rank outputs (n, ...) from one shard_map."""
    xs = _inputs(n)
    ring = Mesh(np.array(jax.devices()[:n]), ("pod",))

    def f(rs_in, ag_in):
        v = {"rs": rs_in, "ag": ag_in}
        return {name: jax_fn(v[kind], "pod", **_kw(name, k))[None]
                for name, (jax_fn, _, kind) in PRIMS.items()}

    sm = compat.shard_map(f, mesh=ring, in_specs=(P("pod"), P("pod")),
                          out_specs={name: P("pod") for name in PRIMS},
                          axis_names={"pod"}, check_vma=False)
    out = jax.jit(sm)(np.concatenate(xs["rs"]), np.concatenate(xs["ag"]))
    return {name: np.asarray(v) for name, v in out.items()}


@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("n", [2, 3, 5])
@pytest.mark.parametrize("name", sorted(PRIMS))
def test_ring_primitive_matches_jax_bitwise(name, n, k):
    want = _jax_rings(n, k)[name]
    _, port_fn, kind = PRIMS[name]
    xs = [torch.from_numpy(a) for a in _inputs(n)[kind]]
    before = cr.launches
    got = mesh.ThreadMesh({"pod": n}, device="cpu").run(
        lambda v: port_fn(v, "pod", **_kw(name, k)), xs)
    assert cr.launches == before               # CPU tensors never reach a kernel
    assert all(g.dtype == torch.float32 for g in got)
    np.testing.assert_array_equal(torch.stack(got).numpy(), want)


@pytest.mark.parametrize("wire", ["float32", "bfloat16"])
@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("n", [2, 3, 4, 5])
def test_fused_schedule_plain_matches_emulated_bitwise(n, k, wire):
    """The plain version of each fused kernel's schedule (parity slots,
    credits as counters, stripes) gives the emulated schedule's bits, in
    both directions, for one ring and for two rings in one launch."""
    rng = np.random.RandomState(n * 10 + k)
    wire_dtype = getattr(torch, wire)
    for direction in (1, -1):
        shape = {"pod": n, "data": 2}
        m = mesh.ThreadMesh(shape, device="cpu")
        xs = [torch.from_numpy(rng.randn(n, 37).astype(np.float32)) for _ in range(m.size)]
        emu_rs = m.run(lambda x: ring_dma._rs_emulated(x, "pod", direction, wire_dtype, k), xs)
        emu_ag = m.run(lambda x: ring_dma._ag_emulated(x[0], "pod", direction, k), xs)
        rings = ring_dma._mesh_rings(m, "pod")
        assert rings == [list(range(0, 2 * n, 2)), list(range(1, 2 * n, 2))]
        plain_rs = ring_dma.reduce_scatter_fused(xs, rings, direction=direction,
                                                 wire_dtype=wire_dtype, n_stripes=k)
        plain_ag = ring_dma.all_gather_fused([x[0] for x in xs], rings,
                                             direction=direction, n_stripes=k)
        for a, b in zip(plain_rs, emu_rs):
            assert torch.equal(a, b)
        for a, b in zip(plain_ag, emu_ag):
            assert torch.equal(a, b)


def test_fused_plain_checks_its_protocol():
    """A ring whose ranks are not covered once is refused; on a good run the
    plain schedules drain their counters and give the ring oracles."""
    g = torch.Generator().manual_seed(0)
    xs = [torch.randn(3, 8, generator=g) for _ in range(3)]
    with pytest.raises(ValueError):
        ring_dma.reduce_scatter_fused_plain(xs, [[0, 1]])
    out = ring_dma.reduce_scatter_fused_plain(xs, [[0, 1, 2]], n_stripes=8)
    want = ref.ring_reduce_scatter([x.reshape(-1) for x in xs])
    for o, w in zip(out, want):
        torch.testing.assert_close(o.double(), w, rtol=1e-6, atol=1e-6)
    ag = ring_dma.all_gather_fused_plain([x[0] for x in xs], [[0, 1, 2]], n_stripes=3)
    for o, w in zip(ag, ref.ring_all_gather([x[0] for x in xs])):
        assert torch.equal(o.reshape(-1), w)


class _RecordingLedger(ring_dma.PullLedger):
    """A PullLedger that also logs every event it checks, in order."""

    def __init__(self):
        super().__init__()
        self.events = []

    def write(self, rank, step, piece):
        self.events.append(("write", rank, step, piece))
        super().write(rank, step, piece)

    def read(self, rank, step, piece):
        self.events.append(("read", rank, step, piece))
        super().read(rank, step, piece)

    def give(self, rank, parity):
        self.events.append(("give", rank, parity))
        super().give(rank, parity)

    def take(self, rank, step):
        self.events.append(("take", rank, step))
        super().take(rank, step)


def _replay(events):
    ledger = ring_dma.PullLedger()
    for kind, *args in events:
        getattr(ledger, kind)(*args)
    ledger.close()


def _pull_events(monkeypatch):
    """The ledger events of a good plain reduce-scatter over one ring of 5
    (credits exist only from n = 5 on), two stripes."""
    rec = []

    def ledger():
        rec.append(_RecordingLedger())
        return rec[-1]

    monkeypatch.setattr(ring_dma, "PullLedger", ledger)
    g = torch.Generator().manual_seed(1)
    ring_dma.reduce_scatter_fused_plain([torch.randn(5, 11, generator=g) for _ in range(5)],
                                        [[0, 1, 2, 3, 4]], n_stripes=2)
    monkeypatch.undo()
    return rec[0].events


@pytest.mark.parametrize("fault", ["reader_skips_written_wait", "writer_skips_credit",
                                   "credit_taken_before_given", "counter_left_over"])
def test_plain_pull_protocol_raises_on_faults(monkeypatch, fault):
    """The plain reduce-scatter's ledger turns each fault of the pull
    protocol into RingProtocolError: a reader that pulls a partial before
    its "written" flag (its read moved ahead of the write), a writer that
    skips its credit wait (its overwrite moved ahead of the downstream's
    read of that parity), a credit taken before it was given, and a counter
    left over (the last read dropped).  The good run's events replay
    cleanly."""
    events = _pull_events(monkeypatch)
    kinds = [e[0] for e in events]
    assert kinds.count("take") == kinds.count("give") > 0
    _replay(events)
    ev = list(events)
    if fault == "reader_skips_written_wait":
        i = next(i for i, e in enumerate(ev) if e[0] == "read")
        w = ev.index(("write", *ev[i][1:]))
        ev.insert(w, ev.pop(i))
    elif fault == "writer_skips_credit":
        t = kinds.index("take")
        rank, step = ev[t][1:]
        w = next(i for i in range(t, len(ev)) if ev[i][:3] == ("write", rank, step))
        r = ev.index(("read", rank, step - 2, ev[w][3]))
        del ev[t]
        ev.insert(r, ev.pop(w - 1))
    elif fault == "credit_taken_before_given":
        t = kinds.index("take")
        rank, step = ev[t][1:]
        gv = max(i for i in range(t) if ev[i] == ("give", rank, step % 2))
        ev.insert(gv, ev.pop(t))
    else:
        del ev[max(i for i, e in enumerate(ev) if e[0] == "read")]
    with pytest.raises(ring_dma.RingProtocolError):
        _replay(ev)


@pytest.mark.parametrize("n", [2, 4])
def test_narrow_wire_matches_jax_mixed_ring(n):
    """wire_dtype=bf16 with the f32 accumulator equals the reference's
    ``ring_reduce_scatter_mixed`` (the collective_reduce semantics)."""
    rng = np.random.RandomState(3)
    xs = [rng.randn(n * 8, 16).astype(np.float32) for _ in range(n)]
    ring = Mesh(np.array(jax.devices()[:n]), ("pod",))
    sm = compat.shard_map(
        lambda v: jax_coll.ring_reduce_scatter_mixed(v, "pod", wire_dtype=jnp.bfloat16)[None],
        mesh=ring, in_specs=P("pod"), out_specs=P("pod"), axis_names={"pod"},
        check_vma=False)
    want = np.asarray(jax.jit(sm)(np.concatenate(xs)))
    m = mesh.ThreadMesh({"pod": n}, device="cpu")
    got = m.run(lambda v: ring_dma.ring_reduce_scatter(v, "pod", wire_dtype=torch.bfloat16),
                [torch.from_numpy(a) for a in xs])
    mixed = m.run(lambda v: coll.ring_reduce_scatter_mixed(v, "pod", wire_dtype=torch.bfloat16),
                  [torch.from_numpy(a) for a in xs])
    np.testing.assert_array_equal(torch.stack(got).numpy(), want)
    np.testing.assert_array_equal(torch.stack(mixed).numpy(), want)


@pytest.mark.parametrize("inc", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(7,), (300, 5), (256, 256)])
def test_collective_reduce_matches_jax(shape, inc):
    rng = np.random.RandomState(1)
    acc = rng.randn(*shape).astype(np.float32)
    incoming = rng.randn(*shape).astype(np.float32)
    jdt, tdt = {"float32": (jnp.float32, torch.float32),
                "bfloat16": (jnp.bfloat16, torch.bfloat16)}[inc]
    want = np.asarray(jax_ops.collective_reduce(jnp.asarray(acc),
                                                jnp.asarray(incoming).astype(jdt),
                                                interpret=True))
    before = cr.launches
    got = tacc.dispatch("collective_reduce", torch.from_numpy(acc),
                        torch.from_numpy(incoming).to(tdt))
    assert cr.launches == before
    np.testing.assert_array_equal(got.numpy(), want)


def test_cuda_tensor_never_takes_the_plain_version():
    """The wrappers pick the plain version only for CPU tensors: a tensor on
    any other device is refused, and no kernel launch is counted."""
    meta = torch.empty(4, device="meta")
    before = (cr.launches, ring_dma.rs_launches, ring_dma.ag_launches)
    with pytest.raises(ValueError):
        cr.collective_reduce(meta, meta)
    with pytest.raises(ValueError):
        ring_dma.reduce_scatter_fused([meta.reshape(2, 2)] * 2, [[0, 1]])
    with pytest.raises(ValueError):
        ring_dma.all_gather_fused([meta] * 2, [[0, 1]])
    assert (cr.launches, ring_dma.rs_launches, ring_dma.ag_launches) == before


def test_schedule_is_emulated_off_the_card():
    """On a CPU ThreadMesh the pallas rings take the emulated schedule even
    though the TACC default is "fused"; a DistMesh would too."""
    assert tacc.get_default("ring_reduce_scatter") == "fused"
    assert tacc.get_default("ring_all_gather") == "fused"
    seen = mesh.ThreadMesh({"pod": 2}, device="cpu").run(
        lambda _: (ring_dma._schedule("ring_reduce_scatter"),
                   ring_dma._schedule("ring_all_gather")), [None, None])
    assert seen == [("emulated", "emulated")] * 2
