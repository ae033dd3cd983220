"""The port's topology model, transport layer, balancer extensions and mesh
mapping against the JAX package's (``repro.core.topology``,
``repro.transport``, ``repro.core.balance``, ``repro.launch.mesh``).

Both packages' modules are jax-free copies of one another, so every output
is held equal exactly (dataclasses through ``dataclasses.asdict``, floats
with ``==``), on the same inputs: healthy and degraded link inventories, the
paper's, the v5e multi-pod, the mixed-fleet and an H100 cluster.
"""
import dataclasses
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.comm import communicator as jax_communicator  # noqa: E402
from repro.comm import policy as jax_policy  # noqa: E402
from repro.core import balance as jax_balance  # noqa: E402
from repro.core import compat  # noqa: E402
from repro.core import topology as jax_topology  # noqa: E402
from repro.launch import mesh as jax_launch_mesh  # noqa: E402
from repro import transport as jax_transport  # noqa: E402
from repro_torch import comm, transport  # noqa: E402
from repro_torch.comm import policy  # noqa: E402
from repro_torch.core import balance, mesh, simulator, topology  # noqa: E402
from repro_torch.kernels import quant, ring_dma  # noqa: E402
from repro_torch.launch import mesh as launch_mesh  # noqa: E402

SHEETS = ("TPU_V5E", "TPU_V4", "V100_PCIE", "W7800", "H100_NVLINK", "MI300X_XGMI")
CONSTANTS = ("IB_HDR_BW", "HOST_STAGED_BW", "RDMA_ALPHA", "MPI_ALPHA", "MPI_HOST_REDUCE_BW")


def _clusters(topo):
    """The clusters every comparison runs on, built by ``topo``'s package."""
    return {
        "paper": topo.paper_cluster(),
        "paper_host_staged": topo.paper_cluster(2, 2, rdma=False),
        "nvidia_only": topo.paper_cluster(4, 0),
        "v5e_multipod": topo.tpu_multipod(4, 128),
        "mixed_fleet": topo.tpu_mixed_fleet(2, 2, 128),
        "h100": topo.ClusterSpec(tuple(topo.PodSpec(f"pod{i}", topo.H100_NVLINK, 8)
                                       for i in range(2))),
        "mi300x_h100": topo.ClusterSpec((topo.PodSpec("amd", topo.MI300X_XGMI, 4),
                                         topo.PodSpec("nv", topo.H100_NVLINK, 4)),
                                        inter_pod_bw=50e9),
    }


def _asdict(cluster):
    return dataclasses.asdict(cluster) | {"n_chips": cluster.n_chips,
                                          "homogeneous": cluster.homogeneous,
                                          "slowest": cluster.slowest_endpoint_bw()}


def test_chip_sheets_constants_and_clusters_match_the_reference():
    for name in SHEETS:
        got, want = getattr(topology, name), getattr(jax_topology, name)
        assert dataclasses.asdict(got) == dataclasses.asdict(want), name
        assert got.effective_flops == want.effective_flops
    for name in CONSTANTS:
        assert getattr(topology, name) == getattr(jax_topology, name), name
    want = _clusters(jax_topology)
    for name, cluster in _clusters(topology).items():
        assert _asdict(cluster) == _asdict(want[name]), name
        for p, q in zip(cluster.pods, want[name].pods):
            assert p.effective_flops == q.effective_flops
            assert cluster.effective_link_bw(p) == want[name].effective_link_bw(q)


def _inventories(pkg, topo):
    """Healthy, degraded, one link down and a mix, on a 4-link chip and a
    6-link chip; same calls on either package."""
    out = {}
    for chip in ("TPU_V5E", "TPU_V4", "V100_PCIE"):
        spec = getattr(topo, chip)
        out[f"{chip}/healthy"] = pkg.LinkInventory.from_chip(spec)
        inv = pkg.LinkInventory.from_chip(spec)
        inv.mark_degraded(0, 0.25)
        out[f"{chip}/degraded"] = inv
        if spec.local_links > 1:
            inv = pkg.LinkInventory.from_chip(spec)
            inv.mark_down(1)
            out[f"{chip}/down"] = inv
            inv = pkg.LinkInventory.from_chip(spec)
            inv.mark_down(0)
            inv.mark_degraded(2, 0.5)
            inv.mark_down(3)
            inv.mark_up(3)
            out[f"{chip}/mixed"] = inv
    return out


def _inv_state(inv):
    return ([dataclasses.asdict(l) for l in inv.links],
            [dataclasses.asdict(inv.health(l.index)) for l in inv.links],
            [inv.effective_bw(l.index) for l in inv.links],
            [l.index for l in inv.healthy_links()], inv.n_healthy(), inv.healthy_bw(),
            repr(inv))


@pytest.mark.parametrize("nbytes", [1, 64 * 1024 - 1, 256 * 1024, 3 * 2**20 + 17, 64 * 2**20])
def test_links_and_stripe_plans_match_the_reference(nbytes):
    """Inventories (healthy, degraded, down, mixed), and every way of
    planning stripes over them: searched, pinned, exact, over n transfers,
    against a narrower peer and a fabric bound."""
    got, want = _inventories(transport, topology), _inventories(jax_transport, jax_topology)
    assert got.keys() == want.keys()
    for key in got:
        a, b = got[key], want[key]
        assert _inv_state(a) == _inv_state(b), key
        peer_a, peer_b = got["V100_PCIE/healthy"], want["V100_PCIE/healthy"]
        for kw in (dict(), dict(max_stripes=2), dict(max_stripes=3, exact=True),
                   dict(n_transfers=7), dict(inter_bw=12.5e9),
                   dict(min_stripe_bytes=1024, n_transfers=3)):
            pa = transport.plan_stripes(a, nbytes=nbytes, **kw)
            pb = jax_transport.plan_stripes(b, nbytes=nbytes, **kw)
            assert dataclasses.asdict(pa) == dataclasses.asdict(pb), (key, kw)
            assert pa.aggregate_bw == pb.aggregate_bw
            assert pa.stripe_bytes(nbytes) == pb.stripe_bytes(nbytes)
            assert pa.wire_time(nbytes, 5) == pb.wire_time(nbytes, 5)
            qa = transport.plan_stripes(a, peer_a, nbytes=nbytes, **kw)
            qb = jax_transport.plan_stripes(b, peer_b, nbytes=nbytes, **kw)
            assert dataclasses.asdict(qa) == dataclasses.asdict(qb), (key, kw)
    for name, cluster in _clusters(topology).items():
        want_c = _clusters(jax_topology)[name]
        assert transport.auto_stripes(cluster, nbytes) == \
            jax_transport.auto_stripes(want_c, nbytes), name
    for mod in (transport, jax_transport):
        dead = mod.LinkInventory.from_chip(jax_topology.V100_PCIE)
        dead.mark_down(0)
        with pytest.raises(RuntimeError, match="no healthy links"):
            mod.plan_stripes(dead, nbytes=nbytes)
        with pytest.raises(ValueError):
            dead.mark_degraded(0, 1.5)


def test_transport_constants_and_exports_match():
    for name in jax_transport.__all__:
        assert hasattr(transport, name), name
    for name in ("MAX_STRIPES", "MIN_STRIPE_BYTES", "MXU_TILE_BYTES", "STRIPE_FILL_S",
                 "N_STREAMS", "N_PARITIES", "LINK_UP", "LINK_DOWN", "LINK_DEGRADED"):
        assert getattr(transport, name) == getattr(jax_transport, name), name
    # the literals the transport layer and the simulator keep for the kernels
    assert transport.N_STREAMS == simulator.DMA_STREAMS == ring_dma.NUM_BUFFERS
    assert simulator.QUANT_CHUNK == quant.DEFAULT_CHUNK
    with pytest.raises(ValueError):
        transport.StripePlan(2, (0,), (1.0, 1.0))


@pytest.mark.parametrize("chip,down", [("TPU_V5E", [1, 0]), ("TPU_V4", [5, 2, 0]),
                                       ("H100_NVLINK", [0])])
def test_flow_scheduler_lanes_and_failover_match_the_reference(chip, down):
    """Lanes of a plan in the kernels' (parity, stream, stripe) order, and
    the priced restripe after each link goes down, down to the last (which
    must raise, not price as zero)."""
    nbytes = 8 * 2**20
    sched = transport.FlowScheduler(transport.LinkInventory.from_chip(getattr(topology, chip)),
                                    inter_bw=20e9)
    jsched = jax_transport.FlowScheduler(
        jax_transport.LinkInventory.from_chip(getattr(jax_topology, chip)), inter_bw=20e9)
    seen = []
    sched.observer = types.SimpleNamespace(on_failover=seen.append)
    plan, jplan = sched.plan(nbytes), jsched.plan(nbytes)
    assert dataclasses.asdict(plan) == dataclasses.asdict(jplan)
    lanes = sched.lanes(plan)
    assert [dataclasses.asdict(x) for x in lanes] == \
        [dataclasses.asdict(x) for x in jsched.lanes(jplan)]
    assert [x.sem_index(plan.n_stripes) for x in lanes] == list(range(len(lanes)))
    for link in down:
        if sched.inventory.n_healthy() == 1:
            with pytest.raises(RuntimeError):
                sched.failover(plan, link, nbytes)
            with pytest.raises(RuntimeError):
                jsched.failover(jplan, link, nbytes)
            break
        ev, jev = sched.failover(plan, link, nbytes), jsched.failover(jplan, link, nbytes)
        assert dataclasses.asdict(ev) == dataclasses.asdict(jev)
        assert ev.slowdown == jev.slowdown
        plan, jplan = ev.new_plan, jev.new_plan
    assert seen == sched.events
    assert [dataclasses.asdict(e) for e in sched.events] == \
        [dataclasses.asdict(e) for e in jsched.events]


def test_balance_extensions_match_the_reference(monkeypatch):
    """``plan_from_cluster`` and ``imbalance`` on every cluster, and
    ``profile_throughput`` on a deterministic step (a fake clock that
    advances by a scripted time per step) in both packages."""
    for name, cluster in _clusters(topology).items():
        want_c = _clusters(jax_topology)[name]
        for total, mb in ((4, 1), (12, 2), (31, 3)):
            if total < len(cluster.pods):
                continue
            got = balance.plan_from_cluster(cluster, total, mb)
            want = jax_balance.plan_from_cluster(want_c, total, mb)
            assert dataclasses.asdict(got) == dataclasses.asdict(want), name
            profs = [balance.PodProfile(p.name, p.effective_flops) for p in cluster.pods]
            jprofs = [jax_balance.PodProfile(p.name, p.effective_flops) for p in want_c.pods]
            assert balance.imbalance(got, profs) == jax_balance.imbalance(want, jprofs)
            uni = balance.make_plan([balance.PodProfile(p.name, 1.0) for p in cluster.pods],
                                    total, mb)
            juni = jax_balance.make_plan([jax_balance.PodProfile(p.name, 1.0)
                                          for p in want_c.pods], total, mb)
            assert balance.imbalance(uni, profs) == jax_balance.imbalance(juni, jprofs)

    def fake_clock(mod):
        state = {"t": 0.0, "i": 0}
        durations = [0.5, 0.25, 0.375, 0.125, 0.75]     # exact in binary

        def step():
            state["t"] += durations[state["i"] % len(durations)]
            state["i"] += 1

        monkeypatch.setattr(mod.time, "perf_counter", lambda: state["t"])
        return step

    got = balance.profile_throughput(fake_clock(balance), 4096, warmup=2, iters=3)
    want = jax_balance.profile_throughput(fake_clock(jax_balance), 4096, warmup=2, iters=3)
    assert got == want == (4096 / 0.375, 2.0)
    # a CPU device adds no synchronisation and changes nothing
    assert balance.profile_throughput(fake_clock(balance), 4096, warmup=2, iters=3,
                                      device="cpu") == want


@pytest.mark.parametrize("shape", [(2, 2), (4, 1), (1, 4), (3, 2)])
def test_cluster_for_mesh_matches_the_reference(shape):
    """A ThreadMesh maps onto the cluster the reference gives for a JAX mesh
    of the same shape, with the same chips (explicit in both packages:
    their defaults differ, DESIGN_TORCH.md §23); the port's default is the
    H100 sheet."""
    m = mesh.ThreadMesh({"pod": shape[0], "data": shape[1]}, device="cpu")
    jm = types.SimpleNamespace(axis_names=("pod", "data"), devices=np.empty(shape))
    if shape == (2, 2):                    # and a real JAX mesh of the shape
        jm = compat.make_mesh(shape, ("pod", "data"))
    assert launch_mesh.mesh_axis_sizes(m) == jax_launch_mesh.mesh_axis_sizes(jm)
    assert launch_mesh.pod_size_of(m) == jax_launch_mesh.pod_size_of(jm)
    n_pods = shape[0]
    for chips, jchips in ((topology.TPU_V5E, jax_topology.TPU_V5E),
                          ([topology.V100_PCIE, topology.W7800] * 2,
                           [jax_topology.V100_PCIE, jax_topology.W7800] * 2)):
        if isinstance(chips, list):
            chips, jchips = chips[:n_pods], jchips[:n_pods]
        for bw in (None, 12.5e9):
            got = launch_mesh.cluster_for_mesh(m, chips, bw)
            want = jax_launch_mesh.cluster_for_mesh(jm, jchips, bw)
            assert _asdict(got) == _asdict(want)
    default = launch_mesh.cluster_for_mesh(m)
    assert [p.chip for p in default.pods] == [topology.H100_NVLINK] * n_pods
    assert _asdict(default) == _asdict(jax_launch_mesh.cluster_for_mesh(
        jm, jax_topology.H100_NVLINK))
    with pytest.raises(ValueError, match="chip sheets"):
        launch_mesh.cluster_for_mesh(m, [topology.W7800] * (n_pods + 1))
    single = mesh.ThreadMesh({"data": 2}, device="cpu")
    jsingle = types.SimpleNamespace(axis_names=("data",), devices=np.empty((2,)))
    assert launch_mesh.pod_size_of(single) == jax_launch_mesh.pod_size_of(jsingle) == 0
    assert _asdict(launch_mesh.cluster_for_mesh(single, topology.TPU_V5E)) == \
        _asdict(jax_launch_mesh.cluster_for_mesh(jsingle, jax_topology.TPU_V5E))


def test_resolve_stripes_matches_the_reference(monkeypatch):
    """``--stripes``: a pinned count passes through; ``auto`` asks the
    transport planner over the mesh's cluster for pallas on several pods, 1
    otherwise.  With the reference's v5e islands priced in both packages
    (4 links) the two agree; the port's own default (H100, one link) gives
    1."""
    m = mesh.ThreadMesh({"pod": 2, "data": 2}, device="cpu")
    jm = types.SimpleNamespace(axis_names=("pod", "data"), devices=np.empty((2, 2)))
    for stripes in ("1", "3"):
        for backend in ("xla", "pallas"):
            assert launch_mesh.resolve_stripes(stripes, backend, m) == \
                jax_launch_mesh.resolve_stripes(stripes, backend, jm) == int(stripes)
    assert launch_mesh.resolve_stripes("auto", "xla", m) == 1
    assert launch_mesh.resolve_stripes("auto", "pallas", m) == 1          # H100: one link
    one_pod = mesh.ThreadMesh({"pod": 1, "data": 4}, device="cpu")
    assert launch_mesh.resolve_stripes("auto", "pallas", one_pod) == 1
    v5e = launch_mesh.cluster_for_mesh
    monkeypatch.setattr(launch_mesh, "cluster_for_mesh",
                        lambda mm, chips=None, bw=None: v5e(mm, topology.TPU_V5E, bw))
    want = jax_launch_mesh.resolve_stripes("auto", "pallas", jm)
    assert launch_mesh.resolve_stripes("auto", "pallas", m) == want > 1


def _comm_state(c):
    return (c.local_axes, c.pod_axis, [(k, p.summary()) for k, p in c.table.rows],
            c.table.default.summary(), c.table.bounds, c.bucket_bytes,
            c.inventory is not None and repr(c.inventory))


@pytest.mark.parametrize("which", ["v5e", "v4_degraded", "paper", "inventory"])
def test_comm_create_binds_and_clamps_like_the_reference(which):
    """``comm.create(..., topology_slice=, link_inventory=)``: the slowest
    island's inventory is bound at creation and every row's stripes are
    clamped to its healthy links, as the reference does; the binding is not
    part of the communicator's value, and survives ZeRO-3's pod-only
    projection with the table."""
    rows = {("all_reduce", "large"): dict(mode="pipelined", backend="pallas",
                                          n_channels=4, n_stripes=8, wire_quant="int8"),
            ("reduce_scatter", "medium"): dict(mode="hier", backend="pallas", n_stripes=3),
            ("all_gather", "small"): dict(mode="flat", backend="xla", n_stripes=4),
            "broadcast": dict(mode="auto")}
    table = policy.PolicyTable.of({k: policy.CommPolicy(**v) for k, v in rows.items()},
                                  default=policy.CommPolicy("hier", "pallas", n_stripes=6))
    jtable = jax_policy.PolicyTable.of({k: jax_policy.CommPolicy(**v) for k, v in rows.items()},
                                       default=jax_policy.CommPolicy("hier", "pallas",
                                                                     n_stripes=6))
    kw, jkw = {}, {}
    if which == "v5e":
        kw["topology_slice"] = topology.tpu_multipod(2, 4)
        jkw["topology_slice"] = jax_topology.tpu_multipod(2, 4)
    elif which == "v4_degraded":
        kw["topology_slice"] = topology.tpu_mixed_fleet(1, 1, 4)
        jkw["topology_slice"] = jax_topology.tpu_mixed_fleet(1, 1, 4)
        for cl in (kw["topology_slice"], jkw["topology_slice"]):
            for i in (0, 2):
                cl.inventory("pod0").mark_down(i)
            cl.inventory("pod1").mark_degraded(1, 0.5)
    elif which == "paper":
        kw["topology_slice"] = topology.paper_cluster(2, 2)
        jkw["topology_slice"] = jax_topology.paper_cluster(2, 2)
    else:
        inv = transport.LinkInventory.from_chip(topology.TPU_V4)
        jinv = jax_transport.LinkInventory.from_chip(jax_topology.TPU_V4)
        for i in (0, 4):
            inv.mark_down(i)
            jinv.mark_down(i)
        kw["link_inventory"], jkw["link_inventory"] = inv, jinv
    c = comm.create(("data",), "pod", table=table, **kw)
    jc = jax_communicator.create(("data",), "pod", table=jtable, **jkw)
    assert _comm_state(c) == _comm_state(jc)
    assert c.inventory is not None
    unbound = dataclasses.replace(c, inventory=None)
    assert c == unbound and hash(c) == hash(unbound)
    assert comm.create(("data",), "pod", table=table).inventory is None
    pod_only = dataclasses.replace(c, local_axes=())
    assert pod_only.table == c.table and pod_only.inventory is c.inventory


def test_check_runnable_names_the_row():
    """A table row the port cannot run raises with the row named; the
    planner's own tables pass."""
    from repro_torch import plan
    bad = {("all_reduce", "large"): policy.CommPolicy("hier", "pallas", n_stripes=9),
           ("broadcast", "small"): policy.CommPolicy("pipelined"),
           ("all_to_all", "medium"): policy.CommPolicy("hier", "pallas")}
    for key, p in bad.items():
        with pytest.raises(ValueError, match=repr(key[0])):
            comm.check_runnable(policy.PolicyTable.of({key: p}))
    with pytest.raises(ValueError, match="default"):
        comm.check_runnable(policy.PolicyTable.of(
            {}, default=policy.CommPolicy("hier", "pallas", n_stripes=12)))
    for cluster in _clusters(topology).values():
        t = plan.policy_table_for(cluster)
        assert comm.check_runnable(t) is t
