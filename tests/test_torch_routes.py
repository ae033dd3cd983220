"""Choices the port's kernel wrappers make before a launch, as plain
functions of shapes, strides, dtypes and alignment: no card, no launch.

* ``grouped_matmul.route``: which of the four routes of
  ``csrc/grouped_matmul.cu`` a grouped matmul takes.  Tensors on the
  ``meta`` device carry shapes, strides and byte offsets without memory, so
  Mixtral's full-width shapes cost nothing here.
* ``grouped_matmul.bwd_route``: which of the backward's routes dx = dy wᵀ
  and dw = xᵀ dy each take.
* ``grouped_matmul.stream_plan``: how the decode route's weight stream
  splits a call over the card's SMs (blocks, units, split-K parts), at
  Mixtral's full-width decode shapes.
* ``ring_dma.slot_pitch`` and ``ring_dma.scratch_sizes``: where the fused
  rings' receive slots lie, and how much scratch a launch reserves.
"""
import importlib.util
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import grouped_matmul as gmm  # noqa: E402
from repro_torch.kernels import ring_dma  # noqa: E402

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(smoke)


def _meta(*shape, dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype, device="meta")


def _layer(L, G, K, N, lead=0, pad=0, dtype=torch.bfloat16):
    """w as the model passes it: layer L - 1 of stacked (L, G, K, lead + N +
    pad) weights, columns lead .. lead + N."""
    return _meta(L, G, K, lead + N + pad, dtype=dtype)[-1, :, :, lead:lead + N]


# (name, x, w, route)
ROUTE_CASES = [
    ("mixtral_prefill_w13", _meta(8, 1280, 4096), _meta(8, 4096, 14336), "wgmma"),
    ("mixtral_prefill_w2", _meta(8, 1280, 14336), _meta(8, 14336, 4096), "wgmma"),
    ("mixtral_prefill_layer_slice", _meta(8, 1280, 4096), _layer(32, 8, 4096, 14336), "wgmma"),
    ("mixtral_window_w13", _meta(8, 1440, 4096), _meta(8, 4096, 14336), "wgmma"),
    ("mixtral_window_w2", _meta(8, 1440, 14336), _layer(32, 8, 14336, 4096), "wgmma"),
    ("moonshot_expert", _meta(64, 240, 2048), _meta(64, 2048, 1408), "wgmma"),
    ("m17", _meta(2, 17, 64), _meta(2, 64, 64), "wgmma"),
    ("aligned_column_view", _meta(8, 100, 512), _layer(2, 8, 512, 1000, lead=24, pad=8),
     "wgmma"),
    ("mixtral_decode_w13", _meta(8, 2, 4096), _meta(8, 4096, 14336), "mma16"),
    ("mixtral_decode_w2", _meta(8, 2, 14336), _meta(8, 14336, 4096), "mma16"),
    ("m16_aligned", _meta(4, 16, 256), _meta(4, 256, 256), "mma16"),
    ("m9_k100", _meta(5, 9, 100), _meta(5, 100, 70), "mma16"),
    ("k100", _meta(5, 40, 100), _meta(5, 100, 64), "mma128"),
    ("k300", _meta(8, 64, 300), _meta(8, 300, 48), "mma128"),
    ("odd_view", _meta(4, 33, 256), _layer(2, 4, 256, 500, lead=3, pad=8), "mma128"),
    ("x_offset_by_one_row_of_k8", _meta(2, 41, 8)[:, 1:], _meta(2, 8, 64), "wgmma"),
    ("x_offset_by_one_element", _meta(2 * 40 * 64 + 1)[1:].view(2, 40, 64),
     _meta(2, 64, 64), "mma128"),
    ("n_not_a_multiple_of_8", _meta(4, 200, 96), _meta(4, 96, 100), "mma128"),
    ("f32_prefill", _meta(8, 1280, 4096, dtype=torch.float32),
     _meta(8, 4096, 14336, dtype=torch.float32), "f32"),
    ("f32_decode", _meta(8, 2, 64, dtype=torch.float32), _meta(8, 64, 64, dtype=torch.float32),
     "f32"),
]


@pytest.mark.parametrize("name,x,w,want", ROUTE_CASES, ids=[c[0] for c in ROUTE_CASES])
def test_gmm_route(name, x, w, want):
    assert gmm.route(x, w) == want


def test_gmm_routes_of_the_smoke_cases():
    """chip_smoke's GMM_CASES reach every route, and each Mixtral prefill and
    window shape the wgmma route, each decode shape the 16-row route."""
    got = {}
    for name, G, M, K, N, dt, layout in smoke.GMM_CASES:
        dtype = getattr(torch, dt)
        lead = {"layer_view": 24, "odd_view": 3}.get(layout, 0)
        w = (_layer(2, G, K, N, lead=lead, pad=8 if lead else 0, dtype=dtype)
             if lead or layout == "layer" else _meta(G, K, N, dtype=dtype))
        got[name] = gmm.route(_meta(G, M, K, dtype=dtype), w)
    assert set(got.values()) == set(gmm.ROUTES)
    for name, r in got.items():
        if name.startswith("mixtral_prefill") or name.startswith("mixtral_window") \
                or name.startswith("wgmma_"):
            assert r == "wgmma", name
        if name.startswith("mixtral_decode"):
            assert r == "mma16", name
    for name, (G, M, K, N) in smoke.GMM_TIMED.items():
        assert gmm.route(_meta(G, M, K), _meta(G, K, N)) == (
            "mma16" if name.startswith("decode") else "wgmma"), name


# (name, x, w, dy, (dx route, dw route)): the capacity buffer's products at
# Mixtral's and moonshot's shapes (w a layer slice, as the model passes it),
# the capacity at or below 16 rows, widths not a multiple of 8, rows TMA
# cannot describe (of w alone: dw takes TMA), an output gradient that is not dense in N (autograd's
# gradient of a sum is an expanded one) and f32
BWD_ROUTE_CASES = [
    ("mixtral_w13", _meta(8, 1280, 4096), _layer(32, 8, 4096, 14336), _meta(8, 1280, 14336),
     ("dx_wgmma", "dw_wgmma")),
    ("mixtral_w2", _meta(8, 1440, 14336), _layer(32, 8, 14336, 4096), _meta(8, 1440, 4096),
     ("dx_wgmma", "dw_wgmma")),
    ("moonshot_w13", _meta(64, 480, 2048), _layer(48, 64, 2048, 1408), _meta(64, 480, 1408),
     ("dx_wgmma", "dw_wgmma")),
    ("m17", _meta(2, 17, 64), _meta(2, 64, 64), _meta(2, 17, 64), ("dx_wgmma", "dw_wgmma")),
    ("m16", _meta(2, 16, 64), _meta(2, 64, 64), _meta(2, 16, 64), ("dx_simt", "dw_simt")),
    ("k100", _meta(3, 200, 100), _meta(3, 100, 64), _meta(3, 200, 64), ("dx_simt", "dw_simt")),
    ("n70", _meta(3, 200, 64), _meta(3, 64, 70), _meta(3, 200, 70), ("dx_simt", "dw_simt")),
    ("odd_view", _meta(4, 33, 256), _layer(2, 4, 256, 500, lead=3, pad=8), _meta(4, 33, 500),
     ("dx_simt", "dw_simt")),
    ("w_unaligned", _meta(4, 33, 256), _layer(2, 4, 256, 512, lead=3, pad=8),
     _meta(4, 33, 512), ("dx_simt", "dw_wgmma")),
    ("expanded_dy", _meta(2, 40, 64), _meta(2, 64, 32), _meta(1, 1, 1).expand(2, 40, 32),
     ("dx_simt", "dw_simt")),
    ("f32", _meta(4, 80, 128, dtype=torch.float32), _meta(4, 128, 128, dtype=torch.float32),
     _meta(4, 80, 128, dtype=torch.float32), ("dx_simt", "dw_simt")),
]


@pytest.mark.parametrize("name,x,w,dy,want", BWD_ROUTE_CASES,
                         ids=[c[0] for c in BWD_ROUTE_CASES])
def test_gmm_bwd_route(name, x, w, dy, want):
    assert (gmm.bwd_route(x, w, dy, "dx"), gmm.bwd_route(x, w, dy, "dw")) == want


def test_gmm_bwd_routes_of_the_smoke_cases():
    """chip_smoke's GMM_BWD_CASES reach every backward route, each Mixtral
    and moonshot shape the wgmma routes, and so do GMM_BWD_TIMED's."""
    got = {}
    for name, G, M, K, N, dt, layout in smoke.GMM_BWD_CASES:
        dtype = getattr(torch, dt)
        lead = {"layer_view": 24, "odd_view": 3}.get(layout, 0)
        w = (_layer(2, G, K, N, lead=lead, pad=8 if lead else 0, dtype=dtype)
             if lead or layout == "layer" else _meta(G, K, N, dtype=dtype))
        x, dy = _meta(G, M, K, dtype=dtype), _meta(G, M, N, dtype=dtype)
        for which in ("dx", "dw"):
            got[(name, which)] = gmm.bwd_route(x, w, dy, which)
    assert set(got.values()) == set(gmm.BWD_ROUTES)
    for (name, which), r in got.items():
        if name.startswith(("mixtral", "moonshot", "wgmma_")):
            assert r == f"{which}_wgmma", (name, which)
    for G, M, K, N in smoke.GMM_BWD_TIMED.values():
        x, w, dy = _meta(G, M, K), _meta(G, K, N), _meta(G, M, N)
        assert [gmm.bwd_route(x, w, dy, which) for which in ("dx", "dw")] == \
            ["dx_wgmma", "dw_wgmma"]


def test_gmm_route_counts_on_the_cpu_stay_zero():
    """On a CPU tensor the wrapper runs the plain version: no launch is
    counted on any route."""
    gmm.reset_counts()
    x = torch.randn(2, 20, 16, dtype=torch.bfloat16)
    w = torch.randn(2, 16, 8, dtype=torch.bfloat16)
    torch.testing.assert_close(gmm.grouped_matmul(x, w).float(),
                               torch.einsum("gmk,gkn->gmn", x.float(), w.float()),
                               rtol=1e-2, atol=1e-2)
    assert gmm.launches == 0 and set(gmm.route_launches.values()) == {0}
    x.requires_grad_()
    torch.autograd.grad(gmm.grouped_matmul(x, w).float().sum(), x)
    assert gmm.bwd_launches == 0 and set(gmm.bwd_route_launches.values()) == {0}


# (name, x, w, SMs): Mixtral-8x7B's decode gmm (w13 and w2, as the model
# passes them: a layer of the stacked weights), one row, sixteen rows, and a
# small call with fewer units than SMs
STREAM_CASES = [
    ("mixtral_decode_w13", _meta(8, 2, 4096), _layer(32, 8, 4096, 14336), 132),
    ("mixtral_decode_w2", _meta(8, 2, 14336), _layer(32, 8, 14336, 4096), 132),
    ("mixtral_decode_m1", _meta(8, 1, 4096), _meta(8, 4096, 14336), 132),
    ("m16_ragged", _meta(3, 16, 1000), _meta(3, 1000, 696), 132),
    ("fewer_units_than_sms", _meta(5, 9, 104), _meta(5, 104, 72), 132),
]


@pytest.mark.parametrize("name,x,w,sms", STREAM_CASES, ids=[c[0] for c in STREAM_CASES])
def test_stream_plan_splits_the_units_evenly(name, x, w, sms):
    """The decode route's plan from shapes alone (meta tensors): the call
    takes the weight stream, every unit belongs to exactly one block's run,
    runs differ by at most one unit, every tile's parts are consecutive
    blocks (at most two where a run is longer than a tile), and the scratch
    holds two part slots per block."""
    G, M, K = x.shape
    N = w.shape[2]
    assert gmm.route(x, w) == "mma16" and gmm._tma_rows(x, w)
    plan = gmm.stream_plan(G, M, K, N, sms)
    assert plan.blocks == min(sms, plan.units)
    assert plan.units == G * -(-N // gmm.STREAM_BN) * -(-K // gmm.STREAM_BK)
    runs = [plan.start(b + 1) - plan.start(b) for b in range(plan.blocks)]
    assert plan.start(0) == 0 and plan.start(plan.blocks) == plan.units
    assert max(runs) - min(runs) <= 1 and min(runs) >= 1
    owners = [plan.owner(u) for u in range(plan.units)]
    assert owners == sorted(owners)
    assert all(plan.start(b) <= u < plan.start(b + 1) for u, b in enumerate(owners))
    parts = [plan.parts(t) for t in range(G * plan.n_tiles)]
    assert all(p.step == 1 and len(p) >= 1 for p in parts)
    if min(runs) >= plan.units_per_tile:
        assert max(len(p) for p in parts) <= 2
    assert plan.scratch_floats == plan.blocks * 2 * plan.threads * 16 * plan.m_tiles
    if name.startswith("mixtral_decode"):       # one block per SM, equal shares
        assert plan.blocks == sms and max(runs) == -(-plan.units // sms)
        assert plan.units * plan.bk * plan.bn * 2 >= K * N * G * 2


def test_stream_plan_at_mixtral_decode_in_numbers():
    """Mixtral's decode gmm on 132 SMs: w13 224 tiles (28 per expert, each 64
    units of 64 K rows), w2 64 tiles (8 per expert, each 224 units); 14336
    units, 108 or 109 per block; split tiles in two parts at most."""
    for (K, N), tiles, per_tile in (((4096, 14336), 224, 64), ((14336, 4096), 64, 224)):
        plan = gmm.stream_plan(8, 2, K, N, 132)
        assert (plan.G * plan.n_tiles, plan.units_per_tile, plan.units) == (tiles, per_tile, 14336)
        runs = {plan.start(b + 1) - plan.start(b) for b in range(132)}
        assert runs == {108, 109}
        assert max(len(plan.parts(t)) for t in range(tiles)) == (2 if per_tile < 108 else 3)


def test_stream_plan_takes_the_library_geometry():
    """Planned with another unit shape (as ``grouped_matmul`` does with the
    loaded library's geometry), the same call splits into that shape's units."""
    plan = gmm.stream_plan(8, 2, 4096, 14336, 132, geometry=(256, 128, 128))
    assert (plan.n_tiles, plan.units_per_tile, plan.blocks) == (56, 32, 132)
    assert plan.scratch_floats == 132 * 2 * 128 * 16


def test_decode_rows_tma_cannot_describe_take_the_16_row_tile():
    """An unaligned view stays on the decode route, without the stream."""
    x = _meta(4, 9, 256)
    w = _layer(2, 4, 256, 500, lead=3, pad=8)
    assert gmm.route(x, w) == "mma16" and not gmm._tma_rows(x, w)


@pytest.mark.parametrize("esize", [4, 2])
@pytest.mark.parametrize("c,want4,want2", [(1_000_000, 1_000_000, 1_000_000),
                                           (1_000_003, 1_000_004, 1_000_008),
                                           (14_155_776, 14_155_776, 14_155_776),
                                           (7, 8, 8), (1, 4, 8), (10, 12, 16)])
def test_slot_pitch(esize, c, want4, want2):
    """c rounded up to whole 16-byte vectors: every slot of every rank starts
    16-byte aligned, and no slot is wider than it needs be."""
    pitch = ring_dma.slot_pitch(c, esize)
    assert pitch == (want4 if esize == 4 else want2)
    assert pitch >= c and (pitch * esize) % 16 == 0 and (pitch - c) * esize < 16


@pytest.mark.parametrize("kind", ["rs", "ag"])
@pytest.mark.parametrize("R,c,esize", [(4, 1_000_003, 4), (4, 1_000_003, 2), (2, 7, 4),
                                       (3, 100_003, 2), (4, 14_155_776, 4)])
def test_scratch_holds_every_slot_at_the_pitch(kind, R, c, esize):
    """_Scratch reserves what scratch_sizes says: for the all-gather two
    slots per rank at the pitch of its ``esize``-byte words and no partials;
    for the reduce-scatter, which pulls, no slots and two f32 partials per
    rank at the f32 pitch (whatever the wire's size).  The last buffer's
    last element lies inside the reservation, and every buffer starts
    16-byte aligned."""
    acc_elems, slot_bytes = ring_dma.scratch_sizes(R, c, esize, kind == "rs")
    unit = 4 if kind == "rs" else esize
    pitch = ring_dma.slot_pitch(c, unit)
    assert slot_bytes == (0 if kind == "rs" else R * 2 * pitch * esize)
    assert acc_elems == (R * 2 * pitch if kind == "rs" else 0)
    offsets = [(r * 2 + par) * pitch * unit for r in range(R) for par in (0, 1)]
    assert all(o % 16 == 0 for o in offsets)
    assert offsets[-1] + c * unit <= max(slot_bytes, acc_elems * 4)
    sc = ring_dma._Scratch("cpu", R, ctas=3)
    sc.reserve(acc_elems, slot_bytes)
    assert sc.slots.numel() == slot_bytes and sc.acc.numel() == acc_elems
    sc.reserve(*ring_dma.scratch_sizes(R, c // 2 + 1, esize, kind == "rs"))
    assert sc.slots.numel() == slot_bytes and sc.acc.numel() == acc_elems   # kept
    assert sc.seq == 2
