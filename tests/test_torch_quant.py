"""The port's int8 and fp8 wire codecs, quantized rings and collectives
against the JAX package's, on the same inputs.

Inputs come from a seeded numpy RandomState and go to both packages.  On the
CPU the port's codec runs its plain versions (``ref.wire_quantize``,
``ref.wire_dequant_accum``); the JAX codec runs under ``jax.jit``, the only
context the reference's rings run it in (ROADMAP C4), and its rings run the
Pallas codec kernels in interpret mode, as tests/test_kernels.py runs them.

What holds, from the readings on these inputs:

* codes and scales are equal bit for bit (the port computes the scale as
  absmax times the f32 reciprocal of 127, which is what XLA makes of the
  reference's ``absmax / 127``);
* ``dequantize_accumulate`` is within one ulp: the port rounds the product
  and the sum on their own, XLA on the CPU fuses them into an FMA (about a
  quarter of the elements differ by one ulp, none by more);
* a quantized ring adds at most one ulp per hop, an ulp of the largest
  partial sum (the sum of the ranks' magnitudes); every all-gather is equal
  bit for bit (its decode adds to zero).

The kernels themselves are held against the plain versions on the card
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

from repro.core import compat  # noqa: E402
from repro.core import hetccl as jax_hetccl  # noqa: E402
from repro.core import tacc as jax_tacc  # noqa: E402
from repro.kernels import ops as jax_ops  # noqa: E402,F401  (registers the codec)
from repro.kernels import quant as jq  # noqa: E402
from repro.kernels import ring_dma as jax_ring  # noqa: E402
from repro_torch.core import hetccl, mesh, tacc  # noqa: E402
from repro_torch.core.tree import leaves  # noqa: E402
from repro_torch.kernels import quant, ref, ring_dma  # noqa: E402

JAX_KERNEL_OPS = ("collective_reduce", "wire_quantize", "wire_dequant_accum")


@pytest.fixture(scope="module", autouse=True)
def interpret_kernels():
    """The JAX rings run the Pallas codec and reduce kernels in interpret
    mode; restored afterwards."""
    prev = {op: jax_tacc.get_default(op) for op in JAX_KERNEL_OPS}
    for op in JAX_KERNEL_OPS:
        jax_tacc.set_default(op, "interpret")
    yield
    for op, v in prev.items():
        jax_tacc.set_default(op, v)


def _bits(a) -> np.ndarray:
    return np.asarray(a, np.float32).view(np.int32)


def _assert_same_bits(got, want):
    """Equal bit for bit, NaN where NaN (NaN payloads may differ by device)."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    nan = np.isnan(want)
    np.testing.assert_array_equal(np.isnan(got), nan)
    np.testing.assert_array_equal(_bits(got)[~nan], _bits(want)[~nan])


def _assert_within_ulps(got, want, ulps, of=None):
    """Within ``ulps`` ulps of each element of ``want`` or, given ``of``, of
    that magnitude: a sum whose terms cancel carries the rounding of its
    larger terms."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    nan = np.isnan(want)
    np.testing.assert_array_equal(np.isnan(got), nan)
    d = np.abs(got[~nan].astype(np.float64) - want[~nan])
    unit = np.spacing(np.abs(want[~nan])) if of is None else np.spacing(np.float32(of))
    assert (d <= ulps * unit).all(), (d.max(), (d > 0).mean())


def _payload(case: str, n: int, seed: int = 0) -> np.ndarray:
    """Codec inputs: ragged lengths and the edges of the int8 grid."""
    rng = np.random.RandomState(seed)
    x = (rng.randn(n) * rng.choice([1e-3, 1.0, 1e3], size=n)).astype(np.float32)
    if case == "zero_chunks":                   # whole chunks of zeros: scale 1
        x[:1024] = 0.0
        x[-(n % 512 or 512):] = 0.0
    elif case == "half_way":                    # x / scale = k + 0.5 exactly
        x = np.zeros(n, np.float32)
        x[:] = (np.arange(n) % 254 - 127).astype(np.float32) + 0.5
        x[::512] = 127.0                        # absmax 127: scale 1
    elif case == "at_absmax":                   # +-absmax codes to +-127
        x[::97] = 1000.0
        x[5::97] = -1000.0
    elif case == "nan_chunk":                   # a NaN: that chunk's scale is 1
        x[700] = np.nan
    return x


CASES = [("random", n) for n in (1, 511, 512, 513, 4097, 100_003)] + [
    ("zero_chunks", 4000), ("half_way", 3000), ("at_absmax", 2048), ("nan_chunk", 1500)]


@functools.lru_cache(maxsize=None)
def _jax_codec(case, n):
    x = _payload(case, n)
    acc = np.random.RandomState(1).randn(n).astype(np.float32)
    res = np.random.RandomState(2).randn(n).astype(np.float32)
    codes, scales = jax.jit(jq.quantize)(x)
    return x, acc, res, {
        "codes": np.asarray(codes), "scales": np.asarray(scales),
        "dq": np.asarray(jax.jit(jq.dequantize_accumulate)(acc, codes, scales)),
        "compress": np.asarray(jax.jit(jq.compress)(x)),
        "ef": [np.asarray(t) for t in jax.jit(jq.ef_compress)(x, res)]}


@pytest.mark.parametrize("case,n", CASES, ids=[f"{c}-{n}" for c, n in CASES])
def test_int8_codec_matches_jitted_jax(case, n):
    x, acc, res, want = _jax_codec(case, n)
    before = (quant.quant_launches, quant.dq_launches)
    codes, scales = quant.quantize(torch.from_numpy(x))
    assert codes.dtype == torch.int8 and tuple(codes.shape) == x.shape
    assert tuple(scales.shape) == (-(-n // quant.DEFAULT_CHUNK), 1)
    np.testing.assert_array_equal(codes.numpy(), want["codes"])          # bitwise
    _assert_same_bits(scales.numpy(), want["scales"])                    # bitwise
    dq = quant.dequantize_accumulate(torch.from_numpy(acc), codes, scales)
    _assert_within_ulps(dq.numpy(), want["dq"], 1)      # XLA fuses an FMA here
    _assert_within_ulps(quant.compress(torch.from_numpy(x)).numpy(), want["compress"], 1)
    c, r = quant.ef_compress(torch.from_numpy(x), torch.from_numpy(res))
    _assert_within_ulps(c.numpy(), want["ef"][0], 1)
    # the residual is y - c: c's one ulp, and nothing more
    y = (x + res).astype(np.float32)
    np.testing.assert_array_less(np.abs(r.numpy() - want["ef"][1])[~np.isnan(y)],
                                 np.spacing(np.abs(want["ef"][0][~np.isnan(y)])) * 1.01
                                 + 1e-45)
    assert (quant.quant_launches, quant.dq_launches) == before   # CPU: no kernel


def test_int8_codec_edges():
    """Zero chunk -> scale 1 and codes 0; halves round to even; +-absmax ->
    +-127; a NaN chunk stores scale 1 and the NaN's code is 0 (what the
    jitted reference does with ``jnp.max``'s NaN)."""
    x = torch.zeros(3, 512)
    x[1, :4] = torch.tensor([127.0, 0.5, 1.5, -2.5])
    x[2, 0], x[2, 1], x[2, 2] = float("nan"), 3.0, -1000.0
    codes, scales = ref.wire_quantize(x)
    assert scales[:, 0].tolist() == [1.0, 1.0, 1.0]
    assert codes[0].abs().sum() == 0
    assert codes[1, :4].tolist() == [127, 0, 2, -2]
    assert codes[2, :3].tolist() == [0, 3, -127]


@pytest.mark.parametrize("n", [1, 777, 4096])
def test_fp8_codec_matches_jax_bitwise(n):
    x = _payload("random", n, seed=3)
    codes, scales = jax.jit(functools.partial(jq.quantize, codec="fp8"))(x)
    got_c, got_s = quant.quantize(torch.from_numpy(x), codec="fp8")
    assert got_c.dtype == torch.uint8
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(codes))
    _assert_same_bits(got_s.numpy(), np.asarray(scales))
    want = jax.jit(functools.partial(jq.dequantize, codec="fp8"))(codes, scales)
    _assert_within_ulps(quant.dequantize(got_c, got_s, codec="fp8").numpy(),
                        np.asarray(want), 1)
    # the software codec on every byte, and the saturating encode past 448
    allb = np.arange(256, dtype=np.uint8)
    allb = allb[(allb & 0x7F) != 0x7F]                  # 0x7f / 0xff are NaN codes
    _assert_same_bits(ref.decode_e4m3(torch.from_numpy(allb)).numpy(),
                      np.asarray(jq.decode_e4m3(jnp.asarray(allb))))
    y = np.concatenate([np.linspace(-600, 600, 4001), [448.0, 449.0, 1e9, -1e9]]) \
        .astype(np.float32)
    np.testing.assert_array_equal(ref.encode_e4m3(torch.from_numpy(y)).numpy(),
                                  np.asarray(jq.encode_e4m3(jnp.asarray(y))))
    assert not ((ref.encode_e4m3(torch.from_numpy(y)).numpy() & 0x7F) == 0x7F).any()


def test_ef_compress_telescopes():
    """sum(compressed_t) + residual_T == sum(x_t) + residual_0, to f32
    rounding of the running sums."""
    rng = np.random.RandomState(4)
    xs = [torch.from_numpy(rng.randn(2000).astype(np.float32)) for _ in range(10)]
    r = torch.zeros(2000)
    total_c = torch.zeros(2000, dtype=torch.float64)
    for x in xs:
        c, r = quant.ef_compress(x, r)
        total_c += c.double()
    want = sum(x.double() for x in xs)
    torch.testing.assert_close(total_c + r.double(), want, rtol=0, atol=1e-5)
    assert r.abs().max() < 0.05             # the residual stays one grid step small


def test_wire_bytes_and_refusals():
    assert quant.wire_bytes_per_elem(None) == 4.0
    assert quant.wire_bytes_per_elem("int8") == 1.0 + 4 / 512
    with pytest.raises(ValueError):
        quant.wire_bytes_per_elem("int4")
    with pytest.raises(ValueError):
        ref.wire_quantize(torch.zeros(1, 512), codec="int4")
    meta = torch.empty(2, 512, device="meta")
    before = (quant.quant_launches, quant.dq_launches)
    with pytest.raises(ValueError):
        quant.wire_quantize_int8(meta)
    with pytest.raises(ValueError):
        quant.wire_dequant_accum_int8(meta, meta.to(torch.int8), meta[:, :1])
    assert (quant.quant_launches, quant.dq_launches) == before
    assert tacc.resolve("wire_quantize", device_type="cpu") is ref.wire_quantize
    assert tacc.resolve("wire_quantize", device_type="cuda") is quant.wire_quantize_cuda
    assert tacc.resolve("wire_dequant_accum", device_type="cuda") \
        is quant.wire_dequant_accum_cuda


# ---------------------------------------------------------------------------
# Quantized rings: shard_map on a ring of n host devices against a ThreadMesh
# ---------------------------------------------------------------------------

RINGS = {"rs": (jax_ring.ring_reduce_scatter, ring_dma.ring_reduce_scatter, "rs"),
         "rs_bidir": (jax_ring.ring_reduce_scatter_bidir, ring_dma.ring_reduce_scatter_bidir,
                      "rs"),
         "ag": (jax_ring.ring_all_gather, ring_dma.ring_all_gather, "ag"),
         "ag_bidir": (jax_ring.ring_all_gather_bidir, ring_dma.ring_all_gather_bidir, "ag")}


def _ring_inputs(n):
    rng = np.random.RandomState(n)
    # reduce-scatter chunks of 1503 elements: ragged against the 512-grid,
    # and odd, so the two streams' halves differ in length
    return {"rs": [(rng.randn(n * 1503) * 10).astype(np.float32) for _ in range(n)],
            "ag": [rng.randn(1100).astype(np.float32) for _ in range(n)]}


@functools.lru_cache(maxsize=None)
def _jax_quant_rings(n, k):
    xs = _ring_inputs(n)
    ring = Mesh(np.array(jax.devices()[:n]), ("pod",))

    def f(rs_in, ag_in):
        v = {"rs": rs_in, "ag": ag_in}
        return {name: fn(v[kind], "pod", n_stripes=k, wire_quant="int8")[None]
                for name, (fn, _, kind) in RINGS.items()}

    sm = compat.shard_map(f, mesh=ring, in_specs=(P("pod"), P("pod")),
                          out_specs={name: P("pod") for name in RINGS},
                          axis_names={"pod"}, check_vma=False)
    out = jax.jit(sm)(np.concatenate(xs["rs"]), np.concatenate(xs["ag"]))
    return {name: np.asarray(v) for name, v in out.items()}


@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("n", [2, 3, 4])
@pytest.mark.parametrize("name", sorted(RINGS))
def test_quantized_ring_matches_jax(name, n, k):
    want = _jax_quant_rings(n, k)[name]
    _, port_fn, kind = RINGS[name]
    xs = [torch.from_numpy(a) for a in _ring_inputs(n)[kind]]
    got = torch.stack(mesh.ThreadMesh({"pod": n}, device="cpu").run(
        lambda v: port_fn(v, "pod", n_stripes=k, wire_quant="int8"), xs)).numpy()
    if kind == "ag":
        _assert_same_bits(got, want)
    else:                      # one ulp of the partial per hop (the FMA above)
        _assert_within_ulps(got, want, n - 1,
                            of=np.abs(np.stack([x.numpy() for x in xs])).sum(0).max())


def test_quantized_ring_takes_the_emulated_schedule_and_the_codec():
    """A codec ring runs the codec's TACC ops on every hop and never the
    fused schedule, and its result lies on the sum of the grid values."""
    seen = []
    orig = {op: tacc.resolve(op, device_type="cpu")
            for op in ("wire_quantize", "wire_dequant_accum")}
    for op, fn in orig.items():
        tacc.register(op, "counting")(lambda *a, _op=op, _fn=fn, **kw: (seen.append(_op),
                                                                        _fn(*a, **kw))[1])
    tacc.set_platform("counting")
    try:
        xs = [torch.full((4 * 600,), float(r + 1)) for r in range(4)]
        got = mesh.ThreadMesh({"pod": 4}, device="cpu").run(
            lambda v: ring_dma.ring_reduce_scatter(v, "pod", wire_quant="int8"), xs)
    finally:
        tacc.set_platform(None)
    # 3 hops x 2 streams: quantize and dequantize-accumulate each, per rank
    assert seen.count("wire_quantize") == seen.count("wire_dequant_accum") == 4 * 3 * 2
    for g in got:
        torch.testing.assert_close(g, torch.full((600,), 10.0), rtol=0, atol=1e-5)


# ---------------------------------------------------------------------------
# Collectives with the codec: hier / pipelined all_reduce, tree_all_reduce
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_mesh():
    return compat.make_mesh((2, 2), ("pod", "data"))


def _jax_per_rank(jmesh, fn, x):
    sm = compat.shard_map(lambda v: jax.tree.map(lambda o: o[None], fn(v)), mesh=jmesh,
                          in_specs=P(("pod", "data")), out_specs=P(("pod", "data")),
                          axis_names={"pod", "data"}, check_vma=False)
    return jax.tree.map(np.asarray, jax.jit(sm)(x))


@pytest.mark.parametrize("op", ["all_reduce", "all_gather", "reduce_scatter"])
@pytest.mark.parametrize("mode", ["hier", "pipelined"])
def test_quantized_collective_matches_jax(jax_mesh, mode, op):
    """The codec rides the cross-pod ring; a bf16 cross_dtype beside it is
    cleared (the codec owns the wire format)."""
    rng = np.random.RandomState(5)
    x = (rng.randn(4 * 2048, 3) * 4).astype(np.float32)
    kw = dict(mode=mode, local_axes=("data",), pod_axis="pod", backend="pallas",
              n_channels=2, wire_quant="int8")
    jcfg = jax_hetccl.HetCCLConfig(cross_dtype=jnp.bfloat16, **kw)
    cfg = hetccl.HetCCLConfig(cross_dtype=torch.bfloat16, **kw)
    want = _jax_per_rank(jax_mesh, lambda v: getattr(jax_hetccl, op)(v, jcfg), x)
    got = mesh.ThreadMesh({"pod": 2, "data": 2}, device="cpu").run(
        lambda v: getattr(hetccl, op)(v, cfg),
        [torch.from_numpy(p.copy()) for p in np.split(x, 4)])
    got = torch.stack(got).numpy()
    assert got.dtype == np.float32
    if op == "all_gather":
        _assert_same_bits(got, want)
    else:                      # one hop on the pod ring, then the local sum
        _assert_within_ulps(got, want, 2, of=4 * np.abs(x).max())


@pytest.mark.parametrize("mode", ["hier", "pipelined"])
def test_quantized_tree_all_reduce_matches_jax(jax_mesh, mode):
    """Buckets of a reduced-smollm-shaped tree (16 KiB) through the
    quantized reduce-scatter and all-gather, per rank, against JAX."""
    from repro_torch.configs import get_config
    from repro_torch.models import build
    from repro_torch.models.common import tree_map_meta
    shapes = tree_map_meta(lambda m: tuple(m.shape),
                           build(get_config("smollm-135m").reduced()).abstract_params())
    rng = np.random.RandomState(6)
    trees = [jax.tree.map(lambda s: rng.randn(*s).astype(np.float32), shapes,
                          is_leaf=lambda s: isinstance(s, tuple)) for _ in range(4)]
    leaves0, treedef = jax.tree.flatten(trees[0])
    stacked = [np.stack([jax.tree.leaves(t)[i] for t in trees]) for i in range(len(leaves0))]
    kw = dict(mode=mode, local_axes=("data",), pod_axis="pod", backend="pallas",
              bucket_bytes=16384, n_channels=2, wire_quant="int8")
    jcfg = jax_hetccl.HetCCLConfig(**kw)
    cfg = hetccl.HetCCLConfig(**kw)

    def jfn(*ls):
        tree = jax.tree.unflatten(treedef, [lf[0] for lf in ls])
        return tuple(o[None] for o in jax.tree.leaves(jax_hetccl.tree_all_reduce(tree, jcfg)))

    sm = compat.shard_map(jfn, mesh=jax_mesh, in_specs=(P(("pod", "data")),) * len(stacked),
                          out_specs=(P(("pod", "data")),) * len(stacked),
                          axis_names={"pod", "data"}, check_vma=False)
    want = [np.asarray(o)[:, 0] for o in jax.jit(sm)(*[s[:, None] for s in stacked])]
    got = mesh.ThreadMesh({"pod": 2, "data": 2}, device="cpu").run(
        lambda t: hetccl.tree_all_reduce(t, cfg), [jax.tree.map(torch.from_numpy, t)
                                                   for t in trees])
    for i, w in enumerate(want):
        port = np.stack([leaves(g)[i].numpy() for g in got])
        _assert_within_ulps(port, w, 2, of=np.abs(stacked[i]).sum(0).max())


def test_addcmul_yardstick_is_the_dequantize_accumulate():
    """``torch.addcmul(acc, codes, scales)``, the one-call yardstick that
    chip_smoke.py times beside ``dq_accum_int8`` (the port never calls it),
    computes the same function: f32 out, and within one f32 ulp of the sum
    plus one of the product of ``acc + codes.float() * scales`` (the plain
    version rounds the product and the sum; the CPU's addcmul fuses them)."""
    rng = np.random.RandomState(5)
    acc = torch.from_numpy(rng.randn(300, 512).astype(np.float32))
    x = torch.from_numpy((rng.randn(300, 512) * np.exp(rng.randn(300, 1) * 3)).astype(np.float32))
    codes, scales = quant.wire_quantize_int8(x)
    got = torch.addcmul(acc, codes, scales)
    want = ref.wire_dequant_accum(acc, codes, scales)
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert torch.equal(want, acc + codes.float() * scales)

    def ulp(t):
        return torch.nextafter(t.abs(), torch.full_like(t, np.inf)) - t.abs()

    assert bool(((got - want).abs() <= ulp(want) + ulp(codes.float() * scales)).all())


def test_codec_wrappers_check_their_arguments_on_every_device():
    """The int8 wrappers refuse malformed arguments before they pick a route,
    so a CPU call is held to what the kernel takes; nothing is counted."""
    x = torch.zeros(4, 512)
    codes, scales = quant.wire_quantize_int8(x)
    before = (quant.quant_launches, quant.dq_launches)
    for bad in (torch.zeros(2, 2, 512), torch.zeros(512)):
        with pytest.raises(ValueError, match="nchunks, chunk"):
            quant.wire_quantize_int8(bad)
    for args in ((x, codes.float(), scales),              # codes not int8
                 (x, codes[:3], scales),                   # codes of another shape
                 (x, codes, scales[:3]),                   # a scale missing
                 (x[0], codes[0], scales[:1])):            # not (nchunks, chunk)
        with pytest.raises(ValueError, match="expected"):
            quant.wire_dequant_accum_int8(*args)
    with pytest.raises(ValueError, match="is on meta"):
        quant.wire_dequant_accum_int8(x, codes.to("meta"), scales)
    assert (quant.quant_launches, quant.dq_launches) == before
    assert torch.equal(quant.wire_dequant_accum_int8(x, codes, scales), x)


def test_f32_shortcut_passes_a_contiguous_f32_tensor_through():
    """The wrappers hand a contiguous f32 tensor to the kernel as it is (no
    copy, no dispatch) and convert anything else."""
    rng = np.random.RandomState(7)
    x = torch.from_numpy(rng.randn(6, 512).astype(np.float32))
    assert quant._f32(x) is x
    for other in (x.bfloat16(), x.double(), x.t(), x[:, ::2]):
        got = quant._f32(other)
        assert got is not other and got.dtype == torch.float32 and got.is_contiguous()
        assert torch.equal(got, other.float())
