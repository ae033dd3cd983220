"""The codec's launches per training step, by shape, against a real step.

``launch/bench_codec.codec_launch_rows`` counts from a model's leaves and
buckets which rows each codec kernel is launched at in one ZeRO-1 int8+EF
step (the card time per step is priced from it).  Here a reduced
smollm-135m takes one such step on a CPU ``ThreadMesh`` while every call of
the codec's front doors is recorded, and the recorded rows must equal the
count exactly: one bucket and several (ragged against the world, so the
bucket padding shows), on (pod=2, data=2) and (pod=3, data=1), where the
ring has two steps.  At full width the totals are ``chip_smoke.train_counts``'
192 and 272.  Nothing here needs the card; ``torch`` alone (no JAX).
"""
import importlib.util
import threading
from collections import Counter
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import RunConfig  # noqa: E402
from repro_torch.core import balance, hetccl, mesh  # noqa: E402
from repro_torch.core.tree import leaves as tree_leaves  # noqa: E402
from repro_torch.data.pipeline import synthetic_batch  # noqa: E402
from repro_torch.kernels import quant  # noqa: E402
from repro_torch.launch import bench_codec  # noqa: E402
from repro_torch.models import build  # noqa: E402
from repro_torch.train.trainer import make_train_program  # noqa: E402

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(smoke)

CFG = get_config("smollm-135m").reduced()


def _recorded_step(monkeypatch, shape, bucket_bytes):
    """Rows of every codec front-door call in one int8+EF step (all ranks),
    and the leaves and buckets of the step's gradient tree."""
    model = build(CFG)
    m = mesh.ThreadMesh(shape, device="cpu")
    plan = balance.uniform_plan(shape["pod"], 2 * shape["pod"], micro_batch=1)
    rc = RunConfig(collective_mode="hier", backend="pallas", wire_quant="int8",
                   bucket_bytes=bucket_bytes, learning_rate=1e-3)
    prog = make_train_program(model, m, rc, plan)
    params = model.init(torch.Generator().manual_seed(0), dtype=torch.float32)
    batch = synthetic_batch(0, 0, plan.n_micro_max, plan.micro_batch * m.size, 16, CFG.vocab)
    calls, lock = Counter(), threading.Lock()
    quantize, dq_accum = quant.quantize, quant.dequantize_accumulate

    def rec(kernel, numel):
        with lock:
            calls[kernel, -(-numel // quant.DEFAULT_CHUNK)] += 1

    def rec_quantize(x, **kw):
        rec("quant_int8", x.numel())
        return quantize(x, **kw)

    def rec_dq_accum(acc, codes, scales, **kw):
        rec("dq_accum_int8", acc.numel())
        return dq_accum(acc, codes, scales, **kw)

    monkeypatch.setattr(quant, "quantize", rec_quantize)
    monkeypatch.setattr(quant, "dequantize_accumulate", rec_dq_accum)
    prog.step_fn(prog.init_fn(params), batch)
    leaves = [p.float() for p in tree_leaves(params)]
    buckets = hetccl._make_buckets(leaves, bucket_bytes)
    return calls, [p.numel() for p in leaves], \
        [sum(leaves[i].numel() for i in b) for b in buckets], m.size


@pytest.mark.parametrize("shape", [{"pod": 2, "data": 2}, {"pod": 3, "data": 1}],
                         ids=["pod2-data2", "pod3-data1"])
@pytest.mark.parametrize("bucket_bytes", [64 << 20, 700_003], ids=["one_bucket", "buckets"])
def test_launch_rows_match_a_recorded_step(monkeypatch, shape, bucket_bytes):
    calls, leaf_numels, bucket_numels, ranks = _recorded_step(monkeypatch, shape,
                                                              bucket_bytes)
    assert (len(bucket_numels) > 1) == (bucket_bytes < 64 << 20)
    want = bench_codec.codec_launch_rows(leaf_numels, bucket_numels, shape["pod"],
                                         shape["data"])
    got = {k: {} for k in want}
    for (kernel, rows), n in calls.items():
        got[kernel][rows] = n
    assert got == {k: {rows: n * ranks for rows, n in v.items()} for k, v in want.items()}


def test_full_width_step_rows_total_the_train_counts():
    rows = bench_codec.smollm_step_rows()
    model = build(get_config("smollm-135m"))
    n_leaves = len(tree_leaves(model.abstract_params()))
    counts = smoke.train_counts(30, 2, 4, n_leaves, 8, 2)
    assert {k: 4 * sum(v.values()) for k, v in rows.items()} == \
        {k: counts[k] for k in ("quant_int8", "dq_accum_int8")} == \
        {"quant_int8": 192, "dq_accum_int8": 272}
    # the largest leaves, encoded whole by error feedback, and the largest
    # bucket's ring streams (a quarter of the 28.3 M-element embedding)
    assert rows["quant_int8"][55296] == 2 and rows["quant_int8"][13824] == 4
    assert max(rows["quant_int8"]) == max(rows["dq_accum_int8"]) == bench_codec.SHAPES["leaf"]


def test_codec_bytes_are_the_bounds_chip_smoke_states():
    n = 6912 * 512
    assert bench_codec.codec_bytes("quant_int8", 6912) == n * 4 + n + 6912 * 4
    assert bench_codec.codec_bytes("dq_accum_int8", 6912) == n * 9 + 6912 * 4
    assert bench_codec.n_sets(bench_codec.codec_bytes("dq_accum_int8", 55296)) == 4
    assert bench_codec.n_sets(1) == bench_codec.MAX_CALLS
