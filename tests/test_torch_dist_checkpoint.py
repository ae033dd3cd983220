"""Checkpoints of a DistMesh program (DESIGN_TORCH.md §28), on the CPU.

A DistMesh rank sees its own state alone; ``checkpoint.save`` with the
program as layout gathers every rank's host copy to rank 0, which writes
the reference's format (a manifest, one ``.npy`` per full logical leaf),
and a restore places each rank's own shards.  Held here, for ZeRO-1 and
ZeRO-3 (reduced smollm-135m, int8 wire with error feedback, so the EF
residuals are in the state): two gloo processes save at step 1 and resume a
ThreadMesh's checkpoint of the same step; a ThreadMesh of the same shape
resumes theirs; both step 2s equal the uninterrupted run bit for bit, and
the two checkpoints hold the same bytes.
"""
import json

import pytest

torch = pytest.importorskip("torch")

import test_torch_dist_ranks  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import balance, mesh  # noqa: E402
from repro_torch.core.tree import leaves  # noqa: E402
from repro_torch.data.pipeline import synthetic_batch  # noqa: E402
from repro_torch.launch.mesh import spawn_dist_mesh  # noqa: E402
from repro_torch.models import build  # noqa: E402
from repro_torch.train import checkpoint  # noqa: E402
from repro_torch.train.trainer import make_train_program  # noqa: E402

CFG = get_config("smollm-135m").reduced()


def _same(a, b) -> bool:
    if isinstance(a, torch.Tensor):
        return torch.equal(a, torch.as_tensor(b))
    return a == b


def _crcs(d):
    with open(d / "manifest.json") as f:
        return [(e["path"], e["shape"], e["dtype"], e["crc"]) for e in json.load(f)["leaves"]]


@pytest.mark.parametrize("zero,shape", [(1, {"pod": 2, "data": 1}), (3, {"pod": 1, "data": 2})])
def test_dist_mesh_checkpoint_round_trips_with_thread_mesh(tmp_path, zero, shape):
    model = build(CFG)
    params = model.init(torch.Generator().manual_seed(5), dtype=torch.float32)
    m = mesh.ThreadMesh(shape, device="cpu")
    prog = make_train_program(model, m, test_torch_dist_ranks.dist_train_rc(zero),
                              balance.uniform_plan(shape["pod"], 2, 1))
    nm, gmb, _ = prog.batch_shape(32)
    batches = [synthetic_batch(0, s, nm, gmb, 32, CFG.vocab) for s in range(2)]
    state = prog.init_fn(params)
    state, met0 = prog.step_fn(state, batches[0])
    checkpoint.save(str(tmp_path / "thread"), 1, state, layout=prog)
    want, met1 = prog.step_fn(state, batches[1])          # uninterrupted

    got = spawn_dist_mesh(test_torch_dist_ranks.train_with_checkpoints, shape,
                          args=(params, zero, str(tmp_path / "thread"), str(tmp_path / "dist")),
                          device="cpu", timeout=240, workdir=str(tmp_path / "ranks"))
    for r, out in enumerate(got):                  # the DistMesh resumed the ThreadMesh's
        assert out["losses"] == [met0["loss"].item(), met1["loss"].item()]
        assert len(out["leaves"]) == len(leaves(want[r]))
        assert all(_same(a, b) for a, b in zip(leaves(want[r]), out["leaves"]))
    assert _crcs(tmp_path / "dist" / "step_00000001") == \
        _crcs(tmp_path / "thread" / "step_00000001")

    step, resumed = checkpoint.restore_latest(str(tmp_path / "dist"), layout=prog)
    assert step == 1
    resumed, met = prog.step_fn(resumed, batches[1])     # the ThreadMesh resumed the DistMesh's
    assert met["loss"].item() == met1["loss"].item()
    for r in range(m.size):
        assert all(_same(a, b) for a, b in zip(leaves(want[r]), leaves(resumed[r])))
