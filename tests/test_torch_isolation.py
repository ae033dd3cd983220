"""The port stands alone: no JAX, nothing of ``repro``, and no silent CPU.

Each check runs in a fresh interpreter, so the modules loaded by the test
process itself (which imports both packages elsewhere) do not count.
"""
import json
import os
import pathlib
import re
import shutil
import subprocess
import sys

import pytest

pytest.importorskip("torch")

ROOT = pathlib.Path(__file__).resolve().parent.parent
SRC = ROOT / "src"
PORT = SRC / "repro_torch"


def _run(args, cwd=ROOT, with_src=True, timeout=240):
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    if with_src:
        env["PYTHONPATH"] = str(SRC)
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=timeout)


FOREIGN = r"(jax|jaxlib|repro)(\.|$)"

PROBE = f"""
import importlib, json, pkgutil, re, sys
import repro_torch
for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
    importlib.import_module(m.name)
from repro_torch.launch import serve
done = serve.main(["--device", "cpu", "--reduced", "--batch", "2",
                   "--prompt-len", "16", "--max-new", "3"])
assert len(done) == 2 and all(len(r.out) == 3 for r in done)
done = serve.main(["--arch", "mixtral-8x7b", "--device", "cpu", "--reduced", "--batch", "2",
                   "--prompt-len", "80", "--max-new", "3"])
assert len(done) == 2 and all(len(r.out) == 3 for r in done)
for arch in ("mamba2-2.7b", "zamba2-7b"):
    done = serve.main(["--arch", arch, "--device", "cpu", "--reduced", "--batch", "2",
                       "--prompt-len", "64", "--max-new", "3"])
    assert len(done) == 2 and all(len(r.out) == 3 for r in done)
for arch in ("qwen2-vl-72b", "whisper-medium"):
    done = serve.main(["--arch", arch, "--device", "cpu", "--reduced", "--batch", "2",
                       "--prompt-len", "16", "--max-new", "3"])
    assert len(done) == 2 and all(len(r.out) == 3 for r in done)
from repro_torch.kernels import grouped_matmul, ops, ssd_scan
from repro_torch.models import encdec, moe, ssm
import torch
from repro_torch.core import hetccl, mesh
cfg = hetccl.HetCCLConfig(mode="pipelined", backend="pallas", n_channels=2)
outs = mesh.ThreadMesh({{"pod": 2, "data": 2}}, device="cpu").run(
    lambda v: hetccl.all_reduce(v, cfg), [torch.full((6, 5), float(r)) for r in range(4)])
assert all(torch.equal(o, torch.full((6, 5), 6.0)) for o in outs)
from repro_torch.core import balance
from repro_torch.data import pipeline
from repro_torch.kernels import quant
from repro_torch.launch import train
from repro_torch.train import optim, trainer
hist = train.main(["--device", "cpu", "--steps", "1", "--seq", "16", "--backend", "pallas",
                   "--wire-quant", "int8"])
assert len(hist) == 1
import tempfile
from repro_torch import obs
from repro_torch.launch import dryrun
from repro_torch.roofline import analysis
from repro_torch.train import checkpoint, ft
tmp = tempfile.mkdtemp()
out = train.run(train.parser().parse_args(["--device", "cpu", "--steps", "2", "--seq", "16",
                                           "--trace", tmp + "/trace", "--ckpt-dir",
                                           tmp + "/ckpt", "--ckpt-every", "1"]))
assert out["telemetry"].tracer.dispatch_rows() and checkpoint.latest_step(tmp + "/ckpt") == 2
obs.load_chrome_trace(tmp + "/trace/trace.json")
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
rec = dryrun.run_cell("smollm-135m", "train_4k", "multi", verbose=False,
                      cfg=get_config("smollm-135m").reduced(),
                      shape_cfg=ShapeConfig("train_256", 256, 256, "train"))
assert rec["status"] == "ok" and rec["hlo_dot_flops_per_chip"] > 0, rec
from repro_torch import elastic
from repro_torch.elastic import chaos, detect, membership, quarantine, recover, watchdog
hist = train.main(["--device", "cpu", "--steps", "3", "--seq", "16", "--zero", "3",
                   "--policy", "legacy", "--backend", "pallas", "--watchdog",
                   "--chaos", "hang:pod0@1;kill:pod1@2"])
assert len(hist) == 3
print(json.dumps(sorted(m for m in sys.modules if re.match(r"{FOREIGN}", m))))
"""


def test_port_imports_neither_jax_nor_repro():
    r = _run(["-c", PROBE])
    assert r.returncode == 0, r.stderr
    assert "served 2 reqs, 6 tokens" in r.stdout
    assert "arch=mixtral-8x7b-reduced: served 2 reqs, 6 tokens" in r.stdout
    assert "arch=mamba2-2.7b-reduced: served 2 reqs, 6 tokens" in r.stdout
    assert "arch=zamba2-7b-reduced: served 2 reqs, 6 tokens" in r.stdout
    assert "arch=qwen2-vl-72b-reduced: served 2 reqs, 6 tokens" in r.stdout
    assert "arch=whisper-medium-reduced: served 2 reqs, 6 tokens" in r.stdout
    assert "error_feedback=True" in r.stdout and "tokens/s" in r.stdout
    assert "-> rebuild" in r.stdout and "recovery: checkpointless@2" in r.stdout
    assert json.loads(r.stdout.strip().splitlines()[-1]) == []


def test_port_sources_name_neither_jax_nor_repro():
    pat = re.compile(rf"^\s*(import|from)\s+{FOREIGN}", re.M)
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    bad = [str(p.relative_to(ROOT)) for p in files if pat.search(p.read_text())]
    assert bad == []


def test_thread_mesh_raises_without_a_card():
    import torch

    from repro_torch.core import mesh
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        mesh.ThreadMesh({"pod": 2, "data": 2})


def test_serve_entry_point_raises_without_a_card():
    r = _run(["-m", "repro_torch.launch.serve", "--reduced"])
    assert r.returncode != 0
    assert "torch.cuda.is_available() is false" in r.stderr
    assert "served" not in r.stdout


def test_train_entry_point_raises_without_a_card():
    r = _run(["-m", "repro_torch.launch.train", "--reduced"])
    assert r.returncode != 0
    assert "torch.cuda.is_available() is false" in r.stderr
    assert "step" not in r.stdout


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_fails_without_a_card_or_the_repo(tmp_path, alone):
    if alone:                      # a directory with chip_smoke.py and nothing else
        shutil.copy(ROOT / "chip_smoke.py", tmp_path)
        r = _run(["chip_smoke.py"], cwd=tmp_path, with_src=False)
    else:
        r = _run(["chip_smoke.py"])
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
