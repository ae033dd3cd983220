"""``chip_smoke.py``'s phase [31] (planned training) alone, on one card.

    python3 -m repro_torch.launch.planned_card     # from the repository root

Prints the card and its power limit, builds the kernels, then runs
``chip_smoke.phase_planned_train``: smollm-135m at full width on the
planner's tables and shares, four runs on a (pod=2, data=2) ThreadMesh,
with every gate of the phase.  A few minutes of command, against the whole
smoke run's quarter hour; it needs the repository's ``chip_smoke.py``.
"""
import json
import subprocess
import sys
import time
from pathlib import Path


def main() -> int:
    root = Path(__file__).resolve().parents[3]
    sys.path.insert(0, str(root))
    import chip_smoke as cs
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core import collectives, hetccl, tacc
    from repro_torch.core import mesh as mesh_mod
    from repro_torch.kernels import _build, quant, ring_dma
    from repro_torch.kernels import collective_reduce as cr
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import grouped_matmul as gmm
    from repro_torch.kernels import ssd_scan as ssd
    from repro_torch.models import build

    print(torch.cuda.get_device_name(0), torch.__version__, torch.version.cuda)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip())
    t = time.perf_counter()
    _build.build()
    print(f"build {time.perf_counter() - t:.1f} s")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    counters = cs.Counters(fa, quant, ring_dma, cr, gmm, ssd)
    t = time.perf_counter()
    out = cs.phase_planned_train(torch, np, get_config, build, mesh_mod, hetccl, tacc,
                                 collectives, ring_dma, counters)
    print(f"[31] wall {time.perf_counter() - t:.1f} s")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
