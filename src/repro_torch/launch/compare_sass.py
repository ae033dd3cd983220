"""Compare the machine code (SASS) of the grouped matmul's ``wgmma`` kernel
between the checkout's ``csrc/grouped_matmul.cu`` and another source, one
instantiation at a time.

    python -m repro_torch.launch.compare_sass --other path/to/grouped_matmul.cu

Both sources are compiled for sm_90a as the port builds them (``-O3``, no
``-shared``: one cubin each, two nvcc processes started together) and read
back with ``cuobjdump -sass``.  ``gmm_wgmma<kAT, kBT[, kBK]>`` is matched by
its operand layouts and stage depth (64 where the source has no depth
parameter): the forward ``<0, 1>``, the backward's dx ``<0, 0>`` and dw
``<1, 1>``.  Prints, for each instantiation of the other source, whether the
checkout's has the same SASS line for line, then the checkout's
instantiations the other lacks; exits 1 if any common one differs.  Needs
nvcc and cuobjdump, so it runs where the card is; the port never calls it.
"""
from __future__ import annotations

import argparse
import re
import subprocess
import sys
import tempfile
from pathlib import Path

from repro_torch.kernels import _build

_WGMMA = re.compile(r"gmm_wgmmaILi(\d)ELi(\d)E(?:Li(\d+)E)?E")


def cubin(src: Path, out: Path) -> subprocess.Popen:
    flags = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-cubin"]
    return subprocess.Popen([_build._nvcc(), *flags, "-o", str(out), str(src)],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def wgmma_sass(path: Path) -> dict:
    """{(kAT, kBT, kBK): [SASS lines]} of a cubin's ``gmm_wgmma`` kernels."""
    tool = Path(_build._nvcc()).parent / "cuobjdump"
    text = subprocess.run([str(tool), "-sass", str(path)], capture_output=True, text=True,
                          check=True).stdout
    out, body = {}, None
    for line in text.splitlines():
        head = re.match(r"\s*Function : (\S+)", line)
        if head:
            m = _WGMMA.search(head.group(1))
            body = out.setdefault((int(m.group(1)), int(m.group(2)), int(m.group(3) or 64)),
                                  []) if m else None
        elif body is not None and "/*" in line:
            body.append(line.strip())
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", required=True, help="another csrc/grouped_matmul.cu")
    args = ap.parse_args(argv)
    with tempfile.TemporaryDirectory() as tmp:
        srcs = {"checkout": _build.CSRC / "grouped_matmul.cu", "other": Path(args.other)}
        procs = {k: cubin(v, Path(tmp) / f"{k}.cubin") for k, v in srcs.items()}
        for k, p in procs.items():
            log, _ = p.communicate()
            if p.returncode:
                print(f"{k}: nvcc failed\n{log}")
                return 1
        mine, theirs = (wgmma_sass(Path(tmp) / f"{k}.cubin") for k in ("checkout", "other"))
    same = True
    for key in sorted(theirs):
        a, b = theirs[key], mine.get(key)
        ok = a == b
        same &= ok
        print(f"gmm_wgmma<{key[0]},{key[1]}> stages of {key[2]}: {len(a)} SASS lines in the "
              f"other source, {None if b is None else len(b)} in the checkout; identical {ok}")
    for key in sorted(set(mine) - set(theirs)):
        print(f"gmm_wgmma<{key[0]},{key[1]}> stages of {key[2]}: only in the checkout, "
              f"{len(mine[key])} SASS lines")
    print(f"identical: {same}")
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
