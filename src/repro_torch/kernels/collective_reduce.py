"""Collective reduce: the hand-written Hopper kernel and its wrapper.

Counterpart of ``repro/kernels/collective_reduce.py:26-96`` and
``repro/kernels/ops.py:120-141``; the kernel (``csrc/collective_reduce.cu``)
replaces the Pallas TPU kernel ``_reduce_kernel``: a ring step's accumulate,
``acc (f32) + incoming (f32 or bf16) -> f32``.  The TPU wrapper reshapes the
chunk to (M, 256) and pads it to its block grid; this kernel walks the flat
chunk and masks its own tail, so any shape goes in without a padding copy.

On a CUDA tensor the wrapper launches the kernel or raises; on a CPU tensor it
runs the plain version, ``ref.collective_reduce``.  ``launches`` counts kernel
launches and nothing else.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import collective_reduce as collective_reduce_plain

launches = 0          # kernel launches made by collective_reduce

_IN_CODE = {torch.float32: 0, torch.bfloat16: 1}

_fn = None
_count_lock = threading.Lock()     # the ranks of a ThreadMesh launch from their threads


def bind(lib: ctypes.CDLL):
    """(launch, error_string) of a loaded ``collective_reduce`` library."""
    fn = lib.collective_reduce
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_longlong, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.collective_reduce_error_string.argtypes = [ctypes.c_int]
    lib.collective_reduce_error_string.restype = ctypes.c_char_p
    return fn, lib.collective_reduce_error_string


def _kernel():
    global _fn
    if _fn is None:
        _fn = bind(_build.load("collective_reduce"))
    return _fn


def collective_reduce(acc, incoming):
    """acc (f32, any shape), incoming (same shape, f32 or bf16) -> f32."""
    global launches
    if acc.device.type == "cpu":
        return collective_reduce_plain(acc, incoming)
    if acc.device.type != "cuda":
        raise ValueError(f"no collective_reduce route for device {acc.device}")
    if acc.dtype != torch.float32 or incoming.dtype not in _IN_CODE:
        raise ValueError(f"dtypes {acc.dtype} + {incoming.dtype}: the kernel takes "
                         "a float32 accumulator and float32 or bfloat16 incoming")
    if incoming.shape != acc.shape or incoming.device != acc.device:
        raise ValueError(f"acc {tuple(acc.shape)} on {acc.device}, incoming "
                         f"{tuple(incoming.shape)} on {incoming.device}")
    a = acc.contiguous()
    b = incoming.contiguous()
    out = torch.empty_like(a)
    if out.numel() == 0:
        return out
    fn, err_str = _kernel()
    stream = torch.cuda.current_stream(a.device).cuda_stream
    err = fn(a.data_ptr(), b.data_ptr(), _IN_CODE[b.dtype], out.data_ptr(),
             a.numel(), stream)
    if err:
        raise RuntimeError(f"collective_reduce launch failed: "
                           f"{err_str(err).decode()} (cuda error {err})")
    with _count_lock:
        launches += 1
    return out
