"""Grouped (per-expert) matmul: the hand-written Hopper kernel and its wrapper.

Counterpart of ``repro/kernels/grouped_matmul.py``; the kernel
(``csrc/grouped_matmul.cu``) replaces the Pallas TPU kernel ``_gmm_kernel``
there.  ``x (G, M, K) @ w (G, K, N) -> (G, M, N)`` in x's type with an f32
accumulator: bf16 through the tensor cores, f32 in full f32 (never TF32).
The source note says what bounds it on an H100 and what its design does
about that.

The reference pads M, K and N to its 128 blocks (``repro/kernels/ops.py:76-84``);
the kernel masks its ragged edges instead, so any M, K, N >= 1 are taken.
``x`` and ``w`` may be strided views (a layer slice of the stacked
``(L, E, D, F)`` expert weights): only the last dimension of each must be
dense.  The output is a new contiguous tensor.

On a CUDA tensor the wrapper launches the kernel or raises; on a CPU tensor it
runs the plain version (``ref.grouped_matmul``).  Nothing falls back from the
one to the other.  The kernel has no backward: on a CUDA tensor that autograd
would need a gradient of, the wrapper raises (MoE training is ROADMAP A6).
``launches`` counts kernel launches and nothing else, under a lock.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import grouped_matmul as grouped_matmul_plain

launches = 0          # kernel launches made by grouped_matmul

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

_fn = None
_lock = threading.Lock()


def bind(lib: ctypes.CDLL):
    """(launch, error_string) of a loaded ``grouped_matmul`` library."""
    fn = lib.grouped_matmul
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 5
                   + [ctypes.c_longlong] * 6 + [ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.grouped_matmul_error_string.argtypes = [ctypes.c_int]
    lib.grouped_matmul_error_string.restype = ctypes.c_char_p
    return fn, lib.grouped_matmul_error_string


def _kernel():
    global _fn
    with _lock:
        if _fn is None:
            _fn = bind(_build.load("grouped_matmul"))
        return _fn


def _check(x, w):
    if x.dim() != 3 or w.dim() != 3:
        raise ValueError(f"x {tuple(x.shape)}, w {tuple(w.shape)}: (G, M, K) and "
                         "(G, K, N) expected")
    if x.shape[0] != w.shape[0] or x.shape[2] != w.shape[1]:
        raise ValueError(f"x {tuple(x.shape)} and w {tuple(w.shape)} do not match "
                         "in G or K")
    if x.dtype not in _DTYPE_CODE or w.dtype != x.dtype:
        raise ValueError(f"dtypes {x.dtype}, {w.dtype}: the kernel takes float32 "
                         "or bfloat16, both alike")
    if w.device != x.device:
        raise ValueError(f"w is on {w.device}, x on {x.device}")
    for name, t in (("x", x), ("w", w)):
        if t.stride(-1) != 1:
            raise ValueError(f"{name} strides {t.stride()}: the last dimension "
                             "must be dense")
    if x.shape[0] > 65535:
        raise ValueError(f"G = {x.shape[0]} groups: at most 65535")
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        raise NotImplementedError(
            "grouped_matmul has no backward kernel yet (MoE training, ROADMAP A6)")


def _vector_loads(x, w) -> bool:
    """True when every row of x and w starts 16-byte aligned (bf16): the
    kernel then copies its tiles with 16-byte cp.async."""
    if x.dtype != torch.bfloat16:
        return False
    return all(t.data_ptr() % 16 == 0 and all(s % 8 == 0 for s in t.stride()[:2])
               for t in (x, w))


def grouped_matmul(x, w):
    """x (G, M, K) @ w (G, K, N) -> (G, M, N) in x.dtype, f32 accumulation:
    the kernel on a CUDA tensor, the plain version on a CPU tensor."""
    global launches
    if x.device.type == "cpu":
        return grouped_matmul_plain(x, w)
    if x.device.type != "cuda":
        raise ValueError(f"no grouped-matmul route for device {x.device}")
    _check(x, w)
    G, M, K = x.shape
    N = w.shape[2]
    out = torch.empty((G, M, N), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    fn, err_str = _kernel()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = fn(x.data_ptr(), w.data_ptr(), out.data_ptr(), _DTYPE_CODE[x.dtype],
             G, M, K, N, x.stride(0), x.stride(1), w.stride(0), w.stride(1),
             out.stride(0), out.stride(1), int(_vector_loads(x, w)), stream)
    if err:
        raise RuntimeError(f"grouped_matmul launch failed: {err_str(err).decode()} "
                           f"(cuda error {err})")
    with _lock:
        launches += 1
    return out
