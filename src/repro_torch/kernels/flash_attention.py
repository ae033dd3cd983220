"""Flash-attention forward: the hand-written Hopper kernel and its wrapper.

Counterpart of ``repro/kernels/flash_attention.py``; the kernel
(``csrc/flash_attention.cu``) replaces the Pallas TPU kernel ``_flash_kernel``
there.  Its source note says what bounds it on an H100 and what its design
does about that.

``flash_attention_fwd`` takes the kernel layout of the reference,
q ``(B, Hq, Sq, d)`` and k, v ``(B, Hkv, Sk, d)``, as strided views: the last
dimension must be dense, the others may have any stride, so callers in model
layout ``(B, S, H, d)`` pass ``transpose(1, 2)`` views without a copy.  The
output has the memory layout of ``q`` (``torch.empty_like``).

On a CUDA tensor the wrapper launches the kernel or raises; on a CPU tensor it
runs the plain version, ``ref.attention``.  Nothing falls back from the one to
the other.  ``launches`` counts kernel launches and nothing else.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import attention as flash_attention_plain

launches = 0          # kernel launches made by flash_attention_fwd

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# 64: smollm and the other served configs; 128: the larger dense configs;
# 32: every reduced config (the serve launcher's default, ``--reduced``)
HEAD_DIMS = (32, 64, 128)

_fn = None


def bind(lib: ctypes.CDLL):
    """(launch, error_string) of a loaded ``flash_attention`` library."""
    fn = lib.flash_attention_fwd
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
                   + [ctypes.c_longlong] * 12
                   + [ctypes.c_int] * 3 + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.flash_attention_error_string.argtypes = [ctypes.c_int]
    lib.flash_attention_error_string.restype = ctypes.c_char_p
    return fn, lib.flash_attention_error_string


def _kernel():
    global _fn
    if _fn is None:
        _fn = bind(_build.load("flash_attention"))
    return _fn


def _check(q, k, v, kind, window, k_len):
    B, Hq, Sq, d = q.shape
    Bk, Hkv, Sk, dk = k.shape
    if v.shape != k.shape or (Bk, dk) != (B, d):
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} do not match")
    if Hkv == 0 or Hq % Hkv:
        raise ValueError(f"Hq={Hq} is not a multiple of Hkv={Hkv}")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"dtypes {q.dtype}, {k.dtype}, {v.dtype}: the kernel "
                         "takes float32 or bfloat16, all alike")
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not in {HEAD_DIMS}")
    if kind not in ("causal", "bidir"):
        raise ValueError(f"kind {kind!r}")
    if window < 0 or not 0 <= k_len <= Sk:
        raise ValueError(f"window={window}, k_len={k_len}, Sk={Sk}")
    # the bf16 route loads 16-byte vectors, the f32 route single floats
    align = 8 if q.dtype == torch.bfloat16 else 1
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.stride(-1) != 1 or any(s % align for s in t.stride()[:-1]) \
                or t.data_ptr() % 16:
            raise ValueError(f"{name} strides {t.stride()} / alignment not "
                             "taken by the kernel")


def flash_attention_fwd(q, k, v, *, kind: str = "causal", window: int = 0,
                        k_len: int | None = None, scale: float | None = None):
    """q: (B, Hq, Sq, d);  k, v: (B, Hkv, Sk, d) -> (B, Hq, Sq, d) in q.dtype.

    kind: "causal" | "bidir"; window: sliding window (0 = none); k_len: only
    keys ``< k_len`` are attended (default Sk); scale: default d ** -0.5.
    """
    global launches
    Sk = k.shape[2]
    k_len = Sk if k_len is None else int(k_len)
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, kind=kind, window=window,
                                     k_len=k_len, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"no flash-attention route for device {q.device}")
    _check(q, k, v, kind, window, k_len)
    B, Hq, Sq, d = q.shape
    o = torch.empty_like(q)
    if o.numel() == 0:
        return o
    fn, err_str = _kernel()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
             _DTYPE_CODE[q.dtype], B, Hq, k.shape[1], Sq, Sk, d,
             *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *o.stride()[:3],
             int(kind == "causal"), int(window), k_len, float(scale), stream)
    if err:
        raise RuntimeError(f"flash_attention_fwd launch failed: "
                           f"{err_str(err).decode()} (cuda error {err})")
    launches += 1
    return o
