"""Wire quantization codecs for compressed collectives (DESIGN.md §17).

Counterpart of ``repro/kernels/quant.py``.  A payload of N elements is
flattened, zero-padded to a multiple of ``DEFAULT_CHUNK`` and encoded as

* ``codes``: one byte per element (int8 in [-127, 127] for ``"int8"``, e4m3
  bits for ``"fp8"``), kept in the payload's own shape so a ring hop slices
  it like an uncompressed payload;
* ``scales``: one f32 per chunk, (nchunks, 1): the chunk's absmax mapped to
  the codec's top code (127, or 448 for e4m3); an all-zero chunk stores 1.

The int8 codec runs the hand-written Hopper kernels of ``csrc/quant.cu``,
which replace the Pallas TPU kernels ``_quant_int8_kernel`` and
``_dq_accum_kernel``: :func:`wire_quantize_int8` and
:func:`wire_dequant_accum_int8` launch them for CUDA tensors (or raise) and
run their plain versions (``ref.wire_quantize``, ``ref.wire_dequant_accum``)
for CPU tensors; ``quant_launches`` and ``dq_launches`` count launches and
nothing else.  Kernel and plain version agree bit for bit (the source note
says how).  The fp8 codec is the reference's *software* codec on every
device, as there (``wire_quantize_pallas`` hands fp8 to the jnp codec): torch
bit arithmetic, no kernel, no ``float8_e4m3fn`` cast (ROADMAP C3).

TACC ops ``wire_quantize`` and ``wire_dequant_accum`` (registered in
``kernels/ops.py``) pick the route per call from the tensors' device.

Error feedback: :func:`ef_compress` compresses ``x + residual`` and carries
the projection error into the new residual, so that the sum of compressed
updates plus the final residual telescopes to the sum of true updates.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from repro_torch.core import tacc
from repro_torch.kernels import _build
from repro_torch.kernels.ref import (E4M3_MAX, INT8_TOP, decode_e4m3,  # noqa: F401
                                     encode_e4m3)
from repro_torch.kernels.ref import wire_dequant_accum as wire_dequant_accum_plain
from repro_torch.kernels.ref import wire_quantize as wire_quantize_plain

CODECS = ("int8", "fp8")
DEFAULT_CHUNK = 512          # elements per scale (f32 sidecar: 4 B per chunk)
SCALE_BYTES = 4              # sidecar bytes per chunk

quant_launches = 0           # launches of the quantize kernel
dq_launches = 0              # launches of the dequantize-accumulate kernel

_lib = None
_lock = threading.Lock()     # ranks of a ThreadMesh launch from their threads


def wire_bytes_per_elem(codec: str | None, itemsize: int = 4,
                        chunk: int = DEFAULT_CHUNK) -> float:
    """Bytes on the wire per payload element under ``codec`` (None: the
    uncompressed itemsize), the scale sidecar included."""
    if codec is None:
        return float(itemsize)
    if codec not in CODECS:
        raise ValueError(f"unknown wire_quant codec {codec!r}; "
                         f"expected one of {CODECS}")
    return 1.0 + SCALE_BYTES / float(chunk)


def bind(lib: ctypes.CDLL):
    """Set the argument types of a loaded ``quant`` library; returns it."""
    lib.quant_int8.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_int,
                                                       ctypes.c_void_p]
    lib.quant_int8.restype = ctypes.c_int
    lib.dq_accum_int8.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_longlong, ctypes.c_int,
                                                          ctypes.c_void_p]
    lib.dq_accum_int8.restype = ctypes.c_int
    lib.quant_error_string.argtypes = [ctypes.c_int]
    lib.quant_error_string.restype = ctypes.c_char_p
    return lib


def _kernel():
    global _lib
    if _lib is None:
        with _lock:
            if _lib is None:
                _lib = bind(_build.load("quant"))
    return _lib


def _route(t) -> bool:
    """True for a CUDA tensor (the kernel), False for a CPU one (the plain
    version); any other device raises."""
    if t.is_cuda:
        return True
    if t.device.type != "cpu":
        raise ValueError(f"no wire codec route for device {t.device}")
    return False


def _raise_on(err: int, what: str, lib):
    if err:
        raise RuntimeError(f"{what} launch failed: "
                           f"{lib.quant_error_string(err).decode()} (cuda error {err})")


def _f32(t):
    """t as a contiguous f32 tensor: t itself where it already is one (no
    dispatch through ``.float()`` and ``.contiguous()``), else a copy."""
    if t.dtype == torch.float32 and t.is_contiguous():
        return t
    return t.float().contiguous()


def _stream(t) -> int:
    # the raw handle of the current stream: torch.cuda.current_stream() builds
    # a Stream object, a few microseconds on a path that is host-bound
    return torch._C._cuda_getCurrentRawStream(t.get_device())


def wire_quantize_int8(x2):
    """x2 (nchunks, chunk) -> (codes int8 (nchunks, chunk), scales f32
    (nchunks, 1)): the ``quant_int8`` kernel on a CUDA tensor, the plain
    version on a CPU tensor."""
    global quant_launches
    if x2.dim() != 2:
        raise ValueError(f"x2 of shape {tuple(x2.shape)}: (nchunks, chunk) expected")
    if not _route(x2):
        return wire_quantize_plain(x2, codec="int8")
    x = _f32(x2)
    rows, chunk = x.shape
    codes = torch.empty((rows, chunk), dtype=torch.int8, device=x.device)
    scales = torch.empty((rows, 1), dtype=torch.float32, device=x.device)
    if rows == 0 or chunk == 0:
        return codes, scales
    lib = _lib or _kernel()
    err = lib.quant_int8(x.data_ptr(), codes.data_ptr(), scales.data_ptr(), rows, chunk,
                         _stream(x))
    _raise_on(err, "quant_int8", lib)
    with _lock:
        quant_launches += 1
    tacc.count_row_launch("quant_int8")
    return codes, scales


def _check_dq(acc2, codes2, scales):
    if acc2.dim() != 2 or codes2.shape != acc2.shape or codes2.dtype != torch.int8 \
            or scales.numel() != acc2.shape[0]:
        raise ValueError(f"acc {tuple(acc2.shape)}, codes {tuple(codes2.shape)} "
                         f"{codes2.dtype}, scales {tuple(scales.shape)}: (nchunks, chunk), "
                         "the same int8, and (nchunks, 1) expected")
    for t in (codes2, scales):
        if t.device != acc2.device:
            raise ValueError(f"a codec input is on {t.device}, acc on {acc2.device}")


def wire_dequant_accum_int8(acc2, codes2, scales):
    """acc2 (nchunks, chunk) f32 + float(codes2) * scales (nchunks, 1) ->
    f32: the ``dq_accum_int8`` kernel on CUDA tensors, the plain version on
    CPU tensors.  The arguments are checked on every device."""
    global dq_launches
    _check_dq(acc2, codes2, scales)
    if not _route(acc2):
        return wire_dequant_accum_plain(acc2, codes2, scales, codec="int8")
    acc = _f32(acc2)
    codes = codes2 if codes2.is_contiguous() else codes2.contiguous()
    sc = _f32(scales)
    out = torch.empty_like(acc)
    rows, chunk = acc.shape
    if rows == 0 or chunk == 0:
        return out
    lib = _lib or _kernel()
    err = lib.dq_accum_int8(acc.data_ptr(), codes.data_ptr(), sc.data_ptr(), out.data_ptr(),
                            rows, chunk, _stream(acc))
    _raise_on(err, "dq_accum_int8", lib)
    with _lock:
        dq_launches += 1
    tacc.count_row_launch("dq_accum_int8")
    return out


def wire_quantize_cuda(x2, *, codec: str = "int8"):
    """The ``cuda`` entry of TACC ``wire_quantize``: the int8 kernel; fp8 is
    the software codec on every device, as in the reference."""
    if codec == "int8":
        return wire_quantize_int8(x2)
    return wire_quantize_plain(x2, codec=codec)


def wire_dequant_accum_cuda(acc2, codes2, scales, *, codec: str = "int8"):
    """The ``cuda`` entry of TACC ``wire_dequant_accum`` (fp8 as above)."""
    if codec == "int8":
        return wire_dequant_accum_int8(acc2, codes2, scales)
    return wire_dequant_accum_plain(acc2, codes2, scales, codec=codec)


# ---------------------------------------------------------------------------
# Shape-polymorphic front doors (the ring / trainer entry points).
# ---------------------------------------------------------------------------

def _to_chunks(flat, chunk: int):
    pad = (-flat.shape[0]) % chunk
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))
    return flat.reshape(-1, chunk)


def quantize(x, *, codec: str = "int8", chunk: int = DEFAULT_CHUNK):
    """x (any shape) -> (codes in x's shape, scales (nchunks, 1) f32) over the
    flattened, chunk-padded view."""
    x2 = _to_chunks(x.float().reshape(-1), chunk)
    codes2, scales = tacc.dispatch("wire_quantize", x2, codec=codec)
    return codes2.reshape(-1)[:x.numel()].reshape(x.shape), scales


def dequantize_accumulate(acc, codes, scales, *, codec: str = "int8",
                          chunk: int = DEFAULT_CHUNK):
    """acc (f32, codes.shape) + decode(codes, scales) -> f32: the receive side
    of a quantized hop; the accumulator never narrows."""
    acc2 = _to_chunks(acc.float().reshape(-1), chunk)
    codes2 = _to_chunks(codes.reshape(-1), chunk)
    out2 = tacc.dispatch("wire_dequant_accum", acc2, codes2, scales, codec=codec)
    return out2.reshape(-1)[:acc.numel()].reshape(acc.shape)


def dequantize(codes, scales, *, codec: str = "int8", chunk: int = DEFAULT_CHUNK):
    """decode(codes, scales) -> f32 in codes' shape."""
    zeros = torch.zeros(codes.shape, dtype=torch.float32, device=codes.device)
    return dequantize_accumulate(zeros, codes, scales, codec=codec, chunk=chunk)


def compress(x, *, codec: str = "int8", chunk: int = DEFAULT_CHUNK):
    """Quantize-dequantize round trip: x projected onto the codec grid, f32."""
    codes, scales = quantize(x, codec=codec, chunk=chunk)
    return dequantize(codes, scales, codec=codec, chunk=chunk)


def ef_compress(x, residual, *, codec: str = "int8", chunk: int = DEFAULT_CHUNK):
    """Error-feedback compression: ``(compress(y), y - compress(y))`` with
    ``y = x + residual`` in f32."""
    y = x.float() + residual.float()
    c = compress(y, codec=codec, chunk=chunk)
    return c, y - c
