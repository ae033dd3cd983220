"""Flash attention: the hand-written Hopper kernels and their wrappers.

Counterpart of ``repro/kernels/flash_attention.py``; the forward kernel
(``csrc/flash_attention.cu``) replaces the Pallas TPU kernel ``_flash_kernel``
there.  The backward kernel (``csrc/flash_attention_bwd.cu``) has no TPU
counterpart (the reference differentiates its plain attention): it takes the
forward's row logsumexp and recomputes the probabilities.
:class:`FlashAttention` joins the two for autograd.  Each source note says
what bounds the kernel on an H100 and what its design does about that.

``flash_attention_fwd`` takes the kernel layout of the reference,
q ``(B, Hq, Sq, d)`` and k, v ``(B, Hkv, Sk, d)``, as strided views: the last
dimension must be dense, the others may have any stride, so callers in model
layout ``(B, S, H, d)`` pass ``transpose(1, 2)`` views without a copy.  The
output has the memory layout of ``q`` (``torch.empty_like``).  The bf16
route's tensor maps take strides of 16 bytes; a bf16 view whose strides are
not multiples of 8 elements (head dim 100 in model layout: heads 200 bytes
apart) is first copied by :func:`tma_ready` into rows padded to a multiple
of 8, and its output is such a padded view too.

On a CUDA tensor a wrapper launches its kernel or raises; on a CPU tensor it
runs the plain version (``ref.attention`` and ``ref.attention_lse``,
``ref.attention_bwd``).  Nothing falls back from the one to the other.
``launches`` and ``bwd_launches`` count kernel launches and nothing else; the
rank threads of a mesh and autograd's own thread bump them, under a lock.
"""
from __future__ import annotations

import array
import ctypes
import threading

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref
from repro_torch.kernels.ref import attention as flash_attention_plain
from repro_torch.kernels.ref import attention_bwd as flash_attention_bwd_plain

launches = 0          # kernel launches made by flash_attention_fwd
bwd_launches = 0      # kernel launches (two passes each in bf16, three in f32) by flash_attention_bwd
d_launches: dict[int, int] = {}   # flash_attention_fwd's launches by head dim
# flash_attention_fwd's launches by (kind, Sq, Sk): the shapes of one head dim
# (whisper's encoder, decoder and cross-attention, all d 64) counted apart
shape_launches: dict[tuple[str, int, int], int] = {}
# flash_attention_bwd's calls by (kind, Sq, Sk), as ``shape_launches``
bwd_shape_launches: dict[tuple[str, int, int], int] = {}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# 64: smollm, the gpt models, llama-1b and smollm-360m; 128: the larger dense
# configs; 112: zamba2's shared attention (3584 / 32); 100: llama-3b (3200 /
# 32); 32: every reduced config (the serve launcher's default, ``--reduced``)
HEAD_DIMS = (32, 64, 100, 112, 128)
BWD_HEAD_DIMS = HEAD_DIMS           # the backward kernel's

# csrc/flash_attention_bwd.cu's kMaxCluster: the portable thread-block cluster
MAX_CLUSTER = 8

_fn = None
_bwd_fn = None
_lock = threading.Lock()


def bind(lib: ctypes.CDLL):
    """(launch, error_string) of a loaded ``flash_attention`` library."""
    fn = lib.flash_attention_fwd
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 7
                   + [ctypes.c_longlong] * 12
                   + [ctypes.c_int] * 3 + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.flash_attention_error_string.argtypes = [ctypes.c_int]
    lib.flash_attention_error_string.restype = ctypes.c_char_p
    return fn, lib.flash_attention_error_string


def bind_bwd(lib: ctypes.CDLL):
    """(launch, error_string) of a loaded ``flash_attention_bwd`` library;
    the launch takes its 35 integer arguments packed in one int64 array
    (the order is in the source's note)."""
    fn = lib.flash_attention_bwd
    fn.argtypes = [ctypes.c_void_p, ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.flash_attention_bwd_error_string.argtypes = [ctypes.c_int]
    lib.flash_attention_bwd_error_string.restype = ctypes.c_char_p
    return fn, lib.flash_attention_bwd_error_string


def _kernel():
    global _fn
    if _fn is None:
        with _lock:
            if _fn is None:
                _fn = bind(_build.load("flash_attention"))
    return _fn


def _bwd_kernel():
    global _bwd_fn
    if _bwd_fn is None:
        with _lock:
            if _bwd_fn is None:
                _bwd_fn = bind_bwd(_build.load("flash_attention_bwd"))
    return _bwd_fn


def bwd_cluster(group: int) -> tuple[int, int]:
    """The bf16 backward's dK/dV pass for a GQA group of ``group`` q heads per
    kv head: (blocks per thread-block cluster, heads per block).  The
    cluster is the largest divisor of the group up to ``MAX_CLUSTER``; rank r
    takes the consecutive heads ``r * m .. r * m + m - 1``, and the cluster
    sums its ranks' dK and dV in ascending rank order."""
    cs = next(c for c in range(min(group, MAX_CLUSTER), 0, -1) if group % c == 0)
    return cs, group // cs


def reset_counts():
    """Set every launch count of this module to 0."""
    global launches, bwd_launches
    with _lock:
        launches = bwd_launches = 0
        d_launches.clear()
        shape_launches.clear()
        bwd_shape_launches.clear()


def _aligned(t) -> bool:
    """A (B, H, S, d) view the kernels take as it is; written out, as it runs
    several times a launch."""
    st = t.stride()
    return (st[3] == 1 and t.data_ptr() % 16 == 0
            and (t.dtype is not torch.bfloat16 or (st[0] | st[1] | st[2]) % 8 == 0))


def padded_empty(shape, dtype, device):
    """An uninitialised tensor of ``shape`` whose rows start 8-element
    multiples apart: a ``[..., :d]`` view of rows of d rounded up to 8."""
    d = shape[-1]
    return torch.empty(tuple(shape[:-1]) + (-(-d // 8) * 8,), dtype=dtype,
                       device=device)[..., :d]


def tma_ready(t):
    """``t`` itself where the kernels take its layout (a dense last dim,
    strides of 8 elements in bf16, a 16-byte aligned base), else a copy in
    rows padded to a multiple of 8 elements (head dim 100 in model layout:
    rows of 104).  A view whose last dim is not dense is returned as it is,
    for the wrapper to refuse."""
    if t.stride(-1) != 1 or _aligned(t):
        return t
    out = padded_empty(t.shape, t.dtype, t.device)
    out.copy_(t)
    return out


def _check(q, k, v, kind, window, k_len, extra=()):
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
    # the bf16 route's tensor maps take strides of 16 bytes, the f32 route's
    # loads single floats; written out, as this runs on every launch
    align = 8 if q.dtype == torch.bfloat16 else 1
    dev = q.device
    for name, t in (("q", q), ("k", k), ("v", v), *extra):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        st = t.stride()
        if st[3] != 1 or st[0] % align or st[1] % align or st[2] % align or t.data_ptr() % 16:
            raise ValueError(f"{name} strides {t.stride()} / alignment not "
                             "taken by the kernel")


def flash_attention_fwd(q, k, v, *, kind: str = "causal", window: int = 0,
                        k_len: int | None = None, scale: float | None = None,
                        return_lse: bool = False):
    """q: (B, Hq, Sq, d);  k, v: (B, Hkv, Sk, d) -> (B, Hq, Sq, d) in q.dtype,
    and with ``return_lse`` also the f32 row logsumexp (B, Hq, Sq) of the
    scaled, masked scores, which the backward takes.

    kind: "causal" | "bidir"; window: sliding window (0 = none); k_len: only
    keys ``< k_len`` are attended (default Sk); scale: default d ** -0.5.
    """
    global launches
    Sk = k.shape[2]
    k_len = Sk if k_len is None else int(k_len)
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        o = flash_attention_plain(q, k, v, kind=kind, window=window,
                                  k_len=k_len, scale=scale)
        if not return_lse:
            return o
        return o, ref.attention_lse(q, k, kind=kind, window=window, k_len=k_len,
                                    scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"no flash-attention route for device {q.device}")
    q, k, v = tma_ready(q), tma_ready(k), tma_ready(v)
    _check(q, k, v, kind, window, k_len)
    B, Hq, Sq, d = q.shape
    # d 100: no dense layout has strides of 8 elements, so o gets padded rows
    o = torch.empty_like(q) if d % 8 == 0 else padded_empty(q.shape, q.dtype, q.device)
    lse = torch.empty((B, Hq, Sq), dtype=torch.float32, device=q.device) \
        if return_lse else None
    if o.numel() == 0:
        return (o, lse) if return_lse else o
    fn, err_str = _kernel()
    # the raw handle of the current stream: torch.cuda.current_stream() builds
    # a Stream object, a few microseconds on a path that is host-bound
    stream = torch._C._cuda_getCurrentRawStream(q.get_device())
    qs, ks, vs, os_ = q.stride(), k.stride(), v.stride(), o.stride()
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
             lse.data_ptr() if return_lse else None,
             _DTYPE_CODE[q.dtype], B, Hq, k.shape[1], Sq, Sk, d,
             qs[0], qs[1], qs[2], ks[0], ks[1], ks[2], vs[0], vs[1], vs[2],
             os_[0], os_[1], os_[2],
             int(kind == "causal"), int(window), k_len, float(scale), stream)
    if err:
        raise RuntimeError(f"flash_attention_fwd launch failed: "
                           f"{err_str(err).decode()} (cuda error {err})")
    with _lock:
        launches += 1
        d_launches[d] = d_launches.get(d, 0) + 1
        key = (kind, Sq, Sk)
        shape_launches[key] = shape_launches.get(key, 0) + 1
    return (o, lse) if return_lse else o


def flash_attention_bwd(q, k, v, o, do, lse, *, kind: str = "causal",
                        window: int = 0, k_len: int | None = None,
                        scale: float | None = None):
    """Gradients (dq, dk, dv) in f32 of the forward's output ``o`` against
    the incoming ``do`` (both (B, Hq, Sq, d), q's dtype), given the
    forward's ``lse`` (B, Hq, Sq) f32; dk, dv summed over the query heads of
    each kv head.  Shapes, dtypes and masks as :func:`flash_attention_fwd`.
    """
    global bwd_launches
    Sk = k.shape[2]
    k_len = Sk if k_len is None else int(k_len)
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, o, do, lse, kind=kind, window=window,
                                         k_len=k_len, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"no flash-attention route for device {q.device}")
    if do.dtype != q.dtype or do.stride(-1) != 1:
        do = do.to(q.dtype).contiguous()
    q, k, v, o, do = (tma_ready(t) for t in (q, k, v, o, do))
    _check(q, k, v, kind, window, k_len, extra=(("o", o), ("do", do)))
    B, Hq, Sq, d = q.shape
    if d not in BWD_HEAD_DIMS:
        raise ValueError(f"head dim {d} not in the backward's {BWD_HEAD_DIMS}")
    if o.shape != q.shape or do.shape != q.shape or o.dtype != q.dtype:
        raise ValueError(f"o {tuple(o.shape)} {o.dtype}, do {tuple(do.shape)}: "
                         f"q's shape {tuple(q.shape)} and dtype {q.dtype} expected")
    if lse.shape != (B, Hq, Sq) or lse.dtype != torch.float32 or lse.device != q.device:
        raise ValueError(f"lse {tuple(lse.shape)} {lse.dtype}: ({B}, {Hq}, {Sq}) f32 expected")
    lse = lse.contiguous()
    f32 = dict(dtype=torch.float32, device=q.device)
    dq = torch.empty((B, Hq, Sq, d), **f32)
    dk = torch.empty(k.shape, **f32)
    dv = torch.empty(v.shape, **f32)
    if dq.numel() == 0 or dk.numel() == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    delta = torch.empty((B, Hq, Sq), **f32)
    fn, err_str = _bwd_kernel()
    stream = torch._C._cuda_getCurrentRawStream(q.get_device())
    args = array.array("q", (
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        _DTYPE_CODE[q.dtype], B, Hq, k.shape[1], Sq, Sk, d,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *o.stride()[:3], *do.stride()[:3],
        int(kind == "causal"), int(window), k_len))
    err = fn(args.buffer_info()[0], float(scale), stream)
    if err:
        raise RuntimeError(f"flash_attention_bwd launch failed: "
                           f"{err_str(err).decode()} (cuda error {err})")
    with _lock:
        bwd_launches += 1
        key = (kind, Sq, Sk)
        bwd_shape_launches[key] = bwd_shape_launches.get(key, 0) + 1
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """Attention with the flash kernels in both directions (kernel layout).

        o = FlashAttention.apply(q, k, v, kind, window, k_len, scale)

    The forward saves q, k, v, o and the row logsumexp; the backward launches
    the backward kernel.  On CPU tensors both directions run their plain
    versions.  Autograd runs the backward on its own thread, outside any mesh
    rank: nothing here may call a collective.
    """

    @staticmethod
    def forward(ctx, q, k, v, kind="causal", window=0, k_len=None, scale=None):
        if q.is_cuda:          # the layout both kernels take, copied once
            q, k, v = tma_ready(q), tma_ready(k), tma_ready(v)
        o, lse = flash_attention_fwd(q, k, v, kind=kind, window=window, k_len=k_len,
                                     scale=scale, return_lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.opts = dict(kind=kind, window=window, k_len=k_len, scale=scale)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, do, lse, **ctx.opts)
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None, None, None
