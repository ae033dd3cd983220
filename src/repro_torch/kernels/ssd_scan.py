"""Mamba2 SSD chunked scan: the hand-written Hopper kernel and its wrappers.

Counterpart of ``repro/kernels/ssd_scan.py``; the kernel (``csrc/ssd_scan.cu``)
replaces the Pallas TPU kernel ``_ssd_kernel`` there.  The source note says
what bounds it on an H100 and what its design does about that.  Two entry
points launch it:

* :func:`ssd_scan`, the reference's kernel layout: x (B, H, nc, Q, P), dt and
  a_cum (B, H, nc, Q), B_in and C_in (B, H, nc, Q, N) -> y in x's type (the
  signature of ``ssd_scan_pallas`` and ``ref.ssd_scan``);
* :func:`ssd_scan_model`, the model's layout, which ``models/ssm.py``
  reaches through the TACC op ``ssd_scan`` on a CUDA tensor: x (B, S, H, P),
  dt and a_cum (B, S, H), B_in and C_in (B, S, G, N), chunk length Q with
  S % Q == 0, an optional initial state -> (y (B, S, H, P) f32 without the
  D*x term, final state (B, H, N, P) f32).  The kernel reads the groups in
  place: nothing is expanded to H heads.

x, B_in and C_in are float32 or bfloat16, all alike; dt and a_cum are cast
to f32.  The dtype alone picks the kernel's route (:func:`route`): bfloat16
takes ``"mma"`` (tensor cores, N a multiple of 8 and at most 128), float32
``"f32"`` (FMA on the CUDA cores).  The head dim P is 16, 32, 64 or 128;
one block's shared memory must fit in 227 KB.  The built library says which
shapes a route takes and what a block of it takes
(:func:`kernel_smem_bytes`); :func:`smem_bytes` is the same layout in
Python, for planning without a card.

On a CUDA tensor a wrapper launches the kernel or raises; on a CPU tensor it
runs the plain version (``ref.ssd_scan``, and :func:`ssd_scan_model_plain`
over ``ref.ssd_scan_states``).  Nothing falls back from the one to the
other.  The kernel has no backward: on a CUDA tensor that autograd would
need a gradient of, the wrappers raise (SSM training is ROADMAP A7).
``launches`` counts kernel launches and nothing else, under a lock;
``route_launches`` counts them per route, and its values sum to
``launches``.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from repro_torch.kernels import _build, ref

launches = 0          # kernel launches made by ssd_scan and ssd_scan_model
ROUTES = ("f32", "mma")                  # in the order of the C dtype codes
route_launches = dict.fromkeys(ROUTES, 0)

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 32, 64, 128)
MAX_SMEM = 232448     # bytes of shared memory one block may take (H100)

_fn = None
_lock = threading.Lock()


def bind(lib: ctypes.CDLL):
    """(launch, error_string) of a loaded ``ssd_scan`` library."""
    fn = lib.ssd_scan
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 9
                   + [ctypes.c_longlong] * 18 + [ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.ssd_scan_error_string.argtypes = [ctypes.c_int]
    lib.ssd_scan_error_string.restype = ctypes.c_char_p
    return fn, lib.ssd_scan_error_string


def reset_counts():
    """Set ``launches`` and every ``route_launches`` count to 0."""
    global launches
    with _lock:
        launches = 0
        for r in ROUTES:
            route_launches[r] = 0


def _kernel():
    global _fn
    with _lock:
        if _fn is None:
            _fn = bind(_build.load("ssd_scan"))
        return _fn


def route(dtype) -> str:
    """The kernel's route for inputs of ``dtype``: "mma" for bfloat16 (tensor
    cores), "f32" for float32 (FMA).  The dtype alone decides."""
    if dtype not in _DTYPE_CODE:
        raise ValueError(f"dtype {dtype}: the kernel takes float32 or bfloat16")
    return ROUTES[_DTYPE_CODE[dtype]]


def smem_bytes(N: int, P: int, Q: int, dtype=torch.bfloat16) -> int:
    """Shared memory of one block of the route for ``dtype``, from the
    source's layout; a launch sizes it in C (:func:`kernel_smem_bytes`, which
    the card tests and chip_smoke hold this to).  mma (``mma_layout`` in the
    source): the f32 state (N rounded up to 16 rows of P + 4), two bf16 tiles
    of 64 rows of B (N + 8 wide) and of x (P + 8), and a, dt and the update's
    factors of the chunk in f32.  f32 (``smem_floats``): two f32 states, the
    C and B tiles, x * dt, the score tile, a and dt."""
    rows = -(-Q // 64) * 64
    if route(dtype) == "mma":
        NP = -(-N // 16) * 16
        return 4 * NP * (P + 4) + 2 * 2 * 64 * (NP + 8) + 2 * 2 * 64 * (P + 8) + 3 * 4 * rows
    return 4 * (2 * N * P + 2 * 64 * (N + 1) + 64 * P + 64 * 65 + 2 * rows)


def _lib():
    """The checkout's library, with its shape queries bound."""
    lib = _build.load("ssd_scan")
    lib.ssd_scan_blocks_per_sm.argtypes = [ctypes.c_int] * 4
    lib.ssd_scan_blocks_per_sm.restype = ctypes.c_int
    lib.ssd_scan_smem_bytes.argtypes = [ctypes.c_int] * 4
    lib.ssd_scan_smem_bytes.restype = ctypes.c_longlong
    return lib


def kernel_smem_bytes(N: int, P: int, Q: int, dtype=torch.bfloat16) -> int:
    """Shared memory that a launch of the route's kernel gives one block at
    these shapes, from the built library; -1 where the route does not take
    them (the launch would refuse them).  Needs nvcc."""
    return _lib().ssd_scan_smem_bytes(_DTYPE_CODE[dtype], N, P, Q)


def blocks_per_sm(N: int, P: int, Q: int, dtype=torch.bfloat16) -> int:
    """Blocks of the route's kernel that one SM holds at once, from the
    card's occupancy calculator (needs the card and the built kernel)."""
    return _lib().ssd_scan_blocks_per_sm(_DTYPE_CODE[dtype], N, P, Q)


def _check(x, bc, init_state, H, G, N, P, Q):
    if x.dtype not in _DTYPE_CODE or any(t.dtype != x.dtype for t in bc):
        raise ValueError(f"dtypes {x.dtype}, {[t.dtype for t in bc]}: the kernel "
                         "takes float32 or bfloat16, x, B and C alike")
    if P not in HEAD_DIMS:
        raise ValueError(f"head dim {P} not in {HEAD_DIMS}")
    if G < 1 or H % G:
        raise ValueError(f"{H} heads are not a multiple of {G} groups")
    if kernel_smem_bytes(N, P, Q, x.dtype) < 0:
        raise ValueError(f"state {N} x {P} with chunk {Q}: the {route(x.dtype)} route does "
                         f"not take it (at most {MAX_SMEM} bytes of shared memory a block; "
                         "on the mma route, bfloat16, N a multiple of 8 up to 128)")
    for name, t in (("x", x), ("B", bc[0]), ("C", bc[1])):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if t.stride(-1) != 1:
            raise ValueError(f"{name} strides {t.stride()}: the last dimension must be dense")
    if init_state is not None and (
            tuple(init_state.shape) != (x.shape[0], H, N, P) or init_state.device != x.device):
        raise ValueError(f"init_state {tuple(init_state.shape)} on {init_state.device}: "
                         f"({x.shape[0]}, {H}, {N}, {P}) on {x.device} expected")
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (x, *bc, init_state)):
        raise NotImplementedError(
            "ssd_scan has no backward kernel yet (SSM training, ROADMAP A7)")


def _rows_aligned(t, strides) -> bool:
    """Every row of ``t`` (last dimension dense) starts 16-byte aligned:
    the base, and each of the (b, h or g, s) ``strides`` in bytes."""
    es = t.element_size()
    return t.data_ptr() % 16 == 0 and all(s * es % 16 == 0 for s in strides)


def _launch(x, dt, a, bm, cm, init_state, y, fin, *, H, G, N, P, Q, nc, strides):
    """One launch; ``strides`` holds the (b, h, s) strides of x, dt, a, y and
    the (b, g, s) strides of B and C, in that order (x, dt, a, B, C, y)."""
    global launches
    fn, err_str = _kernel()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    init = None if init_state is None else init_state.float().contiguous()
    r = route(x.dtype)
    vec = (_rows_aligned(x, strides[0:3]) and _rows_aligned(bm, strides[9:12])
           and _rows_aligned(cm, strides[12:15]))
    err = fn(x.data_ptr(), dt.data_ptr(), a.data_ptr(), bm.data_ptr(), cm.data_ptr(),
             None if init is None else init.data_ptr(), y.data_ptr(),
             None if fin is None else fin.data_ptr(), _DTYPE_CODE[x.dtype],
             int(y.dtype == torch.float32), x.shape[0], H, G, N, P, Q, nc,
             *strides, int(vec), stream)
    if err:
        raise RuntimeError(f"ssd_scan launch failed ({r} route): {err_str(err).decode()} "
                           f"(cuda error {err})")
    with _lock:
        launches += 1
        route_launches[r] += 1


def _route(x):
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no ssd_scan route for device {x.device}")
    return x.device.type


def ssd_scan(x, dt, a_cum, B_in, C_in):
    """Kernel layout: x (B,H,nc,Q,P), dt/a_cum (B,H,nc,Q), B_in/C_in
    (B,H,nc,Q,N) -> y (B,H,nc,Q,P) in x.dtype: the kernel on a CUDA tensor,
    ``ref.ssd_scan`` on a CPU tensor.  The (nc, Q) axes of each tensor must
    merge into one sequence axis (as in a contiguous tensor)."""
    if _route(x) == "cpu":
        return ref.ssd_scan(x, dt, a_cum, B_in, C_in)
    Bb, H, nc, Q, P = x.shape
    N = B_in.shape[-1]
    if tuple(B_in.shape) != (Bb, H, nc, Q, N) or C_in.shape != B_in.shape \
            or tuple(dt.shape) != (Bb, H, nc, Q) or a_cum.shape != dt.shape:
        raise ValueError(f"shapes x {tuple(x.shape)}, dt {tuple(dt.shape)}, a_cum "
                         f"{tuple(a_cum.shape)}, B {tuple(B_in.shape)}, C {tuple(C_in.shape)}")
    _check(x, (B_in, C_in), None, H, H, N, P, Q)
    dt, a_cum = dt.float(), a_cum.float()
    for name, t in (("x", x), ("dt", dt), ("a_cum", a_cum), ("B", B_in), ("C", C_in)):
        if t.stride(2) != Q * t.stride(3):
            raise ValueError(f"{name} strides {t.stride()}: the chunk axes do not merge")
    y = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    if y.numel() == 0:
        return y
    bhs = lambda t: (t.stride(0), t.stride(1), t.stride(3))   # noqa: E731
    _launch(x, dt, a_cum, B_in, C_in, None, y, None, H=H, G=H, N=N, P=P, Q=Q, nc=nc,
            strides=(*bhs(x), *bhs(dt), *bhs(a_cum), *bhs(B_in), *bhs(C_in), *bhs(y)))
    return y


def _to_kernel_layout(t, nc, Q, H=None):
    """(B, S, K, ...) -> (B, K, nc, Q, ...), groups repeated to H heads."""
    if H is not None:
        t = t.repeat_interleave(H // t.shape[2], dim=2)
    t = t.reshape(t.shape[0], nc, Q, *t.shape[2:])
    return t.movedim(3, 1)


def ssd_scan_model_plain(x, dt, a_cum, B_in, C_in, chunk, init_state=None):
    """The plain version of :func:`ssd_scan_model` (any device): the model's
    layout through ``ref.ssd_scan_states`` -> (y (B,S,H,P) f32, final state)."""
    Bb, S, H, P = x.shape
    nc = S // chunk
    y, fin = ref.ssd_scan_states(
        _to_kernel_layout(x, nc, chunk), _to_kernel_layout(dt, nc, chunk),
        _to_kernel_layout(a_cum, nc, chunk), _to_kernel_layout(B_in, nc, chunk, H),
        _to_kernel_layout(C_in, nc, chunk, H), init_state)
    return y.movedim(1, 3).reshape(Bb, S, H, P), fin


def ssd_scan_model(x, dt, a_cum, B_in, C_in, chunk, init_state=None):
    """Model layout: x (B,S,H,P), dt/a_cum (B,S,H) (a_cum the within-chunk
    cumsum of dt*A), B_in/C_in (B,S,G,N), ``chunk`` the chunk length
    (S % chunk == 0), init_state (B,H,N,P) or None -> (y (B,S,H,P) f32
    without the D*x term, final state (B,H,N,P) f32): the kernel on a CUDA
    tensor, :func:`ssd_scan_model_plain` on a CPU tensor."""
    Bb, S, H, P = x.shape
    G, N = B_in.shape[2], B_in.shape[3]
    if chunk < 1 or S % chunk:
        raise ValueError(f"sequence {S} is not a multiple of the chunk {chunk}")
    if tuple(B_in.shape) != (Bb, S, G, N) or C_in.shape != B_in.shape \
            or tuple(dt.shape) != (Bb, S, H) or a_cum.shape != dt.shape:
        raise ValueError(f"shapes x {tuple(x.shape)}, dt {tuple(dt.shape)}, a_cum "
                         f"{tuple(a_cum.shape)}, B {tuple(B_in.shape)}, C {tuple(C_in.shape)}")
    if _route(x) == "cpu":
        return ssd_scan_model_plain(x, dt, a_cum, B_in, C_in, chunk, init_state)
    _check(x, (B_in, C_in), init_state, H, G, N, P, chunk)
    dt, a_cum = dt.float(), a_cum.float()
    y = torch.empty((Bb, S, H, P), dtype=torch.float32, device=x.device)
    fin = torch.empty((Bb, H, N, P), dtype=torch.float32, device=x.device)
    if y.numel() == 0:
        return y, fin.zero_()
    bhs = lambda t: (t.stride(0), t.stride(2), t.stride(1))   # noqa: E731
    _launch(x, dt, a_cum, B_in, C_in, init_state, y, fin, H=H, G=G, N=N, P=P, Q=chunk,
            nc=S // chunk,
            strides=(*bhs(x), *bhs(dt), *bhs(a_cum), *bhs(B_in), *bhs(C_in), *bhs(y)))
    return y, fin
