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

The backward (``csrc/ssd_scan_bwd.cu``, no TPU counterpart: the reference
trains through the VJP of its jnp scan) has a route per dtype as the
forward has, chosen by the dtype alone.  f32: the reverse scan of the
state's gradient, one block per (b, h); the gradients within each chunk,
one block per (b, h, chunk); and a fixed-order sum of dB and dC over each
group's heads.  bf16 (``"mma"``, tensor cores): every chunk's own term of
that scan at once, a combine serial over the chunks only; the chunks'
gradients in clusters of heads that sum dB and dC over distributed shared
memory into one f32 partial per cluster; and the fixed-order sum of each
group's partials.  It reads the state entering each chunk, which the
forward writes when asked (:func:`ssd_scan_model_states`), so it never
rescans the forward.  :class:`SsdScan` joins the two for autograd, and
:func:`ssd_scan_model`, the TACC op's ``cuda`` variant, goes through it when
autograd records (grad enabled and an input requires grad); otherwise it
makes the one forward launch that serving makes, with no extra output.

On a CUDA tensor a wrapper launches the kernel or raises; on a CPU tensor it
runs the plain version (``ref.ssd_scan``, :func:`ssd_scan_model_plain` over
``ref.ssd_scan_states``, :func:`ssd_scan_model_bwd_plain` over
``ref.ssd_scan_bwd``).  Nothing falls back from the one to the other.
``launches`` counts forward launches and nothing else, under a lock;
``route_launches`` counts them per route, and its values sum to
``launches``.  ``bwd_launches`` counts backward calls that reach the
kernels (each makes the launches ``bwd_stage_launches`` counts by stage);
``bwd_route_launches`` counts them per route, and its values sum to
``bwd_launches``.
"""
from __future__ import annotations

import array
import ctypes
import threading

import torch

from repro_torch.kernels import _build, ref

launches = 0          # kernel launches made by ssd_scan and ssd_scan_model
ROUTES = ("f32", "mma")                  # in the order of the C dtype codes
route_launches = dict.fromkeys(ROUTES, 0)
bwd_launches = 0      # backward calls through the kernels (ssd_scan_model_bwd)
bwd_route_launches = dict.fromkeys(ROUTES, 0)
BWD_STAGES = ("state", "chunks", "head_sum")   # the bits 1, 2 and 4 of the C launch
bwd_stage_launches = dict.fromkeys(BWD_STAGES, 0)
# Each route's kernels by the bit of the C launch that makes it alone: on the
# mma route bit 1 makes "delta" and "combine" together (the state stage)
BWD_LAUNCHES = {"f32": {"state": 1, "chunks": 2, "head_sum": 4},
                "mma": {"delta": 8, "combine": 16, "chunks": 2, "group_sum": 4}}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 32, 64, 128)
MAX_SMEM = 232448     # bytes of shared memory one block may take (H100)

_fn = None
_bwd_fn = None
_lock = threading.Lock()


def bind(lib: ctypes.CDLL):
    """(launch, error_string) of a loaded ``ssd_scan`` library."""
    fn = lib.ssd_scan
    fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 9
                   + [ctypes.c_longlong] * 18 + [ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.ssd_scan_error_string.argtypes = [ctypes.c_int]
    lib.ssd_scan_error_string.restype = ctypes.c_char_p
    return fn, lib.ssd_scan_error_string


def bind_bwd(lib: ctypes.CDLL):
    """(launch, error_string) of a loaded ``ssd_scan_bwd`` library; the
    launch takes its 43 integer arguments packed in one int64 array (the
    order is in the source's note), the stage mask and the stream.  Binds
    nothing else, so a library built from an older source binds too."""
    fn = lib.ssd_scan_bwd
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.ssd_scan_bwd_error_string.argtypes = [ctypes.c_int]
    lib.ssd_scan_bwd_error_string.restype = ctypes.c_char_p
    return fn, lib.ssd_scan_bwd_error_string


def reset_counts():
    """Set ``launches``, ``bwd_launches`` and every per-route and per-stage
    count to 0."""
    global launches, bwd_launches
    with _lock:
        launches = bwd_launches = 0
        for r in ROUTES:
            route_launches[r] = bwd_route_launches[r] = 0
        for st in BWD_STAGES:
            bwd_stage_launches[st] = 0


def _kernel():
    global _fn
    with _lock:
        if _fn is None:
            _fn = bind(_build.load("ssd_scan"))
        return _fn


def _bwd_kernel():
    global _bwd_fn
    with _lock:
        if _bwd_fn is None:
            _bwd_fn = bind_bwd(_build.load("ssd_scan_bwd"))
        return _bwd_fn


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


def _rows_aligned(t, strides) -> bool:
    """Every row of ``t`` (last dimension dense) starts 16-byte aligned:
    the base, and each of the (b, h or g, s) ``strides`` in bytes."""
    es = t.element_size()
    return t.data_ptr() % 16 == 0 and all(s * es % 16 == 0 for s in strides)


def _launch(x, dt, a, bm, cm, init_state, y, fin, *, H, G, N, P, Q, nc, strides, states=None):
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
             None if fin is None else fin.data_ptr(),
             None if states is None else states.data_ptr(), _DTYPE_CODE[x.dtype],
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


def _model_shapes(x, dt, a_cum, B_in, C_in, chunk):
    Bb, S, H, P = x.shape
    G, N = B_in.shape[2], B_in.shape[3]
    if chunk < 1 or S % chunk:
        raise ValueError(f"sequence {S} is not a multiple of the chunk {chunk}")
    if tuple(B_in.shape) != (Bb, S, G, N) or C_in.shape != B_in.shape \
            or tuple(dt.shape) != (Bb, S, H) or a_cum.shape != dt.shape:
        raise ValueError(f"shapes x {tuple(x.shape)}, dt {tuple(dt.shape)}, a_cum "
                         f"{tuple(a_cum.shape)}, B {tuple(B_in.shape)}, C {tuple(C_in.shape)}")
    return Bb, S, H, P, G, N


def _forward(x, dt, a_cum, B_in, C_in, chunk, init_state=None, keep_states=False):
    """(y, final state, the states entering each chunk or None): one launch
    of the kernel on a CUDA tensor (writing the chunk states when
    ``keep_states``), :func:`ssd_scan_model_plain` on a CPU tensor (no chunk
    states: the plain backward recomputes them)."""
    Bb, S, H, P, G, N = _model_shapes(x, dt, a_cum, B_in, C_in, chunk)
    if _route(x) == "cpu":
        return (*ssd_scan_model_plain(x, dt, a_cum, B_in, C_in, chunk, init_state), None)
    _check(x, (B_in, C_in), init_state, H, G, N, P, chunk)
    dt, a_cum = dt.float(), a_cum.float()
    nc = S // chunk
    y = torch.empty((Bb, S, H, P), dtype=torch.float32, device=x.device)
    fin = torch.empty((Bb, H, N, P), dtype=torch.float32, device=x.device)
    states = (torch.empty((Bb, H, nc, N, P), dtype=torch.float32, device=x.device)
              if keep_states else None)
    if y.numel() == 0:
        return y, fin.zero_(), None if states is None else states.zero_()
    bhs = lambda t: (t.stride(0), t.stride(2), t.stride(1))   # noqa: E731
    _launch(x, dt, a_cum, B_in, C_in, init_state, y, fin, H=H, G=G, N=N, P=P, Q=chunk, nc=nc,
            strides=(*bhs(x), *bhs(dt), *bhs(a_cum), *bhs(B_in), *bhs(C_in), *bhs(y)),
            states=states)
    return y, fin, states


def ssd_scan_model_states(x, dt, a_cum, B_in, C_in, chunk, init_state=None):
    """One forward launch that also writes the state entering each chunk:
    (y, final state, states (B,H,nc,N,P) f32), what :class:`SsdScan` saves
    for the backward.  CUDA tensors only: the plain backward recomputes the
    states, so the CPU has no use for them."""
    if _route(x) != "cuda":
        raise ValueError(f"the chunk states come from the kernel: {x.device} is not a card")
    return _forward(x, dt, a_cum, B_in, C_in, chunk, init_state, keep_states=True)


class SsdScan(torch.autograd.Function):
    """The SSD scan with its backward kernels (model layout).  The forward
    launch writes the state entering each chunk, saved beside the inputs;
    under remat the recompute writes them again.  The backward computes only
    the gradients ``ctx.needs_input_grad`` asks for.  On CPU tensors it runs
    the plain versions, which keep f64 as f64 so that ``gradcheck`` runs."""

    @staticmethod
    def forward(ctx, x, dt, a_cum, B_in, C_in, chunk, init_state):
        y, fin, states = _forward(x, dt, a_cum, B_in, C_in, chunk, init_state,
                                  keep_states=x.device.type == "cuda")
        ctx.chunk = chunk
        ctx.set_materialize_grads(False)      # an unused final state's gradient stays None
        ctx.save_for_backward(x, dt, a_cum, B_in, C_in, init_state, states)
        return y, fin

    @staticmethod
    def backward(ctx, dy, dfin):
        x, dt, a_cum, B_in, C_in, init_state, states = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
        need = ctx.needs_input_grad
        grads = ssd_scan_model_bwd(x, dt, a_cum, B_in, C_in, ctx.chunk, dy, dfin, init_state,
                                   states, needs=(*need[:5], need[6]))
        return (*grads[:5], None, grads[5])


def ssd_scan_model(x, dt, a_cum, B_in, C_in, chunk, init_state=None):
    """Model layout: x (B,S,H,P), dt/a_cum (B,S,H) (a_cum the within-chunk
    cumsum of dt*A), B_in/C_in (B,S,G,N), ``chunk`` the chunk length
    (S % chunk == 0), init_state (B,H,N,P) or None -> (y (B,S,H,P) f32
    without the D*x term, final state (B,H,N,P) f32): the kernel on a CUDA
    tensor, :func:`ssd_scan_model_plain` on a CPU tensor.  When autograd
    records (grad enabled and an input requires grad) the call goes through
    :class:`SsdScan`, whose backward is the backward kernel (the plain
    backward on a CPU tensor); otherwise it is the one forward launch that
    serving makes."""
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                       for t in (x, dt, a_cum, B_in, C_in, init_state)):
        return SsdScan.apply(x, dt, a_cum, B_in, C_in, chunk, init_state)
    return _forward(x, dt, a_cum, B_in, C_in, chunk, init_state)[:2]


# ---------------------------------------------------------------------------
# The backward
# ---------------------------------------------------------------------------

def ssd_scan_model_bwd_plain(x, dt, a_cum, B_in, C_in, chunk, dy, dfin=None, init_state=None):
    """The plain version of :func:`ssd_scan_model_bwd` (any device):
    ``ref.ssd_scan_bwd`` at the kernel's layout, groups repeated to heads,
    and back -> (dx in x's type, ddt and da_cum (B,S,H) f32, dB and dC
    (B,S,G,N) in B's type, each the f32 sum over its group's heads rounded
    once, dinit (B,H,N,P) f32 or None); f64 stays f64."""
    Bb, S, H, P, G, N = _model_shapes(x, dt, a_cum, B_in, C_in, chunk)
    nc = S // chunk

    def kl(t, heads=None):
        return _to_kernel_layout(t, nc, chunk, heads)

    dx, ddt, da, dB, dC, dinit = ref.ssd_scan_bwd(
        kl(x), kl(dt), kl(a_cum), kl(B_in, H), kl(C_in, H), kl(dy), init_state, dfin)

    def back(t):                    # (B,H,nc,Q,...) -> (B,S,H,...)
        return t.movedim(1, 3).reshape(Bb, S, H, *t.shape[4:])

    def group_sum(t):
        out = back(t).reshape(Bb, S, G, H // G, N).sum(3)
        return out if out.dtype == torch.float64 else out.to(B_in.dtype)

    return (back(dx).to(x.dtype), back(ddt), back(da), group_sum(dB), group_sum(dC), dinit)


def _bwd_lib():
    """The checkout's backward library, with its shape queries bound."""
    lib = _build.load("ssd_scan_bwd")
    lib.ssd_scan_bwd_route_smem_bytes.argtypes = [ctypes.c_int] * 5
    lib.ssd_scan_bwd_route_smem_bytes.restype = ctypes.c_longlong
    lib.ssd_scan_bwd_head_planes.argtypes = [ctypes.c_int] * 3
    lib.ssd_scan_bwd_head_planes.restype = ctypes.c_int
    lib.ssd_scan_bwd_active_clusters.argtypes = [ctypes.c_int] * 5
    lib.ssd_scan_bwd_active_clusters.restype = ctypes.c_int
    return lib


def bwd_smem_bytes(stage: str, N: int, P: int, Q: int, dtype=torch.float32) -> int:
    """Shared memory of one block of the backward's launch ``stage``
    ("state" or "chunks"; on the mma route "state" is the chunks' own terms
    of the scan) of the route for ``dtype`` at these shapes, from the built
    library; -1 where the launch refuses them.  Needs nvcc."""
    return _bwd_lib().ssd_scan_bwd_route_smem_bytes(
        _DTYPE_CODE[dtype], BWD_STAGES.index(stage) + 1, N, P, Q)


def bwd_head_planes(H: int, G: int, dtype=torch.float32) -> int:
    """(S, N) f32 planes a batch of the backward's dB and dC scratch, from
    the built library: H on the f32 route (per head), H over the cluster
    size on the mma route (one partial per cluster of heads).  Needs nvcc."""
    return _bwd_lib().ssd_scan_bwd_head_planes(_DTYPE_CODE[dtype], H, G)


def bwd_active_clusters(H: int, G: int, N: int, P: int, Q: int) -> int:
    """Clusters of the mma route's chunks launch that the card holds at once
    (its occupancy calculator); needs the card."""
    return _bwd_lib().ssd_scan_bwd_active_clusters(H, G, N, P, Q)


def _check_bwd(x, B_in, C_in, init_state, dy, states, H, G, N, P, Q, nc):
    _check(x, (B_in, C_in), init_state, H, G, N, P, Q)
    r = route(x.dtype)
    for stage in ("state", "chunks"):
        if bwd_smem_bytes(stage, N, P, Q, x.dtype) < 0:
            raise ValueError(
                f"state {N} x {P} with chunk {Q}: the backward's {r} route does not take it "
                f"in its {stage} launch (at most {MAX_SMEM} bytes of shared memory a block; N up "
                "to 128; f32: P 16 to 128; mma, bfloat16: P 16, 32 or 64, N a multiple of 8, a "
                "chunk of at most 256; ROADMAP C7)")
    Bb, S = x.shape[0], x.shape[1]
    if tuple(dy.shape) != (Bb, S, H, P) or dy.device != x.device:
        raise ValueError(f"dy {tuple(dy.shape)} on {dy.device}: ({Bb}, {S}, {H}, {P}) on "
                         f"{x.device} expected")
    if states is None or tuple(states.shape) != (Bb, H, nc, N, P) \
            or states.dtype != torch.float32 or not states.is_contiguous():
        raise ValueError("the backward reads the forward's chunk states, (B, H, nc, N, P) "
                         "f32 contiguous (ssd_scan_model_states)")


def _bwd_args(x, dt, a_cum, B_in, C_in, dy, states, dfin, out, chunk):
    """The kernel's packed arguments (the source's note) for ``out``, a dict
    of the output tensors ("gst", "dinit", "dx", "ddt", "da", "dbh", "dch",
    "db", "dc"; None where not asked for)."""
    Bb, S, H, P = x.shape
    G, N = B_in.shape[2], B_in.shape[3]

    def ptr(t):
        return 0 if t is None else t.data_ptr()

    bhs = lambda t: (t.stride(0), t.stride(2), t.stride(1))   # noqa: E731
    vals = [ptr(t) for t in (x, dt, a_cum, B_in, C_in, dy, states, dfin)]
    vals += [ptr(out[k]) for k in ("gst", "dinit", "dx", "ddt", "da", "dbh", "dch", "db", "dc")]
    vals += [_DTYPE_CODE[x.dtype], Bb, H, G, N, P, chunk, S // chunk]
    for t in (x, dt, a_cum, B_in, C_in, dy):
        vals += bhs(t)
    return array.array("q", vals)


def _launch_bwd(args, stages: int, device):
    """The backward's launches named by the bit mask ``stages`` (1 state, 2
    chunks, 4 head sum; ``BWD_LAUNCHES`` names each kernel's bit), on the
    device's current stream; ``bwd_stage_launches`` counts bits 1, 2, 4."""
    fn, err_str = _bwd_kernel()
    stream = torch.cuda.current_stream(device).cuda_stream
    addr, _ = args.buffer_info()
    err = fn(addr, stages, stream)
    if err:
        raise RuntimeError(f"ssd_scan backward launch failed (stages {stages}): "
                           f"{err_str(err).decode()} (cuda error {err})")
    with _lock:
        for i, st in enumerate(BWD_STAGES):
            if stages >> i & 1:
                bwd_stage_launches[st] += 1


def bwd_buffers(x, B_in, init_state, chunk, needs, planes=None):
    """The backward's outputs and scratch (``gst``, the state's gradient after
    each chunk; ``dbh`` and ``dch``, ``planes`` (S, N) f32 planes a batch,
    by default :func:`bwd_head_planes` of the route) for ``needs`` (six
    flags: dx, ddt, da_cum, dB, dC, dinit): a dict of tensors, None where not
    asked for."""
    Bb, S, H, P = x.shape
    G, N = B_in.shape[2], B_in.shape[3]
    if planes is None:
        planes = bwd_head_planes(H, G, x.dtype)

    def f32(*shape):
        return torch.empty(shape, dtype=torch.float32, device=x.device)

    out = {"gst": f32(Bb, H, S // chunk, N, P),
           "dinit": f32(Bb, H, N, P) if needs[5] and init_state is not None else None,
           "dx": torch.empty((Bb, S, H, P), dtype=x.dtype, device=x.device) if needs[0] else None,
           "ddt": f32(Bb, S, H) if needs[1] else None, "da": f32(Bb, S, H) if needs[2] else None,
           "dbh": f32(Bb, planes, S, N) if needs[3] else None,
           "dch": f32(Bb, planes, S, N) if needs[4] else None,
           "db": torch.empty((Bb, S, G, N), dtype=B_in.dtype, device=x.device)
           if needs[3] else None,
           "dc": torch.empty((Bb, S, G, N), dtype=B_in.dtype, device=x.device)
           if needs[4] else None}
    return out


def ssd_scan_model_bwd(x, dt, a_cum, B_in, C_in, chunk, dy, dfin=None, init_state=None,
                       states=None, needs=(True,) * 6):
    """The gradients of :func:`ssd_scan_model` for the output gradients dy
    (B,S,H,P) and dfin (B,H,N,P) (None: zeros) -> (dx in x's type, ddt and
    da_cum (B,S,H) f32, dB and dC (B,S,G,N) in B's type, dinit (B,H,N,P)
    f32), None for each gradient that ``needs`` (six flags, in that order)
    does not ask for, and dinit None without an initial state.  The kernels
    on a CUDA tensor, which read ``states``, the state entering each chunk
    from the forward (:func:`ssd_scan_model_states`); the plain version on a
    CPU tensor."""
    global bwd_launches
    Bb, S, H, P, G, N = _model_shapes(x, dt, a_cum, B_in, C_in, chunk)
    if _route(x) == "cpu":
        grads = ssd_scan_model_bwd_plain(x, dt, a_cum, B_in, C_in, chunk, dy, dfin, init_state)
        return tuple(g if n else None for g, n in zip(grads, needs))
    nc = S // chunk
    dy = dy.float()
    if dy.stride(-1) != 1:
        dy = dy.contiguous()
    _check_bwd(x, B_in, C_in, init_state, dy, states, H, G, N, P, chunk, nc)
    dt, a_cum = dt.float(), a_cum.float()
    if dfin is not None:
        dfin = dfin.float().contiguous()
    out = bwd_buffers(x, B_in, init_state, chunk, needs)
    if (not any(needs[:5]) and out["dinit"] is None) or x.numel() == 0:
        return tuple(None if t is None else t.zero_() for t in (
            out["dx"], out["ddt"], out["da"], out["db"], out["dc"], out["dinit"]))
    stages = 1 | (2 if any(needs[:5]) else 0) | (4 if needs[3] or needs[4] else 0)
    _launch_bwd(_bwd_args(x, dt, a_cum, B_in, C_in, dy, states, dfin, out, chunk), stages,
                x.device)
    with _lock:
        bwd_launches += 1
        bwd_route_launches[route(x.dtype)] += 1
    return out["dx"], out["ddt"], out["da"], out["db"], out["dc"], out["dinit"]
