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

The kernel has four routes (the source note has each one's design), chosen
by :func:`route` from dtype, shapes, strides and alignment before the launch,
never after a failure: ``"wgmma"`` (bf16, M > 16, every operand describable
by TMA: the prefill route), ``"mma16"`` (bf16, M <= 16: decode),
``"mma128"`` (bf16 that TMA cannot describe) and ``"f32"``.  The decode
route streams the weights through persistent blocks where TMA can describe
x and w; :func:`stream_plan` is its split of the work over the card, a pure
function of shapes.

On a CUDA tensor the wrapper launches the kernel or raises; on a CPU tensor it
runs the plain version (``ref.grouped_matmul``).  Nothing falls back from the
one to the other.  ``launches`` counts kernel launches and nothing else, under
a lock; ``route_launches`` counts them per route, and its values sum to
``launches``.

Where autograd records (grad enabled and x or w requires grad) the call goes
through :class:`GroupedMatmul`, whose backward is :func:`grouped_matmul_bwd`:
dx = dy wᵀ and dw = xᵀ dy, the two products the reference gets from the VJP
of its einsums (it has no Pallas backward), each launched only where
autograd asks for it.  They run the same kernel source on views of the saved
x and w (``grouped_matmul_strided`` in the source note): ``"dx_wgmma"`` and
``"dw_wgmma"`` (bf16, capacity M > 16, every operand describable by TMA) or
``"dx_simt"`` / ``"dw_simt"`` (the strided fmaf kernel: f32, M <= 16, and
views TMA cannot describe), chosen by :func:`bwd_route` before the launch;
on the wgmma routes :func:`bwd_schedule` picks the k depth of a stage from
shapes, before the launch too, and :class:`BwdSchedule` mirrors the
kernel's tile decode.
On a CPU tensor the Function runs the plain forward and the plain backward
(``ref.grouped_matmul_bwd``).  ``bwd_launches`` and ``bwd_route_launches``
count the backward's launches as the forward's are counted.
"""
from __future__ import annotations

import ctypes
import dataclasses
import threading

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import grouped_matmul as grouped_matmul_plain
from repro_torch.kernels.ref import grouped_matmul_bwd as grouped_matmul_bwd_plain

launches = 0          # kernel launches made by grouped_matmul
ROUTES = ("f32", "mma16", "mma128", "wgmma")     # in the order of the C route codes
route_launches = dict.fromkeys(ROUTES, 0)
bwd_launches = 0      # kernel launches made by grouped_matmul_bwd
BWD_ROUTES = ("dx_simt", "dw_simt", "dx_wgmma", "dw_wgmma")
bwd_route_launches = dict.fromkeys(BWD_ROUTES, 0)

_DTYPES = (torch.float32, torch.bfloat16)

# The decode route's weight stream (csrc/grouped_matmul.cu: kSBN, kSBK,
# kSConsumers; grouped_matmul_stream_geometry reports the library's): tiles
# of 512 columns, units of 64 K rows, 256 consumer threads that each keep 4
# f32 sums per 16 columns of their warp's share (an eighth of the tile) and
# per 8 rows of x.
STREAM_BN, STREAM_BK, STREAM_THREADS = 512, 64, 256

_fn = None
_strided_fn = None
_lock = threading.Lock()
_sms = {}              # device index -> streaming multiprocessors
_arrivals = {}         # (device index, stream) -> the stream's zeroed tile counters


def bind(lib: ctypes.CDLL):
    """(launch, error_string, stream geometry) of a loaded ``grouped_matmul``
    library; the geometry is the library's (tile columns, unit K rows,
    consumer threads) of the decode route's weight stream."""
    fn = lib.grouped_matmul
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 5
                   + [ctypes.c_longlong] * 6 + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 3)
    fn.restype = ctypes.c_int
    strided = lib.grouped_matmul_strided
    strided.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 5
                        + [ctypes.c_longlong] * 8 + [ctypes.c_int, ctypes.c_void_p])
    strided.restype = ctypes.c_int
    lib.grouped_matmul_error_string.argtypes = [ctypes.c_int]
    lib.grouped_matmul_error_string.restype = ctypes.c_char_p
    lib.grouped_matmul_stream_geometry.argtypes = [ctypes.c_int]
    lib.grouped_matmul_stream_geometry.restype = ctypes.c_int
    geometry = tuple(lib.grouped_matmul_stream_geometry(i) for i in range(3))
    return fn, lib.grouped_matmul_error_string, geometry


def reset_counts():
    """Set ``launches``, ``bwd_launches`` and every route's count to 0."""
    global launches, bwd_launches
    with _lock:
        launches = bwd_launches = 0
        for counts in (route_launches, bwd_route_launches):
            for r in counts:
                counts[r] = 0


def _kernel():
    global _fn, _strided_fn
    with _lock:
        if _fn is None:
            lib = _build.load("grouped_matmul")
            _fn, _strided_fn = bind(lib), lib.grouped_matmul_strided
        return _fn


def _check(x, w):
    if x.dim() != 3 or w.dim() != 3:
        raise ValueError(f"x {tuple(x.shape)}, w {tuple(w.shape)}: (G, M, K) and "
                         "(G, K, N) expected")
    if x.shape[0] != w.shape[0] or x.shape[2] != w.shape[1]:
        raise ValueError(f"x {tuple(x.shape)} and w {tuple(w.shape)} do not match "
                         "in G or K")
    if x.dtype not in _DTYPES or w.dtype != x.dtype:
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


def _aligned_rows(*ts) -> bool:
    """Every row of each bf16 (G, rows, cols) tensor starts 16-byte aligned:
    the base is, and both outer strides are multiples of 8 elements."""
    return all(t.data_ptr() % 16 == 0 and all(s % 8 == 0 for s in t.stride()[:2])
               for t in ts)


def _vector_loads(x, w) -> bool:
    """True when every row of x and w starts 16-byte aligned (bf16): the
    mma.sync routes then copy their tiles with 16-byte cp.async."""
    return x.dtype == torch.bfloat16 and _aligned_rows(x, w)


def _tma_rows(x, w) -> bool:
    """TMA can describe x and w: rows 16-byte aligned and no stride 0."""
    return _aligned_rows(x, w) and min(x.stride()[:2] + w.stride()[:2]) > 0


@dataclasses.dataclass(frozen=True)
class StreamPlan:
    """The decode route's split of x (G, M, K) @ w (G, K, N) over the card.

    The work is ``units`` units, each 64 K rows (``STREAM_BK``) of one
    512-column tile (``STREAM_BN``) of one group, in the order (g, tile, K),
    K fastest: tile t holds units ``[t * units_per_tile, (t + 1) *
    units_per_tile)``.  Block b of ``blocks`` takes the run ``[start(b),
    start(b + 1))``, ``start(b) = b * units // blocks``: equal shares within
    one unit.  A tile cut by a run's end is split-K over the consecutive
    blocks :meth:`parts` names, and its f32 parts are summed in that order.
    """

    G: int
    M: int
    K: int
    N: int
    blocks: int
    n_tiles: int            # column tiles per group
    units_per_tile: int
    bn: int = STREAM_BN     # columns of a tile
    bk: int = STREAM_BK     # K rows of a unit
    threads: int = STREAM_THREADS

    @property
    def units(self) -> int:
        return self.G * self.n_tiles * self.units_per_tile

    def start(self, b: int) -> int:
        return b * self.units // self.blocks

    def owner(self, u: int) -> int:
        """The block whose run holds unit u."""
        return ((u + 1) * self.blocks + self.units - 1) // self.units - 1

    def parts(self, t: int) -> range:
        """The blocks that hold a part of tile t, in summing order."""
        return range(self.owner(t * self.units_per_tile),
                     self.owner((t + 1) * self.units_per_tile - 1) + 1)

    @property
    def m_tiles(self) -> int:
        """n8 tiles of x rows: 1 for M <= 8, else 2."""
        return 1 if self.M <= 8 else 2

    @property
    def scratch_floats(self) -> int:
        """f32 scratch: two part slots per block (the first and the last
        tile of its run), each the consumer threads' sums."""
        per_thread = 4 * (self.bn // 16) // (self.threads // 32) * self.m_tiles
        return self.blocks * 2 * self.threads * per_thread


def stream_plan(G: int, M: int, K: int, N: int, sms: int,
                geometry=(STREAM_BN, STREAM_BK, STREAM_THREADS)) -> StreamPlan:
    """The decode route's weight stream on a card of ``sms`` SMs: one
    persistent block per SM, fewer where there are fewer units."""
    bn, bk, threads = geometry
    n_tiles = -(-N // bn)
    ku = -(-K // bk)
    return StreamPlan(G, M, K, N, min(sms, G * n_tiles * ku), n_tiles, ku, bn, bk, threads)


def _sm_count(device) -> int:
    idx = device.index if device.index is not None else torch.cuda.current_device()
    n = _sms.get(idx)
    if n is None:
        n = _sms[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return n


def _arrivals_for(device, stream, blocks):
    """The tile counters of launches on ``stream``: zero, and left zero by
    every launch, so launches in order on one stream share them."""
    key = (device.index, stream)
    with _lock:
        buf = _arrivals.get(key)
        if buf is None or buf.numel() < blocks:
            buf = _arrivals[key] = torch.zeros(blocks, dtype=torch.int32, device=device)
        return buf


def route(x, w) -> str:
    """The kernel route for x (G, M, K) @ w (G, K, N), from dtype, shapes,
    strides and alignment alone (no launch; meta tensors will do).  wgmma
    needs TMA to describe x, w and the contiguous (G, M, N) output: bases
    16-byte aligned and every stride but the last a multiple of 8 elements
    (so N % 8 == 0 for the output)."""
    if x.dtype == torch.float32:
        return "f32"
    if x.shape[1] <= 16:
        return "mma16"
    if _aligned_rows(x, w) and w.shape[2] % 8 == 0 and min(x.stride()[:2] + w.stride()[:2]) > 0:
        return "wgmma"
    return "mma128"


def grouped_matmul(x, w):
    """x (G, M, K) @ w (G, K, N) -> (G, M, N) in x.dtype, f32 accumulation:
    the kernel on a CUDA tensor, the plain version on a CPU tensor; through
    :class:`GroupedMatmul` where autograd records."""
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        return GroupedMatmul.apply(x, w)
    return _forward(x, w)


class GroupedMatmul(torch.autograd.Function):
    """The grouped matmul with its backward kernels.  x and w are saved as
    given: w is a layer slice of the stacked (L, E, D, F) leaf, so saving the
    view copies nothing (its gradient reaches the leaf through autograd's
    slice backward, one more full-size tensor per layer)."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return _forward(x, w)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        return grouped_matmul_bwd(x, w, dy, *ctx.needs_input_grad)


def _forward(x, w):
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
    fn, err_str, geometry = _kernel()
    r = route(x, w)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    blocks, part, arrivals = 0, None, None
    if r == "mma16" and _tma_rows(x, w):
        plan = stream_plan(G, M, K, N, _sm_count(x.device), geometry)
        blocks = plan.blocks
        part = torch.empty(plan.scratch_floats, dtype=torch.float32, device=x.device)
        arrivals = _arrivals_for(x.device, stream, blocks)
    err = fn(x.data_ptr(), w.data_ptr(), out.data_ptr(), ROUTES.index(r),
             G, M, K, N, x.stride(0), x.stride(1), w.stride(0), w.stride(1),
             out.stride(0), out.stride(1), int(_vector_loads(x, w)), blocks,
             part.data_ptr() if part is not None else None,
             arrivals.data_ptr() if arrivals is not None else None, stream)
    if err:
        raise RuntimeError(f"grouped_matmul launch failed ({r} route): "
                           f"{err_str(err).decode()} (cuda error {err})")
    with _lock:
        launches += 1
        route_launches[r] += 1
    return out


# ---------------------------------------------------------------------------
# The backward: dx = dy wᵀ, dw = xᵀ dy
# ---------------------------------------------------------------------------

def bwd_route(x, w, dy, which: str) -> str:
    """The backward kernel's route for ``which`` ("dx" or "dw") of x (G, M, K)
    @ w (G, K, N) with output gradient dy (G, M, N), from dtype, shapes,
    strides and alignment alone (meta tensors will do): ``"<which>_wgmma"``
    where x is bf16, the capacity M > 16 and TMA can describe the product's
    operands and its contiguous output (dy dense in N; w for dx, x for dw,
    and dy with 16-byte aligned rows and no stride 0; the output's last
    dimension, K for dx and N for dw, a multiple of 8), else
    ``"<which>_simt"``."""
    if which not in ("dx", "dw"):
        raise ValueError(f"which={which!r}: 'dx' or 'dw'")
    other = w if which == "dx" else x
    cols = x.shape[2] if which == "dx" else w.shape[2]
    tma = (x.dtype == torch.bfloat16 and x.shape[1] > 16 and dy.stride(2) == 1
           and cols % 8 == 0 and _aligned_rows(other, dy)
           and min(other.stride()[:2] + dy.stride()[:2]) > 0)
    return f"{which}_{'wgmma' if tma else 'simt'}"


BWD_TILE_M, BWD_TILE_N = 128, 256    # the wgmma tile (csrc/grouped_matmul.cu: kWBM, kWBN)
BWD_TILE_K = (64, 80)                # contraction rows of a stage (80: dw only)


@dataclasses.dataclass(frozen=True)
class BwdSchedule:
    """How the backward's wgmma routes walk the product ``which`` a (G, M, K)
    @ b (G, K, N) (``csrc/grouped_matmul.cu``: ``gmm_wgmma``, ``TileGrid``):
    output tiles of 128 x 256, the contraction in stages of ``tile_k`` rows
    (64, or 80 for dw, whose operands are both MN-major), and ``blocks``
    persistent blocks (one per SM, fewer where there are fewer tiles) taking
    tiles b, b + blocks, ... of the forward's order (g, N tile, M tile), M
    tile fastest.  Raises on a schedule the kernel does not take."""

    which: str
    G: int
    M: int
    K: int
    N: int
    tile_k: int
    blocks: int

    def __post_init__(self):
        if self.which not in ("dx", "dw"):
            raise ValueError(f"which={self.which!r}: 'dx' or 'dw'")
        if self.tile_k not in BWD_TILE_K or (self.tile_k != 64 and self.which != "dw"):
            raise ValueError(f"stages of {self.tile_k} for {self.which}: the kernel takes "
                             f"{BWD_TILE_K}, 80 for dw only")
        if min(self.G, self.M, self.K, self.N) < 1 or not 1 <= self.blocks <= self.tiles:
            raise ValueError(f"{self}: positive extents and 1 to {self.tiles} blocks")

    @property
    def n_m(self) -> int:
        return -(-self.M // BWD_TILE_M)

    @property
    def n_n(self) -> int:
        return -(-self.N // BWD_TILE_N)

    @property
    def n_k(self) -> int:
        return -(-self.K // self.tile_k)

    @property
    def tiles(self) -> int:
        return self.G * self.n_m * self.n_n

    @property
    def name(self) -> str:
        return f"128x{BWD_TILE_N}x{self.tile_k}"

    def decode(self, t: int) -> tuple:
        """Tile t of the order -> (g, M tile, N tile), as ``TileGrid``."""
        rest, mt = divmod(t, self.n_m)
        g, nt = divmod(rest, self.n_n)
        return g, mt, nt

    def block_tiles(self, b: int) -> list:
        """The tiles block b takes, in its order."""
        return [self.decode(t) for t in range(b, self.tiles, self.blocks)]


def bwd_product_shape(G: int, M: int, K: int, N: int, which: str) -> tuple:
    """(G, M', K', N') of the backward product ``which`` of x (G, M, K) @ w
    (G, K, N): dx = dy wᵀ is (G, M, N) @ (G, N, K), dw = xᵀ dy is (G, K, M)
    @ (G, M, N)."""
    if which == "dx":
        return G, M, N, K
    if which == "dw":
        return G, K, M, N
    raise ValueError(f"which={which!r}: 'dx' or 'dw'")


def _dw_depth(capacity: int) -> int:
    """The stage depth of dw, whose contraction is the capacity: 80 where
    its stages hold fewer zero rows than stages of 64 (480: 6 stages of 80
    against 7.5 of 64), else 64."""
    return min(BWD_TILE_K, key=lambda d: (-(-capacity // d) * d, d))


def bwd_schedule(G: int, M: int, K: int, N: int, which: str, sms: int) -> BwdSchedule:
    """The schedule of the backward product ``which`` ("dx" or "dw") of x
    (G, M, K) @ w (G, K, N) on a card of ``sms`` SMs, a pure function of
    shapes, chosen before the launch: the forward's tile and order, with
    dw's stages 80 deep where that leaves fewer zero rows in its
    contraction over the capacity (:func:`_dw_depth`).  Bands of M tiles,
    ping-pong consumers and 128-wide tiles lost to this on the card
    (DESIGN_TORCH.md section 18)."""
    Gp, Mp, Kp, Np = bwd_product_shape(G, M, K, N, which)
    tile_k = _dw_depth(Kp) if which == "dw" else 64
    tiles = Gp * -(-Mp // BWD_TILE_M) * -(-Np // BWD_TILE_N)
    return BwdSchedule(which, Gp, Mp, Kp, Np, tile_k, min(tiles, sms))


def _check_bwd(x, w, dy):
    _check(x, w)
    G, M, _ = x.shape
    if tuple(dy.shape) != (G, M, w.shape[2]) or dy.dtype != x.dtype or dy.device != x.device:
        raise ValueError(f"dy {tuple(dy.shape)} {dy.dtype} on {dy.device}: ({G}, {M}, "
                         f"{w.shape[2]}) {x.dtype} on {x.device} expected")


def _launch_bwd(which, x, w, dy):
    """One backward product through the kernel: dx = dy @ wᵀ (a = dy, b = the
    view wᵀ) or dw = xᵀ @ dy (a = the view xᵀ, b = dy); on the wgmma routes
    in :func:`bwd_schedule`'s stages."""
    global bwd_launches
    a, b = (dy, w.transpose(1, 2)) if which == "dx" else (x.transpose(1, 2), dy)
    G, M, K = a.shape
    N = b.shape[2]
    if M == 0 or N == 0:
        return torch.empty((G, M, N), dtype=x.dtype, device=x.device)
    if K == 0:                       # an empty capacity: dw is zero
        return torch.zeros((G, M, N), dtype=x.dtype, device=x.device)
    out = torch.empty((G, M, N), dtype=x.dtype, device=x.device)
    _kernel()
    r = bwd_route(x, w, dy, which)
    tile_k = 64
    if r.endswith("wgmma"):
        code = {"dx": 2, "dw": 3}[which]
        tile_k = bwd_schedule(*x.shape, w.shape[2], which, _sm_count(x.device)).tile_k
    else:
        code = int(x.dtype == torch.bfloat16)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _strided_fn(a.data_ptr(), b.data_ptr(), out.data_ptr(), code, G, M, K, N,
                      *a.stride(), *b.stride(), out.stride(0), out.stride(1), tile_k,
                      stream)
    if err:
        raise RuntimeError(f"grouped_matmul backward launch failed ({r} route): "
                           f"{_fn[1](err).decode()} (cuda error {err})")
    with _lock:
        bwd_launches += 1
        bwd_route_launches[r] += 1
    return out


def grouped_matmul_bwd(x, w, dy, need_dx: bool = True, need_dw: bool = True):
    """(dx, dw) of x (G, M, K) @ w (G, K, N) for the output gradient dy:
    dx = dy wᵀ (G, M, K) and dw = xᵀ dy (G, K, N) in x's type, f32
    accumulation; None for a gradient not asked for.  The kernel on a CUDA
    tensor (it launches or raises), the plain version on a CPU tensor."""
    if x.device.type == "cpu":
        dx, dw = grouped_matmul_bwd_plain(x, w, dy)
        return dx if need_dx else None, dw if need_dw else None
    if x.device.type != "cuda":
        raise ValueError(f"no grouped-matmul route for device {x.device}")
    _check_bwd(x, w, dy)
    return (_launch_bwd("dx", x, w, dy) if need_dx else None,
            _launch_bwd("dw", x, w, dy) if need_dw else None)
