"""Ring collectives with in-kernel reduction (the ``backend="pallas"`` rings,
DESIGN.md §10): the hand-written Hopper kernels and their schedules.

Counterpart of ``repro/kernels/ring_dma.py``.  Two ways to run a ring
without a codec, chosen in the open as the reference's ``_on_tpu()``
chooses:

* **fused**, when every rank of the ring is a :class:`ThreadMesh` rank on one
  CUDA device: one launch of ``csrc/ring_dma.cu`` covers every rank of the
  mesh (:func:`reduce_scatter_fused`, :func:`all_gather_fused`), replacing
  the Pallas TPU kernels ``_rs_dma_kernel`` / ``_ag_dma_kernel``.  The ranks
  meet in :meth:`ThreadMesh.rendezvous`; the last to arrive launches.  There
  is no fallback: if the kernel cannot build, launch or keep its ranks
  resident, or a wait times out, the call raises.
* **emulated** (:func:`_rs_emulated`, :func:`_ag_emulated`): the same
  numerics and wave structure with the wire hop carried by ``ppermute`` and
  the accumulate dispatched through TACC ``collective_reduce`` (the CUDA
  ``_reduce_kernel`` port on CUDA tensors, its plain version on CPU
  tensors).  It runs on a :class:`DistMesh`, on the CPU, and wherever the
  TACC defaults of ``ring_reduce_scatter`` / ``ring_all_gather`` are pinned
  to ``"emulated"`` (the counterpart of the reference tests' interpret pin).

Each fused schedule also has a plain-torch version
(:func:`reduce_scatter_fused_plain`, :func:`all_gather_fused_plain`): the
kernel's protocol for all ranks of a launch, stepped in order on the host,
with its flags and credits as counters (the reduce-scatter's per pulled
partial in a :class:`PullLedger`, the all-gather's per parity slot).  The
wrappers run it for CPU tensors; the card checks hold the kernels against
it bit for bit.

With a ``wire_quant`` codec (DESIGN.md §17) a ring takes the quantized
emulated schedule on every device, as the reference does on every platform
(:func:`_quant_rs_emulated`, :func:`_quant_ag_emulated`): the hop carries int8
codes and an f32 scale sidecar through ``ppermute``, and the codec's compute
is TACC ``wire_quantize`` / ``wire_dequant_accum`` (the ``csrc/quant.cu``
kernels on CUDA tensors).  The fused kernels never carry a codec.

``n_stripes`` splits each wire hop into that many per-link parts, each with
its own flag (and, in the all-gather, its own slot; DESIGN.md §11); the
result is bit-equal to the unstriped ring.  All per-rank functions run inside a mesh (``core.mesh``).
"""
from __future__ import annotations

import collections
import ctypes
import functools
import threading

import torch

from repro_torch.core import mesh, tacc
from repro_torch.core.collectives import chunked
from repro_torch.kernels import _build, quant
from repro_torch.transport.stripe import MAX_STRIPES

# Double-buffer depth: streams per ring step, whose hops overlap the other
# stream's accumulate.
NUM_BUFFERS = 2

rs_launches = 0       # launches of the fused reduce-scatter kernel
ag_launches = 0       # launches of the fused all-gather kernel

SCHEDULE_OPS = ("ring_reduce_scatter", "ring_all_gather")
_RS_CODE = {torch.float32: 0, torch.bfloat16: 1}


class RingProtocolError(RuntimeError):
    """The ring protocol failed: a wait of the fused kernel timed out on the
    card, or its plain version found a slot, partial or credit out of order."""


def _ring_perm(n: int, direction: int) -> list[tuple[int, int]]:
    return [(j, (j + direction) % n) for j in range(n)]


def _clamp_stripes(n_stripes: int, rows: int) -> int:
    """Stripe count for a payload: the transport cap, bounded by the
    payload's own granularity (a stripe carries at least one row)."""
    return max(1, min(int(n_stripes), MAX_STRIPES, max(rows, 1)))


def _striped_hop(blk, axis: str, perm, n_stripes: int):
    """One wire hop as ``n_stripes`` per-link hops of contiguous parts along
    dim 0, reassembled: bit-identical to the single hop."""
    k = _clamp_stripes(n_stripes, blk.shape[0])
    if k == 1:
        return mesh.ppermute(blk, axis, perm)
    q, r = divmod(blk.shape[0], k)
    sizes = [q + 1] * r + [q] * (k - r)
    return torch.cat([mesh.ppermute(part, axis, perm)
                      for part in torch.split(blk, sizes, 0)], 0)


def _reduce(acc, incoming):
    """One chunk accumulate, acc (f32) + incoming (wire dtype) -> f32, through
    TACC: the CUDA kernel on CUDA tensors, the plain version on CPU ones."""
    return tacc.dispatch("collective_reduce", acc, incoming)


# ---------------------------------------------------------------------------
# Emulated schedule: ppermute wire + kernel reduce (per-rank code).
# ---------------------------------------------------------------------------

@tacc.register("ring_reduce_scatter", "emulated")
def _rs_emulated(chunks, axis: str, direction: int, wire_dtype,
                 n_stripes: int = 1):
    """chunks (n, c, ...) -> this rank's reduced chunk (c, ...), f32.

    Each step's payload is split across NUM_BUFFERS streams; stream 1's hop
    is issued before stream 0's accumulate (eager PyTorch does not overlap
    them yet).  Each hop is split into ``n_stripes`` per-link hops.
    """
    n = chunks.shape[0]
    idx = mesh.axis_index(axis)
    perm = _ring_perm(n, direction)
    acc = list(chunks.float().unbind(0))
    c = chunks.shape[1]
    h = c // NUM_BUFFERS if c >= NUM_BUFFERS else 0
    for s in range(n - 1):
        send_idx = (idx - direction * (s + 1)) % n
        recv_idx = (idx - direction * (s + 2)) % n
        blk = acc[send_idx].to(wire_dtype)
        cur = acc[recv_idx]
        if h:
            r0 = _striped_hop(blk[:h], axis, perm, n_stripes)
            r1 = _striped_hop(blk[h:], axis, perm, n_stripes)
            new = torch.cat([_reduce(cur[:h], r0), _reduce(cur[h:], r1)], 0)
        else:
            new = _reduce(cur, _striped_hop(blk, axis, perm, n_stripes))
        acc[recv_idx] = new
    return acc[idx]


def _quant_hop(blk, axis: str, perm, n_stripes: int, codec: str):
    """One quantized wire hop: per-chunk absmax encode; the byte codes ride
    the striped per-link hops like an uncompressed payload, the f32 scale
    sidecar rides one ppermute."""
    codes, scales = quant.quantize(blk, codec=codec)
    return (_striped_hop(codes, axis, perm, n_stripes),
            mesh.ppermute(scales, axis, perm))


def _quant_rs_emulated(chunks, axis: str, direction: int, codec: str,
                       n_stripes: int = 1):
    """Quantized ring reduce-scatter: :func:`_rs_emulated`'s wave structure
    with each hop's payload quantized.  Every step re-quantizes the running
    partial it forwards (each of the NUM_BUFFERS streams on its own
    512-grid), and the receiver dequantize-accumulates into the f32
    accumulator, which never narrows."""
    n = chunks.shape[0]
    idx = mesh.axis_index(axis)
    perm = _ring_perm(n, direction)
    acc = list(chunks.float().unbind(0))
    c = chunks.shape[1]
    h = c // NUM_BUFFERS if c >= NUM_BUFFERS else 0
    for s in range(n - 1):
        send_idx = (idx - direction * (s + 1)) % n
        recv_idx = (idx - direction * (s + 2)) % n
        blk = acc[send_idx]
        cur = acc[recv_idx]
        if h:
            r0, rs0 = _quant_hop(blk[:h], axis, perm, n_stripes, codec)
            r1, rs1 = _quant_hop(blk[h:], axis, perm, n_stripes, codec)
            new = torch.cat([quant.dequantize_accumulate(cur[:h], r0, rs0, codec=codec),
                             quant.dequantize_accumulate(cur[h:], r1, rs1, codec=codec)], 0)
        else:
            rc, rs = _quant_hop(blk, axis, perm, n_stripes, codec)
            new = quant.dequantize_accumulate(cur, rc, rs, codec=codec)
        acc[recv_idx] = new
    return acc[idx]


def _quant_ag_emulated(x, axis: str, direction: int, codec: str, n_stripes: int = 1):
    """Quantized ring all-gather: the chunk is encoded once and its codes are
    forwarded verbatim, so every rank decodes the same grid value for every
    chunk, its own included.  (n, c, ...) f32 on the codec grid."""
    n = mesh.axis_size(axis)
    idx = mesh.axis_index(axis)
    perm = _ring_perm(n, direction)
    codes, scales = quant.quantize(x, codec=codec)
    out = [None] * n
    out[idx] = quant.dequantize(codes, scales, codec=codec)
    for s in range(n - 1):
        codes = _striped_hop(codes, axis, perm, n_stripes)
        scales = mesh.ppermute(scales, axis, perm)
        out[(idx - direction * (s + 1)) % n] = quant.dequantize(codes, scales, codec=codec)
    return torch.stack(out, 0)


@tacc.register("ring_all_gather", "emulated")
def _ag_emulated(x, axis: str, direction: int, n_stripes: int = 1):
    """x (c, ...) per-rank chunk -> (n, c, ...) rank-stacked."""
    n = mesh.axis_size(axis)
    idx = mesh.axis_index(axis)
    perm = _ring_perm(n, direction)
    out = [None] * n
    out[idx] = cur = x
    for s in range(n - 1):
        cur = _striped_hop(cur, axis, perm, n_stripes)
        out[(idx - direction * (s + 1)) % n] = cur
    return torch.stack(out, 0)


# ---------------------------------------------------------------------------
# Fused schedules over every rank of one launch.
# ``rings`` lists the rings of the launch, each as global ranks in ring
# order; every rank 0..R-1 is in exactly one ring, all rings equally long.
# ---------------------------------------------------------------------------

def _ring_tables(rings, direction: int, R: int):
    """(n, pos, dst, src): ring length, and per global rank its position,
    its downstream and its upstream neighbour."""
    n = len(rings[0])
    pos, dst, src = [None] * R, [None] * R, [None] * R
    for ring in rings:
        if len(ring) != n:
            raise ValueError(f"rings of unequal length: {rings}")
        for i, r in enumerate(ring):
            pos[r] = i
            dst[r] = ring[(i + direction) % n]
            src[r] = ring[(i - direction) % n]
    if None in pos:
        raise ValueError(f"rings {rings} do not cover ranks 0..{R - 1} once")
    return n, pos, dst, src


def _pieces(c: int, parts: int) -> list[tuple[int, int]]:
    """[lo, hi) of each of ``parts`` contiguous parts of [0, c)."""
    return [(c * p // parts, c * (p + 1) // parts) for p in range(parts)]


def _check_inputs(inputs):
    t0 = inputs[0]
    for t in inputs:
        if t.shape != t0.shape or t.dtype != t0.dtype or t.device != t0.device:
            raise ValueError("the ranks' inputs differ in shape, dtype or device: "
                             f"{[(tuple(t.shape), t.dtype, str(t.device)) for t in inputs]}")


class PullLedger:
    """The fused reduce-scatter's flags and credits as counters, for the
    plain version that steps its protocol on the host.

    ``write`` is a rank's store of one piece (stream, stripe) of its partial
    of a step, ``read`` the downstream rank's pull of it; ``give`` and
    ``take`` are the downstream's credit for a parity and the writer's wait
    for it.  A read of a piece that was not written, a write over a piece
    that was not read and a credit taken before it was given raise
    :class:`RingProtocolError`, and :meth:`close` raises if any counter is
    not back at zero."""

    def __init__(self):
        self.unread = collections.Counter()     # (rank, parity, stream, stripe)
        self.credit = collections.Counter()     # (rank, parity)

    def write(self, rank: int, step: int, piece):
        key = (rank, step % 2, *piece)
        if self.unread[key]:
            raise RingProtocolError(f"rank {rank} step {step}: partial {key} overwritten "
                                    "before it was read")
        self.unread[key] += 1

    def read(self, rank: int, step: int, piece):
        key = (rank, step % 2, *piece)
        if not self.unread[key]:
            raise RingProtocolError(f"partial {key} of step {step} read before it was written")
        self.unread[key] -= 1

    def give(self, rank: int, parity: int):
        self.credit[(rank, parity)] += 1

    def take(self, rank: int, step: int):
        key = (rank, step % 2)
        if self.credit[key] < 1:
            raise RingProtocolError(f"rank {rank} step {step}: no credit for parity {key[1]}")
        self.credit[key] -= 1

    def close(self):
        if any(self.unread.values()) or any(self.credit.values()):
            raise RingProtocolError("partials or credits left over at the end: "
                                    f"{+self.unread} {+self.credit}")


def reduce_scatter_fused_plain(inputs, rings, *, direction: int = 1,
                               wire_dtype=None, n_stripes: int = 1):
    """Plain version of the fused reduce-scatter: the kernel's pull protocol
    for every rank of a launch, stepped in order.

    inputs[r]: rank r's chunks (n, c) -> list of rank r's reduced chunk
    (c,), f32.  At step s each rank pulls its upstream's payload (the input
    chunk at s = 0, else the upstream's partial of step s - 1, kept per
    rank and parity), rounds it to the wire dtype and adds its own chunk in
    f32, piece by piece (NUM_BUFFERS streams x stripes); a :class:`PullLedger`
    checks every read, overwrite and credit, and must drain at the end.
    """
    _check_inputs(inputs)
    R = len(inputs)
    n, pos, _, src = _ring_tables(rings, direction, R)
    xs = [t.reshape(n, -1) for t in inputs]
    c = xs[0].shape[1]
    wire = wire_dtype or inputs[0].dtype
    S = _clamp_stripes(n_stripes, c)
    pieces = [((p // S, p % S), lo, hi)
              for p, (lo, hi) in enumerate(_pieces(c, NUM_BUFFERS * S))]
    ledger = PullLedger()
    partial = {}                        # (rank, parity) -> its (c,) f32 partial or output
    for s in range(n - 1):
        last = s == n - 2
        for r in range(R):
            up = src[r]
            recv = (pos[r] - direction * (s + 2)) % n
            if 2 <= s and not last:
                ledger.take(r, s)
            out = partial[(r, s % 2)] = torch.empty(c, dtype=torch.float32,
                                                    device=xs[r].device)
            for piece, lo, hi in pieces:
                if s == 0:
                    payload = xs[up][recv, lo:hi].float()
                else:
                    ledger.read(up, s - 1, piece)
                    payload = partial[(up, (s - 1) % 2)][lo:hi]
                out[lo:hi] = xs[r][recv, lo:hi].float() + payload.to(wire).float()
                if not last:
                    ledger.write(r, s, piece)
            if 1 <= s <= n - 4:
                ledger.give(up, (s - 1) % 2)
    ledger.close()
    return [partial[(r, (n - 2) % 2)] for r in range(R)]


def all_gather_fused_plain(inputs, rings, *, direction: int = 1, n_stripes: int = 1):
    """Plain version of the fused all-gather: inputs[r] (c,) -> list of
    (n, c) per rank, with the kernel's two slots per rank, stripes and
    credits as counters, stepped in order."""
    _check_inputs(inputs)
    R = len(inputs)
    n, pos, dst, src = _ring_tables(rings, direction, R)
    xs = [t.reshape(-1) for t in inputs]
    c = xs[0].shape[0]
    S = _clamp_stripes(n_stripes, c)
    pieces = _pieces(c, S)
    slot = {(r, 0): xs[r].clone() for r in range(R)}
    out = [torch.empty((n, c), dtype=xs[r].dtype, device=xs[r].device) for r in range(R)]
    for r in range(R):
        out[r][pos[r]] = xs[r]
    ready, credit = collections.Counter(), collections.Counter()
    for s in range(n - 1):
        par, nxt = s % 2, (s + 1) % 2
        for r in range(R):                                   # sends
            if s >= 1:
                if credit[(r, nxt)] < 1:
                    raise RingProtocolError(f"rank {r} step {s}: no credit for slot {nxt}")
                credit[(r, nxt)] -= 1
            buf = slot.setdefault((dst[r], nxt), torch.empty_like(xs[r]))
            for j, (lo, hi) in enumerate(pieces):
                key = (dst[r], nxt, j)
                if ready[key]:
                    raise RingProtocolError(f"rank {r} step {s}: slot {key} not drained")
                buf[lo:hi] = slot[(r, par)][lo:hi]
                ready[key] += 1
            if s < n - 2:
                credit[(src[r], par)] += 1
        for r in range(R):                                   # receives
            src_idx = (pos[r] - direction * (s + 1)) % n
            for j, (lo, hi) in enumerate(pieces):
                key = (r, nxt, j)
                if not ready[key]:
                    raise RingProtocolError(f"rank {r} step {s}: slot {key} empty")
                ready[key] -= 1
                out[r][src_idx, lo:hi] = slot[(r, nxt)][lo:hi]
    if any(ready.values()) or any(credit.values()):
        raise RingProtocolError("slots or credits left over at the end")
    return [o.reshape((n,) + tuple(inputs[r].shape)) for r, o in enumerate(out)]


def slot_pitch(c: int, esize: int) -> int:
    """Elements from one receive slot to the next for chunks of ``c``
    elements of ``esize`` bytes: c rounded up to a whole number of 16-byte
    vectors, so every slot starts 16-byte aligned whatever c is."""
    per = 16 // esize
    return -(-c // per) * per


def scratch_sizes(R: int, c: int, esize: int, reduce: bool) -> tuple[int, int]:
    """(f32 partial elements, slot bytes) a launch over R ranks needs: the
    reduce-scatter two f32 partials per rank at the f32 :func:`slot_pitch`
    and no slots, since it pulls; the all-gather two slots per rank at
    :func:`slot_pitch` in its ``esize``-byte words."""
    if reduce:
        return R * 2 * slot_pitch(c, 4), 0
    return 0, R * 2 * slot_pitch(c, esize) * esize


class _Scratch:
    """Flags and the error word of the launches over R ranks on one device,
    kept: flags carry a per-call tag, so they are zeroed once.  The partials
    and slots are sized by each launch (:meth:`buffers`) and go back to the
    caching allocator once it is queued, so that a step's other tensors can
    use them: the next allocation on the stream runs after the kernel."""

    def __init__(self, device, R: int, ctas: int):
        self.ctas = ctas
        n_flags = R * 2 * NUM_BUFFERS * MAX_STRIPES * ctas + R * 2 * ctas
        self.flags = torch.zeros(n_flags, dtype=torch.int64, device=device)
        self.err = torch.zeros(4, dtype=torch.int32, device=device)
        self.seq = 0

    def buffers(self, acc_elems: int, slot_bytes: int):
        """(f32 partials, slot bytes) for one launch; the call tag advances."""
        self.seq += 1
        dev = self.flags.device
        return (torch.empty(acc_elems, dtype=torch.float32, device=dev),
                torch.empty(slot_bytes, dtype=torch.uint8, device=dev))


_scratch: dict = {}
_lib = None
_lib_lock = threading.Lock()


def bind(lib: ctypes.CDLL):
    """Set the argument types of a loaded ``ring_dma`` library; returns it."""
    lib.ring_ctas.argtypes = [ctypes.c_int]
    lib.ring_ctas.restype = ctypes.c_int
    lib.ring_max_ranks.restype = ctypes.c_int
    lib.ring_launch.argtypes = (
        [ctypes.c_int] * 5 + [ctypes.c_longlong] * 2 + [ctypes.c_int] * 3
        + [ctypes.POINTER(ctypes.c_int)] * 3
        + [ctypes.POINTER(ctypes.c_ulonglong)] * 2
        + [ctypes.c_void_p] * 4 + [ctypes.c_ulonglong, ctypes.c_void_p])
    lib.ring_launch.restype = ctypes.c_int
    lib.ring_error_string.argtypes = [ctypes.c_int]
    lib.ring_error_string.restype = ctypes.c_char_p
    return lib


def _kernel():
    global _lib
    with _lib_lock:
        if _lib is None:
            _lib = bind(_build.load("ring_dma"))
        return _lib


_ERRORS = {1: "a data flag (a slot's or a partial's) never came", 2: "a credit never came"}


def _launch(kind, in_code, wire_code, esize, n, c, direction, S, pos, dst, src, ins, outs,
            check):
    """One launch over every rank of ``ins`` (``esize``: bytes of an f32
    partial, 4, or of an all-gather word); raises on a refused launch and,
    with ``check``, on a timed-out wait (it synchronises to read the error
    word; without it the word is left for :func:`check_errors`)."""
    lib = _kernel()
    R = len(ins)
    device = ins[0].device
    if R > lib.ring_max_ranks():
        raise ValueError(f"{R} ranks in one launch; the kernel takes {lib.ring_max_ranks()}")
    key = (str(device), R)
    sc = _scratch.get(key)
    if sc is None:
        ctas = lib.ring_ctas(R)
        if ctas < 1:
            raise RuntimeError(f"the ring kernel cannot keep {R} ranks resident at once")
        sc = _scratch[key] = _Scratch(device, R, ctas)
    acc, slots = sc.buffers(*scratch_sizes(R, c, esize, kind == 0))
    ints = ctypes.c_int * R
    ptrs = ctypes.c_ulonglong * R
    stream = torch.cuda.current_stream(device).cuda_stream
    err = lib.ring_launch(kind, in_code, wire_code, R, n, c, slot_pitch(c, esize),
                          direction, S, sc.ctas,
                          ints(*pos), ints(*dst), ints(*src),
                          ptrs(*(t.data_ptr() for t in ins)),
                          ptrs(*(t.data_ptr() for t in outs)),
                          slots.data_ptr(), acc.data_ptr(), sc.flags.data_ptr(),
                          sc.err.data_ptr(), sc.seq, stream)
    if err:
        raise RuntimeError(f"ring kernel launch failed: "
                           f"{lib.ring_error_string(err).decode()} (cuda error {err})")
    if check:
        _raise_if_failed(sc, f"fused ring {'reduce-scatter' if kind == 0 else 'all-gather'} "
                             f"(n={n}, c={c})")


def _raise_if_failed(sc: _Scratch, what: str):
    code, rank, step, cta = sc.err.tolist()
    if code:
        raise RingProtocolError(f"{what}: {_ERRORS.get(code, code)} at rank {rank}, "
                                f"step {step}, CTA {cta}")


def check_errors():
    """Raise if the latest launch on any scratch timed out (for callers that
    launched with ``check=False`` to time launches back to back)."""
    for sc in _scratch.values():
        _raise_if_failed(sc, "fused ring")


def reduce_scatter_fused(inputs, rings, *, direction: int = 1, wire_dtype=None,
                         n_stripes: int = 1, check: bool = True):
    """inputs[r]: rank r's chunks (n, c...) -> list of rank r's reduced chunk
    (c,) in f32, for every rank of ``rings`` in one launch.

    On CUDA tensors: the ``csrc/ring_dma.cu`` reduce-scatter or an error.
    On CPU tensors: :func:`reduce_scatter_fused_plain`.  Inputs other than
    f32 and bf16 go in as f32, as the reference's kernel takes them; the wire
    is f32 or bf16 (default: the inputs' dtype).
    """
    global rs_launches
    if inputs[0].device.type == "cpu":
        return reduce_scatter_fused_plain(inputs, rings, direction=direction,
                                          wire_dtype=wire_dtype, n_stripes=n_stripes)
    if inputs[0].device.type != "cuda":
        raise ValueError(f"no fused ring route for device {inputs[0].device}")
    _check_inputs(inputs)
    R = len(inputs)
    n, pos, dst, src = _ring_tables(rings, direction, R)
    wire = wire_dtype or inputs[0].dtype
    if wire not in _RS_CODE:
        raise ValueError(f"wire dtype {wire}: the fused ring takes float32 or bfloat16")
    xs = [t.reshape(n, -1) for t in inputs]
    if xs[0].dtype not in _RS_CODE:
        xs = [t.float() for t in xs]
    xs = [t.contiguous() for t in xs]
    c = xs[0].shape[1]
    outs = [torch.empty(c, dtype=torch.float32, device=t.device) for t in xs]
    if c == 0:
        return outs
    S = _clamp_stripes(n_stripes, c)
    _launch(0, _RS_CODE[xs[0].dtype], _RS_CODE[wire], 4, n, c, direction, S, pos,  # f32 partials
            dst, src, xs, outs, check)
    rs_launches += 1
    tacc.count_row_launch(f"ring_reduce_scatter/S{S}")
    return outs


def all_gather_fused(inputs, rings, *, direction: int = 1, n_stripes: int = 1,
                     check: bool = True):
    """inputs[r]: rank r's chunk (c...) -> list of (n, c...) per rank, rank
    order along the ring, for every rank of ``rings`` in one launch.

    On CUDA tensors: the ``csrc/ring_dma.cu`` all-gather or an error (it
    moves 4- or 2-byte words, so any dtype whose payload is a whole number
    of them).  On CPU tensors: :func:`all_gather_fused_plain`.  ``check``
    as in :func:`reduce_scatter_fused`.
    """
    global ag_launches
    if inputs[0].device.type == "cpu":
        return all_gather_fused_plain(inputs, rings, direction=direction,
                                      n_stripes=n_stripes)
    if inputs[0].device.type != "cuda":
        raise ValueError(f"no fused ring route for device {inputs[0].device}")
    _check_inputs(inputs)
    R = len(inputs)
    n, pos, dst, src = _ring_tables(rings, direction, R)
    shape, dtype = tuple(inputs[0].shape), inputs[0].dtype
    nbytes = inputs[0].numel() * inputs[0].element_size()
    word = torch.int32 if nbytes % 4 == 0 else torch.int16
    if nbytes % 2:
        raise ValueError(f"{nbytes} bytes per rank: the fused all-gather moves 2-byte words")
    xs = [t.contiguous().reshape(-1).view(torch.uint8).view(word) for t in inputs]
    c = xs[0].numel()
    outs = [torch.empty((n, c), dtype=word, device=t.device) for t in xs]
    if c:
        S = _clamp_stripes(n_stripes, c)
        esize = 4 if word == torch.int32 else 2
        _launch(1, esize, 0, esize, n, c, direction, S, pos, dst, src, xs, outs, check)
        ag_launches += 1
        tacc.count_row_launch(f"ring_all_gather/S{S}")
    return [o.view(torch.uint8).view(dtype).reshape((n,) + shape) for o in outs]


# ---------------------------------------------------------------------------
# Per-rank fused entries: the ranks of a ThreadMesh meet, one launch for all.
# ---------------------------------------------------------------------------

def _mesh_rings(m, axis: str) -> list[list[int]]:
    """The rings of ``axis`` in a mesh: one per coordinate off the axis."""
    return [list(g) for g in sorted({tuple(m.group(r, axis)) for r in range(m.size)})]


def _thread_mesh():
    m, r = mesh.current()
    if not isinstance(m, mesh.ThreadMesh):
        raise NotImplementedError(
            "the fused ring kernels run over the ranks of one ThreadMesh; across "
            "processes or cards they need peer memory (ROADMAP A3, fused rings "
            "across processes)")
    return m, r


@tacc.register("ring_reduce_scatter", "fused", default=True)
def _rs_fused(chunks, axis: str, direction: int, wire_dtype, n_stripes: int = 1):
    """chunks (n, c, ...) -> this rank's reduced chunk (c, ...), f32."""
    m, r = _thread_mesh()
    launch = functools.partial(reduce_scatter_fused, rings=_mesh_rings(m, axis),
                               direction=direction, wire_dtype=wire_dtype,
                               n_stripes=n_stripes)
    return m.rendezvous(r, chunks, launch).reshape(chunks.shape[1:])


@tacc.register("ring_all_gather", "fused", default=True)
def _ag_fused(x, axis: str, direction: int, n_stripes: int = 1):
    """x (c, ...) -> (n, c, ...) rank-stacked."""
    m, r = _thread_mesh()
    launch = functools.partial(all_gather_fused, rings=_mesh_rings(m, axis),
                               direction=direction, n_stripes=n_stripes)
    return m.rendezvous(r, x, launch)


def _schedule(op: str) -> str:
    """"fused" where every rank of the ring is a ThreadMesh rank on a CUDA
    device (unless the op's TACC default is pinned to "emulated"), else
    "emulated" (DistMesh, CPU)."""
    m, _ = mesh.current()
    if isinstance(m, mesh.ThreadMesh) and m.device.type == "cuda":
        return tacc.get_default(op)
    return "emulated"


# ---------------------------------------------------------------------------
# Public ring primitives (the backend="pallas" cross-island stage).
# Signatures match core.collectives' xla rings; the keyword-only knobs
# (direction, wire_dtype, n_stripes) default to the xla rings' behaviour.
# ---------------------------------------------------------------------------

@tacc.stage("reduce-scatter")
def ring_reduce_scatter(x, axis: str, *, direction: int = 1, wire_dtype=None,
                        n_stripes: int = 1, wire_quant: str | None = None):
    """x (n*c, ...) tiled on dim 0 -> this rank's reduced chunk (c, ...).

    The accumulator is f32 whatever x.dtype is (the collective_reduce
    contract); ``wire_dtype`` narrows only the bytes on the wire.  The result
    is cast back to x.dtype.  ``wire_quant`` replaces the dtype cast with the
    per-chunk codec (the quantized emulated schedule on every device).
    """
    n = mesh.axis_size(axis)
    if n == 1:
        return x
    chunks = chunked(x, n)
    if wire_quant is not None:
        return _quant_rs_emulated(chunks, axis, direction, wire_quant,
                                  n_stripes).to(x.dtype)
    wire = wire_dtype if wire_dtype is not None else x.dtype
    op = "ring_reduce_scatter"
    out = tacc.dispatch(op, chunks, axis, direction, wire, n_stripes,
                        variant=_schedule(op))
    return out.to(x.dtype)


@tacc.stage("reduce-scatter")
def ring_reduce_scatter_bidir(x, axis: str, *, wire_dtype=None, n_stripes: int = 1,
                              wire_quant: str | None = None):
    """The payload's halves travel in opposite directions (one ring call per
    direction)."""
    n = mesh.axis_size(axis)
    if n == 1:
        return x
    chunks = chunked(x, n)
    c = chunks.shape[1]
    if c < 2:
        return ring_reduce_scatter(x, axis, wire_dtype=wire_dtype,
                                   n_stripes=n_stripes, wire_quant=wire_quant)
    h = c // 2
    rest = tuple(x.shape[1:])
    fwd = chunks[:, :h].reshape((n * h,) + rest)
    bwd = chunks[:, h:].reshape((n * (c - h),) + rest)
    return torch.cat([
        ring_reduce_scatter(fwd, axis, direction=1, wire_dtype=wire_dtype,
                            n_stripes=n_stripes, wire_quant=wire_quant),
        ring_reduce_scatter(bwd, axis, direction=-1, wire_dtype=wire_dtype,
                            n_stripes=n_stripes, wire_quant=wire_quant)], 0)


def _ag(x, axis, direction, n_stripes, wire_quant=None):
    if wire_quant is not None:
        return _quant_ag_emulated(x, axis, direction, wire_quant, n_stripes).to(x.dtype)
    op = "ring_all_gather"
    return tacc.dispatch(op, x, axis, direction, n_stripes, variant=_schedule(op))


@tacc.stage("all-gather")
def ring_all_gather(x, axis: str, *, direction: int = 1, n_stripes: int = 1,
                    wire_quant: str | None = None):
    """x (c, ...) per-rank chunk -> (n*c, ...) rank-major, exactly (no
    reduction, no dtype change); with ``wire_quant`` every chunk is encoded
    once and decoded on every rank alike."""
    n = mesh.axis_size(axis)
    if n == 1:
        return x
    out = _ag(x, axis, direction, n_stripes, wire_quant)
    return out.reshape((n * x.shape[0],) + tuple(x.shape[1:]))


@tacc.stage("all-gather")
def ring_all_gather_bidir(x, axis: str, *, n_stripes: int = 1,
                          wire_quant: str | None = None):
    """Bidirectional ring all-gather (each half in its own direction)."""
    n = mesh.axis_size(axis)
    if n == 1:
        return x
    c = x.shape[0]
    if c < 2:
        return ring_all_gather(x, axis, n_stripes=n_stripes, wire_quant=wire_quant)
    h = c // 2
    out = torch.cat([_ag(x[:h], axis, 1, n_stripes, wire_quant),
                     _ag(x[h:], axis, -1, n_stripes, wire_quant)], 1)
    return out.reshape((n * c,) + tuple(x.shape[1:]))


@tacc.stage("all-reduce")
def ring_all_reduce(x, axis: str, *, wire_dtype=None, n_stripes: int = 1,
                    wire_quant: str | None = None):
    """Ring all-reduce (reduce-scatter + all-gather), f32 accumulation,
    result in x.dtype."""
    n = mesh.axis_size(axis)
    if n == 1:
        return x
    shape, dtype = x.shape, x.dtype
    flat = x.reshape(-1)
    pad = (-flat.shape[0]) % n
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))
    red = ring_all_gather(
        ring_reduce_scatter(flat, axis, wire_dtype=wire_dtype, n_stripes=n_stripes,
                            wire_quant=wire_quant),
        axis, n_stripes=n_stripes, wire_quant=wire_quant)
    if pad:
        red = red[: flat.shape[0] - pad]
    return red.reshape(shape).to(dtype)
