"""The per-process arena of the per-rank fused rings (ROADMAP A3;
DESIGN_TORCH.md §28).

On a :class:`~repro_torch.core.mesh.DistMesh` (one process per rank) each
rank of a ring launches its own part of ``csrc/ring_dma.cu``'s per-rank
kernels, as the reference runs one kernel instance per device.  What the
ranks of one launch shared in the one-launch route lives here, one arena
per process and ring group:

    data flags  [2 parity][NUM_BUFFERS][MAX_STRIPES][ctas] u64, set by the upstream
    credits     [2 parity][ctas] u64, set by the downstream
    ready tags  [2 seq parity][2: from the upstream, from the downstream][ctas] u64
    error word  code, rank, step, cta (int32)
    partials    [2][pitch] f32 (the reduce-scatter's; parity 1 also holds
                the chunk staged at "step -1")
    slots       [2][pitch] words (the all-gather's)

Each flag lives in the arena of the rank that waits on it, so a rank spins
on its own memory and its neighbours write into it.  On the card the arena
is device memory of its own (``peer_alloc``: cudaMalloc, never the caching
allocator, whose blocks an IPC handle cannot name and whose expandable
segments cannot be exported), exported with ``cudaIpcGetMemHandle``; the
neighbours' arenas are opened with ``cudaIpcOpenMemHandle`` and closed at
:meth:`Arena.close`.  Its plain version is the same layout in a file
mapped shared (``torch.from_file(..., shared=True)``) under a directory that
every rank of the group reads, so the protocol runs across real processes
on the CPU (``ring_dma``'s per-rank plain version).

:func:`arena_for` keeps one arena per (process group, ring group) of a
mesh, made on the group's first ring call; :func:`close_arenas` frees them
all.  An arena is made collectively by the ranks of its group and grows
collectively: every rank of a ring makes the same calls with the same
shapes, so every rank asks for the same sizes at the same call.  The ranks
meet for that on the host through the process group's store (handles, or
file names on the CPU, go the same way), and every meeting waits at most
:data:`MEET_TIMEOUT_S`: a rank that withholds a call that grows the arena,
or asks for other sizes, makes the others raise :class:`RingProtocolError`
and marks the arena broken for every rank of the group.  Nothing falls
back: an arena that cannot be made or opened raises.
"""
from __future__ import annotations

import ctypes
import datetime
import os
import pickle
import shutil
import tempfile
import threading
import zlib

import torch

from repro_torch.kernels import _build
from repro_torch.transport.stripe import MAX_STRIPES

NUM_BUFFERS = 2             # the kernel's kNumBuffers (ring_dma.NUM_BUFFERS)
_ALIGN = 256
_GRAIN = 1 << 20            # partials and slots grow in whole MiB
PLAIN_CTAS = 2              # column slices of the plain version: two, to step the per-CTA tables
# The longest a rank waits on the host for the other ranks of its group to
# reach the same point of an arena's making, growth or close: five times
# the kernel's bound on a wait (kSpinTimeoutNs, 2 s), as the ranks of a
# ring reach each call within that bound anyway.
MEET_TIMEOUT_S = 10.0


class RingProtocolError(RuntimeError):
    """The ring protocol failed: a wait of the fused kernel timed out on the
    card, its plain version found a slot, partial or credit out of order,
    or the ranks of a per-rank ring did not meet to make or grow its arena."""


def _up(n: int, m: int) -> int:
    return -(-n // m) * m


def layout(ctas: int, acc_bytes: int, slot_bytes: int) -> dict[str, int]:
    """Byte offsets of an arena's regions and its total size ("bytes")."""
    sizes = (("data", 2 * NUM_BUFFERS * MAX_STRIPES * ctas * 8), ("cap", 2 * ctas * 8),
             ("ready", 4 * ctas * 8), ("err", 16), ("acc", acc_bytes), ("slots", slot_bytes))
    out, off = {}, 0
    for name, n in sizes:
        out[name] = off
        off += _up(n, _ALIGN)
    out["bytes"] = off
    return out


OFFSET_KEYS = ("data", "cap", "ready", "err", "acc", "slots")


class _CudaArray:
    """``__cuda_array_interface__`` over raw device memory, so that torch can
    view an arena (``torch.as_tensor``) without owning it."""

    def __init__(self, ptr: int, nbytes: int):
        self.__cuda_array_interface__ = {"shape": (nbytes,), "typestr": "|u1",
                                         "data": (ptr, False), "version": 3}


_lib = None
_lib_lock = threading.Lock()


def _kernel_lib():
    """``csrc/ring_dma.cu``'s library with its arena entries bound."""
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = _build.load("ring_dma")
            lib.ring_error_string.argtypes = [ctypes.c_int]
            lib.ring_error_string.restype = ctypes.c_char_p
            lib.ring_peer_ctas.argtypes = [ctypes.c_int]
            lib.ring_peer_ctas.restype = ctypes.c_int
            lib.peer_alloc.argtypes = [ctypes.c_longlong, ctypes.POINTER(ctypes.c_ulonglong)]
            lib.peer_free.argtypes = [ctypes.c_ulonglong]
            lib.peer_handle_bytes.restype = ctypes.c_int
            lib.peer_export.argtypes = [ctypes.c_ulonglong, ctypes.c_char_p]
            lib.peer_open.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_ulonglong)]
            lib.peer_close.argtypes = [ctypes.c_ulonglong]
            for fn in (lib.peer_alloc, lib.peer_free, lib.peer_export, lib.peer_open,
                       lib.peer_close):
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib


def _check(err: int, what: str):
    if err:
        raise RuntimeError(f"peer arena: {what} failed: "
                           f"{_kernel_lib().ring_error_string(err).decode()} (cuda error {err})")


def export_handle(ptr: int) -> bytes:
    """The IPC handle of the device allocation at ``ptr``; raises where CUDA
    refuses one (memory of the caching allocator's expandable segments, for
    one)."""
    lib = _kernel_lib()
    buf = ctypes.create_string_buffer(lib.peer_handle_bytes())
    _check(lib.peer_export(ctypes.c_ulonglong(ptr), buf), f"export of 0x{ptr:x}")
    return buf.raw


def call_signature(*fields) -> int:
    """24 bits naming a call's kind and shape, for the start handshake."""
    return zlib.crc32(repr(fields).encode()) & 0xFFFFFF


def local_ranks(device: torch.device) -> int:
    """How many ranks of the process group share ``device``, as a DistMesh
    places them (rank r on card ``r % device_count``), counting every rank
    as one of this host's: the per-rank kernels size their grids so that
    all of them are resident at once.  On several hosts this overcounts,
    which only shrinks the grid."""
    import torch.distributed as dist
    if device.type != "cuda":
        return 1
    return len(range(device.index or 0, dist.get_world_size(), torch.cuda.device_count()))


def _store():
    """The store of the default process group's rendezvous (private in
    torch.distributed, stable since its first releases)."""
    import torch.distributed as dist
    return dist.distributed_c10d._get_default_store()


class Arena:
    """One process's arena for its ring group ``group`` (global ranks in ring
    order, this process's rank among them), on ``device``.

    ``uid`` names the arena alike on every rank of the group (the group and
    how many arenas this process made for it before).  Collective: every
    rank of the group builds it, at the same point of its calls."""

    def __init__(self, group, rank: int, device: torch.device, uid: str):
        self.group = tuple(int(g) for g in group)
        self.rank = int(rank)
        self.pos = self.group.index(self.rank)
        self.n = len(self.group)
        self.device = device
        self.cuda = device.type == "cuda"
        self.store = _store()
        self.prefix = f"repro-peer/{uid}"
        self.meets = 0
        self.broken = False
        self.seq = 0
        self.acc_bytes = self.slot_bytes = 0
        self.base = 0                    # this rank's arena (device address; 0 on the CPU)
        self.mem = None                  # a uint8 view of it
        self.peers: dict[int, int] = {}  # neighbour rank -> mapped device address
        self.peer_mem: dict[int, torch.Tensor] = {}
        self.offs: dict[int, int] = {}
        if self.cuda:
            local = local_ranks(device)
            ctas = _kernel_lib().ring_peer_ctas(local)
            if ctas < 1:
                raise RuntimeError(f"the per-rank ring kernel cannot keep {local} ranks of "
                                   "one device resident at once")
        else:
            ctas = PLAIN_CTAS
        made = tempfile.mkdtemp(prefix="repro-peer-") if not self.cuda and self.pos == 0 \
            else None
        got = self._meet((ctas, made))
        self.ctas = min(c for c, _ in got)   # one layout for the whole group
        self._dir = got[0][1]
        self._map(0, 0)

    # -- neighbours --------------------------------------------------------

    def neighbour(self, direction: int) -> tuple[int, int]:
        """(upstream, downstream) global ranks for a ring direction."""
        return (self.group[(self.pos - direction) % self.n],
                self.group[(self.pos + direction) % self.n])

    def _neighbours(self) -> set[int]:
        return {self.group[(self.pos + d) % self.n] for d in (-1, 1)} - {self.rank}

    # -- meetings of the group's ranks on the host ---------------------------

    def _meet(self, value) -> list:
        """Every rank of the group posts ``value``; the values in ring
        order.  Waits at most MEET_TIMEOUT_S for the others, then marks the
        arena broken for the whole group and raises."""
        broken = f"{self.prefix}/broken"
        if self.broken or self.store.check([broken]):
            self.broken = True
            raise RingProtocolError(f"peer arena of ranks {self.group}: broken by an earlier "
                                    "fault of the group")
        k = self.meets
        self.meets += 1
        keys = [f"{self.prefix}/{k}/{p}" for p in range(self.n)]
        self.store.set(keys[self.pos], pickle.dumps(value))
        try:
            self.store.wait(keys, datetime.timedelta(seconds=MEET_TIMEOUT_S))
        except RuntimeError:
            missing = [self.group[p] for p, key in enumerate(keys)
                       if not self.store.check([key])]
            self.store.set(broken, str(self.rank))
            self.broken = True
            raise RingProtocolError(
                f"peer arena of ranks {self.group}: rank(s) {missing} did not come to make, "
                f"grow or close it within {MEET_TIMEOUT_S} s (a call withheld, or made in "
                "another order)") from None
        vals = [pickle.loads(self.store.get(key)) for key in keys]
        if k:                            # every rank read meeting k-1 before it posted k
            self.store.delete_key(f"{self.prefix}/{k - 1}/{self.pos}")
        return vals

    # -- collective (re)mapping ---------------------------------------------

    def ensure(self, acc_bytes: int, slot_bytes: int) -> None:
        """Make room for a call's partials and slots; collective when it grows
        (every rank of the group asks alike, at the same call).  Raises on
        an arena that this rank found broken."""
        if self.broken:
            raise RingProtocolError(f"peer arena of ranks {self.group}: broken by an earlier "
                                    "fault of the group")
        if acc_bytes <= self.acc_bytes and slot_bytes <= self.slot_bytes:
            return
        self._map(max(_up(acc_bytes, _GRAIN), self.acc_bytes),
                  max(_up(slot_bytes, _GRAIN), self.slot_bytes))

    def _unmap_peers(self):
        lib = _kernel_lib() if self.cuda else None
        for ptr in self.peers.values():
            _check(lib.peer_close(ctypes.c_ulonglong(ptr)), "close of a peer arena")
        self.peers, self.peer_mem = {}, {}

    def _map(self, acc_bytes: int, slot_bytes: int):
        if self.cuda:
            torch.cuda.synchronize(self.device)      # this rank's kernels read no arena now
        want = self._meet((acc_bytes, slot_bytes))
        if len(set(want)) != 1:
            self.store.set(f"{self.prefix}/broken", str(self.rank))
            self.broken = True
            raise RingProtocolError(f"peer arena of ranks {self.group}: the ranks' calls ask "
                                    f"for different sizes {want}: their calls differ")
        if self.mem is not None:
            self._unmap_peers()
            self._meet("unmapped")                   # nobody maps this rank's arena any more
            if self.cuda:
                _check(_kernel_lib().peer_free(ctypes.c_ulonglong(self.base)), "free")
            self.base, self.mem = 0, None
        lay = layout(self.ctas, acc_bytes, slot_bytes)
        if self.cuda:
            lib = _kernel_lib()
            ptr = ctypes.c_ulonglong()
            _check(lib.peer_alloc(lay["bytes"], ctypes.byref(ptr)), f"{lay['bytes']} B alloc")
            self.base = ptr.value
            self.mem = torch.as_tensor(_CudaArray(self.base, lay["bytes"]), device=self.device)
            mine = export_handle(self.base)
        else:
            mine = os.path.join(self._dir, f"arena-{self.rank}-{self.meets}-{lay['bytes']}")
            self.mem = torch.from_file(mine, shared=True, size=lay["bytes"], dtype=torch.uint8)
        handles = self._meet(mine)
        for r in self._neighbours():
            h = handles[self.group.index(r)]
            if self.cuda:
                ptr = ctypes.c_ulonglong()
                _check(_kernel_lib().peer_open(h, ctypes.byref(ptr)),
                       f"open of rank {r}'s arena")
                self.peers[r] = ptr.value
            else:
                self.peer_mem[r] = torch.from_file(h, shared=True, size=lay["bytes"],
                                                   dtype=torch.uint8)
        if not self.cuda:
            self._meet("opened")                     # every mapping made: the names can go
            os.unlink(mine)
        self.acc_bytes, self.slot_bytes = acc_bytes, slot_bytes
        self.offs = lay

    def close(self) -> None:
        """Unmap and free (collective); the arena is unusable afterwards.
        A broken arena is only unmapped, with no meeting: on the card its
        own block stays allocated (a neighbour may still map it) until the
        process ends."""
        if self.mem is None:
            return
        if not self.broken and not self.store.check([f"{self.prefix}/broken"]):
            if self.cuda:
                torch.cuda.synchronize(self.device)
            self._meet("close")                      # nobody's kernel reads an arena any more
            self._unmap_peers()
            self._meet("unmapped")                   # nobody maps this rank's arena any more
            if self.cuda:
                _check(_kernel_lib().peer_free(ctypes.c_ulonglong(self.base)), "free")
        else:
            self.broken = True
            self._unmap_peers()
        self.base, self.mem = 0, None
        if self._dir is not None and self.pos == 0:
            shutil.rmtree(self._dir, ignore_errors=True)
        self._dir = None

    # -- views (both devices) ---------------------------------------------

    def view(self, rank: int, region: str, dtype, count: int | None = None) -> torch.Tensor:
        """A region of this rank's arena, or of a neighbour's on the CPU, as
        ``dtype`` (the whole region, or its first ``count`` elements)."""
        mem = self.mem if rank == self.rank else self.peer_mem[rank]
        keys = OFFSET_KEYS + ("bytes",)
        lo = self.offs[region]
        hi = self.offs[keys[keys.index(region) + 1]]
        esize = torch.empty((), dtype=dtype).element_size()
        if count is not None:
            hi = lo + count * esize
        return mem[lo:hi].view(dtype)

    def error_word(self) -> list[int]:
        """code, rank, step, cta of this rank's last failed call (0s if none);
        on the card it synchronises."""
        return self.view(self.rank, "err", torch.int32, 4).tolist()


# ---------------------------------------------------------------------------
# The arenas of this process, one per (process group, ring group)
# ---------------------------------------------------------------------------

_ARENAS: dict = {}                 # (process group, ring group) -> Arena
_MADE: dict = {}                   # ring group -> arenas made for it by this process


def arena_for(m, axes) -> Arena:
    """This rank's arena for its ring group over ``axes`` of the DistMesh
    ``m`` (made on the group's first call, collectively)."""
    pg, grp = m._ordered(axes)
    key = (pg, tuple(grp))
    arena = _ARENAS.get(key)
    if arena is None:
        made = _MADE.get(key[1], 0)
        _MADE[key[1]] = made + 1
        arena = _ARENAS[key] = Arena(grp, m.rank, m.device,
                                     f"{'-'.join(map(str, grp))}/{made}")
    return arena


def close_arenas() -> None:
    """Free every arena of this process, in ring-group order (collective
    over each arena's group: every rank of the mesh calls it)."""
    for key in sorted(_ARENAS, key=lambda k: k[1]):
        _ARENAS.pop(key).close()
