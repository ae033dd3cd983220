"""Checkpoints: atomic, verified, resharding-capable, async.

Counterpart of ``repro/train/checkpoint.py``, in its format:

    step_00000123/
      manifest.json        {step, leaves: [{path, file, shape, dtype, crc}], time}
      arr_00000.npy ...    one file per leaf, a full logical array

* atomic publish: written to ``step_X.tmp`` and renamed; stale ``.tmp``
  dirs left by a crash mid-save are swept by the next save;
* verified restore: each leaf's ``crc`` (md5 of its first MiB) is checked on
  load; a bad leaf raises :class:`CorruptCheckpointError`, and
  :func:`restore_latest` falls back to the previous retained step;
* resharding restore: leaves are full logical arrays, and :func:`place_tree`
  puts them on a target program's mesh of ranks, of any size;
* async: :func:`save_async` copies the state to host memory before it hands
  the write to a background thread (the optimizer writes its state in place,
  so the live tensors would be overwritten under the writer); a failed
  background save raises at the next save;
* retention: keep-last-k.

A train program's state is a list of per-rank states (``ThreadMesh``);
passing the program as ``layout`` makes :func:`save` write its full logical
arrays and :func:`restore` place them back (DESIGN_TORCH.md §24):

* params: the full leaves (ZeRO-3 shards concatenated on their
  ``fsdp_dim`` over "data");
* ZeRO-1 master and moments: the flat f32 leaf *without* the pad that
  ``optim._pad_len`` adds for W ranks (each rank's shard is re-cut, and
  re-padded, for the target's W); ZeRO-3's: like the params, in f32;
* EF residuals (``opt["ef"]``): each rank's own, concatenated in DP order,
  ``(W * n_local,)``, as the reference's state holds them (sharded over every
  DP axis).  A restore onto another world size fails on their shape, as the
  reference's does: a residual belongs to the rank that made it;
* bf16 leaves (numpy has no bf16 here): their 2-byte words as a ``uint16``
  ``.npy`` with ``"dtype": "bfloat16"`` in the manifest, the same bytes and
  ``crc`` as the reference's bf16 leaf.  The port reads both packages'
  bf16 leaves; the reference does not read the port's as bf16.
"""
from __future__ import annotations

import concurrent.futures as cf
import hashlib
import json
import os
import shutil
import time

import numpy as np
import torch

from repro_torch.core.tree import flatten

_CPU = torch.device("cpu")


class CorruptCheckpointError(RuntimeError):
    """A checkpoint leaf failed its manifest checksum (or is unreadable)."""


# ---------------------------------------------------------------------------
# leaves: paths as jax.tree_util.keystr writes them, host arrays
# ---------------------------------------------------------------------------

def leaf_paths(tree, prefix: str = "") -> list[tuple[str, object]]:
    """``(path, leaf)`` in flatten order (dict keys sorted), the paths as the
    reference's ``jax.tree_util.keystr`` spells them (``['params']['w'][0]``)."""
    if isinstance(tree, dict):
        return [pl for k in sorted(tree) for pl in leaf_paths(tree[k], f"{prefix}[{k!r}]")]
    if isinstance(tree, (list, tuple)):
        return [pl for i, v in enumerate(tree) for pl in leaf_paths(v, f"{prefix}[{i}]")]
    return [(prefix, tree)]


def _host(leaf) -> tuple[np.ndarray, str]:
    """(host array, logical dtype name) of one leaf; a bf16 tensor's array
    holds its 2-byte words as uint16.  Always a copy."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to(_CPU, copy=True).contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        arr = t.numpy()
        return arr, str(arr.dtype)
    arr = np.array(leaf, copy=True)
    return arr, str(arr.dtype)


def _crc(arr: np.ndarray) -> str:
    """Leaf checksum: md5 over the first MiB (cheap, catches torn writes)."""
    return hashlib.md5(arr.tobytes()[:1 << 20]).hexdigest()


def _tensor(arr: np.ndarray, dtype: str) -> torch.Tensor:
    """A host array of the manifest's ``dtype`` as a CPU tensor."""
    if not arr.flags.c_contiguous:
        arr = arr.copy(order="C")
    if dtype == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def host_leaves(state, layout=None) -> list[tuple[str, np.ndarray, str]]:
    """``(path, host array, dtype name)`` of every leaf of ``state``'s full
    logical tree (``layout.logical_state(state)`` when a layout is given)."""
    if layout is not None:
        state = StateLayout.of(layout).logical_state(state)
    return [(path, *_host(leaf)) for path, leaf in leaf_paths(state)]


# ---------------------------------------------------------------------------
# save / retention
# ---------------------------------------------------------------------------

def sweep_stale(ckpt_dir: str) -> list[str]:
    """Remove ``step_*.tmp`` dirs left by a crash mid-save; returns them.
    Safe against the async writer: one save is in flight at most, and
    :func:`save` sweeps before it creates its own tmp dir."""
    removed = []
    if not os.path.isdir(ckpt_dir):
        return removed
    for d in os.listdir(ckpt_dir):
        if d.startswith("step_") and d.endswith(".tmp"):
            path = os.path.join(ckpt_dir, d)
            shutil.rmtree(path, ignore_errors=True)
            removed.append(path)
    return removed


def _write(ckpt_dir: str, step: int, leaves, keep: int) -> str:
    os.makedirs(ckpt_dir, exist_ok=True)
    sweep_stale(ckpt_dir)
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp"
    os.makedirs(tmp)
    manifest = {"step": int(step), "leaves": [], "time": time.time()}
    for i, (path, arr, dtype) in enumerate(leaves):
        fname = f"arr_{i:05d}.npy"
        np.save(os.path.join(tmp, fname), arr)
        manifest["leaves"].append({"path": path, "file": fname, "shape": list(arr.shape),
                                   "dtype": dtype, "crc": _crc(arr)})
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)                       # atomic publish
    _retain(ckpt_dir, keep)
    return final


def save(ckpt_dir: str, step: int, state, layout=None, *, keep: int = 3,
         blocking: bool = True):
    """Write one checkpoint of ``state`` (a tree of tensors, arrays and
    ints; a train program's per-rank states with ``layout=`` the program).
    ``blocking=False`` delegates to :func:`save_async` and returns its
    future; a blocking save returns the published directory."""
    if not blocking:
        return save_async(ckpt_dir, step, state, layout, keep=keep)
    return _write(ckpt_dir, step, host_leaves(state, layout), keep)


_EXECUTOR = cf.ThreadPoolExecutor(max_workers=1)
_PENDING: list[cf.Future] = []


def _prune_pending():
    """Drop completed futures; re-raise the first background failure, so a
    failed save surfaces at the next save."""
    first_exc = None
    for f in [f for f in _PENDING if f.done()]:
        _PENDING.remove(f)
        exc = f.exception()
        if exc is not None and first_exc is None:
            first_exc = exc
    if first_exc is not None:
        raise first_exc


def save_async(ckpt_dir: str, step: int, state, layout=None, *, keep: int = 3) -> cf.Future:
    """Copy to host memory now, write to disk on the background thread."""
    _prune_pending()
    leaves = host_leaves(state, layout)
    fut = _EXECUTOR.submit(_write, ckpt_dir, step, leaves, keep)
    _PENDING.append(fut)
    return fut


def wait_pending():
    pending, _PENDING[:] = _PENDING[:], []
    for f in pending:
        f.result()


def _retain(ckpt_dir: str, keep: int):
    steps = sorted(d for d in os.listdir(ckpt_dir)
                   if d.startswith("step_") and not d.endswith(".tmp"))
    for d in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, d), ignore_errors=True)


def retained_steps(ckpt_dir: str) -> list[int]:
    """Published steps with a parseable manifest, ascending."""
    steps = []
    if not os.path.isdir(ckpt_dir):
        return steps
    for d in os.listdir(ckpt_dir):
        if d.startswith("step_") and not d.endswith(".tmp"):
            try:
                with open(os.path.join(ckpt_dir, d, "manifest.json")) as f:
                    json.load(f)
                steps.append(int(d.split("_")[1]))
            except (OSError, ValueError):
                continue
    return sorted(steps)


def latest_step(ckpt_dir: str) -> int | None:
    steps = retained_steps(ckpt_dir)
    return steps[-1] if steps else None


# ---------------------------------------------------------------------------
# restore / place
# ---------------------------------------------------------------------------

def place_tree(host_flat: list, state_like, layout=None):
    """Put full logical host tensors back: the resharding half of
    :func:`restore`.

    Args:
        host_flat: full logical CPU tensors, in ``state_like``'s flatten
            order.
        state_like: a tree (tensors, meta tensors or ints) giving the
            structure and the expected shapes.
        layout: a train program (or its :class:`StateLayout`): returns its
            per-rank states on its mesh; None returns the tree of CPU
            tensors (0-dim int leaves of an int ``state_like`` leaf as ints).
    """
    like_leaves, rebuild = flatten(state_like)
    paths = [p for p, _ in leaf_paths(state_like)]
    out = []
    for path, like, t in zip(paths, like_leaves, host_flat):
        expect = tuple(like.shape) if hasattr(like, "shape") else ()
        if tuple(t.shape) != expect:
            raise ValueError(f"shape mismatch {path}: {tuple(t.shape)} vs {expect}")
        out.append(int(t) if isinstance(like, int) else t)
    tree = rebuild(out)
    if layout is None:
        return tree
    return StateLayout.of(layout).place(tree)


def restore(ckpt_dir: str, step: int, state_like=None, layout=None, *,
            verify: bool = True):
    """Load step ``step`` into the structure of ``state_like`` (default: the
    layout's logical skeleton) and place it with ``layout`` (a train program:
    its per-rank states, on a mesh of any size).  ``verify`` checks every
    leaf's ``crc``; a mismatch raises :class:`CorruptCheckpointError`."""
    if state_like is None:
        state_like = StateLayout.of(layout).logical_like()
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    try:
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
    except (OSError, ValueError) as e:
        raise CorruptCheckpointError(f"unreadable manifest in {d}: {e}") from e
    by_path = {e["path"]: e for e in manifest["leaves"]}
    for path, like in leaf_paths(state_like):     # before reading any leaf
        expect = list(like.shape) if hasattr(like, "shape") else []
        if by_path[path]["shape"] != expect:
            raise ValueError(f"shape mismatch {path}: {tuple(by_path[path]['shape'])} vs "
                             f"{tuple(expect)}")
    host = []
    for path, _like in leaf_paths(state_like):
        entry = by_path[path]
        try:
            arr = np.load(os.path.join(d, entry["file"]))
        except (OSError, ValueError) as e:
            raise CorruptCheckpointError(f"unreadable leaf {entry['file']} in {d}: {e}") from e
        if verify and entry.get("crc") and _crc(arr) != entry["crc"]:
            raise CorruptCheckpointError(f"checksum mismatch for {entry['path']} in {d}")
        host.append(_tensor(arr, entry["dtype"]))
    return place_tree(host, state_like, layout)


def restore_latest(ckpt_dir: str, state_like=None, layout=None, *, verify: bool = True):
    """Restore the newest retained step, falling back to earlier steps when
    one is corrupt.  Returns ``(step, state)``; raises
    :class:`CorruptCheckpointError` when no retained step restores,
    ``FileNotFoundError`` when there is none."""
    steps = retained_steps(ckpt_dir)
    if not steps:
        raise FileNotFoundError(f"no checkpoints in {ckpt_dir}")
    last_err: Exception | None = None
    for step in reversed(steps):
        try:
            return step, restore(ckpt_dir, step, state_like, layout, verify=verify)
        except CorruptCheckpointError as e:
            last_err = e
    raise CorruptCheckpointError(f"every retained step in {ckpt_dir} is corrupt") from last_err


# ---------------------------------------------------------------------------
# a train program's per-rank states <-> full logical arrays
# ---------------------------------------------------------------------------

class StateLayout:
    """How a train program's state lies on its mesh of ranks: the gather of
    per-rank states into full logical arrays, and the placement back onto
    the program's ranks (a ``ThreadMesh``)."""

    def __init__(self, prog):
        from repro_torch.core.mesh import ThreadMesh
        from repro_torch.models.common import meta_leaves
        from repro_torch.train import optim
        if not isinstance(prog.mesh, ThreadMesh):
            raise NotImplementedError("checkpoints gather the ranks of a ThreadMesh; a "
                                      "DistMesh rank sees its own shards only")
        self.prog = prog
        self.mesh = prog.mesh
        self.zero3 = prog.rc.zero_stage == 3
        self.dp_axes = prog.hcfg.dp_axes()
        self.world = prog.dp_world()
        self.n_data = self.mesh.axis_size("data") if "data" in self.mesh.axes else 1
        self.dims = prog.fsdp_dims
        self.metas = meta_leaves(prog.model.abstract_params())
        self.param_dtype = getattr(torch, prog.rc.param_dtype)
        self.ef = optim.ef_codec(prog.rc) is not None
        self.pad_len = optim._pad_len

    @classmethod
    def of(cls, layout) -> "StateLayout":
        return layout if isinstance(layout, cls) else cls(layout)

    def _dp_order(self) -> list[int]:
        """Mesh ranks in DP order (pod-major)."""
        ranks = range(self.mesh.size)
        return sorted(ranks, key=lambda r: self.mesh.axis_index(r, self.dp_axes))

    def _data_ranks(self) -> list[int]:
        """One rank per "data" index (pod 0's), in data order."""
        ranks = [r for r in range(self.mesh.size)
                 if "pod" not in self.mesh.axes or self.mesh.axis_index(r, "pod") == 0]
        if "data" not in self.mesh.axes:
            return ranks[:1]
        return sorted(ranks, key=lambda r: self.mesh.axis_index(r, "data"))

    def logical_like(self):
        """The logical skeleton: meta tensors of the full shapes, an int step."""
        def meta(shape, dtype):
            return torch.empty(tuple(shape), dtype=dtype, device="meta")

        params = [meta(m.shape, self.param_dtype) for m in self.metas]
        if self.zero3:
            flat_opt = [meta(m.shape, torch.float32) for m in self.metas]
        else:
            flat_opt = [meta((int(np.prod(m.shape)),), torch.float32) for m in self.metas]
        _, rebuild = flatten(self.prog.model.abstract_params())
        opt = {"m": rebuild(flat_opt), "v": rebuild(list(flat_opt)),
               "master": rebuild(list(flat_opt))}
        if self.ef:
            n_local = [int(np.prod(m.shape)) // (self.n_data if d is not None else 1)
                       for m, d in zip(self.metas, self.dims)]
            opt["ef"] = rebuild([meta((self.world * n,), torch.float32) for n in n_local])
        return {"params": rebuild(params), "opt": opt, "step": 0}

    def logical_state(self, states):
        """The full logical arrays of every rank's state (on the mesh's
        device; :func:`save` copies them to the host)."""
        if len(states) != self.mesh.size:
            raise ValueError(f"{len(states)} rank states for a mesh of {self.mesh.size}")
        order, data_ranks = self._dp_order(), self._data_ranks()
        _, rebuild = flatten(states[0]["params"])

        def sharded(key, j, leaf_of):
            d = self.dims[j]
            if self.zero3 and d is not None:
                return torch.cat([leaf_of(states[r], key)[j] for r in data_ranks], d)
            return leaf_of(states[0], key)[j]

        def p_of(s, _):
            return flatten(s["params"])[0]

        def o_of(s, key):
            return flatten(s["opt"][key])[0]

        n_leaves = len(self.metas)
        params = rebuild([sharded("params", j, p_of) for j in range(n_leaves)])
        opt = {}
        for key in ("m", "v", "master"):
            if self.zero3:
                opt[key] = rebuild([sharded(key, j, o_of) for j in range(n_leaves)])
            else:
                opt[key] = rebuild([
                    torch.cat([o_of(states[r], key)[j] for r in order])
                    [:int(np.prod(self.metas[j].shape))] for j in range(n_leaves)])
        if self.ef:
            opt["ef"] = rebuild([torch.cat([o_of(states[r], "ef")[j] for r in order])
                                 for j in range(n_leaves)])
        return {"params": params, "opt": opt, "step": int(states[0]["step"])}

    def place(self, tree):
        """Every rank's state of the program from a full logical ``tree``
        (tensors anywhere; each rank gets its own copies on the device)."""
        from repro_torch.models.common import shard_leaf
        dev = self.mesh.device
        p_full, rebuild = flatten(tree["params"])
        opt_full = {k: flatten(v)[0] for k, v in tree["opt"].items()}
        states = []
        for r in range(self.mesh.size):
            i = self.mesh.axis_index(r, self.dp_axes)
            di = self.mesh.axis_index(r, "data") if "data" in self.mesh.axes else 0

            def shard(t, j, dtype):
                t = t.to(dev, dtype)
                if self.zero3 and self.dims[j] is not None:
                    return shard_leaf(t, self.dims[j], di, self.n_data)
                return t.clone()

            def flat_shard(t):
                t = t.to(dev, torch.float32).reshape(-1)
                n = t.numel()
                t = torch.nn.functional.pad(t, (0, self.pad_len(n, self.world) - n))
                s = t.numel() // self.world
                return t[i * s:(i + 1) * s].clone()

            params = rebuild([shard(t, j, self.param_dtype) for j, t in enumerate(p_full)])
            opt = {}
            for key in ("m", "v", "master"):
                opt[key] = rebuild([shard(t, j, torch.float32) if self.zero3 else flat_shard(t)
                                    for j, t in enumerate(opt_full[key])])
            if self.ef:
                opt["ef"] = rebuild([t.to(dev, torch.float32).chunk(self.world)[i].clone()
                                     for t in opt_full["ef"]])
            states.append({"params": params, "opt": opt, "step": int(tree["step"])})
        return states
