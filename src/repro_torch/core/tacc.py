"""TACC: the runtime dispatch table (paper §4.2, Appendix C).

Counterpart of ``repro/core/tacc.py``.  A table maps ``(op, variant)`` to a
callable and is consulted on every call.  Variants in the port:

* ``"cuda"`` -> the hand-written Hopper kernels (``repro_torch.kernels``),
* ``"cpu"``  -> plain-torch implementations (the registered defaults),

and for the collectives (``repro_torch.core.collectives``) ``"flat"``,
``"hier"`` and ``"pipelined"``, which :func:`repro_torch.core.hetccl.install`
swaps by setting defaults.

Where the reference resolves from JAX's global platform, the port resolves
from the **device type of the first tensor argument** of each call, so a CUDA
tensor reaches the kernel and a CPU tensor the plain path.  An explicit
``variant=`` or a :func:`set_platform` pin overrides that, for tests.  There
is no ``interpret`` variant: a CUDA kernel has no interpreter, and its plain
version stands beside it instead.

Collective registrations declare the **policy fields** they consume
(``policy_fields=``): :func:`dispatch` with ``policy=CommPolicy(...)`` maps
exactly those fields onto keyword arguments, and nothing else (DESIGN.md
§12).
"""
from __future__ import annotations

import collections
import contextlib
import threading
from typing import Any, Callable, Dict, Tuple

import torch

_lock = threading.Lock()
_TABLE: Dict[str, Dict[str, Callable[..., Any]]] = {}
_DEFAULT_VARIANT: Dict[str, str] = {}
_POLICY_FIELDS: Dict[Tuple[str, str], Tuple[str, ...]] = {}
_PLATFORM: str | None = None     # pin; None -> per-call device type


class TaccError(KeyError):
    pass


# The collective row a rank's thread is running (set by ``hetccl``'s
# dispatch for the length of the call) and the kernel launches made under
# each row, ``(row, kernel) -> launches``: the kernel wrappers count into it
# where they launch.  A row is ``(op, size class, variant, CommPolicy)``;
# launches outside any collective (error feedback) count under None.  Read
# by the card checks; ``reset_row_launches`` zeroes it.
_row = threading.local()
_row_lock = threading.Lock()
row_launches: collections.Counter = collections.Counter()


@contextlib.contextmanager
def in_row(row):
    """Run the block with ``row`` as this thread's current collective row."""
    prev = getattr(_row, "row", None)
    _row.row = row
    try:
        yield
    finally:
        _row.row = prev


def current_row():
    """This thread's current collective row, or None outside a collective."""
    return getattr(_row, "row", None)


def count_row_launch(kernel: str) -> None:
    """One launch of ``kernel`` under the calling thread's current row."""
    with _row_lock:
        row_launches[(current_row(), kernel)] += 1


def reset_row_launches() -> None:
    with _row_lock:
        row_launches.clear()


def register(op: str, variant: str, *, default: bool = False,
             policy_fields: Tuple[str, ...] = ()) -> Callable:
    """Decorator: register ``fn`` as the ``variant`` implementation of ``op``.

    ``policy_fields`` names the ``CommPolicy`` fields this implementation
    takes as keyword parameters; :func:`dispatch` with ``policy=`` maps
    exactly these.
    """

    def deco(fn: Callable) -> Callable:
        with _lock:
            _TABLE.setdefault(op, {})[variant] = fn
            _POLICY_FIELDS[(op, variant)] = tuple(policy_fields)
            if default or op not in _DEFAULT_VARIANT:
                _DEFAULT_VARIANT[op] = variant
        return fn

    return deco


def set_platform(platform: str | None) -> None:
    """Pin the platform (paper: ``taccSetPlatform``); None unpins, so each
    call resolves from its tensors' device again."""
    global _PLATFORM
    _PLATFORM = platform


def get_platform() -> str | None:
    """The pinned platform, or None when calls resolve per device."""
    return _PLATFORM


def set_default(op: str, variant: str) -> None:
    with _lock:
        if op not in _TABLE or variant not in _TABLE[op]:
            raise TaccError(f"no implementation registered for ({op!r}, {variant!r})")
        _DEFAULT_VARIANT[op] = variant


def get_default(op: str) -> str:
    try:
        return _DEFAULT_VARIANT[op]
    except KeyError:
        raise TaccError(f"no default variant registered for op {op!r}; "
                        f"registered ops: {sorted(_TABLE)}") from None


def policy_fields(op: str, variant: str) -> Tuple[str, ...]:
    """The policy fields declared by the ``(op, variant)`` registration."""
    return _POLICY_FIELDS.get((op, variant), ())


def variants(op: str) -> list[str]:
    with _lock:
        return sorted(_TABLE.get(op, {}))


def _device_type(args) -> str | None:
    for a in args:
        if isinstance(a, torch.Tensor):
            return a.device.type
    return None


def resolve_variant(op: str, variant: str | None = None,
                    device_type: str | None = None) -> str:
    """explicit ``variant`` -> pinned platform -> ``device_type`` -> default."""
    impls = _TABLE.get(op)
    if not impls:
        raise TaccError(f"unknown op {op!r}; registered: {sorted(_TABLE)}")
    if variant is not None:
        if variant not in impls:
            raise TaccError(
                f"op {op!r} has no variant {variant!r}; has {sorted(impls)}")
        return variant
    plat = _PLATFORM or device_type
    if plat in impls:
        return plat
    return get_default(op)


def resolve(op: str, variant: str | None = None,
            device_type: str | None = None) -> Callable[..., Any]:
    return _TABLE[op][resolve_variant(op, variant, device_type)]


def dispatch(op: str, *args: Any, variant: str | None = None,
             policy: Any = None, **kwargs: Any) -> Any:
    """Call the implementation resolved for these arguments.

    With ``policy=`` (a ``CommPolicy``), the fields the resolved registration
    declared via ``policy_fields`` become keyword arguments, and only those;
    explicit ``kwargs`` win over them.
    """
    vname = resolve_variant(op, variant, _device_type(args))
    if policy is not None:
        for f in _POLICY_FIELDS.get((op, vname), ()):
            kwargs.setdefault(f, getattr(policy, f))
    return _TABLE[op][vname](*args, **kwargs)


def table() -> Dict[str, Dict[str, str]]:
    """Readable dump of the function table (paper Appendix C analogue)."""
    with _lock:
        return {op: {v: f"{fn.__module__}.{fn.__qualname__}"
                     for v, fn in impls.items()}
                for op, impls in sorted(_TABLE.items())}
