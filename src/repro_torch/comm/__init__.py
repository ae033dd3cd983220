"""``repro_torch.comm``: communicators with per-op, size-classed collective
policies (DESIGN.md §12).  Counterpart of ``repro/comm``.

* :mod:`~repro_torch.comm.policy` (stdlib only): ``CommPolicy``,
  ``PolicyTable``, ``size_class``;
* :mod:`~repro_torch.comm.communicator`: ``Communicator``, ``create`` (with
  the transport binding), ``from_config``, ``variant_for``,
  ``check_runnable``.

    from repro_torch import comm
    c = comm.create(("data",), "pod", policies={...})
    with hetccl.use(c): ...
"""
from repro_torch.comm.policy import (BACKENDS, CommPolicy,  # noqa: F401
                                     DEFAULT_SIZE_CLASS_BOUNDS, MODES,
                                     PolicyTable, SIZE_CLASSES, WILDCARD,
                                     size_class)
from repro_torch.comm.communicator import (Communicator, check_runnable,  # noqa: F401
                                           create, from_config, variant_for)

__all__ = [
    "BACKENDS", "CommPolicy", "Communicator", "check_runnable", "DEFAULT_SIZE_CLASS_BOUNDS",
    "MODES", "PolicyTable", "SIZE_CLASSES", "WILDCARD", "create",
    "from_config", "size_class", "variant_for",
]
