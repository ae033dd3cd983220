"""Shared fixtures.  8 forced host devices for multi-axis mesh tests
(the 512-device forcing is dry-run-only, per the launch contract)."""
import os

os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")

import pytest  # noqa: E402

from repro.core import compat  # noqa: E402

try:  # the property suite (test_properties.py) runs wherever hypothesis is
    # installed (CI installs it); pin a deterministic profile so CI runs are
    # reproducible: derandomized (fixed example sequence, no hidden seed) and
    # deadline-free (CI hosts are noisy; our own bench gate owns timing).
    from hypothesis import HealthCheck, settings  # noqa: E402

    settings.register_profile(
        "repro-ci", deadline=None, derandomize=True, max_examples=50,
        suppress_health_check=[HealthCheck.too_slow])
    settings.load_profile("repro-ci")
except ImportError:  # keeps tier-1 green on hosts without hypothesis
    pass


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA card; skips where "
        "torch.cuda.is_available() is false")


@pytest.fixture(scope="session")
def mesh3():
    """(pod=2, data=2, model=2) mesh."""
    return compat.make_mesh((2, 2, 2), ("pod", "data", "model"))


@pytest.fixture(scope="session")
def mesh2():
    """(data=2, model=4) single-pod mesh."""
    return compat.make_mesh((2, 4), ("data", "model"))
