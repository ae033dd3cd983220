"""The port's architecture registry against the reference's.

Every architecture of the reference (``ARCH_IDS``) and every model of the
paper (``PAPER_IDS``) is either ported or pending with its ROADMAP item: a
pending one raises ``NotImplementedError`` naming that item, never a bare
``KeyError``.
"""
import pytest

pytest.importorskip("torch")

from repro.configs import ARCH_IDS as REF_ARCH_IDS  # noqa: E402
from repro.configs import PAPER_IDS  # noqa: E402
from repro_torch.configs import ARCH_IDS, PENDING, get_config  # noqa: E402
from repro_torch.launch import serve  # noqa: E402


@pytest.mark.parametrize("arch", REF_ARCH_IDS + PAPER_IDS)
def test_every_reference_arch_is_ported_or_pending(arch):
    assert (arch in ARCH_IDS) != (arch in PENDING)
    if arch in PAPER_IDS:
        with pytest.raises(NotImplementedError, match="A8a"):
            get_config(arch)
    elif arch in PENDING:
        with pytest.raises(NotImplementedError, match=r"ROADMAP A8[abc] "):
            get_config(arch)
    else:
        assert get_config(arch).name == arch


def test_unknown_arch_lists_known_and_pending():
    with pytest.raises(KeyError, match="smollm-135m.*pending.*gpt-125m"):
        get_config("gpt-999m")


def test_serve_launcher_names_the_roadmap_item():
    with pytest.raises(NotImplementedError, match="gpt-125m is not in the port yet: ROADMAP A8a"):
        serve.main(["--arch", "gpt-125m", "--device", "cpu"])
