"""The port's architecture registry against the reference's.

Every architecture of the reference (``ARCH_IDS``, in its order) and every
model of the paper (``PAPER_IDS``) is ported: ``PENDING`` is empty, and an
unknown name raises ``KeyError`` listing the known ones.  Each config
equals the reference's field by field, with its parameter count, head dim,
padded vocab and ``full_attention``; the shapes (``SHAPES``) are the
reference's.
"""
import dataclasses

import pytest

pytest.importorskip("torch")

from repro.configs import ARCH_IDS as REF_ARCH_IDS  # noqa: E402
from repro.configs import PAPER_IDS as REF_PAPER_IDS  # noqa: E402
from repro.configs import SHAPES as REF_SHAPES  # noqa: E402
from repro.configs import all_configs as ref_all_configs  # noqa: E402
from repro.configs import get_config as ref_get_config  # noqa: E402
from repro_torch.configs import (ARCH_IDS, PAPER_IDS, PENDING, SHAPES,  # noqa: E402
                                 all_configs, get_config)
from repro_torch.launch import serve  # noqa: E402

# the configs of the dense slice (ROADMAP A8a), the VLM (A8b) and the
# encoder-decoder (A8c)
NEW_ARCHS = ("gpt-125m", "gpt-355m", "llama-1b", "llama-3b", "smollm-360m",
             "starcoder2-7b", "deepseek-coder-33b", "qwen2-vl-72b", "whisper-medium")


@pytest.mark.parametrize("arch", REF_ARCH_IDS + REF_PAPER_IDS)
def test_every_reference_arch_is_ported_or_pending(arch):
    assert arch in ARCH_IDS or arch in PAPER_IDS
    assert get_config(arch).name == arch
    assert PAPER_IDS == REF_PAPER_IDS and ARCH_IDS == REF_ARCH_IDS
    assert PENDING == {}


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_config_equals_the_reference(arch):
    got, want = get_config(arch), ref_get_config(arch)
    for f in dataclasses.fields(got):
        assert getattr(got, f.name) == getattr(want, f.name), f.name
    assert [f.name for f in dataclasses.fields(got)] == \
        [f.name for f in dataclasses.fields(want)]
    assert got.n_params() == want.n_params()
    assert got.n_active_params() == want.n_active_params()
    assert (got.head_dim_, got.padded_vocab, got.full_attention) == \
        (want.head_dim_, want.padded_vocab, want.full_attention)
    red, ref_red = got.reduced(), want.reduced()
    assert all(getattr(red, f.name) == getattr(ref_red, f.name)
               for f in dataclasses.fields(red))


def test_shapes_and_all_configs_equal_the_reference():
    assert {k: dataclasses.asdict(v) for k, v in SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in REF_SHAPES.items()}
    for arch in NEW_ARCHS:
        assert [s.applicable(get_config(arch)) for s in SHAPES.values()] == \
            [s.applicable(ref_get_config(arch)) for s in REF_SHAPES.values()]
    ref, got = ref_all_configs(), all_configs()
    assert set(got) == set(ARCH_IDS) == set(ref) - set(PENDING)
    assert all(got[a].name == ref[a].name for a in got)


def test_unknown_arch_lists_known_and_pending():
    with pytest.raises(KeyError, match="'gpt-999m': the port has whisper-medium, .*"
                                       "qwen2-vl-72b, mamba2-2.7b, gpt-125m.*llama-3b"):
        get_config("gpt-999m")


def test_serve_launcher_names_the_roadmap_item():
    """The launcher serves the architectures that were pending."""
    done = serve.main(["--arch", "qwen2-vl-72b", "--device", "cpu", "--batch", "2",
                       "--max-new", "2"])
    assert len(done) == 2 and all(len(r.out) == 2 for r in done)
