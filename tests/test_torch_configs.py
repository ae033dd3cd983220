"""The port's architecture registry against the reference's.

Every architecture of the reference (``ARCH_IDS``) and every model of the
paper (``PAPER_IDS``) is either ported or pending with its ROADMAP item: a
pending one raises ``NotImplementedError`` naming that item, never a bare
``KeyError``.  Each ported config equals the reference's field by field,
with its parameter count, head dim, padded vocab and ``full_attention``;
the shapes (``SHAPES``) are the reference's.
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

# the configs this slice ports (ROADMAP A8a)
NEW_ARCHS = ("gpt-125m", "gpt-355m", "llama-1b", "llama-3b", "smollm-360m",
             "starcoder2-7b", "deepseek-coder-33b")


@pytest.mark.parametrize("arch", REF_ARCH_IDS + REF_PAPER_IDS)
def test_every_reference_arch_is_ported_or_pending(arch):
    ported = arch in ARCH_IDS or arch in PAPER_IDS
    assert ported != (arch in PENDING)
    if arch in PENDING:
        with pytest.raises(NotImplementedError, match=r"ROADMAP A8[bc] "):
            get_config(arch)
    else:
        assert get_config(arch).name == arch
    assert PAPER_IDS == REF_PAPER_IDS
    assert set(PENDING) == {"qwen2-vl-72b", "whisper-medium"}


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_config_equals_the_reference(arch):
    got, want = get_config(arch), ref_get_config(arch)
    for f in dataclasses.fields(got):
        assert getattr(got, f.name) == getattr(want, f.name), f.name
    assert (want.n_enc_layers, want.n_frames, want.mrope_sections) == (0, 0, ())
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
    with pytest.raises(KeyError, match="smollm-135m.*pending.*qwen2-vl-72b"):
        get_config("gpt-999m")


def test_serve_launcher_names_the_roadmap_item():
    with pytest.raises(NotImplementedError,
                       match="qwen2-vl-72b is not in the port yet: ROADMAP A8b"):
        serve.main(["--arch", "qwen2-vl-72b", "--device", "cpu"])
