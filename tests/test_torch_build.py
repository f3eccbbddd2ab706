"""The port's kernel cache key (``ops/_build._target``): a library's name
carries a hash of its ``.cu`` source, of every ``csrc/`` header the source
includes (directly or through another header) and of the nvcc flags, so an
edited header rebuilds instead of loading a stale library. CPU only:
nothing is compiled here."""

import shutil

import pytest

from pytorch_distributed_tpu_torch.ops import _build


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    """A temporary copy of ``csrc/`` that ``_build`` reads instead."""
    dst = tmp_path / "csrc"
    shutil.copytree(_build.CSRC_DIR, dst)
    monkeypatch.setattr(_build, "CSRC_DIR", dst)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "_build")
    return dst


def _name(kernel="flash_attention"):
    return _build._target(kernel).name


def test_an_unedited_copy_keeps_the_name(csrc):
    first = _name()
    assert _name() == first
    assert first.startswith("libflash_attention-") and first.endswith(".so")


def test_the_flash_source_hashes_its_header(csrc):
    names = [p.name for p in _build._sources(csrc / "flash_attention.cu",
                                             [])]
    assert names == ["flash_attention.cu", "flash_sm90.cuh"]


@pytest.mark.parametrize("edited", ["flash_sm90.cuh", "flash_attention.cu"])
def test_editing_the_source_or_its_header_changes_the_name(csrc, edited):
    before = _name()
    path = csrc / edited
    path.write_text(path.read_text() + "\n// edited\n")
    assert _name() != before


def test_a_header_the_source_does_not_include_is_not_hashed(csrc):
    before, paged = _name(), _name("paged_attention")
    (csrc / "unused.cuh").write_text("// not included anywhere\n")
    hdr = csrc / "flash_sm90.cuh"
    hdr.write_text(hdr.read_text() + "\n// edited\n")
    assert _name("paged_attention") == paged  # includes no csrc header
    assert _name() != before


def test_a_header_included_by_a_header_is_hashed(csrc):
    (csrc / "inner.cuh").write_text("#pragma once\n// v1\n")
    hdr = csrc / "flash_sm90.cuh"
    hdr.write_text(hdr.read_text() + '\n#include "inner.cuh"\n')
    before = _name()
    (csrc / "inner.cuh").write_text("#pragma once\n// v2\n")
    assert _name() != before


def test_the_flags_change_the_name(csrc, monkeypatch):
    before = _name()
    monkeypatch.setattr(_build, "NVCC_FLAGS", (*_build.NVCC_FLAGS,
                                               "-lineinfo"))
    assert _name() != before
