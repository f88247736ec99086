"""The kernels' build key (``repro_torch.kernels._build._key``).

The library is cached under ``build/repro_torch/<key>/``, so the key must
change with every file that goes into the build: the compiled sources and
the headers they include (``csrc/hopper.cuh``, shared by the flash-attention
forward and backward). Each test works on a copy of ``csrc/`` in
``tmp_path``; nothing is compiled.
"""
import shutil

import pytest

from repro_torch.kernels import _build


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    """A copy of ``csrc/`` that ``_build`` reads in place of the package's."""
    copy = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, copy)
    monkeypatch.setattr(_build, "CSRC", copy)
    return copy


def test_every_compiled_source_and_the_header_are_in_csrc():
    names = {p.name for p in _build.CSRC.iterdir()}
    assert set(_build.SOURCES) <= names
    assert "hopper.cuh" in names
    for name in ("flash_attention.cu", "flash_attention_bwd.cu"):
        assert '#include "hopper.cuh"' in (_build.CSRC / name).read_text()


def test_unchanged_tree_gives_the_same_key(csrc, monkeypatch):
    key = _build._key()
    assert len(key) == 16
    assert _build._key() == key
    monkeypatch.setattr(_build, "CSRC", shutil.copytree(
        csrc, csrc.parent / "again"))   # the same files elsewhere
    assert _build._key() == key


@pytest.mark.parametrize("name", ["hopper.cuh", "flash_attention_bwd.cu",
                                  "fixedpoint.cu"])
def test_editing_a_file_changes_the_key(csrc, name):
    key = _build._key()
    path = csrc / name
    path.write_text(path.read_text() + "\n// edited\n")
    assert _build._key() != key


def test_adding_or_renaming_a_file_changes_the_key(csrc):
    key = _build._key()
    extra = csrc / "extra.cuh"
    extra.write_text("#pragma once\n")
    with_extra = _build._key()
    assert with_extra != key
    extra.rename(csrc / "renamed.cuh")
    assert _build._key() not in (key, with_extra)
    (csrc / "renamed.cuh").unlink()
    assert _build._key() == key
