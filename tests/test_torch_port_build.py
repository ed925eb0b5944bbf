"""How the port names its kernel library (onetrainer_tpu_torch/ops/_build.py):
every file under csrc/, headers included, goes into the hash that names
it, so an edited header rebuilds; only the .cu files are compiled. Nothing
here calls nvcc."""

import shutil

from onetrainer_tpu_torch.ops import _build


def _csrc_files(root):
    return {p for p in root.rglob("*") if p.is_file()}


def test_library_name_hashes_every_file_under_csrc():
    assert set(_build.hashed_files()) == _csrc_files(_build._CSRC)
    assert any(p.suffix == ".cuh" for p in _build.hashed_files())
    assert set(_build.sources()) == set(_build._CSRC.glob("*.cu"))


def test_editing_a_header_renames_the_library(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    shutil.copytree(_build._CSRC, csrc)
    monkeypatch.setattr(_build, "_CSRC", csrc)
    before = _build.library_path()
    assert _build.library_path() == before             # same bytes, same name
    header = next(p for p in csrc.iterdir() if p.suffix == ".cuh")
    header.write_text(header.read_text() + "\n// edited\n")
    edited = _build.library_path()
    assert edited != before
    assert header not in _build.sources()              # headers are not compiled
    (csrc / "extra.cuh").write_text("#pragma once\n")
    assert _build.library_path() != edited             # a new file counts too
