"""How heat_tpu_torch keys its built kernel libraries (``kernels/_build.py``).

A library is named by a hash of its ``.cu`` source, of every ``csrc/*.cuh``
header it includes (directly or through another header) and of the nvcc
flags, so that an edit to a shared header rebuilds every source that
includes it instead of loading a stale library. Nothing here compiles.
"""

import pytest

from heat_tpu_torch.kernels import _build


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "_CSRC", tmp_path)
    monkeypatch.setattr(_build, "build_dir", lambda: tmp_path / "build")
    (tmp_path / "a.cuh").write_text('#pragma once\n#include "b.cuh"\nint a();\n')
    (tmp_path / "b.cuh").write_text("int b();\n")
    (tmp_path / "k.cu").write_text('#include <cuda_runtime.h>\n#include "a.cuh"\n  # include "a.cuh"\nint k();\n')
    (tmp_path / "plain.cu").write_text("#include <stdint.h>\nint p();\n")
    return tmp_path


def test_headers_are_followed_through_includes_once(csrc):
    assert _build._headers((csrc / "k.cu").read_bytes()) == ["a.cuh", "b.cuh"]
    assert _build._headers((csrc / "plain.cu").read_bytes()) == []


@pytest.mark.parametrize("header", ["a.cuh", "b.cuh"])
def test_a_header_edit_changes_the_library_of_its_includers(csrc, header):
    before, plain = _build._library_path("k"), _build._library_path("plain")
    (csrc / header).write_text((csrc / header).read_text() + "// edited\n")
    assert _build._library_path("k") != before
    assert _build._library_path("plain") == plain
    assert _build._library_path("k").parent == csrc / "build"


def test_the_hopper_sources_share_one_header():
    assert {"sddmm_sm90", "sketch_sm90", "attention_sm90", "sketch", "spmm"} <= set(_build.sources())
    for name in ("attention_sm90", "sddmm_sm90", "sketch_sm90"):
        assert "sm90_common.cuh" in _build._headers((_build._CSRC / f"{name}.cu").read_bytes())
    for name in ("sketch", "sketch_sm90"):
        assert "sketch_sums.cuh" in _build._headers((_build._CSRC / f"{name}.cu").read_bytes())


def _package_data_globs():
    import tomllib

    with open(_build._PKG.parent / "pyproject.toml", "rb") as f:
        return tomllib.load(f)["tool"]["setuptools"]["package-data"]["heat_tpu_torch"]


@pytest.mark.parametrize("name", _build.sources())
def test_every_included_header_ships_with_the_package(name):
    from fnmatch import fnmatch

    globs = _package_data_globs()
    assert any(fnmatch(f"csrc/{name}.cu", g) for g in globs)
    for header in _build._headers((_build._CSRC / f"{name}.cu").read_bytes()):
        assert any(fnmatch(f"csrc/{header}", g) for g in globs), f"csrc/{header} (included by {name}.cu) is not shipped"


def test_build_dir_lies_in_the_checkout_here():
    assert (_build._PKG.parent / "pyproject.toml").is_file()
    assert _build.build_dir() == _build._PKG.parent / "build" / "heat_tpu_torch"


@pytest.mark.parametrize("xdg", [None, "cache-home"])
def test_build_dir_of_an_installed_package_lies_outside_its_install_tree(tmp_path, monkeypatch, xdg):
    site = tmp_path / "site-packages"
    (site / "heat_tpu_torch").mkdir(parents=True)
    monkeypatch.setattr(_build, "_PKG", site / "heat_tpu_torch")
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    if xdg is None:
        monkeypatch.delenv("XDG_CACHE_HOME", raising=False)
        expected = tmp_path / "home" / ".cache" / "heat_tpu_torch"
    else:
        monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / xdg))
        expected = tmp_path / xdg / "heat_tpu_torch"
    assert _build.build_dir() == expected
    assert site not in _build.build_dir().parents
