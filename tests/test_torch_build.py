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
