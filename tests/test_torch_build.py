"""The kernel build's cache key: a library is named by a hash of its
source, of the shared headers and of the flags, so an edited header
rebuilds every library whose source includes it. Runs without ``nvcc``:
only the names are computed."""
import re
import shutil

import pytest

pytest.importorskip("torch")

from repro_torch.kernels import _build  # noqa: E402


def _includes(src):
    """The headers src includes, directly or through another header."""
    found, todo = set(), [src]
    while todo:
        text = todo.pop().read_text()
        for h in re.findall(r'#include "([^"]+\.cuh)"', text):
            if h not in found:
                found.add(h)
                todo.append(src.parent / h)
    return found


def test_every_source_is_listed_and_built_by_default():
    on_disk = {p.stem for p in _build.CSRC.glob("*.cu")}
    assert set(_build.SOURCES) == on_disk
    for name in ("assign", "lut_gemm", "flash_decode_kvq"):
        assert name in _build.SOURCES


@pytest.mark.parametrize("header", ["vq_common.cuh", "vq_gather.cuh",
                                    "flash_common.cuh", "cluster.cuh"])
def test_editing_a_shared_header_renames_every_library_that_includes_it(
        monkeypatch, tmp_path, header):
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", csrc)
    users = {n for n in _build.SOURCES
             if header in _includes(csrc / f"{n}.cu")}
    assert len(users) >= 2             # a header shared by two kernels
    before = {n: _build.library_path(n) for n in _build.SOURCES}
    assert before == {n: _build.library_path(n) for n in _build.SOURCES}
    with open(csrc / header, "a") as f:
        f.write("\n// edited\n")
    after = {n: _build.library_path(n) for n in _build.SOURCES}
    for n in users:
        assert after[n] != before[n] and after[n].name.startswith(n + "-")
    # a source edit renames its own library
    with open(csrc / "assign.cu", "a") as f:
        f.write("\n// edited\n")
    assert _build.library_path("assign") != after["assign"]
    assert _build.library_path("lut_gemm") == after["lut_gemm"]
