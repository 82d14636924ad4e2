"""The CUDA build's cache key (``kernels.cuda._target``), on the CPU: no
``nvcc`` needed. A library is named by a hash of the flags, its source and
every ``csrc`` header the source includes, so an edit to a shared header
rebuilds exactly the sources that include it."""
import shutil

import pytest

from repro_torch.kernels import cuda


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    """A copy of ``csrc/`` that the build's cache key reads instead."""
    copy = tmp_path / "csrc"
    shutil.copytree(cuda.CSRC, copy)
    monkeypatch.setattr(cuda, "CSRC", copy)
    return copy


def _includers(header: str) -> list:
    return [n for n, src in cuda.SOURCES.items()
            if f'#include "{header}"' in (cuda.CSRC / src).read_text()]


def test_the_redesigned_sources_share_a_header():
    assert sorted(_includers("async_copy.cuh")) == [
        "ell_accumulate", "flash_attention", "rbf_rows"]


@pytest.mark.parametrize("name", sorted(cuda.SOURCES))
def test_editing_a_header_renames_exactly_its_includers(csrc, name):
    before = cuda._target(name)
    with open(csrc / "async_copy.cuh", "a") as f:
        f.write("// edited\n")
    after = cuda._target(name)
    assert (after != before) == (name in _includers("async_copy.cuh"))
    assert after.parent == before.parent


def test_the_row_kernels_share_the_occupancy_header():
    assert sorted(_includers("occupancy.cuh")) == ["ell_accumulate",
                                                   "ell_rows", "rbf_rows"]


def test_the_accumulates_share_the_chunk_sum_header():
    assert sorted(_includers("chunk_sum.cuh")) == ["ell_accumulate",
                                                   "rbf_accumulate"]


@pytest.mark.parametrize("name", sorted(cuda.SOURCES))
def test_editing_the_chunk_sum_header_renames_exactly_its_includers(csrc,
                                                                    name):
    before = cuda._target(name)
    with open(csrc / "chunk_sum.cuh", "a") as f:
        f.write("// edited\n")
    assert (cuda._target(name) != before) == (
        name in _includers("chunk_sum.cuh"))


@pytest.mark.parametrize("name", sorted(cuda.SOURCES))
def test_editing_the_occupancy_header_renames_exactly_its_includers(csrc,
                                                                    name):
    before = cuda._target(name)
    with open(csrc / "occupancy.cuh", "a") as f:
        f.write("// edited\n")
    assert (cuda._target(name) != before) == (
        name in _includers("occupancy.cuh"))


@pytest.mark.parametrize("name", sorted(cuda.SOURCES))
def test_editing_a_source_renames_its_library(csrc, name):
    before = {n: cuda._target(n) for n in cuda.SOURCES}
    with open(csrc / cuda.SOURCES[name], "a") as f:
        f.write("// edited\n")
    after = {n: cuda._target(n) for n in cuda.SOURCES}
    assert {n for n in cuda.SOURCES if after[n] != before[n]} == {name}


def test_nested_and_toolkit_includes(csrc):
    """A header included through another header counts; an include that
    is not a file beside the source (a toolkit header) is left to nvcc."""
    (csrc / "inner.cuh").write_text("// inner\n")
    with open(csrc / "async_copy.cuh", "a") as f:
        f.write('#include "inner.cuh"\n#include "cuda_fp16.h"\n')
    seen = cuda._inputs(csrc / cuda.SOURCES["rbf_rows"], {})
    assert sorted(p.name for p in seen) == ["async_copy.cuh", "inner.cuh",
                                            "occupancy.cuh", "rbf_rows.cu"]
    before = cuda._target("rbf_rows")
    (csrc / "inner.cuh").write_text("// inner, edited\n")
    assert cuda._target("rbf_rows") != before
