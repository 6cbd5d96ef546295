"""The kernel build's cache key (`ops/build.py::library_path`): the library
name covers a kernel's source, every header under `csrc/` and the nvcc flags,
so an edited header builds anew and an unchanged tree reuses what was built.
Runs on a copy of `csrc/` and calls no nvcc."""

import shutil

import pytest

from stableanimator_tpu_torch.ops import build
from tests.torch_threads import share_cores

THREADS = share_cores()

KERNELS = ("flash_attention_fwd", "flash_attention_resident", "flash_attention_bwd")


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    copy = tmp_path / "csrc"
    shutil.copytree(build.CSRC, copy, ignore=shutil.ignore_patterns("_build"))
    monkeypatch.setattr(build, "CSRC", copy)
    return copy


def test_library_name_is_stable_and_follows_the_flags(csrc, monkeypatch):
    first = {name: build.library_path(name) for name in KERNELS}
    assert all(path.parent == csrc / "_build" for path in first.values())
    assert all(path.name.startswith(f"lib{name}_") for name, path in first.items())
    assert {name: build.library_path(name) for name in KERNELS} == first
    monkeypatch.setattr(build, "NVCC_FLAGS", build.NVCC_FLAGS + ("-lineinfo",))
    assert all(build.library_path(name) != first[name] for name in KERNELS)


@pytest.mark.parametrize("name", KERNELS)
def test_library_name_changes_when_a_header_changes(csrc, name):
    before = build.library_path(name)
    header = csrc / "sm90.cuh"
    header.write_text(header.read_text() + "\n// one more line\n")
    assert build.library_path(name) != before


def test_a_new_header_or_source_edit_changes_the_names_it_should(csrc):
    before = {name: build.library_path(name) for name in KERNELS}
    (csrc / "notes.txt").write_text("not a header")
    assert {name: build.library_path(name) for name in KERNELS} == before
    (csrc / "extra.h").write_text("#pragma once\n")
    added = {name: build.library_path(name) for name in KERNELS}
    assert all(added[name] != before[name] for name in KERNELS)
    src = csrc / "flash_attention_fwd.cu"
    src.write_text(src.read_text() + "\n// edited\n")
    edited = {name: build.library_path(name) for name in KERNELS}
    assert edited["flash_attention_fwd"] != added["flash_attention_fwd"]
    assert all(edited[name] == added[name] for name in KERNELS[1:])


def test_build_kernel_reuses_a_built_library_without_nvcc(csrc, monkeypatch):
    def no_nvcc():
        raise AssertionError("nvcc was called for a library that exists")

    monkeypatch.setattr(build, "_nvcc", no_nvcc)
    path = build.library_path("flash_attention_fwd")
    path.parent.mkdir(parents=True)
    path.write_bytes(b"")
    assert build.build_kernel("flash_attention_fwd") == path
    header = csrc / "sm90.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    with pytest.raises(AssertionError, match="nvcc was called"):
        build.build_kernel("flash_attention_fwd")


def test_the_raster_builds_with_gxx_and_its_own_flags(csrc, monkeypatch):
    """csrc/raster.cpp (no .cu of that name) takes g++ and GXX_FLAGS: its name
    follows those flags, not nvcc's, and the build calls no nvcc."""
    before = build.library_path("raster")
    monkeypatch.setattr(build, "NVCC_FLAGS", build.NVCC_FLAGS + ("-lineinfo",))
    assert build.library_path("raster") == before
    monkeypatch.setattr(build, "GXX_FLAGS", build.GXX_FLAGS + ("-g",))
    assert build.library_path("raster") != before

    def no_nvcc():
        raise AssertionError("nvcc was called for the C++ raster")

    monkeypatch.setattr(build, "_nvcc", no_nvcc)
    out = build.build_kernel("raster")
    assert out == build.library_path("raster") and out.stat().st_size > 0


def test_bwd_ab_watchdog_makes_the_mbarrier_wait_trap():
    # the A/B tool's watchdog build: sm90.cuh's one mbarrier wait loop gains a
    # trap after WATCHDOG_CLOCKS clocks; a text without that loop is refused
    from stableanimator_tpu_torch.tools import bwd_ab

    text = (build.CSRC / "sm90.cuh").read_text()
    patched = bwd_ab.watchdog_source(text)
    assert patched.count("__trap()") == text.count("__trap()") + 1
    assert f"{bwd_ab.WATCHDOG_CLOCKS}LL" in patched
    assert patched.count("mbarrier.try_wait") == text.count("mbarrier.try_wait")
    with pytest.raises(ValueError, match="wait loop"):
        bwd_ab.watchdog_source(patched)
