"""The kernel build helper (`multimodal_flows_tpu_torch/ops/cuda_build.py`)
on the CPU, with no nvcc: a library's name follows its source and every
header beside it, and a build without nvcc fails with a clear error."""

from __future__ import annotations

import pytest

from multimodal_flows_tpu_torch.ops import cuda_build


def _library(tmp_path):
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "kern.cu").write_text('#include "core.cuh"\nextern "C" int kern_fwd() { return f(); }\n')
    (csrc / "core.cuh").write_text("inline int f() { return 0; }\n")
    lib = cuda_build.CudaLibrary("kern.cu", lambda _: None, csrc=csrc,
                                 build_dir=tmp_path / "build")
    return lib, csrc


def test_library_path_changes_with_header(tmp_path):
    lib, csrc = _library(tmp_path)
    before = lib.path()
    (csrc / "core.cuh").write_text("inline int f() { return 1; }\n")
    after = lib.path()
    assert after != before
    assert after.parent == before.parent == tmp_path / "build"
    assert after.name.startswith("libkern_") and after.suffix == ".so"


def test_library_path_is_stable(tmp_path):
    lib, csrc = _library(tmp_path)
    first = lib.path()
    (csrc / "notes.txt").write_text("not a source")
    again = cuda_build.CudaLibrary("kern.cu", lambda _: None, csrc=csrc,
                                   build_dir=tmp_path / "build")
    assert lib.path() == first == again.path()
    (csrc / "kern.cu").write_text((csrc / "kern.cu").read_text() + "// edited\n")
    assert lib.path() != first


def test_load_without_nvcc_raises(tmp_path, monkeypatch):
    lib, _ = _library(tmp_path)
    monkeypatch.setattr(cuda_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(cuda_build, "DEFAULT_NVCC", str(tmp_path / "no-nvcc"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        lib.load()
    assert not (tmp_path / "build").exists()
