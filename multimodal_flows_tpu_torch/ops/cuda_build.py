"""Build and load the port's hand-written CUDA kernels.

Each source in `csrc/` has a plain C interface.  At first use `nvcc`
compiles it for `sm_90a` into a shared library under
`build/multimodal_flows_tpu_torch/` of the checkout, named by a hash of
the source, every header in `csrc/` and the flags (so an edited shared
header rebuilds every kernel), and the library is loaded with ctypes.  The
compiler's register and shared-memory report is kept beside the library
as `<name>.log`.  Nothing is compiled when this module is imported, and
two sources can build at once (one `nvcc` each, e.g. from two threads).

Each source exports `<stem>_error_string(int)`; the entry points return
the launch's `cudaError_t`, and `CudaLibrary.check` raises on a nonzero
one.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Callable, Optional

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "multimodal_flows_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "--ptxas-options=-v")
DEFAULT_NVCC = "/usr/local/cuda/bin/nvcc"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    if os.path.exists(DEFAULT_NVCC):
        return DEFAULT_NVCC
    raise RuntimeError("nvcc not found: the kernels build only where the CUDA toolkit is")


class CudaLibrary:
    """One `csrc/` source, compiled and loaded at first `load()`.
    `declare(lib)` sets the argtypes of the source's entry points."""

    def __init__(self, source_name: str, declare: Callable[[ctypes.CDLL], None],
                 csrc: Path = CSRC, build_dir: Path = BUILD_DIR):
        self.source = csrc / source_name
        self.stem = self.source.stem
        self.build_dir = build_dir
        self._declare = declare
        self._lib: Optional[ctypes.CDLL] = None
        self._lock = threading.Lock()

    def path(self) -> Path:
        digest = hashlib.sha256(self.source.read_bytes() + " ".join(NVCC_FLAGS).encode())
        for header in sorted(self.source.parent.glob("*.cuh")):
            digest.update(header.name.encode() + b"\0" + header.read_bytes())
        return self.build_dir / f"lib{self.stem}_{digest.hexdigest()[:16]}.so"

    def load(self) -> ctypes.CDLL:
        with self._lock:
            if self._lib is not None:
                return self._lib
            so = self.path()
            if not so.exists():
                nvcc = _nvcc()
                self.build_dir.mkdir(parents=True, exist_ok=True)
                tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
                proc = subprocess.run([nvcc, *NVCC_FLAGS, "-o", str(tmp), str(self.source)],
                                      capture_output=True, text=True)
                if proc.returncode != 0:
                    raise RuntimeError(
                        f"nvcc failed on {self.source}:\n{proc.stdout}{proc.stderr}")
                so.with_suffix(".log").write_text(proc.stdout + proc.stderr)
                os.replace(tmp, so)
            lib = ctypes.CDLL(str(so))
            self._declare(lib)
            err = getattr(lib, f"{self.stem}_error_string")
            err.argtypes = [ctypes.c_int]
            err.restype = ctypes.c_char_p
            self._lib = lib
            return lib

    def check(self, rc: int) -> None:
        """Raise if a launch returned a CUDA error."""
        if rc != 0:
            msg = getattr(self.load(), f"{self.stem}_error_string")(rc).decode()
            raise RuntimeError(f"{self.stem} launch failed: CUDA error {rc} ({msg})")
