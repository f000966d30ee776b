"""Build the hand-written CUDA kernels with nvcc and load them via ctypes.

Each kernel is one ``csrc/*.cu`` file with a plain C entry point. It is
compiled for Hopper (``sm_90a``) at first use into
``idc_models_tpu_torch/_build/`` (listed in ``.gitignore``), under a
name that carries a hash of the source, the shared ``csrc/*.cuh``
headers and the flags, so an edited source or header is rebuilt and an
unchanged one is loaded as it is. Nothing is
built or loaded when a module is imported: the CPU tests import every
module on a machine with no ``nvcc`` and no card.

``build_all`` starts one ``nvcc`` per kernel, all together, and waits
for them; ``CudaKernel.lib()`` builds a single kernel on demand.
``set_build_dir`` points every kernel of the process at another
directory (a shared one, as ``serve/compile_cache.py`` arms it).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from collections.abc import Callable, Iterable
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def set_build_dir(path) -> Path:
    """Build and load every kernel of this process from `path` from now
    on (created if need be). A kernel already loaded keeps its library
    until it is loaded again. Returns the directory."""
    global BUILD_DIR
    BUILD_DIR = Path(path)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    return BUILD_DIR


def find_nvcc() -> str:
    """The CUDA compiler: ``nvcc`` on PATH, else the toolkit's default
    install. Raises when there is none: the kernels cannot exist."""
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels of "
                       "idc_models_tpu_torch are built with the CUDA "
                       "toolkit at first use")


class CudaKernel:
    """One hand-written kernel: its source, its built library, and the
    count of its launches.

    ``launches`` is a plain integer that the kernel's wrapper raises by
    one at each launch and nowhere else, so a run can show that its
    main path went through the kernel. ``declare`` sets ``argtypes`` /
    ``restype`` on the loaded library."""

    def __init__(self, source: str, declare: Callable[[ctypes.CDLL], None]):
        self.source = CSRC / source
        self.name = self.source.stem
        self.launches = 0
        self.build_log = ""
        self._declare = declare
        self._lib: ctypes.CDLL | None = None

    def library_path(self) -> Path:
        digest = hashlib.sha256(self.source.read_bytes())
        for header in sorted(CSRC.glob("*.cuh")):  # what a source includes
            digest.update(header.read_bytes())
        digest.update(" ".join(NVCC_FLAGS).encode())
        return BUILD_DIR / f"lib{self.name}-{digest.hexdigest()[:16]}.so"

    def start_build(self) -> subprocess.Popen | None:
        """Start nvcc if the library is not built yet; None if it is."""
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"kernel {self.name} needs a CUDA card; none is available")
        out = self.library_path()
        if out.exists():
            return None
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        self._tmp = out.with_suffix(f".{os.getpid()}.tmp")
        return subprocess.Popen(
            [find_nvcc(), *NVCC_FLAGS, "-o", str(self._tmp),
             str(self.source)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)

    def finish_build(self, proc: subprocess.Popen | None) -> None:
        if proc is None:
            return
        log, _ = proc.communicate()
        self.build_log = log
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {self.source} "
                               f"(exit {proc.returncode}):\n{log}")
        os.replace(self._tmp, self.library_path())

    def lib(self) -> ctypes.CDLL:
        """The loaded library, built first if need be."""
        if self._lib is None:
            self.finish_build(self.start_build())
            self.install(ctypes.CDLL(str(self.library_path())))
        return self._lib

    def install(self, lib: ctypes.CDLL) -> None:
        """Make `lib` (this kernel's library, loaded) the one its wrapper
        launches."""
        self._declare(lib)
        self._lib = lib


def build_all(kernels: Iterable[CudaKernel]) -> None:
    """Build every kernel in parallel (one nvcc each), then load them."""
    kernels = list(kernels)
    procs = [k.start_build() for k in kernels]
    errors = []
    for k, p in zip(kernels, procs):  # wait for every nvcc, failed or not
        try:
            k.finish_build(p)
        except RuntimeError as e:
            errors.append(str(e))
    if errors:
        raise RuntimeError("\n".join(errors))
    for k in kernels:
        k.lib()
