"""ctypes binding for the native (C++/libpng) image loader, as
``idc_models_tpu/data/native/__init__.py``.

Lazily builds this package's own ``loader.cpp`` with ``g++`` into
``idc_models_tpu_torch/_build/native_loader.so`` the first time it is
needed (and whenever the source is newer), then exposes

    decode_batch(paths, size, threads=0) -> np.ndarray [n, size, size, 3]

`available()` reports whether the native path can be used (it needs
``g++`` and libpng's headers where it is built); callers fall back to
the PIL thread pool (``data/idc.py``) when it cannot. numpy only: spawned
decode workers import this module and never torch.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
import warnings
from pathlib import Path

import numpy as np

_SRC = Path(__file__).resolve().parent / "loader.cpp"
_SO = Path(__file__).resolve().parents[2] / "_build" / "native_loader.so"
_ABI = 2

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_build_error: str | None = None


def _build() -> None:
    """Compile to a per-process temp file and atomically rename into
    place: never truncate a .so another process may have mapped, and
    two processes building at once (decode workers sharing a checkout)
    cannot corrupt each other's half-written output."""
    _SO.parent.mkdir(parents=True, exist_ok=True)
    tmp = _SO.with_name(f"{_SO.name}.{os.getpid()}.tmp")
    try:
        subprocess.run(
            ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", str(_SRC),
             "-lpng", "-lz", "-lpthread", "-o", str(tmp)],
            check=True, capture_output=True, text=True)
        os.replace(tmp, _SO)
    finally:
        tmp.unlink(missing_ok=True)


def _open_checked() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(_SO))
    try:
        abi = lib.idc_loader_abi_version()
    except AttributeError:
        _dlclose(lib)
        raise OSError("native loader predates the ABI-version export")
    if abi != _ABI:
        # dlclose before raising: dlopen caches by pathname, so a kept
        # handle would shadow the rebuilt binary on the retry
        _dlclose(lib)
        raise OSError(f"native loader ABI {abi} != expected {_ABI}")
    return lib


def _dlclose(lib: ctypes.CDLL) -> None:
    import _ctypes

    try:
        _ctypes.dlclose(lib._handle)
    except OSError:
        pass


def _load() -> ctypes.CDLL | None:
    global _lib, _build_error
    with _lock:
        if _lib is not None or _build_error is not None:
            return _lib
        try:
            if not _SO.exists() or _SO.stat().st_mtime < _SRC.stat().st_mtime:
                _build()
            try:
                lib = _open_checked()
            except (OSError, AttributeError):
                # a stale binary that escaped the mtime test (coarse
                # timestamps, copied checkouts): rebuild from the source
                _build()
                lib = _open_checked()
            lib.idc_decode_batch.argtypes = [
                ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
                ctypes.POINTER(ctypes.c_float), ctypes.c_int,
                ctypes.POINTER(ctypes.c_uint8),
            ]
            lib.idc_decode_batch.restype = ctypes.c_int
            _lib = lib
        except (OSError, subprocess.CalledProcessError, AttributeError) as e:
            detail = getattr(e, "stderr", "") or str(e)
            _build_error = f"native loader unavailable: {detail}"
        return _lib


def available() -> bool:
    return _load() is not None


def build_error() -> str | None:
    _load()
    return _build_error


def decode_batch(paths: list[str], size: int, *,
                 threads: int = 0, on_error: str = "raise") -> np.ndarray:
    """Decode PNGs to a float32 [n, size, size, 3] batch in [0, 1].

    `on_error="raise"` (default) raises ValueError naming the files that
    failed to decode, as the PIL backend does, so ``backend="auto"``
    cannot silently train on zero images with real labels attached.
    `on_error="zero"` leaves failed slots as zero images, with a warning;
    an input that fails entirely raises even then."""
    if on_error not in ("raise", "zero"):
        raise ValueError(f"on_error must be raise|zero, got {on_error!r}")
    lib = _load()
    if lib is None:
        raise RuntimeError(_build_error or "native loader unavailable")
    n = len(paths)
    out = np.empty((n, size, size, 3), np.float32)
    if n == 0:
        return out
    arr = (ctypes.c_char_p * n)(*[os.fsencode(p) for p in paths])
    status = np.empty(n, np.uint8)
    failures = lib.idc_decode_batch(
        arr, n, size, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        threads, status.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    if failures:
        bad = [paths[i] for i in np.flatnonzero(status == 0)]
        if on_error == "raise" or failures >= n:
            shown = ", ".join(bad[:5])
            more = f" (+{len(bad) - 5} more)" if len(bad) > 5 else ""
            raise ValueError(
                f"{failures}/{n} files failed to decode: {shown}{more}")
        warnings.warn(f"{failures}/{n} files failed to decode; their "
                      f"slots are zero images", stacklevel=2)
    return out
