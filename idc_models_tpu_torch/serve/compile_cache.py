"""Persistent compiled-kernel cache -- warm replica spin-up, the
counterpart of ``idc_models_tpu/serve/compile_cache.py``.

Eager PyTorch builds no executable to serialize: what a cold replica of
the port compiles before it serves is the device code of the kernels
its programs launch -- the ``sm_90a`` libraries ``ops/build.py`` builds
with ``nvcc``. `SlotEngine.warmup(compile_cache=)` looks each serving
program up here, and a blob holds the program's manifest and the built
libraries of the hand kernels it launches (a program that launches none
stores its manifest alone); the next replica with the SAME key places
those libraries and ``ctypes``-loads them in milliseconds instead of
running ``nvcc``.

The key is everything a library is valid for, nothing more:

- the program name and the content digest of each kernel it launches
  (the one ``CudaKernel.library_path`` names its library by: sources,
  headers and flags, the ``sm_90a`` target among them);
- the torch and CUDA versions and the card's compute capability -- a
  toolchain bump keys every entry out, no sweeper needed.

A library depends on nothing else, so replicas on other cards, other
ranks or other serving configurations share a blob.

``ops/build.py``'s build directory is itself persistent and named by
the same digests: a replica whose build directory already holds a
library never runs ``nvcc``, with or without this cache. The cache is
what a replica with an empty build directory (a fresh machine or
container) spins up from.

Entries are one file per key, written atomically (tmp + ``os.replace``)
so a concurrently spinning-up replica never reads a torn blob. A blob
that fails to load (truncated on disk, a library whose bytes do not
match the digest the manifest recorded, one ``ctypes`` cannot load) is
EVICTED and counted as a miss: that handler is the module's one
deliberate swallow. A blob's library is checked and loaded under a
temporary name before it takes its place in the build directory, so a
bad blob never overwrites or leaves a library there. The miss then
builds the libraries with ``nvcc`` and stores them again; a build or
launch that fails after that fails the run (nothing falls back to a
plain version).

`enable_persistent_kernel_cache` points ``ops/build.py``'s build
directory at a shared one for every kernel in the process (training
kernels included): the counterpart of JAX's persistent XLA cache.

Counters (hits, misses, stores, evictions, load and build seconds) feed
the ``serve_compile_cache_*`` gauges (``serve/metrics.py``) and the
``stats`` verb's rollup.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import json
import os
import struct
import time
from collections.abc import Callable
from pathlib import Path

import torch

from idc_models_tpu_torch.ops import build

SCHEMA = 1
_MAGIC = b"IDCK"


def enable_persistent_kernel_cache(path) -> Path:
    """Build and load every kernel of the process under `path` (a
    directory replicas share): ``ops/build.set_build_dir``. Returns the
    directory. Idempotent; safe to call before any engine exists."""
    return build.set_build_dir(path)


def toolchain() -> dict:
    """The torch and CUDA versions and the card's compute capability
    (None on a machine without a card) a library was built against."""
    cap = None
    if torch.cuda.is_available():
        cap = "%d.%d" % torch.cuda.get_device_capability()
    return {"torch": torch.__version__, "cuda": torch.version.cuda,
            "capability": cap}


@dataclasses.dataclass
class Library:
    """One shared library a program launches: its name, the file it is
    built to (its name carries the content digest), how to build it
    there and what takes the loaded handle."""

    name: str
    path: Path
    build: Callable[[], None]
    install: Callable[[ctypes.CDLL], None]


def kernel_library(kernel) -> Library:
    """A hand kernel (``ops/build.CudaKernel``) as a `Library`: built by
    ``nvcc`` into the current build directory, installed as the library
    its wrapper launches."""
    return Library(kernel.name, kernel.library_path(),
                   lambda: kernel.finish_build(kernel.start_build()),
                   kernel.install)


@dataclasses.dataclass
class Program:
    """A loaded program: its name and the ``ctypes`` handle of each of
    its libraries, by name."""

    name: str
    handles: dict


class CompileCache:
    """On-disk store of built kernel libraries, one blob per key.

    `key()` hashes the validity fingerprint; `load()` places and loads a
    program's libraries (hit) or returns None (miss); `compile_and_store`
    finishes a miss by building them and persisting the blob. All
    counters are cumulative for the life of this handle: `summary()` is
    what metrics and the verbs read."""

    def __init__(self, path, *, logger=None):
        self.path = Path(path)
        self.path.mkdir(parents=True, exist_ok=True)
        self.logger = logger
        self.hits = 0
        self.misses = 0
        self.stores = 0
        self.evicted_corrupt = 0
        self.deserialize_s = 0.0
        self.compile_s = 0.0

    def _log(self, **kw) -> None:
        if self.logger is not None:
            self.logger.log(**kw)

    def key(self, *, program: str, fingerprint: dict) -> str:
        """Content address of one program's libraries: program name +
        `fingerprint` (what the libraries depend on; the engine passes
        its kernels' digests) + toolchain. Any drift in any component is
        a different key: invalidation IS the key."""
        material = {"schema": SCHEMA, **toolchain(), "program": program,
                    "fingerprint": fingerprint}
        blob = json.dumps(material, sort_keys=True, default=str)
        return hashlib.sha256(blob.encode()).hexdigest()[:32]

    def _file(self, key: str) -> Path:
        return self.path / f"{key}.torchexe"

    def load(self, key: str) -> Program | None:
        """The program stored under `key` with its libraries placed in
        the build directory and loaded, or None on a miss. A blob that
        exists but cannot load (a torn or truncated file, a library
        whose bytes differ from its recorded digest or that ``ctypes``
        refuses) is evicted and reported as a miss, with nothing of it
        left in the build directory: spin-up then builds for real and
        the rebuilt entry replaces it."""
        f = self._file(key)
        if not f.exists():
            self.misses += 1
            self._log(event="compile_cache", outcome="miss", key=key)
            return None
        t0 = time.perf_counter()
        try:
            program = _unpack(f.read_bytes())
        except Exception as e:
            f.unlink(missing_ok=True)
            self.evicted_corrupt += 1
            self.misses += 1
            self._log(event="compile_cache", outcome="evict_corrupt",
                      key=key, error=f"{type(e).__name__}: {e}")
            return None
        dt = time.perf_counter() - t0
        self.deserialize_s += dt
        self.hits += 1
        self._log(event="compile_cache", outcome="hit", key=key,
                  deserialize_ms=round(dt * 1e3, 3))
        return program

    def compile_and_store(self, key: str, libraries, *,
                          program: str = "") -> Program:
        """Finish a miss: build each of `libraries` (`Library`; ``nvcc``
        for a kernel), install its handle, and persist the blob
        atomically (tmp + ``os.replace``: a reader sees the old complete
        file or the new one, never a torn one). The build seconds count
        as `compile_s`. A build that fails raises."""
        libraries = list(libraries)
        t0 = time.perf_counter()
        for lib in libraries:
            lib.build()
        dt = time.perf_counter() - t0
        self.compile_s += dt
        handles = {}
        for lib in libraries:
            handles[lib.name] = ctypes.CDLL(str(lib.path))
            lib.install(handles[lib.name])
        f = self._file(key)
        tmp = f.with_name(f.name + f".tmp{os.getpid()}")
        tmp.write_bytes(_pack(program, libraries))
        os.replace(tmp, f)
        self.stores += 1
        self._log(event="compile_cache", outcome="store", key=key,
                  compile_ms=round(dt * 1e3, 3), bytes=f.stat().st_size)
        return Program(program, handles)

    def summary(self) -> dict:
        """The frozen-schema rollup metrics and the verbs read."""
        return {
            "hits": self.hits,
            "misses": self.misses,
            "stores": self.stores,
            "evicted_corrupt": self.evicted_corrupt,
            "deserialize_s": round(self.deserialize_s, 6),
            "compile_s": round(self.compile_s, 6),
        }


def _pack(program: str, libraries) -> bytes:
    """A blob: magic, the JSON manifest's length and the manifest (the
    program, each library's name, file name, size and sha256), then the
    libraries' bytes in manifest order."""
    datas = [Path(lib.path).read_bytes() for lib in libraries]
    manifest = json.dumps({
        "schema": SCHEMA, "program": program,
        "libraries": [{"name": lib.name, "file": Path(lib.path).name,
                       "size": len(d),
                       "sha256": hashlib.sha256(d).hexdigest()}
                      for lib, d in zip(libraries, datas)]}).encode()
    return (_MAGIC + struct.pack("<Q", len(manifest)) + manifest
            + b"".join(datas))


def _unpack(blob: bytes) -> Program:
    """Check every library of a blob against its recorded size and
    digest, then load each: the build directory's own file where it has
    one, else the blob's bytes under a temporary name, moved into place
    only once ``ctypes`` has loaded them. Raises on any torn, truncated,
    altered or unloadable part, and leaves nothing of it behind."""
    if blob[:4] != _MAGIC:
        raise ValueError("not a kernel-cache blob")
    (n,) = struct.unpack("<Q", blob[4:12])
    manifest = json.loads(blob[12:12 + n])
    if manifest.get("schema") != SCHEMA:
        raise ValueError(f"blob schema {manifest.get('schema')} != {SCHEMA}")
    off = 12 + n
    datas = []
    for entry in manifest["libraries"]:
        data = blob[off:off + entry["size"]]
        off += entry["size"]
        if len(data) != entry["size"]:
            raise ValueError(f"library {entry['name']} truncated: "
                             f"{len(data)} of {entry['size']} bytes")
        if hashlib.sha256(data).hexdigest() != entry["sha256"]:
            raise ValueError(f"library {entry['name']} does not match "
                             "its recorded digest")
        datas.append(data)
    if off != len(blob):
        raise ValueError(f"blob holds {len(blob) - off} trailing bytes")
    handles = {}
    for entry, data in zip(manifest["libraries"], datas):
        dest = build.BUILD_DIR / entry["file"]
        if dest.exists():
            handles[entry["name"]] = ctypes.CDLL(str(dest))
            continue
        build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = dest.with_name(dest.name + f".tmp{os.getpid()}")
        tmp.write_bytes(data)
        try:
            handles[entry["name"]] = ctypes.CDLL(str(tmp))
            os.replace(tmp, dest)
        finally:
            tmp.unlink(missing_ok=True)
    return Program(manifest["program"], handles)
