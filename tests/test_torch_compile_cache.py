"""The port's persistent compile cache (``serve/compile_cache.py``) and
its wiring: `SlotEngine.warmup(compile_cache=)`, `LMServer(compile_cache=)`,
`ServingMetrics.on_compile_cache`, the fleet /healthz block, the `stats`
rollup and ``--compile-cache`` on `serve` and `serve-cluster`.

The JAX package's own compile-cache tests fail on the CPU
(``tests/test_elastic.py``), so JAX is no value oracle here: the port is
held to the contract those tests and the module's docstring state -- a
round trip through a fresh handle, keys that drift with every component,
a corrupt blob evicted and counted as a miss, then rebuilt, and a second
replica against a populated cache hitting with no new store while it
serves the serial Generator's tokens. On the CPU no serving program
launches a hand kernel, so a tiny library built here with ``g++`` goes
through the same store. JAX stays the oracle of the shared surfaces:
the fingerprint's keys, the program plan's names and the metrics keys.
"""

from __future__ import annotations

import contextlib
import ctypes
import io
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from idc_models_tpu import mesh as jmeshlib
from idc_models_tpu import serve as jserve
from idc_models_tpu.models import lm as jlm
from idc_models_tpu_torch import cli, collectives
from idc_models_tpu_torch.models import lm as tlm
from idc_models_tpu_torch.observe import JsonlLogger, MetricsRegistry
from idc_models_tpu_torch.observe import stats as tstats
from idc_models_tpu_torch.ops import build
from idc_models_tpu_torch.serve import (
    CompileCache, LMServer, Request, ServingMetrics,
    enable_persistent_kernel_cache,
)
from idc_models_tpu_torch.serve import compile_cache as cc_mod

VOCAB, E, HEADS, MLP, BLOCKS, T_MAX = 16, 32, 2, 64, 2, 32
KW = dict(embed_dim=E, num_heads=HEADS, num_blocks=BLOCKS, t_max=T_MAX)
_SRC = 'extern "C" int answer(void) { return 42; }\n'


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def build_dir(tmp_path, monkeypatch):
    """A fresh kernel build directory for the test."""
    d = tmp_path / "build"
    d.mkdir()
    monkeypatch.setattr(build, "BUILD_DIR", d)
    return d


def _answer_library(tmp_path, installed):
    """A `Library` that g++ builds into the current build directory (to
    a new file, replaced into place: a loaded library is never written
    over, as ``ops/build.py`` does for nvcc)."""
    src = tmp_path / "answer.cc"
    src.write_text(_SRC)
    path = build.BUILD_DIR / "libanswer-0123456789abcdef.so"

    def make():
        tmp = path.with_suffix(".tmp")
        subprocess.run(["g++", "-shared", "-fPIC", "-o", str(tmp),
                        str(src)], check=True)
        os.replace(tmp, path)

    return cc_mod.Library("answer", path, make, installed.append)


@pytest.fixture(scope="module")
def _params():
    model = jlm.attention_lm(VOCAB, T_MAX, embed_dim=E, num_heads=HEADS,
                             mlp_dim=MLP, num_blocks=BLOCKS)
    params = jax.tree.map(np.array, jax.device_get(
        model.init(jax.random.key(0)).params))
    params["head"]["kernel"] = params["head"]["kernel"] * 8.0
    return params


# -- the store ---------------------------------------------------------------


def test_round_trip_through_a_fresh_handle(tmp_path, build_dir):
    installed = []
    cache = CompileCache(tmp_path / "cc")
    key = cache.key(program="prefill", fingerprint={"t_max": 64})
    assert cache.load(key) is None
    lib = _answer_library(tmp_path, installed)
    prog = cache.compile_and_store(key, [lib], program="prefill")
    assert prog.handles["answer"].answer() == 42 and len(installed) == 1
    assert cache.summary()["stores"] == 1 and cache.compile_s > 0
    # a fresh process: the build directory is empty, the blob places it
    lib.path.unlink()
    fresh = CompileCache(tmp_path / "cc")
    got = fresh.load(key)
    assert got is not None and got.name == "prefill"
    assert got.handles["answer"].answer() == 42
    assert lib.path.exists()
    s = fresh.summary()
    assert (s["hits"], s["misses"], s["stores"], s["evicted_corrupt"]) == (
        1, 0, 0, 0)
    assert set(s) == {"hits", "misses", "stores", "evicted_corrupt",
                      "deserialize_s", "compile_s"}


@pytest.mark.parametrize("drift", ["program", "fingerprint", "torch",
                                   "cuda", "capability"])
def test_key_drifts_with_each_component(tmp_path, monkeypatch, drift):
    cache = CompileCache(tmp_path)
    fp = {"t_max": 64, "window_steps": 8}
    key = cache.key(program="window", fingerprint=fp)
    assert key == CompileCache(tmp_path).key(program="window",
                                             fingerprint=dict(fp))
    if drift == "program":
        other = cache.key(program="insert", fingerprint=fp)
    elif drift == "fingerprint":
        other = cache.key(program="window",
                          fingerprint=dict(fp, window_steps=16))
    else:
        chain = dict(cc_mod.toolchain(), **{drift: "drifted"})
        monkeypatch.setattr(cc_mod, "toolchain", lambda: chain)
        other = cache.key(program="window", fingerprint=fp)
    assert other != key and len(other) == len(key) == 32


@pytest.mark.parametrize("damage", ["truncated", "garbage"])
def test_corrupt_blob_is_evicted_as_a_miss_and_rebuilt(tmp_path, build_dir,
                                                       damage):
    installed = []
    cache = CompileCache(tmp_path / "cc")
    key = cache.key(program="prefill", fingerprint={})
    cache.compile_and_store(key, [_answer_library(tmp_path, installed)],
                            program="prefill")
    blob = cache._file(key)
    data = blob.read_bytes()
    blob.write_bytes(data[:len(data) // 2] if damage == "truncated"
                     else b"\x00" * 64)
    assert cache.load(key) is None
    assert not blob.exists()
    s = cache.summary()
    assert (s["misses"], s["evicted_corrupt"], s["hits"]) == (1, 1, 0)
    # the miss builds and stores again, and the next load hits
    cache.compile_and_store(key, [_answer_library(tmp_path, installed)],
                            program="prefill")
    assert cache.load(key).handles["answer"].answer() == 42
    assert cache.summary()["stores"] == 2


@pytest.mark.parametrize("build_dir_holds", [True, False])
def test_flipped_library_byte_never_reaches_the_build_dir(
        tmp_path, build_dir, build_dir_holds):
    """A blob of the right size with one byte of its library flipped is
    evicted as a miss before anything is placed: a good library in the
    build directory keeps its bytes, an empty directory stays empty, and
    the miss builds the library again (g++ here, nvcc on a card)."""
    cache = CompileCache(tmp_path / "cc")
    key = cache.key(program="prefill", fingerprint={})
    lib = _answer_library(tmp_path, [])
    cache.compile_and_store(key, [lib], program="prefill")
    good = lib.path.read_bytes()
    blob = cache._file(key)
    data = blob.read_bytes()
    at = len(data) - len(good) // 2
    blob.write_bytes(data[:at] + bytes([data[at] ^ 0xFF]) + data[at + 1:])
    if not build_dir_holds:
        lib.path.unlink()
    assert cache.load(key) is None and not blob.exists()
    s = cache.summary()
    assert (s["misses"], s["evicted_corrupt"], s["hits"]) == (1, 1, 0)
    if build_dir_holds:
        assert lib.path.read_bytes() == good
    else:
        assert not lib.path.exists()
    assert sorted(p.name for p in build_dir.iterdir()) == (
        [lib.path.name] if build_dir_holds else [])
    builds = []
    rebuilt = cc_mod.Library(lib.name, lib.path,
                             lambda: (builds.append(1), lib.build()),
                             lib.install)
    cache.compile_and_store(key, [rebuilt], program="prefill")
    assert builds == [1] and lib.path.exists()
    assert cache.load(key).handles["answer"].answer() == 42


def test_truncated_library_fails_ctypes_loading(tmp_path, build_dir):
    """A library cut short inside its headers fails ``ctypes`` loading
    with an error; one cut further on can take the process down inside
    the loader (SIGBUS), which is why `load` checks each library's size
    against the manifest before ``ctypes`` sees it."""
    lib = _answer_library(tmp_path, [])
    lib.build()
    assert ctypes.CDLL(str(lib.path)).answer() == 42
    data = lib.path.read_bytes()
    cut = tmp_path / "libcut.so"
    cut.write_bytes(data[:32])
    with pytest.raises(OSError):
        ctypes.CDLL(str(cut))
    cut.write_bytes(data[:len(data) // 4])
    probe = subprocess.run(
        [sys.executable, "-c", f"import ctypes; ctypes.CDLL({str(cut)!r})"],
        capture_output=True)
    assert probe.returncode != 0


def test_enable_persistent_kernel_cache_moves_every_kernel(tmp_path,
                                                           monkeypatch):
    from idc_models_tpu_torch.ops import flash_block_kernel as fbk

    monkeypatch.setattr(build, "BUILD_DIR", build.BUILD_DIR)
    got = enable_persistent_kernel_cache(tmp_path / "shared")
    assert got == tmp_path / "shared" and got.is_dir()
    assert fbk.FWD_KERNEL.library_path().parent == got


# -- the engine and the server ----------------------------------------------


ENGINES = {"contiguous": {}, "chunked": dict(prefill_chunk=8),
           "paged": dict(prefill_chunk=8, kv_page_size=8, kv_pages=16)}


@pytest.mark.parametrize("kind", list(ENGINES))
def test_warm_replica_hits_with_no_new_store(tmp_path, _params, kind):
    """Two replicas against one cache: the first misses every program
    and stores it, the second hits each with no new store, and both
    serve the serial Generator's tokens."""
    cache = CompileCache(tmp_path / "cc")
    gen = tlm.Generator(_params, device="cpu", cache_dtype=torch.float32,
                        **KW)
    prompt = (1, 5, 2, 7)
    want = gen([list(prompt)], 6)[0, len(prompt):].tolist()
    programs = len(ENGINES[kind] and ["window", "prefill_chunk",
                                      "insert"] or ["window"])
    for replica in range(2):
        server = LMServer(_params, n_slots=2, window=4, device="cpu",
                          cache_dtype=torch.float32, compile_cache=cache,
                          registry=MetricsRegistry(), **ENGINES[kind], **KW)
        server.submit(Request(id="a", prompt=prompt, max_new_tokens=6))
        server.drain()
        assert server.poll("a").tokens == want
        s = cache.summary()
        if replica == 0:
            assert (s["misses"], s["stores"], s["hits"]) == (
                programs, programs, 0)
        else:
            assert (s["hits"], s["stores"]) == (programs, programs)
        assert server.summary()["serve_compile_cache"] == s


def test_cache_plan_and_fingerprint_follow_the_jax_engine(_params):
    """The programs JAX's `_warm_aot` covers and its fingerprint's keys,
    on the same configurations (the port adds the card's name and
    compute capability)."""
    from idc_models_tpu.serve.engine import SlotEngine as JSlotEngine
    from idc_models_tpu_torch.serve import SlotEngine

    for kw in ENGINES.values():
        jeng = JSlotEngine(_params, n_slots=2, mesh=jmeshlib.seq_mesh(1),
                           cache_dtype=jnp.float32, **kw, **KW)
        eng = SlotEngine(_params, n_slots=2, device="cpu",
                         cache_dtype=torch.float32, **kw, **KW)
        want = set(jeng.cache_fingerprint())
        got = set(eng.cache_fingerprint())
        assert want <= got and got - want == {"device_name", "capability"}
        names = [name for name, kernels in eng._cache_plan()]
        assert names == (["window", "prefill_chunk", "insert"] if kw
                         else ["window"])
        assert all(not kernels for _, kernels in eng._cache_plan())
        fp = eng.cache_fingerprint()
        assert fp["devices"] == [f"cpu@{collectives.axis_index()}"]
        assert fp["mesh_axes"] == {"seq": 1}


def test_metrics_gauges_and_summary_key_as_jax(tmp_path):
    """`on_compile_cache`: the three gauges registered on first call
    only, the summary key, the event record; the JAX metrics' keys."""
    from idc_models_tpu.observe import MetricsRegistry as JRegistry

    reg = MetricsRegistry()
    m = ServingMetrics(None, registry=reg)
    assert "serve_compile_cache" not in m.summary()
    assert "serve_compile_cache_hits" not in reg.prometheus_text()
    cache = CompileCache(tmp_path / "cc")
    cache.load(cache.key(program="window", fingerprint={}))
    m.on_compile_cache(cache)
    text = reg.prometheus_text()
    for g in ("serve_compile_cache_hits", "serve_compile_cache_misses",
              "serve_compile_cache_deserialize_seconds"):
        assert g in text
    assert m.summary()["serve_compile_cache"] == cache.summary()

    class _Summary:
        def summary(self):
            return cache.summary()

    jm = jserve.ServingMetrics(None, registry=JRegistry())
    jm.on_compile_cache(_Summary())
    assert (set(jm.summary()) ^ set(m.summary())) <= set(
        m.summary()) - {"serve_compile_cache"}
    assert jm.summary()["serve_compile_cache"] == m.summary()[
        "serve_compile_cache"]


def test_stats_rolls_up_the_cache_events(tmp_path, build_dir):
    log = tmp_path / "run.jsonl"
    logger = JsonlLogger(log)
    cache = CompileCache(tmp_path / "cc", logger=logger)
    key = cache.key(program="prefill", fingerprint={})
    assert cache.load(key) is None
    cache.compile_and_store(key, [_answer_library(tmp_path, [])])
    cache.load(key)
    logger.close()
    s = tstats.summarize_jsonl(log)
    assert (s["compile_cache"]["hits"], s["compile_cache"]["misses"],
            s["compile_cache"]["stores"]) == (1, 1, 1)
    assert "compile cache: 1 hit(s)" in tstats.format_summary(s)


# -- the verbs ---------------------------------------------------------------


def _lines(argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert cli.main(argv) == 0
    return out.getvalue().splitlines()


def test_serve_verb_second_run_hits(tmp_path):
    argv = ["serve", "--device", "cpu", "--requests", "3", "--slots", "2",
            "--window", "4", "--t-max", "32", "--compile-cache",
            str(tmp_path / "cc")]
    first = [ln for ln in _lines(argv) if ln.startswith("compile cache: ")]
    second = [ln for ln in _lines(argv) if ln.startswith("compile cache: ")]
    assert first and first[0].startswith("compile cache: 0 hit(s) (")
    assert "1 miss(es) -> 1 store(s)" in first[0]
    assert second and second[0].startswith("compile cache: 1 hit(s) (")
    assert "0 miss(es) -> 0 store(s)" in second[0]
    assert second[0].endswith("0 corrupt eviction(s)")


def test_serve_cluster_replicas_share_the_cache(tmp_path):
    """Every replica of the fleet spins up against one cache: the first
    stores, the rest hit; the fleet /healthz carries the counters."""
    from idc_models_tpu_torch.serve import ClusterTelemetry, Router
    from idc_models_tpu_torch.serve.cluster import build_replica

    argv = ["serve-cluster", "--device", "cpu", "--vocab", "11",
            "--t-max", "32", "--embed-dim", "32", "--num-heads", "2",
            "--mlp-dim", "64", "--num-blocks", "1", "--slots", "2",
            "--window", "4", "--requests", "4", "--replicas", "2",
            "--compile-cache", str(tmp_path / "cc")]
    line = [ln for ln in _lines(argv) if ln.startswith("compile cache: ")]
    assert line and line[0].startswith("compile cache: 1 hit(s) (")
    assert "1 miss(es) -> 1 store(s)" in line[0]
    cache = CompileCache(tmp_path / "fleet")
    params = jax.tree.map(np.array, jax.device_get(jlm.attention_lm(
        11, 32, embed_dim=32, num_heads=2, mlp_dim=64,
        num_blocks=1).init(jax.random.key(0)).params))
    reps = [build_replica(params, replica_id=f"r{i}", device="cpu",
                          embed_dim=32, num_heads=2, num_blocks=1,
                          t_max=32, n_slots=2, window=4,
                          compile_cache=cache) for i in range(2)]
    health = ClusterTelemetry(Router(reps), compile_cache=cache).health()
    assert health["compile_cache"] == {"hits": 1, "misses": 1,
                                       "stores": 1}


def test_the_flag_parses_for_both_verbs():
    from idc_models_tpu_torch.cli import _parse

    for verb in ("serve", "serve-cluster"):
        assert _parse([verb, "--compile-cache", "/x"]).compile_cache == "/x"
    assert not hasattr(cli, "_LATER")


def test_a_kernel_that_fails_to_build_fails_the_miss(tmp_path, build_dir):
    """Not a fallback: after an eviction the library is built again, and
    a build that fails raises instead of handing the work elsewhere."""
    def broken():
        raise RuntimeError("nvcc failed")

    lib = cc_mod.Library("answer", build_dir / "libx.so", broken,
                         lambda h: None)
    cache = CompileCache(tmp_path / "cc")
    key = cache.key(program="prefill", fingerprint={})
    with pytest.raises(RuntimeError, match="nvcc failed"):
        cache.compile_and_store(key, [lib])
    assert not cache._file(key).exists()
    assert cache.summary()["stores"] == 0
