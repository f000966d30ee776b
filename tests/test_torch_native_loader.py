"""The port's native (C++/libpng) loader, idc_models_tpu_torch/data/
native, against the JAX package's: the same PNG files decode to
bit-identical arrays, and the same failures raise alike
(tests/test_native_loader.py)."""

from __future__ import annotations

import os
import shutil
import subprocess

import numpy as np
import pytest
from PIL import Image

from idc_models_tpu.data import idc as jidc
from idc_models_tpu.data import native as jnative
from idc_models_tpu_torch.data import idc as tidc
from idc_models_tpu_torch.data import native as tnative

pytestmark = pytest.mark.skipif(
    not (tnative.available() and jnative.available()),
    reason=f"native loader unavailable: {tnative.build_error()}")


def _write_pngs(root, n_per_class=4, size=50, seed=0, mode="RGB"):
    rng = np.random.default_rng(seed)
    for label in ("0", "1"):
        d = root / label
        d.mkdir(parents=True, exist_ok=True)
        for i in range(n_per_class):
            arr = rng.integers(0, 256, (size, size, 3), np.uint8)
            Image.fromarray(arr, "RGB").convert(mode).save(d / f"p{i}.png")
    return sorted(str(p) for p in root.glob("*/*.png"))


def _both(files, size, **kw):
    got = tnative.decode_batch(files, size, **kw)
    want = jnative.decode_batch(files, size, **kw)
    np.testing.assert_array_equal(got, want)
    return got


def test_decode_matches_jax_and_pil_no_resize(tmp_path):
    files = _write_pngs(tmp_path, size=50)
    got = _both(files, 50)
    assert got.shape == (len(files), 50, 50, 3) and got.dtype == np.float32
    for i, f in enumerate(files):
        ref = np.asarray(Image.open(f).convert("RGB"), np.float32) / 255.0
        np.testing.assert_array_equal(got[i], ref)


@pytest.mark.parametrize("mode", ["L", "P"])
def test_decode_grayscale_and_palette(tmp_path, mode):
    files = _write_pngs(tmp_path, n_per_class=2, size=20, mode=mode)
    got = _both(files, 20)
    for i, f in enumerate(files):
        ref = np.asarray(Image.open(f).convert("RGB"), np.float32) / 255.0
        np.testing.assert_allclose(got[i], ref, atol=1 / 255.0)


def test_resize_matches_jax_and_the_python_backend(tmp_path):
    """The native resize is the same half-pixel bilinear as the PIL
    backend's numpy resize, within 1e-5 (the JAX package's bound), and
    bit-identical to the JAX package's native loader."""
    files = _write_pngs(tmp_path, n_per_class=2, size=50)
    got = _both(files, 10)
    assert got.shape[1:] == (10, 10, 3)
    for i, f in enumerate(files):
        np.testing.assert_allclose(got[i], tidc._decode_one(f, 10),
                                   atol=1e-5)


def _with_bad(tmp_path):
    _write_pngs(tmp_path, n_per_class=1, size=10)
    bad = tmp_path / "0" / "bad.png"
    bad.write_bytes(b"not a png")
    return bad, sorted(str(p) for p in tmp_path.glob("*/*.png"))


def test_bad_file_raises_naming_the_file(tmp_path):
    _, files = _with_bad(tmp_path)
    msgs = []
    for mod in (tnative, jnative):
        with pytest.raises(ValueError, match="bad.png") as e:
            mod.decode_batch(files, 10)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_bad_file_zeroed_when_opted_in(tmp_path):
    bad, files = _with_bad(tmp_path)
    with pytest.warns(UserWarning, match="failed to decode"):
        got = tnative.decode_batch(files, 10, on_error="zero")
    with pytest.warns(UserWarning, match="failed to decode"):
        want = jnative.decode_batch(files, 10, on_error="zero")
    np.testing.assert_array_equal(got, want)
    i_bad = files.index(str(bad))
    np.testing.assert_array_equal(got[i_bad], 0.0)
    assert got[(i_bad + 1) % len(files)].max() > 0


def test_all_bad_raises(tmp_path):
    bad = tmp_path / "b.png"
    bad.write_bytes(b"nope")
    for mod in (tnative, jnative):
        with pytest.raises(ValueError):
            mod.decode_batch([str(bad)], 10)
        with pytest.raises(ValueError, match="failed to decode"):
            mod.decode_batch([str(bad)], 10, on_error="zero")
        with pytest.raises(ValueError, match="on_error"):
            mod.decode_batch([str(bad)], 10, on_error="ignore")


def test_stale_abi_binary_triggers_rebuild(tmp_path, monkeypatch):
    """A wrong-ABI binary that escapes the mtime test is rebuilt from
    the port's own source, not cached as a permanent failure."""
    src = tmp_path / "loader.cpp"
    so = tmp_path / "native_loader.so"
    shutil.copy(tnative._SRC, src)
    stub = tmp_path / "stub.cpp"
    stub.write_text('extern "C" int idc_loader_abi_version() { return 0; }')
    subprocess.run(["g++", "-O3", "-shared", "-fPIC", str(stub),
                    "-o", str(so)], check=True)
    future = os.stat(src).st_mtime + 10_000
    os.utime(so, (future, future))
    monkeypatch.setattr(tnative, "_SRC", src)
    monkeypatch.setattr(tnative, "_SO", so)
    monkeypatch.setattr(tnative, "_lib", None)
    monkeypatch.setattr(tnative, "_build_error", None)
    assert tnative.available(), tnative.build_error()
    assert tnative._lib.idc_loader_abi_version() == tnative._ABI


def test_load_directory_native_equals_pil_and_jax(tmp_path):
    _write_pngs(tmp_path, n_per_class=3, size=12)
    ds_nat = tidc.load_directory(tmp_path, image_size=12, seed=7,
                                 backend="native")
    ds_pil = tidc.load_directory(tmp_path, image_size=12, seed=7,
                                 backend="pil")
    ds_jax = jidc.load_directory(tmp_path, image_size=12, seed=7,
                                 backend="native")
    for ds in (ds_pil, ds_jax):
        np.testing.assert_array_equal(ds_nat.labels, ds.labels)
        np.testing.assert_array_equal(ds_nat.images, ds.images)
    with pytest.raises(ValueError, match="backend"):
        tidc.decode_pairs([("x", 0)], 12, backend="gpu")
