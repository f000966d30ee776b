"""The port's FileStream (idc_models_tpu_torch/data/pipeline.py) against
the JAX package's and against the port's own Loader: the same files,
the same seed, bit-identical batch streams; the multi-process decode
equals the in-process one; fit on a stream equals fit on the
materialized set (tests/test_data.py)."""

from __future__ import annotations

import numpy as np
import pytest
import torch
from PIL import Image

from idc_models_tpu.data import idc as jidc
from idc_models_tpu.data import pipeline as jpipeline
from idc_models_tpu_torch.data import idc as tidc
from idc_models_tpu_torch.data import native as tnative
from idc_models_tpu_torch.data import pipeline as tpipeline
from idc_models_tpu_torch.models import core as tcore
from idc_models_tpu_torch.models.small_cnn import small_cnn
from idc_models_tpu_torch.train import loop as tloop
from idc_models_tpu_torch.train import state as tstate
from idc_models_tpu_torch.train.losses import binary_cross_entropy

BACKENDS = ["pil"] + (["native"] if tnative.available() else [])


@pytest.fixture(scope="module")
def png_tree(tmp_path_factory):
    """A tiny <root>/<label>/*.png tree with recoverable labels."""
    root = tmp_path_factory.mktemp("idc")
    rng = np.random.default_rng(0)
    for label in (0, 1):
        d = root / str(label)
        d.mkdir()
        for i in range(12):
            arr = (rng.random((50, 50, 3)) * 100 + label * 120).astype(
                np.uint8)
            Image.fromarray(arr).save(d / f"p{i}.png")
    return root


@pytest.mark.parametrize("backend", BACKENDS)
def test_stream_equals_jax_stream_and_the_loader(png_tree, backend):
    pairs = tidc.list_labeled_files(png_tree)
    assert pairs == jidc.list_labeled_files(png_tree)
    stream = tpipeline.FileStream(pairs, 50, 8, seed=3, repeat=2,
                                  backend=backend)
    jstream = jpipeline.FileStream(pairs, 50, 8, seed=3, repeat=2,
                                   backend=backend)
    labels = np.asarray([l for _, l in pairs], np.int32)
    ds = tidc.ArrayDataset(tidc.decode_pairs(pairs, 50, backend=backend),
                           labels)
    loader = tpipeline.Loader(ds, 8, seed=3, repeat=2)
    assert len(stream) == len(jstream) == len(loader) == 6
    for epoch in (0, 1):
        for (sx, sy), (jx, jy), (lx, ly) in zip(
                stream.epoch(epoch), jstream.epoch(epoch),
                loader.epoch(epoch), strict=True):
            np.testing.assert_array_equal(sx, jx)
            np.testing.assert_array_equal(sx, lx)
            np.testing.assert_array_equal(sy, jy)
            np.testing.assert_array_equal(sy, ly)
    stream.close()
    jstream.close()


def test_stream_validates_as_the_jax_stream(png_tree):
    pairs = tidc.list_labeled_files(png_tree)
    stream = tpipeline.FileStream(pairs, 50, 8, seed=3)
    with pytest.raises(ValueError, match="non-empty"):
        tpipeline.FileStream([], 50, 8)
    with pytest.raises(ValueError, match="repeat"):
        stream.replace(repeat=0)
    with pytest.raises(ValueError, match="batch_size"):
        stream.replace(batch_size=0)
    with pytest.raises(ValueError, match="zero batches"):
        stream.replace(batch_size=100)
    with pytest.raises(AttributeError):
        stream.replace(nope=1)
    stream.close()          # idempotent, even with no pool started
    stream.close()


def test_decode_workers_equal_the_in_process_stream(png_tree):
    """Two spawned decode workers give the in-process stream bit for bit,
    across epochs, repeat passes and replace() copies (which share the
    worker pool)."""
    pairs = tidc.list_labeled_files(png_tree)
    base = tpipeline.FileStream(pairs, 50, 8, seed=3, repeat=2)
    fanout = tpipeline.FileStream(pairs, 50, 8, seed=3, repeat=2,
                                  decode_workers=2)
    try:
        for ep in (0, 1):
            for (sx, sy), (fx, fy) in zip(base.epoch(ep), fanout.epoch(ep),
                                          strict=True):
                np.testing.assert_array_equal(fx, sx)
                np.testing.assert_array_equal(fy, sy)
        half, halfb = fanout.replace(batch_size=4), base.replace(batch_size=4)
        for (sx, _), (fx, _) in zip(halfb.epoch(0), half.epoch(0),
                                    strict=True):
            np.testing.assert_array_equal(fx, sx)
        assert half._proc_box is fanout._proc_box
    finally:
        fanout.close()
        fanout.close()


def test_fit_on_a_stream_equals_fit_on_the_materialized_set(png_tree):
    """fit imposes its own schedule on the stream (seed 5 over the
    stream's 0), so both sources train on the same batches: bit-equal
    losses and parameters on the CPU."""
    pairs = tidc.list_labeled_files(png_tree)
    labels = np.asarray([l for _, l in pairs], np.int32)
    ds = tidc.ArrayDataset(tidc.decode_pairs(pairs, 10), labels)

    def run(source):
        model = tcore.init_params(small_cnn(10, 3, 1), 0)
        tcore.use_generator(model, torch.Generator().manual_seed(1))
        state = tstate.TrainState(model, tstate.rmsprop(model, 1e-3))
        hist = tloop.fit(state, binary_cross_entropy, source, None,
                         epochs=2, batch_size=8, seed=5, verbose=False)
        return hist["loss"], [p.detach().clone()
                              for p in model.parameters()]

    l_mat, p_mat = run(ds)
    stream = tpipeline.FileStream(pairs, 10, 8, seed=0)
    l_str, p_str = run(stream)
    stream.close()
    assert l_str == l_mat
    for a, b in zip(p_str, p_mat, strict=True):
        assert torch.equal(a, b)
