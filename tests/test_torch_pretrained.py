"""The port's Keras h5 loader (models/pretrained.py) against the JAX
package's, on h5 files the tests write themselves (no real ImageNet
weights are in the repository)."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from idc_models_tpu.models import pretrained as jpretrained
from idc_models_tpu.models import vgg as jvgg
from idc_models_tpu_torch import convert
from idc_models_tpu_torch.models import core as tcore
from idc_models_tpu_torch.models import pretrained as tpretrained
from idc_models_tpu_torch.models import vgg as tvgg

h5py = pytest.importorskip("h5py")


def _write_keras_h5(path, layers, *, wrapped=False):
    """A Keras `save_weights` layout: one group per layer whose
    `weight_names` attribute lists "<layer>/<variable>:0" datasets."""
    with h5py.File(path, "w") as f:
        root = f.create_group("model_weights") if wrapped else f
        for layer, weights in layers.items():
            g = root.create_group(layer)
            g.attrs["weight_names"] = [f"{layer}/{w}".encode()
                                       for w in weights]
            for w, arr in weights.items():
                g.create_dataset(f"{layer}/{w}", data=arr)


def _r(rng, *shape):
    return rng.normal(0, 0.1, shape).astype(np.float32)


@pytest.mark.parametrize("wrapped", [False, True])
@pytest.mark.parametrize("suffix", [".h5", ".hdf5"])
def test_load_keras_h5_matches_jax(tmp_path, wrapped, suffix):
    """Conv kernels as they are, depthwise kernels (kh, kw, C, 1) ->
    (kh, kw, 1, C) (by variable name and by layer name), BN gamma/beta to
    params and moving statistics to state, unknown variables skipped."""
    rng = np.random.default_rng(0)
    path = tmp_path / f"weights{suffix}"
    _write_keras_h5(path, {
        "Conv1": {"kernel:0": _r(rng, 3, 3, 3, 8)},
        "expanded_conv_depthwise": {"depthwise_kernel:0": _r(rng, 3, 3, 8, 1)},
        "block_1_depthwise": {"kernel:0": _r(rng, 3, 3, 16, 1)},
        "bn_Conv1": {"gamma:0": _r(rng, 8), "beta:0": _r(rng, 8),
                     "moving_mean:0": _r(rng, 8),
                     "moving_variance:0": _r(rng, 8) + 1.0},
        "fc": {"kernel:0": _r(rng, 8, 2), "bias:0": _r(rng, 2),
               "optimizer_slot:0": _r(rng, 2)},
    }, wrapped=wrapped)
    got = tpretrained.load_pretrained_file(path)
    want = jpretrained.load_pretrained_file(path)
    assert got[1] and got[0]["block_1_depthwise"]["kernel"].shape == (
        3, 3, 1, 16)
    for g, w in zip(got, want):
        fg, fw = convert.flatten(g), convert.flatten(w)
        assert set(fg) == set(fw)
        for k in fw:
            np.testing.assert_array_equal(fg[k], fw[k], err_msg=k)


def test_vgg16_from_keras_h5_gives_the_jax_logits(tmp_path):
    """A VGG16 backbone written as Keras h5 goes through both packages'
    --pretrained-weights loaders; the port's model then holds those
    weights and gives the JAX model's logits."""
    rng = np.random.default_rng(1)
    model = tcore.init_params(tvgg.vgg16(1), 3)
    params, state = convert.to_jax(model)
    layers = {name: {"kernel:0": _r(rng, *v["kernel"].shape),
                     "bias:0": _r(rng, *v["bias"].shape)}
              for name, v in params["backbone"].items()}
    path = tmp_path / "vgg16_notop.h5"
    _write_keras_h5(path, layers)
    tpretrained.maybe_load_pretrained(model, path)
    jparams, jstate = jpretrained.maybe_load_pretrained(params, path,
                                                        state=state)
    got_p, _ = convert.to_jax(model)
    for name, v in layers.items():
        np.testing.assert_array_equal(got_p["backbone"][name]["kernel"],
                                      v["kernel:0"])
    x = np.random.default_rng(2).random((2, 32, 32, 3), dtype=np.float32)
    want, _ = jvgg.vgg16(1).apply(jparams, jstate, jnp.asarray(x))
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-4, atol=1e-5)


def _merge_trees(case):
    """(params, loaded) for one of the strict= cases: every leaf with a
    match, an extra path, a leaf of another shape, a missing leaf."""
    rng = np.random.default_rng(11)
    params = {"conv": {"kernel": _r(rng, 3, 3, 3, 4), "bias": _r(rng, 4)},
              "head": {"kernel": _r(rng, 4, 1)}}
    loaded = {"conv": {"kernel": _r(rng, 3, 3, 3, 4), "bias": _r(rng, 4)},
              "head": {"kernel": _r(rng, 4, 1)}}
    if case == "unexpected":
        loaded["extra"] = {"kernel": _r(rng, 2)}
    elif case == "shape":
        loaded["conv"]["kernel"] = _r(rng, 3, 3, 3, 5)
    elif case == "missing":
        del loaded["head"]
    return params, loaded


@pytest.mark.parametrize("strict", [False, True])
@pytest.mark.parametrize("case", ["exact", "unexpected", "shape", "missing"])
def test_merge_pretrained_strict_matches_jax(case, strict):
    """`strict=` as JAX's merge_pretrained: the same (n_loaded,
    mismatches) and merged leaves where it returns, the same ValueError
    text where it raises (any mismatch, or fewer leaves loaded than the
    params hold)."""
    params, loaded = _merge_trees(case)

    def call(merge):
        try:
            merged, n, mismatches = merge(params, loaded, strict=strict)
        except ValueError as e:
            return "raised", str(e)
        return n, mismatches, convert.flatten(merged)

    got = call(tpretrained.merge_pretrained)
    want = call(jpretrained.merge_pretrained)
    assert (got[0] == "raised") == (strict and case != "exact")
    assert got[:2] == want[:2]
    if got[0] != "raised":
        assert got[2].keys() == want[2].keys()
        for k, w in want[2].items():
            assert np.array_equal(got[2][k], np.asarray(w)), k
