"""The port's `convert-weights` verb (ROADMAP A12) against the JAX
package's on the same Keras-layout `.h5` files, which the tests write
with h5py (no download): the `.npz` array for array and the printed
lines, with and without `--model`. The backbone the shapes are checked
against is built on the meta device, so no weights are materialized."""

from __future__ import annotations

import numpy as np
import pytest

from idc_models_tpu import cli as jcli
from idc_models_tpu_torch import cli

h5py = pytest.importorskip("h5py")


def _write_h5(path, layers) -> None:
    """A Keras `save_weights` file: one group a layer, its
    `weight_names` attribute and a dataset a weight."""
    with h5py.File(path, "w") as f:
        for layer, weights in layers.items():
            g = f.create_group(layer)
            g.attrs["weight_names"] = [f"{layer}/{w}".encode()
                                       for w in weights]
            for w, arr in weights.items():
                g.create_dataset(f"{layer}/{w}", data=arr)


def _rng_arr(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


def _vgg_h5(path) -> None:
    rng = np.random.default_rng(0)
    _write_h5(path, {
        "block1_conv1": {"kernel:0": _rng_arr(rng, (3, 3, 3, 64)),
                         "bias:0": _rng_arr(rng, (64,))},
        "block1_conv2": {"kernel:0": _rng_arr(rng, (3, 3, 64, 64)),
                         "bias:0": _rng_arr(rng, (64,))},
        # a wrong shape and a layer the backbone does not have
        "block2_conv1": {"kernel:0": _rng_arr(rng, (3, 3, 64, 65))},
        "extra_dense": {"kernel:0": _rng_arr(rng, (4, 2))},
    })


def _mobile_h5(path) -> None:
    """MobileNetV2's stem: a conv, its BN (params and moving
    statistics) and the first depthwise kernel, stored (kh, kw, C, 1)."""
    rng = np.random.default_rng(1)
    _write_h5(path, {
        "Conv1": {"kernel:0": _rng_arr(rng, (3, 3, 3, 32))},
        "bn_Conv1": {"gamma:0": _rng_arr(rng, (32,)),
                     "beta:0": _rng_arr(rng, (32,)),
                     "moving_mean:0": _rng_arr(rng, (32,)),
                     "moving_variance:0": np.abs(_rng_arr(rng, (32,)))},
        "expanded_conv_depthwise": {
            "depthwise_kernel:0": _rng_arr(rng, (3, 3, 32, 1))},
    })


def _run(main, argv, capsys):
    assert main(argv) in (0, None)
    return capsys.readouterr()


@pytest.mark.parametrize("h5,model", [
    (_vgg_h5, None), (_vgg_h5, "vgg16"), (_mobile_h5, "mobilenet_v2")],
    ids=["vgg-plain", "vgg-checked", "mobilenet-checked"])
def test_convert_weights_writes_the_jax_verbs_npz(tmp_path, capsys, h5,
                                                   model):
    """The port verb's `.npz` holds the JAX verb's keys and arrays
    exactly, and it prints the same `validated ...: N tensors match, M
    mismatches` lines (with the mismatched names) and `wrote ...` line,
    the output paths aside."""
    src = tmp_path / "weights.h5"
    h5(src)
    extra = ["--model", model] if model else []
    outs, files = {}, {}
    for name, main in (("port", cli.main), ("jax", jcli.main)):
        dst = tmp_path / f"{name}.npz"
        got = _run(main, ["convert-weights", str(src), str(dst), *extra],
                   capsys)
        outs[name] = got.out.replace(str(dst), "OUT").splitlines()
        with np.load(dst) as z:
            files[name] = {k: z[k] for k in z.files}
    assert outs["port"] == outs["jax"]
    assert outs["port"][-1].startswith("wrote OUT (")
    assert set(files["port"]) == set(files["jax"])
    for k, want in files["jax"].items():
        assert files["port"][k].dtype == want.dtype, k
        np.testing.assert_array_equal(files["port"][k], want, err_msg=k)
    checked = [ln for ln in outs["port"] if ln.startswith("validated")]
    if model == "vgg16":
        assert checked == ["validated params against vgg16: 4 tensors "
                           "match, 2 mismatches"]
    elif model == "mobilenet_v2":
        assert checked == [
            "validated params against mobilenet_v2: 4 tensors match, 0 "
            "mismatches",
            "validated state against mobilenet_v2: 2 tensors match, 0 "
            "mismatches"]
        # the depthwise kernel is swapped to (kh, kw, 1, C)
        assert files["port"]["params/expanded_conv_depthwise/kernel"] \
            .shape == (3, 3, 1, 32)
    else:
        assert checked == []


def test_convert_weights_takes_its_alias_and_refuses_an_unknown_model(
        tmp_path):
    src = tmp_path / "weights.h5"
    _vgg_h5(src)
    assert cli.main(["convert_weights", str(src),
                     str(tmp_path / "o.npz")]) == 0
    with pytest.raises(SystemExit):
        cli.main(["convert-weights", str(src), str(tmp_path / "x.npz"),
                  "--model", "resnet50"])
