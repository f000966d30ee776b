"""The port's VGG16 (idc_models_tpu_torch/models/vgg.py) against the JAX
package's, at full width on a small input, on the CPU, and the `vgg`
verb end to end.

Weights: the port's seeded init with the biases randomised (numpy,
seeded), carried to the JAX side by convert.py. Eval logits rtol 1e-4 /
atol 1e-5 (13 convs of f32 summed in different orders by oneDNN and
XLA); gradients rtol 1e-3 / atol 1e-5."""

from __future__ import annotations

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from idc_models_tpu.models import vgg as jvgg
from idc_models_tpu_torch import cli, convert
from idc_models_tpu_torch.models import core as tcore
from idc_models_tpu_torch.models import pretrained as tpretrained
from idc_models_tpu_torch.models import registry as tregistry
from idc_models_tpu_torch.models import vgg as tvgg

FWD_TOL = dict(rtol=1e-4, atol=1e-5)
GRAD_TOL = dict(rtol=1e-3, atol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in several worker processes on a few cores; torch's
    default of one thread a core oversubscribes them, and its OpenMP
    barriers then stall the many small ops of these models (a DenseNet
    test of 10 s took 350 s beside five other workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _variables():
    """(params, state) numpy trees of a seeded port init, biases drawn
    from N(0, 0.05) so they count."""
    params, state = convert.to_jax(tcore.init_params(tvgg.vgg16(1), 0))
    flat = convert.flatten(params)
    rng = np.random.default_rng(3)
    for k, a in flat.items():
        if k.endswith("/bias"):
            flat[k] = rng.normal(0, 0.05, a.shape).astype(np.float32)
    return convert.unflatten(flat), state


def _port():
    return convert.load_jax(tvgg.vgg16(1), *_variables())


def _images(n=2, size=32, seed=4):
    return np.random.default_rng(seed).random((n, size, size, 3),
                                              dtype=np.float32)


def test_param_count_keras_index_and_layer_order_match_jax():
    bb = tvgg.vgg16_backbone()
    assert tcore.count_params(bb) == 14_714_688
    assert tvgg.KERAS_LAYER_INDEX == jvgg.KERAS_LAYER_INDEX
    assert tvgg.KERAS_LAYER_INDEX["block5_conv1"] == 15
    jbb = jvgg.vgg16_backbone()
    assert bb.layer_names == tuple(k for k, _ in jbb.children)
    assert tregistry.get_model("vgg16").layer_index is tvgg.KERAS_LAYER_INDEX


def test_trees_match_the_jax_init_and_round_trip():
    """convert.py carries the trees both ways: the port's (params, state)
    have the JAX init's paths and shapes (from jax.eval_shape, no
    compute), and JAX trees -> port -> JAX trees is exact."""
    jm = jvgg.vgg16(1)
    want = jax.eval_shape(lambda k: (lambda v: (v.params, v.state))(
        jm.init(k)), jax.random.key(0))
    params, state = _variables()
    for got, ref in zip((params, state), want):
        ref = convert.flatten(ref)
        got = convert.flatten(got)
        assert set(got) == set(ref)
        assert all(got[k].shape == ref[k].shape for k in ref)
    back = convert.to_jax(_port())
    for a, b in zip((params, state), back):
        fa, fb = convert.flatten(a), convert.flatten(b)
        assert set(fa) == set(fb)
        for k in fa:
            np.testing.assert_array_equal(fa[k], fb[k], err_msg=k)


def test_fine_tune_masks_at_15_match_jax():
    params, _ = _variables()
    model = _port()
    for got, want in ((tvgg.fine_tune_mask(model, 15),
                       jvgg.fine_tune_mask(params, 15)),
                      (tvgg.head_only_mask(model),
                       jvgg.head_only_mask(params))):
        want = convert.flatten(want)
        assert {k.replace(".", "/"): v for k, v in got.items()} == {
            k: bool(v) for k, v in want.items()}
    live = {k.split(".")[1] for k, v in tvgg.fine_tune_mask(model, 15).items()
            if v and k.startswith("backbone.")}
    assert live == {"block5_conv1", "block5_conv2", "block5_conv3"}


@pytest.mark.parametrize("size", [32, 50])
def test_eval_logits_match_jax(size):
    params, state = _variables()
    x = _images(size=size)
    want, _ = jax.jit(lambda p, x: jvgg.vgg16(1).apply(p, state, x))(
        params, jnp.asarray(x))
    model = _port().eval()
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    assert got.shape == (2, 1)
    np.testing.assert_allclose(got, np.asarray(want), **FWD_TOL)


def test_gradients_match_jax():
    """d(sum r*logits)/d(params) over every parameter, backbone and head."""
    params, state = _variables()
    x = _images()
    r = np.random.default_rng(5).normal(0, 1, (2, 1)).astype(np.float32)
    jm = jvgg.vgg16(1)

    def loss(p):
        y, _ = jm.apply(p, state, jnp.asarray(x), train=True)
        return jnp.sum(y * r)

    want = convert.flatten(jax.tree.map(
        np.asarray, jax.jit(jax.grad(loss))(params)))
    model = _port().train()
    (model(torch.from_numpy(x)) * torch.from_numpy(r)).sum().backward()
    got = {k.replace(".", "/"): p.grad.numpy()
           for k, p in model.named_parameters()}
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, **GRAD_TOL, err_msg=k)


def test_cli_vgg_runs_two_phases_and_saves_the_jax_layout(tmp_path, capsys):
    """The `vgg` verb on the CPU: two epoch records, the test record with
    AUROC, and a model.npz whose trees drive the JAX vgg16 to the port's
    own logits."""
    rc = cli.main(["vgg", "--device", "cpu", "--synthetic-examples", "32",
                   "--batch-size", "8", "--epochs", "1",
                   "--fine-tune-epochs", "1", "--path", str(tmp_path)])
    assert rc == 0
    recs = [json.loads(line) for line in
            (tmp_path / "logs" / "run.jsonl").read_text().splitlines()]
    events = [r["event"] for r in recs]
    # the run log closes with the registry's metrics snapshot
    assert events.count("epoch") == 2
    assert events[-2:] == ["test", "metrics_snapshot"]
    assert {"loss", "accuracy", "auroc"} <= set(recs[-2])
    assert "test: loss=" in capsys.readouterr().out
    params, state = tpretrained.load_pretrained_file(tmp_path / "model.npz")
    x = _images()
    want, _ = jvgg.vgg16(1).apply(params, state, jnp.asarray(x))
    model = convert.load_jax(tvgg.vgg16(1), params, state).eval()
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(want), **FWD_TOL)


@pytest.mark.parametrize("argv,match", [
    (["--model-parallel", "2"],
     "model-parallel degree 2 must divide the device count"),
    # the JAX verb's refusal of the combination, before the mesh's
    (["--model-parallel", "2", "--central-storage"], "model-sharded"),
])
def test_cli_refuses_unported_flags_naming_the_item(argv, match):
    """The JAX verb's refusals of --model-parallel: a degree the world's
    ranks do not divide, and the combination with --central-storage.
    (tests/test_torch_dist.py runs the channel-sharded step;
    --central-storage, --stream and --decode-workers run in
    tests/test_torch_observe_cli.py.)"""
    with pytest.raises(SystemExit, match=match):
        cli.main(["vgg", "--device", "cpu", *argv])
