"""The port's DenseNet201 (idc_models_tpu_torch/models/densenet.py)
against the JAX package's, on the CPU, and its packed blocks against its
concat blocks.

Weights: the port's seeded init with every BN's parameters and moving
statistics randomised (numpy, seeded), carried to the JAX side by
convert.py. The JAX forward is one jitted eval forward at 32x32, batch
2, compiled once for the module (an eager forward of the 201 layers
takes over a minute here). Eval logits against JAX: rtol 1e-4 / atol
1e-4 (about 200 f32 layers summed in different orders). Packed against
concat: eval bit for bit; phase-2 gradients within 1e-5 of each
tensor's largest |gradient| (the same terms, summed into the packed
buffer's gradient in another order)."""

from __future__ import annotations

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from idc_models_tpu.models import densenet as jdensenet
from idc_models_tpu_torch import cli, convert
from idc_models_tpu_torch.models import core as tcore
from idc_models_tpu_torch.models import densenet as tdensenet
from idc_models_tpu_torch.models import pretrained as tpretrained

FWD_TOL = dict(rtol=1e-4, atol=1e-4)
GRAD_REL = 1e-5
PHASE2 = 150            # the dense preset's fine_tune_at


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
    """(params, state) numpy trees: a seeded port init, BN scale/bias and
    statistics randomised so the BNs are far from identity."""
    params, state = convert.to_jax(
        tcore.init_params(tdensenet.densenet201(10), 0))
    rng = np.random.default_rng(7)
    fp, fs = convert.flatten(params), convert.flatten(state)
    for k, a in fp.items():
        if k.endswith("bn/scale"):
            fp[k] = (1.0 + rng.normal(0, 0.2, a.shape)).astype(np.float32)
        elif k.endswith("bn/bias"):
            fp[k] = rng.normal(0, 0.2, a.shape).astype(np.float32)
    for k, a in fs.items():
        fs[k] = (rng.normal(0, 0.2, a.shape) if k.endswith("/mean")
                 else 0.5 + rng.random(a.shape)).astype(np.float32)
    return convert.unflatten(fp), convert.unflatten(fs)


def _port(block_impl="packed", bn_frozen_below=0):
    return convert.load_jax(
        tdensenet.densenet201(10, bn_frozen_below=bn_frozen_below,
                              block_impl=block_impl), *_variables())


def _images(n=2, size=32, seed=4):
    return np.random.default_rng(seed).random((n, size, size, 3),
                                              dtype=np.float32)


@pytest.fixture(scope="module")
def jax_forward():
    """The JAX DenseNet201's eval forward, jitted once: (params, state,
    x) -> logits."""
    m = jdensenet.densenet201(10)
    return jax.jit(lambda p, s, x: m.apply(p, s, x, train=False)[0])


def test_param_count_keras_index_and_layer_order_match_jax():
    bb = tdensenet.densenet201_backbone()
    total = tcore.count_params(bb) + sum(b.numel() for b in bb.buffers())
    assert total == 18_321_984
    idx = tdensenet.KERAS_LAYER_INDEX
    assert idx == jdensenet.KERAS_LAYER_INDEX
    assert idx["conv1_conv"] == 2
    assert idx["conv2_block1_0_bn"] == 7
    # 150 lands inside conv4_block2 (after 6 + 12 layers, two transitions)
    assert idx["conv4_block1_0_bn"] < PHASE2 <= idx["conv4_block2_2_conv"]
    assert bb.layer_names == jdensenet.densenet201_backbone().layer_names
    assert bb.layer_names == tuple(idx)


@pytest.mark.parametrize("block_impl", ["packed", "concat"])
def test_eval_logits_match_jax(jax_forward, block_impl):
    params, state = _variables()
    x = _images()
    want = np.asarray(jax_forward(params, state, jnp.asarray(x)))
    model = _port(block_impl).eval()
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    assert got.shape == (2, 10)
    np.testing.assert_allclose(got, want, **FWD_TOL)


@pytest.mark.parametrize("n,size", [(2, 32), (1, 64)])
def test_packed_equals_concat_in_eval_bit_for_bit(n, size):
    """The same channel layout and the same conv inputs: the packed
    backbone's features equal concat's exactly (64x64 leaves stage 5 at
    2x2, as the JAX package's own test)."""
    x = torch.from_numpy(_images(n, size, seed=5))
    with torch.no_grad():
        y_p = _port("packed").backbone.eval()(x)
        y_c = _port("concat").backbone.eval()(x)
    assert y_p.shape == (n, size // 32, size // 32, 1920)
    assert torch.equal(y_p, y_c)


def _phase2_grads(block_impl, x, r):
    model = _port(block_impl, bn_frozen_below=PHASE2).train()
    mask = tdensenet.fine_tune_mask(model, PHASE2)
    for k, p in model.named_parameters():
        p.requires_grad_(mask[k])
    (model(x) * r).sum().backward()
    return model, {k: p.grad for k, p in model.named_parameters()
                   if mask[k]}


def test_phase2_backward_runs_through_packed_blocks_as_concat():
    """Phase 2 at fine_tune_at=150: the live BNs of stages 4 and 5 train
    on slices of buffers that later layers write into. The backward runs
    (no in-place version error) and every gradient is concat's, within
    1e-5 of the tensor's largest |gradient|; the updated BN statistics
    are equal."""
    x = torch.from_numpy(_images(4, 32, seed=6))
    r = torch.from_numpy(np.random.default_rng(8).normal(0, 1, (4, 10))
                         .astype(np.float32))
    m_p, g_p = _phase2_grads("packed", x, r)
    m_c, g_c = _phase2_grads("concat", x, r)
    assert set(g_p) == set(g_c) and "backbone.conv4_block2_2_conv.kernel" in g_p
    for k in g_c:
        scale = float(g_c[k].abs().max())
        err = float((g_p[k] - g_c[k]).abs().max())
        assert err <= GRAD_REL * scale, (k, err, scale)
    for (k, a), (_, b) in zip(m_p.named_buffers(), m_c.named_buffers()):
        assert torch.equal(a, b), k


@pytest.mark.parametrize("bn_frozen_below", [tdensenet.FREEZE_ALL, PHASE2])
def test_frozen_bn_state_static_in_train_mode(bn_frozen_below):
    """A train-mode forward leaves every BN below bn_frozen_below
    untouched, and moves the others."""
    model = _port("packed", bn_frozen_below).train()
    before = {k: v.clone() for k, v in model.named_buffers()}
    with torch.no_grad():
        model(torch.from_numpy(_images(4, 32)))
    moved = {k.split(".")[1] for k, v in model.named_buffers()
             if not torch.equal(v, before[k])}
    frozen = {n for n in tdensenet.KERAS_LAYER_INDEX
              if tdensenet.KERAS_LAYER_INDEX[n] < bn_frozen_below}
    assert not moved & frozen
    if bn_frozen_below == PHASE2:
        assert "conv4_block2_1_bn" in moved and "bn" in moved


def test_trees_match_the_jax_init_and_round_trip():
    """convert.py carries the trees both ways: the port's (params, state)
    have the JAX init's paths and shapes (from jax.eval_shape, no
    compute), and JAX trees -> port -> JAX trees is exact."""
    jm = jdensenet.densenet201(10)
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


def test_fine_tune_masks_at_150_match_jax():
    params, _ = _variables()
    model = _port()
    for got, want in ((tdensenet.fine_tune_mask(model, PHASE2),
                       jdensenet.fine_tune_mask(params, PHASE2)),
                      (tdensenet.head_only_mask(model),
                       jdensenet.head_only_mask(params))):
        want = convert.flatten(want)
        assert {k.replace(".", "/"): v for k, v in got.items()} == {
            k: bool(v) for k, v in want.items()}


def test_unknown_block_impl_raises():
    with pytest.raises(ValueError, match="packed|concat"):
        tdensenet.densenet201_backbone(3, block_impl="fused")


def test_cli_dense_runs_on_cifar_and_saves_the_jax_layout(tmp_path, capsys,
                                                          jax_forward):
    """The `dense` verb on the CPU: the CIFAR-10 stand-in (none under
    --path), sparse CE over 10 classes, two passes an epoch; its
    model.npz drives the JAX DenseNet201 to the port's own logits."""
    with pytest.warns(UserWarning, match="CIFAR-10 not found"):
        rc = cli.main(["dense", "--device", "cpu", "--synthetic-examples",
                       "40", "--batch-size", "8", "--epochs", "1",
                       "--fine-tune-epochs", "1", "--path", str(tmp_path)])
    assert rc == 0
    recs = [json.loads(line) for line in
            (tmp_path / "logs" / "run.jsonl").read_text().splitlines()]
    assert [r["event"] for r in recs].count("epoch") == 2
    # the run log closes with the registry's metrics snapshot
    assert recs[-1]["event"] == "metrics_snapshot"
    assert recs[-2]["event"] == "test" and "auroc" not in recs[-2]
    assert np.isfinite(recs[-2]["loss"])
    assert "test: loss=" in capsys.readouterr().out
    params, state = tpretrained.load_pretrained_file(tmp_path / "model.npz")
    x = _images()
    want = np.asarray(jax_forward(params, state, jnp.asarray(x)))
    model = convert.load_jax(tdensenet.densenet201(10), params, state).eval()
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, **FWD_TOL)
