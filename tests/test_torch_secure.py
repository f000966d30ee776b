"""The port's secure-aggregation FedAvg (idc_models_tpu_torch/secure,
federated, models/small_cnn, the `secure-fed` verb) against the JAX
package's, on the CPU.

Tolerances: the protected part of an aggregate is integer arithmetic
and compared bit for bit; an f32 mean of the same values, rtol 1e-6
(summation order); a trained result, rtol 1e-5 on both sides' f32
training (oneDNN vs XLA summation order), with atol 2e-6 where the
protected part rounds to the 2^-20 fixed-point grid (a client one ulp
apart can land one quantum away)."""

from __future__ import annotations

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from idc_models_tpu import mesh as meshlib
from idc_models_tpu.data import idc as jidc
from idc_models_tpu.data import synthetic as jsynthetic
from idc_models_tpu.federated import fedavg as jfed
from idc_models_tpu.federated import robust as jrobust
from idc_models_tpu.models import core as jcore
from idc_models_tpu.models.small_cnn import small_cnn as jsmall_cnn
from idc_models_tpu.secure import fedavg as jsecure
from idc_models_tpu.secure import masking as jm
from idc_models_tpu.train import rmsprop as jrmsprop
from idc_models_tpu.train.losses import binary_cross_entropy as jbce
from idc_models_tpu_torch import cli, convert
from idc_models_tpu_torch.data import idc as tidc
from idc_models_tpu_torch.federated import fedavg as tfed
from idc_models_tpu_torch.federated import robust as trobust
from idc_models_tpu_torch.models import core as tcore
from idc_models_tpu_torch.models import small_cnn as tsmall
from idc_models_tpu_torch.models.pretrained import load_pretrained_file
from idc_models_tpu_torch.ops import secure_masking_kernel as tsmk
from idc_models_tpu_torch.secure import fedavg as tsecure
from idc_models_tpu_torch.secure import masking as tm
from idc_models_tpu_torch.secure.paillier import generate_paillier_keypair
from idc_models_tpu_torch.train.losses import binary_cross_entropy as tbce

SB, CLIP = 20, 64.0


def _flat(tree) -> dict[str, np.ndarray]:
    return {k.replace("/", "."): np.asarray(v)
            for k, v in convert.flatten(tree).items()}


def _jax_bn_cnn():
    bb = jcore.sequential(
        [jcore.conv2d(3, 4, 3, name="c1"), jcore.batch_norm(4, name="b1"),
         jcore.relu(name="r1"), jcore.conv2d(4, 4, 3, name="c2"),
         jcore.batch_norm(4, name="b2"), jcore.relu(name="r2")], name="bb")
    return jcore.classifier(bb, 4, 1)


def _torch_bn_cnn():
    bb = tcore.Sequential(
        [tcore.Conv2d(3, 4, 3, name="c1"), tcore.BatchNorm(4, name="b1"),
         tcore.ReLU("r1"), tcore.Conv2d(4, 4, 3, name="c2"),
         tcore.BatchNorm(4, name="b2"), tcore.ReLU("r2")], name="bb")
    return tcore.Classifier(bb, 4, 1)


def _jax_seq():
    """Dropout-free: conv -> relu -> maxpool -> flatten -> dense."""
    return jcore.sequential(
        [jcore.conv2d(3, 4, 3, name="c1"), jcore.relu(),
         jcore.max_pool(2, name="pool"), jcore.flatten(),
         jcore.dense(100, 1, name="head")], name="seq")


def _torch_seq():
    return tcore.Sequential(
        [tcore.Conv2d(3, 4, 3, name="c1"), tcore.ReLU(),
         tcore.MaxPool(2, name="pool"), tcore.Flatten(),
         tcore.Dense(100, 1, name="head")], name="seq")


def _jax_boundary(cp, cs, params, state, percent, layer_names, sb,
                  mask_key):
    """The JAX round boundary (secure/fedavg.py:262-336) on stacked
    client trees: dequantize(Σ (quantize + threefry mask)) on the
    protected part, the plain mean on the rest."""
    n = jax.tree.leaves(cp)[0].shape[0]
    pf, sf = jm.first_fraction_selection_weights(params, state, percent,
                                                 layer_names)
    leaves = jax.tree.leaves(cp) + jax.tree.leaves(cs)
    flags = jax.tree.leaves(pf) + jax.tree.leaves(sf)
    is_state = ([False] * len(jax.tree.leaves(cp))
                + [True] * len(jax.tree.leaves(cs)))
    prot = [x / 256.0 if s else x
            for x, f, s in zip(leaves, flags, is_state) if f]
    flat, meta = jm.pack_leaves(prot, lead_axes=1)
    q = jm.quantize(flat, sb, clip_abs=CLIP)
    masks = jax.vmap(lambda c: jm.pairwise_mask(
        mask_key, c, n, (flat.shape[1],)))(jnp.arange(n))
    deq = jm.dequantize((q + masks).sum(axis=0), sb, count=n)
    saturated = int(jnp.sum(jnp.abs(flat) >= CLIP))
    prot_it = iter([x * 256.0 if s else x for x, s in zip(
        jm.unpack_leaves(deq, meta),
        [s for s, f in zip(is_state, flags) if f])])
    plain = [x for x, f in zip(leaves, flags) if not f]
    pflat, pmeta = jm.pack_leaves(plain, lead_axes=1)
    plain_it = iter(jm.unpack_leaves(pflat.sum(axis=0) / n, pmeta))
    out = [next(prot_it) if f else next(plain_it) for f in flags]
    return out, flags, saturated


@pytest.mark.parametrize("mask_impl", ["threefry", "pallas"])
@pytest.mark.parametrize("percent", [0.5, 1.0])
def test_secure_aggregate_matches_jax_bit_for_bit(mask_impl, percent):
    """Fixed client updates of a BN model (params and moving statistics,
    large variances, values past the clip): the protected part equals the
    JAX package's dequantize(Σ quantize) bit for bit, whichever mask; the
    plain part is the same mean to f32 rounding."""
    jmodel, tmodel = _jax_bn_cnn(), _torch_bn_cnn()
    v = jmodel.init(jax.random.key(0))
    n = 5
    rng = np.random.default_rng(1)

    def noisy(tree, scale):
        return jax.tree.map(lambda x: np.stack([
            np.asarray(x) + rng.normal(0, scale, x.shape).astype(np.float32)
            for _ in range(n)]), tree)

    cp = noisy(v.params, 0.5)
    cp["backbone"]["c1"]["bias"][0, 0] = 70.0  # saturates at the clip
    cs = noisy(v.state, 3.0)
    cs["backbone"]["b1"]["var"] += 3000.0      # beyond ±64 until prescaled
    key = jax.random.key(9)
    sb = jm.choose_scale_bits(n, CLIP)
    want, flags, saturated = _jax_boundary(cp, cs, v.params, v.state,
                                           percent, jmodel.layer_names, sb,
                                           key)

    def torch_tree(tree):
        return {k: torch.from_numpy(x) for k, x in _flat(tree).items()}

    params, state, metrics = tsecure.secure_aggregate(
        torch_tree(cp), torch_tree(cs), torch_tree(v.params),
        torch_tree(v.state), percent=percent,
        layer_order=tmodel.layer_names, mask_impl=mask_impl,
        mask_key=tuple(int(x) for x in jax.random.key_data(key)))
    got = [params[k] for k in tm.leaf_names(params)] + [
        state[k] for k in tm.leaf_names(state)]
    assert len(got) == len(want) == 14
    for g, w, f in zip(got, want, flags):
        if f:
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        else:
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6)
    assert float(metrics["clip_saturated"]) == saturated >= 1


def test_secure_aggregate_rejects_order_statistics_and_applies_norm_clip():
    jmodel, tmodel = _jax_seq(), _torch_seq()
    v = jmodel.init(jax.random.key(0))
    tp = {k: torch.from_numpy(x) for k, x in _flat(v.params).items()}
    cp = {k: torch.stack([x + i for i in range(3)]) for k, x in tp.items()}
    for agg in ("trimmed_mean", "median"):
        with pytest.raises(ValueError, match="not compatible with secure"):
            tsecure.secure_aggregate(cp, {}, tp, {}, percent=0.5,
                                     aggregator=agg)
        with pytest.raises(ValueError, match="not compatible with secure"):
            tsecure.make_secure_fedavg_round(tmodel, 1e-3, tbce,
                                             percent=0.5, aggregator=agg,
                                             device="cpu")
    # norm_clip's per-client transform is the JAX package's
    jcp = jax.tree.map(lambda x: jnp.stack([x + i for i in range(3)]),
                       v.params)
    want, wm = jrobust.NormClip(2.0).per_client({"params": jcp},
                                                {"params": v.params})
    got, gm = trobust.NormClip(2.0).per_client(cp, tp)
    for k, w in _flat(want["params"]).items():
        np.testing.assert_allclose(got[k].numpy(), w, rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(gm["clients_clipped"].numpy(),
                                  np.asarray(wm["clients_clipped"]))
    _, _, m = tsecure.secure_aggregate(cp, {}, tp, {}, percent=0.5,
                                       aggregator="norm_clip")
    assert float(m["clients_clipped"]) == 2.0


def _client_data(n_clients, shard, seed=0):
    imgs, labels = jsynthetic.make_idc_like(n_clients * shard, size=10,
                                            seed=seed)
    return (imgs.astype(np.float32).reshape(n_clients, shard, 10, 10, 3),
            labels.reshape(n_clients, shard))


def test_local_trainer_matches_jax():
    """Two local epochs of one full-shard step each (shard == batch, so
    the per-epoch permutation cannot matter) from carried weights."""
    jmodel, tmodel = _jax_seq(), _torch_seq()
    v = jmodel.init(jax.random.key(3))
    convert.load_jax(tmodel, v.params, v.state)
    imgs, labels = _client_data(1, 16, seed=4)
    jtrain = jax.jit(jfed.make_local_trainer(
        jmodel, jrmsprop(1e-3), jbce, local_epochs=2, batch_size=16))
    jp, _, (jl, ja) = jtrain(v.params, v.state, jnp.asarray(imgs[0]),
                             jnp.asarray(labels[0]), jax.random.key(5))
    ttrain = tfed.make_local_trainer(tmodel, 1e-3, tbce, local_epochs=2,
                                     batch_size=16)
    tl, ta = ttrain(torch.from_numpy(imgs[0]), torch.from_numpy(labels[0]),
                    torch.Generator().manual_seed(5))
    assert tl.shape == (2, 1) == jl.shape
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5)
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    for k, w in _flat(jp).items():
        np.testing.assert_allclose(
            dict(tmodel.named_parameters())[k].detach().numpy(), w,
            rtol=1e-5, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("poison", [False, True])
def test_secure_round_matches_jax(poison):
    """One secure round, 4 clients, 2 local epochs, percent 0.5, on the
    dropout-free model: the aggregate and the metrics match the JAX
    round on a one-device client mesh. With one client's data poisoned
    with NaN, both replace its update with the global weights."""
    jmodel, tmodel = _jax_seq(), _torch_seq()
    v = jmodel.init(jax.random.key(0))
    convert.load_jax(tmodel, v.params, v.state)   # the JAX round donates v
    imgs, labels = _client_data(4, 16, seed=2)
    if poison:
        imgs[1] = np.nan
    jround = jsecure.make_secure_fedavg_round(
        jmodel, jrmsprop(1e-3), jbce, meshlib.client_mesh(1), percent=0.5,
        local_epochs=2, batch_size=16)
    js, jmet = jround(jfed.ServerState(jnp.zeros((), jnp.int32), v.params,
                                       v.state),
                      jnp.asarray(imgs), jnp.asarray(labels),
                      jax.random.key(1))
    tround = tsecure.make_secure_fedavg_round(
        tmodel, 1e-3, tbce, percent=0.5, local_epochs=2, batch_size=16,
        device="cpu")
    server, tmet = tround(tfed.ServerState.of(tmodel), imgs, labels,
                          torch.Generator().manual_seed(1))
    assert server.round == 1
    for k, w in _flat(js.params).items():
        assert np.isfinite(w).all()
        np.testing.assert_allclose(server.params[k].numpy(), w, rtol=1e-5,
                                   atol=2e-6, err_msg=k)
    np.testing.assert_allclose(tmet["loss"], float(jmet["loss"]), rtol=1e-5)
    np.testing.assert_allclose(tmet["accuracy"], float(jmet["accuracy"]),
                               rtol=1e-6)
    assert tmet["clients_recovered"] == float(jmet["clients_recovered"]) \
        == float(poison)
    assert tmet["clip_saturated"] == float(jmet["clip_saturated"]) == 0.0
    if poison:
        off = tsecure.make_secure_fedavg_round(
            tmodel, 1e-3, tbce, percent=0.5, local_epochs=1, batch_size=16,
            recover_nonfinite=False, device="cpu")
        bad, _ = off(tfed.ServerState.of(tmodel), imgs, labels,
                     torch.Generator().manual_seed(1))
        assert not all(torch.isfinite(t).all() for t in bad.params.values())


def test_mask_impls_aggregate_bit_identically_in_a_round():
    """`pallas` (the kernel's plain version on the CPU, no launch) and
    `threefry` give the same server weights, bit for bit, for a small
    CNN with dropout (the same client generators drive both)."""
    imgs, labels = _client_data(3, 8, seed=6)
    out = {}
    before = tsmk.KERNEL.launches
    for impl in ("threefry", "pallas", "auto"):
        model = tcore.init_params(tsmall.small_cnn(10, 3, 1), 0)
        rnd = tsecure.make_secure_fedavg_round(
            model, 1e-3, tbce, percent=0.5, local_epochs=1, batch_size=4,
            mask_impl=impl, device="cpu")
        server, m = rnd(tfed.ServerState.of(model), imgs, labels,
                        torch.Generator().manual_seed(3))
        out[impl] = {**server.params, **server.state}
        assert np.isfinite(m["loss"]) and m["clip_saturated"] == 0.0
    assert tsmk.KERNEL.launches == before
    for k, t in out["threefry"].items():
        assert torch.equal(out["pallas"][k], t), k
        assert torch.equal(out["auto"][k], t), k


def test_resolve_mask_impl_auto():
    big = tcore.Sequential([tcore.Dense(2100, 2000, name="fc")])
    small = tsmall.small_cnn(10, 3, 1)
    assert tsecure.resolve_mask_impl(big, 1.0, device="cuda") == "pallas"
    assert tsecure.resolve_mask_impl(big, 0.4, device="cuda") == "threefry"
    assert tsecure.resolve_mask_impl(small, 1.0, device="cuda") == "threefry"
    assert tsecure.resolve_mask_impl(big, 1.0, device="cpu") == "threefry"
    assert tm.MASK_PALLAS_MIN_ELEMS == jm.MASK_PALLAS_MIN_ELEMS


def test_small_cnn_matches_jax():
    jmodel = jsmall_cnn(10, 3, 1)
    tmodel = tsmall.small_cnn(10, 3, 1)
    v = jmodel.init(jax.random.key(0))
    assert tcore.count_params(tmodel) == sum(
        x.size for x in jax.tree.leaves(v.params)) == 1937
    assert tmodel.layer_names == tuple(jmodel.layer_names) == (
        "conv1", "relu", "pool1", "drop1", "flatten", "fc1", "relu_1",
        "drop2", "head")
    convert.load_jax(tmodel, v.params, v.state)
    x = np.random.default_rng(0).random((6, 10, 10, 3)).astype(np.float32)
    want, _ = jmodel.apply(v.params, v.state, jnp.asarray(x), train=False)
    with torch.no_grad():
        got = tmodel.eval()(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


def test_dropout_in_train_mode():
    drop = tcore.Dropout(0.25)
    x = torch.ones(200_000)
    with pytest.raises(ValueError, match="needs a generator"):
        drop.train()(x)
    tcore.use_generator(drop, torch.Generator().manual_seed(0))
    y = drop(x)
    zero = (y == 0).float().mean().item()
    assert abs(zero - 0.25) < 0.01
    assert torch.equal(y[y != 0], torch.full_like(y[y != 0], 1 / 0.75))
    assert torch.equal(drop.eval()(x), x)
    with pytest.raises(ValueError, match=r"\[0, 1\)"):
        tcore.Dropout(1.0)


def test_maxpool_and_sequential_naming_match_jax():
    x = np.random.default_rng(0).normal(size=(2, 7, 7, 3)).astype(np.float32)
    want, _ = jcore.max_pool(2).apply({}, {}, jnp.asarray(x))
    got = tcore.MaxPool(2)(torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    seq = tcore.Sequential([tcore.ReLU(), tcore.ReLU(), tcore.ReLU()])
    jseq = jcore.sequential([jcore.relu(), jcore.relu(), jcore.relu()])
    assert seq.layer_names == tuple(jseq.layer_names) == (
        "relu", "relu_0", "relu_1")


def test_shard_matches_jax():
    imgs, labels = jsynthetic.make_idc_like(23, size=4, seed=0)
    for i in range(5):
        t = tidc.ArrayDataset(imgs, labels).shard(5, i)
        j = jidc.ArrayDataset(imgs, labels).shard(5, i)
        np.testing.assert_array_equal(t.images, j.images)
        np.testing.assert_array_equal(t.labels, j.labels)


def test_paillier_clients_full_protocol():
    """The host-side parity protocol, 3 clients on tiny shards: fit ->
    encrypt -> aggregate (ciphertext) -> decrypt -> update; every client
    ends with the plain mean of the clients' weights."""
    pub, priv = generate_paillier_keypair(n_length=256)
    model = tsmall.small_cnn(10, 3, 1)
    imgs, labels = jsynthetic.make_idc_like(24, size=10, seed=9)
    clients = [tsecure.PaillierClient(
        model, 1e-3, tbce, imgs[i::3], labels[i::3], i, percent=0.4,
        public_key=pub, private_key=priv, local_epochs=1, batch_size=8,
        seed=0, device="cpu") for i in range(3)]
    packages = [c.client_fit()[0] for c in clients]
    assert clients[0]._num_encrypted() == 2
    assert all(p.dtype == object for p in packages[0][:2])
    assert packages[0][0].shape == (3, 3, 3, 32)   # conv1 kernel first
    expected = {k: np.mean([c.params[k].detach().numpy().astype(np.float64)
                            for c in clients], axis=0)
                for k in clients[0].params}
    agg = tsecure.PaillierServer.aggregate(packages)
    for c in clients:
        c.client_update(agg)
    for c in clients:
        for k, e in expected.items():
            np.testing.assert_allclose(c.params[k].detach().numpy(), e,
                                       rtol=1e-5, atol=1e-7)
    m = clients[0].evaluate(imgs, labels, tbce)
    assert np.isfinite(m["loss"]) and 0 <= m["accuracy"] <= 1
    assert set(m) == {"loss", "accuracy", "auroc"}


def _records(path):
    return [json.loads(line) for line in
            (path / "logs" / "run.jsonl").read_text().splitlines()]


def test_cli_secure_fed_runs_on_the_cpu(tmp_path, capsys):
    rc = cli.main(["secure-fed", "--device", "cpu", "--synthetic-examples",
                   "160", "--num-clients", "4", "--rounds", "1",
                   "--local-epochs", "1", "--path", str(tmp_path)])
    assert rc == 0
    rounds = [r for r in _records(tmp_path) if r["event"] == "round"]
    assert len(rounds) == 1 and rounds[0]["round"] == 0
    for k in ("train_loss", "test_loss", "test_accuracy", "test_auroc"):
        assert np.isfinite(rounds[0][k]), k
    assert rounds[0]["clients_recovered"] == 0
    assert rounds[0]["clip_saturated"] == 0
    assert "round 0: train_loss=" in capsys.readouterr().out
    with pytest.raises(SystemExit, match="cannot compose with secure"):
        cli.main(["secure-fed", "--device", "cpu", "--async-buffer", "4"])


def test_cli_pallas_on_the_cpu_is_the_plain_version(tmp_path):
    """`--mask-impl pallas` on the CPU runs the kernel's plain version
    (no launch) and ends with the same weights as threefry, bit for
    bit."""
    before = tsmk.KERNEL.launches
    weights = {}
    for impl in ("pallas", "threefry"):
        out = tmp_path / impl
        cli.main(["secure_fed", "--device", "cpu", "--synthetic-examples",
                  "120", "--num-clients", "3", "--rounds", "2",
                  "--local-epochs", "1", "--batch-size", "8",
                  "--mask-impl", impl, "--path", str(out)])
        assert len([r for r in _records(out) if r["event"] == "round"]) == 2
        weights[impl] = convert.flatten(load_pretrained_file(
            out / "model.npz")[0])
    assert tsmk.KERNEL.launches == before
    for k, w in weights["threefry"].items():
        np.testing.assert_array_equal(weights["pallas"][k], w)
