"""The port's plain FedAvg round (idc_models_tpu_torch/federated/fedavg.py,
robust.py, faults.py) against the JAX package's, on the CPU.

The JAX round runs on a one-device client mesh. Both sides train a
dropout-free small model with one full-shard step a local epoch (shard ==
batch, so the per-epoch permutation cannot matter: the two packages'
client streams differ). Tolerance: rtol 1e-5, atol 2e-6 on the
aggregates, as tests/test_torch_secure.py holds its trained rounds (f32
training on both sides, oneDNN against XLA summation order)."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from idc_models_tpu import faults as jfaults
from idc_models_tpu import mesh as meshlib
from idc_models_tpu.data import synthetic as jsynthetic
from idc_models_tpu.federated import fedavg as jfed
from idc_models_tpu.federated import robust as jrobust
from idc_models_tpu.models import core as jcore
from idc_models_tpu.train import rmsprop as jrmsprop
from idc_models_tpu.train.losses import binary_cross_entropy as jbce
from idc_models_tpu_torch import convert
from idc_models_tpu_torch import faults as tfaults
from idc_models_tpu_torch.federated import fedavg as tfed
from idc_models_tpu_torch.federated import robust as trobust
from idc_models_tpu_torch.models import core as tcore
from idc_models_tpu_torch.train.losses import binary_cross_entropy as tbce

RTOL, ATOL = 1e-5, 2e-6
N_CLIENTS, SHARD = 4, 16
WEIGHTS = np.array([16.0, 12.0, 16.0, 8.0], np.float32)


def _flat(tree) -> dict[str, np.ndarray]:
    return {k.replace("/", "."): np.asarray(v)
            for k, v in convert.flatten(tree).items()}


def _jax_seq():
    return jcore.sequential(
        [jcore.conv2d(3, 4, 3, name="c1"), jcore.relu(),
         jcore.max_pool(2, name="pool"), jcore.flatten(),
         jcore.dense(100, 1, name="head")], name="seq")


def _torch_seq():
    return tcore.Sequential(
        [tcore.Conv2d(3, 4, 3, name="c1"), tcore.ReLU(),
         tcore.MaxPool(2, name="pool"), tcore.Flatten(),
         tcore.Dense(100, 1, name="head")], name="seq")


def _client_data(seed=2):
    imgs, labels = jsynthetic.make_idc_like(N_CLIENTS * SHARD, size=10,
                                            seed=seed)
    return (imgs.astype(np.float32).reshape(N_CLIENTS, SHARD, 10, 10, 3),
            labels.reshape(N_CLIENTS, SHARD))


# the fed verb trains its clients under a fine-tune mask: freeze the conv
FROZEN = {"c1.kernel", "c1.bias"}


def _rounds(aggregator, spec, n_rounds, imgs, labels, weights=WEIGHTS):
    """`n_rounds` rounds of both packages from the same initial weights;
    returns [(jax server, jax metrics, port server, port metrics)]."""
    jmodel, tmodel = _jax_seq(), _torch_seq()
    v = jmodel.init(jax.random.key(0))
    convert.load_jax(tmodel, v.params, v.state)
    mask = {n: n not in FROZEN for n, _ in tmodel.named_parameters()}
    jmask = convert.unflatten({k.replace(".", "/"): m
                               for k, m in mask.items()})
    agg_kw = ({"trim": 1} if aggregator == "trimmed_mean" else
              {"max_norm": 0.05} if aggregator == "norm_clip" else {})
    jplan = (jfaults.parse_fault_spec(spec, N_CLIENTS) if spec else None)
    tplan = (tfaults.parse_fault_spec(spec, N_CLIENTS) if spec else None)
    jround = jfed.make_fedavg_round(
        jmodel, jrmsprop(1e-3, trainable_mask=jmask), jbce,
        meshlib.client_mesh(1), local_epochs=1, batch_size=SHARD,
        aggregator=jrobust.get_aggregator(aggregator, **agg_kw),
        faults=jplan)
    tround = tfed.make_fedavg_round(
        tmodel, 1e-3, tbce, local_epochs=1, batch_size=SHARD,
        trainable_mask=mask,
        aggregator=trobust.get_aggregator(aggregator, **agg_kw),
        faults=tplan, device="cpu")
    js = jfed.ServerState(jnp.zeros((), jnp.int32), v.params, v.state)
    ts = tfed.ServerState.of(tmodel)
    out = []
    for r in range(n_rounds):
        kw = {"round_idx": r} if jplan is not None else {}
        js, jm = jround(js, jnp.asarray(imgs), jnp.asarray(labels),
                        weights, jax.random.key(r + 1), **kw)
        ts, tm = tround(ts, imgs, labels, weights, (1, r, 0), round_idx=r)
        jm = {k: float(x) for k, x in jax.device_get(jm).items()}
        jp = jax.device_get(js.params)
        out.append((jp, jm, ts, tm))
    return out


FAULTS = [(None, 1), ("crash:2", 1), ("nan:1", 1), ("scale:0:x50", 1),
          ("sign_flip:3:x5", 1), ("straggler:1:2", 3)]


@pytest.mark.parametrize("spec,n_rounds", FAULTS,
                         ids=[f or "none" for f, _ in FAULTS])
@pytest.mark.parametrize("aggregator",
                         ["mean", "trimmed_mean", "median", "norm_clip"])
def test_fedavg_round_matches_jax(aggregator, spec, n_rounds):
    """The aggregate and every metric of the port's round against the JAX
    round, for each aggregator under each fault (the straggler replays
    round r-2's server over three rounds)."""
    imgs, labels = _client_data()
    for r, (jp, jm, ts, tm) in enumerate(
            _rounds(aggregator, spec, n_rounds, imgs, labels)):
        assert ts.round == r + 1
        assert set(tm) == set(jm), (set(tm), set(jm))
        for k, want in _flat(jp).items():
            got = ts.params[k].numpy()
            assert np.isfinite(got).all(), k
            np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL,
                                       err_msg=f"round {r} {k}")
        np.testing.assert_allclose(tm["loss"], jm["loss"], rtol=RTOL)
        for k in set(jm) - {"loss"}:
            np.testing.assert_allclose(tm[k], jm[k], rtol=1e-6,
                                       err_msg=k)
    if spec == "nan:1":
        assert tm["clients_dropped"] == 1.0
    if aggregator == "norm_clip" and spec == "scale:0:x50":
        assert tm["clients_clipped"] >= 1.0


def test_frozen_parameters_stay_put_and_weight0_clients_do_not_train():
    """The trainable mask holds the frozen conv at the server's value (up
    to the rounding of a weighted mean of equal values), and a weight-0
    client (a test client) trains nothing: the round with its shard
    poisoned equals the round with its shard clean, bit for bit."""
    imgs, labels = _client_data()
    weights = np.array([16.0, 16.0, 16.0, 0.0], np.float32)
    tmodel = tcore.init_params(_torch_seq(), 0)
    mask = {n: n not in FROZEN for n, _ in tmodel.named_parameters()}
    rnd = tfed.make_fedavg_round(tmodel, 1e-3, tbce, batch_size=SHARD,
                                 trainable_mask=mask, device="cpu")
    server = tfed.ServerState.of(tmodel)
    clean, mc = rnd(server, imgs, labels, weights, (0, 0, 0))
    bad = imgs.copy()
    bad[3] = np.nan
    poisoned, mp = rnd(server, bad, labels, weights, (0, 0, 0))
    assert mc == mp and mc["clients_dropped"] == 0.0
    for k in server.params:
        assert torch.equal(clean.params[k], poisoned.params[k]), k
        moved = float((clean.params[k] - server.params[k]).abs().max())
        if k in FROZEN:
            assert moved <= 1e-6 * float(server.params[k].abs().max()), k
        else:
            assert moved > 1e-4, k


def test_round_runs_in_the_models_dtype():
    """A float64 working module trains and aggregates in float64 (the
    images enter in the model's dtype, the loss keeps it); its metrics
    are the float32 round's within f32 rounding."""
    imgs, labels = _client_data()
    out = {}
    for dtype in (torch.float32, torch.float64):
        model = tcore.init_params(_torch_seq(), 0).to(dtype)
        rnd = tfed.make_fedavg_round(model, 1e-3, tbce, batch_size=SHARD,
                                     device="cpu")
        out[dtype] = rnd(tfed.ServerState.of(model), imgs, labels, WEIGHTS,
                         (0, 0, 0))
    (s64, m64), (s32, m32) = out[torch.float64], out[torch.float32]
    assert all(v.dtype == torch.float64 for v in s64.params.values())
    assert all(v.dtype == torch.float32 for v in s32.params.values())
    np.testing.assert_allclose(m64["loss"], m32["loss"], rtol=1e-6)
    assert m64["accuracy"] == m32["accuracy"]


def test_all_dropped_round_keeps_the_server():
    """Every client non-finite: the incoming server comes back unchanged
    (round advanced), the loss and accuracy are NaN and every live client
    is counted as dropped, as in the JAX round."""
    imgs, labels = _client_data()
    imgs[:] = np.nan
    tmodel = tcore.init_params(_torch_seq(), 0)
    rnd = tfed.make_fedavg_round(tmodel, 1e-3, tbce, batch_size=SHARD,
                                 device="cpu")
    server = tfed.ServerState.of(tmodel)
    new, m = rnd(server, imgs, labels, WEIGHTS, (0, 0, 0))
    assert new.round == 1
    for k, v in server.params.items():
        assert torch.equal(new.params[k], v), k
    assert np.isnan(m["loss"]) and np.isnan(m["accuracy"])
    assert m["clients_dropped"] == 4.0

    jmodel = _jax_seq()
    v = jmodel.init(jax.random.key(0))
    jround = jfed.make_fedavg_round(jmodel, jrmsprop(1e-3), jbce,
                                    meshlib.client_mesh(1),
                                    batch_size=SHARD)
    _, jm = jround(jfed.ServerState(jnp.zeros((), jnp.int32), v.params,
                                    v.state), jnp.asarray(imgs),
                   jnp.asarray(labels), WEIGHTS, jax.random.key(1))
    assert np.isnan(float(jm["loss"]))
    assert float(jm["clients_dropped"]) == m["clients_dropped"]


def test_trimmed_mean_with_too_few_live_clients_keeps_the_server():
    """Two live clients under trim=1: the kept band is empty, so the
    server is left as it came and trim_degenerate is 1; a trim that can
    never keep a value raises, as in JAX."""
    imgs, labels = _client_data()
    weights = np.array([16.0, 16.0, 0.0, 0.0], np.float32)
    tmodel = tcore.init_params(_torch_seq(), 0)
    rnd = tfed.make_fedavg_round(tmodel, 1e-3, tbce, batch_size=SHARD,
                                 aggregator="trimmed_mean", device="cpu")
    server = tfed.ServerState.of(tmodel)
    new, m = rnd(server, imgs, labels, weights, (0, 0, 0))
    assert m["trim_degenerate"] == 1.0
    for k, v in server.params.items():
        assert torch.equal(new.params[k], v), k
    never = tfed.make_fedavg_round(
        tmodel, 1e-3, tbce, batch_size=SHARD,
        aggregator=trobust.TrimmedMean(2), device="cpu")
    with pytest.raises(ValueError, match="can never keep a value"):
        never(server, imgs, labels, WEIGHTS, (0, 0, 0))


@pytest.mark.parametrize("weights", [WEIGHTS,
                                     np.array([0, 16, 0, 4], np.float32)])
def test_federated_eval_matches_jax(weights):
    jmodel, tmodel = _jax_seq(), _torch_seq()
    v = jmodel.init(jax.random.key(4))
    convert.load_jax(tmodel, v.params, v.state)
    imgs, labels = _client_data(seed=5)
    jeval = jfed.make_federated_eval(jmodel, jbce, meshlib.client_mesh(1))
    want = jax.device_get(jeval(
        jfed.ServerState(jnp.zeros((), jnp.int32), v.params, v.state),
        jnp.asarray(imgs), jnp.asarray(labels), weights))
    teval = tfed.make_federated_eval(tmodel, tbce, device="cpu")
    got = teval(tfed.ServerState.of(tmodel), imgs, labels, weights)
    np.testing.assert_allclose(got["loss"], float(want["loss"]), rtol=1e-5)
    np.testing.assert_allclose(got["accuracy"], float(want["accuracy"]),
                               rtol=1e-6)


def test_seed_server_with_and_copy_tree():
    """Seeding replaces the server model wholesale and keeps the round;
    copy_tree snapshots survive in-place changes of the originals; the
    checkpoint tree round-trips."""
    a = tcore.init_params(_torch_seq(), 0)
    b = tcore.init_params(_torch_seq(), 1)
    pre = tfed.ServerState.of(b)
    server = tfed.seed_server_with(tfed.initialize_server(a, 0).replace(
        round=3), pre.params, pre.state)
    assert server.round == 3 and server.params is pre.params
    snap = tfed.copy_tree(server)
    server.params["head.bias"].add_(1.0)
    assert not torch.equal(snap.params["head.bias"],
                           server.params["head.bias"])
    back = tfed.ServerState.from_tree(snap.tree())
    assert back.round == 3 and back.params.keys() == snap.params.keys()
    assert all(torch.equal(back.params[k], snap.params[k])
               for k in snap.params)
    assert snap.tree()["params"]["head"]["bias"] is snap.params["head.bias"]


@pytest.mark.parametrize("name", ["mean", "norm_clip", "trimmed_mean",
                                  "median"])
def test_aggregators_match_jax_on_random_updates(name):
    """Each aggregator's combine on the same stacked updates, with a dead
    client holding NaN (which must not leak), a large attacker and a
    frozen leaf of ties, as a one-device JAX shard_map runs it."""
    from jax.sharding import PartitionSpec as P

    from idc_models_tpu.compat import shard_map

    rng = np.random.default_rng(0)
    server = {"w": rng.normal(size=(3, 5)).astype(np.float32),
              "b": rng.normal(size=(5,)).astype(np.float32),
              "frozen": rng.normal(size=(40,)).astype(np.float32)}
    upd = {k: (v[None] + rng.normal(0, 0.1, (6,) + v.shape)).astype(
        np.float32) for k, v in server.items()}
    # a frozen parameter: every client reports the server's value, and
    # the tied clients rank by index (JAX's stable argsort)
    upd["frozen"] = np.repeat(server["frozen"][None], 6, axis=0)
    upd["w"][1] += 100.0
    upd["w"][4] = np.nan
    weight = np.array([3, 1, 2, 5, 0, 4], np.float32)
    kw = {"max_norm": 1.0} if name == "norm_clip" else {}
    jagg = jrobust.get_aggregator(name, **kw)
    mesh = meshlib.client_mesh(1)
    fn = shard_map(lambda u, w, s: jagg(u, w, s, meshlib.CLIENT_AXIS),
                   mesh=mesh, in_specs=(P(meshlib.CLIENT_AXIS),
                                        P(meshlib.CLIENT_AXIS), P()),
                   out_specs=(P(), P()), check_vma=False)
    want, wm = jax.device_get(fn(upd, jnp.asarray(weight), server))
    got, gm = trobust.get_aggregator(name, **kw)(
        {k: torch.from_numpy(v) for k, v in upd.items()},
        torch.from_numpy(weight),
        {k: torch.from_numpy(v) for k, v in server.items()})
    for k in server:
        np.testing.assert_allclose(got[k].numpy(), want[k], rtol=1e-6,
                                   atol=1e-6, err_msg=k)
    assert set(gm) == set(wm)
    for k in wm:
        assert float(gm[k]) == float(wm[k]), k
