"""The port's federated rounds over several ranks (ROADMAP A4-client:
``mesh.client_mesh``, the FedAvg, secure and population rounds over a
"client" group, `run_rounds` in lockstep, the verbs over a
``--host-devices`` pod) against the JAX package's rounds on
``client_mesh(4)`` and against the port's own one-rank rounds.

Four gloo ranks start once for the module from `tests/_torch_fed_worker.py`
(torch and the port only), given the JAX package's initial weights of the
dropout-free model; the JAX side runs here, on the conftest's virtual
devices. Tolerances: against JAX, rtol 1e-5 / atol 2e-6 on the
aggregates, as `tests/test_torch_secure.py` holds a trained round (one
full-shard step an epoch, so the packages' permutations cannot matter);
against one rank, the secure round's protected leaves bit for bit (the
masks cancel whatever the layout) and the rest within rtol 1e-6 of the
largest value (the sums over the group add the ranks' partials in
another order)."""

from __future__ import annotations

import functools
import os
import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from idc_models_tpu import faults as jfaults
from idc_models_tpu import mesh as meshlib
from idc_models_tpu.federated import fedavg as jfed
from idc_models_tpu.federated import population as jpop
from idc_models_tpu.federated import robust as jrobust
from idc_models_tpu.models import core as jcore
from idc_models_tpu.secure import fedavg as jsecure
from idc_models_tpu.train import rmsprop as jrmsprop
from idc_models_tpu.train.losses import binary_cross_entropy as jbce
from idc_models_tpu_torch import cli, collectives, convert
from idc_models_tpu_torch import mesh as tmesh
from idc_models_tpu_torch.federated import fedavg as tfed
from idc_models_tpu_torch.federated import driver as tdriver
from idc_models_tpu_torch.models import registry as tregistry
from idc_models_tpu_torch.secure import fedavg as tsecure
from idc_models_tpu_torch.train.losses import binary_cross_entropy as tbce

import _torch_fed_worker as worker

WORKER = Path(worker.__file__)
WORLD = worker.WORLD
DEADLINE_S = 240.0
RTOL, ATOL = 1e-5, 2e-6
ONE_RANK_TOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Several test workers share a few cores: one torch thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_seq():
    return jcore.sequential(
        [jcore.conv2d(3, 4, 3, name="c1"), jcore.relu(),
         jcore.max_pool(2, name="pool"), jcore.flatten(),
         jcore.dense(100, 1, name="head")], name="seq")


@functools.cache
def _init():
    v = jax.device_get(_jax_seq().init(jax.random.key(0)))
    return (jax.tree.map(np.array, v.params),
            jax.tree.map(np.array, v.state))


def _server():
    params, state = _init()
    return jfed.ServerState(jnp.zeros((), jnp.int32),
                            jax.tree.map(jnp.asarray, params),
                            jax.tree.map(jnp.asarray, state))


class _Ranks:
    """The worker processes of one module run: started with the inputs
    written, waited for (all killed past the deadline or when one
    fails), the results loaded."""

    def __init__(self, out: Path):
        self.out = out
        params, state = _init()
        flat = {f"seq/params/{k}": v
                for k, v in convert.flatten(params).items()}
        flat.update({f"seq/state/{k}": v
                     for k, v in convert.flatten(state).items()})
        np.savez(out / "inputs.npz", **flat)
        env = dict(os.environ, OMP_NUM_THREADS="1", CUDA_VISIBLE_DEVICES="")
        self.logs = [open(out / f"log.{r}", "w") for r in range(WORLD)]
        self.procs = [subprocess.Popen(
            [sys.executable, str(WORKER), str(out / "store"), str(WORLD),
             str(r), str(out)], stdout=log, stderr=subprocess.STDOUT,
            env=env) for r, log in enumerate(self.logs)]
        self.started = time.monotonic()

    def kill(self) -> None:
        for p in self.procs:
            if p.poll() is None:
                p.kill()
        for p in self.procs:
            p.wait(timeout=30)
        for log in self.logs:
            if not log.closed:
                log.close()

    def wait(self):
        while any(p.poll() is None for p in self.procs):
            failed = any(p.poll() not in (None, 0) for p in self.procs)
            if failed or time.monotonic() - self.started > DEADLINE_S:
                break
            time.sleep(0.1)
        self.kill()
        codes = [p.returncode for p in self.procs]
        if codes != [0] * WORLD:
            logs = "\n".join(f"--- rank {r}:\n"
                             + (self.out / f"log.{r}").read_text()[-3000:]
                             for r in range(WORLD))
            pytest.fail(f"federated ranks ended with {codes}\n{logs}")
        return (dict(np.load(self.out / "results.npz")),
                [dict(np.load(self.out / f"rank{r}.npz"))
                 for r in range(WORLD)])


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    run = _Ranks(tmp_path_factory.mktemp("fed_ranks"))
    try:
        yield run.wait()
    finally:
        run.kill()


def _case(results, name) -> dict:
    """A case's server leaves (dotted names) from the results."""
    return {k[len(name) + 1:]: v for k, v in results.items()
            if k.startswith(name + "/") and "/m/" not in k
            and not k.endswith(("/round", "/launches"))}


def _metrics(results, name) -> dict:
    pre = f"{name}/m/"
    return {k[len(pre):]: float(v) for k, v in results.items()
            if k.startswith(pre)}


def _flat(tree) -> dict:
    return {k.replace("/", "."): np.asarray(v)
            for k, v in convert.flatten(tree).items()}


def _against_jax(results, name, jparams, jm, metrics_of=None):
    """Case `name`'s server against JAX's params, its metrics (those of
    `metrics_of`, default `name`) against JAX's `jm`."""
    got = _case(results, name)
    want = _flat(jparams)
    assert set(got) == set(want)
    for k, w in want.items():
        assert np.isfinite(w).all(), k
        np.testing.assert_allclose(got[k], w, rtol=RTOL, atol=ATOL,
                                   err_msg=f"{name} {k}")
    tm = _metrics(results, metrics_of or name)
    assert set(tm) == set(jm), (set(tm), set(jm))
    np.testing.assert_allclose(tm["loss"], jm["loss"], rtol=RTOL)
    for k in set(jm) - {"loss"}:
        np.testing.assert_allclose(tm[k], jm[k], rtol=1e-6, err_msg=k)


def _against_one_rank(results, base, exact=()):
    """The 4-rank case `base`4 against the one-rank `base`1: the leaves
    in `exact` bit for bit, the rest within ONE_RANK_TOL of the largest
    value; the metrics likewise."""
    got, want = _case(results, base + "4"), _case(results, base + "1")
    assert set(got) == set(want) and got
    for k, w in want.items():
        if k in exact:
            assert np.array_equal(got[k], w), k
        else:
            np.testing.assert_allclose(
                got[k], w, rtol=ONE_RANK_TOL,
                atol=ONE_RANK_TOL * float(np.abs(w).max()), err_msg=k)
    m4 = {k[len(base) + 2:]: v for k, v in results.items()
          if k.startswith(base + "4/") and "/m/" in k}
    m1 = {k[len(base) + 2:]: v for k, v in results.items()
          if k.startswith(base + "1/") and "/m/" in k}
    assert set(m4) == set(m1) and m4
    for k, w in m1.items():
        np.testing.assert_allclose(m4[k], w, rtol=ONE_RANK_TOL, err_msg=k)


# ---------------------------------------------------------------------------
# against the JAX package's rounds on client_mesh(4)
# ---------------------------------------------------------------------------


def test_fedavg_over_four_ranks_matches_jax_client_mesh_4(ranks):
    """8 clients (2 of weight 0) over 4 ranks, two a rank: the aggregate
    and the metrics against JAX's round on client_mesh(4)."""
    results, _ = ranks
    imgs, labels = worker.client_data(worker.N_FED, worker.FED_SEED)
    jround = jfed.make_fedavg_round(
        _jax_seq(), jrmsprop(worker.LR), jbce, meshlib.client_mesh(WORLD),
        local_epochs=1, batch_size=worker.SHARD)
    js, jm = jround(_server(), jnp.asarray(imgs), jnp.asarray(labels),
                    worker.FED_WEIGHTS, jax.random.key(1))
    jm = {k: float(x) for k, x in jax.device_get(jm).items()}
    _against_jax(results, "fed4", jax.device_get(js.params), jm,
                 metrics_of="fed4/r0")


def test_secure_round_six_clients_on_four_ranks_matches_jax(ranks):
    """6 clients on 4 ranks (8 slots: 2 dummies that join the masks and
    add zero): the aggregate and the metrics, both mask impls, against
    JAX's round on client_mesh(4), which pads the same way."""
    results, _ = ranks
    imgs, labels = worker.client_data(worker.N_SECURE, worker.SECURE_SEED)
    jround = jsecure.make_secure_fedavg_round(
        _jax_seq(), jrmsprop(worker.LR), jbce, meshlib.client_mesh(WORLD),
        percent=worker.PERCENT, local_epochs=worker.SECURE_EPOCHS,
        batch_size=worker.SHARD)
    with pytest.warns(UserWarning, match="padding 6 host-resident"):
        js, jm = jround(_server(), imgs, labels, jax.random.key(1))
    jm = {k: float(x) for k, x in jax.device_get(jm).items()}
    for impl in worker.SECURE_IMPLS:
        _against_jax(results, f"secure_{impl}4",
                     jax.device_get(js.params), jm)


def test_population_two_waves_of_four_match_jax(ranks):
    """A cohort of 8 in 2 waves of 4 over 4 ranks (one client a rank a
    wave, each rank materializing its own): against JAX's streamed round
    on client_mesh(4)."""
    results, _ = ranks
    pop = jpop.ClientPopulation(worker.POPULATION,
                                examples_per_client=worker.POP_EXAMPLES,
                                image_size=10, seed=0)
    jround = jpop.make_population_round(
        _jax_seq(), jrmsprop(worker.LR), jbce, meshlib.client_mesh(WORLD),
        pop, jpop.CohortSampler(pop, worker.COHORT, seed=1),
        wave_size=worker.WAVE, batch_size=worker.POP_EXAMPLES)
    js, jm = jround(_server(), None, None, None, jax.random.key(2),
                    round_idx=0)
    jm = {k: float(x) for k, x in jax.device_get(jm).items()}
    _against_jax(results, "pop4", jax.device_get(js.params), jm)
    assert _metrics(results, "pop4")["waves"] == 2


# ---------------------------------------------------------------------------
# against the port's one-rank rounds
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["secure", "secure_agg"])
@pytest.mark.parametrize("impl", worker.SECURE_IMPLS)
def test_secure_protected_part_equals_one_rank_bit_for_bit(ranks, impl,
                                                           case):
    """The protected leaves of the 4-rank secure round (6 clients, 2
    dummy slots, global ids and n_total = 8 in every rank's masks, int64
    partials summed over the group and wrapped once), and of
    `secure_aggregate` alone over seeded updates, equal the one-rank
    run's bit for bit; the plain part within rounding."""
    results, _ = ranks
    prot = {str(p) for p in results["secure_protected"]}
    assert prot == {"c1.kernel", "c1.bias"}
    _against_one_rank(results, f"{case}_{impl}", exact=prot)
    if case == "secure":
        assert int(results[f"secure_{impl}4/launches"]) == 0   # the CPU


@pytest.mark.parametrize("base", ["fed", "trim", "faults", "pop"])
def test_rounds_over_four_ranks_equal_one_rank(ranks, base):
    """FedAvg, the trimmed mean (the live updates all-gathered over the
    group), a fault plan over two rounds (crash, NaN, a straggler, a
    sign flip; each rank applying its block's codes) and the population
    round against the same rounds with no mesh."""
    results, _ = ranks
    _against_one_rank(results, base)
    if base == "faults":
        m = _metrics(results, "faults4/r1")
        assert m["clients_dropped"] == 1.0


def test_population_round_is_bit_identical_with_replicated_rules(ranks):
    """`rules=REPLICATED_RULES` on the client mesh resolves every server
    leaf to replicated: the round equals the rule-free one bit for bit
    (tests/test_partition.py:474's contract)."""
    results, _ = ranks
    a, b = _case(results, "pop4"), _case(results, "pop4rules")
    assert set(a) == set(b) and a
    for k in a:
        assert np.array_equal(a[k], b[k]), k
    assert _metrics(results, "pop4") == _metrics(results, "pop4rules")


def test_every_rank_returns_the_same_server(ranks):
    """Every rank of the mesh, and rank 3 outside a mesh of three ranks
    (3 clients), returns rank 0's server bit for bit."""
    _, per_rank = ranks
    for r in range(1, WORLD):
        for k, v in per_rank[0].items():
            if "/m/" in k:
                continue
            assert np.array_equal(per_rank[r][k], v), (r, k)
    assert any(k.startswith("secure3/") for k in per_rank[3])


# ---------------------------------------------------------------------------
# the pieces, in this process
# ---------------------------------------------------------------------------


def test_client_mesh_and_layout_in_a_world_of_one():
    m = tmesh.client_mesh()
    assert m.shape == {"client": 1} and m.coords == {"client": 0}
    lay = tfed.ClientLayout.of(m)
    assert (lay.size, lay.index, lay.outside, lay.share_world) == (
        1, 0, False, False)
    x = torch.arange(6)
    assert lay.block(x, 6) is x
    with pytest.raises(ValueError, match="'client' axis"):
        tfed.ClientLayout.of(tmesh.data_mesh(1))
    four = tfed.ClientLayout(None, 4, 2)
    assert four.block(torch.arange(8), 8).tolist() == [4, 5]
    with pytest.raises(ValueError, match="pass all 8 or this rank's block"):
        four.block(torch.arange(3), 8)


def test_rules_that_split_the_server_are_refused():
    """A rule set resolving a server leaf onto the "client" axis would
    leave ranks with pieces of the server: the placement refuses it."""
    from idc_models_tpu_torch import partition
    from idc_models_tpu_torch.models import core as tcore

    model = tcore.init_params(worker.seq_model(), 0)
    server = tfed.ServerState.of(model)
    split = partition.PartitionRules([
        (".*head/kernel", tmesh.P("client", None)), (".*", tmesh.P())])

    class TwoRanks:
        shape = {"client": 2}
        axis_names = ("client",)

    place = tfed.place_server(TwoRanks(), split)
    with pytest.raises(partition.PartitionError, match="server whole"):
        place(server)
    same = tfed.place_server(tmesh.client_mesh(), tregistry.REPLICATED_RULES)
    assert same(server) is server


def test_secure_round_checks_its_slot_counts():
    from idc_models_tpu_torch.models import core as tcore

    model = tcore.init_params(worker.seq_model(), 0)
    rnd = tsecure.make_secure_fedavg_round(
        model, 1e-3, tbce, percent=0.5, local_epochs=1, batch_size=16,
        device="cpu")
    imgs, labels = worker.client_data(2, 3)
    server = tfed.ServerState.of(model)
    with pytest.raises(ValueError, match="pass n_real"):
        rnd(server, None, None, torch.Generator())
    with pytest.raises(ValueError, match="hold the 3 real clients"):
        rnd(server, imgs, labels, torch.Generator(), n_real=3, n_total=2)


def test_driver_lockstep_in_a_world_of_one_keeps_every_decision():
    """`lockstep=True` settles each attempt's status and seconds over the
    world (`collectives.world_max`): in a world of one it changes
    nothing, and a checkpoint is written by rank 0."""
    assert collectives.world_max([1.0, 2.5]) == [1.0, 2.5]
    calls = []

    def round_fn(server, images, labels, weights, key):
        calls.append(key)
        return server.replace(round=server.round + 1), {"loss": 1.0}

    server = tfed.ServerState(0, {"w": torch.zeros(2)}, {})
    res = tdriver.run_rounds(round_fn, server, None, None,
                             np.ones(2, np.float32),
                             config=tdriver.DriverConfig(rounds=2),
                             lockstep=True)
    assert [e["status"] for e in res.events] == ["ok", "ok"]
    assert calls == [(0, 0, 0), (0, 1, 0)] and res.server.round == 2


# ---------------------------------------------------------------------------
# the verbs over a --host-devices pod
# ---------------------------------------------------------------------------


def _npz(path) -> dict:
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def test_secure_fed_verb_over_four_ranks_equals_one_rank(tmp_path, capsys,
                                                         monkeypatch):
    """`secure-fed --host-devices 4 --num-clients 6` (6 clients on 4
    ranks, 2 dummy slots) prints the one-rank run's rounds and writes its
    model: the protected leaves bit for bit, the rest within rounding."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    argv = ["secure-fed", "--synthetic-examples", "160", "--num-clients",
            "6", "--rounds", "2", "--local-epochs", "1"]
    outs = {}
    for name, extra in (("one", ["--device", "cpu"]),
                        ("pod", ["--host-devices", "4"])):
        assert cli.main([*argv, *extra, "--path", str(tmp_path / name)]) \
            == 0
        outs[name] = [ln.split(" test_loss")[0] for ln in
                      capsys.readouterr().out.splitlines()
                      if ln.startswith("round ")]
    assert outs["one"] == outs["pod"] and len(outs["one"]) == 2
    one, pod = (_npz(tmp_path / n / "model.npz") for n in ("one", "pod"))
    assert set(one) == set(pod)
    # the small CNN's first half of its get_weights() enumeration
    from idc_models_tpu_torch.models import small_cnn
    from idc_models_tpu_torch.secure import masking

    model = small_cnn.small_cnn(10, 3, 1)
    pf, sf = masking.first_fraction_selection_weights(
        dict(model.named_parameters()), dict(model.named_buffers()), 0.5,
        model.layer_names)
    prot = {n for n, f in {**pf, **sf}.items() if f}
    assert prot
    for k, w in one.items():
        name = k.split("/", 1)[1].replace("/", ".")
        if name in prot:
            assert np.array_equal(pod[k], w), k
        else:
            np.testing.assert_allclose(pod[k], w, rtol=ONE_RANK_TOL,
                                       atol=ONE_RANK_TOL
                                       * float(np.abs(w).max()), err_msg=k)


def test_fed_verb_over_four_ranks_resumes_on_every_rank_as_one_rank_does(
        tmp_path, capsys, monkeypatch):
    """`fed --host-devices 4` (5 clients on a client mesh of 4, padded to
    8 with weight-0 dummies) runs two rounds and stops; rerun to three,
    every rank restores rank 0's checkpoint and resumes at round 2. A
    one-rank run resumed from the same checkpoint prints the same round
    and ends on the same server (the group's sums add in another order).
    Later rounds are not compared: from servers a rounding apart, the
    clients' first RMSprop step (of slope lr/eps at a zero gradient)
    scatters such differences past any tight bar (PERF.md)."""
    import shutil

    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    argv = ["fed", "--synthetic-examples", "40", "--num-clients", "5",
            "--batch-size", "8", "--pretrain-epochs", "0"]
    pod, one = tmp_path / "pod", tmp_path / "one"
    assert cli.main([*argv, "--host-devices", "4", "--rounds", "2",
                     "--path", str(pod)]) == 0
    first = capsys.readouterr().out
    assert "over 4 ranks (client=4)" in first
    shutil.copytree(pod, one)
    outs = {}
    for name, path, extra in (("pod", pod, ["--host-devices", "4"]),
                              ("one", one, ["--device", "cpu"])):
        assert cli.main([*argv, *extra, "--rounds", "3", "--path",
                         str(path)]) == 0
        out = capsys.readouterr().out
        assert "resuming federated training from round 2" in out, name
        outs[name] = [ln for ln in out.splitlines() if ln.startswith("2, ")]
    assert outs["pod"] == outs["one"] and len(outs["one"]) == 1
    want = _npz(one / "fed_server" / "state.npz")
    got = _npz(pod / "fed_server" / "state.npz")
    assert set(got) == set(want) and int(got["round"]) == 3
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=ONE_RANK_TOL,
                                   atol=ONE_RANK_TOL
                                   * float(np.abs(w).max() or 1.0),
                                   err_msg=k)
