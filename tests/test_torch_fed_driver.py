"""The port's self-healing round driver (idc_models_tpu_torch/federated/
driver.py), held to the six contracts of tests/test_fed_driver.py:
healthy runs, divergence rollback, loss-spike rollback, timeout retry on
a reseeded client subset, bounded retries, checkpoint and resume; plus
reseeded_subset bit-identical to the JAX package's and the pinned
round_health fields."""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from idc_models_tpu.federated import driver as jdriver
from idc_models_tpu_torch.data import synthetic
from idc_models_tpu_torch.data.idc import ArrayDataset
from idc_models_tpu_torch.data.partition import partition_clients
from idc_models_tpu_torch.federated import (
    DriverConfig, RoundFailure, ServerState, initialize_server,
    make_fedavg_round, run_rounds,
)
from idc_models_tpu_torch.federated.driver import reseeded_subset
from idc_models_tpu_torch.models import small_cnn
from idc_models_tpu_torch.observe import JsonlLogger
from idc_models_tpu_torch.train.checkpoint import (
    checkpoint_exists, restore_checkpoint,
)
from idc_models_tpu_torch.train.losses import binary_cross_entropy

N = 8


@pytest.fixture(scope="module")
def fed():
    imgs, labels = synthetic.make_idc_like(N * 16, size=10, seed=0)
    ci, cl = partition_clients(ArrayDataset(imgs, labels), N, iid=True,
                               seed=0)
    ci = torch.as_tensor(ci, dtype=torch.float32)
    cl = torch.as_tensor(cl)
    w = np.full((N,), 16.0, np.float32)
    model = small_cnn.small_cnn(10, 3, 1)
    rnd = make_fedavg_round(model, 1e-3, binary_cross_entropy,
                            local_epochs=1, batch_size=16, device="cpu")
    return model, rnd, ci, cl, w


def _server(model, seed=0):
    return initialize_server(model, seed)


def _nan_server(s):
    return s.replace(params={k: v * float("nan")
                             for k, v in s.params.items()})


def test_healthy_run_and_history(fed, tmp_path):
    model, rnd, ci, cl, w = fed
    logger = JsonlLogger(tmp_path / "run.jsonl")
    res = run_rounds(rnd, _server(model), ci, cl, w,
                     config=DriverConfig(rounds=3), seed=1,
                     eval_fn=lambda s: {"probe": 1.0}, logger=logger)
    logger.close()
    assert res.server.round == 3
    assert [h["round"] for h in res.history] == [0, 1, 2]
    assert all(h["attempts"] == 1 and h["probe"] == 1.0
               for h in res.history)
    assert all(e["status"] == "ok" for e in res.events)
    recs = [json.loads(line)
            for line in (tmp_path / "run.jsonl").read_text().splitlines()]
    assert sum(r["event"] == "round" for r in recs) == 3
    assert sum(r["event"] == "round_health" for r in recs) == 3


def test_divergent_round_rolls_back_and_completes(fed):
    """An injected divergent round is rolled back to the last good server
    state; the retry heals it and training completes on finite params."""
    model, rnd, ci, cl, w = fed
    attempts = []

    def flaky(server, images, labels, weights, key):
        s, m = rnd(server, images, labels, weights, key)
        r = s.round - 1
        a = attempts.count(r)
        attempts.append(r)
        if r == 1 and a == 0:
            s = _nan_server(s)          # round 1 diverges on try 0
        return s, m

    res = run_rounds(flaky, _server(model), ci, cl, w,
                     config=DriverConfig(rounds=3), seed=1)
    statuses = [(e["round"], e["attempt"], e["status"])
                for e in res.events]
    assert (1, 0, "diverged") in statuses
    assert (1, 1, "ok") in statuses
    assert res.server.round == 3
    assert all(torch.isfinite(v).all() for v in res.server.params.values())
    assert res.history[1]["attempts"] == 2


def test_loss_spike_rolls_back(fed):
    model, rnd, ci, cl, w = fed
    calls = []

    def spiky(server, images, labels, weights, key):
        s, m = rnd(server, images, labels, weights, key)
        calls.append(s.round - 1)
        if s.round - 1 == 1 and calls.count(1) == 1:
            m = {**m, "loss": 1e9}      # finite but exploded
        return s, m

    res = run_rounds(spiky, _server(model), ci, cl, w,
                     config=DriverConfig(rounds=3, loss_spike_ratio=5.0),
                     seed=1)
    assert [e["status"] for e in res.events
            if e["round"] == 1] == ["diverged", "ok"]
    assert res.server.round == 3


def test_timeout_retries_with_reseeded_subset(fed):
    """A round past its wall budget is discarded and retried with a
    reseeded, smaller client subset (deterministic per (seed, round,
    attempt)); by default the driver's first attempt is exempt."""
    model, rnd, ci, cl, w = fed
    t = [0.0]
    seen = []

    def slow(server, images, labels, weights, key):
        seen.append(np.asarray(weights).copy())
        t[0] += 100.0 if len(seen) == 1 else 0.1
        return rnd(server, images, labels, weights, key)

    res = run_rounds(slow, _server(model), ci, cl, w,
                     config=DriverConfig(rounds=2, timeout_s=10.0,
                                         timeout_exempt_first=False),
                     seed=1, clock=lambda: t[0])
    assert [(e["round"], e["attempt"], e["status"])
            for e in res.events][:2] == [(0, 0, "timeout"), (0, 1, "ok")]
    assert (seen[1] > 0).sum() < (seen[0] > 0).sum()
    assert np.all(w[seen[1] > 0] > 0)
    np.testing.assert_array_equal(seen[1], reseeded_subset(w, 1, 0, 1, 0.7))
    assert res.server.round == 2

    t[0] = 0.0
    seen.clear()
    res = run_rounds(slow, _server(model), ci, cl, w,
                     config=DriverConfig(rounds=2, timeout_s=10.0),
                     seed=1, clock=lambda: t[0])
    assert all(e["status"] == "ok" for e in res.events)
    assert len(seen) == 2


def test_bounded_retries_then_raise(fed):
    model, rnd, ci, cl, w = fed

    def dead(server, images, labels, weights, key):
        s, m = rnd(server, images, labels, weights, key)
        return _nan_server(s), m

    with pytest.raises(RoundFailure, match="failed 2 attempt"):
        run_rounds(dead, _server(model), ci, cl, w,
                   config=DriverConfig(rounds=2, max_attempts=2), seed=1)

    def broken(server, images, labels, weights, key):
        raise RuntimeError("device fell off")

    with pytest.raises(RoundFailure) as ei:
        run_rounds(broken, _server(model), ci, cl, w,
                   config=DriverConfig(rounds=1, max_attempts=2), seed=1)
    assert isinstance(ei.value.__cause__, RuntimeError)
    assert ei.value.server.round == 0       # rollback anchor exposed


def test_driver_checkpoints_and_resumes(fed, tmp_path):
    """Checkpoints every 2 rounds and at the end; the restored server is
    the last good one, and resuming a finished run is a no-op. A run cut
    after round 1 and resumed equals the straight-through run, bit for
    bit (each round's key is a pure function of (seed, round, attempt))."""
    model, rnd, ci, cl, w = fed
    path = tmp_path / "server"
    res = run_rounds(rnd, _server(model), ci, cl, w,
                     config=DriverConfig(rounds=3, checkpoint_path=path,
                                         checkpoint_every=2), seed=1)
    assert checkpoint_exists(path)
    restored = ServerState.from_tree(
        restore_checkpoint(path, _server(model, 9).tree()))
    assert restored.round == 3
    for k, v in res.server.params.items():
        assert torch.equal(restored.params[k], v), k
    res2 = run_rounds(rnd, restored, ci, cl, w,
                      config=DriverConfig(rounds=3), seed=1)
    assert res2.history == [] and res2.server.round == 3

    cut = tmp_path / "cut"
    run_rounds(rnd, _server(model), ci, cl, w,
               config=DriverConfig(rounds=2, checkpoint_path=cut), seed=1)
    resumed = ServerState.from_tree(
        restore_checkpoint(cut, _server(model, 9).tree()))
    assert resumed.round == 2
    res3 = run_rounds(rnd, resumed, ci, cl, w,
                      config=DriverConfig(rounds=3), seed=1)
    assert [h["round"] for h in res3.history] == [2]
    for k, v in res.server.params.items():
        assert torch.equal(res3.server.params[k], v), k


@pytest.mark.parametrize("seed,round_idx,attempt,fraction",
                         [(1, 0, 1, 0.7), (0, 3, 2, 0.5), (7, 9, 1, 0.1),
                          (2, 1, 1, 1.0)])
def test_reseeded_subset_bit_identical_to_jax(seed, round_idx, attempt,
                                              fraction):
    w = np.array([16, 0, 12, 16, 3, 0, 16, 8, 1, 5], np.float32)
    got = reseeded_subset(w, seed, round_idx, attempt, fraction)
    want = jdriver.reseeded_subset(w, seed, round_idx, attempt, fraction)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        reseeded_subset(np.zeros(4), seed, 0, 1, 0.5), np.zeros(4))


def test_round_health_schema(tmp_path):
    """The pinned round_health fields of tests/test_observability.py and
    the driver's own round records."""
    def round_fn(server, images, labels, weights, key):
        return (ServerState(server.round + 1, server.params, server.state),
                {"loss": 0.5, "accuracy": 0.9, "clients_dropped": 0.0})

    server = ServerState(0, {"w": torch.ones(2)}, {})
    log = tmp_path / "run.jsonl"
    with JsonlLogger(log) as logger:
        res = run_rounds(round_fn, server, None, None,
                         np.ones(3, np.float32),
                         config=DriverConfig(rounds=2), logger=logger)
    assert len(res.history) == 2
    recs = [json.loads(line) for line in log.read_text().splitlines()]
    health = [r for r in recs if r["event"] == "round_health"]
    rounds = [r for r in recs if r["event"] == "round"]
    assert len(health) == 2 and len(rounds) == 2
    assert {"ts", "event", "round", "attempt", "status", "seconds",
            "participants", "loss", "accuracy",
            "clients_dropped"} <= set(health[0])
    assert health[0]["status"] == "ok" and health[0]["participants"] == 3
    assert {"round", "attempts", "loss", "accuracy"} <= set(rounds[0])


def test_driver_config_validation():
    for kw, match in (({"rounds": 0}, "rounds"),
                      ({"rounds": 1, "max_attempts": 0}, "max_attempts"),
                      ({"rounds": 1, "retry_subset_fraction": 0.0},
                       "retry_subset_fraction"),
                      ({"rounds": 1, "loss_spike_ratio": 1.0},
                       "loss_spike_ratio")):
        with pytest.raises(ValueError, match=match):
            DriverConfig(**kw)
        with pytest.raises(ValueError, match=match):
            jdriver.DriverConfig(**kw)
