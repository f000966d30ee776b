"""The port's `fed` verb (idc_models_tpu_torch/cli.py, _run_fed) on the
CPU at a small size: pretrain, partition, rounds under the driver,
checkpoints and resume; and what it refuses."""

from __future__ import annotations

import json
import shutil

import numpy as np
import pytest
import torch

from idc_models_tpu_torch import cli
from idc_models_tpu_torch.train.checkpoint import checkpoint_exists

# VGG16 at the preset's width on 50x50 patches; five clients (four train,
# one test) of eight patches keep a round to a few seconds on one thread
ARGV = ["fed", "--device", "cpu", "--synthetic-examples", "40",
        "--num-clients", "5", "--batch-size", "8", "--pretrain-epochs", "1"]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One torch thread a worker: VGG16's many small CPU ops stall on
    OpenMP barriers when six workers share a few cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _records(path):
    return [json.loads(line) for line in
            (path / "logs" / "run.jsonl").read_text().splitlines()]


def _printed_rounds(out: str) -> list[str]:
    return [ln.split(",")[0] for ln in out.splitlines()
            if ln[:1].isdigit() and ln.count(",") == 4]


@pytest.fixture(scope="module")
def first_run(tmp_path_factory):
    """`fed --rounds 2` once for the module: its run directory and
    standard output. Tests copy the directory before touching it."""
    import contextlib
    import io

    path = tmp_path_factory.mktemp("fed") / "run"
    out = io.StringIO()
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with contextlib.redirect_stdout(out):
            assert cli.main(ARGV + ["--rounds", "2", "--path",
                                    str(path)]) == 0
    finally:
        torch.set_num_threads(n)
    return path, out.getvalue()


def _copy(first_run, tmp_path, what=None):
    src, _ = first_run
    dst = tmp_path / "run"
    shutil.copytree(src / what if what else src,
                    dst / what if what else dst)
    return dst


def test_fed_pretrains_runs_rounds_and_checkpoints(first_run):
    path, out = first_run
    assert "Pre-training for 1 epochs" in out
    assert "round, train_loss, train_acc, test_loss, test_acc" in out
    assert _printed_rounds(out) == ["0", "1"]
    assert checkpoint_exists(path / "pretrained" / "cp.ckpt")
    assert checkpoint_exists(path / "fed_server")
    recs = _records(path)
    rounds = [r for r in recs if r["event"] == "round"]
    assert [r["round"] for r in rounds] == [0, 1]
    for r in rounds:
        assert set(r) == {"ts", "event", "round", "train_loss", "train_acc",
                          "test_loss", "test_acc", "clients_dropped"}
        assert all(np.isfinite(r[k]) for k in ("train_loss", "test_loss"))
        assert r["clients_dropped"] == 0
    health = [r for r in recs if r["event"] == "round_health"]
    assert [(h["round"], h["status"], h["participants"])
            for h in health] == [(0, "ok", 4), (1, "ok", 4)]


def test_fed_resumes_the_pretrained_weights_and_the_server(first_run,
                                                          tmp_path, capsys):
    """The same argv at three rounds restores the pretrained weights and
    the server, runs round 2 only, and appends exactly one new `round`
    record."""
    path = _copy(first_run, tmp_path)
    assert cli.main(ARGV + ["--rounds", "3", "--path", str(path)]) == 0
    out = capsys.readouterr().out
    assert "restored pretrained weights from" in out
    assert "resuming federated training from round 2" in out
    assert "Pre-training" not in out
    assert _printed_rounds(out) == ["2"]
    logged = [r["round"] for r in _records(path) if r["event"] == "round"]
    assert logged == [0, 1, 2]


def test_fed_replayed_round_is_not_logged_twice(first_run, tmp_path,
                                                capsys):
    """A server saved at round 1 (as an every-N save leaves it when the
    run dies before its final save) replays round 1: it prints again but
    adds no second `round` record."""
    from idc_models_tpu_torch.train.checkpoint import (
        restore_checkpoint, save_checkpoint,
    )

    path = _copy(first_run, tmp_path)
    tree = restore_checkpoint(path / "fed_server")
    assert int(tree["round"]) == 2
    save_checkpoint(path / "fed_server", {**tree, "round": np.int32(1)})
    assert cli.main(ARGV + ["--rounds", "2", "--path", str(path)]) == 0
    assert _printed_rounds(capsys.readouterr().out) == ["1"]
    logged = [r["round"] for r in _records(path) if r["event"] == "round"]
    assert logged == [0, 1]


def _first_train_client() -> int:
    from idc_models_tpu_torch.data.partition import train_test_client_split

    return int(train_test_client_split(5, 0.2, seed=0)[0][0])


def test_fed_drops_a_nan_poisoner(first_run, tmp_path, capsys):
    path = _copy(first_run, tmp_path, "pretrained")
    assert cli.main(ARGV + ["--rounds", "1", "--faults",
                            f"nan:{_first_train_client()}",
                            "--path", str(path)]) == 0
    assert "dropped 1 client(s)" in capsys.readouterr().err
    (h,) = [r for r in _records(path) if r["event"] == "round_health"]
    assert h["clients_dropped"] == 1.0 and h["participants"] == 4
    assert np.isfinite(h["loss"])


def test_fed_trimmed_mean_under_a_sign_flipper(first_run, tmp_path):
    path = _copy(first_run, tmp_path, "pretrained")
    assert cli.main(ARGV + ["--rounds", "1", "--faults",
                            f"sign_flip:{_first_train_client()}:x1000",
                            "--aggregator", "trimmed_mean", "--trim", "1",
                            "--path", str(path)]) == 0
    (h,) = [r for r in _records(path) if r["event"] == "round_health"]
    assert np.isfinite(h["loss"]) and "clients_trimmed" in h
    assert h["clients_dropped"] == 0.0


@pytest.mark.parametrize("argv,match", [
    (["--population", "8"], "exceeds --population 8"),
    (["--population", "64", "--async-buffer", "4", "--cohort-wave", "8"],
     "only applies to synchronous"),
    (["--checkpoint-every", "0"], "must be >= 1"),
    (["--loss-spike-ratio", "0.5"], "must be > 1"),
])
def test_fed_refuses(argv, match):
    with pytest.raises(SystemExit, match=match):
        cli.main(["fed", "--device", "cpu", *argv])


def test_fed_raises_without_a_card_unless_given_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["fed", "--synthetic-examples", "40"])
