"""Epoch-granular resume of the port's training loops
(idc_models_tpu_torch/train/loop.py: fit and two_phase_fit with
checkpoint_dir) and the classifier verbs' --resumable /
--checkpoint-every, on the CPU. The JAX package's contract: a run cut
after any epoch and restarted with the same arguments ends with the
straight-through run's history and weights, bit for bit."""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from idc_models_tpu_torch import cli
from idc_models_tpu_torch.data import synthetic as tsynthetic
from idc_models_tpu_torch.data.idc import ArrayDataset
from idc_models_tpu_torch.models import core as tcore
from idc_models_tpu_torch.train import loop as tloop
from idc_models_tpu_torch.train import losses as tlosses
from idc_models_tpu_torch.train.state import TrainState, rmsprop


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The suite runs in several worker processes on a few cores; one
    torch thread each keeps VGG16's many small CPU ops from stalling on
    OpenMP barriers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class Interrupt(Exception):
    pass


class CrashAfter:
    """A logger that kills the run when epoch `epoch` reports, after the
    epoch trained and before its checkpoint is written."""

    def __init__(self, epoch: int):
        self.epoch = epoch

    def log(self, **rec):
        if rec.get("event") == "epoch" and rec["epoch"] == self.epoch:
            raise Interrupt(f"killed at epoch {self.epoch}")


def _data(n=48, size=8):
    imgs, labels = tsynthetic.make_idc_like(n, size=size, seed=0)
    imgs = imgs.astype(np.float32)
    return (ArrayDataset(imgs[:32], labels[:32]),
            ArrayDataset(imgs[32:], labels[32:]))


def _state():
    m = tcore.init_params(tcore.Classifier(
        tcore.Conv2d(3, 4, 3, name="stem"), 4, 1), 0)
    return TrainState(m, rmsprop(m, 1e-2))


def _same_weights(a: torch.nn.Module, b: torch.nn.Module):
    sa, sb = a.state_dict(), b.state_dict()
    assert sa.keys() == sb.keys()
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k


@pytest.mark.parametrize("crash_at,every", [(0, 1), (2, 1), (3, 2),
                                            (4, 2)])
def test_interrupted_fit_resumes_bit_for_bit(tmp_path, crash_at, every):
    train, val = _data()
    bce = tlosses.binary_cross_entropy
    straight = _state()
    want = tloop.fit(straight, bce, train, val, epochs=5, batch_size=8,
                     verbose=False)
    cut = _state()
    with pytest.raises(Interrupt):
        tloop.fit(cut, bce, train, val, epochs=5, batch_size=8,
                  verbose=False, logger=CrashAfter(crash_at),
                  checkpoint_dir=tmp_path, checkpoint_every=every)
    saved = json.loads((tmp_path / "meta.json").read_text())["epoch"] \
        if (tmp_path / "meta.json").exists() else 0
    assert saved == crash_at // every * every
    resumed = _state()
    got = tloop.fit(resumed, bce, train, val, epochs=5, batch_size=8,
                    verbose=False, checkpoint_dir=tmp_path,
                    checkpoint_every=every)
    assert got == want
    assert resumed.step == straight.step == 5 * 4
    _same_weights(resumed.model, straight.model)
    assert resumed.optimizer.state_dict()["state"].keys() == \
        straight.optimizer.state_dict()["state"].keys()
    for i, s in straight.optimizer.state_dict()["state"].items():
        r = resumed.optimizer.state_dict()["state"][i]
        assert all(torch.equal(s[k], r[k]) for k in s)
    # only the newest state is kept beside meta.json
    assert sorted(p.name for p in tmp_path.iterdir()) == ["meta.json",
                                                         "state_e5"]


def test_fingerprint_mismatch_warns_and_trains_from_scratch(tmp_path):
    train, val = _data()
    bce = tlosses.binary_cross_entropy
    tloop.fit(_state(), bce, train, val, epochs=2, batch_size=8,
              verbose=False, checkpoint_dir=tmp_path)
    other = _state()
    with pytest.warns(UserWarning, match="belongs to a different run"):
        got = tloop.fit(other, bce, train, val, epochs=2, batch_size=8,
                        seed=1, verbose=False, checkpoint_dir=tmp_path)
    want_state = _state()
    want = tloop.fit(want_state, bce, train, val, epochs=2, batch_size=8,
                     seed=1, verbose=False)
    assert got == want
    _same_weights(other.model, want_state.model)


def test_more_saved_epochs_than_asked_raises(tmp_path):
    train, val = _data()
    bce = tlosses.binary_cross_entropy
    tloop.fit(_state(), bce, train, val, epochs=3, batch_size=8,
              verbose=False, checkpoint_dir=tmp_path)
    with pytest.raises(ValueError, match="trained for 3 epochs but this "
                                         "run asks for 2"):
        tloop.fit(_state(), bce, train, val, epochs=2, batch_size=8,
                  verbose=False, checkpoint_dir=tmp_path)


@pytest.mark.parametrize("cache_features", [False, True])
@pytest.mark.parametrize("crash_at", [1, 2])
def test_interrupted_two_phase_fit_resumes_bit_for_bit(tmp_path,
                                                       cache_features,
                                                       crash_at):
    """VGG16 on 32x32 patches, two epochs a phase, killed in phase 1
    (epoch 1) or phase 2 (epoch 2), restarted: the histories, the step
    counts and the final weights are the straight-through run's; the
    phases keep their own directories."""
    imgs, labels = tsynthetic.make_idc_like(24, size=32, seed=0)
    train = ArrayDataset(imgs[:16], labels[:16])
    val = ArrayDataset(imgs[16:], labels[16:])
    cfg = tloop.TwoPhaseConfig(epochs=2, fine_tune_epochs=2, batch_size=8,
                               eval_steps=1, cache_features=cache_features)
    want = tloop.two_phase_fit("vgg16", 1, train, val, cfg, device="cpu")
    with pytest.raises(Interrupt):
        tloop.two_phase_fit("vgg16", 1, train, val, cfg,
                            logger=CrashAfter(crash_at), device="cpu",
                            checkpoint_dir=tmp_path)
    got = tloop.two_phase_fit("vgg16", 1, train, val, cfg, device="cpu",
                              checkpoint_dir=tmp_path)
    assert got.history == want.history
    assert got.history_fine == want.history_fine
    assert got.train_steps == want.train_steps
    _same_weights(got.model, want.model)
    assert sorted(p.name for p in tmp_path.iterdir()) == ["phase1",
                                                         "phase2"]


@pytest.mark.parametrize("verb", ["vgg", "mobile", "dense"])
@pytest.mark.parametrize("argv,match", [
    (["--resumable"], "requires --path"),
    (["--resumable", "--path", "x", "--checkpoint-every", "0"],
     "must be >= 1"),
    (["--checkpoint-every", "2"], "needs --resumable"),
])
def test_cli_resumable_checks(verb, argv, match):
    with pytest.raises(SystemExit, match=match):
        cli.main([verb, "--device", "cpu", *argv])


def test_cli_vgg_resumable_resumes_from_dist_ckpt(tmp_path, capsys):
    """`vgg --resumable` writes <path>/dist_ckpt/phase{1,2}; a rerun
    restores both phases instead of training and reports the same test
    metrics."""
    argv = ["vgg", "--device", "cpu", "--synthetic-examples", "32",
            "--batch-size", "8", "--epochs", "1", "--fine-tune-epochs", "1",
            "--resumable", "--path", str(tmp_path)]
    assert cli.main(argv) == 0
    first = capsys.readouterr().out
    assert sorted(p.name for p in (tmp_path / "dist_ckpt").iterdir()) == [
        "phase1", "phase2"]
    assert cli.main(argv) == 0
    second = capsys.readouterr().out
    assert "epoch 1/1" in first and "epoch 1/1" not in second
    assert "resuming fit from epoch 2" in second
    test_line = [ln for ln in first.splitlines() if ln.startswith("test:")]
    assert test_line and test_line == [
        ln for ln in second.splitlines() if ln.startswith("test:")]
