"""`fed --population` and `fed --population --async-buffer` of the port's
CLI on the CPU: the runs, their records and resume, and every refusal
with the JAX package's exit text.

Small size: the small CNN at 10x10 (`--model small_cnn`), populations of
64, cohorts of 8, shards of 8 at batch 8."""

from __future__ import annotations

import json

import numpy as np
import pytest

from idc_models_tpu import cli as jcli
from idc_models_tpu_torch import cli
from idc_models_tpu_torch.train.checkpoint import checkpoint_exists

POP = ["fed", "--population", "64", "--cohort", "8", "--batch-size", "8",
       "--client-examples", "8", "--model", "small_cnn"]


def _records(path):
    return [json.loads(line) for line in
            (path / "logs" / "run.jsonl").read_text().splitlines()]


def _rounds_printed(out: str) -> list[int]:
    return [int(line.split(",")[0]) for line in out.splitlines()
            if line[:1].isdigit() and line.count(",") == 4]


def test_fed_population_runs_and_resumes(tmp_path, capsys):
    """Two streamed rounds of two waves, then a resume to four that runs
    rounds 2-3 alone (the cohorts are drawn again from (seed, round)),
    one round and one fed_cohort record a round."""
    path = tmp_path / "run"
    argv = ["--device", "cpu", "--cohort-wave", "4", "--weighted-sampling",
            "--faults", "crash:*:5%", "--path", str(path)]
    assert cli.main(POP + argv + ["--rounds", "2"]) == 0
    out = capsys.readouterr().out
    assert _rounds_printed(out) == [0, 1]
    assert ("population: 64 virtual clients, cohort 8 (weighted) in 2 "
            "wave(s) of 4; memory bounded by the wave, not the population"
            in out)
    assert checkpoint_exists(path / "fed_server")
    assert cli.main(POP + argv + ["--rounds", "4"]) == 0
    out = capsys.readouterr().out
    assert "resuming federated training from round 2" in out
    assert _rounds_printed(out) == [2, 3]
    recs = _records(path)
    rounds = [r for r in recs if r["event"] == "round"]
    cohorts = [r for r in recs if r["event"] == "fed_cohort"]
    assert [r["round"] for r in rounds] == [0, 1, 2, 3]
    assert [r["round"] for r in cohorts] == [0, 1, 2, 3]
    assert all(c["mode"] == "sync" and c["waves"] == 2 for c in cohorts)
    for r in rounds:
        assert all(np.isfinite(r[k]) for k in ("train_loss", "train_acc",
                                               "test_loss", "test_acc"))
    health = [r for r in recs if r["event"] == "round_health"]
    assert [h["status"] for h in health] == ["ok"] * 4
    assert all(h["participants"] == 8 for h in health)


def test_fed_async_buffer_runs(tmp_path, capsys):
    path = tmp_path / "run"
    assert cli.main(POP + ["--device", "cpu", "--rounds", "2",
                           "--async-buffer", "4", "--staleness-decay", "0.8",
                           "--path", str(path)]) == 0
    out = capsys.readouterr().out
    assert _rounds_printed(out) == [0, 1]
    assert ("memory bounded by the in-flight pool, not the population"
            in out)
    line = next(x for x in out.splitlines() if x.startswith("async buffer"))
    assert line.startswith("async buffer: K=4, staleness decay 0.8, 4 "
                           "buffered update(s), mean staleness ")
    cohorts = [r for r in _records(path) if r["event"] == "fed_cohort"]
    assert [c["mode"] for c in cohorts] == ["async", "async"]
    assert [c["updates"] for c in cohorts] == [2, 2]
    assert all(sum(c["staleness_hist"]) == 8 for c in cohorts)


def test_fed_async_warns_of_inert_stragglers(capsys):
    assert cli.main(POP + ["--device", "cpu", "--rounds", "1",
                           "--async-buffer", "4",
                           "--faults", "straggler:*:2@c1"]) == 0
    assert "straggler faults are INERT" in capsys.readouterr().err


REFUSALS = [
    ["--cohort", "0"],
    ["--cohort", "65"],
    ["--async-buffer", "-2"],
    ["--async-buffer", "4", "--cohort-wave", "4"],
    ["--staleness-decay", "1.5"],
    ["--client-examples", "0"],
    ["--fault-delay-ms", "-5"],
    ["--faults", "meteor:1:5%"],
    ["--faults", "crash:1@c99"],
    ["--cohort-wave", "3"],
    ["--aggregator", "median"],
    ["--aggregator", "trimmed_mean", "--trim", "2", "--cohort-wave", "4"],
    ["--async-buffer", "4", "--aggregator", "trimmed_mean"],
    ["--async-buffer", "9"],
]


@pytest.mark.parametrize("extra", REFUSALS, ids=" ".join)
def test_fed_population_refusals_match_jax(extra):
    """Each invalid population flag combination exits with the JAX
    package's text."""
    with pytest.raises(SystemExit) as want:
        jcli.main(POP + extra)
    with pytest.raises(SystemExit) as got:
        cli.main(POP + ["--device", "cpu"] + extra)
    assert isinstance(want.value.code, str), want.value.code
    assert str(got.value.code) == str(want.value.code)


def test_secure_fed_async_buffer_refusal_matches_jax():
    with pytest.raises(SystemExit) as want:
        jcli.main(["secure-fed", "--async-buffer", "4"])
    with pytest.raises(SystemExit) as got:
        cli.main(["secure-fed", "--device", "cpu", "--async-buffer", "4"])
    assert str(got.value.code) == str(want.value.code)
    assert "cannot compose with secure" in str(got.value.code)
