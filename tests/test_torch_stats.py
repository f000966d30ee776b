"""The port's offline run stats (idc_models_tpu_torch/observe/stats.py
and the `stats` verb) against the JAX package's: a run log written by
either package summarizes alike through both, and the verb prints the
same text (tests/test_observability.py)."""

from __future__ import annotations

import contextlib
import io
import json

import pytest

from idc_models_tpu import cli as jcli
from idc_models_tpu import observe as jobs
from idc_models_tpu_torch import cli as tcli
from idc_models_tpu_torch import observe as tobs


def _run(cli, argv):
    with contextlib.redirect_stdout(io.StringIO()), \
            contextlib.redirect_stderr(io.StringIO()):
        assert cli.main(argv) == 0


@pytest.fixture(scope="module")
def logs(tmp_path_factory):
    """Run logs of both packages: the port's `mobile` (tiny, CPU), the
    port's `fed --population` (fed_cohort records) and `profile`, and
    the JAX package's `lm` (tiny)."""
    root = tmp_path_factory.mktemp("logs")
    _run(tcli, ["mobile", "--device", "cpu", "--synthetic-examples", "32",
                "--batch-size", "8", "--epochs", "1", "--fine-tune-epochs",
                "1", "--path", str(root / "mobile"), "--trace-out",
                str(root / "mobile.json")])
    _run(tcli, ["fed", "--device", "cpu", "--population", "100",
                "--cohort", "8", "--async-buffer", "4", "--batch-size", "8",
                "--client-examples", "8", "--model", "small_cnn",
                "--rounds", "2", "--path", str(root / "pop")])
    _run(tcli, ["profile", "--model", "small", "--device", "cpu",
                "--steps", "2", "--out", str(root / "profile.jsonl")])
    _run(jcli, ["lm", "--steps", "3", "--seq-len", "16", "--vocab", "8",
                "--embed-dim", "16", "--num-heads", "2", "--mlp-dim", "32",
                "--num-blocks", "1", "--generate", "2", "--path",
                str(root / "jlm")])
    return {"mobile": root / "mobile/logs/run.jsonl",
            "population": root / "pop/logs/run.jsonl",
            "profile": root / "profile.jsonl",
            "jax_lm": root / "jlm/logs/run.jsonl"}


@pytest.mark.parametrize("name", ["mobile", "population", "profile",
                                  "jax_lm"])
def test_both_summaries_agree(logs, name):
    got = tobs.summarize_jsonl(logs[name])
    assert got == jobs.summarize_jsonl(logs[name])
    if name != "jax_lm":
        assert got["metrics"], "the port's log ends with a metrics snapshot"
    assert tobs.format_summary(got) == jobs.format_summary(got)


def test_fed_cohorts_section(logs):
    s = tobs.summarize_jsonl(logs["population"])
    assert [c["round"] for c in s["fed_cohorts"]] == [0, 1]
    assert all(c["mode"] == "async" for c in s["fed_cohorts"])
    assert "fed cohorts (per round)" in tobs.format_summary(s)
    names = {m["name"] for m in s["metrics"]}
    assert {"fed_buffer_fill", "fed_async_updates_total",
            "fed_update_staleness", "fed_round_attempts_total"} <= names


@pytest.mark.parametrize("flags", [[], ["--json"], ["--top", "3"]])
def test_stats_verb_prints_the_jax_text(logs, flags, capsys):
    paths = [str(logs["mobile"]), str(logs["jax_lm"])]
    assert tcli.main(["stats", *paths, *flags]) == 0
    got = capsys.readouterr().out
    assert jcli.main(["stats", *paths, *flags]) == 0
    assert got == capsys.readouterr().out
    if flags == ["--json"]:
        assert json.loads(got)["records"] > 0


def test_stats_verb_refusals():
    with pytest.raises(SystemExit, match="no such file"):
        tcli.main(["stats", "/nonexistent/run.jsonl"])
