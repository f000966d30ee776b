"""The port's CLI with the observability layer on the CPU: --trace-out
on `mobile` and `fed`, --profile-dir, the `profile` verb's frozen
records and refusals, --stream and --central-storage end to end, and
the event names the port emits against the JAX package's contracts."""

from __future__ import annotations

import ast
import contextlib
import io
import json
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from idc_models_tpu.observe import profile as jprof
from idc_models_tpu_torch import cli
from idc_models_tpu_torch.observe import profile as prof

REPO = Path(__file__).resolve().parent.parent
MOBILE = ["mobile", "--device", "cpu", "--synthetic-examples", "48",
          "--batch-size", "8", "--epochs", "1", "--fine-tune-epochs", "1",
          "--depthwise-impl", "fused", "--seed", "0"]


def _quiet(argv):
    with contextlib.redirect_stdout(io.StringIO()) as buf:
        assert cli.main(argv) == 0
    return buf.getvalue()


def _jsonl(path):
    return [json.loads(line) for line in Path(path).read_text().splitlines()]


def _spans(path):
    return [e for e in json.loads(Path(path).read_text())["traceEvents"]
            if e["ph"] == "X"]


def _registered_by(argv, program):
    """Run the verb with its program's account cleared; return the
    account it filed and the run log's closing metrics snapshot."""
    prof.PROGRAMS.pop(program, None)
    _quiet(argv)
    assert not prof.accounting_enabled()
    cost = prof.registered_programs().get(program)
    assert cost is not None and cost.flops and cost.bytes_accessed
    snap = [r for r in _jsonl(argv[argv.index("--path") + 1]
                              + "/logs/run.jsonl")
            if r["event"] == "metrics_snapshot"][-1]
    flops = [m["value"] for m in snap["metrics"]
             if m["name"] == "program_flops"
             and m["labels"] == {"program": program}]
    assert flops == [cost.flops]
    return cost


def test_mobile_trace_out_and_profile_dir(tmp_path):
    """--profile-dir writes the profiler's trace and arms program
    accounting: fit counts its first step and files it as train.step,
    which the closing metrics snapshot carries."""
    _registered_by(MOBILE + ["--path", str(tmp_path / "run"), "--trace-out",
                     str(tmp_path / "t.json"), "--profile-dir",
                     str(tmp_path / "prof")], "train.step")
    spans = _spans(tmp_path / "t.json")
    names = [e["name"] for e in spans]
    assert names.count("train.epoch") == 2
    assert names.count("train.step") == names.count("train.epoch") * 4
    assert {"device.sync", "train.eval", "Pre-training for 1 epochs",
            "Fine tuning for 1 epochs"} <= set(names)
    by_id = {e["args"]["span_id"]: e for e in spans}
    for e in spans:
        if e["name"] == "train.step":
            assert by_id[e["args"]["parent_id"]]["name"] == "train.epoch"
    doc = json.loads((tmp_path / "prof" / "trace.json").read_text())
    assert doc["traceEvents"]
    events = [r["event"] for r in _jsonl(tmp_path / "run/logs/run.jsonl")]
    assert events[-1] == "metrics_snapshot"


@pytest.mark.parametrize("argv", [
    ["fed", "--synthetic-examples", "40", "--num-clients", "5",
     "--batch-size", "8", "--pretrain-epochs", "1", "--rounds", "2",
     "--faults", "crash:1"],
    ["fed", "--population", "200", "--cohort", "8", "--cohort-wave", "4",
     "--batch-size", "8", "--client-examples", "8", "--model",
     "small_cnn", "--rounds", "2", "--faults", "crash:*:25%"],
], ids=["classic", "population"])
def test_fed_trace_out_writes_round_and_client_spans(tmp_path, argv):
    """--trace-out writes the round and client spans with their fault
    and id markers; --profile-dir arms accounting, so run_rounds files
    its first attempt as fed.round."""
    _registered_by(argv + ["--device", "cpu", "--path",
                           str(tmp_path / "run"), "--trace-out",
                           str(tmp_path / "t.json"), "--profile-dir",
                           str(tmp_path / "prof")], "fed.round")
    spans = _spans(tmp_path / "t.json")
    rounds = [e for e in spans if e["name"] == "fed.round"]
    clients = [e for e in spans if e["name"] == "fed.client"]
    assert [e["args"]["round"] for e in rounds] == [0, 1]
    assert all(e["args"]["status"] == "ok" for e in rounds)
    assert any(e["name"] == "device.sync" for e in spans)
    per_round = {r: [e["args"] for e in clients if e["args"]["round"] == r]
                 for r in (0, 1)}
    faults = {a["fault"] for r in per_round.values() for a in r}
    assert "crash" in faults and "ok" in faults
    if "--population" in argv:
        # virtual ids from the cohort sampler, no positional weight
        assert len(per_round[0]) == 8
        assert all("weight" not in a and a["client"] < 200
                   for a in per_round[0])
    else:
        assert all("weight" in a for a in per_round[0])
    snap = _jsonl(tmp_path / "run/logs/run.jsonl")[-1]
    assert snap["event"] == "metrics_snapshot"
    assert "fed_round_attempts_total" in {m["name"] for m in snap["metrics"]}


def test_profile_small_writes_the_frozen_records(tmp_path, capsys,
                                                 monkeypatch):
    # --peak-tflops registers a "cpu" roof for the process: keep it out
    # of the tests that follow (test_torch_profile.py reads the table)
    monkeypatch.setattr(prof, "BACKEND_ROOFS", dict(prof.BACKEND_ROOFS))
    out = tmp_path / "p.jsonl"
    assert cli.main(["profile", "--model", "small", "--device", "cpu",
                     "--steps", "2", "--peak-tflops", "1", "--peak-gbps",
                     "1", "--out", str(out)]) == 0
    text = capsys.readouterr().out
    assert "churn: none" in text and "-bound at" in text
    recs = _jsonl(out)
    prog = [r for r in recs if r["event"] == "profile_program"]
    step = [r for r in recs if r["event"] == "profile_step"]
    assert len(prog) == 1 and len(step) == 1
    want_prog = {"ts", "event"} | set(jprof.program_record(
        jprof.ProgramCost(program="x")))
    st = {"steps": 1, "wall_ms": 1.0, "device_ms": 0.0, "host_gap_ms": 1.0,
          "device_busy_fraction": 0.0, "host_gap_fraction": 1.0,
          "step_ms_mean": 1.0}
    want_step = {"ts", "event"} | set(jprof.step_record("x", st))
    assert set(prog[0]) == want_prog and set(step[0]) == want_step
    assert prog[0]["verdict"] != "unknown" and prog[0]["device_kind"] == "cpu"
    assert step[0]["loop"] == "profile.step" and step[0]["steps"] == 2
    assert cli.main(["stats", str(out)]) == 0
    summary = capsys.readouterr().out
    assert "programs (performance attribution):" in summary
    assert "step-time attribution:" in summary


def test_profile_churn_drill_flags_the_drill(tmp_path, capsys):
    assert cli.main(["profile", "--model", "small", "--device", "cpu",
                     "--steps", "1", "--compile-limit", "2",
                     "--churn-drill"]) == 0
    assert "CHURN flagged: churn.drill" in capsys.readouterr().out


@pytest.mark.parametrize("argv,match", [
    (["--model", "serve"], "A9"),
    # the JAX verb's own refusals: more ranks than the world holds, and
    # sharding a model whose rules replicate
    (["--model", "lm", "--fsdp", "2"],
     "--fsdp 2 x --tp 1 needs 2 devices, have 1"),
    (["--model", "lm", "--tp", "2"],
     "--fsdp 1 x --tp 2 needs 2 devices, have 1"),
    (["--model", "small", "--fsdp", "2"],
     "shard the LM's rule-based partition layout"),
    (["--model", "small", "--peak-tflops", "1"], "both or neither"),
])
def test_profile_refusals_name_the_item(argv, match):
    with pytest.raises(SystemExit, match=match):
        cli.main(["profile", "--device", "cpu", *argv])


def test_profile_lm_sharded_over_a_cpu_pod(tmp_path, capsys, monkeypatch):
    """`profile --model lm --fsdp 2 --tp 2 --host-devices 4`: the rule-
    sharded LM step's account on each of 4 gloo ranks, rank 0 printing
    the layout and writing the profile records."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    out = tmp_path / "p.jsonl"
    assert cli.main(["profile", "--model", "lm", "--device", "cpu",
                     "--host-devices", "4", "--fsdp", "2", "--tp", "2",
                     "--steps", "1", "--peak-tflops", "1", "--peak-gbps",
                     "1", "--out", str(out)]) == 0
    text = capsys.readouterr().out
    assert ("fsdp=2, tp=2 (rule set 'lm': params + optimizer state "
            "sharded)") in text
    assert " ms/step" in text
    events = [json.loads(line)["event"] for line in
              out.read_text().splitlines()]
    assert events.count("profile_program") == 1 and "profile_step" in events


@pytest.fixture(scope="module")
def png_tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("idc")
    rng = np.random.default_rng(0)
    for i in range(40):
        d = root / str(i % 2)
        d.mkdir(exist_ok=True)
        Image.fromarray(rng.integers(0, 256, (50, 50, 3), np.uint8)).save(
            d / f"p{i:02d}.png")
    return root


def test_stream_runs_end_to_end(tmp_path, png_tree):
    """--stream --decode-workers 2 over a PNG tree trains both phases and
    evaluates; the same epochs as two_phase_fit on the same file-level
    split decoded up front."""
    from idc_models_tpu_torch.data.idc import (
        ArrayDataset, decode_pairs, list_shuffled_pairs,
    )
    from idc_models_tpu_torch.models import registry
    from idc_models_tpu_torch.train.loop import TwoPhaseConfig, two_phase_fit

    _quiet(MOBILE + ["--data-dir", str(png_tree), "--stream",
                     "--decode-workers", "2", "--path", str(tmp_path)])
    recs = _jsonl(tmp_path / "logs/run.jsonl")
    got = [r["loss"] for r in recs if r["event"] == "epoch"]
    pairs = list_shuffled_pairs(png_tree, seed=0)

    def materialize(subset):
        return ArrayDataset(decode_pairs(subset, 50),
                            np.asarray([l for _, l in subset], np.int32))

    with contextlib.redirect_stdout(io.StringIO()):
        res = two_phase_fit(
            "mobilenet_v2", 1, materialize(pairs[:32]),
            materialize(pairs[32:36]),
            TwoPhaseConfig(lr=1e-4, epochs=1, fine_tune_epochs=1,
                           batch_size=8, fine_tune_at=100, seed=0),
            build_kwargs=registry.FUSED_BUILD_KWARGS["mobilenet_v2"],
            device="cpu")
    assert got == res.history["loss"] + res.history_fine["loss"]
    assert [r["event"] for r in recs][-2:] == ["test", "metrics_snapshot"]


def test_stream_refusals_and_fallback(tmp_path, capsys):
    with pytest.raises(SystemExit, match="IDC directory preset"):
        cli.main(["dense", "--device", "cpu", "--stream"])
    with pytest.raises(SystemExit, match="too few"):
        cli.main(MOBILE + ["--stream", "--data-dir", str(_tiny_tree(
            tmp_path))])


def _tiny_tree(root):
    for i in range(4):
        d = root / str(i % 2)
        d.mkdir(exist_ok=True)
        Image.fromarray(np.zeros((4, 4, 3), np.uint8)).save(d / f"{i}.png")
    return root


def test_central_storage_runs_end_to_end(tmp_path):
    """`vgg --central-storage` trains and evaluates to the mirrored run's
    records, bit for bit on the CPU."""
    base = ["vgg", "--device", "cpu", "--synthetic-examples", "32",
            "--batch-size", "8", "--epochs", "1", "--fine-tune-epochs", "1"]
    out = {}
    for flag in ([], ["--central-storage"]):
        path = tmp_path / ("c" if flag else "m")
        _quiet(base + flag + ["--path", str(path)])
        out[bool(flag)] = [
            {k: v for k, v in r.items() if k != "ts"}
            for r in _jsonl(path / "logs/run.jsonl")
            if r["event"] in ("epoch", "test")]
    assert out[True] == out[False] and len(out[True]) == 3


def _emitted_event_names(root: Path) -> set[str]:
    """Every constant ``event=`` keyword passed to a ``.log`` call under
    `root` (the AST scan of tests/test_observability.py)."""
    names = set()
    for p in sorted(root.rglob("*.py")):
        for node in ast.walk(ast.parse(p.read_text(), filename=str(p))):
            if not isinstance(node, ast.Call):
                continue
            fn = node.func
            attr = (fn.attr if isinstance(fn, ast.Attribute)
                    else fn.id if isinstance(fn, ast.Name) else None)
            if attr not in ("log", "_log"):
                continue
            for kw in node.keywords:
                if (kw.arg == "event" and isinstance(kw.value, ast.Constant)
                        and isinstance(kw.value.value, str)):
                    names.add(kw.value.value)
    return names


def test_every_event_the_port_emits_has_a_jax_contract():
    from test_observability import EVENT_CONTRACTS

    emitted = _emitted_event_names(REPO / "idc_models_tpu_torch")
    assert {"epoch", "round_health", "fed_cohort", "profile_program",
            "profile_step", "metrics_snapshot"} <= emitted
    assert emitted <= set(EVENT_CONTRACTS), sorted(
        emitted - set(EVENT_CONTRACTS))
