"""The port's performance attribution (idc_models_tpu_torch/observe/
profile.py) against the JAX package's: the pure-Python parts give
identical numbers on the same inputs; program accounting counts a
measured call where JAX asks XLA; the watchdog listens to dynamo's
compiles; the loops register their programs when armed
(tests/test_profile.py)."""

from __future__ import annotations

import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from idc_models_tpu.observe import MetricsRegistry as JRegistry
from idc_models_tpu.observe import profile as jprof
from idc_models_tpu_torch.observe import MetricsRegistry
from idc_models_tpu_torch.observe import profile as prof


def _span(name, sid, parent, dur):
    return {"event": "span", "name": name, "id": sid, "parent": parent,
            "tid": 1, "t_ms": float(sid), "dur_ms": float(dur),
            "wall": 0.0, "attrs": {}}


TIMELINES = {
    "ancestor": [
        _span("serve.tick", 1, None, 10.0), _span("serve.collect", 2, 1, 4.0),
        _span("device.sync", 3, 2, 3.0), _span("serve.tick", 4, None, 10.0),
        _span("device.sync", 5, 4, 5.0), _span("device.sync", 6, None, 99.0),
        _span("train.step", 7, None, 2.0)],
    # a repeated id starts a new segment: run 2's sync never reaches
    # run 1's spans
    "segments": [
        _span("serve.tick", 1, None, 10.0), _span("device.sync", 2, 1, 4.0),
        _span("other", 1, None, 100.0), _span("device.sync", 2, 1, 50.0)],
    "clamp": [_span("fed.round", 1, None, 5.0),
              _span("device.sync", 2, 1, 7.5)],
}


@pytest.mark.parametrize("case", sorted(TIMELINES))
def test_device_timeline_reports_as_jax(case):
    records = TIMELINES[case]
    reg = MetricsRegistry()
    got = prof.DeviceTimeline(registry=reg).consume(records).report()
    want = jprof.DeviceTimeline(registry=JRegistry()).consume(
        records).report()
    assert got == want
    for st in got.values():
        assert st["device_busy_fraction"] + st["host_gap_fraction"] == \
            pytest.approx(1.0)
    if case == "ancestor":
        assert got["serve.tick"]["device_busy_fraction"] == \
            pytest.approx(0.4)
        assert reg.get("device_busy_fraction").value(
            loop="serve.tick") == pytest.approx(0.4)
    if case == "clamp":
        assert got["fed.round"]["device_busy_fraction"] == 1.0


def test_roof_table_holds_the_h100_row_only():
    assert set(prof.BACKEND_ROOFS) == {"h100"}
    h100 = prof.roofline_for("NVIDIA H100 80GB HBM3")
    assert (h100.peak_tflops, h100.peak_hbm_gbps) == (989.0, 3350.0)
    assert prof.roofline_for("cpu") is None
    spec = prof.register_roof("TestChip9000", 100.0, 1000.0)
    try:
        assert prof.roofline_for("testchip9000 rev2") is spec
    finally:
        del prof.BACKEND_ROOFS[spec.key]
    with pytest.raises(ValueError):
        prof.register_roof("bad", -1.0, 10.0)


@pytest.mark.parametrize("intensity,seconds,n_dev", [
    (1000.0, 0.1, 1), (10.0, 0.01, 1), (1000.0, 0.1, 2), (None, 0.1, 1)])
def test_roofline_verdict_gives_jax_numbers(intensity, seconds, n_dev):
    kw = dict(program="p", flops=1e12 if intensity != 10.0 else 1e10,
              bytes_accessed=1e9, arithmetic_intensity=intensity)
    got = prof.roofline_verdict(prof.ProgramCost(**kw), seconds,
                                spec=prof.RooflineSpec("x", 100.0, 1000.0),
                                n_dev=n_dev)
    want = jprof.roofline_verdict(jprof.ProgramCost(**kw), seconds,
                                  spec=jprof.RooflineSpec("x", 100.0,
                                                          1000.0),
                                  n_dev=n_dev)
    assert got == want
    # an unknown device: no verdict, the achieved rates still there
    assert prof.roofline_verdict(prof.ProgramCost(**kw), seconds,
                                 "cpu") == jprof.roofline_verdict(
        jprof.ProgramCost(**kw), seconds, "cpu")


def test_records_carry_the_jax_key_sets_and_values():
    cost_kw = dict(program="sch.prog", flops=2e9, bytes_accessed=1e8,
                   arithmetic_intensity=20.0, argument_bytes=1e6,
                   output_bytes=1e3, temp_bytes=5e6,
                   peak_hbm_bytes=6e6)
    roof = dict(verdict="bandwidth-bound", mfu=0.1, hbm_utilization=0.5)
    got = prof.program_record(prof.ProgramCost(**cost_kw), roof,
                              step_ms=1.0, device_kind="cpu")
    want = jprof.program_record(jprof.ProgramCost(**cost_kw), roof,
                                step_ms=1.0, device_kind="cpu")
    assert got == want
    assert prof.format_program(got) == jprof.format_program(want)
    assert set(prof.program_record(prof.ProgramCost(program="x"))) == set(
        want)
    st = {"steps": 2, "wall_ms": 10.0, "device_ms": 6.0,
          "host_gap_ms": 4.0, "device_busy_fraction": 0.6,
          "host_gap_fraction": 0.4, "step_ms_mean": 5.0}
    assert prof.step_record("profile.step", st) == jprof.step_record(
        "profile.step", st)


def test_augment_cost_merges_as_jax():
    kw = dict(program="p", flops=None, bytes_accessed=4.0,
              missing=("flops", "argument_bytes"), available=False)
    got = prof.augment_cost(prof.ProgramCost(**kw), flops=8.0,
                            bytes_accessed=4.0)
    want = jprof.augment_cost(jprof.ProgramCost(**kw), flops=8.0,
                              bytes_accessed=4.0)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.available and got.arithmetic_intensity == 1.0


def _jax_step_flops(jmodel, x, y):
    from idc_models_tpu.train import TrainState, make_train_step, rmsprop
    from idc_models_tpu.train.losses import binary_cross_entropy

    v = jmodel.init(jax.random.key(0))
    opt = rmsprop(1e-3)
    st = TrainState(step=jnp.zeros((), jnp.int32), params=v.params,
                    model_state=v.state, opt_state=opt.init(v.params))
    compiled = jax.jit(make_train_step(jmodel, opt, binary_cross_entropy)) \
        .lower(st, x, y, jax.random.key(1)).compile()
    return jprof.program_report(compiled, name="jax.step").flops


def _torch_step_cost(tmodel, x, y):
    from idc_models_tpu_torch.models import core
    from idc_models_tpu_torch.train.losses import binary_cross_entropy
    from idc_models_tpu_torch.train.state import TrainState, rmsprop
    from idc_models_tpu_torch.train.step import make_train_step

    core.init_params(tmodel, 0)
    core.use_generator(tmodel, torch.Generator().manual_seed(0))
    opt = rmsprop(tmodel, 1e-3)
    step = make_train_step(TrainState(tmodel, opt), binary_cross_entropy)
    cost, m = prof.program_report(step, torch.from_numpy(x),
                                  torch.from_numpy(y), name="torch.step",
                                  arguments=(tmodel, opt))
    assert torch.isfinite(m["loss"])
    return cost


# The measured ratio of the port's count to XLA's cost_analysis FLOPs for
# the same train step on the CPU (batch 2, every layer training), and the
# band held around it. The port counts matmuls and convolutions by
# torch.utils.flop_counter's formulas, forward and backward, and nothing
# for elementwise ops, which XLA counts: the small CNN, mostly
# elementwise, counts 0.677 of XLA's; VGG16 counts 1.141 of XLA's (its
# convolutions count more under torch's formulas than under XLA's).
FLOP_RATIO = {"small_cnn": (0.677, 0.035), "vgg16": (1.141, 0.06)}


@pytest.mark.parametrize("name", sorted(FLOP_RATIO))
def test_program_report_flops_against_xla(name):
    from idc_models_tpu.models import small_cnn as jsmall
    from idc_models_tpu.models import vgg as jvgg
    from idc_models_tpu_torch.models import vgg as tvgg
    from idc_models_tpu_torch.models.small_cnn import small_cnn

    size = 10 if name == "small_cnn" else 50
    rng = np.random.default_rng(0)
    x = rng.random((2, size, size, 3)).astype(np.float32)
    y = np.array([0, 1], np.int32)
    jmodel, tmodel = ((jsmall(10, 3, 1), small_cnn(10, 3, 1))
                      if name == "small_cnn"
                      else (jvgg.vgg16(1), tvgg.vgg16(1)))
    cost = _torch_step_cost(tmodel, x, y)
    ratio = cost.flops / _jax_step_flops(jmodel, x, y)
    want, band = FLOP_RATIO[name]
    assert abs(ratio - want) <= band, ratio
    assert cost.available and cost.bytes_accessed > 0
    # on the CPU the memory fields are not measured
    assert cost.peak_hbm_bytes is None and cost.argument_bytes is None
    assert {"argument_bytes", "temp_bytes", "output_bytes",
            "generated_code_bytes"} <= set(cost.missing)


def test_program_report_counts_flop_formulas_exactly():
    """Against FlopCounterMode itself: a linear layer's forward and
    backward, and a call with no counted op (degraded, with a
    warning)."""
    from torch.utils.flop_counter import FlopCounterMode

    lin = torch.nn.Linear(16, 8)
    x = torch.randn(4, 16)

    def step():
        lin(x).square().sum().backward()

    with FlopCounterMode(display=False) as fcm:
        step()
    cost, _ = prof.program_report(step, name="lin", arguments=(lin,))
    # the forward and the weight gradient (x needs none)
    assert cost.flops == fcm.get_total_flops() == 2 * 2 * 4 * 16 * 8
    with pytest.warns(RuntimeWarning, match="available=False"):
        empty, out = prof.program_report(lambda: 7, name="empty")
    assert out == 7 and not empty.available and empty.flops is None


def test_register_program_files_table_and_gauges():
    reg = MetricsRegistry()
    a, b = torch.randn(8, 8), torch.randn(8, 8)
    cost, out = prof.register_program("t.mm", torch.matmul, a, b,
                                      registry=reg)
    torch.testing.assert_close(out, a @ b)
    assert prof.registered_programs()["t.mm"] is cost
    assert cost.flops == 2 * 8 * 8 * 8
    assert reg.get("program_flops").value(program="t.mm") == cost.flops
    assert reg.get("program_bytes_accessed").value(
        program="t.mm") == 3 * 8 * 8 * 4


def _compile(fn):
    return torch.compile(fn, backend="eager", dynamic=False)


def test_watchdog_fires_on_shape_varying_recompile_loop():
    """A compiled function fed a different shape every call compiles
    every call: flagged once past the limit. A warm loop stays
    silent."""
    reg = MetricsRegistry()
    wd = prof.arm_watchdog(limit=3, registry=reg)
    try:
        f = _compile(lambda t: torch.sum(t * 2.0))
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            with prof.compiling("drill.varying"):
                for n in range(6):
                    float(f(torch.zeros(n + 1)))
        churn = [x for x in w if "compile churn" in str(x.message)]
        assert len(churn) == 1 and "drill.varying" in str(churn[0].message)
        rep = wd.report()
        assert rep["flagged"] == ["drill.varying"]
        assert rep["programs"]["drill.varying"]["count"] > 3
        assert rep["compile_seconds_total"] > 0
        assert reg.get("compile_churn_flagged_total").value(
            program="drill.varying") == 1
    finally:
        prof.disarm_watchdog()
    wd2 = prof.arm_watchdog(limit=3, registry=MetricsRegistry())
    try:
        g = _compile(lambda t: torch.sum(t + 1.0))
        with prof.compiling("drill.warm"):
            for _ in range(10):
                float(g(torch.zeros(4)))
        rep = wd2.report()
        assert rep["flagged"] == [] and \
            rep["programs"]["drill.warm"]["count"] <= 3
    finally:
        prof.disarm_watchdog()
        torch._dynamo.reset()


def test_watchdog_unnamed_bucket_exempt_and_suppression():
    wd = prof.arm_watchdog(limit=2, registry=MetricsRegistry())
    try:
        f = _compile(lambda t: torch.sum(t - 1.0))
        for n in range(5):                   # unnamed: counted, exempt
            float(f(torch.zeros(n + 10)))
        rep = wd.report()
        assert rep["flagged"] == [] and \
            rep["programs"][prof.UNNAMED]["count"] >= 5
        before = rep["total_compiles"]
        with prof.compiling(None):           # suppressed
            float(_compile(lambda t: torch.sum(t * 3.0))(torch.zeros(7)))
        assert wd.report()["total_compiles"] == before
    finally:
        prof.disarm_watchdog()
    after = wd.report()["total_compiles"]
    float(_compile(lambda t: torch.sum(t * 5.0))(torch.zeros(123)))
    assert wd.report()["total_compiles"] == after
    torch._dynamo.reset()


def test_fit_registers_train_step_when_accounting_armed():
    """The armed fit counts its first step in place of a plain call: the
    history equals the unarmed fit's bit for bit."""
    from idc_models_tpu_torch.data.idc import ArrayDataset
    from idc_models_tpu_torch.models import core
    from idc_models_tpu_torch.models.small_cnn import small_cnn
    from idc_models_tpu_torch.train.loop import fit
    from idc_models_tpu_torch.train.losses import binary_cross_entropy
    from idc_models_tpu_torch.train.state import TrainState, rmsprop

    rng = np.random.default_rng(0)
    ds = ArrayDataset(rng.random((16, 10, 10, 3)).astype(np.float32),
                      (rng.random(16) > 0.5).astype(np.int32))

    def run():
        model = core.init_params(small_cnn(10, 3, 1), 0)
        core.use_generator(model, torch.Generator().manual_seed(0))
        return fit(TrainState(model, rmsprop(model, 1e-3)),
                   binary_cross_entropy, ds, None, epochs=1, batch_size=8,
                   verbose=False)

    prof.PROGRAMS.pop("train.step", None)
    plain = run()
    assert "train.step" not in prof.registered_programs()
    prof.enable_accounting()
    try:
        armed = run()
    finally:
        prof.enable_accounting(False)
    assert armed == plain
    cost = prof.registered_programs().get("train.step")
    assert cost is not None and cost.flops


def test_run_rounds_registers_fed_round_when_armed():
    from idc_models_tpu_torch.federated.driver import (
        DriverConfig, run_rounds,
    )
    from idc_models_tpu_torch.federated.fedavg import ServerState

    def round_fn(server, images, labels, weights, key):
        w = server.params["w"] @ torch.eye(4) * 0.9
        return (server.replace(round=server.round + 1, params={"w": w}),
                {"loss": torch.sum(w ** 2), "accuracy": torch.tensor(0.9)})

    server = ServerState(0, {"w": torch.ones(4)}, {})
    prof.PROGRAMS.pop("fed.round", None)
    prof.enable_accounting()
    try:
        res = run_rounds(round_fn, server, None, None, np.ones(3, np.float32),
                         config=DriverConfig(rounds=2))
    finally:
        prof.enable_accounting(False)
    assert len(res.history) == 2
    cost = prof.registered_programs().get("fed.round")
    assert cost is not None and cost.available and cost.flops == 2 * 4 * 4


def test_generator_program_costs():
    from idc_models_tpu_torch.models.core import init_params
    from idc_models_tpu_torch.models.lm import AttentionLM, Generator

    model = init_params(AttentionLM(16, 32, embed_dim=16, num_heads=2,
                                    mlp_dim=32, num_blocks=1), 0)
    gen = Generator(model, embed_dim=16, num_heads=2, num_blocks=1,
                    t_max=32, cache_dtype=torch.float32, device="cpu")
    costs = gen.program_costs(steps=4)
    assert set(costs) == {"lm.prefill", "lm.decode"}
    for cost in costs.values():
        assert cost.available and cost.flops
    assert prof.registered_programs()["lm.prefill"].flops == \
        costs["lm.prefill"].flops
    # the accounting calls leave the Generator serving as before
    assert gen([[1, 2, 3]], 2).shape == (1, 5)
