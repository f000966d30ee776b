"""SLO burn-rate alerting on the federated driver: a straggler-injected
run trips an alert, the clean baseline does not. The PyTorch port of
examples/11_slo_alerts.py.

`python examples/torch_port/11_slo_alerts.py` runs on one card. Two
12-round FedAvg runs share one model:

1. **clean** -- every round completes at its natural pace. The declared
   SLOs (p80 of round wall-clock <= 0.35 s, round-failure rate <= 20%)
   hold; the engine stays silent.
2. **straggler-injected** -- from round 5 on, the round function sleeps
   0.5 s before it starts (a straggling cohort holding up the
   synchronous round, injected at the wall-clock level). The
   round-latency SLO's error budget burns at ~3x the allowed rate in
   BOTH the short and long windows, so the engine fires a `slo_alert`
   (and would stream it to the run's jsonl next to round_health).

The same `SLOEngine` gauges (`slo_burn_rate{slo,window}`,
`slo_breached{slo}`) are live on `GET /metrics` whenever a
`MetricsExporter` is armed -- see docs/OBSERVABILITY.md.
"""

import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))

import _world  # puts the repo root on sys.path
import numpy as np

from idc_models_tpu_torch import collectives
from idc_models_tpu_torch.data import synthetic
from idc_models_tpu_torch.data.idc import ArrayDataset
from idc_models_tpu_torch.data.partition import partition_clients
from idc_models_tpu_torch.federated import (
    DriverConfig, initialize_server, make_fedavg_round, run_rounds,
)
from idc_models_tpu_torch.models.small_cnn import small_cnn
from idc_models_tpu_torch.observe import SLO, SLOEngine
from idc_models_tpu_torch.train.losses import binary_cross_entropy

ROUNDS = 12
STRAGGLE_FROM, STRAGGLE_S = 5, 0.5


def make_clients():
    """8 IID client shards of 64 10x10 patches, weight 64 each."""
    imgs, labels = synthetic.make_idc_like(8 * 64, size=10, seed=0)
    ci, cl = partition_clients(ArrayDataset(imgs, labels), 8, iid=True,
                               seed=0)
    return ci, cl, np.full((8,), 64, np.float32)


def make_slo_engine():
    # p80 (not p95): the chronologically first round pays the card's
    # warm-up in its wall time, and a 20% error budget absorbs that plus
    # machine-phase noise without masking a real straggler wave
    return SLOEngine(
        [SLO.latency("round_seconds", threshold_s=0.35, percentile=80.0),
         SLO.rate("round_failure_rate", budget=0.2)],
        short_window_s=60.0, long_window_s=300.0, min_samples=6)


def run(name, model, round_fn, clients, straggle: bool):
    """12 rounds through the driver under a fresh SLO engine; the
    engine."""
    server = initialize_server(model, 0)
    calls = {"n": 0}

    def wrapped(server_, images, labels_, weights, rng):
        calls["n"] += 1
        if straggle and calls["n"] > STRAGGLE_FROM:
            time.sleep(STRAGGLE_S)      # the injected straggler wave
        return round_fn(server_, images, labels_, weights, rng)

    slo = make_slo_engine()
    result = run_rounds(wrapped, server, *clients,
                        config=DriverConfig(rounds=ROUNDS), seed=1, slo=slo,
                        lockstep=collectives.initialized())
    secs = [e["seconds"] for e in result.events]
    print(f"{name}: {len(result.history)} rounds, wall/round "
          f"p50={sorted(secs)[len(secs) // 2]:.3f}s "
          f"max={max(secs):.3f}s -> {len(slo.alerts)} alert(s)")
    for a in slo.alerts:
        print(f"  slo_alert {a['slo']}: burn short={a['burn_short']}x "
              f"long={a['burn_long']}x of the {a['budget']:.0%} error "
              f"budget (threshold {a['burn_threshold']}x)")
    return slo, secs


def main(argv=None):
    world = _world.start(__file__, argv, __doc__)
    if world is None:
        return None
    with world:
        mesh = world.mesh(client=8)
        model = small_cnn(10, 3, 1)
        round_fn = make_fedavg_round(model, 1e-3, binary_cross_entropy,
                                     local_epochs=1, batch_size=16,
                                     mesh=mesh, device=world.device)
        clients = make_clients()
        clean, clean_s = run("clean baseline", model, round_fn, clients,
                             straggle=False)
        straggled, strag_s = run("straggler-injected", model, round_fn,
                                 clients, straggle=True)

        assert clean.alerts == [], "the clean run must stay silent"
        assert any(a["slo"] == "round_seconds" for a in straggled.alerts), \
            "the straggler wave must trip the round-latency SLO"
        assert straggled.breached("round_seconds")
        print("OK: alert under injected stragglers, silence on the clean "
              "run")
        return {"clean_alerts": len(clean.alerts),
                "straggled_alerts": len(straggled.alerts),
                "clean_round_s_p50": sorted(clean_s)[len(clean_s) // 2],
                "clean_round_s_max": max(clean_s),
                "alerts": [a["slo"] for a in straggled.alerts]}


if __name__ == "__main__":
    main()
