"""Fault-tolerant federated training (docs/ROBUSTNESS.md): inject a
deterministic Byzantine fault plan, watch the weighted mean degrade, and
survive it with the trimmed-mean aggregator + the self-healing driver.
The PyTorch port of examples/09_federated_faults.py.

`python examples/torch_port/09_federated_faults.py` runs on one card;
`--device cpu --host-devices 4` splits the clients over 4 gloo ranks on
the CPU, the driver in lockstep over them.
"""

import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))

import _world  # puts the repo root on sys.path
import numpy as np

from idc_models_tpu_torch import collectives, faults
from idc_models_tpu_torch.data import synthetic
from idc_models_tpu_torch.data.idc import ArrayDataset
from idc_models_tpu_torch.data.partition import pad_clients, partition_clients
from idc_models_tpu_torch.federated import (
    DriverConfig, RoundFailure, get_aggregator, initialize_server,
    make_fedavg_round, make_federated_eval, run_rounds,
)
from idc_models_tpu_torch.models.small_cnn import small_cnn
from idc_models_tpu_torch.train.losses import binary_cross_entropy

N_CLIENTS, N_BYZANTINE, ROUNDS = 10, 3, 2


def make_clients():
    """10 IID client shards of 16 10x10 patches, padded with inert
    weight-0 dummies to 16 shards (a multiple of the JAX example's 8
    devices)."""
    images, labels = synthetic.make_idc_like(N_CLIENTS * 16, size=10, seed=0)
    client_imgs, client_labels = partition_clients(
        ArrayDataset(images, labels), N_CLIENTS, iid=True, seed=0)
    weights = np.full((N_CLIENTS,), client_imgs.shape[1], np.float32)
    return pad_clients(client_imgs, client_labels, weights, multiple=8)


def make_plan():
    """3 of 10 clients run the sign-flip x1000 attack -- finite updates,
    so non-finite detection cannot see them. Seeded: replays
    bit-identically."""
    return faults.FaultPlan.byzantine(N_CLIENTS, N_BYZANTINE,
                                      kind="sign_flip", scale=1000.0, seed=7)


class Drill:
    """The model, the evaluation and the fault plan over `mesh`; `drive`
    runs the self-healing driver from a fresh seed-0 server."""

    def __init__(self, world, mesh, clients, plan):
        self.world, self.mesh, self.clients, self.plan = (world, mesh,
                                                          clients, plan)
        self.model = small_cnn(10, 3, 1)
        self.eval_fn = make_federated_eval(self.model, binary_cross_entropy,
                                           mesh=mesh, device=world.device)

    def build_round(self, agg):
        return make_fedavg_round(self.model, 1e-3, binary_cross_entropy,
                                 local_epochs=1, batch_size=16,
                                 aggregator=agg, faults=self.plan,
                                 mesh=self.mesh, device=self.world.device)

    def drive(self, round_fn, config, server=None):
        # the self-healing driver: divergence rollback, timeout retry
        # with a reseeded client subset, bounded attempts, health events
        if server is None:
            server = initialize_server(self.model, 0)
        result = run_rounds(round_fn, server, *self.clients, config=config,
                            seed=1, lockstep=collectives.initialized())
        em = self.eval_fn(result.server, *self.clients)
        return result, float(em["loss"])


def run(drill) -> dict:
    # 1. The weighted mean under attack: the driver's divergence
    #    detection (loss-spike rollback) refuses the poisoned trajectory
    #    outright.
    refused = False
    try:
        drill.drive(drill.build_round(None), DriverConfig(rounds=ROUNDS))
    except RoundFailure as e:
        refused = True
        print(f"weighted mean: driver REFUSED the poisoned trajectory "
              f"({e})")

    # 2. Detection off (loss_spike_ratio=None): the mean 'completes' --
    #    onto a server the attackers steered far from descent.
    _, mean_loss = drill.drive(drill.build_round(None),
                               DriverConfig(rounds=ROUNDS,
                                            loss_spike_ratio=None))
    print(f"weighted mean, detection off: eval_loss={mean_loss:.4f}")

    # 3. Trimmed mean with trim >= attacker count: completes healthily
    #    under the default driver config, attackers trimmed every round.
    result, trim_loss = drill.drive(
        drill.build_round(get_aggregator("trimmed_mean", trim=N_BYZANTINE)),
        DriverConfig(rounds=ROUNDS))
    trimmed = result.history[-1].get("clients_trimmed", 0)
    print(f"trimmed mean:  eval_loss={trim_loss:.4f} "
          f"(suspected attackers trimmed: {int(trimmed)})")
    assert trim_loss < mean_loss
    print("the robust aggregate stays near a sane binary cross entropy; "
          "the mean is steered away by the attackers")
    return {"mean_refused": refused, "mean_loss": mean_loss,
            "trim_loss": trim_loss, "trimmed": int(trimmed)}


def main(argv=None):
    world = _world.start(__file__, argv, __doc__)
    if world is None:
        return None
    with world:
        mesh = world.mesh(client=8)
        plan = make_plan()
        print(f"fault plan: {plan}")
        return run(Drill(world, mesh, make_clients(), plan))


if __name__ == "__main__":
    main()
