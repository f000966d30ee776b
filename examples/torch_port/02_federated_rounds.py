"""FedAvg as a library: partition a dataset into non-IID clients, run
rounds over the "client" mesh axis, evaluate on the clients
(fed_model.py parity). The PyTorch port of
examples/02_federated_rounds.py.

`python examples/torch_port/02_federated_rounds.py` trains the 8 clients
in turn on one card; `--device cpu --host-devices 4` splits them over 4
gloo ranks on the CPU (2 clients a rank), and under `torchrun
--nproc-per-node 8` each card trains one client -- the client count is
independent of the rank count.
"""

import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))

import _world  # puts the repo root on sys.path
import numpy as np

from idc_models_tpu_torch.data import synthetic
from idc_models_tpu_torch.data.idc import ArrayDataset
from idc_models_tpu_torch.data.partition import partition_clients
from idc_models_tpu_torch.federated import (
    initialize_server, make_fedavg_round, make_federated_eval,
)
from idc_models_tpu_torch.models.small_cnn import small_cnn
from idc_models_tpu_torch.train.losses import binary_cross_entropy

N_CLIENTS, ROUNDS = 8, 3


def make_clients():
    """8 non-IID client shards of 64 10x10 patches each, and their
    example-count weights."""
    images, labels = synthetic.make_idc_like(N_CLIENTS * 64, size=10, seed=0)
    client_imgs, client_labels = partition_clients(
        ArrayDataset(images, labels), N_CLIENTS, iid=False, seed=0)
    weights = np.full((N_CLIENTS,), client_imgs.shape[1], np.float32)
    return client_imgs, client_labels, weights


def build(world, mesh):
    """The small CNN, the round (RMSprop at 1e-3, 2 local epochs of
    batches of 16) and the evaluation over `mesh`."""
    model = small_cnn(10, 3, 1)
    round_fn = make_fedavg_round(model, 1e-3, binary_cross_entropy,
                                 local_epochs=2, batch_size=16, mesh=mesh,
                                 device=world.device)
    eval_fn = make_federated_eval(model, binary_cross_entropy, mesh=mesh,
                                  device=world.device)
    return model, round_fn, eval_fn


def run(world, server, round_fn, eval_fn, clients) -> list[dict]:
    """ROUNDS rounds from `server`, each keyed (1, r) -- the JAX
    example's fold_in(key(1), r) -- and evaluated; one dict a round."""
    client_imgs, client_labels, weights = clients
    out = []
    for r in range(ROUNDS):
        server, m = round_fn(server, client_imgs, client_labels, weights,
                             (1, r))
        em = eval_fn(server, client_imgs, client_labels, weights)
        row = {"train_loss": float(m["loss"]),
               "eval_acc": float(em["accuracy"]),
               "dropped": int(m["clients_dropped"])}
        print(f"round {r}: train_loss={row['train_loss']:.4f} "
              f"eval_acc={row['eval_acc']:.4f} dropped={row['dropped']}")
        out.append(row)
    return out


def main(argv=None):
    world = _world.start(__file__, argv, __doc__)
    if world is None:
        return None
    with world:
        mesh = world.mesh(client=N_CLIENTS)
        model, round_fn, eval_fn = build(world, mesh)
        server = initialize_server(model, 0)
        return {"rounds": run(world, server, round_fn, eval_fn,
                              make_clients())}


if __name__ == "__main__":
    main()
