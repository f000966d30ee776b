"""Workload presets, as ``idc_models_tpu/configs.py`` holds them, for the
workloads ported so far (the ``vgg``, ``mobile``, ``dense``, ``fed`` and
``secure_fed`` presets).

A copy, not an import: the port never imports the JAX package."""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class DistPreset:
    """Two-phase transfer learning of one backbone on IDC patches."""

    name: str
    model: str                   # registry key
    dataset: str                 # "idc" | "cifar10"
    num_outputs: int
    image_size: int
    lr: float
    epochs: int                  # phase-1 epochs
    fine_tune_epochs: int
    batch_size: int              # global (vgg/mobile) or per-replica (dense)
    per_replica_batch: bool      # dense scales the batch by the replicas
    #                              (one card here: global = batch_size)
    fine_tune_at: int
    dataset_limit: int | None    # balanced-subset size
    repeats: int = 1             # train-set passes per epoch (dense: 2)


@dataclasses.dataclass(frozen=True)
class FedPreset:
    """FedAvg with a pretrained backbone (fed_model.py)."""

    name: str = "fed"
    model: str = "vgg16"
    num_outputs: int = 1
    image_size: int = 50
    lr: float = 1e-3             # pretrain lr; clients use lr/10 (fed_model.py:208)
    pretrain_epochs: int = 10
    fine_tune_at: int = 15       # fed_model.py:63
    num_clients: int = 10        # fed_model.py:47
    test_client_fraction: float = 0.2   # 8 train / 2 test (fed_model.py:47-49)
    local_epochs: int = 1
    batch_size: int = 32
    rounds: int = 10
    iid: bool = True
    dataset_limit: int | None = 30000


@dataclasses.dataclass(frozen=True)
class SecureFedPreset:
    """Secure-aggregation FedAvg on the small CNN (secure_fed_model.py)."""

    name: str = "secure_fed"
    model: str = "small_cnn"
    num_outputs: int = 1
    image_size: int = 10         # secure_fed_model.py:173-184 decodes 10x10
    lr: float = 1e-3
    num_clients: int = 8         # one per device; reference shards by NUM_CLIENTS
    local_epochs: int = 5        # secure_fed_model.py:131
    batch_size: int = 32
    rounds: int = 10
    percent: float = 0.5         # fraction of tensors encrypted/masked
    client_examples: int = 24000  # secure_fed_model.py:219
    test_examples: int = 6000     # secure_fed_model.py:220
    paillier: bool = False       # host-side parity mode instead of masks


PRESETS = {
    # the reference's dist_model_tf_vgg.py:8-17,130 -- VGG16, binary IDC,
    # global batch 32, lr 1e-3, fine-tune at Keras index 15
    "vgg": DistPreset(
        name="vgg", model="vgg16", dataset="idc", num_outputs=1,
        image_size=50, lr=1e-3, epochs=10, fine_tune_epochs=10,
        batch_size=32, per_replica_batch=False, fine_tune_at=15,
        dataset_limit=30000),
    # the reference's dist_model_tf_mobile.py:8-16,130,146 -- MobileNetV2,
    # binary IDC, global batch 32, lr 1e-4, fine-tune at Keras index 100
    "mobile": DistPreset(
        name="mobile", model="mobilenet_v2", dataset="idc", num_outputs=1,
        image_size=50, lr=1e-4, epochs=10, fine_tune_epochs=10,
        batch_size=32, per_replica_batch=False, fine_tune_at=100,
        dataset_limit=24257),
    # the reference's dist_model_tf_dense.py:26-28,122-123,131-158 --
    # DenseNet201 on CIFAR-10, batch 256 a replica, lr 1e-4, fine-tune at
    # 150, sparse CE, the train set passed twice an epoch
    "dense": DistPreset(
        name="dense", model="densenet201", dataset="cifar10",
        num_outputs=10, image_size=32, lr=1e-4, epochs=10,
        fine_tune_epochs=10, batch_size=256, per_replica_batch=True,
        fine_tune_at=150, dataset_limit=None, repeats=2),
    "fed": FedPreset(),
    "secure_fed": SecureFedPreset(),
}


def get_preset(name: str):
    key = name.replace("-", "_")
    if key not in PRESETS:
        raise KeyError(f"unknown preset {name!r}; have {sorted(PRESETS)}")
    return PRESETS[key]


# The train-step configurations the `profile` verb times each backbone's
# fine-tune step at, as the JAX package's table: the per-card batch, the
# fine-tune index and the rate handed to RMSprop (the phase-2 rate, the
# preset lr / 10 for the BN backbones). The batches are the JAX package's
# bench batches, kept so both packages profile the same step.
BENCH_TRAIN_CONFIGS = {
    "vgg16": dict(image_size=50, num_outputs=1, fine_tune_at=15,
                  lr=1e-4, batch_per_chip=2048),
    "mobilenet_v2": dict(image_size=50, num_outputs=1, fine_tune_at=100,
                         lr=1e-5, batch_per_chip=4096),
    "densenet201": dict(image_size=32, num_outputs=10, fine_tune_at=150,
                        lr=1e-5, batch_per_chip=2048),
}
