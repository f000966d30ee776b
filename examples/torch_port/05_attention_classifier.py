"""Train a transformer classifier with sequence-parallel attention on a
2-D ("data", "seq") mesh -- DP x SP composed, driven by the SAME train
step every CNN in this framework uses. The PyTorch port of
examples/05_attention_classifier.py.

`python examples/torch_port/05_attention_classifier.py` trains on one
card (a 1 x 1 mesh); `--device cpu --host-devices 4` runs a ring of 4
gloo ranks on the CPU, and under `torchrun --nproc-per-node 8` the batch
splits 2 ways and every self-attention is a 4-card ring, the JAX
example's own layout.
"""

import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))

import _world  # puts the repo root on sys.path
import numpy as np

from idc_models_tpu_torch import collectives, convert
from idc_models_tpu_torch import mesh as meshlib
from idc_models_tpu_torch.data import synthetic
from idc_models_tpu_torch.models.attention import AttentionClassifier
from idc_models_tpu_torch.models.core import init_params
from idc_models_tpu_torch.train.losses import binary_cross_entropy
from idc_models_tpu_torch.train.state import TrainState, rmsprop
from idc_models_tpu_torch.train.step import (
    make_train_step, replicate, shard_batch,
)

SEQ, FEAT = 32, 8
STEPS, BATCH = 150, 64


def make_data():
    """The position-sensitive task: label = marker in the late half --
    unsolvable without attention moving positional information into the
    pooled features."""
    return synthetic.make_sequence_task(512, SEQ, FEAT, seed=5)


def batches(x, y):
    """The 150 training batches' row indices, from seed 7."""
    sel_rng = np.random.default_rng(7)
    return [sel_rng.integers(0, len(x), BATCH) for _ in range(STEPS)]


def build_model(world, mesh, params=None):
    """The classifier on `mesh`, from seed 0 or from a JAX-shaped
    parameter tree (`params`), on the world's device."""
    model = AttentionClassifier(SEQ, FEAT, embed_dim=32, num_heads=2,
                                mlp_dim=64, num_blocks=2, num_outputs=1,
                                mesh=mesh, causal=True)
    if params is None:
        init_params(model, 0)
    else:
        convert.load_jax(model, params)
    return model.to(world.device)


def run(world, model, mesh, x, y, sels) -> dict:
    """Train on the batches `sels`; returns the last step's metrics."""
    state = TrainState(model, rmsprop(model, 1e-3))
    # a process started alone trains without a process group
    step = make_train_step(state, binary_cross_entropy,
                           mesh=mesh if collectives.initialized() else None)
    replicate(mesh, model)
    for i, sel in enumerate(sels):
        xs, ys = shard_batch(mesh, x[sel], y[sel], axis=meshlib.DATA_AXIS,
                             device=world.device)
        m = step(xs, ys)
        if i % 30 == 0 or i == len(sels) - 1:
            print(f"step {i:3d}  loss {float(m['loss']):.3f}  "
                  f"acc {float(m['accuracy']):.3f}")
    return {"loss": float(m["loss"]), "accuracy": float(m["accuracy"])}


def main(argv=None):
    world = _world.start(__file__, argv, __doc__)
    if world is None:
        return None
    with world:
        mesh = world.mesh(data=2, seq=4)        # ("data": 2, "seq": 4) at 8
        model = build_model(world, mesh)
        x, y = make_data()
        m = run(world, model, mesh, x, y, batches(x, y))
        assert m["accuracy"] > 0.8, "should be well above chance by now"
        print("OK: ring-attention transformer trained on a (data, seq) mesh")
        return m


if __name__ == "__main__":
    main()
