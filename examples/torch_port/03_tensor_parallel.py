"""Tensor parallelism: the same training code on a 2-D ("data", "model")
mesh -- weights and RMSprop moments stored channel-sharded over "model",
batch over "data". The PyTorch port of examples/03_tensor_parallel.py.

`python examples/torch_port/03_tensor_parallel.py` runs on one card (a
1 x 1 mesh); `--device cpu --host-devices 4` runs 4-way "model" on 4
gloo ranks of the CPU, and `torchrun --nproc-per-node 8` the JAX
example's 2 x 4 DP x TP mesh of cards.
"""

import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))

import _world  # puts the repo root on sys.path
import torch

from idc_models_tpu_torch import convert, tp
from idc_models_tpu_torch import mesh as meshlib
from idc_models_tpu_torch.data import synthetic
from idc_models_tpu_torch.data.idc import ArrayDataset
from idc_models_tpu_torch.models import core
from idc_models_tpu_torch.models.small_cnn import small_cnn
from idc_models_tpu_torch.train.loop import fit, predict
from idc_models_tpu_torch.train.losses import binary_cross_entropy
from idc_models_tpu_torch.train.state import TrainState, rmsprop
from idc_models_tpu_torch.train.step import place_state


def make_splits():
    """128 synthetic 10x10 patches: the first 96 train, the rest
    validate."""
    images, labels = synthetic.make_idc_like(128, size=10, seed=0)
    return (ArrayDataset(images[:96], labels[:96]),
            ArrayDataset(images[96:], labels[96:]))


def build_model(world, params=None, state=None):
    """The small CNN from seed 0 or from JAX-shaped trees, on the
    world's device, its dropout drawing from a seed-0 generator."""
    model = small_cnn(10, 3, 1)
    if params is None:
        core.init_params(model, 0)
    else:
        convert.load_jax(model, params, state)
    model.to(world.device)
    return core.use_generator(
        model, torch.Generator(device=world.device).manual_seed(0))


def run(world, mesh, model, train, val) -> dict:
    """Three epochs of `fit` over the DP x TP mesh, then the validation
    set's probabilities."""
    state = place_state(mesh, TrainState(model, rmsprop(model, 1e-3)))
    history = fit(state, binary_cross_entropy, train, val, epochs=3,
                  batch_size=16, verbose=True, mesh=mesh)

    probs = torch.sigmoid(torch.from_numpy(
        predict(model, val.images, mesh=mesh))).numpy()
    # the JAX example prints the global array's sharding; here the
    # parameter is stored as this rank's block under the channel rule
    kernel = model.conv1.kernel.detach()
    spec = tp.channel_spec(kernel, mesh.axis_size(meshlib.MODEL_AXIS))
    block = meshlib.put_with_sharding(kernel, meshlib.Sharding(mesh, spec))
    print("conv kernel sharding:", spec, f"(this rank's block "
          f"{tuple(block.shape)} of {tuple(kernel.shape)})")
    print("first 5 malignancy probabilities:", probs[:5].reshape(-1))
    return {"val_loss": history["val_loss"][-1],
            "val_accuracy": history["val_accuracy"][-1],
            "probs": probs[:5].reshape(-1).tolist()}


def main(argv=None):
    world = _world.start(__file__, argv, __doc__)
    if world is None:
        return None
    with world:
        # 2-way data x 4-way tensor parallel at 8 ranks
        mesh = world.mesh(data=2, model=4)
        train, val = make_splits()
        return run(world, mesh, build_model(world), train, val)


if __name__ == "__main__":
    main()
