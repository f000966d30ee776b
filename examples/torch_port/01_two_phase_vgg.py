"""The flagship workload as library calls: two-phase VGG16 transfer
learning (dist_model_tf_vgg.py parity) on a data-parallel mesh. The
PyTorch port of examples/01_two_phase_vgg.py.

Runs on one card with synthetic IDC-like data: `python
examples/torch_port/01_two_phase_vgg.py`; point `load_directory` at a
real `<root>/<label>/*.png` tree for the real thing. `--device cpu
--host-devices 4` trains data-parallel over 4 gloo ranks on the CPU,
and `torchrun --nproc-per-node 8` over 8 cards.
"""

import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))

import _world  # puts the repo root on sys.path

from idc_models_tpu_torch.data import synthetic
from idc_models_tpu_torch.data.idc import ArrayDataset, train_val_test_split
from idc_models_tpu_torch.train.loop import TwoPhaseConfig, two_phase_fit


def make_splits():
    """256 synthetic 50x50 patches split 80/10/10 with seed 0."""
    images, labels = synthetic.make_idc_like(256, size=50, seed=0)
    ds = ArrayDataset(images, labels)          # or: load_directory(root)
    return train_val_test_split(ds, seed=0)


def run(world, mesh, train, val):
    return two_phase_fit(
        "vgg16", 1, train, val,
        TwoPhaseConfig(lr=1e-3, epochs=1, fine_tune_epochs=1,
                       batch_size=32),
        # pretrained_weights="vgg16_imagenet.npz",  # convert-weights output
        device=world.device, mesh=mesh)


def main(argv=None):
    world = _world.start(__file__, argv, __doc__)
    if world is None:
        return None
    with world:
        mesh = world.mesh(data=8)
        train, val, _ = make_splits()
        result = run(world, mesh, train, val)
        acc = result.history_fine["val_accuracy"][-1]
        print(f"pre-train {result.pretrain_seconds:.1f}s, "
              f"fine-tune {result.fine_tune_seconds:.1f}s, "
              f"final val acc {acc:.3f}")
        return {"pretrain_s": result.pretrain_seconds,
                "fine_tune_s": result.fine_tune_seconds,
                "val_accuracy": acc,
                "val_loss": result.history_fine["val_loss"][-1]}


if __name__ == "__main__":
    main()
