"""Channel-wise tensor parallelism over the "model" axis, the counterpart
of ``idc_models_tpu/tp.py``.

The channel rule splits every leaf's last (output-channel) axis over
"model" where it divides and is longer than 1, and replicates the rest
(scalars, the Dense(1) head, odd sizes). In the JAX package GSPMD then
partitions every convolution and matmul. The port stores the classifier
zoo's parameters and RMSprop moments by the rule and gathers them whole
on use (``train.step.ShardedOptimizer``): the compute is not split, as
the JAX package's docstring finds data parallelism alone fastest for the
zoo at 50x50. The LM splits its compute (``models/lm.py``).
"""

from __future__ import annotations

import numpy as np

from idc_models_tpu_torch import collectives
from idc_models_tpu_torch import mesh as meshlib
from idc_models_tpu_torch.mesh import Mesh, PartitionSpec as P


def has_model_axis(mesh: Mesh | None) -> bool:
    return (mesh is not None and meshlib.MODEL_AXIS in mesh.axis_names
            and mesh.shape[meshlib.MODEL_AXIS] > 1)


def dp_tp_mesh(model: int, data: int | None = None) -> Mesh:
    """2-D ("data", "model") mesh: `model`-way TP, data parallelism over
    the rest; "model" innermost, so its gathers join neighbours."""
    n = collectives.axis_size()
    if model < 1 or n % model:
        raise ValueError(
            f"model-parallel degree {model} must divide the device "
            f"count ({n})")
    if data is None:
        data = n // model
    return meshlib.make_mesh({meshlib.DATA_AXIS: data,
                              meshlib.MODEL_AXIS: model})


def channel_spec(x, n_model: int) -> P:
    """The rule in its shape form: the last axis over "model" when it
    divides evenly and is longer than 1, else replicated."""
    shape = np.shape(x)
    if len(shape) >= 1 and shape[-1] > 1 and shape[-1] % n_model == 0:
        return P(*([None] * (len(shape) - 1) + [meshlib.MODEL_AXIS]))
    return P()


def channel_rules():
    """The channel rule as `partition.PartitionRules`: one catch-all whose
    right-aligned ``P("model")`` splits every leaf's last axis; the
    resolution's divisibility fallback and scalar replication make it
    `channel_spec` exactly."""
    from idc_models_tpu_torch import partition

    return partition.PartitionRules(((r".*", P(meshlib.MODEL_AXIS)),))


def state_shardings(mesh: Mesh, tree):
    """A tree of `Sharding` for a state tree (``partition.state_tree``)
    under the channel rule: optimizer moments share their parameter's
    shape, so they shard alike; the step counter replicates."""
    return channel_rules().shardings(mesh, tree)


def place(mesh: Mesh, tree):
    """This rank's blocks of a tree under the channel rule."""
    from idc_models_tpu_torch import partition

    return partition.shard_tree(mesh, channel_rules(), tree)
