"""One rank of the port's two-rank sharded checkpoint check, over gloo on
the CPU. It imports torch and the port only, never JAX.

    python tests/_torch_ckpt_worker.py STORE WORLD RANK OUT

Every rank joins a world of WORLD ranks through
`mesh.initialize_multihost` (the shared file STORE its rendezvous), cuts
`tree()` by `RULES` over a "data" axis of WORLD ranks, saves its blocks
to OUT/ck with `save_sharded`, restores its blocks back under the same
rules and checks them bit for bit, then writes OUT/done.<rank>.
`tests/test_torch_sharded_checkpoint.py` starts the ranks and restores
the checkpoint whole, in both packages.
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from idc_models_tpu_torch import mesh, partition  # noqa: E402
from idc_models_tpu_torch.checkpoint import (  # noqa: E402
    restore_sharded, save_sharded,
)

P = mesh.PartitionSpec
RULES = partition.PartitionRules((
    (r"w1$", P(mesh.DATA_AXIS, mesh.MODEL_AXIS)),
    (r"blocks/.*/kernel$", P(None, mesh.MODEL_AXIS)),
    (r".*", P()),
))


def tree(seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    return {
        "w1": rng.normal(size=(64, 32)).astype(np.float32),
        "blocks": {"0": {"kernel": rng.normal(size=(32, 16))
                         .astype(np.float32),
                         "bias": rng.normal(size=(16,)).astype(np.float32)}},
        "step": np.int32(7),
    }


def main(store: str, world: int, rank: int, out: Path) -> None:
    mesh.initialize_multihost(f"file://{store}", world, rank)
    m = mesh.make_mesh({mesh.DATA_AXIS: world})
    host = tree()
    blocks = partition.shard_tree(m, RULES, host)
    save_sharded(out / "ck", blocks, step=5,
                 shardings=RULES.shardings(m, host))
    back = restore_sharded(out / "ck", mesh=m, rules=RULES)
    for (name, got), (_, want) in zip(partition.tree_paths(back),
                                      partition.tree_paths(blocks)):
        if not torch.equal(got, torch.as_tensor(want)):
            raise SystemExit(f"rank {rank}: block of {name} differs")
    torch.distributed.barrier()
    (out / f"done.{rank}").write_text("ok")


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), Path(sys.argv[4]))
