"""Long-context ring attention as a library: a sequence longer than any
one rank holds, attended EXACTLY over the "seq" mesh axis -- the
PyTorch port of examples/04_ring_attention.py.

`python examples/torch_port/04_ring_attention.py` runs on one card (a
ring of one); `--device cpu --host-devices 4` runs a ring of 4 gloo
ranks on the CPU, each holding T/4 of the sequence; under `torchrun
--nproc-per-node 8` every card keeps O(T/n) activations and the K/V
blocks hop one rank a ring step.
"""

import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))

import _world  # puts the repo root on sys.path
import numpy as np
import torch

from idc_models_tpu_torch import mesh as meshlib
from idc_models_tpu_torch.ring_attention import (
    full_attention, make_ring_attention,
)

B, T, H, D = 2, 512, 4, 32        # T is sharded n ways: T/n per rank


def make_inputs():
    """q, k, v [B, T, H, D] f32 from seed 0, as the JAX example draws
    them."""
    rng = np.random.default_rng(0)
    return tuple(rng.normal(0, 1, (B, T, H, D)).astype(np.float32)
                 for _ in range(3))


def run(world, q, k, v) -> dict:
    """Ring attention over the world's "seq" ring, gathered and held
    against full attention. Returns the gathered output and the error."""
    mesh = world.mesh(seq=8)
    # place the sequence shards: no rank ever holds the full T
    seq_sharding = meshlib.sharding(mesh, None, meshlib.SEQ_AXIS)
    qs, ks, vs = (meshlib.put_with_sharding(x, seq_sharding, world.device)
                  for x in (q, k, v))

    attn = make_ring_attention(causal=True,
                               group=mesh.group(meshlib.SEQ_AXIS))
    out = attn(qs, ks, vs)
    whole = meshlib.gather_block(out, seq_sharding)
    print("ring attention out:", tuple(whole.shape), "sharded over",
          seq_sharding.spec, f"(this rank's block {tuple(out.shape)})")

    # exact, not approximate: gather and compare against full attention
    ref = full_attention(*(torch.from_numpy(x).to(world.device)
                           for x in (q, k, v)), causal=True)
    err = float((whole - ref).abs().max())
    print(f"max |ring - full| = {err:.2e}")
    assert err < 1e-5
    return {"out": whole.cpu().numpy(), "err": err}


def main(argv=None):
    world = _world.start(__file__, argv, __doc__)
    if world is None:
        return None
    with world:
        return {"ring_err": run(world, *make_inputs())["err"]}


if __name__ == "__main__":
    main()
