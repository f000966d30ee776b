"""Serving the long context the ring trained: KV-cache decode with the
cache sharded over the SAME "seq" mesh axis as training -- rank i owns
cache slots [i*T/n, (i+1)*T/n) and never sees the rest. The PyTorch
port of examples/06_ring_decode.py.

`python examples/torch_port/06_ring_decode.py` runs on one card (a ring
of one); `--device cpu --host-devices 4` shards the cache over 4 gloo
ranks on the CPU, where each decode step is a max and a sum over the
ring of the per-shard softmax partials and an owner-local cache write.
"""

import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))

import _world  # puts the repo root on sys.path
import numpy as np
import torch

from idc_models_tpu_torch import mesh as meshlib
from idc_models_tpu_torch.ring_attention import full_attention
from idc_models_tpu_torch.ring_decode import (
    cache_sharding, make_ring_decode, prefill,
)

B, T_MAX, H, D = 2, 256, 4, 32    # cache sharded n ways: T_MAX/n a rank
P_LEN = 192                        # prompt tokens, placed via prefill


def make_inputs():
    """q, k, v [B, T_MAX, H, D] f32 from seed 0, as the JAX example
    draws them."""
    rng = np.random.default_rng(0)
    return tuple(rng.normal(0, 1, (B, T_MAX, H, D)).astype(np.float32)
                 for _ in range(3))


def run(world, q, k, v) -> dict:
    """Prefill P_LEN tokens into the ring cache, decode the rest one at
    a time, and hold every step against full causal attention. Returns
    the decoded rows and the error."""
    mesh = world.mesh(seq=8)
    group = mesh.group(meshlib.SEQ_AXIS)
    q, k, v = (torch.from_numpy(x).to(world.device) for x in (q, k, v))

    # 1. prefill: the prompt's K/V drops straight into the ring layout
    kc, vc = prefill(k[:, :P_LEN], v[:, :P_LEN], T_MAX,
                     dtype=torch.float32, group=group)
    sh = cache_sharding(mesh)
    print(f"cache: {(B, T_MAX, H, D)} sharded over {sh.spec} (this "
          f"rank's shard {tuple(kc.shape)})")

    # 2. decode the remaining tokens one at a time (caches updated in
    #    place)
    step = make_ring_decode(group=group)
    outs = []
    for pos in range(P_LEN, T_MAX):
        tok = slice(pos, pos + 1)
        out, kc, vc = step(kc, vc, q[:, tok], k[:, tok], v[:, tok], pos)
        outs.append(out)
    decoded = torch.cat(outs, dim=1)

    # exact: each step == the matching row of full causal attention
    ref = full_attention(q, k, v, causal=True)[:, P_LEN:]
    err = float((decoded - ref).abs().max())
    print(f"decoded {T_MAX - P_LEN} tokens after a {P_LEN}-token prefill; "
          f"max |err| vs full causal attention = {err:.2e}")
    assert err < 1e-4
    return {"decoded": decoded.cpu().numpy(), "err": err}


def main(argv=None):
    world = _world.start(__file__, argv, __doc__)
    if world is None:
        return None
    with world:
        return {"decode_err": run(world, *make_inputs())["err"]}


if __name__ == "__main__":
    main()
