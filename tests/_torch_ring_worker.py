"""One rank of the port's multi-rank ring and collectives check, over
gloo on the CPU. It imports torch and the port only, never JAX.

    python tests/_torch_ring_worker.py STORE WORLD RANK OUT

Every rank joins a world of WORLD ranks through
`mesh.initialize_multihost`, the shared file STORE its rendezvous
(gloo: the ranks see no card), and runs the same program; rank 0 writes what the checks need to
OUT/results.npz, and every rank writes OUT/done.<rank> when it ends
well. `tests/test_torch_ring_ranks.py` starts the ranks and compares
their results with numpy and with the JAX package's n-device ring.
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
from torch.utils.flop_counter import FlopCounterMode

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from idc_models_tpu_torch import collectives, mesh  # noqa: E402
from idc_models_tpu_torch import ring_attention as tring  # noqa: E402
from idc_models_tpu_torch.models.attention import (  # noqa: E402
    TransformerBlock,
)
from idc_models_tpu_torch.models.core import init_params  # noqa: E402

# the ring cases: ring sizes (groups of the first n ranks), and a local
# block of 256 positions -- the least the pallas zigzag ring takes
RING_SIZES = (2, 3, 4)
B, T_LOCAL, H, D = 2, 256, 2, 8
CASES = [(n, layout, impl, causal) for n in RING_SIZES
         for layout in ("contiguous", "zigzag")
         for impl in ("jnp", "pallas") for causal in (False, True)]
FLOP_RING = 4               # the FLOP-ratio gate's ring size
COLLECTIVE_WEIGHTS = np.asarray([3.0, 0.0, 1.0, 2.0], np.float32)
# a causal TransformerBlock over a 4-rank ring: width, heads, MLP width,
# and its (layout, block engine) cases
BLOCK_RING = 4
BLOCK_E, BLOCK_HEADS, BLOCK_MLP = 16, 2, 32
BLOCK_CASES = [(layout, impl) for layout in ("contiguous", "zigzag")
               for impl in ("jnp", "pallas")]


def ring_inputs(n: int):
    """q, k, v and the output cotangent of the n-rank cases, [B, T, H, D]
    with T = n * T_LOCAL, in natural order."""
    rng = np.random.default_rng(100 + n)
    return [rng.normal(0, 1, (B, n * T_LOCAL, H, D)).astype(np.float32)
            for _ in range(4)]


def case_key(n, layout, impl, causal) -> str:
    return f"{n}_{layout}_{impl}_{int(causal)}"


def collective_values(world: int) -> np.ndarray:
    """Rank r's member of the collectives checks is row r."""
    return np.arange(world * 6, dtype=np.float32).reshape(world, 6) - 5.0


def run_ring_case(group, n, layout, impl, causal, inputs) -> dict:
    """This rank's shard through the ring, forward and backward; the
    output and gradients gathered over the group, in natural order."""
    zig = layout == "zigzag"
    q, k, v, g = (torch.from_numpy(x) for x in inputs)
    if zig:
        q, k, v, g = (tring.to_zigzag(x, n) for x in (q, k, v, g))
    q, k, v, g = (tring.local_shard(x, group).contiguous()
                  for x in (q, k, v, g))
    q, k, v = (x.requires_grad_() for x in (q, k, v))
    ring = tring.make_ring_attention(causal=causal, block_impl=impl,
                                     layout=layout, group=group)
    out = ring(q, k, v)
    out.backward(g)
    res = {}
    for name, x in (("out", out.detach()), ("dq", q.grad), ("dk", k.grad),
                    ("dv", v.grad)):
        x = tring.gather_shards(x, group)
        res[name] = (tring.from_zigzag(x, n) if zig else x).numpy()
    return res


def block_case(group, n: int, layout: str, impl: str) -> dict:
    """A causal TransformerBlock (`group` its ring of n ranks, each rank
    holding its shard of the residual stream) and the same weights on a
    ring of one over the whole sequence: outputs, input gradients and
    parameter gradients. Every parameter acts per position, so the
    sharded block's parameter gradients are its ranks' sum."""
    rng = np.random.default_rng(7)
    x_np, g_np = (rng.normal(0, 1, (B, n * T_LOCAL, BLOCK_E))
                  .astype(np.float32) for _ in range(2))
    res = {}
    for name, grp, ranks in (("ring", group, n), ("one", None, 1)):
        blk = init_params(TransformerBlock(
            BLOCK_E, BLOCK_HEADS, BLOCK_MLP, causal=True, block_impl=impl,
            layout=layout, group=grp), 0)
        x, g = torch.from_numpy(x_np), torch.from_numpy(g_np)
        if layout == "zigzag":
            x, g = tring.to_zigzag(x, ranks), tring.to_zigzag(g, ranks)
        x, g = (tring.local_shard(t, grp).contiguous() for t in (x, g))
        x.requires_grad_()
        out = blk(x)
        out.backward(g)
        grads = torch.cat([p.grad.reshape(-1) for p in blk.parameters()])
        if grp is not None:
            grads = collectives.psum(grads, grp)
        for what, t in (("out", out.detach()), ("dx", x.grad)):
            t = tring.gather_shards(t, grp)
            res[f"{what}_{name}"] = (tring.from_zigzag(t, ranks)
                                     if layout == "zigzag" else t).numpy()
        res[f"dparams_{name}"] = grads.numpy()
    return res


def flop_ratio(group, n: int) -> float:
    """Forward FLOPs of this rank's causal plain-engine ring, zigzag over
    contiguous, as `torch.utils.flop_counter` counts them."""
    q, k, v = (tring.local_shard(torch.from_numpy(x), group).contiguous()
               for x in ring_inputs(n)[:3])
    flops = []
    for layout in ("contiguous", "zigzag"):
        ring = tring.make_ring_attention(causal=True, layout=layout,
                                         group=group)
        with torch.no_grad(), FlopCounterMode(display=False) as counter:
            ring(q, k, v)
        flops.append(counter.get_total_flops())
    return flops[1] / flops[0]


def collectives_checks(world: int) -> dict:
    me = collectives.axis_index()
    vals = collective_values(world)
    x = torch.from_numpy(vals[me])
    ints = torch.from_numpy((vals[me] * 1e8).astype(np.int64)
                            .astype(np.int32))
    bad = torch.full_like(x, float("nan"))
    w = float(COLLECTIVE_WEIGHTS[me])
    fwd = collectives.ring_perm(world)
    res = {
        "axis": np.asarray([collectives.axis_index(),
                            collectives.axis_size()]),
        "psum": collectives.psum({"a": x, "b": [x * 2]}),
        "pmean": collectives.pmean(x),
        "weighted": collectives.weighted_pmean(x, w),
        # a member of weight 0 that diverged must not poison the mean
        "weighted_nan": collectives.weighted_pmean(x if w > 0 else bad, w),
        "weighted_local": collectives.weighted_pmean_local(
            torch.stack([x, x * 3]), torch.tensor([w, 1.0])),
        "gather": collectives.all_gather(x),
        "gather_tiled": collectives.all_gather(x[None], axis=0, tiled=True),
        "ppermute": collectives.ppermute(x, None, fwd),
        # a permutation that leaves rank 0 out: it receives zeros
        "ppermute_partial": collectives.ppermute(
            x, None, [(i, i + 1) for i in range(world - 1)]),
        "ring_psum": collectives.ring_psum(x),
        "ring_psum_int": collectives.ring_psum(ints),
        "psum_int": collectives.psum(ints),
        "reduce_scatter": collectives.reduce_scatter(
            torch.from_numpy(np.tile(vals[me], (world, 1)))),
        "dividing": np.asarray([mesh.largest_dividing_mesh(c)
                                for c in (1, 6, 7, 8, 12)]),
    }
    # the ppermute ring reduction of the JAX package's own test: n-1
    # shifts, each adding the visiting block
    acc, carry = x.clone(), x
    for _ in range(world - 1):
        carry = collectives.ppermute(carry, None, fwd)
        acc = acc + carry
    res["ppermute_ring_sum"] = acc
    # the hop under autograd: the gradient goes back the other way
    y = x.clone().requires_grad_()
    (collectives.ppermute(y, None, fwd) * (me + 1)).sum().backward()
    res["ppermute_grad"] = y.grad
    # a 2-D (data, seq) grid: sums along each axis
    grid = mesh.data_seq_mesh(2)
    res["grid"] = np.asarray([grid.coords["data"], grid.coords["seq"]])
    res["grid_seq_sum"] = collectives.psum(x, grid.group(mesh.SEQ_AXIS))
    res["grid_data_sum"] = collectives.psum(x, grid.group(mesh.DATA_AXIS))
    flat = {}
    for key, val in res.items():
        if isinstance(val, dict):
            val = torch.cat([val["a"], val["b"][0]])
        flat[key] = np.asarray(val)
    # every rank's results, gathered to one file
    return {key: collectives.all_gather(torch.from_numpy(np.asarray(v)))
            .numpy() for key, v in flat.items()}


def main(store: str, world: int, rank: int, out: Path) -> None:
    torch.set_num_threads(1)
    # a rank that waits past this on the others raises
    mesh.PROCESS_GROUP_TIMEOUT_S = 60.0
    mesh.initialize_multihost(f"file://{store}", world, rank)
    try:
        results = {f"coll_{k}": v
                   for k, v in collectives_checks(world).items()}
        meshes = {n: mesh.seq_mesh(n) for n in RING_SIZES}
        inputs = {n: ring_inputs(n) for n in RING_SIZES}
        for n, layout, impl, causal in CASES:
            if meshes[n].coords is None:
                continue
            res = run_ring_case(meshes[n].group(mesh.SEQ_AXIS), n, layout,
                                impl, causal, inputs[n])
            for name, x in res.items():
                results[f"{case_key(n, layout, impl, causal)}_{name}"] = x
        if meshes[2].coords is not None:
            try:
                tring.local_shard(torch.zeros(1, 7, 1, D),
                                  meshes[2].group(mesh.SEQ_AXIS))
            except ValueError as e:
                results["shard_error"] = np.asarray(str(e))
        for layout, impl in BLOCK_CASES:
            res = block_case(meshes[BLOCK_RING].group(mesh.SEQ_AXIS),
                             BLOCK_RING, layout, impl)
            for name, x in res.items():
                results[f"block_{layout}_{impl}_{name}"] = x
        ratio = flop_ratio(meshes[FLOP_RING].group(mesh.SEQ_AXIS), FLOP_RING)
        results["flop_ratio"] = collectives.all_gather(
            torch.tensor([ratio], dtype=torch.float64)).numpy()
        dist.barrier()
        if rank == 0:
            np.savez(out / "results.npz", **results)
        (out / f"done.{rank}").write_text("ok")
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), Path(sys.argv[4]))
