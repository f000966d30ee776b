"""Collectives over a ``torch.distributed`` process group, the
counterpart of ``idc_models_tpu/collectives.py``.

Every function takes the process `group` where the JAX function takes an
``axis_name``: a group the caller built (``mesh.py`` builds them), or
None for the default group. Where ``torch.distributed`` is not
initialized, None is a one-rank world: rank 0 of 1, and every collective
returns its input's values. The backend is the group's own: NCCL on the
card, gloo on the CPU.

Trees (a tensor, or nested lists, tuples and dicts of tensors) are
accepted where the JAX function takes a pytree. The functions run
outside any traced program, eagerly, one collective call per tensor.
`ppermute` is differentiable, as ``lax.ppermute`` is: its backward sends
the gradient the other way round the permutation, so a ring built from
it trains under autograd. The others are not; the sharded layers use the
differentiable operators at the end of this file, each with the backward
its place in a sharded program needs (`mean_moments`, `enter_split`,
`leave_split`, `gather_on_use`).
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.utils import _pytree


def initialized() -> bool:
    """Whether a ``torch.distributed`` world is up (else: one rank)."""
    return dist.is_available() and dist.is_initialized()


def axis_size(group=None) -> int:
    """How many ranks the group holds (1 in a one-rank world)."""
    return dist.get_world_size(group) if initialized() else 1


def axis_index(group=None) -> int:
    """This rank's index within the group (0 in a one-rank world)."""
    return dist.get_rank(group) if initialized() else 0


def is_writer() -> bool:
    """Whether this process is rank 0, which prints a run's records and
    writes its files; the other ranks only compute."""
    return axis_index() == 0


def broadcast_host(values, group, src: int = 0) -> list[float]:
    """Group rank `src`'s float64 `values` on every rank of `group`, a
    gloo group of host values (``mesh.Mesh.host_group``); a group of one
    rank returns them as they are."""
    t = torch.tensor(values, dtype=torch.float64)
    if axis_size(group) > 1:
        dist.broadcast(t, src=_global_rank(group, src), group=group)
    return t.tolist()


def world_max(values) -> list[float]:
    """The elementwise maximum of float `values` over every rank of the
    world (this rank's own in a world of one): how the ranks that run
    one loop together settle a decision each made from its own clock.
    The tensor goes where the world's backend reduces (the current card
    under NCCL)."""
    if axis_size() == 1:
        return [float(v) for v in values]
    device = (torch.device("cuda", torch.cuda.current_device())
              if dist.get_backend() == "nccl" else torch.device("cpu"))
    t = torch.tensor(values, dtype=torch.float64, device=device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return t.tolist()


def _global_rank(group, rank: int) -> int:
    """A group rank as the default group numbers it, which is what
    point-to-point operations take."""
    return rank if group is None else dist.get_global_rank(group, rank)


def _sum(x: torch.Tensor, group) -> torch.Tensor:
    out = x.clone()
    if axis_size(group) > 1:
        dist.all_reduce(out, group=group)
    return out


def psum(tree, group=None):
    """Sum a tree across the group (gradient all-reduce; mask
    cancellation)."""
    return _pytree.tree_map(lambda x: _sum(x, group), tree)


def psum_(tensors, group=None) -> None:
    """Sum each of `tensors` over the group in place: one all-reduce per
    dtype, over their flat concatenation."""
    if axis_size(group) == 1:
        return
    by_dtype: dict[torch.dtype, list[torch.Tensor]] = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for ts in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in ts])
        dist.all_reduce(flat, group=group)
        for t, part in zip(ts, flat.split([t.numel() for t in ts])):
            t.copy_(part.view_as(t))


def pmean(tree, group=None):
    """Mean of a tree across the group (FedAvg's unweighted aggregate)."""
    n = axis_size(group)
    return _pytree.tree_map(lambda x: _sum(x, group) / n, tree)


def pmax(x: torch.Tensor, group=None) -> torch.Tensor:
    """Elementwise maximum across the group (not differentiable)."""
    out = x.clone()
    if axis_size(group) > 1:
        dist.all_reduce(out, op=dist.ReduceOp.MAX, group=group)
    return out


def weighted_pmean(tree, weight, group=None):
    """Weighted mean across the group, this rank's member weighted by
    `weight`. Negative weights count as 0, and members of weight 0 are
    left out even where their values are not finite (a crashed client
    must not poison the mean through NaN * 0). Every weight 0 gives a
    zero tree, never NaN."""
    return weighted_pmean_local(
        _pytree.tree_map(lambda x: torch.as_tensor(x)[None], tree),
        torch.as_tensor(weight, dtype=torch.float32).reshape(1), group)


def weighted_pmean_local(tree, weights, group=None):
    """Weighted mean over members stacked on each leaf's leading axis
    and over the group (`weights` [k], leaves [k, ...]): the k clients a
    rank trains in one round. The failure semantics of
    `weighted_pmean`, of which this is the general form."""
    weights = torch.clamp(torch.as_tensor(weights, dtype=torch.float32),
                          min=0.0)
    total = _sum(weights.sum(), group)
    safe_total = torch.clamp(total, min=1e-30)

    def contrib(x):
        w = weights.to(x.device).reshape((-1,) + (1,) * (x.dim() - 1)).to(
            x.dtype)
        masked = torch.where(w > 0, x * w, torch.zeros_like(x)).sum(0)
        return _sum(masked, group) / safe_total.to(x.device, x.dtype)

    return _pytree.tree_map(contrib, tree)


def all_gather(x: torch.Tensor, group=None, *, axis: int = 0,
               tiled: bool = False) -> torch.Tensor:
    """Every rank's `x`, in rank order: stacked on a new `axis`, or with
    `tiled` concatenated along it."""
    n = axis_size(group)
    if n == 1:
        parts = [x]
    else:
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x, group=group)
    return torch.cat(parts, axis) if tiled else torch.stack(parts, axis)


def ring_perm(n: int, shift: int = 1) -> list[tuple[int, int]]:
    """(source, destination) pairs of a ring shift of `shift` over n
    ranks."""
    return [(i, (i + shift) % n) for i in range(n)]


def _ppermute(xs, group, perm):
    """Send each of `xs` to the rank `perm` maps this one to and receive
    from the rank mapped to this one, all in one batch of point-to-point
    operations. A rank that nothing is sent to receives zeros, as in
    ``lax.ppermute``."""
    me = axis_index(group)
    if axis_size(group) == 1 or (me, me) in perm:
        return [x if (me, me) in perm else torch.zeros_like(x) for x in xs]
    dst = [d for s, d in perm if s == me]
    src = [s for s, d in perm if d == me]
    sends = [x.contiguous() for x in xs]
    outs = [torch.zeros_like(x) for x in sends]
    ops = []
    for x, out in zip(sends, outs):
        ops += [dist.P2POp(dist.isend, x, _global_rank(group, d), group)
                for d in dst]
        ops += [dist.P2POp(dist.irecv, out, _global_rank(group, s), group)
                for s in src]
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return outs


class _PPermute(torch.autograd.Function):
    """`ppermute` under autograd: the backward sends each gradient back
    along the inverse permutation."""

    @staticmethod
    def forward(ctx, group, perm, *xs):
        ctx.group, ctx.perm = group, perm
        return tuple(_ppermute(xs, group, perm))

    @staticmethod
    def backward(ctx, *grads):
        inverse = tuple((d, s) for s, d in ctx.perm)
        return (None, None, *_ppermute(grads, ctx.group, inverse))


def ppermute(tree, group, perm):
    """Point-to-point permutation of a tree over the group: the
    primitive behind ring schedules. `perm` holds (source, destination)
    pairs of group ranks; every leaf travels in one batch."""
    leaves, spec = _pytree.tree_flatten(tree)
    perm = tuple((int(s), int(d)) for s, d in perm)
    if torch.is_grad_enabled() and any(x.requires_grad for x in leaves):
        outs = _PPermute.apply(group, perm, *leaves)
    else:
        outs = _ppermute(leaves, group, perm)
    return _pytree.tree_unflatten(list(outs), spec)


def reduce_scatter(x: torch.Tensor, group=None, *,
                   scatter_dimension: int = 0) -> torch.Tensor:
    """This rank's block of the group's sum, `x` cut into as many equal
    blocks along `scatter_dimension` as the group has ranks (tiled, as
    the JAX package calls ``psum_scatter``). NCCL's own reduce-scatter
    on the card; on gloo, which has none, an all-reduce and a slice."""
    n, me = axis_size(group), axis_index(group)
    size = x.shape[scatter_dimension]
    if size % n:
        raise ValueError(f"dimension {scatter_dimension} of size {size} "
                         f"does not divide into {n} blocks")
    if n > 1 and dist.get_backend(group) == "nccl":
        blocks = x.movedim(scatter_dimension, 0).contiguous()
        out = torch.empty((size // n,) + blocks.shape[1:], dtype=x.dtype,
                          device=x.device)
        dist.reduce_scatter_tensor(out, blocks, group=group)
        return out.movedim(0, scatter_dimension)
    return _sum(x, group).narrow(scatter_dimension, me * (size // n),
                                 size // n)


def ring_psum(x: torch.Tensor, group=None) -> torch.Tensor:
    """All-reduce as an explicit bandwidth-optimal ring: a chunked
    reduce-scatter, then an all-gather, each of n-1 neighbour
    `ppermute` shifts -- the schedule under the caller's control, which
    a ring that fuses compute between hops builds on. Equal to `psum`
    up to summation order: bit for bit for integer types (int32 masks
    wrap the same in any order), within rounding for floats."""
    n = axis_size(group)
    if n == 1:
        return x.clone()
    me = axis_index(group)
    fwd = ring_perm(n)
    flat = x.reshape(-1)
    chunk = -(-flat.numel() // n)
    blocks = torch.nn.functional.pad(
        flat, (0, chunk * n - flat.numel())).reshape(n, chunk)

    # reduce-scatter: after step s the carry holds s+2 ranks' partial
    # sum; after n-1 steps rank i owns the full sum of block (i+1) % n
    carry = blocks[me]
    for s in range(n - 1):
        carry = ppermute(carry, group, fwd) + blocks[(me - s - 1) % n]

    # all-gather: circulate the n reduced blocks round the ring
    out = torch.zeros_like(blocks)
    out[(me + 1) % n] = carry
    for s in range(n - 1):
        carry = ppermute(carry, group, fwd)
        out[(me - s) % n] = carry
    return out.reshape(-1)[:flat.numel()].reshape(x.shape)


# ---------------------------------------------------------------------------
# differentiable operators of the sharded layers
#
# A tensor replicated over a group is held whole by every rank, and so is
# its gradient; a tensor split over the group is held in blocks, each with
# the gradient of its block. Each operator below maps one to the other,
# and its backward is the one that keeps that contract.
# ---------------------------------------------------------------------------


class _MeanMoments(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, *xs):
        ctx.group = group
        return tuple(pmean(list(xs), group))

    @staticmethod
    def backward(ctx, *grads):
        return (None, *pmean(list(grads), ctx.group))


def mean_moments(xs, group):
    """The group's mean of each of `xs`, with the mean's adjoint (the
    group's mean of the gradients) as the backward: batch statistics of
    the global batch from each rank's moments, each rank's loss the mean
    of its own rows (BatchNorm under data parallelism)."""
    if axis_size(group) == 1:
        return list(xs)
    return list(_MeanMoments.apply(group, *xs))


class _EnterSplit(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, x):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return None, _sum(grad, ctx.group)


def enter_split(x: torch.Tensor, group) -> torch.Tensor:
    """A replicated tensor about to feed a split computation (the input
    of a column-parallel layer): the identity, whose backward sums the
    ranks' partial gradients."""
    if axis_size(group) == 1:
        return x
    return _EnterSplit.apply(group, x)


class _LeaveSplit(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, x):
        return _sum(x, group)

    @staticmethod
    def backward(ctx, grad):
        return None, grad


def leave_split(x: torch.Tensor, group) -> torch.Tensor:
    """Partial sums of a split computation made whole (the output of a
    row-parallel layer, a pooled mean over sequence shards): the group's
    sum, whose backward passes the replicated gradient through."""
    if axis_size(group) == 1:
        return x
    return _LeaveSplit.apply(group, x)


class _GatherOnUse(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, dim, reduce, x):
        ctx.group, ctx.dim, ctx.reduce = group, dim, reduce
        return all_gather(x, group, axis=dim, tiled=True)

    @staticmethod
    def backward(ctx, grad):
        if ctx.reduce:
            out = reduce_scatter(grad, ctx.group, scatter_dimension=ctx.dim)
        else:
            n, me = axis_size(ctx.group), axis_index(ctx.group)
            size = grad.shape[ctx.dim] // n
            out = grad.narrow(ctx.dim, me * size, size)
        return None, None, None, out


def gather_on_use(x: torch.Tensor, group, dim: int, *,
                  reduce: bool) -> torch.Tensor:
    """The whole parameter from this rank's block along `dim`. With
    `reduce` (FSDP: every rank computes on its own rows) the backward
    reduce-scatters the gradient, the sum over the group of this
    block's part; without it (every rank computes the same thing) it
    keeps this block's part of the replicated gradient."""
    if axis_size(group) == 1:
        return x
    return _GatherOnUse.apply(group, dim, reduce, x)
