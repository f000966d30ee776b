"""Ring attention: exact causal or full attention over a sequence sharded
across the ranks of a ring, folded block by block through an online
softmax -- the counterpart of ``idc_models_tpu/ring_attention.py``.

Each rank holds its own query block for the whole computation and one
visiting K/V block. At each of the n ring steps it folds the visiting
block into the running (m, l, acc) carry -- the flash-attention
recurrence -- and passes the block on to the next rank. Causal masking
uses GLOBAL positions: rank ``me``'s queries start at ``me * t_local``,
and after s hops the visiting block is rank ``(me - s) mod n``'s.

The ring is a small object (`make_ring`) with this rank's index, the
ring's size and ``hop(*xs)``, which sends to rank+1 and receives from
rank-1: the identity for a ring of one (``group=None``: one card), a
batch of ``torch.distributed`` point-to-point operations
(``collectives.ppermute``) over a process group otherwise. Each rank
passes its own shard of the sequence (`local_shard`) and gets its shard
of the output back (`gather_shards` puts the sequence together).

``layout="zigzag"`` balances the causal schedule: the sequence is cut
into 2n stripes and rank i holds stripes (i, 2n-1-i) -- permute inputs
with `to_zigzag` and the output back with `from_zigzag`. Every rank then
folds three quarter-blocks of its own block (two causal stripe
diagonals and the always-visible high-queries-on-low-keys quarter; the
low-on-high quarter is empty) and two fully visible quarters a hop:
2n+1 quarters where the contiguous layout folds n full blocks, 4n
quarters, of which the masked ones are wasted. The quarters and their
carries are kept as separate contiguous halves, the hops carry the
halves, and the kernels take them as they are. Without `causal` the
layout changes nothing (dense attention is permutation-equivariant), so
a non-causal zigzag ring walks the contiguous schedule.

``block_impl="jnp"`` folds with the plain PyTorch recurrence and is
differentiated by autograd, through differentiable hops.
``block_impl="pallas"`` (the JAX package's name, kept so commands carry
over) folds with the hand-written CUDA kernels of
``ops/flash_block_kernel.py`` under a ring-level autograd.Function that
saves only (q, k, v, out, L) and runs a second, backward ring through
the blockwise flash backward kernels, the dk/dv accumulators riding the
hops home: no [T, T] tensor is kept or built in either direction.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from idc_models_tpu_torch import collectives
from idc_models_tpu_torch.ops import flash_block_kernel as fbk
from idc_models_tpu_torch.ops.flash_block_kernel import (
    MASKED, block_attend, causal_block_mask,
)

BLOCK_IMPLS = ("jnp", "pallas")
LAYOUTS = ("contiguous", "zigzag")


def zigzag_indices(t: int, n: int) -> np.ndarray:
    """Global gather indices realizing the zigzag layout: the sequence is
    cut into 2n equal stripes and rank i's contiguous shard becomes
    [stripe i, stripe 2n-1-i]. ``x_zig = x.take(p, axis=seq)``; the
    inverse is ``argsort(p)``."""
    if t % (2 * n):
        raise ValueError(f"sequence length {t} not divisible by 2*{n}")
    sw = t // (2 * n)
    stripes = np.arange(t).reshape(2 * n, sw)
    order = []
    for i in range(n):
        order += [i, 2 * n - 1 - i]
    return stripes[order].reshape(-1)


def to_zigzag(x: torch.Tensor, n: int, *, axis: int = 1) -> torch.Tensor:
    """Permute a sequence axis into the zigzag layout for an n-rank ring."""
    idx = torch.as_tensor(zigzag_indices(x.shape[axis], n), device=x.device)
    return torch.index_select(x, axis, idx)


def from_zigzag(x: torch.Tensor, n: int, *, axis: int = 1) -> torch.Tensor:
    """Inverse of `to_zigzag`: restore natural sequence order."""
    inv = np.argsort(zigzag_indices(x.shape[axis], n))
    return torch.index_select(x, axis, torch.as_tensor(inv, device=x.device))


def full_attention(q, k, v, *, causal: bool = False,
                   scale: float | None = None) -> torch.Tensor:
    """Single-device reference: softmax(q k^T * scale) v over [B,T,H,D],
    in f32 with a -inf causal mask, cast back to q's dtype."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        t = q.shape[1]
        mask = torch.tril(torch.ones(t, t, dtype=torch.bool,
                                     device=q.device))
        scores = torch.where(mask, scores, float("-inf"))
    w = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", w, v.float()).to(q.dtype)


def finalize(l, acc, dtype) -> torch.Tensor:
    """The attention output from the raw carry: acc / max(l, 1e-37),
    cast to `dtype`."""
    norm = l.transpose(1, 2)[..., None]
    return (acc / torch.clamp(norm, min=1e-37)).to(dtype)


# ---------------------------------------------------------------------------
# the ring
# ---------------------------------------------------------------------------


class LocalRing:
    """A ring of one: this card alone, whose hop is the identity."""

    rank, size = 0, 1

    def hop(self, *xs):
        return xs


class GroupRing:
    """The ranks of a ``torch.distributed`` process group in rank order:
    ``hop(*xs)`` sends every tensor to rank+1 and receives rank-1's, in
    one batch of point-to-point operations."""

    def __init__(self, group):
        self.group = group
        self.rank = collectives.axis_index(group)
        self.size = collectives.axis_size(group)
        self._perm = collectives.ring_perm(self.size)

    def hop(self, *xs):
        return tuple(collectives.ppermute(list(xs), self.group, self._perm))


def make_ring(group=None):
    """The ring over `group`; None is a ring of one."""
    return LocalRing() if group is None else GroupRing(group)


def local_shard(x: torch.Tensor, group=None, *, axis: int = 1):
    """This rank's block of a sequence axis, cut into as many equal
    blocks as the ring has ranks."""
    ring = make_ring(group)
    t = x.shape[axis]
    if t % ring.size:
        raise ValueError(f"sequence length {t} not divisible by the ring "
                         f"size {ring.size} over mesh axis 'seq'")
    t_local = t // ring.size
    return x.narrow(axis, ring.rank * t_local, t_local)


def gather_shards(x: torch.Tensor, group=None, *, axis: int = 1):
    """Every rank's block of a sequence axis, put back together in rank
    order (the inverse of `local_shard`)."""
    if group is None:
        return x
    return collectives.all_gather(x, group, axis=axis, tiled=True)


# ---------------------------------------------------------------------------
# the two schedules, shared by both block engines
# ---------------------------------------------------------------------------


def _fresh_carry(q):
    b, t, h, d = q.shape
    f32 = dict(dtype=torch.float32, device=q.device)
    return (torch.full((b, h, t), MASKED, **f32),
            torch.zeros((b, h, t), **f32), torch.zeros((b, t, h, d), **f32))


def _contiguous_fold(q, k, v, attend, ring, causal: bool):
    """The contiguous walk: n steps, each folding the visiting block,
    the block hopping on between steps. Returns the raw (m, l, acc)."""
    n, me = ring.size, ring.rank
    t_local = q.shape[1]
    m, l, acc = _fresh_carry(q)
    kc, vc = k, v
    for s in range(n):
        if s:
            kc, vc = ring.hop(kc, vc)
        c = (me - s) % n
        m, l, acc = attend(q, kc, vc, m, l, acc, me * t_local, c * t_local,
                           causal)
    return m, l, acc


def _half(t_local: int) -> int:
    if t_local % 2:
        raise ValueError(
            f"zigzag layout needs an even local block, got {t_local}")
    return t_local // 2


def _halves(x, th: int, dim: int = 1):
    """The two stripes of a zigzag block, each contiguous."""
    return (x.narrow(dim, 0, th).contiguous(),
            x.narrow(dim, th, th).contiguous())


def _stripe_offsets(c: int, n: int, th: int) -> tuple[int, int]:
    """Global starts of rank c's stripes c and 2n-1-c."""
    return c * th, (2 * n - 1 - c) * th


def zigzag_schedule(me: int, n: int, th: int):
    """Rank me's walk of the balanced causal schedule of an n-rank ring
    with stripes of th positions: for each ring step (the visiting block
    is rank (me - s) mod n's after s hops), the quarter folds of that
    step as (query stripe, key stripe, q_off, k_off, causal), stripe 0
    the low half of a block and 1 its high half, offsets global.

    Rank me's block is [stripe me, stripe 2n-1-me]. Step 0 folds both
    stripe diagonals (causal) and the high queries against the low keys
    (fully visible); the low queries against the high keys are empty.
    Each hop then folds exactly two fully visible quarters: the high
    queries against the visiting low stripe, and (low, low) if the
    visiting rank c < me, else (high, high). The forward and backward
    rings both walk it."""
    lo, hi = _stripe_offsets(me, n, th)
    yield [(0, 0, lo, lo, True), (1, 1, hi, hi, True), (1, 0, hi, lo, False)]
    for s in range(1, n):
        c = (me - s) % n
        c_lo, c_hi = _stripe_offsets(c, n, th)
        yield [(1, 0, hi, c_lo, False),
               (0, 0, lo, c_lo, False) if c < me
               else (1, 1, hi, c_hi, False)]


def _zigzag_fold(q, k, v, attend, ring):
    """The forward walk of `zigzag_schedule`, the four key/value halves
    hopping between steps. Returns the raw carries of the low and the
    high rows."""
    th = _half(q.shape[1])
    qs = _halves(q, th)
    kv = [*_halves(k, th), *_halves(v, th)]     # k_lo, k_hi, v_lo, v_hi
    carry = [_fresh_carry(x) for x in qs]
    for s, quarters in enumerate(zigzag_schedule(ring.rank, ring.size, th)):
        if s:
            kv = ring.hop(*kv)
        for qi, ki, q_off, k_off, causal in quarters:
            carry[qi] = attend(qs[qi], kv[ki], kv[2 + ki], *carry[qi],
                               q_off, k_off, causal)
    return carry


def _offsets(q_off: int, k_off: int, device) -> torch.Tensor:
    return torch.tensor([q_off, k_off], dtype=torch.int32, device=device)


def _plain_attend(scale):
    def attend(q, kc, vc, m, l, acc, q_off, k_off, masked):
        mask = (causal_block_mask(q.shape[1], kc.shape[1], q_off, k_off,
                                  device=q.device) if masked else None)
        return block_attend(q.float(), kc.float(), vc.float(), m, l, acc,
                            scale=scale, mask=mask)
    return attend


def _kernel_attend(scale):
    def attend(q, kc, vc, m, l, acc, q_off, k_off, masked):
        return fbk.flash_block_fold(q, kc, vc, m, l, acc,
                                    _offsets(q_off, k_off, q.device),
                                    scale=scale, causal=masked)
    return attend


# ---------------------------------------------------------------------------
# the pallas engine: the ring-level autograd.Function
# ---------------------------------------------------------------------------


class _PallasRing(torch.autograd.Function):
    """The ring-level custom vjp of the JAX package's ``pallas_ring_vjp``:
    the forward ring folds with the block-update kernel and saves only
    (q, k, v, out, L = m + log max(l, 1e-37)); the backward computes
    D = rowsum(dout * out) and re-walks the forward's schedule with the
    dq and dk/dv kernels, the dk/dv accumulators travelling with their
    block and one trailing hop delivering them to its owner."""

    @staticmethod
    def forward(ctx, q, k, v, scale, causal, zigzag, ring):
        attend = _kernel_attend(scale)
        if zigzag:
            lo, hi = _zigzag_fold(q, k, v, attend, ring)
            out = torch.cat([finalize(lo[1], lo[2], q.dtype),
                             finalize(hi[1], hi[2], q.dtype)], 1)
            m, l = torch.cat([lo[0], hi[0]], 2), torch.cat([lo[1], hi[1]], 2)
        else:
            m, l, acc = _contiguous_fold(q, k, v, attend, ring, causal)
            out = finalize(l, acc, q.dtype)
        lse = m + torch.log(torch.clamp(l, min=1e-37))
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.scale, ctx.causal, ctx.zigzag, ctx.ring = (scale, causal,
                                                       zigzag, ring)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dout = dout.contiguous()
        delta = torch.einsum("bqhd,bqhd->bhq", dout.float(), out.float())
        walk = _zigzag_grads if ctx.zigzag else _contiguous_grads
        dq, dk, dv = walk(q, k, v, dout, lse, delta, ctx.scale, ctx.causal,
                          ctx.ring)
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype),
                None, None, None, None)


def _block_grads(scale, causal, q, kc, vc, dout, lse, delta, q_off, k_off):
    return fbk.flash_block_grads(q, kc, vc, dout, lse, delta,
                                 _offsets(q_off, k_off, q.device),
                                 scale=scale, causal=causal)


def _f32_zeros(x):
    return torch.zeros(x.shape, dtype=torch.float32, device=x.device)


def _contiguous_grads(q, k, v, dout, lse, delta, scale, causal, ring):
    n, me = ring.size, ring.rank
    t_local = q.shape[1]
    dq, dk, dv = _f32_zeros(q), _f32_zeros(k), _f32_zeros(v)
    kc, vc = k, v
    for s in range(n):
        if s:
            kc, vc, dk, dv = ring.hop(kc, vc, dk, dv)
        c = (me - s) % n
        dqp, dkb, dvb = _block_grads(scale, causal, q, kc, vc, dout, lse,
                                     delta, me * t_local, c * t_local)
        dq += dqp
        dk += dkb
        dv += dvb
    # the n-1 hops left each block's accumulators one rank short of its
    # owner; the n-th delivers them
    dk, dv = ring.hop(dk, dv)
    return dq, dk, dv


def _zigzag_grads(q, k, v, dout, lse, delta, scale, causal, ring):
    """`zigzag_schedule` re-walked with the backward kernels: each
    quarter adds to dq at its query stripe and to dk/dv at its key
    stripe of the visiting block, the accumulators hopping with it."""
    th = _half(q.shape[1])
    # q, dout, L, D of the low stripe's rows, then of the high stripe's
    rows = list(zip(*[_halves(x, th) for x in (q, dout)],
                    *[_halves(x, th, 2) for x in (lse, delta)]))
    kv = [*_halves(k, th), *_halves(v, th)]     # k_lo, k_hi, v_lo, v_hi
    dq = [_f32_zeros(r[0]) for r in rows]
    dkv = [_f32_zeros(x) for x in kv]       # dk_lo, dk_hi, dv_lo, dv_hi
    for s, quarters in enumerate(zigzag_schedule(ring.rank, ring.size, th)):
        if s:
            moved = ring.hop(*kv, *dkv)
            kv, dkv = list(moved[:4]), list(moved[4:])
        for qi, ki, q_off, k_off, diag in quarters:
            qs, do, L, D = rows[qi]
            dqp, dkb, dvb = _block_grads(scale, diag, qs, kv[ki], kv[2 + ki],
                                         do, L, D, q_off, k_off)
            dq[qi] += dqp
            dkv[ki] += dkb
            dkv[2 + ki] += dvb
    # the n-1 hops leave each accumulator one rank before its owner
    dk_lo, dk_hi, dv_lo, dv_hi = ring.hop(*dkv)
    return (torch.cat(dq, 1), torch.cat([dk_lo, dk_hi], 1),
            torch.cat([dv_lo, dv_hi], 1))


# ---------------------------------------------------------------------------
# make_ring_attention
# ---------------------------------------------------------------------------


def make_ring_attention(*, causal: bool = False, scale: float | None = None,
                        block_impl: str = "jnp",
                        layout: str = "contiguous", group=None,
                        unroll: bool = False):
    """Build ``fn(q, k, v) -> out`` over this rank's shard [B, t_local,
    H, D] of the sequence: exact attention through the ring over `group`
    (None: a ring of one, this card). `scale` defaults to
    head_dim ** -0.5.

    ``layout="zigzag"`` expects the inputs permuted with
    ``to_zigzag(x, n)`` before sharding and returns the output in the
    same order; causal runs walk the balanced schedule (odd t_local is a
    ValueError). ``block_impl="pallas"`` needs t_local a multiple of 128,
    and of 256 under the zigzag layout, whose kernel calls take
    half-blocks (ValueError otherwise, as in the JAX package).
    `unroll` is accepted for the JAX package's signature: the ring
    is a Python loop, unrolled already."""
    del unroll
    if block_impl not in BLOCK_IMPLS:
        raise ValueError(f"unknown block_impl {block_impl!r}")
    if layout not in LAYOUTS:
        raise ValueError(f"unknown layout {layout!r}")
    ring = make_ring(group)
    zigzag = layout == "zigzag" and causal

    def attention(q, k, v):
        scale_ = scale if scale is not None else q.shape[-1] ** -0.5
        t_local = q.shape[1]
        if zigzag:
            th = _half(t_local)
            if block_impl == "pallas" and th % fbk.TILE_MIN:
                raise ValueError(
                    f"zigzag + pallas operates on half-blocks: t_local "
                    f"{t_local} gives quarters of {th}, need a multiple "
                    f"of {fbk.TILE_MIN} (t_local % 256 == 0)")
        if block_impl == "pallas":
            return _PallasRing.apply(q.contiguous(), k.contiguous(),
                                     v.contiguous(), float(scale_),
                                     bool(causal), zigzag, ring)
        attend = _plain_attend(scale_)
        if zigzag:
            lo, hi = _zigzag_fold(q, k, v, attend, ring)
            return torch.cat([finalize(lo[1], lo[2], q.dtype),
                              finalize(hi[1], hi[2], q.dtype)], 1)
        _, l, acc = _contiguous_fold(q, k, v, attend, ring, causal)
        return finalize(l, acc, q.dtype)

    return attention


def ring_attention(q, k, v, *, group=None, causal: bool = False,
                   scale: float | None = None, block_impl: str = "jnp",
                   layout: str = "contiguous", unroll: bool = False):
    """One-shot convenience around `make_ring_attention`, every knob of
    it reachable; the function it makes is cached by its arguments. For
    hot loops make the function once."""
    return _cached_ring(group, causal, scale, block_impl, layout,
                        unroll)(q, k, v)


@functools.lru_cache(maxsize=32)
def _cached_ring(group, causal, scale, block_impl, layout, unroll):
    return make_ring_attention(causal=causal, scale=scale,
                               block_impl=block_impl, layout=layout,
                               group=group, unroll=unroll)
