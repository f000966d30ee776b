"""Ring attention: exact causal or full attention folded block by block
through an online softmax, the counterpart of
``idc_models_tpu/ring_attention.py``.

Each of the n ring steps folds the visiting K/V block into the running
(m, l, acc) carry -- the flash-attention recurrence -- and then passes
the block on. Causal masking uses GLOBAL positions: the queries of rank
``me`` start at ``me * t_local``, and after s hops the visiting block is
rank ``(me - s) mod n``'s, starting at ``((me - s) mod n) * t_local``.

This port runs the ring at world size 1, one card: the hop is the
identity, but the loop over the n steps and the global offsets stay, so
the multi-card ring (ROADMAP A4: ``torch.distributed`` isend/irecv on a
"seq" group) plugs in where ``_hop`` is. ``block_impl="jnp"`` folds with
the plain PyTorch recurrence and is differentiated by autograd;
``block_impl="pallas"`` (the JAX package's name, kept so commands carry
over) folds with the hand-written CUDA kernels of
``ops/flash_block_kernel.py`` under a ring-level autograd.Function that
saves only (q, k, v, out, L) and runs a second, backward ring through
the blockwise flash backward kernels: no [T, T] tensor is kept or built
in either direction. The zigzag layout and world size > 1 are not
ported yet (ROADMAP A8, A4).
"""

from __future__ import annotations

import numpy as np
import torch

from idc_models_tpu_torch.ops import flash_block_kernel as fbk
from idc_models_tpu_torch.ops.flash_block_kernel import (
    MASKED, block_attend, causal_block_mask,
)

BLOCK_IMPLS = ("jnp", "pallas")


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


def _hop(x: torch.Tensor) -> torch.Tensor:
    """Pass a block to the next rank. At world size 1 the block stays:
    the identity. The multi-card ring replaces this (ROADMAP A4)."""
    return x


def _fresh_carry(q):
    b, t, h, d = q.shape
    f32 = dict(dtype=torch.float32, device=q.device)
    return (torch.full((b, h, t), MASKED, **f32),
            torch.zeros((b, h, t), **f32), torch.zeros((b, t, h, d), **f32))


def _contiguous_fold(q, k, v, attend, n: int, me: int = 0):
    """The contiguous ring walk: n steps, each folding the visiting block
    and hopping it on. Returns the raw (m, l, acc) carry."""
    t_local = q.shape[1]
    m, l, acc = _fresh_carry(q)
    kc, vc = k, v
    for s in range(n):
        kv_rank = (me - s) % n
        m, l, acc = attend(q, kc, vc, m, l, acc, me * t_local,
                           kv_rank * t_local)
        kc, vc = _hop(kc), _hop(vc)
    return m, l, acc


class _PallasRing(torch.autograd.Function):
    """The ring-level custom vjp of the JAX package's ``pallas_ring_vjp``:
    the forward ring folds with the block-update kernel and saves only
    (q, k, v, out, L = m + log max(l, 1e-37)); the backward computes
    D = rowsum(dout * out) and runs the backward ring with the dq and
    dk/dv kernels, the dk/dv accumulators travelling with their block."""

    @staticmethod
    def forward(ctx, q, k, v, scale, causal, n):
        def attend(q_, kc, vc, m, l, acc, q_off, k_off):
            offs = torch.tensor([q_off, k_off], dtype=torch.int32,
                                device=q_.device)
            return fbk.flash_block_fold(q_, kc, vc, m, l, acc, offs,
                                        scale=scale, causal=causal)

        m, l, acc = _contiguous_fold(q, k, v, attend, n)
        out = finalize(l, acc, q.dtype)
        lse = m + torch.log(torch.clamp(l, min=1e-37))
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.scale, ctx.causal, ctx.n = scale, causal, n
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        n, me = ctx.n, 0
        t_local = q.shape[1]
        dout = dout.contiguous()
        delta = torch.einsum("bqhd,bqhd->bhq", dout.float(), out.float())
        f32 = dict(dtype=torch.float32, device=q.device)
        dq = torch.zeros(q.shape, **f32)
        dk, dv = torch.zeros(k.shape, **f32), torch.zeros(v.shape, **f32)
        kc, vc = k, v
        for s in range(n):
            offs = torch.tensor([me * t_local, ((me - s) % n) * t_local],
                                dtype=torch.int32, device=q.device)
            dqp, dkb, dvb = fbk.flash_block_grads(
                q, kc, vc, dout, lse, delta, offs, scale=ctx.scale,
                causal=ctx.causal)
            dq, dk, dv = dq + dqp, dk + dkb, dv + dvb
            # dk/dv travel with their block; after the n-th hop they are
            # back with the block's owner
            kc, vc, dk, dv = (_hop(x) for x in (kc, vc, dk, dv))
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype),
                None, None, None)


def make_ring_attention(*, causal: bool = False, scale: float | None = None,
                        block_impl: str = "jnp",
                        layout: str = "contiguous", world_size: int = 1):
    """Build ``fn(q, k, v) -> out`` over [B, T, H, D]: exact attention
    through the ring. `scale` defaults to head_dim ** -0.5.
    ``block_impl="pallas"`` needs T a multiple of 128 (ValueError
    otherwise, as in the JAX package)."""
    if block_impl not in BLOCK_IMPLS:
        raise ValueError(f"unknown block_impl {block_impl!r}")
    if layout not in ("contiguous", "zigzag"):
        raise ValueError(f"unknown layout {layout!r}")
    if layout == "zigzag":
        raise NotImplementedError(
            "layout='zigzag' is not ported yet (ROADMAP A8: the balanced "
            "causal schedule comes with the multi-card ring)")
    if world_size != 1:
        raise NotImplementedError(
            f"world_size {world_size}: the ring runs on one card so far "
            f"(ROADMAP A4: torch.distributed over a 'seq' group)")
    n = world_size

    def attend_plain(scale_):
        def attend(q, kc, vc, m, l, acc, q_off, k_off):
            mask = (causal_block_mask(q.shape[1], kc.shape[1], q_off, k_off,
                                      device=q.device) if causal else None)
            return block_attend(q.float(), kc.float(), vc.float(), m, l,
                                acc, scale=scale_, mask=mask)
        return attend

    def ring(q, k, v):
        t = q.shape[1]
        if t % n:
            raise ValueError(f"sequence length {t} not divisible by the "
                             f"ring size {n} over mesh axis 'seq'")
        scale_ = scale if scale is not None else q.shape[-1] ** -0.5
        if block_impl == "pallas":
            return _PallasRing.apply(q.contiguous(), k.contiguous(),
                                     v.contiguous(), float(scale_),
                                     bool(causal), n)
        _, l, acc = _contiguous_fold(q, k, v, attend_plain(scale_), n)
        return finalize(l, acc, q.dtype)

    return ring
