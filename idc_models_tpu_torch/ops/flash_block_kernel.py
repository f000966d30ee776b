"""The flash block update and its blockwise backward: three hand-written
CUDA kernels (``csrc/flash_block_{fwd,dq,dkv}.cu``) and their plain
PyTorch versions.

The counterpart of ``idc_models_tpu/ops/flash_block_kernel.py``:

- ``flash_block_update(q, k, v, m, l, acc, offsets, *, scale, causal)``
  folds one visiting K/V block into an online-softmax carry (m, l, acc);
  an autograd.Function whose backward is autograd of the plain version,
  as the JAX package's custom_vjp differentiates its jnp reference;
- ``flash_block_grads(q, k, v, dout, L, D, offsets, *, scale, causal)``
  is the blockwise flash backward of one visiting block, given the whole
  sequence's per-row logsumexp L and D = rowsum(dout * out): two kernels,
  dq (keys innermost) and dk/dv (queries innermost). Returns f32 grads.

Layouts are the JAX package's: q/k/v/acc/dout ``[B, T, H, D]``, m/l/L/D
``[B, H, T]`` f32, offsets int32 ``[2]`` = the global starts of the query
and key blocks, from which the causal mask is rebuilt. T_q and T_k must
be multiples of 128, on every device, so the port accepts exactly the
shapes the JAX package does.

All three kernels skip causal (tile, chunk) pairs that hold no visible
pair (`causal_chunk_span`). In the backward that is exact because such a
pair's p and ds are exactly 0. In the update it is exact only for rows
whose running max m is already above MASKED, so the update kernel walks
a tile's span, then votes, and walks on only where some row still holds
the sentinel (`update_chunk_span`).

Dispatch is by where the tensors lie. CPU tensors run the plain
versions (``reference_impl``, ``block_grads_reference``); CUDA tensors
launch the kernels or raise -- no fallback. Each kernel keeps its own
launch count (``FWD_KERNEL``, ``DQ_KERNEL``, ``DKV_KERNEL``).
"""

from __future__ import annotations

import ctypes

import torch

from idc_models_tpu_torch.ops.build import CudaKernel

TILE_MIN = 128            # the JAX package's tile floor, kept for parity
HEAD_DIMS = (16, 32, 64, 128)
# Masked scores use a large finite negative instead of -inf: exp() of it
# is exactly 0 in f32, and a row whose first folded block is fully
# masked (p = exp(0) = 1 garbage) heals at the next visible block,
# whose correction factor exp(MASKED - m') is 0. So folding a fully
# masked chunk is a no-op, bit for bit, for a row whose m > MASKED
# (m' = m, corr = 1, every p = 0) but not for a row still at MASKED (l
# grows by the chunk width): the update kernel skips such chunks only
# when every row of its tile is past MASKED (`update_chunk_span`).
MASKED = -1e30

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _declare(name: str, n_ptrs: int, n_ints_before: int):
    def declare(lib: ctypes.CDLL) -> None:
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        fn = getattr(lib, name)
        fn.argtypes = ([ptr] * n_ptrs + [i32] * n_ints_before
                       + [ctypes.c_float, i32, ptr])
        fn.restype = i32
        err = getattr(lib, f"{name}_error_string")
        err.argtypes = [i32]
        err.restype = ctypes.c_char_p
    return declare


# pointers, then dtype, batch, t_q, t_k, heads, d; scale, causal, stream
FWD_KERNEL = CudaKernel("flash_block_fwd.cu",
                        _declare("flash_block_fwd", 10, 6))
DQ_KERNEL = CudaKernel("flash_block_dq.cu", _declare("flash_block_dq", 8, 6))
DKV_KERNEL = CudaKernel("flash_block_dkv.cu",
                        _declare("flash_block_dkv", 9, 6))
KERNELS = (FWD_KERNEL, DQ_KERNEL, DKV_KERNEL)


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def causal_block_mask(t_q: int, t_k: int, q_offset, k_offset, *,
                      device=None) -> torch.Tensor:
    """[1, 1, t_q, t_k] bool: which (query, key) pairs are visible given
    the blocks' global start positions (ints or 0-dim tensors)."""
    q_pos = torch.arange(t_q, device=device) + q_offset
    k_pos = torch.arange(t_k, device=device) + k_offset
    return (q_pos[:, None] >= k_pos[None, :])[None, None]


def causal_chunk_span(t_q: int, t_k: int, rows: int, cols: int,
                      q_offset: int, k_offset: int):
    """The causal tile-skipping rule of the dq and dk/dv kernels, in the
    integer formulas they compute from the offsets on the device
    (``csrc/flash_mma.cuh``): a tile of `rows` queries and a chunk of
    `cols` keys share a visible pair iff the chunk's first key is at or
    before the tile's last query. Every other pair is fully masked.

    Returns (n_chunks, first_tile): the dq block of query tile i walks
    key chunks [0, n_chunks[i]); the dk/dv block of key chunk j walks
    query tiles [first_tile[j], t_q // rows)."""
    n_tiles, n_cols = t_q // rows, t_k // cols
    n_chunks = []
    for i in range(n_tiles):
        last = q_offset + (i + 1) * rows - 1 - k_offset
        n_chunks.append(0 if last < 0 else min(last // cols + 1, n_cols))
    first_tile = []
    for j in range(n_cols):
        need = k_offset + j * cols - q_offset - rows + 1
        first_tile.append(0 if need <= 0
                          else min((need + rows - 1) // rows, n_tiles))
    return n_chunks, first_tile


def backward_tiles(d: int) -> dict:
    """(query rows, keys) of one block's step in each backward kernel, as
    ``csrc/flash_block_dq.cu`` and ``csrc/flash_block_dkv.cu`` fix them:
    dq holds 64 query rows and walks key chunks; dk/dv holds 64 keys and
    walks query tiles; the walked side is 32 at D=128, else 64."""
    walked = 64 if d <= 64 else 32
    return {"dq": (64, walked), "dkv": (walked, 64)}


def forward_tiles(d: int) -> tuple[int, int]:
    """(query rows, keys) of one step of the update kernel, as
    ``csrc/flash_block_fwd.cu`` fixes them: 64 query rows a block, key
    chunks of 64, 32 at D=128."""
    return 64, (64 if d <= 64 else 32)


def update_chunk_span(t_q: int, t_k: int, rows: int, cols: int,
                      q_offset: int, k_offset: int, carried=None):
    """The update kernel's causal chunk skipping, in the integer formulas
    it computes from the offsets on the device: query tile i first walks
    its span, key chunks [0, span[i]) (`causal_chunk_span`). Every chunk
    past the span is fully masked, which is a no-op for a row whose
    m > MASKED and not for a row still at MASKED, so the tile's block then
    votes: it stops when every row's m is past MASKED, else it walks
    every chunk. A row's m is past MASKED after the span iff it was in
    the carry or the row sees a key of this block (its global position
    is at or after k_offset; the scores of visible keys are finite).

    `carried`: a bool per query row, m > MASKED in the carry passed in
    (None: a fresh carry, no row). Returns (span, walked): per tile, the
    chunks walked before the vote and in all. (Without the causal mask
    every tile walks every chunk.)"""
    n_tiles, n_cols = t_q // rows, t_k // cols
    span, _ = causal_chunk_span(t_q, t_k, rows, cols, q_offset, k_offset)
    walked = []
    for i in range(n_tiles):
        seen = all(q_offset + r >= k_offset
                   or (carried is not None and bool(carried[r]))
                   for r in range(i * rows, (i + 1) * rows))
        walked.append(span[i] if seen else n_cols)
    return span, walked


def block_attend(q, k, v, m, l, acc, *, scale, mask=None):
    """One online-softmax update of (m, l, acc) with a visiting K/V
    block, in f32: q [B,Tq,H,D]; k, v [B,Tk,H,D]; m, l [B,H,Tq];
    acc [B,Tq,H,D]."""
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    if mask is not None:
        scores = torch.where(mask, scores, MASKED)
    m_new = torch.maximum(m, scores.amax(-1))
    p = torch.exp(scores - m_new[..., None])
    corr = torch.exp(m - m_new)
    l_new = l * corr + p.sum(-1)
    acc_new = (acc * corr.transpose(1, 2)[..., None]
               + torch.einsum("bhqk,bkhd->bqhd", p, v))
    return m_new, l_new, acc_new


def _offset_pair(offsets, device):
    """(q_offset, k_offset) as 0-dim int tensors on `device` (no host
    sync for a tensor already there)."""
    offs = torch.as_tensor(offsets, dtype=torch.int64).to(device)
    return offs[0], offs[1]


def reference_impl(q, k, v, m, l, acc, offsets, *, scale, causal):
    """The plain fold: `block_attend` on f32 copies of q/k/v with the
    causal mask rebuilt from the two offsets."""
    mask = (causal_block_mask(q.shape[1], k.shape[1],
                              *_offset_pair(offsets, q.device),
                              device=q.device) if causal else None)
    return block_attend(q.float(), k.float(), v.float(), m, l, acc,
                        scale=scale, mask=mask)


def block_grads_reference(q, k, v, dout, L, D, offsets, *, scale, causal):
    """The dense flash-backward formula for one visiting block:
    ``p = exp(s - L)``, ``ds = p * (dout.v - D) * scale``, ``dq = ds.k``,
    ``dk = ds^T.q``, ``dv = p^T.dout``, all f32."""
    qf, kf, vf, do = (x.float() for x in (q, k, v, dout))
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale
    if causal:
        mask = causal_block_mask(q.shape[1], k.shape[1],
                                 *_offset_pair(offsets, q.device),
                                 device=q.device)
        s = torch.where(mask, s, MASKED)
    p = torch.exp(s - L[..., None])
    dp = torch.einsum("bqhd,bkhd->bhqk", do, vf)
    ds = p * (dp - D[..., None]) * scale
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf)
    dv = torch.einsum("bhqk,bqhd->bkhd", p, do)
    return dq, dk, dv


# ---------------------------------------------------------------------------
# the kernels
# ---------------------------------------------------------------------------


def _check_tiles(t_q: int, t_k: int, what: str, hint: str = "") -> None:
    """The JAX package's tile rule and its ValueError, word for word."""
    if t_q % TILE_MIN or t_k % TILE_MIN:
        raise ValueError(f"{what} needs T_local multiples of {TILE_MIN} "
                         f"(got q {t_q}, k {t_k}){hint}")


_UPDATE_HINT = "; use the jnp block impl instead"


def _check_launch(name: str, rows: dict, carries: dict):
    """What every kernel takes: q-like tensors [B,T,H,D] of one dtype
    (f32 or bf16) with D in HEAD_DIMS, f32 carries, all contiguous,
    16-byte aligned and on one CUDA device. Returns (dtype code, device)."""
    q = next(iter(rows.values()))
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"the {name} kernel needs CUDA tensors, got {dev}")
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"the {name} kernel takes float32 or bfloat16 "
                        f"q/k/v, got {q.dtype}")
    if q.dim() != 4 or q.shape[-1] not in HEAD_DIMS:
        raise ValueError(f"the {name} kernel takes [B, T, H, D] with D in "
                         f"{HEAD_DIMS}, got q {tuple(q.shape)}")
    for what, t in {**rows, **carries}.items():
        want = q.dtype if what in rows else torch.float32
        if t.dtype != want:
            raise TypeError(f"{name}: {what} must be {want}, got {t.dtype}")
        if t.device != dev:
            raise ValueError(f"{name}: {what} must lie on {dev}, got "
                             f"{t.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: {what} must be contiguous and "
                             f"16-byte aligned")
    return _DTYPE_CODE[q.dtype], dev


def _offsets_on(offsets, device) -> torch.Tensor:
    offs = torch.as_tensor(offsets).to(device=device, dtype=torch.int32)
    if offs.shape != (2,):
        raise ValueError(f"offsets must be two ints [q_start, k_start], "
                         f"got shape {tuple(offs.shape)}")
    return offs.contiguous()


def _run(kernel: CudaKernel, fn: str, device, *args) -> None:
    lib = kernel.lib()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(lib, fn)(*args, stream)
    if err != 0:
        msg = getattr(lib, f"{fn}_error_string")(err).decode()
        raise RuntimeError(f"{fn} kernel launch failed: {msg}")
    kernel.launches += 1


def _launch_update(q, k, v, m, l, acc, offsets, scale, causal):
    b, t_q, h, d = q.shape
    code, dev = _check_launch(
        "flash block update", {"q": q, "k": k, "v": v},
        {"m": m, "l": l, "acc": acc})
    if (k.shape != v.shape or k.shape[::2] != q.shape[::2]
            or m.shape != (b, h, t_q) or l.shape != m.shape
            or acc.shape != q.shape):
        raise ValueError(f"flash block update: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}, m "
                         f"{tuple(m.shape)}, l {tuple(l.shape)}, acc "
                         f"{tuple(acc.shape)} do not fit together")
    offs = _offsets_on(offsets, dev)
    om, ol = torch.empty_like(m), torch.empty_like(l)
    oacc = torch.empty_like(acc)
    _run(FWD_KERNEL, "flash_block_fwd", dev,
         q.data_ptr(), k.data_ptr(), v.data_ptr(), m.data_ptr(),
         l.data_ptr(), acc.data_ptr(), offs.data_ptr(), om.data_ptr(),
         ol.data_ptr(), oacc.data_ptr(), code, b, t_q, k.shape[1], h, d,
         float(scale), int(causal))
    return om, ol, oacc


class _FlashBlockUpdate(torch.autograd.Function):
    """Forward: the kernel (CUDA) or the plain fold (CPU). Backward:
    autograd through ``reference_impl`` at the saved inputs -- exact for
    the recurrence, but it builds the block's [B,H,Tq,Tk] scores; the
    ring's pallas path uses ``flash_block_grads`` instead."""

    @staticmethod
    def forward(ctx, q, k, v, m, l, acc, offsets, scale, causal):
        ctx.save_for_backward(q, k, v, m, l, acc, offsets)
        ctx.scale, ctx.causal = scale, causal
        return _fold(q, k, v, m, l, acc, offsets, scale, causal)

    @staticmethod
    def backward(ctx, gm, gl, gacc):
        *saved, offsets = ctx.saved_tensors
        needs = ctx.needs_input_grad[:6]
        with torch.enable_grad():
            inputs = [t.detach().requires_grad_(nd)
                      for t, nd in zip(saved, needs)]
            outs = reference_impl(*inputs, offsets, scale=ctx.scale,
                                  causal=ctx.causal)
            wanted = [t for t, nd in zip(inputs, needs) if nd]
            grads = iter(torch.autograd.grad(outs, wanted,
                                             (gm, gl, gacc)))
        return (*(next(grads) if nd else None for nd in needs),
                None, None, None)


def _fold(q, k, v, m, l, acc, offsets, scale, causal):
    if q.device.type == "cpu":
        return reference_impl(q, k, v, m, l, acc, offsets, scale=scale,
                              causal=causal)
    return _launch_update(q, k, v, m, l, acc, offsets, scale, causal)


def flash_block_update(q, k, v, m, l, acc, offsets, *, scale, causal):
    """Fold the visiting block (k, v) into the carry (m, l, acc) for the
    queries q: returns (m', l', acc'), f32. `offsets` are the global
    starts of the query and key blocks (an int32 [2] tensor or two
    ints). Differentiable in q/k/v/m/l/acc."""
    _check_tiles(q.shape[1], k.shape[1], "flash block kernel",
                 _UPDATE_HINT)
    if not torch.is_tensor(offsets):
        offsets = torch.tensor(list(offsets), dtype=torch.int32)
    offsets = offsets.to(q.device)
    return _FlashBlockUpdate.apply(q, k, v, m, l, acc, offsets,
                                   float(scale), bool(causal))


def flash_block_fold(q, k, v, m, l, acc, offsets, *, scale, causal):
    """`flash_block_update` without autograd: what the ring's forward
    runs inside its own autograd.Function."""
    _check_tiles(q.shape[1], k.shape[1], "flash block kernel",
                 _UPDATE_HINT)
    return _fold(q, k, v, m, l, acc, offsets, scale, causal)


def _grads_args(q, k, v, dout, L, D, offsets):
    """Checks what the dq and dk/dv kernels take; returns (pointers of
    q, k, v, dout, L, D and the offsets; dtype code; device; the
    offsets tensor, kept alive until the launch)."""
    b, t_q, h, _ = q.shape
    code, dev = _check_launch(
        "flash backward", {"q": q, "k": k, "v": v, "dout": dout},
        {"L": L, "D": D})
    if (k.shape != v.shape or k.shape[::2] != q.shape[::2]
            or dout.shape != q.shape or L.shape != (b, h, t_q)
            or D.shape != L.shape):
        raise ValueError(f"flash backward: shapes q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}, dout "
                         f"{tuple(dout.shape)}, L {tuple(L.shape)}, D "
                         f"{tuple(D.shape)} do not fit together")
    offs = _offsets_on(offsets, dev)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
            L.data_ptr(), D.data_ptr(), offs.data_ptr())
    return ptrs, code, dev, offs


def flash_block_dq(q, k, v, dout, L, D, offsets, *, scale, causal):
    """This visiting block's share of dq (f32) through the dq kernel:
    CUDA tensors only (`flash_block_grads` dispatches)."""
    _check_tiles(q.shape[1], k.shape[1], "flash backward")
    ptrs, code, dev, _offs = _grads_args(q, k, v, dout, L, D, offsets)
    b, t_q, h, d = q.shape
    dq = torch.empty(q.shape, dtype=torch.float32, device=dev)
    _run(DQ_KERNEL, "flash_block_dq", dev, *ptrs, dq.data_ptr(), code, b,
         t_q, k.shape[1], h, d, float(scale), int(causal))
    return dq


def flash_block_dkv(q, k, v, dout, L, D, offsets, *, scale, causal):
    """dk and dv (f32) of one visiting block through the dk/dv kernel:
    CUDA tensors only (`flash_block_grads` dispatches)."""
    _check_tiles(q.shape[1], k.shape[1], "flash backward")
    ptrs, code, dev, _offs = _grads_args(q, k, v, dout, L, D, offsets)
    b, t_q, h, d = q.shape
    dk = torch.empty(k.shape, dtype=torch.float32, device=dev)
    dv = torch.empty(v.shape, dtype=torch.float32, device=dev)
    _run(DKV_KERNEL, "flash_block_dkv", dev, *ptrs, dk.data_ptr(),
         dv.data_ptr(), code, b, t_q, k.shape[1], h, d, float(scale),
         int(causal))
    return dk, dv


def flash_block_grads(q, k, v, dout, L, D, offsets, *, scale, causal):
    """(dq, dk, dv) of one visiting block, f32: dq is this block's share
    (sum over visiting blocks for the total), dk/dv are complete with
    respect to these queries. The kernels on CUDA tensors, the dense
    formula on CPU ones."""
    _check_tiles(q.shape[1], k.shape[1], "flash backward")
    if q.device.type == "cpu":
        return block_grads_reference(q, k, v, dout, L, D, offsets,
                                     scale=scale, causal=causal)
    kw = dict(scale=scale, causal=causal)
    return (flash_block_dq(q, k, v, dout, L, D, offsets, **kw),
            *flash_block_dkv(q, k, v, dout, L, D, offsets, **kw))
