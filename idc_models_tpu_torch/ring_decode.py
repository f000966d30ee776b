"""Ring-sharded KV-cache decoding, the counterpart of
``idc_models_tpu/ring_decode.py``.

The cache is [B, t_max, H, D] per block, sharded over the ranks of a
"seq" group: rank i holds positions [i*t_max/n, (i+1)*t_max/n) of every
row (`init_cache`, `cache_sharding`). One decode step for ONE new token

1. appends its k/v at `pos` on the rank that owns that position only
   (a clamped local index and a ``where`` on the device: nothing is read
   back to the host);
2. attends the query against the rank's own shard, masked by GLOBAL
   position (the finite sentinel, and their p zeroed);
3. merges the partial softmax across the ring: a ``collectives.pmax``
   of the local maxima, then one ``psum`` of the corrected (l, acc).

Without a group (or over a group of one rank) the max and the sums over
ranks are the identity and the folds give what one card's cache gives,
bit for bit. Appends write the cache IN PLACE (the JAX version donates
the cache; here the caller's tensor is the cache).

Seven folds share that algebra (`_attend`), each taking ``group=``:

- `make_ring_decode`: one token per step, every row at one position;
- `make_batched_ring_decode`: one token per row, each row its own
  sequence at its own position, dead rows (``live`` False) appending
  nothing -- the serving engine's fold (``serve/engine.py``); with
  ``quantized=True`` the caches hold int8 K/V and per-(row, head) f32
  scales that factor out of both contractions (one value across the
  shards: the scales replicate);
- `make_chunk_ring_decode`: C prompt tokens at once, appended at
  `start`, each query attending causally over the whole cache -- chunked
  prefill (``models/lm.py``);
- `make_batched_chunk_ring_decode`: C draft tokens per row, each row
  at its own position, dead rows appending nothing -- the speculative
  verify's fold (and the learned drafter's ingest);
- `make_paged_batched_ring_decode`, `make_paged_chunk_ring_decode` and
  `make_paged_batched_chunk_ring_decode`: the serving folds over a POOL
  of fixed-size pages and a page table (the paged engine,
  ``serve/pages.py``), attending through each row's gathered logical
  view, bit for bit the contiguous folds' result on one rank; int8
  pools carry one scale per (page, head). Over a group the pool shards
  over the PHYSICAL page dim (rank i owns pages [i*P/n, (i+1)*P/n), plus
  a sink page of its own), while the page table and the int8 scales
  replicate (`_page_view`).

`prefill` places a prompt's K/V into a fresh cache shard. The folds
upcast the whole cache (or view) to f32 for the contractions, as the
one-row fold always has (PERF.md §7 lists a fused decode fold as speed
work). No fold reads anything back to the host: liveness, positions and
the append targets stay on the device.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from idc_models_tpu_torch import collectives
from idc_models_tpu_torch import mesh as meshlib
from idc_models_tpu_torch.ops.flash_block_kernel import MASKED


def cache_sharding(mesh, axis: str = meshlib.SEQ_AXIS):
    """The [B, t_max, H, D] cache layout: the training side's
    sequence-parallel layout (`mesh.batch_seq_sharding`), so trained K/V
    drops in with no relayout. It names no "model" axis: the cache
    replicates over the weight axis."""
    return meshlib.batch_seq_sharding(mesh, axis, trailing=2)


def _ring(group) -> tuple[int, int]:
    """(ring size, this rank's index) of a "seq" group; None is a ring
    of one (never the default group of an initialized world)."""
    if group is None:
        return 1, 0
    return collectives.axis_size(group), collectives.axis_index(group)


def _check_ring(t_max: int, n: int) -> None:
    if t_max % n:
        raise ValueError(f"t_max {t_max} not divisible by the ring size "
                         f"{n} over mesh axis {meshlib.SEQ_AXIS!r}")


def init_cache(batch: int, t_max: int, heads: int, dim: int, *,
               dtype=torch.bfloat16, device=None, group=None):
    """Zero-initialized (k, v) caches: this rank's shard
    [batch, t_max/n, heads, dim] over the "seq" `group` (the whole
    [batch, t_max, heads, dim] without one)."""
    n, _ = _ring(group)
    _check_ring(t_max, n)

    def mk():
        return torch.zeros((batch, t_max // n, heads, dim), dtype=dtype,
                           device=device)
    return mk(), mk()


def _attend(q, kc, vc, visible, k_scale=None, v_scale=None, *,
            group=None):
    """Queries against this rank's cache shard: f32 scores, masked where
    `visible` is false, the stable softmax and the merge over the ring
    `group`: the max over ranks, then one sum of the corrected (l, acc)
    (one rank: both are the identity and corr is 1). The one attend of
    every fold, contiguous and paged.

    `q` is one query per row [B, H, D] (`visible` [T] or [B, T]) or a
    chunk [B, C, H, D] (`visible` [C, T] or [B, C, T]; the output is
    [B, C, H, D]). int8 scales are per (row, head) [B, H] -- constant
    over the positions, they multiply the scores and the value sums
    after the contractions -- or per (row, head, position) [B, H, T]
    (paged pools, one scale a page), which multiply the scores and the
    probabilities before the value contraction."""
    chunk = q.dim() == 4
    if chunk:
        s = torch.einsum("bchd,bkhd->bhck", q.float(), kc.float())
        vis = visible if visible.dim() == 2 else visible[:, None]
    else:
        s = torch.einsum("bhd,bkhd->bhk", q.float(), kc.float())
        vis = visible if visible.dim() == 1 else visible[:, None, :]
    s = s * (kc.shape[-1] ** -0.5)

    def over_scores(scale):
        # [B, H] or [B, H, T] -> broadcastable against the scores
        scale = scale[..., None] if scale.dim() == 2 else scale
        return scale[:, :, None] if chunk else scale

    if k_scale is not None:
        s = s * over_scores(k_scale)
    s = torch.where(vis, s, MASKED)
    m_loc = s.amax(-1)
    # a fully masked row would fold p = exp(0) = 1 garbage: zero it
    p = torch.where(vis, torch.exp(s - m_loc[..., None]), 0.0)
    l_loc = p.sum(-1)
    per_position = v_scale is not None and v_scale.dim() == 3
    p_v = p * over_scores(v_scale) if per_position else p
    acc_loc = torch.einsum("bhck,bkhd->bhcd" if chunk else "bhk,bkhd->bhd",
                           p_v, vc.float())
    if v_scale is not None and not per_position:
        acc_loc = acc_loc * (v_scale[:, :, None, None] if chunk
                             else v_scale[..., None])
    m_glob = collectives.pmax(m_loc, group) if group is not None else m_loc
    corr = torch.exp(m_loc - m_glob)
    l_glob = l_loc * corr
    acc_glob = acc_loc * corr[..., None]
    if group is not None:
        collectives.psum_([l_glob, acc_glob], group)
    out = acc_glob / torch.clamp(l_glob, min=1e-37)[..., None]
    return out.movedim(1, 2) if chunk else out


def _positions(ts: int, i: int, device) -> torch.Tensor:
    """The global positions [ts] of rank i's cache shard."""
    return i * ts + torch.arange(ts, device=device)


def make_ring_decode(*, group=None):
    """Build ``fn(k_cache, v_cache, q_t, k_t, v_t, pos) -> (out_t,
    k_cache, v_cache)``: q_t/k_t/v_t are the new token's projections
    [B, 1, H, D] (the same on every rank), `pos` its global position (an
    int in [0, t_max)); the caches are this rank's shards over the "seq"
    `group`, updated in place (by the owner of `pos` only) and
    returned."""
    n, i = _ring(group)

    def fold(kc, vc, q, kt, vt, pos: int):
        if q.shape[1] != 1:
            raise ValueError(
                f"ring decode takes ONE token per step: q_t has sequence "
                f"length {q.shape[1]} (batch prefill goes through "
                f"`prefill` / the training ring)")
        ts = kc.shape[1]
        t_max = ts * n
        pos = int(pos)
        if not 0 <= pos < t_max:
            raise ValueError(
                f"pos {pos} outside the cache (t_max {t_max}) -- grow the "
                f"cache at init/prefill time; decode cannot append past it")
        if pos // ts == i:
            kc[:, pos - i * ts] = kt[:, 0].to(kc.dtype)
            vc[:, pos - i * ts] = vt[:, 0].to(vc.dtype)
        visible = _positions(ts, i, kc.device) <= pos
        out = _attend(q[:, 0], kc, vc, visible, group=group)
        return out[:, None].to(q.dtype), kc, vc

    return fold


def _quantize_token(x, scale):
    """A token's [B, 1, H, D] K or V in int8 levels of the row's frozen
    per-head `scale` [B, H]: round half to even, clipped to +-127 (f32;
    the append casts)."""
    return torch.clamp(torch.round(x.float() / scale[:, None, :, None]),
                       -127, 127)


def make_batched_ring_decode(*, quantized: bool = False, group=None):
    """The serving engine's fold: ``fn(k_cache, v_cache, q_t, k_t, v_t,
    pos, live) -> (out_t, k_cache, v_cache)`` where every batch row is
    an INDEPENDENT sequence at its OWN position.

    `pos` is [B] (row b's new token sits at pos[b]) and `live` bool [B]:
    rows with live False append NOTHING -- the append goes through a
    mask that writes a dead row's stored value back, so its cache row is
    bit-untouched (a finished serving slot idles through decode windows
    without corrupting the row a recycled request overwrites). Dead rows
    may sit at pos == t_max; positions are clamped for the attend, and
    the masked append never fires for them.

    With ``quantized=True`` the caches hold int8 K/V and the signature
    grows the per-(row, head) f32 dequantization scales:
    ``fn(kc, vc, q_t, k_t, v_t, pos, live, k_scale, v_scale)``, both
    [B, H]. A scale is constant over the slot dimension and head_dim, so
    it factors out of both contractions (the scores multiply by k_scale,
    the value sums by v_scale); appends quantize the token with the
    row's frozen scale (`_quantize_token`).

    The attend is the one-token fold's (`_attend`) with per-row
    visibility: a batch whose rows all sit at one position gives that
    fold's output bit for bit. Over a "seq" `group` only the rank that
    owns a row's position writes it: the others write the stored value
    at a clamped local index back."""
    n, i = _ring(group)

    def fold(kc, vc, q, kt, vt, pos, live, *scales):
        if quantized and len(scales) != 2:
            raise ValueError("quantized fold needs (k_scale, v_scale)")
        if not quantized and scales:
            raise ValueError("scales passed to a non-quantized fold")
        if q.shape[1] != 1:
            raise ValueError(
                f"batched ring decode takes ONE token per row per step: "
                f"q_t has sequence length {q.shape[1]}")
        b, ts = kc.shape[:2]
        t_max = ts * n
        if tuple(np.shape(pos)) != (b,):
            raise ValueError(
                f"pos must be one position per row, shape ({b},); got "
                f"{tuple(np.shape(pos))}")
        # host positions are checked here (a silently dropped append is
        # the failure mode); tensors on the card are the caller's
        # contract, as traced positions are in the JAX package
        if not torch.is_tensor(pos) and not torch.is_tensor(live):
            p_arr = np.asarray(pos)
            bad = p_arr[np.asarray(live, bool)
                        & ((p_arr < 0) | (p_arr >= t_max))]
            if bad.size:
                raise ValueError(f"live pos {bad.tolist()} outside the "
                                 f"cache (t_max {t_max})")
        pos = torch.as_tensor(pos, device=kc.device).long()
        live = torch.as_tensor(live, device=kc.device).bool()
        posc = pos.clamp(0, t_max - 1)
        if quantized:
            kt = _quantize_token(kt, scales[0])
            vt = _quantize_token(vt, scales[1])
        rows = torch.arange(b, device=kc.device)
        at = (rows, (posc - i * ts).clamp(0, ts - 1))
        keep = (live & (posc // ts == i))[:, None, None]
        for cache, tok in ((kc, kt), (vc, vt)):
            old = cache[at]
            cache[at] = torch.where(keep, tok[:, 0].to(cache.dtype), old)
        visible = (_positions(ts, i, kc.device)[None, :]
                   <= posc[:, None])
        out = _attend(q[:, 0], kc, vc, visible, *scales, group=group)
        return out[:, None].to(q.dtype), kc, vc

    return fold


def _checked_chunk(q, pos, rows: int, what: str):
    """The [B, C, H, D] draft-chunk and one-position-per-row contract of
    the batched chunk folds."""
    if q.dim() != 4 or q.shape[1] < 1:
        raise ValueError(f"{what} expects [B, C, H, D] queries, got "
                         f"shape {tuple(q.shape)}")
    if tuple(np.shape(pos)) != (rows,):
        raise ValueError(f"pos must be one position per row, shape "
                         f"({rows},); got {tuple(np.shape(pos))}")


def make_batched_chunk_ring_decode(*, quantized: bool = False,
                                   group=None):
    """The speculative verify's fold: ``fn(k_cache, v_cache, q, k, v,
    pos, live) -> (out, k_cache, v_cache)`` runs C draft tokens per
    batch row against the row's cache, each row an INDEPENDENT sequence
    at its OWN position -- the chunk-query algebra of
    `make_chunk_ring_decode` crossed with the per-row masking of
    `make_batched_ring_decode`.

    q/k/v are [B, C, H, D]; `pos` is [B] (row b's chunk occupies
    positions [pos[b], pos[b] + C)) and `live` bool [B]. Per live row the
    chunk's K/V are spliced into [pos[b], pos[b] + C) (positions past the
    cache are dropped); every query then attends the row's whole updated
    cache with per-query causal visibility (cache position <= query
    position, which covers causality inside the chunk too). A dead row
    appends NOTHING: its cache row is bit-untouched, so slots that do not
    speculate ride through a verify as bit-level no-ops. Callers own the
    bound pos[b] + C <= t_max for live rows.

    The splice writes each chunk entry into its target, and an entry
    that must not write (a dead row, a position past the cache, or over
    a "seq" `group` a position another rank owns) writes its row's
    stored value at a position of the shard no entry of the row writes
    back over itself (the one before the row's first write here, else
    the one after its last): every index the write sees twice carries
    one value. Over a group that needs C below the shard length.

    With ``quantized=True`` the caches hold int8 K/V and the signature
    grows the per-(row, head) f32 scales, ``fn(..., pos, live, k_scale,
    v_scale)``; appends quantize with the row's frozen insert-time
    scale, as the one-token fold's do."""
    n, i = _ring(group)

    def fold(kc, vc, q, kt, vt, pos, live, *scales):
        if quantized and len(scales) != 2:
            raise ValueError("quantized fold needs (k_scale, v_scale)")
        if not quantized and scales:
            raise ValueError("scales passed to a non-quantized fold")
        b, ts = kc.shape[:2]
        t_max = ts * n
        _checked_chunk(q, pos, b, "batched chunk fold")
        c = q.shape[1]
        if n > 1 and c >= ts:
            raise ValueError(
                f"draft chunk {c} must be shorter than the cache shard "
                f"{ts} (t_max {t_max} over a ring of {n})")
        dev = kc.device
        pos = torch.as_tensor(pos, device=dev).long()
        live = torch.as_tensor(live, device=dev).bool()
        posc = pos.clamp(0, t_max - 1)
        qpos = posc[:, None] + torch.arange(c, device=dev)     # [B, C]
        writes = live[:, None] & (qpos < t_max) & (qpos // ts == i)
        lo = (posc - i * ts).clamp(0, ts)
        free = torch.where(lo > 0, lo - 1,
                           (posc + c - i * ts).clamp(0, ts - 1))
        at = (torch.arange(b, device=dev)[:, None].expand(b, c),
              torch.where(writes, qpos - i * ts, free[:, None]))
        if quantized:
            kt = _quantize_token(kt, scales[0])
            vt = _quantize_token(vt, scales[1])
        keep = writes[..., None, None]
        for cache, tok in ((kc, kt), (vc, vt)):
            cache.index_put_(at, torch.where(keep, tok.to(cache.dtype),
                                             cache[at]))
        visible = (_positions(ts, i, dev)[None, None, :]
                   <= qpos[:, :, None])                        # [B, C, T]
        out = _attend(q, kc, vc, visible, *scales, group=group)
        return out.to(q.dtype), kc, vc

    return fold


def make_chunk_ring_decode(*, group=None):
    """Chunked-prefill fold: ``fn(k_cache, v_cache, q, k, v, start,
    p_end) -> (out, k_cache, v_cache)`` runs C prompt tokens against an
    existing cache. q/k/v are the chunk's projections [B, C, H, D]; the
    chunk occupies positions [start, start + C), and only those below
    `p_end` are real (the ragged last chunk). The fold appends the real
    positions' K/V, attends every query against the whole updated cache
    with a per-query causal mask (cache position <= query position,
    which also covers causality inside the chunk), and merges over the
    ring. Query rows at or past p_end append nothing; their outputs are
    garbage the caller discards (never NaN: each sees position 0). Over a
    "seq" `group` each rank writes the real positions of its own shard
    (host arithmetic: `start` and `p_end` are host ints)."""
    n, i = _ring(group)

    def fold(kc, vc, q, kt, vt, start: int, p_end: int):
        if q.dim() != 4 or q.shape[1] < 1:
            raise ValueError(f"chunk fold expects [B, C, H, D] queries, "
                             f"got shape {tuple(q.shape)}")
        ts, c = kc.shape[1], q.shape[1]
        t_max = ts * n
        start, p_end = int(start), int(p_end)
        if not 0 <= start <= t_max - c:
            raise ValueError(f"chunk start {start} + chunk {c} outside "
                             f"the cache (t_max {t_max})")
        end = start + max(min(p_end, start + c) - start, 0)
        lo, hi = max(start, i * ts), min(end, (i + 1) * ts)
        if hi > lo:
            kc[:, lo - i * ts:hi - i * ts] = kt[:, lo - start:hi - start].to(
                kc.dtype)
            vc[:, lo - i * ts:hi - i * ts] = vt[:, lo - start:hi - start].to(
                vc.dtype)
        qpos = start + torch.arange(c, device=kc.device)
        visible = (_positions(ts, i, kc.device)[None, :]
                   <= qpos[:, None])                            # [C, T]
        out = _attend(q, kc, vc, visible, group=group)
        return out.to(q.dtype), kc, vc                          # [B,C,H,D]

    return fold


def _page_view(pool, pt, i: int = 0):
    """Gather rank i's pool shard [p_loc + 1, ps, H, D] (its pages and
    its sink) into each row's LOGICAL view: pt [S, L] global physical
    page ids (-1 = unallocated) -> [S, L*ps, H, D] in logical position
    order. Rows gathered through a page another rank owns or an
    unallocated id (clamped into the shard) hold values the caller's
    visibility mask discards (`_page_positions`), as the contiguous
    folds' slots past `pos`."""
    p_loc = pool.shape[0] - 1
    view = pool[(pt - i * p_loc).clamp(0, p_loc - 1)]     # [S, L, ps, H, D]
    s, l, ps, h, d = view.shape
    return view.reshape(s, l * ps, h, d)


def _page_scales(scale, pt, ps):
    """Per-page [n_pages, H] scales -> each row's [S, H, L*ps] scale of
    every logical position."""
    return scale[pt.clamp(min=0)].movedim(2, 1).repeat_interleave(ps, 2)


def _page_positions(pt, ps, i: int = 0, p_loc: int | None = None):
    """The logical positions [L*ps] of a page table's view, and [S, L*ps]
    whether each lies on an allocated page of rank i's shard (pages
    [i*p_loc, (i+1)*p_loc); every allocated page on one rank)."""
    g = torch.arange(pt.shape[1] * ps, device=pt.device)
    here = pt >= 0
    if p_loc is not None:
        here = here & (pt // p_loc == i)
    return g, here.repeat_interleave(ps, 1)


def _shard_target(phys, write, i: int, p_loc: int):
    """(global, local) append targets of rank i's pool shard: a page it
    owns where `write` holds, else the global sink row n*p_loc of the
    replicated scale table and the shard's own sink page p_loc (a page
    id of -1 never owns)."""
    dst_g = torch.where(write & (phys >= 0), phys, -1)
    mine = (dst_g >= 0) & (dst_g // p_loc == i)
    return dst_g, torch.where(mine, dst_g - i * p_loc, p_loc)


def _check_paged_pool(kp, pt, page_size, quantized, scales):
    """The one pool/table contract of every paged fold."""
    if quantized and len(scales) != 2:
        raise ValueError("quantized paged fold needs (k_scale, v_scale)")
    if not quantized and scales:
        raise ValueError("scales passed to a non-quantized paged fold")
    if kp.shape[1] != page_size:
        raise ValueError(f"pool page dim {kp.shape[1]} != the fold's "
                         f"page_size {page_size}")
    if pt.dim() != 2:
        raise ValueError(f"page table must be [S, L] int32, got shape "
                         f"{tuple(pt.shape)}")


def make_paged_batched_ring_decode(*, page_size: int,
                                   quantized: bool = False, group=None):
    """Page-table-indirect `make_batched_ring_decode`, the one-token-per-
    row fold of the PAGED serving engine: ``fn(k_pool, v_pool,
    page_table, q_t, k_t, v_t, pos, live) -> (out_t, k_pool, v_pool)``.

    The caches are a POOL of fixed-size pages [n_pages + 1, page_size,
    H, D] shared by every slot, and an int32 page table [S, L] maps row
    b's logical page j to a physical page (-1 = unallocated). The pool's
    LAST page is a sink that no page table names. Per live row the fold
    appends the new token into the ONE physical page that owns its
    position; a dead row, or one whose page is unallocated, sends its
    append to the sink instead, so no real page receives a non-writer's
    value and nothing is read back to the host. It then gathers every
    row's logical view and runs the contiguous folds' attend (`_attend`)
    with visibility (position <= pos) & (page allocated). The view holds
    the contiguous cache's values in the same order, so a live row's
    output and append equal the contiguous batched fold's bit for bit.

    With ``quantized=True`` the pools hold int8 pages and the signature
    grows per-(page, head) f32 [n_pages + 1, H] scales: an append
    quantizes with its target page's scale, and the attend scales each
    position by its page's. Callers own the bound pos[b] < L*page_size
    and that a live row's page is allocated: an unallocated append is
    dropped. Over a "seq" `group` each rank's pool holds its pages and a
    sink of its own, an append lands on the rank owning its page, and
    the [n_pages + 1, H] scales replicate."""
    n, i = _ring(group)

    def fold(kp, vp, pt, q, kt, vt, pos, live, *scales):
        _check_paged_pool(kp, pt, page_size, quantized, scales)
        if q.shape[1] != 1:
            raise ValueError(
                f"paged batched decode takes ONE token per row per "
                f"step: q_t has sequence length {q.shape[1]}")
        if tuple(np.shape(pos)) != (pt.shape[0],):
            raise ValueError(
                f"pos must be one position per page-table row, shape "
                f"({pt.shape[0]},); got {tuple(np.shape(pos))}")
        l_pages = pt.shape[1]
        dev = kp.device
        pt = pt.to(dev).long()
        pos = torch.as_tensor(pos, device=dev).long()
        live = torch.as_tensor(live, device=dev).bool()
        p_loc = kp.shape[0] - 1
        posc = pos.clamp(0, l_pages * page_size - 1)
        phys = pt.gather(1, (posc // page_size)[:, None])[:, 0]
        dst_g, dst = _shard_target(phys, live, i, p_loc)
        if quantized:
            row = torch.where(dst_g >= 0, dst_g, n * p_loc)
            kt = _quantize_token(kt, scales[0][row])
            vt = _quantize_token(vt, scales[1][row])
        at = (dst, posc % page_size)
        kp.index_put_(at, kt[:, 0].to(kp.dtype))
        vp.index_put_(at, vt[:, 0].to(vp.dtype))
        g, owned = _page_positions(pt, page_size, i, p_loc)
        visible = owned & (g[None, :] <= posc[:, None])       # [S, L*ps]
        extra = tuple(_page_scales(sc, pt, page_size) for sc in scales)
        out = _attend(q[:, 0], _page_view(kp, pt, i), _page_view(vp, pt, i),
                      visible, *extra, group=group)
        return out[:, None].to(q.dtype), kp, vp

    return fold


def make_paged_chunk_ring_decode(*, page_size: int, quantized: bool = False,
                                 group=None):
    """Page-table-indirect `make_chunk_ring_decode`, the chunked-prefill
    fold of the paged engine: ``fn(k_pool, v_pool, page_table, q, k, v,
    start, p_end) -> (out, k_pool, v_pool)`` runs C prompt tokens against
    the request's OWN pages, splicing the real positions [start, p_end)
    straight into the pool (no contiguous single-request cache exists on
    the paged path), then attends each query causally through the
    contiguous folds' attend.

    `page_table` is the request's row(s) [B, L]; the pool's last page is
    the batched fold's sink, where padding positions and unallocated
    pages send their writes. Chunks are aligned to the page grid
    (page_size divides C, checked here), so a chunk fills whole pages and
    a completed chunk boundary's pages are never written again -- the
    invariant that lets prefix-cache snapshots share pages with live
    slots without copies.

    With ``quantized=True`` the signature grows the [n_pages + 1, H]
    scales, which the fold updates in place and returns: ``fn(..., start,
    p_end, k_scale, v_scale) -> (out, k_pool, v_pool, k_scale, v_scale)``.
    Each page the chunk fills gets a fresh per-head scale (absmax of its
    REAL tokens / 127, floor 1e-8) before its content quantizes with it
    (the same update on every rank of a "seq" `group`: the scales
    replicate)."""
    n, i = _ring(group)

    def fold(kp, vp, pt, q, kt, vt, start: int, p_end: int, *scales):
        _check_paged_pool(kp, pt, page_size, quantized, scales)
        if q.dim() != 4 or q.shape[1] < 1:
            raise ValueError(f"paged chunk fold expects [B, C, H, D] "
                             f"queries, got shape {tuple(q.shape)}")
        if q.shape[1] % page_size:
            raise ValueError(
                f"chunk {q.shape[1]} must be a multiple of the page "
                f"size {page_size} — chunk boundaries must land on the "
                f"page grid so completed pages are never rewritten")
        b, c, h, d = q.shape
        l_pages = pt.shape[1]
        dev = kp.device
        pt = pt.to(dev).long()
        start, p_end = int(start), int(p_end)
        n_real = max(min(p_end, start + c) - start, 0)
        cpos = start + torch.arange(c, device=dev)
        real = torch.arange(c, device=dev) < n_real
        phys = pt[:, (cpos // page_size).clamp(max=l_pages - 1)]  # [B, C]
        p_loc = kp.shape[0] - 1
        sink = n * p_loc
        if quantized:
            cpp = c // page_size

            def page_scales(t):
                tf = torch.where(real[None, :, None, None],
                                 t.float().abs(), 0.0)
                m = tf.reshape(b, cpp, page_size, h, d).amax(dim=(0, 2, 4))
                return torch.clamp(m, min=1e-8) / 127.0       # [cpp, H]

            k_new, v_new = page_scales(kt), page_scales(vt)
            first = min(start // page_size, l_pages - 1)
            dst = pt[0, (first + torch.arange(cpp, device=dev)).clamp(
                max=l_pages - 1)]
            fills = ((torch.arange(cpp, device=dev) * page_size < n_real)
                     & (dst >= 0))
            dst = torch.where(fills, dst, sink)
            scales[0].index_put_((dst,), k_new)
            scales[1].index_put_((dst,), v_new)
            ksc = k_new.repeat_interleave(page_size, 0)       # [C, H]
            vsc = v_new.repeat_interleave(page_size, 0)
            kt = torch.clamp(torch.round(
                kt.float() / ksc[None, :, :, None]), -127, 127)
            vt = torch.clamp(torch.round(
                vt.float() / vsc[None, :, :, None]), -127, 127)
        _, dst = _shard_target(phys, real[None, :].expand(b, c), i, p_loc)
        at = (dst, (cpos % page_size).expand(b, c))
        kp.index_put_(at, kt.to(kp.dtype))
        vp.index_put_(at, vt.to(vp.dtype))
        g, owned = _page_positions(pt, page_size, i, p_loc)
        visible = owned[:, None] & (g[None, None] <= cpos[None, :, None])
        extra = tuple(_page_scales(sc, pt, page_size) for sc in scales)
        out = _attend(q, _page_view(kp, pt, i), _page_view(vp, pt, i),
                      visible, *extra, group=group).to(q.dtype)
        if quantized:
            return (out, kp, vp) + tuple(scales)
        return out, kp, vp

    return fold


def make_paged_batched_chunk_ring_decode(*, page_size: int,
                                         quantized: bool = False,
                                         group=None):
    """Page-table-indirect `make_batched_chunk_ring_decode`, the
    speculative verify's fold on the PAGED engine: ``fn(k_pool, v_pool,
    page_table, q, k, v, pos, live) -> (out, k_pool, v_pool)`` runs C
    draft tokens per row against the row's pages, each row at its OWN
    position.

    Each live row's entry at position pos[b] + j lands in the physical
    page that owns that position; a dead row's entries, a position past
    the row's logical view and a position on an unallocated page (-1)
    send their writes to the pool's LAST page, the sink no page table
    names, so no real page receives a non-writer's value and nothing is
    read back to the host. The attend is the contiguous folds' through
    each row's gathered view, visibility (position <= query position) &
    (page allocated). Callers (the engine's room check and the
    scheduler's page grants) own that live rows' pages cover
    [pos[b], pos[b] + C).

    With ``quantized=True`` the pools hold int8 pages and the signature
    grows the [n_pages + 1, H] f32 scales: appends quantize with their
    target page's EXISTING scale (decode pages are stamped when granted)
    and no scale is written. Over a "seq" `group` an entry lands on the
    rank owning its page, as in the one-token paged fold."""
    n, i = _ring(group)

    def fold(kp, vp, pt, q, kt, vt, pos, live, *scales):
        _check_paged_pool(kp, pt, page_size, quantized, scales)
        _checked_chunk(q, pos, pt.shape[0], "paged batched chunk fold")
        s_rows, c = q.shape[:2]
        l_pages = pt.shape[1]
        span = l_pages * page_size
        dev = kp.device
        pt = pt.to(dev).long()
        pos = torch.as_tensor(pos, device=dev).long()
        live = torch.as_tensor(live, device=dev).bool()
        posc = pos.clamp(0, span - 1)
        qraw = posc[:, None] + torch.arange(c, device=dev)     # [S, C]
        qpos = qraw.clamp(max=span - 1)
        phys = pt.gather(1, qpos // page_size)                  # [S, C]
        p_loc = kp.shape[0] - 1
        dst_g, dst = _shard_target(phys, live[:, None] & (qraw < span), i,
                                   p_loc)
        if quantized:
            row = torch.where(dst_g >= 0, dst_g, n * p_loc)
            kt = torch.clamp(torch.round(
                kt.float() / scales[0][row][..., None]), -127, 127)
            vt = torch.clamp(torch.round(
                vt.float() / scales[1][row][..., None]), -127, 127)
        at = (dst, qpos % page_size)
        kp.index_put_(at, kt.to(kp.dtype))
        vp.index_put_(at, vt.to(vp.dtype))
        g, owned = _page_positions(pt, page_size, i, p_loc)
        visible = owned[:, None] & (g[None, None] <= qpos[:, :, None])
        extra = tuple(_page_scales(sc, pt, page_size) for sc in scales)
        out = _attend(q, _page_view(kp, pt, i), _page_view(vp, pt, i),
                      visible, *extra, group=group)
        return out.to(q.dtype), kp, vp

    return fold


def prefill(k_prompt, v_prompt, t_max: int, *, dtype=torch.bfloat16,
            group=None):
    """Place a prompt's [B, P, H, D] K/V into a fresh cache: cast to
    `dtype`, zero-padded to t_max and cut to this rank's shard over the
    "seq" `group`. Returns (k_cache, v_cache)."""
    p_len = k_prompt.shape[1]
    if p_len > t_max:
        raise ValueError(f"prompt length {p_len} exceeds t_max {t_max}")
    n, i = _ring(group)
    _check_ring(t_max, n)

    def place(x):
        x = F.pad(torch.as_tensor(x).to(dtype),
                  (0, 0, 0, 0, 0, t_max - p_len))
        return x[:, i * (t_max // n):(i + 1) * (t_max // n)]

    return place(k_prompt), place(v_prompt)
