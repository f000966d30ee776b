"""KV-cache decoding, the counterpart of ``idc_models_tpu/ring_decode.py``
at world size 1.

The cache is [B, t_max, H, D] per block. One decode step for ONE new
token appends its k/v at `pos`, attends the query against the whole
cache with slots past `pos` masked (the finite sentinel, and their p
zeroed), and merges the partial softmax across the ring -- the max and
the sums over ranks are the identity on one card, but the merge is kept
so the multi-card decode ring (ROADMAP A9-dist) plugs in. Appends write
the cache IN PLACE (the JAX version donates the cache; here the caller's
tensor is the cache).

Seven folds share that algebra (`_attend`):

- `make_ring_decode`: one token per step, every row at one position;
- `make_batched_ring_decode`: one token per row, each row its own
  sequence at its own position, dead rows (``live`` False) appending
  nothing -- the serving engine's fold (``serve/engine.py``); with
  ``quantized=True`` the caches hold int8 K/V and per-(row, head) f32
  scales that factor out of both contractions;
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
  view, bit for bit the contiguous folds' result at world size 1; int8
  pools carry one scale per (page, head).

`prefill` places a prompt's K/V into a fresh cache. The folds upcast
the whole cache (or view) to f32 for the contractions, as the one-row
fold always has (PERF.md §7 lists a fused decode fold as speed work).
No fold reads anything back to the host: liveness, positions and the
append targets stay on the device.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from idc_models_tpu_torch.ops.flash_block_kernel import MASKED


def init_cache(batch: int, t_max: int, heads: int, dim: int, *,
               dtype=torch.bfloat16, device=None):
    """Zero-initialized (k, v) caches, [batch, t_max, heads, dim]."""
    def mk():
        return torch.zeros((batch, t_max, heads, dim), dtype=dtype,
                           device=device)
    return mk(), mk()


def _attend(q, kc, vc, visible, k_scale=None, v_scale=None):
    """Queries against the whole cache: f32 scores, masked where
    `visible` is false, the stable softmax and the merge over the ring
    (one rank: the max and the sums over ranks are the identity and corr
    is 1). The one attend of every fold, contiguous and paged.

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
    m_glob = m_loc
    corr = torch.exp(m_loc - m_glob)
    l_glob = l_loc * corr
    acc_glob = acc_loc * corr[..., None]
    out = acc_glob / torch.clamp(l_glob, min=1e-37)[..., None]
    return out.movedim(1, 2) if chunk else out


def make_ring_decode():
    """Build ``fn(k_cache, v_cache, q_t, k_t, v_t, pos) -> (out_t,
    k_cache, v_cache)``: q_t/k_t/v_t are the new token's projections
    [B, 1, H, D], `pos` its global position (an int in [0, t_max)); the
    caches are updated in place and returned."""

    def fold(kc, vc, q, kt, vt, pos: int):
        if q.shape[1] != 1:
            raise ValueError(
                f"ring decode takes ONE token per step: q_t has sequence "
                f"length {q.shape[1]} (batch prefill goes through "
                f"`prefill` / the training ring)")
        t_max = kc.shape[1]
        pos = int(pos)
        if not 0 <= pos < t_max:
            raise ValueError(
                f"pos {pos} outside the cache (t_max {t_max}) -- grow the "
                f"cache at init/prefill time; decode cannot append past it")
        kc[:, pos] = kt[:, 0].to(kc.dtype)
        vc[:, pos] = vt[:, 0].to(vc.dtype)
        visible = torch.arange(t_max, device=kc.device) <= pos
        out = _attend(q[:, 0], kc, vc, visible)
        return out[:, None].to(q.dtype), kc, vc

    return fold


def _quantize_token(x, scale):
    """A token's [B, 1, H, D] K or V in int8 levels of the row's frozen
    per-head `scale` [B, H]: round half to even, clipped to +-127 (f32;
    the append casts)."""
    return torch.clamp(torch.round(x.float() / scale[:, None, :, None]),
                       -127, 127)


def make_batched_ring_decode(*, quantized: bool = False):
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
    fold's output bit for bit."""

    def fold(kc, vc, q, kt, vt, pos, live, *scales):
        if quantized and len(scales) != 2:
            raise ValueError("quantized fold needs (k_scale, v_scale)")
        if not quantized and scales:
            raise ValueError("scales passed to a non-quantized fold")
        if q.shape[1] != 1:
            raise ValueError(
                f"batched ring decode takes ONE token per row per step: "
                f"q_t has sequence length {q.shape[1]}")
        b, t_max = kc.shape[:2]
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
        keep = live[:, None, None]
        for cache, tok in ((kc, kt), (vc, vt)):
            old = cache[rows, posc]
            cache[rows, posc] = torch.where(keep, tok[:, 0].to(cache.dtype),
                                            old)
        visible = (torch.arange(t_max, device=kc.device)[None, :]
                   <= posc[:, None])
        out = _attend(q[:, 0], kc, vc, visible, *scales)
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


def make_batched_chunk_ring_decode(*, quantized: bool = False):
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
    that must not write (a dead row, a position past the cache) writes
    its row's stored value at pos[b] - 1 back over itself: no live entry
    of the row targets that position, so every index the write sees
    twice carries one value.

    With ``quantized=True`` the caches hold int8 K/V and the signature
    grows the per-(row, head) f32 scales, ``fn(..., pos, live, k_scale,
    v_scale)``; appends quantize with the row's frozen insert-time
    scale, as the one-token fold's do."""

    def fold(kc, vc, q, kt, vt, pos, live, *scales):
        if quantized and len(scales) != 2:
            raise ValueError("quantized fold needs (k_scale, v_scale)")
        if not quantized and scales:
            raise ValueError("scales passed to a non-quantized fold")
        b, t_max = kc.shape[:2]
        _checked_chunk(q, pos, b, "batched chunk fold")
        c = q.shape[1]
        dev = kc.device
        pos = torch.as_tensor(pos, device=dev).long()
        live = torch.as_tensor(live, device=dev).bool()
        posc = pos.clamp(0, t_max - 1)
        qpos = posc[:, None] + torch.arange(c, device=dev)     # [B, C]
        writes = live[:, None] & (qpos < t_max)
        at = (torch.arange(b, device=dev)[:, None].expand(b, c),
              torch.where(writes, qpos, (posc - 1).clamp(min=0)[:, None]))
        if quantized:
            kt = _quantize_token(kt, scales[0])
            vt = _quantize_token(vt, scales[1])
        keep = writes[..., None, None]
        for cache, tok in ((kc, kt), (vc, vt)):
            cache.index_put_(at, torch.where(keep, tok.to(cache.dtype),
                                             cache[at]))
        visible = (torch.arange(t_max, device=dev)[None, None, :]
                   <= qpos[:, :, None])                        # [B, C, T]
        out = _attend(q, kc, vc, visible, *scales)
        return out.to(q.dtype), kc, vc

    return fold


def make_chunk_ring_decode():
    """Chunked-prefill fold: ``fn(k_cache, v_cache, q, k, v, start,
    p_end) -> (out, k_cache, v_cache)`` runs C prompt tokens against an
    existing cache. q/k/v are the chunk's projections [B, C, H, D]; the
    chunk occupies positions [start, start + C), and only those below
    `p_end` are real (the ragged last chunk). The fold appends the real
    positions' K/V, attends every query against the whole updated cache
    with a per-query causal mask (cache position <= query position,
    which also covers causality inside the chunk), and merges over the
    ring. Query rows at or past p_end append nothing; their outputs are
    garbage the caller discards (never NaN: each sees position 0)."""

    def fold(kc, vc, q, kt, vt, start: int, p_end: int):
        if q.dim() != 4 or q.shape[1] < 1:
            raise ValueError(f"chunk fold expects [B, C, H, D] queries, "
                             f"got shape {tuple(q.shape)}")
        t_max, c = kc.shape[1], q.shape[1]
        start, p_end = int(start), int(p_end)
        if not 0 <= start <= t_max - c:
            raise ValueError(f"chunk start {start} + chunk {c} outside "
                             f"the cache (t_max {t_max})")
        n = max(min(p_end, start + c) - start, 0)
        kc[:, start:start + n] = kt[:, :n].to(kc.dtype)
        vc[:, start:start + n] = vt[:, :n].to(vc.dtype)
        g = torch.arange(t_max, device=kc.device)
        qpos = start + torch.arange(c, device=kc.device)
        visible = g[None, :] <= qpos[:, None]                   # [C, T]
        out = _attend(q, kc, vc, visible)
        return out.to(q.dtype), kc, vc                          # [B,C,H,D]

    return fold


def _page_view(pool, pt):
    """Gather a pool into each row's LOGICAL view: pt [S, L] physical
    page ids (-1 = unallocated) -> [S, L*ps, H, D] in logical position
    order. Rows gathered through an unallocated id (clamped to page 0)
    hold values the caller's visibility mask discards, as the contiguous
    folds' slots past `pos`."""
    view = pool[pt.clamp(min=0)]                          # [S, L, ps, H, D]
    s, l, ps, h, d = view.shape
    return view.reshape(s, l * ps, h, d)


def _page_scales(scale, pt, ps):
    """Per-page [n_pages, H] scales -> each row's [S, H, L*ps] scale of
    every logical position."""
    return scale[pt.clamp(min=0)].movedim(2, 1).repeat_interleave(ps, 2)


def _page_positions(pt, ps):
    """The logical positions [L*ps] of a page table's view, and [S, L*ps]
    whether each lies on an allocated page."""
    g = torch.arange(pt.shape[1] * ps, device=pt.device)
    return g, (pt >= 0).repeat_interleave(ps, 1)


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
                                   quantized: bool = False):
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
    dropped."""

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
        posc = pos.clamp(0, l_pages * page_size - 1)
        phys = pt.gather(1, (posc // page_size)[:, None])[:, 0]
        dst = torch.where(live & (phys >= 0), phys, kp.shape[0] - 1)
        if quantized:
            kt = _quantize_token(kt, scales[0][dst])
            vt = _quantize_token(vt, scales[1][dst])
        at = (dst, posc % page_size)
        kp.index_put_(at, kt[:, 0].to(kp.dtype))
        vp.index_put_(at, vt[:, 0].to(vp.dtype))
        g, owned = _page_positions(pt, page_size)
        visible = owned & (g[None, :] <= posc[:, None])       # [S, L*ps]
        extra = tuple(_page_scales(sc, pt, page_size) for sc in scales)
        out = _attend(q[:, 0], _page_view(kp, pt), _page_view(vp, pt),
                      visible, *extra)
        return out[:, None].to(q.dtype), kp, vp

    return fold


def make_paged_chunk_ring_decode(*, page_size: int, quantized: bool = False):
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
    scales, which the fold updates in place and returns: ``fn(..., start, p_end,
    k_scale, v_scale) -> (out, k_pool, v_pool, k_scale, v_scale)``. Each
    page the chunk fills gets a fresh per-head scale (absmax of its REAL
    tokens / 127, floor 1e-8) before its content quantizes with it."""

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
        sink = kp.shape[0] - 1
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
        writer = real[None, :] & (phys >= 0)                  # [B, C]
        at = (torch.where(writer, phys, sink),
              (cpos % page_size).expand(b, c))
        kp.index_put_(at, kt.to(kp.dtype))
        vp.index_put_(at, vt.to(vp.dtype))
        g, owned = _page_positions(pt, page_size)
        visible = owned[:, None] & (g[None, None] <= cpos[None, :, None])
        extra = tuple(_page_scales(sc, pt, page_size) for sc in scales)
        out = _attend(q, _page_view(kp, pt), _page_view(vp, pt), visible,
                      *extra).to(q.dtype)
        if quantized:
            return (out, kp, vp) + tuple(scales)
        return out, kp, vp

    return fold


def make_paged_batched_chunk_ring_decode(*, page_size: int,
                                         quantized: bool = False):
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
    and no scale is written."""

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
        writer = live[:, None] & (qraw < span) & (phys >= 0)
        dst = torch.where(writer, phys, kp.shape[0] - 1)
        if quantized:
            kt = torch.clamp(torch.round(
                kt.float() / scales[0][dst][..., None]), -127, 127)
            vt = torch.clamp(torch.round(
                vt.float() / scales[1][dst][..., None]), -127, 127)
        at = (dst, qpos % page_size)
        kp.index_put_(at, kt.to(kp.dtype))
        vp.index_put_(at, vt.to(vp.dtype))
        g, owned = _page_positions(pt, page_size)
        visible = owned[:, None] & (g[None, None] <= qpos[:, :, None])
        extra = tuple(_page_scales(sc, pt, page_size) for sc in scales)
        out = _attend(q, _page_view(kp, pt), _page_view(vp, pt), visible,
                      *extra)
        return out.to(q.dtype), kp, vp

    return fold


def prefill(k_prompt, v_prompt, t_max: int, *, dtype=torch.bfloat16):
    """Place a prompt's [B, P, H, D] K/V into a fresh cache: cast to
    `dtype` and zero-padded to t_max. Returns (k_cache, v_cache)."""
    p_len = k_prompt.shape[1]
    if p_len > t_max:
        raise ValueError(f"prompt length {p_len} exceeds t_max {t_max}")

    def place(x):
        return F.pad(torch.as_tensor(x).to(dtype),
                     (0, 0, 0, 0, 0, t_max - p_len))

    return place(k_prompt), place(v_prompt)
