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

Three folds share that algebra (`_attend`):

- `make_ring_decode`: one token per step, every row at one position;
- `make_batched_ring_decode`: one token per row, each row its own
  sequence at its own position, dead rows (``live`` False) appending
  nothing -- the serving engine's fold (``serve/engine.py``); with
  ``quantized=True`` the caches hold int8 K/V and per-(row, head) f32
  scales that factor out of both contractions;
- `make_chunk_ring_decode`: C prompt tokens at once, appended at
  `start`, each query attending causally over the whole cache -- chunked
  prefill (``models/lm.py``).

`prefill` places a prompt's K/V into a fresh cache. The folds upcast
the whole cache to f32 for the contractions, as the one-row fold always
has (PERF.md §7 lists a fused decode fold as speed work). The paged
folds go with ``pages.py`` (ROADMAP A9.2), the batched chunk fold with
the speculative verify program (A9.3).
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
    """One query per row [B, H, D] against the whole cache: f32 scores,
    masked where `visible` ([T] or [B, T]) is false, the stable softmax
    and the merge over the ring (one rank: the max and the sums over
    ranks are the identity and corr is 1). The int8 scales [B, H]
    multiply the scores and the value sums after the contractions."""
    vis = visible if visible.dim() == 1 else visible[:, None, :]
    s = torch.einsum("bhd,bkhd->bhk", q.float(), kc.float()) * (
        kc.shape[-1] ** -0.5)
    if k_scale is not None:
        s = s * k_scale[:, :, None]
    s = torch.where(vis, s, MASKED)
    m_loc = s.amax(-1)
    # a fully masked row would fold p = exp(0) = 1 garbage: zero it
    p = torch.where(vis, torch.exp(s - m_loc[..., None]), 0.0)
    l_loc = p.sum(-1)
    acc_loc = torch.einsum("bhk,bkhd->bhd", p, vc.float())
    if v_scale is not None:
        acc_loc = acc_loc * v_scale[..., None]
    m_glob = m_loc
    corr = torch.exp(m_loc - m_glob)
    l_glob = l_loc * corr
    acc_glob = acc_loc * corr[..., None]
    return acc_glob / torch.clamp(l_glob, min=1e-37)[..., None]


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
        s = torch.einsum("bchd,bkhd->bhck", q.float(), kc.float()) * (
            kc.shape[-1] ** -0.5)
        s = torch.where(visible, s, MASKED)
        m_loc = s.amax(-1)                                      # [B, H, C]
        p = torch.where(visible, torch.exp(s - m_loc[..., None]), 0.0)
        l_loc = p.sum(-1)
        acc_loc = torch.einsum("bhck,bkhd->bhcd", p, vc.float())
        m_glob = m_loc
        corr = torch.exp(m_loc - m_glob)
        l_glob = l_loc * corr
        acc_glob = acc_loc * corr[..., None]
        out = acc_glob / torch.clamp(l_glob, min=1e-37)[..., None]
        return out.movedim(1, 2).to(q.dtype), kc, vc            # [B,C,H,D]

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
