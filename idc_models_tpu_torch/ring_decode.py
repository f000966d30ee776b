"""KV-cache decoding, one token at a time, the counterpart of
``idc_models_tpu/ring_decode.py`` at world size 1.

The cache is [B, t_max, H, D] per block. One decode step for ONE new
token appends its k/v at `pos`, attends the query against the whole
cache with slots past `pos` masked (the finite sentinel, and their p
zeroed), and merges the partial softmax across the ring -- the max and
the sums over ranks are the identity on one card, but the merge is kept
so the multi-card ring (ROADMAP A4-rest) plugs in. The append writes the
cache IN PLACE (the JAX version donates the cache; here the caller's
tensor is the cache). The batched, chunk and paged folds and the int8
cache are not ported yet (ROADMAP A9).
"""

from __future__ import annotations

import torch

from idc_models_tpu_torch.ops.flash_block_kernel import MASKED


def init_cache(batch: int, t_max: int, heads: int, dim: int, *,
               dtype=torch.bfloat16, device=None):
    """Zero-initialized (k, v) caches, [batch, t_max, heads, dim]."""
    def mk():
        return torch.zeros((batch, t_max, heads, dim), dtype=dtype,
                           device=device)
    return mk(), mk()


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
        scale = kc.shape[-1] ** -0.5
        # 1. append the token's k/v at its slot
        kc[:, pos] = kt[:, 0].to(kc.dtype)
        vc[:, pos] = vt[:, 0].to(vc.dtype)
        # 2. attend against the cache in f32, slots past pos masked
        s = torch.einsum("bhd,bkhd->bhk", q[:, 0].float(), kc.float()) * scale
        visible = torch.arange(t_max, device=kc.device) <= pos
        s = torch.where(visible, s, MASKED)
        m_loc = s.amax(-1)
        p = torch.where(visible, torch.exp(s - m_loc[..., None]), 0.0)
        l_loc = p.sum(-1)
        acc_loc = torch.einsum("bhk,bkhd->bhd", p, vc.float())
        # 3. merge across the ring: one rank, so the max and the sums
        # over ranks are the identity and corr is 1
        m_glob = m_loc
        corr = torch.exp(m_loc - m_glob)
        l_glob = l_loc * corr
        acc_glob = acc_loc * corr[..., None]
        out = acc_glob / torch.clamp(l_glob, min=1e-37)[..., None]
        return out[:, None].to(q.dtype), kc, vc

    return fold
