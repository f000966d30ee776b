"""Token drafters for speculative decoding, the counterpart of
``idc_models_tpu/models/draft.py`` (host numpy, copied so the port
imports nothing of the JAX package): cheap host-side proposal of the
next k tokens of a slot's stream, verified (and corrected) by the
target model's batched verify program (``serve/engine.py``).

The drafter contract is deliberately tiny:

    drafter.propose(history) -> np.ndarray [k] int32, or None

`history` is the slot's ENTIRE token stream so far -- prompt plus every
emitted token -- as a 1-D int array; the return is exactly `k` proposed
continuation tokens, or None when the drafter has nothing worth
verifying. A proposal is never trusted: the verify program accepts only
the prefix the target model itself would have emitted (greedy argmax,
or the seeded sample, per position), so a BAD drafter costs acceptance
rate, never correctness -- any `propose` implementation is sound.

`NGramDrafter` is prompt-lookup / n-gram drafting: find the most recent
earlier occurrence of the stream's trailing n-gram and propose the
tokens that followed it. No second model, no device work -- it wins on
repetitive, templated traffic and stops proposing (None) on fresh text,
where serving falls back to the plain window.

`ChainedDrafter` composes drafters first-hit-wins per slot: the n-gram
scan's free hits on templated streams, the learned draft LM
(``models/draft_lm.DraftLM``) everywhere the lookup goes quiet.
"""

from __future__ import annotations

import numpy as np


class NGramDrafter:
    """Longest-suffix n-gram lookup over the slot's own stream.

    For n from `order` down to `min_order`, find the LAST position
    before the end where the stream's trailing n tokens occurred, and
    propose the `k` tokens that followed that occurrence (recency wins
    because templated streams drift: the latest occurrence is the best
    predictor of what follows now). A match whose continuation runs
    past the end of the history pads by repeating the final history
    token — padding is verified like any other draft token, so it
    costs only acceptance. Returns None when no n-gram down to
    `min_order` recurs (nothing to verify beats verifying noise).

    `lookback` bounds the scan to the stream's most recent N tokens —
    the drafting pass runs on the serving host's critical path once
    per scheduler cycle per slot, so it must stay O(lookback), not
    O(stream). Recency preference makes the truncation cheap: a match
    only reachable beyond the lookback costs acceptance rate, never
    correctness. None scans everything."""

    def __init__(self, k: int, *, order: int = 3, min_order: int = 1,
                 lookback: int | None = 512):
        if k < 1:
            raise ValueError(f"need k >= 1 draft tokens, got {k}")
        if not 1 <= min_order <= order:
            raise ValueError(f"need 1 <= min_order <= order, got "
                             f"min_order {min_order}, order {order}")
        if lookback is not None and lookback < order + 1:
            raise ValueError(f"lookback {lookback} cannot even hold "
                             f"one order-{order} match")
        self.k = int(k)
        self.order = int(order)
        self.min_order = int(min_order)
        self.lookback = None if lookback is None else int(lookback)

    def propose(self, history) -> np.ndarray | None:
        h = np.asarray(history, np.int64).ravel()
        if self.lookback is not None and h.shape[0] > self.lookback:
            h = h[-self.lookback:]
        length = h.shape[0]
        for n in range(min(self.order, length - 1), self.min_order - 1,
                       -1):
            suffix = h[length - n:]
            # every window over h[:L-1] starts at i <= L-1-n < L-n, so
            # the suffix's self-match at L-n (whose "continuation" is
            # the future being drafted) is excluded by the slice
            windows = np.lib.stride_tricks.sliding_window_view(
                h[:length - 1], n)
            hits = np.flatnonzero((windows == suffix).all(axis=1))
            if not hits.size:
                continue
            i = int(hits[-1])
            cont = h[i + n:i + n + self.k]
            if not cont.size:
                continue
            if cont.shape[0] < self.k:
                cont = np.concatenate([
                    cont, np.full(self.k - cont.shape[0], h[-1],
                                  np.int64)])
            return cont.astype(np.int32)
        return None


class ChainedDrafter:
    """First-hit-wins composition of drafters, one proposal per slot.

    Per slot, members are consulted IN ORDER and the first non-None
    proposal wins — put the free drafter first (lookup-first /
    learned-fallback: `ChainedDrafter(NGramDrafter(k), DraftLM(...))`)
    so the expensive member only answers where the cheap one went
    quiet. All members must agree on `k` (the verify program has ONE
    fixed draft shape), and at most one member may be engine-backed
    (`uses_engine`): the engine hosts one set of drafter ring caches,
    and the chain keeps the one-propose-dispatch-per-cycle budget.

    The batched path calls the engine-backed member's
    `propose_batched` exactly ONCE per cycle regardless of how many
    slots the earlier members already covered — the dispatch is what
    drains the drafter's pending-token backlog into its ring caches,
    so skipping it on lookup-hit cycles would let the drafter's state
    fall behind the streams it must draft next cycle."""

    def __init__(self, *drafters):
        if len(drafters) < 2:
            raise ValueError(
                f"ChainedDrafter needs at least 2 drafters to chain, "
                f"got {len(drafters)} — use the drafter directly")
        ks = sorted({int(d.k) for d in drafters})
        if len(ks) != 1:
            raise ValueError(
                f"chained drafters disagree on k {ks}: the verify "
                f"program has one fixed [n_slots, draft_k] draft "
                f"shape, so every member must propose the same k")
        backed = [d for d in drafters
                  if getattr(d, "uses_engine", False)]
        if len(backed) > 1:
            raise ValueError(
                f"chain has {len(backed)} engine-backed drafters "
                f"({', '.join(type(d).__name__ for d in backed)}); "
                f"the engine hosts ONE set of drafter ring caches — "
                f"chain at most one models/draft_lm.DraftLM")
        self.drafters = tuple(drafters)
        self.k = ks[0]

    @property
    def learned(self):
        """The engine-backed member's model handle (None without one)
        — serve/api.py arms the engine's drafter state from this."""
        for d in self.drafters:
            if getattr(d, "uses_engine", False):
                return d.learned
        return None

    def propose(self, history) -> np.ndarray | None:
        """Host-side chain walk: first member with a proposal wins
        (the engine-backed member answers through its own host-side
        rollout here)."""
        for d in self.drafters:
            got = d.propose(history)
            if got is not None:
                return got
        return None

    def propose_batched(self, engine, slots, hists) -> dict:
        """Per-slot chain resolution over ONE batched learned dispatch
        (when a learned member is chained) plus the host members'
        scans."""
        learned_rows = {}
        for d in self.drafters:
            if getattr(d, "uses_engine", False):
                learned_rows = d.propose_batched(engine, slots, hists)
                break
        out = {}
        for s, h in zip(slots, hists):
            got = None
            for d in self.drafters:
                got = (learned_rows.get(s)
                       if getattr(d, "uses_engine", False)
                       else d.propose(h))
                if got is not None:
                    break
            out[s] = got
        return out
