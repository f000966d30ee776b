"""Multi-head self-attention, the pre-LN transformer block and the
attention sequence classifier over the ring, the counterparts of
``idc_models_tpu/models/attention.py``.

Parameters keep the JAX package's names and shapes, so the state-dict
key of a block's query projection is ``block0.mha.wq`` ([E, E], no
bias) and ``convert.load_jax`` carries JAX parameters over unchanged.
The attention runs through `ring_attention.make_ring_attention`: a ring
of one on this card by default, or over a ``torch.distributed`` group
(``group``), with ``block_impl`` "jnp" or "pallas" and the "contiguous"
or "zigzag" layout.

`AttentionClassifier` runs on a ring of one: with ``layout="zigzag"``
it permutes its input and the position table (never the embedded
stream), and the final mean over positions needs no un-permute.
Sequence parallelism inside a model (each rank holding its shard of
the residual stream) waits for ROADMAP A4-rest.

``remat=True`` checkpoints each block (`run_blocks`): the backward
recomputes the block's activations instead of keeping them. Dropout
draws from explicit generators, which ``torch.utils.checkpoint`` does
not restore, so the recompute rewinds them to where the forward
started: the same masks, and values and gradients equal to the run
without remat, as ``jax.checkpoint`` reuses the block's key.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from idc_models_tpu_torch.models.core import (
    Dense, Dropout, LayerNorm, gelu, glorot_uniform_,
)
from idc_models_tpu_torch.ring_attention import (
    make_ring_attention, to_zigzag, zigzag_indices,
)


class MultiHeadAttention(nn.Module):
    """[B, T, E] -> [B, T, E]: q/k/v projections (``wq wk wv``, no bias),
    attention through the ring, output projection ``wo`` + ``bo``."""

    def __init__(self, embed_dim: int, num_heads: int, *,
                 causal: bool = True, block_impl: str = "jnp",
                 layout: str = "contiguous", group=None,
                 name: str = "mha"):
        super().__init__()
        if embed_dim % num_heads:
            raise ValueError(f"embed_dim {embed_dim} not divisible by "
                             f"num_heads {num_heads}")
        self.name = name
        self.num_heads = num_heads
        self.head_dim = embed_dim // num_heads
        for w in ("wq", "wk", "wv", "wo"):
            setattr(self, w, nn.Parameter(torch.empty(embed_dim, embed_dim)))
        self.bo = nn.Parameter(torch.zeros(embed_dim))
        self.attn = make_ring_attention(causal=causal, block_impl=block_impl,
                                        layout=layout, group=group)

    def reset_parameters(self, g: torch.Generator) -> None:
        for w in (self.wq, self.wk, self.wv, self.wo):
            glorot_uniform_(w, *w.shape, g)
        nn.init.zeros_(self.bo)

    def forward(self, x):
        b, t, e = x.shape
        q, k, v = (
            (x @ w.to(x.dtype)).reshape(b, t, self.num_heads, self.head_dim)
            for w in (self.wq, self.wk, self.wv))
        o = self.attn(q, k, v).reshape(b, t, e)
        return o @ self.wo.to(x.dtype) + self.bo.to(x.dtype)


class TransformerBlock(nn.Module):
    """Pre-LN block: ``x + drop(mha(ln1(x)))``, then
    ``+ drop(fc2(gelu(fc1(ln2(.)))))``, gelu in the tanh form."""

    def __init__(self, embed_dim: int, num_heads: int, mlp_dim: int, *,
                 causal: bool = True, block_impl: str = "jnp",
                 layout: str = "contiguous", group=None,
                 dropout_rate: float = 0.0, name: str = "block"):
        super().__init__()
        self.name = name
        self.ln1 = LayerNorm(embed_dim, name="ln1")
        self.mha = MultiHeadAttention(embed_dim, num_heads, causal=causal,
                                      block_impl=block_impl, layout=layout,
                                      group=group)
        self.ln2 = LayerNorm(embed_dim, name="ln2")
        self.fc1 = Dense(embed_dim, mlp_dim, name="fc1")
        self.fc2 = Dense(mlp_dim, embed_dim, name="fc2")
        self.drop = Dropout(dropout_rate)

    def forward(self, x):
        x = x + self.drop(self.mha(self.ln1(x)))
        return x + self.drop(self.fc2(gelu(self.fc1(self.ln2(x)))))


def _rewound(block: nn.Module, h):
    """`block` under ``torch.utils.checkpoint``, its dropout generators
    rewound for the recompute to their state when the forward ran, then
    set back to where the forward left them."""
    gens = {id(d.generator): d.generator for d in block.modules()
            if isinstance(d, Dropout) and d.generator is not None}
    start = {k: g.get_state() for k, g in gens.items()}
    calls = []

    def run(x):
        if not calls:
            calls.append(1)
            return block(x)
        end = {k: g.get_state() for k, g in gens.items()}
        for k, g in gens.items():
            g.set_state(start[k])
        try:
            return block(x)
        finally:
            for k, g in gens.items():
                g.set_state(end[k])

    return checkpoint(run, h, use_reentrant=False)


def run_blocks(blocks, h, *, remat: bool):
    """The residual stream through `blocks` in turn; with `remat` (and
    only where a gradient is wanted) each block is checkpointed."""
    for blk in blocks:
        h = (_rewound(blk, h) if remat and torch.is_grad_enabled()
             else blk(h))
    return h


class AttentionClassifier(nn.Module):
    """Sequence classifier over [B, T, F] inputs, the counterpart of
    ``attention_classifier``: dense ``embed`` + learned positions
    ``pos`` [T, E] -> ``block{i}`` transformer blocks -> ``ln_f`` -> mean
    over positions -> dense ``head``. Inputs are in natural order; the
    zigzag permutation (causal runs only) is internal."""

    def __init__(self, seq_len: int, features_in: int, *,
                 embed_dim: int = 64, num_heads: int = 4,
                 mlp_dim: int = 128, num_blocks: int = 2,
                 num_outputs: int = 1, causal: bool = True,
                 block_impl: str = "jnp", layout: str = "contiguous",
                 dropout_rate: float = 0.0, remat: bool = False):
        super().__init__()
        self.name = "attention_classifier"
        self.num_blocks = num_blocks
        self.remat = remat
        self.zigzag = layout == "zigzag" and causal
        self.embed = Dense(features_in, embed_dim, name="embed")
        self.pos = nn.Parameter(torch.empty(seq_len, embed_dim))
        for i in range(num_blocks):
            self.add_module(f"block{i}", TransformerBlock(
                embed_dim, num_heads, mlp_dim, causal=causal,
                block_impl=block_impl, layout=layout,
                dropout_rate=dropout_rate, name=f"block{i}"))
        self.ln_f = LayerNorm(embed_dim, name="ln_f")
        self.head = Dense(embed_dim, num_outputs, name="head")

    @property
    def blocks(self) -> list[TransformerBlock]:
        return [getattr(self, f"block{i}") for i in range(self.num_blocks)]

    def reset_parameters(self, g: torch.Generator) -> None:
        with torch.no_grad():
            self.pos.copy_(0.02 * torch.randn(self.pos.shape, generator=g,
                                              device=g.device))

    def forward(self, x):
        pos = self.pos
        if self.zigzag:
            # the input and the positions, not the [B, T, E] stream: the
            # embedding is per position, so the result is the same
            x = to_zigzag(x, 1)
            pos = pos[torch.as_tensor(zigzag_indices(pos.shape[0], 1),
                                      device=pos.device)]
        h = self.embed(x)
        h = h + pos.to(h.dtype)
        h = run_blocks(self.blocks, h, remat=self.remat)
        pooled = self.ln_f(h).mean(1)      # permutation-invariant
        return self.head(pooled)
