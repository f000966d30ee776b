"""Multi-head self-attention and the pre-LN transformer block over the
ring, the counterparts of ``idc_models_tpu/models/attention.py``.

Parameters keep the JAX package's names and shapes, so the state-dict
key of a block's query projection is ``block0.mha.wq`` ([E, E], no
bias) and ``convert.load_jax`` carries JAX parameters over unchanged.
The attention itself is causal, through `ring_attention.make_ring_attention`
at world size 1 (``block_impl`` "jnp" or "pallas"). ``attention_classifier``
(whose attention may be non-causal), the zigzag layout and the
``attention`` verb are not ported yet (ROADMAP A8).
"""

from __future__ import annotations

import torch
from torch import nn

from idc_models_tpu_torch.models.core import (
    Dense, Dropout, LayerNorm, gelu, glorot_uniform_,
)
from idc_models_tpu_torch.ring_attention import make_ring_attention


class MultiHeadAttention(nn.Module):
    """[B, T, E] -> [B, T, E]: q/k/v projections (``wq wk wv``, no bias),
    causal attention through the ring, output projection ``wo`` + ``bo``."""

    def __init__(self, embed_dim: int, num_heads: int, *,
                 block_impl: str = "jnp", name: str = "mha"):
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
        self.attn = make_ring_attention(causal=True, block_impl=block_impl)

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
                 block_impl: str = "jnp", dropout_rate: float = 0.0,
                 name: str = "block"):
        super().__init__()
        self.name = name
        self.ln1 = LayerNorm(embed_dim, name="ln1")
        self.mha = MultiHeadAttention(embed_dim, num_heads,
                                      block_impl=block_impl)
        self.ln2 = LayerNorm(embed_dim, name="ln2")
        self.fc1 = Dense(embed_dim, mlp_dim, name="fc1")
        self.fc2 = Dense(mlp_dim, embed_dim, name="fc2")
        self.drop = Dropout(dropout_rate)

    def forward(self, x):
        x = x + self.drop(self.mha(self.ln1(x)))
        return x + self.drop(self.fc2(gelu(self.fc1(self.ln2(x)))))
