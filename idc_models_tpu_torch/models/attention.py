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

`AttentionClassifier` runs on a ring of one, or sequence-parallel over
a mesh's "seq" axis (``mesh=``): each rank holds its T/n positions of
the residual stream, contiguous or zigzag stripes
(``ring_attention.local_shard``). With ``layout="zigzag"`` it permutes
its input and the position table (never the embedded stream), and the
final mean over positions needs no un-permute: each rank's part of it is
summed over "seq" (``collectives.leave_split``, whose backward passes
the gradient through), and the head runs replicated.
`reduce_gradients` then sums the per-position parameters' gradients
(embed, pos, the blocks, ln_f) over "seq", never the head's, which every
rank already holds whole.

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

from idc_models_tpu_torch import collectives
from idc_models_tpu_torch import mesh as meshlib
from idc_models_tpu_torch.models.core import (
    Dense, Dropout, LayerNorm, dense, gelu, glorot_uniform_, layer_norm,
    shard_dropout,
)
from idc_models_tpu_torch.ring_attention import (
    local_shard, make_ring_attention, to_zigzag, zigzag_indices,
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

    def forward(self, x, weight=None, group=None):
        """`weight(name, split)` gives the parameter `name` as the compute
        uses it: this module's own by default; a model that shards its
        parameters gathers them (``AttentionLM._weight``), keeping this
        rank's heads where `split`. With `group` (the "model" group the
        heads split over) each rank attends over its heads, and the
        out-projection's partial sums are summed over the group before
        ``bo`` is added."""
        w = weight or _own_weight(self)
        b, t, _ = x.shape
        split = group is not None
        if split:
            x = collectives.enter_split(x, group)
        q, k, v = (
            (x @ w(n, split).to(x.dtype)).reshape(b, t, -1, self.head_dim)
            for n in ("wq", "wk", "wv"))
        y = self.attn(q, k, v).reshape(b, t, -1) @ w("wo", split).to(x.dtype)
        if split:
            y = collectives.leave_split(y, group)
        return y + w("bo").to(x.dtype)


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

    def forward(self, x, weight=None, attn_group=None, mlp_group=None):
        """`weight` as `MultiHeadAttention.forward` takes it, by the
        block's own names (``mha.wq``, ``fc1.kernel``); `attn_group` and
        `mlp_group` split the heads and the MLP's hidden units over
        "model" (fc1 column-parallel, fc2 row-parallel, ``fc2.bias``
        added once after the sum)."""
        w = weight or _own_weight(self)
        mha_weight = (None if weight is None else
                      lambda n, split=False: weight(f"mha.{n}", split))
        a = layer_norm(x, w("ln1.scale"), w("ln1.bias"), self.ln1.eps)
        x = x + self.drop(self.mha(a, mha_weight, attn_group))
        a = layer_norm(x, w("ln2.scale"), w("ln2.bias"), self.ln2.eps)
        split = mlp_group is not None
        if split:
            a = collectives.enter_split(a, mlp_group)
        y = dense(gelu(dense(a, w("fc1.kernel", split),
                             w("fc1.bias", split))),
                  w("fc2.kernel", split))
        if split:
            y = collectives.leave_split(y, mlp_group)
        return x + self.drop(y + w("fc2.bias"))


def _own_weight(module: nn.Module):
    """The weight accessor of a module that computes on its own
    parameters, whole."""
    return lambda name, split=False: module.get_parameter(name)


def _rewound(block: nn.Module, h, fn=None):
    """`block` (or `fn`, which runs it) under ``torch.utils.checkpoint``,
    its dropout generators rewound for the recompute to their state when
    the forward ran, then set back to where the forward left them."""
    fn = fn or block
    gens = {id(d.generator): d.generator for d in block.modules()
            if isinstance(d, Dropout) and d.generator is not None}
    start = {k: g.get_state() for k, g in gens.items()}
    calls = []

    def run(x):
        if not calls:
            calls.append(1)
            return fn(x)
        end = {k: g.get_state() for k, g in gens.items()}
        for k, g in gens.items():
            g.set_state(start[k])
        try:
            return fn(x)
        finally:
            for k, g in gens.items():
                g.set_state(end[k])

    return checkpoint(run, h, use_reentrant=False)


def run_blocks(blocks, h, *, remat: bool, fn=None):
    """The residual stream through `blocks` in turn (``fn(block, h)``
    runs one when given); with `remat` (and only where a gradient is
    wanted) each block is checkpointed."""
    for blk in blocks:
        run = (lambda x, blk=blk: fn(blk, x)) if fn is not None else blk
        h = (_rewound(blk, h, run) if remat and torch.is_grad_enabled()
             else run(h))
    return h


def seq_layout(mesh):
    """(ring size, "seq" group, dropout blocks) of a mesh for a sequence
    model: a ring of one (group None: this card's own path) without a
    mesh or on a "seq" axis of size 1; the blocks are this rank's
    (block, blocks) of the [B, T, ...] activations' batch and sequence
    dims (`core.shard_dropout`)."""
    if mesh is None:
        return 1, None, {}
    n = mesh.axis_size(meshlib.SEQ_AXIS)
    group = mesh.group(meshlib.SEQ_AXIS) if n > 1 else None
    rows, index = 1, 0
    for a in meshlib.batch_axes(mesh) or ():
        rows *= mesh.axis_size(a)
        index = index * mesh.axis_size(a) + mesh.axis_index(a)
    return n, group, {0: (index, rows),
                      1: (mesh.axis_index(meshlib.SEQ_AXIS), n)}


class AttentionClassifier(nn.Module):
    """Sequence classifier over [B, T, F] inputs, the counterpart of
    ``attention_classifier``: dense ``embed`` + learned positions
    ``pos`` [T, E] -> ``block{i}`` transformer blocks -> ``ln_f`` -> mean
    over positions -> dense ``head``. Inputs are in natural order; the
    zigzag permutation (causal runs only) is internal.

    With `mesh` the input is this rank's rows [B_local, T, F] of the
    global batch (``train.step.shard_batch``), the sequence is split over
    the mesh's "seq" axis, and the logits [B_local, outputs] are the same
    on every rank of the ring."""

    def __init__(self, seq_len: int, features_in: int, *,
                 embed_dim: int = 64, num_heads: int = 4,
                 mlp_dim: int = 128, num_blocks: int = 2,
                 num_outputs: int = 1, causal: bool = True,
                 block_impl: str = "jnp", layout: str = "contiguous",
                 dropout_rate: float = 0.0, remat: bool = False,
                 mesh=None):
        super().__init__()
        self.name = "attention_classifier"
        self.num_blocks = num_blocks
        self.remat = remat
        self.zigzag = layout == "zigzag" and causal
        self.n_ring, self.seq_group, blocks = seq_layout(mesh)
        self.embed = Dense(features_in, embed_dim, name="embed")
        self.pos = nn.Parameter(torch.empty(seq_len, embed_dim))
        for i in range(num_blocks):
            self.add_module(f"block{i}", TransformerBlock(
                embed_dim, num_heads, mlp_dim, causal=causal,
                block_impl=block_impl, layout=layout, group=self.seq_group,
                dropout_rate=dropout_rate, name=f"block{i}"))
        self.ln_f = LayerNorm(embed_dim, name="ln_f")
        self.head = Dense(embed_dim, num_outputs, name="head")
        shard_dropout(self, blocks)

    @property
    def blocks(self) -> list[TransformerBlock]:
        return [getattr(self, f"block{i}") for i in range(self.num_blocks)]

    def reset_parameters(self, g: torch.Generator) -> None:
        with torch.no_grad():
            self.pos.copy_(0.02 * torch.randn(self.pos.shape, generator=g,
                                              device=g.device))

    def forward(self, x):
        pos, n, group = self.pos, self.n_ring, self.seq_group
        if self.zigzag:
            # the input and the positions, not the [B, T, E] stream: the
            # embedding is per position, so the result is the same
            x = to_zigzag(x, n)
            pos = pos[torch.as_tensor(zigzag_indices(pos.shape[0], n),
                                      device=pos.device)]
        if group is not None:
            x, pos = local_shard(x, group), local_shard(pos, group, axis=0)
        h = self.embed(x)
        h = h + pos.to(h.dtype)
        h = run_blocks(self.blocks, h, remat=self.remat)
        if group is None:
            pooled = self.ln_f(h).mean(1)      # permutation-invariant
        else:
            # this rank's part of the mean over all T positions
            pooled = collectives.leave_split(
                self.ln_f(h).sum(1) / self.pos.shape[0], group)
        return self.head(pooled)

    def reduce_gradients(self) -> None:
        """Sum the per-position parameters' gradients over "seq": each
        rank's hold its positions' part. The head's stay as they are:
        the pooled features, and so its gradient, are whole on every
        rank, and a sum would scale them by the ring size."""
        if self.seq_group is None:
            return
        for name, p in self.named_parameters():
            if p.grad is not None and not name.startswith("head."):
                p.grad.copy_(collectives.psum(p.grad, self.seq_group))
