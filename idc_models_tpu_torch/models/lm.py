"""Causal language model over the ring: train it, then serve it with a
KV cache -- the counterpart of ``idc_models_tpu/models/lm.py``.

`AttentionLM` is the decoder-only LM of the JAX package's
``attention_lm``: token embedding + learned positions, pre-LN ring
attention blocks (``models/attention.py``), a final LN and a
per-position vocab head. ``layout="zigzag"`` permutes the token ids and
positions into the balanced causal layout and the logits back, so the
loss needs no layout; ``remat=True`` checkpoints each block. Both are
training knobs: the `Generator` serves the same parameters in natural
order whatever the model trained under. Its state-dict keys are the JAX
tree's paths
(``embed``, ``pos``, ``block0.mha.wq``, ``block0.fc1.kernel``, ...,
``ln_f.scale``, ``head.kernel``), so ``convert.load_jax`` /
``convert.to_jax`` carry parameters across unchanged in both directions.

Over a ("data", "model", "seq") mesh (``mesh=``, then `shard_` with
partition rules, ``registry.LM_RULES``) each rank keeps its block of
every parameter and of its RMSprop moments, and the compute is planned
from each leaf's resolved spec:

- FSDP over "data": a parameter split over "data" is gathered on use,
  and its gradient reduce-scattered (``collectives.gather_on_use``);
- Megatron TP over "model": where qkv and wo are split over "model" (and
  the heads divide), each rank projects and attends over its H/tp heads
  (ring and flash kernels included) and the out-projection's partial
  sums are all-reduced, ``bo`` added once after; fc1/fc2 alike with
  fc2/bias; a leaf the rules leave whole (its dim not divisible) is
  gathered and its compute replicated, so a mesh may mix the two (tp 3
  at 8 heads);
- the vocab-split head feeds a vocab-parallel cross-entropy
  (`token_loss`): max, sum of exponentials and the target's logit
  reduced over "model", no [B, T, vocab] gather;
- the sequence rides "seq": each rank holds T/n positions (zigzag
  stripes under that layout), and the loss is the global token mean, so
  every parameter's gradient sums over "seq" (`reduce_gradients`).

`Generator` serves the same parameters: a bucketed ring prefill over
the prompt (the ring of the config's ``block_impl``; "pallas" runs the
flash block-update kernel) that fills one KV cache per block, or with
``prefill_chunk=C`` the chunk program C tokens at a time
(`chunked_prefill`), then a decode loop of one-token steps through
`ring_decode`. The JAX package fuses the decode loop into one
``lax.scan`` dispatch; here it is a Python loop over the positions,
eager PyTorch. Greedy decoding (temperature 0) is deterministic;
sampling draws from an explicit ``torch.Generator``, whose stream is
not JAX's. Its prefill and decode record ``lm.prefill`` / ``lm.decode``
spans while a tracer is armed, and `Generator.program_costs` accounts
both programs (``observe/profile.py``). The serving engine
(``serve/engine.py``) runs the same prefill, per-token forward and pick.
`make_adapter_head_hook` is the per-tenant logit adapter the serving
engine's window, verify and propose apply at pick time
(``serve/tenancy.py``).

Serving over ranks (``Generator(mesh=, partition_rules=)``): the KV
caches shard over the mesh's "seq" ring (``ring_decode``), the prefill
runs the ring over that group, each rank on its block of the bucket,
and the decode goes through the folds' merge over ranks. Under
partition rules (``registry.LM_RULES``) each rank keeps its block of the
parameters and the serving forwards follow `AttentionLM.shard_`'s plan:
q/k/v projected for this rank's heads and gathered whole over "model"
(the cache never takes the "model" axis), the out-projection and fc2
row-parallel with their partial sums reduced over "model", fc1
column-parallel, and the vocab-split head's logits gathered whole, so
every rank picks from the same logits.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from idc_models_tpu_torch import collectives, convert, resolve_device
from idc_models_tpu_torch import mesh as meshlib
from idc_models_tpu_torch.models.attention import (
    TransformerBlock, run_blocks, seq_layout,
)
from idc_models_tpu_torch.models.core import (
    Dense, LayerNorm, dense, gelu, layer_norm, shard_dropout,
)
from idc_models_tpu_torch.observe import trace
from idc_models_tpu_torch.ring_attention import (
    from_zigzag, local_shard, make_ring_attention, to_zigzag,
)
from idc_models_tpu_torch.ring_decode import (
    init_cache, make_chunk_ring_decode, make_ring_decode,
)


class AttentionLM(nn.Module):
    """Decoder-only LM: int tokens [B, T] -> logits [B, T, vocab], T the
    position table's length (``seq_len``). Causal by construction.

    With `mesh` the input is this rank's rows [B_local, T] of the global
    batch in natural order, and the output this rank's logits
    [B_local, T/n, vocab block] in layout order (`local_positions`
    orders and cuts anything per position alike); `token_loss` scores
    them. `shard_` cuts the parameters by partition rules."""

    def __init__(self, vocab_size: int, seq_len: int, *,
                 embed_dim: int = 64, num_heads: int = 4,
                 mlp_dim: int = 128, num_blocks: int = 2,
                 block_impl: str = "jnp", layout: str = "contiguous",
                 dropout_rate: float = 0.0, remat: bool = False,
                 mesh=None):
        super().__init__()
        self.name = "attention_lm"
        self.num_blocks = num_blocks
        self.num_heads = num_heads
        self.zigzag = layout == "zigzag"
        self.remat = remat
        self.mesh = mesh
        self.n_ring, self.seq_group, blocks = seq_layout(mesh)
        self.embed = nn.Parameter(torch.empty(vocab_size, embed_dim))
        self.pos = nn.Parameter(torch.empty(seq_len, embed_dim))
        for i in range(num_blocks):
            self.add_module(f"block{i}", TransformerBlock(
                embed_dim, num_heads, mlp_dim, block_impl=block_impl,
                layout=layout, group=self.seq_group,
                dropout_rate=dropout_rate, name=f"block{i}"))
        self.ln_f = LayerNorm(embed_dim, name="ln_f")
        self.head = Dense(embed_dim, vocab_size, name="head")
        # every parameter whole until `shard_` cuts them
        self.specs = {n: meshlib.P() for n, _ in self.named_parameters()}
        self._split: dict[str, bool] = {}
        shard_dropout(self, blocks)

    @property
    def blocks(self) -> list[TransformerBlock]:
        return [getattr(self, f"block{i}") for i in range(self.num_blocks)]

    def reset_parameters(self, g: torch.Generator) -> None:
        with torch.no_grad():
            for t in (self.embed, self.pos):
                t.copy_(0.02 * torch.randn(t.shape, generator=g,
                                           device=g.device))

    def forward(self, tokens):
        if self.mesh is not None:
            return self._sharded_forward(tokens)
        # the train step may hand over any integer (or float) type; the
        # table gather needs int64
        tokens, pos = tokens.long(), self.pos
        if self.zigzag:
            tokens, pos = to_zigzag(tokens, 1), to_zigzag(pos[None], 1)[0]
        h = run_blocks(self.blocks, self.embed[tokens] + pos,
                       remat=self.remat)
        logits = self.head(self.ln_f(h))
        return from_zigzag(logits, 1) if self.zigzag else logits

    # -- over a mesh ------------------------------------------------------

    def shard_(self, rules) -> "AttentionLM":
        """Keep this rank's block of every parameter, cut by the spec
        `rules` (``partition.PartitionRules``) resolve on the model's
        mesh from the whole parameter's shape, and plan the compute from
        those specs. Returns the model; build its optimizer after."""
        specs = rules.specs({"params": convert.unflatten(
            {n.replace(".", "/"): p for n, p in self.named_parameters()})},
            mesh=self.mesh)["params"]
        flat = convert.flatten(specs)
        tp = self.mesh.axis_size(meshlib.MODEL_AXIS)
        with torch.no_grad():
            for name, p in self.named_parameters():
                spec = flat[name.replace(".", "/")]
                for entry in spec:
                    axes = meshlib.axes_of(entry)
                    if len(axes) > 1 or not set(axes) <= {
                            meshlib.DATA_AXIS, meshlib.MODEL_AXIS}:
                        raise ValueError(
                            f"the LM splits a parameter dim over 'data' "
                            f"or 'model' alone; {name} resolves to {spec}")
                p.data = meshlib.put_with_sharding(
                    p.data, meshlib.Sharding(self.mesh, spec)).clone()
                self.specs[name] = spec

        def on_model(*names):
            return all(meshlib.MODEL_AXIS in self.specs[n] for n in names)

        for blk in self.blocks:
            b = blk.name
            self._split[f"{b}.attn"] = self.num_heads % tp == 0 and on_model(
                *(f"{b}.mha.{w}" for w in ("wq", "wk", "wv", "wo")))
            self._split[f"{b}.mlp"] = on_model(
                f"{b}.fc1.kernel", f"{b}.fc1.bias", f"{b}.fc2.kernel")
        self._split["head"] = on_model("head.kernel", "head.bias")
        return self

    def _weight(self, name: str, keep_model: bool = False) -> torch.Tensor:
        """A parameter as the compute uses it: gathered over "data"
        (FSDP: the gradient reduce-scattered), and over "model" unless
        `keep_model` (the compute is split there). Read by attribute, so
        ``torch.func.functional_call``'s stand-in tensors are used too."""
        owner, _, leaf = name.rpartition(".")
        p = getattr(self.get_submodule(owner), leaf)
        for dim, axis in enumerate(self.specs[name]):
            if axis == meshlib.DATA_AXIS:
                p = collectives.gather_on_use(
                    p, self.mesh.group(axis), dim, reduce=True)
            elif axis == meshlib.MODEL_AXIS and not keep_model:
                p = collectives.gather_on_use(
                    p, self.mesh.group(axis), dim, reduce=False)
        return p

    def local_positions(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's positions of a per-position [B, T, ...] tensor in
        natural order: permuted into the layout, then cut over "seq"."""
        if self.zigzag:
            x = to_zigzag(x, self.n_ring)
        return local_shard(x, self.seq_group)

    def _sharded_block(self, blk: TransformerBlock, h):
        """One block on this rank's blocks of its parameters, its heads
        and MLP split over "model" where `shard_` planned it."""
        groups = (self.mesh.group(meshlib.MODEL_AXIS)
                  if self._split.get(f"{blk.name}.{part}") else None
                  for part in ("attn", "mlp"))
        return blk(h, lambda n, split=False: self._weight(
            f"{blk.name}.{n}", split), *groups)

    def _sharded_forward(self, tokens):
        tokens = self.local_positions(tokens.long())
        pos = self.local_positions(self._weight("pos")[None])[0]
        h = self._weight("embed")[tokens] + pos
        h = run_blocks(self.blocks, h, remat=self.remat,
                       fn=self._sharded_block)
        h = layer_norm(h, self._weight("ln_f.scale"),
                       self._weight("ln_f.bias"))
        split = self._split.get("head", False)
        if split:
            h = collectives.enter_split(h, self.mesh.group(meshlib.MODEL_AXIS))
        return dense(h, self._weight("head.kernel", split),
                     self._weight("head.bias", split))

    def vocab_offset(self) -> int:
        """The first vocab id of this rank's logits block."""
        if not self._split.get("head", False):
            return 0
        return (self.mesh.axis_index(meshlib.MODEL_AXIS)
                * self.head.kernel.shape[1])

    def next_token_targets(self, tokens: torch.Tensor):
        """(targets, mask) at this rank's positions: position t's target
        is token t+1, the last position has none."""
        tokens = tokens.long()
        targets = torch.cat([tokens[:, 1:], tokens[:, :1]], 1)
        mask = torch.ones_like(tokens, dtype=torch.bool)
        mask[:, -1] = False
        return self.local_positions(targets), self.local_positions(mask)

    def token_loss(self, logits, targets, mask):
        """(sum of the masked tokens' cross-entropy, count of them the
        argmax gets right) over this rank's logits block: the
        vocab-parallel cross-entropy, its max, sum of exponentials and
        target logit reduced over "model" (the sum and target through
        ``leave_split``: the loss is whole on every rank of the model
        axis, and so is its gradient)."""
        split = self._split.get("head", False)
        group = self.mesh.group(meshlib.MODEL_AXIS) if split else None
        offset, lf = self.vocab_offset(), logits.float()
        vl = lf.shape[-1]
        shift = lf.detach().amax(-1)
        if split:
            shift = collectives.pmax(shift, group)
        z = lf - shift[..., None]
        sum_exp = z.exp().sum(-1)
        local = targets - offset
        inside = (local >= 0) & (local < vl)
        picked = z.gather(-1, local.clamp(0, vl - 1)[..., None])[..., 0]
        picked = torch.where(inside, picked, torch.zeros_like(picked))
        best, pred = lf.detach().max(-1)
        if split:
            sum_exp = collectives.leave_split(sum_exp, group)
            picked = collectives.leave_split(picked, group)
            bests = collectives.all_gather(best, group)
            preds = collectives.all_gather(pred + offset, group)
            pred = preds.gather(0, bests.argmax(0)[None])[0]
        loss = ((torch.log(sum_exp) - picked) * mask).sum()
        return loss, ((pred == targets) & mask).sum()

    def reduce_gradients(self) -> None:
        """Sum the gradients over "data" (those FSDP did not already
        reduce-scatter) and over "seq" (each rank's positions carry
        their own loss terms). Nothing without a mesh."""
        if self.mesh is None:
            return
        data, seq = (self.mesh.group(a) for a in (meshlib.DATA_AXIS,
                                                  meshlib.SEQ_AXIS))
        named = [(n, p) for n, p in self.named_parameters()
                 if p.grad is not None]
        collectives.psum_([p.grad for n, p in named
                           if meshlib.DATA_AXIS not in self.specs[n]], data)
        collectives.psum_([p.grad for _, p in named], seq)

    def gathered_params(self) -> dict:
        """The whole JAX-shaped parameter tree (host arrays), gathered
        from every rank's blocks: every rank of the mesh must call it."""
        out = {}
        for name, p in self.named_parameters():
            x = p.detach()
            if self.mesh is not None:
                x = meshlib.gather_block(
                    x, meshlib.Sharding(self.mesh, self.specs[name]))
            out[name.replace(".", "/")] = x.cpu().numpy()
        return convert.unflatten(out)


def next_token_loss(logits: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy of logits[:, :-1] predicting tokens[:, 1:]."""
    logp = torch.log_softmax(logits[:, :-1].float(), dim=-1)
    tgt = tokens[:, 1:].long()
    return -logp.gather(-1, tgt[..., None])[..., 0].mean()


def make_lm_train_step(state, *, global_batch: int):
    """The LM's train step over its mesh: ``step(tokens, labels) ->
    metrics`` with this rank's rows of the global batch (natural
    order). The loss is the global batch's token mean (each rank's
    share over the global count), the gradients are reduced as the
    specs say (`AttentionLM.reduce_gradients`), and each rank's
    optimizer updates its own blocks; the metrics are the global
    batch's, the same on every rank."""
    model, optimizer = state.model, state.optimizer
    groups = [model.mesh.group(a) for a in (meshlib.DATA_AXIS,
                                            meshlib.SEQ_AXIS)]

    def train_step(tokens, labels):
        model.train()
        optimizer.zero_grad(set_to_none=True)
        count = global_batch * (labels.shape[1] - 1)
        targets, mask = model.next_token_targets(labels)
        loss, correct = model.token_loss(model(tokens), targets, mask)
        (loss / count).backward()
        model.reduce_gradients()
        optimizer.step()
        state.step += 1
        m = torch.stack([loss.detach(), correct.float()]) / count
        for g in groups:
            m = collectives.psum(m, g)
        return {"loss": m[0], "accuracy": m[1]}

    return train_step


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class _ServeConfig:
    """What shapes the serving path (parameters are not part of it)."""

    embed_dim: int
    num_heads: int
    num_blocks: int
    t_max: int
    cache_dtype: torch.dtype
    temperature: float
    top_k: int | None
    # the "seq" ring the caches shard over: its group (None: this card
    # alone), size and this rank's index
    group: object = dataclasses.field(default=None, compare=False)
    n_ring: int = 1
    ring_rank: int = 0


def _seq_group(mesh):
    """The "seq" group of a serving mesh (None without one)."""
    return None if mesh is None else mesh.group(meshlib.SEQ_AXIS)


def _serve_config(params, *, embed_dim, num_heads, num_blocks, t_max,
                  cache_dtype, temperature=0.0, top_k=None,
                  mesh=None) -> _ServeConfig:
    if embed_dim % num_heads:
        raise ValueError(f"embed_dim {embed_dim} not divisible by "
                         f"num_heads {num_heads}")
    if params["pos"].shape[0] < t_max:
        raise ValueError(
            f"cache t_max {t_max} exceeds the trained position table "
            f"({params['pos'].shape[0]}) — positions past it have no "
            f"embedding")
    if temperature < 0.0:
        raise ValueError(f"temperature must be >= 0, got {temperature}")
    if top_k is not None and top_k < 1:
        raise ValueError(f"top_k must be >= 1, got {top_k}")
    group = _seq_group(mesh)
    n = collectives.axis_size(group) if group is not None else 1
    if t_max % n:
        raise ValueError(f"t_max {t_max} not divisible by the ring size "
                         f"{n} over mesh axis {meshlib.SEQ_AXIS!r}")
    return _ServeConfig(embed_dim, num_heads, num_blocks, t_max,
                        cache_dtype, float(temperature), top_k, group, n,
                        collectives.axis_index(group) if n > 1 else 0)


def _as_tokens(tokens) -> torch.Tensor:
    return (tokens if torch.is_tensor(tokens)
            else torch.as_tensor(np.asarray(tokens))).long()


def _check_prompt(tokens, t_max: int) -> torch.Tensor:
    """The prompt contract: non-empty int [B, P] with P <= t_max."""
    tokens = _as_tokens(tokens)
    if tokens.dim() != 2 or tokens.shape[1] < 1:
        raise ValueError(f"prefill expects non-empty [B, P] tokens, "
                         f"got shape {tuple(tokens.shape)}")
    if tokens.shape[1] > t_max:
        raise ValueError(f"prompt length {tokens.shape[1]} exceeds "
                         f"t_max {t_max}")
    return tokens


def prefill_bucket(p_len: int, t_max: int, n_ring: int) -> int:
    """The padded prompt length the prefill runs at: the smallest
    ``n_ring * 2**k`` >= p_len, capped at t_max."""
    if not 1 <= p_len <= t_max:
        raise ValueError(f"prompt length {p_len} outside [1, {t_max}]")
    b = n_ring
    while b < p_len:
        b *= 2
    return min(b, t_max)


def prefill_buckets(t_max: int, n_ring: int) -> tuple[int, ...]:
    """Every bucket `prefill_bucket` can return."""
    out, b = [], n_ring
    while b < t_max:
        out.append(b)
        b *= 2
    out.append(t_max)
    return tuple(out)


def check_prefill_chunk(chunk: int, t_max: int) -> int:
    """The one chunk-length contract: chunks tile the cache exactly, so
    chunk k starts at k*chunk and never hangs past t_max (the ragged
    last chunk is cut by its true end, not by a different shape)."""
    chunk = int(chunk)
    if not 1 <= chunk <= t_max:
        raise ValueError(f"prefill_chunk {chunk} outside [1, {t_max}]")
    if t_max % chunk:
        raise ValueError(f"prefill_chunk {chunk} must divide t_max "
                         f"{t_max} so chunk boundaries tile the cache")
    return chunk


def _pad_prompt(tokens: torch.Tensor, t_max: int, n_ring: int):
    """[B, P] -> ([B, bucket] zero-padded, true length P). Causality keeps
    the pad tokens from reaching any real position."""
    p_len = tokens.shape[1]
    bucket = prefill_bucket(p_len, t_max, n_ring)
    if bucket != p_len:
        tokens = F.pad(tokens, (0, bucket - p_len))
    return tokens, p_len


def _make_pick(cfg: _ServeConfig):
    """The sampling rule: greedy argmax at temperature 0, else a draw from
    softmax(logits / temperature), optionally restricted to the top_k
    most likely tokens. ``pick(logits [B, V], generator) -> [B]``."""
    def pick(logits, generator=None):
        lg = logits.float()
        if cfg.top_k is not None and cfg.top_k < lg.shape[-1]:
            kth = torch.topk(lg, cfg.top_k, dim=-1).values[:, -1]
            lg = torch.where(lg >= kth[:, None], lg, float("-inf"))
        if cfg.temperature == 0.0:
            return lg.argmax(-1)
        probs = torch.softmax(lg / cfg.temperature, dim=-1)
        where = generator.device if generator is not None else probs.device
        return torch.multinomial(probs.to(where), 1,
                                 generator=generator)[:, 0].to(lg.device)

    return pick


def _weights(model: AttentionLM, blk: TransformerBlock):
    """Block `blk`'s parameters as the serving compute uses them
    (``AttentionLM._weight``: whole, or this rank's block where
    `split`; an unmeshed model's parameters as they are)."""
    return lambda n, split=False: model._weight(f"{blk.name}.{n}", split)


def _model_group(model: AttentionLM, part: str):
    """The "model" group where `shard_` split `part` ("<block>.attn",
    "<block>.mlp" or "head"), else None."""
    if not model._split.get(part):
        return None
    return model.mesh.group(meshlib.MODEL_AXIS)


def _embed(model: AttentionLM, tokens, positions):
    """Token embeddings plus the learned positions (an int, a slice or
    an index tensor into the table)."""
    return model._weight("embed")[tokens] + model._weight("pos")[positions]


def _project_qkv(cfg: _ServeConfig, blk: TransformerBlock, h,
                 seq_shape: tuple, model: AttentionLM):
    """Pre-LN q/k/v projection of one block, the one definition shared by
    the one-token decode forward and the ring prefill. Where `model`'s
    heads split over "model", each rank projects its heads and the heads
    are gathered whole (the cache holds every head)."""
    b = h.shape[0]
    head_dim = cfg.embed_dim // cfg.num_heads
    w, g = _weights(model, blk), _model_group(model, f"{blk.name}.attn")
    a = layer_norm(h, w("ln1.scale"), w("ln1.bias"))

    def project(name):
        y = (a @ w(f"mha.{name}", g is not None).to(a.dtype)).reshape(
            b, *seq_shape, -1, head_dim)
        if g is None:
            return y
        return collectives.all_gather(y, g, axis=y.dim() - 2, tiled=True)

    return project("wq"), project("wk"), project("wv")


def _attn_residual(blk: TransformerBlock, h, o, model: AttentionLM):
    """Out-projection + residual (row-parallel over "model" where
    `model`'s heads split: this rank's heads of `o`, the partial sums
    reduced, ``bo`` added once after)."""
    w, g = _weights(model, blk), _model_group(model, f"{blk.name}.attn")
    if g is not None:
        tp, r = collectives.axis_size(g), collectives.axis_index(g)
        heads = o.reshape(*o.shape[:-1], blk.mha.num_heads, -1)
        per = blk.mha.num_heads // tp
        o = heads[..., r * per:(r + 1) * per, :].reshape(
            *o.shape[:-1], -1)
    y = o @ w("mha.wo", g is not None).to(o.dtype)
    if g is not None:
        y = collectives.psum(y, g)
    return h + (y + w("mha.bo").to(o.dtype))


def _mlp_residual(blk: TransformerBlock, h, model: AttentionLM):
    """Pre-LN MLP + residual (fc1 column-parallel and fc2 row-parallel
    over "model" where `model` split it)."""
    w, g = _weights(model, blk), _model_group(model, f"{blk.name}.mlp")
    split = g is not None
    a = layer_norm(h, w("ln2.scale"), w("ln2.bias"))
    y = gelu(a @ w("fc1.kernel", split) + w("fc1.bias", split)) @ w(
        "fc2.kernel", split)
    if split:
        y = collectives.psum(y, g)
    return h + (y + w("fc2.bias"))


def _final_logits(model: AttentionLM, h):
    """Final LN + vocab head (the vocab-split head's blocks gathered
    whole where `shard_` split it)."""
    g = _model_group(model, "head")
    h = layer_norm(h, model._weight("ln_f.scale"), model._weight("ln_f.bias"))
    z = (h @ model._weight("head.kernel", g is not None)
         + model._weight("head.bias", g is not None))
    if g is None:
        return z
    return collectives.all_gather(z, g, axis=z.dim() - 1, tiled=True)


def make_adapter_head_hook(u, v, tslot):
    """The per-tenant adapter hook (``serve/tenancy.py``), the one
    definition the serving window, verify and propose apply at pick
    time.

    `u` [T, V, r] and `v` [T, r, V] stack every tenant's low-rank
    logit-space adapter factors; `tslot` [S] (int64 on the logits'
    device) names each slot's tenant. The rows are gathered once, here;
    the returned hook maps base logits to the effective pick logits

        eff[s] = logits[s] + (logits[s] @ u[tslot[s]]) @ v[tslot[s]]

    -- an effective head ``W (I + U_t V_t)`` per tenant -- for logits of
    shape [S, V] (a window step) or [S, K+1, V] (a verify's candidate
    distributions). The products run in `u`'s dtype and the delta is
    cast back to the logits' dtype. The delta is a function of the BASE
    logits, so stored state (prefill outputs, the engine's per-slot
    logits, prefix-cache snapshots) stays tenant-agnostic, and a tenant's
    zero rows give back its base logits bit for bit. Tenant mixes are
    values of `tslot`, not shapes."""
    ug = u.index_select(0, tslot)            # [S, V, r]
    vg = v.index_select(0, tslot)            # [S, r, V]

    def hook(logits):
        z = torch.einsum("s...v,svr->s...r", logits.to(u.dtype), ug)
        d = torch.einsum("s...r,srv->s...v", z, vg)
        return logits + d.to(logits.dtype)

    return hook


def _token_forward(cfg: _ServeConfig, model: AttentionLM, caches, tok, pos,
                   fold):
    """One token per row through every block: embed (+ position), then
    per block [pre-LN -> q/k/v of this token -> cache fold ->
    out-projection residual -> pre-LN MLP residual], final LN, vocab
    head. `pos` is an int or one position per row [B];
    ``fold(i, kc, vc, q, k, v) -> (o, kc, vc)`` is block i's cache fold."""
    b = tok.shape[0]
    h = _embed(model, tok, pos)                             # [B, E]
    new_caches = []
    for i, (blk, (kc, vc)) in enumerate(zip(model.blocks, caches)):
        q, k, v = _project_qkv(cfg, blk, h, (1,), model)
        o, kc, vc = fold(i, kc, vc, q, k, v)
        h = _attn_residual(blk, h, o.reshape(b, cfg.embed_dim), model)
        h = _mlp_residual(blk, h, model)
        new_caches.append((kc, vc))
    return _final_logits(model, h), tuple(new_caches)


def _chunk_forward(cfg: _ServeConfig, model: AttentionLM, caches, tokens,
                   start: int, p_end: int, fold):
    """One prompt chunk [B, C] at positions [start, start + C) through
    every block: `_token_forward` widened to C positions, with the chunk
    fold in place of the one-token fold,
    ``fold(i, kc, vc, q, k, v, start, p_end) -> (o, kc, vc)``. Returns the
    logits of the last REAL position (p_end - 1) and the extended
    caches."""
    b, c = tokens.shape
    h = _embed(model, tokens, slice(start, start + c))      # [B, C, E]
    new_caches = []
    for i, (blk, (kc, vc)) in enumerate(zip(model.blocks, caches)):
        q, k, v = _project_qkv(cfg, blk, h, (c,), model)
        o, kc, vc = fold(i, kc, vc, q, k, v, start, p_end)
        h = _attn_residual(blk, h, o.reshape(b, c, cfg.embed_dim), model)
        h = _mlp_residual(blk, h, model)
        new_caches.append((kc, vc))
    return _final_logits(model, h[:, p_end - start - 1]), tuple(new_caches)


def _chunk_batch_forward(cfg: _ServeConfig, model: AttentionLM, caches,
                         toks, pos, fold):
    """C tokens per row through every block: `_token_forward` widened to
    C positions with PER-ROW start positions, the model half of the
    speculative verify. Row b's tokens [B, C] occupy positions
    [pos[b], pos[b] + C) (clamped into the position table); per block
    the q/k/v of the C tokens go through
    ``fold(i, kc, vc, q, k, v) -> (o [B, C, H, D], kc, vc)`` (the
    batched chunk fold, contiguous or paged, with liveness and positions
    closed over by the caller). Returns the logits at EVERY position
    [B, C, V] -- the verify needs each next-token distribution -- and
    the caches."""
    b, c = toks.shape
    idx = (pos[:, None] + torch.arange(c, device=toks.device)).clamp(
        0, model.pos.shape[0] - 1)
    h = _embed(model, toks, idx)                            # [B, C, E]
    new_caches = []
    for i, (blk, (kc, vc)) in enumerate(zip(model.blocks, caches)):
        q, k, v = _project_qkv(cfg, blk, h, (c,), model)
        o, kc, vc = fold(i, kc, vc, q, k, v)
        h = _attn_residual(blk, h, o.reshape(b, c, cfg.embed_dim), model)
        h = _mlp_residual(blk, h, model)
        new_caches.append((kc, vc))
    return _final_logits(model, h), tuple(new_caches)


def _prefill(cfg: _ServeConfig, model: AttentionLM, ring, tokens, p_len):
    """The bucketed prompt [B, P'] through every block's ring attention:
    the last REAL position's logits, and per block the prompt's K/V with
    the pad positions zeroed (decode's visibility mask relies on slots
    past the prompt staying zero), cast to the cache dtype and padded to
    t_max. Over a "seq" ring of n ranks (`ring` built on that group) each
    rank runs its block of P'/n positions, the last real position's
    activations come from the rank that holds it, and each block's K/V
    are gathered and cut to this rank's cache shard."""
    b, p_pad = tokens.shape
    n, r = cfg.n_ring, cfg.ring_rank
    tl = p_pad // n
    h = _embed(model, tokens[:, r * tl:(r + 1) * tl],
               slice(r * tl, (r + 1) * tl))                 # [B, P'/n, E]
    kvs = []
    for blk in model.blocks:
        q, k, v = _project_qkv(cfg, blk, h, (tl,), model)
        o = ring(q, k, v).reshape(b, tl, cfg.embed_dim)
        h = _attn_residual(blk, h, o, model)
        h = _mlp_residual(blk, h, model)
        kvs.append((k, v))
    owner, at = divmod(p_len - 1, tl)
    h_last = h[:, at]
    if cfg.group is not None:
        h_last = collectives.all_gather(h_last, cfg.group)[owner]
    logits = _final_logits(model, h_last)
    keep = (torch.arange(p_pad, device=h.device) < p_len)[None, :, None, None]
    ts = cfg.t_max // n

    def to_cache(x):
        if cfg.group is not None:
            x = collectives.all_gather(x, cfg.group, axis=1, tiled=True)
        x = torch.where(keep, x, 0).to(cfg.cache_dtype)
        x = F.pad(x, (0, 0, 0, 0, 0, cfg.t_max - p_pad))
        return x[:, r * ts:(r + 1) * ts] if n > 1 else x

    return logits, tuple((to_cache(k), to_cache(v)) for k, v in kvs)


def serving_model(tree, *, num_heads: int, num_blocks: int, device,
                  mesh=None, rules=None) -> AttentionLM:
    """The eval-mode `AttentionLM` a serving path computes on, its sizes
    read off a JAX-shaped tree of host arrays: the whole tree on
    `device`, or on a `mesh` this rank's blocks of it under `rules`
    (``partition.PartitionRules``; None keeps it whole)."""
    vocab, embed_dim = tree["embed"].shape
    model = AttentionLM(vocab, tree["pos"].shape[0], embed_dim=embed_dim,
                        num_heads=num_heads,
                        mlp_dim=tree["block0"]["fc1"]["kernel"].shape[1],
                        num_blocks=num_blocks, mesh=mesh)
    model = convert.load_jax(model, tree).to(device).eval()
    if mesh is not None and rules is not None:
        model.shard_(rules)
    return model


class Generator:
    """The serving path for one parameter tree and decode configuration:
    ``gen(prompt, steps, rng=...) -> [B, P + steps]`` runs one bucketed
    ring prefill over the prompt, then `steps` one-token decode steps.

    `params_or_module` is an `AttentionLM` or its JAX-shaped parameter
    tree; the Generator keeps its own copy on `device` (CUDA unless
    "cpu" is asked for), in eval mode. ``temperature=0`` (default) is
    greedy argmax; ``temperature > 0`` samples (``rng``, a
    ``torch.Generator``, required), optionally from the ``top_k`` most
    likely tokens. The Generator owns the positions: `__call__`/`decode`
    reject any request past `t_max` before any work is done.

    ``prefill_chunk=C`` prefills through the chunk program, C tokens at a
    time (`chunked_prefill`), the path a chunked serving engine admits
    through; None keeps the one bucketed ring prefill.

    `mesh` (``mesh.seq_mesh(n)`` or ``mesh.fsdp_tp_mesh(1, tp, n)``,
    built by every rank) puts the caches on its "seq" ring and runs the
    prefill and the folds over that group; `partition_rules` shard the
    parameters over its "model" axis (``registry.get_partition_rules(
    "lm")``) while the caches keep the ring's layout. Every rank of the
    mesh calls the same methods in the same order; each returns the same
    logits and tokens on every rank."""

    def __init__(self, params_or_module, *, embed_dim: int, num_heads: int,
                 num_blocks: int, t_max: int, mesh=None,
                 cache_dtype: torch.dtype = torch.bfloat16,
                 block_impl: str = "jnp", temperature: float = 0.0,
                 top_k: int | None = None,
                 prefill_chunk: int | None = None, partition_rules=None,
                 device=None):
        tree = (convert.to_jax(params_or_module)[0]
                if isinstance(params_or_module, nn.Module)
                else params_or_module)
        if partition_rules is not None and mesh is None:
            mesh = meshlib.seq_mesh(1)
        self._cfg = _serve_config(
            tree, embed_dim=embed_dim, num_heads=num_heads,
            num_blocks=num_blocks, t_max=t_max, cache_dtype=cache_dtype,
            temperature=temperature, top_k=top_k, mesh=mesh)
        self.mesh = mesh
        self.device = resolve_device(device)
        self._model = serving_model(
            tree, num_heads=num_heads, num_blocks=num_blocks,
            device=self.device, mesh=mesh, rules=partition_rules)
        group = self._cfg.group
        self._ring = make_ring_attention(causal=True, block_impl=block_impl,
                                         group=group)
        self._fold = make_ring_decode(group=group)
        self._chunk_fold = make_chunk_ring_decode(group=group)
        self._pick = _make_pick(self._cfg)
        self.t_max = t_max
        self.temperature = float(temperature)
        self.prefill_chunk = (None if prefill_chunk is None
                              else check_prefill_chunk(prefill_chunk, t_max))

    def init_caches(self, batch: int):
        """Fresh zeroed caches, one (k, v) pair per block."""
        cfg = self._cfg
        return tuple(init_cache(batch, cfg.t_max, cfg.num_heads,
                                cfg.embed_dim // cfg.num_heads,
                                dtype=cfg.cache_dtype, device=self.device,
                                group=cfg.group)
                     for _ in range(cfg.num_blocks))

    @torch.no_grad()
    def prefill(self, prompt):
        """Prompt [B, P] -> (last-position logits [B, vocab], caches). The
        prompt is padded to its prefill bucket (`prefill_bucket` over the
        ring's size); with ``block_impl="pallas"`` a bucket under 128 a
        rank raises, as the kernel needs T a multiple of 128. With
        `prefill_chunk` the prompt runs through the chunk program
        instead, ceil(P / C) chunks extending fresh caches (no flash
        kernel)."""
        tokens = _check_prompt(prompt, self.t_max)
        if self.prefill_chunk is not None:
            with trace.span("lm.prefill", p_len=tokens.shape[1],
                            chunk=self.prefill_chunk):
                return chunked_prefill(self, tokens, self.prefill_chunk)
        padded, p_len = _pad_prompt(tokens, self.t_max, self._cfg.n_ring)
        with trace.span("lm.prefill", p_len=p_len, bucket=padded.shape[1]):
            return _prefill(self._cfg, self._model, self._ring,
                            padded.to(self.device), p_len)

    @torch.no_grad()
    def prefill_chunk_step(self, caches, tokens, start: int, p_end: int):
        """One chunk [B, C] at positions [start, start + C), real below
        `p_end`, through every block, extending `caches` in place:
        (logits of position p_end - 1, caches)."""
        return _chunk_forward(self._cfg, self._model, caches,
                              _as_tokens(tokens).to(self.device), start,
                              p_end, lambda i, *a: self._chunk_fold(*a))

    @torch.no_grad()
    def decode(self, caches, logits, pos0: int, steps: int, *, rng=None):
        """Emit `steps` tokens from (caches, logits) at global position
        `pos0` (the position the next sampled token occupies). Returns
        ``(tokens [B, steps], logits, caches)``; the caches are updated
        in place."""
        if steps < 1:
            raise ValueError(f"decode needs steps >= 1, got {steps}")
        if pos0 < 0:
            raise ValueError(f"decode pos {pos0} must be >= 0")
        if pos0 + steps > self.t_max:
            raise ValueError(f"decode at pos {pos0} + steps {steps} "
                             f"exceeds t_max {self.t_max} — the cache "
                             f"cannot grow at decode time")
        if self.temperature > 0.0 and rng is None:
            raise ValueError("sampling (temperature > 0) needs an rng "
                             "(a torch.Generator)")
        cfg, model, fold = self._cfg, self._model, self._fold
        toks = []
        # the span covers the steps' launches; the caller's token fetch
        # waits for the card
        with trace.span("lm.decode", pos0=pos0, steps=steps):
            for pos in range(pos0, pos0 + steps):
                tok = self._pick(logits, rng)
                logits, caches = _token_forward(
                    cfg, model, caches, tok, pos,
                    lambda _i, kc, vc, q, k, v, pos=pos: fold(
                        kc, vc, q, k, v, pos))
                toks.append(tok)
        return torch.stack(toks, 1), logits, caches

    def __call__(self, prompt, steps: int, *, rng=None) -> torch.Tensor:
        prompt = _as_tokens(prompt)
        p_len = prompt.shape[1] if prompt.dim() == 2 else 0
        if steps < 1 or p_len < 1:
            raise ValueError(f"generate needs a non-empty prompt and "
                             f"steps >= 1, got prompt length {p_len}, "
                             f"steps {steps}")
        if p_len + steps > self.t_max:
            raise ValueError(f"prompt {p_len} + steps {steps} exceeds "
                             f"t_max {self.t_max}")
        if self.temperature > 0.0 and rng is None:
            raise ValueError("sampling (temperature > 0) needs an rng "
                             "(a torch.Generator)")
        logits, caches = self.prefill(prompt)
        toks, _, _ = self.decode(caches, logits, p_len, steps, rng=rng)
        return torch.cat([prompt.to(self.device), toks], dim=1)

    def cache_sizes(self) -> dict:
        """The JAX package's per-program jit-cache entry counts. Eager
        PyTorch compiles no serving program, so every count is 0 and a
        second same-shape call trivially recompiles nothing."""
        return {"step": 0, "prefill": 0, "prefill_chunk": 0,
                "decode_loop": 0}

    def program_costs(self, *, batch: int = 1, steps: int = 8) -> dict:
        """Cost/memory accounts of the serial serving programs
        (``observe/profile.py`` ProgramCost): the full-bucket prefill of
        `batch` prompts of ``t_max`` tokens, and `steps` decode steps
        from fresh caches. Each is one counted real call, registered
        under ``lm.prefill`` / ``lm.decode``. The flash kernels of
        ``block_impl="pallas"`` are ctypes launches the count cannot
        see."""
        from idc_models_tpu_torch.observe import profile as prof

        vocab = self._model.embed.shape[0]
        toks = torch.zeros((batch, self.t_max), dtype=torch.long)
        prefill, _ = prof.register_program(
            "lm.prefill", self.prefill, toks, arguments=(self._model,))
        caches = self.init_caches(batch)
        logits = torch.zeros((batch, vocab), device=self.device)
        rng = (torch.Generator(device=self.device).manual_seed(0)
               if self.temperature > 0.0 else None)
        decode, _ = prof.register_program(
            "lm.decode", self.decode, caches, logits, 0, steps, rng=rng,
            arguments=(self._model,))
        return {"lm.prefill": prefill, "lm.decode": decode}


def chunked_prefill(gen: Generator, tokens, chunk: int, caches=None,
                    start: int = 0):
    """Drive `gen`'s chunk program over ``tokens[:, start:]``: ceil((P -
    start) / chunk) chunks, each extending the previous one's caches in
    place. `caches=None` starts from fresh zeroed caches; caches with a
    chunk-aligned `start` resume a prefix already in them. Returns (the
    last real position's logits, caches)."""
    tokens = _as_tokens(tokens)
    b, p_len = tokens.shape
    if start % chunk or not 0 <= start < p_len:
        raise ValueError(f"chunk resume start {start} must be a chunk "
                         f"multiple inside the prompt (P={p_len})")
    if caches is None:
        caches = gen.init_caches(b)
    logits = None
    for c0 in range(start, p_len, chunk):
        end = min(c0 + chunk, p_len)
        padded = torch.zeros((b, chunk), dtype=torch.long)
        padded[:, :end - c0] = tokens[:, c0:end]
        logits, caches = gen.prefill_chunk_step(caches, padded, c0, end)
    return logits, caches


def generate(params, prompt, steps: int, *, embed_dim: int, num_heads: int,
             num_blocks: int, t_max: int, mesh=None,
             cache_dtype=torch.bfloat16, temperature: float = 0.0,
             top_k: int | None = None, rng=None, block_impl: str = "jnp",
             device=None) -> torch.Tensor:
    """One-shot convenience around `Generator`: [B, P + steps] tokens."""
    gen = Generator(params, embed_dim=embed_dim, num_heads=num_heads,
                    num_blocks=num_blocks, t_max=t_max, mesh=mesh,
                    cache_dtype=cache_dtype, block_impl=block_impl,
                    temperature=temperature, top_k=top_k, device=device)
    return gen(prompt, steps, rng=rng)
