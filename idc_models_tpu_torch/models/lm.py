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

`Generator` serves the same parameters: a bucketed ring prefill over
the prompt (the ring of the config's ``block_impl``; "pallas" runs the
flash block-update kernel) that fills one KV cache per block, then a
decode loop of one-token steps through `ring_decode`. The JAX package
fuses the decode loop into one ``lax.scan`` dispatch; here it is a
Python loop over the positions, eager PyTorch. Greedy decoding
(temperature 0) is deterministic; sampling draws from an explicit
``torch.Generator``, whose stream is not JAX's. Its prefill and decode
record ``lm.prefill`` / ``lm.decode`` spans while a tracer is armed, and
`Generator.program_costs` accounts both programs
(``observe/profile.py``). Left out so far (ROADMAP A9): chunked prefill
(``prefill_chunk``), partition rules (A4-rest) and the adapter hook.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from idc_models_tpu_torch import convert, resolve_device
from idc_models_tpu_torch.models.attention import (
    TransformerBlock, run_blocks,
)
from idc_models_tpu_torch.models.core import Dense, LayerNorm, gelu, layer_norm
from idc_models_tpu_torch.observe import trace
from idc_models_tpu_torch.ring_attention import (
    from_zigzag, make_ring_attention, to_zigzag,
)
from idc_models_tpu_torch.ring_decode import init_cache, make_ring_decode


class AttentionLM(nn.Module):
    """Decoder-only LM: int tokens [B, T] -> logits [B, T, vocab], T the
    position table's length (``seq_len``). Causal by construction."""

    def __init__(self, vocab_size: int, seq_len: int, *,
                 embed_dim: int = 64, num_heads: int = 4,
                 mlp_dim: int = 128, num_blocks: int = 2,
                 block_impl: str = "jnp", layout: str = "contiguous",
                 dropout_rate: float = 0.0, remat: bool = False):
        super().__init__()
        self.name = "attention_lm"
        self.num_blocks = num_blocks
        self.zigzag = layout == "zigzag"
        self.remat = remat
        self.embed = nn.Parameter(torch.empty(vocab_size, embed_dim))
        self.pos = nn.Parameter(torch.empty(seq_len, embed_dim))
        for i in range(num_blocks):
            self.add_module(f"block{i}", TransformerBlock(
                embed_dim, num_heads, mlp_dim, block_impl=block_impl,
                layout=layout, dropout_rate=dropout_rate,
                name=f"block{i}"))
        self.ln_f = LayerNorm(embed_dim, name="ln_f")
        self.head = Dense(embed_dim, vocab_size, name="head")

    @property
    def blocks(self) -> list[TransformerBlock]:
        return [getattr(self, f"block{i}") for i in range(self.num_blocks)]

    def reset_parameters(self, g: torch.Generator) -> None:
        with torch.no_grad():
            for t in (self.embed, self.pos):
                t.copy_(0.02 * torch.randn(t.shape, generator=g,
                                           device=g.device))

    def forward(self, tokens):
        # the train step may hand over any integer (or float) type; the
        # table gather needs int64
        tokens, pos = tokens.long(), self.pos
        if self.zigzag:
            tokens, pos = to_zigzag(tokens, 1), to_zigzag(pos[None], 1)[0]
        h = run_blocks(self.blocks, self.embed[tokens] + pos,
                       remat=self.remat)
        logits = self.head(self.ln_f(h))
        return from_zigzag(logits, 1) if self.zigzag else logits


def next_token_loss(logits: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy of logits[:, :-1] predicting tokens[:, 1:]."""
    logp = torch.log_softmax(logits[:, :-1].float(), dim=-1)
    tgt = tokens[:, 1:].long()
    return -logp.gather(-1, tgt[..., None])[..., 0].mean()


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


def _serve_config(params, *, embed_dim, num_heads, num_blocks, t_max,
                  cache_dtype, temperature=0.0, top_k=None) -> _ServeConfig:
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
    return _ServeConfig(embed_dim, num_heads, num_blocks, t_max,
                        cache_dtype, float(temperature), top_k)


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


def _project_qkv(cfg: _ServeConfig, blk: TransformerBlock, h,
                 seq_shape: tuple):
    """Pre-LN q/k/v projection of one block, the one definition shared by
    the one-token decode forward and the ring prefill."""
    b = h.shape[0]
    head_dim = cfg.embed_dim // cfg.num_heads
    a = layer_norm(h, blk.ln1.scale, blk.ln1.bias)

    def split(y):
        return y.reshape(b, *seq_shape, cfg.num_heads, head_dim)

    mha = blk.mha
    return (split(a @ mha.wq.to(a.dtype)), split(a @ mha.wk.to(a.dtype)),
            split(a @ mha.wv.to(a.dtype)))


def _attn_residual(blk: TransformerBlock, h, o):
    """Out-projection + residual."""
    return h + (o @ blk.mha.wo.to(o.dtype) + blk.mha.bo.to(o.dtype))


def _mlp_residual(blk: TransformerBlock, h):
    """Pre-LN MLP + residual."""
    a = layer_norm(h, blk.ln2.scale, blk.ln2.bias)
    m = gelu(a @ blk.fc1.kernel + blk.fc1.bias)
    return h + (m @ blk.fc2.kernel + blk.fc2.bias)


def _final_logits(model: AttentionLM, h):
    """Final LN + vocab head."""
    h = layer_norm(h, model.ln_f.scale, model.ln_f.bias)
    return h @ model.head.kernel + model.head.bias


def _token_forward(cfg: _ServeConfig, model: AttentionLM, caches, tok, pos,
                   fold):
    """One token per row through every block: embed (+ position), then
    per block [pre-LN -> q/k/v of this token -> cache fold ->
    out-projection residual -> pre-LN MLP residual], final LN, vocab
    head. ``fold(kc, vc, q, k, v) -> (o, kc, vc)`` is the cache fold."""
    b = tok.shape[0]
    h = model.embed[tok] + model.pos[pos]                   # [B, E]
    new_caches = []
    for blk, (kc, vc) in zip(model.blocks, caches):
        q, k, v = _project_qkv(cfg, blk, h, (1,))
        o, kc, vc = fold(kc, vc, q, k, v)
        h = _attn_residual(blk, h, o.reshape(b, cfg.embed_dim))
        h = _mlp_residual(blk, h)
        new_caches.append((kc, vc))
    return _final_logits(model, h), tuple(new_caches)


def _prefill(cfg: _ServeConfig, model: AttentionLM, ring, tokens, p_len):
    """The bucketed prompt [B, P'] through every block's ring attention:
    the last REAL position's logits, and per block the prompt's K/V with
    the pad positions zeroed (decode's visibility mask relies on slots
    past the prompt staying zero), cast to the cache dtype and padded to
    t_max."""
    b, p_pad = tokens.shape
    h = model.embed[tokens] + model.pos[:p_pad]             # [B, P', E]
    kvs = []
    for blk in model.blocks:
        q, k, v = _project_qkv(cfg, blk, h, (p_pad,))
        o = ring(q, k, v).reshape(b, p_pad, cfg.embed_dim)
        h = _attn_residual(blk, h, o)
        h = _mlp_residual(blk, h)
        kvs.append((k, v))
    logits = _final_logits(model, h[:, p_len - 1])
    keep = (torch.arange(p_pad, device=h.device) < p_len)[None, :, None, None]

    def to_cache(x):
        x = torch.where(keep, x, 0).to(cfg.cache_dtype)
        return F.pad(x, (0, 0, 0, 0, 0, cfg.t_max - p_pad))

    return logits, tuple((to_cache(k), to_cache(v)) for k, v in kvs)


def _lm_from_tree(params, *, num_heads: int, num_blocks: int) -> AttentionLM:
    """An `AttentionLM` holding a JAX-shaped parameter tree of host
    arrays, its sizes read off the tree."""
    vocab, embed_dim = params["embed"].shape
    model = AttentionLM(vocab, params["pos"].shape[0], embed_dim=embed_dim,
                        num_heads=num_heads,
                        mlp_dim=params["block0"]["fc1"]["kernel"].shape[1],
                        num_blocks=num_blocks)
    return convert.load_jax(model, params)


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
    reject any request past `t_max` before any work is done."""

    def __init__(self, params_or_module, *, embed_dim: int, num_heads: int,
                 num_blocks: int, t_max: int,
                 cache_dtype: torch.dtype = torch.bfloat16,
                 block_impl: str = "jnp", temperature: float = 0.0,
                 top_k: int | None = None, device=None):
        tree = (convert.to_jax(params_or_module)[0]
                if isinstance(params_or_module, nn.Module)
                else params_or_module)
        self._cfg = _serve_config(
            tree, embed_dim=embed_dim, num_heads=num_heads,
            num_blocks=num_blocks, t_max=t_max, cache_dtype=cache_dtype,
            temperature=temperature, top_k=top_k)
        self.device = resolve_device(device)
        self._model = _lm_from_tree(
            tree, num_heads=num_heads, num_blocks=num_blocks).to(
                self.device).eval()
        self._ring = make_ring_attention(causal=True, block_impl=block_impl)
        self._fold = make_ring_decode()
        self._pick = _make_pick(self._cfg)
        self.t_max = t_max
        self.temperature = float(temperature)

    def init_caches(self, batch: int):
        """Fresh zeroed caches, one (k, v) pair per block."""
        cfg = self._cfg
        return tuple(init_cache(batch, cfg.t_max, cfg.num_heads,
                                cfg.embed_dim // cfg.num_heads,
                                dtype=cfg.cache_dtype, device=self.device)
                     for _ in range(cfg.num_blocks))

    @torch.no_grad()
    def prefill(self, prompt):
        """Prompt [B, P] -> (last-position logits [B, vocab], caches). The
        prompt is padded to its prefill bucket (`prefill_bucket`); with
        ``block_impl="pallas"`` a bucket under 128 raises, as the kernel
        needs T a multiple of 128."""
        tokens = _check_prompt(prompt, self.t_max)
        padded, p_len = _pad_prompt(tokens, self.t_max, 1)
        with trace.span("lm.prefill", p_len=p_len, bucket=padded.shape[1]):
            return _prefill(self._cfg, self._model, self._ring,
                            padded.to(self.device), p_len)

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
                    lambda kc, vc, q, k, v, pos=pos: fold(kc, vc, q, k, v,
                                                          pos))
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


def generate(params, prompt, steps: int, *, embed_dim: int, num_heads: int,
             num_blocks: int, t_max: int, cache_dtype=torch.bfloat16,
             temperature: float = 0.0, top_k: int | None = None, rng=None,
             block_impl: str = "jnp", device=None) -> torch.Tensor:
    """One-shot convenience around `Generator`: [B, P + steps] tokens."""
    gen = Generator(params, embed_dim=embed_dim, num_heads=num_heads,
                    num_blocks=num_blocks, t_max=t_max,
                    cache_dtype=cache_dtype, block_impl=block_impl,
                    temperature=temperature, top_k=top_k, device=device)
    return gen(prompt, steps, rng=rng)
