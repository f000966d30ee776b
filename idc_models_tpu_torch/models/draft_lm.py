"""The learned draft model for speculative decoding, the counterpart of
``idc_models_tpu/models/draft_lm.py``: a tiny `AttentionLM` student (the
target's vocab, about 2 blocks) distilled from the target's own logits,
and the glue that carries it from ``train/loop.fit`` to the serve stack.

- `draft_config` / `draft_lm`: the student architecture, a scaled-down
  `AttentionLM` with the target's parameter-tree schema.
- `greedy_streams` / `teacher_logits`: the target's own greedy
  continuations of a prompt batch (the distillation corpus) and its
  logits over them (the soft labels).
- `distill_kl_loss` / `distill_draft_lm`: per-position KL against the
  teacher, trained through ``train/loop.fit`` and ``train/state.rmsprop``.
- `save_draft_lm` / `load_draft_lm`: the sharded checkpoint
  (``checkpoint/sharded.py``) plus a ``draft_config.json`` sidecar,
  committed atomically, so a restore knows the architecture; either
  package restores the other's.
- `DraftLM`: the serve-side drafter. It honours the ``models/draft.py``
  contract with a host-side greedy rollout (`propose`) and flags
  ``uses_engine = True``, so the scheduler asks the engine instead
  (`propose_batched` -> ``SlotEngine.propose_all``): one batched call a
  cycle for every running slot over the drafter's own per-slot caches.

A draft model is never trusted: the target's verify accepts only the
prefix the target itself would have emitted, so a bad student costs
acceptance rate, never correctness.

The LM forward takes exactly `seq_len` tokens, so a stream is as long as
the position table that reads it: the target's for `greedy_streams` and
`teacher_logits`, the student's for `distill_draft_lm`.
"""

from __future__ import annotations

import json
import os
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from idc_models_tpu_torch import convert, resolve_device
from idc_models_tpu_torch.models.lm import AttentionLM

CONFIG_NAME = "draft_config.json"

# architecture knobs a draft_config carries (beyond vocab/seq): the tiny
# student the distillation recipe targets
_ARCH_DEFAULTS = {
    "embed_dim": 32,
    "num_heads": 2,
    "mlp_dim": 64,
    "num_blocks": 2,
}


def draft_config(vocab_size: int, seq_len: int, **overrides) -> dict:
    """The normalized draft-model architecture dict (the sidecar's
    schema). `seq_len` sizes the position table: it must cover the
    serving engine's t_max (the engine checks) and the training
    streams."""
    unknown = set(overrides) - set(_ARCH_DEFAULTS)
    if unknown:
        raise ValueError(
            f"unknown draft_config overrides {sorted(unknown)}; valid "
            f"keys: {sorted(_ARCH_DEFAULTS)}")
    cfg = {"vocab_size": int(vocab_size), "seq_len": int(seq_len)}
    for key, default in _ARCH_DEFAULTS.items():
        cfg[key] = int(overrides.get(key, default))
    if cfg["embed_dim"] % cfg["num_heads"]:
        raise ValueError(
            f"draft embed_dim {cfg['embed_dim']} must divide by "
            f"num_heads {cfg['num_heads']}")
    return cfg


def _normalized(config: dict) -> dict:
    return draft_config(config["vocab_size"], config["seq_len"],
                        **{k: config[k] for k in _ARCH_DEFAULTS
                           if k in config})


def draft_lm(config: dict, *, mesh=None,
             block_impl: str = "jnp") -> AttentionLM:
    """The student module (parameters uninitialized) for a
    `draft_config` dict."""
    return AttentionLM(
        config["vocab_size"], config["seq_len"],
        embed_dim=config["embed_dim"], num_heads=config["num_heads"],
        mlp_dim=config["mlp_dim"], num_blocks=config["num_blocks"],
        block_impl=block_impl, mesh=mesh)


def _device_of(model: torch.nn.Module) -> torch.device:
    return next(model.parameters()).device


@torch.no_grad()
def greedy_streams(model: AttentionLM, prompts, total_len: int
                   ) -> np.ndarray:
    """The target's own greedy continuations: each prompt row extended to
    `total_len` tokens (the target's `seq_len`) by the target's argmax
    picks, each step a causal forward over the whole zero-padded window.
    The distillation corpus: the student learns the target on the
    target's OWN streams."""
    prompts = np.asarray(prompts, np.int64)
    n, p_len = prompts.shape
    if not 1 <= p_len < total_len:
        raise ValueError(f"need 1 <= prompt len < total_len, got "
                         f"prompt {p_len}, total_len {total_len}")
    was = model.training
    model.eval()
    toks = torch.zeros((n, total_len), dtype=torch.long,
                       device=_device_of(model))
    toks[:, :p_len] = torch.from_numpy(prompts)
    for t in range(p_len, total_len):
        toks[:, t] = model(toks)[:, t - 1].argmax(-1)
    model.train(was)
    return toks.cpu().numpy().astype(np.int32)


@torch.no_grad()
def teacher_logits(model: AttentionLM, streams, *,
                   batch_size: int = 32) -> np.ndarray:
    """The teacher's full-sequence logits [N, T, V] float32: the soft
    labels the KL loss distils against."""
    streams = np.asarray(streams, np.int64)
    was = model.training
    model.eval()
    dev = _device_of(model)
    out = [model(torch.from_numpy(streams[i:i + batch_size]).to(dev))
           .float().cpu().numpy()
           for i in range(0, len(streams), batch_size)]
    model.train(was)
    return np.concatenate(out, axis=0)


def distill_kl_loss(logits: torch.Tensor,
                    labels: torch.Tensor) -> torch.Tensor:
    """Mean per-position KL(teacher || student). `labels` are the
    teacher's raw logits [B, T, V]; both distributions are formed in
    f32. Unshifted: both sides' position t predict token t+1."""
    t = F.log_softmax(labels.float(), dim=-1)
    s = F.log_softmax(logits.float(), dim=-1)
    return (t.exp() * (t - s)).sum(-1).mean()


def distill_draft_lm(target_model: AttentionLM, streams, *, config: dict,
                     mesh=None, epochs: int = 4, batch_size: int = 8,
                     lr: float = 1e-2, seed: int = 0, rules=None,
                     checkpoint_dir: str | None = None, logger=None,
                     verbose: bool = False):
    """The distillation recipe through the standard train stack: the
    teacher's logits over `streams` (int [N, T] token streams, T both
    position tables' length; `greedy_streams` samples them from the
    target), then ``train/loop.fit`` on the student with
    `distill_kl_loss` and the Keras RMSprop -- the epoch loop,
    checkpoint-resume and history every model here trains through. The
    student starts from ``init_params(draft_lm(config), seed)`` on the
    target's device; `mesh` makes the loop data-parallel, and `rules`
    (``partition.PartitionRules``, e.g. the registry's "draft_lm" set)
    store the student's parameters and RMSprop moments by rule over it
    (``train.step.ShardedOptimizer``).

    Returns `(student, TrainState, history)`; persist with
    ``save_draft_lm(path, student, config=config)``."""
    from idc_models_tpu_torch.data.idc import ArrayDataset
    from idc_models_tpu_torch.models.core import init_params
    from idc_models_tpu_torch.train.loop import fit
    from idc_models_tpu_torch.train.state import TrainState, rmsprop
    from idc_models_tpu_torch.train.step import ShardedOptimizer

    if rules is not None and mesh is None:
        raise ValueError("distilling under partition rules needs the "
                         "mesh they resolve on (mesh=...)")
    streams = np.asarray(streams, np.int32)
    if streams.ndim != 2:
        raise ValueError(f"streams must be [N, T] int tokens, got "
                         f"shape {streams.shape}")
    if streams.shape[1] > config["seq_len"]:
        raise ValueError(
            f"stream length {streams.shape[1]} exceeds the draft "
            f"position table seq_len={config['seq_len']}; raise "
            f"seq_len in draft_config (it must also cover the serving "
            f"engine's t_max)")
    labels = teacher_logits(target_model, streams, batch_size=batch_size)
    model = init_params(draft_lm(config), seed).to(_device_of(target_model))
    optimizer = rmsprop(model, lr)
    if rules is not None:
        optimizer = ShardedOptimizer(optimizer, model, mesh, rules)
    state = TrainState(model, optimizer)
    history = fit(state, distill_kl_loss, ArrayDataset(streams, labels),
                  None, epochs=epochs, batch_size=batch_size, seed=seed,
                  logger=logger, verbose=verbose,
                  checkpoint_dir=checkpoint_dir, mesh=mesh)
    return model, state, history


def _param_tree(params) -> dict:
    """A JAX-shaped tree of host arrays from a module or a tree; a leaf
    that is not an array is the error of passing the wrong object."""
    if isinstance(params, torch.nn.Module):
        return convert.to_jax(params)[0]
    for name, leaf in convert.flatten(params).items():
        if not (torch.is_tensor(leaf) or isinstance(leaf, np.ndarray)):
            raise ValueError(
                f"save_draft_lm got a non-array leaf at {name} "
                f"({type(leaf).__name__}): pass the PARAM tree (or the "
                f"student module distill_draft_lm returns)")
    return params


def save_draft_lm(path, params, *, config: dict, step=None):
    """Save a distilled drafter (a module or its JAX-shaped parameter
    tree): the tree through the sharded checkpoint (atomic manifest,
    per-shard writes) plus the ``draft_config.json`` sidecar, committed
    by the same atomic writer. Returns the save's handle."""
    from idc_models_tpu_torch.checkpoint.sharded import (
        _commit_json, save_sharded,
    )

    tree = _param_tree(params)
    handle = save_sharded(str(path), tree, step=step)
    _commit_json(Path(path), CONFIG_NAME, _normalized(config))
    return handle


def load_draft_lm(path, *, mesh=None, rules=None):
    """`(params, config)` from a `save_draft_lm` directory (either
    package's). `mesh` + `rules` restore this rank's blocks under the
    rules on that mesh (``checkpoint/sharded.py``); with a mesh and no
    rules the registry's "draft_lm" rule set is used. Without a mesh the
    tree comes back whole, as host arrays."""
    from idc_models_tpu_torch.checkpoint import restore_sharded

    if mesh is not None and rules is None:
        from idc_models_tpu_torch.models.registry import DRAFT_LM_RULES

        rules = DRAFT_LM_RULES
    cfg_path = os.path.join(str(path), CONFIG_NAME)
    if not os.path.exists(cfg_path):
        raise FileNotFoundError(
            f"{cfg_path}: missing the {CONFIG_NAME} sidecar, so this is "
            f"not a draft-LM checkpoint (a bare sharded tree has no "
            f"architecture record); save with "
            f"models/draft_lm.save_draft_lm")
    with open(cfg_path) as f:
        config = _normalized(json.load(f))
    params = restore_sharded(str(path), mesh=mesh, rules=rules)
    return params, config


class DraftLM:
    """Learned drafter over a distilled draft LM's parameter tree.

    Honours the ``models/draft.py`` contract with a host-side greedy
    rollout (`propose`, on `device`: CUDA unless "cpu"), and flags
    ``uses_engine = True``, so the serving scheduler instead batches
    proposals for every running slot through ``SlotEngine.propose_all``
    over the drafter's own per-slot caches.

    ``adapters=(u [T, V, r], v [T, r, V])`` optionally stacks per-tenant
    low-rank drafter heads; the engine applies them to its drafter's
    picks with the same tenant-id gather as the target's bank
    (``models/lm.make_adapter_head_hook``), so a mix of tenants stays
    one call."""

    uses_engine = True

    def __init__(self, k: int, params, config: dict, *, adapters=None,
                 device=None):
        if k < 1:
            raise ValueError(f"need k >= 1 draft tokens, got {k}")
        self.k = int(k)
        self.params = _param_tree(params)
        self.config = _normalized(config)
        vocab = int(np.shape(self.params["embed"])[0])
        if vocab != self.config["vocab_size"]:
            raise ValueError(
                f"draft params embed a {vocab}-token vocab but the "
                f"config says {self.config['vocab_size']}; the sidecar "
                f"and the tree disagree — re-save with save_draft_lm")
        if adapters is not None:
            u, v = (np.asarray(a) for a in adapters)
            if (u.ndim != 3 or v.ndim != 3 or u.shape[0] != v.shape[0]
                    or u.shape[1] != vocab or v.shape[2] != vocab
                    or u.shape[2] != v.shape[1]):
                raise ValueError(
                    f"drafter adapters must be u [T, V, r] / v [T, r, V] "
                    f"with V={vocab}, got u {u.shape} v {v.shape}")
            adapters = (u, v)
        self.adapters = adapters
        self._device = device
        self._model = None

    @property
    def learned(self) -> "DraftLM":
        """The engine-backed member (``serve/api.py`` arms the engine's
        drafter state from it)."""
        return self

    @property
    def vocab_size(self) -> int:
        return self.config["vocab_size"]

    def _forward_model(self) -> AttentionLM:
        if self._model is None:
            model = convert.load_jax(draft_lm(self.config), self.params)
            self._model = model.to(resolve_device(self._device)).eval()
        return self._model

    @torch.no_grad()
    def propose(self, history) -> np.ndarray | None:
        """Host-side greedy rollout of k tokens. The window is always
        [1, seq_len]: the stream's last seq_len tokens, zero-padded, read
        at the last real position; a full window slides by one a
        token."""
        h = np.asarray(history, np.int64).ravel()
        if h.size == 0:
            return None
        model = self._forward_model()
        seq = self.config["seq_len"]
        tail = h[-seq:]
        n = tail.size
        toks = torch.zeros((1, seq), dtype=torch.long,
                           device=model.pos.device)
        toks[0, :n] = torch.from_numpy(tail.copy())
        out = np.empty(self.k, np.int32)
        for j in range(self.k):
            nxt = model(toks)[0, n - 1].argmax()
            out[j] = int(nxt)
            if n < seq:
                toks[0, n] = nxt
                n += 1
            else:
                toks = torch.cat([toks[:, 1:], nxt.view(1, 1)], 1)
        return out

    def propose_batched(self, engine, slots, hists) -> dict:
        """One ``SlotEngine.propose_all()`` covering every running slot;
        rows come back per requested slot (None where the drafter had
        no valid context)."""
        del hists
        res = engine.propose_all()
        if res is None:
            return {s: None for s in slots}
        drafts, valid = res
        return {s: (np.asarray(drafts[s], np.int32) if valid[s]
                    else None) for s in slots}
