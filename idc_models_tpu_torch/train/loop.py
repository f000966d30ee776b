"""Training orchestration: epoch loops, evaluation, prediction and the
two-phase transfer-learning schedule.

The counterpart of ``idc_models_tpu/train/loop.py`` on one card:
evaluate the untrained floor on a few validation batches -> fit N epochs
with the backbone frozen (head-only mask at `lr`) -> unfreeze the layers
at and above ``fine_tune_at`` with a fresh RMSprop at ``lr / 10`` -> fit
the remaining epochs, continuing the epoch counter with ``seed + 1``.

Phase 1 and phase 2 are two builds of the model (every BN frozen, then
only the BNs below ``fine_tune_at``), as in the JAX package; phase 2
starts from phase 1's parameters and BN statistics. A frozen parameter
does not require grad, so autograd computes nothing for it and the
optimizer never sees it. ``cache_features`` runs phase 2 on the frozen
prefix's cached activations (``train/feature_cache.py``); ``repeats``
passes over the train set per epoch (the ``dense`` preset's 2).

``checkpoint_dir`` makes `fit` resumable at epoch granularity, and
`two_phase_fit` keeps one such directory per phase (``phase1/``,
``phase2/``): the JAX package's commit protocol and fingerprint, with
the model's parameters and buffers, the RMSprop moments, the step count
and the history as the state (`train/checkpoint.py`'s format).

``central_storage`` keeps the train state in host memory between steps
(the reference's CentralStorageStrategy toggle). `fit` records
``train.epoch`` / ``train.step`` / ``device.sync`` / ``train.eval`` spans
and the ``train_*`` registry metrics, and registers the train step's
program account when accounting is armed (``profile_trace``, which the
verbs' ``--profile-dir`` opens, arms it).
``two_phase_fit`` saves the training-curve plot under `artifact_path`.
"""

from __future__ import annotations

import dataclasses
import hashlib
import inspect
import json
import shutil
import sys
import warnings
from pathlib import Path

import numpy as np
import torch
from torch import nn

from idc_models_tpu_torch import convert, resolve_device
from idc_models_tpu_torch.data.idc import ArrayDataset
from idc_models_tpu_torch.data.pipeline import Loader, eval_batches, to_device
from idc_models_tpu_torch.models import core, registry
from idc_models_tpu_torch.observe import metrics_registry as mreg
from idc_models_tpu_torch.observe import profile as prof
from idc_models_tpu_torch.observe import trace
from idc_models_tpu_torch.observe.timer import Timer
from idc_models_tpu_torch.train import checkpoint, losses
from idc_models_tpu_torch.train import metrics as metrics_lib
from idc_models_tpu_torch.train.state import TrainState, rmsprop
from idc_models_tpu_torch.train.step import make_train_step

History = dict[str, list[float]]


def _model_device(model: nn.Module) -> torch.device:
    return next(model.parameters()).device


def batched_logits(model: nn.Module, ds: ArrayDataset, batch_size: int,
                   steps: int | None = None) -> torch.Tensor:
    """Eval-mode logits of the first `steps` batches of `ds` (all of
    them when None; the final batch is partial, so every example counts
    once), concatenated in order on the model's device."""
    device = _model_device(model)
    model.eval()
    with torch.no_grad():
        parts = [model(x).float() for x, _ in
                 to_device(eval_batches(ds, batch_size, steps=steps), device)]
    return torch.cat(parts)


def evaluate(model: nn.Module, ds: ArrayDataset, loss_fn, *,
             batch_size: int = 32, steps: int | None = None,
             with_auroc: bool = False) -> dict[str, float]:
    """Loss and accuracy (and AUROC of the sigmoid scores) over `ds`, or
    its first `steps` batches, in eval mode on the model's device."""
    logits = batched_logits(model, ds, batch_size, steps)
    labels = torch.from_numpy(ds.labels[:len(logits)]).to(logits.device)
    out = {"loss": float(loss_fn(logits, labels)),
           "accuracy": float(metrics_lib.auto_accuracy(logits, labels))}
    if with_auroc:
        out["auroc"] = float(metrics_lib.auroc(
            torch.sigmoid(logits.reshape(-1)), labels))
    return out


def predict(model: nn.Module, images, *, batch_size: int = 32) -> np.ndarray:
    """Eval-mode logits for every image, in order, as a host array (the
    Keras ``model.predict`` convenience)."""
    images = np.asarray(images, np.float32)
    if len(images) == 0:
        with torch.no_grad():
            probe = torch.zeros((1,) + images.shape[1:],
                                device=_model_device(model))
            model.eval()
            shape = model(probe).shape
        return np.zeros((0,) + tuple(shape[1:]), np.float32)
    ds = ArrayDataset(images, np.zeros((len(images),), np.int32))
    return batched_logits(model, ds, batch_size).cpu().numpy()


class _CentralStore:
    """The train state (parameters, BN statistics, optimizer moments) kept
    in host memory between steps: `to_device()` moves every tensor that
    lived on the card there, `to_host()` moves them back. A Parameter
    keeps its identity (its ``.data`` moves), so the optimizer's
    references stay valid; RMSprop's step count, a host scalar, stays
    where it is."""

    def __init__(self, state: TrainState, device: torch.device):
        self._device = device
        self._tensors = [*state.model.parameters(), *state.model.buffers()]
        self._opt = state.optimizer
        self.to_host()

    def _move(self, device: torch.device) -> None:
        with torch.no_grad():
            for t in self._tensors:
                t.data = t.data.to(device)
            for st in self._opt.state.values():
                for k, v in st.items():
                    if isinstance(v, torch.Tensor) and v.dim() > 0:
                        st[k] = v.to(device)

    def to_device(self) -> None:
        self._move(self._device)

    def to_host(self) -> None:
        self._move(torch.device("cpu"))


def fit(state: TrainState, loss_fn, train_ds, val_ds: ArrayDataset | None,
        *, epochs: int, batch_size: int = 32, initial_epoch: int = 0,
        seed: int = 0, repeats: int = 1, logger=None, verbose: bool = True,
        central_storage: bool = False,
        checkpoint_dir: str | Path | None = None,
        checkpoint_every: int = 1) -> History:
    """Keras-``fit``-shaped epoch loop on the model's device.

    Returns the history ({"loss", "accuracy", "val_loss",
    "val_accuracy"} per epoch). Batch order is the JAX package's
    (``Loader``'s (seed, epoch) contract), so the same seed feeds the
    same batches in the same order; each epoch passes over `train_ds`
    `repeats` times, freshly shuffled each pass. `train_ds` may be a
    ``pipeline.FileStream`` instead of an ArrayDataset: it keeps its
    decode configuration, and fit imposes the schedule (batch, shuffle,
    seed, repeat), so both train identically. Per-step metrics stay on
    the device and are read once per epoch, inside a ``device.sync``
    span. A non-finite epoch loss raises ``FloatingPointError`` naming
    the first bad step.

    `central_storage=True` keeps the state in host memory between steps:
    each step copies it to the card, runs there and copies the new state
    back -- the same numbers as the default, with a host round trip a
    step.

    `checkpoint_dir` makes the loop resumable: the state is saved every
    `checkpoint_every` epochs and after the last, and a restart with the
    same arguments and starting parameters resumes after the last saved
    epoch. Nothing else in the loop draws from a random stream (the
    classifier models have no dropout, and a dropout layer without a
    generator refuses to train), so a resumed run equals a
    straight-through one bit for bit."""
    model = state.model
    device = _model_device(model)
    step = make_train_step(state, loss_fn)
    if isinstance(train_ds, ArrayDataset):
        loader = Loader(train_ds, batch_size, shuffle=True, seed=seed,
                        repeat=repeats)
    else:
        loader = train_ds.replace(batch_size=batch_size, shuffle=True,
                                  seed=seed, repeat=repeats)
    history: History = {"loss": [], "accuracy": [],
                        "val_loss": [], "val_accuracy": []}
    start_epoch = initial_epoch
    fingerprint = None
    if checkpoint_dir is not None:
        fingerprint = _fit_fingerprint(model, loader.seed, loader.batch_size,
                                       loader.repeat, initial_epoch)
        restored = _restore_fit_checkpoint(checkpoint_dir, state, epochs,
                                           fingerprint)
        if restored is not None:
            history, start_epoch = restored
            start_epoch = max(start_epoch, initial_epoch)
            if verbose and start_epoch > initial_epoch:
                print(f"resuming fit from epoch {start_epoch + 1}")
    store = _CentralStore(state, device) if central_storage else None
    m_steps = mreg.REGISTRY.counter("train_steps_total",
                                    "optimizer steps taken")
    m_epochs = mreg.REGISTRY.counter("train_epochs_total",
                                     "epochs completed")
    m_loss = mreg.REGISTRY.gauge("train_loss",
                                 "last completed epoch's train loss")
    # program accounting only while armed (a profile_trace window): the
    # first step runs under the counting mode, in place of a plain call
    accounted = not prof.accounting_enabled()

    def run_step(x, y):
        nonlocal accounted
        if store is not None:
            store.to_device()
        if accounted:
            m = step(x, y)
        else:
            accounted = True
            _, m = prof.register_program("train.step", step, x, y,
                                         arguments=(model, state.optimizer))
        if store is not None:
            store.to_host()
        return m

    try:
        for epoch in range(start_epoch, epochs):
            step_losses, step_accs = [], []
            with trace.span("train.epoch", epoch=epoch) as ep_span:
                for x, y in to_device(loader.epoch(epoch), device):
                    # the span covers the host's part and the step's
                    # launches; the device time they hide is waited for
                    # in the device.sync below
                    with trace.span("train.step"):
                        m = run_step(x, y)
                    step_losses.append(m["loss"])
                    step_accs.append(m["accuracy"])
                m_steps.inc(len(step_losses))
                # the epoch-mean fetch is where the loop waits for the card
                with trace.span("device.sync"):
                    loss_arr = torch.stack(step_losses).cpu()
                    ep = {"loss": float(loss_arr.mean()),
                          "accuracy": float(torch.stack(step_accs).mean())}
                ep_span.set(steps=len(step_losses), loss=ep["loss"])
            if not np.isfinite(ep["loss"]):
                bad = int(np.flatnonzero(~np.isfinite(loss_arr.numpy()))[0])
                raise FloatingPointError(
                    f"non-finite training loss ({ep['loss']}) at epoch "
                    f"{epoch + 1}, step {bad + 1}/{len(step_losses)}: the "
                    f"parameters and optimizer state are corrupt from that "
                    f"step on -- lower the lr or check the input data for "
                    f"NaN/Inf")
            if val_ds is not None:
                with trace.span("train.eval", epoch=epoch):
                    if store is not None:
                        store.to_device()
                    vm = evaluate(model, val_ds, loss_fn,
                                  batch_size=batch_size)
                    if store is not None:
                        store.to_host()
                ep["val_loss"] = vm["loss"]
                ep["val_accuracy"] = vm["accuracy"]
            for k, v in ep.items():
                history[k].append(v)
            m_epochs.inc()
            m_loss.set(ep["loss"])
            if verbose:
                msg = " ".join(f"{k}={v:.4f}" for k, v in ep.items())
                print(f"epoch {epoch + 1}/{epochs} {msg}")
            if logger is not None:
                logger.log(event="epoch", epoch=epoch, **ep)
            if checkpoint_dir is not None and (
                    (epoch + 1) % max(checkpoint_every, 1) == 0
                    or epoch + 1 == epochs):
                _save_fit_checkpoint(checkpoint_dir, state, history,
                                     epoch + 1, fingerprint)
    finally:
        if store is not None:
            store.to_device()      # the caller gets its model back on its card
    return history


def _fit_fingerprint(model: nn.Module, seed: int, batch_size: int,
                     repeats: int, initial_epoch: int) -> str:
    """Identifies the run a checkpoint belongs to, as the JAX package
    does: the data-schedule knobs plus each starting parameter's shape
    and float64 sum, in JAX's leaf order (so a retrained upstream phase
    invalidates a downstream phase's checkpoint). The optimizer is not
    captured: a changed lr between runs is not detected."""
    h = hashlib.sha1(
        f"{seed}/{batch_size}/{repeats}/{initial_epoch}".encode())
    params, _ = convert.to_jax(model)
    for a in checkpoint._leaves(params):
        h.update(str(a.shape).encode())
        h.update(np.float64(a.astype(np.float64).sum()).tobytes())
    return h.hexdigest()


def _fit_state_tree(state: TrainState) -> dict:
    """The resumable state as one JAX-layout tree: parameters, buffers,
    each trained parameter's optimizer state under its own path, and
    the step count."""
    names = {id(p): n for n, p in state.model.named_parameters()}
    params, buffers = convert.to_jax(state.model)
    opt = {f"{names[id(p)].replace('.', '/')}/{k}": v
           for p, s in state.optimizer.state.items() for k, v in s.items()}
    return {"params": params, "state": buffers,
            "opt": convert.unflatten(opt), "step": np.int64(state.step)}


def _load_fit_state(state: TrainState, tree: dict) -> None:
    """Load `_fit_state_tree`'s tree into `state` in place, onto the
    model's device (the optimizer's own load_state_dict places its
    moments)."""
    state.model.load_state_dict(convert.from_jax(tree["params"],
                                                 tree.get("state")))
    named = dict(state.model.named_parameters())
    order = {id(p): i for i, p in enumerate(
        p for g in state.optimizer.param_groups for p in g["params"])}
    per_param: dict[int, dict] = {}
    for path, v in convert.flatten(tree.get("opt", {})).items():
        name, key = path.rsplit("/", 1)
        p = named.get(name.replace("/", "."))
        if p is None or id(p) not in order:
            raise ValueError(f"checkpoint holds optimizer state for "
                             f"{name!r}, which this optimizer does not "
                             f"train")
        per_param.setdefault(order[id(p)], {})[key] = torch.from_numpy(
            np.array(v))
    sd = state.optimizer.state_dict()
    sd["state"] = per_param
    state.optimizer.load_state_dict(sd)
    state.step = int(tree["step"])


def _save_fit_checkpoint(ckpt_dir, state: TrainState, history: History,
                         next_epoch: int, fingerprint: str) -> None:
    """Commit protocol: the epoch-versioned state lands first, then
    meta.json is atomically renamed to point at it, then older states are
    pruned. A crash between the two leaves meta pointing at the previous
    consistent (state, epoch) pair, so a resume retrains at most the one
    interrupted epoch."""
    d = Path(ckpt_dir)
    name = f"state_e{next_epoch}"
    checkpoint.save_checkpoint(d / name, _fit_state_tree(state))
    tmp = d / "meta.json.tmp"
    tmp.write_text(json.dumps({"epoch": next_epoch, "state": name,
                               "fingerprint": fingerprint,
                               "history": history}))
    tmp.replace(d / "meta.json")
    for old in d.glob("state_e*"):
        if old.name != name:
            shutil.rmtree(old, ignore_errors=True)


def _restore_fit_checkpoint(ckpt_dir, state: TrainState, epochs: int,
                            fingerprint: str
                            ) -> tuple[History, int] | None:
    """Load the committed state into `state` and return (history,
    epoch), or None when there is nothing of this run to resume."""
    d = Path(ckpt_dir)
    meta = d / "meta.json"
    if not meta.exists():
        return None
    info = json.loads(meta.read_text())
    if info.get("fingerprint") != fingerprint:
        warnings.warn(
            f"checkpoint {d} belongs to a different run (seed/batch/"
            f"repeats or starting parameters changed); ignoring it and "
            f"training from scratch", stacklevel=3)
        return None
    epoch = int(info["epoch"])
    if epoch > epochs:
        raise ValueError(
            f"checkpoint {d} was trained for {epoch} epochs but this run "
            f"asks for {epochs}; refusing to silently return the longer "
            f"run -- delete the checkpoint dir or raise --epochs")
    state_dir = d / info.get("state", "state")
    if not checkpoint.checkpoint_exists(state_dir):
        return None
    _load_fit_state(state, checkpoint.restore_checkpoint(state_dir))
    return dict(info["history"]), epoch


@dataclasses.dataclass(frozen=True)
class TwoPhaseConfig:
    """The reference's training hyperparameters in one place."""

    lr: float = 1e-3
    epochs: int = 10               # phase-1 (frozen backbone) epochs
    fine_tune_epochs: int = 10     # additional phase-2 epochs
    batch_size: int = 32
    fine_tune_at: int | None = None  # None -> registry default
    eval_steps: int | None = 20    # batches of the untrained-floor sample
    repeats: int = 1               # train-set passes per epoch (dense: 2)
    cache_features: bool = False   # phase 2 on cached frozen-prefix
    #                                activations (train/feature_cache.py)
    seed: int = 0
    central_storage: bool = False  # host-resident train state per step


@dataclasses.dataclass
class TwoPhaseResult:
    model: nn.Module               # the phase-2 model (for inference)
    history: History
    history_fine: History
    baseline: dict[str, float]
    pretrain_seconds: float
    fine_tune_seconds: float
    train_steps: tuple[int, int]   # optimizer steps in phase 1, phase 2


_FREEZE_ALL = 10_000  # larger than any Keras layer index


def _phase_dir(checkpoint_dir, phase: int) -> Path | None:
    return (None if checkpoint_dir is None
            else Path(checkpoint_dir) / f"phase{phase}")


def _build_model(spec: registry.ModelSpec, num_outputs: int,
                 bn_frozen_below: int, build_kwargs: dict) -> nn.Module:
    """Build with the BN-freeze setting where the model has BNs (VGG16
    has none)."""
    if "bn_frozen_below" in inspect.signature(spec.build).parameters:
        build_kwargs = {**build_kwargs, "bn_frozen_below": bn_frozen_below}
    return spec.build(num_outputs, **build_kwargs)


def two_phase_fit(model_name: str, num_outputs: int, train_ds: ArrayDataset,
                  val_ds: ArrayDataset,
                  config: TwoPhaseConfig = TwoPhaseConfig(), *,
                  loss_fn=None,
                  build_kwargs: dict | None = None,
                  pretrained_weights: str | None = None,
                  artifact_path: str | Path | None = None,
                  checkpoint_dir: str | Path | None = None,
                  checkpoint_every: int = 1,
                  logger=None, device=None) -> TwoPhaseResult:
    """The reference's two-phase transfer-learning program.

    Phase 1: head-only training at `lr` with every BN frozen. Phase 2:
    the layers with Keras index >= fine_tune_at unfrozen, a fresh
    RMSprop at lr/10, the epoch counter continued and the shuffle seeded
    with seed + 1 -- on cached frozen-prefix features with
    ``config.cache_features`` where the model splits. `build_kwargs` go
    to the model constructor (``registry.FUSED_BUILD_KWARGS[name]``
    selects the fused depthwise kernel). `checkpoint_dir` makes both
    phases resumable at epoch granularity (``phase1/`` and ``phase2/``
    under it; `fit`). `artifact_path` gets the training-curve plot
    (``<artifact_path>/logs/plot_dev1.png``; without matplotlib one line
    on stderr says so and nothing else changes). `device` is CUDA unless
    "cpu" is asked for."""
    device = resolve_device(device)
    if loss_fn is None:
        loss_fn = (losses.binary_cross_entropy if num_outputs == 1
                   else losses.sparse_categorical_cross_entropy)
    spec = registry.get_model(model_name)
    fine_tune_at = (config.fine_tune_at if config.fine_tune_at is not None
                    else spec.default_fine_tune_at)
    kw = dict(build_kwargs or {})

    model1 = _build_model(spec, num_outputs, _FREEZE_ALL, kw)
    core.init_params(model1, config.seed)
    if pretrained_weights is not None:
        from idc_models_tpu_torch.models.pretrained import (
            maybe_load_pretrained,
        )

        maybe_load_pretrained(model1, pretrained_weights)
    model1.to(device)

    state1 = TrainState(model1, rmsprop(
        model1, config.lr, trainable_mask=spec.head_only_mask(model1)))
    baseline = evaluate(model1, val_ds, loss_fn, batch_size=config.batch_size,
                        steps=config.eval_steps)
    print(f"initial loss: {baseline['loss']:.2f}")
    print(f"initial accuracy: {baseline['accuracy']:.2f}")

    with Timer(f"Pre-training for {config.epochs} epochs",
               logger=logger) as t1:
        history = fit(state1, loss_fn, train_ds, val_ds,
                      epochs=config.epochs, batch_size=config.batch_size,
                      seed=config.seed, repeats=config.repeats,
                      logger=logger, central_storage=config.central_storage,
                      checkpoint_dir=_phase_dir(checkpoint_dir, 1),
                      checkpoint_every=checkpoint_every)

    # Phase 2: "recompile" = a fresh optimizer (and moments) at lr/10 with
    # the fine-tune mask; BN below fine_tune_at stays in inference mode
    model2 = _build_model(spec, num_outputs, fine_tune_at, kw).to(device)
    model2.load_state_dict(model1.state_dict())
    del model1
    plan = None
    if config.cache_features:
        if not isinstance(train_ds, ArrayDataset):
            raise ValueError(
                "cache_features needs a materialized ArrayDataset (the "
                "cache runs the frozen prefix over the whole train set); "
                "drop --stream or --cache-features")
        from idc_models_tpu_torch.train import feature_cache as fc

        plan = fc.plan_feature_cache(model2, spec.layer_index or {},
                                     fine_tune_at)
        if plan is None:
            print(f"[idc_models_tpu_torch] {model_name} is not splittable "
                  f"at fine_tune_at={fine_tune_at}; feature cache disabled")
    total_epochs = config.epochs + config.fine_tune_epochs
    with Timer(f"Fine tuning for {config.fine_tune_epochs} epochs",
               logger=logger) as t2:
        if plan is not None:
            state2, history_fine = _fit_cached_phase2(
                plan, spec, model2, train_ds, val_ds, config, fine_tune_at,
                loss_fn, total_epochs, logger,
                checkpoint_dir=_phase_dir(checkpoint_dir, 2),
                checkpoint_every=checkpoint_every)
        else:
            state2 = TrainState(model2, rmsprop(
                model2, config.lr / 10.0,
                trainable_mask=spec.fine_tune_mask(model2, fine_tune_at)))
            history_fine = fit(state2, loss_fn, train_ds, val_ds,
                               epochs=total_epochs,
                               batch_size=config.batch_size,
                               initial_epoch=config.epochs,
                               seed=config.seed + 1,
                               repeats=config.repeats, logger=logger,
                               central_storage=config.central_storage,
                               checkpoint_dir=_phase_dir(checkpoint_dir, 2),
                               checkpoint_every=checkpoint_every)
    print(history)
    print(history_fine)
    if artifact_path is not None:
        _plot(artifact_path, history, history_fine, config.epochs)
    return TwoPhaseResult(
        model=model2, history=history, history_fine=history_fine,
        baseline=baseline, pretrain_seconds=t1.seconds,
        fine_tune_seconds=t2.seconds,
        train_steps=(state1.step, state2.step))


def _fit_cached_phase2(plan, spec: registry.ModelSpec, model: nn.Module,
                       train_ds: ArrayDataset, val_ds: ArrayDataset | None,
                       config: TwoPhaseConfig, fine_tune_at: int, loss_fn,
                       total_epochs: int, logger,
                       checkpoint_dir: Path | None = None,
                       checkpoint_every: int = 1
                       ) -> tuple[TrainState, History]:
    """Phase 2 on cached frozen-prefix features: run the prefix once over
    train and val, then fit the suffix model (which trains `model`'s own
    layers) with the mask, optimizer and seed schedule of the uncached
    path. Returns a TrainState for the full `model` with a fresh
    optimizer (the suffix's moments live only inside this phase), as
    the JAX package's does."""
    from idc_models_tpu_torch.train import feature_cache as fc

    with Timer("Caching frozen-backbone features", logger=logger):
        feat_train = fc.compute_features(plan, train_ds,
                                         batch_size=config.batch_size)
        feat_val = (fc.compute_features(plan, val_ds,
                                        batch_size=config.batch_size)
                    if val_ds is not None else None)
    suffix = plan.suffix_model
    sstate = TrainState(suffix, rmsprop(
        suffix, config.lr / 10.0,
        trainable_mask=spec.fine_tune_mask(suffix, fine_tune_at)))
    history_fine = fit(sstate, loss_fn, feat_train, feat_val,
                       epochs=total_epochs, batch_size=config.batch_size,
                       initial_epoch=config.epochs, seed=config.seed + 1,
                       repeats=config.repeats, logger=logger,
                       central_storage=config.central_storage,
                       checkpoint_dir=checkpoint_dir,
                       checkpoint_every=checkpoint_every)
    full = TrainState(model, rmsprop(
        model, config.lr / 10.0,
        trainable_mask=spec.fine_tune_mask(model, fine_tune_at)),
        step=sstate.step)
    return full, history_fine


def _plot(artifact_path, history: History, history_fine: History,
          initial_epochs: int) -> None:
    """The training-curve plot on one card, or one stderr line when
    matplotlib is missing (the card's machine has none)."""
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        print("[idc_models_tpu_torch] matplotlib is not installed: no "
              "training-curve plot written", file=sys.stderr)
        return
    from idc_models_tpu_torch.observe.plots import plot_history

    plot_history(artifact_path, history, history_fine, 1,
                 initial_epochs=initial_epochs)
