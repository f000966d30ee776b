"""Command-line entry point: the ``mobile`` verb of ``idc_models_tpu``.

    python -m idc_models_tpu_torch mobile --path runs/mobile \\
        --data-dir .../balanced_IDC_30k --depthwise-impl fused

Two-phase transfer learning of MobileNetV2 on IDC patches with the
``mobile`` preset's hyperparameters (batch 32, lr 1e-4, fine-tune at
Keras index 100), every one overridable. Data: --data-dir (a
``<label>/*.png`` tree) if given, else ``<path>/data/balanced_IDC_30k``
if present, else --synthetic-examples synthetic patches.

``--depthwise-impl fused`` runs MobileNetV2's frozen and eval depthwise
chains through the hand-written CUDA kernel (``ops/fused_conv.py``);
``grouped`` (the default, as in the JAX package) uses cuDNN's grouped
convolution. ``--device`` is ``cuda`` unless ``cpu`` is asked for.

With --path the run writes ``<path>/logs/run.jsonl`` (``epoch``,
``timer`` and ``test`` records) and the trained model as
``<path>/model.npz`` in the JAX package's npz layout
(``{"params": ..., "state": ...}``).
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
from pathlib import Path

from idc_models_tpu_torch.models.core import DEPTHWISE_IMPLS


def main(argv: list[str] | None = None) -> int:
    ns = _parse(argv)
    {"mobile": _run_dist}[ns.preset_key](ns)
    return 0


def _parse(argv):
    p = argparse.ArgumentParser(prog="idc_models_tpu_torch",
                                description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    sub = p.add_subparsers(dest="preset_key", required=True)
    sp = sub.add_parser("mobile", help="MobileNetV2 two-phase training")
    sp.add_argument("--path", default=None,
                    help="artifact root (<path>/logs/run.jsonl, "
                         "<path>/model.npz)")
    sp.add_argument("--data-dir", default=None,
                    help="directory tree <label>/*.png")
    sp.add_argument("--synthetic-examples", type=int, default=512,
                    help="synthetic dataset size when no real data")
    sp.add_argument("--seed", type=int, default=0)
    sp.add_argument("--batch-size", type=int, default=None)
    sp.add_argument("--lr", type=float, default=None)
    sp.add_argument("--epochs", type=int, default=None)
    sp.add_argument("--fine-tune-epochs", type=int, default=None)
    sp.add_argument("--fine-tune-at", type=int, default=None)
    sp.add_argument("--pretrained-weights", default=None,
                    help="backbone weight artifact (.npz in the JAX "
                         "package's layout)")
    sp.add_argument("--depthwise-impl", default="grouped",
                    choices=DEPTHWISE_IMPLS,
                    help="MobileNetV2's depthwise lowering: 'fused' runs "
                         "the frozen/eval depthwise+BN+relu6 chains "
                         "through the CUDA kernel")
    sp.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ns = p.parse_args(argv)
    ns.preset_key = ns.preset_key.replace("-", "_")
    return ns


def _apply_overrides(preset, ns, fields):
    kw = {f: getattr(ns, f) for f in fields if getattr(ns, f) is not None}
    return dataclasses.replace(preset, **kw) if kw else preset


def _data_root(ns):
    """--data-dir > <path>/data/balanced_IDC_30k > None (synthetic)."""
    root = ns.data_dir
    if root is None and ns.path is not None:
        cand = Path(ns.path) / "data" / "balanced_IDC_30k"
        if cand.exists():
            root = cand
    return root


def _load_idc(ns, image_size, limit):
    from idc_models_tpu_torch.data import synthetic
    from idc_models_tpu_torch.data.idc import ArrayDataset, load_directory

    root = _data_root(ns)
    if root is not None:
        return load_directory(root, image_size=image_size, limit=limit,
                              seed=ns.seed)
    print(f"[idc_models_tpu_torch] no IDC data found; using "
          f"{ns.synthetic_examples} synthetic {image_size}x{image_size} "
          f"patches", file=sys.stderr)
    imgs, labels = synthetic.make_idc_like(ns.synthetic_examples,
                                           size=image_size, seed=ns.seed)
    return ArrayDataset(imgs, labels)


def _run_dist(ns):
    from idc_models_tpu_torch import convert, resolve_device
    from idc_models_tpu_torch.configs import get_preset
    from idc_models_tpu_torch.data.idc import train_val_test_split
    from idc_models_tpu_torch.models.pretrained import save_npz
    from idc_models_tpu_torch.observe import JsonlLogger
    from idc_models_tpu_torch.train import losses
    from idc_models_tpu_torch.train.loop import (
        TwoPhaseConfig, evaluate, two_phase_fit,
    )

    device = resolve_device(ns.device)
    preset = _apply_overrides(
        get_preset(ns.preset_key), ns,
        ["batch_size", "lr", "epochs", "fine_tune_epochs", "fine_tune_at"])
    print(f"Device: {device}")
    # the synthetic fallback must yield at least one full batch after the
    # train split, or the Loader rightly refuses to run
    ns.synthetic_examples = max(ns.synthetic_examples, 2 * preset.batch_size)
    ds = _load_idc(ns, preset.image_size, preset.dataset_limit)
    train, val, test = train_val_test_split(ds, seed=ns.seed)
    loss_fn = (losses.binary_cross_entropy if preset.num_outputs == 1
               else losses.sparse_categorical_cross_entropy)

    logger = (JsonlLogger(Path(ns.path) / "logs" / "run.jsonl")
              if ns.path is not None else None)
    try:
        result = two_phase_fit(
            preset.model, preset.num_outputs, train, val,
            TwoPhaseConfig(lr=preset.lr, epochs=preset.epochs,
                           fine_tune_epochs=preset.fine_tune_epochs,
                           batch_size=preset.batch_size,
                           fine_tune_at=preset.fine_tune_at, seed=ns.seed),
            loss_fn=loss_fn,
            build_kwargs={"depthwise_impl": ns.depthwise_impl},
            pretrained_weights=ns.pretrained_weights,
            logger=logger, device=device)
        test_metrics = evaluate(result.model, test, loss_fn,
                                batch_size=preset.batch_size,
                                with_auroc=preset.num_outputs == 1)
        print("test:", " ".join(f"{k}={v:.4f}"
                                for k, v in test_metrics.items()))
        if logger is not None:
            logger.log(event="test", **test_metrics)
            params, state = convert.to_jax(result.model)
            save_npz(Path(ns.path) / "model.npz",
                     {"params": params, "state": state})
    finally:
        if logger is not None:
            logger.close()
