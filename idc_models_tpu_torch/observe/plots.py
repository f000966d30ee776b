"""Training-curve plot artifact.

Parity with the reference's `log()` (SURVEY.md C18,
dist_model_tf_vgg.py:67-101): concatenate phase-1 + phase-2 accuracy/loss
histories, draw a 2-panel figure with a "Start Fine Tuning" marker at the
phase boundary, and save it to `<path>/logs/plot_dev<N>.png`. The raw
history dicts are printed by the caller (the reference prints them at
dist_model_tf_vgg.py:100-101); the jsonl log carries the same numbers in
structured form.
"""

from __future__ import annotations

import os
from pathlib import Path


def plot_history(path: str | os.PathLike, history: dict,
                 history_fine: dict | None, num_devices: int,
                 *, initial_epochs: int | None = None) -> str:
    """Save the 2-panel acc/loss figure; returns the written file path."""
    # Force the headless backend BEFORE this function's pyplot import:
    # on a display-less CI container an interactive default backend
    # raises at pyplot import time. The env var (honored at matplotlib
    # import) + use(force=True) (re-selects even if someone imported
    # pyplot first) together make plotting display-independent —
    # scoped HERE, not at module import, so merely importing the
    # library never mutates the process environment for an embedding
    # application's own matplotlib use. setdefault keeps an explicit
    # user choice.
    os.environ.setdefault("MPLBACKEND", "Agg")
    import matplotlib

    matplotlib.use("Agg", force=True)
    import matplotlib.pyplot as plt

    acc = list(history.get("accuracy", []))
    val_acc = list(history.get("val_accuracy", []))
    loss = list(history.get("loss", []))
    val_loss = list(history.get("val_loss", []))
    boundary = initial_epochs if initial_epochs is not None else len(acc)
    if history_fine:
        acc += list(history_fine.get("accuracy", []))
        val_acc += list(history_fine.get("val_accuracy", []))
        loss += list(history_fine.get("loss", []))
        val_loss += list(history_fine.get("val_loss", []))

    out_dir = Path(path) / "logs"
    out_dir.mkdir(parents=True, exist_ok=True)
    out = out_dir / f"plot_dev{num_devices}.png"

    fig, (ax1, ax2) = plt.subplots(2, 1, figsize=(8, 8))
    ax1.plot(acc, label="Training Accuracy")
    ax1.plot(val_acc, label="Validation Accuracy")
    if history_fine:
        ax1.axvline(boundary - 0.5, color="k", linestyle="--",
                    label="Start Fine Tuning")
    ax1.legend(loc="lower right")
    ax1.set_title("Training and Validation Accuracy")

    ax2.plot(loss, label="Training Loss")
    ax2.plot(val_loss, label="Validation Loss")
    if history_fine:
        ax2.axvline(boundary - 0.5, color="k", linestyle="--",
                    label="Start Fine Tuning")
    ax2.legend(loc="upper right")
    ax2.set_title("Training and Validation Loss")
    ax2.set_xlabel("epoch")

    fig.savefig(out, dpi=100, bbox_inches="tight")
    plt.close(fig)
    return str(out)
