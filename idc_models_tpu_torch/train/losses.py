"""Loss functions (from logits), as the JAX package's ``train/losses.py``."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def binary_cross_entropy(logits: torch.Tensor,
                         labels: torch.Tensor) -> torch.Tensor:
    """BCE from logits; logits [B,1] or [B], labels [B] in {0,1}
    (Keras ``BinaryCrossentropy(from_logits=True)``)."""
    logits = logits.reshape(-1)
    labels = labels.reshape(-1).to(logits.dtype)
    return F.binary_cross_entropy_with_logits(logits, labels)


def sparse_categorical_cross_entropy(logits: torch.Tensor,
                                     labels: torch.Tensor) -> torch.Tensor:
    """Softmax CE against integer labels."""
    return F.cross_entropy(logits, labels.long())
