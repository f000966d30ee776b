"""Metrics on device: accuracy, binary accuracy, AUROC.

The counterparts of ``idc_models_tpu/train/metrics.py``: classifier
logits ([B, C>1] multiclass, [B, 1] or [B] binary) and LM logits
([B, T, V]).
"""

from __future__ import annotations

import torch


def accuracy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Multiclass accuracy; logits [B,C], integer labels [B]."""
    return (logits.argmax(-1) == labels).float().mean()


def binary_accuracy(logits: torch.Tensor, labels: torch.Tensor,
                    threshold: float = 0.0) -> torch.Tensor:
    """Binary accuracy on logits (threshold 0 == probability 0.5)."""
    pred = logits.reshape(-1) > threshold
    return (pred == (labels.reshape(-1) > 0.5)).float().mean()


def auto_accuracy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Keras ``metrics=['accuracy']``: multiclass for [B, C>1] logits,
    binary otherwise. Sequence logits [B, T, V] with token labels [B, T]
    (the LM) score shifted next-token accuracy, as ``next_token_loss``
    trains; soft labels [B, T, V] (teacher logits) score unshifted
    greedy agreement, since both sides' position t predict token t+1."""
    if logits.dim() == 3 and logits.shape[-1] > 1:
        if labels.dim() == 3:
            return (logits.argmax(-1) == labels.argmax(-1)).float().mean()
        pred = logits[:, :-1].argmax(-1)
        return (pred == labels[:, 1:].to(pred.dtype)).float().mean()
    if logits.dim() == 2 and logits.shape[-1] > 1:
        return accuracy(logits, labels)
    return binary_accuracy(logits, labels)


def auroc(scores: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """AUROC via the rank-sum (Mann-Whitney U) identity, ties given their
    average rank; NaN when one class is absent."""
    scores = scores.reshape(-1).float()
    labels = (labels.reshape(-1) > 0.5).float()
    n = scores.shape[0]
    order = torch.argsort(scores, stable=True)
    s = scores[order]
    lab = labels[order]
    idx = torch.arange(n, dtype=torch.float32, device=scores.device)
    is_new = torch.ones(n, dtype=torch.bool, device=scores.device)
    is_new[1:] = s[1:] != s[:-1]
    group = torch.cumsum(is_new.long(), 0) - 1
    group_sum = torch.zeros(n, device=scores.device).index_add_(0, group, idx)
    group_cnt = torch.zeros(n, device=scores.device).index_add_(
        0, group, torch.ones_like(idx))
    avg_rank = (group_sum / group_cnt.clamp(min=1.0))[group] + 1.0
    n_pos = lab.sum()
    n_neg = n - n_pos
    u = (avg_rank * lab).sum() - n_pos * (n_pos + 1.0) / 2.0
    denom = (n_pos * n_neg).clamp(min=1.0)
    nan = torch.full((), float("nan"), device=scores.device)
    return torch.where((n_pos == 0) | (n_neg == 0), nan, u / denom)
