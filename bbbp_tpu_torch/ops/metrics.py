"""Evaluation metrics, the counterpart of ``bbbp_tpu/ops/metrics.py``.

Classification: the eight metrics of the reference's ``evaluate_model``
(accuracy, precision, recall, F1, balanced accuracy, MCC, Cohen's kappa,
ROC AUC by the rank statistic with average ranks over ties). Regression:
MSE and R². Each computes in f32 on the device of its tensor arguments
(numpy arrays land on the CPU) and returns a 0-d tensor; the reports
return Python floats.
"""

from __future__ import annotations

from typing import Dict

import torch


def _f32(a, like=None) -> torch.Tensor:
    dev = like.device if isinstance(like, torch.Tensor) else None
    return torch.as_tensor(a, device=dev).to(torch.float32)


def _confusion(y_true, y_pred):
    y_true = _f32(y_true, y_pred)
    y_pred = _f32(y_pred, y_true)
    tp = torch.sum(y_true * y_pred)
    tn = torch.sum((1 - y_true) * (1 - y_pred))
    fp = torch.sum((1 - y_true) * y_pred)
    fn = torch.sum(y_true * (1 - y_pred))
    return tp, tn, fp, fn


def _floor(t: torch.Tensor, low: float) -> torch.Tensor:
    return torch.clamp(t, min=low)


def accuracy(y_true, y_pred):
    y_true, y_pred = torch.as_tensor(y_true), torch.as_tensor(y_pred)
    return (y_true.to(y_pred.device) == y_pred).to(torch.float32).mean()


def precision(y_true, y_pred):
    tp, tn, fp, fn = _confusion(y_true, y_pred)
    return tp / _floor(tp + fp, 1e-12)


def recall(y_true, y_pred):
    tp, tn, fp, fn = _confusion(y_true, y_pred)
    return tp / _floor(tp + fn, 1e-12)


def f1_score(y_true, y_pred):
    p = precision(y_true, y_pred)
    r = recall(y_true, y_pred)
    return 2 * p * r / _floor(p + r, 1e-12)


def balanced_accuracy(y_true, y_pred):
    tp, tn, fp, fn = _confusion(y_true, y_pred)
    tpr = tp / _floor(tp + fn, 1e-12)
    tnr = tn / _floor(tn + fp, 1e-12)
    return 0.5 * (tpr + tnr)


def mcc(y_true, y_pred):
    tp, tn, fp, fn = _confusion(y_true, y_pred)
    num = tp * tn - fp * fn
    den = torch.sqrt(_floor((tp + fp) * (tp + fn) * (tn + fp) * (tn + fn), 1e-12))
    return num / den


def cohen_kappa(y_true, y_pred):
    tp, tn, fp, fn = _confusion(y_true, y_pred)
    n = tp + tn + fp + fn
    po = (tp + tn) / _floor(n, 1e-12)
    pe = ((tp + fp) * (tp + fn) + (tn + fn) * (tn + fp)) / _floor(n * n, 1e-12)
    return (po - pe) / _floor(1 - pe, 1e-12)


def roc_auc(y_true, y_score):
    """Mann-Whitney U / rank statistic; tied scores share their average
    rank."""
    y_score = _f32(y_score, y_true)
    y_true = _f32(y_true, y_score)
    n = y_score.shape[0]
    dev = y_score.device
    order = torch.argsort(y_score, stable=True)
    sorted_scores = y_score[order]
    ranks_ord = torch.arange(1, n + 1, dtype=torch.float32, device=dev)
    is_new = torch.ones(n, dtype=torch.float32, device=dev)
    is_new[1:] = (sorted_scores[1:] != sorted_scores[:-1]).to(torch.float32)
    group_id = (torch.cumsum(is_new, 0) - 1).long()
    group_sum = torch.zeros(n, device=dev).index_add_(0, group_id, ranks_ord)
    group_cnt = torch.zeros(n, device=dev).index_add_(0, group_id,
                                                      torch.ones(n, device=dev))
    avg_ranks = (group_sum / _floor(group_cnt, 1.0))[group_id]
    ranks = torch.zeros(n, device=dev)
    ranks[order] = avg_ranks
    n_pos = torch.sum(y_true)
    n_neg = n - n_pos
    sum_pos = torch.sum(ranks * y_true)
    u = sum_pos - n_pos * (n_pos + 1) / 2
    return u / _floor(n_pos * n_neg, 1e-12)


def mse(y_true, y_pred):
    y_true = _f32(y_true, y_pred)
    y_pred = _f32(y_pred, y_true)
    return torch.mean((y_true - y_pred) ** 2)


def r2_score(y_true, y_pred):
    y_true = _f32(y_true, y_pred)
    y_pred = _f32(y_pred, y_true)
    ss_res = torch.sum((y_true - y_pred) ** 2)
    ss_tot = torch.sum((y_true - torch.mean(y_true)) ** 2)
    return 1.0 - ss_res / _floor(ss_tot, 1e-12)


def classification_report(y_true, y_pred, y_score=None) -> Dict[str, float]:
    """The reference's 8-metric set (Models/model_opt_20250130.py:66-97)."""
    out = {
        "accuracy": float(accuracy(y_true, y_pred)),
        "precision": float(precision(y_true, y_pred)),
        "recall": float(recall(y_true, y_pred)),
        "f1": float(f1_score(y_true, y_pred)),
        "balanced_accuracy": float(balanced_accuracy(y_true, y_pred)),
        "mcc": float(mcc(y_true, y_pred)),
        "cohen_kappa": float(cohen_kappa(y_true, y_pred)),
    }
    if y_score is not None:
        out["roc_auc"] = float(roc_auc(y_true, y_score))
    return out


def regression_report(y_true, y_pred) -> Dict[str, float]:
    return {"mse": float(mse(y_true, y_pred)), "r2": float(r2_score(y_true, y_pred))}
