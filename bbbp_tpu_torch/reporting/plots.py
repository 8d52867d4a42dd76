"""The reference's full plot suite, as one host-side reporting module.

Reference plots, duplicated into every trainer there, centralized here
(SURVEY.md §2 L5): confusion matrix (Models/model_opt_20250130.py:76-86),
performance bars (:99-116), learning curves (:119-158), 3-D/2-D hyperparameter
scatter (:161-238), regression loss curves / pred-vs-actual / feature
importance / distribution comparison
(Models/multi_input_data_regression_opt_transformer_cnn_20250113.py:211-286,352-384,436-483),
PCA chemical-space scatter (Descriptors/create_descriptors_PCA_classification.py:44+).
Styling follows the reference: serif (Times New Roman when available), dpi=600.

A copy of ``bbbp_tpu/reporting/plots.py`` that draws on the host only.
matplotlib is imported when a function first draws, not with the module
(the card's machine may not have it): a caller that cannot import it gets
the ``ImportError`` and says which files it does not write.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence

import numpy as np

DPI = 600


def _pyplot():
    """matplotlib's pyplot on the Agg backend, styled as the reference."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    plt.rcParams["font.family"] = "serif"
    plt.rcParams["font.serif"] = ["Times New Roman", "DejaVu Serif"]
    return plt


def available() -> bool:
    """Whether matplotlib (and the PIL it draws through) imports here."""
    try:
        _pyplot()
    except ImportError:
        return False
    return True


def skip_note(who: str, directory: str, names) -> str:
    """The one line a pipeline prints for the figures it does not write."""
    return (f"[{who}] matplotlib does not import here: not writing "
            f"{', '.join(names)} in {directory}")


def _save(fig, path: str) -> str:
    plt = _pyplot()
    fig.savefig(path, dpi=DPI, bbox_inches="tight")
    plt.close(fig)
    return path


def confusion_matrix_plot(y_true, y_pred, path: str, labels=("BBB-", "BBB+")) -> str:
    plt = _pyplot()
    y_true = np.asarray(y_true).astype(int)
    y_pred = np.asarray(y_pred).astype(int)
    cm = np.zeros((2, 2), dtype=int)
    for t, p in zip(y_true, y_pred):
        cm[t, p] += 1
    fig, ax = plt.subplots(figsize=(4, 4))
    im = ax.imshow(cm, cmap="Blues")
    for i in range(2):
        for j in range(2):
            ax.text(j, i, str(cm[i, j]), ha="center", va="center",
                    color="black" if cm[i, j] < cm.max() / 2 else "white")
    ax.set_xticks([0, 1], labels)
    ax.set_yticks([0, 1], labels)
    ax.set_xlabel("Predicted")
    ax.set_ylabel("Actual")
    fig.colorbar(im, shrink=0.8)
    return _save(fig, path)


def performance_bar_plot(report: Dict[str, Dict[str, float]], path: str,
                         metrics: Sequence[str] = ("accuracy", "precision",
                                                   "recall", "f1", "roc_auc")) -> str:
    plt = _pyplot()
    models = list(report)
    x = np.arange(len(models))
    width = 0.8 / len(metrics)
    fig, ax = plt.subplots(figsize=(max(6, len(models) * 1.1), 4))
    for i, m in enumerate(metrics):
        vals = [report[k].get(m, np.nan) for k in models]
        ax.bar(x + i * width, vals, width, label=m)
    ax.set_xticks(x + 0.4, models, rotation=45, ha="right")
    ax.set_ylim(0, 1.05)
    ax.legend(fontsize=7)
    ax.set_ylabel("Score")
    return _save(fig, path)


def learning_curve_plot(train_sizes, train_scores, val_scores, path: str,
                        ylabel: str = "Score") -> str:
    plt = _pyplot()
    fig, ax = plt.subplots(figsize=(5, 4))
    ts = np.asarray(train_scores)
    vs = np.asarray(val_scores)
    ax.plot(train_sizes, ts.mean(1) if ts.ndim > 1 else ts, "o-", label="train")
    ax.plot(train_sizes, vs.mean(1) if vs.ndim > 1 else vs, "s-", label="validation")
    if ts.ndim > 1:
        ax.fill_between(train_sizes, ts.mean(1) - ts.std(1), ts.mean(1) + ts.std(1),
                        alpha=0.15)
        ax.fill_between(train_sizes, vs.mean(1) - vs.std(1), vs.mean(1) + vs.std(1),
                        alpha=0.15)
    ax.set_xlabel("Training set size")
    ax.set_ylabel(ylabel)
    ax.legend()
    return _save(fig, path)


def loss_curve_plot(losses, path: str, labels: Optional[List[str]] = None) -> str:
    """Per-fold training loss curves (reference :211-230)."""
    plt = _pyplot()
    losses = np.atleast_2d(np.asarray(losses))
    fig, ax = plt.subplots(figsize=(5, 4))
    for i, row in enumerate(losses):
        ax.plot(row, label=labels[i] if labels else f"fold {i+1}", lw=0.9)
    ax.set_xlabel("Epoch")
    ax.set_ylabel("MSE loss")
    if losses.shape[0] <= 12:
        ax.legend(fontsize=6)
    return _save(fig, path)


def pred_vs_actual_plot(y_true, y_pred, path: str, r2: Optional[float] = None,
                        mse: Optional[float] = None) -> str:
    """Scatter like the reference's stacked_predict_*.png (filename-encoded
    metrics become an annotation)."""
    plt = _pyplot()
    fig, ax = plt.subplots(figsize=(4.5, 4.5))
    ax.scatter(y_true, y_pred, s=8, alpha=0.5, edgecolors="none")
    lo = min(np.min(y_true), np.min(y_pred))
    hi = max(np.max(y_true), np.max(y_pred))
    ax.plot([lo, hi], [lo, hi], "r--", lw=1)
    ax.set_xlabel("Actual logBB")
    ax.set_ylabel("Predicted logBB")
    if r2 is not None:
        ax.set_title(f"$R^2$={r2:.4f}  MSE={mse:.4f}")
    return _save(fig, path)


def distribution_plot(y_true, y_pred, path: str) -> str:
    plt = _pyplot()
    fig, ax = plt.subplots(figsize=(5, 4))
    bins = np.linspace(min(np.min(y_true), np.min(y_pred)),
                       max(np.max(y_true), np.max(y_pred)), 40)
    ax.hist(y_true, bins=bins, alpha=0.5, label="actual", density=True)
    ax.hist(y_pred, bins=bins, alpha=0.5, label="predicted", density=True)
    ax.set_xlabel("logBB")
    ax.set_ylabel("Density")
    ax.legend()
    return _save(fig, path)


def feature_importance_plot(importances, path: str, names=None, top: int = 20) -> str:
    plt = _pyplot()
    imp = np.asarray(importances)
    order = np.argsort(imp)[::-1][:top]
    names = names or [f"f{i}" for i in range(len(imp))]
    fig, ax = plt.subplots(figsize=(5, max(3, top * 0.25)))
    ax.barh(range(len(order)), imp[order][::-1])
    ax.set_yticks(range(len(order)), [names[i] for i in order][::-1], fontsize=6)
    ax.set_xlabel("Importance")
    return _save(fig, path)


def hyperparam_scatter_plot(results: List[Dict], x_key: str, y_key: str,
                            score_key: str, path: str,
                            z_key: Optional[str] = None) -> str:
    """2-D/3-D hyperparameter search scatter (reference :161-238)."""
    plt = _pyplot()
    xs = np.asarray([r[x_key] for r in results], dtype=float)
    ys = np.asarray([r[y_key] for r in results], dtype=float)
    sc = np.asarray([r[score_key] for r in results], dtype=float)
    if z_key is not None:
        zs = np.asarray([r[z_key] for r in results], dtype=float)
        fig = plt.figure(figsize=(5.5, 4.5))
        ax = fig.add_subplot(projection="3d")
        p = ax.scatter(xs, ys, zs, c=sc, cmap="viridis", s=18)
        ax.set_zlabel(z_key)
    else:
        fig, ax = plt.subplots(figsize=(5, 4))
        p = ax.scatter(xs, ys, c=sc, cmap="viridis", s=20)
    ax.set_xlabel(x_key)
    ax.set_ylabel(y_key)
    fig.colorbar(p, label=score_key, shrink=0.8)
    return _save(fig, path)


def hyperparam_search_plots(trials: List[Dict], prefix: str,
                            score_key: str = "mean_accuracy") -> List[str]:
    """Emit the reference's 2-D and 3-D hyperparameter-search scatters
    (Models/model_opt_20250130.py:161-238: plot_3d_hyperparam_search when the
    search space has >=3 numeric dims, plot_2d otherwise) from a trials list.
    Returns the written paths."""
    plt = _pyplot()
    if not trials:
        return []
    num_keys = [k for k in trials[0]
                if not k.startswith("mean_") and k != "repeat_std"
                and isinstance(trials[0][k], (int, float))
                and len({float(t[k]) for t in trials}) > 1]
    out = []
    if len(num_keys) >= 2:
        out.append(hyperparam_scatter_plot(
            trials, num_keys[0], num_keys[1], score_key, prefix + "_2d.png"))
    if len(num_keys) >= 3:
        out.append(hyperparam_scatter_plot(
            trials, num_keys[0], num_keys[1], score_key, prefix + "_3d.png",
            z_key=num_keys[2]))
    if len(num_keys) == 1:
        k = num_keys[0]
        xs = np.asarray([t[k] for t in trials], dtype=float)
        sc = np.asarray([t[score_key] for t in trials], dtype=float)
        fig, ax = plt.subplots(figsize=(5, 4))
        ax.scatter(xs, sc, s=20)
        ax.set_xlabel(k)
        ax.set_ylabel(score_key)
        out.append(_save(fig, prefix + "_1d.png"))
    return out


def shap_dependence_plot(shap_values, features, feature_idx: int, path: str,
                         color_idx: Optional[int] = None,
                         feature_name: Optional[str] = None) -> str:
    """SHAP dependence scatter: feature value vs its attribution, colored by
    the most-interacting other feature (reference shap.dependence_plot usage,
    Models/model_opt_20250130.py:241-349)."""
    plt = _pyplot()
    sv = np.asarray(shap_values)
    x = np.asarray(features)
    xi = x[:, feature_idx]
    yi = sv[:, feature_idx]
    if color_idx is None:
        # pick the feature whose value correlates most with this feature's
        # attribution residual (simple interaction heuristic)
        best, best_c = 0, -1.0
        for j in range(x.shape[1]):
            if j == feature_idx or np.std(x[:, j]) < 1e-12:
                continue
            c = abs(np.corrcoef(x[:, j], yi)[0, 1])
            if np.isfinite(c) and c > best_c:
                best, best_c = j, c
        color_idx = best
    fig, ax = plt.subplots(figsize=(5.2, 4))
    p = ax.scatter(xi, yi, c=x[:, color_idx], cmap="coolwarm", s=14,
                   edgecolors="none")
    ax.set_xlabel(feature_name or f"feature {feature_idx}")
    ax.set_ylabel("SHAP value")
    fig.colorbar(p, label=f"feature {color_idx}", shrink=0.85)
    return _save(fig, path)


def pca_space_plot(coords_2d, labels, path: str, label_names=("BBB-", "BBB+")) -> str:
    """PCA chemical-space scatter colored by class (reference F6/F7)."""
    plt = _pyplot()
    coords_2d = np.asarray(coords_2d)
    labels = np.asarray(labels)
    fig, ax = plt.subplots(figsize=(5, 4.5))
    for val, name, color in zip(sorted(set(labels.tolist())), label_names,
                                ("tab:red", "tab:blue")):
        m = labels == val
        ax.scatter(coords_2d[m, 0], coords_2d[m, 1], s=6, alpha=0.5,
                   label=name, color=color, edgecolors="none")
    ax.set_xlabel("PC1")
    ax.set_ylabel("PC2")
    ax.legend()
    return _save(fig, path)


def shap_summary_plot(shap_values, features, path: str, names=None,
                      top: int = 20) -> str:
    """Beeswarm-style summary of per-feature attributions (reference
    shap_analysis :241-349)."""
    plt = _pyplot()
    sv = np.asarray(shap_values)
    x = np.asarray(features)
    order = np.argsort(np.abs(sv).mean(0))[::-1][:top]
    names = names or [f"f{i}" for i in range(sv.shape[1])]
    fig, ax = plt.subplots(figsize=(6, max(3, top * 0.28)))
    rng = np.random.default_rng(0)
    for row, fi in enumerate(order[::-1]):
        vals = sv[:, fi]
        col = x[:, fi]
        cn = (col - col.min()) / (col.max() - col.min() + 1e-9)
        jitter = rng.normal(0, 0.08, len(vals))
        ax.scatter(vals, row + jitter, c=cn, cmap="coolwarm", s=5,
                   edgecolors="none")
    ax.set_yticks(range(len(order)), [names[i] for i in order[::-1]], fontsize=6)
    ax.axvline(0, color="gray", lw=0.5)
    ax.set_xlabel("Attribution (impact on prediction)")
    return _save(fig, path)
