"""Metrics persistence: per-model CSVs and JSONL step logs, a copy of
``bbbp_tpu/reporting/metrics_io.py``.

Mirrors the reference's artifacts: ``model_performance_metrics*.csv``
(reference: Models/model_opt_20250130.py:669-670, committed examples under
Descriptors/output/) and the learning-score CSVs (:151-158), plus a
structured JSONL step log (the reference's equivalent is print()s —
SURVEY.md §5 metrics/logging).
"""

from __future__ import annotations

import csv
import json
import time
from typing import Dict, Optional


def write_metrics_csv(path: str, report: Dict[str, Dict[str, float]],
                      metric_order=None) -> None:
    """rows = models, columns = metrics (reference CSV layout)."""
    if not report:
        return
    metrics = metric_order or sorted({k for r in report.values() for k in r})
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["Model"] + list(metrics))
        for model, r in report.items():
            w.writerow([model] + [f"{r.get(m, float('nan')):.4f}" for m in metrics])


def write_trials_csv(path: str, trials) -> None:
    """Hyperparameter-search trial records → CSV (reference learning-scores
    CSV convention, Models/model_opt_20250130.py:151-158)."""
    if not trials:
        return
    keys = list(trials[0].keys())
    with open(path, "w", newline="") as f:
        w = csv.writer(f)          # quotes tuple-valued params (mlp hidden)
        w.writerow(keys)
        for t in trials:
            w.writerow([t.get(k, "") for k in keys])


def append_jsonl(path: str, record: Dict, add_time: bool = True) -> None:
    if add_time:
        record = {"t": time.time(), **record}
    with open(path, "a") as f:
        f.write(json.dumps(record) + "\n")


def read_metrics_csv(path: str) -> Dict[str, Dict[str, float]]:
    out: Dict[str, Dict[str, float]] = {}
    with open(path) as f:
        r = csv.reader(f)
        header = next(r)
        for row in r:
            out[row[0]] = {h: float(v) for h, v in zip(header[1:], row[1:])}
    return out
