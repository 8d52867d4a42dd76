"""Reporting: metrics persistence (``metrics_io``), the figures
(``plots``, matplotlib imported when a figure is drawn) and attribution
(``attribution``: TreeSHAP, kernel SHAP, integrated gradients)."""

from bbbp_tpu_torch.reporting.metrics_io import append_jsonl, write_metrics_csv
