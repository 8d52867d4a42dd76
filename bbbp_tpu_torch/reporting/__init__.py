"""Reporting: metrics persistence (``metrics_io``). The plots and the
attribution of the JAX package's ``reporting/`` are not ported yet."""

from bbbp_tpu_torch.reporting.metrics_io import append_jsonl, write_metrics_csv
