"""Tracing / profiling / debug hooks, the counterpart of
``bbbp_tpu/utils/profiling.py`` (SURVEY.md §5 aux subsystems).

The reference has only epoch-time prints; here: a ``torch.profiler`` trace
context (CPU and CUDA activity, CPU alone where there is no card) that
writes a Chrome trace, a per-step timer with JSONL export, and a NaN check
that fails fast, as ``jax_debug_nans`` does: a ``TorchDispatchMode`` that
raises ``FloatingPointError`` at the first operator whose floating output
holds a NaN, forward or backward (``torch.autograd.set_detect_anomaly``
alone checks the backward only).
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Iterator, List, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode

# operators whose output is uninitialised memory by design, not a result
_UNINITIALISED = ("empty", "empty_like", "empty_strided", "new_empty",
                  "new_empty_strided", "resize_", "set_")


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """Profile the block; its Chrome trace goes to ``log_dir``
    (``trace_<pid>_<ns>.json``, viewable in Perfetto or chrome://tracing).
    Yields the profiler (``key_averages()`` for sums by kernel)."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(
        log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


def _has_nan(t) -> bool:
    return (isinstance(t, torch.Tensor) and (t.is_floating_point() or t.is_complex())
            and t.numel() > 0 and bool(torch.isnan(t).any()))


class NaNCheck(TorchDispatchMode):
    """Raise ``FloatingPointError`` at the first operator whose floating
    output holds a NaN."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.__name__.split(".")[0] not in _UNINITIALISED:
            leaves = out if isinstance(out, (tuple, list)) else (out,)
            if any(_has_nan(t) for t in leaves):
                raise FloatingPointError(f"NaN in the output of {func}")
        return out


@contextlib.contextmanager
def debug_nans(enable: bool = True) -> Iterator[None]:
    """NaN-fail-fast mode (the functional runtime's sanitizer). Autograd
    carries the mode into its backward threads, so a NaN made in a backward
    operator raises too."""
    if not enable:
        yield
        return
    with NaNCheck():
        yield


def _block(out) -> None:
    """Wait for the devices of the CUDA tensors in ``out``."""
    if isinstance(out, torch.Tensor):
        if out.is_cuda:
            torch.cuda.synchronize(out.device)
    elif isinstance(out, dict):
        for v in out.values():
            _block(v)
    elif isinstance(out, (list, tuple)):
        for v in out:
            _block(v)


class StepTimer:
    """Wall-clock step timing with blocking, JSONL-exportable."""

    def __init__(self, jsonl_path: Optional[str] = None):
        self.records: List[Dict] = []
        self.jsonl_path = jsonl_path

    @contextlib.contextmanager
    def step(self, name: str, **meta) -> Iterator[None]:
        t0 = time.perf_counter()
        yield
        dt = time.perf_counter() - t0
        rec = {"name": name, "seconds": dt, **meta}
        self.records.append(rec)
        if self.jsonl_path:
            from bbbp_tpu_torch.reporting.metrics_io import append_jsonl

            append_jsonl(self.jsonl_path, rec)

    def timed(self, name: str, fn, *args, block: bool = True, **meta):
        """``fn(*args)`` timed; with ``block`` the time includes the device
        work of the CUDA tensors it returns."""
        t0 = time.perf_counter()
        out = fn(*args)
        if block:
            _block(out)
        dt = time.perf_counter() - t0
        rec = {"name": name, "seconds": dt, **meta}
        self.records.append(rec)
        if self.jsonl_path:
            from bbbp_tpu_torch.reporting.metrics_io import append_jsonl

            append_jsonl(self.jsonl_path, rec)
        return out

    def summary(self) -> Dict[str, float]:
        out: Dict[str, List[float]] = {}
        for r in self.records:
            out.setdefault(r["name"], []).append(r["seconds"])
        return {k: sum(v) / len(v) for k, v in out.items()}
