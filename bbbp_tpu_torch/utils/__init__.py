"""Checkpoints (``checkpoint``) and tracing, NaN checks and step timing
(``profiling``)."""

from bbbp_tpu_torch.utils.checkpoint import restore_checkpoint, save_checkpoint
