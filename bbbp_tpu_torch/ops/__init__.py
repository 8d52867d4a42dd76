"""Ports of the ``bbbp_tpu.ops`` modules on the screening path; the kernels
live in ``bitops`` and ``forest``."""
