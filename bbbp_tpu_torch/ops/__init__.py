"""Ports of the ``bbbp_tpu.ops`` modules on the screening and training
paths; the kernels' wrappers live in ``bitops``, ``forest`` and
``forest_train``."""
