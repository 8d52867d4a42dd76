"""Ports of the ``bbbp_tpu.ops`` modules on the screening, training,
classification and regression paths; the kernels' wrappers live in ``bitops``, ``forest``,
``forest_train`` and ``similarity``."""
