"""PyTorch / CUDA port of ``bbbp_tpu``'s virtual-screening path, of the
training of its screening model, of the cross-task transfer features and of
the regression stack's chemistry-kernel estimators.

The port runs on one NVIDIA Hopper card (``sm_90a``). Its device kernels
are CUDA C++ under ``csrc/``, built with ``nvcc`` at first use
(``_build.py``); every kernel wrapper runs its plain PyTorch version on CPU
tensors, which is what the CPU tests compare against the JAX package.

This package imports ``torch`` and never ``jax`` or ``bbbp_tpu``: it reuses
the C++ featurizer by compiling ``bbbp_tpu/native/bbbpchem.cpp`` from its
path, and keeps its own copy of the pure-Python featurizer (``chem/``).
"""
