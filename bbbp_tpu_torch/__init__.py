"""PyTorch / CUDA port of the virtual-screening path of ``bbbp_tpu``.

The port runs on one NVIDIA Hopper card (``sm_90a``). Its two device kernels
are CUDA C++ under ``csrc/``, built with ``nvcc`` at first use
(``_build.py``); every kernel wrapper runs its plain PyTorch version on CPU
tensors, which is what the CPU tests compare against the JAX package.

This package imports ``torch`` and never ``jax`` or ``bbbp_tpu``: it reuses
the C++ featurizer by compiling ``bbbp_tpu/native/bbbpchem.cpp`` from its
path.
"""
