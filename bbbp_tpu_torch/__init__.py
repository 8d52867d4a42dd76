"""PyTorch / CUDA port of ``bbbp_tpu``'s virtual-screening path, of the
training of its screening model, of the cross-task transfer features, of
the regression stack's chemistry-kernel estimators, of its flagship
Transformer+CNN regressor with the fold-batched K-fold trainer
(``models/``, ``train/loop.py``; no kernel of their own), and of the
classification ensemble with its searches and the A1 baseline
(``ops/{metrics,linear,resample}.py``, ``train/{search,batched_search,
classification,baseline}.py``; its forests run the trainer's kernels, and
with ``BBBP_FOREST_VMAP=1`` a search's forest trials × folds run as lanes of
``ops/forest_train.py::fit_forest_lanes``), and
of the logBB regression stack (``pipelines/preprocess.py``,
``models/gnn.py``, ``train/regression.py``; its forests and kernel legs run
the trainer's and the similarity kernels), of the remaining model families
(SMILES-BERT, aux pretraining, the dual-branch MLP, the flow classifier),
and of the reporting and utility modules (``reporting/`` attribution and
figures, ``utils/`` checkpoints and profiling, ``parallel/`` meshes on
``torch.distributed`` and prefetch, the CLIs, ``data/curation.py``).

The port runs on one NVIDIA Hopper card (``sm_90a``). Its device kernels
are CUDA C++ under ``csrc/``, built with ``nvcc`` at first use
(``_build.py``); every kernel wrapper runs its plain PyTorch version on CPU
tensors, which is what the CPU tests compare against the JAX package.

This package imports ``torch`` and never ``jax`` or ``bbbp_tpu``: it reuses
the C++ featurizer by compiling ``bbbp_tpu/native/bbbpchem.cpp`` from its
path, and keeps its own copy of the pure-Python featurizer (``chem/``).
"""
