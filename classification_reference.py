#!/usr/bin/env python3
"""The JAX package's classification ensemble on the rows that phase 10 of
``chip_smoke.py`` feeds the PyTorch port, as a reference for its learning
check (``chip_smoke.CLS_JAX_VOTING_AUC``).

    JAX_PLATFORMS=cpu python3 classification_reference.py [--out report.json]

It makes ``bbbp_tpu_torch.testing.classification_inputs()``'s rows with the
JAX package alone (the same ``synthetic_smiles``, Morgan and MACCS bits from
the same C++ featurizer, the same seeded label rule;
``tests/test_torch_classification.py`` holds the two equal), runs
``bbbp_tpu.train.classification.run_classification`` with ``tune=False`` on
them, and prints the report as one JSON line.
"""

from __future__ import annotations

import argparse
import json

import numpy as np

N_MOLECULES, SEED, N_BITS, POSITIVE_SHARE = 7809, 0, 2048, 2 / 3


def inputs(n: int = N_MOLECULES, seed: int = SEED):
    """(MACCS [n, 167] f32, labels [n] int32): each label is 1 where the
    molecule's Morgan bits score above a threshold under a seeded ±1 weight
    vector, two thirds positive, ties broken by a seeded jitter."""
    from bbbp_tpu.chem.featurize import fingerprints
    from bbbp_tpu.data.zinc import synthetic_smiles

    smiles = synthetic_smiles(n, seed=seed)
    morgan = fingerprints(smiles, kind="morgan", n_bits=N_BITS).features
    rng = np.random.default_rng(seed)
    w = rng.choice([-1.0, 1.0], size=N_BITS)
    score = morgan.astype(np.float64) @ w + 0.5 * rng.random(n)
    labels = (score > np.quantile(score, 1 - POSITIVE_SHARE)).astype(np.int32)
    return fingerprints(smiles, kind="maccs").features, labels


def main() -> None:
    from bbbp_tpu.train.classification import (ClassificationTrainConfig,
                                               run_classification)

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    x, y = inputs()
    res = run_classification(ClassificationTrainConfig(tune=False), x, y,
                             verbose=False)
    print(json.dumps(res.report))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(res.report, f, indent=1)


if __name__ == "__main__":
    main()
