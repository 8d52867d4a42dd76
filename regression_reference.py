#!/usr/bin/env python3
"""The JAX package's regression stack on the rows that phase 11 of
``chip_smoke.py`` feeds the PyTorch port, as a reference for its learning
check (``chip_smoke.REG_JAX_STACKED_R2``).

    JAX_PLATFORMS=cpu python3 regression_reference.py [--out report.json]

It makes ``bbbp_tpu_torch.testing.regression_molecules()``'s 1,058
molecules and target with the JAX package alone (the same
``synthetic_smiles``, MACCS bits from the same C++ featurizer, the same
seeded target rule; ``tests/test_torch_regression.py`` holds the two
equal), writes them to a B3DB-format TSV, runs
``bbbp_tpu.pipelines.preprocess.preprocess_regression`` on it as
``run_regression`` would, then ``bbbp_tpu.train.regression.run_regression``
at ``RegressionTrainConfig()``'s defaults with phase 11's cuts (``CUTS``),
and prints the report as one JSON line. On an 8-core CPU it ran 2.2 hours
(7,897 s): the NN leg's bf16 convolutions over 10 vmapped folds take ~30
minutes an epoch there, which is why phase 11 cuts the NN to 3 epochs and
the MPNN to 12.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import numpy as np

N_MOLECULES, SEED = 1058, 1
# phase 11's depth: one seed replica of every leg, the NN's 50 epochs cut to
# 3 (snapshots from epoch 2, 30 of 50 scaled), the MPNN's 100 to 12
CUTS = dict(nn_seeds=1, graph_seeds=1, tree_seeds=1, epochs=3,
            snapshot_from=2, graph_epochs=12)


def molecules(n: int = N_MOLECULES, seed: int = SEED):
    """(SMILES, f32 target): a seeded random linear score of the MACCS
    bits, standardized, plus N(0, 0.3²) noise."""
    from bbbp_tpu.chem.featurize import fingerprints
    from bbbp_tpu.data.zinc import synthetic_smiles

    smiles = synthetic_smiles(n, seed=seed)
    x = fingerprints(smiles, kind="maccs").features
    rng = np.random.default_rng(seed)
    score = x.astype(np.float64) @ rng.normal(size=x.shape[1])
    score = (score - score.mean()) / max(score.std(), 1e-12)
    return smiles, (score + rng.normal(0, 0.3, n)).astype(np.float32)


def write_tsv(path: str, smiles, y) -> None:
    """A B3DB regression TSV (``NO.``, ``SMILES``, ``logBB``); each target
    written so that it reads back as the same f32."""
    with open(path, "w") as f:
        f.write("NO.\tSMILES\tlogBB\n")
        for i, (s, v) in enumerate(zip(smiles, y)):
            f.write(f"{i + 1}\t{s}\t{float(np.float32(v))!r}\n")


def main() -> None:
    from bbbp_tpu.pipelines.preprocess import (PreprocessConfig,
                                               preprocess_regression)
    from bbbp_tpu.train.regression import RegressionTrainConfig, run_regression

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    cfg = RegressionTrainConfig(**CUTS)
    t0 = time.time()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "B3DB_regression.tsv")
        write_tsv(path, *molecules())
        data = preprocess_regression(PreprocessConfig(
            fp_kind=cfg.fp_kind, image_size=cfg.image_size, workers=cfg.workers,
            seed=cfg.seed, tsv_path=path))
    t_pre = time.time() - t0
    res = run_regression(cfg, data=data, verbose=True)
    out = {"report": res.report, "rows": int(len(res.y)),
           "preprocess_s": t_pre, "run_s": res.wall_time_s, "cuts": CUTS}
    print(json.dumps(out))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)


if __name__ == "__main__":
    main()
