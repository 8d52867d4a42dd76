"""B3DB classification loader, the counterpart of
``bbbp_tpu/data/b3db.py::load_b3db_classification``.

Written with the ``csv`` module (the card's machine has no pandas). The
directory comes from ``BBBP_B3DB_DIR``, read when the loader is called. The
columns, the rows dropped and the labels are the JAX package's: rows whose
``SMILES`` or ``BBB+/BBB-`` field is missing (empty, or one of pandas'
default missing-value markers) are dropped, and a label is 1 where the
stripped ``BBB+/BBB-`` field is ``BBB+``.
"""

from __future__ import annotations

import csv
import os
from dataclasses import dataclass
from typing import List, Optional

import numpy as np

ENV_DIR = "BBBP_B3DB_DIR"
CLASSIFICATION_TSV = "B3DB_classification.tsv"
REQUIRED = ("SMILES", "BBB+/BBB-", "NO.")
# pandas.read_csv's default missing-value strings
MISSING = frozenset({"", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN",
                     "-NaN", "-nan", "1.#IND", "1.#QNAN", "<NA>", "N/A", "NA",
                     "NULL", "NaN", "None", "n/a", "nan", "null"})


@dataclass
class ClassificationData:
    smiles: List[str]
    labels: np.ndarray       # int32 [N], 1 = BBB+, 0 = BBB-
    numbers: np.ndarray      # the `NO.` column, int64 [N]

    def __len__(self) -> int:
        return len(self.smiles)


def classification_tsv() -> str:
    """``$BBBP_B3DB_DIR/B3DB_classification.tsv``; raises when the variable
    is unset."""
    root = os.environ.get(ENV_DIR)
    if not root:
        raise FileNotFoundError(f"set {ENV_DIR} to the directory that holds "
                                f"{CLASSIFICATION_TSV}")
    return os.path.join(root, CLASSIFICATION_TSV)


def load_b3db_classification(path: Optional[str] = None) -> ClassificationData:
    path = path or classification_tsv()
    with open(path, newline="") as f:
        reader = csv.DictReader(f, delimiter="\t")
        missing = set(REQUIRED) - set(reader.fieldnames or ())
        if missing:
            raise ValueError(f"B3DB classification TSV missing columns: {missing}")
        # a short row leaves its last fields None: missing too
        rows = [r for r in reader if (r["SMILES"] or "") not in MISSING
                and (r["BBB+/BBB-"] or "") not in MISSING]
    return ClassificationData(
        smiles=[r["SMILES"] for r in rows],
        labels=np.array([r["BBB+/BBB-"].strip() == "BBB+" for r in rows],
                        dtype=np.int32),
        numbers=np.array([int(float(r["NO."])) for r in rows], dtype=np.int64),
    )
