"""B3DB loaders, the counterparts of ``bbbp_tpu/data/b3db.py``.

Written with the ``csv`` module (the port does not use pandas). The
directory comes from ``BBBP_B3DB_DIR``, read when a loader is called. The
columns, the rows dropped and the labels are the JAX package's: rows whose
``SMILES`` or ``BBB+/BBB-`` (classification) or ``logBB`` (regression) field
is missing (empty, or one of pandas' default missing-value markers) are
dropped, and a label is 1 where the stripped ``BBB+/BBB-`` field is ``BBB+``.
In place of the JAX package's data frame, the two columns that the
transfer path reads, ``logBB`` and ``Inchi``, are kept as lists of the
fields' strings (None where missing or where the TSV has no such column).
"""

from __future__ import annotations

import csv
import os
from dataclasses import dataclass
from typing import List, Optional

import numpy as np

ENV_DIR = "BBBP_B3DB_DIR"
CLASSIFICATION_TSV = "B3DB_classification.tsv"
REGRESSION_TSV = "B3DB_regression.tsv"
REQUIRED = ("SMILES", "BBB+/BBB-", "NO.")
REQUIRED_REGRESSION = ("SMILES", "logBB", "NO.")
# pandas.read_csv's default missing-value strings
MISSING = frozenset({"", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN",
                     "-NaN", "-nan", "1.#IND", "1.#QNAN", "<NA>", "N/A", "NA",
                     "NULL", "NaN", "None", "n/a", "nan", "null"})


@dataclass
class ClassificationData:
    smiles: List[str]
    labels: np.ndarray       # int32 [N], 1 = BBB+, 0 = BBB-
    numbers: np.ndarray      # the `NO.` column, int64 [N]
    logbb: List[Optional[str]]   # the `logBB` fields as written
    inchi: List[Optional[str]]   # the `Inchi` fields as written

    def __len__(self) -> int:
        return len(self.smiles)


@dataclass
class RegressionData:
    smiles: List[str]
    logbb: np.ndarray        # float32 [N]
    numbers: np.ndarray      # the `NO.` column, int64 [N]
    inchi: List[Optional[str]]

    def __len__(self) -> int:
        return len(self.smiles)


def _tsv(name: str) -> str:
    root = os.environ.get(ENV_DIR)
    if not root:
        raise FileNotFoundError(f"set {ENV_DIR} to the directory that holds "
                                f"{name}")
    return os.path.join(root, name)


def classification_tsv() -> str:
    """``$BBBP_B3DB_DIR/B3DB_classification.tsv``; raises when the variable
    is unset."""
    return _tsv(CLASSIFICATION_TSV)


def regression_tsv() -> str:
    """``$BBBP_B3DB_DIR/B3DB_regression.tsv``; raises when the variable is
    unset."""
    return _tsv(REGRESSION_TSV)


def is_numeric(text: Optional[str]) -> bool:
    """Whether ``pandas.to_numeric(errors="coerce")`` gives a number, not
    NaN, for a TSV field: not a missing-value marker, and a decimal literal
    (Python's ``float`` also takes digit-group underscores, pandas does not)."""
    if text is None or text in MISSING or "_" in text:
        return False
    try:
        return not np.isnan(float(text))
    except ValueError:
        return False


def _rows(path: str, required, what: str) -> List[dict]:
    """The TSV's rows whose first two ``required`` fields are present."""
    with open(path, newline="") as f:
        reader = csv.DictReader(f, delimiter="\t")
        missing = set(required) - set(reader.fieldnames or ())
        if missing:
            raise ValueError(f"B3DB {what} TSV missing columns: {missing}")
        # a short row leaves its last fields None: missing too
        return [r for r in reader
                if all((r[c] or "") not in MISSING for c in required[:2])]


def _column(rows: List[dict], name: str) -> List[Optional[str]]:
    return [None if (r.get(name) or "") in MISSING else r[name] for r in rows]


def _numbers(rows: List[dict]) -> np.ndarray:
    return np.array([int(float(r["NO."])) for r in rows], dtype=np.int64)


def load_b3db_classification(path: Optional[str] = None) -> ClassificationData:
    rows = _rows(path or classification_tsv(), REQUIRED, "classification")
    return ClassificationData(
        smiles=[r["SMILES"] for r in rows],
        labels=np.array([r["BBB+/BBB-"].strip() == "BBB+" for r in rows],
                        dtype=np.int32),
        numbers=_numbers(rows),
        logbb=_column(rows, "logBB"),
        inchi=_column(rows, "Inchi"),
    )


def load_b3db_regression(path: Optional[str] = None) -> RegressionData:
    rows = _rows(path or regression_tsv(), REQUIRED_REGRESSION, "regression")
    return RegressionData(
        smiles=[r["SMILES"] for r in rows],
        logbb=np.array([float(r["logBB"]) for r in rows], dtype=np.float32),
        numbers=_numbers(rows),
        inchi=_column(rows, "Inchi"),
    )
