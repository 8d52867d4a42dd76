""".smi readers, chunking, the ZINC acquisition helpers and the synthetic
drug-like SMILES generator.

Counterparts of everything in ``bbbp_tpu/data/zinc.py``: the readers
(``iter_smi_file``, ``iter_smi_dir``, ``chunked``), the downloader script
parser ``parse_wget_list`` (the reference's D13), the per-ID downloader
``ZINC_FORMATS``, ``zinc_substance_url``, ``download_molecule`` and the
threaded bulk fetch ``download_dataset`` (D12), and ``synthetic_smiles``.
The acquisition helpers are copies with the same behaviour: the ID echo
check, ``None`` on any fetch error, ``2 × cpu`` workers, a ``ZINC_ID,SMILES``
CSV in completion order. ``urllib.request`` is imported only when a molecule
is fetched. The generator keeps the same fragment grammar and the same
``random.Random(seed)`` draws, and validates candidates with the C++
parser's bad flags instead of the Python parser; both accept the same
candidates, so it returns the same list as the JAX package's version.
"""

from __future__ import annotations

import csv
import os
import random
from concurrent.futures import ThreadPoolExecutor, as_completed
from typing import Iterable, Iterator, List, Optional, Sequence, Tuple

from bbbp_tpu_torch.native.bindings import fingerprints_packed


def iter_smi_file(path: str) -> Iterator[Tuple[str, str]]:
    """Yield (smiles, id) from a .smi file (whitespace-separated, optional
    header line starting with 'smiles')."""
    with open(path) as f:
        for line in f:
            parts = line.strip().split()
            if not parts:
                continue
            if parts[0].lower() in ("smiles", "smile"):
                continue
            yield parts[0], (parts[1] if len(parts) > 1 else "")


def iter_smi_dir(path: str) -> Iterator[Tuple[str, str]]:
    """Walk a directory of .smi tranches in sorted file order."""
    for root, _, files in os.walk(path):
        for fn in sorted(files):
            if fn.endswith(".smi"):
                yield from iter_smi_file(os.path.join(root, fn))


def chunked(it: Iterable, size: int) -> Iterator[List]:
    buf: List = []
    for x in it:
        buf.append(x)
        if len(buf) >= size:
            yield buf
            buf = []
    if buf:
        yield buf


def parse_wget_list(path: str) -> List[str]:
    """Extract tranche URLs from a ZINC downloader wget script (D13)."""
    urls = []
    with open(path) as f:
        for line in f:
            for tok in line.split():
                tok = tok.strip("\"'")
                if tok.startswith("http://") or tok.startswith("https://"):
                    urls.append(tok)
    return urls


ZINC_FORMATS = ("smi", "sdf", "csv", "xml", "json")


def zinc_substance_url(zinc_id: str, fmt: str = "smi") -> str:
    zid = zinc_id.strip().upper()
    if not zid.startswith("ZINC"):
        zid = f"ZINC{int(zid):012d}"
    return f"https://zinc15.docking.org/substances/{zid}.{fmt}"


def download_molecule(zinc_id: str, fmt: str = "smi",
                      timeout: float = 10.0) -> Optional[Tuple[str, str]]:
    """Fetch one substance; validates the ID echo like the reference
    (zinc_download.py:19-28). Returns (zinc_id, smiles) or None."""
    import urllib.request

    url = zinc_substance_url(zinc_id, fmt)
    try:
        with urllib.request.urlopen(url, timeout=timeout) as r:
            body = r.read().decode("utf-8", "replace").strip()
    except Exception:
        return None
    parts = body.split()
    if len(parts) >= 2 and parts[1].upper().startswith("ZINC"):
        return parts[1], parts[0]
    return None


def download_dataset(zinc_ids: Sequence[str], out_csv: str = "zinc_dataset.csv",
                     fmt: str = "smi", workers: Optional[int] = None) -> int:
    """Threaded bulk fetch (reference uses ThreadPoolExecutor(2×cpu),
    zinc_download.py:85-94); writes ZINC_ID,SMILES rows; returns count."""
    workers = workers or 2 * (os.cpu_count() or 1)
    n = 0
    with ThreadPoolExecutor(max_workers=workers) as ex, open(out_csv, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["ZINC_ID", "SMILES"])
        futs = {ex.submit(download_molecule, z, fmt): z for z in zinc_ids}
        for fut in as_completed(futs):
            res = fut.result()
            if res is not None:
                w.writerow(res)
                n += 1
    return n


_CORES = [
    "c1ccccc1", "c1ccncc1", "c1ccc2ccccc2c1", "c1cnc2[nH]ccc2c1", "C1CCNCC1",
    "C1CCOCC1", "c1ccsc1", "c1ccoc1", "c1cnco1", "c1cncs1", "C1CCCCC1",
    "c1cc2ccccc2[nH]1", "c1nccn1C", "C1CNCCN1", "c1ccc(cc1)O", "c1ncncn1",
]
_LINKERS = ["", "C", "CC", "CCC", "C(=O)", "C(=O)N", "OC", "NC", "S(=O)(=O)",
            "C=C", "CNC", "COC", "N(C)C"]
_CAPS = ["C", "CC", "O", "N", "F", "Cl", "Br", "C(F)(F)F", "OC", "N(C)C",
         "C#N", "C(=O)O", "C(=O)OC", "CO", "CN", "S", "OCC", "NCC"]


def _draw(rng: random.Random) -> str:
    s = rng.choice(_CORES)
    if rng.random() < 0.7:
        s = s + rng.choice(_LINKERS) + rng.choice(_CORES)
    for _ in range(rng.randint(0, 3)):
        cap = rng.choice(_CAPS)
        s = s + cap if rng.random() < 0.3 else cap + s
    return s


def synthetic_smiles(n: int, seed: int = 0, validate: bool = True) -> List[str]:
    """Generate n drug-like SMILES: core [+linker+core] + substituents.

    Candidates are drawn in batches and the valid ones kept in draw order,
    which is the order the one-at-a-time loop of the JAX package keeps."""
    rng = random.Random(seed)
    out: List[str] = []
    while len(out) < n:
        batch = [_draw(rng) for _ in range(max(n - len(out), 64))]
        if validate:
            bad = set(fingerprints_packed(batch)[1])
            batch = [s for i, s in enumerate(batch) if i not in bad]
        out.extend(batch[: n - len(out)])
    return out
