"""Package hygiene of the PyTorch port: it runs where JAX is absent, its
data generator matches the JAX package's, and it never falls back to the CPU
when asked for CUDA."""

import os
import re
import shutil
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "bbbp_tpu_torch")

_IMPORT_ALL = """
import pkgutil, importlib, sys
import bbbp_tpu_torch
names = [m.name for m in pkgutil.walk_packages(bbbp_tpu_torch.__path__, "bbbp_tpu_torch.")]
for name in names:
    importlib.import_module(name)
leaked = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "bbbp_tpu", "flax", "optax",
                                       "pandas"))
print(len(names), leaked)
"""


# the modules of the last slice: attribution, figures, checkpoints,
# profiling, the mesh, the CLIs and curation
SLICE_H = ["reporting.attribution", "reporting.plots", "chem.highlight", "utils",
           "utils.checkpoint", "utils.profiling", "parallel", "parallel.mesh",
           "parallel.prefetch", "pipelines.featurize", "pipelines.analyze",
           "pipelines.chemspace", "data.curation", "entry",
           "pipelines.screen_ensemble", "pipelines.train_baseline",
           "pipelines.train_bert", "pipelines.train_classify",
           "pipelines.train_flow", "pipelines.train_regress"]

# imports each module alone (what it adds to sys.modules after torch and
# numpy, removed again before the next) and prints what of the refused
# packages each loaded
_IMPORT_ALONE = """
import importlib, json, sys
import numpy, torch
base = set(sys.modules)
refused = ("jax", "jaxlib", "bbbp_tpu", "flax", "optax", "pandas", "matplotlib", "PIL")
out = {}
for name in sys.argv[1:]:
    importlib.import_module("bbbp_tpu_torch." + name)
    added = set(sys.modules) - base
    out[name] = sorted(m for m in added if m.split(".")[0] in refused)
    for m in added:
        del sys.modules[m]
print(json.dumps(out))
"""


def _py(*args, cwd=REPO, **env):
    return subprocess.run([sys.executable, *args], cwd=cwd, capture_output=True,
                          text=True, timeout=120, env={**os.environ, **env})


def test_importing_every_module_loads_neither_jax_nor_bbbp_tpu():
    proc = _py("-c", _IMPORT_ALL)
    assert proc.returncode == 0, proc.stderr
    n_modules, leaked = proc.stdout.split(" ", 1)
    assert int(n_modules) >= 30        # chem, data, native, ops, pipelines, train
    assert leaked.strip() == "[]"


def test_sources_import_neither_jax_nor_bbbp_tpu():
    pattern = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|bbbp_tpu|pandas|flax|optax)\b",
                         re.M)
    for root, _, files in os.walk(PKG):
        for fn in files:
            if fn.endswith(".py"):
                with open(os.path.join(root, fn)) as f:
                    assert not pattern.search(f.read()), fn
    with open(os.path.join(REPO, "chip_smoke.py")) as f:
        assert not pattern.search(f.read())


@pytest.mark.parametrize("module", [
    "ops.metrics", "ops.linear", "ops.resample", "train.search",
    "train.batched_search", "train.learning_curve", "train.classification",
    "train.baseline", "reporting", "reporting.metrics_io",
    "chem.graph_features", "ops.interactions", "ops.outliers",
    "pipelines.preprocess", "models.gnn", "train.regression", "models.bert",
    "models.mlp", "models.flow", "train.bert_pretrain", "train.aux_pretrain",
    "train.weighted_ensemble", "train.nn_search", "train.bert_pipeline",
    "train.flow_pipeline"] + SLICE_H)
def test_import_checks_reach_the_classification_slice(module):
    """The two checks above walk every module of the package: each module of
    the classification and regression slices is among those they import and
    read."""
    import pkgutil

    import bbbp_tpu_torch

    names = {m.name for m in pkgutil.walk_packages(bbbp_tpu_torch.__path__,
                                                   "bbbp_tpu_torch.")}
    assert f"bbbp_tpu_torch.{module}" in names


@pytest.fixture(scope="module")
def imported_alone():
    import json

    proc = _py("-c", _IMPORT_ALONE, *SLICE_H)
    assert proc.returncode == 0, proc.stderr
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("module", SLICE_H)
def test_module_alone_loads_no_jax_pandas_or_matplotlib(module, imported_alone):
    """Imported alone, a module of the last slice loads no jax, flax, optax,
    ``bbbp_tpu``, pandas, matplotlib or PIL (the figures import matplotlib
    and PIL when they draw)."""
    assert imported_alone[module] == []


@pytest.mark.parametrize("seed", [0, 3, 42])
def test_synthetic_smiles_equal_to_jax_package(seed):
    from bbbp_tpu.data.zinc import synthetic_smiles as jax_version
    from bbbp_tpu_torch.data.zinc import synthetic_smiles

    assert synthetic_smiles(500, seed=seed) == jax_version(500, seed=seed)


def test_screen_on_cuda_raises_without_cuda(monkeypatch):
    from bbbp_tpu_torch.pipelines.screen import ScreeningModel, screen
    from bbbp_tpu_torch.testing import full_width_screening_state

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = ScreeningModel.from_state(full_width_screening_state(0, n_molecules=64))
    with pytest.raises(RuntimeError, match="CUDA"):
        screen(model, iter([("CCO", "a")]), out_csv=None, device="cuda")


def test_chip_smoke_fails_without_cuda_or_without_the_repo(tmp_path):
    """No result line where torch sees no card, nor in a directory that holds
    chip_smoke.py and nothing else of the repo."""
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    for cwd in (REPO, str(tmp_path)):
        proc = _py("chip_smoke.py", cwd=cwd, CUDA_VISIBLE_DEVICES="")
        assert proc.returncode != 0
        assert '"ok": true' not in proc.stdout


_LEAVE_CHILDREN = """
import ctypes, subprocess, sys, time
from multiprocessing import resource_tracker
import chip_smoke
ctypes.CDLL(None).prctl(36, 1, 0, 0, 0)      # as chip_smoke.main() does
resource_tracker.ensure_running()            # as the featurizer's pool leaves it
subprocess.run(["sh", "-c", "sleep 60 & exit 0"])   # an orphaned grandchild
subprocess.Popen(["sleep", "60"])
time.sleep(0.2)
before = len(chip_smoke.own_children())
chip_smoke.stop_children()
print(before, len(chip_smoke.own_children()))
"""


@pytest.mark.skipif(not sys.platform.startswith("linux"), reason="reads /proc")
def test_chip_smoke_stops_every_process_it_started():
    """The smoke run reaps the resource tracker, its children and orphaned
    grandchildren before it exits."""
    proc = _py("-c", _LEAVE_CHILDREN)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split() == ["3", "0"]
