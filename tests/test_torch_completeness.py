"""The port does all that ``bbbp_tpu`` does.

Reads both packages with ``ast`` (imports neither, so it needs no JAX and
no torch) and holds, module by module:

- every public top-level function and class of ``bbbp_tpu/<m>.py`` has a
  counterpart of the same name in ``bbbp_tpu_torch/<m>.py``, or is in
  ``MOVED`` (its port module and name, which must exist) or ``LEFT_OUT``
  (with a reason; the name must still exist in ``bbbp_tpu``);
- every parameter of a JAX function or constructor is a parameter of its
  counterpart's, or is in ``PARAM_EXCEPTIONS`` with a reason.

A constructor's parameters are its class's ``__init__``'s; without one,
those of its base classes in the same module followed by its own annotated
fields (a dataclass, a ``NamedTuple``, a flax module)."""

import ast
import os
from typing import Dict, List

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_ROOT = os.path.join(REPO, "bbbp_tpu")
PORT_ROOT = os.path.join(REPO, "bbbp_tpu_torch")

_HOST_TRAINERS = ("the JAX package's host trainers, its fallback for a host "
                  "without a TPU; the port trains every forest on the card "
                  "(ops/forest_train.py)")

# "module::name" of the JAX package → "module::name" in the port
MOVED = {
    "ops/forest_tpu.py::DenseTreeEnsemble": "ops/forest.py::DenseTreeEnsemble",
    "ops/forest_tpu.py::dense_to_tree_arrays": "ops/forest.py::dense_to_tree_arrays",
    "ops/forest_tpu.py::TPUGBDTRegressor": "ops/forest_train.py::GBDTRegressor",
    "ops/forest_tpu.py::TPUGBDTClassifier": "ops/forest_train.py::GBDTClassifier",
    "ops/forest_tpu.py::TPURandomForestRegressor":
        "ops/forest_train.py::RandomForestRegressor",
    "ops/forest_tpu.py::TPURandomForestClassifier":
        "ops/forest_train.py::RandomForestClassifier",
    "ops/forest.py::BinMapper": "ops/forest_train.py::BinMapper",
    "native/build.py::build": "_build.py::build_chem",
    "ops/bitops.py::unpack_bits_jnp": "ops/bitops.py::unpack_bits_reference",
}

# "module::name" of the JAX package → why the port has no counterpart
LEFT_OUT = {
    "ops/forest.py::TreeEnsemble": "the host trainers' tree ensemble; " + _HOST_TRAINERS,
    "ops/forest.py::GBDTRegressor": _HOST_TRAINERS,
    "ops/forest.py::GBDTClassifier": _HOST_TRAINERS,
    "ops/forest.py::RandomForestRegressor": _HOST_TRAINERS,
    "ops/forest.py::RandomForestClassifier": _HOST_TRAINERS,
    "ops/forest_tpu.py::fit_forest_launched": (
        "splits a fit into launches against a TPU worker's limits; the port's "
        "fit_forest is one device program a tree and needs no splitting"),
    "native/bindings.py::available": (
        "the JAX package falls back to the Python featurizer when its library "
        "is absent; the port builds the library at first use or raises"),
}

# "module::name" of the JAX package → {parameter: why the port lacks it}
_NO_PANDAS = "the port never imports pandas: it takes a list of row dicts, rows"
PARAM_EXCEPTIONS = {
    "pipelines/screen.py::screen": {
        "mesh": "devices=[...] takes its place: the port lays a chunk over a "
                "list of cards, not a jax Mesh",
        "verbose": "accepted but never read by the JAX function",
    },
    "ops/bitops.py::packed_project": {
        "use_pallas": "chooses Pallas or XLA on a TPU; the port's wrapper "
                      "launches its kernel for a CUDA tensor and runs the plain "
                      "version for a CPU tensor",
    },
    "data/curation.py::split_regression_classification": {"df": _NO_PANDAS},
    "data/curation.py::reconcile_regression_labels": {"df": _NO_PANDAS},
    "data/curation.py::reconcile_classification_labels": {"df": _NO_PANDAS},
    "data/b3db.py::RegressionData": {
        "frame": "a pandas DataFrame; the port never imports pandas and keeps "
                 "the columns it reads as fields"},
    "data/b3db.py::ClassificationData": {
        "frame": "a pandas DataFrame; the port never imports pandas and keeps "
                 "the columns it reads as fields"},
    "reporting/attribution.py::forest_feature_importance": {
        "estimator": "trees: the JAX function reads its host trainers' "
                     "_host_trees, which the port does not have"},
    "models/flow.py::FlowLayer": {
        "dropout": "rate, the name the port's dropout layers give the same "
                   "argument"},
    "native/build.py::build": {
        "verbose": "the port's build prints nothing and puts the compiler's "
                   "output in the BuildError it raises"},
}


def jax_modules(root: str = JAX_ROOT) -> List[str]:
    """Every .py file under ``root``, as a path relative to it."""
    out = []
    for d, _, files in os.walk(root):
        for fn in files:
            if fn.endswith(".py"):
                out.append(os.path.relpath(os.path.join(d, fn), root).replace(os.sep, "/"))
    return sorted(out)


def _classes_and_defs(root: str, rel: str) -> Dict[str, ast.AST]:
    """Top-level functions and classes of ``root/rel`` by name, private ones
    included; {} when the file does not exist."""
    path = os.path.join(root, rel)
    if not os.path.exists(path):
        return {}
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    return {n.name: n for n in tree.body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef))}


def _public(defs: Dict[str, ast.AST]) -> List[str]:
    return [k for k in defs if not k.startswith("_")]


def _fn_params(fn) -> List[str]:
    a = fn.args
    names = [x.arg for x in a.posonlyargs + a.args + a.kwonlyargs]
    if a.vararg:
        names.append("*" + a.vararg.arg)
    if a.kwarg:
        names.append("**" + a.kwarg.arg)
    return [n for n in names if n not in ("self", "cls")]


def params(node, defs: Dict[str, ast.AST]) -> List[str]:
    """Parameters of a function, or of a class's constructor (see the module
    docstring)."""
    if not isinstance(node, ast.ClassDef):
        return _fn_params(node)
    for b in node.body:
        if isinstance(b, (ast.FunctionDef, ast.AsyncFunctionDef)) and b.name == "__init__":
            return _fn_params(b)
    out = []
    for base in node.bases:
        if isinstance(base, ast.Name) and isinstance(defs.get(base.id), ast.ClassDef):
            out += params(defs[base.id], defs)
    return out + [b.target.id for b in node.body
                  if isinstance(b, ast.AnnAssign) and isinstance(b.target, ast.Name)]


def module_problems(rel: str, jax_root: str = JAX_ROOT, port_root: str = PORT_ROOT,
                    moved=None, left_out=None, param_exceptions=None) -> List[str]:
    """What keeps ``jax_root/rel`` from having its counterpart in the port,
    and which entries of the three dicts for it are stale."""
    moved = MOVED if moved is None else moved
    left_out = LEFT_OUT if left_out is None else left_out
    param_exceptions = PARAM_EXCEPTIONS if param_exceptions is None else param_exceptions
    jdefs = _classes_and_defs(jax_root, rel)
    pdefs = _classes_and_defs(port_root, rel)
    problems = []
    for key in sorted(set(moved) | set(left_out) | set(param_exceptions)):
        mod, name = key.split("::")
        if mod == rel and name not in jdefs:
            problems.append(f"{key}: listed, but bbbp_tpu/{rel} has no {name}")
    for name in _public(jdefs):
        key = f"{rel}::{name}"
        if key in left_out:
            if name in pdefs:
                problems.append(f"{key}: left out, but the port has it")
            continue
        if key in moved:
            tmod, tname = moved[key].split("::")
            tdefs = _classes_and_defs(port_root, tmod)
            if tname not in tdefs:
                problems.append(f"{key}: moved to {moved[key]}, which does not exist")
                continue
            counterpart, cdefs = tdefs[tname], tdefs
        elif name in pdefs:
            counterpart, cdefs = pdefs[name], pdefs
        else:
            problems.append(f"{key}: no counterpart in bbbp_tpu_torch/{rel}, "
                            f"and neither MOVED nor LEFT_OUT lists it")
            continue
        theirs = params(jdefs[name], jdefs)
        ours = params(counterpart, cdefs)
        excused = param_exceptions.get(key, {})
        for p in theirs:
            if p not in ours and p not in excused:
                problems.append(f"{key}: parameter {p} missing from the port's "
                                f"counterpart, and PARAM_EXCEPTIONS does not list it")
        for p in excused:
            if p not in theirs:
                problems.append(f"{key}: PARAM_EXCEPTIONS lists {p}, which the JAX "
                                f"function does not take")
            elif p in ours:
                problems.append(f"{key}: PARAM_EXCEPTIONS lists {p}, which the "
                                f"port's counterpart takes")
    return problems


def stale_modules(jax_root: str = JAX_ROOT, moved=None, left_out=None,
                  param_exceptions=None) -> List[str]:
    """Entries of the three dicts that name a module ``jax_root`` lacks."""
    keys = set(MOVED if moved is None else moved)
    keys |= set(LEFT_OUT if left_out is None else left_out)
    keys |= set(PARAM_EXCEPTIONS if param_exceptions is None else param_exceptions)
    have = set(jax_modules(jax_root))
    return [f"{k}: bbbp_tpu has no module {k.split('::')[0]}"
            for k in sorted(keys) if k.split("::")[0] not in have]


def check(jax_root: str, port_root: str, moved, left_out, param_exceptions) -> List[str]:
    """Every problem of every module of ``jax_root``, and stale modules."""
    out = stale_modules(jax_root, moved, left_out, param_exceptions)
    for rel in jax_modules(jax_root):
        out += module_problems(rel, jax_root, port_root, moved, left_out, param_exceptions)
    return out


# ---------------------------------------------------------------- the repo

@pytest.mark.parametrize("rel", jax_modules())
def test_module_has_its_counterparts(rel):
    assert module_problems(rel) == []


def test_every_entry_names_a_module_of_bbbp_tpu():
    assert stale_modules() == []


def test_every_entry_has_a_reason():
    assert all(isinstance(v, str) and v for v in LEFT_OUT.values())
    assert all(isinstance(v, str) and v
               for d in PARAM_EXCEPTIONS.values() for v in d.values())
    assert all("::" in k for k in list(MOVED) + list(MOVED.values())
               + list(LEFT_OUT) + list(PARAM_EXCEPTIONS))


def test_the_walk_sees_the_packages():
    """A walk that found nothing would pass the cases above vacuously."""
    mods = jax_modules()
    assert len(mods) >= 70
    n_public = sum(len(_public(_classes_and_defs(JAX_ROOT, m))) for m in mods)
    assert n_public >= 250
    assert "data/zinc.py" in mods and "pipelines/screen.py" in mods
    screen = _classes_and_defs(PORT_ROOT, "pipelines/screen.py")["screen"]
    assert "devices" in params(screen, {})


# ------------------------------------------- the checker on fake packages

def _tree(tmp_path, jax: Dict[str, str], port: Dict[str, str]):
    for root, files in (("jax", jax), ("port", port)):
        for rel, src in files.items():
            p = tmp_path / root / rel
            p.parent.mkdir(parents=True, exist_ok=True)
            p.write_text(src)
    return str(tmp_path / "jax"), str(tmp_path / "port")


def _check(tmp_path, jax, port, moved=(), left_out=(), params_ex=()):
    j, p = _tree(tmp_path, jax, port)
    return check(j, p, dict(moved), dict(left_out), dict(params_ex))


JAX_SRC = ("def f(a, b=1, *, c=2):\n    pass\n\n"
           "class _Base:\n    def __init__(self, x, y=0):\n        pass\n\n"
           "class K(_Base):\n    pass\n\n"
           "class D:\n    u: int\n    v: float = 0.0\n\n"
           "def _private(z):\n    pass\n")
PORT_SRC = ("def f(a, b=1, *, c=2, device=None):\n    pass\n\n"
            "class K:\n    def __init__(self, x, y=0, device=None):\n        pass\n\n"
            "class D:\n    u: int\n    v: float = 0.0\n")


def test_checker_passes_a_complete_pair(tmp_path):
    assert _check(tmp_path, {"m.py": JAX_SRC}, {"m.py": PORT_SRC}) == []


def test_checker_fails_on_a_name_without_counterpart(tmp_path):
    problems = _check(tmp_path, {"m.py": JAX_SRC, "sub/n.py": "def g():\n    pass\n"},
                      {"m.py": PORT_SRC.replace("class D", "class E")})
    assert problems == [
        "m.py::D: no counterpart in bbbp_tpu_torch/m.py, and neither MOVED nor "
        "LEFT_OUT lists it",
        "sub/n.py::g: no counterpart in bbbp_tpu_torch/sub/n.py, and neither "
        "MOVED nor LEFT_OUT lists it"]
    # either dict accounts for them
    assert _check(tmp_path, {}, {"other.py": "class D:\n    u: int\n    v: float\n"},
                  moved={"m.py::D": "other.py::D"},
                  left_out={"sub/n.py::g": "a reason"}) == []


def test_checker_fails_on_a_missing_moved_target(tmp_path):
    problems = _check(tmp_path, {"m.py": JAX_SRC},
                      {"m.py": PORT_SRC.replace("class D", "class E")},
                      moved={"m.py::D": "other.py::D"})
    assert problems == ["m.py::D: moved to other.py::D, which does not exist"]


def test_checker_fails_on_a_stale_left_out_entry(tmp_path):
    problems = _check(tmp_path, {"m.py": JAX_SRC}, {"m.py": PORT_SRC},
                      left_out={"m.py::gone": "a reason", "x.py::h": "a reason"})
    assert problems == ["x.py::h: bbbp_tpu has no module x.py",
                        "m.py::gone: listed, but bbbp_tpu/m.py has no gone"]
    # and a name the port now has is no longer left out
    problems = _check(tmp_path, {"m.py": JAX_SRC}, {"m.py": PORT_SRC},
                      left_out={"m.py::f": "a reason"})
    assert problems == ["m.py::f: left out, but the port has it"]


@pytest.mark.parametrize("old,new,missing", [
    ("def f(a, b=1, *, c=2, device=None)", "def f(a, *, c=2)", "m.py::f: parameter b"),
    ("def f(a, b=1, *, c=2, device=None)", "def f(a, b=1)", "m.py::f: parameter c"),
    ("def __init__(self, x, y=0, device=None)", "def __init__(self, x)",
     "m.py::K: parameter y"),
    ("    v: float = 0.0\n", "", "m.py::D: parameter v"),
])
def test_checker_fails_on_a_missing_parameter(tmp_path, old, new, missing):
    port = PORT_SRC.replace(old, new)
    assert port != PORT_SRC
    problems = _check(tmp_path, {"m.py": JAX_SRC}, {"m.py": port})
    assert problems == [missing + " missing from the port's counterpart, and "
                        "PARAM_EXCEPTIONS does not list it"]
    key, p = missing.split(": parameter ")
    assert _check(tmp_path, {"m.py": JAX_SRC}, {"m.py": port},
                  params_ex={key: {p: "a reason"}}) == []


def test_checker_fails_on_a_stale_parameter_exception(tmp_path):
    problems = _check(tmp_path, {"m.py": JAX_SRC}, {"m.py": PORT_SRC},
                      params_ex={"m.py::f": {"b": "a reason", "q": "a reason"}})
    assert problems == [
        "m.py::f: PARAM_EXCEPTIONS lists b, which the port's counterpart takes",
        "m.py::f: PARAM_EXCEPTIONS lists q, which the JAX function does not take"]
