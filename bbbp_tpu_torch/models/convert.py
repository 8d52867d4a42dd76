"""Load flax parameter trees into the port's fold-axis models.

A flax ``params`` tree, as nested dicts of numpy arrays (what
``jax.device_get`` of the JAX package's params gives, or a pickle of it),
becomes the parameters of a port model of the same configuration
(``models/transformer_cnn.py``, ``models/gnn.py``, ``models/bert.py``,
``models/mlp.py``, ``models/flow.py``). The port's parameters
carry flax's names (``enc0.ff1.kernel`` is the leaf ``enc0/ff1/kernel``)
and, but for the cases of ``_LAYOUTS``, the shape of one fold of them:
dense kernels stay ``[in, out]``. ``_LAYOUTS`` is the one place that knows
where the two differ: HWIO convolution kernels turn to OIHW, attention's
``DenseGeneral`` leaves reshape, the four heads of
``MultiHeadAttentionFusion`` lie side by side, and so do the MPNN's
bond-type message layers. Given K trees, fold k takes tree k; given one,
every fold takes it.

``params_from_flax`` refuses a tree with a missing or an extra leaf, or a
leaf of another shape. ``matching_params`` takes what matches and leaves
the rest, as ``train_cv``'s ``warm_start`` does in the JAX package.
``stats_from_flax`` loads flax's ``batch_stats`` collection (BatchNorm's
running statistics, the port's buffers). ``flax_from_params`` and
``flax_stats_from_buffers`` are the inverses: one fold of a port model as
a flax tree, for the artifacts the JAX package reads (``stack_folds``
joins the folds' trees on a leading axis, as the JAX package's vmapped
trees are).
``mlp_from_jax`` carries the JAX package's small MLP (``ops/linear.py``)
across.
"""

from __future__ import annotations

import re
from typing import Callable, Dict, List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch import nn

Tree = Mapping[str, object]
Shape = Tuple[int, ...]
# (flax leaf paths, the shape of each, how they make one fold of the
# parameter, how one fold of the parameter splits back into them)
Leaves = Tuple[Tuple[str, ...], Tuple[Shape, ...],
               Callable[[List[np.ndarray]], np.ndarray],
               Callable[[np.ndarray], List[np.ndarray]]]


def flatten_tree(tree: Tree, prefix: str = "") -> Dict[str, np.ndarray]:
    """{"a/b/kernel": array} of a nested dict of arrays."""
    out: Dict[str, np.ndarray] = {}
    for key, value in tree.items():
        path = f"{prefix}/{key}" if prefix else str(key)
        if isinstance(value, Mapping):
            out.update(flatten_tree(value, path))
        else:
            out[path] = np.asarray(value)
    return out


def _conv(model: nn.Module, m: re.Match, shape: Shape) -> Leaves:
    """flax ``Conv``'s HWIO kernel; the port's is OIHW."""
    o, c, kh, kw = shape
    return ((m["path"],), ((kh, kw, c, o),),
            lambda a: a[0].transpose(3, 2, 0, 1),
            lambda p: [p.transpose(2, 3, 1, 0)])


def _attention(model: nn.Module, m: re.Match, shape: Shape) -> Leaves:
    """flax ``MultiHeadDotProductAttention``'s ``DenseGeneral`` leaves:
    query / key / value kernels [in, heads, head_dim] and biases [heads,
    head_dim], the out kernel [heads, head_dim, out]; the port's are the
    dense layers of the same numbers."""
    h = model.get_submodule(m["module"]).n_heads
    if m["proj"] == "out.kernel":
        flax = (h, shape[0] // h, shape[1])
    else:
        flax = shape[:-1] + (h, shape[-1] // h)
    return ((m["path"],), (flax,), lambda a: a[0].reshape(shape),
            lambda p: [p.reshape(flax)])


def _heads(model: nn.Module, m: re.Match, shape: Shape) -> Leaves:
    """``MultiHeadAttentionFusion``'s heads, each its own flax ``Dense``
    (``score{h}_1``, ``score{h}_2``, ``value{h}``), side by side in one
    parameter: the first score layers' and the values' kernels and biases
    concatenated on their last axis, the second score layers' [64, 1]
    kernels stacked to [heads, 64]."""
    h = model.get_submodule(m["module"]).num_heads
    layer, leaf = m["layer"], m["leaf"]
    name = layer.replace("_", "{}_") if "_" in layer else layer + "{}"
    prefix = m["module"].replace(".", "/")
    paths = tuple(f"{prefix}/{name.format(i)}/{leaf}" for i in range(h))
    if (layer, leaf) == ("score_2", "kernel"):
        return (paths, ((shape[1], 1),) * h,
                lambda a: np.stack([x[:, 0] for x in a]),
                lambda p: [row[:, None] for row in p])
    return (paths, (shape[:-1] + (shape[-1] // h,),) * h,
            lambda a: np.concatenate(a, axis=-1),
            lambda p: np.split(p, h, axis=-1))


def _messages(model: nn.Module, m: re.Match, shape: Shape) -> Leaves:
    """``MPNNRegressor``'s bond-type message layers of one message-passing
    layer, each its own flax ``Dense`` (``Dense_{1 + i(T+1) + t}``, t < T),
    side by side in one kernel [H, T·H] and one bias [T·H]."""
    mpnn = model.get_submodule(m["module"].rstrip("."))
    first, t = mpnn.message_dense(int(m["layer"])), mpnn.n_types
    prefix = m["module"].replace(".", "/")
    paths = tuple(f"{prefix}Dense_{first + j}/{m['leaf']}" for j in range(t))
    return (paths, (shape[:-1] + (shape[-1] // t,),) * t,
            lambda a: np.concatenate(a, axis=-1),
            lambda p: np.split(p, t, axis=-1))


# The port's parameters whose flax leaves are not one leaf of their own
# path and per-fold shape: a pattern of the port's name → its leaves.
_LAYOUTS = (
    (r"(?P<path>(.*\.)?Conv_\d+\.kernel)", _conv),
    (r"(?P<path>(?P<module>.*MultiHeadDotProductAttention_0|(.*\.)?attn\d+)"
     r"\.(?P<proj>(query|key|value)\.(kernel|bias)|out\.kernel))", _attention),
    (r"(?P<module>(.*\.)?MultiHeadAttentionFusion_0)"
     r"\.(?P<layer>score_1|score_2|value)_(?P<leaf>kernel|bias)", _heads),
    (r"(?P<module>(.*\.)?)messages_(?P<layer>\d+)_(?P<leaf>kernel|bias)",
     _messages),
)


def _leaves(model: nn.Module, name: str, shape: Shape) -> Leaves:
    for pattern, rule in _LAYOUTS:
        m = re.fullmatch(pattern, name)
        if m:
            return rule(model, m, shape)
    return (name,), (shape,), lambda a: a[0], lambda p: [p]


def _layouts(model: nn.Module):
    """(port name, flax leaf paths, combine) for every parameter of
    ``model``; combine checks each leaf's shape."""
    for name, p in model.named_parameters():
        paths, shapes, combine, _ = _leaves(model, name, tuple(p.shape[1:]))
        yield (name, tuple(path.replace(".", "/") for path in paths),
               _checked(shapes, combine))


def _checked(shapes: Tuple[Shape, ...], combine):
    def run(arrays: List[np.ndarray]) -> np.ndarray:
        for a, want in zip(arrays, shapes):
            if tuple(a.shape) != want:
                raise ValueError(f"flax leaf of shape {tuple(a.shape)}, "
                                 f"expected {want}")
        return combine(arrays)
    return run


def _folds_of(model: nn.Module, trees) -> List[Dict[str, np.ndarray]]:
    if isinstance(trees, Mapping):
        trees = [trees]
    flat = [flatten_tree(t) for t in trees]
    if len(flat) not in (1, model.folds):
        raise ValueError(f"{len(flat)} trees for a model of {model.folds} folds")
    return flat


def _stack(model: nn.Module, name: str, paths: Tuple[str, ...], combine,
           folds: List[Dict[str, np.ndarray]]) -> torch.Tensor:
    per_fold = [np.asarray(combine([f[p] for p in paths]), np.float32)
                for f in folds]
    value = torch.from_numpy(np.stack(per_fold))
    want = tuple(model.get_parameter(name).shape[1:])
    if tuple(value.shape[1:]) != want:
        raise ValueError(f"flax leaves give {tuple(value.shape[1:])}, "
                         f"expected {want}")
    return value.expand(model.folds, *want).clone()


def params_from_flax(model: nn.Module, trees: Union[Tree, Sequence[Tree]]
                     ) -> Dict[str, torch.Tensor]:
    """The model's parameters (name → f32 [K, ...] on the CPU) from one flax
    tree for every fold, or one a fold. Raises ``ValueError`` for a missing
    or extra leaf, a leaf of another shape, or a count of trees that is
    neither 1 nor K."""
    folds = _folds_of(model, trees)
    out, wanted = {}, set()
    for name, paths, combine in _layouts(model):
        wanted.update(paths)
        missing = [p for p in paths if p not in folds[0]]
        if missing:
            raise ValueError(f"flax tree lacks {missing} (for {name})")
        try:
            out[name] = _stack(model, name, paths, combine, folds)
        except ValueError as e:
            raise ValueError(f"{name}: {e}") from None
    extra = sorted(set(folds[0]) - wanted)
    if extra:
        raise ValueError(f"flax tree has leaves the model lacks: {extra}")
    for f in folds[1:]:
        if set(f) != set(folds[0]):
            raise ValueError("the flax trees differ in their leaves")
    return out


def matching_params(model: nn.Module, trees: Union[Tree, Sequence[Tree]]
                    ) -> Dict[str, torch.Tensor]:
    """The parameters whose flax leaves are all in the tree(s) with the
    model's shapes; the others are left out."""
    folds = _folds_of(model, trees)
    out = {}
    for name, paths, combine in _layouts(model):
        if all(p in f for f in folds for p in paths):
            try:
                out[name] = _stack(model, name, paths, combine, folds)
            except ValueError:
                continue
    return out


def stats_from_flax(model: nn.Module, trees: Union[Tree, Sequence[Tree]]
                    ) -> Dict[str, torch.Tensor]:
    """The model's running statistics (buffer name → f32 [K, d] on the CPU)
    out of the ``batch_stats`` tree(s) of flax: BatchNorm's ``mean`` and
    ``var``, a leaf of the buffer's path each. Raises ``ValueError`` as
    ``params_from_flax``."""
    folds = _folds_of(model, trees)
    out, wanted = {}, set()
    for name, b in model.named_buffers():
        path = name.replace(".", "/")
        wanted.add(path)
        if path not in folds[0]:
            raise ValueError(f"flax batch_stats lack {path} (for {name})")
        try:
            out[name] = _stack_leaf(model.folds, tuple(b.shape[1:]), path, folds)
        except ValueError as e:
            raise ValueError(f"{name}: {e}") from None
    extra = sorted(set(folds[0]) - wanted)
    if extra:
        raise ValueError(f"flax batch_stats have leaves the model lacks: {extra}")
    return out


def _stack_leaf(k: int, want: Shape, path: str,
                folds: List[Dict[str, np.ndarray]]) -> torch.Tensor:
    value = torch.from_numpy(np.stack([np.asarray(f[path], np.float32)
                                       for f in folds]))
    if tuple(value.shape[1:]) != want:
        raise ValueError(f"flax leaf of shape {tuple(value.shape[1:])}, "
                         f"expected {want}")
    return value.expand(k, *want).clone()


def load_flax(model: nn.Module, trees: Union[Tree, Sequence[Tree]],
              batch_stats: Union[Tree, Sequence[Tree], None] = None) -> nn.Module:
    """Copy ``params_from_flax(model, trees)`` into ``model``, and
    ``stats_from_flax(model, batch_stats)`` where given; returns it."""
    params = params_from_flax(model, trees)
    stats = {} if batch_stats is None else stats_from_flax(model, batch_stats)
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.copy_(params[name])
        for name, b in model.named_buffers():
            if name in stats:
                b.copy_(stats[name])
    return model


def unflatten_tree(flat: Mapping[str, np.ndarray]) -> Dict[str, object]:
    """The nested dict of {"a/b/kernel": array} (``flatten_tree``'s inverse)."""
    out: Dict[str, object] = {}
    for path, value in flat.items():
        node = out
        *parents, leaf = path.split("/")
        for key in parents:
            node = node.setdefault(key, {})
        node[leaf] = value
    return out


def _fold_array(t: torch.Tensor, fold: int) -> np.ndarray:
    return t.detach()[fold].float().cpu().numpy()


def flax_from_params(model: nn.Module, fold: int = 0,
                     params: Optional[Mapping[str, torch.Tensor]] = None
                     ) -> Dict[str, object]:
    """``params_from_flax``'s inverse: the flax params tree (nested dicts
    of f32 numpy arrays, flax's names and layouts) of fold ``fold`` of
    ``model``, or of ``params`` ({name: [K, ...]}, e.g. a ``CVResult``'s)
    laid out as ``model``'s. This is what the port writes into the
    artifacts that the JAX package reads (a pretrained directory's
    ``params.pkl``, an aux-pretraining pickle, a flow classifier)."""
    flat = {}
    for name, p in model.named_parameters():
        value = _fold_array(p if params is None else params[name], fold)
        paths, shapes, _, split = _leaves(model, name, tuple(p.shape[1:]))
        for path, a in zip(paths, split(value)):
            flat[path.replace(".", "/")] = np.ascontiguousarray(a)
    return unflatten_tree(flat)


def flax_stats_from_buffers(model: nn.Module, fold: int = 0,
                            stats: Optional[Mapping[str, torch.Tensor]] = None
                            ) -> Dict[str, object]:
    """``stats_from_flax``'s inverse: the flax ``batch_stats`` tree of fold
    ``fold`` of ``model``'s buffers, or of ``stats`` ({name: [K, d]})."""
    return unflatten_tree({
        name.replace(".", "/"): _fold_array(b if stats is None else stats[name],
                                            fold)
        for name, b in model.named_buffers()})


def stack_folds(trees: Sequence[Mapping[str, object]]) -> Dict[str, object]:
    """K trees of one structure as one tree whose leaves carry a leading
    fold axis, [K, ...] (the layout of the JAX package's vmapped params)."""
    flats = [flatten_tree(t) for t in trees]
    return unflatten_tree({path: np.stack([f[path] for f in flats])
                           for path in flats[0]})


def unstack_folds(tree: Mapping[str, object]) -> List[Dict[str, object]]:
    """``stack_folds``' inverse: a tree whose leaves carry a leading fold
    axis as K trees, one a fold (what ``load_flax`` takes for K folds)."""
    flat = flatten_tree(tree)
    k = len(next(iter(flat.values())))
    return [unflatten_tree({path: a[i] for path, a in flat.items()})
            for i in range(k)]


def mlp_from_jax(params: Sequence[Tuple[object, object]]
                 ) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """The JAX package's MLP parameters (``bbbp_tpu/ops/linear.py``: a list
    of (w [in, out], b [out]) pairs, from ``_init_mlp`` or a trained
    ``params_``) → the port's (``ops/linear.py``), f32 CPU tensors of the
    same layout."""
    out = []
    for w, b in params:
        w, b = np.asarray(w, np.float32), np.asarray(b, np.float32)
        if w.ndim != 2 or b.shape != (w.shape[1],):
            raise ValueError(f"an MLP layer is (w [in, out], b [out]), got "
                             f"{w.shape} and {b.shape}")
        out.append((torch.from_numpy(w.copy()), torch.from_numpy(b.copy())))
    for (w0, _), (w1, _) in zip(out, out[1:]):
        if w0.shape[1] != w1.shape[0]:
            raise ValueError(f"layers of {tuple(w0.shape)} and {tuple(w1.shape)} "
                             f"do not chain")
    return out
