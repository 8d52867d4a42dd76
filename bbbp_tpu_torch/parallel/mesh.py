"""Device meshes on ``torch.distributed``, the counterpart of
``bbbp_tpu/parallel/mesh.py``, and what the port needs to use them: a
launcher of one process a rank, fold blocks for ``train_cv``, and column
sharding of wide dense kernels over the ``model`` axis.

The JAX package lays a 2-D ``(data, model)`` mesh over the devices of one
process and lets XLA insert the collectives its sharding annotations imply.
Here a mesh is a ``DeviceMesh`` over the ranks of a process group, one
process a rank (NCCL on cards, gloo on the CPU): ``make_mesh`` builds it,
``batch_sharding`` / ``replicated`` are the DTensor placements of
``P("data", ...)`` and ``P()``, and ``shard_batch`` distributes tensors by
them. The collectives are written out where the port uses a mesh:

- the fold axis over ``data`` (``train/loop.py::train_cv``): data-rank r
  trains a contiguous block of folds and the results are all-gathered
  (``gather_folds``);
- a dense kernel column-sharded over ``model`` (``entry.dryrun_multichip``):
  each model-rank computes its slice of the layer's outputs, which a
  differentiable all-gather joins (``shard_columns`` turns the layers that
  own such kernels into their column-sharded forms, ``ShardedDense`` and
  ``ShardedHeadsFusion``; ``models/fold.py::dense`` knows no mesh).

Nothing here starts a thread or a process when imported; ``launch`` starts
``world_size`` spawned processes, joins them into one process group and
returns their results.
"""

from __future__ import annotations

import datetime
import os
import queue
import socket
import time
import traceback
from typing import Callable, List, NamedTuple, Optional, Sequence

import torch
import torch.distributed as dist

from bbbp_tpu_torch.models.fold import Dense, dense
from bbbp_tpu_torch.models.fusion import MultiHeadAttentionFusion


class Sharding(NamedTuple):
    """A mesh and the DTensor placements of one tensor on it."""

    mesh: object
    placements: tuple


def _placements():
    from torch.distributed.tensor import Replicate, Shard

    return Replicate, Shard


def make_mesh(n_devices: Optional[int] = None, model_parallel: int = 1,
              axis_names: Sequence[str] = ("data", "model")):
    """A (data, model) ``DeviceMesh`` over the process group's ranks
    (data-major: rank = data·model_parallel + model). The group must be
    initialised (``launch`` does it); its backend picks the device type
    (NCCL: cuda, gloo: cpu)."""
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised process group "
                           "(torch.distributed.init_process_group, or launch)")
    world = dist.get_world_size()
    n = min(n_devices or world, world)
    if n % model_parallel != 0:
        raise ValueError(f"{n} devices not divisible by model_parallel={model_parallel}")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, (n // model_parallel, model_parallel),
                            mesh_dim_names=tuple(axis_names))


def batch_sharding(mesh, ndim: int = 2) -> Sharding:
    """Shard the leading (batch) axis over 'data'; replicate the rest.
    ``ndim`` (the tensor's axes) is the JAX package's signature: a DTensor
    placement is given a mesh axis, not a tensor axis, so it is not read."""
    Replicate, Shard = _placements()
    return Sharding(mesh, (Shard(0),) + (Replicate(),) * (mesh.ndim - 1))


def replicated(mesh) -> Sharding:
    Replicate, _ = _placements()
    return Sharding(mesh, (Replicate(),) * mesh.ndim)


def shard_batch(mesh, *arrays):
    """Distribute host arrays with batch sharding (pads nothing: callers pass
    batch sizes divisible by the data axis). Every rank passes the same
    arrays; each keeps its rows."""
    from torch.distributed.tensor import distribute_tensor

    out = []
    for a in arrays:
        t = torch.as_tensor(a)
        sh = batch_sharding(mesh, t.dim())
        out.append(distribute_tensor(t.to(mesh.device_type), sh.mesh, sh.placements))
    return tuple(out) if len(out) > 1 else out[0]


def fold_block(k: int, mesh) -> Optional[tuple]:
    """(start, stop) of the folds this rank trains when ``k`` folds shard
    over the mesh's ``data`` axis, or None when ``k`` is no multiple of it.
    Anything but a ``DeviceMesh`` with a ``data`` axis is refused."""
    if "data" not in (getattr(mesh, "mesh_dim_names", None) or ()):
        raise ValueError(f"mesh must be a DeviceMesh with a 'data' axis "
                         f"(make_mesh), got {mesh!r}")
    dp = mesh["data"].size()
    if k % dp:
        return None
    r = mesh["data"].get_local_rank()
    return (r * k // dp, (r + 1) * k // dp)


def gather_folds(t: torch.Tensor, group) -> torch.Tensor:
    """Every rank's ``t`` (one fold block each, in rank order) joined on the
    leading axis."""
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t.contiguous(), group=group)
    return torch.cat(parts)


# --- column sharding over the model axis -----------------------------------

class _Enter(torch.autograd.Function):
    """Identity forward; the backward sums the input's gradient over the
    model group (each model-rank holds the part its columns contribute)."""

    @staticmethod
    def forward(ctx, x, shard):
        ctx.shard = shard
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        g = grad.float().contiguous()
        dist.all_reduce(g, group=ctx.shard.group)
        return g.to(grad.dtype), None


class _Columns(torch.autograd.Function):
    """This rank's columns of a replicated bias; the backward spreads the
    slice's gradient into the whole bias and sums it over the model group,
    so every model-rank's copy gets the whole gradient."""

    @staticmethod
    def forward(ctx, bias, shard, width):
        ctx.shard, ctx.width, ctx.full = shard, width, bias.shape
        r = shard.rank
        return bias[..., r * width:(r + 1) * width].clone()

    @staticmethod
    def backward(ctx, grad):
        r, w = ctx.shard.rank, ctx.width
        full = torch.zeros(ctx.full, dtype=torch.float32, device=grad.device)
        full[..., r * w:(r + 1) * w] = grad.float()
        dist.all_reduce(full, group=ctx.shard.group)
        return full.to(grad.dtype), None, None


class _Gather(torch.autograd.Function):
    """All-gather of the column slices on the last axis; the backward keeps
    this rank's columns of the gradient (every model-rank computes the
    same loss from the gathered output, so each holds the whole gradient)."""

    @staticmethod
    def forward(ctx, y, shard):
        ctx.shard, ctx.width = shard, y.shape[-1]
        parts = [torch.empty(y.shape, dtype=torch.float32, device=y.device)
                 for _ in range(shard.size)]
        dist.all_gather(parts, y.float().contiguous(), group=shard.group)
        return torch.cat(parts, dim=-1).to(y.dtype)

    @staticmethod
    def backward(ctx, grad):
        r, w = ctx.shard.rank, ctx.width
        return grad[..., r * w:(r + 1) * w].contiguous(), None


class ColumnShard:
    """One model-rank's share of a layer whose dense kernel [K, in, out]
    is split by columns over the model group and whose bias stays whole:
    ``dense`` computes this rank's columns and gathers the rest.
    Communication is in f32, exact for bf16 values."""

    def __init__(self, group, rank: int, size: int):
        self.group, self.rank, self.size = group, rank, size

    def dense(self, x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor,
              dtype: torch.dtype) -> torch.Tensor:
        """``models/fold.py::dense`` of the whole layer, from this rank's
        columns of ``kernel``."""
        x = _Enter.apply(x, self)
        y = dense(x, kernel, _Columns.apply(bias, self, kernel.shape[-1]), dtype)
        return _Gather.apply(y, self)


class ShardedDense(Dense):
    """A ``Dense`` that holds one model-rank's columns of its kernel."""

    column_shard: ColumnShard

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.column_shard.dense(x, self.kernel, self.bias, self.dtype)


class ShardedHeadsFusion(MultiHeadAttentionFusion):
    """A ``MultiHeadAttentionFusion`` that holds one model-rank's columns
    of its value kernel."""

    column_shard: ColumnShard

    def values(self, x: torch.Tensor) -> torch.Tensor:
        return self.column_shard.dense(x, self.value_kernel, self.value_bias,
                                       self.dtype)


# {(layer class, kernel attribute): its column-sharded form}
SHARDED_FORMS = {(Dense, "kernel"): ShardedDense,
                 (MultiHeadAttentionFusion, "value_kernel"): ShardedHeadsFusion}


def wide_dense_kernels(model: torch.nn.Module, min_width: int = 128) -> List[str]:
    """The dense kernels of ``model`` whose flax leaves are at least
    ``min_width`` wide on their last axis: the rule of
    ``__graft_entry__.py``'s ``param_spec`` (a fold-axis leaf of three or
    more axes whose last axis is ≥ 128 shards over ``model``; biases and
    the 32- and 64-channel convolutions stay whole). The port's dense
    kernels are [K, in, out]."""
    from bbbp_tpu_torch.models.convert import _leaves

    out = []
    for name, p in model.named_parameters():
        if p.dim() != 3 or not name.endswith("kernel"):
            continue
        _, shapes, _, _ = _leaves(model, name, tuple(p.shape[1:]))
        if all(len(s) >= 2 and s[-1] >= min_width for s in shapes):
            out.append(name)
    return out


def shard_columns(model: torch.nn.Module, kernels: Sequence[str], group,
                  rank: int, size: int) -> None:
    """Keep this model-rank's contiguous column slice of each kernel in
    ``kernels`` and turn the layer that owns it into its column-sharded
    form (``SHARDED_FORMS``). A kernel of any other layer, or whose width
    ``size`` does not divide, is refused before anything changes."""
    plan = []
    for name in kernels:
        owner_name, _, attr = name.rpartition(".")
        owner = model.get_submodule(owner_name)
        form = SHARDED_FORMS.get((type(owner), attr))
        if form is None:
            raise ValueError(f"{name}: {type(owner).__name__}.{attr} has no "
                             f"column-sharded form")
        width = owner.get_parameter(attr).shape[-1]
        if width % size:
            raise ValueError(f"{name} has {width} columns, not a multiple of {size}")
        plan.append((owner, attr, form, width // size))
    shard = ColumnShard(group, rank, size)
    with torch.no_grad():
        for owner, attr, form, w in plan:
            p = owner.get_parameter(attr)
            p.data = p.data[..., rank * w:(rank + 1) * w].clone()
            owner.__class__ = form
            owner.column_shard = shard


def gather_columns(model: torch.nn.Module, kernels: Sequence[str], group,
                   size: int) -> dict:
    """{name: whole kernel} of the kernels ``shard_columns`` sliced."""
    out = {}
    for name in kernels:
        p = model.get_parameter(name).detach()
        parts = [torch.empty_like(p) for _ in range(size)]
        dist.all_gather(parts, p.contiguous(), group=group)
        out[name] = torch.cat(parts, dim=-1)
    return out


# --- one process a rank ----------------------------------------------------

def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def init_local_group(backend: str, rank: int, world_size: int, port: int,
                     timeout_s: float = 600.0) -> None:
    """Join the process group at ``tcp://localhost:port``; with NCCL, rank r
    uses card r."""
    if backend == "nccl":
        torch.cuda.set_device(rank)
    dist.init_process_group(backend, init_method=f"tcp://localhost:{port}",
                            world_size=world_size, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout_s))


def _rank_main(fn, rank, world_size, port, backend, args, results) -> None:
    try:
        if backend == "gloo":
            torch.set_num_threads(max(1, (os.cpu_count() or 1) // world_size))
        init_local_group(backend, rank, world_size, port)
        try:
            out = fn(*args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:           # reported to the parent, which raises
        results.put((rank, False, traceback.format_exc()))
        raise


def launch(fn: Callable, world_size: int, *args, backend: str = "gloo",
           timeout: float = 600.0) -> list:
    """``fn(*args)`` in ``world_size`` spawned processes joined into one
    process group (``tcp://localhost:<free port>``; gloo on the CPU, or NCCL
    with rank r on card r). Returns the results by rank. A rank that raises,
    dies or outlives ``timeout`` seconds makes it raise ``RuntimeError``
    with that rank's traceback; every process is stopped before it
    returns. ``fn`` and its arguments and results are pickled, so ``fn`` is
    a module-level function."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_rank_main,
                         args=(fn, r, world_size, port, backend, args, results),
                         daemon=True)
             for r in range(world_size)]
    for p in procs:
        p.start()
    got, failed = {}, {}
    deadline = time.time() + timeout
    try:
        while len(got) + len(failed) < world_size:
            try:
                rank, ok, value = results.get(timeout=1.0)
            except queue.Empty:
                for r, p in enumerate(procs):
                    if p.exitcode not in (None, 0) and r not in got and r not in failed:
                        failed[r] = f"exited with code {p.exitcode}"
                if time.time() > deadline:
                    for r in range(world_size):
                        if r not in got and r not in failed:
                            failed[r] = f"still running after {timeout:.0f} s"
                continue
            (got if ok else failed)[rank] = value
    finally:
        for p in procs:
            p.join(timeout=5.0 if failed else 30.0)
            if p.is_alive():
                p.kill()
                p.join()
        results.close()
    if failed:
        first = min(failed)
        raise RuntimeError(f"{len(failed)} of {world_size} ranks failed; rank "
                           f"{first}: {failed[first]}")
    return [got[r] for r in range(world_size)]
