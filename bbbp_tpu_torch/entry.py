"""Entry points of the port's flagship model, the counterparts of
``entry()`` and ``dryrun_multichip()`` in ``__graft_entry__.py``.

``entry()`` is the forward of ``MultiModalRegressor(fp_dim=167,
n_layers=4)`` (Transformer+CNN with multi-head attention fusion, bf16
compute) on (8, 167) fingerprints and (8, 128, 128, 3) images of ones:

    forward, args = entry()           # on the card; entry("cpu") on the CPU
    out = forward(*args)              # [8] f32

The parameters are drawn from a seeded generator, as the reference's
``model.init(PRNGKey(0), ...)`` draws them (other numbers: torch's
generator is not ``jax.random``).

``dryrun_multichip(n)`` runs one dp × tp training step of a small
regressor on a (data, model) mesh of n ranks (``parallel/mesh.py``): the
folds shard over ``data`` (one fold a data-rank), and the dense kernels
whose flax leaves are at least 128 wide are column-sharded over ``model``
(each model-rank computes its slice of the layer's outputs; a
differentiable all-gather joins them). It starts one process a rank: NCCL
over n cards where there are n, else gloo on the CPU, which it says.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple, Union

import numpy as np
import torch

from bbbp_tpu_torch.models.transformer_cnn import MultiModalRegressor
from bbbp_tpu_torch.ops.forest_train import resolve_device

# the dry run's model, batch, image side and optimizer (__graft_entry__.py)
DRYRUN_MODEL = dict(fp_dim=64, n_layers=2, emb_dim=64, head_dims=(128, 64))
DRYRUN_BATCH, DRYRUN_SIDE = 8, 32
DRYRUN_LR, DRYRUN_WEIGHT_DECAY = 1e-3, 1e-4      # optax.adamw(1e-3)'s defaults


def entry(device: Union[str, torch.device] = "cuda"
          ) -> Tuple[Callable[..., torch.Tensor], tuple]:
    """(forward, (model, fp, img)); ``cuda`` without a card raises."""
    dev = resolve_device(device)
    generator = torch.Generator(device=dev).manual_seed(0)
    model = MultiModalRegressor(fp_dim=167, n_layers=4, device=dev,
                                generator=generator)
    fp = torch.ones((8, 167), dtype=torch.float32, device=dev)
    img = torch.ones((8, 128, 128, 3), dtype=torch.bfloat16, device=dev)

    def forward(model, fp, img):
        with torch.no_grad():
            return model(fp, img, train=False)

    return forward, (model, fp, img)


def dryrun_step(folds: int, mesh=None, params=None, dropout: Optional[float] = None,
                dtype: torch.dtype = torch.bfloat16,
                device: Union[str, torch.device] = "cuda"):
    """One AdamW step of ``MultiModalRegressor(**DRYRUN_MODEL)`` × ``folds``
    on the dry run's batch (fingerprints and 32² images of ones, targets 0,
    8 rows a fold, dropout on): the folds' losses [K] and every parameter
    after the step ({name: [K, ...]}), numpy.

    Without ``mesh`` one process runs all folds. With ``mesh`` (this
    process one rank of it; ``folds`` its data axis) data-rank r keeps fold
    block r, the wide dense kernels are column-sharded over ``model``, and
    the losses and parameters are gathered back, so each rank returns what
    one process returns. The init comes from a generator seeded 0 and the
    dropout from one seeded 1 (drawn for all folds, each rank keeping its
    block's), or the init from ``params``, a flax params tree with a
    leading fold axis (the JAX dry run's vmapped init). ``dropout``
    overrides the model's rate. ``cuda`` without a card raises."""
    from bbbp_tpu_torch.models.convert import load_flax, unstack_folds
    from bbbp_tpu_torch.models.fold import FoldBlock, keep_fold_block
    from bbbp_tpu_torch.parallel import mesh as pm
    from bbbp_tpu_torch.train.loop import AdamW

    dev = resolve_device(device)
    kw = dict(DRYRUN_MODEL, image_size=DRYRUN_SIDE, dtype=dtype)
    if dropout is not None:
        kw["dropout"] = dropout
    net = MultiModalRegressor(**kw, folds=folds, device=dev,
                              generator=torch.Generator(device=dev).manual_seed(0))
    if params is not None:
        load_flax(net, unstack_folds(params))
    draws = torch.Generator(device=dev).manual_seed(1)
    start, stop, kernels = 0, folds, []
    if mesh is not None:
        block = pm.fold_block(folds, mesh)
        if block is None:
            raise ValueError(f"{folds} folds do not divide the mesh's data axis")
        start, stop = block
        keep_fold_block(net, start, stop)
        draws = FoldBlock(draws, folds, start, stop)
        mp = mesh["model"].size()
        if mp > 1:
            kernels = pm.wide_dense_kernels(net)
            pm.shard_columns(net, kernels, mesh.get_group("model"),
                             mesh["model"].get_local_rank(), mp)
    opt = AdamW(list(net.parameters()), DRYRUN_LR, DRYRUN_WEIGHT_DECAY)
    k = stop - start
    fp = torch.ones((k, DRYRUN_BATCH, DRYRUN_MODEL["fp_dim"]), device=dev)
    img = torch.ones((k, DRYRUN_BATCH, DRYRUN_SIDE, DRYRUN_SIDE, 3), device=dev)
    pred = net(fp, img, train=True, generator=draws)
    loss = (pred ** 2).mean(dim=1)                   # targets 0
    opt.step(torch.autograd.grad(loss.sum(), opt.params))
    loss = loss.detach()
    state = {name: p.detach() for name, p in net.named_parameters()}
    if kernels:
        state.update(pm.gather_columns(net, kernels, mesh.get_group("model"),
                                       mesh["model"].size()))
    if mesh is not None:
        data = mesh.get_group("data")
        loss = pm.gather_folds(loss, data)
        state = {name: pm.gather_folds(t, data) for name, t in state.items()}
    return (loss.float().cpu().numpy(),
            {name: t.float().cpu().numpy() for name, t in state.items()})


def dryrun_mesh_shape(n_devices: int) -> dict:
    """(data, model) of the dry run's mesh: model 2 where n is even and
    at least 4."""
    mp = 2 if n_devices % 2 == 0 and n_devices >= 4 else 1
    return {"data": n_devices // mp, "model": mp}


def dryrun_rank(n_devices: int, params=None, dropout: Optional[float] = None,
                dtype: torch.dtype = torch.bfloat16):
    """One rank of the dry run (``parallel/mesh.py::launch`` calls it in each
    process): ``dryrun_step`` on the mesh of ``dryrun_mesh_shape``."""
    import torch.distributed as dist

    from bbbp_tpu_torch.parallel.mesh import make_mesh

    shape = dryrun_mesh_shape(n_devices)
    mesh = make_mesh(n_devices, model_parallel=shape["model"])
    device = (torch.device("cuda", torch.cuda.current_device())
              if dist.get_backend() == "nccl" else "cpu")
    return dryrun_step(shape["data"], mesh, params, dropout, dtype, device)


def dryrun_multichip(n_devices: int, timeout: float = 1200.0) -> dict:
    """One sharded training step on n ranks (module doc); prints
    ``dryrun_multichip(n): mesh={...} loss=[...]`` and returns the mesh, the
    backend, the losses and the updated parameters. Any rank's failure
    raises."""
    from bbbp_tpu_torch.parallel.mesh import launch

    shape = dryrun_mesh_shape(n_devices)
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    backend = "nccl" if cards >= n_devices else "gloo"
    if backend == "gloo":
        print(f"dryrun_multichip({n_devices}): {cards} CUDA cards, fewer than "
              f"{n_devices}: running {n_devices} gloo processes on the CPU")
    loss, params = launch(dryrun_rank, n_devices, n_devices, backend=backend,
                          timeout=timeout)[0]
    print(f"dryrun_multichip({n_devices}): mesh={shape} "
          f"loss={np.round(loss, 4).tolist()}")
    return {"mesh": shape, "backend": backend, "loss": loss, "params": params}
