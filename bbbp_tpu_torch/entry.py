"""Entry point of the port's flagship model, the counterpart of
``entry()`` in ``__graft_entry__.py``: the forward of
``MultiModalRegressor(fp_dim=167, n_layers=4)`` (Transformer+CNN with
multi-head attention fusion, bf16 compute) on (8, 167) fingerprints and
(8, 128, 128, 3) images of ones.

    forward, args = entry()           # on the card; entry("cpu") on the CPU
    out = forward(*args)              # [8] f32

The parameters are drawn from a seeded generator, as the reference's
``model.init(PRNGKey(0), ...)`` draws them (other numbers: torch's
generator is not ``jax.random``). The reference's ``dryrun_multichip`` (one
dp × tp training step on a device mesh) has no counterpart yet: it comes
with the port of ``parallel/mesh.py``.
"""

from __future__ import annotations

from typing import Callable, Tuple, Union

import torch

from bbbp_tpu_torch.models.transformer_cnn import MultiModalRegressor
from bbbp_tpu_torch.ops.forest_train import resolve_device


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
