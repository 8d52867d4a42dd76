"""Device meshes on ``torch.distributed`` (``mesh``) and host→device
prefetch (``prefetch``)."""

from bbbp_tpu_torch.parallel.mesh import (batch_sharding, make_mesh,
                                          replicated, shard_batch)
from bbbp_tpu_torch.parallel.prefetch import prefetch_to_device

__all__ = ["make_mesh", "batch_sharding", "replicated", "shard_batch",
           "prefetch_to_device"]
