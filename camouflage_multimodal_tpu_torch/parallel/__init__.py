"""Data parallelism over ``torch.distributed`` (the ``data`` axis of the JAX
package's ``parallel/``)."""

from camouflage_multimodal_tpu_torch.parallel.sharding import (  # noqa: F401
    make_mesh,
    replicate,
    shard_batch,
    shard_fusion_params,
)
