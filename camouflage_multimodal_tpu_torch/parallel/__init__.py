"""The ``(data, model)`` mesh over ``torch.distributed``: data parallelism,
tensor parallelism of the fusion model and spatial sharding of the
region-graph build (the JAX package's ``parallel/``)."""

from camouflage_multimodal_tpu_torch.parallel.sharding import (  # noqa: F401
    gather_fusion_params,
    make_mesh,
    replicate,
    shard_batch,
    shard_fusion_params,
    shard_spatial,
)
