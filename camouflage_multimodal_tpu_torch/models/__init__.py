"""The port's models, with the names ``camouflage_multimodal_tpu/models/__init__.py``
exports."""

from camouflage_multimodal_tpu_torch.models.layers import MaskedBatchNorm  # noqa: F401
from camouflage_multimodal_tpu_torch.models.region_graph import RegionGraphGNN  # noqa: F401
from camouflage_multimodal_tpu_torch.models.knowledge_graph import KnowledgeGraphGNN  # noqa: F401
from camouflage_multimodal_tpu_torch.models.fusion import (  # noqa: F401
    CrossAttentionFusion,
    LateFusion,
    MultimodalCamouflageDetector,
    build_multimodal_model,
)
