"""Host-side data helpers: COD10K decode and datasets, labels from masks,
the embedding stores and the RG ↔ KG matcher (the JAX package's ``data/``
and the store functions of its ``core/artifacts.py``), re-exported here
under one name."""

from camouflage_multimodal_tpu_torch.core.artifacts import (  # noqa: F401
    load_kg_embeddings, load_rg_embeddings, save_kg_embeddings, save_rg_embeddings)
from camouflage_multimodal_tpu_torch.data.cod10k import (  # noqa: F401
    IMAGE_EXTS, CODDataset, CODSample, load_image_rgb, load_mask, parse_cod10k_name)
from camouflage_multimodal_tpu_torch.data.labels import (  # noqa: F401
    _mask_stats, extract_label_from_mask)
from camouflage_multimodal_tpu_torch.data.matcher import (  # noqa: F401
    EmbeddingMatcher, build_ordered_kg_tensor)
