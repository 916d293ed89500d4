"""Knowledge-graph store, annotation normalizer and subgraph featurizer
(host-side, numpy), with the names ``camouflage_multimodal_tpu/kg/__init__.py``
exports. The optional Neo4j export lives in :mod:`.neo4j_compat`."""

from camouflage_multimodal_tpu_torch.kg.store import CamouflageKnowledgeStore  # noqa: F401
from camouflage_multimodal_tpu_torch.kg.normalize import extract_structured  # noqa: F401
from camouflage_multimodal_tpu_torch.kg.featurize import (  # noqa: F401
    build_subgraph,
    pad_subgraphs,
    NODE_TYPES,
    COLOR_VOCAB,
    TEXTURE_VOCAB,
)
