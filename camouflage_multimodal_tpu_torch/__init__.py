"""PyTorch / CUDA port of :mod:`camouflage_multimodal_tpu` for NVIDIA Hopper.

The JAX package stays the reference; every module here mirrors its
counterpart's name (``ops/slic.py`` ↔ ``camouflage_multimodal_tpu/ops/slic.py``)
so a reader finds each twin. The Pallas kernels — SLIC assignment, the
fused cross-attention and its gradient — are hand-written CUDA C++ for
``sm_90a`` under ``csrc/``; each sits behind a wrapper that runs its plain
PyTorch version for CPU tensors, launches the kernel for CUDA tensors, and
raises for anything else. Ported: inference and directory evaluation
(``api``), fusion, RG and KG training (``train``), RG embedding extraction
(``extract``), the embedding stores and the RG ↔ KG matcher (``core``,
``data``), the metrics (``eval``, ``utils``) and the reference's ``.pth`` /
``.pt`` files (``core.torch_compat``), serving and the CLI (``serve``,
``cli``), data and model parallelism (``parallel``) and the optional Neo4j
export (``kg.neo4j_compat``).

This package imports ``torch`` and numpy only — never ``jax``, ``flax`` or
anything of :mod:`camouflage_multimodal_tpu`. Entry points default to
``device="cuda"`` and raise when CUDA is absent; ``device="cpu"`` runs the
plain versions (the test suite's route).

The top-level names are those of the JAX package: ``load_config`` and
``default_config`` at import, the models, pipelines and the API on first
access (importing the package loads none of them, nor the kernels).
"""

__version__ = "0.1.0"

from camouflage_multimodal_tpu_torch.core.config import load_config, default_config  # noqa: F401

_LAZY = {
    "RegionGraphGNN": "camouflage_multimodal_tpu_torch.models",
    "KnowledgeGraphGNN": "camouflage_multimodal_tpu_torch.models",
    "MultimodalCamouflageDetector": "camouflage_multimodal_tpu_torch.models",
    "build_multimodal_model": "camouflage_multimodal_tpu_torch.models",
    "RegionGraphPipeline": "camouflage_multimodal_tpu_torch.pipeline",
    "MultimodalPipeline": "camouflage_multimodal_tpu_torch.pipeline",
    "detect_camouflage": "camouflage_multimodal_tpu_torch.api",
    "MultimodalPredictor": "camouflage_multimodal_tpu_torch.api",
    "evaluate_directory": "camouflage_multimodal_tpu_torch.api",
    "EmbeddingMatcher": "camouflage_multimodal_tpu_torch.data.matcher",
    "CamouflageKnowledgeStore": "camouflage_multimodal_tpu_torch.kg.store",
}


def __getattr__(name):
    """The JAX package's lazy top-level API, each name from the port's
    module."""
    if name in _LAZY:
        import importlib

        return getattr(importlib.import_module(_LAZY[name]), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
