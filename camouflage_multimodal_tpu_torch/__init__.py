"""PyTorch / CUDA port of :mod:`camouflage_multimodal_tpu` for NVIDIA Hopper.

The JAX package stays the reference; every module here mirrors its
counterpart's name (``ops/slic.py`` ↔ ``camouflage_multimodal_tpu/ops/slic.py``)
so a reader finds each twin. The Pallas kernels — SLIC assignment, the
fused cross-attention and its gradient — are hand-written CUDA C++ for
``sm_90a`` under ``csrc/``; each sits behind a wrapper that runs its plain
PyTorch version for CPU tensors, launches the kernel for CUDA tensors, and
raises for anything else. Inference (``api``) and fusion training
(``train.train_fusion``) are ported.

This package imports ``torch`` and numpy only — never ``jax``, ``flax`` or
anything of :mod:`camouflage_multimodal_tpu`. Entry points default to
``device="cuda"`` and raise when CUDA is absent; ``device="cpu"`` runs the
plain versions (the test suite's route).
"""

__version__ = "0.1.0"
