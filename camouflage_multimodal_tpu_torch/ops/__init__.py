"""The port's compute ops: image ops, morphology, Canny, SLIC, connectivity,
region features and the region adjacency graph, in PyTorch and the CUDA
kernels of ``csrc/``.

Exports the names of ``camouflage_multimodal_tpu/ops/__init__.py``, in its
order, and the connectivity entry point. As there, ``ops.slic`` and
``ops.canny`` are the functions: take their modules with
``importlib.import_module("camouflage_multimodal_tpu_torch.ops.slic")``.
"""

from camouflage_multimodal_tpu_torch.ops.image import (  # noqa: F401
    rgb_to_gray,
    rgb_to_lab,
    gaussian_blur,
    imagenet_normalize,
    imagenet_denormalize,
)
from camouflage_multimodal_tpu_torch.ops.morphology import (  # noqa: F401
    binary_dilation_cross,
    binary_dilation_full,
)
from camouflage_multimodal_tpu_torch.ops.canny import canny  # noqa: F401
from camouflage_multimodal_tpu_torch.ops.slic import slic  # noqa: F401
from camouflage_multimodal_tpu_torch.ops.regions import region_features, region_label_means  # noqa: F401
from camouflage_multimodal_tpu_torch.ops.rag import region_adjacency, rag_edge_weights  # noqa: F401
from camouflage_multimodal_tpu_torch.ops.connectivity import enforce_label_connectivity  # noqa: F401
