"""The reference's ``utils`` names: the metric wrappers. The plotting
helpers of ``camouflage_multimodal_tpu/utils/visualization.py`` are not
ported yet."""

from camouflage_multimodal_tpu_torch.utils.metrics import (  # noqa: F401
    batch_evaluate,
    calculate_accuracy,
    calculate_dice,
    calculate_iou,
    calculate_mae,
    calculate_precision_recall_f1,
    evaluate_segmentation,
)
