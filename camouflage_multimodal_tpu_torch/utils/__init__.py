"""The reference's ``utils`` names: the metric wrappers and the four plot
helpers of :mod:`.visualization`. The plot helpers load matplotlib on first
access, so the metrics import without it."""

from camouflage_multimodal_tpu_torch.utils.metrics import (  # noqa: F401
    batch_evaluate,
    calculate_accuracy,
    calculate_dice,
    calculate_iou,
    calculate_mae,
    calculate_precision_recall_f1,
    evaluate_segmentation,
)

_PLOTS = ("plot_training_history", "plot_attention_heatmap", "plot_comparison",
          "plot_metrics_summary")

__all__ = [
    "calculate_iou",
    "calculate_dice",
    "calculate_precision_recall_f1",
    "calculate_mae",
    "calculate_accuracy",
    "evaluate_segmentation",
    "batch_evaluate",
    *_PLOTS,
]


def __getattr__(name):
    if name in _PLOTS:
        from camouflage_multimodal_tpu_torch.utils import visualization

        return getattr(visualization, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
