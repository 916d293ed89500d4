from camouflage_multimodal_tpu_torch.eval.metrics import (  # noqa: F401
    batch_evaluate,
    dice,
    e_measure,
    evaluate_segmentation,
    iou,
    mae,
    pixel_accuracy,
    precision_recall_f1,
    s_measure,
)
