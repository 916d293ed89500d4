"""Quality anchor: the reference recipe's weights and the port's RGTrainer
on the same split, evaluated by the same composed pipeline.

Port of the JAX system's ``scripts/quality_anchor.py``. The reference
published no accuracy numbers, so quality is anchored here: the reference's
own torch model trained by its own recipe (``fidelity_gate --stage train``)
and the port's ``RGTrainer`` trained on the same 120-image split of
``fidelity_gate.quadruples``, both evaluated by ``api.evaluate_directory``
on the same 50 held-out images (kernel B1 in the RG build and in every
evaluation batch on the card).

Rows of ``quality_table[_<size>].json`` (the JAX keys; ``jax_trained`` is
the port's trainer here):

* ``reference_torch_trained_weights_in_jax_pipeline`` — the gate's probe
  weights (``fidelity/best_model[_<size>].pth`` of the output root, else
  the repo's committed ones) in the port's pipeline at ``feature_norm=256``;
* ``jax_trained`` — ``quality/rg_jax_anchor[_<size>].ckpt`` from ``train``;
* ``reference_composed_pipeline_iou`` — the reference side's IoU from the
  gate's report in the same output root.

Images and GT come from ``fidelity_gate.REF_DATA``; everything is written
under ``--out`` (default ``artifacts/torch_port/``).

    python -m camouflage_multimodal_tpu_torch.scripts.quality_anchor \\
        [--stage all|train|eval] [--epochs 30] [--size 256] [--out DIR]
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile

import torch

from camouflage_multimodal_tpu_torch.scripts import fidelity_gate as gate


def _quality(out: str, name: str, size: int) -> str:
    stem, ext = os.path.splitext(name)
    return os.path.join(out, "quality", name if size == 256 else f"{stem}_{size}{ext}")


def _ckpt(size: int, out: str = gate.OUT) -> str:
    return _quality(out, "rg_jax_anchor.ckpt", size)


def _filtered_dataset(names, image_size: int = 256):
    from camouflage_multimodal_tpu_torch.data.cod10k import CODDataset

    ds = CODDataset(*(os.path.join(gate.REF_DATA, d)
                      for d in ("images", "gt_object", "gt_instance", "gt_edge")),
                    image_size=image_size)
    want = {base for base, *_ in names}
    ds.samples = [s for s in ds.samples if os.path.splitext(s.image_name)[0] in want]
    if len(ds.samples) != len(names):
        raise ValueError(f"{len(names)} images asked for, {len(ds.samples)} found with GT "
                         f"under {gate.REF_DATA}")
    return ds


def stage_train(train_names, epochs: int = 30, batch_size: int = 4, size: int = 256,
                out: str = gate.OUT, device: str | torch.device = "cuda") -> None:
    from camouflage_multimodal_tpu_torch.pipeline import padded_nodes
    from camouflage_multimodal_tpu_torch.train.train_rg import RGTrainer

    ckpt = _ckpt(size, out)
    os.makedirs(os.path.dirname(ckpt), exist_ok=True)
    ds = _filtered_dataset(train_names, image_size=size)
    trainer = RGTrainer(n_segments=500, max_nodes=padded_nodes(500, size))
    _, history = trainer.fit(ds, epochs=epochs, batch_size=batch_size,
                             checkpoint_path=ckpt, device=device)
    with open(_quality(out, "rg_jax_anchor_history.json", size), "w") as f:
        json.dump(history, f, indent=2)


def _eval_split(ckpt, test_names, size: int = 256, feature_norm=None,
                device: str | torch.device = "cuda"):
    """Composed-pipeline metrics on exactly the held-out images (a directory
    of symlinks to them). ``feature_norm=256`` for reference-recipe weights,
    trained on /256-normalised positions."""
    from camouflage_multimodal_tpu_torch.api import evaluate_directory

    with tempfile.TemporaryDirectory(prefix="quality_eval_") as tmp:
        img_dir = os.path.join(tmp, "images")
        gt_dir = os.path.join(tmp, "gt")
        os.makedirs(img_dir)
        os.makedirs(gt_dir)
        for base, img_p, mask_p, *_ in test_names:
            os.symlink(os.path.abspath(img_p), os.path.join(img_dir, base + ".jpg"))
            os.symlink(os.path.abspath(mask_p), os.path.join(gt_dir, base + ".png"))
        return evaluate_directory(ckpt, img_dir, gt_dir, batch_size=10, image_size=size,
                                  feature_norm=feature_norm, device=device)


def stage_eval(test_names, size: int = 256, out: str = gate.OUT,
               device: str | torch.device = "cuda") -> dict:
    rows = {}
    ref_ckpt = gate.weights(gate._rg_name(size), out)
    if os.path.exists(ref_ckpt):
        rows["reference_torch_trained_weights_in_jax_pipeline"] = _eval_split(
            ref_ckpt, test_names, size=size, feature_norm=256, device=device)
    ckpt = _ckpt(size, out)
    if os.path.exists(ckpt):
        rows["jax_trained"] = _eval_split(ckpt, test_names, size=size, device=device)
    report = os.path.join(out, "fidelity_report.json" if size == 256
                          else f"fidelity_report_{size}.json")
    if os.path.exists(report):
        with open(report) as f:
            fr = json.load(f)
        rows["reference_composed_pipeline_iou"] = (
            fr.get("iou_vs_gt", fr.get("iou_vs_gt_cam_only", {})) or {}).get("ref")

    table = {
        "image_size": size,
        "n_held_out": len(test_names),
        "protocol": "composed image→heatmap pipeline, binarized at 0.5, "
                    "IoU/Dice/F1/MAE/S/E on the device over the fidelity "
                    "held-out images; both models trained on the same split "
                    "(reference: its own recipe; jax_trained: the port's "
                    "RGTrainer, same losses and schedule)",
        "rows": rows,
    }
    os.makedirs(out, exist_ok=True)
    name = "quality_table.json" if size == 256 else f"quality_table_{size}.json"
    with open(os.path.join(out, name), "w") as f:
        json.dump(table, f, indent=2)
    print(json.dumps(table, indent=2))
    return table


def main(argv=None, device: str | torch.device = "cuda") -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--stage", default="all", choices=["all", "train", "eval"])
    ap.add_argument("--epochs", type=int, default=30)
    ap.add_argument("--n-train", type=int, default=120)
    ap.add_argument("--n-test", type=int, default=50)
    ap.add_argument("--size", type=int, default=256,
                    help="image resolution; non-256 rows land in quality_table_<size>.json")
    ap.add_argument("--out", default=gate.OUT, help="output root (default: %(default)s)")
    args = ap.parse_args(argv)

    train_s, test_s = gate.quadruples(args.n_train, args.n_test)
    if args.stage in ("all", "train"):
        stage_train(train_s, epochs=args.epochs, size=args.size, out=args.out, device=device)
    if args.stage in ("all", "eval"):
        stage_eval(test_s, size=args.size, out=args.out, device=device)


if __name__ == "__main__":
    main()
