"""Train the region-graph GNN on a COD10K tree end to end and evaluate it
on a held-out split.

Port of the JAX system's ``scripts/train_rg_real.py``: ``RGTrainer`` on the
first ``--images`` quadruples (SLIC → features → RAG → GNN → multi-task
loss, the graphs built once on the device with kernel B1), then
``api.evaluate_directory`` on the next ``--eval-images`` (head/tail split)
or, with ``--eval-stride N``, on every Nth image held out of training, with
the metrics also on its CAM-only subset (NonCAM images carry empty GT).
Above 1,500 training images the edge weights are stored in bfloat16.

Writes ``rg_model.ckpt``, ``rg_training_history.json`` and
``rg_eval_metrics.json`` under ``--out`` (default ``artifacts/torch_port/``).

    python -m camouflage_multimodal_tpu_torch.scripts.train_rg_real \\
        [--data-root DIR] [--images N] [--eval-images N] [--eval-stride N] \\
        [--epochs E] [--out DIR]
"""

from __future__ import annotations

import argparse
import json
import os
import time

import torch

from camouflage_multimodal_tpu_torch.scripts import fidelity_gate as gate


def main(argv=None, device: str | torch.device = "cuda") -> dict:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--images", type=int, default=256)
    parser.add_argument("--eval-images", type=int, default=256)
    parser.add_argument("--eval-stride", type=int, default=0,
                        help="If >0, hold out every Nth image (interleaved split "
                             "spanning all COD10K categories) instead of the head/tail "
                             "split; --images then caps the train side and "
                             "--eval-images the held-out side.")
    parser.add_argument("--epochs", type=int, default=10)
    parser.add_argument("--batch-size", type=int, default=8)
    parser.add_argument("--image-size", type=int, default=256)
    parser.add_argument("--n-segments", type=int, default=500)
    parser.add_argument("--data-root", default=gate.REF_DATA)
    parser.add_argument("--out", default=gate.OUT, help="output root (default: %(default)s)")
    args = parser.parse_args(argv)

    from camouflage_multimodal_tpu_torch.api import evaluate_directory
    from camouflage_multimodal_tpu_torch.core.device import resolve_device
    from camouflage_multimodal_tpu_torch.data.cod10k import CODDataset
    from camouflage_multimodal_tpu_torch.pipeline import padded_nodes
    from camouflage_multimodal_tpu_torch.train.train_rg import RGTrainer

    dev = resolve_device(device)
    os.makedirs(args.out, exist_ok=True)
    ds_full = CODDataset(*(os.path.join(args.data_root, d)
                           for d in ("images", "gt_object", "gt_instance", "gt_edge")),
                         image_size=args.image_size)
    held_out = []
    if args.eval_stride > 0:
        all_samples = ds_full.samples
        held_out = all_samples[:: args.eval_stride][: args.eval_images]
        held_names = {s.image_name for s in held_out}
        ds_full.samples = [s for s in all_samples
                           if s.image_name not in held_names][: args.images]
    else:
        ds_full.samples = ds_full.samples[: args.images]
    print(f"dataset: {len(ds_full)} quadruples  device={dev}"
          + (f"  (+{len(held_out)} interleaved held-out)" if held_out else ""))

    trainer = RGTrainer(n_segments=args.n_segments,
                        max_nodes=padded_nodes(args.n_segments, args.image_size),
                        learning_rate=1e-3, weight_decay=1e-4)
    # bfloat16 edge weights halve the largest device buffer of large runs.
    weights_dtype = torch.bfloat16 if args.images > 1500 else torch.float32

    ckpt = os.path.join(args.out, "rg_model.ckpt")
    t0 = time.time()
    _, history = trainer.fit(ds_full, epochs=args.epochs, batch_size=args.batch_size,
                             weights_dtype=weights_dtype, checkpoint_path=ckpt, device=dev)
    train_time = time.time() - t0
    print(f"training wall-clock: {train_time:.1f}s "
          f"({train_time / args.epochs:.1f}s/epoch incl. one-time graph build)")

    with open(os.path.join(args.out, "rg_training_history.json"), "w") as f:
        json.dump(history, f, indent=2)

    # Held-out evaluation (at the evaluation's default 256², as the JAX
    # script runs it whatever --image-size is).
    img_dir = os.path.join(args.data_root, "images")
    gt_dir = os.path.join(args.data_root, "gt_object")
    if held_out:
        eval_sets = {"all": [s.image_name for s in held_out]}
        cam = [n for n in eval_sets["all"] if "-CAM-" in n]
        if cam:
            eval_sets["cam_only"] = cam
        report = {"protocol": (f"interleaved held-out split (every {args.eval_stride}th "
                               f"image, excluded from training), {len(held_out)} images")}
        for name, file_list in eval_sets.items():
            print(f"evaluating on {len(file_list)} held-out images ({name})...")
            report[name] = evaluate_directory(ckpt, img_dir, gt_dir, n_segments=args.n_segments,
                                              batch_size=16, files=file_list, device=dev)
        metrics = report
        printable = {k: round(v, 4) for k, v in report.get("cam_only", report["all"]).items()
                     if not k.endswith("_std")}
    else:
        print(f"evaluating on {args.eval_images} held-out images...")
        metrics = evaluate_directory(ckpt, img_dir, gt_dir, n_segments=args.n_segments,
                                     batch_size=16, skip_images=args.images,
                                     max_images=args.eval_images, device=dev)
        printable = {k: round(v, 4) for k, v in metrics.items() if not k.endswith("_std")}
    with open(os.path.join(args.out, "rg_eval_metrics.json"), "w") as f:
        json.dump(metrics, f, indent=2)
    print(json.dumps(printable, indent=2))
    return metrics


if __name__ == "__main__":
    main()
